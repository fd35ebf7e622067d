"""Communication op logging.

Port of ``deepspeedsyclsupport_tpu/comm/comms_logging.py`` (the reference's
``deepspeed/utils/comms_logging.py`` and the ``@timed_op`` wrapper of
``comm/comm.py:101-142``): per-op counts, message bytes and a
``log_summary()`` table, keyed ``"<op>[<axis>]"`` as in the JAX package.

The JAX package records at trace time (its collectives fuse into one
program); here every collective is an eager call, so each call is one
record, with the bytes of the tensor handed to it (the shard, as the JAX
package counts it). With ``timed`` on, the façade also records each call's
wall time (after a device sync, so that the time is the collective's and
not the enqueue's): that costs a sync a call, which is why it is off by
default.

The census window (:meth:`CommsLogger.open_window` /
:meth:`CommsLogger.close_window`, opened by the engine around one step)
is the port's counterpart of the compiled program the JAX package parses
(``comm/hlo_comms.py``): one entry per data-moving call, ``{"op",
"bytes", "shape", "group_size"}`` in ``hlo_comms.parse_collectives``'s
conventions: ``op`` the HLO opcode of the same data movement
(:data:`HLO_OPCODES`), ``bytes`` the RESULT tensor's (an all-gather the
gathered tensor, a reduce-scatter the shard), ``shape`` its HLO spelling
(``f32[64,128]``). A call over a group of one member moves no bytes and is
no entry (JAX ``analysis/collectives.py:118-124``: XLA emits no
collective for a single-member axis). The window records whether the
logger is enabled or not: it is the census, not the op-mix table.
:meth:`record_hlo` merges a census summary under ``xla::`` keys (the JAX
package's names, so that one pod report reads either package's
streams), :meth:`record_wall` and ``log_summary(show_straggler=True)``
give the straggler columns across the world.
"""
import logging
import re
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: the façade's op names -> the HLO opcode of the same data movement (the
#: JAX façade's lowering: ``broadcast`` and ``scatter`` are a psum there,
#: ``reduce`` a psum kept on its root, ``gather`` an untiled all-gather; a
#: ``send`` arrives as its peer's ``recv``, one permute)
HLO_OPCODES = {
    "all_reduce": "all-reduce", "all_reduce_mean": "all-reduce",
    "reduce": "all-reduce", "broadcast": "all-reduce",
    "scatter": "all-reduce",
    "all_gather": "all-gather", "gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all", "hierarchical_all_to_all": "all-to-all",
    "ppermute": "collective-permute", "recv": "collective-permute",
}

#: torch dtype name -> HLO element type (``hlo_comms._DTYPE_BYTES`` keys)
_HLO_TYPES = {
    "float32": "f32", "float16": "f16", "bfloat16": "bf16", "float64": "f64",
    "int8": "s8", "uint8": "u8", "int16": "s16", "int32": "s32",
    "int64": "s64", "bool": "pred", "float8_e4m3fn": "f8e4m3fn",
    "float8_e5m2": "f8e5m2", "complex64": "c64", "complex128": "c128",
}


def hlo_shape(t) -> str:
    """``t``'s shape in HLO's spelling: ``f32[64,128]``."""
    dt = str(t.dtype).replace("torch.", "")
    return f"{_HLO_TYPES.get(dt, dt)}[{','.join(str(d) for d in t.shape)}]"


@dataclass
class _OpRecord:
    count: int = 0
    total_bytes: int = 0
    seconds: float = 0.0


class CommsLogger:
    """Collective op recorder (reference: ``utils/comms_logging.py``)."""

    def __init__(self, enabled: bool = False, verbose: bool = False,
                 timed: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.timed = timed
        self._lock = threading.Lock()
        self._records: Dict[str, _OpRecord] = defaultdict(_OpRecord)
        self._wall: Dict[str, float] = {}
        self._window: Optional[List[Dict[str, Any]]] = None

    def configure(self, enabled: Optional[bool] = None,
                  verbose: Optional[bool] = None,
                  timed: Optional[bool] = None):
        if enabled is not None:
            self.enabled = enabled
        if verbose is not None:
            self.verbose = verbose
        if timed is not None:
            self.timed = timed

    def append(self, op_name: str, axis_name, nbytes: int, shape: tuple,
               seconds: Optional[float] = None):
        if not self.enabled:
            return
        key = f"{op_name}[{axis_name}]"
        with self._lock:
            rec = self._records[key]
            rec.count += 1
            rec.total_bytes += nbytes
            if seconds is not None:
                rec.seconds += seconds
        if self.verbose:
            logger.info("comm op: %s | bytes: %d | shape: %s", key, nbytes,
                        shape)

    # ------------------------------------------------------ census window
    def open_window(self) -> None:
        """Start recording census entries (the engine, at a step's
        start); an open window is started afresh."""
        with self._lock:
            self._window = []

    def close_window(self) -> List[Dict[str, Any]]:
        """Stop recording; returns the window's entries in call order."""
        with self._lock:
            out, self._window = self._window or [], None
        return out

    def record_call(self, op_name: str, result, group_size: int) -> None:
        """One façade call's census entry (no-op with no window open, for
        an op that moves no data, and over a group of one member)."""
        if self._window is None or group_size <= 1:
            return
        op = HLO_OPCODES.get(op_name)
        if op is None:
            return
        entry = {"op": op, "bytes": result.numel() * result.element_size(),
                 "shape": hlo_shape(result), "group_size": int(group_size)}
        with self._lock:
            if self._window is not None:
                self._window.append(entry)

    def record_hlo(self, summary: Dict[str, Dict], tag: str) -> None:
        """Merge a census summary (``hlo_comms.summarize_collectives``)
        under ``xla::`` keys. Idempotent per (op, tag): recording the same
        step's summary again replaces rather than double-counts."""
        with self._lock:
            for op, s in summary.items():
                rec = self._records[f"xla::{op}[{tag}]"]
                rec.count = s["count"]
                rec.total_bytes = s["total_bytes"]

    def record_wall(self, name: str, seconds: float) -> None:
        """Accumulate wall-clock against a name (engine step timing): the
        basis of the straggler columns."""
        with self._lock:
            self._wall[name] = self._wall.get(name, 0.0) + seconds

    def log_summary(self, show_straggler: bool = False) -> str:
        """The summary table (reference ``log_summary``): each op's count,
        MB and (timed) ms. ``show_straggler`` (reference
        ``utils/comms_logging.py:108``) adds each rank's accumulated
        wall-clock per name beside the world's min and max: a rank far
        above the min is the straggler. A collective then (see
        :meth:`_straggler_rows`)."""
        lines = [f"{'op':<44}{'count':>10}{'total MB':>14}{'ms':>12}"]
        with self._lock:
            for key in sorted(self._records):
                rec = self._records[key]
                lines.append(f"{key:<44}{rec.count:>10}"
                             f"{rec.total_bytes / 2**20:>14.2f}"
                             f"{rec.seconds * 1e3:>12.3f}")
            wall = dict(self._wall)
        if show_straggler:
            lines.append("")
            lines.append(f"{'wall-clock (per rank)':<44}{'self s':>10}"
                         f"{'min s':>10}{'max s':>10}")
            for name, mine, lo, hi in self._straggler_rows(wall):
                lines.append(f"{name:<44}{mine:>10.3f}{lo:>10.3f}"
                             f"{hi:>10.3f}")
        table = "\n".join(lines)
        logger.info("\n%s", table)
        return table

    @staticmethod
    def _straggler_rows(wall: Dict[str, float]):
        """``[(name, self, min, max)]`` over the ranks of the default
        process group, in ONE collective.

        COLLECTIVE CONTRACT: under a process group every rank calls
        ``log_summary(show_straggler=True)`` together with the SAME timed
        names; the names' digest rides the same gather and a disagreement
        raises instead of misaligning the columns."""
        import hashlib

        import torch.distributed as dist

        names = sorted(wall)
        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() == 1:
            return [(n, wall[n], wall[n], wall[n]) for n in names]
        digest = hashlib.sha256("|".join(names).encode()).hexdigest()[:16]
        gathered: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, (digest, [wall[n] for n in names]))
        if any(g[0] != digest for g in gathered):
            raise RuntimeError(
                "show_straggler: ranks timed different op names — every "
                "rank must record the same wall-clock keys")
        return [(n, wall[n], min(g[1][i] for g in gathered),
                 max(g[1][i] for g in gathered))
                for i, n in enumerate(names)]

    def summary_events(self, step: int):
        """Per-op monitor events under the declared ``Comm/`` family
        (``monitor/telemetry.py`` EVENT_PREFIXES), keys sanitized to the
        ``Group/name`` charset (``all_reduce[data]`` ->
        ``all_reduce.data``)."""
        events = []
        with self._lock:
            for key in sorted(self._records):
                rec = self._records[key]
                name = re.sub(r"[^\w.\-]", ".", key).strip(".")
                events.append((f"Comm/{name}/count", rec.count, step))
                events.append((f"Comm/{name}/bytes", rec.total_bytes, step))
        return events

    def reset(self):
        with self._lock:
            self._records.clear()
            self._wall.clear()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{key: {"count", "total_bytes"}}`` (plus ``"seconds"`` for the
        ops a timed logger saw)."""
        with self._lock:
            out = {}
            for k, v in self._records.items():
                out[k] = {"count": v.count, "total_bytes": v.total_bytes}
                if v.seconds:
                    out[k]["seconds"] = v.seconds
            return out


comms_logger = CommsLogger()


def get_comms_logger() -> CommsLogger:
    return comms_logger
