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
default. The JAX package's ``record_hlo`` (post-compile XLA collective
summaries) has no counterpart: there is no compiled program to read; its
straggler columns and monitor events come with A.3.4 (observability).
"""
import logging
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional

logger = logging.getLogger(__name__)


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

    def log_summary(self) -> str:
        """The summary table (reference ``log_summary``): each op's count,
        MB and (timed) ms."""
        lines = [f"{'op':<44}{'count':>10}{'total MB':>14}{'ms':>12}"]
        with self._lock:
            for key in sorted(self._records):
                rec = self._records[key]
                lines.append(f"{key:<44}{rec.count:>10}"
                             f"{rec.total_bytes / 2**20:>14.2f}"
                             f"{rec.seconds * 1e3:>12.3f}")
        table = "\n".join(lines)
        logger.info("\n%s", table)
        return table

    def reset(self):
        with self._lock:
            self._records.clear()

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
