"""Structured observability spine: metrics registry + flight recorder +
goodput, and the training ``Telemetry`` facade the engine holds.

Port of ``deepspeedsyclsupport_tpu/monitor/telemetry.py`` (host-only
Python, copied statement for statement where the JAX package's code is
host code):

* :class:`ResilienceCounters` — process-wide degradation counters;
* the event-name registry (``EVENT_NAMES``, ``check_events``): every event
  name the engine and the serving plane emit is declared, and strict mode
  (``DSTPU_STRICT_EVENTS=1``) raises on an undeclared one;
* :class:`Counter`, :class:`Gauge`, :class:`Histogram` and the process-wide
  :data:`metrics_registry`;
* :class:`FlightRecorder` — the bounded record ring that streams to a
  rank-local JSONL sink and is dumped on crash / SIGTERM;
* :class:`GoodputAccounter` — wall-clock attributed to productive step
  time vs checkpoint, compile, rollback, startup and the residual;
* :class:`Heartbeat` — the freshness file the elastic agent and the
  replica supervisor watch; :func:`install_hang_dump`;
* :class:`Telemetry` / :func:`build_telemetry` — the engine's wiring: step
  spans, goodput, heartbeat, memory gauges (``torch.cuda.memory_stats``
  of the engine's card; none on the CPU, where they read 0 as the JAX
  package's CPU backend reports), checkpoint spans, the sentinel's
  ``Health/*`` ledger, the barrier-anchored ``align/anchor`` records the
  pod report aligns ranks by, Prometheus textfiles.

Where the port differs by design: an eager step compiles nothing, so
there is no counterpart of the JAX compile listener — :func:`compile_stats`
reads 0, ``Compile/*`` events read 0 and the goodput ``compile`` bucket
stays 0. ``Offload/*`` waits for the offload pipeline (ROADMAP.md A.3.2).
"""
import contextlib
import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils.logging import logger
# request-lifecycle stage registry for the Serve/stage.* / Fleet/stage.*
# families lives in the stdlib-only reqtrace module (telemetry imports from
# it, never the reverse)
from .reqtrace import (FLEET_STAGES as REQTRACE_FLEET_STAGES,
                       SERVE_STAGES as REQTRACE_SERVE_STAGES,
                       STAGE_HISTOGRAMS as REQTRACE_STAGE_HISTOGRAMS)

Event = Tuple[str, Any, int]

# shared fixed-bucket helpers live in the stdlib-only pod module, the MFU
# region registry in the stdlib-only mfu module (telemetry imports from
# them, never the reverse)
from .mfu import REGIONS as MFU_REGIONS
from .pod import DURATION_BUCKETS_S, histogram_quantile  # noqa: F401


# =========================================================================
# Resilience counters (moved here from monitor/monitor.py — the degradation
# counters are one island this module unifies; monitor.py re-exports them
# for backwards compatibility).
# =========================================================================


class ResilienceCounters:
    """Process-wide degradation counters (operators must *see* retries,
    fallback loads, emergency saves and restarts instead of discovering them
    at recovery time). Incremented by the checkpoint writers, the preemption
    handler and the elastic agent; the engine surfaces changed counters as
    ``Resilience/*`` monitor events at its print boundaries."""

    NAMES = ("io_retries", "io_giveups", "corrupt_tags_skipped",
             "fallback_loads", "emergency_saves", "preemptions",
             "staging_sweeps", "staging_promotions", "checkpoints_rotated",
             "restarts", "hang_restarts",
             # pod fault tolerance: two-phase commit protocol,
             # collective-hang watchdog (rc 218) and the elastic agent's
             # prompt sibling teardown — per-cause, so operators can tell a
             # flaky interconnect from a preemption storm at a glance
             "pod_commits", "torn_pod_quarantined", "comm_hang_aborts",
             "comm_hang_restarts", "pod_teardowns",
             # serving-plane fault tolerance: the stuck-decode
             # watchdog's rc-219 aborts and the supervisor's per-cause
             # restart class for them (inference/v2/supervisor.py)
             "serve_hang_aborts", "serve_hang_restarts",
             # training-health sentinel (runtime/sentinel.py): batches whose
             # update the sentinel discarded (spike/NaN gate or fp16
             # overflow — one unified ledger), rollbacks to the promoted
             # last-good tag, and the elastic agent's per-cause restart
             # class for rc-220 divergence aborts
             "skipped_batches", "rollbacks", "divergence_restarts")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = dict.fromkeys(self.NAMES, 0)

    def incr(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            return self._counts[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(self.NAMES, 0)


resilience_counters = ResilienceCounters()

# =========================================================================
# Event-name registry
# =========================================================================

#: ``Group/name`` convention: slash-separated segments of word chars / dots /
#: dashes, at least two segments. ``Train/Samples/train_loss`` ✓, ``loss`` ✗.
EVENT_NAME_RE = re.compile(r"^[A-Za-z0-9][\w.\-]*(/[\w.\-]+)+$")

#: Exact declared event names. Anything the engine emits through
#: ``MonitorMaster`` must appear here (or match a family prefix below) —
#: the tier-1 guard test runs with strict mode on, so a typo'd name raises
#: instead of silently forking a new CSV file.
EVENT_NAMES = frozenset(
    {"Train/Samples/train_loss", "Train/Samples/lr",
     "Train/Samples/loss_scale",
     "Goodput/productive_s", "Goodput/checkpoint_s", "Goodput/compile_s",
     "Goodput/offload_stall_s", "Goodput/rollback_s", "Goodput/startup_s",
     "Goodput/other_s", "Goodput/total_s", "Goodput/productive_frac",
     # hierarchical offload pipeline (runtime/multihost_offload.py +
     # offload_pipeline.py; docs/offload.md): per-direction bytes and
     # effective bandwidth, host fp32-Adam seconds, exposed transfer
     # stall, and the derived overlap efficiency (1 − exposed/total)
     "Offload/d2h_bytes", "Offload/h2d_bytes", "Offload/nvme_read_bytes",
     "Offload/nvme_write_bytes", "Offload/d2h_gbps", "Offload/h2d_gbps",
     "Offload/nvme_read_gbps", "Offload/host_compute_s", "Offload/stall_s",
     "Offload/overlap_efficiency",
     "Memory/bytes_in_use", "Memory/peak_bytes_in_use",
     "Compile/count", "Compile/total_s",
     "Ckpt/save_s", "Ckpt/bytes_written",
     # two-phase all-ranks commit (checkpoint/engine.py::pod_commit):
     # cumulative seconds spent in phase-1 manifest writes + the
     # cross-process barrier + the rank-0 commit-record write
     "Ckpt/pod_commit_s",
     # SLA serving policy (inference/v2/serving.py — admission gate,
     # slack scheduler, KV-pressure eviction; docs/serving.md): queue
     # depth / KV-pool occupancy / live-stream gauges, admission outcome
     # counters, and TTFT/ITL latency histograms
     "Serve/queue_depth", "Serve/kv_occupancy", "Serve/live_seqs",
     "Serve/admitted", "Serve/queued", "Serve/shed", "Serve/evicted",
     "Serve/completed", "Serve/ttft_s", "Serve/itl_s",
     # serving-plane recovery (inference/v2/supervisor.py — request
     # journal replay after an engine crash, stuck-decode rc-219 aborts;
     # dot-tail convention like Pod/comm_hang.* so the static event-name
     # lint resolves literals): counters + the time-to-recover histogram
     "Serve/recovery.replays", "Serve/recovery.replay_sheds",
     "Serve/recovery.serve_hang_aborts",
     "Serve/recovery.time_to_recover_s",
     # cross-request KV prefix cache (inference/v2/prefix_cache.py;
     # docs/serving.md "prefix reuse", semantics in docs/observability.md):
     # admission-probe hit/miss counters, prefill tokens skipped, physical
     # blocks mapped into more than one block table, copy-on-write
     # unshares, plus the hit-ratio / pinned-block gauges
     "Serve/prefix.hits", "Serve/prefix.misses",
     "Serve/prefix.tokens_saved", "Serve/prefix.blocks_shared",
     "Serve/prefix.cow_copies", "Serve/prefix.hit_ratio",
     "Serve/prefix.pinned_blocks",
     # serving fleet control plane (inference/v2/fleet — router edge
     # admission, affinity placement, journal-based cross-replica
     # failover; docs/serving.md "fleet control plane"): routed/shed/
     # completed counters, failover accounting, rotation gauges and the
     # routed-TTFT histogram. Per-replica members (live/queued per
     # replica id) are data-dependent and ride the Fleet/replica. prefix.
     "Fleet/routed", "Fleet/shed", "Fleet/completed", "Fleet/affinity_hits",
     "Fleet/failover.deaths", "Fleet/failover.replays",
     "Fleet/failover.replay_sheds",
     "Fleet/replicas_ready", "Fleet/inflight", "Fleet/routed_ttft_s",
     # MFU ledger (monitor/mfu.py + analysis/roofline.py; docs/
     # observability.md "MFU ledger"): achieved MFU vs the roofline bound,
     # the measured clean-step wall + device-busy split, and analytic step
     # FLOPs. Per-region measured seconds ride the dot-tail convention
     # (MFU/region.attn) and are enumerated from the region registry below
     # so the static event-name lint resolves every literal — a typo'd
     # region name fails dslint, not strict mode at runtime.
     "MFU/achieved", "MFU/roofline_bound", "MFU/step_s",
     "MFU/device_busy_s", "MFU/model_tflops",
     # training-health sentinel (runtime/sentinel.py; docs/resilience.md
     # "numerical faults"): robust z-scores of the loss / global grad-norm
     # history, the run-cumulative nonfinite-gradient element count, ladder
     # action counts (warn → skip → rollback → abort) and the current
     # anomaly streak. The per-region grad-norm breakdown is named to the
     # SAME region registry the MFU ledger uses, enumerated below so the
     # static event-name lint resolves every member.
     "Health/loss_z", "Health/grad_norm_z", "Health/nonfinite_count",
     "Health/warns", "Health/skips", "Health/rollbacks", "Health/aborts",
     "Health/anomaly_streak",
     # request-time attribution (monitor/reqtrace.py; docs/observability.md
     # "request-time attribution"): the admission→first-prefill-dispatch
     # queue-wait histogram and the sliding-window SLO burn gauges — the
     # fraction of first tokens missing their per-request TTFT SLA, the
     # fraction of arrivals shed, and miss_frac/error_budget burn rates.
     # Per-stage counters/histograms are enumerated from the reqtrace stage
     # registry below (the MFU-region pattern: a typo'd stage fails dslint's
     # undeclared-stage-name rule, not strict mode at runtime).
     "Serve/queue_wait_s",
     "Serve/slo.ttft_miss_frac", "Serve/slo.shed_frac", "Serve/slo.burn_rate",
     "Fleet/slo.ttft_miss_frac", "Fleet/slo.shed_frac", "Fleet/slo.burn_rate"}
    | {f"MFU/region.{r}" for r in MFU_REGIONS}
    | {f"Health/grad_norm.{r}" for r in MFU_REGIONS}
    | {f"Serve/stage.{s}" for s in REQTRACE_SERVE_STAGES}
    | {f"Fleet/stage.{s}" for s in REQTRACE_FLEET_STAGES}
    | {f"Serve/stage.{s}_s" for s in REQTRACE_STAGE_HISTOGRAMS}
    | {f"Serve/stage.{s}_s/{q}" for s in REQTRACE_STAGE_HISTOGRAMS
       for q in ("p50", "p95", "p99")}
    | {f"Serve/{h}/{q}" for h in ("ttft_s", "itl_s", "queue_wait_s",
                                  "recovery.time_to_recover_s")
       for q in ("p50", "p95", "p99")}
    | {f"Fleet/{h}/{q}" for h in ("routed_ttft_s",)
       for q in ("p50", "p95", "p99")}
    | {f"Resilience/{n}" for n in ResilienceCounters.NAMES})

#: Families whose member names are data-dependent (collective op mix, user
#: extensions, pod-scope aggregates whose per-class / per-rank member names
#: depend on the parallelism layout — see ``monitor/pod.py``; per-replica
#: fleet gauges keyed by replica id — ``inference/v2/fleet/router.py``). A
#: prefix declares the whole family.
EVENT_PREFIXES = ("Comm/", "Custom/", "Pod/", "Fleet/replica.")

_extra_event_names: set = set()
_warned_names: set = set()


class UndeclaredEventError(ValueError):
    """An event name violating the convention / registry under strict mode."""


def declare_events(names: Iterable[str]) -> None:
    """Register additional exact event names (user extensions). Names must
    already match the ``Group/name`` convention."""
    for name in names:
        if not EVENT_NAME_RE.match(name):
            raise UndeclaredEventError(
                f"event name {name!r} does not match the Group/name "
                f"convention ({EVENT_NAME_RE.pattern})")
        _extra_event_names.add(name)


def is_declared(name: str) -> bool:
    if not EVENT_NAME_RE.match(name):
        return False
    if name in EVENT_NAMES or name in _extra_event_names:
        return True
    return any(name.startswith(p) for p in EVENT_PREFIXES)


def events_strict() -> bool:
    """Strict mode: undeclared names raise instead of warn. On under pytest
    (tests/conftest.py sets ``DSTPU_STRICT_EVENTS=1``) and for any operator
    who exports it."""
    return os.environ.get("DSTPU_STRICT_EVENTS", "0").lower() in ("1", "true")


def check_events(events: List[Event]) -> List[Event]:
    """Validate event names against the registry. Strict mode raises
    :class:`UndeclaredEventError`; otherwise undeclared names warn once and
    pass through (operators keep their data, CI keeps its guard)."""
    for name, _value, _step in events:
        if is_declared(name):
            continue
        msg = (f"event name {name!r} is not declared in "
               f"monitor.telemetry.EVENT_NAMES / EVENT_PREFIXES (or violates "
               f"the Group/name convention); declare it via "
               f"declare_events([...])")
        if events_strict():
            raise UndeclaredEventError(msg)
        if name not in _warned_names:
            _warned_names.add(name)
            logger.warning(msg)
    return events


# =========================================================================
# Metrics registry
# =========================================================================


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def incr(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("name", "_value", "_t")

    def __init__(self, name: str):
        self.name = name
        self._value: float = 0.0
        self._t: float = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)
        # wall timestamp (when was this gauge last set), not a duration
        self._t = time.time()

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative-le buckets)."""

    __slots__ = ("name", "buckets", "counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Tuple[float, ...] = DURATION_BUCKETS_S):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +inf overflow bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"buckets": list(self.buckets), "counts": list(self.counts),
                    "sum": self._sum, "count": self._count}

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q ≤ 1) from the fixed buckets: linear
        interpolation inside the bucket the target observation falls in.
        Resolution is the bucket width; an estimate landing in the +inf
        overflow bucket returns the highest finite edge (a floor, flagged by
        callers that care). ``None`` with no observations."""
        with self._lock:
            counts, total = list(self.counts), self._count
        return histogram_quantile(self.buckets, counts, total, q)

    def quantiles(self, qs: Iterable[float] = (0.5, 0.95, 0.99)
                  ) -> Dict[str, Optional[float]]:
        """{"p50": …, "p95": …, "p99": …} estimates (see :meth:`quantile`)."""
        return {f"p{int(round(q * 100))}": self.quantile(q) for q in qs}


class MetricsRegistry:
    """Process-wide named metrics. Creation is idempotent; the hot path is a
    dict lookup + a lock-free-ish update on the metric object itself."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DURATION_BUCKETS_S) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, buckets)
            return self._histograms[name]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.snapshot()
                               for n, h in self._histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: Process-wide registry (the analog of ``resilience_counters`` for general
#: metrics; checkpoint writers and the engine feed it).
metrics_registry = MetricsRegistry()


# =========================================================================
# Flight recorder
# =========================================================================


class FlightRecorder:
    """Bounded ring of structured telemetry records.

    Every record is appended to an in-memory deque (``capacity`` newest
    records survive) and forwarded to any attached sinks (the rank-local
    JSONL writer). ``dump()`` force-flushes the sinks — wired into the
    preemption handler so the last steps before a SIGTERM are on disk."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._lock = threading.Lock()
        self._sinks: List[Tuple[Callable[[Dict[str, Any]], None],
                                Optional[Callable[[], None]]]] = []

    def add_sink(self, write_record: Callable[[Dict[str, Any]], None],
                 flush: Optional[Callable[[], None]] = None) -> None:
        """Register a per-record writer and (optionally) the flush that
        :meth:`dump` must call to force its buffer onto disk — explicit, so
        plain-function sinks don't silently lose their tail on a crash."""
        self._sinks.append((write_record, flush))

    # ------------------------------------------------------------- recording
    def record(self, kind: str, name: str, step: Optional[int] = None,
               dur: Optional[float] = None, value: Any = None,
               data: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        # "t" is an epoch timestamp for offline correlation across ranks —
        # wall clock by design; durations ("dur") come from perf_counter
        rec: Dict[str, Any] = {"kind": kind, "name": name,
                               "t": time.time()}
        if step is not None:
            rec["step"] = int(step)
        if dur is not None:
            rec["dur"] = float(dur)
        if value is not None:
            rec["value"] = value
        if data:
            rec["data"] = data
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            sinks = tuple(self._sinks)
        for write, _flush in sinks:
            try:
                write(rec)
            except Exception as e:  # telemetry must never kill training
                logger.warning("flight-recorder sink failed: %s", e)
        return rec

    def event(self, name: str, step: Optional[int] = None, **data) -> Dict[str, Any]:
        return self.record("event", name, step=step, data=data or None)

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int] = None,
             data: Optional[Dict[str, Any]] = None):
        """Measure a region; the record lands on exit with its duration."""
        t0 = time.perf_counter()
        extra: Dict[str, Any] = dict(data or {})
        try:
            yield extra
        finally:
            self.record("span", name, step=step,
                        dur=time.perf_counter() - t0, data=extra or None)

    # ------------------------------------------------------------- inspection
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, reason: str = "manual") -> List[Dict[str, Any]]:
        """Record a dump marker (with the metrics-registry snapshot inlined)
        and force-flush every sink. Returns the ring contents."""
        self.record("dump", "flight_recorder/dump",
                    data={"reason": reason,
                          "metrics": metrics_registry.snapshot(),
                          "resilience": resilience_counters.snapshot()})
        for _write, flush in tuple(self._sinks):
            if flush is None:
                continue
            try:
                flush()
            except Exception as e:
                logger.warning("flight-recorder dump flush failed: %s", e)
        return self.snapshot()


# Active recorder: the seam through which re-pointed islands
# (``utils/timer.py`` spans, checkpoint writers) reach the current engine's
# recorder without holding a reference. Last telemetry constructed wins.
_active_recorder: Optional[FlightRecorder] = None


def set_active_recorder(rec: Optional[FlightRecorder]) -> None:
    global _active_recorder
    _active_recorder = rec


def get_active_recorder() -> Optional[FlightRecorder]:
    return _active_recorder


# =========================================================================
# Recompiles
# =========================================================================


def compile_stats() -> Tuple[int, float]:
    """(total executable compiles, total compile wall-seconds) so far:
    always ``(0, 0.0)`` — an eager step builds no executable (the JAX
    package counts ``jax.monitoring`` compile events here). Kept so the
    ``Compile/*`` events and the goodput ``compile`` bucket exist, at 0."""
    return 0, 0.0


def _tree_items(tree: Any, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _tree_items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, path + (str(i),))
    else:
        yield path, tree


def tree_shapes(tree: Any) -> Dict[str, str]:
    """Flat ``leaf-path -> shape/dtype`` map for arg-shape diffing (dtypes
    by their numpy names: ``(4, 32):int32``)."""
    out = {}
    for path, leaf in _tree_items(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = getattr(leaf, "dtype", type(leaf).__name__)
        out["/".join(path)] = \
            f"{shape}:{str(dtype).replace('torch.', '')}"
    return out


def shape_diff(old: Optional[Dict[str, str]],
               new: Dict[str, str]) -> Dict[str, Any]:
    """What changed between two shape maps — the offending diff logged with a
    recompile event."""
    if old is None:
        return {"initial": True}
    changed = {k: {"was": old[k], "now": v}
               for k, v in new.items() if k in old and old[k] != v}
    added = sorted(set(new) - set(old))
    removed = sorted(set(old) - set(new))
    out: Dict[str, Any] = {}
    if changed:
        out["changed"] = changed
    if added:
        out["added"] = added
    if removed:
        out["removed"] = removed
    return out or {"identical_shapes": True}


# =========================================================================
# Goodput accounting
# =========================================================================


class GoodputAccounter:
    """Attribute wall-clock since construction to named categories.

    ``other`` is the residual (total − sum of known categories), so the
    split accounts for 100% of measured wall-clock by construction.
    ``offload_stall`` is the exposed (non-overlapped) transfer wait inside
    offloaded steps — carved OUT of productive. ``rollback`` is the
    sentinel's recovery wall (last-good reload + data fast-forward,
    ``runtime/sentinel.py``) — carved out for the same reason: it is time
    training exists to avoid."""

    CATEGORIES = ("productive", "checkpoint", "compile", "offload_stall",
                  "rollback", "startup", "other")

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._buckets: Dict[str, float] = {c: 0.0 for c in self.CATEGORIES
                                           if c != "other"}
        self._first_step_seen = False

    def account(self, category: str, seconds: float) -> None:
        if seconds < 0:
            return
        with self._lock:
            self._buckets[category] = self._buckets.get(category, 0.0) + seconds

    def mark_first_step(self) -> None:
        """Everything before the first step is startup (process boot, model
        build, checkpoint resume)."""
        with self._lock:
            if self._first_step_seen:
                return
            self._first_step_seen = True
            known = sum(self._buckets.values())
            self._buckets["startup"] = max(
                0.0, (self._clock() - self._t0) - known)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            total = max(1e-9, self._clock() - self._t0)
            buckets = dict(self._buckets)
        known = sum(buckets.values())
        buckets["other"] = max(0.0, total - known)
        buckets["total"] = total
        buckets["productive_frac"] = buckets.get("productive", 0.0) / total
        return buckets

    def events(self, step: int) -> List[Event]:
        s = self.summary()
        ev: List[Event] = [(f"Goodput/{c}_s", s.get(c, 0.0), step)
                           for c in self.CATEGORIES]
        ev.append(("Goodput/total_s", s["total"], step))
        ev.append(("Goodput/productive_frac", s["productive_frac"], step))
        return ev


# =========================================================================
# Heartbeat
# =========================================================================


class Heartbeat:
    """Per-rank freshness file: ``{"t", "step", "pid"}``, rewritten atomically
    at most every ``interval_s``. The elastic agent compares the recorded
    wall time against its clock to tell a hung worker from a slow one."""

    def __init__(self, path: str, interval_s: float = 1.0,
                 clock: Callable[[], float] = time.time):
        self.path = path
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last: Optional[float] = None  # first beat always writes
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, force: bool = False) -> bool:
        now = self._clock()
        if not force and self._last is not None \
                and now - self._last < self.interval_s:
            return False
        self._last = now
        tmp = f"{self.path}.tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"t": now, "step": int(step), "pid": os.getpid()}, f)
            os.replace(tmp, self.path)
        except OSError as e:  # heartbeat failure must never kill training
            logger.warning("heartbeat write failed: %s", e)
            return False
        return True

    @staticmethod
    def read(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def age(path: str, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the last beat, or None if unreadable."""
        hb = Heartbeat.read(path)
        if hb is None or "t" not in hb:
            return None
        # cross-PROCESS freshness: the beat's "t" is another process's wall
        # clock, so the comparison clock must be wall too (same host)
        return (now if now is not None
                else time.time()) - float(hb["t"])


# =========================================================================
# Prometheus textfile rendering (export_textfile)
# =========================================================================

_PROM_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    """Metric-registry name → Prometheus metric name (``Serve/ttft_s`` →
    ``dstpu_Serve_ttft_s``)."""
    out = _PROM_BAD_CHARS.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return f"dstpu_{out}"


def render_prometheus(snapshot: Dict[str, Any],
                      labels: Optional[Dict[str, str]] = None) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` (plus any extra scalar maps
    merged into its ``counters``/``gauges``) as Prometheus text exposition
    format — the textfile-collector contract: a node exporter (or any
    scraper) reads the file, so long multi-host runs are observable without
    ever parsing JSONL."""
    label_str = ""
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        label_str = "{" + inner + "}"
    lines: List[str] = []
    for name, value in sorted(snapshot.get("counters", {}).items()):
        pname = prometheus_name(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname}{label_str} {value}")
    for name, value in sorted(snapshot.get("gauges", {}).items()):
        pname = prometheus_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname}{label_str} {value}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        pname = prometheus_name(name)
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for edge, count in zip(h["buckets"], h["counts"]):
            cum += count
            le = ("{" + (label_str[1:-1] + "," if label_str else "")
                  + f'le="{edge}"' + "}")
            lines.append(f"{pname}_bucket{le} {cum}")
        cum += h["counts"][-1]
        le_inf = ("{" + (label_str[1:-1] + "," if label_str else "")
                  + 'le="+Inf"' + "}")
        lines.append(f"{pname}_bucket{le_inf} {cum}")
        lines.append(f"{pname}_sum{label_str} {h['sum']}")
        lines.append(f"{pname}_count{label_str} {h['count']}")
    return "\n".join(lines) + "\n"


def export_metrics_textfile(path: str, snapshot: Dict[str, Any],
                            labels: Optional[Dict[str, str]] = None,
                            extra_counters: Optional[Dict[str, Any]] = None
                            ) -> str:
    """Write one registry snapshot as a Prometheus textfile-collector file
    with the atomic-rename contract (write ``<path>.tmp<pid>``, then
    ``os.replace`` — a scraper never observes a torn file). The single
    implementation behind :meth:`Telemetry.export_textfile` (training,
    rank-labelled) and the serving plane (``serve_worker`` per-replica
    journals dir, ``FleetRouter`` beside its stream) so both sides share
    one cumulative-bucket/labeling contract. Failure is a warning, never
    fatal — export must not kill the workload."""
    if extra_counters:
        snapshot = {**snapshot,
                    "counters": {**snapshot.get("counters", {}),
                                 **extra_counters}}
    text = render_prometheus(snapshot, labels=labels)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except OSError as e:  # export failure must never kill the workload
        logger.warning("textfile export failed: %s", e)
    return path



_anchor_lock = threading.Lock()
_anchor_counter = 0


def _next_anchor_seq() -> int:
    """Process-global anchor epoch counter: two anchored engines in one
    process must stamp DISTINCT sync epochs or their step spans would
    collide on the pod aggregator's (sync, step) fusion keys. Ranks stay in
    lockstep because :meth:`Telemetry.anchor` is a collective — every rank
    performs the same anchor calls in the same order."""
    global _anchor_counter
    with _anchor_lock:
        _anchor_counter += 1
        return _anchor_counter


_faulthandler_installed = False


def install_hang_dump(stack_path: str) -> bool:
    """Register ``faulthandler`` on SIGUSR1 so the elastic agent can demand a
    stack dump from a hung worker before restarting it. Idempotent; returns
    whether the handler is (now) installed."""
    global _faulthandler_installed
    if _faulthandler_installed:
        return True
    import faulthandler
    import signal

    if not hasattr(signal, "SIGUSR1"):  # pragma: no cover - non-posix
        return False
    try:
        os.makedirs(os.path.dirname(stack_path) or ".", exist_ok=True)
        f = open(stack_path, "a")
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True)
    except (OSError, ValueError, RuntimeError) as e:  # pragma: no cover
        logger.warning("faulthandler hang-dump unavailable: %s", e)
        return False
    _faulthandler_installed = True
    return True


def memory_stats(device: Any = None) -> Dict[str, int]:
    """``{"bytes_in_use", "peak_bytes_in_use"}`` of a CUDA device from
    ``torch.cuda.memory_stats`` (the caching allocator's allocated bytes,
    now and at peak); ``{}`` for the CPU or no device."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0))}


# =========================================================================
# Telemetry facade (what the engine holds)
# =========================================================================


class Telemetry:
    """Everything observability, wired together for one engine.

    The engine calls :meth:`on_step_end` after every ``train_batch``,
    :meth:`ckpt_span` around checkpoint saves, and the preemption handler
    calls :meth:`dump` before the process dies. ``device`` is the engine's
    (its memory gauges). :meth:`close` stops the watchdog's poll thread and
    drops the ring's process-wide references."""

    def __init__(self, cfg: Any, jsonl: Any = None, rank: int = 0,
                 device: Any = None):
        self.cfg = cfg
        self.rank = rank
        self.device = device
        self.recorder = FlightRecorder(capacity=cfg.ring_size)
        self.registry = metrics_registry
        self.goodput = GoodputAccounter() if cfg.goodput_enabled else None
        self.jsonl = jsonl
        self._closed = False
        self._last_shapes: Optional[Dict[str, str]] = None
        self._compile_base = (0, 0.0)
        self._last_memory_step = -1
        self._last_step_end: Optional[float] = None
        self._step_hist = self.registry.histogram("step_time_s")
        # run-cumulative health-sentinel ledger (record_health); the
        # Health/* periodic events are derived from it
        self._health_totals: Dict[str, Any] = {}
        # latest anchor epoch THIS telemetry stamped on its step spans; the
        # counter behind it is process-global (_next_anchor_seq) so two
        # anchored engines in one process get distinct epochs
        self._anchor_seq = 0
        self._last_textfile: Optional[float] = None
        # the engine parks its CollectiveWatchdog (comm/watchdog.py) here
        # so close() stops the poll thread
        self.watchdog: Any = None
        self.heartbeat: Optional[Heartbeat] = None
        if cfg.heartbeat_enabled:
            self.heartbeat = Heartbeat(
                os.path.join(cfg.output_dir, f"heartbeat_rank{rank}.json"),
                interval_s=cfg.heartbeat_interval_s)
            if cfg.stack_dump_on_hang:
                install_hang_dump(
                    os.path.join(cfg.output_dir, f"stacks_rank{rank}.txt"))
        self._compile_base = compile_stats()
        if jsonl is not None and hasattr(jsonl, "attach_recorder"):
            jsonl.attach_recorder(self.recorder)
        self.recorder.record(
            "meta", "flight_recorder/start",
            data={"rank": rank, "pid": os.getpid(), "version": 1,
                  "ring_size": cfg.ring_size})
        set_active_recorder(self.recorder)
        import atexit

        atexit.register(self.close)

    # ------------------------------------------------------------- step path
    def on_step_end(self, step: int, dur: Optional[float] = None,
                    batch: Any = None) -> None:
        """Per-step accounting: step span into the ring, duration histogram,
        goodput, heartbeat, Prometheus textfile and periodic memory gauges.

        ``dur`` is the caller-measured step wall; ``None`` (the eager
        ``forward/backward/step`` path) falls back to boundary-to-boundary
        timing. Either way this is HOST wall-clock: the card's queue runs
        behind the host, and its wait lands at the next sync. Set
        ``telemetry.sync_timing`` for device-accurate per-step spans at the
        cost of the host / device overlap."""
        now = time.perf_counter()
        if dur is None:
            dur = (now - self._last_step_end
                   if self._last_step_end is not None else 0.0)
        self._last_step_end = now
        count, seconds = compile_stats()
        d_count = count - self._compile_base[0]
        d_seconds = seconds - self._compile_base[1]
        self._compile_base = (count, seconds)
        span_data: Optional[Dict[str, Any]] = None
        if d_count > 0:
            self.registry.counter("recompiles").incr(d_count)
            new_shapes = tree_shapes(batch) if batch is not None else {}
            diff = shape_diff(self._last_shapes, new_shapes)
            self._last_shapes = new_shapes
            self.recorder.record("event", "compile/train_step", step=step,
                                 dur=d_seconds,
                                 data={"compiles": d_count,
                                       "shape_diff": diff})
            span_data = {"compiles": d_count, "compile_s": d_seconds}
        elif batch is not None and self._last_shapes is None:
            self._last_shapes = tree_shapes(batch)
        if self._anchor_seq:
            # barrier-anchored alignment epoch: lets the pod aggregator
            # (monitor/pod.py) fuse step N of THIS run across ranks without
            # confusing it with step N of a previous incarnation in the same
            # appended JSONL
            span_data = {**(span_data or {}), "sync": self._anchor_seq}
        self.recorder.record("span", "step", step=step, dur=dur,
                             data=span_data)
        self._step_hist.observe(dur)
        if self.goodput is not None:
            # account this step BEFORE marking first-step: startup is the
            # residual of everything before it
            compile_s = min(d_seconds, dur)
            self.goodput.account("compile", compile_s)
            self.goodput.account("productive", max(0.0, dur - compile_s))
            self.goodput.mark_first_step()
        if self.heartbeat is not None:
            self.heartbeat.beat(step)
        if self.cfg.textfile_enabled:
            # heartbeat-cadence Prometheus snapshot: long multi-host runs
            # are scraped off this file without anyone tailing JSONL
            tnow = time.perf_counter()
            if self._last_textfile is None or \
                    tnow - self._last_textfile >= self.cfg.textfile_interval_s:
                self._last_textfile = tnow
                self.export_textfile()
        interval = self.cfg.memory_interval_steps
        if interval > 0 and step - self._last_memory_step >= interval:
            self._last_memory_step = step
            self.sample_memory(step)

    def sample_memory(self, step: int) -> Dict[str, int]:
        try:
            stats = memory_stats(self.device)
        except Exception as e:  # pragma: no cover - backend dependent
            logger.warning("memory_stats unavailable: %s", e)
            return {}
        in_use = int(stats.get("bytes_in_use", 0))
        peak = int(stats.get("peak_bytes_in_use", 0))
        self.registry.gauge("hbm_bytes_in_use").set(in_use)
        self.registry.gauge("hbm_peak_bytes_in_use").set(peak)
        self.recorder.record("gauge", "memory/hbm", step=step,
                             data={"bytes_in_use": in_use,
                                   "peak_bytes_in_use": peak})
        return {"bytes_in_use": in_use, "peak_bytes_in_use": peak}

    @contextlib.contextmanager
    def ckpt_span(self, what: str = "save", step: int = 0):
        """Wraps checkpoint saves: a ``ckpt`` span in the ring + goodput's
        checkpoint bucket. Forces heartbeats at entry/exit so a long save
        doesn't read as a silent gap — but a save longer than the agent's
        ``heartbeat_timeout`` will still be declared hung: size the timeout
        to cover the worst-case checkpoint, not just a step."""
        if self.heartbeat is not None:
            self.heartbeat.beat(step, force=True)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self.recorder.record("span", f"ckpt/{what}", dur=dur)
            self.registry.histogram("ckpt_save_s").observe(dur)
            if self.goodput is not None:
                self.goodput.account("checkpoint", dur)
            if self.heartbeat is not None:
                self.heartbeat.beat(step, force=True)

    # ----------------------------------------------------- pod-scope hooks
    def anchor(self, tag: str = "start") -> int:
        """Record a barrier-anchored alignment point for cross-rank trace
        fusion (``monitor/pod.py``).

        Under a process group every rank calls this together (the engine
        does, at construction — a collective contract like any barrier):
        after ``torch.distributed.barrier()`` all ranks stamp the same
        physical instant through their own wall clocks, which the pod
        aggregator subtracts to recover per-rank clock offsets. Subsequent
        step spans carry the anchor sequence id (``data.sync``) so steps
        fuse within one anchored epoch only."""
        import torch.distributed as dist

        seq = _next_anchor_seq()
        synced = True
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            try:
                dist.barrier()
            except Exception as e:  # pragma: no cover - backend dependent
                # the epoch marker is still valid (step spans need it to
                # separate epochs) but its timestamp is NOT a shared
                # instant — flag it so the pod aggregator falls back to
                # step-boundary alignment instead of trusting a fake offset
                logger.warning("pod anchor barrier unavailable (%s); "
                               "recording unsynchronized anchor", e)
                synced = False
        self._anchor_seq = seq
        self.recorder.record("meta", "align/anchor",
                             data={"anchor": seq, "tag": tag,
                                   "synced": synced})
        return seq

    def record_health(self, step: int, data: Dict[str, Any]) -> None:
        """Persist one sentinel observation/decision (``runtime/sentinel.py``
        verdict shape: cause, z-scores, nonfinite count, action taken,
        per-region grad norms) as a ``health/step`` record and fold it into
        the run-cumulative ledger behind the ``Health/*`` periodic events."""
        self.recorder.record("event", "health/step", step=step,
                             data=dict(data))
        t = self._health_totals
        action = data.get("action")
        if action in ("warn", "skip", "rollback", "abort"):
            key = action + "s"
            t[key] = int(t.get(key, 0)) + 1
        t["nonfinite_count"] = (int(t.get("nonfinite_count", 0))
                                + int(data.get("nonfinite", 0) or 0))
        for key in ("loss_z", "grad_norm_z", "streak"):
            if data.get(key) is not None:
                t[f"last_{key}"] = float(data[key])
        for region, norm in (data.get("region_norms") or {}).items():
            t.setdefault("region_norms", {})[region] = float(norm)

    def health_events(self, step: int) -> List[Event]:
        """``Health/*`` scalar events from the cumulative sentinel ledger:
        ladder action counts, last observed robust z-scores, cumulative
        nonfinite gradient elements and the per-region grad-norm breakdown
        (named to the MFU region registry)."""
        t = self._health_totals
        if not t:
            return []
        ev: List[Event] = []
        for action in ("warns", "skips", "rollbacks", "aborts"):
            ev.append((f"Health/{action}", int(t.get(action, 0)), step))
        ev.append(("Health/nonfinite_count",
                   int(t.get("nonfinite_count", 0)), step))
        for key, name in (("last_loss_z", "Health/loss_z"),
                          ("last_grad_norm_z", "Health/grad_norm_z"),
                          ("last_streak", "Health/anomaly_streak")):
            if key in t:
                ev.append((name, t[key], step))
        for region, norm in sorted((t.get("region_norms") or {}).items()):
            ev.append((f"Health/grad_norm.{region}", norm, step))
        return ev

    def record_census(self, census: Dict[str, Any]) -> None:
        """Persist a collective-census class summary
        (``analysis/collectives.py`` ``CollectiveClasses.summary()`` shape,
        plus any context keys) into the stream — the pod report joins it
        against measured step spans for the per-traffic-class bytes/time/
        bandwidth decomposition."""
        self.recorder.record("event", "comm/census", data=census)

    def export_textfile(self, path: Optional[str] = None) -> str:
        """Write the current metrics-registry + resilience-counter state as
        a Prometheus textfile-collector snapshot (atomic rename, scrape-safe)
        and return the path. Called automatically at heartbeat cadence when
        ``telemetry.textfile.enabled`` is set; safe to call manually."""
        path = path or os.path.join(self.cfg.output_dir,
                                    f"metrics_rank{self.rank}.prom")
        return export_metrics_textfile(
            path, self.registry.snapshot(),
            labels={"rank": str(self.rank)},
            extra_counters={f"resilience_{k}": v for k, v in
                            resilience_counters.snapshot().items()})

    # ------------------------------------------------------------ reporting
    def periodic_events(self, step: int) -> List[Event]:
        """Scalar events for MonitorMaster at print boundaries: Goodput/*,
        Memory/*, Compile/*, Ckpt/*, Health/*."""
        ev: List[Event] = []
        if self.goodput is not None:
            ev.extend(self.goodput.events(step))
        snap = self.registry.snapshot()
        g = snap["gauges"]
        if "hbm_bytes_in_use" in g:
            ev.append(("Memory/bytes_in_use", g["hbm_bytes_in_use"], step))
            ev.append(("Memory/peak_bytes_in_use",
                       g["hbm_peak_bytes_in_use"], step))
        count, seconds = compile_stats()
        ev.append(("Compile/count", count, step))
        ev.append(("Compile/total_s", seconds, step))
        if snap["counters"].get("ckpt_bytes_written"):
            ev.append(("Ckpt/bytes_written",
                       snap["counters"]["ckpt_bytes_written"], step))
        ckpt_hist = snap["histograms"].get("ckpt_save_s")
        if ckpt_hist and ckpt_hist["count"]:
            ev.append(("Ckpt/save_s", ckpt_hist["sum"], step))
        commit_hist = snap["histograms"].get("ckpt_pod_commit_s")
        if commit_hist and commit_hist["count"]:
            ev.append(("Ckpt/pod_commit_s", commit_hist["sum"], step))
        ev.extend(self.health_events(step))
        return ev

    def dump(self, reason: str = "manual") -> List[Dict[str, Any]]:
        """Force the ring (and a goodput summary) onto disk — called by the
        preemption handler before the process exits."""
        if self.goodput is not None:
            self.recorder.record("goodput", "goodput/summary",
                                 data=self.goodput.summary())
        try:
            from ..comm.comms_logging import comms_logger

            if comms_logger.enabled:
                self.recorder.record("event", "comm/snapshot",
                                     data=comms_logger.snapshot())
        except Exception:  # pragma: no cover - defensive
            pass
        records = self.recorder.dump(reason)
        if self.jsonl is not None:
            try:
                self.jsonl.flush()
            except Exception as e:
                logger.warning("telemetry dump: jsonl flush failed: %s", e)
        if self.cfg.textfile_enabled:
            # the scrape file must reflect the final state too — a scraper
            # polling a preempted run otherwise reads a stale snapshot
            self.export_textfile()
        return records

    def close(self, reason: str = "shutdown") -> None:
        """Idempotent shutdown: final goodput summary + dump + sink flush,
        and the watchdog's poll thread stopped."""
        if self._closed:
            return
        self._closed = True
        import atexit

        try:  # drop our strong atexit ref so closed telemetries don't pin
            atexit.unregister(self.close)  # their rings for life
        except Exception:  # pragma: no cover - defensive
            pass
        try:
            self.dump(reason)
        finally:
            if self.watchdog is not None:
                try:
                    self.watchdog.stop()
                except Exception:  # pragma: no cover - defensive
                    pass
            if get_active_recorder() is self.recorder:
                set_active_recorder(None)


def build_telemetry(config: Any, monitor: Any,
                    device: Any = None) -> Optional[Telemetry]:
    """Engine-side factory: returns a wired :class:`Telemetry` or ``None``
    when the ``telemetry`` config section is off (and ``DSTPU_TELEMETRY``
    doesn't force it). Ensures a rank-local ``JsonlMonitor`` backend exists
    on the given :class:`~.monitor.MonitorMaster` and attaches the flight
    recorder to it."""
    tcfg = config.telemetry
    forced = os.environ.get("DSTPU_TELEMETRY", "").lower() in ("1", "true")
    if not (tcfg.enabled or forced):
        return None
    from .monitor import JsonlMonitor
    from ..utils.podid import pod_rank

    # pod identity: the torch.distributed rank, or an env-declared pod
    # member's (utils/podid.py), so every rank writes DISTINCT
    # flightrec_rank<N>.jsonl / heartbeat files
    rank = pod_rank()
    jsonl = next((m for m in monitor.monitors
                  if isinstance(m, JsonlMonitor)), None)
    if jsonl is None:
        jsonl = JsonlMonitor(
            path=os.path.join(tcfg.output_dir,
                              f"flightrec_rank{rank}.jsonl"),
            flush_interval=tcfg.flush_interval_records)
        monitor.monitors.append(jsonl)
        monitor.enabled = True
    return Telemetry(tcfg, jsonl=jsonl, rank=rank, device=device)
