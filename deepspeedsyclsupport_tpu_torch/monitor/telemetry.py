"""Structured observability, the serving plane's part: metrics registry,
event-name registry, flight recorder, heartbeat and Prometheus textfiles.

Port of the serving-plane subset of ``deepspeedsyclsupport_tpu/monitor/
telemetry.py`` (host-only Python, copied statement for statement):

* :class:`ResilienceCounters` — process-wide degradation counters;
* the event-name registry (``EVENT_NAMES``, ``check_events``): every
  ``Serve/*`` name the serving session emits is declared, and strict mode
  (``DSTPU_STRICT_EVENTS=1``) raises on an undeclared one;
* :class:`Counter`, :class:`Gauge`, :class:`Histogram` and the process-wide
  :data:`metrics_registry`;
* :class:`FlightRecorder` — the bounded record ring the request journal
  streams through;
* :class:`Heartbeat` — the freshness file the elastic agent and the
  replica supervisor watch;
* :func:`render_prometheus` / :func:`export_metrics_textfile`;
* :data:`DURATION_BUCKETS_S` and :func:`histogram_quantile` (in the JAX
  package they live in ``monitor/pod.py``).

Not ported yet (ROADMAP.md A.3.4): the compile listener, the goodput
accounter and the training ``Telemetry`` facade.
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

#: MFU attribution regions of the JAX package's ``monitor/mfu.py`` (scope
#: regions, then derived ones): the ``MFU/region.*`` and
#: ``Health/grad_norm.*`` families below are enumerated from them, so the
#: port's registry declares exactly the JAX package's names.
MFU_REGIONS = ("embed", "attn", "mlp", "head", "loss", "optimizer",
               "collective", "other", "host")

# Fixed duration buckets (seconds) shared by every histogram; a copy of the
# JAX package's monitor/pod.py ones.
DURATION_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                      5.0, 10.0, 30.0, 60.0, 120.0)


def histogram_quantile(buckets: Tuple[float, ...], counts: List[int],
                       total: int, q: float) -> Optional[float]:
    """Quantile estimate over Prometheus-style fixed buckets (``counts`` has
    one overflow slot past the last edge): linear interpolation inside the
    bucket the target observation falls in; resolution is the bucket width;
    a target landing in the overflow bucket returns the highest finite
    edge. Shared by ``telemetry.Histogram`` and the offline skew table."""
    if total <= 0 or not 0.0 < q <= 1.0:
        return None
    target = q * total
    cum = 0.0
    for i, edge in enumerate(buckets):
        prev_cum, cum = cum, cum + counts[i]
        if cum >= target:
            lo = buckets[i - 1] if i > 0 else 0.0
            frac = (target - prev_cum) / max(counts[i], 1)
            return lo + (edge - lo) * frac
    return buckets[-1] if buckets else None


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

