"""Pod-scope observability: cross-rank trace fusion + comm/compute split.

Port of ``deepspeedsyclsupport_tpu/monitor/pod.py``, a copy statement for
statement: the rank streams' format (``monitor/telemetry.py``'s flight
recorder JSONL) is the JAX package's, so the same fusion reads either
package's streams. It fuses N rank-local JSONL streams into one cluster
timeline and answers the pod-scale questions: *is this step comm-bound,
which rank is the straggler, and what effective bandwidth did each traffic
class achieve?* The per-class table needs a ``comm/census`` record, which
the port's engine writes with ``Engine.emit_comm_census()``; without one
the report says so and keeps the step, skew and straggler tables. The
census cross-check (``bytes_match``) compares the census with the
``xla::`` keys of a ``comm/snapshot`` record. The port writes those keys
from the same record window as the census (``Engine.xla_comms_summary``),
so in the port's streams it always matches: a report, not a hold.

CLI (the JAX package's ``tools/pod_report.py``: its flags, output and exit
codes; offline, no device)::

    python -m deepspeedsyclsupport_tpu_torch.monitor.pod <dirs|globs|files>

Everything here is OFFLINE: pure JSON/arithmetic over recorded streams —
no device or backend initialization, no live job required — safe on a
login node over files rsynced from a dead run.

Alignment model
---------------
Per-rank record timestamps (``t``) are that host's wall clock; hosts skew.
Two alignment sources, in preference order:

* **anchor** — ``align/anchor`` meta records written by
  ``Telemetry.anchor()`` immediately after a cross-process barrier: every
  rank stamps the same physical instant through its own clock, so
  subtracting anchor timestamps recovers true per-rank clock offsets,
  including any *constant* straggling.
* **step-median** — fallback when no common anchor exists: the median of
  per-rank deltas over shared step-span boundaries. A rank that is
  consistently late is absorbed into its clock offset under this method
  (only per-step *variation* remains visible) — the report says which
  method produced it.

Restart incarnations append to the same JSONL; extraction slices each
stream to its newest ``flight_recorder/start`` marker so a dead
incarnation's trailing steps (and its stale anchor — a different barrier)
never pollute the resumed timeline. Within an incarnation, step spans
carry a barrier-anchored epoch id (``data.sync``) separating multiple
anchored engines in one process.

Decomposition model
-------------------
Per fused step: ``pod_dur`` = slowest rank's measured step wall.
``compute_floor`` is the comm-free compute estimate — caller-provided
(single-chip calibration) or the minimum observed per-rank step duration
(an optimistic floor: the fastest step bounds compute + unavoidable comm).
Then ``exposed_comm = max(0, pod_dur - compute_floor)`` is communication on
the critical path, and ``comm_bound_frac = exposed_comm / pod_dur``.
Exposed time is attributed to traffic classes proportionally to their
static census bytes (the interconnect serves classes at one effective rate
within a step — an approximation, stated in the report), giving per-class
**effective bandwidth** = class bytes moved / attributed time. With a
``link_gbps`` capacity hint, ``overlapped_comm`` = the part of the analytic
transfer time hidden under compute. Class byte totals come straight from
the census join, so they match the static census exactly by construction —
the tier-1 suite asserts this through a real compiled ZeRO-3 step.
"""
import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# DELIBERATELY stdlib-only, including no sibling imports: the offline CLIs
# (tools/pod_report.py, tools/trace_report.py) load this file by path so a
# login node without jax can still render reports — the telemetry module
# imports the shared helpers below FROM here, never the other way around.

#: Default histogram buckets for durations in seconds (5 ms … 2 min) —
#: telemetry's Histogram default and the pod skew table's resolution.
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


def _quantile_summary(values: Sequence[float],
                      qs: Tuple[float, ...] = (0.5, 0.95, 0.99)
                      ) -> Dict[str, Optional[float]]:
    counts = [0] * (len(DURATION_BUCKETS_S) + 1)
    for v in values:
        for i, edge in enumerate(DURATION_BUCKETS_S):
            if v <= edge:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    return {f"p{int(round(q * 100))}": histogram_quantile(
        DURATION_BUCKETS_S, counts, len(values), q) for q in qs}


#: bump when the ``PodReport.to_dict`` shape changes incompatibly
POD_SCHEMA_VERSION = 1

#: top-level keys every serialized pod report carries (the multichip smoke
#: validates emitted reports against this)
POD_REPORT_KEYS = ("schema_version", "ranks", "truncated_ranks",
                   "missing_ranks", "n_steps", "align", "steps", "skew",
                   "straggler", "decomposition", "census", "comm_hang")

#: ``flightrec_rank3.jsonl`` / ``whatever-rank12.jsonl`` → rank id
_RANK_FILE_RE = re.compile(r"rank(\d+)[^0-9]*\.jsonl$")

#: census traffic classes, heavy movers first (presentation order)
TRAFFIC_CLASSES = ("param_gather", "grad_sync", "other", "scalar_sync")

#: skews below this resolve to "no skew" (host clock + record jitter floor)
_EPS_S = 1e-9


# =========================================================================
# Loading: discovery, salvage, rank inference
# =========================================================================


@dataclass
class RankStream:
    """One rank's parsed flight-recorder stream."""
    rank: int
    path: str
    records: List[Dict[str, Any]]
    truncated: bool = False       # torn tail / unparsable lines were skipped
    salvaged_lines: int = 0       # how many lines could not be parsed


def parse_stream_text(text: str) -> Tuple[List[Dict[str, Any]], int, bool]:
    """Parse JSONL text, salvaging past damage: unparsable lines (a rank
    killed mid-write — the preemption force-dump race) are skipped, not
    fatal. Returns ``(records, bad_line_count, truncated)`` where truncated
    also covers a file whose final line never got its newline."""
    records: List[Dict[str, Any]] = []
    bad = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            bad += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
        else:
            bad += 1
    truncated = bad > 0 or (bool(text) and not text.endswith("\n"))
    return records, bad, truncated


def infer_rank(path: str, records: Sequence[Dict[str, Any]]) -> Optional[int]:
    """Rank id for a stream: the ``rank<N>`` filename convention first, else
    the LAST ``flight_recorder/start`` meta record (restarts append; the
    newest incarnation is authoritative)."""
    m = _RANK_FILE_RE.search(os.path.basename(path))
    if m:
        return int(m.group(1))
    for rec in reversed(records):
        if rec.get("kind") == "meta" and \
                rec.get("name") == "flight_recorder/start":
            rank = (rec.get("data") or {}).get("rank")
            if rank is not None:
                return int(rank)
    return None


def discover_rank_files(specs: Iterable[str]) -> List[str]:
    """Expand each spec — a directory (its ``flightrec*.jsonl``, else any
    ``*.jsonl``), a glob pattern, or a literal file — into a sorted,
    deduplicated path list. This is what lets the CLIs take
    ``telemetry_logs/`` instead of a hand-enumerated per-rank list."""
    out: List[str] = []
    for spec in specs:
        spec = os.path.expanduser(spec)
        if os.path.isdir(spec):
            hits = sorted(glob.glob(os.path.join(spec, "flightrec*.jsonl")))
            if not hits:
                hits = sorted(glob.glob(os.path.join(spec, "*.jsonl")))
            out.extend(hits)
        elif glob.has_magic(spec):
            out.extend(sorted(glob.glob(spec)))
        else:
            out.append(spec)
    seen, unique = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            unique.append(p)
    return unique


def load_rank_streams(specs: Iterable[str]) -> Dict[int, RankStream]:
    """Discover + parse per-rank streams keyed by rank id. Unreadable files
    are dropped (reported by the CLI); a stream whose rank cannot be
    inferred gets the next free non-negative id so nothing is silently
    merged onto an existing rank."""
    streams: Dict[int, RankStream] = {}
    pending: List[RankStream] = []
    for path in discover_rank_files(specs):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        records, bad, truncated = parse_stream_text(text)
        if not records:
            continue
        rank = infer_rank(path, records)
        stream = RankStream(rank=-1 if rank is None else rank, path=path,
                            records=records, truncated=truncated,
                            salvaged_lines=bad)
        if rank is None or rank in streams:
            pending.append(stream)
        else:
            streams[rank] = stream
    next_free = 0
    for stream in pending:
        while next_free in streams:
            next_free += 1
        stream.rank = next_free
        streams[next_free] = stream
    return streams


# =========================================================================
# Extraction helpers
# =========================================================================


def _newest_incarnation(records: Sequence[Dict[str, Any]]
                        ) -> Sequence[Dict[str, Any]]:
    """Records belonging to the newest PROCESS incarnation.

    Restart incarnations append to the same rank-local JSONL (crash
    forensics keep the history), and each incarnation restarts its record
    ``seq`` — so the timeline/alignment extraction must only see the
    newest incarnation, or a dead incarnation's trailing steps would fuse
    into (and its stale anchor could mis-align) the resumed run. An
    incarnation is a PROCESS: ``flight_recorder/start`` markers carry the
    writer's pid, and consecutive markers with the newest marker's pid are
    the same incarnation (a second anchored engine in one process is not a
    restart — its earlier siblings' steps stay live, separated by their
    sync epochs). File order is the incarnation order."""
    start = None
    newest_pid = None
    for i in range(len(records) - 1, -1, -1):
        rec = records[i]
        if rec.get("kind") != "meta" or \
                rec.get("name") != "flight_recorder/start":
            continue
        pid = (rec.get("data") or {}).get("pid")
        if start is None:
            start, newest_pid = i, pid
            if pid is None:  # no pid recorded: marker = incarnation
                break
        elif pid == newest_pid:
            start = i  # same process, earlier engine — still live
        else:
            break
    return records if start is None else records[start:]


def _step_spans(records: Sequence[Dict[str, Any]]
                ) -> Dict[Tuple[int, int], Tuple[float, float, bool]]:
    """``{(sync_epoch, step): (t_end_wall, dur_s, compiled)}`` over the
    newest incarnation only (see :func:`_newest_incarnation`); the sync
    epoch separates multiple anchored engines *within* one incarnation.
    ``compiled`` marks a jit cache miss inside the step — its duration is
    compile-contaminated and must not enter the comm/compute split."""
    out: Dict[Tuple[int, int], Tuple[float, float, bool]] = {}
    for rec in _newest_incarnation(records):
        if rec.get("kind") != "span" or rec.get("name") != "step" \
                or "step" not in rec:
            continue
        data = rec.get("data") or {}
        out[(int(data.get("sync", 0)), int(rec["step"]))] = (
            float(rec.get("t", 0.0)), float(rec.get("dur", 0.0)),
            bool(data.get("compiles")))
    return out


def _anchors(records: Sequence[Dict[str, Any]]) -> Dict[int, float]:
    """``{anchor_seq: wall_t}`` from the newest incarnation's
    ``align/anchor`` meta records (an older incarnation's anchor is a
    different barrier — subtracting across them yields garbage offsets).
    Anchors whose barrier failed (``synced: false``) are NOT shared
    instants and are excluded — alignment then falls back to step
    boundaries."""
    out: Dict[int, float] = {}
    for rec in _newest_incarnation(records):
        if rec.get("kind") == "meta" and rec.get("name") == "align/anchor":
            data = rec.get("data") or {}
            if data.get("anchor") is not None and "t" in rec \
                    and data.get("synced", True):
                out[int(data["anchor"])] = float(rec["t"])
    return out


def _comm_marks(records: Sequence[Dict[str, Any]]
                ) -> Tuple[Dict[int, float], List[Dict[str, Any]]]:
    """Watchdog marks from the newest incarnation: ``comm/arm`` events
    (step → wall time the rank arrived at its collective dispatch) and any
    ``comm/hang`` abort events (``comm/watchdog.py``). The arm is the
    pre-dispatch deadline stamp; the per-step ``step`` span is its post
    record — so an arm with no matching span is a step that never came
    back."""
    arms: Dict[int, float] = {}
    hangs: List[Dict[str, Any]] = []
    for rec in _newest_incarnation(records):
        if rec.get("kind") != "event":
            continue
        if rec.get("name") == "comm/arm" and "step" in rec:
            arms[int(rec["step"])] = float(rec.get("t", 0.0))
        elif rec.get("name") == "comm/hang":
            h = dict(rec.get("data") or {})
            if rec.get("step") is not None:
                h.setdefault("step", int(rec["step"]))
            hangs.append(h)
    return arms, hangs


def attribute_comm_hang(streams: Dict[int, "RankStream"], align: "Alignment",
                        spans: Dict[int, Dict]) -> Optional[Dict[str, Any]]:
    """Name the rank that hung the pod.

    Joins each rank's pre-dispatch ``comm/arm`` stamps against its
    completed step spans: on the fatal step, ranks that ARMED but never
    completed were *waiting inside the collective*; a rank that armed
    earlier steps but never armed the fatal one **never arrived** — it is
    the culprit the whole pod was waiting for. When every rank armed (the
    hang was inside the fabric, not before it), the last rank to arm is
    the suspect — the fatal-step extension of the last-arriving-rank
    straggler ledger. Returns ``None`` when no stream shows a watchdog
    abort or a dangling arm."""
    marks = {r: _comm_marks(s.records) for r, s in streams.items()}
    watchdog_ranks = sorted(r for r, (a, h) in marks.items() if a or h)
    if not watchdog_ranks:
        return None
    hang_events = [h for r in watchdog_ranks for h in marks[r][1]]
    done = {r: {s for (_sync, s) in spans.get(r, {})} for r in streams}
    hang_steps = [int(h["step"]) for h in hang_events
                  if h.get("step") is not None]
    if hang_steps:
        step = max(hang_steps)
    else:
        # no (step-carrying) abort record — a salvaged/torn stream may
        # hold a comm/hang without its step field; fall back to the
        # newest arm that never came back
        dangling = [s for r in watchdog_ranks
                    for s in marks[r][0] if s not in done[r]]
        if not dangling:
            return None if not hang_events else {
                "step": None, "arrived_ranks": [], "never_arrived_ranks": [],
                "stuck_ranks": [],
                "detected_by_ranks": sorted(
                    {int(h["rank"]) for h in hang_events
                     if h.get("rank") is not None}),
                "deadline_s": None, "waited_s": None}
        step = max(dangling)
    arrived = sorted(r for r in watchdog_ranks if step in marks[r][0])
    never = sorted(r for r in watchdog_ranks if step not in marks[r][0])
    stuck = sorted(r for r in arrived if step not in done[r])
    detected_by = sorted({int(h["rank"]) for h in hang_events
                          if h.get("rank") is not None}
                         or {r for r in watchdog_ranks if marks[r][1]})
    out: Dict[str, Any] = {
        "step": step,
        "arrived_ranks": arrived,
        "never_arrived_ranks": never,
        "stuck_ranks": stuck,
        "detected_by_ranks": detected_by,
        "deadline_s": max((h.get("deadline_s") or 0.0)
                          for h in hang_events) if hang_events else None,
        "waited_s": max((h.get("waited_s") or 0.0)
                        for h in hang_events) if hang_events else None,
    }
    if never:
        out["culprit_rank"] = never[0]
        out["culprit_reason"] = "never-arrived"
    elif stuck and len(stuck) < len(arrived):
        # some ranks completed the step, these armed and never did: they
        # wedged inside their own collective window (the self-abort shape
        # — independent replicas, or a rank that died mid-collective)
        out["culprit_rank"] = stuck[0]
        out["culprit_reason"] = "never-completed"
    elif arrived:
        # every rank reached its dispatch and none finished: the hang is
        # in the fabric — suspect the rank that arrived last, using
        # aligned clocks so a constant clock offset can't frame an
        # innocent rank
        ts = {r: marks[r][0][step] - align.offsets_s.get(r, 0.0)
              for r in arrived}
        out["culprit_rank"] = max(ts, key=ts.get)
        out["culprit_reason"] = "last-to-arm"
        if len(ts) >= 2:
            out["arm_skew_s"] = round(max(ts.values()) - min(ts.values()), 6)
    return out


def _last_event_data(records: Sequence[Dict[str, Any]],
                     name: str) -> Optional[Dict[str, Any]]:
    for rec in reversed(records):
        if rec.get("name") == name and rec.get("data"):
            return rec["data"]
    return None


def find_census(streams: Dict[int, RankStream]
                ) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """Last ``comm/census`` event across ranks (lowest rank wins ties —
    rank 0 is the conventional emitter). Returns ``(classes_summary,
    source_rank)``; accepts both the bare ``CollectiveClasses.summary()``
    dict and a ``{"classes": ..., ...context}`` wrapper."""
    for rank in sorted(streams):
        data = _last_event_data(streams[rank].records, "comm/census")
        if data is None:
            continue
        classes = data.get("classes", data)
        if isinstance(classes, dict) and any(
                isinstance(v, dict) and "total_bytes" in v
                for v in classes.values()):
            return classes, rank
    return None, None


def _measured_xla_bytes(streams: Dict[int, RankStream]) -> Optional[int]:
    """Total bytes of the measured post-compile op mix (``comm/snapshot``
    records' ``xla::`` keys) — the census join's runtime cross-check."""
    for rank in sorted(streams):
        snap = _last_event_data(streams[rank].records, "comm/snapshot")
        if not snap:
            continue
        xla = {k: v for k, v in snap.items()
               if isinstance(v, dict) and k.startswith("xla::")}
        if xla:
            return sum(int(v.get("total_bytes", 0)) for v in xla.values())
    return None


def _median(values: Sequence[float]) -> float:
    from statistics import median

    return float(median(values))


# =========================================================================
# Clock alignment
# =========================================================================


@dataclass
class Alignment:
    #: "anchor" | "step-median" | "mixed" | "single" — how offsets were
    #: derived ("mixed": some ranks anchored, others fell back per-rank)
    method: str
    offsets_s: Dict[int, float]       # rank -> subtract from its wall times
    reference_rank: int
    unaligned_ranks: List[int] = field(default_factory=list)


def align_streams(streams: Dict[int, RankStream],
                  spans: Optional[Dict[int, Dict]] = None) -> Alignment:
    """Per-rank clock offsets relative to the lowest rank with step spans.
    ``spans`` accepts the precomputed per-rank :func:`_step_spans` maps so
    :func:`fuse_pod` walks each record list once, not twice.

    Per rank, an anchor shared with the reference is preferred (true clock
    offset — constant straggling stays visible as skew); the median delta
    over shared step-span boundaries is the fallback (constant straggling
    is absorbed into the offset; only per-step variation remains). The
    choice is PER RANK: one truncated stream that lost its anchor degrades
    itself, not the whole pod. Ranks sharing neither an anchor nor any
    step with the reference are reported unaligned and excluded from
    skew."""
    if spans is None:
        spans = {r: _step_spans(s.records) for r, s in streams.items()}
    anchors = {r: _anchors(s.records) for r, s in streams.items()}
    ranks_with_steps = [r for r in sorted(streams) if spans[r]]
    if not ranks_with_steps:
        ref = min(streams) if streams else 0
        return Alignment(method="single", offsets_s={}, reference_rank=ref,
                         unaligned_ranks=sorted(streams))
    # prefer an ANCHORED reference: if rank 0's truncated stream lost its
    # anchor record, comparing everyone against it would degrade the whole
    # pod to step-median even though ranks 1..N share valid anchors
    anchored = [r for r in ranks_with_steps if anchors[r]]
    ref = anchored[0] if anchored else ranks_with_steps[0]
    if len(streams) == 1:
        return Alignment(method="single", offsets_s={ref: 0.0},
                         reference_rank=ref)

    offsets: Dict[int, float] = {ref: 0.0}
    unaligned: List[int] = []
    methods_used = set()
    for r in sorted(streams):
        if r == ref:
            continue
        shared_anchors = set(anchors[r]) & set(anchors[ref])
        if shared_anchors:
            seq = max(shared_anchors)  # newest barrier = tightest clocks
            offsets[r] = anchors[r][seq] - anchors[ref][seq]
            methods_used.add("anchor")
            continue
        shared = sorted(set(spans[r]) & set(spans[ref]))
        if shared:
            offsets[r] = _median([spans[r][k][0] - spans[ref][k][0]
                                  for k in shared])
            methods_used.add("step-median")
        else:
            unaligned.append(r)
    method = (methods_used.pop() if len(methods_used) == 1
              else "mixed" if methods_used else "single")
    return Alignment(method=method, offsets_s=offsets, reference_rank=ref,
                     unaligned_ranks=unaligned)


# =========================================================================
# Fusion + decomposition
# =========================================================================


@dataclass
class PodReport:
    """The fused cluster view. ``to_dict()`` is the stable serialized
    schema (``POD_REPORT_KEYS``); ``render()`` the operator tables;
    ``events()``/``publish()`` feed the ``Pod/*`` family back through the
    monitor registry on rank 0."""
    ranks: List[int]
    truncated_ranks: List[int]
    missing_ranks: List[int]          # present but no usable step spans
    align: Alignment
    steps: List[Dict[str, Any]]       # fused per-step rows, step order
    skew: Dict[str, Optional[float]]  # p50/p95/p99/max seconds
    straggler_counts: Dict[int, int]  # rank -> times it arrived last
    straggler_lateness_s: Dict[int, float]
    compute_floor_s: Optional[float]
    compute_floor_source: str         # "provided" | "min-observed" | "none"
    comm_bound_frac: Optional[float]  # mean over steps
    exposed_comm_s: float
    overlapped_comm_s: Optional[float]
    classes: Dict[str, Dict[str, Any]]
    census_rank: Optional[int]
    census_total_bytes: Optional[int]
    measured_xla_bytes: Optional[int]
    #: collective-hang attribution (attribute_comm_hang): which rank never
    #: arrived at the fatal step's dispatch — None when the run saw none
    comm_hang: Optional[Dict[str, Any]] = None
    source_files: Dict[int, str] = field(default_factory=dict)

    # ------------------------------------------------------------- schema
    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def bytes_match(self) -> Optional[bool]:
        if self.census_total_bytes is None or self.measured_xla_bytes is None:
            return None
        return self.census_total_bytes == self.measured_xla_bytes

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": POD_SCHEMA_VERSION,
            "ranks": list(self.ranks),
            "truncated_ranks": list(self.truncated_ranks),
            "missing_ranks": list(self.missing_ranks),
            "n_steps": self.n_steps,
            "align": {"method": self.align.method,
                      "reference_rank": self.align.reference_rank,
                      "offsets_s": {str(r): round(o, 6) for r, o in
                                    self.align.offsets_s.items()},
                      "unaligned_ranks": list(self.align.unaligned_ranks)},
            "steps": self.steps,
            "skew": self.skew,
            "straggler": {
                "counts": {str(r): c for r, c in
                           self.straggler_counts.items()},
                "lateness_s": {str(r): round(v, 6) for r, v in
                               self.straggler_lateness_s.items()}},
            "decomposition": {
                "compute_floor_s": self.compute_floor_s,
                "compute_floor_source": self.compute_floor_source,
                "comm_bound_frac": self.comm_bound_frac,
                "exposed_comm_s": round(self.exposed_comm_s, 6),
                "overlapped_comm_s": self.overlapped_comm_s,
                "classes": self.classes},
            "census": {"source_rank": self.census_rank,
                       "total_bytes_per_step": self.census_total_bytes,
                       "measured_xla_bytes": self.measured_xla_bytes,
                       "bytes_match": self.bytes_match},
            "comm_hang": self.comm_hang,
        }

    # ------------------------------------------------------------- events
    def events(self, step: int = 0) -> List[Tuple[str, Any, int]]:
        """Scalar ``Pod/*`` events (declared family prefix) for a rank-0
        MonitorMaster: skew quantiles, comm-bound fraction, per-class
        effective bandwidth, straggler histogram."""
        ev: List[Tuple[str, Any, int]] = [
            ("Pod/ranks", float(len(self.ranks)), step),
            ("Pod/steps", float(self.n_steps), step),
            ("Pod/exposed_comm_s", self.exposed_comm_s, step)]
        for q in ("p50", "p95", "p99"):
            v = self.skew.get(q)
            if v is not None:
                ev.append((f"Pod/skew_{q}_s", v, step))
        if self.comm_bound_frac is not None:
            ev.append(("Pod/comm_bound_frac", self.comm_bound_frac, step))
        # data-dependent members use the Comm/-family dot convention
        # (Group/base.tail) so the static event-name lint can resolve the
        # literal base against the registry
        for cls, d in self.classes.items():
            if d.get("effective_gbps") is not None:
                ev.append((f"Pod/bw.{cls}_gbps", d["effective_gbps"], step))
        for rank, count in sorted(self.straggler_counts.items()):
            ev.append((f"Pod/straggler.rank{rank}", float(count), step))
        if self.comm_hang is not None:
            if self.comm_hang.get("step") is not None:
                ev.append(("Pod/comm_hang.step",
                           float(self.comm_hang["step"]), step))
            if self.comm_hang.get("culprit_rank") is not None:
                ev.append(("Pod/comm_hang.culprit_rank",
                           float(self.comm_hang["culprit_rank"]), step))
        return ev

    def publish(self, registry: Any = None, monitor: Any = None,
                step: int = 0) -> List[Tuple[str, Any, int]]:
        """Feed the ``Pod/*`` events into a :class:`MetricsRegistry` (as
        gauges/counters) and optionally a ``MonitorMaster`` — the rank-0
        feedback path. Returns the event list either way."""
        ev = self.events(step)
        if registry is not None:
            for name, value, _step in ev:
                if name.startswith("Pod/straggler."):
                    c = registry.counter(name)
                    c.incr(int(value) - c.value)
                else:
                    registry.gauge(name).set(value)
        if monitor is not None:
            monitor.write_events(ev)
        return ev

    # ------------------------------------------------------------- render
    def render(self, last: int = 20) -> str:
        out: List[str] = []
        out.append(f"pod report — {len(self.ranks)} rank(s), "
                   f"{self.n_steps} fused step(s), clock alignment: "
                   f"{self.align.method}")
        for rank in self.ranks:
            notes = []
            if rank in self.truncated_ranks:
                notes.append("TRUNCATED (salvaged partial stream)")
            if rank in self.missing_ranks:
                notes.append("no step spans")
            if rank in self.align.unaligned_ranks:
                notes.append("unalignable (excluded from skew)")
            off = self.align.offsets_s.get(rank)
            off_txt = "" if off is None else (
                f"offset {off * 1e3:+.1f}ms" if abs(off) < 10.0
                else f"offset {off:+.1f}s")
            src = self.source_files.get(rank, "")
            out.append(f"  rank{rank:<4}{off_txt:<24}{src}"
                       + (f"  <-- {', '.join(notes)}" if notes else ""))

        out.append("")
        out.append(f"step timeline (last {min(last, self.n_steps)} of "
                   f"{self.n_steps})")
        out.append(f"{'step':>8}{'pod dur':>12}{'skew':>10}"
                   f"{'straggler':>11}{'comm-bound':>12}")
        for row in self.steps[-last:]:
            cb = (f"{100 * row['comm_bound_frac']:.1f}%"
                  if row.get("comm_bound_frac") is not None
                  else ("compile" if row.get("compiled") else "-"))
            skew = (_fmt_s(row["skew_s"]) if row.get("skew_s") is not None
                    else "-")
            strag = (f"rank{row['straggler']}"
                     if row.get("straggler") is not None else "-")
            out.append(f"{row['step']:>8}{_fmt_s(row['dur_s']):>12}"
                       f"{skew:>10}{strag:>11}{cb:>12}")
        if not self.steps:
            out.append("  (no fusable step spans)")

        out.append("")
        out.append("arrival skew (last-arriving-rank attribution)")
        if len(self.ranks) < 2 or not any(
                r.get("skew_s") is not None for r in self.steps):
            out.append("  (single aligned rank — no cross-rank skew)")
        else:
            qs = ", ".join(
                f"{q}={_fmt_s(self.skew[q])}" for q in ("p50", "p95", "p99")
                if self.skew.get(q) is not None)
            out.append(f"  quantiles: {qs}  max={_fmt_s(self.skew['max'])}")
            out.append(f"  {'rank':<8}{'times last':>12}"
                       f"{'total lateness':>16}")
            for rank in sorted(self.straggler_counts):
                out.append(
                    f"  rank{rank:<4}{self.straggler_counts[rank]:>12}"
                    f"{_fmt_s(self.straggler_lateness_s.get(rank, 0.0)):>16}")

        if self.comm_hang is not None:
            h = self.comm_hang
            out.append("")
            out.append("collective hang (watchdog abort)")
            who = (f"rank{h['culprit_rank']} ({h.get('culprit_reason')})"
                   if h.get("culprit_rank") is not None else "unattributed")
            out.append(f"  step {h['step']}: culprit {who}")
            out.append(f"  armed (arrived at dispatch): "
                       f"{h.get('arrived_ranks')}  never arrived: "
                       f"{h.get('never_arrived_ranks')}")
            detail = []
            if h.get("deadline_s") is not None:
                detail.append(f"deadline {h['deadline_s']:.1f}s")
            if h.get("waited_s") is not None:
                detail.append(f"waited {h['waited_s']:.1f}s")
            if h.get("arm_skew_s") is not None:
                detail.append(f"arm skew {_fmt_s(h['arm_skew_s'])}")
            if h.get("detected_by_ranks"):
                detail.append(f"detected by rank(s) "
                              f"{h['detected_by_ranks']}")
            if detail:
                out.append(f"  {', '.join(detail)}")

        out.append("")
        out.append("comm/compute decomposition")
        if self.compute_floor_s is None:
            out.append("  (no steps — nothing to decompose)")
        else:
            out.append(f"  compute floor: {_fmt_s(self.compute_floor_s)} "
                       f"({self.compute_floor_source})")
            out.append(f"  exposed comm:  {_fmt_s(self.exposed_comm_s)} "
                       f"total, comm_bound_frac="
                       f"{100 * (self.comm_bound_frac or 0.0):.1f}% mean")
            if self.overlapped_comm_s is not None:
                out.append(f"  overlapped comm: "
                           f"{_fmt_s(self.overlapped_comm_s)} total "
                           f"(analytic demand hidden under compute)")
        if self.classes:
            out.append(f"  {'class':<14}{'ops/step':>9}{'MB/step':>10}"
                       f"{'time':>10}{'eff GB/s':>10}")
            for cls in TRAFFIC_CLASSES:
                d = self.classes.get(cls)
                if d is None:
                    continue
                bw = (f"{d['effective_gbps']:.2f}"
                      if d.get("effective_gbps") is not None else
                      ("overlap" if d["bytes_per_step"] else "-"))
                out.append(f"  {cls:<14}{d['count']:>9}"
                           f"{d['bytes_per_step'] / 2**20:>10.2f}"
                           f"{_fmt_s(d['attributed_s']):>10}{bw:>10}")
            match = self.bytes_match
            check = ("MATCH" if match else "MISMATCH") if match is not None \
                else "no comm/snapshot in streams"
            out.append(f"  census {self.census_total_bytes} B/step vs "
                       f"measured xla:: op mix "
                       f"{self.measured_xla_bytes} B: {check}")
        else:
            out.append("  (no comm/census record in any stream — run with "
                       "engine.emit_comm_census() for the per-class table)")
        return "\n".join(out)


def _fmt_s(sec: float) -> str:
    if sec >= 1.0:
        return f"{sec:.2f}s"
    if sec >= 1e-3:
        return f"{sec * 1e3:.1f}ms"
    return f"{sec * 1e6:.0f}us"


def fuse_pod(streams: Dict[int, RankStream],
             census: Optional[Dict[str, Any]] = None,
             compute_s: Optional[float] = None,
             link_gbps: Optional[float] = None) -> PodReport:
    """Fuse per-rank streams into a :class:`PodReport`.

    ``census`` overrides the in-stream ``comm/census`` record (the classes
    summary dict); ``compute_s`` overrides the observed compute floor;
    ``link_gbps`` enables the exposed-vs-overlapped split against an
    analytic transfer-time demand."""
    spans = {r: _step_spans(s.records) for r, s in streams.items()}
    align = align_streams(streams, spans=spans)
    aligned_ranks = [r for r in sorted(streams)
                     if spans[r] and r in align.offsets_s]
    missing = [r for r in sorted(streams) if not spans[r]]

    # fused step rows: keys shared semantics — any (sync, step) seen by at
    # least one aligned rank; cross-rank skew only where >=2 ranks share it
    all_keys = sorted({k for r in aligned_ranks for k in spans[r]})
    steps: List[Dict[str, Any]] = []
    skews: List[float] = []
    straggler_counts: Dict[int, int] = {r: 0 for r in aligned_ranks}
    straggler_lateness: Dict[int, float] = {r: 0.0 for r in aligned_ranks}
    min_rank_dur: Optional[float] = None
    for key in all_keys:
        present = [r for r in aligned_ranks if key in spans[r]]
        durs = {r: spans[r][key][1] for r in present}
        ends = {r: spans[r][key][0] - align.offsets_s[r] for r in present}
        compiled = any(spans[r][key][2] for r in present)
        if not compiled:
            for d in durs.values():
                if d > 0:
                    min_rank_dur = d if min_rank_dur is None \
                        else min(min_rank_dur, d)
        row: Dict[str, Any] = {"step": key[1], "sync": key[0],
                               "dur_s": max(durs.values()),
                               "ranks": len(present),
                               "compiled": compiled}
        if len(present) >= 2:
            first = min(ends.values())
            last_rank = max(ends, key=ends.get)
            skew = max(0.0, ends[last_rank] - first)
            row["skew_s"] = skew
            row["straggler"] = last_rank
            skews.append(skew)
            if skew > _EPS_S:
                straggler_counts[last_rank] += 1
                straggler_lateness[last_rank] += skew
        steps.append(row)

    skew_summary: Dict[str, Optional[float]] = {
        "p50": None, "p95": None, "p99": None, "max": None}
    if skews:
        skew_summary.update(_quantile_summary(skews), max=max(skews))

    # ---------------------------------------------------- decomposition
    if census is None:
        census, census_rank = find_census(streams)
    else:
        census = census.get("classes", census)
        census_rank = None
    measured = _measured_xla_bytes(streams)
    census_total = (sum(int(census[c]["total_bytes"]) for c in census)
                    if census else None)

    if compute_s is not None:
        floor, floor_src = float(compute_s), "provided"
    elif min_rank_dur is not None:
        floor, floor_src = min_rank_dur, "min-observed"
    else:
        floor, floor_src = None, "none"

    exposed_total = 0.0
    cb_fracs: List[float] = []
    overlapped_total: Optional[float] = None
    if floor is not None:
        data_bytes = census_total or 0
        demand_s = (data_bytes / (link_gbps * 1e9)
                    if link_gbps and data_bytes else None)
        if demand_s is not None:
            overlapped_total = 0.0
        for row in steps:
            if row["compiled"]:
                # a jit cache miss inflates this step's wall with compile
                # time — goodput's compile bucket, not communication
                continue
            dur = row["dur_s"]
            exposed = max(0.0, dur - floor)
            row["exposed_comm_s"] = round(exposed, 9)
            row["comm_bound_frac"] = exposed / dur if dur > 0 else 0.0
            cb_fracs.append(row["comm_bound_frac"])
            exposed_total += exposed
            if demand_s is not None:
                overlapped = max(0.0, min(demand_s, dur) - exposed)
                row["overlapped_comm_s"] = round(overlapped, 9)
                overlapped_total += overlapped

    classes: Dict[str, Dict[str, Any]] = {}
    if census:
        data_total = sum(int(census[c]["total_bytes"]) for c in census) or 1
        # bandwidth is a clean-sample ratio: exposed_total sums CLEAN
        # (non-compile) steps only, so the byte numerator must count the
        # same steps — total_bytes still reports the whole run's movement
        n_clean = sum(1 for row in steps if not row["compiled"])
        for cls in census:
            b = int(census[cls]["total_bytes"])
            share = b / data_total
            attributed = share * exposed_total
            clean_moved = b * n_clean
            classes[cls] = {
                "count": int(census[cls].get("count", 0)),
                "bytes_per_step": b,
                "total_bytes": b * len(steps),
                "attributed_s": attributed,
                "effective_gbps": (round(clean_moved / attributed / 1e9, 6)
                                   if attributed > 1e-12 and clean_moved
                                   else None),
            }

    return PodReport(
        ranks=sorted(streams),
        truncated_ranks=[r for r in sorted(streams) if streams[r].truncated],
        missing_ranks=missing,
        align=align,
        steps=steps,
        skew=skew_summary,
        straggler_counts=straggler_counts,
        straggler_lateness_s=straggler_lateness,
        compute_floor_s=floor,
        compute_floor_source=floor_src,
        comm_bound_frac=(sum(cb_fracs) / len(cb_fracs)) if cb_fracs else None,
        exposed_comm_s=exposed_total,
        overlapped_comm_s=overlapped_total,
        classes=classes,
        census_rank=census_rank,
        census_total_bytes=census_total,
        measured_xla_bytes=measured,
        comm_hang=attribute_comm_hang(streams, align, spans),
        source_files={r: s.path for r, s in streams.items()},
    )


def validate_pod_report(d: Dict[str, Any]) -> List[str]:
    """Schema check for a serialized pod report (the multichip smoke gate).
    Returns a list of problems — empty means valid."""
    problems = [f"missing key: {k}" for k in POD_REPORT_KEYS if k not in d]
    if problems:
        return problems
    if d["schema_version"] != POD_SCHEMA_VERSION:
        problems.append(f"schema_version {d['schema_version']} != "
                        f"{POD_SCHEMA_VERSION}")
    if not isinstance(d["steps"], list):
        problems.append("steps is not a list")
    else:
        for i, row in enumerate(d["steps"]):
            for k in ("step", "dur_s"):
                if k not in row:
                    problems.append(f"steps[{i}] missing {k}")
    for k in ("method", "offsets_s", "reference_rank"):
        if k not in d["align"]:
            problems.append(f"align missing {k}")
    dec = d["decomposition"]
    for k in ("compute_floor_s", "comm_bound_frac", "exposed_comm_s",
              "classes"):
        if k not in dec:
            problems.append(f"decomposition missing {k}")
    cb = dec.get("comm_bound_frac")
    if cb is not None and not (isinstance(cb, (int, float))
                               and -1e-9 <= cb <= 1.0 + 1e-9):
        problems.append(f"comm_bound_frac out of [0,1]: {cb}")
    for cls, row in (dec.get("classes") or {}).items():
        for k in ("count", "bytes_per_step", "attributed_s",
                  "effective_gbps"):
            if k not in row:
                problems.append(f"class {cls} missing {k}")
    ch = d.get("comm_hang")
    if ch is not None:
        for k in ("step", "arrived_ranks", "never_arrived_ranks"):
            if k not in ch:
                problems.append(f"comm_hang missing {k}")
    return problems


def pod_report_from_paths(specs: Iterable[str],
                          census: Optional[Dict[str, Any]] = None,
                          compute_s: Optional[float] = None,
                          link_gbps: Optional[float] = None
                          ) -> Optional[PodReport]:
    """One-call convenience: discover + load + fuse. ``None`` when no spec
    yields any records."""
    streams = load_rank_streams(specs)
    if not streams:
        return None
    return fuse_pod(streams, census=census, compute_s=compute_s,
                    link_gbps=link_gbps)


# ----------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    """Fuse per-rank flight-recorder JSONLs into the pod report
    (``tools/pod_report.py``'s contract). Exit 0 on success, 2 when no
    input yields any records."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m deepspeedsyclsupport_tpu_torch.monitor.pod",
        description="Fuse per-rank flight-recorder JSONLs into a pod "
                    "timeline / straggler / bandwidth report.")
    ap.add_argument("inputs", nargs="+",
                    help="directories, globs or files of per-rank JSONLs")
    ap.add_argument("--last", type=int, default=20,
                    help="trailing steps to show in the timeline")
    ap.add_argument("--census", metavar="JSON",
                    help="static census classes file (overrides any "
                         "comm/census record in the streams)")
    ap.add_argument("--compute-s", type=float, default=None,
                    help="comm-free compute time per step (e.g. a "
                         "single-chip calibration); default: the minimum "
                         "observed per-rank step duration")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="interconnect capacity hint enabling the "
                         "exposed-vs-overlapped comm split")
    ap.add_argument("--json", metavar="OUT",
                    help="also write the serialized report (schema "
                         "monitor/pod.py POD_REPORT_KEYS) to this file")
    args = ap.parse_args(argv)

    census = None
    if args.census:
        try:
            with open(args.census) as f:
                census = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: cannot read census {args.census}: {e}",
                  file=sys.stderr)
            return 2

    report = pod_report_from_paths(
        args.inputs, census=census, compute_s=args.compute_s,
        link_gbps=args.link_gbps)
    if report is None:
        print("no flight-recorder records found in any input",
              file=sys.stderr)
        return 2
    for rank in report.truncated_ranks:
        stream_path = report.source_files.get(rank, "?")
        print(f"note: rank{rank} stream is truncated (salvaged partial "
              f"records from {stream_path})", file=sys.stderr)
    if report.comm_hang is not None:
        h = report.comm_hang
        who = (f"rank{h['culprit_rank']} ({h.get('culprit_reason')})"
               if h.get("culprit_rank") is not None else "unattributed")
        print(f"COMM HANG: step {h['step']} — culprit {who}; see the "
              f"'collective hang' section below", file=sys.stderr)
    print(report.render(last=args.last))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
        print(f"\nserialized report -> {args.json}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
