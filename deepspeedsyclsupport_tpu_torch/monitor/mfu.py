"""MFU ledger core: region registry, trace op→region map, trace join.

Port of ``deepspeedsyclsupport_tpu/monitor/mfu.py``. The step-time
attribution instrument: model and engine code wrap phases in
:func:`region_scope` (``torch.profiler.record_function("mfu.<region>")``),
the profiler's Chrome trace of one step carries those ranges on the host
threads beside every kernel the step ran, and this module owns the joins:

* :func:`build_opmap` — a trace's op events → ``{op key: {region, category,
  opcode}}``. A kernel joins its launch (the ``cuda_runtime`` /
  ``cuda_driver`` event with the same ``correlation`` id, on the host
  thread that issued it); the launch's region is the innermost ``mfu.*``
  range around it. A launch in the backward lies in no such range: the
  autograd engine runs it under ``autograd::engine::evaluate_function:
  <Node>``, whose ``Sequence number`` names the forward op that made the
  node, and the launch takes that forward op's region (the recomputed
  forward of activation checkpointing runs inside the backward under its
  own ``mfu.*`` ranges). NCCL kernels are the ``collective`` region.
  This is new: the JAX package reads XLA's ``op_name`` metadata instead.
* :func:`op_events` — the trace's op events renamed to their opmap keys,
  which is what :func:`measure_regions` joins (kernel names repeat across
  regions; the keys do not).
* :func:`parse_trace`, :func:`measure_regions`, :func:`ledger`,
  :func:`ledger_events`, :func:`render_ledger` — copies of the JAX
  package's stdlib half, statement for statement (the ledger's numbers and
  its text are the same functions of the same inputs).

Stdlib-only like the JAX module: :func:`region_scope` imports torch when it
is called.

CLI (the JAX package's ``tools/mfu_report.py``: its flags, output and exit
codes; offline, no device)::

    python -m deepspeedsyclsupport_tpu_torch.monitor.mfu <trace dir> [--json OUT]

It reads either package's window: an opmap keyed by trace position (the
port's, ``<i>:<name>``) is joined through :func:`op_events`, one keyed by
op name (the JAX package's) through the events as they are.
"""
import gzip
import json
import os
import re
import warnings
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# ``python -m deepspeedsyclsupport_tpu_torch.monitor.mfu``: the package's
# models import this module (region_scope) before runpy runs it as
# __main__, which runpy warns of; the module holds no state the CLI reads
warnings.filterwarnings(
    "ignore", category=RuntimeWarning,
    message=r"'deepspeedsyclsupport_tpu_torch\.monitor\.mfu' found in "
            r"sys\.modules")

#: Canonical attribution regions. The first block are SCOPE regions — model/
#: engine code wraps phases in :func:`region_scope`. The rest are DERIVED:
#: ``collective`` is assigned by kernel (NCCL), ``host`` is the measured
#: step-wall minus device-busy gap, ``other`` is every op with no scope
#: (norm chains, residual adds, loss-scale bookkeeping, data movement).
SCOPE_REGIONS = ("embed", "attn", "mlp", "head", "loss", "optimizer")
DERIVED_REGIONS = ("collective", "other", "host")
REGIONS = SCOPE_REGIONS + DERIVED_REGIONS

#: record_function label prefix — ``mfu.attn`` etc.
SCOPE_PREFIX = "mfu."

_REGION_RE = re.compile(r"mfu\.([A-Za-z0-9_]+)")

# an observer of region_scope's entries and exits (the op counter of
# profiling/flops_profiler.py sets one while it counts a step)
_observer: Any = None


def set_scope_observer(observer: Any) -> None:
    """``observer.enter(region) -> token`` and ``observer.exit(token)`` are
    called around every :func:`region_scope` while it is set (None
    clears it)."""
    global _observer
    _observer = observer


class _RegionScope:
    __slots__ = ("name", "_token", "_range")

    def __init__(self, name: str):
        self.name = name
        self._token = self._range = None

    def __enter__(self):
        import torch  # lazy: this module must import stdlib-only

        obs = _observer
        self._token = obs.enter(self.name) if obs is not None else None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(
                SCOPE_PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        obs = _observer
        if obs is not None and self._token is not None:
            obs.exit(self._token)
        return False


def region_scope(name: str) -> _RegionScope:
    """``torch.profiler.record_function("mfu.<name>")`` for a declared MFU
    region — the ONE sanctioned way model/engine code labels a phase (a
    typo'd region would silently orphan its time, so this raises). The
    range is opened only while a profiler records (otherwise a scope costs
    an attribute check: the serving path's layers run under it too)."""
    if name not in SCOPE_REGIONS:
        raise ValueError(f"undeclared MFU region {name!r}; declared scope "
                         f"regions: {SCOPE_REGIONS} (monitor/mfu.py)")
    return _RegionScope(name)


def region_of(op_name: str) -> Optional[str]:
    """Region encoded in a range name (``mfu.attn`` → ``attn``); the LAST
    match wins. ``None`` = unscoped or undeclared."""
    found = _REGION_RE.findall(op_name or "")
    if not found:
        return None
    name = found[-1]
    return name if name in SCOPE_REGIONS else None


# ------------------------------------------------------------- trace → opmap
#: trace categories of device work (the kernels and the copies / fills)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of the host calls that launch it
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_EVAL_PREFIX = "autograd::engine::evaluate_function:"

_CPU_DOTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
             "aten::matmul", "aten::linear", "aten::_scaled_mm",
             "aten::convolution")
_CPU_REDUCE = ("sum", "mean", "amax", "amin", "max", "min", "norm",
               "logsumexp", "softmax", "prod", "var", "std", "cumsum")
_CPU_MOVE = ("copy", "cat", "index", "gather", "scatter", "embedding",
             "clone", "contiguous", "_to_copy", "stack", "pad", "fill",
             "zero", "where")


def _category(e: Dict[str, Any]) -> str:
    """Coarse category of one op event: ``dot``, ``collective``,
    ``reduce``, ``data-movement``, ``elementwise`` or ``other``."""
    name = str(e.get("name", "")).lower()
    cat = e.get("cat")
    if "nccl" in name or "c10d::" in name or "gloo" in name:
        return "collective"
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "data-movement"
    if cat == "cpu_op":
        op = name.split("::")[-1]
        if str(e.get("name")) in _CPU_DOTS:
            return "dot"
        if any(op.startswith(r) for r in _CPU_REDUCE):
            return "reduce"
        if any(m in op for m in _CPU_MOVE):
            return "data-movement"
        return "other"
    if any(s in name for s in ("gemm", "matmul", "xmma", "cutlass", "wgmma",
                               "flash_", "dot")):
        return "dot"
    if any(s in name for s in ("reduce", "norm", "softmax", "sum_", "max_",
                               "min_")):
        return "reduce"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "copy" in name or "cat" in name or "index" in name:
        return "data-movement"
    return "other"


def _thread(e: Dict[str, Any]) -> Tuple[Any, Any]:
    return (e.get("pid"), e.get("tid"))


def _innermost(intervals: List[Tuple[float, float, Any]],
               queries: List[Tuple[float, Any]]) -> Dict[Any, Any]:
    """For properly nested ``(start, end, payload)`` intervals of ONE
    thread and ``(ts, qid)`` queries: ``{qid: payload of the innermost
    interval containing ts}`` (queries in none are absent). One sweep."""
    marks = [(s, 0, -e, p) for s, e, p in intervals]
    marks += [(t, 1, 0.0, q) for t, q in queries]
    marks.sort(key=lambda m: (m[0], m[1], m[2]))
    stack: List[Tuple[float, Any]] = []
    out: Dict[Any, Any] = {}
    for t, kind, neg_end, item in marks:
        while stack and stack[-1][0] < t:
            stack.pop()
        if kind == 0:
            stack.append((-neg_end, item))
        elif stack:
            out[item] = stack[-1][1]
    return out


# host ops that do no work of their own: an aten op whose nested aten
# ops are all of these is still a leaf (``aten::mm`` calls
# ``aten::resolve_conj``)
_TRIVIAL = frozenset(f"aten::{n}" for n in (
    "resolve_conj", "resolve_neg", "empty", "empty_strided", "empty_like",
    "as_strided", "view", "_unsafe_view", "t", "transpose", "expand",
    "reshape", "_reshape_alias", "detach", "unsqueeze", "squeeze",
    "permute", "select", "slice", "alias", "lift_fresh"))


def op_events(events: Sequence[Dict[str, Any]], cpu_ops: bool = False
              ) -> List[Dict[str, Any]]:
    """The trace's op events, each a copy renamed to its opmap key
    (``<position in events>:<name>``) and marked as an op (``args.hlo_op``,
    the mark :func:`measure_regions` counts ops by). The ops are the device
    events (kernels, copies, fills) — or, with ``cpu_ops``, the host's leaf
    ``aten::`` ops (no aten op nested inside them but view and alias
    bookkeeping), which is what a trace without a device holds."""
    out: List[Dict[str, Any]] = []
    if not cpu_ops:
        for i, e in enumerate(events):
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                out.append(dict(e, name=f"{i}:{e['name']}",
                                args=dict(e.get("args") or {},
                                          hlo_op=e["name"])))
        return out
    by_thread: Dict[Tuple[Any, Any], List[Tuple[int, Dict[str, Any]]]] = {}
    for i, e in enumerate(events):
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" and \
                str(e.get("name", "")).startswith("aten::"):
            by_thread.setdefault(_thread(e), []).append((i, e))
    for ops in by_thread.values():
        ops.sort(key=lambda x: (float(x[1]["ts"]), -float(x[1]["dur"])))
        for k, (i, e) in enumerate(ops):
            if e["name"] in _TRIVIAL:
                continue
            end = float(e["ts"]) + float(e["dur"])
            leaf = True
            for _, c in ops[k + 1:]:
                if float(c["ts"]) >= end:
                    break
                if c["name"] not in _TRIVIAL:
                    leaf = False
                    break
            if leaf:
                out.append(dict(e, name=f"{i}:{e['name']}",
                                args=dict(e.get("args") or {},
                                          hlo_op=e["name"])))
    return out


def _launch_points(events: Sequence[Dict[str, Any]],
                   ops: List[Dict[str, Any]], cpu_ops: bool
                   ) -> Dict[str, Tuple[Tuple[Any, Any], float]]:
    """``{op key: (host thread, ts)}``: where each op was issued — a
    kernel's launch call (joined by ``correlation``), or a host op's own
    start."""
    if cpu_ops:
        return {o["name"]: (_thread(o), float(o["ts"])) for o in ops}
    launches: Dict[Any, Tuple[Tuple[Any, Any], float]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (_thread(e), float(e["ts"]))
    out = {}
    for o in ops:
        corr = (o.get("args") or {}).get("correlation")
        if corr in launches:
            out[o["name"]] = launches[corr]
    return out


def _scope_regions(events: Sequence[Dict[str, Any]],
                   points: Dict[Any, Tuple[Tuple[Any, Any], float]]
                   ) -> Dict[Any, str]:
    """Region of each point from the innermost ``mfu.*`` range around it on
    its thread (points in none are absent)."""
    ranges: Dict[Tuple[Any, Any], List[Tuple[float, float, Any]]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            region = region_of(str(e.get("name", "")))
            if region is not None and str(e["name"]).startswith(
                    SCOPE_PREFIX):
                ts = float(e["ts"])
                ranges.setdefault(_thread(e), []).append(
                    (ts, ts + float(e["dur"]), region))
    queries: Dict[Tuple[Any, Any], List[Tuple[float, Any]]] = {}
    for qid, (thread, ts) in points.items():
        queries.setdefault(thread, []).append((ts, qid))
    out: Dict[Any, str] = {}
    for thread, qs in queries.items():
        out.update(_innermost(ranges.get(thread, []), qs))
    return out


def build_opmap(events: Sequence[Dict[str, Any]], cpu_ops: bool = False
                ) -> Dict[str, Dict[str, str]]:
    """A profiler trace's events → ``{op key: {"region", "category",
    "opcode"}}`` for every op of :func:`op_events` (``opcode`` is the
    kernel's or host op's name).

    Region precedence: NCCL kernel → ``collective``; the innermost
    ``mfu.*`` range around the op's launch; for a launch inside the
    backward, the region of the forward op whose ``Sequence number`` the
    enclosing ``evaluate_function`` carries; else ``other``."""
    ops = op_events(events, cpu_ops)
    points = _launch_points(events, ops, cpu_ops)
    direct = _scope_regions(events, points)
    # the backward: the innermost evaluate_function around each launch
    # that no mfu range names, and the forward ops by sequence number
    evals: Dict[Tuple[Any, Any], List[Tuple[float, float, Any]]] = {}
    forward: Dict[int, List[Tuple[Tuple[Any, Any], float]]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cpu_op":
            continue
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if seq is None:
            continue
        ts = float(e["ts"])
        if str(e["name"]).startswith(_EVAL_PREFIX):
            evals.setdefault(_thread(e), []).append(
                (ts, ts + float(e["dur"]), (int(seq),
                                            args.get("Fwd thread id"))))
        elif not args.get("Fwd thread id"):
            forward.setdefault(int(seq), []).append((_thread(e), ts))
    pending: Dict[Tuple[Any, Any], List[Tuple[float, Any]]] = {}
    for key, (thread, ts) in points.items():
        if key not in direct:
            pending.setdefault(thread, []).append((ts, key))
    nodes: Dict[Any, Tuple[int, Any]] = {}
    for thread, qs in pending.items():
        nodes.update(_innermost(evals.get(thread, []), qs))
    # a sequence number is per host thread: where two threads made a
    # forward op with the same one (the recomputed forward runs on the
    # backward's thread), the forward thread a backward node names is
    # learned from the numbers only one thread made
    fwd_thread: Dict[Any, Tuple[Any, Any]] = {}
    for seq, fwd_tid in nodes.values():
        cands = {t for t, _ in forward.get(seq, [])}
        if len(cands) == 1:
            fwd_thread.setdefault(fwd_tid, next(iter(cands)))
    firsts: Dict[Any, Tuple[Tuple[Any, Any], float]] = {}
    for key, (seq, fwd_tid) in nodes.items():
        cands = forward.get(seq, [])
        want = fwd_thread.get(fwd_tid)
        pick = [c for c in cands if c[0] == want] or cands
        if pick:
            firsts[key] = pick[0]
    via_forward = _scope_regions(events, firsts)
    out: Dict[str, Dict[str, str]] = {}
    for o in ops:
        key = o["name"]
        cat = _category(dict(o, name=o["args"]["hlo_op"]))
        region = ("collective" if cat == "collective" else
                  direct.get(key) or via_forward.get(key) or "other")
        out[key] = {"region": region, "category": cat,
                    "opcode": o["args"]["hlo_op"]}
    return out


# ------------------------------------------------------------------ trace IO
def _salvage_events(text: str) -> Tuple[List[Dict[str, Any]], bool]:
    """Chrome-trace JSON salvage: when ``json.loads`` fails (torn tail),
    walk the ``traceEvents`` array with a brace counter and keep every
    COMPLETE event object. Returns (events, salvaged_flag)."""
    try:
        d = json.loads(text)
        return list(d.get("traceEvents", [])), False
    except ValueError:
        pass
    events: List[Dict[str, Any]] = []
    idx = text.find('"traceEvents"')
    if idx < 0:
        return events, True
    idx = text.find("[", idx)
    if idx < 0:
        return events, True
    depth = 0
    start = None
    in_str = False
    esc = False
    for i in range(idx + 1, len(text)):
        c = text[i]
        if in_str:
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_str = False
            continue
        if c == '"':
            in_str = True
        elif c == "{":
            if depth == 0:
                start = i
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0 and start is not None:
                try:
                    events.append(json.loads(text[start:i + 1]))
                except ValueError:
                    pass
                start = None
        elif c == "]" and depth == 0:
            break
    return events, True


def parse_trace(path: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Load one Chrome-trace file (``.json`` or ``.json.gz``) with
    truncation salvage. Returns ``(duration_events, meta)`` where
    duration_events are the ``"ph" == "X"`` records and ``meta`` carries
    ``{"truncated": bool, "n_events": int, "path": str}``. A torn gzip
    stream (killed mid-write) decompresses to its last whole deflate block
    and the JSON salvage keeps every complete event — flagged, not fatal."""
    truncated = False
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return [], {"truncated": True, "n_events": 0, "path": path}
    if path.endswith(".gz") or raw[:2] == b"\x1f\x8b":
        try:
            text = gzip.decompress(raw).decode("utf-8", "replace")
        except (OSError, EOFError, zlib.error):
            # torn gzip: stream-decompress whatever whole blocks exist
            d = zlib.decompressobj(wbits=31)
            try:
                text = d.decompress(raw).decode("utf-8", "replace")
            except zlib.error:
                text = ""
            truncated = True
    else:
        text = raw.decode("utf-8", "replace")
    events, salvaged = _salvage_events(text)
    truncated = truncated or salvaged
    dur_events = [e for e in events
                  if e.get("ph") == "X" and "ts" in e and "dur" in e]
    return dur_events, {"truncated": truncated, "n_events": len(dur_events),
                        "path": path}


def find_trace(root: str) -> Optional[str]:
    """Newest ``*.trace.json.gz`` (or ``trace.json``) under ``root`` (the
    engine's window writes ``<root>/mfu_rank<N>.trace.json.gz``); a bare
    file path passes through."""
    if os.path.isfile(root):
        return root
    hits: List[str] = []
    for dirpath, _dirnames, files in os.walk(root):
        for f in files:
            if f.endswith((".trace.json.gz", "trace.json.gz", "trace.json")):
                hits.append(os.path.join(dirpath, f))
    return max(hits, key=lambda p: os.path.getmtime(p)) if hits else None


# ---------------------------------------------------------------- measurement
def _union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals (µs)."""
    ivs = sorted(intervals)
    total = 0.0
    cur_s = cur_e = None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _self_segments(events: List[Dict[str, Any]],
                   opmap: Dict[str, Dict[str, str]]
                   ) -> List[Tuple[float, float, str, str]]:
    """Flatten one THREAD's (properly nested) op events into disjoint
    ``(start, end, region, category)`` self-time segments: a ``while`` op's
    event covers its whole loop while every body op is ALSO recorded inside
    it — a plain duration sum double-counts that containment (observed
    1.7× on the CPU executor). Each event owns only the parts of its span
    not covered by a nested event."""
    es = sorted((e for e in events), key=lambda e: (e["ts"], -e["dur"]))
    segs: List[Tuple[float, float, str, str]] = []
    # stack entries: [end, cursor, region, category]; cursor = where this
    # event's uncovered span resumes after the current child
    stack: List[List[Any]] = []

    def pop_to(ts: float) -> None:
        while stack and stack[-1][0] <= ts:
            end, cursor, region, cat = stack.pop()
            if end > cursor:
                segs.append((cursor, end, region, cat))
            if stack:
                stack[-1][1] = max(stack[-1][1], end)

    for e in es:
        ts = float(e["ts"])
        end = ts + float(e["dur"])
        info = opmap[str(e["name"])]
        pop_to(ts)
        if stack and stack[-1][1] < ts:
            # parent's uncovered span up to this child
            segs.append((stack[-1][1], ts, stack[-1][2], stack[-1][3]))
            stack[-1][1] = ts
        stack.append([end, ts, info["region"], info["category"]])
    pop_to(float("inf"))
    return segs


def measure_regions(events: Sequence[Dict[str, Any]],
                    opmap: Dict[str, Dict[str, str]],
                    steps: int = 1) -> Dict[str, Any]:
    """Join timed trace events against the opmap into per-region and
    per-HLO-category seconds (per step).

    Attribution is WALL-CLOCK-exact, not duration-sum: per thread, nested
    events flatten to self-time segments (:func:`_self_segments`); across
    threads, every instant of the mapped-op union timeline is split evenly
    among the threads busy at that instant (the executor genuinely runs
    independent ops concurrently — billing both in full would overcount).
    So ``sum(regions) == mapped-op union`` by construction, and the ledger
    reconciliation catches the one thing that can still go missing:
    op events whose name is NOT in the opmap (``orphan_s``) — exactly what
    a typo'd/missing scope or a stale opmap produces.

    ``device_busy_s`` is the union over ALL op events (an event counts as
    an op when its name is in the opmap or it carries an ``hlo_op`` arg),
    mapped or not."""
    steps = max(1, int(steps))
    by_thread: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    all_intervals: List[Tuple[float, float]] = []
    n_mapped = n_orphan = 0
    for e in events:
        name = str(e.get("name", ""))
        mapped = name in opmap
        is_op = mapped or "hlo_op" in (e.get("args") or {})
        if not is_op:
            continue
        ts = float(e["ts"])
        all_intervals.append((ts, ts + float(e["dur"])))
        if not mapped:
            n_orphan += 1
            continue
        n_mapped += 1
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)

    # per-thread disjoint self segments → global even-split sweep
    threads = [
        _self_segments(es, opmap) for es in by_thread.values()]
    points: List[Tuple[float, int, int, str, str]] = []
    for ti, segs in enumerate(threads):
        for s, e, region, cat in segs:
            points.append((s, 1, ti, region, cat))
            points.append((e, -1, ti, region, cat))
    # closes (-1) before opens (+1) at equal t: per-thread segments are
    # disjoint, so a segment ending exactly where the next begins must
    # release the thread slot before the successor claims it
    points.sort(key=lambda p: (p[0], p[1]))
    regions: Dict[str, float] = {}
    categories: Dict[str, float] = {}
    active: Dict[int, Tuple[str, str]] = {}
    prev = None
    mapped_union = 0.0
    for t, kind, ti, region, cat in points:
        if prev is not None and active and t > prev:
            share = (t - prev) / len(active)
            mapped_union += t - prev
            for r, c in active.values():
                regions[r] = regions.get(r, 0.0) + share
                categories[c] = categories.get(c, 0.0) + share
        prev = t
        if kind == 1:
            active[ti] = (region, cat)
        else:
            active.pop(ti, None)

    union_all = _union_us(all_intervals)
    return {
        "regions": {r: s / 1e6 / steps for r, s in regions.items()},
        "categories": {c: s / 1e6 / steps for c, s in categories.items()},
        "device_busy_s": union_all / 1e6 / steps,
        "mapped_union_s": mapped_union / 1e6 / steps,
        "orphan_s": max(0.0, union_all - mapped_union) / 1e6 / steps,
        "n_mapped": n_mapped,
        "n_unmapped": n_orphan,
        "steps": steps,
    }


# -------------------------------------------------------------------- ledger
#: serialized-ledger schema (validated by tests and the report tool)
MFU_LEDGER_KEYS = ("schema_version", "step_s", "device_busy_s", "host_s",
                   "orphan_s", "model_flops", "peak_flops", "achieved_mfu",
                   "roofline_mfu", "waterfall", "regions", "top_sinks",
                   "reconciliation", "truncated_trace", "device")


def ledger(roofline: Optional[Dict[str, Any]],
           measured: Dict[str, Any],
           step_s: float,
           truncated_trace: bool = False) -> Dict[str, Any]:
    """The join: analytic roofline table + measured per-region times + the
    measured clean-step wall → the MFU ledger.

    ``roofline`` is ``analysis/roofline.py``'s serialized table
    (``{"device", "spec": {"peak_flops", ...}, "regions": {r: {"flops",
    "hbm_bytes", "comm_bytes", "achievable_s", "bound_by"}},
    "total_flops", "total_achievable_s"}``) — optional: without it the
    ledger is measured-only (no waterfall/verdicts), which is what a bare
    trace on a login node can still say.

    Waterfall semantics: ``hardware_peak`` is the time the step's analytic
    FLOPs would take at 100% MFU; ``roofline_achievable`` adds each
    region's binding resource (compute, HBM bytes, or comm bytes — the
    per-region max, summed, an optimistic no-overlap-needed floor);
    ``measured`` is the observed clean-step wall. Each level carries the
    MFU the step WOULD run at if time stopped there, so gap = distance
    between adjacent bars and names whether the model (peak→roofline) or
    the execution (roofline→measured) loses the time.

    Reconciliation: region times (``host`` = step wall − device-busy union,
    included) must re-sum to the step wall. Region attribution is
    wall-exact (``measure_regions``), so the frac moves away from 1.0 for
    exactly two reasons: ORPHANED op time (measured ops whose name the
    opmap doesn't know — a typo'd scope, a stale opmap) pushes it low, and
    a window that measured MORE than the claimed step (two steps fused,
    wrong window) pushes it high."""
    step_s = max(float(step_s), 1e-12)
    meas_regions = dict(measured.get("regions", {}))
    device_busy = float(measured.get("device_busy_s", 0.0))
    host_s = max(0.0, step_s - device_busy)
    meas_regions["host"] = host_s
    spec = (roofline or {}).get("spec", {})
    peak = float(spec.get("peak_flops", 0.0))
    total_flops = float((roofline or {}).get("total_flops", 0.0))
    roof_regions = (roofline or {}).get("regions", {})
    roof_total_s = float((roofline or {}).get("total_achievable_s", 0.0))

    regions_out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(set(meas_regions) | set(roof_regions)):
        meas = float(meas_regions.get(name, 0.0))
        roof = roof_regions.get(name, {})
        achievable = float(roof.get("achievable_s", 0.0))
        regions_out[name] = {
            "measured_s": meas,
            "frac": meas / step_s,
            "achievable_s": achievable,
            # measured/achievable: how far this region runs above its own
            # roofline floor (1.0 = at the roofline; 50 = 50x headroom)
            "headroom": (meas / achievable) if achievable > 0 else None,
            "bound_by": roof.get("bound_by"),
            "flops": float(roof.get("flops", 0.0)),
            "hbm_bytes": float(roof.get("hbm_bytes", 0.0)),
            "comm_bytes": float(roof.get("comm_bytes", 0.0)),
        }

    achieved_mfu = (total_flops / (step_s * peak)) if peak > 0 else None
    roofline_mfu = (total_flops / (roof_total_s * peak)
                    if peak > 0 and roof_total_s > 0 else None)
    waterfall = []
    if peak > 0 and total_flops > 0:
        peak_s = total_flops / peak
        waterfall = [
            {"level": "hardware_peak", "s": peak_s, "mfu": 1.0},
            {"level": "roofline_achievable", "s": roof_total_s,
             "mfu": roofline_mfu},
            {"level": "measured", "s": step_s, "mfu": achieved_mfu},
        ]
    sinks = sorted((r for r in regions_out if r != "host"),
                   key=lambda r: -regions_out[r]["measured_s"])
    region_sum = sum(v["measured_s"] for v in regions_out.values())
    return {
        "schema_version": 1,
        "step_s": step_s,
        "device_busy_s": device_busy,
        "host_s": host_s,
        "orphan_s": float(measured.get("orphan_s", 0.0)),
        "model_flops": total_flops,
        "peak_flops": peak,
        "achieved_mfu": achieved_mfu,
        "roofline_mfu": roofline_mfu,
        "waterfall": waterfall,
        "regions": regions_out,
        "top_sinks": sinks[:5],
        "reconciliation": {"region_sum_s": region_sum, "step_s": step_s,
                           "frac": region_sum / step_s},
        "truncated_trace": bool(truncated_trace),
        "device": (roofline or {}).get("device"),
        "categories": dict(measured.get("categories", {})),
    }


def validate_ledger(d: Dict[str, Any]) -> List[str]:
    """Missing-key check against :data:`MFU_LEDGER_KEYS` (schema v1)."""
    return [k for k in MFU_LEDGER_KEYS if k not in d]


def ledger_events(led: Dict[str, Any], step: int = 0
                  ) -> List[Tuple[str, Any, int]]:
    """Strict-registry ``MFU/*`` scalar events from a ledger (dot-tail
    region members — ``MFU/region.attn`` — so the static event-name lint
    resolves every literal)."""
    ev: List[Tuple[str, Any, int]] = [
        ("MFU/step_s", led["step_s"], step),
        ("MFU/device_busy_s", led["device_busy_s"], step),
    ]
    if led.get("achieved_mfu") is not None:
        ev.append(("MFU/achieved", led["achieved_mfu"], step))
    if led.get("roofline_mfu") is not None:
        ev.append(("MFU/roofline_bound", led["roofline_mfu"], step))
    if led.get("model_flops"):
        ev.append(("MFU/model_tflops", led["model_flops"] / 1e12, step))
    for name in REGIONS:
        r = led["regions"].get(name)
        if r is not None:
            # members enumerated from REGIONS, each declared exactly in
            # EVENT_NAMES — the base below never ships a typo'd member
            ev.append((f"MFU/region.{name}",
                       r["measured_s"], step))
    return ev


# -------------------------------------------------------------------- render
def _fmt_s(sec: Optional[float]) -> str:
    if sec is None:
        return "     -"
    if sec < 1e-3:
        return f"{sec * 1e6:.0f}us"
    return f"{sec * 1000:.1f}ms" if sec < 1.0 else f"{sec:.2f}s"


def _fmt_pct(x: Optional[float]) -> str:
    return "    -" if x is None else f"{100.0 * x:5.1f}%"


def render_ledger(led: Dict[str, Any], top: int = 10) -> str:
    """Human-readable ledger: waterfall, per-region table, top sinks."""
    lines = ["MFU ledger" + (f" — device {led['device']}"
                             if led.get("device") else "")]
    if led.get("truncated_trace"):
        lines.append("  WARNING: trace window was truncated — measured "
                     "times are a lower bound")
    if led.get("achieved_mfu") is not None:
        lines.append(f"  achieved MFU: {_fmt_pct(led['achieved_mfu'])} "
                     f"({led['model_flops'] / 1e12:.3f} TFLOP analytic step "
                     f"in {_fmt_s(led['step_s'])})")
    if led.get("waterfall"):
        lines.append("  gap waterfall (where would the step be if time "
                     "stopped at each level):")
        for w in led["waterfall"]:
            lines.append(f"    {w['level']:<22}{_fmt_s(w['s']):>10}  "
                         f"MFU {_fmt_pct(w.get('mfu'))}")
    regions = led.get("regions", {})
    if regions:
        lines.append(f"  {'region':<12}{'measured':>10}{'share':>8}"
                     f"{'roofline':>10}{'headroom':>10}  bound by")
        order = sorted(regions, key=lambda r: -regions[r]["measured_s"])
        for name in order:
            r = regions[name]
            if r["measured_s"] <= 0 and r["achievable_s"] <= 0:
                continue
            head = (f"{r['headroom']:8.1f}x" if r.get("headroom")
                    else "       -")
            lines.append(
                f"  {name:<12}{_fmt_s(r['measured_s']):>10}"
                f"{_fmt_pct(r['frac']):>8}{_fmt_s(r['achievable_s']):>10}"
                f"{head:>10}  {r.get('bound_by') or '-'}")
    sinks = led.get("top_sinks", [])[:top]
    if sinks:
        lines.append("  top sinks: " + ", ".join(
            f"{s} ({_fmt_s(regions[s]['measured_s'])})" for s in sinks))
    rec = led.get("reconciliation", {})
    if rec:
        frac = rec.get("frac", 0.0)
        flag = "" if abs(frac - 1.0) <= 0.05 else \
            "  <-- regions do not re-sum to the step (orphaned ops or " \
            "wrong window)"
        lines.append(f"  reconciliation: region sum "
                     f"{_fmt_s(rec.get('region_sum_s'))} vs step "
                     f"{_fmt_s(rec.get('step_s'))} "
                     f"({_fmt_pct(frac)} accounted){flag}")
        if led.get("orphan_s"):
            lines.append(f"  orphaned op time (not in opmap): "
                         f"{_fmt_s(led['orphan_s'])}")
    cats = led.get("categories", {})
    if cats:
        order = sorted(cats, key=lambda c: -cats[c])
        lines.append("  by HLO category: " + ", ".join(
            f"{c}={_fmt_s(cats[c])}" for c in order if cats[c] > 0))
    return "\n".join(lines)


# ----------------------------------------------------------------------- CLI
_POSITION_KEY = re.compile(r"^[0-9]+:")


def _load_json(path: Optional[str], what: str) -> Optional[dict]:
    import sys

    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        print(f"  note: cannot read {what} {path}: {e}", file=sys.stderr)
        return None


def main(argv: Optional[List[str]] = None) -> int:
    """Render a captured MFU trace window into the step-time attribution
    ledger (``tools/mfu_report.py``'s contract). Exit 0 on success, 2
    when no trace yields any op events."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m deepspeedsyclsupport_tpu_torch.monitor.mfu",
        description="Render a captured MFU trace window into the step-time "
                    "attribution ledger.")
    ap.add_argument("input",
                    help="trace dir (engine's mfu_trace_rank<N>, searched "
                         "for the newest trace + sidecar JSONs) or a bare "
                         "trace.json[.gz]")
    ap.add_argument("--opmap", help="mfu_opmap.json override")
    ap.add_argument("--roofline", help="mfu_roofline.json override")
    ap.add_argument("--window", help="mfu_window.json override")
    ap.add_argument("--step-s", type=float, default=None,
                    help="measured clean-step seconds (overrides the "
                         "window sidecar)")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps covered by the trace window (default from "
                         "the window sidecar, else 1)")
    ap.add_argument("--json", metavar="OUT",
                    help="also write the serialized ledger (schema "
                         "monitor/mfu.py MFU_LEDGER_KEYS) to this file")
    args = ap.parse_args(argv)

    root = os.path.expanduser(args.input)
    trace_path = find_trace(root)
    if trace_path is None:
        print(f"error: no trace file found under {root}", file=sys.stderr)
        return 2
    side = os.path.dirname(root) if os.path.isfile(root) else root
    opmap = _load_json(args.opmap or os.path.join(side, "mfu_opmap.json"),
                       "opmap")
    roofline = _load_json(
        args.roofline or os.path.join(side, "mfu_roofline.json"), "roofline")
    window = _load_json(
        args.window or os.path.join(side, "mfu_window.json"), "window") or {}

    events, meta = parse_trace(trace_path)
    if meta["truncated"]:
        print(f"  note: {trace_path}: truncated — salvaged "
              f"{meta['n_events']} event(s)", file=sys.stderr)
    if not events:
        print(f"error: {trace_path} holds no duration events",
              file=sys.stderr)
        return 2
    if opmap is None:
        print("error: no opmap (mfu_opmap.json) — the region join needs "
              "the window's op->region map; pass --opmap or rerun with "
              "telemetry.mfu so the engine persists it", file=sys.stderr)
        return 2
    if any(_POSITION_KEY.match(k) for k in opmap):
        # the port's opmap: the device ops, else the host's leaf aten ops
        events = op_events(events) or op_events(events, cpu_ops=True)

    steps = args.steps or int(window.get("steps", 1))
    measured = measure_regions(events, opmap, steps=steps)
    if measured["n_mapped"] == 0:
        print("error: no trace event matches the opmap (trace and opmap "
              "from different programs?)", file=sys.stderr)
        return 2
    step_s = args.step_s or window.get("step_s")
    if step_s is None:
        print("  note: no step wall (mfu_window.json / --step-s) — using "
              "the device-busy union; host time reads as 0",
              file=sys.stderr)
        step_s = measured["device_busy_s"]
    led = ledger(roofline, measured, float(step_s),
                 truncated_trace=meta["truncated"])
    print(render_ledger(led))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(led, f, indent=1, sort_keys=True)
        print(f"ledger written to {args.json}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
