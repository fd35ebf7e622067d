"""Request-time attribution: stage registry, journal join, TTFT/ITL waterfall.

The serving-side sibling of the MFU ledger (``monitor/mfu.py``):
``Serve/ttft_s`` p95 says a request was slow, not whether edge admission,
router queueing, replica spool transport, chunked prefill, fused-decode
rounds, preemption/requeue or failover replay ate the budget. This module
owns the three pieces that answer it:

* **stage registry** — :data:`SERVE_STAGES` / :data:`FLEET_STAGES`, the
  canonical lifecycle-stage names. ``ServingSession``/``RequestJournal``
  stamp ``serve/stage`` records and ``FleetRouter`` stamps ``fleet/stage``
  records with these literals riding the EXISTING journal / flight-recorder
  streams (no second transport); ``monitor/telemetry.py`` enumerates the
  strict ``Serve/stage.*`` / ``Fleet/stage.*`` event families from these
  tuples, and dslint's ``undeclared-stage-name`` rule rejects any literal
  outside them (the ``undeclared-region`` pattern).
* **join** — :func:`join_traces` fuses the router stream + per-replica
  journals (uid-keyed, wall-``t`` ordered, torn-tail salvaged) into
  per-request span trees that survive generation respawns and failover:
  a replayed request's trace spans the dead replica's segment and the
  survivor's replay segment. Stage self-times are a telescoping partition
  of the request's timeline, so the reconciliation contract holds by
  construction: stage sums match the journal-observed enqueue→close wall
  time within 5%, residual reported as ``unattributed``.
* **attribution** — :func:`attribution`: TTFT and ITL decomposed per stage
  at p50/p95/p99, tail attribution (which stage grew for the slowest
  decile vs the median cohort), SLO burn over sliding windows, and the
  N worst requests' waterfalls — the ``detail.request_waterfall`` payload
  the bench rungs emit and ``tools/trace_report.py --requests`` renders.

A copy of ``deepspeedsyclsupport_tpu/monitor/reqtrace.py`` (stdlib-only):
the PyTorch port keeps its own so that it imports nothing of the JAX
package. Journals written by either package join alike here and there.
Telemetry and serving import FROM here, never the reverse.
"""
import glob as _glob
import json
import math
import os
import re
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Tuple)

#: Canonical replica-side lifecycle stages. The first block are STAMPED —
#: ``ServingSession``/``serve_worker`` write ``serve/stage`` records with
#: these literals (dslint's ``undeclared-stage-name`` rule rejects any
#: other). The rest are DERIVED by the join from the emit/close stream:
#: ``decode`` from inter-emit gaps, ``finalize`` (last emit → close),
#: ``unattributed`` (any interval the classifier cannot name — the
#: reconciliation residual).
STAMPED_SERVE_STAGES = ("gate", "queue_wait", "requeue_wait", "prefill",
                        "prefill_chunk", "decode_round", "preempt",
                        "replay", "spool_wait")
DERIVED_SERVE_STAGES = ("decode", "finalize", "unattributed")
SERVE_STAGES = STAMPED_SERVE_STAGES + DERIVED_SERVE_STAGES

#: Router-side stages (``fleet/stage`` records). ``transport`` is derived:
#: the route→replica-admit gap (spool wait + process hop for
#: ``ProcessReplica``; ~0 in-process).
STAMPED_FLEET_STAGES = ("edge_gate", "placement", "failover_claim",
                        "replay_segment")
DERIVED_FLEET_STAGES = ("transport",)
FLEET_STAGES = STAMPED_FLEET_STAGES + DERIVED_FLEET_STAGES

#: Stages whose per-request self-time the session observes into
#: ``Serve/stage.<name>_s`` histograms at close (queue wait has its own
#: satellite family, ``Serve/queue_wait_s``).
STAGE_HISTOGRAMS = ("prefill", "decode")

_SERVE_STAGE_SET = frozenset(SERVE_STAGES)
_FLEET_STAGE_SET = frozenset(FLEET_STAGES)


def check_stage(name: str, fleet: bool = False) -> str:
    """Validate a stage literal against the registry — the runtime twin of
    dslint's ``undeclared-stage-name`` rule (``mfu.region_scope`` pattern:
    a typo'd stage must fail loudly, not silently orphan its time)."""
    ok = name in (_FLEET_STAGE_SET if fleet else _SERVE_STAGE_SET)
    if not ok:
        kind = "fleet" if fleet else "serve"
        declared = FLEET_STAGES if fleet else SERVE_STAGES
        raise ValueError(f"undeclared {kind} stage {name!r}; declared: "
                         f"{declared} (monitor/reqtrace.py)")
    return name


# =========================================================================
# Stream loading (torn-tail salvage; the load_journal contract)
# =========================================================================


def load_stream(path: str) -> List[Dict[str, Any]]:
    """Parse one JSONL stream; a torn final line (crash mid-write) is
    skipped, not fatal — everything before it was flushed durably."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return []
    out: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail
        if isinstance(rec, dict):
            out.append(rec)
    return out


_ATT_RE = re.compile(r"\.att([0-9.]+)\.jsonl$")


def file_attempt(path: str) -> str:
    """Generation/attempt suffix from a journal filename
    (``journal_rank0.att1.0.jsonl`` → ``"1.0"``; ``DSTPU_FLEET_GEN``
    namespaces the attempt — ``supervisor.journal_path``)."""
    m = _ATT_RE.search(os.path.basename(path))
    return m.group(1) if m else ""


def discover_root(root: str) -> Tuple[Dict[str, List[str]], List[str]]:
    """Fleet-root layout discovery: ``{replica_id: [journal files]}``
    (oldest incarnation first) plus the router stream files. Accepts a
    fleet root (``replica<id>/journal/``), a bare journal dir, or a dir
    of journals + ``router*.jsonl`` side by side."""
    replicas: Dict[str, List[str]] = {}
    if os.path.isdir(root):
        for sub in sorted(os.listdir(root)):
            jdir = os.path.join(root, sub, "journal")
            if sub.startswith("replica") and os.path.isdir(jdir):
                files = sorted(
                    _glob.glob(os.path.join(jdir, "journal_rank*.jsonl")),
                    key=lambda p: (os.path.getmtime(p), p))
                if files:
                    replicas[sub[len("replica"):]] = files
        if not replicas:
            files = sorted(
                _glob.glob(os.path.join(root, "journal_rank*.jsonl")),
                key=lambda p: (os.path.getmtime(p), p))
            if files:
                replicas["0"] = files
    router = sorted(_glob.glob(os.path.join(root, "router*.jsonl"))
                    ) if os.path.isdir(root) else []
    return replicas, router


# =========================================================================
# Join: streams → per-request span trees
# =========================================================================

#: Interval classifier: (previous edge, next edge) → stage. Every named
#: interval is a consecutive slice of the request's timeline, so the
#: per-stage self-times telescope to enqueue→close exactly — the 5%
#: reconciliation contract holds unless records are missing (torn tail),
#: and THAT shortfall is what ``unattributed`` reports.
_INTERVAL_STAGE = {
    ("route", "admit"): "transport",
    ("admit", "activate"): "queue_wait",
    ("admit", "emit"): "prefill",       # activation record lost (torn tail)
    ("admit", "close"): "queue_wait",   # closed while queued (shed/timeout)
    ("admit", "admit"): "replay",       # died before activation, replayed
    ("admit", "preempt"): "queue_wait",
    ("activate", "emit"): "prefill",
    ("activate", "close"): "prefill",
    ("activate", "preempt"): "prefill",
    ("activate", "admit"): "replay",
    ("emit", "emit"): "decode",
    ("emit", "preempt"): "decode",
    ("emit", "close"): "finalize",
    ("emit", "admit"): "replay",        # dead-replica gap → survivor admit
    ("preempt", "activate"): "requeue_wait",
    ("preempt", "close"): "requeue_wait",
    ("preempt", "admit"): "replay",
}


def _new_trace(uid: int) -> Dict[str, Any]:
    return {"uid": uid, "segments": [], "intervals": [], "stages": {},
            "t_route": None, "t_admit": None, "t_first_emit": None,
            "t_close": None, "ttft_s": None, "wall_s": None,
            "unattributed_s": 0.0, "reconciled_frac": None,
            "tokens": 0, "closes": 0, "close_reason": "", "outcome": "",
            "cached_prefix_len": None, "spool_wait_s": 0.0,
            "rounds": {"fused": 0, "per_token": 0},
            "ttft_sla_s": None, "tenant": "", "verdicts": [],
            "replays": 0, "replica_path": []}


def join_traces(streams: Iterable[Tuple[str, str, Sequence[Dict[str, Any]]]],
                router_records: Sequence[Dict[str, Any]] = (),
                since: Optional[float] = None) -> Dict[int, Dict[str, Any]]:
    """Fuse router stream + per-replica journal streams into per-request
    span trees.

    ``streams`` is ``[(replica_id, attempt, records), ...]`` — what
    :func:`join_root` builds from disk, or what a caller hands over from
    in-memory ``trace_log`` buffers (``ServingSession.trace_log`` /
    ``FleetRouter.trace_log``). Records are ordered by wall ``t`` (the one
    clock every stream stamps) with append order breaking ties, so a
    replayed request's trace spans replicas and generations. ``since``
    drops requests whose first record predates it (per-load-point joins
    over an accumulating journal dir).
    """
    # (t, idx, kind, payload) per uid; router records first so same-t route
    # edges sort ahead of the replica admit they caused
    events: Dict[int, List[Tuple[float, int, str, Dict[str, Any]]]] = {}
    idx = 0

    def _push(uid: int, t: float, kind: str, payload: Dict[str, Any]) -> None:
        nonlocal idx
        if int(uid) < 0:
            # batch-scope stamps (decode_round fanout carriers, the
            # router's fleet-wide failover_claim) are not requests
            return
        idx += 1
        events.setdefault(int(uid), []).append((float(t), idx, kind, payload))

    for rec in router_records:
        name = rec.get("name")
        data = rec.get("data") or {}
        t = float(rec.get("t", 0.0))
        uid = data.get("uid")
        if uid is None:
            continue
        if name == "fleet/route":
            _push(uid, t, "route", {"replica": data.get("replica", "")})
        elif name == "fleet/shed":
            _push(uid, t, "edge_shed", {"reason": data.get("reason", "")})
        elif name == "fleet/stage":
            _push(uid, t, "fleet_stage", dict(data))
        elif name == "fleet/failover":
            _push(uid, t, "failover", dict(data))
    for replica_id, attempt, records in streams:
        for rec in records:
            name = rec.get("name")
            data = rec.get("data") or {}
            t = float(rec.get("t", 0.0))
            uid = data.get("uid")
            if uid is None:
                continue
            if name == "serve/admit":
                n_prompt = data.get("n_tokens",
                                    len(data.get("tokens", []) or []))
                _push(uid, t, "admit", {
                    "replica": replica_id, "attempt": attempt,
                    "replayed": bool(data.get("replayed")),
                    "out_n": data.get("watermark",
                                      len(data.get("out", []) or [])),
                    "tenant": data.get("tenant", ""),
                    "ttft_sla_s": data.get("ttft_sla_s"),
                    "n_prompt": int(n_prompt)})
            elif name == "serve/emit":
                _push(uid, t, "emit",
                      {"n": int(data.get("n",
                                         len(data.get("tokens", []) or [])))})
            elif name == "serve/close":
                _push(uid, t, "close", {"reason": data.get("reason", "")})
            elif name == "serve/stage":
                stage = data.get("stage", "")
                if stage == "decode_round":
                    for u in data.get("uids", ()):
                        _push(u, t, "round",
                              {"mode": data.get("mode", "per_token")})
                elif stage in ("queue_wait", "requeue_wait"):
                    _push(uid, t, "activate", dict(data))
                elif stage == "preempt":
                    _push(uid, t, "preempt", dict(data))
                else:
                    _push(uid, t, "stage", dict(data))

    traces: Dict[int, Dict[str, Any]] = {}
    for uid, evs in events.items():
        evs.sort(key=lambda e: (e[0], e[1]))
        if since is not None and evs[0][0] < since:
            continue
        tr = _new_trace(uid)
        prev: Optional[Tuple[float, str]] = None  # last EDGE (t, kind)
        seg: Optional[Dict[str, Any]] = None
        for t, _i, kind, payload in evs:
            if kind == "round":
                key = ("fused" if payload.get("mode") == "fused"
                       else "per_token")
                tr["rounds"][key] += 1
                continue
            if kind == "stage":
                stage = payload.get("stage", "")
                if stage == "spool_wait":
                    tr["spool_wait_s"] += float(payload.get("dur", 0.0))
                elif stage == "gate":
                    tr["verdicts"].append(payload.get("verdict", ""))
                elif stage == "prefill":
                    if payload.get("cached_prefix_len") is not None:
                        tr["cached_prefix_len"] = int(
                            payload["cached_prefix_len"])
                continue
            if kind == "fleet_stage":
                stage = payload.get("stage", "")
                if stage == "placement":
                    tr["verdicts"].append("routed")
                elif stage == "edge_gate":
                    tr["verdicts"].append(payload.get("verdict", ""))
                continue
            if kind == "failover":
                if payload.get("outcome") in ("replayed", "dispatched"):
                    tr["replays"] += 1
                continue
            if kind == "edge_shed":
                tr["outcome"] = "edge_shed"
                tr["close_reason"] = f"edge_shed:{payload.get('reason', '')}"
                continue
            # ---- timeline edges -------------------------------------
            if kind == "route":
                # metadata edge: seeds t_route / the replica path and, at
                # stream start, the transport interval. A route stamp can
                # land AFTER the replica's admit (an in-process submit
                # returns before the router records the route) — it must
                # not reset ``prev`` mid-chain or the admit→activate→emit
                # intervals it would interrupt become unattributed.
                tr["t_route"] = t if tr["t_route"] is None else tr["t_route"]
                rep = payload.get("replica", "")
                if rep and (not tr["replica_path"]
                            or tr["replica_path"][-1] != rep):
                    tr["replica_path"].append(rep)
                if prev is None:
                    prev = (t, kind)
                continue
            if prev is not None:
                dt = max(0.0, t - prev[0])
                stage = _INTERVAL_STAGE.get((prev[1], kind), "unattributed")
                if dt > 0:
                    tr["intervals"].append((stage, prev[0], t))
            if kind == "admit":
                if tr["t_admit"] is None:
                    tr["t_admit"] = t
                    tr["tenant"] = payload.get("tenant", "")
                    tr["ttft_sla_s"] = payload.get("ttft_sla_s")
                seg = {"replica": payload.get("replica", ""),
                       "attempt": payload.get("attempt", ""),
                       "replayed": payload.get("replayed", False),
                       "watermark": payload.get("out_n", 0),
                       "t_admit": t, "t_first_emit": None,
                       "t_last": t, "closed": False, "tokens": 0}
                tr["segments"].append(seg)
                if payload.get("replica") and (
                        not tr["replica_path"]
                        or tr["replica_path"][-1] != payload["replica"]):
                    tr["replica_path"].append(payload["replica"])
            elif kind == "activate":
                if seg is not None:
                    seg["t_last"] = t
                if payload.get("cached_prefix_len") is not None \
                        and tr["cached_prefix_len"] is None:
                    tr["cached_prefix_len"] = int(payload["cached_prefix_len"])
            elif kind == "emit":
                if tr["t_first_emit"] is None:
                    tr["t_first_emit"] = t
                tr["tokens"] += payload.get("n", 0)
                if seg is not None:
                    if seg["t_first_emit"] is None:
                        seg["t_first_emit"] = t
                    seg["t_last"] = t
                    seg["tokens"] += payload.get("n", 0)
            elif kind == "preempt":
                if seg is not None:
                    seg["t_last"] = t
            elif kind == "close":
                tr["closes"] += 1
                tr["t_close"] = t
                tr["close_reason"] = payload.get("reason", "")
                if seg is not None:
                    seg["closed"] = True
                    seg["t_last"] = t
            prev = (t, kind)
        # ---- derived summary ----------------------------------------
        if tr["t_admit"] is not None and tr["t_first_emit"] is not None \
                and tr["segments"] and not tr["segments"][0]["replayed"]:
            tr["ttft_s"] = tr["t_first_emit"] - tr["t_admit"]
        if tr["t_admit"] is not None and tr["t_close"] is not None:
            tr["wall_s"] = max(0.0, tr["t_close"] - tr["t_admit"])
            for stage, t0, t1 in tr["intervals"]:
                if t0 >= tr["t_admit"]:  # transport precedes enqueue
                    tr["stages"][stage] = (tr["stages"].get(stage, 0.0)
                                           + (t1 - t0))
            attributed = sum(v for s, v in tr["stages"].items()
                             if s != "unattributed")
            tr["unattributed_s"] = max(0.0, tr["wall_s"] - attributed)
            tr["reconciled_frac"] = (1.0 if tr["wall_s"] <= 0 else
                                     min(1.0, attributed / tr["wall_s"]))
        if not tr["outcome"]:
            reason = tr["close_reason"]
            tr["outcome"] = ("open" if tr["closes"] == 0 else
                             "shed" if reason.startswith("shed")
                             or reason == "replay_shed" else "closed")
        traces[uid] = tr
    return traces


def join_root(root: str, since: Optional[float] = None
              ) -> Dict[int, Dict[str, Any]]:
    """Disk entry point: discover + load + join a fleet root (or bare
    journal dir)."""
    replicas, router_files = discover_root(root)
    router_records: List[Dict[str, Any]] = []
    for path in router_files:
        router_records.extend(load_stream(path))
    streams = [(rid, file_attempt(path), load_stream(path))
               for rid, files in sorted(replicas.items()) for path in files]
    return join_traces(streams, router_records, since=since)


# =========================================================================
# Attribution: traces → TTFT/ITL waterfall, tail, SLO burn, exemplars
# =========================================================================


def _rank_quantile(vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank quantile (exact, no interpolation — these are offline
    joins over full populations, not streaming buckets)."""
    if not vals:
        return None
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def _quantiles(vals: Sequence[float]) -> Dict[str, Optional[float]]:
    return {f"p{int(q * 100)}": _rank_quantile(vals, q)
            for q in (0.5, 0.95, 0.99)}


def _clip_stages(tr: Dict[str, Any], t0: float, t1: float
                 ) -> Dict[str, float]:
    """Per-stage seconds inside the window [t0, t1] (interval clipping)."""
    out: Dict[str, float] = {}
    for stage, a, b in tr["intervals"]:
        lo, hi = max(a, t0), min(b, t1)
        if hi > lo:
            out[stage] = out.get(stage, 0.0) + (hi - lo)
    return out


def slo_burn_windows(traces: Dict[int, Dict[str, Any]],
                     window_s: float = 60.0, budget: float = 0.05
                     ) -> List[Dict[str, Any]]:
    """TTFT-SLO burn rate over fixed sliding windows: per window the
    fraction of first tokens that missed their per-request SLA, divided by
    the error budget (burn > 1 ⇒ the budget is being spent faster than it
    accrues — the standard multi-window burn-rate alerting input)."""
    samples = [(tr["t_first_emit"],
                tr["ttft_s"] is not None and tr["ttft_sla_s"] is not None
                and tr["ttft_s"] <= tr["ttft_sla_s"])
               for tr in traces.values()
               if tr["t_first_emit"] is not None
               and tr["ttft_sla_s"] is not None and tr["ttft_s"] is not None]
    if not samples:
        return []
    samples.sort()
    t_lo, t_hi = samples[0][0], samples[-1][0]
    out: List[Dict[str, Any]] = []
    t = t_lo
    while t <= t_hi:
        inside = [ok for ts, ok in samples if t <= ts < t + window_s]
        if inside:
            miss = 1.0 - sum(inside) / len(inside)
            out.append({"t0": t, "n": len(inside),
                        "miss_frac": round(miss, 4),
                        "burn": round(miss / max(budget, 1e-9), 3)})
        t += window_s
    return out


def attribution(traces: Dict[int, Dict[str, Any]], worst_n: int = 5,
                slo_window_s: float = 60.0, slo_budget: float = 0.05
                ) -> Dict[str, Any]:
    """The request waterfall: stage-decomposed TTFT/ITL quantiles, tail
    attribution, reconciliation summary, SLO burn and worst-request
    exemplars — the ``detail.request_waterfall`` payload."""
    done = [tr for tr in traces.values()
            if tr["t_admit"] is not None and tr["t_close"] is not None]
    firsts = [tr for tr in done if tr["ttft_s"] is not None]
    out: Dict[str, Any] = {
        "requests": len(traces), "closed": len(done),
        "edge_sheds": sum(1 for tr in traces.values()
                          if tr["outcome"] == "edge_shed"),
        "multi_close": sum(1 for tr in traces.values() if tr["closes"] > 1),
        "failover_spans": sum(1 for tr in done if tr["replays"] > 0
                              or len({s["replica"]
                                      for s in tr["segments"]}) > 1),
    }
    recon = [tr["reconciled_frac"] for tr in done
             if tr["reconciled_frac"] is not None]
    out["reconciliation"] = {
        "median_frac": _rank_quantile(recon, 0.5),
        "min_frac": min(recon) if recon else None,
        "within_5pct_frac": (round(sum(1 for f in recon if f >= 0.95)
                                   / len(recon), 4) if recon else None)}
    # ---- TTFT decomposition --------------------------------------------
    stage_ttft: Dict[str, List[float]] = {}
    for tr in firsts:
        clipped = _clip_stages(tr, tr["t_admit"], tr["t_first_emit"])
        for stage in set(clipped) | set(stage_ttft):
            stage_ttft.setdefault(stage, []).append(clipped.get(stage, 0.0))
    # equal-length arrays (zeros for requests lacking a stage) so quantile
    # ranks align across stages
    n_first = len(firsts)
    for stage, vals in stage_ttft.items():
        vals.extend(0.0 for _ in range(n_first - len(vals)))
    out["ttft"] = _quantiles([tr["ttft_s"] for tr in firsts])
    out["ttft_by_stage"] = {
        stage: {**_quantiles(vals),
                "mean_s": round(sum(vals) / len(vals), 6) if vals else 0.0}
        for stage, vals in sorted(stage_ttft.items())}
    means = {s: v["mean_s"] for s, v in out["ttft_by_stage"].items()}
    out["dominant_ttft_stage"] = (max(means, key=means.get)
                                  if means else None)
    # ---- ITL decomposition (per emitted token past the first) ----------
    stage_itl: Dict[str, List[float]] = {}
    decoders = [tr for tr in done if tr["t_first_emit"] is not None
                and tr["tokens"] > 1]
    for tr in decoders:
        clipped = _clip_stages(tr, tr["t_first_emit"], tr["t_close"])
        denom = max(1, tr["tokens"] - 1)
        for stage in set(clipped) | set(stage_itl):
            stage_itl.setdefault(stage, []).append(
                clipped.get(stage, 0.0) / denom)
    n_dec = len(decoders)
    for stage, vals in stage_itl.items():
        vals.extend(0.0 for _ in range(n_dec - len(vals)))
    out["itl_by_stage"] = {
        stage: {**_quantiles(vals),
                "mean_s": round(sum(vals) / len(vals), 6) if vals else 0.0}
        for stage, vals in sorted(stage_itl.items())}
    # ---- tail attribution: slowest TTFT decile vs the median cohort ----
    if len(firsts) >= 4:
        ranked = sorted(firsts, key=lambda tr: tr["ttft_s"])
        n = len(ranked)
        tail = ranked[max(0, n - max(1, n // 10)):]
        mid = ranked[n // 4: max(n // 4 + 1, 3 * n // 4)]

        def _mean_stages(group):
            acc: Dict[str, float] = {}
            for tr in group:
                for stage, v in _clip_stages(
                        tr, tr["t_admit"], tr["t_first_emit"]).items():
                    acc[stage] = acc.get(stage, 0.0) + v
            return {s: v / len(group) for s, v in acc.items()}

        tail_m, mid_m = _mean_stages(tail), _mean_stages(mid)
        by_stage = {
            stage: {"median_s": round(mid_m.get(stage, 0.0), 6),
                    "tail_s": round(tail_m.get(stage, 0.0), 6),
                    "growth_s": round(tail_m.get(stage, 0.0)
                                      - mid_m.get(stage, 0.0), 6)}
            for stage in sorted(set(tail_m) | set(mid_m))}
        growth = {s: v["growth_s"] for s, v in by_stage.items()}
        out["tail"] = {
            "tail_n": len(tail), "median_n": len(mid),
            "by_stage": by_stage,
            "dominant_stage": (max(growth, key=growth.get)
                               if growth else None)}
    else:
        out["tail"] = None
    # ---- decode mode + prefix visibility -------------------------------
    out["decode_rounds"] = {
        "fused": sum(tr["rounds"]["fused"] for tr in done),
        "per_token": sum(tr["rounds"]["per_token"] for tr in done)}
    cached = [tr["cached_prefix_len"] for tr in done
              if tr["cached_prefix_len"] is not None]
    out["cached_prefix_tokens_mean"] = (
        round(sum(cached) / len(cached), 2) if cached else None)
    # ---- SLO burn ------------------------------------------------------
    burn = slo_burn_windows(traces, window_s=slo_window_s, budget=slo_budget)
    out["slo_burn"] = {
        "window_s": slo_window_s, "budget": slo_budget,
        "windows": burn,
        "max_burn": max((w["burn"] for w in burn), default=None)}
    # ---- worst-request exemplar waterfalls -----------------------------
    ranked = sorted(firsts, key=lambda tr: -(tr["ttft_s"] or 0.0))
    out["worst"] = [
        {"uid": tr["uid"], "ttft_s": round(tr["ttft_s"], 6),
         "wall_s": round(tr["wall_s"], 6) if tr["wall_s"] is not None
         else None,
         "tokens": tr["tokens"], "close_reason": tr["close_reason"],
         "replays": tr["replays"],
         "replica_path": tr["replica_path"],
         "cached_prefix_len": tr["cached_prefix_len"],
         "unattributed_s": round(tr["unattributed_s"], 6),
         "stages": {s: round(v, 6) for s, v in sorted(tr["stages"].items())}}
        for tr in ranked[:worst_n]]
    return out


def waterfall(streams: Iterable[Tuple[str, str, Sequence[Dict[str, Any]]]],
              router_records: Sequence[Dict[str, Any]] = (),
              since: Optional[float] = None, **kw) -> Dict[str, Any]:
    """join + attribution in one call (the bench rungs' per-load-point
    entry: hand over the in-memory ``trace_log`` buffers, get the
    ``detail.request_waterfall`` payload)."""
    return attribution(join_traces(streams, router_records, since=since),
                       **kw)
