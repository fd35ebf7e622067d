"""SLA-aware serving policy layer above :class:`InferenceEngineV2`.

Port of ``deepspeedsyclsupport_tpu/inference/v2/serving.py``, statement for
statement: the same gate, ordering, eviction, fused-round K cap, journal
and watchdog calls, and every ``self.clock()`` call in the same order, so a
synthetic clock gives the port's session and the JAX package's the same
times and the same event stream. Randomness is an explicit
``torch.Generator`` (``generator``, default seeded from
``engine.config.seed + 1`` on the engine's device) in place of a
``jax.random`` key; sampling goes through ``sampling.sample_token_dyn``.

The scheduling policy the "Ragged Paged Attention" stack assumes sits above
the paged KV cache (PAPERS.md): the engine below this module is a batch
executor — it will happily admit everyone and let everyone miss deadline.
This layer makes overload degrade *gracefully* instead:

* **admission control** — every request carries a deadline budget (TTFT
  bound + decode token-rate SLA, stamped onto its
  :class:`~.ragged.SequenceDescriptor`); an EWMA :class:`CapacityModel` of
  measured prefill tok/s and decode step time projects each arrival's
  completion, and the gate admits, queues, or *sheds* it so that admitting
  never blows the SLA of already-admitted streams;
* **deadline-driven batch composition** — admitted work is ordered by
  slack (:func:`~.scheduler.slack_of`) with starvation aging and a
  per-tenant prefill budget per round (:class:`~.scheduler.SlackPolicy`);
* **overload-graceful eviction** — when the paged KV pool exhausts, the
  lowest-slack stream is preempted (`engine.preempt`: blocks freed,
  request rejected with partial output or requeued) rather than stalling
  the whole batch;
* **dispatch amortization** — whenever every live stream is decoding and
  nothing admissible waits, up to K decode steps fuse into ONE device
  dispatch (``engine._decode_multi_dispatch``: one CUDA graph replay on
  the card), with K capped by the slack of the most urgent queued request
  so fusion never starves TTFT.

Everything here is host-side policy over monotonic time
(``time.perf_counter``); the ``clock`` hook exists so tests drive the
policy with a synthetic clock and capacity model. The JAX package's
``docs/serving.md`` states the overload-behavior contract and config keys.

Across ranks (an engine built with ``topology=`` over more than one rank)
every rank runs this session and makes the same calls. Each time the
session reads its clock, rank 0 reads ITS clock (or takes the caller's
``now``) and broadcasts the value over the engine's gloo group
(``engine.rank0``, :mod:`...comm.rank0`); the other ranks never read
theirs. The same times, the same deterministic policy and the gathered
logits under equally seeded generators give every rank the same
admissions, sheds, evictions, slack order, fused-round K and tokens, so the
ranks' collectives stay in step. Only rank 0 writes the journal, the
watchdog's records and the Prometheus text; every rank keeps the same
counters, histograms and trace ring in memory.
"""
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .config import ServingPolicyConfig
from .kv_cache import kv_pool_stats
from .scheduler import SlackPolicy, slack_of
from ..sampling import SamplingParams, sample_token_dyn
from ...comm.watchdog import SERVE_HANG_EXIT_CODE, CollectiveWatchdog
from ...utils.fault_injection import get_fault_injector
from ...utils.logging import logger

#: ``Serve/*`` metric names this module emits (registered in
#: ``monitor.telemetry.EVENT_NAMES`` so ``DSTPU_STRICT_EVENTS=1`` passes).
SERVE_COUNTERS = ("Serve/admitted", "Serve/queued", "Serve/shed",
                  "Serve/evicted", "Serve/completed")
#: sliding-window SLO burn gauges (request-time attribution,
#: docs/observability.md): TTFT-SLA miss fraction, shed fraction, and
#: max(miss, shed)/error-budget burn rate over ``policy.slo_window_s``
SERVE_SLO_GAUGES = ("Serve/slo.ttft_miss_frac", "Serve/slo.shed_frac",
                    "Serve/slo.burn_rate")
SERVE_GAUGES = ("Serve/queue_depth", "Serve/kv_occupancy",
                "Serve/live_seqs") + SERVE_SLO_GAUGES
#: ``Serve/queue_wait_s`` is the satellite admission→prefill-dispatch wait;
#: the ``Serve/stage.*_s`` pair are the per-request prefill/decode phase
#: self-times observed at close — all surface p50/p95/p99 via
#: :meth:`ServingSession.summary_events` (quantile members are registry-
#: enumerated in ``monitor/telemetry.py``)
SERVE_HISTOGRAMS = ("Serve/ttft_s", "Serve/itl_s", "Serve/queue_wait_s",
                    "Serve/stage.prefill_s", "Serve/stage.decode_s",
                    "Serve/recovery.time_to_recover_s")
#: crash-replay recovery family (``inference/v2/supervisor.py`` — journal
#: replay counters + the stuck-decode watchdog's abort count). Full
#: literals on purpose: the static event-name lint resolves each against
#: the registry.
_RECOVERY_COUNTERS = {"replays": "Serve/recovery.replays",
                      "replay_sheds": "Serve/recovery.replay_sheds"}
SERVE_RECOVERY = (_RECOVERY_COUNTERS["replays"],
                  _RECOVERY_COUNTERS["replay_sheds"],
                  "Serve/recovery.serve_hang_aborts")
#: cross-request prefix cache (``inference/v2/prefix_cache.py`` —
#: docs/serving.md "prefix reuse"). Full literals on purpose: the static
#: event-name lint resolves each against the registry.
_PREFIX_COUNTERS = {"hits": "Serve/prefix.hits",
                    "misses": "Serve/prefix.misses",
                    "tokens_saved": "Serve/prefix.tokens_saved",
                    "blocks_shared": "Serve/prefix.blocks_shared",
                    "cow_copies": "Serve/prefix.cow_copies"}
SERVE_PREFIX = (_PREFIX_COUNTERS["hits"], _PREFIX_COUNTERS["misses"],
                _PREFIX_COUNTERS["tokens_saved"],
                _PREFIX_COUNTERS["blocks_shared"],
                _PREFIX_COUNTERS["cow_copies"],
                "Serve/prefix.hit_ratio", "Serve/prefix.pinned_blocks")
SERVE_EVENT_NAMES = (SERVE_COUNTERS + SERVE_GAUGES + SERVE_HISTOGRAMS
                     + SERVE_RECOVERY + SERVE_PREFIX)


class Ewma:
    """Exponentially-weighted moving average seeded with a prior; the first
    measured sample replaces the prior outright (a prior is a guess, not
    data — blending it in would drag measurements toward it for ~1/alpha
    samples)."""

    __slots__ = ("value", "alpha", "samples")

    def __init__(self, prior: float, alpha: float = 0.25):
        self.value = float(prior)
        self.alpha = float(alpha)
        self.samples = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.value = x if self.samples == 0 else \
            (1.0 - self.alpha) * self.value + self.alpha * x
        self.samples += 1
        return self.value


class CapacityModel:
    """Measured service capacity: prefill tokens/s and decode seconds/step.

    The engine's forwards are shape-padded (every decode dispatch computes
    ``max_sequences`` slots), so decode step time is close to
    occupancy-independent — one EWMA per quantity captures it; the
    admission gate multiplies by ``sla_headroom`` instead of modelling the
    residual occupancy sensitivity.
    """

    def __init__(self, prefill_tok_s: float = 1000.0,
                 decode_step_s: float = 0.05, alpha: float = 0.25):
        self._prefill = Ewma(prefill_tok_s, alpha)
        self._step = Ewma(decode_step_s, alpha)
        # best-case (least-loaded) rates ever measured: what an IDLE engine
        # delivers. The EWMA deliberately folds queueing delay in (that is
        # the backpressure signal), which makes it an over-estimate of
        # service time on an empty engine — and once everything is shed no
        # new samples arrive, so gating an idle engine on the loaded EWMA
        # is an absorbing shed-everything state.
        self._prefill_best = 0.0
        self._step_best = math.inf

    # ------------------------------------------------------------- recording
    def record_prefill(self, tokens: int, seconds: float) -> None:
        if tokens > 0 and seconds > 0:
            sample = tokens / seconds
            rate = self._prefill.update(sample)
            # best only rises when the smoothed rate supports the sample:
            # one spuriously fast outlier must not pin the idle-engine
            # projection optimistic forever
            self._prefill_best = max(self._prefill_best, min(rate, sample))

    def record_decode(self, steps: int, seconds: float) -> None:
        if steps > 0 and seconds > 0:
            sample = seconds / steps
            step = self._step.update(sample)
            # symmetric outlier guard (see record_prefill)
            self._step_best = min(self._step_best, max(step, sample))

    # ------------------------------------------------------------- estimates
    @property
    def prefill_tok_s(self) -> float:
        return max(self._prefill.value, 1e-9)

    @property
    def prefill_tok_s_best(self) -> float:
        """Best-case prefill rate: for projecting service on an idle
        engine (falls back to the EWMA/prior before any measurement)."""
        return max(self._prefill_best, self.prefill_tok_s)

    @property
    def decode_step_s(self) -> float:
        return max(self._step.value, 1e-9)

    @property
    def decode_step_s_best(self) -> float:
        return max(min(self._step_best, self.decode_step_s), 1e-9)

    @property
    def decode_tok_s(self) -> float:
        """Per-stream decode rate (1 token per live stream per step)."""
        return 1.0 / self.decode_step_s

    @property
    def decode_tok_s_best(self) -> float:
        return 1.0 / self.decode_step_s_best

    def prefill_eta_s(self, tokens: int, best: bool = False) -> float:
        return tokens / (self.prefill_tok_s_best if best
                         else self.prefill_tok_s)


@dataclass
class ServeEvent:
    """One observable serving outcome, stamped on the session clock.

    kinds: ``token`` (``tokens`` delivered at ``t``; a fused dispatch
    delivers several at once), ``finish`` (reason: done|eos|context|
    evicted), ``shed`` (admission rejected the request; reason names why),
    ``evict`` (KV-pressure preemption; reason: reject|requeue).
    """

    kind: str
    uid: int
    t: float
    tokens: List[int] = field(default_factory=list)
    reason: str = ""


@dataclass
class _Request:
    uid: int
    tokens: List[int]
    max_new_tokens: int
    tenant: str
    arrival_s: float
    deadline_s: Optional[float]
    rate_sla: float
    budget: int = 0                 # remaining new-token budget
    out: List[int] = field(default_factory=list)  # emitted tokens (requeue)
    enqueue_s: float = 0.0          # when the prompt entered the engine
    queued_s: float = 0.0           # when it (last) entered the queue
    cached_prefix_len: int = 0      # prefix-cache hit at (last) activation
    preempted: bool = False         # next activation is a requeue, not fresh
    #: ``tokens`` stays the ORIGINAL prompt forever; a requeued stream's
    #: context is rebuilt as tokens + out at activation (mutating tokens
    #: would duplicate the partial output on a second eviction)

    @property
    def n_prefill(self) -> int:
        """Tokens a (re)admission must prefill: prompt + emitted prefix."""
        return len(self.tokens) + len(self.out)
    first_token_s: Optional[float] = None
    last_emit_s: Optional[float] = None


class ServingSession:
    """Drives one engine under the SLA policy; the serving loop an MII-style
    frontend (or ``bench.py``'s closed-loop clients) sits on.

    ``submit()`` is the admission gate; ``step()`` runs one scheduling
    round — queue maintenance, slack-ordered batch composition, fused or
    per-token dispatch, KV-pressure eviction — and returns the round's
    :class:`ServeEvent` stream. The caller owns pacing (when to call
    ``step``) and delivery; the session owns policy.
    """

    def __init__(self, engine, policy: Optional[ServingPolicyConfig] = None,
                 *, clock: Callable[[], float] = time.perf_counter,
                 capacity: Optional[CapacityModel] = None,
                 sampling: Optional[SamplingParams] = None,
                 eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 journal: Any = None, watchdog: Any = None):
        world = getattr(engine, "world", 1)
        #: rank 0's readings on every rank (None on one rank)
        self.rank0 = getattr(engine, "rank0", None)
        if world > 1 and self.rank0 is None:
            raise RuntimeError(
                f"a session over an engine that serves across {world} "
                f"ranks takes rank 0's clock through the engine's process "
                f"group: start one (comm.init_distributed) and build the "
                f"engine with topology= on every rank")
        #: this rank writes the durable records (journal, Prometheus text)
        self.lead = self.rank0 is None or self.rank0.lead
        self.eng = engine
        self.policy = policy or ServingPolicyConfig()
        self.clock = clock
        self.capacity = capacity or CapacityModel(
            self.policy.prefill_tok_s_prior, self.policy.decode_step_s_prior,
            self.policy.ewma_alpha)
        self.sampling = sampling or SamplingParams()
        self.eos_token_id = eos_token_id
        self.queue: List[_Request] = []
        self.running: Dict[int, _Request] = {}
        self.counters: Dict[str, int] = {
            "admitted": 0, "queued": 0, "shed": 0, "evicted": 0,
            "completed": 0}
        #: crash-replay recovery accounting (``Serve/recovery.*`` family)
        self.recovery_counters: Dict[str, int] = {"replays": 0,
                                                  "replay_sheds": 0}
        self._pending_tok: Dict[int, int] = {}  # sampled, not yet submitted
        self._last_decode_s: Optional[float] = None
        self._round = 0            # scheduling rounds (watchdog step label)
        self._tokens_emitted = 0   # serve_crash fault trigger input
        self._stall_rounds = 0     # consecutive no-progress rounds
        # request-time attribution (monitor/reqtrace.py; docs/
        # observability.md): lifecycle-edge records mirrored into a bounded
        # in-memory ring so bench load points join per-request waterfalls
        # with zero disk IO in the measured path (the journal — when
        # configured — carries the same records durably). The fixed wall
        # offset maps this session's monotonic clock onto the journal's
        # wall stamps: every record rides ONE clock base, so the offline
        # join can order router and replica streams together.
        self._tracing = bool(self.policy.trace_stages)
        self.trace_log: deque = deque(maxlen=65536)
        self._wall0 = self._rank0_value(lambda: time.time() - self.clock())
        # SLO burn accounting (Serve/slo.* gauges): sliding windows of
        # (t, first-token-met-SLA) and (t, outcome-was-shed) samples
        self._slo_ttft: deque = deque()
        self._slo_gate: deque = deque()
        self.generator = generator if generator is not None else \
            torch.Generator(device=engine.device).manual_seed(
                engine.config.seed + 1)
        # cross-request prefix reuse (docs/serving.md "prefix reuse"): the
        # policy owns the knobs, the engine owns the cache — installing is
        # idempotent, so a recovered session reuses the warm index
        pc_cfg = self.policy.prefix_cache
        if pc_cfg and pc_cfg.get("enabled", True):
            engine.install_prefix_cache(
                scope=pc_cfg.get("scope", "tenant"),
                min_block_hits=int(pc_cfg.get("min_block_hits", 1)),
                max_pinned_blocks=pc_cfg.get("max_pinned_blocks"))
        # registry counters are monotone increments; the cache keeps plain
        # totals — this snapshot turns totals into deltas at flush time
        self._prefix_reported: Dict[str, int] = {}
        if self.policy.telemetry:
            from ...monitor.telemetry import metrics_registry as _mr

            self._metrics = _mr
        else:
            self._metrics = None
        # request journal: in-flight state survives the process (see
        # docs/serving.md "failure contract"); caller-provided instance
        # wins over the config path. Across ranks rank 0's alone.
        if journal is None and self.policy.journal_path and self.lead:
            from .supervisor import RequestJournal

            journal = RequestJournal(self.policy.journal_path)
        self.journal = journal if self.lead else None
        # stuck-decode watchdog: the collective watchdog's machinery with
        # the serving contract's names — rc 219, serve_hang_aborts, and
        # serve/arm-serve/hang deadline records into the journal stream
        if watchdog is None and self.policy.watchdog_enabled:
            watchdog = CollectiveWatchdog(
                deadline_s=self.policy.watchdog_deadline_s,
                warmup_deadline_s=self.policy.watchdog_warmup_deadline_s,
                poll_s=self.policy.watchdog_poll_s,
                telemetry=self.journal,
                exit_code=SERVE_HANG_EXIT_CODE,
                abort_counter="serve_hang_aborts",
                arm_name="serve/arm", hang_name="serve/hang",
                what="serving decode").start()
        self.watchdog = watchdog

    # ----------------------------------------------------------------- clock
    def _rank0_value(self, fn: Callable[[], float]) -> float:
        rank0 = getattr(self, "rank0", None)
        return fn() if rank0 is None else rank0.value(fn)

    def now(self, now: Optional[float] = None) -> float:
        """The session's time: ``now`` when given, else a read of
        ``clock``; across ranks rank 0's value on every rank (the only
        clock read the session makes)."""
        return self._rank0_value(lambda: self.clock() if now is None else now)

    def close(self) -> None:
        """Stop the watchdog poller and close the journal stream.
        Idempotent; live/queued requests stay journaled as in-flight (the
        truthful state for a replica being stopped mid-serve)."""
        if self.watchdog is not None:
            try:
                self.watchdog.stop()
            except Exception:  # teardown must never raise out of serving
                pass
        if self.journal is not None:
            self.journal.close()

    # ----------------------------------------------- request-time attribution
    def _trace(self, name: str, t: float, data: Dict[str, Any]) -> None:
        """Mirror one lifecycle record (journal-record shape) into the
        in-memory ring, stamped on the session-clock→wall mapping."""
        if self._tracing:
            self.trace_log.append(
                {"name": name, "t": t + self._wall0, "data": data})

    def _stage(self, uid: int, stage: str, t: float,
               dur: Optional[float] = None, **data: Any) -> None:
        """``serve/stage`` lifecycle edge: in-memory ring always (when
        tracing), journal stream when one is configured — same record, one
        clock base, no second transport."""
        if not self._tracing:
            return
        payload = {"uid": int(uid), "stage": stage,
                   **({"dur": float(dur)} if dur is not None else {}),
                   **data}
        self.trace_log.append(
            {"name": "serve/stage", "t": t + self._wall0, "data": payload})
        if self.journal is not None:
            self.journal.stage(uid, stage, dur=dur, **data)

    def note_stage(self, uid: int, stage: str,
                   dur: Optional[float] = None, **data: Any) -> None:
        """Public stamping hook for the owning loop (``serve_worker``
        stamps ``spool_wait`` through this; a future RPC front-end stamps
        its ingress edge the same way)."""
        self._stage(uid, stage, self.now(), dur=dur, **data)

    def drain_trace(self) -> List[Dict[str, Any]]:
        """Hand over and clear the in-memory lifecycle records — the bench
        rungs drain per load point so each point's waterfall joins only its
        own requests."""
        out = list(self.trace_log)
        self.trace_log.clear()
        return out

    def export_metrics(self, path: str) -> Optional[str]:
        """Prometheus textfile snapshot of the session's registry (atomic
        rename — the training exporter's contract). No-op without
        telemetry, and on every rank but rank 0."""
        if self._metrics is None or not getattr(self, "lead", True):
            return None
        from ...monitor.telemetry import export_metrics_textfile

        return export_metrics_textfile(path, self._metrics.snapshot())

    def _slo_snapshot(self, now: float) -> Tuple[float, float, float]:
        """(ttft_miss_frac, shed_frac, burn_rate) over the trailing
        ``policy.slo_window_s`` window. Burn is the worse of the two miss
        fractions priced against the error budget: burn > 1 means the SLO
        budget is being spent faster than it accrues."""
        horizon = now - self.policy.slo_window_s
        for dq in (self._slo_ttft, self._slo_gate):
            while dq and dq[0][0] < horizon:
                dq.popleft()
        miss = (1.0 - sum(1 for _, ok in self._slo_ttft if ok)
                / len(self._slo_ttft)) if self._slo_ttft else 0.0
        shed = (sum(1 for _, s in self._slo_gate if s)
                / len(self._slo_gate)) if self._slo_gate else 0.0
        burn = max(miss, shed) / max(self.policy.slo_budget, 1e-9)
        return miss, shed, burn

    # ------------------------------------------------------------- admission
    def submit(self, uid: int, tokens: Sequence[int], max_new_tokens: int,
               *, tenant: str = "default", now: Optional[float] = None,
               ttft_sla_s: Optional[float] = None,
               rate_sla: Optional[float] = None) -> str:
        """Admission gate. Returns ``"admitted"`` (prompt enqueued for the
        next round), ``"queued"`` (held; re-evaluated every round), or
        ``"shed"`` (rejected now — the graceful-overload answer: the client
        learns in O(1) instead of timing out)."""
        if not tokens:
            raise ValueError("cannot serve an empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if uid in self.running or uid in self.eng.seqs \
                or any(r.uid == uid for r in self.queue):
            raise ValueError(f"uid {uid} is already being served")
        now = self.now(now)
        ttft = ttft_sla_s if ttft_sla_s is not None else self.policy.ttft_sla_s
        req = _Request(
            uid=uid, tokens=list(tokens), max_new_tokens=int(max_new_tokens),
            tenant=tenant, arrival_s=now,
            deadline_s=(now + ttft) if ttft is not None else None,
            rate_sla=(rate_sla if rate_sla is not None
                      else self.policy.token_rate_sla),
            budget=int(max_new_tokens), queued_s=now)
        decision = self._gate(req, now, ahead_tokens=self._queued_tokens())
        if decision == "admit" and self.queue:
            # no leapfrogging: a new arrival must not take a freed slot
            # ahead of older queued requests — it joins the queue, which
            # _maintain_queue re-gates in deadline order every round (an
            # urgent arrival still legitimately outranks laxer ones there)
            decision = "queue"
        # gate-verdict edge: the ONLY trace a shed-at-submit request leaves
        # (terminal sheds are never journaled as admits), so the waterfall
        # still counts and names them
        self._stage(uid, "gate", now, verdict=decision,
                    n_prompt=len(req.tokens))
        self._slo_gate.append((now, decision == "shed"))
        if decision == "shed":
            # terminal at submit: the caller learns synchronously, nothing
            # is in flight — so nothing to journal
            self._count("shed")
            return "shed"
        if self.journal is not None:
            # journaled BEFORE any token can be produced: from here the
            # request is in flight and must survive the process
            self.journal.admit(uid, req.tokens, req.max_new_tokens,
                               tenant=req.tenant, rate_sla=req.rate_sla,
                               ttft_sla_s=ttft)
        self._trace("serve/admit", now, {
            "uid": int(uid), "n_tokens": len(req.tokens),
            "max_new_tokens": req.max_new_tokens, "tenant": req.tenant,
            "rate_sla": req.rate_sla,
            **({"ttft_sla_s": float(ttft)} if ttft is not None else {})})
        if decision == "admit":
            self._activate(req, now)
            return "admitted"
        self.queue.append(req)
        self._count("queued")
        return "queued"

    def replay(self, uid: int, tokens: Sequence[int], max_new_tokens: int,
               *, emitted_tokens: Sequence[int] = (),
               tenant: str = "default", rate_sla: Optional[float] = None,
               now: Optional[float] = None) -> str:
        """Re-admit a journaled in-flight request from its emitted-token
        watermark after an engine death (``supervisor.recover_requests``).

        The TTFT deadline is burned (the first token — if any — was
        delivered in a previous incarnation), so the gate re-projects on
        the **rate SLA only**, exactly like the requeue path; the
        context is rebuilt as prompt + emitted prefix at activation, so
        the stream continues from the watermark with zero duplicate
        tokens. Returns ``"replayed"`` (re-admitted or queued),
        ``"shed"`` (provably unmeetable — terminal, counted under
        ``Serve/recovery.replay_sheds``), or ``"completed"`` (the crash
        landed between the final emit and the close record — the output
        was already fully delivered)."""
        if not tokens:
            raise ValueError("cannot replay an empty prompt")
        if uid in self.running or uid in self.eng.seqs \
                or any(r.uid == uid for r in self.queue):
            raise ValueError(f"uid {uid} is already being served")
        now = self.now(now)
        out = [int(t) for t in emitted_tokens]
        rate = (rate_sla if rate_sla is not None
                else self.policy.token_rate_sla)
        if len(out) >= max_new_tokens:
            # fully delivered before the crash; only the close record was
            # lost — re-journal the final state (admit carrying the full
            # prefix, so THIS incarnation's journal is self-contained)
            # plus the missing close, and the next recovery skips the uid
            self._count("completed")
            if self.journal is not None:
                self.journal.admit(uid, tokens, max_new_tokens,
                                   tenant=tenant, rate_sla=rate, out=out,
                                   replayed=True)
                self.journal.close_request(uid, "done")
            self._trace("serve/admit", now, {
                "uid": int(uid), "n_tokens": len(tokens),
                "max_new_tokens": int(max_new_tokens), "tenant": tenant,
                "replayed": True, "watermark": len(out)})
            self._trace("serve/close", now,
                        {"uid": int(uid), "reason": "done"})
            return "completed"
        req = _Request(
            uid=uid, tokens=[int(t) for t in tokens],
            max_new_tokens=int(max_new_tokens), tenant=tenant,
            arrival_s=now, deadline_s=None, rate_sla=rate,
            budget=int(max_new_tokens) - len(out), out=out, queued_s=now)
        if out:
            # decode phase: slack scoring and the admission gate must see
            # the first token as delivered (see _activate's same rule for
            # requeued streams)
            req.first_token_s = now
        # replay gate: rate SLA only, and against the BEST-CASE (idle-
        # engine) measured rate — the replay set was running together
        # before the crash, so it is proven placeable; _gate's loaded-EWMA
        # heuristic would shed every replay after the first one re-fills
        # the engine. "Provably unmeetable" here means even an idle engine
        # cannot deliver the rate.
        # a replayed context is prime prefix-cache material: the donor
        # incarnation's committed blocks (or a sibling stream's) make the
        # re-prefill a block-table copy up to the first uncached token
        decision = "admit" if uid in self.eng.check_schedule(
            [uid], [req.n_prefill],
            cached_prefix={uid: self._peek_prefix(req)}).admitted \
            else "queue"
        if self.policy.admission != "none" and req.rate_sla > 0 \
                and self.capacity.decode_tok_s_best \
                < self.policy.rate_feasibility_margin * req.rate_sla:
            decision = "shed"
        if decision == "shed":
            self._count("shed")
            self._count_recovery("replay_sheds")
            if self.journal is not None:
                self.journal.close_request(uid, "replay_shed")
            self._trace("serve/close", now,
                        {"uid": int(uid), "reason": "replay_shed"})
            return "shed"
        if self.journal is not None:
            self.journal.admit(uid, req.tokens, req.max_new_tokens,
                               tenant=tenant, rate_sla=rate, out=out,
                               replayed=True)
        self._trace("serve/admit", now, {
            "uid": int(uid), "n_tokens": len(req.tokens),
            "max_new_tokens": req.max_new_tokens, "tenant": tenant,
            "rate_sla": rate, "replayed": True, "watermark": len(out)})
        # replay-segment edge: the survivor side of a failover-spanning
        # trace (generation/incarnation carried by the journal filename)
        self._stage(uid, "replay", now, watermark=len(out))
        self._count_recovery("replays")
        if decision == "admit" and not self.queue:
            self._activate(req, now)
        else:
            self.queue.append(req)
            self._count("queued")
        return "replayed"

    def _peek_prefix(self, req: _Request) -> int:
        """Cached-prefix length for ``req``'s full context, side-effect
        free (no counters, no recency) — the gate prices prefill at the
        NOVEL tokens only; the request may still be shed."""
        pc = self.eng.prefix_cache
        if pc is None:
            return 0
        return pc.peek(req.tokens + req.out, req.tenant)

    def _gate(self, req: _Request, now: float, ahead_tokens: int = 0) -> str:
        """admit | queue | shed for one request against the capacity model
        and the engine's structural limits. Prefill cost — both the KV
        block demand and the TTFT projection — is priced at
        ``n_prefill − cached_prefix_len``: a cached prefix is a
        block-table copy, not a forward."""
        cached = self._peek_prefix(req)
        res = self.eng.check_schedule([req.uid], [req.n_prefill],
                                      cached_prefix={req.uid: cached})
        structural_ok = req.uid in res.admitted
        if self.policy.admission == "none":
            return "admit" if structural_ok else "queue"
        # an IDLE engine projects at the best-case (least-loaded) measured
        # rates: the EWMA folds queueing delay in (the backpressure signal
        # while streams run), so after a shed-heavy phase empties the
        # engine it over-states service time — and with nothing admitted
        # no new samples would ever correct it (shed-everything lock-in)
        idle = not self.running
        # rate feasibility: a per-stream decode rate the hardware CLEARLY
        # cannot deliver is never meetable — admitting would only push the
        # already admitted streams' ITL over their SLA too. Margin < 1, not
        # headroom > 1: the EWMA breathes under load, and shedding the
        # whole fleet over a few-percent reading is the opposite of
        # graceful (TTFT projection is the overload valve)
        decode_rate = (self.capacity.decode_tok_s_best if idle
                       else self.capacity.decode_tok_s)
        if req.rate_sla > 0 and decode_rate \
                < self.policy.rate_feasibility_margin * req.rate_sla:
            return "shed"
        # TTFT projection only gates requests that have not started: a
        # requeued (evicted mid-decode) stream already delivered its first
        # token — its TTFT deadline is long past and meaningless; what it
        # must still sustain is the rate SLA, checked above
        if req.deadline_s is not None and req.first_token_s is None:
            slot_wait = 0.0 if structural_ok else self._slot_wait_s()
            eta = self.policy.sla_headroom * self.capacity.prefill_eta_s(
                self._prefill_backlog_tokens() + ahead_tokens
                + req.n_prefill - cached, best=idle)
            if now + slot_wait + eta > req.deadline_s:
                return "shed"
        if not structural_ok:
            return "queue" if self.policy.shed_policy == "queue" else "shed"
        return "admit"

    def _activate(self, req: _Request, now: float) -> None:
        """Hand the admitted request to the engine: descriptor created with
        its SLA budget BEFORE the first scheduler pass, prompt enqueued —
        the actual forwards run inside :meth:`step`."""
        d = self.eng.ensure_seq(
            req.uid, arrival_s=req.arrival_s, deadline_s=req.deadline_s,
            rate_sla=req.rate_sla, tenant=req.tenant,
            target_new_tokens=req.max_new_tokens, emitted=len(req.out),
            # a requeued stream keeps its first-token stamp: without it
            # slack_of scores the re-prefill against the long-expired TTFT
            # deadline (hugely negative slack) and the slack eviction
            # policies re-victimize the very stream we chose to resume
            first_token_s=req.first_token_s)
        # probe the prefix cache with the FULL context (prompt + emitted
        # prefix): an admission, a requeue after eviction and a crash
        # replay all re-enter here, so all three skip straight to the
        # first uncached token when the blocks are still indexed
        ctx = [int(t) for t in req.tokens] + [int(t) for t in req.out]
        cached = self.eng.map_cached_prefix(req.uid, ctx)
        d.pending.extend(ctx[cached:])
        d.last_logits = None
        req.enqueue_s = now
        req.cached_prefix_len = cached
        # queue-wait edge (admission→prefill dispatch; the prompt fuses
        # into the very next forward). A preemption-requeue re-enters here
        # as requeue_wait so the waterfall separates first-admission queue
        # time from re-admission backoff; both waits land in the satellite
        # Serve/queue_wait_s histogram.
        wait = max(0.0, now - req.queued_s)
        self._observe("Serve/queue_wait_s", wait)
        self._stage(req.uid,
                    "requeue_wait" if req.preempted else "queue_wait",
                    now, dur=wait, cached_prefix_len=cached,
                    novel_tokens=len(ctx) - cached)
        req.preempted = False
        self.running[req.uid] = req
        self._count("admitted")

    # --------------------------------------------------------- projections
    def _prefill_backlog_tokens(self) -> int:
        return sum(len(d.pending) for d in self.eng.seqs.values())

    def _queued_tokens(self) -> int:
        return sum(r.n_prefill for r in self.queue)

    def _slot_wait_s(self) -> float:
        """Earliest a slot/KV frees: the closest-to-done running stream's
        remaining tokens at the measured step time (∞ when nothing runs —
        structurally stuck)."""
        if not self.running:
            return math.inf
        rem = min(r.budget for r in self.running.values())
        return rem * self.capacity.decode_step_s

    def _slack_policy(self, now: float) -> SlackPolicy:
        return SlackPolicy(
            now=now, prefill_tok_s=self.capacity.prefill_tok_s,
            decode_tok_s=self.capacity.decode_tok_s,
            aging_weight=self.policy.aging_weight,
            tenant_budget=self.policy.tenant_token_budget)

    # -------------------------------------------------------------- stepping
    def step(self, now: Optional[float] = None) -> List[ServeEvent]:
        """One scheduling round; returns the round's event stream (possibly
        empty — e.g. nothing live and nothing admissible).

        The round's device dispatches run inside an armed stuck-decode
        watchdog window (``policy.watchdog_enabled``): a dispatch that
        never returns becomes a faulthandler dump + journal flush +
        ``os._exit(219)`` — the serving twin of the rc-218 collective-hang
        contract — instead of a silent forever-hang the supervisor can
        only guess at."""
        now = self.now(now)
        self._round += 1
        injector = get_fault_injector()
        rc = injector.should_serve_crash(self._round, self._tokens_emitted)
        if rc is not None:
            # a hard crash by definition: no journal close, no flush — the
            # per-record journal durability is what recovery rides
            logger.error("fault injection: serving process crashing "
                         "mid-decode (round %d, %d tokens emitted, rc=%d)",
                         self._round, self._tokens_emitted, rc)
            os._exit(rc)
        events: List[ServeEvent] = []
        self._maintain_queue(now, events)
        self.eng.slack_policy = self._slack_policy(now)
        # arm only when the round has work: an idle poll (the natural
        # serving-loop pattern while awaiting the first request) must not
        # consume the one-shot warmup allowance — the first REAL round
        # compiles prefill + sampler + fused rungs and needs it
        wd = self.watchdog if (self.running or self.queue) else None
        if wd is not None:
            wd.arm(self._round)
        dispatches0 = self.eng.host_dispatches
        try:
            # decode_wedge lands HERE — after arming, inside the watched
            # window — so the injected stall is exactly the hang the
            # watchdog exists to convert into rc 219
            injector.maybe_wedge_decode(self._round)
            fused = self._can_fuse() and self._fused_round(now, events)
            if not fused:
                self._per_token_round(now, events)
        finally:
            # disarm in a finally: an exception mid-round must not leave
            # the deadline live to rc-219 the process during ordinary
            # error handling
            if wd is not None:
                wd.disarm(self._round)
            self.eng.slack_policy = None
        self._note_progress(events, dispatches0, now)
        self._flush_gauges(now)
        return events

    def _note_progress(self, events: List[ServeEvent], dispatches0: int,
                       now: float) -> None:
        """Structured backpressure valve: a round with live streams that
        neither emitted an event nor dispatched anything is a wedged batch
        (KV pool exhausted with the remaining holders un-evictable, an
        injected ``kv_alloc_fail`` streak, allocator drift). After
        ``stall_patience_rounds`` such rounds the lowest-slack stream is
        preempted — requeued or rejected-with-partial-output per
        ``preempt_policy`` — so the batch un-wedges through the session's
        own event stream instead of an exception (or a caller's stall
        guard) killing the serving loop."""
        if events or self.eng.host_dispatches != dispatches0 \
                or not self.running:
            self._stall_rounds = 0
            return
        self._stall_rounds += 1
        if self._stall_rounds < self.policy.stall_patience_rounds:
            return
        self._stall_rounds = 0
        victim = self._eviction_victim(now)
        if victim is None:
            # no block-holding stream: fall back to lowest slack outright
            # (its re-prefill is the cheapest to redo)
            victim = min(self.running, key=lambda u: (
                slack_of(self.eng.seqs[u], now, self.capacity.prefill_tok_s,
                         self.capacity.decode_tok_s)
                if u in self.eng.seqs else 0.0))
        logger.warning("serving session: %d no-progress rounds with %d "
                       "live stream(s) — preempting uid %d to un-wedge "
                       "the batch", self.policy.stall_patience_rounds,
                       len(self.running), victim)
        self._evict(victim, now, events)

    def _maintain_queue(self, now: float, events: List[ServeEvent]) -> None:
        """Shed queued requests that aged out or became unmeetable; admit
        (in slack order) the ones the gate now accepts."""
        if not self.queue:
            return
        self.queue.sort(key=lambda r: (r.deadline_s is None,
                                       r.deadline_s or 0.0, r.arrival_s))
        kept: List[_Request] = []
        ahead = 0
        for req in self.queue:
            if now - req.queued_s > self.policy.max_queue_s:
                self._drop_queued(req, now, events, "queue timeout")
                continue
            decision = self._gate(req, now, ahead_tokens=ahead)
            if decision == "admit":
                self._activate(req, now)
            elif decision == "shed" and self.policy.admission != "none":
                self._drop_queued(req, now, events, "deadline unmeetable")
            else:
                kept.append(req)
                ahead += req.n_prefill
        self.queue = kept

    def _drop_queued(self, req: _Request, now: float,
                     events: List[ServeEvent], reason: str) -> None:
        """Terminal shed of a queued request. A requeued stream that
        already delivered tokens gets a ``finish`` (reason ``evicted``,
        partial output) instead of a bare ``shed`` — callers tracking
        completion must see closure for a request they received tokens
        from (one terminal event either way, never both)."""
        self._count("shed")
        self._slo_gate.append((now, True))
        close_reason = ("evicted" if req.first_token_s is not None
                        else f"shed:{reason}")
        if self.journal is not None:
            self.journal.close_request(req.uid, close_reason)
        self._trace("serve/close", now,
                    {"uid": int(req.uid), "reason": close_reason})
        if req.first_token_s is not None:
            events.append(ServeEvent("finish", req.uid, now,
                                     reason="evicted"))
        else:
            events.append(ServeEvent("shed", req.uid, now, reason=reason))

    # --------------------------------------------------------- fused decode
    def _can_fuse(self) -> bool:
        """Steady state: every live stream is decoding with fresh logits and
        nothing admissible is waiting (queue heads were just re-gated by
        :meth:`_maintain_queue`) — the fused K-step program applies even
        below full occupancy."""
        if self.eng.config.decode_steps_per_dispatch <= 1 or not self.running:
            return False
        if self._pending_tok:
            return False  # a sampled-but-unsubmitted token must ship first
        for uid, req in self.running.items():
            d = self.eng.seqs.get(uid)
            if d is None or d.pending or d.last_logits is None:
                return False
            if req.first_token_s is None:
                # a just-drained prefill must deliver its first token NOW
                # (one per-token round), not after a whole K-step device
                # loop — fusing here would bake K*step_time into TTFT
                return False
        return True

    def _k_cap(self, now: float) -> Optional[int]:
        """Bound the fused dispatch so a queued request with little TTFT
        slack is not starved behind a long device loop: K ≤ that slack in
        decode steps (the ladder in the engine rounds it down)."""
        cap: Optional[int] = None
        for req in self.queue:
            if req.deadline_s is None:
                continue
            slack = (req.deadline_s - now
                     - self.capacity.prefill_eta_s(req.n_prefill))
            k = int(slack / self.capacity.decode_step_s)
            cap = k if cap is None else min(cap, k)
        return None if cap is None else max(2, cap)

    def _fused_round(self, now: float, events: List[ServeEvent]) -> bool:
        budgets = {u: self.running[u].budget for u in self.running}
        emitted = self.eng._decode_multi_dispatch(
            budgets, self.sampling, self.eos_token_id, self.generator,
            k_cap=self._k_cap(now))
        if emitted is None:
            return False  # KV pool can't pre-fund ≥2 steps → per-token path
        t1 = self.now()
        steps = max((len(v) for v in emitted.values()), default=0)
        self.capacity.record_decode(steps, t1 - now)
        self._last_decode_s = t1
        # one record per scheduling round (uid −1 = session scope; the
        # scheduled uids ride in data) — per-uid stamps here would double
        # the journal volume for no join benefit
        self._stage(-1, "decode_round", t1, dur=t1 - now, mode="fused",
                    k=steps, uids=sorted(emitted))
        for uid, toks in emitted.items():
            req = self.running[uid]
            req.budget -= len(toks)
            if toks:
                events.append(ServeEvent("token", uid, t1, tokens=list(toks)))
                self._note_emission(req, toks, t1)
            if uid not in budgets:  # retired on device; engine flushed it
                reason = ("eos" if (toks and self.eos_token_id is not None
                                    and toks[-1] == self.eos_token_id)
                          else ("done" if req.budget <= 0 else "context"))
                self._finish(uid, t1, events, reason, flush=False)
            else:
                req.budget = budgets[uid]  # authoritative (device counted)
        return True

    # ------------------------------------------------------ per-token round
    def _per_token_round(self, now: float, events: List[ServeEvent]) -> None:
        eng = self.eng
        sp = self.sampling
        # 1. one batched device sample over every drained stream
        drained: List[Tuple[int, torch.Tensor]] = []
        for uid in list(self.running):
            if uid in self._pending_tok:
                continue
            lg = eng.query(uid)
            if lg is not None:
                drained.append((uid, lg))
        if drained:
            toks = sample_token_dyn(
                torch.stack([lg for _, lg in drained]), self.generator,
                sp.temperature, sp.top_p, sp.structure).cpu().numpy()
            eng.host_dispatches += 1  # the sampler is a dispatch too
            t1 = self.now()
            if self._last_decode_s is not None:
                self.capacity.record_decode(1, t1 - self._last_decode_s)
            self._last_decode_s = t1
            self._stage(-1, "decode_round", t1, dur=t1 - now,
                        mode="per_token",
                        uids=sorted(u for u, _lg in drained))
            for (uid, _lg), tok in zip(drained, toks):
                tok = int(tok)
                req = self.running[uid]
                events.append(ServeEvent("token", uid, t1, tokens=[tok]))
                self._note_emission(req, [tok], t1)
                req.budget -= 1
                d = eng.seqs[uid]
                d.emitted += 1
                done = (req.budget <= 0
                        or (self.eos_token_id is not None
                            and tok == self.eos_token_id)
                        or d.n_cached >= eng.config.max_context)
                if done:
                    reason = ("eos" if (self.eos_token_id is not None
                                        and tok == self.eos_token_id)
                              else ("done" if req.budget <= 0 else "context"))
                    self._finish(uid, t1, events, reason)
                else:
                    self._pending_tok[uid] = tok
        else:
            self._last_decode_s = None  # no decode this round: break the
            #                             ITL chain across prefill-only gaps
        # 2. KV pressure: preempt the lowest-slack stream until the decode
        # tokens fit (never stall the whole batch on an exhausted pool)
        put_uids = list(self._pending_tok)
        while put_uids:
            res = eng.check_schedule(put_uids, [1] * len(put_uids))
            if not any(res.reasons.get(u, "").startswith("kv")
                       for u in res.rejected):
                break
            victim = self._eviction_victim(now)
            if victim is None:
                break
            self._evict(victim, now, events)
            put_uids = [u for u in put_uids if u != victim]
        # 3. submit: decode tokens + (slack-ordered, tenant-capped) prompt
        # chunks fuse into the same forward inside put()
        if put_uids or any(d.pending for d in eng.seqs.values()):
            t0 = self.now()
            pend0 = ({u: len(d.pending) for u, d in eng.seqs.items()
                      if d.pending} if self._tracing else {})
            res = eng.put(put_uids, [[self._pending_tok[u]] for u in put_uids],
                          drain=False)
            for uid in res.admission.admitted:
                self._pending_tok.pop(uid, None)
            t1 = self.now()
            # prefill-chunk edges: which uids advanced their prompt this
            # forward and by how many tokens (dur is the whole mixed
            # forward's wall — chunks share the dispatch, annotation only)
            for u, n0 in pend0.items():
                d = eng.seqs.get(u)
                n1 = len(d.pending) if d is not None else 0
                if n1 < n0:
                    self._stage(u, "prefill_chunk", t1, dur=t1 - t0,
                                tokens=n0 - n1)
            # first-token landings this pass: prefill capacity samples.
            # DELIBERATELY enqueue-to-first-token per request, not raw
            # forward throughput: the sample folds in the scheduling delay
            # a prompt experiences at the CURRENT concurrency, so the rate
            # sinks as load rises and the admission gate tightens — the
            # closed-loop backpressure that keeps admitted streams inside
            # their SLA under overload. A per-forward throughput sample
            # (budget tokens / forward time) reads ~constant regardless of
            # how many streams share the budget; gating on it admits far
            # past capacity and every admitted stream goes borderline-miss
            # (a uid drained this round has first_token_s set by
            # _note_emission, so only freshly-landed prefills sample here)
            for uid, req in self.running.items():
                if req.first_token_s is None and eng.query(uid) is not None:
                    self.capacity.record_prefill(len(req.tokens),
                                                 t1 - req.enqueue_s)

    def _exclusive_blocks(self, uid: int) -> int:
        """Blocks only ``uid`` holds (refcount 1): preempting it frees
        exactly these — shared blocks stay alive under their other holders
        (sibling streams or the prefix index), so they buy no relief."""
        alloc = self.eng.allocator
        blocks = self.eng.seqs[uid].blocks
        if not hasattr(alloc, "refcount"):
            return len(blocks)
        return sum(1 for b in blocks if alloc.refcount(b) == 1)

    def _eviction_victim(self, now: float) -> Optional[int]:
        """Lowest slack first — the stream most likely to miss its SLA
        anyway; ties (e.g. every stream slack-less) break toward the most
        EXCLUSIVE (unshared) blocks, which buy the most actual relief —
        a stream riding a hot shared prefix frees almost nothing — then
        toward the longest context."""
        live = [u for u in self.running if u in self.eng.seqs
                and self.eng.seqs[u].blocks]
        if not live:
            return None
        return min(live, key=lambda u: (
            slack_of(self.eng.seqs[u], now, self.capacity.prefill_tok_s,
                     self.capacity.decode_tok_s),
            -self._exclusive_blocks(u),
            -self.eng.seqs[u].n_cached))

    def _evict(self, uid: int, now: float, events: List[ServeEvent]) -> None:
        req = self.running.pop(uid)
        self._pending_tok.pop(uid, None)
        self.eng.preempt(uid)
        self._count("evicted")
        requeue = self.policy.preempt_policy == "requeue"
        self._stage(uid, "preempt", now,
                    policy="requeue" if requeue else "reject")
        events.append(ServeEvent("evict", uid, now,
                                 reason="requeue" if requeue else "reject"))
        if requeue:
            # the emitted prefix is part of the context now — a fresh
            # prefill (tokens + out, rebuilt at activation) must restore
            # its KV before decode can continue. Still in flight: no
            # journal close (a crash here replays it from the watermark)
            req.queued_s = now
            req.preempted = True
            self.queue.append(req)
            self._count("queued")
        else:
            if self.journal is not None:
                self.journal.close_request(uid, "evicted")
            self._observe_stage_times(req)
            self._trace("serve/close", now,
                        {"uid": int(uid), "reason": "evicted"})
            events.append(ServeEvent("finish", uid, now, reason="evicted"))

    # ------------------------------------------------------------- plumbing
    def _note_emission(self, req: _Request, toks: Sequence[int],
                       t: float) -> None:
        req.out.extend(int(t_) for t_ in toks)
        self._tokens_emitted += len(toks)
        if self.journal is not None:
            # journal-before-release: the watermark is on disk before the
            # caller sees the tokens (step() returns the events after this),
            # which is what makes crash replay exactly-once
            self.journal.emit(req.uid, toks, len(req.out))
        self._trace("serve/emit", t, {"uid": int(req.uid), "n": len(toks)})
        if req.first_token_s is None:
            req.first_token_s = t
            d = self.eng.seqs.get(req.uid)
            if d is not None:
                d.first_token_s = t
            self._observe("Serve/ttft_s", t - req.arrival_s)
            # prefill edge closes at the first token; cached_prefix_len
            # makes the prefix-cache saving visible per request
            self._stage(req.uid, "prefill", t,
                        dur=max(0.0, t - req.enqueue_s),
                        cached_prefix_len=req.cached_prefix_len)
            if req.deadline_s is not None:
                self._slo_ttft.append((t, t <= req.deadline_s))
        elif req.last_emit_s is not None and toks:
            itl = (t - req.last_emit_s) / len(toks)
            for _ in toks:
                self._observe("Serve/itl_s", itl)
        req.last_emit_s = t

    def _finish(self, uid: int, now: float, events: List[ServeEvent],
                reason: str, flush: bool = True) -> None:
        req = self.running.pop(uid, None)
        self._pending_tok.pop(uid, None)
        if flush:
            self.eng.flush([uid])
        self._count("completed")
        if self.journal is not None:
            self.journal.close_request(uid, reason)
        if req is not None:
            self._observe_stage_times(req)
        self._trace("serve/close", now, {"uid": int(uid), "reason": reason})
        events.append(ServeEvent("finish", uid, now, reason=reason))

    def _observe_stage_times(self, req: _Request) -> None:
        """Terminal per-request phase self-times into the Serve/stage.*_s
        histograms (the streaming twin of the offline join's stage sums;
        guarded against requeue reorderings where first_token predates the
        last activation)."""
        if req.first_token_s is not None \
                and req.first_token_s >= req.enqueue_s:
            self._observe("Serve/stage.prefill_s",
                          req.first_token_s - req.enqueue_s)
        if req.first_token_s is not None and req.last_emit_s is not None \
                and req.last_emit_s > req.first_token_s:
            self._observe("Serve/stage.decode_s",
                          req.last_emit_s - req.first_token_s)

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self._metrics is not None:
            self._metrics.counter(f"Serve/{name}").incr(n)

    def _count_recovery(self, name: str, n: int = 1) -> None:
        self.recovery_counters[name] = \
            self.recovery_counters.get(name, 0) + n
        if self._metrics is not None:
            self._metrics.counter(_RECOVERY_COUNTERS[name]).incr(n)

    def _observe(self, name: str, value: float) -> None:
        if self._metrics is not None:
            self._metrics.histogram(name).observe(value)

    def _kv_occupancy(self) -> float:
        return kv_pool_stats(self.eng.kv, self.eng.allocator)["occupancy"]

    def _flush_gauges(self, now: Optional[float] = None) -> None:
        if self._metrics is None:
            return
        self._metrics.gauge("Serve/queue_depth").set(len(self.queue))
        self._metrics.gauge("Serve/kv_occupancy").set(self._kv_occupancy())
        self._metrics.gauge("Serve/live_seqs").set(len(self.running))
        if now is not None:
            miss, shed, burn = self._slo_snapshot(now)
            self._metrics.gauge("Serve/slo.ttft_miss_frac").set(miss)
            self._metrics.gauge("Serve/slo.shed_frac").set(shed)
            self._metrics.gauge("Serve/slo.burn_rate").set(burn)
        pc = self.eng.prefix_cache
        if pc is not None:
            # the cache keeps lifetime totals; registry counters take the
            # delta since the last flush (monotone either way)
            for key, metric in _PREFIX_COUNTERS.items():
                delta = pc.counters[key] - self._prefix_reported.get(key, 0)
                if delta:
                    self._metrics.counter(metric).incr(delta)
                    self._prefix_reported[key] = pc.counters[key]
            self._metrics.gauge("Serve/prefix.hit_ratio").set(pc.hit_ratio)
            self._metrics.gauge("Serve/prefix.pinned_blocks").set(
                pc.pinned_blocks)

    # ------------------------------------------------------------ reporting
    @property
    def idle(self) -> bool:
        return not self.running and not self.queue

    def prefix_stats(self) -> Optional[Dict[str, float]]:
        """Prefix-cache counters + hit ratio (None when no cache is
        installed) — what the fleet router joins with its placement-side
        ``Fleet/affinity_hits`` for REALIZED reuse."""
        pc = self.eng.prefix_cache
        return None if pc is None else pc.stats()

    def stats(self) -> Dict[str, float]:
        """Counters + instantaneous state, for bench lines and operators."""
        out = {**self.counters,
               **{f"recovery_{n}": v
                  for n, v in self.recovery_counters.items()},
               "queue_depth": len(self.queue),
               "live_seqs": len(self.running),
               "kv_occupancy": round(self._kv_occupancy(), 4),
               "prefill_tok_s_est": round(self.capacity.prefill_tok_s, 1),
               "decode_step_s_est": round(self.capacity.decode_step_s, 5)}
        ps = self.prefix_stats()
        if ps is not None:
            out.update({f"prefix_{k}": v for k, v in ps.items()})
        return out

    def summary_events(self, step: Optional[int] = None) -> List[Tuple]:
        """Scalar ``Serve/*`` events for a MonitorMaster print boundary —
        validated against the telemetry registry (strict mode safe).
        TTFT/ITL histograms surface their estimated p50/p95/p99 (bucket-
        interpolated, ``Histogram.quantile``) alongside the raw bucket
        counts the registry already holds — the scalar a dashboard or the
        pod report's skew table actually wants."""
        from ...monitor.telemetry import check_events

        from ...monitor.telemetry import resilience_counters

        ev = [(f"Serve/{n}", float(v), step)
              for n, v in self.counters.items()]
        ev += [(_RECOVERY_COUNTERS[n], float(v), step)
               for n, v in self.recovery_counters.items()]
        ev += [("Serve/recovery.serve_hang_aborts",
                float(resilience_counters.get("serve_hang_aborts")), step),
               ("Serve/queue_depth", float(len(self.queue)), step),
               ("Serve/live_seqs", float(len(self.running)), step),
               ("Serve/kv_occupancy", self._kv_occupancy(), step)]
        # getattr chain: skeleton sessions (offline renderers, report
        # tests) carry no engine at all
        pc = getattr(getattr(self, "eng", None), "prefix_cache", None)
        if pc is not None:
            ev += [(_PREFIX_COUNTERS[n], float(pc.counters[n]), step)
                   for n in _PREFIX_COUNTERS]
            ev += [("Serve/prefix.hit_ratio", float(pc.hit_ratio), step),
                   ("Serve/prefix.pinned_blocks",
                    float(pc.pinned_blocks), step)]
        if getattr(self, "_slo_ttft", None) is not None \
                and getattr(self, "clock", None) is not None:
            miss, shed, burn = self._slo_snapshot(self.now())
            ev += [("Serve/slo.ttft_miss_frac", miss, step),
                   ("Serve/slo.shed_frac", shed, step),
                   ("Serve/slo.burn_rate", burn, step)]
        if self._metrics is not None:
            for name in SERVE_HISTOGRAMS:
                hist = self._metrics.histogram(name)
                if not hist.count:
                    continue
                for q, value in hist.quantiles().items():
                    if value is not None:
                        ev.append((f"{name}/{q}", float(value), step))
        return check_events(ev)
