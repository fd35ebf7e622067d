"""Deterministic fault injection for resilience testing.

Port of ``deepspeedsyclsupport_tpu/utils/fault_injection.py``: the same
spec grammar, the same ``DSTPU_FAULT_INJECTION`` env var, every host hook;
``corrupt_batch`` poisons the floating-point torch tensors of a batch.

TPU fleet reality (arXiv 2011.03641's failure-domain analysis): VMs get
maintenance-evicted mid-step, NFS/GCS writes fail transiently, and async
writers can be arbitrarily delayed — so every one of those failure modes
needs a *deterministic* lever the test suite can pull. A single process-wide
:class:`FaultInjector` exposes injection points that the checkpoint writers
(``checkpoint/engine.py``), the async engine
(``checkpoint/ckpt_engine.py::AsyncCheckpointEngine``) and the preemption
handler (``runtime/resilience.py``) consult. All state is counter-based —
no wall-clock or RNG — so a given spec replays identically.

Spec (programmatic dict or JSON in the ``DSTPU_FAULT_INJECTION`` env var):

``{"write_fail":  {"match": "state.bin", "count": 2},``
``  "truncate":   {"match": "state.bin", "keep_bytes": 64, "count": 1},``
``  "async_delay": 0.05,``
``  "preempt_at_step": 3,``
``  "hang_step":   {"rank": 1, "step": 4, "seconds": 600},``
``  "kill_step":   {"rank": 1, "step": 4, "rc": 1},``
``  "tear_pod":    {"rank": 0, "skip": 1, "drop": "commit", "count": 1}}``

* ``write_fail`` — the next ``count`` storage writes whose target path
  contains ``match`` raise a transient :class:`OSError` (``EIO``) before any
  bytes hit disk. Paired with :func:`retry_io` this exercises the
  self-healing path.
* ``truncate`` — after a matching file is durably written, chop it to
  ``keep_bytes`` (or ``keep_fraction`` of its size): a torn write, exactly
  what a preemption mid-``write(2)`` leaves behind.
* ``async_delay`` — seconds the async checkpoint worker sleeps before
  touching storage, widening the save/shutdown race window.
* ``preempt_at_step`` — deliver one simulated preemption request at the
  first step boundary where ``global_steps >= N`` (consumed by
  ``runtime/resilience.py``), standing in for a real SIGTERM.

Pod-scale (comm-layer) faults — rank-targeted and one-shot, so a chosen
rank misbehaves deterministically while its siblings stay healthy:

* ``hang_step`` — rank ``rank`` blocks for ``seconds`` (default forever,
  i.e. until killed) *before dispatching* step ``step``'s collectives: the
  rank never arrives at the all-reduce, every sibling spins inside it, and
  the collective watchdog (``comm/watchdog.py``) is what ends the pod.
  Consumed by the engine at the top of ``train_batch``.
* ``kill_step`` — rank ``rank`` dies with ``os._exit(rc)`` (default 1) at
  the step boundary *after* completing step ``step``: a hard crash with no
  emergency save, exercising the agent's prompt sibling teardown.
* ``tear_pod`` — tears the two-phase pod-commit record of a checkpoint
  after the save claims durability: ``drop: "commit"`` deletes
  ``dstpu_commit.json`` (phase 2 never happened), ``drop: "rank_manifest"``
  deletes rank ``drop_rank``'s phase-1 manifest. ``skip`` healthy saves
  pass through first; only the actor ``rank`` performs the teardown (the
  files are shared). Consumed by ``checkpoint/engine.py::save_tree``.

Serving-plane faults (one-shot, consumed by
``inference/v2/serving.ServingSession`` / the KV block allocator — the
deterministic levers behind the crash-replay and stuck-decode contracts in
``docs/serving.md``):

* ``decode_wedge`` — ``{"round": N, "seconds": S}``: the serving session
  blocks for ``seconds`` (default: until killed) inside scheduling round
  ``N``'s dispatch window, AFTER the stuck-decode watchdog armed — so the
  session's own watchdog converts the wedge into rc 219
  (``SERVE_HANG_EXIT_CODE``).
* ``serve_crash`` — ``{"round": N}`` or ``{"tokens": N}`` (+ optional
  ``rc``, default 1): the serving process dies with ``os._exit(rc)`` at
  the start of scheduling round ``N`` / once ``N`` total tokens have been
  emitted — a hard mid-decode crash with no cleanup, exercising the
  request journal + replica-supervisor replay path.

  Both serving faults accept an optional ``attempt`` key: fire only in
  supervisor incarnation ``DSTPU_ELASTIC_ATTEMPT == attempt`` (the env
  spec is re-read by every restarted process — without the gate a
  one-shot fault would re-arm each incarnation and recovery could never
  complete).
* ``kv_alloc_fail`` — ``{"count": N}``: the next ``N`` KV block-pool
  allocations behave as exhausted (``BlockedAllocator.try_allocate``
  returns None). Exercises the structured-backpressure contract: an
  allocation failure must queue/shed through the session, never raise out
  of the engine loop.

Numerical faults (consumed by the engine right before step dispatch; the
deterministic levers behind the training-health sentinel's ladder,
``runtime/sentinel.py`` / docs/resilience.md "numerical faults"). Each is
rank-targeted, fires for ``count`` consecutive steps starting at ``step``
(default 1), decrements as it fires — so a sentinel rollback that replays
the step window does NOT re-poison it — and honors the ``attempt`` gate:

* ``nan_step`` — ``{"rank": R, "step": N, "count": 1}``: every float leaf
  of step ``N``'s batch is multiplied by NaN, so the loss and every
  gradient go nonfinite. The in-graph health gate must discard the update.
* ``loss_spike`` — ``{"rank": R, "step": N, "factor": 1e3, "count": 1}``:
  float batch leaves are scaled by ``factor`` — a finite but wildly
  out-of-distribution loss, the spike the robust z-score detector names.
* ``bad_batch`` — ``{"rank": R, "step": N, "fill": 1e4, "count": 1}``:
  float batch leaves are REPLACED with the constant ``fill`` — garbage
  data (a corrupt shard read), not merely scaled data.
"""
import errno
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, TypeVar

from .logging import logger

ENV_SPEC = "DSTPU_FAULT_INJECTION"

T = TypeVar("T")


class InjectedOSError(OSError):
    """Marker subclass so logs/tests can tell injected faults from real ones."""


class FaultInjector:
    """Counter-based fault delivery; thread-safe (the async checkpoint worker
    and the training thread both consult it)."""

    def __init__(self, spec: Optional[Dict[str, Any]] = None):
        spec = dict(spec or {})
        self.write_fail = dict(spec.get("write_fail") or {})
        self.truncate = dict(spec.get("truncate") or {})
        self.async_delay = float(spec.get("async_delay") or 0.0)
        p = spec.get("preempt_at_step")
        self.preempt_at_step: Optional[int] = None if p is None else int(p)
        self.hang_step = dict(spec.get("hang_step") or {})
        self.kill_step = dict(spec.get("kill_step") or {})
        self.tear_pod = dict(spec.get("tear_pod") or {})
        self.decode_wedge = dict(spec.get("decode_wedge") or {})
        self.serve_crash = dict(spec.get("serve_crash") or {})
        # numerical faults: remaining-step counters, decremented
        # as they fire so a rollback replay never re-poisons the window
        self.nan_step = dict(spec.get("nan_step") or {})
        self.loss_spike = dict(spec.get("loss_spike") or {})
        self.bad_batch = dict(spec.get("bad_batch") or {})
        self._nan_steps_left = int(self.nan_step.get("count", 1)
                                   if self.nan_step else 0)
        self._spike_steps_left = int(self.loss_spike.get("count", 1)
                                     if self.loss_spike else 0)
        self._bad_batches_left = int(self.bad_batch.get("count", 1)
                                     if self.bad_batch else 0)
        self._kv_alloc_fails_left = int(
            (spec.get("kv_alloc_fail") or {}).get("count", 0))
        self._write_failures_left = int(self.write_fail.get("count", 0))
        self._truncates_left = int(self.truncate.get("count", 1)
                                   if self.truncate else 0)
        self._tears_left = int(self.tear_pod.get("count", 1)
                               if self.tear_pod else 0)
        self._tear_skips_left = int(self.tear_pod.get("skip", 0))
        self._preempted = False
        self._hung = False
        self._killed = False
        self._decode_wedged = False
        self._serve_crashed = False
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> "FaultInjector":
        raw = os.environ.get(ENV_SPEC)
        if not raw:
            return cls()
        try:
            return cls(json.loads(raw))
        except ValueError as e:
            raise ValueError(f"{ENV_SPEC} is not valid JSON: {e}") from e

    @property
    def armed(self) -> bool:
        return bool(self.write_fail or self.truncate or self.async_delay
                    or self.preempt_at_step is not None
                    or self.hang_step or self.kill_step or self.tear_pod
                    or self.decode_wedge or self.serve_crash
                    or self.nan_step or self.loss_spike or self.bad_batch
                    or self._kv_alloc_fails_left)

    # ------------------------------------------------------- injection points
    @staticmethod
    def _matches(pattern: Optional[str], path: str) -> bool:
        return pattern is None or pattern in path

    def maybe_fail_write(self, path: str) -> None:
        """Raise a transient ``OSError`` for the next N matching writes."""
        with self._lock:
            if self._write_failures_left <= 0:
                return
            if not self._matches(self.write_fail.get("match"), path):
                return
            self._write_failures_left -= 1
        raise InjectedOSError(errno.EIO,
                              f"injected transient write failure for {path}")

    def maybe_truncate(self, path: str) -> bool:
        """Tear a durably-written file; returns True if it was truncated."""
        with self._lock:
            if self._truncates_left <= 0:
                return False
            if not self._matches(self.truncate.get("match"), path):
                return False
            self._truncates_left -= 1
        size = os.path.getsize(path)
        keep = self.truncate.get("keep_bytes")
        if keep is None:
            keep = int(size * float(self.truncate.get("keep_fraction", 0.5)))
        keep = max(0, min(int(keep), size))
        with open(path, "rb+") as f:
            f.truncate(keep)
        logger.warning("fault injection: tore %s to %d/%d bytes",
                       path, keep, size)
        return True

    def maybe_delay_async(self) -> None:
        if self.async_delay > 0:
            time.sleep(self.async_delay)

    def should_preempt(self, global_steps: int) -> bool:
        """One-shot simulated preemption at step boundary >= N."""
        with self._lock:
            if self._preempted or self.preempt_at_step is None:
                return False
            if global_steps < self.preempt_at_step:
                return False
            self._preempted = True
        return True

    # -------------------------------------------------- pod (comm-layer) faults
    def maybe_hang_step(self, rank: int, global_steps: int,
                        phase: str = "pre") -> bool:
        """One-shot rank-targeted stall in the step's collective window.

        ``phase: "pre"`` (spec default) stalls BEFORE the watchdog arms —
        the rank *never arrives* at the all-reduce; the siblings spin
        inside it and their watchdogs (or the agent's teardown) end the
        pod. ``phase: "in"`` stalls after arming — the rank arrived and
        then wedged, so its OWN watchdog fires. Blocks for ``seconds``
        (default: effectively forever; the process is expected to be
        killed first). Returns whether it hung."""
        with self._lock:
            if self._hung or not self.hang_step:
                return False
            if self.hang_step.get("phase", "pre") != phase:
                return False
            if int(self.hang_step.get("rank", 0)) != int(rank):
                return False
            if global_steps < int(self.hang_step.get("step", 0)):
                return False
            self._hung = True
        seconds = float(self.hang_step.get("seconds", 0) or 0)
        logger.warning("fault injection: rank %d hanging %s step %d's "
                       "collective window (%s)", rank,
                       "inside" if phase == "in" else "before",
                       global_steps,
                       f"{seconds:.0f}s" if seconds > 0 else "until killed")
        self._stall(seconds)
        return True

    @staticmethod
    def _stall(seconds: float) -> None:
        """Block for ``seconds`` (<= 0: effectively forever — the process
        is expected to be killed first). The sleep argument is clamped to
        >= 0: the deadline can elapse between the loop check and the
        argument computation, and a negative ``time.sleep`` raises."""
        deadline = (time.monotonic() + seconds) if seconds > 0 else None
        while deadline is None or time.monotonic() < deadline:
            time.sleep(max(0.0, min(1.0, (deadline - time.monotonic())
                                    if deadline else 1.0)))

    def should_kill(self, rank: int, global_steps: int) -> Optional[int]:
        """One-shot hard-death request for this rank at a step boundary:
        returns the exit code to die with (the caller ``os._exit``\\ s — no
        emergency save, no cleanup; this is a crash, not a preemption)."""
        with self._lock:
            if self._killed or not self.kill_step:
                return None
            if int(self.kill_step.get("rank", 0)) != int(rank):
                return None
            if global_steps < int(self.kill_step.get("step", 0)):
                return None
            self._killed = True
        return int(self.kill_step.get("rc", 1))

    def corrupt_batch(self, rank: int, global_steps: int, batch: Any,
                      skip_keys: tuple = ()) -> Any:
        """Numerical-fault seam (consumed by the engine right before step
        dispatch): poison the batch a chosen rank is about to train on.
        Fires for ``count`` consecutive steps starting at ``step`` and
        decrements as it fires, so a sentinel rollback that replays the
        window trains on clean data. Only floating-point leaves are
        touched; top-level dict keys in ``skip_keys`` (the engine's own
        riders: ``pld_theta``, the sentinel gate) pass through untouched."""
        mode = spec = None
        with self._lock:
            for name, left_attr, s in (
                    ("nan_step", "_nan_steps_left", self.nan_step),
                    ("bad_batch", "_bad_batches_left", self.bad_batch),
                    ("loss_spike", "_spike_steps_left", self.loss_spike)):
                left = getattr(self, left_attr)
                if left <= 0 or not s:
                    continue
                if int(s.get("rank", 0)) != int(rank):
                    continue
                if global_steps < int(s.get("step", 0)):
                    continue
                if not self._attempt_matches(s):
                    continue
                setattr(self, left_attr, left - 1)
                mode, spec = name, s
                break
        if mode is None:
            return batch
        if mode == "nan_step":
            poison_leaf = lambda x: x * float("nan")  # noqa: E731
        elif mode == "loss_spike":
            factor = float(spec.get("factor", 1e3))
            poison_leaf = lambda x: x * factor  # noqa: E731
        else:  # bad_batch: replace with a constant, keep shape/dtype/device
            fill = float(spec.get("fill", 1e4))
            poison_leaf = lambda x: x * 0 + fill  # noqa: E731

        def poison(x):
            if isinstance(x, dict):
                return {k: poison(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(poison(v) for v in x)
            if getattr(x, "is_floating_point", None) is not None \
                    and x.is_floating_point():
                return poison_leaf(x)
            return x

        logger.warning("fault injection: rank %d %s poisoning the batch for "
                       "step %d", rank, mode, global_steps)
        if isinstance(batch, dict) and skip_keys:
            kept = {k: v for k, v in batch.items() if k in skip_keys}
            poisoned = poison({k: v for k, v in batch.items()
                               if k not in kept})
            return {**poisoned, **kept}
        return poison(batch)

    def maybe_tear_pod(self, path: str, rank: int) -> Optional[str]:
        """Tear a pod checkpoint's two-phase commit after the save claimed
        durability: delete the commit record (``drop: "commit"``) or one
        rank's phase-1 manifest (``drop: "rank_manifest"`` +
        ``drop_rank``). ``skip`` healthy saves pass first; only the actor
        ``rank`` tears (the files are shared across ranks). Returns the
        deleted path, or None."""
        with self._lock:
            if self._tears_left <= 0 or not self.tear_pod:
                return None
            if int(self.tear_pod.get("rank", 0)) != int(rank):
                return None
            if self._tear_skips_left > 0:
                self._tear_skips_left -= 1
                return None
            self._tears_left -= 1
        from ..checkpoint.engine import COMMIT_FILE, rank_manifest_name

        if self.tear_pod.get("drop", "commit") == "rank_manifest":
            victim = os.path.join(path, rank_manifest_name(
                int(self.tear_pod.get("drop_rank", 0))))
        else:
            victim = os.path.join(path, COMMIT_FILE)
        try:
            os.unlink(victim)
        except OSError as e:
            logger.warning("fault injection: could not tear pod commit "
                           "%s: %s", victim, e)
            return None
        logger.warning("fault injection: tore pod checkpoint %s (deleted "
                       "%s)", path, os.path.basename(victim))
        return victim

    # ----------------------------------------------------- serving-plane faults
    @staticmethod
    def _attempt_matches(spec: Dict[str, Any]) -> bool:
        """Optional ``attempt`` key: the fault fires only in the named
        supervisor incarnation (``DSTPU_ELASTIC_ATTEMPT``). The env spec is
        re-read by every restarted process, so without this gate a one-shot
        serving fault would re-arm in each incarnation and the recovery it
        exists to test could never complete."""
        a = spec.get("attempt")
        if a is None:
            return True
        return int(os.environ.get("DSTPU_ELASTIC_ATTEMPT", "0")) == int(a)

    def maybe_wedge_decode(self, round_no: int) -> bool:
        """One-shot stall inside the serving session's dispatch window
        (AFTER the stuck-decode watchdog armed, so rc 219 is the expected
        outcome). Blocks for ``seconds`` (default: effectively forever —
        the watchdog or the supervisor is expected to kill the process
        first). Returns whether it wedged."""
        with self._lock:
            if self._decode_wedged or not self.decode_wedge:
                return False
            if not self._attempt_matches(self.decode_wedge):
                return False
            if round_no < int(self.decode_wedge.get("round", 0)):
                return False
            self._decode_wedged = True
        seconds = float(self.decode_wedge.get("seconds", 0) or 0)
        logger.warning("fault injection: wedging serving round %d's decode "
                       "dispatch (%s)", round_no,
                       f"{seconds:.0f}s" if seconds > 0 else "until killed")
        self._stall(seconds)
        return True

    def should_serve_crash(self, round_no: int,
                           tokens_emitted: int) -> Optional[int]:
        """One-shot mid-decode hard-death request for the serving process:
        returns the exit code to die with (the caller ``os._exit``\\ s — no
        cleanup, no journal close; the request journal's per-record flush
        is what recovery rides). Triggers at scheduling round ``round`` or
        once ``tokens`` total tokens have been emitted."""
        with self._lock:
            if self._serve_crashed or not self.serve_crash:
                return None
            if not self._attempt_matches(self.serve_crash):
                return None
            at_round = self.serve_crash.get("round")
            at_tokens = self.serve_crash.get("tokens")
            hit = ((at_round is not None and round_no >= int(at_round))
                   or (at_tokens is not None
                       and tokens_emitted >= int(at_tokens)))
            if not hit:
                return None
            self._serve_crashed = True
        return int(self.serve_crash.get("rc", 1))

    def should_fail_kv_alloc(self) -> bool:
        """Consume one injected KV-pool allocation failure (the allocator
        reports exhaustion instead of handing out blocks)."""
        with self._lock:
            if self._kv_alloc_fails_left <= 0:
                return False
            self._kv_alloc_fails_left -= 1
        logger.warning("fault injection: KV block allocation reported as "
                       "exhausted")
        return True


# -------------------------------------------------------------- global access
_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def get_fault_injector() -> FaultInjector:
    """Process-wide injector; built from ``DSTPU_FAULT_INJECTION`` on first use."""
    global _injector
    with _injector_lock:
        if _injector is None:
            _injector = FaultInjector.from_env()
        return _injector


def configure_fault_injection(spec: Optional[Dict[str, Any]]
                              ) -> Optional[FaultInjector]:
    """Install (or with ``None`` clear) the process-wide injector. After a
    clear the next :func:`get_fault_injector` re-reads the env var."""
    global _injector
    with _injector_lock:
        _injector = FaultInjector(spec) if spec is not None else None
        return _injector


# ------------------------------------------------------------------ retry I/O
def retry_io(fn: Callable[[], T], *, attempts: int = 3,
             base_delay: float = 0.01, max_delay: float = 0.5,
             what: str = "storage I/O",
             on_retry: Optional[Callable[[int, BaseException], None]] = None
             ) -> T:
    """Run ``fn`` retrying transient ``OSError`` with capped exponential
    backoff — GCS/NFS blips and injected faults self-heal instead of killing
    a multi-hour run. Each retry is recorded on the resilience counters
    (``monitor/monitor.py``) so operators see degradation, not silence."""
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as e:
            last = e
            if attempt == attempts - 1:
                break
            from ..monitor.monitor import resilience_counters

            resilience_counters.incr("io_retries")
            if on_retry is not None:
                on_retry(attempt + 1, e)
            delay = min(max_delay, base_delay * (2 ** attempt))
            logger.warning("%s failed (%s); retry %d/%d in %.3fs",
                           what, e, attempt + 1, attempts - 1, delay)
            time.sleep(delay)
    from ..monitor.monitor import resilience_counters

    resilience_counters.incr("io_giveups")
    assert last is not None
    raise last
