"""Collective hang watchdog: deadline-stamped dispatch, structured rc-218.

A copy of ``deepspeedsyclsupport_tpu/comm/watchdog.py`` (stdlib-only): the
same arm/disarm, warm-up allowance, faulthandler dump and ``os._exit``. The
port's serving session runs it around each scheduling round's dispatches
(rc 219); a CUDA launch queue plays the part of XLA's below.

At pod scale the dominant non-crash failure is the *silent* hang: one rank
stalls (bad host, stuck IO, kernel livelock) before an all-reduce, and every
sibling spins inside the collective forever — no exception, no exit code,
nothing for a supervisor to react to until a generic timeout guesses. This
module turns that into a structured contract:

* The engine **arms** the watchdog immediately before dispatching a step's
  collective phase and **disarms** it once the step's results are back. The
  arm stamps a ``comm/arm`` record (step + deadline + rank) into the flight
  recorder; the existing per-step ``step`` span is the post-dispatch record
  — so the pair survives on disk even when the process is killed mid-hang,
  and ``tools/pod_report.py`` can name the rank that *never armed* (never
  arrived) vs the ranks that armed and waited.
* A daemon thread polls the armed deadline. On expiry it force-writes a
  ``faulthandler`` all-thread stack dump (the main thread is wedged inside
  XLA — it cannot report itself), records a ``comm/hang`` event, flushes
  the flight recorder, bumps ``Resilience/comm_hang_aborts`` and exits the
  process with :data:`COMM_HANG_EXIT_CODE` (rc 218).
* The elastic agent (``elasticity/elastic_agent.py``) recognizes rc 218 as
  a *comm hang*: counted and restarted distinctly from a crash (rc≠0) and
  a preemption (rc 217), and the whole pod is torn down promptly instead
  of waiting for siblings to cascade.

The first armed step covers compilation (jit cache miss inside the dispatch
call), so it gets ``warmup_deadline_s``; every later step uses
``deadline_s``. Exit is ``os._exit`` by design: the main thread is stuck in
a C extension and ``sys.exit`` from a sibling thread would never unwind it.

Async-dispatch caveat: without ``telemetry.sync_timing`` the armed window
covers the dispatch call, and a purely device-side hang is detected when
XLA's bounded in-flight queue blocks a *later* dispatch inside its armed
window — rc 218 still fires within ~deadline of the queue filling, but the
attributed step can trail the wedged one by the queue depth. Enable
``sync_timing`` for exact-step windows (trades the dispatch/compute
overlap — the <5% overhead guard runs without it).
"""
import os
import threading
import time
from typing import Any, Callable, Optional, Tuple

from ..utils.logging import logger

# Distinguished "a collective deadline expired" exit code: adjacent to the
# preemption contract's 217, outside the shell's 126/127/128+N ranges, and
# mirrored by the elastic agent's per-cause restart accounting.
COMM_HANG_EXIT_CODE = 218

# Distinguished "a serving decode dispatch expired its deadline" exit code
# (the serving-plane sibling of 218 — `inference/v2/supervisor.py` and the
# elastic agent count it as its own restart class; docs/serving.md's
# failure contract). Defined here next to its training-plane twin so the
# supervisor/agent import stays light.
SERVE_HANG_EXIT_CODE = 219


class CollectiveWatchdog:
    """Deadline watch over one engine's collective phase.

    ``arm``/``disarm`` are step-path calls: one attribute store plus one
    flight-recorder append each (<5% overhead guard in the tier-1 suite
    covers them). The hot-path state is a single tuple attribute —
    GIL-atomic to publish, so the poller thread never needs the step path
    to take a lock.

    The deadline/abort machinery is plane-agnostic: the serving layer
    (``inference/v2/serving.py``) runs the SAME class around its decode
    dispatches with ``exit_code=SERVE_HANG_EXIT_CODE``, its own resilience
    counter and ``serve/arm``/``serve/hang`` record names — one watchdog
    implementation, two structured-exit contracts (rc 218 / rc 219).
    """

    def __init__(self, deadline_s: float, warmup_deadline_s: Optional[float]
                 = None, poll_s: float = 0.25, rank: int = 0,
                 telemetry: Any = None, stack_path: Optional[str] = None,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 exit_code: int = COMM_HANG_EXIT_CODE,
                 abort_counter: str = "comm_hang_aborts",
                 arm_name: str = "comm/arm", hang_name: str = "comm/hang",
                 what: str = "collective"):
        if deadline_s <= 0:
            raise ValueError(f"watchdog deadline_s must be > 0, "
                             f"got {deadline_s}")
        self.deadline_s = float(deadline_s)
        # the first dispatch compiles; default warmup allowance is 10x
        self.warmup_deadline_s = float(warmup_deadline_s
                                       if warmup_deadline_s is not None
                                       else 10.0 * deadline_s)
        self.poll_s = float(poll_s)
        self.rank = int(rank)
        self.telemetry = telemetry
        self.stack_path = stack_path
        self._exit_fn = exit_fn or os._exit
        self.exit_code = int(exit_code)
        self.abort_counter = abort_counter
        self.arm_name = arm_name
        self.hang_name = hang_name
        self.what = what
        #: (step, armed_at_monotonic, deadline_s) while a collective phase
        #: is in flight, else None — published with one attribute store
        self._inflight: Optional[Tuple[int, float, float]] = None
        self._completed_once = False
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ step path
    def arm(self, step: int, deadline_s: Optional[float] = None) -> float:
        """Pre-dispatch stamp: record the deadline and publish the in-flight
        marker. Returns the deadline used."""
        d = float(deadline_s if deadline_s is not None else
                  (self.deadline_s if self._completed_once
                   else self.warmup_deadline_s))
        rec = self._recorder()
        if rec is not None:
            rec.record("event", self.arm_name, step=step,
                       data={"deadline_s": d, "rank": self.rank})
        self._inflight = (int(step), time.monotonic(), d)
        return d

    def disarm(self, step: int) -> None:
        """Post-dispatch stamp: the step's results are back — the per-step
        ``step`` span the engine records right after is the durable post
        record, so disarm itself writes nothing."""
        self._inflight = None
        self._completed_once = True

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "CollectiveWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name="dstpu-comm-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 1.0)
            self._thread = None

    # ------------------------------------------------------------- watching
    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            s = self._inflight
            if s is None:
                continue
            step, armed_at, deadline = s
            waited = time.monotonic() - armed_at
            if waited <= deadline:
                continue
            # re-check identity: a disarm/arm race between reads must not
            # fire on a step that actually completed
            if self._inflight is not s:
                continue
            self._fire(step, waited, deadline)
            return

    def _fire(self, step: int, waited: float, deadline: float) -> None:
        if self._fired:  # pragma: no cover - defensive re-entry guard
            return
        self._fired = True
        from ..monitor.monitor import resilience_counters

        resilience_counters.incr(self.abort_counter)
        logger.error(
            "%s watchdog: step %d in flight %.1fs > deadline %.1fs "
            "— rank %d declares a hang; dumping stacks and exiting "
            "rc=%d", self.what, step, waited, deadline, self.rank,
            self.exit_code)
        self._dump_stacks()
        rec = self._recorder()
        if rec is not None:
            try:
                rec.record("event", self.hang_name, step=step,
                           data={"waited_s": round(waited, 3),
                                 "deadline_s": deadline, "rank": self.rank})
            except Exception:  # pragma: no cover - never block the exit
                pass
        if self.telemetry is not None:
            try:  # force the ring (arm records included) onto disk
                self.telemetry.dump(self.hang_name.replace("/", "_"))
            except Exception as e:  # pragma: no cover
                logger.warning("watchdog telemetry dump failed: %s", e)
        self._exit_fn(self.exit_code)

    def _dump_stacks(self) -> None:
        """All-thread faulthandler dump: the main thread is wedged inside a
        collective and cannot report itself."""
        import faulthandler

        try:
            if self.stack_path:
                with open(self.stack_path, "a") as f:
                    label = self.arm_name.split("/", 1)[0]  # comm | serve
                    f.write(f"\n=== {label} watchdog fired "
                            f"(rank {self.rank}, pid {os.getpid()}) ===\n")
                    f.flush()
                    faulthandler.dump_traceback(file=f, all_threads=True)
            else:
                faulthandler.dump_traceback(all_threads=True)
        except Exception as e:  # pragma: no cover - diagnostics best-effort
            logger.warning("watchdog stack dump failed: %s", e)

    def _recorder(self):
        t = self.telemetry
        return None if t is None else getattr(t, "recorder", None)
