"""Preemption-aware resilience: signal -> emergency save -> distinguished
exit.

Port of ``deepspeedsyclsupport_tpu/runtime/resilience.py``. A preempted
machine gets a SIGTERM and a short grace window, so:

* :class:`ResilienceManager` installs SIGTERM / SIGINT handlers that only
  store an attribute (a handler must take no lock: it runs between
  bytecodes of whatever frame it interrupted);
* the engine calls :meth:`ResilienceManager.at_step_boundary` after every
  optimizer step; on a pending preemption it saves a checkpoint, waits for
  it to be durable and exits with :data:`PREEMPTION_EXIT_CODE` through an
  injectable ``exit_fn``;
* the elastic agent (``elasticity/elastic_agent.py``) restarts a worker
  that exits 217 for free: it left a durable checkpoint behind.

A simulated preemption (``utils/fault_injection.py`` ``preempt_at_step``)
enters through the same step boundary.

Under a process group the scheduler's SIGTERM (or an injected preemption)
may reach the ranks at different step boundaries, and the emergency save
is a collective: ranks that saw the flag at different steps would wait
for each other forever. So at every step boundary, while handling is
armed, the pending flag is OR-ed over the world (one all-reduce of one
element, the only cost handling adds to a step): every rank then saves at
the same step, the pod commits and every rank exits 217. The JAX package's
single controller sees one flag and needs none of this.
"""
import signal
import sys
import threading
from typing import Any, Callable, Iterable, Optional

from ..utils.fault_injection import get_fault_injector
from ..utils.logging import logger
from .sentinel import DIVERGENCE_EXIT_CODE  # noqa: F401  (re-export)

# Distinguished "I was preempted and saved cleanly" exit code. Chosen outside
# the shell's 126/127/128+N signal-death range so it can't be confused with a
# crash, and mirrored by the elastic agent's free-restart accounting.
PREEMPTION_EXIT_CODE = 217


class ResilienceManager:
    """The signal -> flag -> emergency-save -> exit pipeline of one engine.
    ``exit_fn`` defaults to ``sys.exit``; tests pass one that raises."""

    def __init__(self, engine: Any, save_dir: str,
                 exit_code: int = PREEMPTION_EXIT_CODE,
                 exit_fn: Optional[Callable[[int], None]] = None):
        self.engine = engine
        self.save_dir = save_dir
        self.exit_code = exit_code
        self._exit_fn = exit_fn or sys.exit
        self.preemption_requested = threading.Event()
        self._signal_pending = False
        self._signal_num: Optional[int] = None
        self._prev_handlers = {}

    # ------------------------------------------------------------- signals
    def install(self, signals: Iterable[int] = (signal.SIGTERM,
                                                signal.SIGINT)) -> None:
        """Install the handlers (main thread only, a CPython rule)."""
        for s in signals:
            self._prev_handlers[s] = signal.signal(s, self._on_signal)

    def uninstall(self) -> None:
        while self._prev_handlers:
            s, prev = self._prev_handlers.popitem()
            signal.signal(s, prev)

    def _on_signal(self, signum, frame) -> None:
        # attribute stores only: an Event, the logger or the counters take
        # locks the interrupted frame may hold (a SIGTERM landing inside the
        # checkpoint write's retry counter would deadlock)
        self._signal_num = signum
        self._signal_pending = True

    def request_preemption(self) -> None:
        if not self.preemption_requested.is_set():
            self.preemption_requested.set()
            from ..monitor.monitor import resilience_counters

            resilience_counters.incr("preemptions")

    # -------------------------------------------------------- step boundary
    def at_step_boundary(self) -> None:
        """Called by the engine after each completed optimizer step (on
        every rank under a process group: the flag is agreed here)."""
        if self._signal_pending:
            self._signal_pending = False
            logger.warning("received signal %s: emergency checkpoint at "
                           "step boundary", self._signal_num)
            self.request_preemption()
        if not self.preemption_requested.is_set() and \
                get_fault_injector().should_preempt(self.engine.global_steps):
            logger.warning("fault injection: simulated preemption at "
                           "step %d", self.engine.global_steps)
            self.request_preemption()
        pending = self.preemption_requested.is_set()
        if getattr(self.engine, "distributed", False):
            from ..checkpoint.engine import world_any

            if world_any(pending) and not pending:
                logger.warning("a sibling rank was preempted: emergency "
                               "checkpoint at step %d",
                               self.engine.global_steps)
                self.request_preemption()
                pending = True
        if pending:
            self._emergency_save_and_exit()

    def _emergency_save_and_exit(self) -> None:
        from ..monitor.monitor import resilience_counters

        path = self.engine.save_checkpoint(self.save_dir)
        self.engine.checkpoint_engine.commit()  # durable before we die
        resilience_counters.incr("emergency_saves")
        try:
            self.engine._flush_monitor()
            self.engine.monitor.flush()
        except Exception as e:  # monitoring never blocks the exit
            logger.warning("monitor flush during preemption failed: %s", e)
        telemetry = getattr(self.engine, "telemetry", None)
        if telemetry is not None:
            # force the flight-recorder ring onto disk: the last steps
            # before this death must be inspectable after the fact
            try:
                telemetry.dump("preemption")
            except Exception as e:
                logger.warning("flight-recorder dump during preemption "
                               "failed: %s", e)
        logger.warning("emergency checkpoint %s durable; exiting with "
                       "preemption code %d", path, self.exit_code)
        self.uninstall()
        self._exit_fn(self.exit_code)
