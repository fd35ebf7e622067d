"""Wall-clock + throughput timers.

Port of ``deepspeedsyclsupport_tpu/utils/timer.py`` (reference
``deepspeed/utils/timer.py``: ``SynchronizedWallClockTimer`` and
``ThroughputTimer``). A synchronized start or stop drains the card's queue
first — ``torch.cuda.synchronize()`` on the timer's device when that is a
CUDA device; on the CPU there is nothing in flight and the sync is a
no-op. A stopped interval lands in the active flight recorder as a
``timer/<name>`` span.
"""
import time
from typing import Any, Dict, List, Optional

from .logging import logger

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


class _Timer:
    def __init__(self, name: str, device: Any = None):
        self.name = name
        self.device = device
        self._start: Optional[float] = None
        self._elapsed = 0.0
        self._record: List[float] = []
        self.started = False

    def start(self, sync: bool = False):
        if sync:
            _sync(self.device)
        self._start = time.perf_counter()
        self.started = True

    def stop(self, sync: bool = False, record: bool = True):
        if not self.started:
            return
        if sync:
            _sync(self.device)
        delta = time.perf_counter() - self._start
        self._elapsed += delta
        if record:
            self._record.append(delta)
        self.started = False
        # re-pointed island: timer intervals land in the flight recorder ring
        # (when one is active) so the step timeline shows fwd/bwd/step spans
        from ..monitor.telemetry import get_active_recorder

        rec = get_active_recorder()
        if rec is not None:
            rec.record("span", f"timer/{self.name}", dur=delta)

    def reset(self):
        self._start = None
        self._elapsed = 0.0
        self.started = False

    def elapsed(self, reset: bool = True) -> float:
        now = time.perf_counter()
        value = self._elapsed
        if self.started:
            value += now - self._start
        if reset:
            self._elapsed = 0.0
            if self.started:
                # rebase a running timer: without this the interval just
                # reported would be re-added by the subsequent stop()
                self._start = now
        return value

    def mean(self) -> float:
        return sum(self._record) / len(self._record) if self._record else 0.0


def _sync(device: Any = None) -> None:
    """Wait for the work queued on a CUDA ``device``; a no-op otherwise."""
    if device is None:
        return
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named timer registry (reference: ``utils/timer.py:43``); ``device``:
    what a synchronized start / stop waits for."""

    def __init__(self, device: Any = None):
        self.device = device
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.device)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False) -> str:
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}ms")
        msg = " | ".join(parts)
        logger.info("time: %s", msg)
        return msg

    def memory_usage(self) -> str:
        from ..monitor.telemetry import memory_stats

        stats = memory_stats(self.device)
        in_use = stats.get("bytes_in_use", 0) / 2**30
        peak = stats.get("peak_bytes_in_use", 0) / 2**30
        return f"mem_in_use={in_use:.2f}GB peak={peak:.2f}GB"


class ThroughputTimer:
    """Samples/sec + TFLOPS reporting (reference: ``utils/timer.py:198``)."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, monitor_memory: bool = False,
                 logging_fn=None):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = max(1, steps_per_output)
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self.global_step_count = 0
        self.local_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self._start_time = 0.0
        self.started = False

    def update_epoch_count(self):
        self.local_step_count = 0

    def start(self):
        self._start_time = time.perf_counter()
        self.started = True

    def stop(self, global_step: bool = True, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        self.global_step_count += int(global_step)
        self.local_step_count += 1
        duration = time.perf_counter() - self._start_time
        if self.global_step_count > self.start_step:
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                self.logging(
                    f"step={self.global_step_count}, "
                    f"samples/sec={self.avg_samples_per_sec():.2f}, "
                    f"batch_time={duration:.3f}s")
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            steps = self.global_step_count - self.start_step
            return self.batch_size / (self.total_elapsed_time / steps)
        return 0.0
