"""LR schedules as plain Python ``step -> float`` functions.

Port of ``deepspeedsyclsupport_tpu/runtime/lr_schedules.py`` (the
reference's LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR and
WarmupCosineLR, plus the constant schedule used when no scheduler is
configured). The JAX package writes them as traced functions compiled into
the update; here the optimizer calls them on the host once per step with
the step count, so they are ordinary Python arithmetic (float64).
"""
import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[int], float]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log"
              ) -> Schedule:
    """Ramp from min to max over ``warmup_num_steps`` (log or linear), then
    hold."""
    warmup_num_steps = max(2, warmup_num_steps)

    def sched(step):
        s = min(float(step), warmup_num_steps)
        if warmup_type == "log":
            frac = math.log1p(s) / math.log(warmup_num_steps + 1)
        else:
            frac = s / warmup_num_steps
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * min(frac, 1.0)

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    """Warmup, then linear decay to 0 at ``total_num_steps``."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def sched(step):
        s = float(step)
        if s < warmup_num_steps:
            return base(step)
        decay = (total_num_steps - s) / max(1.0, total_num_steps
                                            - warmup_num_steps)
        return warmup_max_lr * min(max(decay, 0.0), 1.0)

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001) -> Schedule:
    """Linear warmup, then cosine decay to ``cos_min_ratio``."""
    def sched(step):
        s = float(step)
        if s < warmup_num_steps:
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * min(
                s / max(1, warmup_num_steps), 1.0)
        else:
            prog = min(max((s - warmup_num_steps)
                           / max(1, total_num_steps - warmup_num_steps), 0.0),
                       1.0)
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
                1 + math.cos(math.pi * prog))
        return warmup_max_lr * ratio

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_ignored) -> Schedule:
    """min -> max over the first leg, max -> min over the second, then an
    optional decay below min."""
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size
    cycle_len = cycle_first_step_size + second

    def sched(step):
        s = float(step)
        if decay_step_size > 0 and s >= cycle_len:
            return cycle_min_lr * max(
                1.0 - decay_lr_rate * ((s - cycle_len) / decay_step_size), 0.0)
        if s < cycle_first_step_size:
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
                s / cycle_first_step_size)
        down = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
            (s - cycle_first_step_size) / max(1, second))
        return max(down, cycle_min_lr)

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    """Linearly increasing LR sweep."""
    def sched(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return sched


_FACTORIES: Dict[str, Callable[..., Schedule]] = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    ONE_CYCLE: one_cycle,
    LR_RANGE_TEST: lr_range_test,
}


def build_schedule(sched_type: Optional[str], params: Dict[str, Any],
                   base_lr: float) -> Schedule:
    """Config -> schedule; no type means the constant ``base_lr``."""
    if sched_type is None:
        return constant(base_lr)
    if sched_type not in _FACTORIES:
        raise ValueError(f"scheduler type {sched_type!r} not in "
                         f"{VALID_LR_SCHEDULES}")
    return _FACTORIES[sched_type](**params)
