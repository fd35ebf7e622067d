"""fp16 loss scaling.

Port of ``deepspeedsyclsupport_tpu/runtime/loss_scaler.py``. The JAX package
threads an immutable scaler pytree through its jitted step and makes every
transition branch-free; here the state lives on the host as plain numbers
and the transition is ordinary Python, the same machine as the JAX
package's ``update_loss_scale`` (:46-72) and its host twin: on overflow the
step is skipped and the scale halves after ``hysteresis`` consecutive
overflows; after ``scale_window`` clean steps it doubles.
"""
from typing import List, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float           # current loss scale
    good_steps: int        # consecutive overflow-free steps
    hysteresis_left: int   # overflows still tolerated before halving
    overflows: int         # cumulative skipped steps


def init_loss_scale(initial_scale: float, dynamic: bool,
                    hysteresis: int = 2) -> LossScaleState:
    return LossScaleState(scale=float(initial_scale), good_steps=0,
                          hysteresis_left=hysteresis if dynamic else 2**30,
                          overflows=0)


def grads_finite(grads: List[torch.Tensor]) -> torch.Tensor:
    """Global overflow check: a 0-d bool tensor on the grads' device."""
    if not grads:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_loss_scale(state: LossScaleState, finite: bool, *, dynamic: bool,
                      scale_window: int, scale_factor: float = 2.0,
                      min_scale: float = 1.0,
                      hysteresis: int = 2) -> LossScaleState:
    """One scaler transition (reference ``DynamicLossScaler.update_scale``)."""
    finite = bool(finite)
    overflows = state.overflows + (0 if finite else 1)
    if not dynamic:
        return state._replace(overflows=overflows)
    scale, good, hys = state.scale, state.good_steps, state.hysteresis_left
    if finite:
        good += 1
        if good >= scale_window:
            scale *= scale_factor
            good = 0
            hys = hysteresis
    else:
        hys -= 1
        if hys <= 0:
            scale = max(scale / scale_factor, min_scale)
            hys = hysteresis
        good = 0
    return LossScaleState(scale=scale, good_steps=good, hysteresis_left=hys,
                          overflows=overflows)


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale


def unscale_grads(grads: List[torch.Tensor], state: LossScaleState) -> None:
    """Multiply float32 grads by ``1 / scale`` in place."""
    if state.scale != 1.0 and grads:
        torch._foreach_mul_(grads, 1.0 / state.scale)


def overflow_ledger(state: LossScaleState) -> dict:
    """The scaler's overflow bookkeeping for the training sentinel's
    journal (its divergence abort record)."""
    return {"overflows": int(state.overflows), "scale": float(state.scale),
            "good_steps": int(state.good_steps)}
