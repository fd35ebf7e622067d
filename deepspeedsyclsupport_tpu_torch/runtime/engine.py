"""Training engine on one card.

Port of ``deepspeedsyclsupport_tpu/runtime/engine.py`` (``initialize``:64,
``Engine.train_batch``:989, the eager ``forward/backward/step``:1482-1592)
for one card. The JAX package compiles the whole step — forward, backward,
accumulation, clipping, update, loss-scale bookkeeping — into one jitted
program; here the same step runs eagerly:

* the params are float32 master tensors on the card; inside the loss they
  are cast to the compute dtype (``bf16``/``fp16`` config, else float32),
  so autograd returns float32 grads (``_cast_params``, :793-840);
* ``train_batch`` reshapes the global batch to ``(gas, micro, ...)``, runs
  each micro-batch's scaled loss backward (grads accumulate in ``.grad``),
  divides by ``gas``, then unscales, checks ``finite`` (fp16 only, as in
  the reference), takes the pre-clip global ``grad_norm``, clips (optax's
  ``clip_by_global_norm``) and applies the optimizer only when ``finite``
  (:862-917). Losses and metrics are averaged over micro-batches.

With fp16 the overflow gate reads ``finite`` on the host (one device sync
per step); without it nothing in the step waits for the card. ZeRO stages
0-3 are one program on one card. Checkpointing, offload, the resilience
hooks, the sentinel and telemetry are not ported: they raise
``NotImplementedError`` naming their ``ROADMAP.md`` entry.
"""
import copy
import dataclasses
import inspect
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .config import DSTpuConfig
from .loss_scaler import (grads_finite, init_loss_scale, scale_loss,
                          unscale_grads, update_loss_scale)
from .lr_schedules import build_schedule
from .optimizers import build_optimizer, current_lr
from ..device import resolve_device

logger = logging.getLogger(__name__)


class _InitTuple(NamedTuple):
    """Return shape of :func:`initialize`: ``engine, optimizer, dataloader,
    lr_scheduler = initialize(...)``."""
    engine: "Engine"
    optimizer: Any
    training_data: Any
    lr_scheduler: Any


def initialize(model: Any = None, loss_fn: Optional[Callable] = None,
               params: Any = None, config: Any = None,
               topology: Any = None, training_data: Any = None,
               lr_schedule: Optional[Callable] = None, device=None,
               config_params: Any = None) -> _InitTuple:
    """Build an :class:`Engine` (reference ``deepspeed.initialize``).

    ``model``: anything with ``loss(params, batch, rng, train=...)`` (the
    port's ``CausalLM``) — or pass ``loss_fn``. ``params``: the initial
    params tree (default ``model.init_params`` on the engine's device).
    ``device``: None means the card (and raises without one)."""
    config = config if config is not None else config_params
    if config is None:
        raise ValueError("config (dict or json path) is required")
    if topology is not None:
        raise NotImplementedError(
            "a device mesh / topology is not ported yet: ROADMAP.md, queue "
            "A.3.1 (distributed training)")
    if training_data is not None:
        raise NotImplementedError(
            "the engine's data loader is not ported yet: ROADMAP.md, queue "
            "A.3.3 (runtime/dataloader.py); pass batches to train_batch")
    dev = resolve_device(device)
    if loss_fn is None:
        if model is None or not hasattr(model, "loss"):
            raise ValueError("provide loss_fn, or a model with a .loss method")
        loss_fn = model.loss
    if params is None:
        if model is None or not hasattr(model, "init_params"):
            raise ValueError("provide params, or a model with init_params()")
        params = model.init_params(device=dev)
    engine = Engine(loss_fn=loss_fn, params=params, config=config,
                    lr_schedule=lr_schedule, module=model, device=dev)
    return _InitTuple(engine, engine.optimizer, None, engine.lr_schedule)


def _leaves(tree, path=()):
    """(path segments without list indices, tensor) for every leaf, in a
    fixed order. ``layers`` is a list here; JAX stacks it, so its paths are
    ``layers/attn/wq`` without an index — kept so that ``no_decay_patterns``
    match the same leaves in both packages."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, path)
    else:
        yield path, tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class Engine:
    def __init__(self, loss_fn: Callable, params: Any, config: Any,
                 lr_schedule: Optional[Callable] = None, module: Any = None,
                 device=None):
        self.device = resolve_device(device)
        self.config = DSTpuConfig.from_config(config)
        self.config.resolve_batch_sizes(1)
        self.module = module
        self.loss_fn_raw = loss_fn
        try:
            self._loss_accepts_train = "train" in inspect.signature(
                loss_fn).parameters
        except (TypeError, ValueError):
            self._loss_accepts_train = False
        self.zero_stage = self.config.zero_stage
        ac = self.config.activation_checkpointing
        mcfg = getattr(module, "config", None)
        if ac is not None and mcfg is not None and hasattr(mcfg, "remat"):
            # a private view of the model with remat set (engine.py:430-459):
            # the caller's model and config are left untouched
            view = copy.copy(module)
            view.config = dataclasses.replace(mcfg, remat=ac.enabled)
            if getattr(loss_fn, "__self__", None) is module:
                self.loss_fn_raw = getattr(view, loss_fn.__name__)
            self.module = view
        elif ac is not None:
            logger.warning("activation_checkpointing configured but the "
                           "model exposes no remat flag")

        # ------------------------------------------------------- precision
        self.compute_dtype = self.config.compute_dtype
        fp16 = self.config.fp16
        self.fp16_enabled = fp16.enabled
        self.scaler_state = init_loss_scale(
            fp16.initial_scale if fp16.enabled else 1.0,
            dynamic=fp16.enabled and fp16.dynamic, hysteresis=fp16.hysteresis)

        # ----------------------------------------------- master params
        def master(t):
            t = torch.as_tensor(t)
            if t.is_floating_point():
                return t.detach().to(self.device, torch.float32,
                                     copy=True).requires_grad_(True)
            return t.to(self.device)

        self.params = _tree_map(master, params)
        named = [(p, t) for p, t in _leaves(self.params)
                 if t.is_floating_point()]
        self._leaf_tensors: List[torch.Tensor] = [t for _, t in named]

        # ------------------------------------------------------- optimizer
        sched = self.config.scheduler
        self.lr_schedule = lr_schedule or build_schedule(
            sched.type, sched.params, self.config.optimizer.lr)
        self.optimizer = build_optimizer(self.config.optimizer.type,
                                         self.config.optimizer.params,
                                         self.lr_schedule)
        self.optimizer.init(self._leaf_tensors, [p for p, _ in named])

        # ----------------------------------------------------- bookkeeping
        self.global_steps = 0
        self.micro_steps = 0
        self._accum_count = 0
        self._accum_losses: List[torch.Tensor] = []
        self._pending: Optional[torch.Tensor] = None
        self._last_grad_norm: Optional[torch.Tensor] = None
        self.losses = None

    # =============================================================== loss core
    def _cast_params(self, params):
        dtype = self.compute_dtype
        return _tree_map(
            lambda t: t.to(dtype) if t.is_floating_point() else t, params)

    def _loss_and_metrics(self, params, batch, train: bool = True
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        p = self._cast_params(params)
        out = (self.loss_fn_raw(p, batch, None, train=train)
               if self._loss_accepts_train else self.loss_fn_raw(p, batch,
                                                                  None))
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        return loss.float(), dict(metrics)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _zero_grads(self) -> None:
        for t in self._leaf_tensors:
            t.grad = None

    def _grads(self) -> List[torch.Tensor]:
        return [t.grad if t.grad is not None else torch.zeros_like(t)
                for t in self._leaf_tensors]

    def _micro_backward(self, batch) -> Tuple[torch.Tensor, Dict]:
        loss, metrics = self._loss_and_metrics(self.params, batch)
        scale_loss(loss, self.scaler_state).backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def _apply_grads(self, grads: List[torch.Tensor]) -> Dict[str, Any]:
        """Unscale, overflow check, pre-clip norm, clip, gated update and
        loss-scale transition (``engine.py:862-917``). Grads are modified in
        place."""
        unscale_grads(grads, self.scaler_state)
        finite = grads_finite(grads) if self.fp16_enabled \
            else torch.ones((), dtype=torch.bool, device=self.device)
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))) if grads \
            else torch.zeros((), device=self.device)
        clip = self.config.gradient_clipping
        if clip and clip > 0 and grads:
            # optax.clip_by_global_norm: scale only when norm > max_norm
            factor = torch.where(grad_norm < clip,
                                 torch.ones_like(grad_norm), clip / grad_norm)
            torch._foreach_mul_(grads, factor)
        ok = bool(finite) if self.fp16_enabled else True
        if ok:
            self.optimizer.step(grads)
        fp16 = self.config.fp16
        self.scaler_state = update_loss_scale(
            self.scaler_state, ok, dynamic=self.fp16_enabled and fp16.dynamic,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
        self._last_grad_norm = grad_norm
        return {"grad_norm": grad_norm, "finite": finite,
                "loss_scale": self.scaler_state.scale}

    # ============================================================ fused path
    def train_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step on one global batch (leading dim =
        ``train_batch_size``), cut into ``gradient_accumulation_steps``
        micro-batches. Returns ``loss``, the loss function's metrics
        (``lm_loss``), ``grad_norm``, ``finite`` and ``loss_scale``."""
        gas = self.config.gradient_accumulation_steps
        batch = self._to_device(batch)
        for k, v in batch.items():
            if v.shape[0] % gas:
                raise ValueError(f"batch[{k!r}] leading dim {v.shape[0]} is "
                                 f"not a multiple of gradient_accumulation_"
                                 f"steps={gas}")
        self._zero_grads()
        losses, metrics = [], []
        for i in range(gas):
            mb = {k: v.reshape(gas, v.shape[0] // gas, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, m = self._micro_backward(mb)
            losses.append(loss)
            metrics.append(m)
        grads = self._grads()
        if gas > 1:
            torch._foreach_div_(grads, float(gas))
        out = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        out.update(self._apply_grads(grads))
        out["loss"] = torch.stack(losses).mean()
        self._zero_grads()
        self.global_steps += 1
        self.micro_steps += gas
        self._log(out)
        return out

    # ============================================================ eager path
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Loss on one micro-batch (reference ``engine.forward``). The
        autograd graph is kept for :meth:`backward`, which runs it instead
        of recomputing the forward as the JAX package must."""
        loss, _ = self._loss_and_metrics(self.params, self._to_device(batch))
        self._pending = loss
        self.losses = loss.detach()
        return loss

    def backward(self, loss: Optional[torch.Tensor] = None,
                 batch: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Accumulate one micro-batch's grads (reference ``engine.backward``)
        from the graph :meth:`forward` kept; with ``batch`` and no pending
        forward, runs the forward first."""
        if self._pending is None:
            if batch is None:
                raise RuntimeError("backward() needs forward() first or an "
                                   "explicit batch")
            self.forward(batch)
        if self._accum_count == 0:
            self._zero_grads()
        pending, self._pending = self._pending, None
        scale_loss(pending, self.scaler_state).backward()
        self._accum_losses.append(pending.detach())
        self._accum_count += 1
        self.micro_steps += 1
        return pending.detach()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._accum_count >= self.config.gradient_accumulation_steps

    def step(self) -> Dict[str, Any]:
        """Apply the accumulated grads, averaged over the micro-batches
        (reference ``engine.step``)."""
        if self._accum_count == 0:
            raise RuntimeError("step() before backward()")
        grads = self._grads()
        if self._accum_count > 1:
            torch._foreach_div_(grads, float(self._accum_count))
        out = self._apply_grads(grads)
        out["loss"] = torch.stack(self._accum_losses).mean()
        self._zero_grads()
        self._accum_count = 0
        self._accum_losses = []
        self.global_steps += 1
        self._log(out)
        return out

    def __call__(self, batch):
        return self.forward(batch)

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Loss on a batch without touching training state."""
        return self._loss_and_metrics(self.params, self._to_device(batch),
                                      train=False)[0]

    def _log(self, out: Dict[str, Any]) -> None:
        if self.global_steps % self.config.steps_per_print == 0:
            logger.info("step=%d loss=%.4f lr=%.3e scale=%.1f",
                        self.global_steps, float(out["loss"]), self.get_lr(),
                        self.get_loss_scale())

    # ============================================================= accessors
    @property
    def skipped_steps(self) -> int:
        return self.scaler_state.overflows

    def get_lr(self) -> float:
        return current_lr(self.optimizer)

    def get_loss_scale(self) -> float:
        return float(self.scaler_state.scale)

    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's pre-clip global grad norm (None before one)."""
        n = self._last_grad_norm
        return None if n is None else float(n)

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    # ================================================ not ported (queue A.3)
    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpointing is not ported yet: ROADMAP.md, queue A.3.3 "
            "(resilience: checkpoint/engine.py)")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpointing is not ported yet: ROADMAP.md, queue A.3.3 "
            "(resilience: checkpoint/engine.py)")

    def enable_preemption_handling(self, *args, **kwargs):
        raise NotImplementedError(
            "preemption handling is not ported yet: ROADMAP.md, queue A.3.3 "
            "(resilience: runtime/resilience.py)")
