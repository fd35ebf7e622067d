"""Optimizers on float32 master tensors.

Port of ``deepspeedsyclsupport_tpu/runtime/optimizers.py`` for the Adam
family: ``adam``, ``adamw``, ``fusedadam`` and ``cpuadam`` (``adam_w_mode``
True, the default, is AdamW; False is classic Adam without weight decay),
with ``no_decay_patterns``. The JAX package runs ``optax.adamw``/``adam``
under ``inject_hyperparams``; :class:`Adam` follows the same algebra with
``torch._foreach_*`` over the master tensors, updated in place:

* ``mu = b1·mu + (1−b1)·g``, ``nu = b2·nu + (1−b2)·g²``, bias correction at
  step ``t = count + 1``: ``u = (mu/(1−b1^t)) / (sqrt(nu/(1−b2^t)) + eps)``
  (``eps`` outside the sqrt);
* decoupled decay ``u += wd·p`` on the leaves the mask keeps;
* ``p -= lr·u`` with ``lr = schedule(count)`` read BEFORE the count is
  incremented, as ``optax.inject_hyperparams`` does; :attr:`Adam.last_lr`
  is what ``current_lr`` reports (the reference's ``param_groups[0]['lr']``).

The state is checkpointed in the JAX package's optax layout, leaf for leaf
(:meth:`Adam.state_tree`): ``inject_hyperparams``' ``count``,
``hyperparams`` (``b1``, ``b2``, ``eps``, ``eps_root``, ``learning_rate``
and, for AdamW, ``weight_decay``: float32) and the schedule's ``count``,
then ``scale_by_adam``'s ``count``, ``mu`` and ``nu`` (counts int32), all
under ``1/`` when gradient clipping puts ``clip_by_global_norm``'s empty
state at index 0 of a chain. The stored ``learning_rate`` is the float32
value of the last update's rate (the schedule at step 0 before one), as
optax carries it; a loaded value is carried as it was read. The config's
betas and eps drive the arithmetic; the stored ones are carried for the
format.

The reference's fused Adam is not a TPU kernel (``optimizers.py:10-13``: a
jitted optax update is the fused multi-tensor kernel there), so none is
written here: the foreach ops are PyTorch's multi-tensor kernels. Lamb,
Lion, SGD, Adagrad and the 1-bit family raise ``NotImplementedError``.
"""
import fnmatch
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

ADAM_FAMILY = ("adam", "adamw", "fusedadam", "cpuadam")
NOT_PORTED = ("lamb", "fusedlamb", "lion", "fusedlion", "sgd", "adagrad",
              "onebitadam", "zerooneadam", "onebitlamb")
# elements per foreach call: bounds the float32 temporaries of one update
# (two of them: 512 MiB); a larger contiguous leaf is cut into flat views
_CHUNK_ELEMS = 1 << 26


def _common(params: Dict[str, Any]):
    lr = float(params.get("lr", 1e-3))
    betas = params.get("betas", (0.9, 0.999))
    eps = float(params.get("eps", 1e-8))
    wd = float(params.get("weight_decay", 0.0))
    return lr, (float(betas[0]), float(betas[1])), eps, wd


def decay_mask(patterns: Optional[Sequence[str]]
               ) -> Optional[Callable[[Sequence[str]], bool]]:
    """``optimizer.params.no_decay_patterns`` as a predicate over a leaf's
    path segments (True = decay), the JAX package's ``_decay_mask``
    (``optimizers.py:58-90``): a pattern matches a WHOLE segment (glob
    syntax), or, when it contains "/", a substring of the "/"-joined path.
    Paths are the JAX package's, without list indices (``layers/attn/wq``),
    so one config decays the same leaves in both packages."""
    if not patterns:
        return None
    pats = [str(x) for x in patterns]

    def decays(segs: Sequence[str]) -> bool:
        joined = "/".join(segs)
        for pat in pats:
            if "/" in pat:
                if pat in joined:
                    return False
            elif any(fnmatch.fnmatch(seg, pat) for seg in segs):
                return False
        return True

    return decays


class Adam:
    """Adam/AdamW over a list of float32 master tensors (see the module
    docstring). :meth:`init` takes the leaves and their path segments;
    :meth:`step` updates the leaves in place from float32 grads."""

    def __init__(self, schedule: Callable[[int], float],
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 mask: Optional[Callable[[Sequence[str]], bool]] = None):
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.decoupled = decoupled
        self.weight_decay = weight_decay if decoupled else 0.0
        self.mask = mask
        self.count = 0
        self.last_lr = float(schedule(0))
        # optax's stored hyperparams (float32), carried into checkpoints
        self.hyperparams = {"b1": np.float32(self.b1),
                            "b2": np.float32(self.b2),
                            "eps": np.float32(eps),
                            "eps_root": np.float32(0.0),
                            "learning_rate": np.float32(self.last_lr)}
        if decoupled:
            self.hyperparams["weight_decay"] = np.float32(weight_decay)
        self.params: List[torch.Tensor] = []
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        self.decay: List[bool] = []

    def init(self, params: List[torch.Tensor],
             paths: List[Sequence[str]]) -> None:
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.decay = [self.mask is None or self.mask(s) for s in paths]

    def _pieces(self, grads: List[torch.Tensor]) -> List[tuple]:
        """``(param, grad, mu, nu, decay)`` a leaf; a leaf of more than
        ``_CHUNK_ELEMS`` elements whose four tensors are contiguous comes
        as flat views of at most that many (the update is elementwise: the
        cut changes no bit)."""
        out = []
        for *leaf, dec in zip(self.params, grads, self.mu, self.nu,
                              self.decay):
            if leaf[0].numel() > _CHUNK_ELEMS and \
                    all(x.is_contiguous() for x in leaf):
                out += [(*views, dec) for views in zip(
                    *(x.view(-1).split(_CHUNK_ELEMS) for x in leaf))]
            else:
                out.append((*leaf, dec))
        return out

    @staticmethod
    def _chunks(pieces: List[tuple]):
        start, elems = 0, 0
        for i, piece in enumerate(pieces):
            if elems and elems + piece[0].numel() > _CHUNK_ELEMS:
                yield pieces[start:i]
                start, elems = i, 0
            elems += piece[0].numel()
        if start < len(pieces):
            yield pieces[start:]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = float(self.schedule(self.count))
        t = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for chunk in self._chunks(self._pieces(grads)):
            p, g, mu, nu, decay = (list(x) for x in zip(*chunk))
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            del denom
            if self.weight_decay:
                keep = [i for i, d in enumerate(decay) if d]
                if keep:
                    torch._foreach_add_([upd[i] for i in keep],
                                        [p[i] for i in keep],
                                        alpha=self.weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr)
        self.count = t
        self.last_lr = lr
        self.hyperparams["learning_rate"] = np.float32(lr)

    def state_tree(self, layout: Callable[[List[Any]], Any],
                   clip: bool) -> Dict[str, Any]:
        """The state in the JAX package's optax layout (module docstring).
        ``layout`` turns a list parallel to the params (the moments) into
        the JAX package's params tree; ``clip``: gradient clipping is on."""
        count = np.int32(self.count)
        inject = {"count": count,
                  "hyperparams": dict(self.hyperparams),
                  "hyperparams_states": {"learning_rate": {"count": count}},
                  "inner_state": {"0": {"count": count,
                                        "mu": layout(self.mu),
                                        "nu": layout(self.nu)}}}
        return {"1": inject} if clip else inject

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any],
                        unlayout: Callable[[Any], List[Any]],
                        clip: bool) -> None:
        """Restore from :meth:`state_tree`'s layout (leaves tensors or
        numpy): the moments are copied into the existing tensors;
        ``unlayout`` is ``layout``'s inverse."""
        inject = tree["1"] if clip else tree
        self.count = int(inject["count"])
        self.hyperparams = {k: np.float32(float(v)) for k, v in
                            inject["hyperparams"].items()}
        self.last_lr = float(self.hyperparams["learning_rate"])
        adam = inject["inner_state"]["0"]
        for dst, src in ((self.mu, adam["mu"]), (self.nu, adam["nu"])):
            for d, x in zip(dst, unlayout(src)):
                d.copy_(x if isinstance(x, torch.Tensor)
                        else torch.from_numpy(np.array(x)))


def build_optimizer(opt_type: str, params: Dict[str, Any],
                    lr_schedule: Optional[Callable[[int], float]] = None
                    ) -> Adam:
    """Config ``optimizer.type`` + ``params`` -> an optimizer (reference
    ``engine._configure_basic_optimizer``)."""
    t = opt_type.lower().replace("_", "")
    lr, betas, eps, wd = _common(params)
    schedule = lr_schedule if lr_schedule is not None else (lambda _: lr)
    if t in NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet (only the Adam family "
            f"{ADAM_FAMILY}): ROADMAP.md, queue A.3.6 (optimizers beyond Adam)")
    if t not in ADAM_FAMILY:
        raise ValueError(f"unknown optimizer type {opt_type!r}")
    decoupled = t == "adamw" or bool(params.get("adam_w_mode",
                                                params.get("adamw_mode", True)))
    return Adam(schedule, betas=betas, eps=eps, weight_decay=wd,
                decoupled=decoupled,
                mask=decay_mask(params.get("no_decay_patterns")))


def current_lr(optimizer: Adam) -> float:
    """The learning rate the last update used (the schedule at step 0
    before any update)."""
    return optimizer.last_lr
