"""Optimizers on float32 master tensors.

Port of ``deepspeedsyclsupport_tpu/runtime/optimizers.py``
(``build_optimizer``: config ``optimizer.type`` + ``params``): ``adam``,
``adamw``, ``fusedadam`` and ``cpuadam`` (:class:`Adam`; ``adam_w_mode``
True, the default, is AdamW; False is classic Adam without weight decay),
``lamb`` / ``fusedlamb`` (:class:`Lamb`), ``lion`` / ``fusedlion``
(:class:`Lion`), ``sgd`` (:class:`SGD`, the config's ``momentum`` as a
trace), ``adagrad`` (:class:`Adagrad`) and the 1-bit family
(``runtime/onebit.py``: ``onebitadam``, ``zerooneadam``, ``onebitlamb``).
The JAX package runs optax under ``inject_hyperparams``; each class here
follows its optax chain's algebra over the master tensors, updated in
place, with ``lr = schedule(count)`` read BEFORE the count is incremented,
as ``inject_hyperparams`` does; :attr:`_Optimizer.last_lr` is what
``current_lr`` reports (the reference's ``param_groups[0]['lr']``):

* Adam: ``mu = b1·mu + (1−b1)·g``, ``nu = b2·nu + (1−b2)·g²``, bias
  correction at step ``t = count + 1``: ``u = (mu/(1−b1^t)) /
  (sqrt(nu/(1−b2^t)) + eps)``; decoupled decay ``u += wd·p`` on the leaves
  the mask keeps; ``p -= lr·u``;
* Lamb (``optax.lamb``: ``scale_by_adam`` -> decayed weights ->
  ``scale_by_trust_ratio``): Adam's ``u`` plus decay, times the leaf's
  ``‖p‖ / ‖u‖`` (1 where either norm is 0);
* Lion (``optax.lion``): ``u = sign((1−b1)·g + b1·mu)``, then ``mu =
  (1−b2)·g + b2·mu``, plus decay;
* SGD (``optax.sgd``): ``trace = g + momentum·trace``, ``u = trace``;
* Adagrad (``optax.adagrad``): ``s = g² + s`` from
  ``initial_accumulator_value`` 0.1, ``u = g·rsqrt(s + eps)`` where ``s >
  0``, else 0.

A statistic over a whole leaf (Lamb's norms, the 1-bit family's scales) is
over the JAX package's leaf, which the port may hold in pieces: a stacked
``[L, ...]`` layer leaf is a list of per-layer tensors, and across ranks a
tensor is a shard. :class:`LeafStats` says which tensors make up which
leaf and sums (or maxes) per-piece partials over them and over the ranks
that split them; by default every tensor is a leaf of its own.

The state is checkpointed in the JAX package's optax layout, leaf for leaf
(:meth:`_Optimizer.state_tree`): ``inject_hyperparams``' ``count``,
``hyperparams`` (optax's names, float32) and the schedule's ``count``,
then the chain's states under their indices (Adam / Lamb ``0``: ``count``,
``mu``, ``nu``; Lion ``0``: ``count``, ``mu``; SGD ``0``: ``trace``;
Adagrad ``0``: ``sum_of_squares``; counts int32), all under ``1/`` when
gradient clipping puts ``clip_by_global_norm``'s empty state at index 0
of a chain. The stored ``learning_rate`` is the float32 value of the last
update's rate (the schedule at step 0 before one), as optax carries it; a
loaded value is carried as it was read. The config's betas and eps drive
the arithmetic; the stored ones are carried for the format.

The reference's fused Adam / Lamb / Lion are not TPU kernels
(``optimizers.py:10-13``: a jitted optax update is the fused multi-tensor
kernel there), so none is written here: the updates are PyTorch's
elementwise and ``foreach`` kernels.
"""
import fnmatch
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

ADAM_FAMILY = ("adam", "adamw", "fusedadam", "cpuadam")
LAMB_FAMILY = ("lamb", "fusedlamb")
LION_FAMILY = ("lion", "fusedlion")
ONEBIT_FAMILY = ("onebitadam", "zerooneadam", "onebitlamb")
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


class LeafStats:
    """The JAX package's leaves as the optimizer's tensors make them up.

    ``group[i]``: the leaf tensor ``i`` is a piece of; ``sizes[j]``: leaf
    ``j``'s element count; ``owner[i]``: whether tensor ``i``'s partial is
    counted (False on a rank that holds a replica of a piece another rank
    counts); ``reduce(vector, op)``: ``op`` (``"sum"`` or ``"max"``) over
    the ranks, or None on one rank."""

    def __init__(self, group: Sequence[int], sizes: Sequence[int],
                 owner: Optional[Sequence[bool]] = None,
                 reduce: Optional[Callable[[torch.Tensor, str],
                                           torch.Tensor]] = None):
        self.group = list(group)
        self.sizes = [int(s) for s in sizes]
        self.owner = None if owner is None else list(owner)
        self.reduce = reduce
        self._idx: Dict[torch.device, tuple] = {}

    @classmethod
    def single(cls, tensors: Sequence[torch.Tensor]) -> "LeafStats":
        """Every tensor a whole leaf, on one rank."""
        return cls(range(len(tensors)), [t.numel() for t in tensors])

    @property
    def n(self) -> int:
        return len(self.sizes)

    def _index(self, device):
        if device not in self._idx:
            own = self.owner or [True] * len(self.group)
            self._idx[device] = (
                torch.tensor(self.group, dtype=torch.long, device=device),
                torch.tensor(own, dtype=torch.float32, device=device),
                torch.tensor(self.sizes, dtype=torch.float32, device=device))
        return self._idx[device]

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """``[n]`` float32: each leaf's sum of its pieces' partials (0-d,
        one a tensor)."""
        v = torch.stack([p.float() for p in parts])
        idx, own, _ = self._index(v.device)
        out = torch.zeros(self.n, dtype=torch.float32,
                          device=v.device).index_add_(0, idx, v * own)
        return self.reduce(out, "sum") if self.reduce else out

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """``[n]`` float32: each leaf's largest partial."""
        v = torch.stack([p.float() for p in parts])
        idx, _, _ = self._index(v.device)
        out = torch.full((self.n,), -float("inf"), dtype=torch.float32,
                         device=v.device).scatter_reduce_(
            0, idx, v, "amax", include_self=True)
        return self.reduce(out, "max") if self.reduce else out

    def size(self, device) -> torch.Tensor:
        """``[n]`` float32: the leaves' element counts."""
        return self._index(device)[2]

    def of(self, per_leaf: torch.Tensor) -> List[torch.Tensor]:
        """A per-leaf vector as one 0-d value a tensor."""
        return [per_leaf[j] for j in self.group]

    def first(self) -> List[int]:
        """The first tensor of each leaf."""
        out = [-1] * self.n
        for i, j in enumerate(self.group):
            if out[j] < 0:
                out[j] = i
        return out


def _sq(t: torch.Tensor) -> torch.Tensor:
    return torch.square(t).sum()


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(like.device, like.dtype)


class _Optimizer:
    """What every optimizer here shares: the schedule and host count, the
    decay mask, :meth:`init` / :meth:`step`, and the optax state layout
    (``inject_hyperparams`` around ``_inner_tree`` when ``injected``).
    Subclasses define ``_init_state``, ``_update(grads, lr)``,
    ``_inner_tree(layout)`` and ``_load_inner(tree, unlayout)``."""

    injected = True

    def __init__(self, schedule: Callable[[int], float],
                 hyperparams: Dict[str, float],
                 mask: Optional[Callable[[Sequence[str]], bool]] = None):
        self.schedule = schedule
        self.mask = mask
        self.count = 0
        self.last_lr = float(schedule(0))
        # optax's stored hyperparams (float32), carried into checkpoints
        self.hyperparams = {k: np.float32(v) for k, v in hyperparams.items()}
        self.hyperparams["learning_rate"] = np.float32(self.last_lr)
        self.params: List[torch.Tensor] = []
        self.decay: List[bool] = []
        self.stats: Optional[LeafStats] = None

    def init(self, params: List[torch.Tensor], paths: List[Sequence[str]],
             stats: Optional[LeafStats] = None) -> None:
        self.params = list(params)
        self.decay = [self.mask is None or self.mask(s) for s in paths]
        self.stats = stats or LeafStats.single(self.params)
        self._init_state()

    def _init_state(self) -> None:
        raise NotImplementedError

    def _update(self, grads: List[torch.Tensor], lr: float) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = float(self.schedule(self.count))
        self._update(grads, lr)
        self.count += 1
        self.last_lr = lr
        self.hyperparams["learning_rate"] = np.float32(lr)

    def _zeros(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) for p in self.params]

    def _inner_tree(self, layout) -> Dict[str, Any]:
        raise NotImplementedError

    def _load_inner(self, tree, unlayout) -> None:
        raise NotImplementedError

    def state_tree(self, layout: Callable[..., Any],
                   clip: bool) -> Dict[str, Any]:
        """The state in the JAX package's optax layout (module docstring).
        ``layout(values)`` turns a list parallel to the params (the
        moments) into the JAX package's params tree, ``layout(values,
        per_leaf=True)`` a list of per-leaf scalars (each tensor carrying
        its leaf's); ``clip``: gradient clipping is on."""
        inner = self._inner_tree(layout)
        if self.injected:
            count = np.int32(self.count)
            inner = {"count": count,
                     "hyperparams": dict(self.hyperparams),
                     "hyperparams_states": {"learning_rate": {
                         "count": count}},
                     "inner_state": inner}
        return {"1": inner} if clip else inner

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any],
                        unlayout: Callable[..., List[Any]],
                        clip: bool) -> None:
        """Restore from :meth:`state_tree`'s layout (leaves tensors or
        numpy), copying into the existing tensors; ``unlayout`` is
        ``layout``'s inverse."""
        tree = tree["1"] if clip else tree
        if self.injected:
            self.count = int(tree["count"])
            self.hyperparams = {k: np.float32(float(v)) for k, v in
                                tree["hyperparams"].items()}
            self.last_lr = float(self.hyperparams["learning_rate"])
            tree = tree["inner_state"]
        self._load_inner(tree, unlayout)

    @staticmethod
    def _copy_into(dst: List[torch.Tensor], src: List[Any]) -> None:
        for d, x in zip(dst, src):
            d.copy_(_as_tensor(x, d))


class Adam(_Optimizer):
    """Adam/AdamW over a list of float32 master tensors (see the module
    docstring). :meth:`init` takes the leaves and their path segments;
    :meth:`step` updates the leaves in place from float32 grads, in
    ``foreach`` chunks."""

    def __init__(self, schedule: Callable[[int], float],
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 mask: Optional[Callable[[Sequence[str]], bool]] = None):
        self.b1, self.b2 = betas
        self.eps = eps
        self.decoupled = decoupled
        self.weight_decay = weight_decay if decoupled else 0.0
        hp = {"b1": self.b1, "b2": self.b2, "eps": eps, "eps_root": 0.0}
        if decoupled:
            hp["weight_decay"] = weight_decay
        super().__init__(schedule, hp, mask)
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def _init_state(self) -> None:
        self.mu, self.nu = self._zeros(), self._zeros()

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

    def _update(self, grads: List[torch.Tensor], lr: float) -> None:
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

    def _inner_tree(self, layout) -> Dict[str, Any]:
        return {"0": {"count": np.int32(self.count), "mu": layout(self.mu),
                      "nu": layout(self.nu)}}

    def _load_inner(self, tree, unlayout) -> None:
        adam = tree["0"]
        self._copy_into(self.mu, unlayout(adam["mu"]))
        self._copy_into(self.nu, unlayout(adam["nu"]))


class Lamb(Adam):
    """``optax.lamb`` (module docstring): Adam's direction with decoupled
    decay, scaled per leaf by the trust ratio ``‖p‖ / ‖u‖``, the norms over
    the whole leaf (:class:`LeafStats`)."""

    def __init__(self, schedule, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0, mask=None):
        super().__init__(schedule, betas=betas, eps=eps,
                         weight_decay=weight_decay, decoupled=True, mask=mask)

    def _update(self, grads: List[torch.Tensor], lr: float) -> None:
        t = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        upds = []
        for p, g, mu, nu, dec in zip(self.params, grads, self.mu, self.nu,
                                     self.decay):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if self.weight_decay and dec:
                u.add_(p, alpha=self.weight_decay)
            upds.append(u)
        pn = self.stats.sum([_sq(p) for p in self.params]).sqrt()
        un = self.stats.sum([_sq(u) for u in upds]).sqrt()
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                            pn / un)
        for p, u, r in zip(self.params, upds, self.stats.of(ratio)):
            p.add_(u.mul_(r), alpha=-lr)


class Lion(_Optimizer):
    """``optax.lion`` (module docstring)."""

    def __init__(self, schedule, betas=(0.9, 0.99),
                 weight_decay: float = 0.0, mask=None):
        self.b1, self.b2 = betas
        self.weight_decay = weight_decay
        super().__init__(schedule, {"b1": self.b1, "b2": self.b2,
                                    "weight_decay": weight_decay}, mask)

    def _init_state(self) -> None:
        self.mu = self._zeros()

    def _update(self, grads, lr):
        for p, g, mu, dec in zip(self.params, grads, self.mu, self.decay):
            u = torch.sign(g * (1.0 - self.b1) + mu * self.b1)
            mu.mul_(self.b2).add_(g, alpha=1.0 - self.b2)
            if self.weight_decay and dec:
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)

    def _inner_tree(self, layout):
        return {"0": {"count": np.int32(self.count), "mu": layout(self.mu)}}

    def _load_inner(self, tree, unlayout):
        self._copy_into(self.mu, unlayout(tree["0"]["mu"]))


class SGD(_Optimizer):
    """``optax.sgd`` with the config's ``momentum`` (module docstring)."""

    def __init__(self, schedule, momentum: float = 0.0):
        self.momentum = momentum
        super().__init__(schedule, {"momentum": momentum})

    def _init_state(self) -> None:
        self.trace = self._zeros()

    def _update(self, grads, lr):
        for p, g, tr in zip(self.params, grads, self.trace):
            tr.mul_(self.momentum).add_(g)
            p.add_(tr, alpha=-lr)

    def _inner_tree(self, layout):
        return {"0": {"trace": layout(self.trace)}}

    def _load_inner(self, tree, unlayout):
        self._copy_into(self.trace, unlayout(tree["0"]["trace"]))


class Adagrad(_Optimizer):
    """``optax.adagrad`` (module docstring)."""

    def __init__(self, schedule, eps: float = 1e-7,
                 initial_accumulator_value: float = 0.1):
        self.eps = eps
        self.initial = initial_accumulator_value
        super().__init__(schedule, {
            "eps": eps, "initial_accumulator_value": self.initial})

    def _init_state(self) -> None:
        self.sum_of_squares = [torch.full_like(p, self.initial)
                               for p in self.params]

    def _update(self, grads, lr):
        for p, g, s in zip(self.params, grads, self.sum_of_squares):
            s.addcmul_(g, g)
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                              torch.zeros_like(s))
            p.add_(inv.mul_(g), alpha=-lr)

    def _inner_tree(self, layout):
        return {"0": {"sum_of_squares": layout(self.sum_of_squares)}}

    def _load_inner(self, tree, unlayout):
        self._copy_into(self.sum_of_squares,
                        unlayout(tree["0"]["sum_of_squares"]))


def build_optimizer(opt_type: str, params: Dict[str, Any],
                    lr_schedule: Optional[Callable[[int], float]] = None
                    ) -> _Optimizer:
    """Config ``optimizer.type`` + ``params`` -> an optimizer (reference
    ``engine._configure_basic_optimizer``; the JAX ``build_optimizer``'s
    names, defaults and refusals)."""
    t = opt_type.lower().replace("_", "")
    lr, betas, eps, wd = _common(params)
    schedule = lr_schedule if lr_schedule is not None else (lambda _: lr)
    mask = decay_mask(params.get("no_decay_patterns"))
    if t in ONEBIT_FAMILY:
        from . import onebit

        if mask is not None:
            # the 1-bit family applies decay inside its fused update;
            # silently decaying excluded params would diverge from the same
            # config under AdamW
            raise ValueError(
                f"no_decay_patterns is not supported with {opt_type!r} "
                f"(the 1-bit optimizers decay every leaf); drop the patterns "
                f"or use AdamW/Lamb/Lion")
        return onebit.build(t, params, schedule, betas, eps, wd)
    if t in ADAM_FAMILY:
        decoupled = t == "adamw" or bool(params.get(
            "adam_w_mode", params.get("adamw_mode", True)))
        return Adam(schedule, betas=betas, eps=eps, weight_decay=wd,
                    decoupled=decoupled, mask=mask)
    if t in LAMB_FAMILY:
        return Lamb(schedule, betas=betas, eps=eps, weight_decay=wd,
                    mask=mask)
    if t in LION_FAMILY:
        return Lion(schedule, betas=betas, weight_decay=wd, mask=mask)
    if t == "sgd":
        return SGD(schedule, momentum=float(params.get("momentum", 0.0)))
    if t == "adagrad":
        return Adagrad(schedule, eps=eps)
    raise ValueError(f"unknown optimizer type {opt_type!r}")


def current_lr(optimizer: _Optimizer) -> float:
    """The learning rate the last update used (the schedule at step 0
    before any update)."""
    return optimizer.last_lr
