"""1-bit Adam, 0/1 Adam and 1-bit LAMB.

Port of ``deepspeedsyclsupport_tpu/runtime/onebit.py`` (reference
``runtime/fp16/onebit/{adam,zoadam,lamb}.py``). 1-bit Adam (Tang et al.)
runs vanilla Adam for ``freeze_step`` warmup steps, then freezes the
variance and passes the momentum through the 1-bit compression operator
with error feedback (``comm/quantized.sign_compress``: sign and one scale,
``mean(|x|)``, per leaf; zero maps to +1).

In the engine the gradients are reduced before the update, so, as in the
JAX package, the compression is applied to the momentum LOCALLY (the
reference's server-side math; unbiased over steps through the residual).
A leaf the port holds in pieces (the layers of a stacked ``[L, ...]``
leaf, or shards across ranks) is compressed with the scale of the WHOLE
leaf, and 1-bit LAMB's norms, maxima and scales are the whole leaf's
(``optimizers.LeafStats``), so a split run computes the world-1 update.

The wire form of the operator, for manual data-parallel loops, is
``comm/quantized.compressed_allreduce`` (int8 signs and a float32 scale a
rank, averaged, the residual fed back), as in the JAX package.

The checkpoint layout is the JAX package's: ``onebitadam`` under
``inject_hyperparams`` (``learning_rate`` alone) around its chain
(``0``: ``count``, ``mu``, ``nu``, ``error``); ``zerooneadam`` and
``onebitlamb`` are not injected, so their own states are the top level
(:class:`ZeroOneAdam`, :class:`OneBitLamb`).
"""
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..comm.quantized import sign_compress
from .optimizers import _Optimizer


class _OneBit(_Optimizer):
    """The 1-bit family's shared compression (JAX ``_compress``)."""

    def _compress(self, xs: List[torch.Tensor], errs: List[torch.Tensor]):
        """``[(scale * sign, residual)]`` of each ``x + e``, the scale its
        whole leaf's ``mean(|x + e|)``."""
        corrected = [x + e for x, e in zip(xs, errs)]
        st = self.stats
        scale = st.sum([c.abs().sum() for c in corrected]) / \
            st.size(corrected[0].device)
        out = []
        for c, s in zip(corrected, st.of(scale)):
            sign, _, residual = sign_compress(c, s)
            out.append((s * sign.to(torch.float32), residual))
        return out


class OneBitAdam(_OneBit):
    """1-bit Adam (JAX ``onebit_adam`` / ``scale_by_onebit_adam``)."""

    def __init__(self, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 freeze_step: int = 100, weight_decay: float = 0.0):
        self.b1, self.b2 = betas
        self.eps = eps
        self.freeze_step = int(freeze_step)
        self.weight_decay = weight_decay
        # static_args in the JAX package: only the rate is a hyperparam
        super().__init__(schedule, {})

    def _init_state(self) -> None:
        self.mu, self.nu, self.error = (self._zeros(), self._zeros(),
                                        self._zeros())

    def _update(self, grads, lr):
        b1, b2 = self.b1, self.b2
        t = self.count + 1
        warm = t <= self.freeze_step
        # the variance moves in warmup only
        for mu, nu, g in zip(self.mu, self.nu, grads):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            if warm:
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        if not warm:
            # the momentum RECURSION carries the compressed value (1-bit
            # Adam Alg. 1): the residual lives in `error`; carrying the raw
            # momentum would count it twice. Warmup keeps the residual 0.
            for mu, err, (comp, res) in zip(
                    self.mu, self.error, self._compress(self.mu,
                                                        self.error)):
                mu.copy_(comp)
                err.copy_(res)
        # in float32, as the JAX package computes them: past the freeze the
        # compressed momentum over a frozen (small) variance magnifies the
        # corrections' rounding, so their float64 values would not do
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(t))
        # the variance froze at freeze_step, and so does its correction
        bc2 = float(f32(1) - f32(b2) ** f32(min(t, self.freeze_step)))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)

    def _inner_tree(self, layout):
        return {"0": {"count": np.int32(self.count), "mu": layout(self.mu),
                      "nu": layout(self.nu), "error": layout(self.error)}}

    def _load_inner(self, tree, unlayout):
        s = tree["0"]
        for name in ("mu", "nu", "error"):
            self._copy_into(getattr(self, name), unlayout(s[name]))


class OneBitLamb(_OneBit):
    """1-bit LAMB (JAX ``onebit_lamb``): warmup runs LAMB on dense grads
    and keeps an EMA of the clipped trust ratio per leaf; at the freeze step
    the variance freezes and each leaf's ``scaling_coeff`` (the mean of
    the leaves' momentum scales over its own) is taken; after it the
    momentum moves on local grads through the compression, a fresh
    variance tracks the reconstructed grads, and the trust ratio is the
    frozen EMA times a rate-limited ``factor``. Consumes the rate itself."""

    injected = False

    def __init__(self, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 freeze_step: int = 100, weight_decay: float = 0.0,
                 max_coeff: float = 10.0, min_coeff: float = 0.01,
                 coeff_beta: float = 0.9, factor_max: float = 4.0,
                 factor_min: float = 0.5, factor_threshold: float = 0.1):
        self.b1, self.b2 = betas
        self.eps = eps
        self.freeze_step = int(freeze_step)
        self.weight_decay = weight_decay
        self.max_coeff, self.min_coeff = max_coeff, min_coeff
        self.coeff_beta = coeff_beta
        self.factor_max, self.factor_min = factor_max, factor_min
        self.factor_threshold = factor_threshold
        super().__init__(schedule, {})

    def _init_state(self) -> None:
        self.mu, self.nu, self.nu_fresh, self.error = (
            self._zeros(), self._zeros(), self._zeros(), self._zeros())
        dev = self.params[0].device if self.params else "cpu"
        n = self.stats.n
        # per-leaf scalars
        self.scaling_coeff = torch.ones(n, device=dev)
        self.lamb_coeff_freeze = torch.zeros(n, device=dev)
        self.last_factor = torch.ones(n, device=dev)

    def _norm(self, xs) -> torch.Tensor:
        return self.stats.sum([torch.square(x).sum() for x in xs]).sqrt()

    def _update(self, grads, lr):
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        st = self.stats
        t = self.count + 1
        if t <= self.freeze_step:
            upds = []
            for p, mu, nu, g in zip(self.params, self.mu, self.nu, grads):
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                u = mu / (nu.sqrt() + eps)
                if wd > 0.0:
                    u.add_(p, alpha=wd)
                upds.append(u)
            w_norm, u_norm = self._norm(self.params), self._norm(upds)
            coeff = (w_norm / u_norm.clamp_min(1e-12)).clamp(
                self.min_coeff, self.max_coeff)
            coeff = torch.where((w_norm > 0) & (u_norm > 0), coeff,
                                torch.ones_like(coeff))
            ema = self.lamb_coeff_freeze
            self.lamb_coeff_freeze = torch.where(
                coeff != 1.0, self.coeff_beta * ema
                + (1 - self.coeff_beta) * coeff, ema)
            for p, u, c in zip(self.params, upds, st.of(coeff)):
                p.add_(u.mul_(-lr * c))
            if t == self.freeze_step:
                # the scaling coefficient is taken at the freeze step, and
                # the fresh variance starts from the frozen one
                scales = self._norm(self.mu) / st.size(
                    self.scaling_coeff.device).sqrt()
                united = scales.sum() / st.n
                self.scaling_coeff = united / scales.clamp_min(1e-12)
                for fresh, nu in zip(self.nu_fresh, self.nu):
                    fresh.copy_(nu)
            return
        sc = st.of(self.scaling_coeff)
        m_local = [(m * b1 + g * (1.0 - b1)) * s
                   for m, g, s in zip(self.mu, grads, sc)]
        comp = self._compress(m_local, self.error)
        del m_local
        upds, prelims, ratios = [], [], []
        for i, (p, (m_synced, res), s) in enumerate(zip(self.params, comp,
                                                        sc)):
            m_eff = m_synced / s
            recon = (m_eff - b1 * self.mu[i]) / (1.0 - b1)
            fresh = self.nu_fresh[i]
            fresh.mul_(b2).addcmul_(recon, recon, value=1.0 - b2)
            denom = self.nu[i].sqrt() + eps
            denom_real = fresh.sqrt() + eps
            prelim = m_eff / denom
            upd = prelim + wd * p if wd > 0.0 else prelim
            ratios.append((denom / denom_real).max())
            prelims.append(prelim)
            upds.append(upd)
            self.mu[i].copy_(m_eff)
            self.error[i].copy_(res)
        factor = st.max(ratios).clamp(self.factor_min, self.factor_max)
        if wd > 0.0:
            ratio = torch.minimum(
                torch.ones_like(factor), self._norm(prelims)
                / self._norm(upds).clamp_min(1e-12))
            factor = factor * ratio + (1.0 - ratio)
        last = self.last_factor
        factor = torch.minimum(torch.maximum(
            factor, last * (1.0 - self.factor_threshold)),
            last * (1.0 + self.factor_threshold))
        coeff = self.lamb_coeff_freeze * factor
        for p, u, c in zip(self.params, upds, st.of(coeff)):
            p.add_(u.mul_(-lr * c))
        self.last_factor = factor

    def _per_leaf(self, layout, vec: torch.Tensor):
        return layout(self.stats.of(vec), per_leaf=True)

    def _inner_tree(self, layout):
        return {"count": np.int32(self.count), "mu": layout(self.mu),
                "nu": layout(self.nu), "nu_fresh": layout(self.nu_fresh),
                "error": layout(self.error),
                "scaling_coeff": self._per_leaf(layout, self.scaling_coeff),
                "lamb_coeff_freeze": self._per_leaf(layout,
                                                    self.lamb_coeff_freeze),
                "last_factor": self._per_leaf(layout, self.last_factor)}

    def _load_inner(self, tree, unlayout):
        self.count = int(tree["count"])
        for name in ("mu", "nu", "nu_fresh", "error"):
            self._copy_into(getattr(self, name), unlayout(tree[name]))
        first = self.stats.first()
        for name in ("scaling_coeff", "lamb_coeff_freeze", "last_factor"):
            vals = unlayout(tree[name], per_leaf=True)
            vec = getattr(self, name)
            for j, i in enumerate(first):
                vec[j] = _scalar(vals[i])


def _scalar(x) -> float:
    return float(x.item() if isinstance(x, torch.Tensor) else np.asarray(x))


class ZeroOneAdam(_OneBit):
    """0/1 Adam (JAX ``zero_one_adam``): variance updates on an
    exponentially growing interval (doubling every ``var_update_scaler``
    updates) until ``var_freeze_step``; the steps between them move the
    momentum on 1-bit gradients; after the freeze the parameters advance on
    local momentum while ``comm_buffer`` collects the deltas, and every
    ``local_interval`` steps (doubling every ``local_step_scaler``, at most
    ``local_step_clipper``) the accumulated trajectory is re-synchronized
    through the compression and the momentum rebuilt from it. Consumes the
    rate itself."""

    injected = False

    def __init__(self, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 var_freeze_step: int = 100000, var_update_scaler: int = 16,
                 local_step_scaler: int = 32678, local_step_clipper: int = 16,
                 weight_decay: float = 0.0):
        self.b1, self.b2 = betas
        self.eps = eps
        self.var_freeze_step = int(var_freeze_step)
        self.var_update_scaler = int(var_update_scaler)
        self.local_step_scaler = int(local_step_scaler)
        self.local_step_clipper = int(local_step_clipper)
        self.weight_decay = weight_decay
        super().__init__(schedule, {})

    def _init_state(self) -> None:
        self.mu, self.nu, self.error, self.comm_buffer = (
            self._zeros(), self._zeros(), self._zeros(), self._zeros())
        self.lrs = np.float32(0.0)
        self.var_interval, self.var_counter = 1, 0
        self.local_interval, self.local_counter = 1, 0

    def _update(self, grads, lr):
        b1, b2, eps = self.b1, self.b2, self.eps
        t = self.count + 1
        frozen = t > self.var_freeze_step
        var_step = not frozen and t % self.var_interval == 0
        sync_step = frozen and t % self.local_interval == 0
        if t == self.var_freeze_step + 1:
            # the error buffer switches metrics at the freeze (grads ->
            # accumulated deltas): start it again (zoadam
            # reinitial_error_buffer)
            for e in self.error:
                e.zero_()
        if var_step:
            g_eff = grads
            for nu, g in zip(self.nu, g_eff):
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        elif frozen:
            g_eff = grads
        else:
            comp = self._compress(grads, self.error)
            g_eff = [c for c, _ in comp]
            for e, (_, res) in zip(self.error, comp):
                e.copy_(res)
        for mu, g in zip(self.mu, g_eff):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
        deltas = []
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            d = mu / (nu.sqrt() + eps)
            d.add_(p, alpha=self.weight_decay).mul_(-lr)
            deltas.append(d)
        if frozen:
            for b, d in zip(self.comm_buffer, deltas):
                b.add_(d)
            self.lrs = np.float32(self.lrs + np.float32(lr))
        if sync_step:
            denoms = [nu.sqrt() + eps for nu in self.nu]
            comp = self._compress([b * dn for b, dn in
                                   zip(self.comm_buffer, denoms)],
                                  self.error)
            lrs = max(self.lrs, np.float32(1e-12))
            for i, ((synced, res), dn) in enumerate(zip(comp, denoms)):
                deltas[i] = deltas[i] - self.comm_buffer[i] + synced / dn
                self.mu[i].copy_(-synced / float(lrs))
                self.comm_buffer[i].zero_()
                self.error[i].copy_(res)
            self.lrs = np.float32(0.0)
        for p, d in zip(self.params, deltas):
            p.add_(d)
        # interval bookkeeping (zoadam.py:265-286)
        if var_step:
            self.var_counter += 1
        if self.var_counter == self.var_update_scaler:
            self.var_interval *= 2
            self.var_counter = 0
        if frozen:
            self.local_counter += 1
        if self.local_counter == self.local_step_scaler:
            self.local_interval = min(self.local_step_clipper,
                                      self.local_interval * 2)
            self.local_counter = 0

    def _inner_tree(self, layout):
        i32 = np.int32
        return {"count": i32(self.count), "mu": layout(self.mu),
                "nu": layout(self.nu), "error": layout(self.error),
                "comm_buffer": layout(self.comm_buffer),
                "lrs": np.float32(self.lrs),
                "var_interval": i32(self.var_interval),
                "var_counter": i32(self.var_counter),
                "local_interval": i32(self.local_interval),
                "local_counter": i32(self.local_counter)}

    def _load_inner(self, tree, unlayout):
        self.count = int(tree["count"])
        for name in ("mu", "nu", "error", "comm_buffer"):
            self._copy_into(getattr(self, name), unlayout(tree[name]))
        self.lrs = np.float32(_scalar(tree["lrs"]))
        for name in ("var_interval", "var_counter", "local_interval",
                     "local_counter"):
            setattr(self, name, int(_scalar(tree[name])))


def build(t: str, params: Dict[str, Any], schedule: Callable[[int], float],
          betas, eps: float, wd: float) -> _Optimizer:
    """``onebitadam`` / ``zerooneadam`` / ``onebitlamb`` with the JAX
    ``build_optimizer``'s keys and defaults."""
    if t == "onebitadam":
        return OneBitAdam(schedule, betas=betas, eps=eps,
                          freeze_step=int(params.get("freeze_step", 100)),
                          weight_decay=wd)
    if t == "zerooneadam":
        return ZeroOneAdam(
            schedule, betas=betas, eps=eps,
            var_freeze_step=int(params.get("var_freeze_step", 100000)),
            var_update_scaler=int(params.get("var_update_scaler", 16)),
            local_step_scaler=int(params.get("local_step_scaler", 32678)),
            local_step_clipper=int(params.get("local_step_clipper", 16)),
            weight_decay=wd)
    return OneBitLamb(
        schedule, betas=betas, eps=eps,
        freeze_step=int(params.get("freeze_step", 100)), weight_decay=wd,
        max_coeff=float(params.get("max_coeff", 10.0)),
        min_coeff=float(params.get("min_coeff", 0.01)),
        coeff_beta=float(params.get("coeff_beta", 0.9)),
        factor_max=float(params.get("factor_max", 4.0)),
        factor_min=float(params.get("factor_min", 0.5)),
        factor_threshold=float(params.get("factor_threshold", 0.1)))
