"""PyTorch port: the lse-returning flash attention (``flash_attention(...,
return_lse=True)``) against the JAX package's (``_make_flash_lse``, the
Pallas kernels in interpret mode), on numpy inputs from a seed.

Both return ``(o, lse)`` differentiable; the loss is ``sum(o * dO) +
sum(lse * dLSE)`` with a random ``dLSE``, so the backward runs with
``delta - dlse`` in delta's slot. Cases: causal with GQA; a ring-attention
block (query positions 128-383 against key positions 256-511, so the first
128 query rows see no key); and a pair bias broadcast over the batch (the
reducing dbias path). Tolerances are the JAX flash tests': o and lse 2e-5,
gradients 2e-4, relative to the largest magnitude. Rows that see nothing
read lse exactly -1e30 and o exactly 0, and their q gradient is exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

TOL, GRAD_TOL = 2e-5, 2e-4
B, S, H, D = 2, 256, 4, 32


def _positions(lo):
    return np.tile(np.arange(lo, lo + S), (B, 1)).astype(np.int32)


CASES = {
    "causal_gqa": dict(kvh=2, kw=dict(causal=True)),
    "ring_block": dict(kvh=4, kw=dict(causal=True,
                                      q_positions=_positions(128),
                                      kv_positions=_positions(256)),
                       dead_rows=128),
    "pair_bias": dict(kvh=4, kw=dict(causal=False), bias=(1, H)),
}


def _inputs(case, seed=0):
    c = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k, v = (rng.randn(B, S, c["kvh"], D).astype(np.float32)
            for _ in range(2))
    do = rng.randn(B, S, H, D).astype(np.float32)
    dlse = rng.randn(B, S, H).astype(np.float32)
    bias = None
    if "bias" in c:
        bias = (0.5 * rng.randn(*c["bias"], S, S)).astype(np.float32)
    return q, k, v, do, dlse, bias


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_lse_variant_matches_jax(case):
    q, k, v, do, dlse, bias = _inputs(case)
    kw = CASES[case]["kw"]
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    args = [q, k, v] + ([bias] if bias is not None else [])

    def jf(*a):
        extra = {"bias": a[3]} if len(a) > 3 else {}
        o, lse = jax_flash(a[0], a[1], a[2], return_lse=True, interpret=True,
                           block_q=128, block_k=128, **jkw, **extra)
        return (o * do).sum() + (lse * dlse).sum(), (o, lse)

    (_, (o_want, lse_want)), g_want = jax.value_and_grad(
        jf, argnums=tuple(range(len(args))), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    if bias is not None:
        tkw["bias"] = targs[3]
    o, lse = tfa.flash_attention(*targs[:3], return_lse=True, **tkw)
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    assert _rel(o.detach().numpy(), np.asarray(o_want)) < TOL
    live = slice(CASES[case].get("dead_rows", 0), S)
    np.testing.assert_allclose(lse.detach().numpy()[:, live],
                               np.asarray(lse_want)[:, live], atol=TOL,
                               rtol=TOL)
    for name, t, g in zip("qkvb", targs, g_want):
        assert _rel(t.grad.numpy(), np.asarray(g)) < GRAD_TOL, name
    dead = CASES[case].get("dead_rows")
    if dead:
        assert (lse.detach()[:, :dead] == tfa.NEG_INF).all()
        assert (np.asarray(lse_want)[:, :dead] == tfa.NEG_INF).all()
        assert (o.detach()[:, :dead] == 0).all()
        assert (targs[0].grad[:, :dead] == 0).all()


def test_lse_variant_without_lse_cotangent_equals_plain():
    """Using only ``o`` of the lse variant gives the plain function's
    output and grads bit for bit (the lse cotangent is zero)."""
    q, k, v, do, _, _ = _inputs("causal_gqa", seed=1)
    grads = []
    for ret in (False, True):
        t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tfa.flash_attention(*t, causal=True, return_lse=ret)
        o = out[0] if ret else out
        (o * torch.from_numpy(do)).sum().backward()
        grads.append([o.detach()] + [x.grad for x in t])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
