"""PyTorch port: what the CPU can check of the Hopper reducing dbias
(``flash_dbias_sm90_kernel`` + ``flash_dbias_sum_kernel`` in
``csrc/flash_attention.cu``, the bfloat16 / float16 route at D <= 128).

The kernel's arithmetic and order, emulated here in float32: the grid of
128-row by 64-key tiles; for each tile, bias entry (bb, hb) and chunk of
replicas, the replicas r of the chunk in order (batch bb * rb + r // rh,
q head hb * rh + r % rh), each adding p (dp - delta) to a float32
accumulator, with s = q.k scale (+ ALiBi) + pair bias + k-row bias where
visible and p = exp2((s - LSE) log2 e); a tile outside the keys its rows can
see stays zero; then the chunks' partial tiles added in chunk order, with
the chunk count the wrapper takes (``dbias_chunks``). It is held against
the JAX package's broadcast-bias gradient (``jax.grad`` of its Pallas
``flash_attention`` in interpret mode, whose ``_dbias_call`` reduces the
replicas) on the same numpy inputs, within 2e-5 of the largest |dbias| (the
port's float32 tolerance for biases): the two sum in other orders.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

BR, BC = 128, 64          # the kernel's q rows and keys per CTA
LOG2E = 1.4426950408889634
TOL = 2e-5


def _kv_range(mask, sq, skv, i0, i1):
    """Keys [lo, hi) rows [i0, i1) can see by index (the kernels'
    ``kv_range``): cut only under causality with the default positions."""
    lo, hi = 0, skv
    if mask.pos_q is None and mask.pos_k is None and mask.causal:
        hi = min(hi, i1 + skv - sq)
        if mask.window is not None:
            lo = max(0, i0 + skv - sq - mask.window + 1)
    return lo, hi


def emulate_dbias_sm90(q, k, v, do, lse, delta, mask, bias, chunks):
    """``flash_dbias_sm90_kernel``'s arithmetic and order in float32 (see
    the module docstring): float32 ``[Bb, Hb, Sq, Skv]``."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bb, hb = bias.shape[:2]
    rb, rh = b // bb, h // hb
    nrep = rb * rh
    scale = 1.0 / math.sqrt(d)
    pq = (torch.arange(sq) + skv - sq)[None].expand(b, -1) \
        if mask.pos_q is None else mask.pos_q.long()
    pk = torch.arange(skv)[None].expand(b, -1) \
        if mask.pos_k is None else mask.pos_k.long()
    parts = torch.zeros((chunks, bb, hb, sq, skv))
    for i0 in range(0, sq, BR):
        i1 = min(i0 + BR, sq)
        for j0 in range(0, skv, BC):
            j1 = min(j0 + BC, skv)
            lo, hi = _kv_range(mask, sq, skv, i0, i1)
            if not (j0 < hi and j0 + BC > lo):
                continue                      # a dead tile stays zero
            for e in range(bb * hb):
                eb, eh = divmod(e, hb)
                for c in range(chunks):
                    acc = torch.zeros((i1 - i0, j1 - j0))
                    for r in range(nrep * c // chunks,
                                   nrep * (c + 1) // chunks):
                        bi, hq = eb * rb + r // rh, eh * rh + r % rh
                        kh = hq // g
                        s = q[bi, i0:i1, hq] @ k[bi, j0:j1, kh].T
                        dp = do[bi, i0:i1, hq] @ v[bi, j0:j1, kh].T
                        qp, kp = pq[bi, i0:i1, None], pk[bi, None, j0:j1]
                        x = s * scale
                        if mask.alibi is not None:
                            x = x + mask.alibi[hq] * (kp - qp).float()
                        ok = torch.arange(j0, j1)[None] < hi
                        if mask.causal:
                            ok = ok & (kp <= qp)
                        if mask.window is not None:
                            ok = ok & (qp - kp < mask.window)
                        if mask.seg_q is not None:
                            ok = ok & (mask.seg_q[bi, i0:i1, None]
                                       == mask.seg_k[bi, None, j0:j1])
                        x = x + bias[eb, eh, i0:i1, j0:j1]
                        if mask.k_bias is not None:
                            x = x + mask.k_bias[
                                bi // (b // mask.k_bias.shape[0]), j0:j1]
                        x = torch.where(ok, x, torch.full_like(x, -math.inf))
                        p = torch.exp2((x - lse[bi, hq, i0:i1, None])
                                       * LOG2E)
                        acc = acc + p * (dp - delta[bi, hq, i0:i1, None])
                    parts[c, eb, eh, i0:i1, j0:j1] = acc
    out = parts[0]
    for c in range(1, chunks):                # chunk order
        out = out + parts[c]
    return out


# name -> (shape, pair bias (Bb, Hb), flash keyword arguments)
CASES = {
    # evoformer-like: N_seq 4 rows share the pair bias, 10 % masked keys
    "evoformer": (dict(b=4, s=96, h=4, kvh=4, d=32), (1, 4),
                  dict(causal=False, kbias=True)),
    # heads broadcast (Hb < H), GQA, two q tiles with a ragged edge
    "heads_broadcast_200": (dict(b=2, s=200, h=4, kvh=2, d=32), (2, 2),
                            dict(causal=False)),
    "alibi": (dict(b=2, s=96, h=4, kvh=4, d=64), (1, 4),
              dict(causal=True, alibi=True)),
    "causal_window_70": (dict(b=3, s=70, h=2, kvh=2, d=32), (1, 2),
                         dict(causal=True, window=30)),
}


def _case(name):
    shape, (bb, hb), spec = CASES[name]
    b, s, h, kvh, d = (shape[x] for x in ("b", "s", "h", "kvh", "d"))
    rng = np.random.RandomState(sorted(CASES).index(name))
    q, w = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, s, kvh, d).astype(np.float32) for _ in range(2))
    bias = rng.randn(bb, hb, s, s).astype(np.float32)
    kw = {"causal": spec["causal"]}
    if "window" in spec:
        kw["window"] = spec["window"]
    if spec.get("alibi"):
        kw["alibi"] = alibi_slopes(h)
    if spec.get("kbias"):
        kw["k_bias"] = np.where(rng.rand(b, s) < 0.1, -1e9, 0.0).astype(
            np.float32)
    return q, k, v, w, bias, kw


def _jax_dbias(q, k, v, w, bias, kw):
    jkw = {k_: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for k_, x in kw.items()}

    def loss(b_):
        return jnp.sum(jax_flash(*map(jnp.asarray, (q, k, v)), bias=b_,
                                 interpret=True, block_q=128, block_k=128,
                                 **jkw) * jnp.asarray(w))

    return torch.from_numpy(np.array(jax.grad(loss)(jnp.asarray(bias))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_dbias_sm90_matches_jax(case):
    q, k, v, w, bias, kw = _case(case)
    want = _jax_dbias(q, k, v, w, bias, kw)
    tq, tk, tv, tw, tb = map(torch.from_numpy, (q, k, v, w, bias))
    mask = tfa.make_mask(tq, tk, **{
        k_: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
        for k_, x in kw.items()})
    o, lse = tfa.flash_attention_fwd_reference(tq, tk, tv, mask, tb)
    delta = tfa.attention_delta(tw, o)
    # the chunks the wrapper cuts a bf16 call of this shape into
    chunks = tfa.dbias_chunks(tq.to(torch.bfloat16), tk, tb)
    got = emulate_dbias_sm90(tq, tk, tv, tw, lse, delta, mask, tb, chunks)
    assert got.shape == want.shape == tb.shape
    lim = TOL * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= lim, f"{case}: max abs err {err} > {lim}"
    # one chunk, the replicas all in order: the same function
    one = emulate_dbias_sm90(tq, tk, tv, tw, lse, delta, mask, tb, 1)
    assert float((one - want).abs().max()) <= lim


def test_dbias_chunks_follow_the_shapes_alone(monkeypatch):
    """The chunk count takes no SM count and asks nothing of a device: the
    same shapes give the same chunks, and with them the same order of the
    sums and the same bits, on any card."""
    assert list(inspect.signature(tfa.dbias_chunks).parameters) == [
        "q", "k", "bias"]

    def no_device(*_, **__):
        raise AssertionError("dbias_chunks asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "device_count", no_device)
    q = torch.empty((512, 384, 8, 32), dtype=torch.bfloat16)
    pair = torch.empty((1, 8, 384, 384))
    assert tfa.dbias_chunks(q, q, pair) == 8      # 144 CTAs a chunk -> 1152
    assert tfa.dbias_chunks(q.float(), q, pair) == 8   # 288 -> 2304
