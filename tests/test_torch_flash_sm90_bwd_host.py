"""PyTorch port: what the CPU can check of the Hopper flash-attention
backward (``flash_dq_sm90_kernel`` and ``flash_dkv_sm90_kernel`` in
``csrc/flash_attention.cu``, the bfloat16 / float16 route at D <= 128).

The kernels' numerics, emulated here tile by tile: P = exp(s - LSE) and
dS = P (dO V^T - delta) in float32 as the plain backward computes them,
then P and dS as hi + lo operands of bf16 / fp16 in the three products
(dV += P^T dO, dK += dS^T Q, dQ += dS K; the plain version keeps both in
float32, ROADMAP C2), dQ summed over key tiles of 64, dK and dV over (q
head, q tile of 64)
for each key tile of 128, and the outputs rounded to the dtype. LSE and
delta come from the float32 forward, as the JAX backward takes them (the
kernels take both as inputs; the autograd backward's delta from O in the
dtype is outside them). The emulation is
held against the JAX package's backward (``jax.vjp`` of its Pallas
``flash_attention`` in interpret mode, float32, on the same rounded
inputs) at the card tests' tolerances (``tests/test_torch_cuda.py``
``FLASH_TOL``): each gradient within 2e-2 (bf16) or 4e-3 (fp16) of its
largest magnitude and, row by row, of each row's (one token and head over
D) largest magnitude. A faulty emulation that leaves one q tile out of one
key tile's dK / dV passes the first hold and fails the second.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3}
# rows below this share of a gradient's largest magnitude are held against
# it (the card tests' ``GRAD_ROW_FLOOR``): dQ of a query that sees one key
# is exactly zero (its dS row sums to zero), and both sides' rows are then
# float32 rounding noise of different sums, ~4e-7 of the largest |dQ|
ROW_FLOOR = 1e-2
KEY_TILE, Q_TILE = 128, 64      # dK/dV: a CTA's keys, a ring tile's q rows
DQ_TILE = 64                    # dQ: a ring tile's keys


def row_relative_err(got, want):
    """The largest over rows of the row's max abs error over the row's
    largest |want|, at least ``ROW_FLOOR`` of the largest |want| (the card
    tests' ``_assert_rows_close`` with ``floor=GRAD_ROW_FLOOR``)."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    den = w.abs().amax(-1).clamp_min(
        max(1e-30, ROW_FLOOR * float(w.abs().max())))
    return float(((g - w).abs().amax(-1) / den).max())


def max_relative_err(got, want):
    """Max abs error over max(1, largest |want|) (``_assert_close_scaled``)."""
    err = float((got.float() - want.float()).abs().max())
    return err / max(1.0, float(want.float().abs().max()))


def emulate_sm90_backward(q, k, v, do, mask, r_dtype, bias=None,
                          skip=None):
    """The Hopper backward's arithmetic on the CPU: ``(dq, dk, dv)`` in q's
    dtype. ``r_dtype`` None keeps P and dS in float32 (the plain version's
    algebra); otherwise P and dS are split into hi + lo operands of
    ``r_dtype``, as the kernels multiply them. ``skip = (key_tile,
    q_tile)``: that q tile (of the first q head) left out of that key
    tile's dK and dV, as a faulty kernel would."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa.flash_attention_fwd_reference(*(t.float() for t in (q, k, v)),
                                               mask, bias)
    delta = tfa.attention_delta(do, o)
    s, vis = tfa._scores(q, k, mask, 0, sq, bias)       # [B, KVH, G, Sq, Skv]
    p = torch.where(vis, torch.exp(s - lse.reshape(b, kvh, g, sq, 1)),
                    torch.zeros_like(s))
    dof = do.float().reshape(b, sq, kvh, g, d)
    dp = torch.einsum("bqkgd,bjkd->bkgqj", dof, v.float())
    ds = p * (dp - delta.reshape(b, kvh, g, sq, 1))
    if r_dtype is not None:
        # hi + lo, two operands of the type, into one float32 sum
        hi_p, hi_ds = p.to(r_dtype).float(), ds.to(r_dtype).float()
        p = hi_p + (p - hi_p).to(r_dtype).float()
        ds = hi_ds + (ds - hi_ds).to(r_dtype).float()
    qf = q.float().reshape(b, sq, kvh, g, d)
    kf = k.float()
    dq = torch.zeros((b, kvh, g, sq, d))
    for j0 in range(0, skv, DQ_TILE):
        dq += torch.einsum("bkgqj,bjkd->bkgqd", ds[..., j0:j0 + DQ_TILE],
                           kf[:, j0:j0 + DQ_TILE])
    dk = torch.zeros((b, skv, kvh, d))
    dv = torch.zeros((b, skv, kvh, d))
    for kt, j0 in enumerate(range(0, skv, KEY_TILE)):
        j1 = min(skv, j0 + KEY_TILE)
        for gi in range(g):
            for qt, i0 in enumerate(range(0, sq, Q_TILE)):
                if skip == (kt, qt) and gi == 0:
                    continue
                i1 = min(sq, i0 + Q_TILE)
                dk[:, j0:j1] += torch.einsum(
                    "bkqj,bqkd->bjkd", ds[:, :, gi, i0:i1, j0:j1],
                    qf[:, i0:i1, :, gi])
                dv[:, j0:j1] += torch.einsum(
                    "bkqj,bqkd->bjkd", p[:, :, gi, i0:i1, j0:j1],
                    dof[:, i0:i1, :, gi])
    dq = (scale * dq).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return dq.to(q.dtype), (scale * dk).to(k.dtype), dv.to(v.dtype)


# name -> (q/k/v shape, flash kwargs); the JAX tests' shapes and masks
EMU_CASES = {
    "causal_d64": (dict(b=2, sq=256, h=4, d=64), dict(causal=True)),
    "gqa_d128": (dict(b=1, sq=256, h=4, kvh=2, d=128), dict(causal=True)),
    "segments_d32": (dict(b=2, sq=256, h=2, d=32),
                     dict(causal=True, segment_ids="seg4")),
    "alibi_window_gqa_d80": (dict(b=1, sq=256, h=4, kvh=2, d=80),
                             dict(causal=True, alibi="slopes", window=40)),
    "pair_bias_d32": (dict(b=2, sq=200, h=2, d=32),
                      dict(causal=False, bias="full")),
}


def _emu_inputs(case, dtype):
    shape, kw = EMU_CASES[case]
    b, sq, h, d = shape["b"], shape["sq"], shape["h"], shape["d"]
    kvh = shape.get("kvh", h)
    rng = np.random.RandomState(10 + sorted(EMU_CASES).index(case))
    q, k, v, do = (rng.randn(*s).astype(np.float32)
                   for s in ((b, sq, h, d), (b, sq, kvh, d), (b, sq, kvh, d),
                             (b, sq, h, d)))
    # the inputs both sides see: rounded to the kernels' dtype
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    kw = dict(kw)
    if kw.get("segment_ids") == "seg4":
        kw["segment_ids"] = np.repeat(np.arange(4), sq // 4)[None].repeat(
            b, 0).astype(np.int32)
    if kw.get("alibi") == "slopes":
        from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
        kw["alibi"] = alibi_slopes(h)
    if kw.get("bias") == "full":
        kw["bias"] = rng.randn(b, h, sq, sq).astype(np.float32)
    return tq, tk, tv, tdo, kw


def _jax_grads(tq, tk, tv, tdo, kw):
    """dq, dk, dv of the JAX package's flash attention (interpret mode,
    float32) on the rounded inputs, as float32 torch tensors."""
    jkw = {k_: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for k_, x in kw.items()}

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, interpret=True, block_q=128,
                         block_k=128, **jkw)

    args = [jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)]
    _, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(tdo.float().numpy()))
    return [torch.from_numpy(np.array(x)) for x in grads]


def _torch_mask_bias(tq, tk, kw):
    kw = dict(kw)
    bias = kw.pop("bias", None)
    mask = tfa.make_mask(tq, tk, **{
        k_: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
        for k_, x in kw.items()})
    return mask, None if bias is None else torch.from_numpy(bias)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_p_ds_rounding_fits_the_card_tolerance(case, dtype):
    tq, tk, tv, tdo, kw = _emu_inputs(case, dtype)
    want = _jax_grads(tq, tk, tv, tdo, kw)
    mask, bias = _torch_mask_bias(tq, tk, kw)
    got = emulate_sm90_backward(tq, tk, tv, tdo, mask, dtype, bias)
    tol = FLASH_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = max_relative_err(g, w)
        assert err <= tol, f"{name}: max-relative err {err} > {tol}"
        row_err = row_relative_err(g, w)
        assert row_err <= tol, f"{name}: row-relative err {row_err} > {tol}"
    # the emulation without the roundings is the plain version's algebra
    f32 = [t.float() for t in (tq, tk, tv, tdo)]
    exact = emulate_sm90_backward(*f32, mask, None, bias)
    o, lse = tfa.flash_attention_fwd_reference(*f32[:3], mask, bias)
    plain = tfa.flash_attention_bwd_reference(
        *f32, lse, tfa.attention_delta(f32[3], o), mask, bias=bias)
    for g, w in zip(exact, plain):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


def test_row_hold_catches_a_q_tile_left_out_of_dkv():
    """bf16, S = 2048 causal, D = 128: a kernel that leaves q tile 30 (rows
    1920-1983) out of the last key tile's (keys 1920-2047) dK / dV errs
    only on keys whose gradients are far below the first keys'. The bf16
    hold by the largest magnitude lets it pass; the row-by-row hold does
    not, and passes the sound kernel's numerics."""
    dtype = torch.bfloat16
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn((1, 2048, 2, 128), generator=g).to(dtype)
                   for _ in range(4))
    mask = tfa.make_mask(q, k, causal=True)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, mask)
    _, dk_ref, dv_ref = tfa.flash_attention_bwd_reference(
        q, k, v, do, lse, tfa.attention_delta(do, o), mask, parts="dkv")
    tol = FLASH_TOL[dtype]
    _, dk, dv = emulate_sm90_backward(q, k, v, do, mask, dtype)
    _, dk_bad, dv_bad = emulate_sm90_backward(q, k, v, do, mask, dtype,
                                              skip=(15, 30))
    for bad, sound, ref in ((dk_bad, dk, dk_ref), (dv_bad, dv, dv_ref)):
        assert max_relative_err(bad, ref) <= tol
        assert row_relative_err(bad, ref) > 5 * tol
        assert row_relative_err(sound, ref) <= tol
