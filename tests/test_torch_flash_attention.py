"""PyTorch port: flash attention's plain versions and autograd Function
against the JAX package's Pallas flash kernel in interpret mode
(``deepspeedsyclsupport_tpu/ops/flash_attention.py``), on numpy inputs made
from a seed.

Cases are those of ``tests/unit/test_flash_attention.py``, plus the
additive pair bias (full-shape, and broadcast over contiguous groups of
batches or heads), the k-row bias and block layouts. Tolerances are the JAX
tests' own: 2e-5 in float32 and 2e-2 in bf16 for the forward, 2e-4 for the
gradients, the pair bias's included (float32 on both sides; only summation
order and the exp of the two backends differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

FWD_TOL = {np.float32: 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 2e-4
JAX_KW = dict(interpret=True, block_q=128, block_k=128)


def _inputs(seed, b=2, sq=256, skv=None, h=4, kvh=None, d=32):
    rng = np.random.RandomState(seed)
    skv = sq if skv is None else skv
    kvh = h if kvh is None else kvh
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, kvh, d).astype(np.float32),
            rng.randn(b, skv, kvh, d).astype(np.float32))


def _seg(b, s, n):
    return np.repeat(np.arange(n), s // n)[None].repeat(b, 0).astype(np.int32)


def _alibi(h):
    from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes

    return alibi_slopes(h)


CASES = {
    "causal": dict(shape={}, kw=dict(causal=True)),
    "non_causal": dict(shape={}, kw=dict(causal=False)),
    "gqa": dict(shape=dict(h=8, kvh=2), kw=dict(causal=True)),
    "unaligned_200": dict(shape=dict(sq=200), kw=dict(causal=True)),
    "cross_128_384": dict(shape=dict(sq=128, skv=384), kw=dict(causal=True)),
    "segments": dict(shape={}, kw=dict(causal=True, segment_ids="seg4")),
    "alibi": dict(shape={}, kw=dict(causal=True, alibi="slopes")),
    "window": dict(shape={}, kw=dict(causal=True, window=48)),
    "alibi_window": dict(shape=dict(h=8, kvh=2),
                         kw=dict(causal=True, alibi="slopes", window=40)),
}


def _kw(case, q):
    kw = dict(CASES[case]["kw"])
    if kw.get("segment_ids") == "seg4":
        kw["segment_ids"] = _seg(q.shape[0], q.shape[1], 4)
    if kw.get("alibi") == "slopes":
        kw["alibi"] = _alibi(q.shape[2])
    return kw


def _to_jax(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _to_torch(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_reference_matches_jax(case):
    q, k, v = _inputs(len(case), **CASES[case]["shape"])
    kw = _kw(case, q)
    want_o, want_lse = jax_flash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), return_lse=True,
                                 **_to_jax(kw), **JAX_KW)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    mask = tfa.make_mask(tq, tk, **_to_torch(kw))
    o, lse = tfa.flash_attention_fwd_reference(tq, tk, tv, mask)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=2e-5,
                               rtol=2e-5)
    # the JAX package returns lse as [B, Sq, H]; the port keeps [B, H, Sq]
    np.testing.assert_allclose(lse.transpose(1, 2).numpy(),
                               np.asarray(want_lse), atol=2e-5, rtol=2e-5)
    # the public function on a CPU tensor takes the same plain version
    np.testing.assert_array_equal(
        tfa.flash_attention(tq, tk, tv, **_to_torch(kw)).numpy(), o.numpy())


def test_forward_bf16_matches_jax():
    q, k, v = _inputs(5)
    want = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     causal=True, **JAX_KW)
    got = tfa.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_fully_masked_rows_zero_output_and_lse():
    """Rows whose segment appears in no key: o = 0, lse ~ -1e30, and the
    backward gives finite zeros there (no NaN from exp(s - lse))."""
    q, k, v = _inputs(9, b=1, sq=64, skv=64, h=2, d=16)
    seg_q = np.zeros((1, 64), np.int32)
    seg_q[0, 32:] = 7
    seg_k = np.zeros((1, 64), np.int32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kw = dict(causal=False, segment_ids=torch.from_numpy(seg_q),
              kv_segment_ids=torch.from_numpy(seg_k))
    with torch.no_grad():
        o, lse = tfa.flash_attention_fwd_reference(
            tq, tk, tv, tfa.make_mask(tq, tk, **kw))
    assert float(o[0, 32:].abs().max()) == 0.0
    assert float(lse[0, :, 32:].max()) <= -1e29
    out = tfa.flash_attention(tq, tk, tv, **kw)
    out.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in (tq, tk, tv))
    assert float(tq.grad[0, 32:].abs().max()) == 0.0


GRAD_CASES = ["causal", "non_causal", "gqa_segments", "unaligned_200",
              "alibi_window"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_grads_match_jax(case):
    shape = dict(gqa_segments=dict(h=8, kvh=2),
                 alibi_window=dict(h=8, kvh=2),
                 unaligned_200=dict(sq=200)).get(case, {})
    q, k, v = _inputs(20 + len(case), **shape)
    kw = {"causal": case != "non_causal"}
    if case == "gqa_segments":
        kw["segment_ids"] = _seg(q.shape[0], q.shape[1], 4)
    if case == "alibi_window":
        kw.update(alibi=_alibi(q.shape[2]), window=40)
    w = np.random.RandomState(3).randn(*q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, **_to_jax(kw), **JAX_KW)
                       * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, **_to_torch(kw))
     * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_backward_reference_parts_agree():
    """``parts="dq"``/``"dkv"`` compute the same numbers as ``"all"``."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(31, b=1, sq=96, h=4,
                                                    kvh=2, d=16))
    mask = tfa.make_mask(q, k, causal=True, window=33)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, mask)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    delta = tfa.attention_delta(do, o)
    dq, dk, dv = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                                   mask)
    dq1, _, _ = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                                  mask, parts="dq")
    _, dk1, dv1 = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                                    mask, parts="dkv")
    for a, b in ((dq, dq1), (dk, dk1), (dv, dv1)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_reference_blocks_agree_with_one_block(monkeypatch):
    """Looping over query blocks gives the one-block numbers."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(32, b=1, sq=80, h=2,
                                                    d=16))
    mask = tfa.make_mask(q, k, causal=True,
                         alibi=torch.from_numpy(_alibi(2)))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, mask)
    monkeypatch.setattr(tfa, "_REF_BLOCK_ELEMS", 2 * 80 * 7)
    o7, lse7 = tfa.flash_attention_fwd_reference(q, k, v, mask)
    torch.testing.assert_close(o, o7, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, lse7, atol=1e-6, rtol=1e-6)


def test_unported_arguments_raise():
    """What the port refuses, as the JAX function does: a block layout with
    a broadcast pair bias; and malformed bias, k-bias and layout shapes.
    The lse-returning variant is ported (``tests/test_torch_flash_lse.py``):
    it returns ``(o, lse [B, Sq, H])``."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, b=2, sq=16, d=8))
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert o.shape == q.shape and lse.shape == (2, 16, 4)
    with pytest.raises(NotImplementedError, match="BROADCAST"):
        tfa.flash_attention(q, k, v, bias=torch.zeros(1, 4, 16, 16),
                            block_layout=torch.ones(1, 1, 1))
    for kw, what in ((dict(bias=torch.zeros(2, 3, 16, 16)), "bias shape"),
                     (dict(bias=torch.zeros(2, 4, 16, 8)), "bias shape"),
                     (dict(k_bias=torch.zeros(3, 16)), "k_bias shape"),
                     (dict(k_bias=torch.zeros(2, 15)), "k_bias shape"),
                     (dict(block_layout=torch.ones(2, 1, 1)), "block_layout"),
                     (dict(block_layout=torch.ones(1, 2, 2), block_q=8),
                      "block_layout")):
        with pytest.raises(ValueError, match=what):
            tfa.flash_attention(q, k, v, **kw)
    # a layout with a full-shape bias is taken, as in the JAX package
    tfa.flash_attention(q, k, v, bias=torch.zeros(2, 4, 16, 16),
                        block_layout=torch.ones(1, 1, 1))
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tfa.flash_attention(q, k[:, :8], v[:, :8],
                            segment_ids=torch.zeros(1, 16, dtype=torch.int32))


def test_cpu_tensors_never_launch():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(1, b=2, sq=32, d=8))
    tfa.reset_launch_counts()
    tfa.flash_attention(q, k, v).sum().backward()
    for bias in (torch.zeros(2, 4, 32, 32), torch.zeros(1, 1, 32, 32)):
        tfa.flash_attention(q, k, v, bias=bias.requires_grad_(),
                            k_bias=torch.zeros(1, 32)).sum().backward()
        assert bias.grad.shape == bias.shape
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                            "flash_dbias": 0}


def test_launchers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, b=1, sq=32, d=8))
    mask = tfa.make_mask(q, k)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, v, mask)


# ------------------------------------------------------- biases and layouts
# name -> (input shape, flash kwargs); "pair" is a pair-bias shape, "kbias"
# a k-row-bias shape (with "kbias_neg" keys at -1e9), "layout" a layout of
# (Hl, block) over the sequence
BIAS_CASES = {
    "full_bias": (dict(b=2, sq=96), dict(causal=True, pair=(2, 4))),
    "bcast_batch_6_over_2": (dict(b=6, sq=64),
                             dict(causal=False, pair=(2, 4))),
    "bcast_heads": (dict(b=2, sq=96), dict(causal=False, pair=(2, 1))),
    "bcast_both": (dict(b=2, sq=80), dict(causal=True, pair=(1, 2))),
    "kbias_6_over_2": (dict(b=6, sq=64), dict(causal=False, kbias=2)),
    "bias_gqa_alibi": (dict(b=2, sq=96, h=8, kvh=2),
                       dict(causal=True, alibi="slopes", pair=(2, 8),
                            kbias=1)),
    "bcast_gqa_window": (dict(b=2, sq=96, h=8, kvh=2),
                         dict(causal=True, window=40, pair=(1, 4))),
    "full_bias_kbias_layout_200": (dict(b=2, sq=200),
                                   dict(causal=True, pair=(2, 4), kbias=2,
                                        layout=(4, 64))),
    "cross_bias_layout_16": (dict(b=2, sq=64, skv=128),
                             dict(causal=False, pair=(2, 4), layout=(1, 16))),
}


def _bias_kw(case, q, k, seed):
    """numpy keyword arguments of one bias case (the JAX and the port's
    flash functions take the same names)."""
    _, spec = BIAS_CASES[case]
    rng = np.random.RandomState(seed)
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    kw = {"causal": spec["causal"]}
    if "window" in spec:
        kw["window"] = spec["window"]
    if spec.get("alibi"):
        kw["alibi"] = _alibi(h)
    if "pair" in spec:
        kw["bias"] = rng.randn(*spec["pair"], sq, skv).astype(np.float32)
    if "kbias" in spec:
        kb = (0.5 * rng.randn(spec["kbias"], skv)).astype(np.float32)
        kb[rng.rand(*kb.shape) < 0.2] = -1e9
        kw["k_bias"] = kb
    if "layout" in spec:
        hl, blk = spec["layout"]
        bq, bk = min(blk, -(-sq // 128) * 128), min(blk, -(-skv // 128) * 128)
        lay = (rng.rand(hl, -(-sq // bq), -(-skv // bk)) < 0.6).astype(
            np.int32)
        lay[:, :, 0] = 1          # every row block sees something
        kw.update(block_layout=lay, block_q=blk, block_k=blk)
    return kw


def _jax_kw(kw):
    out = dict(interpret=True, block_q=128, block_k=128)
    out.update(_to_jax(kw))
    return out


@pytest.mark.parametrize("case", sorted(BIAS_CASES))
def test_bias_forward_matches_jax(case):
    q, k, v = _inputs(50 + len(case), **BIAS_CASES[case][0])
    kw = _bias_kw(case, q, k, seed=len(case))
    want = jax_flash(*map(jnp.asarray, (q, k, v)), **_jax_kw(kw))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              **_to_torch(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


BIAS_GRAD_CASES = ["full_bias", "bcast_batch_6_over_2", "bcast_heads",
                   "bias_gqa_alibi", "bcast_gqa_window",
                   "full_bias_kbias_layout_200"]


@pytest.mark.parametrize("case", BIAS_GRAD_CASES)
def test_bias_grads_match_jax(case):
    """Grads of q, k, v and the pair bias: the dQ kernel's full-shape dbias
    and the reducing kernel's broadcast one, on their plain versions."""
    q, k, v = _inputs(70 + len(case), **BIAS_CASES[case][0])
    kw = _bias_kw(case, q, k, seed=len(case))
    bias = kw.pop("bias")
    w = np.random.RandomState(4).randn(*q.shape).astype(np.float32)

    def jloss(q_, k_, v_, b_):
        return jnp.sum(jax_flash(q_, k_, v_, bias=b_, **_jax_kw(kw))
                       * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    (tfa.flash_attention(*leaves[:3], bias=leaves[3], **_to_torch(kw))
     * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_minus_inf_k_bias_on_every_key_matches_jax():
    """A batch whose k-row bias is -inf on every key: o = 0 there and the
    grads finite and zero, as the JAX function gives."""
    q, k, v = _inputs(90, b=2, sq=64)
    kb = np.zeros((2, 64), np.float32)
    kb[1] = -np.inf
    bias = np.random.RandomState(1).randn(1, 4, 64, 64).astype(np.float32)

    def jloss(q_, b_):
        return jnp.sum(jax_flash(q_, jnp.asarray(k), jnp.asarray(v),
                                 causal=False, bias=b_,
                                 k_bias=jnp.asarray(kb), **JAX_KW))

    want_o = jax_flash(*map(jnp.asarray, (q, k, v)), causal=False,
                       bias=jnp.asarray(bias), k_bias=jnp.asarray(kb),
                       **JAX_KW)
    want_gq, want_gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q),
                                                       jnp.asarray(bias))
    tq, tb = (torch.from_numpy(x).requires_grad_() for x in (q, bias))
    out = tfa.flash_attention(tq, *map(torch.from_numpy, (k, v)),
                              causal=False, bias=tb,
                              k_bias=torch.from_numpy(kb))
    out.sum().backward()
    assert float(out.detach()[1].abs().max()) == 0.0
    assert bool(torch.isfinite(tq.grad).all())
    assert bool(torch.isfinite(tb.grad).all())
    assert float(tq.grad[1].abs().max()) == 0.0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               atol=2e-5, rtol=2e-5)
    for got, want in ((tq.grad, want_gq), (tb.grad, want_gb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_broadcast_dbias_is_the_sum_of_the_full_one():
    """The reduced dbias of a broadcast bias equals the full-shape dbias of
    the same bias expanded to every (batch, head), summed over the batches
    b // (B / Bb) and heads h // (H / Hb) that share each entry."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(91, b=6, sq=48, h=4,
                                                    kvh=2))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    bias = torch.randn((2, 2, 48, 48),
                       generator=torch.Generator().manual_seed(2))
    mask = tfa.make_mask(q, k, causal=False)
    full = bias.repeat_interleave(3, 0).repeat_interleave(2, 1)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, mask, bias)
    o_full, lse_full = tfa.flash_attention_fwd_reference(q, k, v, mask, full)
    torch.testing.assert_close(o, o_full, atol=0, rtol=0)
    delta = tfa.attention_delta(do, o)
    reduced = tfa.flash_dbias_reference(q, k, v, do, lse, delta, mask, bias)
    per = tfa.flash_dbias_reference(q, k, v, do, lse, delta, mask, full)
    assert reduced.shape == bias.shape and per.shape == full.shape
    torch.testing.assert_close(
        reduced, per.reshape(2, 3, 2, 2, 48, 48).sum(dim=(1, 3)),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,bias,dtype,want", [
    ((512, 384, 8, 32), (1, 8, 384, 384), torch.float32, 8),   # MSA rows
    ((384, 384, 4, 32), (1, 4, 384, 384), torch.float32, 15),  # triangle
    ((6, 96, 4, 32), (2, 4, 96, 96), torch.float32, 3),    # one replica each
    ((2, 64, 4, 32), (2, 4, 64, 64), torch.float32, 1),    # full: no sum
    ((4096, 64, 2, 256), (1, 1, 64, 64), torch.float32, 16),   # at most 16
    ((512, 384, 8, 32), (1, 8, 384, 384), torch.bfloat16, 8),  # Hopper route
    ((384, 384, 4, 32), (1, 4, 384, 384), torch.float16, 15),
    ((4096, 64, 2, 256), (1, 1, 64, 64), torch.bfloat16, 16),  # D > 128
])
def test_dbias_chunks(shape, bias, dtype, want):
    """The reducing kernel cuts each bias entry's replicas into enough
    fixed ranges for its route's CTA target (the CUDA-core kernel's 64 x 64
    tiles: 2112; the Hopper kernel's 128 x 64: 1024), at most 16 and one
    replica each, from the shapes and dtype alone."""
    q = torch.empty(shape, dtype=dtype)
    assert tfa.dbias_chunks(q, q, torch.empty(bias)) == want
