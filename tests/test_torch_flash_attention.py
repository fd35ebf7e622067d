"""PyTorch port: flash attention's plain versions and autograd Function
against the JAX package's Pallas flash kernel in interpret mode
(``deepspeedsyclsupport_tpu/ops/flash_attention.py``), on numpy inputs made
from a seed.

Cases are those of ``tests/unit/test_flash_attention.py``. Tolerances are
the JAX tests' own: 2e-5 in float32 and 2e-2 in bf16 for the forward,
2e-4 for the gradients (float32 on both sides; only summation order and
the exp of the two backends differ).
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
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, b=1, sq=16, d=8))
    for kw, entry in ((dict(bias=torch.zeros(1, 1, 16, 16)), "A.3.5"),
                      (dict(k_bias=torch.zeros(1, 16)), "A.3.5"),
                      (dict(block_layout=torch.ones(1, 1, 1)), "A.3.5"),
                      (dict(return_lse=True), "A.3.1")):
        with pytest.raises(NotImplementedError, match=entry):
            tfa.flash_attention(q, k, v, **kw)
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tfa.flash_attention(q, k[:, :8], v[:, :8],
                            segment_ids=torch.zeros(1, 16, dtype=torch.int32))


def test_cpu_tensors_never_launch():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(1, b=1, sq=32, d=8))
    tfa.reset_launch_counts()
    tfa.flash_attention(q, k, v).sum().backward()
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_launchers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, b=1, sq=32, d=8))
    mask = tfa.make_mask(q, k)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, v, mask)
