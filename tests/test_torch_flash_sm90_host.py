"""PyTorch port: what the CPU can check of the Hopper flash-attention
forward (``flash_fwd_sm90_kernel`` in ``csrc/flash_attention.cu``, the
bfloat16 / float16 route).

* The wrapper's TMA eligibility test and its copy of an operand TMA cannot
  read in place (``tma_ready``, ``tma_operand``, ``COPIES``). The route
  each dtype takes is the built library's answer, so its test runs on the
  card (``tests/test_torch_cuda.py``).
* The kernel's numerics, emulated here: the online softmax over tiles of BC
  keys with P as two operands of bf16 / fp16 in P V, hi = T(P) and lo =
  T(P - hi) (the plain version keeps P in float32; ROADMAP C2), and O
  rounded to the dtype, against the JAX package's
  Pallas ``_fwd_kernel`` in interpret mode on the same (rounded) inputs in
  float32. The tolerances are the card tests' (``tests/test_torch_cuda.py``
  ``FLASH_TOL``): O within 2e-2 (bf16) or 4e-3 (fp16) of the largest |O|,
  and of each row's largest |O| row by row, LSE within 1e-4. This shows on
  the CPU that the arithmetic fits the budget, and that the row-by-row hold
  catches a kernel that leaves one key tile out of P V where the hold by
  the largest |O| does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3}
LSE_TOL = 1e-4
DIMS = [16, 20, 32, 80, 128, 256]


# ------------------------------------------------------------ TMA eligibility
def _contiguous(d, h=4, dtype=torch.bfloat16):
    return torch.zeros((2, 33, h, d), dtype=dtype)


@pytest.mark.parametrize("d", DIMS)
def test_tma_ready_contiguous(d):
    """Contiguous [B, S, H, D]: the head stride is D elements, so TMA reads
    it in place iff D * 2 bytes is a multiple of 16."""
    assert tfa.tma_ready(_contiguous(d)) == (d % 8 == 0)


@pytest.mark.parametrize("d", DIMS)
def test_tma_ready_packed_qkv(d):
    """q, k and v as views of one packed [B, S, H + 2 KVH, D] buffer (the
    fused projection's layout): every view is ready iff D % 8 == 0."""
    h, kvh = 4, 2
    qkv = torch.zeros((2, 33, h + 2 * kvh, d), dtype=torch.bfloat16)
    views = (qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:])
    assert [tfa.tma_ready(t) for t in views] == [d % 8 == 0] * 3


@pytest.mark.parametrize("d", DIMS)
def test_tma_ready_sliced(d):
    """A slice along the sequence starts a whole row later: aligned iff the
    row is; a slice of one head of several keeps the head stride."""
    t = _contiguous(d)
    assert tfa.tma_ready(t[:, 5:]) == (d % 8 == 0)
    assert tfa.tma_ready(t[:, :, 1:3]) == (d % 8 == 0)


@pytest.mark.parametrize("d", DIMS)
def test_tma_ready_odd_offset(d):
    """A view that starts one element into its buffer is never ready."""
    shape = (2, 33, 4, d)
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.float16)
    t = flat[1:].view(shape)
    assert t.data_ptr() % 16 != 0
    assert not tfa.tma_ready(t)


def test_tma_ready_ignores_dims_of_one_entry():
    """A dimension with one entry never steps: its stride does not matter."""
    one = torch.zeros((1, 1, 1, 20), dtype=torch.bfloat16)
    assert tfa.tma_ready(one)
    assert not tfa.tma_ready(torch.zeros((1, 3, 1, 20),
                                         dtype=torch.bfloat16))
    assert tfa.tma_ready(torch.zeros((1, 3, 1, 24), dtype=torch.bfloat16))
    # a broadcast (stride 0) sequence is not a tensor TMA can describe
    row = torch.zeros((1, 1, 2, 32), dtype=torch.bfloat16)
    assert not tfa.tma_ready(row.expand(1, 5, 2, 32))


@pytest.mark.parametrize("d", DIMS)
def test_tma_operand_copies_only_what_it_must(d):
    """A ready operand passes as it is; another is copied once into rows
    padded to a multiple of 8, the copy counted, its values unchanged."""
    tfa.reset_launch_counts()
    ready = _contiguous(24)
    assert tfa.tma_operand(ready) is ready
    assert tfa.COPIES == dict.fromkeys(tfa.COPIES, 0)
    shape = (2, 33, 4, d)
    flat = torch.randn(int(np.prod(shape)) + 1).to(torch.bfloat16)
    odd = flat[1:].view(shape)
    got = tfa.tma_operand(odd)
    assert tfa.COPIES == {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0,
                          "flash_dbias": 0}
    assert tfa.tma_ready(got) and got.shape == odd.shape
    assert got.stride(2) == tfa.round_up(d, 8)
    assert torch.equal(got, odd)
    for counter in ("flash_dq", "flash_dkv", "flash_dbias"):  # backward's
        tfa.tma_operand(odd, counter)
        assert tfa.COPIES[counter] == 1
    tfa.reset_launch_counts()
    assert tfa.COPIES == dict.fromkeys(tfa.COPIES, 0)


def test_cpu_forward_makes_no_copy():
    """On a CPU tensor the wrappers take the plain versions, forward and
    backward: nothing is launched and nothing copied, whatever the
    alignment."""
    shape = (1, 40, 2, 20)
    flat = torch.randn(3 * int(np.prod(shape)) + 1).to(torch.bfloat16)
    q, k, v = (flat[1 + i * int(np.prod(shape)):][:int(np.prod(shape))]
               .view(shape) for i in range(3))
    tfa.reset_launch_counts()
    q.requires_grad_()
    tfa.flash_attention(q, k, v).sum().backward()
    assert tfa.COPIES == dict.fromkeys(tfa.COPIES, 0)
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)


# ---------------------------------------------------------------- numerics
def row_relative_err(got, want):
    """The largest over rows of the row's max abs error over the row's
    largest |want| (the card tests' ``_assert_rows_close``)."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    ratio = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)
    return float(ratio.max())


def emulate_sm90_forward(q, k, v, mask, p_dtype, bc, skip_tile=None):
    """The Hopper kernel's arithmetic on the CPU: scores in float32, online
    softmax over tiles of ``bc`` keys (m from -1e30, alpha = exp(m_old -
    m_new), l summed from the unrounded p), O += P V with P as hi + lo
    operands of ``p_dtype`` (hi = T(p), lo = T(p - hi)), then O / max(l,
    1e-30) in q's dtype and LSE = m + log(max(l, 1e-30)). ``p_dtype`` None
    keeps p in float32 (the plain version's algebra).
    ``skip_tile``: the index of a key tile left out of P V, as a faulty
    kernel would (l and m still count it)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    s, vis = tfa._scores(q, k, mask, 0, sq)             # [B, KVH, G, Sq, Skv]
    s = torch.where(vis, s, torch.full_like(s, float("-inf")))
    vf = v.float()
    m = torch.full((b, kvh, g, sq, 1), tfa.NEG_INF)
    l = torch.zeros((b, kvh, g, sq, 1))
    acc = torch.zeros((b, kvh, g, sq, d))
    for j0 in range(0, skv, bc):
        st = s[..., j0:j0 + bc]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pr = p
        if p_dtype is not None:
            pr = p.to(p_dtype).float()
            pr = pr + (p - pr).to(p_dtype).float()
        if j0 // bc == skip_tile:
            pr = torch.zeros_like(pr)
        acc = acc * alpha + torch.einsum("bkgqj,bjkd->bkgqd", pr,
                                         vf[:, j0:j0 + bc])
        m = m_new
    denom = l.clamp_min(1e-30)
    o = (acc / denom).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    lse = (m + torch.log(denom)).reshape(b, h, sq)
    return o.to(q.dtype), lse


# name -> (q/k/v shape, flash kwargs); the JAX tests' shapes and masks
EMU_CASES = {
    "causal_d64": (dict(b=2, sq=256, h=4, d=64), dict(causal=True)),
    "non_causal_gqa_d128": (dict(b=1, sq=256, h=4, kvh=2, d=128),
                            dict(causal=False)),
    "unaligned_200_d32": (dict(b=2, sq=200, h=2, d=32), dict(causal=True)),
    "cross_128_384_d80": (dict(b=1, sq=128, skv=384, h=2, d=80),
                          dict(causal=True)),
    "segments_d16": (dict(b=2, sq=256, h=2, d=16),
                     dict(causal=True, segment_ids="seg4")),
    "alibi_window_d256": (dict(b=1, sq=256, h=4, kvh=2, d=256),
                          dict(causal=True, alibi="slopes", window=40)),
}


def _emu_inputs(case, dtype):
    shape, kw = EMU_CASES[case]
    b, sq, h, d = shape["b"], shape["sq"], shape["h"], shape["d"]
    skv, kvh = shape.get("skv", sq), shape.get("kvh", h)
    rng = np.random.RandomState(sorted(EMU_CASES).index(case))
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    # the inputs both sides see: rounded to the kernel's dtype
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    kw = dict(kw)
    if kw.get("segment_ids") == "seg4":
        kw["segment_ids"] = np.repeat(np.arange(4), sq // 4)[None].repeat(
            b, 0).astype(np.int32)
    if kw.get("alibi") == "slopes":
        from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
        kw["alibi"] = alibi_slopes(h)
    return tq, tk, tv, kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_p_rounding_fits_the_card_tolerance(case, dtype):
    tq, tk, tv, kw = _emu_inputs(case, dtype)
    want_o, want_lse = jax_flash(
        *(jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)),
        return_lse=True, interpret=True, block_q=128, block_k=128,
        **{k_: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for k_, x in kw.items()})
    want_o = torch.from_numpy(np.array(want_o))
    want_lse = torch.from_numpy(np.array(want_lse)).transpose(1, 2)
    mask = tfa.make_mask(tq, tk, **{
        k_: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
        for k_, x in kw.items()})
    bc = 128 if tq.shape[3] <= 128 else 64
    o, lse = emulate_sm90_forward(tq, tk, tv, mask, dtype, bc)
    assert o.dtype == dtype
    lim = FLASH_TOL[dtype] * max(1.0, float(want_o.abs().max()))
    err = float((o.float() - want_o).abs().max())
    assert err <= lim, f"O: max abs err {err} > {lim}"
    row_err = row_relative_err(o, want_o)
    assert row_err <= FLASH_TOL[dtype], f"O: row-relative err {row_err}"
    live = want_lse > -1e29
    assert float((lse[live] - want_lse[live]).abs().max()) <= LSE_TOL
    # the emulation without the rounding is the plain version's algebra
    o32, lse32 = emulate_sm90_forward(tq.float(), tk.float(), tv.float(),
                                      mask, None, bc)
    ref_o, ref_lse = tfa.flash_attention_fwd_reference(
        tq.float(), tk.float(), tv.float(), mask)
    torch.testing.assert_close(o32, ref_o, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse32, ref_lse, atol=2e-5, rtol=2e-5)


def test_row_hold_catches_a_dropped_key_tile():
    """bf16, S = 2048 causal, D = 128: a kernel that leaves the last key
    tile out of P V errs only on the last 128 rows, whose |O| is ~50x below
    the first rows'. The bf16 hold by the largest |O| lets it pass; the
    row-by-row hold does not, and passes the sound kernel's numerics."""
    dtype = torch.bfloat16
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((1, 2048, 2, 128), generator=g).to(dtype)
               for _ in range(3))
    mask = tfa.make_mask(q, k, causal=True)
    want, _ = tfa.flash_attention_fwd_reference(q, k, v, mask)
    tol = FLASH_TOL[dtype]
    lim = tol * max(1.0, float(want.float().abs().max()))
    sound, _ = emulate_sm90_forward(q, k, v, mask, dtype, 128)
    faulty, _ = emulate_sm90_forward(q, k, v, mask, dtype, 128, skip_tile=15)
    assert float((faulty.float() - want.float()).abs().max()) <= lim
    assert row_relative_err(faulty, want) > 5 * tol
    assert row_relative_err(sound, want) <= tol
