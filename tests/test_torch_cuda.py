"""PyTorch port on the card: the CUDA ragged paged-attention kernels (each
case's route asserted: the Hopper prefill, split-KV decode or CUDA-core
kernel) and the CUDA flash-attention kernels (forward, dQ, dK/dV) against their plain
versions over many small shapes, their input checks, and the serving and
training engines through the kernels. Marked ``cuda``: they skip where
there is no card.

This file imports no JAX (the card's machine has none), so on the card it
runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 1e-4 in float32 (kernel and plain version both sum in float32,
in different orders, over contexts of a few hundred tokens); 2e-2 in bf16
(both round a float32 result to bf16; one rounding step at |x| < 4 may
differ); 4e-3 in fp16 (10 mantissa bits). Flash backward outputs are held
relative to their largest magnitude (they are sums over up to a few hundred
rows) and row by row (each row over its own largest magnitude, at least
``GRAD_ROW_FLOOR`` of the tensor's: dQ of a query that sees one key is
exactly zero, so both sides' rows are float32 rounding noise there). float32
products run without TF32 (set in the fixture).
"""
import math

import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
PAGED_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _want_route(dtype, bq, h, kvh, d, bs, aligned=True):
    """The route the library takes (``route_of`` in
    csrc/paged_attention.cu), written out for the tests."""
    g = h // kvh
    if bq * g <= 16:
        return "paged_decode_split_kernel"
    if dtype != torch.float32 and d <= 128 and d % 8 == 0 and aligned and \
            (bs % 64 == 0 or (64 % bs == 0 and bs >= 8)) and 128 % g == 0:
        return "paged_prefill_sm90_kernel"
    return "paged_attention_kernel"


def _hold_paged(got, want, dtype, what=""):
    """Max abs error within TOL (relative to the largest |want| where that
    is above 1) and, in bf16 / fp16, each row within TOL of its own largest
    |want| (a row zero in want is zero in got)."""
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype != torch.float32:
        _assert_rows_close(got, want, TOL[dtype], what or "paged O")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, *, a, bq, h, kvh, d, bs, bps, seed, full=False):
    rng = np.random.RandomState(seed)
    num_slots = (bps * a + 3) * bs
    cap = bps * bs
    pos0 = rng.randint(0, cap, a)
    qlen = np.minimum(rng.randint(0, bq + 1, a), np.maximum(cap - pos0, 0))
    if full:
        qlen[0], pos0[0] = bq, 0
    qlen[-1] = 0                                   # one dead atom
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((a, bq, h, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.from_numpy(rng.randint(0, num_slots // bs, (a, bps)).astype(
                np.int32)).to(dev),
            torch.from_numpy(pos0.astype(np.int32)).to(dev),
            torch.from_numpy(qlen.astype(np.int32)).to(dev)]


SHAPES = [
    dict(a=4, bq=16, h=4, kvh=2, d=32, bs=8, bps=6),      # the JAX test shape
    dict(a=3, bq=8, h=4, kvh=1, d=32, bs=8, bps=1),       # single block
    dict(a=5, bq=128, h=8, kvh=8, d=128, bs=64, bps=8),   # llama-like MHA
    dict(a=5, bq=128, h=8, kvh=2, d=128, bs=16, bps=20),  # GQA, G=4
    dict(a=3, bq=64, h=8, kvh=1, d=64, bs=32, bps=4),     # G=8 (two tiles)
    dict(a=3, bq=33, h=6, kvh=3, d=80, bs=8, bps=9),      # phi head dim
    dict(a=3, bq=16, h=4, kvh=4, d=96, bs=16, bps=4),     # neox head dim
    dict(a=3, bq=16, h=4, kvh=2, d=256, bs=16, bps=4),    # largest head dim
    dict(a=4, bq=16, h=4, kvh=2, d=16, bs=8, bps=6),      # tiny's head dim
]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("variant", ["plain", "alibi", "window",
                                     "alibi_window"])
def test_ragged_kernel_matches_plain(dev, shape, dtype, variant):
    s = SHAPES[shape]
    args = _case(dev, dtype, seed=shape, full=True, **s)
    kw = dict(block_size=s["bs"])
    if "alibi" in variant:
        kw["alibi"] = torch.from_numpy(alibi_slopes(s["h"])).to(dev)
    if "window" in variant:
        kw["window"] = max(1, s["bs"] * s["bps"] // 5)
    assert pa.kernel_for(*args[:3], s["bs"]) == _want_route(
        dtype, s["bq"], s["h"], s["kvh"], s["d"], s["bs"])
    before = pa.LAUNCHES["ragged_prefill_attention"]
    got = pa.ragged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["ragged_prefill_attention"] == before + 1
    want = pa.ragged_prefill_attention_reference(*args, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    _hold_paged(got, want, dtype)
    rows = torch.arange(s["bq"], device=dev)[None, :]
    assert float(got[rows >= args[5].long()[:, None]].abs().max()) == 0.0


def _decode_args(dev, dtype, *, s, h, kvh, d, bs, bps, seed, lens=None):
    rng = np.random.RandomState(seed)
    num_slots = (s * bps + 2) * bs
    if lens is None:
        lens = rng.randint(0, bps * bs + 1, s).astype(np.int32)
        lens[0], lens[1] = 0, bps * bs
    g = torch.Generator(device="cpu").manual_seed(0)
    return [torch.randn((s, h, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.from_numpy(rng.permutation(num_slots // bs)[:s * bps]
                             .reshape(s, bps).astype(np.int32)).to(dev),
            torch.from_numpy(np.asarray(lens, np.int32)).to(dev)]


@pytest.mark.parametrize("kvh,d,bs", [(8, 128, 64), (2, 128, 16), (1, 64, 8),
                                      (8, 80, 32), (8, 256, 64), (4, 256, 16)])
@pytest.mark.parametrize("dtype", PAGED_DTYPES)
def test_decode_kernel_matches_plain(dev, kvh, d, bs, dtype):
    h = 8
    args = _decode_args(dev, dtype, s=9, h=h, kvh=kvh, d=d, bs=bs, bps=12,
                        seed=d + bs)
    assert pa.kernel_for(args[0][:, None], *args[1:3], bs) == \
        "paged_decode_split_kernel"
    for kw in (dict(), dict(window=37),
               dict(alibi=torch.from_numpy(alibi_slopes(h)).to(dev))):
        got = pa.paged_decode_attention(*args, block_size=bs, **kw)
        want = pa.paged_decode_attention_reference(*args, block_size=bs, **kw)
        _hold_paged(got, want, dtype)
        assert float(got[0].abs().max()) == 0.0     # dead slot


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_long_context_window(dev, dtype):
    """mistral-7b heads (GQA 32 / 8, D = 128) over an 8192-token context
    with its 4096 window: atoms at the start, in the middle, at the end of
    the table, one partial and one dead, on the Hopper route."""
    rng = np.random.RandomState(3)
    bs, bps, h, kvh, d, bq = 64, 128, 32, 8, 128, 128
    pos0 = np.array([0, 4000, 8064, 6100, 0], np.int32)
    qlen = np.array([128, 128, 128, 37, 0], np.int32)
    num_slots = (bps * len(pos0) + 2) * bs
    g = torch.Generator(device="cpu").manual_seed(3)
    args = [torch.randn((len(pos0), bq, h, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.from_numpy(rng.permutation(num_slots // bs)[:len(pos0) * bps]
                             .reshape(len(pos0), bps).astype(np.int32)).to(
                dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(qlen).to(dev)]
    assert pa.kernel_for(*args[:3], bs) == "paged_prefill_sm90_kernel"
    got = pa.ragged_prefill_attention(*args, block_size=bs, window=4096)
    want = pa.ragged_prefill_attention_reference(*args, block_size=bs,
                                                 window=4096)
    _hold_paged(got, want, dtype)
    assert float(got[-1].abs().max()) == 0.0 and \
        float(got[3, 37:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
def test_decode_long_context_spans_chunks(dev, dtype):
    """Decode over up to 2047 tokens of llama2-7b heads: up to eight chunks
    of the split route folded by the combine kernel, beside one-chunk
    sequences the split kernel writes itself and a dead slot."""
    lens = [2047, 1, 255, 256, 257, 1500, 0, 2048, 513]
    args = _decode_args(dev, dtype, s=len(lens), h=32, kvh=32, d=128, bs=64,
                        bps=32, seed=5, lens=lens)
    got = pa.paged_decode_attention(*args, block_size=64)
    want = pa.paged_decode_attention_reference(*args, block_size=64)
    _hold_paged(got, want, dtype)
    assert float(got[6].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
def test_paged_routes_are_bit_identical_on_repeat(dev, dtype):
    """Every route gives the same bits twice: no atomics, the split
    route's chunks folded in order."""
    cases = [_case(dev, dtype, seed=2, full=True, **SHAPES[2]),    # prefill
             _case(dev, dtype, seed=7, full=True, **SHAPES[7])]    # D = 256
    for args in cases:
        bs = 64 if args[0].shape[-1] == 128 else 16
        one = pa.ragged_prefill_attention(*args, block_size=bs, window=300)
        assert torch.equal(one, pa.ragged_prefill_attention(
            *args, block_size=bs, window=300))
    dargs = _decode_args(dev, dtype, s=6, h=32, kvh=8, d=128, bs=16, bps=100,
                         seed=1)
    one = pa.paged_decode_attention(*dargs, block_size=16)
    assert torch.equal(one, pa.paged_decode_attention(*dargs, block_size=16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_unaligned_pool_takes_the_cuda_core_route_without_a_copy(dev, dtype):
    """A pool view that starts one element into its buffer cannot be read
    by TMA: the library takes the CUDA-core kernel, which reads it in place
    (the call allocates less than one pool), and the result holds."""
    s = SHAPES[2]
    args = _case(dev, dtype, seed=4, full=True, **s)
    assert pa.kernel_for(*args[:3], s["bs"]) == "paged_prefill_sm90_kernel"
    pools = []
    for t in args[1:3]:
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        pools.append(view)
    assert pools[0].is_contiguous() and pools[0].data_ptr() % 16 != 0
    odd = [args[0], *pools, *args[3:]]
    assert pa.kernel_for(*odd[:3], s["bs"]) == "paged_attention_kernel"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = pa.ragged_prefill_attention(*odd, block_size=s["bs"])
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < pools[0].nbytes
    _hold_paged(got, pa.ragged_prefill_attention_reference(
        *args, block_size=s["bs"]), dtype)


def test_kernel_rejects_what_it_does_not_take(dev):
    args = _case(dev, torch.float32, a=2, bq=4, h=4, kvh=2, d=32, bs=8, bps=2,
                 seed=0)
    with pytest.raises(TypeError):
        pa.ragged_prefill_attention(args[0].double(), *args[1:], block_size=8)
    with pytest.raises(TypeError):       # q and pool of different dtypes
        pa.ragged_prefill_attention(args[0].half(), *args[1:], block_size=8)
    with pytest.raises(ValueError, match="contiguous"):
        pa.ragged_prefill_attention(args[0].transpose(1, 2).contiguous()
                                    .transpose(1, 2), *args[1:],
                                    block_size=8)
    big = [torch.zeros((2, 4, 4, 512), device=dev),
           torch.zeros((16, 2, 512), device=dev),
           torch.zeros((16, 2, 512), device=dev)] + args[3:]
    with pytest.raises(ValueError, match="256"):
        pa.ragged_prefill_attention(*big, block_size=8)


def test_engine_serves_through_kernel(dev):
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    model = build_model("tiny", dtype="float32", sliding_window=6)
    params = model.init_params(device=dev)
    kw = dict(dtype=torch.float32, block_size=8, max_context=64,
              max_tokens_per_batch=16, max_sequences=4, atom_q_size=8)
    prompts = [[7, 3, 11], [4, 100, 42, 8, 19], list(range(30, 52)), [9]]
    pa.reset_launch_counts()
    kern = InferenceEngineV2(model, params, **kw).generate(prompts, 6)
    counts = dict(pa.LAUNCHES)
    plain = InferenceEngineV2(model, params, prefill_attn="xla",
                              decode_attn="xla", **kw).generate(prompts, 6)
    assert kern == plain
    assert counts["ragged_prefill_attention"] > 0
    assert counts["paged_decode_attention"] > 0
    logits = InferenceEngineV2(model, params, **kw).put([1], [prompts[2]])[1]
    dense = model.apply(params, torch.tensor([prompts[2]], device=dev))
    assert math.isclose(float((logits - dense[0, -1]).abs().max()), 0.0,
                        abs_tol=2e-4)


def test_engine_serves_fp16_through_kernels(dev):
    """float16 serving end to end: the engine through the kernels (prefill
    atoms of 16 rows x 2 heads on the Hopper route, decode on the split
    route) gives the plain path's greedy tokens."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    model = build_model("tiny", dtype="float16")
    params = model.init_params(device=dev, dtype=torch.float16)
    kw = dict(dtype=torch.float16, block_size=8, max_context=64,
              max_tokens_per_batch=32, max_sequences=4, atom_q_size=16)
    prompts = [[7, 3, 11], [4, 100, 42, 8, 19], list(range(30, 60)), [9]]
    cfg = model.config
    assert pa.kernel_name("prefill", torch.float16, cfg.head_dim,
                          block_size=8, bq=16,
                          group=cfg.num_heads // cfg.num_kv_heads) == \
        "paged_prefill_sm90_kernel"
    pa.reset_launch_counts()
    kern = InferenceEngineV2(model, params, **kw).generate(prompts, 6)
    counts = dict(pa.LAUNCHES)
    plain = InferenceEngineV2(model, params, prefill_attn="xla",
                              decode_attn="xla", **kw).generate(prompts, 6)
    assert kern == plain
    assert counts["ragged_prefill_attention"] > 0
    assert counts["paged_decode_attention"] > 0


# ------------------------------------------------------------ flash attention
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa  # noqa: E402

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
# gradient rows below this share of the tensor's largest magnitude are held
# against it: dQ of a query that sees one key is exactly zero (its dS row
# sums to zero) and comes out as float32 noise ~4e-7 of the largest |dQ| on
# both sides; fp16 keys that only see p below 2^-14 carry subnormal P and dS
GRAD_ROW_FLOOR = 1e-2
FLASH_SHAPES = [
    dict(b=2, sq=128, skv=128, h=4, kvh=4, d=128),   # aligned MHA
    dict(b=1, sq=200, skv=200, h=4, kvh=2, d=64),    # unaligned, GQA 2
    dict(b=2, sq=96, skv=160, h=2, kvh=1, d=80),     # cross length, phi dim
    dict(b=1, sq=130, skv=130, h=6, kvh=3, d=96),    # neox head dim
    dict(b=1, sq=100, skv=100, h=2, kvh=2, d=256),   # largest head dim
    dict(b=1, sq=70, skv=70, h=4, kvh=2, d=16),      # tiny's head dim
]
FLASH_VARIANTS = ["causal", "non_causal", "segments", "alibi_window",
                  "positions"]


def _flash_case(dev, dtype, s, variant, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((s["b"], s["sq"], s["h"], s["d"]), generator=g)
    k = torch.randn((s["b"], s["skv"], s["kvh"], s["d"]), generator=g)
    v = torch.randn((s["b"], s["skv"], s["kvh"], s["d"]), generator=g)
    do = torch.randn(q.shape, generator=g)
    q, k, v, do = (t.to(dev, dtype) for t in (q, k, v, do))
    kw = {"causal": variant != "non_causal"}
    if variant == "segments" and s["sq"] == s["skv"]:
        kw["segment_ids"] = (torch.arange(s["sq"], device=dev)
                             * 3 // s["sq"])[None].expand(s["b"], -1)
    if variant == "alibi_window":
        kw.update(alibi=torch.from_numpy(alibi_slopes(s["h"])).to(dev),
                  window=max(1, s["skv"] // 3))
    if variant == "positions":
        # ragged shape: q tokens at the end of each kv context, with kv
        # segments marking a dead tail
        kw["q_positions"] = (torch.arange(s["sq"], device=dev) + s["skv"]
                             - s["sq"])[None].expand(s["b"], -1)
        kw["kv_positions"] = torch.arange(s["skv"], device=dev)[None].expand(
            s["b"], -1)
        kw["segment_ids"] = torch.zeros((s["b"], s["sq"]), device=dev)
        seg_k = torch.zeros((s["b"], s["skv"]), device=dev)
        seg_k[:, : s["skv"] // 5] = -1
        kw["kv_segment_ids"] = seg_k
    return q, k, v, do, fa.make_mask(q, k, **kw)


def _assert_close_scaled(got, want, tol, what):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _assert_rows_close(got, want, tol, what, floor=0.0):
    """Each row's (every index but the last) max abs error within ``tol``
    of that row's largest |want|, or of ``floor`` times the largest |want|
    where that is more: the few large rows do not set the limit for the many
    small ones. With no floor a row that is zero in want is zero in got."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    den = w.abs().amax(-1).clamp_min(max(1e-30,
                                         floor * float(w.abs().max())))
    err = float(((g - w).abs().amax(-1) / den).max())
    assert err <= tol, f"{what}: row-relative err {err} > {tol}"


def _hold_bwd_rows(q, k, v, do, mask, dtype, bias=None):
    """The dQ and dK/dV kernels row by row against the plain versions on
    the same inputs (LSE and delta of the plain forward). An end-to-end
    comparison is held by the largest magnitude only: there delta comes
    from each side's own O, and the forward's bf16 / fp16 rounding of P
    moves it by an ulp of O, which dQ rows of a peaked softmax (dQ much
    smaller than its terms) do not absorb."""
    o, lse = fa.flash_attention_fwd_reference(q, k, v, mask, bias)
    delta = fa.attention_delta(do, o)
    got = (fa.flash_dq(q, k, v, do, lse, delta, mask, bias=bias),
           *fa.flash_dkv(q, k, v, do, lse, delta, mask, bias=bias))
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, mask,
                                            bias=bias)
    for name, g, w in zip(("dq", "dk", "dv"), got, refs):
        _assert_rows_close(g, w, FLASH_TOL[dtype], name, floor=GRAD_ROW_FLOOR)


def _assert_grads_close(got, want, tol, what):
    """A gradient held both ways: by its largest magnitude and row by row
    (with ``GRAD_ROW_FLOOR``)."""
    _assert_close_scaled(got, want, tol, what)
    _assert_rows_close(got, want, tol, what, floor=GRAD_ROW_FLOOR)


@pytest.mark.parametrize("variant", FLASH_VARIANTS)
@pytest.mark.parametrize("shape", range(len(FLASH_SHAPES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernels_match_plain(dev, dtype, shape, variant):
    s = FLASH_SHAPES[shape]
    q, k, v, do, mask = _flash_case(dev, dtype, s, variant, seed=shape)
    tol = FLASH_TOL[dtype]
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask)
    assert o.dtype == dtype and lse.dtype == torch.float32
    _assert_close_scaled(o, o_ref, tol, "o")
    _assert_rows_close(o, o_ref, tol, "o")
    live = lse_ref > -1e29          # rows with something visible
    torch.testing.assert_close(lse[live], lse_ref[live], atol=1e-4,
                               rtol=1e-5)
    assert bool((lse[~live] < -1e29).all())
    delta = fa.attention_delta(do, o_ref)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, mask)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, mask)
    torch.cuda.synchronize()
    dq_ref, dk_ref, dv_ref = fa.flash_attention_bwd_reference(
        q, k, v, do, lse_ref, delta, mask)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        assert got.dtype == dtype
        _assert_grads_close(got, want, tol, name)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_dbias": 0}


def test_flash_never_writes_past_the_rows(dev):
    """Outputs written into views of NaN-filled buffers with spare rows:
    the spare rows stay NaN (the kernels mask the ragged edge)."""
    s = dict(b=2, sq=77, skv=77, h=4, kvh=2, d=64)
    q, k, v, do, mask = _flash_case(dev, torch.float32, s, "causal", 1)

    def spare(like):
        buf = torch.full((like.shape[0], like.shape[1] + 40) + like.shape[2:],
                         float("nan"), device=dev)
        return buf, buf[:, :like.shape[1]]

    ob, ov = spare(q)
    o, lse = fa.flash_fwd(q, k, v, mask, out=ov)
    delta = fa.attention_delta(do, o)
    qb, qv = spare(q)
    kb, kv = spare(k)
    vb, vv = spare(v)
    fa.flash_dq(q, k, v, do, lse, delta, mask, out=qv)
    fa.flash_dkv(q, k, v, do, lse, delta, mask, out=(kv, vv))
    torch.cuda.synchronize()
    for buf, n in ((ob, 77), (qb, 77), (kb, 77), (vb, 77)):
        assert bool(torch.isfinite(buf[:, :n]).all())
        assert bool(torch.isnan(buf[:, n:]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_dkv_gqa_is_the_group_sum(dev, dtype):
    """GQA dK/dV equal the MHA dK/dV of the repeated kv heads, summed over
    each group (float32 exactly to 1e-4; bf16 / fp16, where the MHA heads
    are rounded to the dtype before the sum, within the dtype's tolerance
    of the largest magnitude)."""
    s = dict(b=1, sq=150, skv=150, h=8, kvh=2, d=64)
    q, k, v, do, mask = _flash_case(dev, dtype, s, "causal", 2)
    o, lse = fa.flash_fwd(q, k, v, mask)
    delta = fa.attention_delta(do, o)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, mask)
    kr, vr = (t.repeat_interleave(4, dim=2) for t in (k, v))
    dk4, dv4 = fa.flash_dkv(q, kr, vr, do, lse, delta, mask)
    for got, per_head in ((dk, dk4), (dv, dv4)):
        want = per_head.float().reshape(1, 150, 2, 4, 64).sum(3)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            _assert_close_scaled(got, want, FLASH_TOL[dtype], "group sum")


def test_flash_reads_strided_views(dev):
    """q/k/v as views into one packed qkv buffer give the same bits as
    contiguous copies."""
    b, sq, h, kvh, d = 2, 90, 4, 2, 64
    g = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn((b, sq, h + 2 * kvh, d), generator=g).to(dev)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    mask = fa.make_mask(q, k)
    o1, l1 = fa.flash_fwd(q, k, v, mask)
    o2, l2 = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                          mask)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


# ------------------------------- the Hopper forward (bf16 / fp16, wgmma+TMA)
def test_flash_fwd_kernel_route(dev):
    """The library names the forward it launches: the Hopper kernel for
    bfloat16 and float16 at every head dim, the CUDA-core one for float32."""
    for d in (16, 128, 256):
        assert fa.kernel_name("fwd", torch.bfloat16, d) == \
            "flash_fwd_sm90_kernel"
        assert fa.kernel_name("fwd", torch.float16, d) == \
            "flash_fwd_sm90_kernel"
        assert fa.kernel_name("fwd", torch.float32, d) == "flash_fwd_kernel"


def test_flash_bwd_kernel_routes(dev):
    """dQ, dK/dV and the reducing dbias: the Hopper kernels for bfloat16
    and float16 at D <= 128, the CUDA-core ones at D = 256 and for float32;
    ``dbias_on_sm90`` (which sizes the dbias chunks) agrees with the
    library."""
    for kind in ("dq", "dkv", "dbias"):
        for dtype in (torch.bfloat16, torch.float16):
            for d in (16, 32, 64, 80, 128):
                assert fa.kernel_name(kind, dtype, d) == \
                    f"flash_{kind}_sm90_kernel"
            assert fa.kernel_name(kind, dtype, 256) == f"flash_{kind}_kernel"
        for d in (64, 128, 256):
            assert fa.kernel_name(kind, torch.float32, d) == \
                f"flash_{kind}_kernel"
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (32, 128, 256):
            assert fa.dbias_on_sm90(dtype, d) == (
                fa.kernel_name("dbias", dtype, d) == "flash_dbias_sm90_kernel")


def test_flash_fwd_bf16_is_bit_identical_on_repeat(dev):
    s = dict(b=2, sq=300, skv=300, h=4, kvh=2, d=128)
    q, k, v, _, mask = _flash_case(dev, torch.bfloat16, s, "causal", 11)
    o1, l1 = fa.flash_fwd(q, k, v, mask)
    o2, l2 = fa.flash_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_flash_reads_strided_views_bf16(dev):
    """bf16 q/k/v as views into one packed qkv buffer: TMA reads them in
    place (no copy) and gives the bits of contiguous copies."""
    b, sq, h, kvh, d = 2, 90, 4, 2, 64
    g = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn((b, sq, h + 2 * kvh, d), generator=g).to(
        dev, torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    mask = fa.make_mask(q, k)
    fa.reset_launch_counts()
    o1, l1 = fa.flash_fwd(q, k, v, mask)
    assert fa.COPIES == dict.fromkeys(fa.COPIES, 0)
    o2, l2 = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                          mask)
    torch.cuda.synchronize()
    assert fa.COPIES == dict.fromkeys(fa.COPIES, 0)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_flash_fwd_copies_a_misaligned_view(dev):
    """A q that starts one element into its buffer cannot be read by TMA:
    the wrapper copies it (one copy counted) and the result is the same."""
    s = dict(b=1, sq=150, skv=150, h=4, kvh=4, d=64)
    q, k, v, _, mask = _flash_case(dev, torch.bfloat16, s, "causal", 12)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    odd = flat[1:].view(q.shape)
    odd.copy_(q)
    assert not fa.tma_ready(odd)
    fa.reset_launch_counts()
    o1, l1 = fa.flash_fwd(odd, k, v, mask)
    assert fa.COPIES == {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0,
                         "flash_dbias": 0}
    o2, l2 = fa.flash_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.COPIES == {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0,
                         "flash_dbias": 0}
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def _hold_fwd(q, k, v, mask, dtype, out=None):
    o, lse = fa.flash_fwd(q, k, v, mask, out=out)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask)
    _assert_close_scaled(o, o_ref, FLASH_TOL[dtype], "o")
    _assert_rows_close(o, o_ref, FLASH_TOL[dtype], "o")
    live = lse_ref > -1e29
    torch.testing.assert_close(lse[live], lse_ref[live], atol=1e-4,
                               rtol=1e-5)
    assert bool((lse[~live] < -1e29).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_fwd_long_causal(dev, dtype):
    """S = 4096, causal, D = 128: 32 key tiles on the longest rows."""
    s = dict(b=1, sq=4096, skv=4096, h=2, kvh=2, d=128)
    q, k, v, _, mask = _flash_case(dev, dtype, s, "causal", 13)
    _hold_fwd(q, k, v, mask, dtype)


@pytest.mark.parametrize("variant", ["causal", "positions"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_fwd_cross_length_tail(dev, dtype, variant):
    """Sq != Skv, neither a multiple of 128 (causal offset 153, the last q
    tile half past Sq): the output lands in a view of a NaN-filled buffer
    whose spare rows stay NaN."""
    s = dict(b=2, sq=300, skv=453, h=4, kvh=2, d=128)
    q, k, v, _, mask = _flash_case(dev, dtype, s, variant, 14)
    buf = torch.full((2, 340, 4, 128), float("nan"), dtype=dtype,
                     device=dev)
    _hold_fwd(q, k, v, mask, dtype, out=buf[:, :300])
    assert bool(torch.isfinite(buf[:, :300]).all())
    assert bool(torch.isnan(buf[:, 300:]).all())


# ------------------------------ the Hopper backward (bf16 / fp16, wgmma+TMA)
def _hold_bwd(q, k, v, do, mask, dtype, out=(None, None, None)):
    o, lse = fa.flash_attention_fwd_reference(q, k, v, mask)
    delta = fa.attention_delta(do, o)
    dq = fa.flash_dq(q, k, v, do, lse, delta, mask, out=out[0])
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, mask, out=out[1:])
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, mask)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == dtype
        _assert_grads_close(got, want, FLASH_TOL[dtype], name)
    return dq, dk, dv


def _bwd(q, k, v, do, mask):
    o, lse = fa.flash_attention_fwd_reference(q, k, v, mask)
    delta = fa.attention_delta(do, o)
    return (fa.flash_dq(q, k, v, do, lse, delta, mask),
            *fa.flash_dkv(q, k, v, do, lse, delta, mask))


def test_flash_bwd_bf16_is_bit_identical_on_repeat(dev):
    """No atomics and sums in a fixed order: the same bits every run."""
    s = dict(b=2, sq=300, skv=300, h=4, kvh=2, d=128)
    q, k, v, do, mask = _flash_case(dev, torch.bfloat16, s, "causal", 15)
    r1, r2 = _bwd(q, k, v, do, mask), _bwd(q, k, v, do, mask)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_long_causal(dev, dtype):
    """S = 4096, causal, D = 128: 64 key tiles on the longest dQ rows, 64
    q tiles under key tile 0."""
    s = dict(b=1, sq=4096, skv=4096, h=2, kvh=2, d=128)
    q, k, v, do, mask = _flash_case(dev, dtype, s, "causal", 13)
    _hold_bwd(q, k, v, do, mask, dtype)


@pytest.mark.parametrize("variant", ["causal", "positions"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_cross_length_tail(dev, dtype, variant):
    """Sq != Skv, neither a multiple of 64 (causal offset 153): dQ, dK and
    dV land in views of NaN-filled buffers whose spare rows stay NaN."""
    s = dict(b=2, sq=300, skv=453, h=4, kvh=2, d=128)
    q, k, v, do, mask = _flash_case(dev, dtype, s, variant, 14)
    bufs = [torch.full((2, n + 40, hh, 128), float("nan"), dtype=dtype,
                       device=dev) for n, hh in ((300, 4), (453, 2), (453, 2))]
    views = [buf[:, :n] for buf, n in zip(bufs, (300, 453, 453))]
    _hold_bwd(q, k, v, do, mask, dtype, out=views)
    for buf, n in zip(bufs, (300, 453, 453)):
        assert bool(torch.isfinite(buf[:, :n]).all())
        assert bool(torch.isnan(buf[:, n:]).all())


def test_flash_bwd_reads_strided_views_bf16(dev):
    """bf16 q/k/v as views into one packed qkv buffer: the backward's TMA
    reads them in place (no copy) and gives the bits of contiguous copies."""
    b, sq, h, kvh, d = 2, 90, 4, 2, 64
    g = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn((b, sq, h + 2 * kvh, d), generator=g).to(
        dev, torch.bfloat16)
    do = torch.randn((b, sq, h, d), generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    mask = fa.make_mask(q, k)
    fa.reset_launch_counts()
    r1 = _bwd(q, k, v, do, mask)
    assert fa.COPIES == dict.fromkeys(fa.COPIES, 0)
    r2 = _bwd(q.contiguous(), k.contiguous(), v.contiguous(), do, mask)
    torch.cuda.synchronize()
    assert fa.COPIES == dict.fromkeys(fa.COPIES, 0)
    assert fa.LAUNCHES["flash_dq"] == 2 and fa.LAUNCHES["flash_dkv"] == 2
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))


def test_flash_bwd_copies_a_misaligned_view(dev):
    """A dO that starts one element into its buffer cannot be read by TMA:
    each backward wrapper copies it (one copy counted per wrapper) and the
    result is the same."""
    s = dict(b=1, sq=150, skv=150, h=4, kvh=4, d=64)
    q, k, v, do, mask = _flash_case(dev, torch.bfloat16, s, "causal", 12)
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device=dev)
    odd = flat[1:].view(do.shape)
    odd.copy_(do)
    assert not fa.tma_ready(odd)
    fa.reset_launch_counts()
    r1 = _bwd(q, k, v, odd, mask)
    assert fa.COPIES == {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 1,
                         "flash_dbias": 0}
    r2 = _bwd(q, k, v, do, mask)
    torch.cuda.synchronize()
    assert fa.COPIES == {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 1,
                         "flash_dbias": 0}
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_dkv_unseen_keys_are_zero(dev, dtype):
    """Keys no query sees get exact zeros in dK and dV, written by the
    kernel into NaN-filled outputs: keys 0-127, whose layout column is dead
    (their CTA walks no q tile), and keys 200-259, of a kv segment no query
    has (masked in every tile)."""
    b, sq, skv, h, d = 1, 256, 384, 2, 64
    g = torch.Generator(device="cpu").manual_seed(17)
    q, do = (torch.randn((b, sq, h, d), generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn((b, skv, h, d), generator=g).to(dev, dtype)
            for _ in range(2))
    lay = torch.ones((1, 2, 3), dtype=torch.int32)
    lay[:, :, 0] = 0
    seg_k = torch.zeros((b, skv), dtype=torch.int32)
    seg_k[:, 200:260] = 7
    mask = fa.make_mask(q, k, causal=False,
                        segment_ids=torch.zeros((b, sq), device=dev),
                        kv_segment_ids=seg_k.to(dev),
                        block_layout=lay.to(dev), block_q=128, block_k=128)
    bufs = [torch.full(k.shape, float("nan"), dtype=dtype, device=dev)
            for _ in range(2)]
    _, dk, dv = _hold_bwd(q, k, v, do, mask, dtype, out=(None, *bufs))
    dead = torch.zeros(skv, dtype=torch.bool)
    dead[:128] = dead[200:260] = True
    for t in (dk, dv):
        assert bool((t[:, dead.to(dev)] == 0).all())
        assert bool(torch.isfinite(t).all())
        assert float(t[:, ~dead.to(dev)].abs().max()) > 0


def test_flash_autograd_matches_plain_attention(dev):
    from deepspeedsyclsupport_tpu_torch.models.layers import (
        reference_attention)

    s = dict(b=2, sq=100, skv=100, h=4, kvh=2, d=64)
    q, k, v, do, _ = _flash_case(dev, torch.float32, s, "causal", 4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launch_counts()
    out = fa.flash_attention(*leaves, window=37)
    (out * do).sum().backward()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                           "flash_dbias": 0}
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    (reference_attention(*ref, window=37) * do).sum().backward()
    torch.testing.assert_close(out, reference_attention(q, k, v, window=37),
                               atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=2e-4, rtol=2e-4)


def test_flash_rejects_what_it_does_not_take(dev):
    s = dict(b=1, sq=16, skv=16, h=2, kvh=2, d=32)
    q, k, v, _, mask = _flash_case(dev, torch.float32, s, "causal", 0)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.double(), k.double(), v.double(), mask)
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.half(), v, mask)
    with pytest.raises(ValueError, match="innermost"):
        fa.flash_fwd(q.transpose(1, 3), k, v, mask)
    big = torch.zeros((1, 16, 2, 512), device=dev)
    with pytest.raises(ValueError, match="256"):
        fa.flash_fwd(big, big, big, fa.make_mask(big, big))


def test_engine_trains_through_flash_kernels(dev):
    """The training engine on the card: the kernels' loss and grad norm
    equal the plain path's, and every micro-batch launches each kernel once
    per layer (twice for the forward with activation checkpointing)."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize

    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0}
    g = torch.Generator(device="cpu").manual_seed(0)
    batch = {"input_ids": torch.randint(0, 512, (4, 64), generator=g)}
    runs = {}
    for name, impl, extra in (("flash", "flash", {}), ("xla", "xla", {}),
                              ("remat", "flash", {"activation_checkpointing":
                                                  {}})):
        model = build_model("tiny", dtype="float32", attn_impl=impl)
        params = model.init_params(
            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        eng, *_ = initialize(model=model, params=params,
                             config=dict(cfg, **extra), device=dev)
        fa.reset_launch_counts()
        m = [eng.train_batch(batch) for _ in range(2)]
        runs[name] = ([(float(x["loss"]), float(x["grad_norm"])) for x in m],
                      dict(fa.LAUNCHES))
    layers = 2
    assert runs["flash"][1] == {"flash_fwd": 2 * 2 * layers,
                                "flash_dq": 2 * 2 * layers,
                                "flash_dkv": 2 * 2 * layers,
                                "flash_dbias": 0}
    assert runs["remat"][1]["flash_fwd"] == 2 * 2 * 2 * layers
    assert runs["xla"][1] == dict.fromkeys(fa.LAUNCHES, 0)
    assert runs["remat"][0] == runs["flash"][0]
    np.testing.assert_allclose(runs["flash"][0], runs["xla"][0], rtol=1e-4)


@pytest.mark.parametrize("prec", ["bf16", "fp16"])
def test_engine_half_precision_through_flash_kernels(dev, prec):
    """bf16 and fp16 engine configs train through the kernels in the
    compute dtype; the loss stays within 2e-2 of the plain path's and the
    fp32 masters move."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize

    dtype = {"bf16": "bfloat16", "fp16": "float16"}[prec]
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           prec: {"enabled": True, "initial_scale_power": 8}}
    g = torch.Generator(device="cpu").manual_seed(5)
    batch = {"input_ids": torch.randint(0, 512, (2, 96), generator=g)}
    losses = {}
    for impl in ("flash", "xla"):
        model = build_model("tiny", dtype=dtype, attn_impl=impl)
        params = model.init_params(
            generator=torch.Generator(device=dev).manual_seed(2), device=dev)
        eng, *_ = initialize(model=model, params=params, config=cfg,
                             device=dev)
        before = [t.detach().clone() for t in eng._leaf_tensors]
        fa.reset_launch_counts()
        m = [eng.train_batch(batch) for _ in range(3)]
        assert all(bool(x["finite"]) for x in m)
        losses[impl] = [float(x["loss"]) for x in m]
        if impl == "flash":
            assert fa.LAUNCHES["flash_dkv"] == 3 * 2
        assert any(not torch.equal(b, t) for b, t in
                   zip(before, eng._leaf_tensors))
        assert all(t.dtype == torch.float32 for t in eng._leaf_tensors)
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=2e-2)


def test_flash_empty_sequences(dev):
    """No keys: o is 0 and lse -1e30 (nothing visible); no queries: dK/dV
    are 0. Nothing is launched."""
    q = torch.randn((1, 5, 2, 32), device=dev)
    none = torch.zeros((1, 0, 2, 32), device=dev)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, none, none, fa.make_mask(q, none, causal=False))
    assert float(o.abs().max()) == 0.0 and float(lse.max()) <= -1e29
    k = torch.randn((1, 7, 2, 32), device=dev)
    rows = torch.zeros((1, 2, 0), device=dev)
    dk, dv = fa.flash_dkv(none, k, k, none, rows, rows,
                          fa.make_mask(none, k, causal=False))
    assert float(dk.abs().max()) == 0.0 and float(dv.abs().max()) == 0.0
    assert fa.LAUNCHES == dict.fromkeys(fa.LAUNCHES, 0)


# ------------------------------------------- biases, layouts and the dbias
# The pair bias, the k-row bias and block layouts through the forward, dQ
# (with its full-shape dbias output) and dK/dV kernels, and the reducing
# dbias kernel for a broadcast pair bias. dbias is float32 on both sides and
# held relative to its largest magnitude, at the dtype's tolerance (the
# kernels' scores come from inputs of that dtype in another summation order).
BIAS_SHAPES = [
    dict(b=6, sq=96, skv=96, h=4, kvh=4, d=32),      # evoformer head dim
    dict(b=2, sq=130, skv=130, h=8, kvh=2, d=64),    # unaligned, GQA 4
    dict(b=2, sq=64, skv=200, h=4, kvh=4, d=128),    # cross length
    dict(b=1, sq=70, skv=70, h=2, kvh=2, d=256),     # 32 x 32 dbias tiles
]
BIAS_VARIANTS = ["full", "bcast_batch", "bcast_heads", "kbias",
                 "alibi_causal", "layout16", "layout64", "layout128",
                 "neg_inf_rows"]


def _bias_case(dev, dtype, s, variant, seed):
    """q, k, v, dO, the mask (k-row bias and layout inside) and the float32
    pair bias (or None) of one case."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, sq, skv, h = s["b"], s["sq"], s["skv"], s["h"]
    q = torch.randn((b, sq, h, s["d"]), generator=g)
    k = torch.randn((b, skv, s["kvh"], s["d"]), generator=g)
    v = torch.randn((b, skv, s["kvh"], s["d"]), generator=g)
    do = torch.randn(q.shape, generator=g)
    q, k, v, do = (t.to(dev, dtype) for t in (q, k, v, do))
    bb, hb = b, h
    if variant in ("bcast_batch", "neg_inf_rows"):
        bb = 2 if b % 2 == 0 and b > 2 else 1
    if variant == "bcast_heads":
        hb = 1
    bias = None if variant == "kbias" else torch.randn(
        (bb, hb, sq, skv), generator=g).to(dev)
    kw = {"causal": variant == "alibi_causal"}
    if variant in ("kbias", "alibi_causal", "neg_inf_rows"):
        kb = 0.5 * torch.randn((2 if b % 2 == 0 else 1, skv), generator=g)
        kb[torch.rand(kb.shape, generator=g) < 0.2] = -1e9
        if variant == "neg_inf_rows":
            kb[0] = float("-inf")      # every key of batch 0's rows
        kw["k_bias"] = kb.to(dev)
    if variant == "alibi_causal":
        kw["alibi"] = torch.from_numpy(alibi_slopes(h)).to(dev)
    if variant.startswith("layout"):
        blk = int(variant[6:])
        bq, bk = (min(blk, -(-n // 128) * 128) for n in (sq, skv))
        lay = (torch.rand((h, -(-sq // bq), -(-skv // bk)), generator=g)
               < 0.5).to(torch.int32)
        lay[:, 1::3] = 0               # some row blocks see nothing
        kw.update(block_layout=lay.to(dev), block_q=blk, block_k=blk)
    return q, k, v, do, fa.make_mask(q, k, **kw), bias


@pytest.mark.parametrize("variant", BIAS_VARIANTS)
@pytest.mark.parametrize("shape", range(len(BIAS_SHAPES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_bias_kernels_match_plain(dev, dtype, shape, variant):
    s = BIAS_SHAPES[shape]
    q, k, v, do, mask, bias = _bias_case(dev, dtype, s, variant, seed=shape)
    tol = FLASH_TOL[dtype]
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, mask, bias=bias)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask, bias)
    _assert_close_scaled(o, o_ref, tol, "o")
    live = lse_ref > -1e29
    torch.testing.assert_close(lse[live], lse_ref[live], atol=1e-4,
                               rtol=1e-5)
    assert bool((lse[~live] < -1e29).all())
    if variant == "neg_inf_rows":
        assert bool((~live).any())     # the case has rows that see nothing
    if bool((~live).any()):
        assert float(o.float()[~live.transpose(1, 2)].abs().max()) == 0.0
    delta = fa.attention_delta(do, o_ref)
    dq, dk, dv, dbias = fa.flash_attention_bwd(q, k, v, do, lse_ref, delta,
                                               mask, bias)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse_ref, delta,
                                            mask, bias=bias)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == dtype
        _assert_grads_close(got, want, tol, name)
    if bias is not None:
        want = fa.flash_dbias_reference(q, k, v, do, lse_ref, delta, mask,
                                        bias)
        assert dbias.dtype == torch.float32 and dbias.shape == bias.shape
        _assert_close_scaled(dbias, want, tol, "dbias")
    broadcast = bias is not None and fa.is_broadcast(bias, q)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
        "flash_dbias": int(broadcast)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_dbias_kernels_are_deterministic(dev, dtype):
    """The reducing kernels (the Hopper one in bf16 / fp16, the CUDA-core
    one in float32) and the dQ kernel's dbias output give the same bits on
    every run (no atomics); the reducing kernel's over several replica
    chunks too, at an evoformer-like shape."""
    s = BIAS_SHAPES[0]
    q, k, v, do, mask, bias = _bias_case(dev, dtype, s, "bcast_batch",
                                         seed=7)
    o, lse = fa.flash_fwd(q, k, v, mask, bias=bias)
    delta = fa.attention_delta(do, o)
    args = (q, k, v, do, lse, delta, mask)
    r1, r2 = (fa.flash_dbias(*args, bias) for _ in range(2))
    full = bias.repeat_interleave(q.shape[0] // bias.shape[0], 0)
    full = full.contiguous()
    f1, f2 = (torch.empty((s["b"], s["h"], s["sq"], s["skv"]), device=dev)
              for _ in range(2))
    fa.flash_dq(*args, bias=full, dbias=f1)
    fa.flash_dq(*args, bias=full, dbias=f2)
    g = torch.Generator(device="cpu").manual_seed(8)
    qe, ke, ve, de = (torch.randn((64, 96, 4, 32), generator=g).to(dev, dtype)
                      for _ in range(4))
    pair = torch.randn((1, 4, 96, 96), generator=g).to(dev)
    me = fa.make_mask(qe, ke, causal=False)
    oe, le = fa.flash_fwd(qe, ke, ve, me, bias=pair)
    eargs = (qe, ke, ve, de, le, fa.attention_delta(de, oe), me)
    assert fa.dbias_chunks(qe, ke, pair) > 1
    e1, e2 = (fa.flash_dbias(*eargs, pair) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(r1, r2) and torch.equal(f1, f2)
    assert torch.equal(e1, e2)


def test_broadcast_dbias_is_the_sum_of_the_full_one(dev):
    """The reducing kernel's dbias equals the dQ kernel's full-shape dbias
    of the same bias expanded to every (batch, head), summed over the
    batches b // (B / Bb) and heads h // (H / Hb) that share each entry."""
    b, h, s = 6, 4, 96
    g = torch.Generator(device="cpu").manual_seed(8)
    q, do = (torch.randn((b, s, h, 32), generator=g).to(dev)
             for _ in range(2))
    k, v = (torch.randn((b, s, 2, 32), generator=g).to(dev)
            for _ in range(2))
    bias = torch.randn((2, 2, s, s), generator=g).to(dev)
    full = bias.repeat_interleave(3, 0).repeat_interleave(2, 1).contiguous()
    mask = fa.make_mask(q, k, causal=False)
    o, lse = fa.flash_fwd(q, k, v, mask, bias=bias)
    delta = fa.attention_delta(do, o)
    reduced = fa.flash_dbias(q, k, v, do, lse, delta, mask, bias)
    per = torch.empty((b, h, s, s), device=dev)
    fa.flash_dq(q, k, v, do, lse, delta, mask, bias=full, dbias=per)
    _assert_close_scaled(reduced,
                         per.reshape(2, 3, 2, 2, s, s).sum(dim=(1, 3)),
                         1e-5, "reduced vs summed full dbias")
    # one replica per entry: the reducing kernel runs one chunk, no sum pass
    assert fa.dbias_chunks(q, k, full) == 1
    _assert_close_scaled(fa.flash_dbias(q, k, v, do, lse, delta, mask, full),
                         per, 1e-5, "reducing kernel on a full-shape bias")


# flash_dbias_sm90_kernel (bf16 / fp16 at D <= 128): the broadcast pair
# bias's gradient against the plain version at the dtype's tolerance of the
# largest |dbias| and row by row (each row over its largest |dbias|, at least
# GRAD_ROW_FLOOR of the largest), one launch per call
DBIAS_SM90_CASES = {
    # evoformer-like: mask bias and a pair bias broadcast over the batch
    "evoformer": (dict(b=4, s=96, h=4, kvh=4), (1, 4),
                  dict(causal=False, kbias=True)),
    "ragged_70": (dict(b=4, s=70, h=4, kvh=4), (1, 4),
                  dict(causal=False, kbias=True)),
    "heads_broadcast": (dict(b=2, s=96, h=8, kvh=4), (2, 2),
                        dict(causal=False)),
    "alibi": (dict(b=3, s=96, h=4, kvh=2), (1, 4),
              dict(causal=True, alibi=True)),
    "causal_window_ragged": (dict(b=2, s=200, h=2, kvh=2), (1, 1),
                             dict(causal=True, window=50)),
}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", sorted(DBIAS_SM90_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dbias_sm90_matches_plain(dev, dtype, case, d):
    shape, (bb, hb), kw = DBIAS_SM90_CASES[case]
    b, s, h, kvh = shape["b"], shape["s"], shape["h"], shape["kvh"]
    g = torch.Generator(device="cpu").manual_seed(sorted(
        DBIAS_SM90_CASES).index(case) + d)
    q, do = (torch.randn((b, s, h, d), generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn((b, s, kvh, d), generator=g).to(dev, dtype)
            for _ in range(2))
    bias = torch.randn((bb, hb, s, s), generator=g).to(dev)
    mkw = dict(causal=kw["causal"], window=kw.get("window"))
    if kw.get("kbias"):
        kb = torch.where(torch.rand((b, s), generator=g) < 0.1, -1e9, 0.0)
        mkw["k_bias"] = kb.to(dev)
    if kw.get("alibi"):
        mkw["alibi"] = torch.from_numpy(alibi_slopes(h)).to(dev)
    mask = fa.make_mask(q, k, **mkw)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, mask, bias)
    delta = fa.attention_delta(do, o)
    args = (q, k, v, do, lse, delta, mask)
    assert fa.kernel_name("dbias", dtype, d) == "flash_dbias_sm90_kernel"
    before = fa.LAUNCHES["flash_dbias"]
    got = fa.flash_dbias(*args, bias)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_dbias"] == before + 1
    want = fa.flash_dbias_reference(*args, bias)
    assert got.dtype == torch.float32 and got.shape == bias.shape
    _assert_close_scaled(got, want, FLASH_TOL[dtype], "dbias")
    _assert_rows_close(got, want, FLASH_TOL[dtype], "dbias",
                       floor=GRAD_ROW_FLOOR)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_evoformer_through_kernels(dev, dtype):
    """``DS4Sci_EvoformerAttention`` forward + backward on the card: one
    launch of each kernel (the reducing dbias kernel for the pair bias), and
    the output and grads of the same call on the CPU's plain versions."""
    from deepspeedsyclsupport_tpu_torch.ops import DS4Sci_EvoformerAttention

    b, n, s, h, d = 1, 5, 100, 4, 32
    g = torch.Generator(device="cpu").manual_seed(9)
    q, k, v, w = (torch.randn((b, n, s, h, d), generator=g).to(dtype)
                  for _ in range(4))
    mask_bias = torch.where(torch.rand((b, n, 1, 1, s), generator=g) > 0.1,
                            0.0, -1e9)
    pair = torch.randn((b, 1, h, s, s), generator=g).to(dtype)
    results = {}
    for where in ("cuda", "cpu"):
        leaves = [t.to(where).requires_grad_() for t in (q, k, v, pair)]
        fa.reset_launch_counts()
        out = DS4Sci_EvoformerAttention(*leaves[:3],
                                        [mask_bias.to(where), leaves[3]])
        (out.float() * w.to(where).float()).sum().backward()
        torch.cuda.synchronize()
        results[where] = (out, [t.grad for t in leaves], dict(fa.LAUNCHES))
    assert results["cuda"][2] == {"flash_fwd": 1, "flash_dq": 1,
                                  "flash_dkv": 1, "flash_dbias": 1}
    assert results["cpu"][2] == dict.fromkeys(fa.LAUNCHES, 0)
    tol = FLASH_TOL[dtype]
    _assert_close_scaled(results["cuda"][0].cpu(), results["cpu"][0], tol,
                         "out")
    for name, got, want in zip(("dq", "dk", "dv", "dpair"),
                               results["cuda"][1], results["cpu"][1]):
        assert got.dtype == want.dtype and got.shape == want.shape
        _assert_close_scaled(got.cpu(), want, tol, name)
    # the backward kernels row by row on the inputs the op gives them
    qf, kf, vf, dof = (t.to(dev).reshape(b * n, s, h, d) for t in (q, k, v, w))
    _hold_bwd_rows(qf, kf, vf, dof, fa.make_mask(
        qf, kf, causal=False, k_bias=mask_bias.to(dev).reshape(b * n, s)),
        dtype, bias=fa.check_bias(pair.to(dev)[:, 0], qf, kf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("block", [16, 64, 128])
def test_sparse_attention_through_kernels(dev, block, dtype):
    """BigBird block-sparse attention on the card against the same call on
    the CPU; the layout never launches the dbias kernel."""
    from deepspeedsyclsupport_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, sparse_attention)

    cfg = BigBirdSparsityConfig(4, block, different_layout_per_head=True,
                                num_random_blocks=1)
    g = torch.Generator(device="cpu").manual_seed(block)
    q, k, v, w = (torch.randn((2, 256, 4, 64), generator=g).to(dtype)
                  for _ in range(4))
    results = {}
    for where in ("cuda", "cpu"):
        leaves = [t.to(where).requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        out = sparse_attention(*leaves, cfg, causal=True)
        (out * w.to(where)).sum().backward()
        torch.cuda.synchronize()
        results[where] = ([out] + [t.grad for t in leaves],
                          dict(fa.LAUNCHES))
    assert results["cuda"][1] == {"flash_fwd": 1, "flash_dq": 1,
                                  "flash_dkv": 1, "flash_dbias": 0}
    tol = FLASH_TOL[dtype]
    for name, got, want in zip(("out", "dq", "dk", "dv"), results["cuda"][0],
                               results["cpu"][0]):
        _assert_close_scaled(got.cpu(), want, tol, name)
    # the backward kernels row by row on the inputs the op gives them
    layout = torch.from_numpy(cfg.make_layout(256, causal=True))
    qd, kd, vd, wd = (t.to(dev) for t in (q, k, v, w))
    _hold_bwd_rows(qd, kd, vd, wd, fa.make_mask(
        qd, kd, causal=True, block_layout=layout.to(dev), block_q=block,
        block_k=block), dtype)


def test_flash_bias_rejects_what_it_does_not_take(dev):
    s = dict(b=2, sq=32, skv=32, h=2, kvh=2, d=32)
    q, k, v, do, mask, bias = _bias_case(dev, torch.float32, s, "full", 0)
    with pytest.raises(TypeError, match="bias"):
        fa.flash_fwd(q, k, v, mask, bias=bias.double())
    with pytest.raises(TypeError, match="bias"):
        fa.flash_fwd(q, k, v, mask, bias=bias.transpose(2, 3))
    with pytest.raises(ValueError, match="bias shape"):
        fa.flash_fwd(q, k, v, mask, bias=bias[:, :, :16].contiguous())
    o, lse = fa.flash_fwd(q, k, v, mask, bias=bias)
    delta = fa.attention_delta(do, o)
    with pytest.raises(ValueError, match="dbias"):
        fa.flash_dq(q, k, v, do, lse, delta, mask, bias=bias,
                    dbias=torch.empty((2, 2, 32, 16), device=dev))
    lay_mask = fa.make_mask(q, k, block_layout=torch.ones(
        (1, 1, 1), dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError, match="BROADCAST"):
        fa.flash_dbias(q, k, v, do, lse, delta, lay_mask, bias[:1])
    wide = torch.zeros((65536, 1, 1, 8), device=dev)
    with pytest.raises(ValueError, match="65535"):
        fa.flash_fwd(wide, wide, wide, fa.make_mask(wide, wide))


# --------------------------------------------- serving decode as CUDA graphs
def _graph_decode_case(dev, dtype=torch.float32, s=4, bps=8, bs=8):
    """A tiny model, a random paged pool of ``s`` slots and the inputs of
    one fused decode dispatch (live, idle and short-budget slots)."""
    from deepspeedsyclsupport_tpu_torch import build_model
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        RaggedInferenceConfig, init_blocked_kv)

    model = build_model("tiny", dtype="float32" if dtype == torch.float32
                        else "bfloat16")
    params = model.init_params(
        generator=torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=dtype)
    kv = init_blocked_kv(model.config, RaggedInferenceConfig(
        dtype=dtype, block_size=bs, max_context=bps * bs, max_sequences=s,
        num_blocks=s * bps), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    kv.k.copy_(torch.randn(kv.k.shape, generator=g, device=dev))
    kv.v.copy_(torch.randn(kv.v.shape, generator=g, device=dev))
    inputs = dict(
        logits0=torch.randn((s, model.config.vocab_size), generator=g,
                            device=dev),
        positions=np.array([5, 17, 0, 30], np.int32),
        tables=np.arange(s * bps, dtype=np.int32).reshape(s, bps),
        active=np.array([True, True, False, True]),
        steps_left=np.array([3, 1, 0, 5], np.int32),
        temperature=np.asarray(1.0, np.float32),
        top_p=np.asarray(1.0, np.float32), eos=np.asarray(-1, np.int32))
    idle = dict(inputs, positions=np.zeros(s, np.int32),
                active=np.zeros(s, bool), steps_left=np.zeros(s, np.int32),
                logits0=torch.zeros_like(inputs["logits0"]))
    return model, params, kv, inputs, idle


def _multi_body(model, params, kv, struct, generator=None, k=4, bs=8,
                max_context=64):
    from deepspeedsyclsupport_tpu_torch.inference.v2.model import (
        decode_multi_forward)

    def body(logits0, positions, tables, active, steps_left, temperature,
             top_p, eos):
        buf, logits, pos, act, sl, _ = decode_multi_forward(
            model, params, kv, logits0, positions, tables, active,
            steps_left, generator, temperature, top_p, eos, block_size=bs,
            num_steps=k, samp_struct=struct, max_context=max_context,
            attn_impl="kernel")
        return buf, logits, pos, act, sl
    return body


def test_fused_decode_graph_equals_eager_bit_for_bit(dev):
    """One capture of ``decode_multi_forward`` (4 steps, greedy) replayed
    gives the eager body's tokens, logits, positions, retirements and KV
    pool (the sink block aside) bit for bit, and counts its launches per
    replay, none for the capture."""
    from deepspeedsyclsupport_tpu_torch.inference.v2.graphs import (
        DecodeRunner)
    from deepspeedsyclsupport_tpu_torch.inference.v2.kv_cache import BlockedKV

    model, params, kv, inputs, idle = _graph_decode_case(dev)
    kv2 = BlockedKV(kv.k.clone(), kv.v.clone())
    struct = (False, 0, False)
    eager = DecodeRunner(_multi_body(model, params, kv, struct), idle,
                         torch.device("cpu"))
    want = eager(**{n: (torch.from_numpy(x).to(dev)
                        if isinstance(x, np.ndarray) else x)
                    for n, x in inputs.items()})
    pa.reset_launch_counts()
    runner = DecodeRunner(_multi_body(model, params, kv2, struct), idle, dev)
    layers = model.config.num_layers
    assert runner.graph is not None
    assert runner.launches[0] == {"paged_decode_attention": 4 * layers}
    warm = dict(pa.LAUNCHES)          # the warm-up run's launches only
    assert warm["paged_decode_attention"] == 4 * layers
    got = runner(**inputs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode_attention"] == 8 * layers
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sink = kv.num_slots - 8
    assert torch.equal(kv2.k[:, :sink], kv.k[:, :sink])
    assert torch.equal(kv2.v[:, :sink], kv.v[:, :sink])
    runner(**inputs)
    assert pa.LAUNCHES["paged_decode_attention"] == 12 * layers


def test_sampled_fused_decode_draws_anew_on_each_replay(dev):
    """The engine's generator is registered with the graph: two replays
    of a sampled body on the same inputs (flat logits) draw other tokens,
    and the generator's state moves on."""
    from deepspeedsyclsupport_tpu_torch.inference.v2.graphs import (
        DecodeRunner)

    model, params, kv, inputs, idle = _graph_decode_case(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    inputs = dict(inputs, logits0=torch.zeros_like(inputs["logits0"]),
                  active=np.ones(4, bool), steps_left=np.full(4, 9, np.int32),
                  positions=np.array([5, 17, 3, 30], np.int32))
    runner = DecodeRunner(_multi_body(model, params, kv, (True, 0, False),
                                      gen), idle, dev, generator=gen)
    first = runner(**inputs)[0].clone()
    state = gen.get_state()
    second = runner(**inputs)[0].clone()
    assert not torch.equal(first, second)
    assert not torch.equal(state, gen.get_state())
    assert bool((first >= 0).all()) and bool((second >= 0).all())


def test_runners_leave_no_memory_behind(dev):
    """Runners captured and dropped one after another leave the card's
    allocation where the first left it: their warm-ups share one stream,
    so cuBLAS keeps one workspace (MiBs) and not one for each capture."""
    import gc

    from deepspeedsyclsupport_tpu_torch.inference.v2.graphs import (
        DecodeRunner)

    model, params, kv, inputs, idle = _graph_decode_case(dev)
    left = []
    for _ in range(5):
        body = _multi_body(model, params, kv, (False, 0, False))
        runner = DecodeRunner(body, idle, dev)
        runner(**inputs)
        torch.cuda.synchronize()
        del runner
        gc.collect()
        left.append(torch.cuda.memory_allocated())
    assert max(left[1:]) - left[0] < 2**20, left


def test_engine_fused_decode_replays_graphs(dev):
    """The engine on the card: warmup captures the per-token decode graph
    and every fused rung; fused (K = 8) and per-token generate give the
    plain path's greedy tokens; decode launches are counted per replay and
    host dispatches fall by the fusion."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    model = build_model("tiny", dtype="float32")
    params = model.init_params(device=dev)
    kw = dict(dtype=torch.float32, block_size=8, max_context=64,
              max_tokens_per_batch=16, max_sequences=4)
    prompts = [[7, 3, 11], [4, 100, 42, 8, 19], list(range(30, 52)), [9]]
    plain = InferenceEngineV2(model, params, prefill_attn="xla",
                              decode_attn="xla", **kw).generate(prompts, 12)
    per_tok = InferenceEngineV2(model, params, **kw)
    per_tok.warmup()
    assert per_tok._decode_runner.graph is not None
    fused = InferenceEngineV2(model, params, decode_steps_per_dispatch=8,
                              **kw)
    fused.warmup(fused_ladder=True)
    assert [key[0] for key in fused._decode_multi] == [8, 4, 2]
    assert all(r.graph is not None for r in fused._decode_multi.values())
    assert not fused.seqs and fused.host_dispatches == 0
    assert fused.allocator.free_blocks == fused.config.num_blocks
    pa.reset_launch_counts()
    assert fused.generate(prompts, 12) == plain
    replayed = pa.LAUNCHES["paged_decode_attention"]
    assert replayed >= 8 * model.config.num_layers
    assert per_tok.generate(prompts, 12) == plain
    assert fused.host_dispatches < per_tok.host_dispatches // 2


def test_engine_flash_prefill_on_the_card(dev):
    """``prefill_attn="flash"`` runs the flash forward kernel on the
    serving path and serves the kernel path's greedy tokens."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    model = build_model("tiny", dtype="float32")
    params = model.init_params(device=dev)
    kw = dict(dtype=torch.float32, block_size=8, max_context=64,
              max_tokens_per_batch=16, max_sequences=4)
    prompts = [[7, 3, 11], [4, 100, 42, 8, 19], list(range(30, 52)), [9]]
    want = InferenceEngineV2(model, params, **kw).generate(prompts, 6)
    fa.reset_launch_counts()
    got = InferenceEngineV2(model, params, prefill_attn="flash",
                            **kw).generate(prompts, 6)
    assert got == want
    assert fa.LAUNCHES["flash_fwd"] > 0


def test_capture_failure_raises(dev, monkeypatch):
    """A decode body that reads a value back to the host cannot be
    captured: the engine raises and never serves that body eagerly."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.inference.v2 import engine_v2

    real = engine_v2.decode_multi_forward

    def host_reading(*args, **kwargs):
        out = real(*args, **kwargs)
        int(out[0].sum())          # a host read: refused under capture
        return out

    monkeypatch.setattr(engine_v2, "decode_multi_forward", host_reading)
    model = build_model("tiny", dtype="float32")
    params = model.init_params(device=dev)
    eng = InferenceEngineV2(model, params, dtype=torch.float32, block_size=8,
                            max_context=64, max_tokens_per_batch=16,
                            max_sequences=4, decode_steps_per_dispatch=4)
    with pytest.raises(RuntimeError):
        eng.generate([[7, 3, 11]], 8)
    assert not eng._decode_multi
    torch.cuda.synchronize()


# ------------------------------------------ MoE serving, quantized weights
def _moe_case(dev, dtype, t=24, d=64, f=128, e=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn(d, e, generator=g),
         "w_gate": torch.randn(e, d, f, generator=g) * 0.1,
         "w_up": torch.randn(e, d, f, generator=g) * 0.1,
         "w_down": torch.randn(e, f, d, generator=g) * 0.1}
    x = torch.randn(t, d, generator=g)
    return ({n: v.to(dev, dtype) for n, v in p.items()}, x.to(dev, dtype))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_card_route_matches_plain(dev, dtype, k, monkeypatch):
    """``moe_mlp_nodrop`` on the card takes the grouped-GEMM route in bf16
    and the plain version otherwise; the grouped route agrees with the plain
    version row by row (TOL), also under a skewed routing where expert 0
    takes every token and expert 7 none."""
    from deepspeedsyclsupport_tpu_torch.models import get_config
    from deepspeedsyclsupport_tpu_torch.parallel import moe

    cfg = get_config("tiny-moe", num_experts=8, num_experts_per_tok=k)
    p, x = _moe_case(dev, dtype)
    taken = []
    for name in ("experts_grouped", "experts_plain"):
        real = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda *a, _r=real, _n=name:
                            taken.append(_n) or _r(*a))
    got = moe.moe_mlp_nodrop(p, x, cfg)
    assert taken == ["experts_grouped" if dtype == torch.bfloat16
                     else "experts_plain"]
    gate, experts = moe.topk_route(x, p["router"], k)
    act = moe._activation("silu")
    want = moe.experts_plain(p, x, gate, experts, act)
    if dtype != torch.bfloat16:
        assert torch.equal(got, want)
        return
    _hold_paged(got, want, dtype, "MoE")
    skew = torch.stack([torch.zeros(24, dtype=torch.long, device=dev),
                        1 + torch.arange(24, device=dev) % 6], 1)[:, :k]
    _hold_paged(moe.experts_grouped(p, x, gate, skew, act),
                moe.experts_plain(p, x, gate, skew, act), dtype, "MoE skew")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_route_in_a_cuda_graph(dev, dtype):
    """The MoE routes read nothing back to the host: captured once, a
    replay on new tokens gives the eager route's bits."""
    from deepspeedsyclsupport_tpu_torch.models import get_config
    from deepspeedsyclsupport_tpu_torch.parallel import moe

    cfg = get_config("tiny-moe", num_experts=8)
    p, x = _moe_case(dev, dtype)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_mlp_nodrop(p, static, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe_mlp_nodrop(p, static, cfg)
    x2 = _moe_case(dev, dtype, seed=1)[1]
    static.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, moe.moe_mlp_nodrop(p, x2, cfg))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_on_the_card_is_bit_exact(dev, bits, dtype):
    """Codes and scales made on the card equal the CPU's, and dequantizing
    on the card gives the CPU's bits (one float32 product, one rounding)."""
    from deepspeedsyclsupport_tpu_torch.compression.quantize import (
        quantize_leaf)

    w = torch.randn(256, 448, generator=torch.Generator().manual_seed(3))
    cpu = quantize_leaf(w, 64, bits=bits)
    card = quantize_leaf(w.to(dev), 64, bits=bits)
    assert torch.equal(card.q.cpu(), cpu.q)
    assert torch.equal(card.scale.cpu(), cpu.scale)
    assert torch.equal(card.dequantize(dtype).cpu(), cpu.dequantize(dtype))


def test_engine_serves_quantized_moe_on_the_card(dev):
    """An int8 MoE model on the card: the kernel engine (per-token decode
    as CUDA graph replays) gives the plain engine's greedy tokens in
    float32; in bf16 the grouped route serves through the per-token decode
    graph and through the fused rungs (K = 4), with equal tokens."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    model = build_model("tiny-moe", dtype="float32", num_experts=8)
    params = model.init_params(device=dev)
    kw = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
              max_sequences=4, quantize_weights=True)
    prompts = [[7, 3, 11], [4, 100, 42, 8, 19], list(range(30, 52)), [9]]
    plain = InferenceEngineV2(model, params, dtype=torch.float32,
                              prefill_attn="xla", decode_attn="xla",
                              **kw).generate(prompts, 8)
    pa.reset_launch_counts()
    eng = InferenceEngineV2(model, params, dtype=torch.float32, **kw)
    assert eng.generate(prompts, 8) == plain
    assert eng._decode_runner.graph is not None
    assert pa.LAUNCHES["paged_decode_attention"] >= 7 * model.config.num_layers
    bf_model = build_model("tiny-moe", num_experts=8)
    bf = InferenceEngineV2(bf_model, params, dtype=torch.bfloat16, **kw)
    bf.warmup()
    out = bf.generate(prompts, 8)
    assert bf._decode_runner.graph is not None
    assert all(len(o) == 8 for o in out)
    fused = InferenceEngineV2(bf_model, params, dtype=torch.bfloat16,
                              decode_steps_per_dispatch=4, **kw)
    fused.warmup(fused_ladder=True)
    assert all(r.graph is not None for r in fused._decode_multi.values())
    assert fused.generate(prompts, 8) == out


# ----------------------------------------------------- serving plane, snapshot
def _llama_cut(dev, dtype, layers, seed):
    from deepspeedsyclsupport_tpu_torch import build_model

    model = build_model("llama2-7b", num_layers=layers,
                        dtype="float32" if dtype == torch.float32
                        else "bfloat16")
    params = model.init_params(
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev,
        dtype=dtype)
    return model, params


def test_session_tokens_equal_generate_on_the_card(dev):
    """``ServingSession`` (fused K = 8 after ``warmup(fused_ladder=True)``,
    graph replays) at llama2-7b width cut to 4 layers, float32: each
    request's greedy tokens equal ``generate`` of its prompt alone."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        ServingPolicyConfig, ServingSession)

    model, params = _llama_cut(dev, torch.float32, 4, 1)
    eng = InferenceEngineV2(model, params, dtype=torch.float32,
                            block_size=64, max_context=1024, max_sequences=8,
                            decode_steps_per_dispatch=8, device=dev)
    eng.warmup(fused_ladder=True)
    rng = np.random.RandomState(0)
    reqs = [(u, rng.randint(1, 32000, rng.randint(64, 300)).tolist(),
             int(rng.randint(8, 25))) for u in range(6)]
    sess = ServingSession(eng, ServingPolicyConfig())
    got = {}
    for u, p, n in reqs:
        sess.submit(u, p, n)
    while not sess.idle:
        for e in sess.step():
            if e.kind == "token":
                got.setdefault(e.uid, []).extend(e.tokens)
    assert sess.counters["completed"] == len(reqs)
    for u, p, n in reqs:
        assert got[u] == eng.generate([p], max_new_tokens=n)[0], u


def test_snapshot_round_trip_on_the_card(dev, tmp_path):
    """``serialize`` then ``deserialize(device="cuda")`` at llama2-7b width
    cut to 2 layers, bf16: prefill logits bit-equal, greedy tokens equal,
    every parameter equal bit for bit."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2

    model, params = _llama_cut(dev, torch.bfloat16, 2, 2)
    eng = InferenceEngineV2(model, params, dtype=torch.bfloat16,
                            block_size=64, max_context=1024, max_sequences=4,
                            device=dev)
    eng.serialize(str(tmp_path / "snap"))
    eng2 = InferenceEngineV2.deserialize(str(tmp_path / "snap"), device=dev)
    assert eng2.device.type == "cuda"
    for a, b in zip(eng.params["layers"], eng2.params["layers"]):
        for k in a["attn"]:
            assert torch.equal(a["attn"][k], b["attn"][k]), k
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 32000, n).tolist() for n in (77, 300)]
    logits = []
    for e in (eng, eng2):
        out = e.put([0, 1], prompts)
        logits.append(torch.stack([out[0], out[1]]))
        e.flush([0, 1])
    assert torch.equal(logits[0], logits[1])
    assert eng.generate(prompts, max_new_tokens=8) == \
        eng2.generate(prompts, max_new_tokens=8)


# ------------------------------------------------ checkpoints and the sentinel
def test_async_checkpoint_copies_card_tensors_before_return(dev, tmp_path):
    """The async engine's ``save`` returns after a device -> pinned host
    copy it waited for: updating the card tensors in place right after (as
    the optimizer does) leaves the saved bytes those of the step saved."""
    from deepspeedsyclsupport_tpu_torch.checkpoint import ckpt_engine as ce
    from deepspeedsyclsupport_tpu_torch.checkpoint.engine import load_tree
    from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
        configure_fault_injection)

    w = torch.randn(1 << 22, device=dev)
    h = torch.randn(64, 64, device=dev).to(torch.bfloat16)
    want = (w.cpu().clone(), h.cpu().clone())
    configure_fault_injection({"async_delay": 0.3})
    try:
        eng = ce.build_checkpoint_engine("async")
        eng.save(str(tmp_path / "t"), {"w": w, "h": lambda: h * 1},
                 {"global_steps": 1})
        w.add_(1.0)
        h.mul_(2)
        eng.wait()
    finally:
        configure_fault_injection(None)
    got, _ = load_tree(str(tmp_path / "t"), {
        "w": torch.empty(w.shape, device="meta"),
        "h": torch.empty(h.shape, dtype=torch.bfloat16, device="meta")},
        device=dev)
    assert got["w"].device.type == dev.type
    assert torch.equal(got["w"].cpu(), want[0])
    assert torch.equal(got["h"].cpu(), want[1])


def test_dataloader_pins_and_copies_to_the_card(dev):
    from deepspeedsyclsupport_tpu_torch.runtime.dataloader import (
        CheckpointableDataLoader, DSTpuDataLoader)

    rng = np.random.RandomState(0)
    data = [{"ids": rng.randint(0, 9, (2, 8)), "x": rng.randn(2, 4)}
            for _ in range(5)]
    for loader in (DSTpuDataLoader(data, dev, prefetch=2),
                   CheckpointableDataLoader(data, dev, shuffle=True, seed=1)):
        order = loader._order(0) if hasattr(loader, "_order") else range(5)
        for i, b in zip(order, loader):
            assert b["ids"].device.type == dev.type
            np.testing.assert_array_equal(b["ids"].cpu().numpy(),
                                          data[i]["ids"])
            np.testing.assert_array_equal(b["x"].cpu().numpy(), data[i]["x"])


def test_sentinel_gate_on_the_card(dev, tmp_path):
    """A NaN step is discarded on the card (params and the optimizer
    state bit-unchanged) and journaled as a skip; an armed clean run equals
    an unarmed one bit for bit; a save / load round trip resumes bit for
    bit."""
    import json

    from deepspeedsyclsupport_tpu_torch import build_model, initialize
    from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
        configure_fault_injection)

    def engine(extra):
        model = build_model("tiny", dtype="bfloat16", attn_impl="xla")
        params = model.init_params(
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        cfg = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
               "gradient_clipping": 1.0, **extra}
        return initialize(model=model, params=params, config=cfg,
                          device=dev)[0]

    rng = np.random.RandomState(1)
    batches = [{"input_ids": rng.randint(0, 512, (2, 64)),
                "loss_mask": np.ones((2, 64), np.float32)} for _ in range(4)]
    sentinel = {"sentinel": {"enabled": True,
                             "journal_dir": str(tmp_path / "j")}}
    plain, armed = engine({}), engine(sentinel)
    for b in batches:
        assert float(plain.train_batch(b)["loss"]) == float(
            armed.train_batch(b)["loss"])
    armed.save_checkpoint(str(tmp_path / "ckpt"))
    fresh = engine(sentinel)
    fresh.load_checkpoint(str(tmp_path / "ckpt"))
    for a, b in zip(armed._leaf_tensors, fresh._leaf_tensors):
        assert torch.equal(a, b)
    configure_fault_injection({"nan_step": {"rank": 0, "step": 6}})
    try:
        assert float(armed.train_batch(batches[0])["loss"]) == float(
            fresh.train_batch(batches[0])["loss"])
        before = [t.detach().clone() for t in fresh._leaf_tensors]
        mu = [t.clone() for t in fresh.optimizer.mu]
        m = fresh.train_batch(batches[1])       # step 6: NaN
        for a, b in zip(before, fresh._leaf_tensors):
            assert torch.equal(a, b.detach())
        for a, b in zip(mu, fresh.optimizer.mu):
            assert torch.equal(a, b)
        fresh.train_batch(batches[2])           # its verdict (lag 1)
    finally:
        configure_fault_injection(None)
    assert not bool(m["finite"]) and int(m["health_nonfinite"]) > 0
    assert fresh.optimizer.count == 6 and fresh.skipped_steps == 1
    lines = (tmp_path / "j" / "health_journal_rank0.jsonl").read_text()
    skips = [json.loads(x) for x in lines.splitlines()
             if json.loads(x)["event"] == "skip"]
    assert [(r["step"], r["cause"]) for r in skips] == [(6, "nonfinite")]


# ------------------------------------------- lse-returning flash attention
LSE_CASES = {
    "causal_gqa": dict(b=2, s=192, h=4, kvh=2, d=64, kw=dict(causal=True)),
    # a ring block: queries at 256-447 against keys at 352-543, so query
    # rows 0-95 see no key and keys 96-191 no query
    "ring_block": dict(b=1, s=192, h=4, kvh=4, d=128, q0=256, k0=352,
                       kw=dict(causal=True)),
    "pair_bias": dict(b=6, s=96, h=4, kvh=4, d=32, kw=dict(causal=False),
                      bias=(1, 4)),
}


@pytest.mark.parametrize("case", sorted(LSE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_lse_matches_plain(dev, dtype, case):
    """``flash_attention(..., return_lse=True)`` through the kernels with a
    random dLSE: o and lse against the plain forward, the grads end to end
    by their largest magnitude, the dQ and dK/dV kernels (and the reducing
    dbias) on the plain forward's LSE and delta - dLSE also row by row; one
    launch of each kernel; exact -1e30 / 0 where nothing is visible."""
    c = LSE_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn((c["b"], c["s"], c["h"], c["d"]), generator=g)
    k, v = (torch.randn((c["b"], c["s"], c["kvh"], c["d"]), generator=g)
            for _ in range(2))
    do = torch.randn(q.shape, generator=g)
    dlse = torch.randn((c["b"], c["s"], c["h"]), generator=g).to(dev)
    q, k, v, do = (t.to(dev, dtype) for t in (q, k, v, do))
    kw = dict(c["kw"])
    if "q0" in c:
        ar = torch.arange(c["s"], device=dev)[None]
        kw["q_positions"] = ar + c["q0"]
        kw["kv_positions"] = ar + c["k0"]
    bias = None
    if "bias" in c:
        bias = (0.5 * torch.randn((*c["bias"], c["s"], c["s"]), generator=g)
                ).to(dev, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if bias is not None:
        leaves.append(bias.clone().requires_grad_())
        kw["bias"] = leaves[3]
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention(*leaves[:3], return_lse=True, **kw)
    grads = torch.autograd.grad((o, lse), leaves, (do, dlse))
    o, lse = o.detach(), lse.detach()
    torch.cuda.synchronize()
    got = {n: fa.LAUNCHES[n] - before[n] for n in before}
    assert got == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                   "flash_dbias": int(bias is not None)}
    mask = fa.make_mask(q, k, kw["causal"], None, None,
                        kw.get("q_positions"), kw.get("kv_positions"))
    b32 = None if bias is None else fa.check_bias(bias, q, k)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask, b32)
    tol = FLASH_TOL[dtype]
    _assert_close_scaled(o, o_ref, tol, "o")
    _assert_rows_close(o, o_ref, tol, "o")
    torch.testing.assert_close(lse, lse_ref.transpose(1, 2), atol=1e-4,
                               rtol=1e-5)
    delta = (fa.attention_delta(do, o_ref) - dlse.transpose(1, 2)
             ).contiguous()
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse_ref, delta,
                                            mask, bias=b32)
    if b32 is not None:
        refs = refs + (fa.flash_dbias_reference(q, k, v, do, lse_ref, delta,
                                                mask, b32),)
    for name, gr, ref in zip(("dq", "dk", "dv", "dbias"), grads, refs):
        _assert_close_scaled(gr, ref, tol, f"end-to-end {name}")
    kern = (fa.flash_dq(q, k, v, do, lse_ref, delta, mask, bias=b32),
            *fa.flash_dkv(q, k, v, do, lse_ref, delta, mask, bias=b32))
    for name, gr, ref in zip(("dq", "dk", "dv"), kern, refs):
        _assert_grads_close(gr, ref, tol, name)
    if b32 is not None:
        _assert_close_scaled(fa.flash_dbias(q, k, v, do, lse_ref, delta,
                                            mask, b32), refs[3], tol, "dbias")
    if "q0" in c:
        rows = keys = c["k0"] - c["q0"]
        assert bool((lse[:, :rows] == fa.NEG_INF).all())
        assert bool((o[:, :rows] == 0).all())
        assert bool((grads[0][:, :rows] == 0).all())
        assert bool((grads[1][:, -keys:] == 0).all())
        assert bool((grads[2][:, -keys:] == 0).all())


# ---------------------------------------------------------- MoE training
def test_moe_train_step_through_kernels_matches_plain(dev):
    """``tiny-moe`` in float32 through ``initialize`` -> ``train_batch``:
    the flash kernels (launches held a step) against the plain attention,
    loss 1e-4 and grad_norm 1e-3 relative over 3 steps (one on a repeated
    token, which drops rows at capacity); with remat bit-identical to
    itself."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize

    rng = np.random.RandomState(3)
    batches = [{"input_ids": rng.randint(0, 512, (2, 128))} for _ in range(3)]
    batches[1]["input_ids"][:] = 17
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0}
    runs = {}
    for name, impl, extra in (("kernel", "flash", {}), ("xla", "xla", {}),
                              ("remat", "flash",
                               {"activation_checkpointing": {}}),
                              ("remat2", "flash",
                               {"activation_checkpointing": {}})):
        model = build_model("tiny-moe", dtype="float32", attn_impl=impl)
        params = model.init_params(
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        eng = initialize(model=model, params=params,
                         config=dict(cfg, **extra), device=dev)[0]
        out = []
        for b in batches:
            before = dict(fa.LAUNCHES)
            m = eng.train_batch(b)
            got = {n: fa.LAUNCHES[n] - before[n] for n in before}
            layers = model.config.num_layers
            assert got == ({"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                            "flash_dbias": 0} if impl == "xla" else
                           {"flash_fwd": layers * (2 if extra else 1),
                            "flash_dq": layers, "flash_dkv": layers,
                            "flash_dbias": 0})
            out.append((float(m["loss"]), float(m["moe_aux_loss"]),
                        float(m["grad_norm"])))
        runs[name] = out
    for (kl, ka, kg), (xl, xa, xg) in zip(runs["kernel"], runs["xla"]):
        assert abs(kl - xl) <= 1e-4 * abs(xl)
        assert abs(ka - xa) <= 1e-4 * abs(xa)
        assert abs(kg - xg) <= 1e-3 * abs(xg)
    assert runs["remat"] == runs["remat2"]


# ------------------------------------------------------------- the fleet
def test_fleet_of_two_on_the_card_with_a_kill(dev, tmp_path):
    """Two in-process replicas (``tiny`` sessions, float32, decode as CUDA
    graphs) behind a ``FleetRouter``; replica 0 is killed mid-decode. Its
    in-flight streams replay on replica 1, whose graphs the kill leaves
    alone: the journals' outputs equal ``generate`` of each prompt, every
    stream closes once."""
    import os

    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        ServingPolicyConfig, ServingSession, journal_path, load_journal,
        reconstruct_outputs)
    from deepspeedsyclsupport_tpu_torch.inference.v2.fleet import (
        FleetConfig, FleetRequest, FleetRouter, LocalReplica)

    kw = dict(dtype=torch.float32, block_size=8, max_context=64,
              max_tokens_per_batch=16, max_sequences=4)
    model = build_model("tiny", dtype="float32")
    params = model.init_params(device=dev)
    reps, dirs = [], []
    for rid in ("0", "1"):
        jdir = str(tmp_path / f"replica{rid}")
        os.makedirs(jdir)
        dirs.append(jdir)
        sess = ServingSession(
            InferenceEngineV2(model, params, device=dev, **kw),
            ServingPolicyConfig(journal_path=journal_path(jdir, attempt=0)))
        reps.append(LocalReplica(rid, sess, journal_dir=jdir))
    router = FleetRouter(reps, FleetConfig(affinity="none"))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 500, n).tolist()
               for n in rng.randint(3, 20, 6)]
    for u, p in enumerate(prompts):
        assert router.submit(FleetRequest(uid=u, tokens=p,
                                          max_new_tokens=10))[0] == "routed"
    seen, polls = 0, 0
    while not router.idle:
        seen += sum(len(e.tokens) for e in router.poll() if e.kind == "token")
        polls += 1
        assert polls < 500
        if seen >= 12 and reps[0].ready():
            reps[0].kill()
    assert router.failover_counters["deaths"] == 1
    assert router.failover_counters["replays"] >= 1
    router.close()
    reps[1].close()
    states, _ = load_journal(dirs)
    eng = InferenceEngineV2(model, params, device=dev, **kw)
    assert reconstruct_outputs(states) == {
        u: eng.generate([p], max_new_tokens=10)[0]
        for u, p in enumerate(prompts)}
    assert all(st.closed for st in states.values())
