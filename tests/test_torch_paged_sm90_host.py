"""PyTorch port: what the CPU can check of the redesigned ragged paged
attention (``csrc/paged_attention.cu``).

* The two new routes' numerics, emulated here in torch:
  - ``paged_prefill_sm90_kernel`` (bfloat16 / float16 prefill): an online
    softmax over tiles of 64 KV positions with P as two operands of the
    dtype, hi + lo, in P V (the JAX kernel keeps P in float32) and O
    rounded to the dtype. Against the JAX kernel that O errs by one
    rounding to the dtype, half an ulp (2^-8 of the row's largest |O| in
    bf16, 2^-11 in fp16), as the plain algebra's does; P rounded to the
    dtype alone, the route's arithmetic before ROADMAP C2 was closed, errs
    more in every case;
  - ``paged_decode_split_kernel`` + ``paged_decode_combine_kernel`` (decode):
    float32 partials (m, l, acc) over fixed chunks of ``SPLIT_CHUNK``
    positions, folded in chunk order, O rounded to the dtype.
  Both are held against the JAX package's Pallas kernel in interpret mode
  (``ragged_prefill_attention_pallas`` / ``paged_decode_attention_pallas``)
  on the same inputs, rounded to the dtype and handed over in float32: O
  within 2e-2 (bf16) or 4e-3 (fp16) of the largest |O|, and row by row of
  each row's largest |O|, the card tests' tolerances. Rows with nothing
  visible (dead atoms, rows past qlen, dead slots) are exactly 0.
* That the row-by-row hold catches an emulation that leaves one KV tile
  out of P V, or one decode chunk out of the combine, where the hold by the
  largest |O| does not.
* The split route's plan (chunks, lane tiles, scratch size), which the
  wrapper computes from shapes alone, and that CPU tensors never launch.
The route each dtype and shape takes is the built library's answer, so its
test runs on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops import paged_attention as jpa
from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
from deepspeedsyclsupport_tpu_torch.ops import paged_attention as tpa

TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3}
TILE = 64                   # KV positions per tile of the prefill route
# one rounding of O to the dtype: half an ulp is at most 2^-8 (bf16, 8
# significant bits) or 2^-11 (fp16) of the row's largest |O|
ONE_ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def row_relative_err(got, want):
    """The largest over rows (every index but the last) of the row's max
    abs error over the row's largest |want|; a row that is zero in want
    must be zero in got."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    ratio = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)
    return float(ratio.max())


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _scores(q, k, tables, pos0, qlen, bs, alibi, window):
    """Scores of every lane over every table position, float32, as the
    kernels form them: lanes [A, KVH, BQ * G] (lane r * G + gi is q row r,
    head kh * G + gi), positions [C = Bps * block_size]; masked ones -inf."""
    a, bq, h, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    c = tables.shape[1] * bs
    j = torch.arange(c)
    slot = tables.long()[:, j // bs] * bs + j % bs               # [A, C]
    ql = q.float().reshape(a, bq, kvh, g, d).permute(0, 2, 1, 3, 4).reshape(
        a, kvh, bq * g, d)
    s = torch.einsum("akld,ackd->aklc", ql, k[slot].float()) / np.sqrt(d)
    lane = torch.arange(bq * g)
    row = lane // g
    qpos = pos0.long()[:, None, None, None] + row[None, None, :, None]
    jj = j[None, None, None, :]
    if alibi is not None:
        slope = alibi.float().reshape(kvh, g)[:, lane % g]       # [KVH, L]
        s = s + slope[None, :, :, None] * (jj - qpos).float()
    ok = (jj <= qpos) & (row[None, None, :, None] < qlen.long()[:, None, None,
                                                               None])
    if window is not None:
        ok = ok & (qpos - jj < window)
    return torch.where(ok, s, torch.full_like(s, float("-inf"))), slot


def _lanes_to_rows(x, bq, h):
    """[A, KVH, BQ * G, D] lanes back to [A, BQ, H, D]."""
    a, kvh, _, d = x.shape
    return x.reshape(a, kvh, bq, h // kvh, d).permute(0, 2, 1, 3, 4).reshape(
        a, bq, h, d)


def emulate_prefill(q, k, v, tables, pos0, qlen, bs, alibi=None,
                    window=None, p_mode=None, skip_tile=None):
    """``paged_prefill_sm90_kernel``'s arithmetic: online softmax over tiles
    of 64 positions (m from -1e30, alpha = exp(m_old - m_new), l summed from
    the unrounded p), O += P V, O / max(l, 1e-30) in q's dtype. ``p_mode``:
    how P reaches P V, as two operands of q's dtype hi = T(p) and lo = T(p -
    hi) (``"split"``, the route's arithmetic), one operand T(p)
    (``"round"``, its arithmetic before ROADMAP C2 was closed) or float32
    (None, the plain version's algebra). ``skip_tile``: the index of a tile
    left out of P V, as a faulty kernel would (l and m still count it)."""
    a, bq, h, d = q.shape
    s, slot = _scores(q, k, tables, pos0, qlen, bs, alibi, window)
    vs = v[slot].float()                                          # [A,C,KVH,D]
    m = torch.full(s.shape[:3] + (1,), tpa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:3] + (d,))
    for t, j0 in enumerate(range(0, s.shape[-1], TILE)):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pr = p
        if p_mode is not None:
            pr = p.to(q.dtype).float()
            if p_mode == "split":
                pr = pr + (p - pr).to(q.dtype).float()
        if t == skip_tile:
            pr = torch.zeros_like(pr)
        acc = acc * alpha + torch.einsum("aklc,ackd->akld", pr,
                                         vs[:, j0:j0 + TILE])
        m = m_new
    return _lanes_to_rows(acc / l.clamp_min(1e-30), bq, h).to(q.dtype)


def emulate_split_decode(q, k, v, tables, seq_lens, bs, alibi=None,
                         window=None, drop_chunk=None):
    """``paged_decode_split_kernel`` + ``paged_decode_combine_kernel``:
    per chunk of ``SPLIT_CHUNK`` positions a float32 partial (m, l, acc =
    sum p V with p = exp(s - m)), folded in chunk order (M = max m_c, l =
    sum l_c exp(m_c - M), acc likewise), O = acc / max(l, 1e-30) in q's
    dtype. ``drop_chunk``: a chunk whose P V a faulty combine leaves out
    (its l still counted)."""
    seq_lens = seq_lens.to(torch.int32)
    pos0 = torch.clamp(seq_lens - 1, min=0)
    qlen = (seq_lens > 0).to(torch.int32)
    qa = q[:, None]
    s, slot = _scores(qa, k, tables, pos0, qlen, bs, alibi, window)
    vs = v[slot].float()
    parts = []
    for j0 in range(0, s.shape[-1], tpa.SPLIT_CHUNK):
        st = s[..., j0:j0 + tpa.SPLIT_CHUNK]
        m_c = torch.clamp(st.amax(-1, keepdim=True), min=tpa.NEG_INF)
        p = torch.exp(st - m_c)
        parts.append((m_c, p.sum(-1, keepdim=True),
                      torch.einsum("aklc,ackd->akld", p,
                                   vs[:, j0:j0 + tpa.SPLIT_CHUNK])))
    mm = torch.stack([m_c for m_c, _, _ in parts]).amax(0)
    l = torch.zeros_like(mm)
    acc = torch.zeros_like(parts[0][2])
    for c, (m_c, l_c, a_c) in enumerate(parts):
        e = torch.exp(m_c - mm)
        l = l + l_c * e
        if c != drop_chunk:
            acc = acc + a_c * e
    return _lanes_to_rows(acc / l.clamp_min(1e-30), 1, q.shape[1])[:, 0].to(
        q.dtype)


# name -> atoms (pos0, qlen), shape; every case ends with a dead atom
PREFILL_CASES = {
    "mha_bs64": dict(pos0=(0, 100, 200, 0), qlen=(32, 32, 17, 0), h=2,
                     kvh=2, d=32, bs=64, bps=4, bq=32),
    "gqa4_bs8_window": dict(pos0=(0, 60, 150, 0), qlen=(16, 16, 9, 0), h=4,
                            kvh=1, d=16, bs=8, bps=24, bq=16, window=50),
    "gqa2_bs16_alibi": dict(pos0=(5, 90, 0), qlen=(24, 24, 0), h=4, kvh=2,
                            d=32, bs=16, bps=8, bq=24, alibi=True),
    "bs128_alibi_window": dict(pos0=(0, 130, 240, 0), qlen=(16, 16, 16, 0),
                               h=2, kvh=2, d=32, bs=128, bps=2, bq=16,
                               alibi=True, window=70),
}


def _prefill_inputs(name, dtype):
    c = PREFILL_CASES[name]
    rng = np.random.RandomState(sorted(PREFILL_CASES).index(name))
    a, bq, h, kvh, d = len(c["pos0"]), c["bq"], c["h"], c["kvh"], c["d"]
    slots = (c["bps"] * a + 2) * c["bs"]
    # the inputs both sides see: rounded to the kernel's dtype
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
               for s in ((a, bq, h, d), (slots, kvh, d), (slots, kvh, d)))
    tables = torch.from_numpy(rng.permutation(slots // c["bs"])[
        :a * c["bps"]].reshape(a, c["bps"]).astype(np.int32))
    pos0 = torch.tensor(c["pos0"], dtype=torch.int32)
    qlen = torch.tensor(c["qlen"], dtype=torch.int32)
    kw = dict(window=c.get("window"),
              alibi=torch.from_numpy(alibi_slopes(h)) if c.get("alibi")
              else None)
    return (q, k, v, tables, pos0, qlen), c["bs"], kw


def _jnp(t):
    return jnp.asarray(t.float().numpy() if t.is_floating_point()
                       else t.numpy())


def _hold(o, want, dtype):
    lim = TOL[dtype] * max(1.0, float(want.abs().max()))
    assert max_err(o, want) <= lim, f"O: max abs err > {lim}"
    err = row_relative_err(o, want)
    assert err <= TOL[dtype], f"O: row-relative err {err} > {TOL[dtype]}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_route_fits_the_card_tolerance(name, dtype):
    args, bs, kw = _prefill_inputs(name, dtype)
    want = torch.from_numpy(np.array(jpa.ragged_prefill_attention_pallas(
        *(_jnp(t) for t in args), block_size=bs, interpret=True,
        alibi=None if kw["alibi"] is None else _jnp(kw["alibi"]),
        window=kw["window"])))
    o = emulate_prefill(*args, bs, p_mode="split", **kw)
    assert o.dtype == dtype
    _hold(o, want, dtype)
    rows = torch.arange(args[0].shape[1])[None, :]
    pad = rows >= args[5].long()[:, None]
    assert bool((o[pad] == 0).all()) and bool((want[pad] == 0).all())
    # without the rounding the emulation is the plain version's algebra
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    torch.testing.assert_close(
        emulate_prefill(*f32, bs, **kw),
        tpa.ragged_prefill_attention_reference(*f32, block_size=bs, **kw),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_split_p_errs_by_one_rounding_of_o(name, dtype):
    """ROADMAP C2 on the prefill route: against the JAX Pallas
    ``_prefill_kernel`` in interpret mode (P in float32), the split
    arithmetic's O errs row by row within one rounding of O to the dtype
    (``ONE_ROUNDING``), as the plain algebra does; P rounded to the dtype
    (the route before the fix) exceeds it."""
    args, bs, kw = _prefill_inputs(name, dtype)
    want = torch.from_numpy(np.array(jpa.ragged_prefill_attention_pallas(
        *(_jnp(t) for t in args), block_size=bs, interpret=True,
        alibi=None if kw["alibi"] is None else _jnp(kw["alibi"]),
        window=kw["window"])))
    lim = ONE_ROUNDING[dtype]
    err = {mode: row_relative_err(emulate_prefill(*args, bs, p_mode=mode,
                                                  **kw), want)
           for mode in (None, "split", "round")}
    assert err[None] <= lim and err["split"] <= lim, err
    assert err["round"] > lim, err


# name -> (seq_lens, h, kvh, d, block_size, bps, window, alibi)
DECODE_CASES = {
    "mha_bs64": ((0, 1, 255, 256, 257, 600, 767, 768), 4, 4, 32, 64, 12,
                 None, False),
    "gqa4_bs8_window": ((700, 0, 33, 512, 513, 640), 8, 2, 16, 8, 80, 300,
                        False),
    "gqa2_bs16_alibi": ((1, 300, 0, 520, 700), 4, 2, 32, 16, 48, None, True),
}


def _decode_inputs(name, dtype):
    lens, h, kvh, d, bs, bps, window, alibi = DECODE_CASES[name]
    rng = np.random.RandomState(10 + sorted(DECODE_CASES).index(name))
    n = len(lens)
    slots = (bps * n + 2) * bs
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
               for s in ((n, h, d), (slots, kvh, d), (slots, kvh, d)))
    tables = torch.from_numpy(rng.permutation(slots // bs)[:n * bps].reshape(
        n, bps).astype(np.int32))
    kw = dict(window=window,
              alibi=torch.from_numpy(alibi_slopes(h)) if alibi else None)
    return (q, k, v, tables, torch.tensor(lens, dtype=torch.int32)), bs, kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_split_decode_fits_the_card_tolerance(name, dtype):
    args, bs, kw = _decode_inputs(name, dtype)
    want = torch.from_numpy(np.array(jpa.paged_decode_attention_pallas(
        *(_jnp(t) for t in args), block_size=bs, interpret=True,
        alibi=None if kw["alibi"] is None else _jnp(kw["alibi"]),
        window=kw["window"])))
    o = emulate_split_decode(*args, bs, **kw)
    assert o.dtype == dtype
    _hold(o, want, dtype)
    dead = args[4] == 0
    assert bool((o[dead] == 0).all()) and bool((want[dead] == 0).all())
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    torch.testing.assert_close(
        emulate_split_decode(*f32, bs, **kw),
        tpa.paged_decode_attention_reference(*f32, block_size=bs, **kw),
        atol=2e-5, rtol=2e-5)


def test_row_hold_catches_a_dropped_kv_tile():
    """bf16, llama-like head dim: an atom at the start of its sequence
    (rows of large |O|) beside an atom at positions 1920-2047 of a
    2048-token context. A kernel that leaves that atom's last KV tile out
    of P V errs only on its rows past 1983, whose |O| is far below the first
    atom's: the hold by the largest |O| lets it pass, the row-by-row hold
    does not, and passes the sound kernel's numerics."""
    dtype = torch.bfloat16
    g = torch.Generator().manual_seed(7)
    bs, bps, slots = 64, 32, 64 * 64
    q = torch.randn((2, 128, 2, 128), generator=g).to(dtype)
    k, v = (torch.randn((slots, 2, 128), generator=g).to(dtype)
            for _ in range(2))
    tables = torch.stack([torch.arange(bps), torch.arange(bps, 2 * bps)]).to(
        torch.int32)
    pos0 = torch.tensor([0, 1920], dtype=torch.int32)
    qlen = torch.tensor([128, 128], dtype=torch.int32)
    args = (q, k, v, tables, pos0, qlen, bs)
    want = tpa.ragged_prefill_attention_reference(*args[:6], block_size=bs)
    tol = TOL[dtype]
    lim = tol * max(1.0, float(want.float().abs().max()))
    sound = emulate_prefill(*args, p_mode="split")
    faulty = emulate_prefill(*args, p_mode="split", skip_tile=31)
    assert max_err(faulty, want) <= lim
    assert row_relative_err(faulty, want) > 5 * tol
    assert row_relative_err(sound, want) <= tol


def test_row_hold_catches_a_dropped_decode_chunk():
    """bf16 decode: a one-token slot (|O| = |v|) beside a 2047-token one
    (eight chunks). A combine that leaves one chunk's P V out of the long
    slot passes the hold by the largest |O| and fails the row-by-row one;
    the sound combine passes both."""
    dtype = torch.bfloat16
    g = torch.Generator().manual_seed(8)
    bs, bps, slots = 64, 32, 64 * 64
    q = torch.randn((2, 4, 128), generator=g).to(dtype)
    k, v = (torch.randn((slots, 4, 128), generator=g).to(dtype)
            for _ in range(2))
    tables = torch.stack([torch.arange(bps), torch.arange(bps, 2 * bps)]).to(
        torch.int32)
    lens = torch.tensor([1, 2047], dtype=torch.int32)
    want = tpa.paged_decode_attention_reference(q, k, v, tables, lens,
                                                block_size=bs)
    tol = TOL[dtype]
    lim = tol * max(1.0, float(want.float().abs().max()))
    sound = emulate_split_decode(q, k, v, tables, lens, bs)
    faulty = emulate_split_decode(q, k, v, tables, lens, bs, drop_chunk=3)
    assert max_err(faulty, want) <= lim
    assert row_relative_err(faulty, want) > 5 * tol
    assert row_relative_err(sound, want) <= tol


# ------------------------------------------------------------- split plan
@pytest.mark.parametrize("d,lanes_per_tile", [(16, 16), (64, 16), (80, 8),
                                              (128, 8), (192, 4), (256, 4)])
def test_split_plan_lane_tiles(d, lanes_per_tile):
    """A CTA holds D / 32 columns of up to 1024 / DMAX lanes; fewer lanes
    than that make one tile of exactly those lanes."""
    for bq, h, kvh in ((1, 32, 32), (1, 32, 8), (1, 16, 1), (16, 4, 4),
                       (2, 8, 1)):
        lanes = bq * h // kvh
        nch, lt, ltiles, n = tpa.split_plan(3, bq, h, kvh, d, 10, 64)
        assert lt == min(lanes_per_tile, lanes)
        assert ltiles == -(-lanes // lt) and (ltiles - 1) * lt < lanes
        assert n == 3 * kvh * ltiles * nch * lt * (d + 2)


@pytest.mark.parametrize("bps,bs,nch", [(1, 8, 1), (32, 8, 1), (33, 8, 2),
                                        (32, 64, 8), (128, 64, 32),
                                        (3, 100, 2)])
def test_split_plan_chunks_follow_the_table_capacity(bps, bs, nch):
    """Chunks of SPLIT_CHUNK positions cover Bps * block_size: the grid
    follows shapes alone, never a sequence length read from the card."""
    assert tpa.SPLIT_CHUNK == 256
    assert tpa.split_plan(1, 1, 8, 8, 128, bps, bs)[0] == nch


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors both wrappers return the plain versions' results in
    any dtype, fp16 included, and count no launch."""
    args, bs, kw = _prefill_inputs("gqa2_bs16_alibi", torch.float16)
    tpa.reset_launch_counts()
    got = tpa.ragged_prefill_attention(*args, block_size=bs, **kw)
    assert torch.equal(got, tpa.ragged_prefill_attention_reference(
        *args, block_size=bs, **kw))
    dargs, dbs, dkw = _decode_inputs("mha_bs64", torch.float16)
    got = tpa.paged_decode_attention(*dargs, block_size=dbs, **dkw)
    assert got.dtype == torch.float16
    assert torch.equal(got, tpa.paged_decode_attention_reference(
        *dargs, block_size=dbs, **dkw))
    assert tpa.LAUNCHES == dict.fromkeys(tpa.LAUNCHES, 0)
