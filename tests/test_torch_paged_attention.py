"""PyTorch port: ragged paged attention against the JAX package.

The port's plain versions (which its wrappers take for CPU tensors) are
held against the JAX Pallas kernel in interpret mode and against the JAX
package's jnp references, on the cases of ``tests/unit/test_paged_attention
.py``: full, partial and dead atoms, GQA, a single block, ALiBi, window,
ALiBi with window, bf16, dead decode slots. Inputs are made with numpy from
a seed and handed to both packages.

Tolerances: 2e-5 in float32, as the JAX package's own kernel tests (both
sides sum in float32, in different orders). 2e-2 for bf16 outputs: both
compute in float32 and round the output to bf16 (8 bits of mantissa), so
one rounding step at |x| ~ 2 may differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.models.layers import alibi_slopes
from deepspeedsyclsupport_tpu.ops import paged_attention as jpa
from deepspeedsyclsupport_tpu_torch.ops import paged_attention as tpa

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _ragged_case(seed=0, bs=8, bps=6, kvh=2, h=4, d=32, bq=16,
                 pos0=(0, 13, 5, 40), qlen=(16, 9, 0, 7), num_slots=96):
    rng = np.random.RandomState(seed)
    return dict(
        q=rng.randn(len(pos0), bq, h, d).astype(np.float32),
        k=rng.randn(num_slots, kvh, d).astype(np.float32),
        v=rng.randn(num_slots, kvh, d).astype(np.float32),
        tables=rng.randint(0, num_slots // bs, (len(pos0), bps)).astype(
            np.int32),
        pos0=np.asarray(pos0, np.int32),
        qlen=np.minimum(np.asarray(qlen, np.int32), bq), bs=bs)


RAGGED_CASES = {
    # full / partial / dead atoms
    "full_partial_dead": dict(),
    # GQA with one kv head, a single block per table
    "gqa_single_block": dict(seed=3, kvh=1, h=4, bps=1, bq=8),
    "mha": dict(seed=4, kvh=4, h=4),
    "alibi": dict(seed=7, pos0=(0, 13, 5), qlen=(16, 9, 4), alibi=True),
    "window": dict(seed=7, pos0=(0, 13, 5), qlen=(16, 9, 4), window=6),
    "alibi_window": dict(seed=7, pos0=(0, 13, 5), qlen=(16, 9, 4),
                         alibi=True, window=9),
    # window far below the rows: the tile skips every block below it
    "window_skips_blocks": dict(seed=8, pos0=(30, 2, 41), qlen=(8, 16, 6),
                                window=3),
}


def _jax_ragged(c, dtype, impl, **kw):
    args = [jnp.asarray(c[n], dtype) for n in ("q", "k", "v")]
    args += [jnp.asarray(c[n]) for n in ("tables", "pos0", "qlen")]
    if impl == "pallas":
        return jpa.ragged_prefill_attention_pallas(
            *args, block_size=c["bs"], interpret=True, **kw)
    return jpa.ragged_prefill_attention_reference(*args, block_size=c["bs"],
                                                  **kw)


def _torch_ragged(c, dtype, **kw):
    args = [torch.from_numpy(c[n]).to(dtype) for n in ("q", "k", "v")]
    args += [torch.from_numpy(c[n]) for n in ("tables", "pos0", "qlen")]
    return tpa.ragged_prefill_attention(*args, block_size=c["bs"], **kw)


def _kw(spec, h, to):
    kw = {}
    if spec.get("alibi"):
        kw["alibi"] = to(alibi_slopes(h))
    if spec.get("window"):
        kw["window"] = spec["window"]
    return kw


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_prefill_plain_matches_jax(name):
    spec = dict(RAGGED_CASES[name])
    alibi, window = spec.pop("alibi", False), spec.pop("window", None)
    c = _ragged_case(**spec)
    h = c["q"].shape[2]
    kw_spec = dict(alibi=alibi, window=window)
    before = dict(tpa.LAUNCHES)
    got = _torch_ragged(c, torch.float32,
                        **_kw(kw_spec, h, torch.from_numpy)).numpy()
    assert tpa.LAUNCHES == before   # CPU tensors never reach the kernel
    for impl in ("pallas", "reference"):
        want = np.asarray(_jax_ragged(c, jnp.float32, impl,
                                      **_kw(kw_spec, h, jnp.asarray)))
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=impl)
    # dead atoms and rows past qlen are exact zeros
    for a, ql in enumerate(c["qlen"]):
        assert np.abs(got[a, ql:]).max(initial=0.0) == 0.0


def test_ragged_prefill_bf16_matches_jax():
    c = _ragged_case(seed=5)
    got = _torch_ragged(c, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax_ragged(c, jnp.bfloat16, "pallas")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def _decode_case(seed, s=3, h=8, kvh=4, d=32, bs=16, bps=4, seq_lens=None):
    rng = np.random.RandomState(seed)
    num_blocks = s * bps + 2
    tables = rng.permutation(num_blocks)[:s * bps].reshape(s, bps)
    lens = (seq_lens if seq_lens is not None else [bs * bps, bs + 3, 1])[:s]
    return dict(q=rng.randn(s, h, d).astype(np.float32),
                k=rng.randn(num_blocks * bs, kvh, d).astype(np.float32),
                v=rng.randn(num_blocks * bs, kvh, d).astype(np.float32),
                tables=tables.astype(np.int32),
                lens=np.asarray(lens, np.int32), bs=bs)


DECODE_CASES = {
    "mixed_lens": dict(seed=0, seq_lens=[64, 19, 1]),
    "equal_lens": dict(seed=0, seq_lens=[5, 5, 5]),
    "full_lens": dict(seed=0, seq_lens=[64, 64, 64]),
    "mha": dict(seed=1, h=4, kvh=4),
    "dead_slot": dict(seed=2, s=4, h=4, kvh=2, bs=8, seq_lens=[17, 1, 0, 30]),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_jax(name, dtype):
    c = _decode_case(**DECODE_CASES[name])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(c[n], jdt) for n in ("q", "k", "v")] + [
        jnp.asarray(c["tables"]), jnp.asarray(c["lens"])]
    targs = [torch.from_numpy(c[n]).to(tdt) for n in ("q", "k", "v")] + [
        torch.from_numpy(c["tables"]), torch.from_numpy(c["lens"])]
    got = tpa.paged_decode_attention(*targs, block_size=c["bs"])
    ref = tpa.paged_decode_attention_reference(*targs, block_size=c["bs"])
    assert torch.equal(got, ref)    # the CPU wrapper IS the plain version
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (jpa.paged_decode_attention_pallas(
                     *jargs, block_size=c["bs"], interpret=True),
                 jpa.paged_decode_attention_reference(
                     *jargs, block_size=c["bs"])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    dead = np.flatnonzero(c["lens"] == 0)
    if dead.size:
        assert float(got[dead].abs().max()) == 0.0


def test_decode_with_alibi_and_window_matches_jax():
    c = _decode_case(3, s=4, h=8, kvh=2, bs=8, seq_lens=[17, 1, 0, 30])
    sl = alibi_slopes(8)
    jargs = [jnp.asarray(c[n]) for n in ("q", "k", "v", "tables", "lens")]
    targs = [torch.from_numpy(c[n]) for n in ("q", "k", "v", "tables",
                                              "lens")]
    got = tpa.paged_decode_attention(*targs, block_size=8,
                                     alibi=torch.from_numpy(sl), window=5)
    want = jpa.paged_decode_attention_pallas(
        *jargs, block_size=8, alibi=jnp.asarray(sl), window=5,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
