"""PyTorch port on the card: the CUDA ragged paged-attention kernel against
its plain version over many small shapes, its input checks, and the engine
through the kernel. Marked ``cuda``: they skip where there is no card.

This file imports no JAX (the card's machine has none), so on the card it
runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 1e-4 in float32 (kernel and plain version both sum in float32,
in different orders, over contexts of a few hundred tokens); 2e-2 in bf16
(both round a float32 result to bf16; one rounding step at |x| < 4 may
differ).
"""
import math

import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    before = pa.LAUNCHES["ragged_prefill_attention"]
    got = pa.ragged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["ragged_prefill_attention"] == before + 1
    want = pa.ragged_prefill_attention_reference(*args, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    rows = torch.arange(s["bq"], device=dev)[None, :]
    assert float(got[rows >= args[5].long()[:, None]].abs().max()) == 0.0


@pytest.mark.parametrize("kvh,d,bs", [(8, 128, 64), (2, 128, 16), (1, 64, 8),
                                      (8, 80, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(dev, kvh, d, bs, dtype):
    rng = np.random.RandomState(d + bs)
    s, h, bps = 9, 8, 12
    num_slots = (s * bps + 2) * bs
    lens = rng.randint(0, bps * bs + 1, s).astype(np.int32)
    lens[0], lens[1] = 0, bps * bs
    g = torch.Generator(device="cpu").manual_seed(0)
    args = [torch.randn((s, h, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.randn((num_slots, kvh, d), generator=g).to(dev, dtype),
            torch.from_numpy(rng.permutation(num_slots // bs)[:s * bps]
                             .reshape(s, bps).astype(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev)]
    for kw in (dict(), dict(window=37),
               dict(alibi=torch.from_numpy(alibi_slopes(h)).to(dev))):
        got = pa.paged_decode_attention(*args, block_size=bs, **kw)
        want = pa.paged_decode_attention_reference(*args, block_size=bs, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert float(got[0].abs().max()) == 0.0     # dead slot


def test_kernel_rejects_what_it_does_not_take(dev):
    args = _case(dev, torch.float32, a=2, bq=4, h=4, kvh=2, d=32, bs=8, bps=2,
                 seed=0)
    with pytest.raises(TypeError):
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
