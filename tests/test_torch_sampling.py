"""PyTorch port: sampling, engine config and KV-pool stats against the JAX
package. Random bits differ between ``jax.random`` and ``torch.Generator``,
so sampled tokens are held to the set the JAX filters allow; greedy is
exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.inference import sampling as js
from deepspeedsyclsupport_tpu.inference.v2 import config as jc
from deepspeedsyclsupport_tpu.inference.v2 import kv_cache as jkv
from deepspeedsyclsupport_tpu.inference.v2.ragged import (
    BlockedAllocator as JaxAllocator)
from deepspeedsyclsupport_tpu.models import get_config
from deepspeedsyclsupport_tpu_torch.inference import sampling as ts
from deepspeedsyclsupport_tpu_torch.inference.v2 import config as tc
from deepspeedsyclsupport_tpu_torch.inference.v2 import kv_cache as tkv
from deepspeedsyclsupport_tpu_torch.inference.v2.ragged import (
    BlockedAllocator)


def _logits(seed=0, b=6, v=50):
    return np.random.RandomState(seed).randn(b, v).astype(np.float32) * 3


def test_greedy_identical_including_ties():
    lg = _logits()
    lg[0, 7] = lg[0, 3] = lg[0].max() + 1      # a tie: both take the first
    want = np.asarray(js.sample_token(jnp.asarray(lg), None,
                                      js.SamplingParams()))
    got = ts.sample_token(torch.from_numpy(lg), None, ts.SamplingParams())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 3


def _allowed(lg, params):
    """Tokens the JAX sampler can emit: those its filters leave finite."""
    allowed = np.zeros(lg.shape, bool)
    for seed in range(64):
        tok = np.asarray(js.sample_token(jnp.asarray(lg),
                                         jax.random.PRNGKey(seed), params))
        allowed[np.arange(lg.shape[0]), tok] = True
    return allowed


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.5), (5, 0.7)])
def test_filtered_sampling_stays_in_the_reference_support(top_k, top_p):
    lg = _logits(1)
    jp = js.SamplingParams(True, 0.8, top_k, top_p)
    # the reference's support, from its own filters' arithmetic
    x = lg / 0.8
    keep = np.ones_like(x, bool)
    if top_k:
        keep &= x >= np.sort(x, axis=-1)[:, -top_k][:, None]
    if top_p < 1.0:
        xs = np.where(keep, x, -np.inf)
        srt = -np.sort(-xs, axis=-1)
        p = np.exp(srt - srt[:, :1])
        p /= p.sum(-1, keepdims=True)
        cut = np.min(np.where(np.cumsum(p, -1) - p < top_p, srt, np.inf), -1)
        keep &= xs >= cut[:, None]
    assert not (_allowed(lg, jp) & ~keep).any()   # the oracle is the JAX one
    gen = torch.Generator().manual_seed(0)
    tp = ts.SamplingParams(True, 0.8, top_k, top_p)
    seen = np.zeros_like(keep)
    for _ in range(200):
        tok = ts.sample_token_dyn(torch.from_numpy(lg), gen, 0.8, top_p,
                                  tp.structure).numpy()
        seen[np.arange(lg.shape[0]), tok] = True
    assert not (seen & ~keep).any()
    assert seen.sum() > lg.shape[0]          # it does sample, not argmax


def test_sampling_structure_matches():
    for p in [(False, 0.5, 4, 0.3), (True, 1.0, 0, 1.0), (True, 0.7, 8, 0.9)]:
        assert ts.SamplingParams(*p).structure == js.SamplingParams(
            *p).structure


@pytest.mark.parametrize("bad", [
    dict(max_prefill_fraction=0.0), dict(eviction_policy="coinflip"),
    dict(atom_q_size=0), dict(decode_steps_per_dispatch=0),
    dict(quant_bits=3), dict(max_context=100, block_size=64),
    dict(prefill_attn="")])
def test_config_validation_matches(bad):
    with pytest.raises(ValueError):
        jc.RaggedInferenceConfig(**bad)
    with pytest.raises(ValueError):
        tc.RaggedInferenceConfig(**bad)


@pytest.mark.parametrize("pad", [-3, -200, 2.5, True])
def test_head_dim_lane_pad_rejects_what_is_not_a_pad(pad):
    """``head_dim_lane_pad`` is None, 0 (auto) or a positive int: -3 once
    gave a pool head dim of 126 and -200 one of 0. The JAX package keeps
    the gap (ROADMAP.md, differences by design)."""
    with pytest.raises(ValueError, match="head_dim_lane_pad"):
        tc.RaggedInferenceConfig(head_dim_lane_pad=pad)
    for ok in (None, 0, 8, np.int64(128)):
        tc.RaggedInferenceConfig(head_dim_lane_pad=ok)


def test_config_defaults_match():
    j = dataclasses.asdict(jc.RaggedInferenceConfig(max_sequences=16))
    t = dataclasses.asdict(tc.RaggedInferenceConfig(max_sequences=16))
    assert j.pop("dtype") == jnp.bfloat16 and t.pop("dtype") == torch.bfloat16
    assert j == t
    assert tc.RaggedInferenceConfig.from_config(
        {"dtype": "fp32"}).dtype == torch.float32
    with pytest.raises(ValueError, match="unknown ragged config keys"):
        tc.RaggedInferenceConfig.from_config({"bogus": 1})


def test_kv_pool_stats_match():
    mcfg = get_config("tiny")
    kw = dict(block_size=8, max_context=64, max_sequences=4, num_blocks=12)
    jpool = jkv.init_blocked_kv(mcfg, jc.RaggedInferenceConfig(
        dtype=jnp.bfloat16, **kw))
    tpool = tkv.init_blocked_kv(mcfg, tc.RaggedInferenceConfig(
        dtype=torch.bfloat16, **kw), torch.device("cpu"))
    # the port's pool has one more block, the sink (never allocated); the
    # stats count the allocator's blocks, as the JAX package's do
    jl, jslots, *rest = jpool.k.shape
    assert tuple(tpool.k.shape) == (jl, jslots + kw["block_size"], *rest)
    ja, ta = JaxAllocator(12), BlockedAllocator(12)
    for a in (ja, ta):
        got = a.allocate(5)
        a.retain(got[:2])
    assert tkv.kv_pool_stats(tpool, ta) == jkv.kv_pool_stats(jpool, ja)
    assert tkv.lane_padded_head_dim(16, 128) == 128
    assert tkv.lane_padded_head_dim(16, None) == 16   # no pad on CUDA
