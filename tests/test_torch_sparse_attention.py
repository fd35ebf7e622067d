"""PyTorch port: block-sparse attention against the JAX package's
(``deepspeedsyclsupport_tpu/ops/sparse_attention.py``, its Pallas flash
kernel in interpret mode), on numpy inputs made from a seed.

Every ``SparsityConfig``'s ``make_layout`` must equal the JAX one exactly
(both draw BigBird's random blocks from ``np.random.RandomState(seed)``).
``sparse_attention`` is held at the JAX sparse test's shape (B=2, S=256,
H=4, D=32) with layout blocks of 16, 64 and 128, which the port's 64 x 64
kernel tiles do not match, so the per-element layout lookup is what is
tested: forward 2e-5 (the JAX test's own tolerance), gradients 2e-4 (the
flash gradients' tolerance; float32 on both sides).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops import sparse_attention as jsa
from deepspeedsyclsupport_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

# the port's ``ops`` package exports the function ``sparse_attention``, which
# shadows the submodule's name as an attribute
tsa = importlib.import_module(
    "deepspeedsyclsupport_tpu_torch.ops.sparse_attention")

B, S, H, D = 2, 256, 4, 32
FWD_TOL = 2e-5
GRAD_TOL = 2e-4

# name -> (class name, keyword arguments but num_heads and block)
CONFIGS = {
    "dense": ("DenseSparsityConfig", {}),
    "local_window": ("LocalSlidingWindowSparsityConfig",
                     dict(num_sliding_window_blocks=3)),
    "fixed": ("FixedSparsityConfig",
              dict(num_local_blocks=2, num_global_blocks=1)),
    "fixed_per_head": ("FixedSparsityConfig",
                       dict(different_layout_per_head=True,
                            num_local_blocks=4, num_global_blocks=1,
                            num_different_global_patterns=2,
                            horizontal_global_attention=True)),
    "bigbird": ("BigBirdSparsityConfig",
                dict(num_random_blocks=2, num_sliding_window_blocks=3,
                     num_global_blocks=1, seed=3)),
    "bigbird_per_head": ("BigBirdSparsityConfig",
                         dict(different_layout_per_head=True,
                              num_random_blocks=1,
                              num_sliding_window_blocks=1,
                              num_global_blocks=2)),
    "longformer": ("BSLongformerSparsityConfig",
                   dict(num_sliding_window_blocks=3,
                        global_block_indices=[0, 5])),
    "longformer_ends": ("BSLongformerSparsityConfig",
                        dict(num_sliding_window_blocks=1,
                             global_block_indices=[1, 6],
                             global_block_end_indices=[3, 7])),
}


def _configs(name, block, heads=H):
    cls, kw = CONFIGS[name]
    return (getattr(jsa, cls)(heads, block, **kw),
            getattr(tsa, cls)(heads, block, **kw))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_layout_matches_jax_exactly(name, causal):
    for block, seq in ((16, 256), (64, 1024), (128, 1024)):
        jcfg, tcfg = _configs(name, block)
        want = jcfg.make_layout(seq, causal=causal)
        got = tcfg.make_layout(seq, causal=causal)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _qkv(seed, s=S):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, s, H, D).astype(np.float32) for _ in range(3))


FWD_CASES = [("bigbird", True), ("bigbird_per_head", False),
             ("fixed_per_head", True), ("longformer_ends", False),
             ("local_window", True)]


@pytest.mark.parametrize("block", [16, 64, 128])
@pytest.mark.parametrize("name,causal", FWD_CASES)
def test_forward_matches_jax(name, causal, block):
    q, k, v = _qkv(block + len(name))
    jcfg, tcfg = _configs(name, block)
    want = jsa.sparse_attention(*map(jnp.asarray, (q, k, v)), jcfg,
                                causal=causal, interpret=True)
    got = tsa.sparse_attention(*map(torch.from_numpy, (q, k, v)), tcfg,
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("block", [16, 64, 128])
def test_grads_match_jax(block):
    name = "bigbird_per_head"
    q, k, v = _qkv(40 + block)
    jcfg, tcfg = _configs(name, block)
    w = np.random.RandomState(block).randn(B, S, H, D).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jsa.sparse_attention(q_, k_, v_, jcfg, causal=True,
                                            interpret=True) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tsa.sparse_attention(*leaves, tcfg, causal=True)
     * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_dead_row_block_gives_zero_output_and_lse():
    """A layout whose second row block is dead: those rows get o = 0 and
    lse ~ -1e30, as the JAX kernel gives them (and its `_masked_reference`
    oracle zeroes them)."""
    q, k, v = _qkv(7)
    layout = np.ones((1, 4, 4), np.int32)
    layout[0, 1] = 0
    want_o, want_lse = jax_flash(*map(jnp.asarray, (q, k, v)), causal=False,
                                 block_layout=jnp.asarray(layout),
                                 block_q=64, block_k=64, interpret=True,
                                 return_lse=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    mask = tfa.make_mask(tq, tk, causal=False,
                         block_layout=torch.from_numpy(layout), block_q=64,
                         block_k=64)
    o, lse = tfa.flash_attention_fwd_reference(tq, tk, tv, mask)
    assert float(o[:, 64:128].abs().max()) == 0.0
    assert float(lse[:, :, 64:128].max()) <= -1e29
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(lse.transpose(1, 2).numpy(),
                               np.asarray(want_lse), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_unaligned_sequence_matches_jax():
    """S = 200 with 64-blocks: the layout covers the padded 256 grid."""
    q, k, v = _qkv(8, s=200)
    jcfg, tcfg = _configs("bigbird", 64)
    want = jsa.sparse_attention(*map(jnp.asarray, (q, k, v)), jcfg,
                                causal=True, interpret=True)
    got = tsa.sparse_attention(*map(torch.from_numpy, (q, k, v)), tcfg,
                               causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_rejections_match_jax():
    q = torch.ones((1, 64, 4, 16))
    with pytest.raises(ValueError, match="exceeds the padded sequence"):
        tsa.sparse_attention(q, q, q, tsa.DenseSparsityConfig(4, block=512))
    with pytest.raises(ValueError, match="num_heads"):
        tsa.sparse_attention(q, q, q, tsa.DenseSparsityConfig(5, block=16))
    with pytest.raises(ValueError, match="not a multiple of block"):
        tsa.DenseSparsityConfig(4, block=48).make_layout(100)
    with pytest.raises(ValueError, match="requires different_layout"):
        tsa.FixedSparsityConfig(4, num_different_global_patterns=2)
    with pytest.raises(ValueError, match="more global patterns"):
        tsa.FixedSparsityConfig(4, different_layout_per_head=True,
                                num_local_blocks=2, num_global_blocks=1,
                                num_different_global_patterns=3)
    with pytest.raises(ValueError, match="must match"):
        tsa.BSLongformerSparsityConfig(4, global_block_indices=[0, 2],
                                       global_block_end_indices=[1])
    with pytest.raises(NotImplementedError):
        tsa.SparsityConfig(4).make_layout(128)


def test_cpu_tensors_never_launch():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(9))
    _, tcfg = _configs("bigbird", 64)
    tfa.reset_launch_counts()
    tsa.sparse_attention(q, k, v, tcfg).sum().backward()
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)
