"""PyTorch port: weight quantization (ZeRO-Inference int8 / int4) against
the JAX package's ``compression/quantize.py``.

The same numpy weights go through both. The JAX side runs eagerly (under
``jax.jit`` XLA turns the division of the scale by 127 into a
multiplication by 1/127, a different rounding). Codes and scales must be
EQUAL, not close: they are integers and float32 values computed by the same
float32 operations; dequantized weights are equal bit for bit in float32
and bf16 (one float32 product, then one rounding to the type).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.compression import quantize as jq
from deepspeedsyclsupport_tpu_torch.compression import quantize as tq
from deepspeedsyclsupport_tpu_torch.inference.params import (
    place_inference_params)

L = 2


def _stacked_tree(seed=0):
    """A stacked [L, ...] layer tree covering every rule: a grouped matrix,
    a router whose last dim does not divide 64 (one scale a row), an odd
    last dim (int4 falls back to int8), a 1-D norm, a matrix below
    ``min_size``, an integer leaf, and a leaf whose rows span orders of
    magnitude (scales far apart)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {
        "attn": {"wq": rng.randn(L, 64, 128).astype(f32) * 0.02,
                 "norm": rng.randn(L, 4096).astype(f32)},
        "moe": {"router": rng.randn(L, 512, 8).astype(f32),
                "w_down": (rng.randn(L, 4, 32, 64)
                           * np.exp(rng.randn(L, 4, 32, 1) * 3)).astype(f32)},
        "odd": rng.randn(L, 96, 63).astype(f32),
        "small": rng.randn(L, 16, 32).astype(f32),
        "ids": rng.randint(0, 100, (L, 64, 64)).astype(np.int32),
    }


def _layer(tree, li):
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree[li]))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_equals_jax(bits):
    """Codes, scales, group sizes and bits equal the JAX package's
    ``quantize_tree(stacked=True)`` slice by slice; which leaves are
    quantized (and which fall back to int8) is the same; untouched leaves
    pass through."""
    tree = _stacked_tree()
    want = jq.quantize_tree(tree, 64, stacked=True, bits=bits)
    want_leaves = dict(_leaves(want))
    for li in range(L):
        got = tq.quantize_tree(_layer(tree, li), 64, bits=bits)
        assert [n for n, _ in _leaves(got)] == [n for n, _ in _leaves(tree)]
        for name, g in _leaves(got):
            w = want_leaves[name]
            if isinstance(w, jq.QuantTensor):
                assert isinstance(g, tq.QuantTensor), name
                assert (g.bits, g.group_size) == (w.bits, w.group_size), name
                assert g.shape == tuple(w.shape[1:]), name
                np.testing.assert_array_equal(g.q.numpy(),
                                              np.asarray(w.q)[li])
                np.testing.assert_array_equal(g.scale.numpy(),
                                              np.asarray(w.scale)[li])
            else:
                assert isinstance(g, torch.Tensor), name
                np.testing.assert_array_equal(g.numpy(), np.asarray(w)[li])
    got = tq.quantize_tree(_layer(tree, 0), 64, bits=bits)
    assert got["moe"]["router"].group_size == 8          # one scale a row
    assert got["odd"].bits == 8                           # int4 fallback
    assert got["attn"]["wq"].bits == bits
    assert isinstance(got["attn"]["norm"], torch.Tensor)
    assert isinstance(got["small"], torch.Tensor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_tree_equals_jax_bit_for_bit(bits, dtype):
    tree = _stacked_tree(1)
    want = jq.dequantize_tree(jq.quantize_tree(tree, 64, stacked=True,
                                               bits=bits),
                              getattr(jnp, dtype))
    want_leaves = dict(_leaves(want))
    for li in range(L):
        got = tq.dequantize_tree(tq.quantize_tree(_layer(tree, li), 64,
                                                  bits=bits),
                                 getattr(torch, dtype))
        for name, g in _leaves(got):
            w = np.asarray(want_leaves[name])[li]
            assert str(g.dtype) == f"torch.{w.dtype.name}", name
            if g.is_floating_point():   # bf16 -> float32 is exact
                np.testing.assert_array_equal(g.float().numpy(),
                                              w.astype(np.float32))
            else:
                np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("group", [-1, 32])
@pytest.mark.parametrize("bits", [8, 4])
def test_primitives_equal_jax(bits, group):
    """quantize_int8 / int4 and their inverses, per tensor and by groups."""
    x = (np.random.RandomState(2).randn(6, 96) * 0.3).astype(np.float32)
    qf = {8: (jq.quantize_int8, tq.quantize_int8, jq.dequantize_int8,
              tq.dequantize_int8),
          4: (jq.quantize_int4, tq.quantize_int4, jq.dequantize_int4,
              tq.dequantize_int4)}[bits]
    jq_, js = qf[0](jnp.asarray(x), group_size=group)
    tq_, ts = qf[1](torch.from_numpy(x), group_size=group)
    assert tq_.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        qf[3](tq_, ts, group_size=group).numpy(),
        np.asarray(qf[2](jq_, js, group_size=group)))


def test_int4_layout_and_odd_dim():
    """Low nibble = even element, values biased by +8; an odd last dim is
    refused by the int4 packer (quantize_leaf falls back to int8)."""
    x = torch.tensor([[7.0, -7.0, 0.0, 3.0]])
    packed, scale = tq.quantize_int4(x, group_size=4)
    assert float(scale[0, 0]) == pytest.approx(1.0)
    assert packed.tolist() == [[(7 + 8) | ((-7 + 8) << 4),
                                (0 + 8) | ((3 + 8) << 4)]]
    with pytest.raises(ValueError, match="even"):
        tq.quantize_int4(torch.ones(2, 3))
    leaf = tq.quantize_leaf(torch.randn(64, 63), 64, bits=4)
    assert (leaf.bits, leaf.group_size, leaf.shape) == (8, 63, (64, 63))


def test_placement_keeps_codes_and_float32_scales():
    """A quantized leaf is placed whole: codes stay int8 / uint8 and scales
    float32 when the serving dtype is bf16; a pre-quantized tree passes
    through quantize_tree untouched."""
    tree = {"a": tq.quantize_leaf(torch.randn(64, 128), 64),
            "b": tq.quantize_leaf(torch.randn(64, 128), 64, bits=4),
            "n": torch.ones(64)}
    placed = place_inference_params(tree, torch.bfloat16,
                                    torch.device("cpu"))
    assert placed["a"].q.dtype == torch.int8
    assert placed["b"].q.dtype == torch.uint8
    assert placed["a"].scale.dtype == placed["b"].scale.dtype == torch.float32
    assert placed["n"].dtype == torch.bfloat16
    again = tq.quantize_tree(placed, 64)
    assert again["a"] is placed["a"] and again["b"] is placed["b"]
    assert placed["b"].shape == (64, 128)
