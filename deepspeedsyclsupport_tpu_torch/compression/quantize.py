"""Weight quantization for serving: symmetric int8 / int4 pack and unpack.

Port of ``deepspeedsyclsupport_tpu/compression/quantize.py``'s weight
format (the ZeRO-Inference path): :func:`quantize_int8` /
:func:`dequantize_int8`, :func:`quantize_int4` / :func:`dequantize_int4`
(two values a byte), :class:`QuantTensor` (codes + float32 scales as one
leaf of a params tree), :func:`quantize_leaf`, :func:`quantize_tree` and
:func:`dequantize_tree`. The same rules as the JAX package's, bit for bit:
groups run along the last dim; the scale is ``(amax + 1e-12) / 127`` (or
``/ 7``) in float32; codes round half to even; dequantizing multiplies the
float32 codes by the scale in float32 and then casts. The training
fake-quant is not ported (ROADMAP.md, queue A.3.7).

The port's layers are a Python list of per-layer dicts, so
:func:`quantize_tree` has no ``stacked`` mode: a per-layer leaf is what one
slice of the JAX package's stacked ``[L, ...]`` leaf is, and quantizes to
the same codes and scales.

The JAX package's codes equal these when it runs eagerly. Under
``jax.jit`` XLA folds the division by the constant 127 (or 7) into a
multiplication by its reciprocal, which moves some scales by one ulp.
"""
from typing import Any, Tuple

import torch

_QMAX = {8: 127.0, 4: 7.0}


def _quantize(x: torch.Tensor, group_size: int, qmax: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric codes (float, integral, in [-qmax, qmax]) and float32
    scales: one scale per ``group_size`` elements of the last dim, or one
    for the whole tensor when ``group_size <= 0``. The scale divides by a
    tensor of ``qmax``: CUDA divides by a Python number as a product with
    its reciprocal, which would move some scales by one ulp from the
    CPU's."""
    if group_size > 0:
        shape = x.shape
        if shape[-1] % group_size:
            raise ValueError(f"last dim {shape[-1]} does not divide into "
                             f"groups of {group_size}")
        x = x.reshape(*shape[:-1], shape[-1] // group_size, group_size)
        amax = x.abs().amax(dim=-1, keepdim=True) + 1e-12
    else:
        shape = None
        amax = x.abs().amax() + 1e-12
    scale = (amax / torch.full_like(amax, qmax)).float()
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    if shape is None:
        return q, scale
    return q.reshape(shape), scale.squeeze(-1)


def _scaled(q: torch.Tensor, scale: torch.Tensor, group_size: int,
            dtype: torch.dtype) -> torch.Tensor:
    if group_size > 0:
        shape = q.shape
        qg = q.reshape(*shape[:-1], shape[-1] // group_size, group_size)
        return (qg.float() * scale[..., None]).reshape(shape).to(dtype)
    return (q.float() * scale).to(dtype)


def quantize_int8(x: torch.Tensor, group_size: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: ``(q int8, scales float32)``, blockwise over the last
    dim when ``group_size > 0``."""
    q, scale = _quantize(x, group_size, _QMAX[8])
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    group_size: int = -1,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _scaled(q, scale, group_size, dtype)


def quantize_int4(x: torch.Tensor, group_size: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 packed two a byte: values in [-7, 7] biased by +8 to
    nibbles, the low nibble the even element. The last dim must be even.
    Returns ``(packed uint8 [..., n/2], scales float32)``."""
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"int4 packing needs an even last dim, got {n}")
    q, scale = _quantize(x, group_size, _QMAX[4])
    nib = (q.to(torch.int32) + 8).to(torch.uint8)        # 1..15
    return nib[..., 0::2] | (nib[..., 1::2] << 4), scale


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    group_size: int = -1,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    b = packed.to(torch.int32)
    q = torch.stack([(b & 0xF) - 8, ((b >> 4) & 0xF) - 8], dim=-1)
    q = q.reshape(*packed.shape[:-1], packed.shape[-1] * 2)
    return _scaled(q, scale, group_size, dtype)


class QuantTensor:
    """Codes + blockwise float32 scales of one weight, one leaf of a params
    tree (the ZeRO-Inference format: the weight stays quantized until the
    layer that uses it runs). ``q``: int8 codes, or uint8 with two int4
    codes a byte when ``bits == 4``; ``scale``: float32, one per group of
    ``group_size`` elements of the last dim."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, group_size: int,
                 bits: int = 8):
        self.q = q
        self.scale = scale
        self.group_size = int(group_size)
        self.bits = int(bits)

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.bits == 4:  # packed two a byte on the last dim
            return tuple(self.q.shape[:-1]) + (self.q.shape[-1] * 2,)
        return tuple(self.q.shape)

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        fn = dequantize_int4 if self.bits == 4 else dequantize_int8
        return fn(self.q, self.scale, group_size=self.group_size, dtype=dtype)

    def to(self, device) -> "QuantTensor":
        """The same codes and scales on ``device`` (their dtypes kept)."""
        return QuantTensor(self.q.to(device), self.scale.to(device),
                           self.group_size, self.bits)

    def __repr__(self):
        return (f"QuantTensor(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)}, group={self.group_size}, "
                f"bits={self.bits})")


def quantize_leaf(x: torch.Tensor, group_size: int = 64,
                  bits: int = 8) -> QuantTensor:
    """Blockwise quantization of one weight from its float32 value: groups
    of ``group_size`` along the last dim, or one group a row when the last
    dim does not divide. int4 needs an even last dim and group; otherwise
    the leaf takes int8."""
    gs = group_size if (group_size > 0 and x.dim()
                        and x.shape[-1] % group_size == 0) else x.shape[-1]
    x = x.float()
    if bits == 4 and x.shape[-1] % 2 == 0 and gs % 2 == 0:
        q, scale = quantize_int4(x, group_size=gs)
        return QuantTensor(q, scale, gs, bits=4)
    q, scale = quantize_int8(x, group_size=gs)
    return QuantTensor(q, scale, gs)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def dequantize_tree(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """A new tree with every :class:`QuantTensor` leaf dequantized to
    ``dtype``; other leaves are shared."""
    return _tree_map(lambda x: x.dequantize(dtype)
                     if isinstance(x, QuantTensor) else x, tree)


def quantize_tree(tree: Any, group_size: int = 64, min_size: int = 4096,
                  bits: int = 8) -> Any:
    """A new tree whose floating leaves of >= 2 dims and >= ``min_size``
    elements are :class:`QuantTensor` s. Norm scales, biases and small
    matrices stay as they are; a leaf that is already quantized passes
    through."""
    def maybe(x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.dim() >= 2 and x.numel() >= min_size):
            return quantize_leaf(x, group_size, bits=bits)
        return x

    return _tree_map(maybe, tree)
