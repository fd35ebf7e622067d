"""Quantized collectives: ZeRO++'s int8 transport and the 1-bit operator.

Port of ``deepspeedsyclsupport_tpu/comm/quantized.py`` on the façade's
process groups (``comm/comm.py``):

* :func:`quantized_all_gather` (qwZ): this rank's tensor, flattened and
  zero-padded to a multiple of ``group_size``, quantized to int8 blocks of
  ``group_size`` with one float32 scale each; the codes and the scales are
  all-gathered as two tensors, dequantized, and the padding dropped;
* :func:`all_to_all_quant_reduce` (qgZ): ``n`` chunks along dim 0, one
  for each rank, each quantized the same way; an untiled all-to-all of the
  codes and of the scales, then the dequantized float32 chunks are averaged
  over their sources and cast back to the input's dtype;
* :func:`sign_compress` (zero maps to +1) and :func:`compressed_allreduce`,
  the error-feedback 1-bit all-reduce of the 1-bit optimizers.

The quantization is ``compression.quantize``'s ``quantize_int8`` /
``dequantize_int8``, the JAX package's rules (round half to even). ``axis``
names a mesh axis of the world topology; ``group=`` (a process group of
that axis's ranks, such as one of ``MeshTopology.hierarchical_groups``)
stands for JAX's ``axis_index_groups``. Like the ``lax`` collectives these
stand for, the calls record nothing in the comms logger: the ZeRO++ step
(``runtime/zeropp.py``) records its wire bytes under the JAX package's
names. The int8 codes travel as int8, never widened.
"""
from typing import Optional, Tuple

import torch

from . import comm
from ..compression.quantize import dequantize_int8, quantize_int8

__all__ = ["quantized_all_gather", "all_to_all_quant_reduce",
           "sign_compress", "compressed_allreduce"]


def _group(axis_name, group):
    """(process group or None, its size) of ``axis_name`` or ``group``."""
    if group is None:
        g, n, _ = comm._resolve(axis_name)
        return g, n
    import torch.distributed as dist

    return group, dist.get_world_size(group)


def _block_quant(x: torch.Tensor, group_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flatten, zero-pad to a multiple of ``group_size``, blockwise int8
    (JAX ``_block_quant``)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % group_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = quantize_int8(flat, group_size=group_size)
    return q, s, pad


def quantized_all_gather(x: torch.Tensor, axis_name, group_size: int = 256,
                         dtype: Optional[torch.dtype] = None,
                         group=None) -> torch.Tensor:
    """All-gather along dim 0 with int8 transport (qwZ): ``[m, ...]`` ->
    ``[W m, ...]``, ``W`` the axis size (or ``group``'s, the hpZ hop within
    a node), in ``dtype`` (default ``x``'s)."""
    dtype = dtype or x.dtype
    g, n = _group(axis_name, group)
    q, s, pad = _block_quant(x, group_size)
    qg = comm._gather_stacked(g, n, q)   # int8 on the wire
    sg = comm._gather_stacked(g, n, s)
    deq = dequantize_int8(qg, sg, group_size=group_size, dtype=dtype)
    if pad:
        deq = deq[:, :-pad]
    return deq.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def all_to_all_quant_reduce(x: torch.Tensor, axis_name,
                            group_size: int = 256,
                            group=None) -> torch.Tensor:
    """Quantized reduce-scatter MEAN (qgZ): ``[W m, ...]`` (chunk ``j`` for
    the rank at index ``j``) -> this rank's ``[m, ...]``, the float32 mean
    of the dequantized chunks its ``W`` sources sent, in ``x``'s dtype."""
    g, w = _group(axis_name, group)
    if x.shape[0] % w:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{w} ranks")
    m = x.shape[0] // w
    flat = x.reshape(w, -1)
    pad = (-flat.shape[1]) % group_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(w, pad)], dim=1)
    q, s = quantize_int8(flat, group_size=group_size)
    qt = comm._exchange(q, g)            # one chunk to each peer
    st = comm._exchange(s, g)
    deq = dequantize_int8(qt, st, group_size=group_size, dtype=torch.float32)
    if pad:
        deq = deq[:, :-pad]
    return deq.mean(dim=0).reshape((m,) + tuple(x.shape[1:])).to(x.dtype)


def sign_compress(corrected: torch.Tensor,
                  scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 1-bit operator: ``(sign int8, float32 scale, residual)``. Zero
    maps to +1, so dequantizing is exactly ``scale * sign`` (the local and
    wire paths must agree or error feedback breaks). ``scale`` defaults to
    ``mean(|corrected|)``; a leaf the port holds in pieces passes its
    whole-leaf mean."""
    if scale is None:
        scale = corrected.abs().mean()
    sign = torch.where(corrected >= 0, 1, -1).to(torch.int8)
    residual = corrected - scale * sign.to(corrected.dtype)
    return sign, scale, residual


def compressed_allreduce(x: torch.Tensor, error: torch.Tensor, axis_name,
                         group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit error-feedback all-reduce (reference
    ``NcclBackend.compressed_allreduce``): every rank's sign bits (int8 on
    the wire) and its one float32 scale are gathered and averaged; the
    local residual is the next call's ``error``. Returns (the average in
    ``x``'s dtype, the new error)."""
    corrected = x + error
    sign, scale, new_error = sign_compress(corrected)
    g, n = _group(axis_name, group)
    signs = comm._gather_stacked(g, n, sign)             # [W, ...] int8
    scales = comm._gather_stacked(
        g, n, scale.reshape(1).float())[:, 0]            # [W]
    avg = torch.tensordot(scales, signs.float(), dims=1) / n
    return avg.to(x.dtype), new_error
