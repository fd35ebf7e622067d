"""Tensor parallelism: the auto-TP rules and Megatron's regions.

Port of ``deepspeedsyclsupport_tpu/parallel/tensor_parallel.py``. The rules
(``auto_tp_rules``, ``column_parallel``, ``row_parallel``) are the JAX
package's name heuristics, returning ``PartitionSpec``-like tuples for
``runtime/zero.py``. Under XLA the partitioner inserts TP's all-reduces
from those layouts; here the model runs on this rank's shards and calls
Megatron's two autograd functions itself:

* :func:`copy_to_model_region` — identity forward, all-reduce backward
  (before a column-parallel matmul: every model rank reads the same input,
  and the input's gradient sums the ranks' parts);
* :func:`reduce_from_model_region` — all-reduce forward, identity backward
  (after a row-parallel matmul: the partial products sum to the output).

:func:`column_bias` cuts a replicated bias to a column-parallel layer's
columns.

:func:`vocab_parallel_embedding` looks up ids in this rank's rows of a
vocab-split table and sums over ``model``; :func:`vocab_parallel_logz`
gives the log-partition and the gold logit of vocab-split logits, so the
loss never gathers ``[B, S, V]``.
"""
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..comm import comm

ROW_PARALLEL_PATTERNS: Tuple[str, ...] = (
    "o_proj", "out_proj", "wo", "w_down", "down_proj", "dense_4h_to_h",
    "attention.dense", "fc2", "w2", "proj_out",
)
EMBEDDING_PATTERNS: Tuple[str, ...] = ("embed", "wte", "word_embeddings",
                                       "tok")


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path).lower()


def auto_tp_rules(stacked_layer_key: Optional[str] = "layers",
                  row_patterns: Sequence[str] = ROW_PARALLEL_PATTERNS,
                  embed_patterns: Sequence[str] = EMBEDDING_PATTERNS
                  ) -> Callable:
    """An ``extra_rules(path, shape)`` for ``runtime/zero.py`` from name
    heuristics: embeddings split their vocab dim, output / down projections
    are row-parallel, other matrices column-parallel; a stacked layer leaf
    leads with an unsplit layer dim."""

    def rules(path, shape):
        s = _path_str(path)
        ndim = len(shape)
        if ndim < 2:
            return None
        stacked = stacked_layer_key is not None and stacked_layer_key in s
        pre = (None,) if (stacked and ndim >= 3) else ()
        body = ndim - len(pre)
        if body < 2:
            return None
        if any(p in s for p in embed_patterns):
            return pre + ("model",) + (None,) * (body - 1)
        if any(p in s for p in row_patterns):
            return pre + ("model",) + ("fsdp",) + (None,) * (body - 2)
        return pre + ("fsdp",) + (None,) * (body - 2) + ("model",)

    return rules


def column_parallel(*, stacked: bool = False) -> Tuple:
    """Spec of an [in, out] weight split on out (ColumnParallelLinear)."""
    return ((None,) if stacked else ()) + ("fsdp", "model")


def row_parallel(*, stacked: bool = False) -> Tuple:
    """Spec of an [in, out] weight split on in (RowParallelLinear)."""
    return ((None,) if stacked else ()) + ("model", "fsdp")


class _CopyToModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return comm.all_reduce(grad, ctx.axis), None


class _ReduceFromModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return comm.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_region(x: torch.Tensor, axis: str = "model"
                         ) -> torch.Tensor:
    """Identity forward; the backward all-reduces the gradient over
    ``axis``."""
    return _CopyToModelRegion.apply(x, axis)


def reduce_from_model_region(x: torch.Tensor, axis: str = "model"
                             ) -> torch.Tensor:
    """All-reduce over ``axis`` forward; identity backward."""
    return _ReduceFromModelRegion.apply(x, axis)


def column_bias(bias: torch.Tensor, n: int, axis: str = "model"
                ) -> torch.Tensor:
    """This rank's ``n`` entries of a bias that is replicated over ``axis``
    but added to a column-parallel output (the JAX package replicates every
    bias and GSPMD slices it to the rank's columns): the slice at
    ``axis_index * n``. The backward sums the ranks' zero-padded slices over
    ``axis`` (:func:`copy_to_model_region`), so every rank holds the
    replicated leaf's whole gradient. A row-parallel layer's bias is added
    once, after :func:`reduce_from_model_region`, and needs no call."""
    if comm.axis_size(axis) == 1:
        return bias
    return copy_to_model_region(bias, axis).narrow(
        -1, comm.axis_index(axis) * n, n)


def vocab_parallel_embedding(table: torch.Tensor, input_ids: torch.Tensor,
                             axis: str = "model") -> torch.Tensor:
    """Embedding lookup in a table split on its vocab dim over ``axis``
    (Megatron ``VocabParallelEmbedding``): this rank looks up the ids in its
    rows, zero-fills the rest, and the sum over ``axis`` combines. With
    ``axis`` of size 1 it is ``F.embedding``."""
    n = comm.axis_size(axis)
    ids = input_ids.long()
    if n == 1:
        return F.embedding(ids, table)
    rows = table.shape[0]
    local = ids - comm.axis_index(axis) * rows
    ok = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(ok, local, torch.zeros_like(local)), table)
    x = x * ok[..., None].to(x.dtype)
    return reduce_from_model_region(x, axis)


def vocab_parallel_logz(logits: torch.Tensor, labels: torch.Tensor,
                        axis: str = "model"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logsumexp(logits), logits[label])`` over a vocab dim split across
    ``axis`` (Megatron's vocab-parallel cross-entropy): the max over the
    ranks (no gradient), the sum of ``exp(l - max)`` and the gold logit
    (held by the rank whose rows hold the label) reduced over ``axis``.
    Memory: this rank's ``[B, S, V / tp]`` and a few ``[B, S]``, never the
    full logits."""
    vl = logits.shape[-1]
    start = comm.axis_index(axis) * vl
    with torch.no_grad():
        m = comm.all_reduce(logits.max(dim=-1).values, axis, op="max")
    sumexp = reduce_from_model_region(
        torch.exp(logits - m[..., None]).sum(dim=-1), axis)
    logz = m + torch.log(sumexp)
    local = labels - start
    ok = (local >= 0) & (local < vl)
    gold = logits.gather(-1, torch.where(ok, local, torch.zeros_like(
        local))[..., None])[..., 0] * ok.to(logits.dtype)
    return logz, reduce_from_model_region(gold, axis)
