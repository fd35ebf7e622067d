"""Ulysses sequence parallelism (DeepSpeed-Ulysses).

Port of ``deepspeedsyclsupport_tpu/parallel/ulysses.py``. The reference's
``DistributedAttention`` (``deepspeed/sequence/layer.py:60``) wraps any
attention with two all-to-alls over the sequence group: scatter heads /
gather the sequence before local attention, and the inverse after. The
JAX package issues them inside a ``shard_map`` over ``seq``; here each
``seq`` rank holds its contiguous chunk of every row (``[B, C, H_loc, D]``,
``C = S / sp``, ``H_loc`` the heads of this rank's tensor-parallel shard)
and the all-to-alls are ``comm.all_to_all``'s, differentiable (their
backward is the all-to-all with split and concat swapped, as JAX's AD
derives). Local attention sees the whole sequence on ``H_loc / sp`` heads,
so causality and segment masking are exact; it runs through
``ops.flash_attention`` (the CUDA kernels on the card) or the plain path.

Requirement (the reference's, and the JAX package's checks :93-113): the
query heads divide by sp·tp; KV heads that do not are replicated up to the
lcm (consecutive repetition keeps the query -> KV group mapping).
"""
from typing import Optional

import numpy as np
import torch

from ..comm import comm
from ..comm.topology import get_world_topology


def _local_attention(q, k, v, causal, segment_ids, inner):
    """Attention over the full sequence on a head slice."""
    if inner is None:
        inner = "flash" if q.device.type == "cuda" else "xla"
    if inner not in ("flash", "xla"):
        raise ValueError(f"unknown ulysses inner impl {inner!r} "
                         f"(flash | xla)")
    if inner == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    from ..models.layers import reference_attention

    return reference_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)


def _seq_all_to_all_body(q, k, v, segment_ids, *, causal, inner):
    """Shards arrive ``[B, C, H_loc, D]`` (segment ids ``[B, C]``):
    all-to-all #1 over ``seq`` scatters heads / gathers the sequence (->
    ``[B, S, H_loc / sp, D]``), local attention, all-to-all #2 inverts."""
    q = comm.all_to_all(q, "seq", split_axis=2, concat_axis=1)
    k = comm.all_to_all(k, "seq", split_axis=2, concat_axis=1)
    v = comm.all_to_all(v, "seq", split_axis=2, concat_axis=1)
    if segment_ids is not None:
        segment_ids = comm.all_gather(segment_ids.contiguous(), "seq",
                                      axis=1)
    out = _local_attention(q, k, v, causal, segment_ids, inner)
    return comm.all_to_all(out, "seq", split_axis=1, concat_axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      segment_ids: Optional[torch.Tensor] = None,
                      inner: Optional[str] = None) -> torch.Tensor:
    """q: ``[B, C, H_loc, D]``, k/v: ``[B, C, KVH_loc, D]``: this rank's
    sequence chunk (``seq``) of its heads (``model``). Returns the
    attention output of the same layout. With no ``seq`` axis (or a
    world of one) the attention is local."""
    topo = get_world_topology()
    sp = topo.axis_sizes["seq"]
    if sp == 1:
        return _local_attention(q, k, v, causal, segment_ids, inner)
    tp = topo.axis_sizes["model"]
    g = sp * tp
    h, kvh = q.shape[2] * tp, k.shape[2] * tp
    if h % g:
        raise ValueError(
            f"ulysses needs q heads ({h}) divisible by sp*tp ({sp}*{tp}) — "
            f"reference sequence/layer.py has the same constraint")
    if kvh % g:
        # GQA with fewer kv heads than sp·tp: replicate kv heads up to the
        # lcm so every rank owns a whole head after the scatter
        r = int(np.lcm(kvh, g) // kvh)
        if (kvh * r) and h % (kvh * r) == 0:
            k = torch.repeat_interleave(k, r, dim=2)
            v = torch.repeat_interleave(v, r, dim=2)
        else:
            raise ValueError(
                f"ulysses cannot align kv heads ({kvh}) with sp*tp "
                f"({sp}*{tp}) for q heads {h}")
    return _seq_all_to_all_body(q, k, v, segment_ids, causal=causal,
                                inner=inner)
