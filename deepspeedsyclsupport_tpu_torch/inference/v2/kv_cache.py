"""Blocked (paged) KV cache on the device.

Port of ``deepspeedsyclsupport_tpu/inference/v2/kv_cache.py``: a pool of
fixed-size KV blocks in the flat-slot layout ``[L, (num_blocks + 1) *
block_size, KVH, D]``, so slot ``block_id * block_size + offset`` is one
index. The forwards write into the pool in place (the JAX package donates
it instead).

The block past ``num_blocks`` is the **sink**: the allocator never hands it
out, so no block table names it and no attention reads it. Rows that the
JAX package scatters out of range (``mode="drop"``: padded prefill tokens,
retired decode slots) are written there instead, so a forward writes every
row with no mask and reads nothing back to the host, as a CUDA graph
requires.
"""
from typing import NamedTuple, Optional

import torch

from .config import RaggedInferenceConfig


class BlockedKV(NamedTuple):
    k: torch.Tensor  # [L, num_blocks*block_size, KVH, D]
    v: torch.Tensor

    @property
    def num_slots(self) -> int:
        """Slots of the pool, the sink block's included."""
        return self.k.shape[1]


def sink_slot(kv: BlockedKV, block_size: int) -> int:
    """First slot of the sink block (the pool's last block)."""
    return kv.num_slots - block_size


def copy_block(kv: BlockedKV, src: int, dst: int, block_size: int) -> None:
    """Copy block ``src``'s rows to block ``dst`` in every layer of both
    pools, in place: the prefix cache's copy-on-write (the JAX package's
    ``build_block_copy_fn``, which returns a new pool instead)."""
    for pool in (kv.k, kv.v):
        pool[:, dst * block_size:(dst + 1) * block_size].copy_(
            pool[:, src * block_size:(src + 1) * block_size])


def lane_padded_head_dim(head_dim: int, pad) -> int:
    """Head dim of the pool, rounded up to a multiple of ``pad``. ``None``
    or 0 means auto, which on CUDA is no padding: the JAX package's 128 is a
    Mosaic (TPU) tiling constraint. q/k/v are zero-padded at the attention
    seam, q pre-scaled by sqrt(d_pad/d) (``model._lane_pad``), so a forced
    pad leaves scores mathematically unchanged."""
    if pad in (None, 0):
        pad = 1
    return -(-head_dim // pad) * pad


def init_blocked_kv(model_config, cfg: RaggedInferenceConfig,
                    device: torch.device, tp: int = 1) -> BlockedKV:
    """The pool of one rank: under tensor parallelism over ``tp`` ranks it
    holds this rank's ``num_kv_heads / tp`` KV heads."""
    kvh = model_config.num_kv_heads
    if kvh % tp:
        raise ValueError(
            f"tensor parallelism over {tp} ranks needs num_kv_heads "
            f"({kvh}) to divide by {tp}: each rank holds whole KV heads of "
            f"the paged pool and attends with its query heads' groups")
    d = lane_padded_head_dim(model_config.head_dim, cfg.head_dim_lane_pad)
    shape = (model_config.num_layers, (cfg.num_blocks + 1) * cfg.block_size,
             kvh // tp, d)
    return BlockedKV(torch.zeros(shape, dtype=cfg.dtype, device=device),
                     torch.zeros(shape, dtype=cfg.dtype, device=device))


def kv_pool_stats(kv: BlockedKV, allocator, world: Optional[int] = None
                  ) -> dict:
    """Occupancy and footprint of the paged pool, from shapes and the
    allocator only (no device sync). Blocks are the allocator's
    ``num_blocks``, as in the JAX package: the sink block is neither
    counted nor priced. ``occupancy`` is the physical fraction of blocks
    held; ``logical_occupancy`` prices every block-table entry (sum of
    refcounts). ``pool_bytes`` counts both k and v over those blocks in
    this rank's pool. With ``world`` (the ranks serving together, each
    holding a pool like this one: every rank runs the same scheduler) the
    dict adds ``pool_bytes_world``, their sum; without it the keys are the
    JAX package's."""
    total = allocator.num_blocks
    free = allocator.free_blocks
    physical = total - free
    logical = int(getattr(allocator, "logical_blocks", physical))
    shared = int(getattr(allocator, "shared_blocks", 0))
    per_slot = (kv.k.shape[2] * kv.k.shape[3] * kv.k.element_size()
                * kv.k.shape[0])
    pool = 2 * per_slot * (kv.num_slots // (total + 1)) * total
    out = {"blocks_total": total, "blocks_free": free,
           "blocks_physical": physical, "blocks_logical": logical,
           "blocks_shared": shared,
           "occupancy": 1.0 - free / total,
           "logical_occupancy": logical / total,
           "pool_bytes": pool}
    if world is not None:
        out["pool_bytes_world"] = pool * int(world)
    return out
