"""Block-sparse attention: SparsityConfig layouts over the flash kernels.

Port of ``deepspeedsyclsupport_tpu/ops/sparse_attention.py``, the analog of
the reference's ``deepspeed/ops/sparse_attention/`` (``sparsity_config.py``
layouts + ``SparseSelfAttention``). A layout is a ``[Hl, nb, nb]`` 0/1
block mask; it rides the flash kernels' layout input (``block_layout``),
which masks element by element and skips a 64 x 64 tile whose layout
blocks are all dead.

The config classes are this package's own copy of the JAX module's
(:27-207, numpy only): Dense, LocalSlidingWindow, Fixed, BigBird (the same
``np.random.RandomState(seed)`` draws) and BSLongformer.
"""
from typing import List, Optional

import numpy as np
import torch

from .flash_attention import flash_attention, round_up

__all__ = ["SparsityConfig", "DenseSparsityConfig",
           "LocalSlidingWindowSparsityConfig", "FixedSparsityConfig",
           "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "sparse_attention"]


class SparsityConfig:
    """Base: ``make_layout(seq_len)`` -> int32 ``[Hl, nb, nb]`` block mask
    (reference ``SparsityConfig.setup_layout``)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    @property
    def layout_heads(self) -> int:
        return self.num_heads if self.different_layout_per_head else 1

    def _empty(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not a multiple of "
                             f"block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.layout_heads, nb, nb), np.int32)

    def _finish(self, layout: np.ndarray, causal: bool) -> np.ndarray:
        if causal:
            layout = layout * np.tril(
                np.ones(layout.shape[1:], np.int32))[None]
        return layout

    def make_layout(self, seq_len: int, causal: bool = True) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks live (the parity baseline)."""

    def make_layout(self, seq_len: int, causal: bool = True) -> np.ndarray:
        layout = self._empty(seq_len)
        layout[:] = 1
        return self._finish(layout, causal)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Banded local attention."""

    def __init__(self, num_heads: int, block: int = 128,
                 num_sliding_window_blocks: int = 3,
                 different_layout_per_head: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks

    def make_layout(self, seq_len: int, causal: bool = True) -> np.ndarray:
        layout = self._empty(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks
        for i in range(nb):
            lo = max(0, i - w // 2) if not causal else max(0, i - w + 1)
            hi = min(nb, i + w // 2 + 1) if not causal else i + 1
            layout[:, i, lo:hi] = 1
        return self._finish(layout, causal)


class FixedSparsityConfig(SparsityConfig):
    """Local windows of ``num_local_blocks`` plus the last
    ``num_global_blocks`` block-columns of every window (the Sparse
    Transformer 'fixed' pattern); ``num_different_global_patterns`` rotates
    which columns are global across head groups (needs per-head layouts)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 requires "
                             "different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // max(
                num_global_blocks, 1):
            raise ValueError("more global patterns than fit in a window")
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int, causal: bool = True) -> np.ndarray:
        layout = self._empty(seq_len)
        nb = layout.shape[1]
        nl, ng = self.num_local_blocks, self.num_global_blocks
        for h in range(layout.shape[0]):
            pat = (h * self.num_different_global_patterns //
                   max(layout.shape[0], 1)) if \
                self.num_different_global_patterns > 1 else 0
            for i in range(nb):
                w0 = (i // nl) * nl
                layout[h, i, w0:min(w0 + nl, nb)] = 1  # local window
            for w0 in range(0, nb, nl):
                # the pattern-selected ng columns at this window's tail
                # (pattern p shifts them back by p * ng)
                c_hi = min(w0 + nl, nb) - pat * ng
                c_lo = max(c_hi - ng, 0)
                layout[h, :, c_lo:c_hi] = 1
                if self.horizontal_global_attention:
                    layout[h, c_lo:c_hi, :] = 1
        return self._finish(layout, causal)


class BigBirdSparsityConfig(SparsityConfig):
    """Sliding window + global first (and, non-causal, last) blocks +
    random blocks drawn from ``np.random.RandomState(seed)``."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.seed = seed

    def make_layout(self, seq_len: int, causal: bool = True) -> np.ndarray:
        layout = self._empty(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks
        g = min(self.num_global_blocks, nb)
        rng = np.random.RandomState(self.seed)
        for h in range(layout.shape[0]):
            for i in range(nb):
                lo, hi = max(0, i - w // 2), min(nb, i + w // 2 + 1)
                layout[h, i, lo:hi] = 1                   # sliding window
                cand = np.arange(0, i + 1 if causal else nb)
                if len(cand):
                    pick = rng.choice(cand, size=min(self.num_random_blocks,
                                                     len(cand)),
                                      replace=False)
                    layout[h, i, pick] = 1                # random blocks
            layout[h, :, :g] = 1                          # global columns
            layout[h, :g, :] = 1                          # global rows
            if not causal:
                layout[h, :, nb - g:] = 1
                layout[h, nb - g:, :] = 1
        return self._finish(layout, causal)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + designated global block indices."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError(
                f"global_block_end_indices ({len(global_block_end_indices)}) "
                f"must match global_block_indices "
                f"({len(self.global_block_indices)})")
        self.global_block_end_indices = global_block_end_indices

    def make_layout(self, seq_len: int, causal: bool = True) -> np.ndarray:
        layout = self._empty(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks
        for i in range(nb):
            lo, hi = max(0, i - w // 2), min(nb, i + w // 2 + 1)
            layout[:, i, lo:hi] = 1
        ends = self.global_block_end_indices
        for n, start in enumerate(self.global_block_indices):
            stop = ends[n] if ends else start + 1
            layout[:, :, start:stop] = 1    # everyone sees global blocks
            layout[:, start:stop, :] = 1    # global blocks see everyone
        return self._finish(layout, causal)


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     config: SparsityConfig,
                     causal: bool = True) -> torch.Tensor:
    """Block-sparse attention over ``q/k/v [B, S, H, D]`` (the
    ``SparseSelfAttention.forward`` analog): the config's layout for the
    padded block grid, through the flash kernels with dead blocks masked.
    Differentiable in q, k and v."""
    b, s, h, d = q.shape
    if h != config.num_heads:
        raise ValueError(f"config.num_heads={config.num_heads} != {h}")
    blk = config.block
    if blk > round_up(s, 128):
        # the flash function clamps its layout blocks to the 128-padded
        # sequence; a coarser layout block cannot map onto that grid
        raise ValueError(f"config.block={blk} exceeds the padded sequence "
                         f"({round_up(s, 128)}) — use a smaller block")
    layout = config.make_layout(round_up(s, blk), causal=causal)
    return flash_attention(q, k, v, causal=causal,
                           block_layout=torch.from_numpy(layout),
                           block_q=blk, block_k=blk)
