"""Cross-request KV prefix cache: a block-aligned prefix trie over the
paged pool.

Port of ``deepspeedsyclsupport_tpu/inference/v2/prefix_cache.py``, whose
host-only code this module copies (the PyTorch package imports nothing of
the JAX one). Attention reads KV through per-sequence block tables, so N
streams can point their leading table entries at the SAME physical blocks:
a prefix hit turns most of a prompt's prefill into a block-table copy, and
chunked prefill starts at the first uncached token.

* **block alignment**: only FULL blocks are indexed and a probe matches
  whole blocks only, so a stream's writable frontier is always at or past
  the first block it owns alone; the engine's copy-on-write
  (``_ensure_writable``) is defence in depth, not the steady-state path.
* **chained hashes**: the key of block *i* is ``H(key(i-1) ‖ tokens of
  block i)``, so one hash names the whole prefix up to that block.
* **pinning**: an indexed block holds one allocator reference (the index
  pin), so it outlives the stream that produced it; LRU eviction past
  ``max_pinned_blocks`` and allocator-pressure :meth:`PrefixCache.reclaim`
  release that pin through the same refcounted path as every other holder.
  ``min_block_hits`` > 1 defers the pin until a hash was offered that often.
* **scope**: ``"tenant"`` keys the trie per tenant; ``"global"`` shares it.

Everything here is host bookkeeping; the device sees it only through the
block tables and the allocator's refcounts.
"""
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_GLOBAL_SCOPE = "*"


def chain_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    """Key for the block holding ``tokens``, chained on the previous
    block's key — identifies the entire prefix, not just this block."""
    return hashlib.sha1(
        prev + np.asarray(tokens, np.int64).tobytes()).digest()


class PrefixCache:
    """Block-aligned, tenant-scoped prefix trie over a
    :class:`~.ragged.BlockedAllocator`'s pool.

    The engine owns the instance (``engine.prefix_cache``, installed via
    ``engine.install_prefix_cache``). Counters are plain ints
    (:meth:`stats`).
    """

    def __init__(self, allocator, block_size: int, *,
                 scope: str = "tenant", min_block_hits: int = 1,
                 max_pinned_blocks: Optional[int] = None):
        if scope not in ("tenant", "global"):
            raise ValueError(f"scope must be tenant|global, got {scope!r}")
        if min_block_hits < 1:
            raise ValueError(f"min_block_hits must be >= 1, got "
                             f"{min_block_hits}")
        if max_pinned_blocks is not None and max_pinned_blocks < 1:
            raise ValueError(f"max_pinned_blocks must be >= 1 or None, got "
                             f"{max_pinned_blocks}")
        self.allocator = allocator
        self.block_size = int(block_size)
        self.scope = scope
        self.min_block_hits = int(min_block_hits)
        # default cap: half the pool — the cache must never be able to pin
        # the whole pool against live streams even before reclaim pressure
        self.max_pinned_blocks = (max(1, allocator.num_blocks // 2)
                                  if max_pinned_blocks is None
                                  else int(max_pinned_blocks))
        # (scope_key, chain_hash) -> physical block id; insertion order is
        # recency (move_to_end on every probe touch) — the LRU for both the
        # pin cap and allocator-pressure reclaim
        self._index: "OrderedDict[Tuple[str, bytes], int]" = OrderedDict()
        # hashes seen but not yet pinned (min_block_hits > 1): observation
        # counts only — no block id is stored, so a stale entry can never
        # dangle into reused storage
        self._cand: Dict[Tuple[str, bytes], int] = {}
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "tokens_saved": 0, "blocks_shared": 0,
            "cow_copies": 0, "pins": 0, "unpins": 0}

    # --------------------------------------------------------------- keys
    def _scope_key(self, tenant: str) -> str:
        return tenant if self.scope == "tenant" else _GLOBAL_SCOPE

    def _walk(self, tokens: Sequence[int], tenant: str,
              touch: bool) -> Tuple[List[int], List[bytes]]:
        """Longest indexed block-aligned prefix of ``tokens``. Capped at
        ``len(tokens) - 1`` so at least one token always runs a forward —
        the stream needs logits to decode from."""
        sk = self._scope_key(tenant)
        limit = max(0, (len(tokens) - 1) // self.block_size)
        blocks: List[int] = []
        hashes: List[bytes] = []
        h = b""
        for i in range(limit):
            h = chain_hash(h, tokens[i * self.block_size:
                                     (i + 1) * self.block_size])
            b = self._index.get((sk, h))
            if b is None:
                break
            if touch:
                self._index.move_to_end((sk, h))
            blocks.append(b)
            hashes.append(h)
        return blocks, hashes

    # -------------------------------------------------------------- probe
    def probe(self, tokens: Sequence[int],
              tenant: str = "default") -> Tuple[List[int], List[bytes], int]:
        """Admission-time lookup: ``(blocks, hashes, cached_len)`` for the
        longest cached block-aligned prefix (possibly empty). Counts a hit
        or miss and refreshes the matched entries' recency. The CALLER
        maps the blocks (``allocator.retain`` + block-table entries) —
        the cache itself takes no new references on a probe."""
        blocks, hashes, = self._walk(tokens, tenant, touch=True)
        cached = len(blocks) * self.block_size
        if blocks:
            self.counters["hits"] += 1
            self.counters["tokens_saved"] += cached
            self.counters["blocks_shared"] += len(blocks)
        else:
            self.counters["misses"] += 1
        return blocks, hashes, cached

    def peek(self, tokens: Sequence[int], tenant: str = "default") -> int:
        """Cached-prefix length WITHOUT counters or recency touches — the
        admission gate's pricing input (``n_prefill − cached_prefix_len``),
        called speculatively for requests that may never be admitted."""
        blocks, _ = self._walk(tokens, tenant, touch=False)
        return len(blocks) * self.block_size

    # ------------------------------------------------------------- insert
    def offer(self, tenant: str, chain_h: bytes, block: int) -> bool:
        """Offer one freshly-FULL block for indexing (engine commit path).
        Returns True when the block is now pinned in the index. Repeated
        offers of an already-indexed hash only refresh recency — first
        writer wins, so N streams sharing a prefix converge on one
        physical copy."""
        key = (self._scope_key(tenant), chain_h)
        if key in self._index:
            self._index.move_to_end(key)
            return True
        if self.min_block_hits > 1:
            seen = self._cand.get(key, 0) + 1
            if seen < self.min_block_hits:
                self._cand[key] = seen
                return False
            self._cand.pop(key, None)
        # the index is a holder: the pin keeps the block id valid (never
        # recycled) for as long as the entry lives
        self.allocator.retain([block])
        self.counters["pins"] += 1
        self._index[key] = block
        while len(self._index) > self.max_pinned_blocks:
            self._unpin(next(iter(self._index)))
        return True

    # ----------------------------------------------------------- eviction
    def _unpin(self, key: Tuple[str, bytes]) -> None:
        block = self._index.pop(key)
        self.allocator.release([block])
        self.counters["unpins"] += 1

    def reclaim(self, n_blocks: int) -> int:
        """Allocator-pressure valve (``allocator.reclaim_cb``): release up
        to ``n_blocks`` COLD UNSHARED pins — LRU entries whose block has no
        holder besides the index — and report how many came free. Entries
        still mapped by a live stream (refcount > 1) are skipped: unpinning
        them frees nothing and only forgets a provably-hot prefix."""
        freed = 0
        for key in list(self._index):
            if freed >= n_blocks:
                break
            if self.allocator.refcount(self._index[key]) == 1:
                self._unpin(key)
                freed += 1
        return freed

    def reclaimable(self) -> int:
        """Pins :meth:`reclaim` could surrender right now (refcount 1 —
        no live stream maps them): the engine's admission check counts
        these as free KV headroom."""
        return sum(1 for b in self._index.values()
                   if self.allocator.refcount(b) == 1)

    def invalidate(self, tenant: Optional[str] = None) -> int:
        """Drop (and unpin) every entry — or one tenant's under tenant
        scope. The blunt instrument for tests and operator resets."""
        keys = [k for k in self._index
                if tenant is None or k[0] == self._scope_key(tenant)]
        for k in keys:
            self._unpin(k)
        if tenant is None:
            self._cand.clear()
        else:
            sk = self._scope_key(tenant)
            self._cand = {k: v for k, v in self._cand.items() if k[0] != sk}
        return len(keys)

    # ------------------------------------------------------------ reporting
    def note_cow(self, n: int = 1) -> None:
        self.counters["cow_copies"] += n

    @property
    def pinned_blocks(self) -> int:
        return len(self._index)

    @property
    def hit_ratio(self) -> float:
        lookups = self.counters["hits"] + self.counters["misses"]
        return self.counters["hits"] / lookups if lookups else 0.0

    def stats(self) -> Dict[str, float]:
        return {**self.counters, "pinned_blocks": self.pinned_blocks,
                "hit_ratio": round(self.hit_ratio, 4)}
