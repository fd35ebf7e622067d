"""Ragged-batch state: block allocator, sequence descriptors, batch metadata.

Analogs of the reference's ``inference/v2/ragged/`` host-side machinery:

* :class:`BlockedAllocator` — ``ragged/blocked_allocator.py`` free-list of KV
  blocks (there a torch int32 linked list; here a plain Python free list — this
  is host bookkeeping, never on device).
* :class:`SequenceDescriptor` — ``ragged/sequence_descriptor.py``
  (``DSSequenceDescriptor``): tokens seen/scheduled, owned KV blocks.
* :class:`RaggedBatch` — ``ragged/ragged_wrapper.py`` (``RaggedBatchWrapper``):
  the per-forward metadata arrays, built once on host and shipped to device as
  one transfer (the reference stages the same arrays into pinned host buffers).

Static shapes: every array is padded to (max_tokens, max_sequences,
blocks_per_seq), as in the JAX package (``deepspeedsyclsupport_tpu/
inference/v2/ragged.py``), whose numpy-only code this module copies so the
PyTorch port imports nothing of it. The padding keeps batch metadata
array-identical across the two packages (the parity tests pin that).
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class BlockedAllocator:
    """Refcounted KV block free-list (reference ``ragged/blocked_allocator.py``
    plus vLLM-style per-block reference counts for cross-request sharing).

    Serving-loop callers (the scheduler's chunk admission) go through
    :meth:`try_allocate`: exhaustion answers ``None`` so the engine
    surfaces structured backpressure (the sequence stays pending) instead
    of an exception tearing down the whole serving loop. :meth:`allocate`
    keeps the raising contract for callers that pre-checked.

    Sharing contract (prefix cache, docs/serving.md "prefix reuse"): a
    freshly allocated block has refcount 1; every additional holder
    (another stream's block table, the prefix index's pin) must
    :meth:`retain` it, and every holder releases through
    :meth:`release`/:meth:`free` — the block returns to the free list only
    when its LAST holder lets go, so eviction/preempt/failover all route
    through the same refcounted release and can never tear a shared block
    out from under a live stream. ``reclaim_cb`` (installed with the
    prefix cache) is the pressure valve: a shortfall asks the cache to
    unpin cold unshared blocks before the allocator reports exhaustion.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("need at least one block")
        self._free: List[int] = list(range(num_blocks))
        self._refs: List[int] = [0] * num_blocks
        self.num_blocks = num_blocks
        # pressure hook: called with the block shortfall before allocation
        # fails; returns how many blocks it freed (prefix_cache.reclaim)
        self.reclaim_cb = None

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def logical_blocks(self) -> int:
        """Sum of refcounts: block-table entries across all holders. With
        sharing this exceeds the physical ``num_blocks - free_blocks``."""
        return sum(self._refs)

    @property
    def shared_blocks(self) -> int:
        """Physical blocks with more than one holder."""
        return sum(1 for r in self._refs if r > 1)

    def refcount(self, block: int) -> int:
        if not 0 <= block < self.num_blocks:
            raise ValueError(f"refcount of invalid block {block}")
        return self._refs[block]

    def _relieve(self, n: int) -> None:
        if n > len(self._free) and self.reclaim_cb is not None:
            self.reclaim_cb(n - len(self._free))

    def try_allocate(self, n: int) -> Optional[List[int]]:
        """``allocate`` that reports exhaustion (or an injected allocation
        fault) as ``None`` instead of raising — the serving engine's
        backpressure seam."""
        self._relieve(n)
        if n > len(self._free):
            return None
        if n > 0:
            from ...utils.fault_injection import get_fault_injector

            if get_fault_injector().should_fail_kv_alloc():
                return None
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._refs[b] = 1
        return out

    def allocate(self, n: int) -> List[int]:
        self._relieve(n)
        if n > len(self._free):
            raise RuntimeError(
                f"KV cache exhausted: want {n} blocks, {len(self._free)} free")
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._refs[b] = 1
        return out

    def retain(self, blocks: Sequence[int]) -> None:
        """Add one holder to each LIVE block (mapping a cached prefix into
        a new stream's block table; pinning a block into the prefix
        index). Retaining a free block is a bug — it would resurrect
        storage another allocation may already own."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"retaining invalid block {b}")
            if self._refs[b] < 1:
                raise ValueError(f"retain of free block {b}")
        for b in blocks:
            self._refs[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one holder per block; a block returns to the free list only
        at refcount zero. Releasing a free block raises — double free is
        impossible by construction, shared or not."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"freeing invalid block {b}")
            if self._refs[b] < 1:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    # the reference's name; every legacy caller (flush/preempt/failover)
    # routes through the refcounted release
    free = release


@dataclass(eq=False)  # identity semantics: descriptors live in scheduler sets
class SequenceDescriptor:
    """Per-sequence serving state (reference ``DSSequenceDescriptor``)."""

    uid: int
    pending: List[int] = field(default_factory=list)  # tokens awaiting forward
    n_cached: int = 0                                 # tokens with KV in cache
    blocks: List[int] = field(default_factory=list)   # owned KV block ids
    last_logits: Optional[np.ndarray] = None          # set when pending drains
    # --- prefix-cache state (inference/v2/prefix_cache.py) ---------------
    cached_prefix_len: int = 0  # tokens adopted from the prefix cache at
    #                             admission (block-aligned; positions/
    #                             sampling stay exact because token_pos
    #                             continues from n_cached)
    history: List[int] = field(default_factory=list)  # tokens committed to
    #                             KV, in position order (prefix-hash input)
    block_hashes: List[bytes] = field(default_factory=list)  # chained hash
    #                             per FULL block (prefix-trie keys)
    last_scheduled: int = -1   # engine forward-tick of the last chunk (LRU
    #                            eviction + prefill round-robin fairness)
    # --- SLA budget (serving.py admission gate / scheduler slack ordering).
    # All timestamps share one monotonic clock base (time.perf_counter by
    # default — the session's ``clock``); absolute wall time never enters.
    arrival_s: float = 0.0          # when the request was submitted
    deadline_s: Optional[float] = None  # absolute TTFT deadline (None = no SLA)
    rate_sla: float = 0.0           # required decode tokens/s (0 = none)
    tenant: str = "default"         # fairness-budget key
    target_new_tokens: int = 0      # requested generation length
    emitted: int = 0                # decode tokens delivered so far
    first_token_s: Optional[float] = None  # when the first token landed
    last_service_s: float = -1.0    # clock stamp of the last scheduled chunk
    #                                 (starvation aging in slack ordering)

    @property
    def needs_tokens(self) -> int:
        return len(self.pending)

    def blocks_needed(self, new_tokens: int, block_size: int) -> int:
        total = self.n_cached + new_tokens
        want = -(-total // block_size)  # ceil
        return max(0, want - len(self.blocks))


@dataclass
class RaggedBatch:
    """One forward's metadata (reference ``RaggedBatchWrapper``): flat token
    stream + per-token routing + per-sequence block tables. All padded."""

    tokens: np.ndarray        # [T] int32
    token_seq: np.ndarray     # [T] int32, slot id; padded entries = max_sequences
    token_pos: np.ndarray     # [T] int32 position within sequence
    block_tables: np.ndarray  # [S, blocks_per_seq] int32
    last_tok_idx: np.ndarray  # [S] int32 index into tokens of each slot's last chunk token
    seq_active: np.ndarray    # [S] bool
    uids: List[int]           # slot -> uid (host only)
    # atom decomposition (reference atom_builder, ragged_ops/): fixed-size
    # single-sequence q tiles for the ragged paged-attention kernel
    atom_qidx: Optional[np.ndarray] = None    # [A, BQ] packed-row gather idx
    atom_pos0: Optional[np.ndarray] = None    # [A] first q position
    atom_qlen: Optional[np.ndarray] = None    # [A] valid rows (0 = dead atom)
    atom_tables: Optional[np.ndarray] = None  # [A, Bps] owning block-table row
    atom_inv: Optional[np.ndarray] = None     # [T] packed row -> a*BQ + off

    @property
    def current_tokens(self) -> int:
        return int((self.token_seq < len(self.seq_active)).sum())


def build_ragged_batch(chunks: Sequence[Tuple[SequenceDescriptor, int]],
                       max_tokens: int, max_sequences: int,
                       blocks_per_seq: int,
                       atom_q: Optional[int] = None) -> RaggedBatch:
    """Assemble metadata for scheduled ``(descriptor, n_tokens)`` chunks.

    The chunk's tokens are ``desc.pending[:n_tokens]``; positions continue from
    ``desc.n_cached``. Mirrors ``RaggedBatchWrapper.insert_sequence`` +
    ``finalize``.
    """
    if len(chunks) > max_sequences:
        raise ValueError(f"{len(chunks)} chunks > max_sequences {max_sequences}")
    T, S = max_tokens, max_sequences
    tokens = np.zeros((T,), np.int32)
    token_seq = np.full((T,), S, np.int32)   # S = padding sentinel
    token_pos = np.zeros((T,), np.int32)
    block_tables = np.zeros((S, blocks_per_seq), np.int32)
    last_tok = np.zeros((S,), np.int32)
    active = np.zeros((S,), bool)
    uids: List[int] = []

    cursor = 0
    for slot, (desc, n) in enumerate(chunks):
        assert n >= 1 and n <= len(desc.pending)
        if cursor + n > T:
            raise ValueError("token budget overflow — scheduler bug")
        tokens[cursor:cursor + n] = desc.pending[:n]
        token_seq[cursor:cursor + n] = slot
        token_pos[cursor:cursor + n] = np.arange(desc.n_cached,
                                                 desc.n_cached + n)
        block_tables[slot, :len(desc.blocks)] = desc.blocks
        last_tok[slot] = cursor + n - 1
        active[slot] = True
        uids.append(desc.uid)
        cursor += n

    atoms = {}
    if atom_q:
        # atoms: ≤atom_q-row single-sequence q tiles (reference atom_builder).
        # Worst case sum(ceil(n_i/BQ)) ≤ S + T//BQ; slot A_max-1 is reserved
        # DEAD (qlen 0) so padded packed rows gather a guaranteed-zero output
        BQ = atom_q
        A_max = S + T // BQ + 1
        atom_qidx = np.zeros((A_max, BQ), np.int32)
        atom_pos0 = np.zeros((A_max,), np.int32)
        atom_qlen = np.zeros((A_max,), np.int32)
        atom_tables = np.zeros((A_max, blocks_per_seq), np.int32)
        atom_inv = np.full((T,), (A_max - 1) * BQ, np.int32)
        a = 0
        cur = 0
        for slot, (desc, n) in enumerate(chunks):
            pos0 = desc.n_cached
            k = 0
            while k * BQ < n:
                ql = min(BQ, n - k * BQ)
                rows = cur + k * BQ + np.arange(ql)
                atom_qidx[a, :ql] = rows
                atom_pos0[a] = pos0 + k * BQ
                atom_qlen[a] = ql
                atom_tables[a] = block_tables[slot]
                atom_inv[rows] = a * BQ + np.arange(ql)
                a += 1
                k += 1
            cur += n
        assert a <= A_max - 1, "atom overflow — builder bug"
        atoms = dict(atom_qidx=atom_qidx, atom_pos0=atom_pos0,
                     atom_qlen=atom_qlen, atom_tables=atom_tables,
                     atom_inv=atom_inv)
    return RaggedBatch(tokens, token_seq, token_pos, block_tables, last_tok,
                       active, uids, **atoms)
