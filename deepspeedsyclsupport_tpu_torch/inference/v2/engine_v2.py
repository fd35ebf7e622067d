"""InferenceEngineV2 — continuous-batching ragged serving, in PyTorch.

Port of ``deepspeedsyclsupport_tpu/inference/v2/engine_v2.py``: the same
``put / query / flush / can_schedule`` contract over a paged KV cache, the
same host scheduler, the :meth:`generate` loop, fused multi-step decode
(``decode_steps_per_dispatch > 1``), :meth:`warmup` and the cross-request
prefix cache. Each :meth:`put` pass builds the ragged batch on the host,
ships its metadata to the device and runs one ragged forward
(``model.ragged_forward``); pure-decode batches take
``model.decode_forward``. On CUDA both reach the hand-written ragged
paged-attention kernel.

Where the JAX package jits a program, the port on the card replays a CUDA
graph (``graphs.DecodeRunner``): the per-token decode forward is one graph,
and each rung K of the fused decode ladder another, keyed like the JAX
package's compiled programs by ``(K, SamplingParams.structure)`` in an LRU
of 16. Prefill forwards run eagerly. On the CPU every body runs eagerly.

MoE models (``cfg.any_moe``) serve through an exact top-k MoE
(``parallel.moe``). With ``quantize_weights`` the layer weights are held as
int8 or int4 ``QuantTensor`` s (ZeRO-Inference) and each layer is
dequantized when it runs; a params tree whose layers are quantized already
is taken as it is.

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP.md
entry): serialize/deserialize.
"""
import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...compression.quantize import quantize_tree
from ...device import resolve_device
from ..params import place_inference_params
from ..sampling import SamplingParams, sample_token_dyn
from .config import RaggedInferenceConfig
from .graphs import DecodeRunner
from .kv_cache import copy_block, init_blocked_kv
from .model import decode_forward, decode_multi_forward, ragged_forward
from .module_registry import select_impl
from .prefix_cache import PrefixCache, chain_hash
from .ragged import BlockedAllocator, SequenceDescriptor, build_ragged_batch
from .scheduler import schedule_chunks


def _not_ported(what: str, entry: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, "
        f"queue A: {entry})")


@dataclasses.dataclass(frozen=True)
class AdmissionResult:
    """Structured admission decision: who was rejected and why."""
    admitted: Tuple[int, ...]
    reasons: Dict[int, str]  # per rejected uid

    @property
    def rejected(self) -> Tuple[int, ...]:
        return tuple(self.reasons)

    def __bool__(self) -> bool:
        return not self.reasons


class PutResult(Dict[int, torch.Tensor]):
    """:meth:`InferenceEngineV2.put`'s return: {uid: last-token logits} plus
    the admission outcome in ``.admission``."""
    admission: AdmissionResult


def _select(kind: str, name: str, ctx: dict):
    try:
        return select_impl(kind, name, ctx)
    except KeyError as e:
        # get_impl's message already names the registered impls
        raise ValueError(str(e)) from e


class InferenceEngineV2:
    def __init__(self, model, params, config: Optional[dict] = None,
                 device=None, **kw):
        """``device`` None means the card: without one this raises; tests
        pass ``device="cpu"``. ``params`` is the port's params tree
        (``CausalLM.init_params`` or ``params_from_jax``); floating leaves
        are cast to ``config.dtype`` and moved to the device (no copy for
        leaves already in place), ``QuantTensor`` leaves move whole."""
        self.config = (config if isinstance(config, RaggedInferenceConfig)
                       else RaggedInferenceConfig.from_config(config, **kw))
        cfg = self.config
        mcfg = model.config
        if mcfg.attn_windows is not None:
            raise ValueError("per-layer attention windows (attn_windows) are "
                             "not served by the ragged engine, as in the JAX "
                             "package (it requires identical layers)")
        self.model = model
        self.device = resolve_device(device)
        self.params = place_inference_params(params, cfg.dtype, self.device)
        if cfg.quantize_weights:
            # ZeRO-Inference: the placed (cast) layer weights, quantized as
            # the JAX package quantizes them; each forward dequantizes them
            # a layer at a time
            self.params["layers"] = quantize_tree(
                self.params["layers"], cfg.quant_group_size,
                bits=cfg.quant_bits)
        self.kv = init_blocked_kv(mcfg, cfg, self.device)
        self.allocator = BlockedAllocator(cfg.num_blocks)
        self.seqs: Dict[int, SequenceDescriptor] = {}
        # the SLA layer installs a scheduler.SlackPolicy here; None = the
        # least-recently-served ordering
        self.slack_policy = None
        # cross-request prefix cache (install_prefix_cache); None = every
        # stream prefills its full prompt
        self.prefix_cache = None
        self._tick = 0  # forward counter (LRU eviction / prefill fairness)
        self.host_dispatches = 0
        self._generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        # the per-token decode body (one CUDA graph on the card) and the
        # fused K-step bodies keyed by (K, sampling STRUCTURE[, generator]),
        # a bounded LRU as the JAX package's compiled programs are
        self._decode_runner: Optional[DecodeRunner] = None
        self._decode_multi: "OrderedDict[Any, DecodeRunner]" = OrderedDict()
        self._decode_multi_cap = 16
        self._graph_pool = None
        backend = self.device.type
        # atoms feed only impls that declare needs_atoms: decide once
        spec = _select("prefill_attn", cfg.prefill_attn,
                       {"backend": backend, "has_atoms": True})
        self._use_atoms = bool(spec.metadata.get("needs_atoms"))
        _select("decode_attn", cfg.decode_attn, {"backend": backend})

    # ------------------------------------------------------ not yet ported
    def serialize(self, save_path: str) -> None:
        raise _not_ported("serialize", "engine snapshot")

    @classmethod
    def deserialize(cls, save_path: str, **config_overrides):
        raise _not_ported("deserialize", "engine snapshot")

    # --------------------------------------------------------------- warmup
    def warmup(self, fused_ladder: bool = False) -> None:
        """Run the prefill and decode paths once each before serving, as
        the JAX package's ``warmup`` does (there: to compile both KV
        sharding states; here: to build the kernels, warm cuBLAS and, on
        the card, capture the per-token decode graph). With
        ``decode_steps_per_dispatch`` K > 1 it also captures the fused
        rung K for greedy sampling, and with ``fused_ladder=True`` every
        rung the dispatch can select, walking ``max(2, rung // 2)``.
        Leaves the engine clean: no sequences, every block free,
        ``host_dispatches`` 0. Raises if it cannot admit its sequence."""
        cfg = self.config
        uid = -(1 << 40) - 1   # reserved: below any sane caller uid
        n = max(2, min(cfg.max_tokens_per_batch - 1, cfg.max_context - 4, 8))
        for toks in ([[1] * n], [[2]], [[2, 2]], [[2]]):
            out = self.put([uid], toks)
            if uid not in out and out.admission.rejected:
                self.flush([uid])
                raise RuntimeError(
                    f"warmup could not admit its sequence — call warmup() "
                    f"on an idle engine ({dict(out.admission.reasons)})")
        if cfg.decode_steps_per_dispatch > 1:
            k = cfg.decode_steps_per_dispatch
            self.flush([uid])
            self.put([uid], [[2]])
            running = {uid: 2 * k + 1}
            for _ in range(2):
                if uid not in running:
                    break
                self._decode_multi_dispatch(running, SamplingParams(), None,
                                            self._generator)
            if fused_ladder:
                rung = k
                while rung > 2:
                    rung = max(2, rung // 2)
                    self.flush([uid])
                    self.put([uid], [[2]])
                    # k_cap pins the ladder top at `rung`, forcing its
                    # capture (the prefer-captured walk would reuse K)
                    self._decode_multi_dispatch({uid: rung},
                                                SamplingParams(), None,
                                                self._generator, k_cap=rung)
        self.flush([uid])
        self.host_dispatches = 0  # the counter measures serving, not warmup

    # ------------------------------------------------------------- scheduling
    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        """Admission check: sequence slots, per-sequence context limit and
        worst-case KV block pressure."""
        return not self.check_schedule(uids, lengths).rejected

    def check_schedule(self, uids: Sequence[int],
                       lengths: Sequence[int],
                       cached_prefix: Optional[Dict[int, int]] = None
                       ) -> AdmissionResult:
        """Per-uid admission: admits uids in caller order while slots,
        context and KV blocks allow, and names the limit that rejected each
        of the rest. ``cached_prefix`` maps a NEW uid to the prefix-cache
        token count its prompt would adopt (``prefix_cache.peek``): those
        blocks arrive shared, so the KV check prices the novel blocks
        only; context and slot checks are unchanged."""
        cfg = self.config
        slots = len(self.seqs)
        free = self.allocator.free_blocks
        if self.prefix_cache is not None:
            # cold unshared index pins surrender to allocation pressure
            # (allocator.reclaim_cb): count them as free
            free += self.prefix_cache.reclaimable()
        admitted: List[int] = []
        rejected: Dict[int, str] = {}
        seen: set = set()
        for u, n in zip(uids, lengths):
            if u in seen:
                rejected[u] = "duplicate uid in one call (merge the token " \
                              "lists or put() sequentially)"
                continue
            seen.add(u)
            d = self.seqs.get(u)
            cached = (d.n_cached + len(d.pending)) if d else 0
            have = len(d.blocks) if d else 0
            if cached + n > cfg.max_context:
                rejected[u] = (f"context: {cached}+{n} tokens exceeds "
                               f"max_context {cfg.max_context}")
                continue
            if d is None and slots + 1 > cfg.max_sequences:
                rejected[u] = f"slots: engine at max_sequences {cfg.max_sequences}"
                continue
            shared = 0
            if d is None and cached_prefix:
                # the probe leaves >= 1 novel token (same cap here)
                shared = min(int(cached_prefix.get(u, 0)),
                             max(0, n - 1)) // cfg.block_size
            want = max(0, -(-(cached + n) // cfg.block_size) - have - shared)
            if want > free:
                rejected[u] = (f"kv: needs {want} blocks, "
                               f"{free} free in the pool")
                continue
            free -= want
            if d is None:
                slots += 1
            admitted.append(u)
        return AdmissionResult(tuple(admitted), dict(rejected))

    # -------------------------------------------------------------------- put
    def put(self, uids: Sequence[int],
            tokens_list: Sequence[Sequence[int]],
            strict: bool = False, drain: bool = True) -> PutResult:
        """Enqueue tokens and run ragged forwards over what fits.

        Returns {uid: last-token logits [V] (float32, on the device)} for
        sequences whose pending input fully drained, with ``.admission``
        naming rejected uids and why (raise only under ``strict=True``).
        ``drain=False`` runs at most one scheduler pass and forward.

        With a prefix cache installed, each FRESH uid's prompt is probed at
        admission: matched block-aligned prefix blocks are mapped (shared)
        into its block table, only the novel tail is enqueued, and the KV
        check prices the request at its novel blocks."""
        cfg = self.config
        vocab = self.model.config.vocab_size
        for toks in tokens_list:
            for t in toks:
                if not 0 <= int(t) < vocab:
                    raise ValueError(f"token id {int(t)} outside the "
                                     f"vocabulary [0, {vocab})")
        cached_peek: Dict[int, int] = {}
        if self.prefix_cache is not None:
            for uid, toks in zip(uids, tokens_list):
                if toks and self.seqs.get(uid) is None:
                    pk = self.prefix_cache.peek(toks)
                    if pk:
                        cached_peek[uid] = pk
        admission = self.check_schedule(uids, [len(t) for t in tokens_list],
                                        cached_prefix=cached_peek or None)
        if strict and admission.rejected:
            raise RuntimeError(
                f"cannot schedule batch: {dict(admission.reasons)} "
                f"(strict=True; default is structured rejection)")
        admitted_set = set(admission.admitted)
        enqueued: set = set()
        for uid, toks in zip(uids, tokens_list):
            if uid not in admitted_set or uid in enqueued:
                continue
            enqueued.add(uid)
            d = self.seqs.get(uid)
            skip = 0
            if d is None:
                d = self.seqs[uid] = SequenceDescriptor(uid=uid)
                if self.prefix_cache is not None and toks:
                    skip = self.map_cached_prefix(uid, toks)
            d.pending.extend(int(t) for t in toks[skip:])
            d.last_logits = None

        out = PutResult()
        out.admission = admission
        while True:
            chunks = schedule_chunks(
                list(self.seqs.values()), self.allocator,
                max_tokens=cfg.max_tokens_per_batch,
                max_sequences=cfg.max_sequences, block_size=cfg.block_size,
                max_context=cfg.max_context,
                max_prefill_fraction=cfg.max_prefill_fraction,
                policy=self.slack_policy)
            if not chunks:
                break
            if self.prefix_cache is not None:
                for d, n in chunks:
                    self._ensure_writable(d, n)
            logits = self._run(chunks)
            self._tick += 1
            served_s = time.perf_counter()  # aging base for slack ordering
            for slot, (d, n) in enumerate(chunks):
                d.last_scheduled = self._tick
                d.last_service_s = served_s
                if self.prefix_cache is not None:
                    d.history.extend(int(t) for t in d.pending[:n])
                del d.pending[:n]
                d.n_cached += n
                if self.prefix_cache is not None:
                    self._commit_prefix(d)
                if not d.pending:
                    d.last_logits = logits[slot]
                    out[d.uid] = d.last_logits
            if not drain:
                break
            if all(not d.pending for d in self.seqs.values()):
                break
        return out

    def _evict_index(self, uids: Sequence[int]) -> int:
        """Victim index under ``eviction_policy``: longest_context, lru,
        newest (LIFO) or slack (least SLA slack, ties to longest)."""
        policy = self.config.eviction_policy
        if policy == "lru":
            return min(range(len(uids)),
                       key=lambda i: self.seqs[uids[i]].last_scheduled)
        if policy == "newest":
            return max(range(len(uids)),
                       key=lambda i: self.seqs[uids[i]].last_scheduled)
        if policy == "slack":
            from .scheduler import slack_of

            now = time.perf_counter()
            return min(range(len(uids)),
                       key=lambda i: (slack_of(self.seqs[uids[i]], now),
                                      -self.seqs[uids[i]].n_cached))
        return max(range(len(uids)),
                   key=lambda i: self.seqs[uids[i]].n_cached)

    def ensure_seq(self, uid: int, **fields) -> SequenceDescriptor:
        """Create (or fetch) ``uid``'s descriptor and set SLA fields before
        any tokens are enqueued. Unknown fields raise."""
        d = self.seqs.get(uid)
        if d is None:
            d = self.seqs[uid] = SequenceDescriptor(uid=uid)
        for name, value in fields.items():
            if not hasattr(d, name):
                raise AttributeError(
                    f"SequenceDescriptor has no SLA field {name!r}")
            setattr(d, name, value)
        return d

    # ---------------------------------------------------------- prefix cache
    def install_prefix_cache(self, *, scope: str = "tenant",
                             min_block_hits: int = 1,
                             max_pinned_blocks: Optional[int] = None
                             ) -> PrefixCache:
        """Build and wire the cross-request prefix cache: probes at
        admission map cached block-aligned prompt prefixes into new
        streams' block tables, committed full blocks are indexed, and the
        allocator's pressure valve reclaims cold pins. Idempotent: an
        installed cache is returned as it is."""
        if self.prefix_cache is None:
            self.prefix_cache = PrefixCache(
                self.allocator, self.config.block_size, scope=scope,
                min_block_hits=min_block_hits,
                max_pinned_blocks=max_pinned_blocks)
            self.allocator.reclaim_cb = self.prefix_cache.reclaim
        return self.prefix_cache

    def uninstall_prefix_cache(self) -> None:
        """Release every index pin and unwire the pressure valve. Live
        streams keep their mapped blocks (they hold their own
        references)."""
        if self.prefix_cache is not None:
            self.prefix_cache.invalidate()
            self.allocator.reclaim_cb = None
            self.prefix_cache = None

    def map_cached_prefix(self, uid: int, tokens: Sequence[int],
                          tenant: Optional[str] = None) -> int:
        """Probe the prefix cache for ``tokens``' block-aligned head and
        map the matched blocks into ``uid``'s (fresh) block table: the
        blocks are retained (shared), ``n_cached`` / ``cached_prefix_len``
        advance past them, and the caller enqueues only the novel tail.
        Returns the cached token count (0 on a miss, without a cache, or
        for a stream that is not fresh). Positions, sampling and the fused
        decode's pre-funding all derive from ``n_cached``, so a mapped
        prefix is indistinguishable from a prefilled one; the probe leaves
        >= 1 token novel so the stream still runs a forward."""
        pc = self.prefix_cache
        if pc is None or not tokens:
            return 0
        d = self.seqs.get(uid)
        if d is not None and (d.n_cached or d.pending or d.blocks):
            return 0
        if tenant is None:
            tenant = d.tenant if d is not None else "default"
        blocks, hashes, cached = pc.probe(tokens, tenant)
        if not cached:
            return 0
        if d is None:
            d = self.seqs[uid] = SequenceDescriptor(uid=uid, tenant=tenant)
        self.allocator.retain(blocks)
        d.blocks = list(blocks)
        d.n_cached = cached
        d.cached_prefix_len = cached
        d.history = [int(t) for t in tokens[:cached]]
        d.block_hashes = list(hashes)
        return cached

    def _commit_prefix(self, d: SequenceDescriptor) -> None:
        """Index every newly FULL block of ``d`` (after a forward advanced
        ``n_cached``: its KV is committed). Chain hashes extend the
        descriptor's running chain."""
        pc = self.prefix_cache
        bs = self.config.block_size
        full = min(len(d.history), d.n_cached) // bs
        while len(d.block_hashes) < full:
            i = len(d.block_hashes)
            prev = d.block_hashes[-1] if d.block_hashes else b""
            h = chain_hash(prev, d.history[i * bs:(i + 1) * bs])
            d.block_hashes.append(h)
            if i < len(d.blocks):
                pc.offer(d.tenant, h, d.blocks[i])

    def _ensure_writable(self, d: SequenceDescriptor, n_new: int) -> None:
        """Copy-on-write before ``n_new`` KV appends at ``d.n_cached``: a
        block of the write range still shared (refcount > 1) is copied to
        a fresh block (``kv_cache.copy_block``, in place) and the table
        entry repointed. Block-aligned sharing never writes a shared
        block, so this is defence in depth; a copy is counted
        (``cow_copies``), and one that cannot allocate raises."""
        if self.prefix_cache is None or n_new < 1 or not d.blocks:
            return
        alloc = self.allocator
        bs = self.config.block_size
        first = d.n_cached // bs
        last = (d.n_cached + n_new - 1) // bs
        for bi in range(first, min(last + 1, len(d.blocks))):
            b = d.blocks[bi]
            if alloc.refcount(b) <= 1:
                continue
            got = alloc.try_allocate(1)
            if got is None:
                raise RuntimeError(
                    f"copy-on-write: no free block to unshare block {b} of "
                    f"uid {d.uid} — block-aligned sharing should never "
                    f"write a shared block (scheduler/prefix-cache bug)")
            copy_block(self.kv, b, got[0], bs)
            alloc.release([b])
            d.blocks[bi] = got[0]
            self.prefix_cache.note_cow()

    def preempt(self, uid: int) -> Optional[SequenceDescriptor]:
        """Release ``uid``'s KV blocks and slot but return its descriptor
        (emitted count and SLA budget intact, KV state reset) for requeue.
        Shared blocks only lose this stream's reference."""
        d = self.seqs.pop(uid, None)
        if d is None:
            return None
        self.allocator.free(d.blocks)
        d.blocks = []
        d.n_cached = 0
        d.cached_prefix_len = 0
        d.history = []
        d.block_hashes = []
        d.pending.clear()
        d.last_logits = None
        d.last_scheduled = -1
        return d

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run(self, chunks) -> torch.Tensor:
        cfg = self.config
        if all(n == 1 and d.n_cached > 0 for d, n in chunks):
            return self._run_decode(chunks)
        batch = build_ragged_batch(
            chunks, cfg.max_tokens_per_batch, cfg.max_sequences,
            cfg.blocks_per_seq,
            atom_q=cfg.atom_q_size if self._use_atoms else None)
        atom_args = ()
        if self._use_atoms:
            atom_args = tuple(self._to_device(a) for a in (
                batch.atom_qidx, batch.atom_pos0, batch.atom_qlen,
                batch.atom_tables, batch.atom_inv))
        logits, self.kv = ragged_forward(
            self.model, self.params, self.kv, self._to_device(batch.tokens),
            self._to_device(batch.token_seq), self._to_device(batch.token_pos),
            self._to_device(batch.block_tables),
            self._to_device(batch.last_tok_idx), *atom_args,
            block_size=cfg.block_size, attn_impl=cfg.prefill_attn)
        self.host_dispatches += 1
        return logits[:len(chunks)]

    def _slot_arrays(self, descs):
        """Per-slot decode metadata padded to max_sequences: position,
        block table and live mask per slot."""
        cfg = self.config
        s_max = cfg.max_sequences
        positions = np.zeros((s_max,), np.int32)
        tables = np.zeros((s_max, cfg.blocks_per_seq), np.int32)
        active = np.zeros((s_max,), bool)
        for slot, d in enumerate(descs):
            positions[slot] = d.n_cached
            tables[slot, :len(d.blocks)] = d.blocks
            active[slot] = True
        return positions, tables, active

    def _runner(self, body, idle, generator=None) -> DecodeRunner:
        """``body`` as a :class:`DecodeRunner`: a CUDA graph in the engine's
        shared graph pool on the card, the eager body on the CPU."""
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return DecodeRunner(body, idle, self.device, pool=self._graph_pool,
                            generator=generator)

    def _idle_slots(self) -> Dict[str, np.ndarray]:
        """Decode inputs with every slot inactive (the warm-up before a
        capture writes only the sink block)."""
        positions, tables, active = self._slot_arrays([])
        return {"positions": positions, "tables": tables, "active": active}

    def _run_decode(self, chunks) -> torch.Tensor:
        """Pure-decode batches (serving's steady state): one token per
        slot through the decode forward, replayed as one CUDA graph on the
        card (the JAX package's jitted ``_decode_forward``)."""
        cfg = self.config
        if self._decode_runner is None:
            # the body holds the model, params and pool, not the engine: a
            # cycle through the engine would keep its graphs and pool alive
            # past the last reference until the garbage collector ran
            model, params, kv = self.model, self.params, self.kv

            def body(tokens, positions, tables, active):
                return decode_forward(
                    model, params, kv, tokens, positions, tables, active,
                    block_size=cfg.block_size, attn_impl=cfg.decode_attn)[0]

            idle = dict(self._idle_slots(),
                        tokens=np.zeros((cfg.max_sequences,), np.int32))
            self._decode_runner = self._runner(body, idle)
        positions, tables, active = self._slot_arrays([d for d, _n in chunks])
        tokens = np.zeros((cfg.max_sequences,), np.int32)
        for slot, (d, _n) in enumerate(chunks):
            tokens[slot] = d.pending[0]
        logits = self._decode_runner(tokens=tokens, positions=positions,
                                     tables=tables, active=active)
        self.host_dispatches += 1
        # a graph's output is overwritten by its next replay: copy it out
        return logits[:len(chunks)].clone()

    def _multi_key(self, k: int, sp: SamplingParams, generator):
        """The fused decode cache key: the rung and the sampling STRUCTURE,
        and for a sampling structure the generator its graph draws from."""
        return (k, sp.structure) + ((generator,) if sp.do_sample else ())

    def _multi_runner(self, k: int, sp: SamplingParams, generator
                      ) -> DecodeRunner:
        """The fused K-step body for ``(k, sp.structure)`` from the LRU,
        captured (on the card) on first use."""
        cfg = self.config
        key = self._multi_key(k, sp, generator)
        runner = self._decode_multi.get(key)
        if runner is not None:
            self._decode_multi.move_to_end(key)
            return runner
        s_max = cfg.max_sequences
        vocab = self.model.config.vocab_size
        model, params, kv = self.model, self.params, self.kv  # not the engine

        def body(logits0, positions, tables, active, steps_left,
                 temperature, top_p, eos):
            buf, logits, pos, act, sl, _ = decode_multi_forward(
                model, params, kv, logits0, positions, tables,
                active, steps_left, generator, temperature, top_p, eos,
                block_size=cfg.block_size, num_steps=k,
                samp_struct=sp.structure, max_context=cfg.max_context,
                attn_impl=cfg.decode_attn)
            # one host transfer: the [K, S] tokens and the state rows
            return torch.cat([buf.reshape(-1), pos, act.to(torch.int32),
                              sl]), logits

        idle = dict(self._idle_slots(),
                    logits0=torch.zeros((s_max, vocab), dtype=torch.float32,
                                        device=self.device),
                    steps_left=np.zeros((s_max,), np.int32),
                    temperature=np.asarray(1.0, np.float32),
                    top_p=np.asarray(1.0, np.float32),
                    eos=np.asarray(-1, np.int32))
        runner = self._decode_multi[key] = self._runner(
            body, idle, generator if sp.do_sample else None)
        while len(self._decode_multi) > self._decode_multi_cap:
            self._decode_multi.popitem(last=False)
        return runner

    def _decode_multi_dispatch(self, running: Dict[int, int],
                               sp: SamplingParams,
                               eos_token_id: Optional[int],
                               generator: torch.Generator,
                               k_cap: Optional[int] = None
                               ) -> Optional[Dict[int, List[int]]]:
        """Steady-state fused decode: up to K tokens per live sequence in
        ONE dispatch (``model.decode_multi_forward``; a CUDA graph replay on
        the card).

        ``running`` maps each live uid (input fully drained) to its
        remaining new-token budget; it is updated in place and retired
        sequences are flushed. Returns {uid: emitted tokens}, or ``None``
        when the KV pool cannot pre-fund >= 2 steps for the worst case (the
        caller then takes the per-token path, which evicts under pressure).

        K walks the ladder {K, K/2, ..., 2}: the smallest rung covering the
        largest number of steps any live sequence can still absorb (budget
        and context headroom), then the smallest rung already captured at
        or above it. ``k_cap`` bounds the dispatch without forking the
        ladder. KV blocks for the worst-case K appends are allocated up
        front, so the block tables are fixed during the replay; a retiring
        sequence's unused blocks go back with its flush."""
        cfg = self.config
        uids = list(running)
        k = cfg.decode_steps_per_dispatch
        if k_cap is not None:
            cap = max(2, int(k_cap))
            while k > 2 and k > cap:
                k = max(2, k // 2)  # snap DOWN the rung ladder (floor 2)
        absorb = max((min(running[u],
                          max(0, cfg.max_context - self.seqs[u].n_cached))
                      for u in uids), default=0)
        if absorb < 1:
            return None
        ladder = [k]
        while ladder[-1] > 2:
            ladder.append(max(2, ladder[-1] // 2))
        i = max((j for j, r in enumerate(ladder) if r >= absorb), default=0)
        while i > 0 and self._multi_key(ladder[i], sp, generator) \
                not in self._decode_multi:
            i -= 1
        k = ladder[i]

        def _wants(k_steps: int) -> List[int]:
            out = []
            for u in uids:
                d = self.seqs[u]
                appends = min(k_steps, running[u],
                              max(0, cfg.max_context - d.n_cached))
                out.append(d.blocks_needed(appends, cfg.block_size))
            return out

        wants = _wants(k)
        while sum(wants) > self.allocator.free_blocks and k > 2:
            k = max(2, k // 2)
            wants = _wants(k)
        if k < 2 or sum(wants) > self.allocator.free_blocks:
            return None
        for u, w in zip(uids, wants):
            if w:
                got = self.allocator.try_allocate(w)
                if got is None:
                    return None   # blocks already handed out stay owned
                self.seqs[u].blocks.extend(got)
        if self.prefix_cache is not None:
            for u in uids:
                d = self.seqs[u]
                self._ensure_writable(
                    d, min(k, running[u],
                           max(0, cfg.max_context - d.n_cached)))

        runner = self._multi_runner(k, sp, generator)
        s_max = cfg.max_sequences
        n = len(uids)
        positions, tables, active = self._slot_arrays(
            [self.seqs[u] for u in uids])
        steps_left = np.zeros((s_max,), np.int32)
        steps_left[:n] = [running[u] for u in uids]
        stacked = torch.stack([self.seqs[u].last_logits for u in uids])
        logits0 = torch.zeros((s_max, stacked.shape[-1]), dtype=torch.float32,
                              device=self.device)
        logits0[:n] = stacked
        packed, logits = runner(
            logits0=logits0, positions=positions, tables=tables,
            active=active, steps_left=steps_left,
            temperature=np.asarray(sp.temperature, np.float32),
            top_p=np.asarray(sp.top_p, np.float32),
            eos=np.asarray(-1 if eos_token_id is None else eos_token_id,
                           np.int32))
        logits_f = logits.clone()   # the next replay overwrites the output
        self.host_dispatches += 1
        self._tick += k
        host = packed.cpu().numpy()
        toks = host[:k * s_max].reshape(k, s_max)
        pos_h, act_h, sl_h = host[k * s_max:].reshape(3, s_max)
        emitted: Dict[int, List[int]] = {}
        served_s = time.perf_counter()
        for i, u in enumerate(uids):
            d = self.seqs[u]
            emitted[u] = [int(t) for t in toks[:, i] if t >= 0]
            d.n_cached = int(pos_h[i])
            d.last_scheduled = self._tick
            d.last_service_s = served_s
            d.emitted += len(emitted[u])
            if self.prefix_cache is not None:
                # committed = sampled tokens appended to KV; an early-
                # retiring slot appends nothing past its final position
                d.history.extend(emitted[u])
                del d.history[d.n_cached:]
                self._commit_prefix(d)
            if act_h[i]:
                running[u] = int(sl_h[i])
                d.last_logits = logits_f[i]
            else:
                del running[u]
                self.flush([u])
        return emitted

    # ------------------------------------------------------------ query/flush
    def query(self, uid: int) -> Optional[torch.Tensor]:
        """Last-token logits [V] (on the device) once the uid's input has
        drained, else None."""
        d = self.seqs.get(uid)
        return None if d is None else d.last_logits

    def flush(self, uids: Sequence[int]) -> None:
        """Release sequences and their KV blocks."""
        for uid in uids:
            d = self.seqs.pop(uid, None)
            if d is not None:
                self.allocator.free(d.blocks)

    # --------------------------------------------------------------- generate
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> List[List[int]]:
        """Continuous-batching loop: each iteration samples every drained
        sequence's next token and issues ONE put carrying those decode
        tokens plus as many waiting prompts as FIFO admission allows; in
        the steady state (every live sequence drained, nothing admissible)
        with ``decode_steps_per_dispatch`` > 1 it fuses up to K decode
        steps into one dispatch instead. Sequences retire on EOS, length or
        the context cap; under KV pressure the ``eviction_policy`` victim
        is evicted so decode always progresses. ``generator`` defaults to
        the engine's, seeded from ``config.seed``."""
        cfg = self.config
        sp = SamplingParams(do_sample, float(temperature), int(top_k),
                            float(top_p))
        gen = generator if generator is not None else self._generator
        for p in prompts:
            if len(p) > cfg.max_context:
                raise ValueError(f"prompt of {len(p)} tokens can never fit "
                                 f"max_context {cfg.max_context}")
        results: Dict[int, List[int]] = {i: [] for i in range(len(prompts))}
        waiting = [(i, list(p)) for i, p in enumerate(prompts) if p]
        running: Dict[int, int] = {}  # uid -> remaining new-token budget
        uid_base = 1 << 20  # avoid colliding with caller uids

        while waiting or running:
            # 0. steady state: every live sequence decoding and nothing
            # admissible from the backlog (empty, or its head cannot be
            # admitted): fuse up to K decode steps into one dispatch; fall
            # through to the per-token path on KV pressure (it evicts)
            if (cfg.decode_steps_per_dispatch > 1 and running
                    and (not waiting or not self.can_schedule(
                        [uid_base + waiting[0][0]], [len(waiting[0][1])]))
                    and all(self.query(u) is not None for u in running)):
                emitted = self._decode_multi_dispatch(running, sp,
                                                      eos_token_id, gen)
                if emitted is not None:
                    for uid, toks in emitted.items():
                        results[uid - uid_base].extend(toks)
                    continue
            # 1. one batched sample over every drained sequence
            put_uids: List[int] = []
            put_toks: List[List[int]] = []
            drained = [(u, self.query(u)) for u in list(running)]
            drained = [(u, lg) for u, lg in drained if lg is not None]
            if drained:
                toks = sample_token_dyn(
                    torch.stack([lg for _, lg in drained]), gen,
                    sp.temperature, sp.top_p, sp.structure).cpu().numpy()
                self.host_dispatches += 1  # the sampler is a dispatch too
                for (uid, _), tok in zip(drained, toks):
                    tok = int(tok)
                    results[uid - uid_base].append(tok)
                    running[uid] -= 1
                    done = (running[uid] <= 0
                            or (eos_token_id is not None
                                and tok == eos_token_id)
                            or self.seqs[uid].n_cached >= cfg.max_context)
                    if done:  # context-capped sequences truncate
                        del running[uid]
                        self.flush([uid])
                    else:
                        put_uids.append(uid)
                        put_toks.append([tok])
            # 2. KV pressure: evict per the configured policy
            while put_uids and not self.can_schedule(put_uids,
                                                     [1] * len(put_uids)):
                k = self._evict_index(put_uids)
                uid = put_uids.pop(k)
                put_toks.pop(k)
                del running[uid]
                self.flush([uid])
            # 3. FIFO admission, fused into the same put as the decodes
            while waiting:
                idx, ptoks = waiting[0]
                cand_u = put_uids + [uid_base + idx]
                cand_t = put_toks + [ptoks]
                if not self.can_schedule(cand_u, [len(t) for t in cand_t]):
                    break
                waiting.pop(0)
                put_uids, put_toks = cand_u, cand_t
                running[uid_base + idx] = max_new_tokens
            if not put_uids:
                if not running and waiting:
                    raise RuntimeError(
                        "nothing schedulable on an empty engine — prompts "
                        "exceed KV pool limits; raise num_blocks/max_context")
                continue
            self.put(put_uids, put_toks)
        return [results[i] for i in range(len(prompts))]
