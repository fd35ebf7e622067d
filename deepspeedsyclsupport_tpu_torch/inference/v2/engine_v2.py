"""InferenceEngineV2 — continuous-batching ragged serving, in PyTorch.

Port of ``deepspeedsyclsupport_tpu/inference/v2/engine_v2.py``: the same
``put / query / flush / can_schedule`` contract over a paged KV cache, the
same host scheduler, and the per-token :meth:`generate` loop. Each
:meth:`put` pass builds the ragged batch on the host, ships its metadata to
the device and runs one ragged forward (``model.ragged_forward``); pure-decode
batches take ``model.decode_forward``. On CUDA both reach the hand-written
ragged paged-attention kernel.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
entry): fused multi-step decode (``decode_steps_per_dispatch > 1``),
quantized weights, the prefix cache, serialize/deserialize, warmup, MoE
models.
"""
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..params import place_inference_params
from ..sampling import SamplingParams, sample_token_dyn
from .config import RaggedInferenceConfig
from .kv_cache import init_blocked_kv
from .model import decode_forward, ragged_forward
from .module_registry import select_impl
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
        leaves already in place)."""
        self.config = (config if isinstance(config, RaggedInferenceConfig)
                       else RaggedInferenceConfig.from_config(config, **kw))
        cfg = self.config
        mcfg = model.config
        if mcfg.any_moe:
            raise _not_ported("MoE serving", "MoE serving")
        if mcfg.attn_windows is not None:
            raise ValueError("per-layer attention windows (attn_windows) are "
                             "not served by the ragged engine, as in the JAX "
                             "package (it requires identical layers)")
        if cfg.quantize_weights:
            raise _not_ported("quantize_weights", "quantized weights")
        if cfg.decode_steps_per_dispatch > 1:
            raise _not_ported("decode_steps_per_dispatch > 1",
                              "fused-K decode")
        self.model = model
        self.device = resolve_device(device)
        self.params = place_inference_params(params, cfg.dtype, self.device)
        self.kv = init_blocked_kv(mcfg, cfg, self.device)
        self.allocator = BlockedAllocator(cfg.num_blocks)
        self.seqs: Dict[int, SequenceDescriptor] = {}
        # the SLA layer installs a scheduler.SlackPolicy here; None = the
        # least-recently-served ordering
        self.slack_policy = None
        self._tick = 0  # forward counter (LRU eviction / prefill fairness)
        self.host_dispatches = 0
        self._generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
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

    def warmup(self, fused_ladder: bool = False) -> None:
        raise _not_ported("warmup", "warmup")

    def install_prefix_cache(self, **kw):
        raise _not_ported("install_prefix_cache", "prefix cache")

    # ------------------------------------------------------------- scheduling
    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        """Admission check: sequence slots, per-sequence context limit and
        worst-case KV block pressure."""
        return not self.check_schedule(uids, lengths).rejected

    def check_schedule(self, uids: Sequence[int],
                       lengths: Sequence[int]) -> AdmissionResult:
        """Per-uid admission: admits uids in caller order while slots,
        context and KV blocks allow, and names the limit that rejected each
        of the rest."""
        cfg = self.config
        slots = len(self.seqs)
        free = self.allocator.free_blocks
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
            want = max(0, -(-(cached + n) // cfg.block_size) - have)
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
        ``drain=False`` runs at most one scheduler pass and forward."""
        cfg = self.config
        vocab = self.model.config.vocab_size
        for toks in tokens_list:
            for t in toks:
                if not 0 <= int(t) < vocab:
                    raise ValueError(f"token id {int(t)} outside the "
                                     f"vocabulary [0, {vocab})")
        admission = self.check_schedule(uids, [len(t) for t in tokens_list])
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
            if d is None:
                d = self.seqs[uid] = SequenceDescriptor(uid=uid)
            d.pending.extend(int(t) for t in toks)
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
            logits = self._run(chunks)
            self._tick += 1
            served_s = time.perf_counter()  # aging base for slack ordering
            for slot, (d, n) in enumerate(chunks):
                d.last_scheduled = self._tick
                d.last_service_s = served_s
                del d.pending[:n]
                d.n_cached += n
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

    def preempt(self, uid: int) -> Optional[SequenceDescriptor]:
        """Release ``uid``'s KV blocks and slot but return its descriptor
        (emitted count and SLA budget intact, KV state reset) for requeue."""
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

    def _run_decode(self, chunks) -> torch.Tensor:
        """Pure-decode batches (serving's steady state): one token per
        slot through the decode forward."""
        cfg = self.config
        positions, tables, active = self._slot_arrays([d for d, _n in chunks])
        tokens = np.zeros((cfg.max_sequences,), np.int32)
        for slot, (d, _n) in enumerate(chunks):
            tokens[slot] = d.pending[0]
        logits, self.kv = decode_forward(
            self.model, self.params, self.kv, self._to_device(tokens),
            self._to_device(positions), self._to_device(tables),
            self._to_device(active), block_size=cfg.block_size,
            attn_impl=cfg.decode_attn)
        self.host_dispatches += 1
        return logits[:len(chunks)]

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
        tokens plus as many waiting prompts as FIFO admission allows.
        Sequences retire on EOS, length or the context cap; under KV
        pressure the ``eviction_policy`` victim is evicted so decode always
        progresses. ``generator`` defaults to the engine's, seeded from
        ``config.seed``."""
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
