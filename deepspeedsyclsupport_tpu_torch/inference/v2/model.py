"""Ragged forward over the paged KV cache, in PyTorch.

Port of ``deepspeedsyclsupport_tpu/inference/v2/model.py``: one flat token
stream ``[T]`` with per-token (sequence slot, position) routing; QKV + RoPE,
an append of k/v into the flat-slot pool, attention through the registered
``prefill_attn`` / ``decode_attn`` implementation, MLP, and logits for each
sequence's last scheduled token only. Each layer's quantized weights
(``QuantTensor`` leaves) are dequantized at the top of that layer, and its
MLP is dense or an exact top-k MoE.

Registered implementations:

* ``prefill_attn``: ``kernel`` — the CUDA ragged paged-attention kernel
  over fixed-size single-sequence atoms (``ops/paged_attention.py``);
  ``flash`` — KV gathered once per sequence and packed, then the flash
  kernel with segment ids and explicit positions (``ops/flash_attention``);
  ``xla`` — the plain gather-and-softmax version (port of the JAX package's
  ``_paged_attention``; the name is kept so config values carry across).
* ``decode_attn``: ``kernel`` (alias ``pallas``, so a config written for
  the JAX package still selects the kernel) and ``xla``.

``auto`` picks ``kernel`` on CUDA tensors and ``xla`` on CPU tensors. The
JAX package's ``kernel_interpret`` and ``pallas_interpret`` implementations
are not registered here.

The JAX package runs the layers with ``lax.scan`` over stacked params and
donates the KV pool to a jitted program. Here a Python loop runs over the
per-layer params and k/v are written into the pool IN PLACE. Rows the JAX
package drops (padded tokens, inactive slots) land in the pool's sink block
(``kv_cache.sink_slot``), so the forwards read nothing back to the host:
:func:`decode_forward` and :func:`decode_multi_forward` can be captured in
a CUDA graph.

Across ranks (:class:`ServePlan`, the engine's topology under a process
group) each rank runs the same forward on its shards of the JAX package's
layout (``CausalLM.sharding_rules``): q/k/v and the MLP's gate / up (fc1)
column-parallel, so attention and the paged kernels run on the rank's
``H / tp`` query and ``KVH / tp`` KV heads over its own pool; ``o`` and
``down`` (fc2) row-parallel, each followed by one all-reduce over
``model``; the embedding vocab-parallel; the LM head's ``V / tp`` columns
all-gathered for the rows that are sampled alone (a sequence's last
token, never ``[T, V]``). An MoE layer runs the rank's ``E / ep`` experts
(split on F over ``model``) on every token and all-reduces the partial
``[T, D]`` over (expert, model). The collectives run whenever a plan is
given, at a world of one too, so that path is the one a CUDA graph holds
under NCCL.
"""
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .kv_cache import BlockedKV, sink_slot
from .module_registry import register_impl, select_impl
from ..sampling import sample_token_dyn
from ...compression.quantize import dequantize_tree
from ...models.layers import apply_rope, device_constant, mlp_block, norm
from ...models.transformer import compute_dtype
from ...ops.flash_attention import flash_attention
from ...ops.paged_attention import (paged_decode_attention,
                                    paged_decode_attention_reference,
                                    ragged_prefill_attention)
from ...parallel.moe import moe_mlp_nodrop
from ...parallel.tensor_parallel import vocab_parallel_embedding

NEG_INF = torch.finfo(torch.float32).min
# elements of gathered K per chunk of tokens in the plain (xla) prefill
# attention: bounds its [tokens, max_ctx, H, D] gather to 256 MB of float32
_XLA_CHUNK_ELEMS = 1 << 26


TP_AXIS = "model"


class ServePlan(NamedTuple):
    """This rank's place in the serving mesh: the size of ``model`` (tensor
    parallelism) and of ``expert`` and the rank's index along each."""
    tp: int = 1
    tp_index: int = 0
    ep: int = 1
    ep_index: int = 0

    @property
    def moe_region(self):
        """The axes an MoE layer's partial output is summed over: the
        (expert, model) axes of size > 1, else ``model`` (one all-reduce a
        layer at every size)."""
        live = tuple(a for a, n in (("expert", self.ep), (TP_AXIS, self.tp))
                     if n > 1)
        if len(live) == 2:
            return live
        return live[0] if live else TP_AXIS


def _all_reduce(x, axis):
    from ...comm import comm

    return comm.all_reduce(x, axis)


def _cols(t, plan: Optional[ServePlan], n: int):
    """This rank's ``n`` entries of a replicated vector added to a
    column-parallel output (a bias)."""
    if plan is None or plan.tp == 1:
        return t
    return t.narrow(-1, plan.tp_index * n, n)


class PrefillAttnContext(NamedTuple):
    """Everything a prefill-attention implementation may consume."""
    k_cache: Any
    v_cache: Any
    token_seq: Any
    token_pos: Any
    block_tables: Any
    block_size: int
    alibi: Any
    window: Optional[int]
    atom_qidx: Any = None
    atom_pos0: Any = None
    atom_qlen: Any = None
    atom_tables: Any = None
    atom_inv: Any = None


class DecodeAttnContext(NamedTuple):
    k_cache: Any
    v_cache: Any
    block_tables: Any
    seq_lens: Any
    block_size: int
    alibi: Any
    window: Optional[int]


def _mlp(p, y, cfg, plan: Optional[ServePlan] = None):
    """Per-layer MLP over flat tokens [T, D]: dense (GLU or fc1/fc2), or
    exact top-k MoE (``parallel.moe.moe_mlp_nodrop``); under a plan the
    rank's shards and the all-reduce of their partial outputs."""
    if cfg.any_moe:
        return moe_mlp_nodrop(p["moe"], y, cfg, plan=plan)
    return mlp_block(p["mlp"], y, cfg,
                     tp_axis=None if plan is None else TP_AXIS)


def _qkv(p, y, cfg, n, plan: Optional[ServePlan] = None):
    """qkv projection over flat tokens [n, D] (+ optional biases): the
    rank's heads under a plan."""
    q, k, v = y @ p["wq"], y @ p["wk"], y @ p["wv"]
    if cfg.qkv_bias:
        q = q + _cols(p["bq"], plan, q.shape[-1]).to(q.dtype)
        k = k + _cols(p["bk"], plan, k.shape[-1]).to(k.dtype)
        v = v + _cols(p["bv"], plan, v.shape[-1]).to(v.dtype)
    return (q.reshape(n, -1, cfg.head_dim), k.reshape(n, -1, cfg.head_dim),
            v.reshape(n, -1, cfg.head_dim))


def _attn_out(p, attn, cfg, n, plan: Optional[ServePlan] = None):
    out = attn.reshape(n, -1) @ p["wo"]
    if plan is not None:
        out = _all_reduce(out, TP_AXIS)
    if cfg.attn_out_bias:
        out = out + p["bo"].to(out.dtype)
    return out


def _lane_pad(x, d_pad: int, is_q: bool = False):
    """Zero-pad the trailing head dim to the pool's width. Every attention
    implementation scales scores by 1/sqrt(trailing dim), so q is
    pre-scaled by sqrt(d_pad/d): scores and softmax equal the unpadded ones
    up to one rounding of q. The attention output is sliced back."""
    d = x.shape[-1]
    if d == d_pad:
        return x
    if is_q:
        x = x * device_constant("scalar", (math.sqrt(d_pad / d),), x.device,
                                x.dtype)
    return F.pad(x, (0, d_pad - d))


def _positionize(cfg, q, k, positions):
    if cfg.pos_embed == "rope":
        q = apply_rope(q[None], positions[None], cfg.rope_theta,
                       cfg.rotary_dim)[0]
        k = apply_rope(k[None], positions[None], cfg.rope_theta,
                       cfg.rotary_dim)[0]
    return q, k


def _arch_bias(cfg, device, plan: Optional[ServePlan] = None):
    ab = (device_constant("alibi", (cfg.num_heads, cfg.alibi_scale), device)
          if cfg.pos_embed == "alibi" else None)
    if ab is not None and plan is not None and plan.tp > 1:
        h = cfg.num_heads // plan.tp
        ab = ab[plan.tp_index * h:(plan.tp_index + 1) * h]
    return ab, cfg.sliding_window


def _lookup(table, ids, plan: Optional[ServePlan]):
    if plan is None:
        return table[ids.long()]
    return vocab_parallel_embedding(table, ids, TP_AXIS)


def _embed(params, tokens, positions, cfg, plan: Optional[ServePlan] = None):
    x = _lookup(params["embed"]["embedding"], tokens, plan)
    if cfg.pos_embed == "learned":
        pos = (positions + cfg.pos_embed_offset).clamp(
            0, cfg.max_seq_len + cfg.pos_embed_offset - 1)
        x = x + _lookup(params["pos_embed"]["embedding"], pos,
                        plan).to(x.dtype)
    x = x.to(compute_dtype(cfg))
    if cfg.embed_norm:
        x = norm(x, params["embed_norm"], cfg)
    return x


def _unembed(params, x, cfg, plan: Optional[ServePlan] = None):
    """float32 logits ``[rows, V]`` of the rows of ``x``; under a plan the
    rank's ``V / tp`` columns are all-gathered over ``model``."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(x.dtype)
        if cfg.lm_head_bias:
            logits = logits + _cols(params["lm_head"]["bias"], plan,
                                    logits.shape[-1]).to(logits.dtype)
    logits = logits.float()
    if plan is None:
        return logits
    from ...comm import comm

    return comm.all_gather(logits, TP_AXIS, axis=-1)


def _block(cfg, p, x, attn_fn, plan: Optional[ServePlan] = None):
    """One transformer block over flat tokens: sequential or parallel
    (GPT-J/NeoX/Falcon/Phi) residual form."""
    x_norm = norm(x, p["attn_norm"], cfg)
    attn = attn_fn(x_norm)
    h = _attn_out(p["attn"], attn, cfg, x.shape[0], plan)
    if cfg.parallel_block:
        y = x_norm if cfg.shared_block_norm else norm(x, p["mlp_norm"], cfg)
        return (x + h + _mlp(p, y, cfg, plan)).to(x.dtype)
    x = (x + h).to(x.dtype)
    return (x + _mlp(p, norm(x, p["mlp_norm"], cfg), cfg, plan)).to(x.dtype)


def _paged_attention(q, k_cache, v_cache, token_seq, token_pos, block_tables,
                     block_size: int, alibi=None, window=None):
    """Plain paged attention. q: [T, H, D]; caches: [num_slots, KVH, D];
    block_tables: [S, Bps]. Returns [T, H, D].

    Each token's query attends to its sequence's KV at positions <= its own,
    gathered through the block table (padded tokens, ``token_seq == S``,
    read sequence S-1 as in the JAX package; their rows are never used).
    The ``[T, max_ctx, H, D]`` gather runs in chunks of tokens to bound its
    memory; the arithmetic is the JAX package's."""
    t, h, d = q.shape
    s, bps = block_tables.shape
    max_ctx = bps * block_size
    kvh = k_cache.shape[1]
    j = torch.arange(max_ctx, device=q.device)
    slot_of_pos = block_tables.long()[:, j // block_size] * block_size \
        + j % block_size                                 # [S, max_ctx]
    seq_clip = token_seq.long().clamp(max=s - 1)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    chunk = max(1, _XLA_CHUNK_ELEMS // (max_ctx * h * d))
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        slots = slot_of_pos[seq_clip[sl]]                # [tc, max_ctx]
        k_tok = k_cache[slots].float()                   # [tc, C, KVH, D]
        v_tok = v_cache[slots].float()
        if kvh != h:
            k_tok = k_tok.repeat_interleave(h // kvh, dim=2)
            v_tok = v_tok.repeat_interleave(h // kvh, dim=2)
        pos = token_pos[sl].long()
        logits = torch.einsum("thd,tchd->thc", q[sl].float(), k_tok) * scale
        if alibi is not None:
            logits = logits + alibi.float()[None, :, None] * (
                j[None, None, :] - pos[:, None, None]).float()
        mask = (j[None, :] <= pos[:, None])[:, None, :]
        if window is not None:
            mask = mask & (pos[:, None] - j[None, :] < window)[:, None, :]
        logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out[sl] = torch.einsum("thc,tchd->thd", probs, v_tok).to(q.dtype)
    return out


def _packed_flash_attention(q, k_cache, v_cache, token_seq, token_pos,
                            block_tables, block_size: int, alibi=None,
                            window=None):
    """Chunked-prefill attention through the flash kernel (port of the JAX
    package's ``_packed_flash_attention``): KV is gathered once per
    SEQUENCE (``[S, max_ctx]`` resolved from the block table), flattened
    into one packed stream with per-slot segment ids and positions, and
    the flat token queries attend through ``flash_attention``'s ragged
    cross-attention mode: sequence boundaries from q / kv segment ids,
    causality in position space. Padded tokens carry ``token_seq == S``,
    which matches no kv segment: their rows come out 0."""
    t, h, d = q.shape
    s, bps = block_tables.shape
    bs = block_size
    max_ctx = bps * bs
    dev = q.device
    j = torch.arange(max_ctx, device=dev)
    slot_of_pos = block_tables.long()[:, j // bs] * bs + j % bs
    kvh = k_cache.shape[1]
    k_flat = k_cache[slot_of_pos].reshape(1, s * max_ctx, kvh, d)
    v_flat = v_cache[slot_of_pos].reshape(1, s * max_ctx, kvh, d)
    kv_seg = torch.arange(s, dtype=torch.int32,
                          device=dev).repeat_interleave(max_ctx)[None]
    kv_pos = j.to(torch.int32).repeat(s)[None]
    out = flash_attention(q[None], k_flat, v_flat, causal=True,
                          segment_ids=token_seq[None].to(torch.int32),
                          kv_segment_ids=kv_seg,
                          q_positions=token_pos[None].to(torch.int32),
                          kv_positions=kv_pos, alibi=alibi, window=window)
    return out[0]


# ------------------------------------------ registered prefill-attn impls
def _has_atoms(ctx):
    return bool(ctx.get("has_atoms"))


@register_impl("prefill_attn", "kernel", priority=10, available=_has_atoms,
               auto_eligible=lambda c: _has_atoms(c)
               and c.get("backend") == "cuda",
               metadata={"needs_atoms": True})
def _prefill_kernel_impl(q, ctx: PrefillAttnContext):
    """Ragged paged-attention kernel: q gathers into fixed-size
    single-sequence atoms; the kernel streams each atom's KV through its
    block-table row (no ``[S, max_ctx]`` gather)."""
    q_at = q[ctx.atom_qidx.long()]                      # [A, BQ, H, D]
    out_at = ragged_prefill_attention(
        q_at, ctx.k_cache, ctx.v_cache, ctx.atom_tables, ctx.atom_pos0,
        ctx.atom_qlen, block_size=ctx.block_size, alibi=ctx.alibi,
        window=ctx.window)
    flat = out_at.reshape(-1, *out_at.shape[2:])
    return flat[ctx.atom_inv.long()]                    # back to packed rows


# auto only on the TPU in the JAX package: never auto here
@register_impl("prefill_attn", "flash", priority=5,
               auto_eligible=lambda c: False)
def _prefill_flash_impl(q, ctx: PrefillAttnContext):
    return _packed_flash_attention(q, ctx.k_cache, ctx.v_cache,
                                   ctx.token_seq, ctx.token_pos,
                                   ctx.block_tables, ctx.block_size,
                                   alibi=ctx.alibi, window=ctx.window)


@register_impl("prefill_attn", "xla", priority=0)
def _prefill_xla_impl(q, ctx: PrefillAttnContext):
    return _paged_attention(q, ctx.k_cache, ctx.v_cache, ctx.token_seq,
                            ctx.token_pos, ctx.block_tables, ctx.block_size,
                            alibi=ctx.alibi, window=ctx.window)


# ------------------------------------------- registered decode-attn impls
def _decode_kernel_impl(q, ctx: DecodeAttnContext):
    return paged_decode_attention(
        q, ctx.k_cache, ctx.v_cache, ctx.block_tables, ctx.seq_lens,
        block_size=ctx.block_size, alibi=ctx.alibi, window=ctx.window)


def _decode_xla_impl(q, ctx: DecodeAttnContext):
    return paged_decode_attention_reference(
        q, ctx.k_cache, ctx.v_cache, ctx.block_tables, ctx.seq_lens,
        block_size=ctx.block_size, alibi=ctx.alibi, window=ctx.window)


register_impl("decode_attn", "kernel", priority=10,
              auto_eligible=lambda c: c.get("backend") == "cuda")(
    _decode_kernel_impl)
register_impl("decode_attn", "pallas", priority=10,
              auto_eligible=lambda c: False)(_decode_kernel_impl)
register_impl("decode_attn", "xla", priority=0)(_decode_xla_impl)


def _write_kv(k_cache, v_cache, dest, k, v):
    """Write every k/v row at its flat slot ``dest`` (in place). Rows the
    JAX package drops (``mode="drop"`` past the pool) have ``dest`` in the
    sink block, which no block table names."""
    k_cache.index_copy_(0, dest, k.to(k_cache.dtype))
    v_cache.index_copy_(0, dest, v.to(v_cache.dtype))


@torch.no_grad()
def ragged_forward(model, params: Any, kv: BlockedKV, tokens, token_seq,
                   token_pos, block_tables, last_tok_idx,
                   atom_qidx=None, atom_pos0=None, atom_qlen=None,
                   atom_tables=None, atom_inv=None, *, block_size: int,
                   attn_impl: str = "auto",
                   plan: Optional[ServePlan] = None
                   ) -> Tuple[torch.Tensor, BlockedKV]:
    """Flat-token forward. Returns (per-slot last-token logits [S, V]
    float32, kv). ``kv`` is updated in place and returned for symmetry with
    the JAX package, which returns a new (donated) pool. ``plan``: this
    rank's place in the serving mesh (module docstring)."""
    cfg = model.config
    bs = block_size
    t = tokens.shape[0]
    s, bps = block_tables.shape
    ab, window = _arch_bias(cfg, tokens.device, plan)
    spec = select_impl("prefill_attn", attn_impl, {
        "backend": tokens.device.type, "has_atoms": atom_qidx is not None})

    # padded tokens carry token_seq == S and write the sink block. JAX
    # clamps out-of-range gathers: clamp explicitly here
    dest_block = block_tables.long()[token_seq.long().clamp(max=s - 1),
                                     (token_pos // bs).long().clamp(
                                         max=bps - 1)]
    dest = torch.where(token_seq < s, dest_block * bs
                       + (token_pos % bs).long(), sink_slot(kv, bs))

    x = _embed(params, tokens, token_pos, cfg, plan)
    for li, layer in enumerate(params["layers"]):
        k_cache, v_cache = kv.k[li], kv.v[li]
        # ZeRO-Inference: this layer's QuantTensor leaves, dequantized here
        # so that at most one layer's weights exist dequantized at a time
        p = dequantize_tree(layer, x.dtype)

        def attn_fn(y):
            q, k, v = _qkv(p["attn"], y, cfg, t, plan)
            q, k = _positionize(cfg, q, k, token_pos)
            d_pool = k_cache.shape[-1]
            q = _lane_pad(q, d_pool, is_q=True)
            k, v = _lane_pad(k, d_pool), _lane_pad(v, d_pool)
            _write_kv(k_cache, v_cache, dest, k, v)
            ctx = PrefillAttnContext(
                k_cache=k_cache, v_cache=v_cache, token_seq=token_seq,
                token_pos=token_pos, block_tables=block_tables,
                block_size=bs, alibi=ab, window=window,
                atom_qidx=atom_qidx, atom_pos0=atom_pos0,
                atom_qlen=atom_qlen, atom_tables=atom_tables,
                atom_inv=atom_inv)
            return spec.fn(q, ctx)[..., :cfg.head_dim]

        x = _block(cfg, p, x, attn_fn, plan)
        del p   # this layer's dequantized weights go before the next's

    x = norm(x, params["final_norm"], cfg)
    h_last = x[last_tok_idx.long()]                     # logits gather
    return _unembed(params, h_last, cfg, plan), kv


@torch.no_grad()
def decode_forward(model, params: Any, kv: BlockedKV, tokens, positions,
                   block_tables, active, *, block_size: int,
                   attn_impl: str = "auto",
                   plan: Optional[ServePlan] = None
                   ) -> Tuple[torch.Tensor, BlockedKV]:
    """All-decode forward: one token per slot. ``tokens``/``positions``/
    ``active``: [S]; positions = tokens already cached (the new token
    writes slot ``positions[s]``; an inactive slot writes the sink block).
    Returns (logits [S, V] float32, kv), ``kv`` updated in place. Reads
    nothing back to the host: a CUDA graph can hold it."""
    cfg = model.config
    bs = block_size
    s, bps = block_tables.shape
    ab, window = _arch_bias(cfg, tokens.device, plan)
    spec = select_impl("decode_attn", attn_impl,
                       {"backend": tokens.device.type})

    blk = (positions // bs).long().clamp(max=bps - 1)
    dest_block = block_tables.long().gather(1, blk[:, None])[:, 0]
    dest = torch.where(active, dest_block * bs + (positions % bs).long(),
                       sink_slot(kv, bs))
    seq_lens = torch.where(active, positions + 1, torch.zeros_like(positions))

    x = _embed(params, tokens, positions, cfg, plan)
    for li, layer in enumerate(params["layers"]):
        k_cache, v_cache = kv.k[li], kv.v[li]
        p = dequantize_tree(layer, x.dtype)

        def attn_fn(y):
            q, k, v = _qkv(p["attn"], y, cfg, s, plan)
            q, k = _positionize(cfg, q, k, positions)
            d_pool = k_cache.shape[-1]
            q = _lane_pad(q, d_pool, is_q=True)
            k, v = _lane_pad(k, d_pool), _lane_pad(v, d_pool)
            _write_kv(k_cache, v_cache, dest, k, v)
            return spec.fn(q, DecodeAttnContext(
                k_cache=k_cache, v_cache=v_cache, block_tables=block_tables,
                seq_lens=seq_lens, block_size=bs, alibi=ab,
                window=window))[..., :cfg.head_dim]

        x = _block(cfg, p, x, attn_fn, plan)
        del p

    x = norm(x, params["final_norm"], cfg)
    return _unembed(params, x, cfg, plan), kv


@torch.no_grad()
def decode_multi_forward(model, params: Any, kv: BlockedKV, logits0,
                         positions, block_tables, active, steps_left,
                         generator, temperature, top_p, eos_tok, *,
                         block_size: int, num_steps: int, samp_struct,
                         max_context: int, attn_impl: str = "auto",
                         plan: Optional[ServePlan] = None):
    """``num_steps`` fused decode iterations: sample from the logits, append
    the token's KV through :func:`decode_forward`, advance positions (port
    of the JAX package's ``decode_multi_forward``).

    Per-slot retirement mirrors the host loop exactly: a slot samples
    (emitting the token), decrements its budget, then retires on budget
    exhaustion, EOS or the context cap; the EOS / terminal token is emitted
    but never appended. The JAX package's ``while_loop`` exits once every
    slot has retired; here the body runs all ``num_steps`` (a CUDA graph
    has a fixed length), and a step after the last retirement changes
    nothing but the sink block and the generator, so the outputs are the
    same. The engine's rung ladder bounds that waste.

    ``logits0``: [S, V] last-token logits each slot drained with;
    ``steps_left``: [S] per-slot new-token budgets; ``temperature``,
    ``top_p`` (float32) and ``eos_tok`` (int32, -1 = no EOS) may be 0-d
    device tensors, so one capture serves every value of them;
    ``samp_struct`` is ``SamplingParams.structure``. Reads nothing back to
    the host. Returns ``(tokens [num_steps, S] int32 with -1 for
    retired-slot steps, final logits [S, V], final positions [S], final
    active [S], final steps_left [S], kv)``, ``kv`` updated in place."""
    s = positions.shape[0]
    buf = torch.full((num_steps, s), -1, dtype=torch.int32,
                     device=positions.device)
    logits = logits0.float()
    pos, act, sl = positions, active, steps_left
    for step in range(num_steps):
        tok = sample_token_dyn(logits, generator, temperature, top_p,
                               samp_struct)
        buf[step] = torch.where(act, tok, -1)
        sl = torch.where(act, sl - 1, sl)
        done = (sl <= 0) | ((eos_tok >= 0) & (tok == eos_tok)) \
            | (pos >= max_context)
        append = act & ~done
        new_logits, kv = decode_forward(
            model, params, kv, tok, pos, block_tables, append,
            block_size=block_size, attn_impl=attn_impl, plan=plan)
        logits = torch.where(append[:, None], new_logits, logits)
        pos = torch.where(append, pos + 1, pos)
        act = append
    return buf, logits, pos, act, sl, kv
