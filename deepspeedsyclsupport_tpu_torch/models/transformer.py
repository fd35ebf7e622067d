"""Causal-LM transformer (Llama/Mistral/GPT family) in PyTorch.

Port of ``deepspeedsyclsupport_tpu/models/transformer.py``: the same params
tree (``embed``/``layers``/``final_norm``/``lm_head``, leaf names and shapes
as the JAX package's), but ``layers`` is a Python list of per-layer dicts —
the JAX package stacks them ``[L, ...]`` for ``lax.scan``; here a Python loop
runs over the list. :func:`params_from_jax` converts a JAX params tree.

Ported: the no-cache forward (differentiable ``_forward``; the no-grad
:meth:`CausalLM.apply`), the next-token ``loss`` the training engine calls
(plus ``aux_loss_coef`` times the MoE layers' summed load-balance loss),
and per-layer activation checkpointing (``cfg.remat``).
Attention goes through the ``attention`` dispatch of ``layers.py``
(``cfg.attn_impl``): on the card the flash kernels, on the CPU the plain
version; ``attn_impl="xla"`` keeps the plain version anywhere, which is the
oracle the serving engine and the kernels are held against.
MoE layers (``p["moe"]``: router and stacked experts) run the JAX
package's capacity-buffer ``moe_mlp`` (``parallel/moe.py``) in every
forward here, train and eval alike; the serving engine runs the exact
``moe_mlp_nodrop`` instead. ``router_jitter > 0`` draws its noise from a
``torch.Generator`` (``loss``'s ``rng``): one seed a layer is drawn from
it before the layer runs, so a layer recomputed under activation
checkpointing draws the same noise. Random-LTD and progressive layer
drop are not ported; they raise ``NotImplementedError``.

The KV-cache path (the v1 inference engine's, JAX ``transformer.py:30,
469, 477``): :class:`KVCache` holds ``[L, B, max_len, KVH, D]`` keys and
values and the next slot to fill; :meth:`CausalLM.decode_step` runs the
layers in cache mode (``layers.attention_block``), writing the chunk's
k / v into the cache IN PLACE, so a step allocates no cache; the cache may
live in host memory (``init_kv_cache(host=True)``, the v1 engine's
``kv_offload``), one layer's slice copied to the card as that layer runs.
Quantized layer weights (``QuantTensor`` leaves, ZeRO-Inference) are
dequantized at the top of each layer, as the JAX package does.

The pipelined trunk (``cfg.pipe_stages > 1``): the forward is cut into
:meth:`CausalLM.embed`, :meth:`CausalLM.trunk` (a run of layers, under
remat one checkpoint a layer) and :meth:`CausalLM.head`, and the loss into
:meth:`CausalLM.targets`, :meth:`CausalLM.nll_sum` and
:meth:`CausalLM.token_count`, which ``parallel/pipeline.py`` runs stage by
stage. Called directly, the model runs the layers its params hold in
order, which is the pipeline's function; the JAX package's refusals under
a pipeline stand (random-LTD, progressive layer drop, ``scan_layers=False``).

Distributed training (``runtime/engine.py`` over ``comm/``): the engine
hands its private view of the model a :class:`ParallelPlan`. Under tensor
parallelism (``model`` axis > 1) the params are this rank's shards of the
JAX package's layout (:meth:`CausalLM.sharding_rules`): q/k/v and gate/up
column-parallel, o and down row-parallel, so attention runs on the
``H / tp`` query and ``KVH / tp`` KV heads of this rank through the same
attention dispatch (the flash kernels on the card); the embedding and LM
head are vocab-parallel and the loss is the vocab-parallel cross-entropy
(``parallel/tensor_parallel.py``: the logits stay ``[B, S, V / tp]``).
ZeRO-3's sharded leaves arrive as ``runtime/zero.ZeroShard`` and are
gathered per layer just before it runs (``run_gathered``). An MoE layer
runs ``moe_mlp`` with the plan: its routing over the global token set of
the batch axes, this rank's ``num_experts / ep`` experts (split over
``expert``, and on F over ``model``) between the expert region's
collectives, and its aux loss as this rank's share of the global one. The loss is
this rank's share of the GLOBAL masked mean: its masked sum over the token
count all-reduced over the plan's batch axes (``(data, fsdp)``, and
``seq`` under sequence parallelism, where a rank holds a contiguous chunk
of each row's tokens), so the shares sum to the JAX package's loss over
the global batch whatever the per-rank counts.
"""
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..compression.quantize import dequantize_tree
from ..device import parse_dtype, resolve_device
from ..monitor.mfu import region_scope
from .config import ModelConfig, get_config
from .layers import attention_block, mlp_block, norm
from ..parallel.moe import moe_mlp

Params = Dict[str, Any]


# the mesh axes the model's collectives name: the batch is split over
# BATCH_AXES (the loss's token count is all-reduced over them), tensor
# parallelism runs over TP_AXIS
BATCH_AXES = ("data", "fsdp")
TP_AXIS = "model"


class KVCache(NamedTuple):
    """The decode cache: ``k`` / ``v`` ``[L, B, max_len, KVH, D]`` (under
    tensor parallelism this rank's ``KVH / tp`` heads) and ``write_pos``,
    the next slot to fill (a host int: every row of the batch writes the
    same slots, as in the JAX package)."""
    k: torch.Tensor
    v: torch.Tensor
    write_pos: int


@dataclass(frozen=True)
class ParallelPlan:
    """What the model needs to know of the mesh: the size of ``TP_AXIS``
    (tensor parallelism), the axes the loss's token count is summed over
    (the batch axes, plus ``seq`` under sequence parallelism: an MoE
    layer routes over the tokens of the same axes), and the size of the
    ``expert`` axis (an MoE layer holds ``num_experts / ep`` experts)."""
    tp: int = 1
    batch_axes: Tuple[str, ...] = BATCH_AXES
    ep: int = 1


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype named by ``cfg.dtype`` (a string, as in JAX)."""
    return parse_dtype(str(cfg.dtype))


class CausalLM:
    """Decoder-only LM: ``init_params() -> params``, ``apply(params, ids)``."""

    def __init__(self, config: ModelConfig, seed: int = 0):
        self.config = config
        self.seed = seed
        # set by the engine on its private view under torch.distributed
        self.parallel: Optional[ParallelPlan] = None

    @property
    def _tp_axis(self) -> Optional[str]:
        par = self.parallel
        return TP_AXIS if par is not None and par.tp > 1 else None

    # ------------------------------------------------------------------ init
    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None, dtype: torch.dtype = torch.float32) -> Params:
        """Random params with the JAX package's shapes and scales
        (``transformer.py:48-136``): normal(0, initializer_range) matrices,
        output projections scaled by 1/sqrt(2L), unit norm scales, zero
        biases. Each leaf is drawn in float32 from ``generator`` (seeded
        from ``self.seed`` when None) and cast to ``dtype``, one leaf at a
        time, so a 7B model never holds a float32 copy. ``device="meta"``
        gives the shapes alone (the engine's sharding plan)."""
        cfg = self.config
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(self.seed)
        std = cfg.initializer_range
        out_std = std / np.sqrt(2 * cfg.num_layers)

        def dense(shape, scale=std):
            if dev.type == "meta":
                return torch.empty(shape, device=dev, dtype=dtype)
            x = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale
            return x.to(dtype)

        def zeros(n):
            return torch.zeros((n,), device=dev, dtype=dtype)

        def norm_params() -> Params:
            p = {"scale": torch.ones((cfg.hidden_size,), device=dev,
                                     dtype=dtype)}
            if cfg.norm_type == "layernorm":
                p["bias"] = zeros(cfg.hidden_size)
            return p

        def layer_params() -> Params:
            d, q, kv, f = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                           cfg.intermediate_size)
            attn: Params = {"wq": dense((d, q)), "wk": dense((d, kv)),
                            "wv": dense((d, kv)),
                            "wo": dense((q, d), out_std)}
            if cfg.qkv_bias:
                attn.update(bq=zeros(q), bk=zeros(kv), bv=zeros(kv))
            if cfg.attn_out_bias:
                attn["bo"] = zeros(d)
            p: Params = {"attn_norm": norm_params(), "attn": attn}
            if not cfg.shared_block_norm:
                p["mlp_norm"] = norm_params()
            if cfg.any_moe:
                e = cfg.num_experts
                p["moe"] = {"router": dense((d, e)),
                            "w_gate": dense((e, d, f)),
                            "w_up": dense((e, d, f)),
                            "w_down": dense((e, f, d), out_std)}
            elif cfg.mlp_type == "mlp":
                p["mlp"] = {"fc1": dense((d, f)), "fc2": dense((f, d), out_std)}
                if cfg.use_bias:
                    p["mlp"].update(b1=zeros(f), b2=zeros(d))
            else:
                p["mlp"] = {"w_gate": dense((d, f)), "w_up": dense((d, f)),
                            "w_down": dense((f, d), out_std)}
            return p

        params: Params = {
            "embed": {"embedding": dense((cfg.vocab_size, cfg.hidden_size))},
            "layers": [layer_params() for _ in range(cfg.num_layers)],
            "final_norm": norm_params(),
        }
        if cfg.pos_embed == "learned":
            params["pos_embed"] = {"embedding": dense(
                (cfg.max_seq_len + cfg.pos_embed_offset, cfg.hidden_size))}
        if cfg.embed_norm:
            params["embed_norm"] = norm_params()
        if not cfg.tie_embeddings:
            params["lm_head"] = {
                "kernel": dense((cfg.hidden_size, cfg.vocab_size))}
            if cfg.lm_head_bias:
                params["lm_head"]["bias"] = zeros(cfg.vocab_size)
        return params

    # ------------------------------------------------------------------ forward
    def _check_trunk(self, train: bool) -> None:
        cfg = self.config
        if cfg.pipe_stages is not None and cfg.pipe_stages > 1:
            # the JAX package's refusals under a pipeline (its messages)
            if cfg.random_ltd and train:
                raise ValueError(
                    "pipeline parallelism is incompatible with random-LTD / "
                    "progressive layer dropping (they restructure the stack)")
            if not cfg.scan_layers:
                raise ValueError("pipeline parallelism requires "
                                 "scan_layers=True (stacked layer params)")
        if cfg.random_ltd and train:
            raise NotImplementedError(
                "random-LTD token dropping is not ported yet: ROADMAP.md, "
                "queue A.3.7 (training-time model options)")

    def _layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
               segment_ids: Optional[torch.Tensor], window: Optional[int],
               jitter_seed: Optional[int] = None, regather: bool = True,
               kv: Optional[Dict[str, Any]] = None):
        """One block; returns ``(x, aux)`` with ``aux`` the MoE layer's
        load-balance loss (a float32 tensor; 0.0 for a dense MLP). ZeRO-3
        shards of ``p`` are gathered for the block alone (``regather``:
        no activation checkpointing around it, see ``run_gathered``).
        ``kv``: ``attention_block``'s cache arguments (cache mode)."""
        if self.parallel is None:
            return self._block(p, x, positions, segment_ids, window,
                               jitter_seed, kv)
        from ..runtime.zero import run_gathered

        return run_gathered(p, self._block, x, positions, segment_ids,
                            window, jitter_seed, kv, regather=regather)

    def _block(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
               segment_ids: Optional[torch.Tensor], window: Optional[int],
               jitter_seed: Optional[int] = None,
               kv: Optional[Dict[str, Any]] = None):
        cfg = self.config
        tp_axis = self._tp_axis
        dtype = x.dtype   # pin the activation dtype: fp32 params must not
        #                   promote bf16 activations (transformer.py:149)
        # ZeRO-Inference: this layer's QuantTensor weights, dequantized here
        # so that at most one layer's exist in full at a time (other leaves
        # pass through as they are)
        p = dequantize_tree(p, compute_dtype(cfg))

        def run_mlp(y):
            if cfg.any_moe:
                gen = None
                if jitter_seed is not None:
                    gen = torch.Generator(device=y.device).manual_seed(
                        jitter_seed)
                with region_scope("mlp"):  # MoE is the mlp region too
                    return moe_mlp(p["moe"], y, cfg, gen, plan=self.parallel)
            return mlp_block(p["mlp"], y, cfg, tp_axis=tp_axis), 0.0

        x_norm = norm(x, p["attn_norm"], cfg)
        h = attention_block(p["attn"], x_norm, cfg, positions, segment_ids,
                            window=window, tp_axis=tp_axis, **(kv or {}))
        if cfg.parallel_block:
            y = x_norm if cfg.shared_block_norm else norm(x, p["mlp_norm"], cfg)
            m, aux = run_mlp(y)
            return (x + h + m).to(dtype), aux
        x = (x + h).to(dtype)
        m, aux = run_mlp(norm(x, p["mlp_norm"], cfg))
        return (x + m).to(dtype), aux

    def _gathered(self, tree, fn, *args):
        """``fn(tree, *args)``, ZeRO-3 shards of ``tree`` gathered for the
        call alone."""
        if self.parallel is None:
            return fn(tree, *args)
        from ..runtime.zero import run_gathered

        return run_gathered(tree, fn, *args)

    def _lookup(self, table, ids):
        tp_axis = self._tp_axis
        if tp_axis is None:
            return F.embedding(ids.long(), table)
        from ..parallel.tensor_parallel import vocab_parallel_embedding

        return vocab_parallel_embedding(table, ids, tp_axis)

    def embed(self, params: Params, input_ids: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        """The token (and learned position) embedding and the embedding
        norm: ``[B, S, hidden]`` in the compute dtype (the first pipe
        stage's part), under the ``embed`` MFU region scope."""
        with region_scope("embed"):
            return self._embed(params, input_ids, positions)

    def _embed(self, params, input_ids, positions):
        cfg = self.config
        x = self._gathered(params["embed"],
                           lambda e: self._lookup(e["embedding"], input_ids))
        if cfg.pos_embed == "learned":
            def add_pos(pe, x):
                pos = (positions + cfg.pos_embed_offset).clamp(
                    0, cfg.max_seq_len + cfg.pos_embed_offset - 1)
                return x + self._lookup(pe["embedding"], pos).to(x.dtype)

            x = self._gathered(params["pos_embed"], add_pos, x)
        x = x.to(compute_dtype(cfg))
        if cfg.embed_norm:
            x = self._gathered(params["embed_norm"],
                               lambda p, x: norm(x, p, cfg), x)
        return x

    def trunk(self, layers, x: torch.Tensor, positions: torch.Tensor,
              segment_ids: Optional[torch.Tensor] = None,
              rng: Optional[torch.Generator] = None, first: int = 0,
              cache: Optional[KVCache] = None,
              kv_mask: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None):
        """Run ``layers`` (a list of layer params, the first being layer
        ``first`` of the stack: a pipe stage's block) over ``x``; returns
        ``(x, aux)``. With ``cfg.remat`` (and autograd on) each layer runs
        under ``torch.utils.checkpoint`` (non-reentrant). With ``cache``
        each layer runs in cache mode on its slice of it (written in
        place)."""
        cfg = self.config
        use_remat = cfg.remat and torch.is_grad_enabled()
        jitter = cfg.any_moe and cfg.router_jitter > 0.0
        if jitter and rng is None:
            rng = torch.Generator(device=x.device).manual_seed(self.seed)
        aux = 0.0
        if jitter:
            # a pipe stage's block draws the seeds of its own layers
            for _ in range(first):
                torch.randint(2 ** 62, (1,), generator=rng, device=rng.device)
        for i, p in enumerate(layers, start=first):
            window = (cfg.attn_windows[i] if cfg.attn_windows is not None
                      else cfg.sliding_window)
            seed = None
            if jitter:
                seed = int(torch.randint(2 ** 62, (1,), generator=rng,
                                         device=rng.device))
            kv = None
            if cache is not None:
                kv = {"kv_cache": (cache.k[i], cache.v[i], cache.write_pos),
                      "kv_mask": kv_mask, "kv_positions": kv_positions}
            if use_remat and kv is None:
                x, a = checkpoint(self._layer, p, x, positions, segment_ids,
                                  window, seed, False, use_reentrant=False)
            else:
                x, a = self._layer(p, x, positions, segment_ids, window,
                                   seed, kv=kv)
            aux = aux + a
        return x, aux

    def head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the LM head: float32 logits ``[B, S, V]``
        (under TP this rank's ``V / tp`` columns; the last pipe stage's
        part), under the ``head`` MFU region scope."""
        with region_scope("head"):
            return self._head(params, x)

    def _head(self, params, x):
        cfg = self.config
        tp_axis = self._tp_axis

        def run(hp, x):
            x = norm(x, hp["final_norm"], cfg)
            if tp_axis is not None:
                from ..parallel.tensor_parallel import copy_to_model_region

                x = copy_to_model_region(x, tp_axis)
            if cfg.tie_embeddings:
                return x @ hp["embed"]["embedding"].to(x.dtype).T
            logits = x @ hp["lm_head"]["kernel"].to(x.dtype)
            if cfg.lm_head_bias:
                from .layers import _bias

                logits = logits + _bias(hp["lm_head"]["bias"], logits,
                                        tp_axis)
            return logits

        hp = {"final_norm": params["final_norm"]}
        hp.update({"embed": params["embed"]} if cfg.tie_embeddings
                  else {"lm_head": params["lm_head"]})
        return self._gathered(hp, run, x).float()

    def _forward(self, params: Params, input_ids: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 rng: Optional[torch.Generator] = None,
                 train: bool = True):
        """Differentiable forward over ``input_ids`` [B, S] (no KV cache).
        Returns ``(logits [B, S, V] float32, aux)`` (under tensor
        parallelism this rank's ``V / tp`` vocab columns), ``aux`` the
        layers' summed MoE load-balance loss (a float32 tensor; 0.0 for a
        dense model). With ``cfg.remat`` each
        layer runs under ``torch.utils.checkpoint`` (non-reentrant): its
        activations are recomputed in the backward, the port of
        ``jax.checkpoint`` with policy ``nothing_saveable``. ``rng``: the
        router jitter's generator (a generator seeded from ``self.seed``
        on the ids' device when None, as the JAX package draws from key 0
        without one)."""
        self._check_trunk(train)
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None].expand(
                b, s)
        x = self.embed(params, input_ids, positions)
        x, aux = self.trunk(params["layers"], x, positions, segment_ids, rng)
        return self.head(params, x), aux

    @torch.no_grad()
    def apply(self, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
        """Dense forward over ``input_ids`` [B, S] without autograd. Returns
        float32 logits [B, S, V]. Attention follows ``cfg.attn_impl``
        (``auto``: the flash kernels on the card, the plain version on the
        CPU)."""
        return self._forward(params, input_ids, train=False)[0]

    # ------------------------------------------------------------------ decode
    def init_kv_cache(self, batch_size: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16, device=None,
                      host: bool = False, kv_heads: Optional[int] = None
                      ) -> KVCache:
        """A zeroed :class:`KVCache` on ``device`` (default: the card), or
        with ``host`` in host memory (pinned when a card is present: the
        v1 engine's ``kv_offload``). ``kv_heads``: this rank's KV heads
        (default: all)."""
        cfg = self.config
        shape = (cfg.num_layers, batch_size, max_len,
                 kv_heads or cfg.num_kv_heads, cfg.head_dim)
        if host:
            pin = torch.cuda.is_available()
            mk = lambda: torch.zeros(shape, dtype=dtype, pin_memory=pin)
        else:
            dev = resolve_device(device)
            mk = lambda: torch.zeros(shape, dtype=dtype, device=dev)
        return KVCache(mk(), mk(), 0)

    @torch.no_grad()
    def decode_step(self, params: Params, cache: KVCache,
                    tokens: torch.Tensor,
                    positions: Optional[torch.Tensor] = None,
                    kv_mask: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, KVCache]:
        """One incremental step over ``tokens`` [B, S] (S = 1 for a decode
        step, more for a prefill): writes their k / v into ``cache`` at
        ``write_pos`` in place and returns ``(logits, cache)`` with the
        cache's ``write_pos`` advanced by S. Logits are float32 ``[B, S,
        V]``, or with ``rows`` [B] ``[B, 1, V]`` of row ``rows[b]`` of
        sequence b alone (under tensor parallelism the rank's ``V / tp``
        columns). ``positions`` default to ``write_pos + arange(S)``;
        ``kv_mask`` / ``kv_positions``: the right-padded ragged batch's
        slot validity and slot positions (``layers.attention_block``)."""
        b, s = tokens.shape
        if positions is None:
            positions = (torch.arange(s, device=tokens.device)
                         + cache.write_pos)[None].expand(b, s)
        x = self.embed(params, tokens, positions)
        x, _ = self.trunk(params["layers"], x, positions, cache=cache,
                          kv_mask=kv_mask, kv_positions=kv_positions)
        if rows is not None:
            x = x[torch.arange(b, device=x.device), rows.long()][:, None]
        return self.head(params, x), cache._replace(
            write_pos=cache.write_pos + s)

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Generator] = None, train: bool = True):
        """Next-token cross-entropy (``transformer.py:428-466``), the
        engine's ``loss_fn`` protocol. With ``labels``: positions with
        ``labels < 0`` are masked unless ``loss_mask`` is given (which then
        replaces that mask); without: the labels are ``input_ids`` shifted
        left, the last position masked, times ``loss_mask`` when given. The
        loss is the masked sum over ``max(mask.sum(), 1)``, with a float32
        logsumexp; under a :class:`ParallelPlan` the sum is this rank's and
        the count is all-reduced over the batch axes (this rank's share of
        the global mean), and under TP the logsumexp is the vocab-parallel
        one. An MoE model adds ``aux_loss_coef`` times the layers'
        summed load-balance loss and reports that sum as ``moe_aux_loss``
        (under a plan this rank's share of it, as the LM loss is: the
        shares sum over the batch axes to the global values).
        Returns ``(loss, {"lm_loss": ..., ["moe_aux_loss": ...]})``.
        ``rng``: the router jitter's ``torch.Generator`` (only an MoE model
        with ``router_jitter > 0`` draws from it)."""
        if "pld_theta" in batch:
            if self.config.pipe_stages is not None and \
                    self.config.pipe_stages > 1:
                raise ValueError(
                    "pipeline parallelism is incompatible with random-LTD / "
                    "progressive layer dropping (they restructure the stack)")
            raise NotImplementedError(
                "progressive layer drop is not ported yet: ROADMAP.md, "
                "queue A.3.7 (training-time model options)")
        logits, aux = self._forward(params, batch["input_ids"],
                                    positions=batch.get("positions"),
                                    segment_ids=batch.get("segment_ids"),
                                    rng=rng, train=train)
        with region_scope("loss"):  # softmax-xent MFU region
            labels, mask = self.targets(batch)
            lm_loss = self.nll_sum(logits, labels, mask) / \
                self.token_count(mask).clamp_min(1.0)
            metrics = {"lm_loss": lm_loss.detach()}
            if not self.config.any_moe:
                return lm_loss, metrics
            metrics["moe_aux_loss"] = aux.detach()
            return lm_loss + self.config.aux_loss_coef * aux, metrics

    @staticmethod
    def targets(batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(labels, mask)`` of the loss (``transformer.py:442-452``):
        ``labels`` (negatives masked, or ``loss_mask`` as the mask) or the
        ids shifted left, the last position masked, times ``loss_mask``.
        Under sequence parallelism the engine takes them on the whole row,
        before the split, so a chunk's last label is the next chunk's
        first token."""
        if "labels" in batch:
            labels = batch["labels"].long()
            mask = batch["loss_mask"].float() if "loss_mask" in batch \
                else (labels >= 0).float()
            return labels.clamp_min(0), mask
        ids = batch["input_ids"].long()
        labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
        mask = torch.cat([torch.ones_like(ids[:, 1:], dtype=torch.float32),
                          torch.zeros_like(ids[:, :1], dtype=torch.float32)],
                         dim=1)
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"].float()
        return labels, mask

    def nll_sum(self, logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """The masked sum of the token losses, a float32 logsumexp (under
        TP the vocab-parallel one)."""
        if self._tp_axis is not None:
            from ..parallel.tensor_parallel import vocab_parallel_logz

            logz, gold = vocab_parallel_logz(logits, labels, self._tp_axis)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels[..., None])[..., 0]
        return ((logz - gold) * mask).sum()

    def token_count(self, mask: torch.Tensor) -> torch.Tensor:
        """The loss's denominator before its floor of 1: ``mask``'s sum,
        all-reduced over the plan's batch axes under a process group (the
        global batch's count; none: this rank's, as the ZeRO++ step's local
        loss counts)."""
        count = mask.sum()
        if self.parallel is not None and self.parallel.batch_axes:
            from ..comm import comm

            count = comm.all_reduce(count, self.parallel.batch_axes)
        return count

    # ------------------------------------------------------------------ sharding
    def sharding_rules(self, path, shape) -> Optional[Tuple]:
        """Megatron TP plus explicit FSDP dims (JAX ``transformer.py:493``),
        composed by ``runtime/zero.py`` (which strips ``fsdp`` below stage
        3). ``path``: the JAX leaf path's names (``("layers", "attn",
        "wq")``); a stacked layer leaf leads with its layer dim, which
        shards over ``pipe`` under a pipelined trunk and never otherwise."""
        names = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        s = "/".join(names)
        stacked = "layers" in names and self.config.scan_layers
        if stacked:
            if self.config.pipe_stages is not None:
                pipe = self.config.pipe_stages > 1
            else:
                from ..comm import topology as topo_mod

                t = topo_mod._WORLD_TOPOLOGY
                pipe = t is not None and t.axis_sizes.get("pipe", 1) > 1
            pre: Tuple = ("pipe",) if pipe else (None,)
        else:
            pre = ()
        if s.endswith("embed/embedding"):
            return ("model", "fsdp")
        if s.endswith("lm_head/kernel"):
            return ("fsdp", "model")
        if "attn/" in s or s.endswith(("wq", "wk", "wv", "wo")):
            if s.endswith(("wq", "wk", "wv")):
                return pre + ("fsdp", "model")
            if s.endswith("wo"):
                return pre + ("model", "fsdp")
        if s.endswith(("mlp/w_gate", "mlp/w_up", "mlp/fc1")):
            return pre + ("fsdp", "model")
        if s.endswith(("mlp/w_down", "mlp/fc2")):
            return pre + ("model", "fsdp")
        if s.endswith("pos_embed/embedding"):
            return ("model", "fsdp")
        if s.endswith("moe/router"):
            return pre + (None, None)
        if s.endswith(("moe/w_gate", "moe/w_up")):
            return pre + ("expert", "fsdp", "model")
        if s.endswith("moe/w_down"):
            return pre + ("expert", "model", "fsdp")
        return pre or None


def build_model(name_or_config: Union[str, ModelConfig], **overrides
                ) -> CausalLM:
    """Model factory: a preset name (with config overrides) or a config."""
    if isinstance(name_or_config, ModelConfig):
        cfg = name_or_config
    else:
        cfg = get_config(name_or_config, **overrides)
    return CausalLM(cfg)


def _leaf_to_torch(x, dtype, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)   # numpy has no bfloat16 torch can take
    t = torch.from_numpy(np.array(a))   # a writable copy the tensor owns
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(np_tree: Params, cfg: ModelConfig,
                    dtype: Optional[torch.dtype] = None,
                    device=None) -> Params:
    """Convert a JAX params tree (numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, params)``) into the port's tree.

    Stacked ``[L, ...]`` layer leaves (``cfg.scan_layers``, the default) are
    unstacked into a list of ``L`` per-layer dicts; a list of layers
    (``scan_layers=False``) is converted as it is. Floating leaves are cast
    to ``dtype`` when given."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _leaf_to_torch(t, dtype, dev)

    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return np.asarray(t)[i]

    out = {k: conv(v) for k, v in np_tree.items() if k != "layers"}
    layers = np_tree["layers"]
    if isinstance(layers, dict):
        layers = [unstack(layers, i) for i in range(cfg.num_layers)]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"params carry {len(layers)} layers, config says "
                         f"{cfg.num_layers}")
    out["layers"] = [conv(p) for p in layers]
    return out
