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
checkpointing draws the same noise. The KV-cache ``decode_step``, the
pipelined trunk, random-LTD and progressive layer drop are not ported;
they raise ``NotImplementedError``.
"""
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import parse_dtype, resolve_device
from .config import ModelConfig, get_config
from .layers import attention_block, mlp_block, norm
from ..parallel.moe import moe_mlp

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype named by ``cfg.dtype`` (a string, as in JAX)."""
    return parse_dtype(str(cfg.dtype))


class CausalLM:
    """Decoder-only LM: ``init_params() -> params``, ``apply(params, ids)``."""

    def __init__(self, config: ModelConfig, seed: int = 0):
        self.config = config
        self.seed = seed

    # ------------------------------------------------------------------ init
    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None, dtype: torch.dtype = torch.float32) -> Params:
        """Random params with the JAX package's shapes and scales
        (``transformer.py:48-136``): normal(0, initializer_range) matrices,
        output projections scaled by 1/sqrt(2L), unit norm scales, zero
        biases. Each leaf is drawn in float32 from ``generator`` (seeded
        from ``self.seed`` when None) and cast to ``dtype``, one leaf at a
        time, so a 7B model never holds a float32 copy."""
        cfg = self.config
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(self.seed)
        std = cfg.initializer_range
        out_std = std / np.sqrt(2 * cfg.num_layers)

        def dense(shape, scale=std):
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
            raise NotImplementedError(
                "the pipelined trunk (pipe_stages > 1) is not ported yet: "
                "ROADMAP.md, queue A.3.1 (distributed training)")
        if cfg.random_ltd and train:
            raise NotImplementedError(
                "random-LTD token dropping is not ported yet: ROADMAP.md, "
                "queue A.3.7 (training-time model options)")

    def _layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
               segment_ids: Optional[torch.Tensor], window: Optional[int],
               jitter_seed: Optional[int] = None):
        """One block; returns ``(x, aux)`` with ``aux`` the MoE layer's
        load-balance loss (a float32 tensor; 0.0 for a dense MLP)."""
        cfg = self.config
        dtype = x.dtype   # pin the activation dtype: fp32 params must not
        #                   promote bf16 activations (transformer.py:149)

        def run_mlp(y):
            if cfg.any_moe:
                gen = None
                if jitter_seed is not None:
                    gen = torch.Generator(device=y.device).manual_seed(
                        jitter_seed)
                return moe_mlp(p["moe"], y, cfg, gen)
            return mlp_block(p["mlp"], y, cfg), 0.0

        x_norm = norm(x, p["attn_norm"], cfg)
        h = attention_block(p["attn"], x_norm, cfg, positions, segment_ids,
                            window=window)
        if cfg.parallel_block:
            y = x_norm if cfg.shared_block_norm else norm(x, p["mlp_norm"], cfg)
            m, aux = run_mlp(y)
            return (x + h + m).to(dtype), aux
        x = (x + h).to(dtype)
        m, aux = run_mlp(norm(x, p["mlp_norm"], cfg))
        return (x + m).to(dtype), aux

    def _forward(self, params: Params, input_ids: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 rng: Optional[torch.Generator] = None,
                 train: bool = True):
        """Differentiable forward over ``input_ids`` [B, S] (no KV cache).
        Returns ``(logits [B, S, V] float32, aux)``, ``aux`` the layers'
        summed MoE load-balance loss (a float32 tensor; 0.0 for a dense
        model). With ``cfg.remat`` each
        layer runs under ``torch.utils.checkpoint`` (non-reentrant): its
        activations are recomputed in the backward, the port of
        ``jax.checkpoint`` with policy ``nothing_saveable``. ``rng``: the
        router jitter's generator (a generator seeded from ``self.seed``
        on the ids' device when None, as the JAX package draws from key 0
        without one)."""
        cfg = self.config
        self._check_trunk(train)
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None].expand(
                b, s)
        x = F.embedding(input_ids.long(), params["embed"]["embedding"])
        if cfg.pos_embed == "learned":
            table = params["pos_embed"]["embedding"]
            pos = (positions + cfg.pos_embed_offset).clamp(0, table.shape[0] - 1)
            x = x + F.embedding(pos.long(), table).to(x.dtype)
        x = x.to(compute_dtype(cfg))
        if cfg.embed_norm:
            x = norm(x, params["embed_norm"], cfg)
        jitter = cfg.any_moe and cfg.router_jitter > 0.0
        if jitter and rng is None:
            rng = torch.Generator(device=input_ids.device).manual_seed(
                self.seed)
        aux = 0.0
        for i, p in enumerate(params["layers"]):
            window = (cfg.attn_windows[i] if cfg.attn_windows is not None
                      else cfg.sliding_window)
            seed = None
            if jitter:
                seed = int(torch.randint(2 ** 62, (1,), generator=rng,
                                         device=rng.device))
            if cfg.remat and torch.is_grad_enabled():
                x, a = checkpoint(self._layer, p, x, positions, segment_ids,
                                  window, seed, use_reentrant=False)
            else:
                x, a = self._layer(p, x, positions, segment_ids, window,
                                   seed)
            aux = aux + a
        x = norm(x, params["final_norm"], cfg)
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["embedding"].to(x.dtype).T
        else:
            logits = x @ params["lm_head"]["kernel"].to(x.dtype)
            if cfg.lm_head_bias:
                logits = logits + params["lm_head"]["bias"].to(logits.dtype)
        return logits.float(), aux

    @torch.no_grad()
    def apply(self, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
        """Dense forward over ``input_ids`` [B, S] without autograd. Returns
        float32 logits [B, S, V]. Attention follows ``cfg.attn_impl``
        (``auto``: the flash kernels on the card, the plain version on the
        CPU)."""
        return self._forward(params, input_ids, train=False)[0]

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Generator] = None, train: bool = True):
        """Next-token cross-entropy (``transformer.py:428-466``), the
        engine's ``loss_fn`` protocol. With ``labels``: positions with
        ``labels < 0`` are masked unless ``loss_mask`` is given (which then
        replaces that mask); without: the labels are ``input_ids`` shifted
        left, the last position masked, times ``loss_mask`` when given. The
        loss is the masked sum over ``max(mask.sum(), 1)``, with a float32
        logsumexp. An MoE model adds ``aux_loss_coef`` times the layers'
        summed load-balance loss and reports that sum as ``moe_aux_loss``.
        Returns ``(loss, {"lm_loss": ..., ["moe_aux_loss": ...]})``.
        ``rng``: the router jitter's ``torch.Generator`` (only an MoE model
        with ``router_jitter > 0`` draws from it)."""
        if "pld_theta" in batch:
            raise NotImplementedError(
                "progressive layer drop is not ported yet: ROADMAP.md, "
                "queue A.3.7 (training-time model options)")
        input_ids = batch["input_ids"]
        logits, aux = self._forward(params, input_ids,
                                    positions=batch.get("positions"),
                                    segment_ids=batch.get("segment_ids"),
                                    rng=rng, train=train)
        if "labels" in batch:
            labels = batch["labels"].long()
            mask = batch["loss_mask"].float() if "loss_mask" in batch \
                else (labels >= 0).float()
            labels = labels.clamp_min(0)
        else:
            ids = input_ids.long()
            labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])],
                               dim=1)
            mask = torch.cat([torch.ones_like(ids[:, 1:], dtype=torch.float32),
                              torch.zeros_like(ids[:, :1],
                                               dtype=torch.float32)], dim=1)
            if "loss_mask" in batch:
                mask = mask * batch["loss_mask"].float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None])[..., 0]
        nll = (logz - gold) * mask
        lm_loss = nll.sum() / mask.sum().clamp_min(1.0)
        metrics = {"lm_loss": lm_loss.detach()}
        if not self.config.any_moe:
            return lm_loss, metrics
        metrics["moe_aux_loss"] = aux.detach()
        return lm_loss + self.config.aux_loss_coef * aux, metrics


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
