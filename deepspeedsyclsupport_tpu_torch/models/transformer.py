"""Causal-LM transformer (Llama/Mistral/GPT family) in PyTorch.

Port of ``deepspeedsyclsupport_tpu/models/transformer.py``: the same params
tree (``embed``/``layers``/``final_norm``/``lm_head``, leaf names and shapes
as the JAX package's), but ``layers`` is a Python list of per-layer dicts —
the JAX package stacks them ``[L, ...]`` for ``lax.scan``; here a Python loop
runs over the list. :func:`params_from_jax` converts a JAX params tree.

Only the dense, no-cache forward is ported (:meth:`CausalLM.apply`). Its
attention is plain causal attention — matmul, mask, softmax, in float32 —
which is the oracle the serving engine is held against.
"""
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..device import parse_dtype, resolve_device
from .config import ModelConfig, get_config
from .layers import alibi_slopes, apply_rope, mlp_block, norm

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype named by ``cfg.dtype`` (a string, as in JAX)."""
    return parse_dtype(str(cfg.dtype))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     alibi: Optional[torch.Tensor] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Exact causal softmax attention. q: [B, S, H, D]; k/v: [B, S, KVH, D]
    (GQA by repeating kv heads). ``alibi``: per-head slopes [H];
    ``window``: queries see only the last ``window`` positions."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(d)
    pos = torch.arange(s, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    if alibi is not None:
        logits = logits + alibi.float()[None, :, None, None] * (
            k_pos - q_pos).float()
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


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
                raise NotImplementedError(
                    "MoE layers are not ported yet (ROADMAP.md, queue A: "
                    "MoE serving)")
            if cfg.mlp_type == "mlp":
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
    def _attention(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
                   window: Optional[int]) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if cfg.qkv_bias:
            q = q + p["bq"].to(q.dtype)
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
        q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        if cfg.pos_embed == "rope":
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_dim)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_dim)
        alibi = (torch.from_numpy(alibi_slopes(cfg.num_heads)
                                  * cfg.alibi_scale).to(x.device)
                 if cfg.pos_embed == "alibi" else None)
        if cfg.attn_scale is not None:
            # non-standard logit scale, folded into q as the reference does
            q = q * torch.tensor(cfg.attn_scale * np.sqrt(cfg.head_dim),
                                 dtype=q.dtype, device=q.device)
        out = causal_attention(q, k, v, alibi=alibi, window=window)
        out = out.reshape(b, s, cfg.q_dim) @ p["wo"]
        if cfg.attn_out_bias:
            out = out + p["bo"].to(out.dtype)
        return out

    def _layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
        cfg = self.config
        dtype = x.dtype
        x_norm = norm(x, p["attn_norm"], cfg)
        h = self._attention(p["attn"], x_norm, positions, window)
        if cfg.parallel_block:
            y = x_norm if cfg.shared_block_norm else norm(x, p["mlp_norm"], cfg)
            return (x + h + mlp_block(p["mlp"], y, cfg)).to(dtype)
        x = (x + h).to(dtype)
        return (x + mlp_block(p["mlp"], norm(x, p["mlp_norm"], cfg),
                              cfg)).to(dtype)

    @torch.no_grad()
    def apply(self, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
        """Dense forward over ``input_ids`` [B, S]. Returns float32 logits
        [B, S, V]."""
        cfg = self.config
        if cfg.any_moe:
            raise NotImplementedError(
                "MoE layers are not ported yet (ROADMAP.md, queue A: MoE "
                "serving)")
        b, s = input_ids.shape
        positions = torch.arange(s, device=input_ids.device)
        x = params["embed"]["embedding"][input_ids]
        if cfg.pos_embed == "learned":
            table = params["pos_embed"]["embedding"]
            pos = (positions + cfg.pos_embed_offset).clamp(0, table.shape[0] - 1)
            x = x + table[pos].to(x.dtype)
        x = x.to(compute_dtype(cfg))
        if cfg.embed_norm:
            x = norm(x, params["embed_norm"], cfg)
        for i, p in enumerate(params["layers"]):
            window = (cfg.attn_windows[i] if cfg.attn_windows is not None
                      else cfg.sliding_window)
            x = self._layer(p, x, positions, window)
        x = norm(x, params["final_norm"], cfg)
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["embedding"].to(x.dtype).T
        else:
            logits = x @ params["lm_head"]["kernel"].to(x.dtype)
            if cfg.lm_head_bias:
                logits = logits + params["lm_head"]["bias"].to(logits.dtype)
        return logits.float()


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
