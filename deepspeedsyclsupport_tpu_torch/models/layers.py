"""Transformer building blocks in PyTorch.

Port of ``deepspeedsyclsupport_tpu/models/layers.py`` (norms, rotary and ALiBi
positions, the attention dispatch and its plain version, the no-cache
attention sublayer, the two MLP shapes). Functions take a params dict and
tensors, as the JAX package's do. Normalisation and RoPE compute in float32
and cast back to the input dtype, as the reference does. The JAX package's
sharding ``constrain`` and MFU ``region_scope`` have no meaning on one GPU
and are not carried over.

JAX promotes a bf16 x float32 product to float32 silently; ``torch.matmul``
refuses mixed types. :func:`matmul` reproduces JAX's promotion, so a model
whose activations are bf16 (``cfg.dtype``) runs with float32 params as it
does in the JAX package.

Activations follow the ``[B, S, H, D]`` layout of the reference so that the
parity tests compare like with like.
"""
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig

Params = Dict[str, Any]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp.einsum`` does."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


@functools.lru_cache(maxsize=None)
def device_constant(kind: str, args: tuple, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A constant built on the host once per (kind, args, device, dtype)
    and kept on the device: ``"rope"`` (``rope_frequencies(*args)``),
    ``"alibi"`` (``alibi_slopes(num_heads) * scale``) or ``"scalar"`` (a 0-d
    tensor of ``args[0]``). A forward then makes no host-to-device copy per
    call, which a CUDA graph could not hold and which costs the training
    step a sync. Never written to: every caller shares it."""
    if kind == "rope":
        value = rope_frequencies(*args)
    elif kind == "alibi":
        value = alibi_slopes(args[0]) * args[1]
    elif kind == "scalar":
        value = np.asarray(args[0], np.float64)
    else:
        raise ValueError(f"unknown device constant {kind!r}")
    return torch.from_numpy(value).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """Norm dispatch on ``cfg.norm_type`` over a ``{"scale"[, "bias"]}`` dict."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.rms_norm_eps)
    return rms_norm(x, p["scale"], cfg.rms_norm_eps)


# --------------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotary embedding, split-half convention. x: [B, S, H, D]; positions:
    [B, S] or [S]. ``rotary_dim < D`` rotates only the leading dims (partial
    rotary: GPT-NeoX, GPT-J, Phi); the rest passes through."""
    head_dim = x.shape[-1]
    rd = head_dim if rotary_dim is None else rotary_dim
    x_rot, x_pass = (x, None) if rd == head_dim else (x[..., :rd], x[..., rd:])
    freqs = device_constant("rope", (rd, theta), x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs     # [B, S, rd/2]
    cos = torch.cos(angles)[:, :, None, :]            # [B, S, 1, rd/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    return out if x_pass is None else torch.cat([out, x_pass], dim=-1)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes: the geometric schedule of the ALiBi paper with
    its interpolation for head counts that are not a power of two."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    n = 2 ** int(np.floor(np.log2(num_heads)))
    slopes = pow2_slopes(n)
    if n < num_heads:
        extra = pow2_slopes(2 * n)[0::2][: num_heads - n]
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


# --------------------------------------------------------------------------- attention
def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        alibi: Optional[torch.Tensor] = None,
                        window: Optional[int] = None,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Exact softmax attention in float32 — port of the JAX package's
    ``reference_attention`` (``layers.py:133-210``) for the training
    arguments. q: [B, Sq, H, D], k/v: [B, Skv, KVH, D] (GQA by repeating kv
    heads). Causality compares explicit positions when both are given, else
    ``k_idx <= q_idx + (Skv - Sq)``; ``segment_ids`` [B, S] apply when Sq ==
    Skv; ``alibi`` adds ``slope·(k_pos − q_pos)``; ``window``: queries see
    only the last ``window`` positions. Masked logits are float32's min, so
    a fully masked row comes out uniform, as in the reference. The cached-
    decode arguments (``kv_positions_below``/``kv_mask``) belong to the v1
    engine, which is not ported."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / np.sqrt(d))
    skv = k.shape[1]
    dev = q.device
    explicit = q_positions is not None and kv_positions is not None
    if explicit:
        q_pos = q_positions.long()[:, None, :, None]
        k_pos = kv_positions.long()[:, None, None, :]
    else:
        q_pos = (torch.arange(sq, device=dev) + (skv - sq))[None, None, :,
                                                             None]
        k_pos = torch.arange(skv, device=dev)[None, None, None, :]
    if alibi is not None:
        slopes = torch.as_tensor(alibi, device=dev).float()
        logits = logits + slopes[None, :, None, None] * (k_pos - q_pos).float()
    mask = None
    if causal:
        mask = k_pos <= q_pos
    if window is not None:
        wmask = (q_pos - k_pos) < window
        mask = wmask if mask is None else mask & wmask
    if segment_ids is not None and segment_ids.shape[1] == sq == skv:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None,
              alibi: Optional[torch.Tensor] = None,
              window: Optional[int] = None,
              q_positions: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention dispatch (``layers.py:252-337``):

    * ``auto`` — ``flash`` on a CUDA tensor, the plain path on a CPU tensor;
    * ``flash`` — the hand-written CUDA flash kernels
      (``ops/flash_attention.py``; on a CPU tensor their plain versions);
    * ``xla`` — :func:`reference_attention` (the name is kept so that
      configs carry across);
    * ``ring`` / ``ulysses`` (and ``ring:flash`` / ``ring:xla`` /
      ``ulysses:flash`` / ``ulysses:xla``, the inner attention; bare: flash
      on a CUDA tensor) — sequence parallelism over the ``seq`` axis
      (``parallel/ring_attention.py``, ``parallel/ulysses.py``): ``q`` /
      ``k`` / ``v`` are this rank's chunk of the sequence. Neither takes
      ALiBi or a window (as in the JAX package); ``ring`` takes no
      ``segment_ids`` either, where the JAX package drops them and lets a
      packed batch attend across documents.
    """
    inner = None
    if impl and ":" in impl:
        outer, inner = impl.split(":", 1)
        if outer not in ("ring", "ulysses") or inner not in ("flash", "xla"):
            raise ValueError(f"unknown attention impl {impl!r}")
        impl = outer
    if impl in ("ring", "ulysses"):
        if alibi is not None or window is not None:
            # silently materializing O(S²) logits would defeat the point
            raise NotImplementedError(
                f"attn_impl={impl!r} does not support alibi/sliding-window "
                f"yet; use attn_impl='flash' or 'xla'")
        if impl == "ring":
            if segment_ids is not None:
                raise ValueError(
                    "attn_impl='ring' takes no segment_ids: a packed batch "
                    "would attend across documents (use 'ulysses', which "
                    "masks them exactly)")
            from ..parallel.ring_attention import ring_attention

            return ring_attention(q, k, v, causal=causal, inner=inner)
        from ..parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, causal=causal,
                                 segment_ids=segment_ids, inner=inner)
    if window is not None and not causal and kv_positions is None:
        raise ValueError("window requires causal=True (the sliding window "
                         "only bounds attention to the past)")
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "xla"
    if impl == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, alibi=alibi,
                               window=window, q_positions=q_positions,
                               kv_positions=kv_positions)
    if impl == "xla":
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids, alibi=alibi,
                                   window=window, q_positions=q_positions,
                                   kv_positions=kv_positions)
    raise ValueError(f"unknown attention impl {impl!r} (auto | flash | xla)")


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None,
                    window: Optional[int] = None,
                    tp_axis: Optional[str] = None) -> torch.Tensor:
    """Self-attention sublayer without a KV cache (``layers.py:388-473``):
    qkv projection → RoPE → attention → out projection. ``window`` is the
    layer's sliding window (the caller resolves ``cfg.sliding_window`` /
    ``cfg.attn_windows``). Returns [B, S, hidden].

    ``tp_axis``: the params are this rank's column (q/k/v) and row (o)
    shards over that mesh axis; attention runs on the rank's ``H / tp``
    query and ``KVH / tp`` KV heads (``x`` enters through
    ``copy_to_model_region``, the output leaves through
    ``reduce_from_model_region``, the bias ``bo`` is added after it)."""
    b, s, _ = x.shape
    if tp_axis is not None:
        from ..parallel.tensor_parallel import copy_to_model_region

        x = copy_to_model_region(x, tp_axis)
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_dim)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_dim)
    alibi = (device_constant("alibi", (cfg.num_heads, cfg.alibi_scale),
                             x.device)
             if cfg.pos_embed == "alibi" else None)
    if alibi is not None and tp_axis is not None:
        from ..comm import comm

        h = q.shape[2]
        alibi = alibi[comm.axis_index(tp_axis) * h:][:h]
    if cfg.attn_scale is not None:
        # non-standard logit scale (GPT-Neo uses 1.0), folded into q so that
        # every attention implementation inherits it
        q = q * device_constant(
            "scalar", (cfg.attn_scale * np.sqrt(cfg.head_dim),), q.device,
            q.dtype)
    out = attention(q, k, v, impl=impl or cfg.attn_impl, causal=True,
                    segment_ids=segment_ids, alibi=alibi, window=window)
    out = matmul(out.reshape(b, s, -1), p["wo"])
    if tp_axis is not None:
        from ..parallel.tensor_parallel import reduce_from_model_region

        out = reduce_from_model_region(out, tp_axis)
    if cfg.attn_out_bias:
        out = out + p["bo"].to(out.dtype)
    return out


# --------------------------------------------------------------------------- mlp
def _activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation; "gelu_exact" is erf
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_exact": lambda x: F.gelu(x, approximate="none"),
            "relu": F.relu}[name]


def glu_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated-linear-unit MLP (SwiGLU/GeGLU): act(x W_gate) * (x W_up) W_down."""
    act = _activation(cfg.activation)
    return matmul(act(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                  p["w_down"])


def std_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Two-matrix MLP (fc1 -> act -> fc2), the GPT-2/OPT/BLOOM/Falcon/Phi
    shape."""
    act = _activation(cfg.activation)
    h = matmul(x, p["fc1"])
    if cfg.use_bias:
        h = h + p["b1"].to(h.dtype)
    out = matmul(act(h), p["fc2"])
    if cfg.use_bias:
        out = out + p["b2"].to(out.dtype)
    return out


def mlp_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
              tp_axis: Optional[str] = None) -> torch.Tensor:
    """The MLP; with ``tp_axis`` the params are this rank's column (gate /
    up / fc1) and row (down / fc2) shards: ``x`` enters through
    ``copy_to_model_region`` and the output leaves through
    ``reduce_from_model_region`` (a ``b2`` bias, replicated, after it)."""
    if tp_axis is None:
        return std_mlp(p, x, cfg) if cfg.mlp_type == "mlp" \
            else glu_mlp(p, x, cfg)
    from ..parallel.tensor_parallel import (copy_to_model_region,
                                            reduce_from_model_region)

    x = copy_to_model_region(x, tp_axis)
    if cfg.mlp_type == "mlp":
        act = _activation(cfg.activation)
        h = matmul(x, p["fc1"])
        if cfg.use_bias:
            h = h + p["b1"].to(h.dtype)
        out = reduce_from_model_region(matmul(act(h), p["fc2"]), tp_axis)
        if cfg.use_bias:
            out = out + p["b2"].to(out.dtype)
        return out
    return reduce_from_model_region(glu_mlp(p, x, cfg), tp_axis)
