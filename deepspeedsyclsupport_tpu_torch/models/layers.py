"""Transformer building blocks in PyTorch.

Port of ``deepspeedsyclsupport_tpu/models/layers.py`` (norms, rotary and ALiBi
positions, the two MLP shapes). Functions take a params dict and tensors,
as the JAX package's do. Normalisation and RoPE compute in float32 and cast
back to the input dtype, as the reference does. The JAX package's sharding
``constrain`` and MFU ``region_scope`` have no meaning on one GPU and are
not carried over.

Activations follow the ``[B, S, H, D]`` layout of the reference so that the
parity tests compare like with like.
"""
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig

Params = Dict[str, Any]


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
    freqs = torch.from_numpy(rope_frequencies(rd, theta)).to(x.device)
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
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def std_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Two-matrix MLP (fc1 -> act -> fc2), the GPT-2/OPT/BLOOM/Falcon/Phi
    shape."""
    act = _activation(cfg.activation)
    h = x @ p["fc1"]
    if cfg.use_bias:
        h = h + p["b1"].to(h.dtype)
    out = act(h) @ p["fc2"]
    if cfg.use_bias:
        out = out + p["b2"].to(out.dtype)
    return out


def mlp_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return std_mlp(p, x, cfg) if cfg.mlp_type == "mlp" else glu_mlp(p, x, cfg)
