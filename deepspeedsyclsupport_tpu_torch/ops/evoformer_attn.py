"""EvoformerAttention: DS4Science MSA attention over the flash kernels.

Port of ``deepspeedsyclsupport_tpu/ops/evoformer_attn.py`` (:30-70), the
analog of the reference's ``DS4Sci_EvoformerAttention``: attention over
AlphaFold-style MSA tensors ``[B, N, S, H, D]`` with up to two additive
logit biases,

* ``mask_bias [B, N, 1, 1, Skv]``: per-key residue-mask bias (0 / -inf or
  -1e9), non-differentiable (its gradient is zeros);
* ``pair_bias [B, 1, H, Sq, Skv]``: the pair-representation bias, shared by
  the N MSA rows and differentiable (its gradient sums over N).

The (B, N) leading dims flatten into the flash kernels' batch; the pair
bias rides their broadcast bias input (batch b reads bias batch b // N, so
it is never expanded per row) and the mask bias their k-row bias. On a CUDA
tensor the forward, dQ, dK/dV and reduced-dbias CUDA kernels run
(``csrc/flash_attention.cu``); on a CPU tensor their plain versions.
"""
from typing import List, Optional

import torch

from .flash_attention import flash_attention

__all__ = ["DS4Sci_EvoformerAttention", "evoformer_attention"]


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Optional[List[Optional[torch.Tensor]]] = None
                        ) -> torch.Tensor:
    """q/k/v: ``[B, N, S, H, D]``; ``biases``: up to ``[mask_bias
    [B,N,1,1,Skv], pair_bias [B,1,H,Sq,Skv]]`` (either may be None).
    Returns ``[B, N, Sq, H, D]``, non-causal."""
    if q.dim() != 5:
        raise ValueError(f"expected [B, N, S, H, D], got {tuple(q.shape)}")
    b, n, sq, h, d = q.shape
    skv = k.shape[2]
    mask_bias = pair_bias = None
    for bias in (biases or []):
        if bias is None:
            continue
        if bias.dim() != 5:
            raise ValueError(f"bias rank must be 5, got {tuple(bias.shape)}")
        if bias.shape[2] == 1 and bias.shape[3] == 1:
            mask_bias = bias      # [B, N, 1, 1, Skv]
        elif bias.shape[1] == 1:
            pair_bias = bias      # [B, 1, H, Sq, Skv]
        else:
            raise ValueError(f"unrecognized evoformer bias shape "
                             f"{tuple(bias.shape)} (want [B,N,1,1,S] mask "
                             f"or [B,1,H,S,S] pair)")

    qf = q.reshape(b * n, sq, h, d)
    kf = k.reshape(b * n, skv, h, d)
    vf = v.reshape(b * n, skv, h, d)
    k_bias = (mask_bias.reshape(b * n, skv)
              if mask_bias is not None else None)
    bias = pair_bias[:, 0] if pair_bias is not None else None  # [B,H,Sq,Skv]
    out = flash_attention(qf, kf, vf, causal=False, bias=bias, k_bias=k_bias)
    return out.reshape(b, n, sq, h, d)


# the reference's name (deepspeed/ops/deepspeed4science/evoformer_attn.py)
DS4Sci_EvoformerAttention = evoformer_attention
