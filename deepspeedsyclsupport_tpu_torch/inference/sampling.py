"""Token sampling — greedy, temperature, top-k, top-p (nucleus).

Port of ``deepspeedsyclsupport_tpu/inference/sampling.py``. Randomness comes
from an explicit ``torch.Generator``; it does not reproduce ``jax.random``'s
bits, so sampled streams differ between the packages. Greedy decoding is
exact (``argmax`` picks the first maximum in both) and is what the parity
tests pin.

``temperature`` and ``top_p`` may be 0-d tensors on the device, as the JAX
package's may be traced scalars: the fused decode's CUDA graphs take them
as inputs, so one capture serves every value. Nothing here reads a value
back to the host, so the sampler can run inside a CUDA graph.
"""
from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled

    @property
    def structure(self) -> tuple:
        """``(do_sample, top_k, use_top_p)``: the part a CUDA graph of the
        sampler is captured for (in the JAX package, the compile-relevant
        part); a ``top_p`` tensor keeps the filter in the graph."""
        if not self.do_sample:
            return False, 0, False
        if isinstance(self.top_p, torch.Tensor):
            return True, int(self.top_k), True
        return True, int(self.top_k), float(self.top_p) < 1.0


def sample_token_dyn(logits: torch.Tensor,
                     generator: Optional[torch.Generator],
                     temperature, top_p, structure) -> torch.Tensor:
    """:func:`sample_token` with the reference's static/dynamic split."""
    do_sample, top_k, use_top_p = structure
    return sample_token(logits, generator, SamplingParams(
        do_sample, temperature, top_k, top_p if use_top_p else 1.0))


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 params: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32)."""
    if not params.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if isinstance(params.temperature, torch.Tensor):
        logits = logits.float() / params.temperature.clamp(min=1e-6)
    else:
        logits = logits.float() / max(float(params.temperature), 1e-6)
    if params.top_k and params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.structure[2]:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (>= 1 token)
        keep = cum - probs < params.top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # torch.multinomial's one-sample path without its host-side checks of
    # the probabilities: argmax(p / q), q ~ Exp(1), the same draws and bits
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)
