"""Exact top-k Mixture-of-Experts over a flat token stream (serving).

Port of ``moe_mlp_nodrop`` (``deepspeedsyclsupport_tpu/parallel/moe.py``):
router logits in float32, softmax, top-k, the gate weights renormalised
with a floor of 1e-9; each (token, choice) row goes to its expert's GLU
and the weighted rows are summed back per token. No token is dropped.
The capacity-buffer training path (``moe_mlp``, ``topk_gating``) is not
ported (ROADMAP.md, queue A.3.1).

Two routes compute the expert part, chosen by the tensor's device and
dtype, never by a failure:

* bf16 CUDA tensors take grouped GEMMs (:func:`experts_grouped`): rows
  stably sorted by expert, group ends counted on the device and
  ``torch._grouped_mm`` over the sorted rows (its sm90 grouped kernel takes
  bf16 only). Without ``torch._grouped_mm`` this raises.
* Every other tensor takes the plain version (:func:`experts_plain`): a
  loop over the experts, each over every token, weighted by the token's
  gate for it (0 where the expert was not chosen). ``torch._grouped_mm``
  runs fp16 / fp32 by reading its group ends back to the host, which a
  CUDA graph cannot hold; the plain loop reads nothing back.

Neither route reads back to the host, so the decode step's CUDA graph
holds them. Each token's choices are put in expert order, and its
weighted rows are summed in that order, as the JAX package's scatter-add
sums them: the result does not depend on the order of the sorted rows.
"""
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F


def _activation(name: str) -> Callable:
    # as the JAX package's moe_mlp_nodrop: silu, else gelu (tanh form)
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def topk_route(x: torch.Tensor, router: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of flat tokens ``x`` [T, D]: ``(gate [T, k] float32,
    experts [T, k] int64)``, each token's choices in ascending expert
    order, the gates renormalised over the k choices (floor 1e-9)."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, experts = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    experts, perm = torch.sort(experts, dim=-1)
    return gate.gather(-1, perm), experts


def _combine(y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``sum_c y[:, c] * gate[:, c]`` in ``y``'s dtype, choice by choice.
    y: [T, k, D]; gate: [T, k]."""
    w = gate.to(y.dtype)
    out = y[:, 0] * w[:, 0, None]
    for c in range(1, y.shape[1]):
        out = out + y[:, c] * w[:, c, None]
    return out


def experts_plain(p: Dict[str, Any], x: torch.Tensor, gate: torch.Tensor,
                  experts: torch.Tensor, act: Callable) -> torch.Tensor:
    """The plain version: every expert over every token, weighted by the
    token's gate for it (0 if it did not choose it), summed in expert
    order."""
    out = torch.zeros_like(x)
    for e in range(p["w_gate"].shape[0]):
        w = torch.where(experts == e, gate, 0.0).sum(-1).to(x.dtype)
        y = (act(x @ p["w_gate"][e]) * (x @ p["w_up"][e])) @ p["w_down"][e]
        out = out + y * w[:, None]
    return out


def experts_grouped(p: Dict[str, Any], x: torch.Tensor, gate: torch.Tensor,
                    experts: torch.Tensor, act: Callable) -> torch.Tensor:
    """Grouped GEMMs over the rows sorted by expert
    (``torch._grouped_mm(rows [M, D], w [E, D, F], offs=[E] int32)``);
    the group ends stay on the device."""
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None:
        raise RuntimeError(
            f"MoE serving in bf16 on the card needs torch._grouped_mm "
            f"(PyTorch >= 2.8 on sm90); torch {torch.__version__} has none")
    t, k = experts.shape
    flat = experts.reshape(-1)          # row t * k + c
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(p["w_gate"].shape[0], dtype=torch.int64,
                         device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    offs = counts.cumsum(0).to(torch.int32)
    xs = x[order // k]
    h = act(grouped_mm(xs, p["w_gate"], offs=offs)) \
        * grouped_mm(xs, p["w_up"], offs=offs)
    ys = grouped_mm(h, p["w_down"], offs=offs)
    y = torch.empty_like(ys).index_copy_(0, order, ys)
    return _combine(y.reshape(t, k, -1), gate)


def moe_mlp_nodrop(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """Exact top-k MoE GLU over flat tokens ``x`` [T, D] -> [T, D].
    ``p``: ``router`` [D, E], ``w_gate`` / ``w_up`` [E, D, F], ``w_down``
    [E, F, D], in ``x``'s dtype (the router may be any floating type)."""
    gate, experts = topk_route(x, p["router"], cfg.num_experts_per_tok)
    act = _activation(cfg.activation)
    p = {name: p[name].to(x.dtype) for name in ("w_gate", "w_up", "w_down")}
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        return experts_grouped(p, x, gate, experts, act)
    return experts_plain(p, x, gate, experts, act)
