"""Mixture-of-Experts: the capacity-buffer training path and exact top-k
serving.

Port of ``deepspeedsyclsupport_tpu/parallel/moe.py``, on one card and
across ranks. The JAX package writes the MoE layer as one global function
that GSPMD partitions (tokens split over (data, fsdp), experts over
``expert``); here each rank computes its part of that function
(:func:`moe_mlp` with a ``plan``): the routing over the GLOBAL token set
from all-gathered counts (:func:`global_slots`), its ``E / ep`` experts
on its own tokens, and the expert region's two collectives (tokens are
replicated over ``expert`` and ``model``, so no token moves between
ranks: the partial outputs are all-reduced instead).

Training (:func:`topk_gating`, :func:`moe_mlp`): router logits in float32,
softmax, top-k (ties to the lower expert index, as ``jax.lax.top_k``),
the load-balance aux loss ``E * sum_e(mean_prob_e * top1_frac_e)``, and
capacity ``C = max(ceil(T * capacity_factor * k / E), k)`` slots per
expert, every top-1 choice taking a slot before any top-2 spill; a choice
past its expert's capacity is dropped (its token gets nothing from that
expert). :func:`topk_gating` returns the JAX package's dense one-hot
dispatch and combine ``[T, E, C]``; :func:`moe_mlp` computes the same
function from the slot indices instead (a scatter of the kept rows into
``[E, C, D]``, batched expert GEMMs, a gather back weighted by the
combine weights), because the dense ``[k*T, E, C]`` one-hot is 335 MB a
layer in float32 at Mixtral's width and T = 4096. ``router_jitter`` draws
its multiplicative noise from an explicit ``torch.Generator`` (the JAX
package draws from ``jax.random``: the two give other numbers).

Serving (:func:`moe_mlp_nodrop`): router logits in float32, softmax,
top-k, the gate weights renormalised with a floor of 1e-9; each (token,
choice) row goes to its expert's GLU and the weighted rows are summed back
per token. No token is dropped. Two routes compute the expert part,
chosen by the tensor's device and dtype, never by a failure:

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

The expert GEMMs of both paths are plain products (``torch.matmul`` /
``bmm`` / ``_grouped_mm``), as the JAX package leaves them to XLA: no
TPU kernel of the JAX package is on either path.
"""
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def _activation(name: str) -> Callable:
    # as the JAX package's moe_mlp_nodrop: silu, else gelu (tanh form)
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def _topk(logits: torch.Tensor, k: int,
          noise: Optional[torch.Tensor] = None):
    """``(probs [T, E] float32, top_w [T, k], top_e [T, k] int64)``: the
    softmax of the (jittered) logits and its top-k, ties to the lower
    expert index."""
    if noise is not None:
        logits = logits * noise
    probs = torch.softmax(logits.float(), dim=-1)                # [T, E]
    # jax.lax.top_k takes the lower index on a tie; a stable descending
    # sort keeps equal probabilities in index order (torch.topk promises
    # no order among ties)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top_w[:, :k], top_e[:, :k]


def _jitter(shape, dtype, device, generator: Optional[torch.Generator],
            jitter: float) -> Optional[torch.Tensor]:
    """The router's multiplicative noise, uniform in ``[1 - jitter, 1 +
    jitter]`` (None without jitter or generator)."""
    if not (jitter > 0.0 and generator is not None):
        return None
    noise = torch.empty(shape, dtype=dtype, device=device)
    return noise.uniform_(1.0 - jitter, 1.0 + jitter, generator=generator)


def segment_counts(top_e: torch.Tensor, e: int, segments: int = 1
                   ) -> torch.Tensor:
    """``[G, k, E]`` int64: how many of each of ``segments`` (G) runs of
    consecutive tokens chose each expert as their choice ``c``. ``top_e``
    [T, k], T = G x L."""
    t, k = top_e.shape
    onehot = F.one_hot(top_e.reshape(segments, t // segments, k), e)
    return onehot.sum(dim=1)


def global_slots(top_e: torch.Tensor, all_counts: torch.Tensor,
                 mine: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity slots of this rank's (choice, token) rows in the order
    of the GLOBAL token set (the JAX package's cumsum over every token of
    the micro-batch, choice-major), from this rank's choices alone and
    every segment's counts.

    ``top_e`` [T, k]: this rank's choices, its tokens in G segments of L
    consecutive tokens; ``all_counts`` [N, k, E]: every segment's
    :func:`segment_counts` in global token order (candidates before the
    capacity cut: a dropped row still takes its place in the order);
    ``mine`` [G] int64: the global index of each of this rank's segments.
    A row's slot is the count of every segment's rows of earlier choices
    for its expert, plus earlier segments' rows of its choice, plus the
    rows before it in its segment. Returns ``(expert [kT], pos [kT])``,
    row ``c * T + t``; with one segment holding every token it is the
    single-card cumsum."""
    t, k = top_e.shape
    e = all_counts.shape[-1]
    g = int(mine.numel())
    expert = top_e.t().reshape(k * t)
    onehot = F.one_hot(expert, e).view(k, g, t // g, e)
    within = onehot.cumsum(2) - onehot                          # [k,G,L,E]
    totals = all_counts.sum(dim=0)                              # [k, E]
    before_choice = totals.cumsum(0) - totals
    before_seg = all_counts.cumsum(0) - all_counts              # [N, k, E]
    offset = before_choice[:, None] + before_seg[mine].transpose(0, 1)
    pos = (within + offset[:, :, None]).view(k * t, e)
    return expert, pos.gather(1, expert[:, None])[:, 0]


def _capacity_route(logits: torch.Tensor, k: int, capacity: int,
                    generator: Optional[torch.Generator] = None,
                    jitter: float = 0.0, tokens: Optional["_Tokens"] = None):
    """The capacity routing of :func:`topk_gating` over its ``k * T``
    (choice, token) rows, choice-major (row ``c * T + t``: all top-1
    choices first, so they win capacity slots over top-2 spill). Returns
    ``(expert [kT] int64, pos [kT] int64 slot in the expert's buffer,
    keep [kT] bool, gate [kT] float32 renormalised weight, 0 where
    dropped, aux float32 scalar)``. ``tokens`` (a :class:`_Tokens`, under a
    process group): ``logits`` are this rank's tokens of the micro-batch,
    routed over its global token set (``capacity`` is the global one), and
    ``aux`` is this rank's share (:func:`moe_mlp`); None: every token of
    the micro-batch is here."""
    t, e = logits.shape
    if tokens is None:
        tokens = _Tokens(1, t, None, logits.device)
    n = tokens.n
    noise = _jitter((t * n, e), logits.dtype, logits.device, generator,
                    jitter)
    if noise is not None:
        noise = noise.view(tokens.segments, -1, e)[tokens.mine].reshape(t, e)
    probs, top_w, top_e = _topk(logits, k, noise)
    all_counts = tokens.gather(segment_counts(top_e, e, tokens.g))
    expert, pos = global_slots(top_e, all_counts, tokens.mine)
    if n == 1:
        me = probs.mean(dim=0)
        ce = F.one_hot(top_e[:, 0], e).float().mean(dim=0)
    else:
        me = probs.mean(dim=0) / n
        ce = all_counts[:, 0].sum(dim=0).float() / (t * n)
    aux = (me * ce).sum() * e
    keep = pos < capacity
    gate = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    gate = gate.t().reshape(k * t) * keep
    return expert, pos, keep, gate, aux


def topk_gating(logits: torch.Tensor, k: int, capacity: int,
                generator: Optional[torch.Generator] = None,
                jitter: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating with capacity (JAX ``topk_gating``). ``logits`` [T, E].
    Returns ``(dispatch [T, E, C] one-hot, combine [T, E, C] weights,
    aux_loss)`` in float32. ``jitter > 0`` with a ``generator`` multiplies
    the logits by uniform noise in ``[1 - jitter, 1 + jitter]``."""
    t, e = logits.shape
    expert, pos, keep, gate, aux = _capacity_route(logits, k, capacity,
                                                   generator, jitter)
    tok = torch.arange(t, device=logits.device).repeat(k)
    # a dropped row adds 0 to slot 0 of its expert, as the JAX package's
    # zeroed one-hot does
    flat = (tok * e + expert) * capacity + torch.where(keep, pos, 0)
    zeros = torch.zeros(t * e * capacity, dtype=torch.float32,
                        device=logits.device)
    dispatch = zeros.index_add(0, flat, keep.float())
    combine = zeros.index_add(0, flat, gate)
    return (dispatch.view(t, e, capacity), combine.view(t, e, capacity),
            aux)


def capacity(tokens: int, cfg) -> int:
    """Slots per expert: ``max(ceil(T * capacity_factor * k / E), k)``."""
    k = cfg.num_experts_per_tok
    return max(int(math.ceil(tokens * cfg.capacity_factor * k
                             / cfg.num_experts)), k)


class _Tokens:
    """Where this rank's tokens sit in the micro-batch's global token order
    (row-major over (row, position); rows split over (data, fsdp) in rank
    order, positions over ``seq`` in contiguous chunks under sequence
    parallelism): ``n`` ranks share the micro-batch, and this rank's T
    tokens are G segments of L consecutive global tokens (G = its rows
    under sequence parallelism, else 1) whose global segment indices, of
    ``segments``, are ``mine`` [G]. Without a plan every token is here
    (n = G = 1)."""

    def __init__(self, rows: int, t: int, plan, device):
        from ..comm import comm

        axes = tuple(getattr(plan, "batch_axes", ()) or ())
        sizes = {a: comm.axis_size(a) for a in axes}
        self.axes = tuple(a for a in axes if sizes[a] > 1)
        self.n = math.prod(sizes.values()) if sizes else 1
        self.sp = sizes.get("seq", 1)
        self.g = rows if self.sp > 1 else 1
        r = comm.axis_index(("data", "fsdp")) if self.n > self.sp else 0
        q = comm.axis_index("seq") if self.sp > 1 else 0
        self.segments = self.n * self.g
        self.mine = (r * self.g) * self.sp + q + self.sp * torch.arange(
            self.g, device=device)

    def gather(self, counts: torch.Tensor) -> torch.Tensor:
        """Every rank's :func:`segment_counts` ``[G, k, E]`` -> ``[N, k,
        E]`` in global segment order (one all-gather over the batch
        axes)."""
        from ..comm import comm

        if not self.axes:
            return counts
        axis = self.axes[0] if len(self.axes) == 1 else self.axes
        got = comm.all_gather(counts, axis, tiled=False)   # [n, G, k, E]
        got = got.view(self.n // self.sp, self.sp, *counts.shape)
        return got.transpose(1, 2).reshape(self.segments,
                                           *counts.shape[1:])


def expert_region(plan) -> Optional[Any]:
    """The axes an MoE layer's expert part is partial over: ``expert`` (a
    rank holds E / ep experts) and ``model`` (each expert's GLU split on F
    over tp), those of size > 1 (a name, a tuple, or None)."""
    if plan is None:
        return None
    axes = tuple(a for a, n in (("expert", plan.ep), ("model", plan.tp))
                 if n > 1)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def moe_mlp(p: Dict[str, Any], x: torch.Tensor, cfg,
            generator: Optional[torch.Generator] = None, plan=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE GLU block with capacity buffers (JAX ``moe_mlp``), the training
    path. ``x`` [B, S, D] -> ``(out [B, S, D], aux_loss float32)``.

    The same function as the JAX package's dense einsums, from indices: the
    kept (choice, token) rows are scattered into the experts' buffers
    ``[E, C, D]`` (each slot holds at most one row; empty slots are 0),
    the experts run as batched GEMMs in ``x``'s dtype, and each token sums
    its kept choices' rows times their combine weights (rounded to ``x``'s
    dtype, as the JAX package casts combine) in float32, rounded once.

    ``plan`` (the model's ``ParallelPlan`` under a process group): ``x``
    holds this rank's tokens of the micro-batch (its rows of the batch
    axes, its chunk under ``seq``), and the routing is the JAX package's
    over the GLOBAL token set: capacity from the global token count, each
    row's slot from every rank's counts (:func:`global_slots` after one
    all-gather of ``[G, k, E]`` counts over the batch axes), and the aux
    loss returned as this rank's share ``E * sum_e (probs_e summed here /
    T_global) * top1_frac_e (global)``: the shares sum over the batch
    ranks to the JAX aux, and a share's gradient reaches this rank's probs
    alone. The jitter noise is drawn for the global token set and this
    rank's tokens take theirs from it, so ranks holding the same tokens
    draw the same noise. The rank runs its ``E / ep`` experts (its shards
    of ``w_*``, split on F over ``model`` under tensor parallelism) on the
    kept rows routed to them: the tokens and the combine weights enter
    through ``copy_to_model_region`` over :func:`expert_region` (identity;
    the gradient all-reduced) and the partial output ``[T, D]`` (float32)
    leaves through ``reduce_from_model_region`` (all-reduced; identity
    backward), so the leaves replicated over the region (router,
    attention, norms) get full and equal gradients on each of its ranks.
    At a world of one every step is the single-card arithmetic."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    tok = _Tokens(b, t, plan, x.device)
    cap = capacity(t * tok.n, cfg)
    xt = x.reshape(t, d)
    logits = xt.float() @ p["router"].float()
    expert, pos, keep, gate, aux = _capacity_route(
        logits, k, cap, generator, cfg.router_jitter, tokens=tok)
    # this rank's experts [lo, lo + el): the kept rows routed to them to
    # their slots, every other row to one sink row past the buffers, which
    # no expert reads
    ep = getattr(plan, "ep", 1)
    el, lo = e // ep, 0
    if ep > 1:
        from ..comm import comm

        lo = comm.axis_index("expert") * el
    here = keep & (expert >= lo) & (expert < lo + el)
    slot = torch.where(here, (expert - lo) * cap + pos, el * cap)
    region = expert_region(plan)
    if region is not None:
        from .tensor_parallel import copy_to_model_region

        xt = copy_to_model_region(xt, region)
        gate = copy_to_model_region(gate, region)
    buf = xt.new_zeros(el * cap + 1, d).index_add(0, slot, xt.repeat(k, 1))
    h = buf[:el * cap].view(el, cap, d)
    act = _activation(cfg.activation)
    wg, wu, wd = (p[n].to(x.dtype) for n in ("w_gate", "w_up", "w_down"))
    y = torch.bmm(act(torch.bmm(h, wg)) * torch.bmm(h, wu), wd)  # [E, C, D]
    y = torch.cat([y.reshape(el * cap, d), y.new_zeros(1, d)])
    w = gate.to(x.dtype).float()
    out = (y[slot].float() * w[:, None]).view(k, t, d).sum(dim=0)
    if region is not None:
        from .tensor_parallel import reduce_from_model_region

        out = reduce_from_model_region(out, region)
    return out.to(x.dtype).view(b, s, d), aux


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
    order. ``experts`` is in ``[0, E]``: ``E`` marks a choice of no expert
    held here, which adds 0."""
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
    the group ends stay on the device. ``experts`` is in ``[0, E]``: ``E``
    marks a choice of no expert held here (another rank's under EP). Those
    rows sort after the last group, which ends before them, so no GEMM
    computes them, and they add 0."""
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None:
        raise RuntimeError(
            f"MoE serving in bf16 on the card needs torch._grouped_mm "
            f"(PyTorch >= 2.8 on sm90); torch {torch.__version__} has none")
    t, k = experts.shape
    n_exp = p["w_gate"].shape[0]
    flat = experts.reshape(-1)          # row t * k + c
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_exp + 1, dtype=torch.int64,
                         device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    offs = counts[:n_exp].cumsum(0).to(torch.int32)
    xs = x[order // k]
    h = act(grouped_mm(xs, p["w_gate"], offs=offs)) \
        * grouped_mm(xs, p["w_up"], offs=offs)
    ys = grouped_mm(h, p["w_down"], offs=offs)
    y = torch.empty_like(ys).index_copy_(0, order, ys)
    # the rows past the last group end are left unwritten by the GEMMs
    y = torch.where((flat < n_exp)[:, None], y, torch.zeros_like(y))
    return _combine(y.reshape(t, k, -1), gate)


def moe_mlp_nodrop(p: Dict[str, Any], x: torch.Tensor, cfg,
                   plan=None) -> torch.Tensor:
    """Exact top-k MoE GLU over flat tokens ``x`` [T, D] -> [T, D].
    ``p``: ``router`` [D, E], ``w_gate`` / ``w_up`` [E, D, F], ``w_down``
    [E, F, D], in ``x``'s dtype (the router may be any floating type).

    ``plan`` (the serving engine's ``ServePlan`` across ranks): ``p`` holds
    this rank's ``E / ep`` experts, split on F over ``model``, and every
    rank holds every token. The routing is over all E experts, as at one
    rank; a choice of another rank's expert is keyed ``E / ep`` (no expert
    here), so the grouped route computes only the rows routed to this
    rank's experts, and the partial ``[T, D]`` is all-reduced over
    ``plan.moe_region``."""
    gate, experts = topk_route(x, p["router"], cfg.num_experts_per_tok)
    act = _activation(cfg.activation)
    w = {name: p[name].to(x.dtype) for name in ("w_gate", "w_up", "w_down")}
    if plan is not None and plan.ep > 1:
        el = w["w_gate"].shape[0]
        lo = plan.ep_index * el
        here = (experts >= lo) & (experts < lo + el)
        experts = torch.where(here, experts - lo, torch.full_like(experts, el))
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        out = experts_grouped(w, x, gate, experts, act)
    else:
        out = experts_plain(w, x, gate, experts, act)
    if plan is None:
        return out
    from ..comm import comm

    return comm.all_reduce(out, plan.moe_region)
