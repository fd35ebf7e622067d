"""Ring attention: context parallelism over the ``seq`` axis.

Port of ``deepspeedsyclsupport_tpu/parallel/ring_attention.py``. Each
``seq`` rank holds the contiguous chunk ``[r C, (r + 1) C)`` of every row
(``C = S / sp``); K/V blocks rotate around the ``seq`` ring by
``comm.ppermute`` (differentiable: its backward is the inverse rotation)
while each rank accumulates attention for its resident Q block with a
streaming (online-softmax) update, memory O(S / n) a rank.

Three bodies, as in the JAX package:

* :func:`_ring_body_flash` (``ring:flash``, the default on the card): each
  incoming KV block is ONE ``ops.flash_attention`` call with explicit
  absolute positions (cross-block causality lives in position space)
  returning ``(out, lse)``; blocks merge in LSE space, with the JAX
  package's ``live`` guard (``lse > -1e30 / 2``: a fully masked future
  block reports ``lse = -1e30`` and must weigh nothing). Every block is
  called, dead future blocks too, so the launches follow from the shape:
  ``n`` forwards (and ``n`` dQ and dK/dV in the backward) a layer.
* :func:`_ring_body_full` (``ring:xla``, non-causal or an odd chunk): the
  naive n-block ring in plain PyTorch.
* :func:`_ring_body_zigzag` (``ring:xla``, causal, even chunk): the
  load-balanced ring. Rank i works on half-chunks (i, 2n-1-i) after a
  re-layout of two ppermutes a tensor (:func:`_zigzag_plan` 2-colors the
  transfer multigraph into two perfect matchings), so every rotation has
  two live half-chunk products.

GQA runs repeat-free: grouped query heads are batched against their
shared KV head.
"""
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..comm import comm
from ..comm.topology import get_world_topology

NEG_INF = -1e30


# --------------------------------------------------------------------- GQA
def _scores(qf, k_t, scale):
    """q [B,Cq,KVH,G,D] fp32 × k [B,Ck,KVH,D] → s [B,KVH,G,Cq,Ck]."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qf, k_t.float()) * scale


def _apply_v(p, v_t):
    """p [B,KVH,G,Cq,Ck] × v [B,Ck,KVH,D] → [B,KVH,G,Cq,D]."""
    return torch.einsum("bhgqk,bkhd->bhgqd", p, v_t.float())


def _update(acc, m, l, qf, q_pos, k_t, v_t, kv_pos, scale, causal):
    """One online-softmax accumulation of an incoming KV block."""
    s = _scores(qf, k_t, scale)
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]           # [Cq, Ck]
        s = torch.where(mask[None, None, None], s,
                        torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))              # [B,KVH,G,Cq]
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    acc = acc * corr[..., None] + _apply_v(p, v_t)
    l = l * corr + p.sum(dim=-1)
    return acc, m_new, l


def _group_q(q, kvh):
    """[B,C,H,D] → [B,C,KVH,G,D] (q head h ↔ kv head h // G)."""
    b, c, h, d = q.shape
    return q.reshape(b, c, kvh, h // kvh, d)


def _ungroup(x):
    """[B,KVH,G,C,D] → [B,C,H,D]."""
    b, kvh, g, c, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, c, kvh * g, d)


# ----------------------------------------------------------- zigzag re-layout
@lru_cache(maxsize=None)
def _zigzag_plan(n: int):
    """Static transfer plan moving contiguous half-chunks to zigzag layout
    (JAX ``_zigzag_plan``).

    Global half-chunks h ∈ [0, 2n): rank h//2 holds h (front if even).
    Zigzag target: chunk h lands on rank h (lo slot) if h < n, else on
    rank 2n-1-h (hi slot). The 2n transfers form a 2-regular bipartite
    multigraph over ranks; walking its alternating cycles 2-colors it into
    two perfect matchings → two ppermutes. Returns per color:
    (perm, send_front[src], recv_is_lo[dst]) plus the inverse plan for
    routing the output back. A coloring that is not a pair of perfect
    matchings raises ``ValueError`` (the JAX package asserts, which
    ``python -O`` strips)."""
    edges = []
    for h in range(2 * n):
        edges.append({"chunk": h, "src": h // 2, "front": h % 2 == 0,
                      "dst": h if h < n else 2 * n - 1 - h, "lo": h < n})
    color = _two_color(edges)
    fwd = _pack(edges, color, n, "src", "dst", "front", "lo")
    # inverse: chunk flows dst→src; "front" now describes the DESTINATION
    # slot (is the chunk the front half at home), "lo" the SOURCE slot
    inv = _pack(edges, color, n, "dst", "src", "lo", "front")
    return fwd, inv


def _two_color(edges):
    by_src, by_dst = {}, {}
    for i, e in enumerate(edges):
        by_src.setdefault(e["src"], []).append(i)
        by_dst.setdefault(e["dst"], []).append(i)

    def other(lst, i):
        return lst[0] if lst[1] == i else lst[1]

    color = [None] * len(edges)
    for start in range(len(edges)):
        if color[start] is not None:
            continue
        i, c = start, 0
        while color[i] is None:
            color[i] = c
            j = other(by_src[edges[i]["src"]], i)      # same src → flip
            if color[j] is not None:
                break
            color[j] = 1 - c
            i = other(by_dst[edges[j]["dst"]], j)      # same dst → flip back
    return color


def _pack(edges, color, n, src_key, dst_key, front_key, lo_key):
    out = []
    for c in (0, 1):
        es = [e for e, col in zip(edges, color) if col == c]
        if len({e[src_key] for e in es}) != n or \
                len({e[dst_key] for e in es}) != n:
            raise ValueError(f"bad matching: color {c} of the zigzag plan "
                             f"for {n} ranks is not a perfect matching")
        perm = tuple((e[src_key], e[dst_key]) for e in es)
        send_front = [True] * n
        recv_lo = [True] * n
        for e in es:
            send_front[e[src_key]] = e[front_key]
            recv_lo[e[dst_key]] = e[lo_key]
        out.append((perm, tuple(send_front), tuple(recv_lo)))
    return tuple(out)


def _sel(cond: bool, a, b):
    """``a`` if ``cond`` else ``b``, as a ``torch.where``: every rank
    builds the same autograd graph whatever its index, so the backward runs
    the collectives in one order on every rank (a graph that branched on
    the rank could order two ranks' ``ppermute`` backwards differently and
    deadlock them)."""
    return torch.where(torch.tensor(bool(cond), device=a.device), a, b)


def _route(front, back, plan_colors, axis_name, idx):
    """Send the two resident halves through the 2-matching plan; returns
    ``(slot0, slot1)``, slot0 the 'lo' / 'front' slot per the plan's recv
    flags."""
    recvs = []
    for perm, send_first, _recv_first in plan_colors:
        sent = _sel(send_first[idx], front, back)
        recvs.append(comm.ppermute(sent, axis_name, perm))
    c0_first = plan_colors[0][2][idx]
    return (_sel(c0_first, recvs[0], recvs[1]),
            _sel(c0_first, recvs[1], recvs[0]))


def _ring_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


# ------------------------------------------------------------------- bodies
def _ring_body_flash(q, k, v, axis_name: str, n: int, causal: bool):
    """One ``flash_attention(..., return_lse=True)`` a KV block, merged in
    LSE space (JAX ``_ring_body_flash``)."""
    from ..ops.flash_attention import flash_attention

    idx = comm.axis_index(axis_name)
    b, c, h, d = q.shape
    ar = torch.arange(c, device=q.device)
    q_pos = (idx * c + ar)[None].expand(b, c)
    acc = torch.zeros((b, c, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, c, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, c, h), dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    for t in range(n):
        src_blk = (idx - t) % n
        kv_pos = (src_blk * c + ar)[None].expand(b, c)
        o_b, lse_b = flash_attention(
            q, k_t, v_t, causal=causal,
            q_positions=q_pos if causal else None,
            kv_positions=kv_pos if causal else None, return_lse=True)
        live = lse_b > NEG_INF / 2   # [B,C,H] per row: block contributes
        m_new = torch.where(live, torch.maximum(m, lse_b), m)
        corr = torch.exp(m - m_new)
        w = torch.where(live, torch.exp(lse_b - m_new),
                        torch.zeros_like(lse_b))
        acc = acc * corr[..., None] + o_b.float() * w[..., None]
        l = l * corr + w
        m = m_new
        if t < n - 1:
            k_t = comm.ppermute(k_t, axis_name, _ring_perm(n))
            v_t = comm.ppermute(v_t, axis_name, _ring_perm(n))
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _ring_body_full(q, k, v, axis_name: str, n: int, causal: bool):
    """Naive n-block ring (non-causal, or the causal fallback for odd
    chunks). q/k/v local: [B, C, H, D]."""
    idx = comm.axis_index(axis_name)
    b, c, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(d)
    qf = _group_q(q.float(), kvh)
    ar = torch.arange(c, device=q.device)
    q_pos = idx * c + ar
    acc = torch.zeros((b, kvh, g, c, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kvh, g, c), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, c), dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    for t in range(n):
        kv_pos = ((idx - t) % n) * c + ar
        acc, m, l = _update(acc, m, l, qf, q_pos, k_t, v_t, kv_pos, scale,
                            causal)
        k_t = comm.ppermute(k_t, axis_name, _ring_perm(n))
        v_t = comm.ppermute(v_t, axis_name, _ring_perm(n))
    out = acc / l.clamp_min(1e-30)[..., None]
    return _ungroup(out).to(q.dtype)


def _ring_body_zigzag(q, k, v, axis_name: str, n: int):
    """Load-balanced causal ring. q/k/v local: [B, C, H, D], C even."""
    idx = comm.axis_index(axis_name)
    b, c, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    c2 = c // 2
    scale = 1.0 / np.sqrt(d)
    fwd, inv = _zigzag_plan(n)

    def halves(x):
        return x[:, :c2], x[:, c2:]

    q_lo, q_hi = _route(*halves(q), fwd, axis_name, idx)
    k_lo, k_hi = _route(*halves(k), fwd, axis_name, idx)
    v_lo, v_hi = _route(*halves(v), fwd, axis_name, idx)
    qf_lo = _group_q(q_lo.float(), kvh)
    qf_hi = _group_q(q_hi.float(), kvh)
    ar = torch.arange(c2, device=q.device)
    qpos_lo = idx * c2 + ar
    qpos_hi = (2 * n - 1 - idx) * c2 + ar

    def zeros():
        return (torch.zeros((b, kvh, g, c2, d), dtype=torch.float32,
                            device=q.device),
                torch.full((b, kvh, g, c2), NEG_INF, dtype=torch.float32,
                           device=q.device),
                torch.zeros((b, kvh, g, c2), dtype=torch.float32,
                            device=q.device))

    lo = zeros()
    hi = zeros()
    # diagonal step (j == idx): both resident diagonals plus hi×lo
    kv_lo0 = idx * c2 + ar
    kv_hi0 = (2 * n - 1 - idx) * c2 + ar
    lo = _update(*lo, qf_lo, qpos_lo, k_lo, v_lo, kv_lo0, scale, True)
    hi = _update(*hi, qf_hi, qpos_hi, k_lo, v_lo, kv_lo0, scale, True)
    hi = _update(*hi, qf_hi, qpos_hi, k_hi, v_hi, kv_hi0, scale, True)
    for t in range(1, n):
        # rotate FIRST: the diagonal step consumed the resident blocks
        k_lo, k_hi, v_lo, v_hi = (comm.ppermute(x, axis_name, _ring_perm(n))
                                  for x in (k_lo, k_hi, v_lo, v_hi))
        j = (idx - t) % n
        kv_lo_pos = j * c2 + ar
        kv_hi_pos = (2 * n - 1 - j) * c2 + ar
        # product A — always live for t >= 1: Q_hi attends K_lo(j) in full
        hi = _update(*hi, qf_hi, qpos_hi, k_lo, v_lo, kv_lo_pos, scale, True)
        # product B — Q_lo×K_lo when j < idx (a past block), else Q_hi×K_hi:
        # ONE update on the selected accumulator (selects, not a branch)
        early = j < idx
        got = _update(*(_sel(early, a, b) for a, b in zip(lo, hi)),
                      _sel(early, qf_lo, qf_hi),
                      _sel(early, qpos_lo, qpos_hi),
                      _sel(early, k_lo, k_hi), _sel(early, v_lo, v_hi),
                      _sel(early, kv_lo_pos, kv_hi_pos), scale, True)
        lo = tuple(_sel(early, g, a) for g, a in zip(got, lo))
        hi = tuple(_sel(early, a, g) for g, a in zip(got, hi))
    out_lo = _ungroup(lo[0] / lo[2].clamp_min(1e-30)[..., None])
    out_hi = _ungroup(hi[0] / hi[2].clamp_min(1e-30)[..., None])
    front, back = _route(out_lo, out_hi, inv, axis_name, idx)
    return torch.cat([front, back], dim=1).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, axis_name: str = "seq",
                   topology=None, inner: Optional[str] = None
                   ) -> torch.Tensor:
    """q/k/v: ``[B, C, H|KVH, D]``, this rank's chunk of the sequence
    (``C = S / n`` over ``axis_name``; under TP its heads). ``inner``
    picks the per-block attention: ``"flash"`` (``ops.flash_attention``,
    LSE-combined, exact), ``"xla"`` (the plain online-softmax bodies,
    zigzag-balanced when causal), None: flash on a CUDA tensor. Reachable
    from model configs as ``attn_impl="ring:flash"`` / ``"ring:xla"``.
    Takes no segment ids (as the JAX package's): the attention dispatch
    refuses a packed batch."""
    topo = topology or get_world_topology()
    n = topo.axis_sizes.get(axis_name, 1)
    if inner is None:
        inner = "flash" if q.device.type == "cuda" else "xla"
    if inner not in ("flash", "xla"):
        raise ValueError(f"unknown ring inner impl {inner!r} (flash | xla)")
    if n <= 1:
        if inner == "flash":
            from ..ops.flash_attention import flash_attention

            return flash_attention(q, k, v, causal=causal)
        from ..models.layers import reference_attention

        return reference_attention(q, k, v, causal=causal)
    c = q.shape[1]
    if inner == "flash":
        return _ring_body_flash(q, k, v, axis_name, n, causal)
    if causal and c % 2 == 0 and c >= 2:
        return _ring_body_zigzag(q, k, v, axis_name, n)
    return _ring_body_full(q, k, v, axis_name, n, causal)
