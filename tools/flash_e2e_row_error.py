#!/usr/bin/env python3
"""End-to-end dQ / dK / dV row errors against fp64, on the CPU: the JAX
package's own, and the port's Hopper kernels' arithmetic with each of its
roundings switched on alone (ROADMAP C2).

The port's bf16 / fp16 flash kernels pass P (forward, and dV in the
backward) and dS (dQ and dK) to the tensor cores as operands of the input
type; the JAX package keeps both in float32. This script measures, at the
``chip_smoke.py`` phase 9 shapes cut for CPU time:

* ``jax``: inputs of ``--dtype`` (bf16 or fp16), ``jax.vjp`` of the JAX
  flash attention (its Pallas kernels in interpret mode), delta from its
  own O in that type;
* the port's kernels emulated in torch (:func:`emulate_port`): the
  forward's online softmax over 128-key tiles with P rounded or not, O in
  the input type, delta from that O, then P and dS each rounded to the type,
  split into two terms of the type (``hi + lo``, what every sm90
  backward multiplies), or kept in float32. The variants are listed in
  ``VARIANTS``: none of the roundings (the plain version's algebra), each
  alone, all three (the kernels before the C2 fix) and all three split
  (every bf16 / fp16 route since the fix).

Every variant is held against an fp64 oracle on the same (rounded) inputs.
Row error: each (batch, row, head) row's max abs error over that row's
largest |grad|, or over 1 % of the tensor's largest |grad| where that is
more (``chip_smoke.py``'s ``GRAD_ROW_FLOOR``); the largest over rows. The
port's dQ rows are also given against its plain version end to end
(float32 algebra and dQ, O in the input type, delta from it), which is what
``chip_smoke.py`` holds on the card (``e2e_dq_row``).

Shapes (``chip_smoke.py`` phase 9), S, D, heads and biases kept; cut for
CPU time:
* msa: MSA row attention with pair bias, N_seq 512 -> ``--n-seq`` rows
  (default 8) of S = 384, H = 8, D = 32, mask bias (10 % of keys at -1e9)
  and pair bias [1, 8, 384, 384];
* triangle: triangle attention starting node, N 384 -> ``--n-seq`` rows of
  S = 384, H = 4, D = 32, same biases;
* full-bias: a full-shape pair bias [B, 8, 1024, 1024], D = 64, causal,
  B 4 -> 1;
* causal: the full-bias shape without any bias (the unbiased route).
Inputs are random normal from ``--seed`` (numpy), rounded to the dtype
(``--dtype``, bf16 by default; the JAX rows take the same type). Prints
one line per shape and variant and a JSON line. Run from the repository root:

    JAX_PLATFORMS=cpu python tools/flash_e2e_row_error.py [--no-jax]
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GRAD_ROW_FLOOR = 1e-2
MASKED = 0.1
FWD_TILE = 128          # keys per tile of flash_fwd_sm90_kernel (D <= 128)
# name -> how the forward's P, the backward's P (dV) and dS (dQ, dK) reach
# their products: "round" (one operand of the dtype), "split" (hi + lo, two
# operands of the dtype) or None (float32)
VARIANTS = {
    "none": (None, None, None),
    "fwd-P": ("round", None, None),
    "bwd-P": (None, "round", None),
    "bwd-dS": (None, None, "round"),
    "rounded": ("round", "round", "round"),
    "split": ("split", "split", "split"),
}


def shapes(n_seq):
    return {
        "msa": dict(b=n_seq, s=384, h=8, d=32, causal=False, mask=True,
                    bias=(1, 8)),
        "triangle": dict(b=n_seq, s=384, h=4, d=32, causal=False, mask=True,
                         bias=(1, 4)),
        "full-bias": dict(b=1, s=1024, h=8, d=64, causal=True, mask=False,
                          bias=(1, 8)),
        "causal": dict(b=1, s=1024, h=8, d=64, causal=True, mask=False,
                       bias=None),
    }


def bf16(x):
    """Round float32 numpy values to bfloat16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def inputs(c, seed, dtype="bfloat16"):
    """q, k, v, dO [B, S, H, D], the pair bias (or None) and the k-row
    bias [B, S] (or None), float32 numpy values rounded to ``dtype``."""
    rnd = bf16 if dtype == "bfloat16" else (
        lambda x: np.asarray(x, np.float32).astype(np.float16).astype(
            np.float32))
    rng = np.random.RandomState(seed)
    b, s, h, d = c["b"], c["s"], c["h"], c["d"]
    q, k, v, do = (rnd(rng.randn(b, s, h, d)) for _ in range(4))
    bias = None if c["bias"] is None else rnd(rng.randn(*c["bias"], s, s))
    kbias = (np.where(rng.rand(b, s) >= MASKED, 0.0, -1e9).astype(
        np.float32) if c["mask"] else None)
    return q, k, v, do, bias, kbias


def oracle(q, k, v, do, bias, kbias, causal):
    """fp64 attention and its gradients; q/k/v/do [B, S, H, D], bias [Bb,
    Hb, S, S] broadcast over batch groups (or None), kbias [B, S] or
    None."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    b, s, h, d = q.shape
    sc = np.einsum("bihd,bjhd->bhij", q, k) / np.sqrt(d)
    if bias is not None:
        sc = sc + np.repeat(bias.astype(np.float64), b // bias.shape[0], 0)
    if kbias is not None:
        sc = sc + kbias.astype(np.float64)[:, None, None, :]
    if causal:
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhij,bjhd->bihd", p, v)
    dp = np.einsum("bihd,bjhd->bhij", do, v)
    delta = np.einsum("bihd,bihd->bhi", do, o)[..., None]
    ds = p * (dp - delta)
    dq = np.einsum("bhij,bjhd->bihd", ds, k) / np.sqrt(d)
    dk = np.einsum("bhij,bihd->bjhd", ds, q) / np.sqrt(d)
    dv = np.einsum("bhij,bihd->bjhd", p, do)
    return dq, dk, dv


class RowErr:
    """The row error of ``got`` against ``want`` gathered over passes of
    rows (the floor needs the largest |want| of the whole tensor)."""

    def __init__(self):
        self.err, self.top = [], []

    def add(self, got, want):
        g = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
        w = np.asarray(want, np.float64).reshape(-1, want.shape[-1])
        self.err.append(np.abs(g - w).max(-1))
        self.top.append(np.abs(w).max(-1))
        return self

    def value(self):
        err, top = np.concatenate(self.err), np.concatenate(self.top)
        den = np.maximum(top, max(1e-30, GRAD_ROW_FLOOR * top.max()))
        return float((err / den).max())


def row_err(got, want):
    return RowErr().add(got, want).value()


def operand(x, dtype, mode):
    """What a product multiplies for float32 ``x`` given as an operand of
    ``dtype``: ``x`` itself (mode None), ``x`` rounded to the dtype
    ("round"), or the sum of two operands of the dtype, hi = T(x) and lo =
    T(x - hi) ("split"; the two products accumulate in float32)."""
    if mode is None:
        return x
    hi = x.to(dtype).float()
    if mode == "round":
        return hi
    return hi + (x - hi).to(dtype).float()


def emulate_port(q, k, v, do, mask, bias, fwd_p, bwd_p, ds):
    """The port's flash kernels end to end on the CPU (torch, inputs in
    their dtype T): the forward's online softmax over ``FWD_TILE`` keys
    (m from -1e30, l summed from the unrounded p, P V with P as
    :func:`operand` of mode ``fwd_p``), O in T and LSE; delta = rowsum(dO *
    O) from that O (the autograd backward's); then p = exp(s - LSE), dS = p
    (dO V^T - delta) in float32, dV = P^T dO with P as the operand of mode
    ``bwd_p``, dQ = scale dS K and dK = scale dS^T Q with dS as that of
    mode ``ds``. Returns float32 (dq, dk, dv) rounded to T, the kernels'
    outputs."""
    import torch

    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

    dt = q.dtype
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    s, vis = tfa._scores(q, k, mask, 0, sq, bias)       # [B, KVH, G, Sq, Skv]
    s = torch.where(vis, s, torch.full_like(s, float("-inf")))
    vf, kf, qf = v.float(), k.float(), q.float().reshape(b, sq, kvh, g, d)
    m = torch.full((b, kvh, g, sq, 1), tfa.NEG_INF)
    l = torch.zeros((b, kvh, g, sq, 1))
    acc = torch.zeros((b, kvh, g, sq, d))
    for j0 in range(0, skv, FWD_TILE):
        st = s[..., j0:j0 + FWD_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgqj,bjkd->bkgqd", operand(p, dt, fwd_p),
            vf[:, j0:j0 + FWD_TILE])
        m = m_new
    denom = l.clamp_min(1e-30)
    o = (acc / denom).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(dt)
    lse = m + torch.log(denom)
    delta = tfa.attention_delta(do, o).reshape(b, kvh, g, sq, 1)
    p = torch.where(vis, torch.exp(s - lse), torch.zeros_like(s))
    dof = do.float().reshape(b, sq, kvh, g, d)
    dp = torch.einsum("bqkgd,bjkd->bkgqj", dof, vf)
    ds = operand(p * (dp - delta), dt, ds)
    p = operand(p, dt, bwd_p)
    scale = 1.0 / math.sqrt(d)
    dq = scale * torch.einsum("bkgqj,bjkd->bqkgd", ds, kf).reshape(
        b, sq, h, d)
    dk = scale * torch.einsum("bkgqj,bqkgd->bjkd", ds, qf)
    dv = torch.einsum("bkgqj,bqkgd->bjkd", p, dof)
    return tuple(x.to(dt).float() for x in (dq, dk, dv))


def torch_case(c, arrays, dtype):
    """The numpy inputs as torch tensors of ``dtype`` with the port's mask
    and float32 pair bias."""
    import torch

    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

    q, k, v, do, bias, kbias = arrays
    tq, tk, tv, tdo = (torch.from_numpy(x).to(getattr(torch, dtype))
                       for x in (q, k, v, do))
    mask = tfa.make_mask(tq, tk, causal=c["causal"],
                         k_bias=None if kbias is None else torch.from_numpy(
                             kbias))
    tb = None if bias is None else torch.from_numpy(bias)
    return tq, tk, tv, tdo, mask, tb


def port_rows(c, arrays, dtype, variants=VARIANTS, rows_per_pass=8):
    """Row errors of each variant of :func:`emulate_port` against fp64
    (``dq_row``, ``dk_row``, ``dv_row``) and of dQ against the port's plain
    version end to end (``dq_vs_plain_row``), over passes of
    ``rows_per_pass`` batch rows (a pair bias shared by every row)."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

    q, k, v, do, bias, kbias = arrays
    step = rows_per_pass if bias is None or bias.shape[0] == 1 else len(q)
    stats = {name: {n: RowErr() for n in ("dq", "dk", "dv", "dq_vs_plain")}
             for name in variants}
    for r0 in range(0, len(q), step):
        part = tuple(x[r0:r0 + step] for x in (q, k, v, do)) + (
            bias, None if kbias is None else kbias[r0:r0 + step])
        tq, tk, tv, tdo, mask, tb = torch_case(c, part, dtype)
        ref = oracle(*part, c["causal"])
        o, lse = tfa.flash_attention_fwd_reference(tq, tk, tv, mask, tb)
        plain_dq = tfa.flash_attention_bwd_reference(
            tq, tk, tv, tdo, lse, tfa.attention_delta(tdo, o), mask, "dq",
            bias=tb)[0].numpy()
        for name in variants:
            grads = emulate_port(tq, tk, tv, tdo, mask, tb, *VARIANTS[name])
            for n, x, r in zip(("dq", "dk", "dv"), grads, ref):
                stats[name][n].add(x.numpy(), r)
            stats[name]["dq_vs_plain"].add(grads[0].numpy(), plain_dq)
    return {name: {f"{n}_row": e.value() for n, e in st.items()}
            for name, st in stats.items()}


def jax_grads(c, arrays, dtype="bfloat16"):
    """dq, dk, dv of the JAX flash attention in ``dtype`` (its Pallas
    kernels in interpret mode, delta from its own O in that type) on
    ``arrays`` (from :func:`inputs`), as float32 numpy arrays."""
    import jax
    import jax.numpy as jnp

    from deepspeedsyclsupport_tpu.ops.flash_attention import flash_attention

    q, k, v, do, bias, kbias = arrays
    jt = getattr(jnp, dtype)

    def f(q_, k_, v_):
        return flash_attention(
            q_, k_, v_, causal=c["causal"],
            bias=None if bias is None else jnp.asarray(bias, jt),
            k_bias=None if kbias is None else jnp.asarray(kbias, jt),
            block_q=128, block_k=128, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jt) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(do, jt))]


def measure(name, c, seed, dtype="bfloat16"):
    """The JAX package's end-to-end rows in ``dtype`` against fp64."""
    arrays = inputs(c, seed, dtype)
    t0 = time.perf_counter()
    dq, dk, dv = jax_grads(c, arrays, dtype)
    secs = time.perf_counter() - t0
    rq, rk, rv = oracle(*arrays, c["causal"])
    return dict(shape=name, dq_row=row_err(dq, rq), dk_row=row_err(dk, rk),
                dv_row=row_err(dv, rv), seconds=round(secs, 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-seq", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=sorted(shapes(1)))
    ap.add_argument("--dtype", choices=("bfloat16", "float16"),
                    default="bfloat16", help="the input type of both packages' rows")
    ap.add_argument("--rows-per-pass", type=int, default=8,
                    help="batch rows the port's emulation takes at once")
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    default=list(VARIANTS), help="the port's variants to run")
    ap.add_argument("--no-jax", action="store_true",
                    help="only the port's emulated rows")
    args = ap.parse_args()
    rows = []
    for name, c in shapes(args.n_seq).items():
        if args.only and name != args.only:
            continue
        dims = (f"B={c['b']} S={c['s']} H={c['h']} D={c['d']} bias "
                f"{c['bias']}{' + mask' if c['mask'] else ''}"
                f"{' causal' if c['causal'] else ''}")
        r = dict(shape=name, dims=dict(c, bias=c["bias"] and list(c["bias"])))
        if not args.no_jax:
            r["jax"] = measure(name, c, args.seed, args.dtype)
            print(f"{name}: {dims}: JAX {args.dtype} end to end vs fp64 row error "
                  f"dQ {r['jax']['dq_row']:.4g}, dK {r['jax']['dk_row']:.4g}, "
                  f"dV {r['jax']['dv_row']:.4g} ({r['jax']['seconds']} s)",
                  flush=True)
        r["port"] = port_rows(c, inputs(c, args.seed, args.dtype),
                              args.dtype, variants=args.variants,
                              rows_per_pass=args.rows_per_pass)
        r["port_dtype"] = args.dtype
        for var, e in r["port"].items():
            print(f"{name}: port {args.dtype} emulated, {var}: vs fp64 dQ "
                  f"{e['dq_row']:.4g}, dK {e['dk_row']:.4g}, dV "
                  f"{e['dv_row']:.4g}; dQ vs the plain version "
                  f"{e['dq_vs_plain_row']:.4g}", flush=True)
        rows.append(r)
    print(json.dumps({"e2e_row_error": rows}))


if __name__ == "__main__":
    main()
