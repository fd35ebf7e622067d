#!/usr/bin/env python3
"""The JAX package's own end-to-end dQ row error in bfloat16, on the CPU.

The port's Hopper flash kernels round P (forward) and P, dS (backward) to
bf16; end to end (delta from each side's own O) their dQ rows differ from
the port's float32 plain version by 0.039 (MSA), 0.054 (triangle) and 0.061
(full bias), logged by ``chip_smoke.py`` as "end to end (not held)". This
script measures what the reference itself gives at those shapes: bf16
inputs, ``jax.vjp`` of the JAX flash attention (its Pallas kernels in
interpret mode), delta from its own bf16 O, against an fp64 oracle on the
same (rounded) inputs. Row error: each (batch, row, head) row's max abs dQ
error over that row's largest |dQ|, or over 1 % of the tensor's largest
|dQ| where that is more (``chip_smoke.py``'s ``GRAD_ROW_FLOOR``); the
largest over rows is printed, with dK and dV beside it.

Shapes (``chip_smoke.py`` phase 9), S, D, heads and biases kept; cut for
CPU time:
* msa: MSA row attention with pair bias, N_seq 512 -> ``--n-seq`` rows
  (default 8) of S = 384, H = 8, D = 32, mask bias (10 % of keys at -1e9)
  and pair bias [1, 8, 384, 384];
* triangle: triangle attention starting node, N 384 -> ``--n-seq`` rows of
  S = 384, H = 4, D = 32, same biases;
* full-bias: a full-shape pair bias [B, 8, 1024, 1024], D = 64, causal,
  B 4 -> 1.
Inputs are random normal from ``--seed`` (numpy). Prints one line per
shape and a JSON line. Run from the repository root:

    JAX_PLATFORMS=cpu python tools/flash_e2e_row_error.py
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GRAD_ROW_FLOOR = 1e-2
MASKED = 0.1


def shapes(n_seq):
    return {
        "msa": dict(b=n_seq, s=384, h=8, d=32, causal=False, mask=True,
                    bias=(1, 8)),
        "triangle": dict(b=n_seq, s=384, h=4, d=32, causal=False, mask=True,
                         bias=(1, 4)),
        "full-bias": dict(b=1, s=1024, h=8, d=64, causal=True, mask=False,
                          bias=(1, 8)),
    }


def bf16(x):
    """Round float32 numpy values to bfloat16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def oracle(q, k, v, do, bias, kbias, causal):
    """fp64 attention and its gradients; q/k/v/do [B, S, H, D], bias [Bb,
    Hb, S, S] broadcast over batch groups, kbias [B, S] or None."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    b, s, h, d = q.shape
    sc = np.einsum("bihd,bjhd->bhij", q, k) / np.sqrt(d)
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


def row_err(got, want):
    g = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    w = np.asarray(want, np.float64).reshape(-1, want.shape[-1])
    den = np.maximum(np.abs(w).max(-1),
                     max(1e-30, GRAD_ROW_FLOOR * np.abs(w).max()))
    return float((np.abs(g - w).max(-1) / den).max())


def measure(name, c, seed):
    import jax
    import jax.numpy as jnp

    from deepspeedsyclsupport_tpu.ops.flash_attention import flash_attention

    rng = np.random.RandomState(seed)
    b, s, h, d = c["b"], c["s"], c["h"], c["d"]
    q, k, v, do = (bf16(rng.randn(b, s, h, d)) for _ in range(4))
    bias = bf16(rng.randn(*c["bias"], s, s))
    kbias = (np.where(rng.rand(b, s) >= MASKED, 0.0, -1e9).astype(
        np.float32) if c["mask"] else None)
    t0 = time.perf_counter()

    def f(q_, k_, v_):
        return flash_attention(
            q_, k_, v_, causal=c["causal"], bias=jnp.asarray(bias,
                                                             jnp.bfloat16),
            k_bias=None if kbias is None else jnp.asarray(kbias,
                                                          jnp.bfloat16),
            block_q=128, block_k=128, interpret=True)

    o, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    dq, dk, dv = (np.asarray(x.astype(jnp.float32))
                  for x in vjp(jnp.asarray(do, jnp.bfloat16)))
    secs = time.perf_counter() - t0
    rq, rk, rv = oracle(q, k, v, do, bias, kbias, c["causal"])
    return dict(shape=name, dims=dict(c, bias=list(c["bias"])),
                dq_row=row_err(dq, rq), dk_row=row_err(dk, rk),
                dv_row=row_err(dv, rv), seconds=round(secs, 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-seq", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=sorted(shapes(1)))
    args = ap.parse_args()
    rows = []
    for name, c in shapes(args.n_seq).items():
        if args.only and name != args.only:
            continue
        r = measure(name, c, args.seed)
        rows.append(r)
        print(f"{name}: B={c['b']} S={c['s']} H={c['h']} D={c['d']} "
              f"bias {c['bias']}{' + mask' if c['mask'] else ''}"
              f"{' causal' if c['causal'] else ''}: JAX bf16 end to end vs "
              f"fp64 row error dQ {r['dq_row']:.4g}, dK {r['dk_row']:.4g}, "
              f"dV {r['dv_row']:.4g} ({r['seconds']} s)", flush=True)
    print(json.dumps({"e2e_row_error_jax_bf16": rows}))


if __name__ == "__main__":
    main()
