#!/usr/bin/env python3
"""Card times of the flash kernels on their biased and unbiased routes, for
one or more checkouts of the port, in one process each, on one CUDA device.

For each ``--root`` (a checkout's root: its ``deepspeedsyclsupport_tpu_
torch`` package and kernel build are used) this builds the inputs of
``chip_smoke.py``'s evoformer shapes (MSA row attention with pair bias:
512 rows of S = 384, H = 8, D = 32; triangle attention: 384 rows, H = 4; a
mask bias with 10 % of keys at -1e9 and a pair bias broadcast over the
rows) and of its training shape (llama2-1b: B = 2, S = 4096, H = 16, D =
128, causal, no bias), random from a seed, and prints the milliseconds of
one forward, dQ, dK/dV and reducing-dbias call (CUDA events over
``--reps`` calls after warm-up) in each dtype asked for, with the route the
library names. Roots run in the order given, each in a child process;
list a pair in turns (A B B A) to see the spread:

    python3 tools/flash_bias_times.py --root build/parent --root . \\
        --root . --root build/parent
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {"msa": (512, 8), "triangle": (384, 4)}


def cuda_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(root: str, dtypes, reps: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    out = {"root": root}
    for name, (n, h) in SHAPES.items():
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            gen = torch.Generator(device="cuda").manual_seed(1)
            q, k, v, do = (torch.randn((n, 384, h, 32), generator=gen,
                                       device="cuda").to(dt)
                           for _ in range(4))
            kb = torch.where(torch.rand((n, 384), generator=gen,
                                        device="cuda") < 0.1, -1e9, 0.0)
            pair = torch.randn((1, h, 384, 384), generator=gen,
                               device="cuda")
            mask = fa.make_mask(q, k, causal=False, k_bias=kb)
            o, lse = fa.flash_fwd(q, k, v, mask, bias=pair)
            args = (q, k, v, do, lse, fa.attention_delta(do, o), mask)
            out[f"{name} {dtype}"] = {
                "fwd": cuda_ms(torch, lambda: fa.flash_fwd(
                    q, k, v, mask, bias=pair), reps),
                "dq": cuda_ms(torch, lambda: fa.flash_dq(*args, bias=pair),
                              reps),
                "dkv": cuda_ms(torch, lambda: fa.flash_dkv(*args, bias=pair),
                               reps),
                "dbias": cuda_ms(torch, lambda: fa.flash_dbias(*args, pair),
                                 reps),
                "dbias_route": fa.kernel_name("dbias", dt, 32)}
            del q, k, v, do, o, lse, args
            torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn((2, 4096, 16, 128), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    mask = fa.make_mask(q, k, causal=True)
    o, lse = fa.flash_fwd(q, k, v, mask)
    args = (q, k, v, do, lse, fa.attention_delta(do, o), mask)
    out["llama2-1b bfloat16"] = {
        "fwd": cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), 2 * reps),
        "dq": cuda_ms(torch, lambda: fa.flash_dq(*args), 2 * reps),
        "dkv": cuda_ms(torch, lambda: fa.flash_dkv(*args), 2 * reps)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--dtype", action="append",
                    choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    dtypes = args.dtype or ["bfloat16", "float16", "float32"]
    if args.child:
        print(json.dumps(measure(args.root[0], dtypes, args.reps)),
              flush=True)
        return 0
    rows = []
    for root in args.root:
        cmd = [sys.executable, __file__, "--child", "--root", root, "--reps",
               str(args.reps)] + [a for d in dtypes for a in ("--dtype", d)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(r)
        for case, t in r.items():
            if case == "root":
                continue
            print(f"{root}: {case}: " + ", ".join(
                f"{kind} {ms:.4f} ms" for kind, ms in t.items()
                if kind != "dbias_route")
                + (f" (dbias: {t['dbias_route']})" if "dbias_route" in t
                   else ""), flush=True)
    print(json.dumps({"flash_bias_times": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
