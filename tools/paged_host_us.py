#!/usr/bin/env python3
"""Host time of one paged-attention wrapper call, for one or more
checkouts of the port, in one process each, on one CUDA device.

Decode is host-bound (the serve phase issues ~2300 kernels a step), so
what a wrapper costs the CPU matters as much as its kernel. For each
``--root`` (a checkout's root: its ``deepspeedsyclsupport_tpu_torch``
package and kernel build are used) this builds the decode case of
``chip_smoke.py`` phase 3 (llama2-7b heads, 16 slots of 1-2047 tokens,
block_size 64, bf16, inputs from a seed) and prints the host microseconds
per ``paged_decode_attention`` and ``ragged_prefill_attention`` call, issued
back to back with no wait (as ``chip_smoke.host_us_per_call``), the median
of ``--rounds`` rounds of ``--reps`` calls with a wait between rounds (few
enough calls that the launch queue never fills), and the card's time per
decode call. Roots run in the order given, each in a child
process; list a pair twice in turns (A B B A) to see the spread:

    python3 tools/paged_host_us.py --root build/parent --root .
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

DECODE_LENS = [1, 7, 64, 65, 130, 300, 511, 512, 777, 1000, 1024, 1290,
               1500, 1800, 2047]


def measure(root: str, reps: int, rounds: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    dev, dt, bs, bps, h, d = "cuda", torch.bfloat16, 64, 32, 32, 128
    rng = np.random.RandomState(4)
    n = len(DECODE_LENS) + 1
    slots = (bps * n + 8) * bs
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((n, h, d), generator=gen, device=dev).to(dt)
    k, v = (torch.randn((slots, h, d), generator=gen, device=dev).to(dt)
            for _ in range(2))
    tables = torch.tensor(rng.permutation(slots // bs)[:n * bps].reshape(
        n, bps), dtype=torch.int32, device=dev)
    lens = torch.tensor(DECODE_LENS + [0], dtype=torch.int32, device=dev)
    qa = torch.randn((4, 128, h, d), generator=gen, device=dev).to(dt)
    pos0 = torch.tensor([0, 128, 1800, 0], dtype=torch.int32, device=dev)
    qlen = torch.tensor([128, 128, 128, 0], dtype=torch.int32, device=dev)

    def decode():
        return pa.paged_decode_attention(q, k, v, tables, lens,
                                         block_size=bs)

    def prefill():
        return pa.ragged_prefill_attention(qa, k, v, tables[:4], pos0, qlen,
                                           block_size=bs)

    out = {}
    for name, fn in (("decode", decode), ("prefill", prefill)):
        fn()
        times = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
        out[f"{name}_host_us"] = sorted(times)[len(times) // 2]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        decode()
    end.record()
    torch.cuda.synchronize()
    out["decode_card_ms"] = start.elapsed_time(end) / reps
    out["root"] = root
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(args.root[0], args.reps, args.rounds)),
              flush=True)
        return 0
    rows = []
    for root in args.root:
        proc = subprocess.run([sys.executable, __file__, "--child", "--root",
                               root, "--reps", str(args.reps), "--rounds",
                               str(args.rounds)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(r)
        print(f"{root}: decode wrapper {r['decode_host_us']:.1f} us host per "
              f"call ({r['decode_card_ms']:.4f} ms on the card), prefill "
              f"wrapper {r['prefill_host_us']:.1f} us host per call",
              flush=True)
    print(json.dumps({"paged_host_us": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
