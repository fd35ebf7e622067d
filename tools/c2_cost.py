#!/usr/bin/env python3
"""What P and dS as hi + lo operands cost on the card (ROADMAP C2), for one
or more checkouts of the port, in one process each, on one CUDA device.

For each ``--root`` (a checkout's root: its ``deepspeedsyclsupport_tpu_
torch`` package, its ``chip_smoke.py`` and its kernel build are used) this
prints, with the kernel route the library names:

* the flash forward, dQ and dK/dV at llama2-1b (B = 2, S = 4096, H = 16,
  D = 128, causal, no bias, bf16; random from a seed): milliseconds per
  call, CUDA events over ``--reps`` calls after warm-up;
* the end-to-end dQ row error at that shape, as ``chip_smoke.py`` phase 4
  computes the one it holds (its inputs, seed 10; the kernels' forward and
  dQ from their own LSE and O against the plain backward of the plain
  forward; ``row_err`` with ``GRAD_ROW_FLOOR``): what
  ``E2E_DQ_ROW_LIMIT["llama2-1b"]`` must separate;
* the paged prefill at ``chip_smoke.py`` phase 3's llama2-7b case (23 atoms
  of 128 rows, H = KVH = 32, D = 128, contexts up to 2048, bf16), the same
  way;
* the llama2-1b training step of ``chip_smoke.py`` phase 6 (its config,
  2 x 2 micro-batches of 4096 tokens, bf16), one warm-up step then the mean
  wall time of ``--steps`` steps.

Roots run in the order given, each in a child process; list a pair in
turns (A B B A) to see the spread:

    python3 tools/c2_cost.py --root build/parent --root . --root . \\
        --root build/parent
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


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


def measure(root: str, reps: int, steps: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from deepspeedsyclsupport_tpu_torch import build_model, initialize
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    out = {"root": root}
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn((2, 4096, 16, 128), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    mask = fa.make_mask(q, k, causal=True)
    o, lse = fa.flash_fwd(q, k, v, mask)
    args = (q, k, v, do, lse, fa.attention_delta(do, o), mask)
    out["llama2-1b"] = {
        "fwd": cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), reps),
        "dq": cuda_ms(torch, lambda: fa.flash_dq(*args), reps),
        "dkv": cuda_ms(torch, lambda: fa.flash_dkv(*args), reps),
        "routes": {kind: fa.kernel_name(kind, torch.bfloat16, 128)
                   for kind in ("fwd", "dq", "dkv")}}
    del q, k, v, do, o, lse, args
    q, k, v, do, mask = cs.flash_inputs(torch, cs.FLASH_CASES[0], "bfloat16",
                                        seed=10)
    o, lse = fa.flash_fwd(q, k, v, mask)
    dq = fa.flash_dq(q, k, v, do, lse, fa.attention_delta(do, o), mask)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask)
    ref = fa.flash_attention_bwd_reference(
        q, k, v, do, lse_ref, fa.attention_delta(do, o_ref), mask)[0]
    out["llama2-1b"]["e2e_dq_row"] = cs.row_err(dq, ref, cs.GRAD_ROW_FLOOR)
    del q, k, v, do, mask, o, lse, dq, o_ref, lse_ref, ref
    torch.cuda.empty_cache()
    c = cs.attention_case(
        torch, np, name="llama2-7b", dtype="bfloat16", seed=1, h=32, kvh=32,
        bq=128, max_ctx=2048, n_atoms=23,
        seqs=[(0, 384), (1800, 200), (2047, 1), (500, 100)])
    call = (c["q"], c["k"], c["v"], c["tables"], c["pos0"], c["qlen"])
    out["paged-prefill-llama2-7b"] = {
        "prefill": cuda_ms(torch, lambda: pa.ragged_prefill_attention(
            *call, block_size=c["bs"]), reps),
        "route": pa.kernel_for(c["q"], c["k"], c["v"], c["bs"])}
    del c, call
    torch.cuda.empty_cache()

    model = build_model(cs.TRAIN_MODEL)
    params = model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    eng, *_ = initialize(model=model, params=params, config=cs.TRAIN_CONFIG,
                         device="cuda")
    del params
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (eng.train_batch_size(), cs.TRAIN_SEQ))
    batch = {"input_ids": torch.from_numpy(ids).to("cuda")}
    times = []
    for step in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        float(m["loss"])
        torch.cuda.synchronize()
        if step:
            times.append((time.perf_counter() - t0) * 1e3)
    out["train-step-llama2-1b"] = {"ms": sum(times) / len(times),
                                   "steps_ms": times}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(args.root[0], args.reps, args.steps)),
              flush=True)
        return 0
    rows = []
    for root in args.root:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
               "--root", root, "--reps", str(args.reps), "--steps",
               str(args.steps)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(r)
        f, p, t = (r["llama2-1b"], r["paged-prefill-llama2-7b"],
                   r["train-step-llama2-1b"])
        print(f"{root}: llama2-1b fwd {f['fwd']:.4f} dq {f['dq']:.4f} dkv "
              f"{f['dkv']:.4f} ms, end-to-end dQ row {f['e2e_dq_row']:.5f} "
              f"| paged prefill {p['prefill']:.4f} ms "
              f"({p['route']}) | train step {t['ms']:.1f} ms", flush=True)
    print(json.dumps({"c2_cost": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
