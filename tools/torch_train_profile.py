#!/usr/bin/env python3
"""Where the PyTorch port's training time goes on the card.

Builds the engine as ``chip_smoke.py``'s train phase does (llama2-1b at full
width and depth, random weights from a seed, bf16 compute with float32
master weights, AdamW + WarmupLR + clipping, 2 micro-batches of 2 x 4096
tokens), runs one warm-up step, then profiles ``--steps`` ``train_batch``
calls with ``torch.profiler``. It prints the wall time, the share of it the
card was busy (union of kernel intervals), the host gap (wall minus busy),
device time by kernel class (the port's flash forward, dQ and dK/dV
kernels, matrix products, everything else) and the top kernels, then one
JSON line with the same numbers. Needs one CUDA device:

    python3 tools/torch_train_profile.py [--model llama2-1b] [--steps 3]
"""
import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                 "warmup_max_lr": 3e-4,
                                                 "warmup_num_steps": 2}},
    "gradient_clipping": 1.0}


def classify(name: str) -> str:
    low = name.lower()
    for kind in ("fwd", "dq", "dkv"):
        # the bf16 / fp16 kernels are flash_{fwd,dq,dkv}_sm90_kernel
        if f"flash_{kind}_kernel" in low or f"flash_{kind}_sm90_kernel" in low:
            return f"flash {kind} (port kernel)"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas", "splitk")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, rope, loss, optimizer, copies)"


def profile_window(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_class, by_name = defaultdict(float), defaultdict(float)
    intervals = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_class[classify(e.name)] += us
        by_name[e.name[:90]] += us
        intervals.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, t in sorted(intervals):          # union of kernel intervals
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / wall_us,
            "host_gap_ms": (wall_us - busy) / 1e3, "kernels": len(kernels),
            "by_class_ms": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_ms": {k: v / 1e3 for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama2-1b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from deepspeedsyclsupport_tpu_torch import build_model, initialize
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    model = build_model(args.model)
    params = model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    eng, *_ = initialize(model=model, params=params, config=CONFIG,
                         device="cuda")
    del params
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (eng.train_batch_size(), args.seq))
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    eng.train_batch(batch)                  # warm-up: kernel build, cuBLAS
    losses = []

    def steps():
        for _ in range(args.steps):
            losses.append(eng.train_batch(batch)["loss"])

    fa.reset_launch_counts()
    r = profile_window(torch, steps)
    r["launches"] = dict(fa.LAUNCHES)
    r["ms_per_step"] = r["wall_ms"] / args.steps
    r["losses"] = [float(x) for x in losses]
    card = torch.cuda.get_device_name(0)
    print(f"{args.model}, {args.steps} train_batch steps of "
          f"{eng.train_batch_size()} x {args.seq} tokens: wall "
          f"{r['wall_ms']:.1f} ms ({r['ms_per_step']:.1f} ms/step), card "
          f"busy {r['busy_ms']:.1f} ms ({100 * r['busy_share']:.1f} %), host "
          f"gap {r['host_gap_ms']:.1f} ms, {r['kernels']} kernels, launches "
          f"{r['launches']}")
    for k, v in r["by_class_ms"].items():
        print(f"    {v:10.2f} ms  {100 * v / r['busy_ms']:5.1f} %  {k}")
    for k, v in r["top_ms"].items():
        print(f"      {v:10.2f} ms  {k}")
    print(json.dumps({"card": card, "model": args.model, "seq": args.seq,
                      "train": r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
