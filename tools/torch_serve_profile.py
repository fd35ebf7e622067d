#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on the card.

Builds ``InferenceEngineV2`` as ``chip_smoke.py``'s serve phase does
(llama2-7b at full width, bf16, random weights from a seed, block_size 64,
max_context 2048, max_sequences 16), then profiles with ``torch.profiler``:

* one prefill ``put`` of 8 prompts of 128-1024 tokens (4608 tokens);
* ``--steps`` pure-decode ``put`` calls over those 8 sequences.

For each it prints the wall time, the share of it the card was busy (union
of kernel intervals), device time by kernel class (the port's paged-
attention kernel, matrix products, everything else) and the top kernels,
then one JSON line with the same numbers. Needs one CUDA device:

    python3 tools/torch_serve_profile.py [--model llama2-7b] [--steps 8]
"""
import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def classify(name: str) -> str:
    low = name.lower()
    if "paged_" in low:     # the port's paged-attention kernels
        return "paged_attention (port kernel)"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas", "splitk")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, rope, gather, copies)"


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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / wall_us, "kernels": len(kernels),
            "by_class_ms": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_ms": {k: v / 1e3 for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    model = build_model(args.model)
    params = model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda", dtype=torch.bfloat16)
    eng = InferenceEngineV2(model, params, dtype=torch.bfloat16,
                            block_size=64, max_context=2048,
                            max_sequences=16)
    rng = np.random.RandomState(0)
    lens = [128, 256, 384, 512, 640, 768, 896, 1024]
    prompts = [rng.randint(1, model.config.vocab_size, n).tolist()
               for n in lens]
    eng.generate([prompts[0][:64]], max_new_tokens=2)   # warm-up
    uids = list(range(len(prompts)))

    pa.reset_launch_counts()
    out = {}
    prefill = profile_window(torch, lambda: out.update(eng.put(uids,
                                                               prompts)))
    prefill["launches"] = dict(pa.LAUNCHES)

    def decode():
        for _ in range(args.steps):
            nxt = [[int(eng.query(u).argmax())] for u in uids]
            eng.put(uids, nxt)

    pa.reset_launch_counts()
    dec = profile_window(torch, decode)
    dec["launches"] = dict(pa.LAUNCHES)
    dec["ms_per_step"] = dec["wall_ms"] / args.steps

    card = torch.cuda.get_device_name(0)
    for name, r in (("prefill put (4608 tokens)", prefill),
                    (f"decode, {args.steps} puts x 8 seqs", dec)):
        print(f"{name}: wall {r['wall_ms']:.2f} ms, card busy "
              f"{r['busy_ms']:.2f} ms ({100 * r['busy_share']:.1f} %), "
              f"{r['kernels']} kernels, launches {r['launches']}")
        for k, v in r["by_class_ms"].items():
            print(f"    {v:9.3f} ms  {k}")
        for k, v in r["top_ms"].items():
            print(f"      {v:9.3f} ms  {k}")
    print(json.dumps({"card": card, "model": args.model,
                      "prefill": prefill, "decode": dec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
