#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on the card.

Builds ``InferenceEngineV2`` as ``chip_smoke.py``'s serve phase does
(llama2-7b at full width, bf16, random weights from a seed, block_size 64,
max_context 2048, max_sequences 16), then profiles with ``torch.profiler``:

* one prefill ``put`` of 8 prompts of 128-1024 tokens (4608 tokens);
* ``generate`` of 32 greedy tokens on those prompts, per-token (one CUDA
  graph replay a decode step) and fused (``--fused`` K steps a replay,
  after ``warmup(fused_ladder=True)``); its decode window runs from the end
  of the last prefill kernel to the end of the last kernel.

For each it prints the wall time, the share of it the card was busy (union
of kernel intervals), device time by kernel class (the port's paged-
attention kernels, matrix products, everything else) and the top kernels
(per decode step in a decode window). Then, without the profiler, one
``generate`` of ``--timed-new`` tokens per engine with every CUDA graph
replay timed (``replay_times``): per graph (the rung-1 decode graph, each
fused rung), the replays, the host time of the replay call and the device
time from an event recorded before it to one recorded after it (which
includes any wait of the card for the launch), each per replay and per
decode step, and the time of the loop outside the replays. Last, one JSON
line with all these numbers. Needs one CUDA device:

    python3 tools/torch_serve_profile.py [--model llama2-7b] [--fused 8]
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
    if "flash_" in low:     # the port's flash-attention kernels
        return "flash_attention (port kernel)"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas", "splitk")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, rope, gather, copies)"


GAP_BINS_US = (2, 10, 50)


def summarize(kernels, span_us):
    """Busy time (union of the kernels' intervals), device time by class
    and the top kernels, over a span of ``span_us``; and the idle gaps
    between the union's intervals: their count and ms per size bin
    (``GAP_BINS_US`` edges) and the ms of gaps of 10 us or more by the
    kernel that ends before them."""
    by_class, by_name = defaultdict(float), defaultdict(float)
    bins = {b: [0, 0.0] for b in GAP_BINS_US + (None,)}
    after = defaultdict(float)
    busy, end, last = 0.0, None, None
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        us = e.time_range.elapsed_us()
        by_class[classify(e.name)] += us
        by_name[e.name[:90]] += us
        s, t = e.time_range.start, e.time_range.end
        if end is None or s > end:
            if end is not None:
                gap = s - end
                b = next((b for b in GAP_BINS_US if gap < b), None)
                bins[b][0] += 1
                bins[b][1] += gap / 1e3
                if gap >= 10:
                    after[last[:60]] += gap / 1e3
            busy += t - s
            end, last = t, e.name
        elif t > end:
            busy += t - end
            end, last = t, e.name
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": span_us / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / span_us if span_us else 0.0,
            "kernels": len(kernels),
            "by_class_ms": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_ms": {k: v / 1e3 for k, v in top},
            "gaps": {(f"<{b}us" if b else f">={GAP_BINS_US[-1]}us"): v
                     for b, v in bins.items()},
            "gap_ms_after": dict(sorted(after.items(),
                                        key=lambda kv: -kv[1])[:6])}


def profile_window(torch, fn, decode_after=None):
    """``fn`` under ``torch.profiler`` (kernels of CUDA graph replays
    included): :func:`summarize` over its wall time and, with
    ``decode_after`` (a kernel name's substring: the prefill kernel), also
    under ``"decode"`` over the span from the end of the last such kernel
    to the end of the last kernel."""
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
    out = summarize(kernels, wall_us)
    if decode_after is not None:
        ends = [e.time_range.end for e in kernels if decode_after in e.name]
        if not ends:
            raise RuntimeError(f"no {decode_after!r} kernel in the window")
        t_pre = max(ends)
        dec = [e for e in kernels if e.time_range.start >= t_pre]
        span = max(e.time_range.end for e in dec) - t_pre if dec else 0.0
        out["decode"] = summarize(dec, span)
    return out


def replay_times(torch, fn, names):
    """``fn()`` with ``torch.cuda.CUDAGraph.replay`` timed: the wall ms of
    ``fn`` and, per graph (``names`` maps a graph to its name), the number
    of replays, the host ms of the replay calls and the device ms between
    events recorded on the stream just before and just after each call."""
    cls = torch.cuda.CUDAGraph
    orig, recs = cls.replay, []

    def timed(graph):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        t0 = time.perf_counter()
        orig(graph)
        host = time.perf_counter() - t0
        b.record()
        recs.append((names.get(graph, "other"), host, a, b))

    cls.replay = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cls.replay = orig
    out = {}
    for name, host, a, b in recs:
        r = out.setdefault(name, {"replays": 0, "host_ms": 0.0,
                                  "device_ms": 0.0})
        r["replays"] += 1
        r["host_ms"] += host * 1e3
        r["device_ms"] += a.elapsed_time(b)
    return wall * 1e3, out


def graph_names(eng):
    """{graph: name} of an engine's decode graphs: ``k1`` for the rung-1
    decode forward, ``k<K>`` for each fused rung."""
    names = {}
    if eng._decode_runner is not None and eng._decode_runner.graph:
        names[eng._decode_runner.graph] = "k1"
    for key, runner in eng._decode_multi.items():
        if runner.graph is not None:
            names[runner.graph] = f"k{key[0]}"
    return names


def per_step(r, steps):
    """A decode window's numbers per decode step."""
    return dict(r, steps=steps, ms_per_step=r["wall_ms"] / steps,
                busy_ms_per_step=r["busy_ms"] / steps,
                kernels_per_step=r["kernels"] / steps,
                by_class_ms={k: v / steps for k, v in r["by_class_ms"].items()},
                top_ms={k: v / steps for k, v in r["top_ms"].items()},
                gaps={k: [n / steps, ms / steps]
                      for k, (n, ms) in r["gaps"].items()},
                gap_ms_after={k: v / steps
                              for k, v in r["gap_ms_after"].items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--fused", type=int, default=8,
                    help="decode steps per dispatch of the fused engine")
    ap.add_argument("--new", type=int, default=32, help="tokens generated")
    ap.add_argument("--timed-new", type=int, default=128,
                    help="tokens generated with the graph replays timed")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    model = build_model(args.model)
    layers = model.config.num_layers
    params = model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda", dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    lens = [128, 256, 384, 512, 640, 768, 896, 1024]
    prompts = [rng.randint(1, model.config.vocab_size, n).tolist()
               for n in lens]
    report = {"card": torch.cuda.get_device_name(0), "model": args.model}
    for k in (1, args.fused):
        eng = InferenceEngineV2(model, params, dtype=torch.bfloat16,
                                block_size=64, max_context=2048,
                                max_sequences=16,
                                decode_steps_per_dispatch=k)
        eng.warmup(fused_ladder=True)
        if k == 1:
            uids = list(range(len(prompts)))
            pa.reset_launch_counts()
            r = profile_window(torch, lambda: eng.put(uids, prompts))
            r["launches"] = dict(pa.LAUNCHES)
            report["prefill"] = r
            eng.flush(uids)
        eng.generate(prompts, max_new_tokens=args.new)     # warm
        pa.reset_launch_counts()
        r = profile_window(torch, lambda: eng.generate(
            prompts, max_new_tokens=args.new), decode_after="paged_prefill")
        steps = pa.LAUNCHES["paged_decode_attention"] // layers
        r["decode"] = per_step(r["decode"], steps)
        r["launches"] = dict(pa.LAUNCHES)
        report[f"generate_k{k}"] = r
        wall, graphs = replay_times(torch, lambda: eng.generate(
            prompts, max_new_tokens=args.timed_new), graph_names(eng))
        report[f"replays_k{k}"] = {"wall_ms": wall, "graphs": graphs}
        del eng
        torch.cuda.empty_cache()

    p = report["prefill"]
    print(f"prefill put ({sum(lens)} tokens): wall {p['wall_ms']:.2f} ms, "
          f"card busy {p['busy_ms']:.2f} ms ({100 * p['busy_share']:.1f} %),"
          f" {p['kernels']} kernels, launches {p['launches']}")
    for name, v in p["by_class_ms"].items():
        print(f"    {v:9.3f} ms  {name}")
    for k in (1, args.fused):
        r = report[f"generate_k{k}"]
        d = r["decode"]
        print(f"generate({args.new}), {k} decode step(s) per dispatch: wall "
              f"{r['wall_ms']:.2f} ms; decode window {d['wall_ms']:.2f} ms "
              f"over {d['steps']} steps: {d['ms_per_step']:.3f} ms a step, "
              f"card busy {d['busy_ms_per_step']:.3f} ms a step "
              f"({100 * d['busy_share']:.1f} %), "
              f"{d['kernels_per_step']:.0f} kernels a step")
        for name, v in d["by_class_ms"].items():
            print(f"    {v:9.4f} ms a step  {name}")
        for name, v in d["top_ms"].items():
            print(f"      {v:9.4f} ms a step  {name}")
        print("    idle gaps a step: " + ", ".join(
            f"{k} {n:.1f} ({ms:.4f} ms)" for k, (n, ms) in d["gaps"].items()))
        for name, v in d["gap_ms_after"].items():
            print(f"      {v:9.4f} ms a step idle after  {name}")
    for k in (1, args.fused):
        r = report[f"replays_k{k}"]
        inside = sum(g["device_ms"] for g in r["graphs"].values())
        print(f"generate({args.timed_new}), {k} decode step(s) per "
              f"dispatch, no profiler: wall {r['wall_ms']:.2f} ms, "
              f"{inside:.2f} ms inside graph replays (device), "
              f"{r['wall_ms'] - inside:.2f} ms "
              f"outside them (prefill, sampling, host)")
        for name, g in sorted(r["graphs"].items()):
            steps = int(name[1:]) if name[1:].isdigit() else 1
            n = g["replays"]
            print(f"    graph {name}: {n} replays, host {g['host_ms'] / n:.3f}"
                  f" ms a replay call, device {g['device_ms'] / n:.3f} ms a "
                  f"replay = {g['device_ms'] / n / steps:.3f} ms a step")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
