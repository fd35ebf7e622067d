#!/usr/bin/env python3
"""Where ``flash_dbias_sm90_kernel``'s time goes: the kernel against copies
of itself with one part taken out, on one CUDA device.

Each variant is the checkout's ``csrc/flash_attention.cu`` with a few lines
of the dbias kernel replaced (``VARIANTS``), built into its own copy of the
package under ``build/torch_kernels/ablation/<name>/`` (ignored by git; all
builds at once) and timed in a child process: the reducing dbias at the
evoformer MSA and triangle shapes of ``chip_smoke.py`` phase 9 (bf16,
inputs from a seed, CUDA events over 10 calls after 3). A variant's output
is wrong by design; only its time means anything.

* ``kernel``: the kernel as it is;
* ``no-exp``: p (dp - delta) without the exp (s (dp - delta));
* ``no-wgmma``: no S and dP products (the accumulators keep their zeros);
* ``no-elementwise``: the products, no scores and no sum;
* ``skeleton``: the consumers only wait for each stage and release it (the
  producer's copies, rows and barriers alone);
* ``skeleton-no-tma``: the skeleton without the tile copies.

Run from the repository root on a machine with one card:

    python3 tools/dbias_ablation.py [--variant kernel --variant skeleton]
"""
import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "torch_kernels" / "ablation"
SRC = "deepspeedsyclsupport_tpu_torch/csrc/flash_attention.cu"

ACC = '''        acc[x] = fmaf(exp2f(s[x] * kLog2e), dp[x] - dl[(x >> 1) & 1],
                      acc[x]);'''
WAIT = "      mbar_wait(bar_full + 8 * st, (t / NS) & 1);\n"
RELEASE = "      mbar_arrive(bar_empty + 8 * st);"
FENCE = "      wg_fence();\n"
SCORES = "      const float* rs = rows_s + st * L::ROW_FLOATS;"
COPIES = "        if (lane == 0) {   // its arrival carries the copies' bytes"
COPIES_END = "        } else {\n          mbar_arrive(full);\n        }\n"
COMMIT = "      wg_commit();"


def _cut(src, start, end, keep_start=False, new=""):
    """``src`` with the dbias kernel's text from ``start`` (kept when
    ``keep_start``) up to ``end`` replaced by ``new``."""
    k = src.index("flash_dbias_sm90_kernel(")
    a = src.index(start, k) + (len(start) if keep_start else 0)
    return src[:a] + new + src[src.index(end, a):]


VARIANTS = {
    "kernel": lambda s: s,
    "no-exp": lambda s: s.replace(
        ACC, "        acc[x] += s[x] * (dp[x] - dl[(x >> 1) & 1]);"),
    "no-wgmma": lambda s: _cut(s, FENCE, COMMIT, keep_start=True),
    "no-elementwise": lambda s: _cut(s, SCORES, RELEASE),
    "skeleton": lambda s: _cut(s, WAIT, RELEASE, keep_start=True),
    "skeleton-no-tma": lambda s: _cut(
        _cut(s, WAIT, RELEASE, keep_start=True), COPIES, COPIES_END,
        new="        mbar_arrive(full);\n").replace(
            "mbar_arrive(full);\n" + COPIES_END,
            "mbar_arrive(full);\n", 1),
}


def prepare(name):
    """The variant's package copy, built; returns its root."""
    root = OUT / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "deepspeedsyclsupport_tpu_torch",
                    root / "deepspeedsyclsupport_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = ROOT / SRC
    text = VARIANTS[name](src.read_text())
    if name != "kernel" and text == src.read_text():
        raise RuntimeError(f"variant {name}: the source it edits is gone")
    (root / SRC).write_text(text)
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from deepspeedsyclsupport_tpu_torch.ops import _build;"
         " _build.build('flash_attention')", str(root)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name} did not build:\n"
                           f"{proc.stderr[-3000:]}")
    return root


def measure(root):
    sys.path.insert(0, str(root))
    import torch

    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    def cuda_ms(fn, reps=10, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    for name, n, h in (("msa", 512, 8), ("triangle", 384, 4)):
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v, do = (torch.randn((n, 384, h, 32), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        kb = torch.where(torch.rand((n, 384), generator=gen, device="cuda")
                         < 0.1, -1e9, 0.0)
        pair = torch.randn((1, h, 384, 384), generator=gen, device="cuda")
        mask = fa.make_mask(q, k, causal=False, k_bias=kb)
        o, lse = fa.flash_fwd(q, k, v, mask, bias=pair)
        args = (q, k, v, do, lse, fa.attention_delta(do, o), mask)
        out[name] = cuda_ms(lambda: fa.flash_dbias(*args, pair))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(Path(args.child))), flush=True)
        return 0
    names = args.variant or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as ex:
        roots = dict(zip(names, ex.map(prepare, names)))
    rows = {}
    for name in names + names[:1]:     # the first again: the spread
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(roots[name])], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.setdefault(name, []).append(r)
        print(f"{name}: MSA {r['msa']:.4f} ms, triangle {r['triangle']:.4f} "
              f"ms", flush=True)
    print(json.dumps({"dbias_ablation": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
