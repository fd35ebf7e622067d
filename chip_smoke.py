#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

It imports nothing of JAX or the JAX package. Phases, one line each:

1. device  — the card (``nvidia-smi`` name and power limit) and versions;
             fails without CUDA.
2. build   — builds the CUDA kernel from ``deepspeedsyclsupport_tpu_torch/
             csrc`` with nvcc (into ``build/torch_kernels/``).
3. kernel  — the ragged paged-attention kernel against its plain PyTorch
             version at the serving path's shapes (llama2-7b, mistral-7b with
             its 4096 window, an ALiBi case, decode over 16 sequences), in
             bf16 and float32, with times (CUDA events), the bound, and the
             time of one ``scaled_dot_product_attention`` call over the
             gathered KV as a yardstick (the port never calls it).
4. serve   — ``InferenceEngineV2`` serving llama2-7b at full width and depth
             (bf16, random weights from a seed): greedy ``generate`` on 8
             prompts of 128-1024 tokens, 32 new tokens each. Kernel launch
             counts are zeroed just before and read just after.
5. parity  — the same width cut to 4 layers in float32: the engine through
             the kernel against the engine through the plain path and the
             dense ``CausalLM.apply``.
6. kernels — every TPU kernel of the JAX package and its status here.

Then a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure prints its error
and exits non-zero without that last line.
"""
import json
import math
import re
import subprocess
import sys
import time
from functools import partial

MEM_BYTES_PER_S = 3.35e12                    # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PARITY_TOL = 5e-4
DEV = "cuda"
SERVE_MODEL = "llama2-7b"
SERVE_PROMPT_LENS = (128, 256, 384, 512, 640, 768, 896, 1024)
SOURCE = "deepspeedsyclsupport_tpu_torch/csrc/paged_attention.cu"
REPLACES = "deepspeedsyclsupport_tpu/ops/paged_attention.py:96"
TPU_KERNELS = [
    ("ops/paged_attention.py:96 _prefill_kernel", SOURCE),
    ("ops/flash_attention.py:145 _fwd_kernel", None),
    ("ops/flash_attention.py:208 _dq_kernel", None),
    ("ops/flash_attention.py:273 _dkv_kernel", None),
    ("ops/flash_attention.py:330 _dbias_kernel", None),
]


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ cases
def attention_case(torch, np, *, name, h, kvh, d=128, bs=64, bq, seqs,
                   max_ctx, n_atoms, dtype, alibi=False, window=None,
                   seed=0):
    """A batch of atoms as the engine builds them: each sequence's chunk
    (first position, tokens) cut into atoms of up to ``bq`` rows, all atoms
    of a sequence sharing its block table, then dead atoms up to
    ``n_atoms``. The pool is random normal; tables are disjoint random
    blocks."""
    from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes

    rng = np.random.RandomState(seed)
    bps = max_ctx // bs
    num_blocks = bps * len(seqs) + 8
    perm = rng.permutation(num_blocks)
    tables, pos0, qlen = [], [], []
    for i, (p0, n) in enumerate(seqs):
        table = perm[i * bps:(i + 1) * bps]
        for k in range(0, n, bq):
            tables.append(table)
            pos0.append(p0 + k)
            qlen.append(min(bq, n - k))
    while len(pos0) < n_atoms:
        tables.append(np.zeros(bps, np.int64))
        pos0.append(0)
        qlen.append(0)
    dev = DEV
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    slots = num_blocks * bs
    c = dict(
        name=name, dtype=dtype, bs=bs, window=window,
        q=torch.randn((len(pos0), bq, h, d), generator=gen, device=dev).to(tdt),
        k=torch.randn((slots, kvh, d), generator=gen, device=dev).to(tdt),
        v=torch.randn((slots, kvh, d), generator=gen, device=dev).to(tdt),
        tables=torch.tensor(np.stack(tables), dtype=torch.int32, device=dev),
        pos0=torch.tensor(pos0, dtype=torch.int32, device=dev),
        qlen=torch.tensor(qlen, dtype=torch.int32, device=dev),
        alibi=(torch.from_numpy(alibi_slopes(h)).to(dev) if alibi else None))
    return c


def work_of(np, c):
    """Bytes the function must move and flops it must do on this data:
    live q rows read, the output written, each distinct KV slot any live
    row can see read once (k and v); 4*D flops per (row, head, visible
    position)."""
    q, bs, window = c["q"], c["bs"], c["window"]
    a, bq, h, d = q.shape
    kvh = c["k"].shape[1]
    esize = q.element_size()
    tables = c["tables"].cpu().numpy()
    pos0, qlen = c["pos0"].cpu().numpy(), c["qlen"].cpu().numpy()
    cap = tables.shape[1] * bs
    slots, visible = set(), 0
    for i in range(a):
        if qlen[i] == 0:
            continue
        qpos = pos0[i] + np.arange(qlen[i])
        hi = np.minimum(qpos + 1, cap)
        lo = np.maximum(qpos + 1 - window, 0) if window else np.zeros_like(hi)
        visible += int(np.maximum(hi - lo, 0).sum())
        pos = np.arange(lo.min(), hi.max())
        slots.update((tables[i][pos // bs] * bs + pos % bs).tolist())
    live_rows = int(qlen.sum())
    nbytes = (live_rows * h * d * esize + a * bq * h * d * esize
              + 2 * len(slots) * kvh * d * esize
              + tables.nbytes + pos0.nbytes + qlen.nbytes)
    flops = 4.0 * h * d * visible
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[c["dtype"]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_inputs(torch, c):
    """q/k/v/mask for one ``scaled_dot_product_attention`` call computing
    the same attention over the KV gathered out of the pool (the gather is
    not timed)."""
    q, k, v, tables, bs = c["q"], c["k"], c["v"], c["tables"], c["bs"]
    a, bq, h, d = q.shape
    kvh = k.shape[1]
    c_len = tables.shape[1] * bs
    j = torch.arange(c_len, device=q.device)
    slot = tables.long()[:, j // bs] * bs + j % bs
    ks = k[slot].repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    vs = v[slot].repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    qpos = c["pos0"].long()[:, None, None, None] + torch.arange(
        bq, device=q.device)[None, None, :, None]
    allowed = j[None, None, None, :] <= qpos
    if c["window"]:
        allowed = allowed & (qpos - j[None, None, None, :] < c["window"])
    mask = torch.zeros(allowed.shape, dtype=q.dtype, device=q.device)
    mask = mask.masked_fill(~allowed, float("-inf"))
    if c["alibi"] is not None:
        mask = mask + (c["alibi"][None, :, None, None] * (
            j[None, None, None, :] - qpos)).to(q.dtype)
    return q.transpose(1, 2), ks.contiguous(), vs.contiguous(), mask


def check_attention(torch, np, c, decode):
    """Kernel vs plain on one case; returns a result row."""
    import torch.nn.functional as F

    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    kw = dict(block_size=c["bs"], alibi=c["alibi"], window=c["window"])
    if decode:
        q = c["q"][:, 0]
        seq_lens = torch.where(c["qlen"] > 0, c["pos0"] + 1,
                               torch.zeros_like(c["pos0"]))
        args = (q, c["k"], c["v"], c["tables"], seq_lens)
        kernel = partial(pa.paged_decode_attention, *args, **kw)
        plain = partial(pa.paged_decode_attention_reference, *args, **kw)
    else:
        args = (c["q"], c["k"], c["v"], c["tables"], c["pos0"], c["qlen"])
        kernel = partial(pa.ragged_prefill_attention, *args, **kw)
        plain = partial(pa.ragged_prefill_attention_reference, *args, **kw)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    if not math.isfinite(err) or err > TOL[c["dtype"]]:
        raise AssertionError(f"{c['name']} {c['dtype']}: kernel vs plain "
                             f"max abs err {err} > {TOL[c['dtype']]}")
    if decode:
        dead = (c["qlen"] == 0).nonzero().squeeze(1)
        if dead.numel() and float(got[dead].abs().max()) != 0.0:
            raise AssertionError(f"{c['name']}: dead decode slots not zero")
    else:
        rows = torch.arange(c["q"].shape[1], device=got.device)[None, :]
        pad = rows >= c["qlen"].long()[:, None]
        if float(got[pad].abs().max()) != 0.0:
            raise AssertionError(f"{c['name']}: rows past qlen not zero")
    ms = cuda_ms(torch, kernel, reps=20)
    plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
    sq, sk, sv, smask = sdpa_inputs(torch, c)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=smask), reps=10)
    del sq, sk, sv, smask
    bound_ms, bound_by = work_of(np, c)
    return dict(case=c["name"], dtype=c["dtype"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_kernels(torch, np):
    llama = dict(h=32, kvh=32, bq=128, max_ctx=2048, n_atoms=23,
                 # full atoms from 0, a long-context chunk (full+partial),
                 # one decode-like row at the context cap, a partial atom
                 seqs=[(0, 384), (1800, 200), (2047, 1), (500, 100)])
    mistral = dict(h=32, kvh=8, bq=128, max_ctx=8192, n_atoms=12,
                   window=4096,
                   seqs=[(0, 384), (5000, 128), (8191, 1), (6000, 50)])
    decode_lens = [1, 7, 64, 65, 130, 300, 511, 512, 777, 1000, 1024, 1290,
                   1500, 1800, 2047, 2048]
    rows = {}
    for dtype in ("bfloat16", "float32"):
        cases = [
            ("prefill", attention_case(torch, np, name="llama2-7b", dtype=dtype,
                                       seed=1, **llama)),
            ("prefill", attention_case(torch, np, name="mistral-7b",
                                       dtype=dtype, seed=2, **mistral)),
            ("prefill", attention_case(torch, np, name="alibi-bloom-7b1",
                                       dtype=dtype, seed=3, alibi=True,
                                       **llama)),
            ("decode", attention_case(
                torch, np, name="decode-llama2-7b", dtype=dtype, seed=4,
                h=32, kvh=32, bq=1, max_ctx=2048, n_atoms=16,
                seqs=[(n - 1, 1) for n in decode_lens[:-1]])),
            ("decode", attention_case(
                torch, np, name="decode-mistral-7b", dtype=dtype, seed=5,
                h=32, kvh=8, bq=1, max_ctx=8192, n_atoms=16, window=4096,
                seqs=[(4 * n - 1, 1) for n in decode_lens])),
        ]
        for kind, c in cases:
            r = check_attention(torch, np, c, decode=kind == "decode")
            log("kernel", f"{kind} {r['case']} {dtype}: max_abs_err "
                f"{r['max_abs_err']:.3g} (tol {TOL[dtype]}) | kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
            rows[(kind, r["case"], dtype)] = r
            del c
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ serve
def phase_serve(torch, np):
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    model = build_model(SERVE_MODEL)
    cfg = model.config
    lens = SERVE_PROMPT_LENS
    t0 = time.perf_counter()
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(0),
        device=DEV, dtype=torch.bfloat16)
    eng = InferenceEngineV2(model, params, dtype=torch.bfloat16, block_size=64,
                            max_context=2048, max_sequences=16, device=DEV)
    torch.cuda.synchronize()
    log("serve", f"{SERVE_MODEL}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads, bf16, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]
    eng.generate([prompts[0][:64]], max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()

    pa.reset_launch_counts()
    t0 = time.perf_counter()
    first = eng.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    t1 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    full = time.perf_counter() - t1
    launches = dict(pa.LAUNCHES)

    for i, o in enumerate(outs):
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"prompt {i}: bad output {o}")
        if o[0] != first[i][0]:
            raise AssertionError(f"prompt {i}: first token {o[0]} differs "
                                 f"between runs ({first[i][0]})")
    probe = eng.put([7], [prompts[2]])[7]
    if not bool(torch.isfinite(probe).all()):
        raise AssertionError("non-finite logits")
    eng.flush([7])
    if launches["ragged_prefill_attention"] < 1 or \
            launches["paged_decode_attention"] < 1:
        raise AssertionError(f"the serving path missed the kernel: "
                             f"{launches}")
    decode_s = full - ttft
    n_decode = sum(len(o) - 1 for o in outs)
    log("serve", f"{len(lens)} prompts ({sum(lens)} tokens), 32 new tokens each, "
        f"greedy: TTFT (all 8 first tokens) {ttft * 1e3:.1f} ms, prefill "
        f"{sum(lens) / ttft:.0f} tok/s, decode {n_decode / decode_s:.1f} "
        f"tok/s ({n_decode} tokens in {decode_s:.3f} s = generate(32) - "
        f"generate(1)), launches prefill "
        f"{launches['ragged_prefill_attention']} decode "
        f"{launches['paged_decode_attention']}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("serve", f"tokens[0][:8] = {outs[0][:8]}")
    del eng, params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ parity
def phase_parity(torch, np):
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    model = build_model(SERVE_MODEL, num_layers=4, dtype="float32")
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(1),
        device=DEV, dtype=torch.float32)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, model.config.vocab_size, n).tolist()
               for n in (300, 130, 77)]
    new = 8
    res = {}
    for impl in ("kernel", "xla"):
        eng = InferenceEngineV2(model, params, dtype=torch.float32,
                                block_size=64, max_context=512,
                                max_tokens_per_batch=256, max_sequences=4,
                                prefill_attn=impl, decode_attn=impl,
                                device=DEV)
        out = eng.put([0, 1, 2], prompts)
        logits = torch.stack([out[u] for u in range(3)])
        eng.flush([0, 1, 2])
        res[impl] = (logits, eng.generate(prompts, max_new_tokens=new))
        del eng
    dense = torch.stack([model.apply(params, torch.tensor(
        [p], device=DEV))[0, -1] for p in prompts])
    greedy = []
    for p in prompts:
        seq = list(p)
        for _ in range(new):
            lg = model.apply(params, torch.tensor([seq], device=DEV))
            seq.append(int(lg[0, -1].argmax()))
        greedy.append(seq[len(p):])
    e_xla = float((res["kernel"][0] - res["xla"][0]).abs().max())
    e_dense = float((res["kernel"][0] - dense).abs().max())
    if not e_xla <= PARITY_TOL or not e_dense <= PARITY_TOL:
        raise AssertionError(f"logits: kernel vs xla {e_xla}, kernel vs "
                             f"dense {e_dense} (tol {PARITY_TOL})")
    if not res["kernel"][1] == res["xla"][1] == greedy:
        raise AssertionError(f"greedy tokens differ: kernel "
                             f"{res['kernel'][1]} xla {res['xla'][1]} dense "
                             f"{greedy}")
    log("parity", f"{SERVE_MODEL} width, 4 layers, fp32 (TF32 off), prompts "
        f"{[len(p) for p in prompts]}: last-token logits kernel vs xla "
        f"{e_xla:.3g}, kernel vs dense {e_dense:.3g} (tol {PARITY_TOL}); "
        f"greedy {new} tokens identical across kernel, xla and dense")
    del params
    torch.cuda.empty_cache()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no result",
              file=sys.stderr)
        return 2
    from deepspeedsyclsupport_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("device", f"{card} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    built = _build.build("paged_attention")
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", built.log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                         built.log)]
    log("build", f"{built.path.name} in {built.seconds:.1f} s: "
        f"{len(regs)} kernel instantiations, max {max(regs, default=0)} "
        f"registers, max {max(spills, default=0)} bytes spill stores")

    rows = phase_kernels(torch, np)
    launches = phase_serve(torch, np)
    phase_parity(torch, np)

    log("kernels", " | ".join(
        f"{k}: " + (f"ported (cuda, {src}), checked" if src else
                    "not yet ported") for k, src in TPU_KERNELS))
    entries = []
    for name, key in (("ragged_prefill_attention",
                       ("prefill", "llama2-7b", "bfloat16")),
                      ("paged_decode_attention",
                       ("decode", "decode-llama2-7b", "bfloat16"))):
        r = rows[key]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                               if k[0] == key[0]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
