#!/usr/bin/env python3
"""Drive the PyTorch port's serving (dense and MoE, quantized; the SLA
serving session, its supervisor and the engine snapshot), training,
evoformer and block-sparse attention paths on one NVIDIA GPU and check
them.

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

It imports nothing of JAX or the JAX package. Phases, one line each:

1. device  — the card (``nvidia-smi`` name and power limit) and versions;
             fails without CUDA.
2. build   — builds both CUDA kernel sources from ``deepspeedsyclsupport_
             tpu_torch/csrc`` with nvcc, in parallel (into
             ``build/torch_kernels/``); registers and spills per kernel
             instantiation of each library.
   rehearse— every paged-attention route, and the flash kernels' biased
             routes with the reducing dbias, once at a small shape in a
             child process under a timeout (a deadlocked mbarrier pipeline
             would hang the card), held against the plain versions.
3. kernel  — the ragged paged-attention kernels against their plain PyTorch
             version at the serving path's shapes (llama2-7b, mistral-7b with
             its 4096 window, an ALiBi case, Mixtral-8x7B's prefill (36
             atoms, GQA group 4), decode over 16 sequences), in
             bf16, fp16 and float32: each case's route as the library names
             it (the Hopper prefill, the split-KV decode or the CUDA-core
             kernel), O held by its max error and, in bf16 / fp16, row by
             row, exact zeros where nothing is visible, the same bits on
             repeat and no copy of the pool; times (CUDA events), TFLOP/s or
             GB/s against the bound, the decode wrapper's host time per
             call, and the time of one ``scaled_dot_product_attention`` call
             over the gathered KV as a yardstick (the port never calls it).
4. flash   — the flash-attention forward, dQ and dK/dV kernels against their
             plain versions (O, LSE, dQ, dK, dV) at llama2-1b (B=2, S=4096),
             mistral-7b heads (S=8192, window 4096), 4 packed documents,
             ALiBi with bloom-7b1 heads and an unaligned S=4000, in bf16 and
             float32 (O, dQ, dK and dV also held row by row); times, bounds,
             each kernel as the library names it (bf16: the Hopper wgmma +
             TMA ones, float32: the CUDA-core ones), each kernel's TFLOP/s,
             the host's time per forward call, and SDPA forward / backward
             as the yardstick where it computes the same function
             (llama2-1b, unaligned-4000). In bf16 the end-to-end dQ rows
             (the kernels' own O and LSE) are held at llama2-1b
             (``E2E_DQ_ROW_LIMIT``, ROADMAP C2) and logged elsewhere.
5. serve   — ``InferenceEngineV2`` serving llama2-7b at full width and depth
             (bf16, random weights from a seed, one params tree for the
             four phases below): greedy ``generate`` on 8 prompts of
             128-1024 tokens, 32 new tokens each, each decode step one CUDA
             graph replay. Kernel launch counts are zeroed just before and
             read just after; host dispatches per token and the card's busy
             share (``torch.profiler``) are logged.
   serve-fused — the same prompts with ``decode_steps_per_dispatch=8``
             after ``warmup(fused_ladder=True)`` (one CUDA graph per rung 8,
             4, 2): tokens equal to the per-token path's; decode tok/s, host
             dispatches per token, busy share, launches via replays.
   prefix  — 8 prompts sharing a 1024-token head (64-256-token tails) after
             one request carrying it, the prefix cache on vs off: tokens
             equal; prefill tokens computed and TTFT.
   flash-prefill — ``prefill_attn="flash"`` (the flash forward kernel on the
             serving path): its launches in every layer held, TTFT, and its
             logits and greedy tokens against ``"kernel"`` logged (bf16
             ties part them; phase 7 holds them in float32).
   session — ``ServingSession`` over the same llama2-7b (K = 8 after
             ``warmup(fused_ladder=True)``, a 32-block KV pool with evicted
             streams requeued, the prefix cache, the journal, the watchdog
             at 60 s): 48 requests from
             seed 0 (two tenants, prompts 128-1024, 32-128 new tokens,
             TTFT SLA 1.5 s, rate SLA 15 tok/s; 16 at 4 req/s, then 32 at
             once). Held: one terminal outcome per request, the journal's
             reconstructed outputs equal the delivered tokens, the trace
             join closes each admitted request once, eviction ran, the
             watchdog never fired, B1 launched in the window (counts zeroed
             just before, read just after). Logged: outcome counts, TTFT
             and ITL p50 / p99, goodput, host dispatches a token, the share
             of fused rounds, the capacity model's estimates; then decode
             tok/s with the journal on and off (16 requests at once) and
             the card's busy share over that decode window.
   session-parity — the paced part of that traffic at 4 layers, float32
             (TF32 off): each completed request's greedy tokens equal
             ``generate`` of its prompt alone.
   supervise — ``ReplicaSupervisor`` running ``serve_worker`` in a child
             process on the card (llama2-7b float32, 4 prompts of 64-256
             tokens, 16 new tokens): uninterrupted, then ``serve_crash``
             after 8 tokens; the worker's exit codes (0) and (1, 0), the
             replayed outputs equal the uninterrupted run's; time to
             recover.
   snapshot — ``serialize`` then ``deserialize(device="cuda")`` at 4
             layers, bf16: prefill logits bit-equal, greedy tokens equal;
             GB written and GB/s each way.
   mixtral — ``mixtral-8x7b`` at full width and depth, its layer weights
             int8 (built and quantized one layer at a time: 93 GB in bf16),
             bf16 compute, ``InferenceEngineV2(quantize_weights=True)``
             through the paged kernels at a GQA group of 4 and the grouped-
             GEMM MoE route: the 8 prompts' prefill with B1 held row by row
             in layers 0 and 31 (and one eager decode step likewise),
             ``warmup``, ``generate`` of 32 greedy tokens (TTFT, decode
             tok/s, peak memory, B1 launches, the decode window's busy share
             and kernel time by class); the MoE route against its plain
             loop (T 4608 and 8, routed and skewed), dequantization bit for
             bit (int8 and int4), and a 2-layer float32 parity of the
             kernel and plain engines (int8).
   Then a short fp16 serve at llama2-7b width (4 layers): the kernels
             against the plain path, greedy tokens equal, TTFT and decode
             tok/s.
6. train   — ``initialize`` -> ``train_batch`` on llama2-1b at full width
             and depth (bf16, AdamW, WarmupLR, clipping, 2 micro-batches of
             2 x 4096 tokens), 6 steps; flash launch counts zeroed just before
             and read just after, asserted per step, and no operand copied
             for any kernel's TMA (forward, dQ, dK/dV).
7. parity  — the serving width cut to 4 layers in float32: the engine
             through the kernel against the engine through the plain path,
             the engine through the flash prefill and the dense
             ``CausalLM.apply`` (plain attention): logits and greedy tokens.
8. trainpar— llama2-1b width cut to 2 layers, float32, TF32 off, B=2,
             S=2048, 3 steps through the kernels, the plain path and the
             kernels with activation checkpointing.
9. evoformer— ``DS4Sci_EvoformerAttention`` forward + backward at two
             OpenFold shapes (MSA row attention with pair bias, N_seq 512 x
             N_res 384, 8 heads x 32; triangle attention, 384 x 384, 4 heads
             x 32) in bf16, fp16 and float32, random inputs from a seed:
             launch counts zeroed just before each call and read just after
             (one of each flash kernel, the reducing dbias kernel included:
             ``flash_dbias_sm90_kernel`` in bf16 / fp16); O, LSE, dQ, dK, dV
             and dPair held against the plain versions, and in bf16 the
             end-to-end dQ rows (``E2E_DQ_ROW_LIMIT``); kernel times,
             bounds, and SDPA with a float mask (mask + pair bias) as the
             yardstick. Then one full-shape pair bias through
             ``flash_attention`` (dbias from the dQ kernel).
10. sparse — ``sparse_attention`` at BigBird-RoBERTa-base widths (12 heads
             x 64, block 64, 3 random + 3 window + 1 global blocks, B=2,
             S=4096, non-causal, bf16): launches around the call, outputs
             against the plain versions, times, bounds and SDPA with the
             expanded layout as a mask.
11. kernels — every TPU kernel of the JAX package and its status here.

Then a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure prints its error
and exits non-zero without that last line.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from functools import partial

MEM_BYTES_PER_S = 3.35e12                    # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": 67e12}                   # dense, no sparsity
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}
# gradient rows below this share of the tensor's largest magnitude are held
# against it: dQ of a query that sees one key is exactly zero (its dS row
# sums to zero) and comes out as float32 noise on both sides
GRAD_ROW_FLOOR = 1e-2
LSE_TOL = 1e-4              # absolute: LSE is float32 in kernel and plain
# End-to-end bf16 dQ rows (kernels vs plain versions, each side's delta
# from its own O) held at twice the JAX package's own end-to-end bf16 dQ
# row error against an fp64 oracle (tools/flash_e2e_row_error.py, CPU),
# since both sides may err by it: 0.0389 at the full-shape bias (B cut 4 ->
# 1), 0.0088 at MSA and at triangle (N_seq cut 512 -> 8, 384 -> 8; the
# reference errs more over more rows: 0.0825 at triangle's full 384, by the
# tool's emulation of its algebra, so these two limits are the stricter).
# Every bf16 / fp16 route multiplies P and dS as hi + lo operands, the
# reference's float32 (ROADMAP C2): the emulated port then errs as the
# reference does. llama2-1b (causal, no bias): twice the departure of the
# JAX package's algebra from the plain version end to end at the tool's
# unbiased causal shape (S 1024, H 8, D 64: 0.0038; P and dS rounded to bf16
# depart 0.0122), as tests/test_torch_flash_sm90_precision_host.py holds.
# At the held shape on an H100 80GB HBM3 (tools/c2_cost.py, the kernels as
# phase 4 runs them) the split kernels depart 0.0039 and the same kernels
# with P and dS rounded to bf16 depart 0.1295: the limit lies between.
E2E_DQ_ROW_LIMIT = {"full-bias": 2 * 0.0389, "msa-row-pair-bias": 2 * 0.0088,
                    "triangle-start": 2 * 0.0088, "llama2-1b": 2 * 0.0038}
PARITY_TOL = 5e-4
# train parity, float32 through the kernels vs the plain path: loss and
# grad_norm relative (summation order in attention, magnified by Adam's
# 1/sqrt(nu) on later steps)
TRAIN_PARITY_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
DEV = "cuda"
SERVE_MODEL = "llama2-7b"
SERVE_PROMPT_LENS = (128, 256, 384, 512, 640, 768, 896, 1024)
DECODE_TIMED = 128          # tokens of the generate that times decode
TRAIN_MODEL = "llama2-1b"
TRAIN_SEQ = 4096
TRAIN_STEPS = 6
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                 "warmup_max_lr": 3e-4,
                                                 "warmup_num_steps": 2}},
    "gradient_clipping": 1.0}
SOURCE = "deepspeedsyclsupport_tpu_torch/csrc/paged_attention.cu"
REPLACES = "deepspeedsyclsupport_tpu/ops/paged_attention.py:96"
FLASH_SOURCE = "deepspeedsyclsupport_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_fwd": "deepspeedsyclsupport_tpu/ops/flash_attention.py:145",
                  "flash_dq": "deepspeedsyclsupport_tpu/ops/flash_attention.py:208",
                  "flash_dkv": "deepspeedsyclsupport_tpu/ops/flash_attention.py:273",
                  "flash_dbias": "deepspeedsyclsupport_tpu/ops/flash_attention.py:330"}
TPU_KERNELS = [
    ("ops/paged_attention.py:96 _prefill_kernel", SOURCE),
    ("ops/flash_attention.py:145 _fwd_kernel", FLASH_SOURCE),
    ("ops/flash_attention.py:208 _dq_kernel", FLASH_SOURCE),
    ("ops/flash_attention.py:273 _dkv_kernel", FLASH_SOURCE),
    ("ops/flash_attention.py:330 _dbias_kernel", FLASH_SOURCE),
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


def host_us_per_call(torch, fn, reps=20):
    """Host wall time of one call of ``fn`` in microseconds, the calls
    issued back to back with no wait: what a launch costs the CPU."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e6


def hold(what, got, want, tol, relative=True):
    """Max abs error of got vs want; raises past ``tol``, taken relative to
    want's largest magnitude (at least 1) unless ``relative`` is false (LSE,
    float32 on both sides). Outputs are held relative because dK/dV and
    dPair sum over thousands of rows."""
    err = float((got.float() - want.float()).abs().max())
    lim = tol * (max(1.0, float(want.float().abs().max())) if relative
                 else 1.0)
    if not math.isfinite(err) or err > lim:
        raise AssertionError(f"{what}: kernel vs plain max abs err {err} > "
                             f"{lim}")
    return err, lim


def row_err(got, want, floor=0.0):
    """The largest over rows of the row's max abs error over its largest
    |want| (or ``floor`` times the largest |want| where that is more)."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    den = w.abs().amax(-1).clamp_min(max(1e-30,
                                         floor * float(w.abs().max())))
    return float(((g - w).abs().amax(-1) / den).max())


def hold_rows(what, got, want, tol, floor=0.0):
    """Largest over rows (every index but the last) of the row's max abs
    error over the row's largest |want|, or over ``floor`` times the
    largest |want| where that is more; raises past ``tol``. Unlike
    ``hold``, the few rows of large magnitude (attention's first rows) do
    not set the limit for the many small ones. With no floor a row that is
    zero in ``want`` (a masked row) must be zero in ``got``."""
    err = row_err(got, want, floor)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{what}: kernel vs plain row-relative err "
                             f"{err} > {tol}")
    return err, tol


# ------------------------------------------------------------------ build
def _instantiations(log_text):
    """(kernel, registers, spill-store bytes) per entry in a ptxas -v log."""
    out, name, spill = [], None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"(flash_(?:fwd|dq|dkv|dbias)_kernel|flash_(?:fwd|dq|"
                          r"dkv|dbias)_sm90_kernel|paged_attention_kernel|"
                          r"paged_prefill_sm90_kernel|paged_decode_(?:split|"
                          r"combine)_kernel)I(f|13__nv_bfloat16|6__half)"
                          r"((?:L[ib]\d+E)*)", name)
            label = name if k is None else "{}<{},{}>".format(
                k.group(1), {"f": "fp32", "13__nv_bfloat16": "bf16",
                             "6__half": "fp16"}[k.group(2)],
                ",".join(re.findall(r"\d+", k.group(3))))
            out.append((label, int(m.group(1)), spill))
            name = None
    return out


def phase_build(_build):
    """Both kernel sources with nvcc at once (one process each)."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("paged_attention", "flash_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(_build.build, names)))
    for name, b in built.items():
        inst = _instantiations(b.log)
        log("build", f"{b.path.name} in {b.seconds:.1f} s: {len(inst)} "
            f"kernel instantiations, max "
            f"{max((r for _, r, _ in inst), default=0)} registers, max "
            f"{max((s for _, _, s in inst), default=0)} bytes spill stores")
    for name in names:
        log("build", f"{name} instantiations (registers, spill bytes): "
            + "; ".join(f"{k} {r} {s}" for k, r, s in _instantiations(
                built[name].log)))
    log("build", f"both sources in {time.perf_counter() - t0:.1f} s")


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
    position). Returns (bound ms, "bytes" or "operations", bytes, flops)."""
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
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


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


def paged_calls(pa, c, decode):
    """(kernel, plain) calls of one case: the wrapper and its plain version
    on the same arguments."""
    kw = dict(block_size=c["bs"], alibi=c["alibi"], window=c["window"])
    if decode:
        q = c["q"][:, 0]
        seq_lens = c["pos0"] + c["qlen"]   # qlen 0 or 1: a dead slot is 0
        args = (q, c["k"], c["v"], c["tables"], seq_lens)
        return (partial(pa.paged_decode_attention, *args, **kw),
                partial(pa.paged_decode_attention_reference, *args, **kw))
    args = (c["q"], c["k"], c["v"], c["tables"], c["pos0"], c["qlen"])
    return (partial(pa.ragged_prefill_attention, *args, **kw),
            partial(pa.ragged_prefill_attention_reference, *args, **kw))


def check_attention(torch, np, c, decode):
    """Kernel vs plain on one case: max abs error, row by row in bf16 /
    fp16, exact zeros where nothing is visible, the same bits on repeat, no
    copy of the pool (beyond its output, the call allocates less than one K
    pool);
    then times and rates. Returns a result row."""
    import torch.nn.functional as F

    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    kernel, plain = paged_calls(pa, c, decode)
    route = pa.kernel_for(c["q"], c["k"], c["v"], c["bs"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = kernel()
    torch.cuda.synchronize()
    # beyond its output (at Mixtral's 36 atoms and 8 KV heads the output
    # outweighs a K pool)
    extra = torch.cuda.max_memory_allocated() - base - got.nbytes
    if extra >= c["k"].nbytes:
        raise AssertionError(f"{c['name']}: the call allocated {extra} "
                             f"bytes beyond its output, a pool is "
                             f"{c['k'].nbytes}")
    if not torch.equal(kernel(), got):
        raise AssertionError(f"{c['name']} {c['dtype']}: not bit-identical "
                             f"on repeat")
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    if not math.isfinite(err) or err > TOL[c["dtype"]]:
        raise AssertionError(f"{c['name']} {c['dtype']}: kernel vs plain "
                             f"max abs err {err} > {TOL[c['dtype']]}")
    row = (hold_rows(f"{c['name']} {c['dtype']}", got, want,
                     TOL[c["dtype"]])[0] if c["dtype"] != "float32"
           else row_err(got, want))
    if decode:
        dead = (c["qlen"] == 0).nonzero().squeeze(1)
        if dead.numel() and float(got[dead].abs().max()) != 0.0:
            raise AssertionError(f"{c['name']}: dead decode slots not zero")
    else:
        rows = torch.arange(c["q"].shape[1], device=got.device)[None, :]
        pad = rows >= c["qlen"].long()[:, None]
        if bool(pad.any()) and float(got[pad].abs().max()) != 0.0:
            raise AssertionError(f"{c['name']}: rows past qlen not zero")
    ms = cuda_ms(torch, kernel, reps=20)
    plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
    sq, sk, sv, smask = sdpa_inputs(torch, c)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=smask), reps=10)
    del sq, sk, sv, smask
    bound_ms, bound_by, nbytes, flops = work_of(np, c)
    return dict(case=c["name"], dtype=c["dtype"], max_abs_err=err,
                row_err=row, route=route, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=flops / (ms * 1e-3) / 1e12,
                gbps=nbytes / (ms * 1e-3) / 1e9,
                host_us=host_us_per_call(torch, kernel) if decode else None)


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
    for dtype in ("bfloat16", "float16", "float32"):
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
            # the mixtral phase's prefill: its 8 prompts (4608 tokens) as
            # one batch of 36 atoms from position 0 (the engine runs them
            # in 6 forwards of <= 768 tokens: the same query-key pairs)
            ("prefill", attention_case(
                torch, np, name="mixtral-8x7b", dtype=dtype, seed=7, h=32,
                kvh=8, bq=128, max_ctx=2048, n_atoms=36,
                seqs=[(0, n) for n in SERVE_PROMPT_LENS])),
            # the mixtral phase's decode: 16 slots, its 8 prompts 16 tokens
            # into generate(32)
            ("decode", attention_case(
                torch, np, name="decode-mixtral-8x7b", dtype=dtype, seed=6,
                h=32, kvh=8, bq=1, max_ctx=2048, n_atoms=16,
                seqs=[(n + 15, 1) for n in SERVE_PROMPT_LENS])),
        ]
        for kind, c in cases:
            r = check_attention(torch, np, c, decode=kind == "decode")
            rate = (f"{r['tflops']:.1f} TFLOP/s" if r["bound_by"] ==
                    "operations" else f"{r['gbps']:.0f} GB/s")
            log("kernel", f"{kind} {r['case']} {dtype} via {r['route']}: "
                f"max_abs_err {r['max_abs_err']:.3g} (tol {TOL[dtype]}), "
                f"row {r['row_err']:.3g}"
                + (" (held)" if dtype != "float32" else "")
                + f", bits repeat, no pool copy | kernel {r['ms']:.4f} ms "
                f"({rate}, {r['bound_ms'] / r['ms']:.1%} of the bound), "
                f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} "
                f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                + (f" | host {r['host_us']:.1f} us per call"
                   if r["host_us"] is not None else ""))
            rows[(kind, r["case"], dtype)] = r
            del c
            torch.cuda.empty_cache()
    return rows


# A new mbarrier pipeline that deadlocks hangs the card: each paged route
# runs first in a child process with a timeout, at a small shape.
REHEARSAL = [
    # (dtype, atoms, bq, h, kvh, d, block_size, bps, window, alibi)
    ("bfloat16", 4, 128, 4, 4, 128, 64, 8, None, False),
    ("float16", 3, 64, 8, 1, 64, 8, 12, 37, False),
    ("bfloat16", 3, 128, 4, 4, 128, 32, 10, None, True),
    ("float32", 4, 128, 4, 2, 128, 64, 8, None, False),
    ("bfloat16", 9, 1, 8, 8, 128, 64, 12, None, False),
    ("float16", 9, 1, 8, 2, 128, 16, 40, 300, True),
]
# ... and the flash kernels' biased routes (P and dS as hi + lo operands)
# and flash_dbias_sm90_kernel's ring, each once at a small shape
FLASH_REHEARSAL = [
    # (dtype, b, s, h, kvh, d, bias (Bb, Hb), causal, window, alibi, kbias)
    ("bfloat16", 6, 96, 4, 4, 32, (2, 4), False, None, False, True),
    ("float16", 4, 70, 4, 2, 64, (1, 2), True, 30, False, False),
    ("bfloat16", 2, 130, 4, 4, 128, (1, 4), True, None, True, True),
]
REHEARSAL_TIMEOUT_S = 240


def rehearse_flash(torch, np):
    """Each FLASH_REHEARSAL case once through the forward, dQ, dK/dV and
    reducing dbias wrappers, held against the plain versions."""
    from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    for i, (dtype, b, s, h, kvh, d, (bb, hb), causal, window, alibi,
            kbias) in enumerate(FLASH_REHEARSAL):
        gen = torch.Generator(device=DEV).manual_seed(100 + i)
        tdt = getattr(torch, dtype)
        q, do = (torch.randn((b, s, h, d), generator=gen, device=DEV).to(tdt)
                 for _ in range(2))
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device=DEV).to(tdt)
                for _ in range(2))
        bias = torch.randn((bb, hb, s, s), generator=gen, device=DEV)
        kb = None
        if kbias:
            kb = torch.where(torch.rand((b, s), generator=gen, device=DEV)
                             < 0.1, -1e9, 0.0)
        mask = fa.make_mask(q, k, causal=causal, window=window, k_bias=kb,
                            alibi=torch.from_numpy(alibi_slopes(h)).to(DEV)
                            if alibi else None)
        o, lse = fa.flash_fwd(q, k, v, mask, bias=bias)
        delta = fa.attention_delta(do, o)
        args = (q, k, v, do, lse, delta, mask)
        got = (o, fa.flash_dq(*args, bias=bias), *fa.flash_dkv(*args,
                                                              bias=bias),
               fa.flash_dbias(*args, bias))
        torch.cuda.synchronize()
        want = (fa.flash_attention_fwd_reference(q, k, v, mask, bias)[0],
                *fa.flash_attention_bwd_reference(*args, bias=bias),
                fa.flash_dbias_reference(*args, bias))
        for name, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
            hold(f"flash rehearsal {i} {dtype} {name}", g, w, TOL[dtype])
        print(f"flash case {i} {dtype} B {b} S {s} H {h}/{kvh} D {d} bias "
              f"[{bb}, {hb}] via {fa.kernel_name('dbias', tdt, d)}: ok",
              flush=True)


def rehearse_child(torch, np):
    """Each REHEARSAL and FLASH_REHEARSAL case once through the wrappers,
    held against the plain versions (the child of ``phase_rehearse``)."""
    from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    for i, (dtype, a, bq, h, kvh, d, bs, bps, window, alibi) in enumerate(
            REHEARSAL):
        rng = np.random.RandomState(i)
        cap, slots = bps * bs, (bps * a + 3) * bs
        pos0 = rng.randint(0, cap, a)
        qlen = np.minimum(rng.randint(1, bq + 1, a), cap - pos0)
        pos0[0], qlen[0], qlen[-1] = 0, min(bq, cap), 0
        gen = torch.Generator(device=DEV).manual_seed(i)
        tdt = getattr(torch, dtype)
        args = [torch.randn(shape, generator=gen, device=DEV).to(tdt)
                for shape in ((a, bq, h, d), (slots, kvh, d), (slots, kvh, d))]
        args += [torch.from_numpy(x.astype(np.int32)).to(DEV) for x in (
            rng.randint(0, slots // bs, (a, bps)), pos0, qlen)]
        kw = dict(block_size=bs, window=window, alibi=torch.from_numpy(
            alibi_slopes(h)).to(DEV) if alibi else None)
        got = pa.ragged_prefill_attention(*args, **kw)
        torch.cuda.synchronize()
        want = pa.ragged_prefill_attention_reference(*args, **kw)
        hold(f"rehearsal {i} {dtype}", got, want, TOL[dtype])
        print(f"case {i} {dtype} bq {bq} G {h // kvh} D {d} bs {bs} via "
              f"{pa.kernel_for(*args[:3], bs)}: ok", flush=True)
    rehearse_flash(torch, np)


def phase_rehearse():
    """``rehearse_child`` in a child process under a timeout."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, __file__, "--rehearse"],
                              capture_output=True, text=True,
                              timeout=REHEARSAL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"rehearsal did not finish in "
                             f"{REHEARSAL_TIMEOUT_S} s (a hung pipeline?)")
    if proc.returncode != 0:
        raise AssertionError(f"rehearsal failed (rc {proc.returncode})"
                             f":\n{proc.stdout}\n{proc.stderr[-4000:]}")
    log("rehearse", f"every paged route and the flash kernels' biased routes "
        f"ran once in a child process in "
        f"{time.perf_counter() - t0:.1f} s: "
        + "; ".join(proc.stdout.strip().splitlines()))


# ------------------------------------------------------------------ flash
FLASH_CASES = [
    dict(name="llama2-1b", b=2, s=4096, h=16, kvh=16, d=128),
    dict(name="mistral-7b", b=1, s=8192, h=32, kvh=8, d=128, window=4096),
    dict(name="packed-4-docs", b=1, s=4096, h=16, kvh=16, d=128,
         docs=(1500, 1000, 1100, 496)),
    dict(name="alibi-bloom-7b1", b=1, s=2048, h=32, kvh=32, d=128,
         alibi=True),
    dict(name="unaligned-4000", b=2, s=4000, h=16, kvh=16, d=128),
]


# flops per visible (query, key) pair, q head and unit of D
FLASH_FLOPS = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}


def flash_inputs(torch, c, dtype, seed):
    """q, k, v, dO (random normal from a seed) and the normalised mask."""
    from deepspeedsyclsupport_tpu_torch.models.layers import alibi_slopes
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    qs = (c["b"], c["s"], c["h"], c["d"])
    ks = (c["b"], c["s"], c["kvh"], c["d"])
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV).to(tdt)
                   for shape in (qs, ks, ks, qs))
    kw = dict(causal=True, window=c.get("window"))
    if "docs" in c:
        seg = torch.cat([torch.full((n,), i, dtype=torch.int32)
                         for i, n in enumerate(c["docs"])])
        kw["segment_ids"] = seg[None].expand(c["b"], -1).to(DEV)
    if c.get("alibi"):
        kw["alibi"] = torch.from_numpy(alibi_slopes(c["h"])).to(DEV)
    return q, k, v, do, fa.make_mask(q, k, **kw)


def visible_pairs(torch, m, b, sq, skv):
    """(query row, key) pairs the mask lets through, summed over the batch
    (per q head), counted on the card in row blocks."""
    total = 0
    dev = DEV
    pk = (torch.arange(skv, device=dev)[None].expand(b, -1)
          if m.pos_k is None else m.pos_k)
    for r0 in range(0, sq, 512):
        r1 = min(sq, r0 + 512)
        pq = ((torch.arange(r0, r1, device=dev) + skv - sq)[None].expand(
            b, -1) if m.pos_q is None else m.pos_q[:, r0:r1])
        vis = torch.ones((b, r1 - r0, skv), dtype=torch.bool, device=dev)
        if m.causal:
            vis &= pk[:, None, :] <= pq[:, :, None]
        if m.window is not None:
            vis &= pq[:, :, None] - pk[:, None, :] < m.window
        if m.seg_q is not None:
            vis &= m.seg_q[:, r0:r1, None] == m.seg_k[:, None, :]
        total += int(vis.sum())
    return total


def flash_bounds(c, dtype, pairs):
    """Least time for each kernel's work: the bytes each must move (inputs
    read once, outputs written once) over 3.35 TB/s, and its flops on the
    visible pairs (fwd 4D, dQ 6D, dK/dV 8D per pair and q head) over the
    dtype's peak; the larger of the two, and which one it is."""
    es = 4 if dtype == "float32" else 2
    b, s, h, kvh, d = c["b"], c["s"], c["h"], c["kvh"], c["d"]
    qb, kvb, row = b * s * h * d * es, b * s * kvh * d * es, b * h * s * 4
    moved = {"flash_fwd": qb + 2 * kvb + qb + row,
             "flash_dq": 3 * qb + 2 * kvb + 2 * row,
             "flash_dkv": 2 * qb + 4 * kvb + 2 * row}
    out = {}
    for name, nbytes in moved.items():
        flops = FLASH_FLOPS[name] * d * pairs * h
        t_bytes = nbytes / MEM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def sdpa_times(torch, q, k, v, do, gqa):
    """One ``scaled_dot_product_attention(is_causal=True)`` call on the same
    inputs: forward, and its backward as autograd (fwd+bwd) minus fwd. The
    port never calls it."""
    import torch.nn.functional as F

    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    go = do.transpose(1, 2)
    kw = dict(is_causal=True, enable_gqa=gqa)
    with torch.no_grad():
        fwd_nograd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, **kw), reps=10)
    fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, **kw), reps=10)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, **kw)
        torch.autograd.grad(out, (qs, ks, vs), go)

    return fwd_nograd, cuda_ms(torch, fwd_bwd, reps=5) - fwd


def flash_routes(fa, dtype, d):
    """Each flash kernel the built library launches for (dtype, D)."""
    return {f"flash_{k}": fa.kernel_name(k, dtype, d)
            for k in ("fwd", "dq", "dkv", "dbias")}


def hold_grad_rows(what, grads, refs, tol):
    """dq, dk and dv held row by row (``hold_rows`` with the floor)."""
    return {f"{n}_row": hold_rows(f"{what} {n}", g, r, tol, GRAD_ROW_FLOOR)
            for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}


def hold_kernel_rows(fa, what, args, refs, tol, bias=None):
    """The dQ and dK/dV kernels on ``args`` (q, k, v, dO, LSE, delta,
    mask: the plain version's inputs) held row by row against ``refs``."""
    got = (fa.flash_dq(*args, bias=bias), *fa.flash_dkv(*args, bias=bias))
    return hold_grad_rows(what, got, refs, tol)


def e2e_rows(grads, refs):
    """Row errors of end-to-end grads (delta from each side's own O, so the
    forward's rounding of P moves it by an ulp of O, which the dQ rows of a
    peaked softmax do not absorb): logged, and dQ's held where
    ``E2E_DQ_ROW_LIMIT`` grounds a limit (``hold_e2e_dq``)."""
    return {f"e2e_{n}_row": row_err(g, r, GRAD_ROW_FLOOR)
            for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}


def check_flash(torch, np, c, dtype, seed):
    """Kernels vs plain versions on one case; returns a result row."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    q, k, v, do, mask = flash_inputs(torch, c, dtype, seed)
    tol = TOL[dtype]
    o, lse = fa.flash_fwd(q, k, v, mask)
    # end to end: dQ from the kernels' own LSE and delta (their O)
    dq_e2e = fa.flash_dq(q, k, v, do, lse, fa.attention_delta(do, o), mask)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask)
    delta = fa.attention_delta(do, o_ref)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, mask)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, mask)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse_ref, delta,
                                            mask)
    e2e = {"e2e_dq_row": row_err(dq_e2e, refs[0], GRAD_ROW_FLOOR)}
    del dq_e2e
    errs = {"lse": hold(f"flash {c['name']} {dtype} lse", lse, lse_ref,
                        LSE_TOL, relative=False)}
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]),
                            ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        errs[name] = hold(f"flash {c['name']} {dtype} {name}", got, want,
                          tol)
    errs["o_row"] = hold_rows(f"flash {c['name']} {dtype} o", o, o_ref, tol)
    errs.update(hold_grad_rows(f"flash {c['name']} {dtype}", (dq, dk, dv),
                               refs, tol))
    del o_ref, lse_ref, refs, o, dq, dk, dv
    args = (q, k, v, do, lse, delta, mask)
    ms = {"flash_fwd": cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, mask),
                               reps=5),
          "flash_dq": cuda_ms(torch, lambda: fa.flash_dq(*args), reps=5),
          "flash_dkv": cuda_ms(torch, lambda: fa.flash_dkv(*args), reps=5)}
    plain = {
        "flash_fwd": cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q, k, v, mask), reps=1, warmup=1),
        "flash_dq": cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            *args, parts="dq"), reps=1, warmup=1),
        "flash_dkv": cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            *args, parts="dkv"), reps=1, warmup=1)}
    library = {}
    if not (c.get("window") or c.get("docs") or c.get("alibi")):
        # SDPA(is_causal) computes the same function only without these
        f, bwd = sdpa_times(torch, q, k, v, do, c["kvh"] != c["h"])
        library = {"flash_fwd": f, "flash_dq": bwd, "flash_dkv": bwd}
    pairs = visible_pairs(torch, mask, c["b"], c["s"], c["s"])
    flops = {n: f * c["d"] * pairs * c["h"] for n, f in FLASH_FLOPS.items()}
    return dict(case=c["name"], dtype=dtype, errs=errs, e2e=e2e, ms=ms,
                plain=plain,
                library=library, bounds=flash_bounds(c, dtype, pairs),
                pairs=pairs, routes=flash_routes(fa, q.dtype, c["d"]),
                tflops={n: flops[n] / (ms[n] * 1e-3) / 1e12 for n in ms},
                host_us=host_us_per_call(torch, lambda: fa.flash_fwd(
                    q, k, v, mask)))


def phase_flash(torch, np):
    rows = {}
    for dtype in ("bfloat16", "float32"):
        for i, c in enumerate(FLASH_CASES):
            r = check_flash(torch, np, c, dtype, seed=10 + i)
            err = ", ".join(f"{k} {e:.3g} (lim {lim:.3g})"
                            for k, (e, lim) in r["errs"].items())
            if dtype == "bfloat16" and c["name"] in E2E_DQ_ROW_LIMIT:
                err += hold_e2e_dq(f"flash {c['name']} {dtype}",
                                   dict(r["e2e"]), c["name"])
            else:
                err += (f" | end to end (not held) e2e_dq_row "
                        f"{r['e2e']['e2e_dq_row']:.3g}")
            times = " | ".join(
                f"{n[6:]} {r['ms'][n]:.3f} ms (plain {r['plain'][n]:.3f}, "
                f"bound {r['bounds'][n][0]:.3f} {r['bounds'][n][1]}"
                + (f", sdpa {r['library'][n]:.3f}" if r["library"] else "")
                + ")" for n in ("flash_fwd", "flash_dq", "flash_dkv"))
            log("flash", f"{c['name']} {dtype} B={c['b']} S={c['s']} "
                f"H={c['h']}/{c['kvh']} D={c['d']}, {r['pairs']} visible "
                f"pairs/head: {err} | {times} | kernels "
                + ", ".join(f"{n[6:]} {r['routes'][n]} "
                            f"{r['tflops'][n]:.1f} TFLOP/s"
                            for n in ("flash_fwd", "flash_dq", "flash_dkv"))
                + f" | host {r['host_us']:.1f} us per forward call")
            rows[(c["name"], dtype)] = r
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ serve
def serve_params(torch):
    """llama2-7b at full width and depth, bf16, random weights from a seed:
    one params tree for every llama2-7b serve phase."""
    from deepspeedsyclsupport_tpu_torch import build_model

    model = build_model(SERVE_MODEL)
    t0 = time.perf_counter()
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(0),
        device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = model.config
    log("serve", f"{SERVE_MODEL}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads, bf16, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return model, params


def serve_engine(torch, model, params, **kw):
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2

    return InferenceEngineV2(model, params, dtype=torch.bfloat16,
                             block_size=64, max_context=2048,
                             max_sequences=16, device=DEV, **kw)


def serve_prompts(np, cfg):
    rng = np.random.RandomState(0)
    return [rng.randint(1, cfg.vocab_size, n).tolist()
            for n in SERVE_PROMPT_LENS]


def timed_generate(torch, eng, prompts, new, rounds=3, long=DECODE_TIMED):
    """``generate`` of one token (TTFT), of ``new`` tokens (the outputs)
    and of ``long`` tokens, in turns, ``rounds`` times each: the outputs,
    the least TTFT s, the decode s (the least ``long``-token time less the
    least TTFT: the host-bound prefill varies by ~0.1 s from run to run, so
    a long decode keeps that spread small against it) and the decode
    tokens it covers."""
    t1, tl = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        t1.append(time.perf_counter() - t0)
        outs = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=long)
        torch.cuda.synchronize()
        tl.append(time.perf_counter() - t0)
        for i, o in enumerate(outs):
            if o[0] != first[i][0]:
                raise AssertionError(f"prompt {i}: first token {o[0]} "
                                     f"differs between runs ({first[i][0]})")
    return outs, min(t1), min(tl) - min(t1), len(prompts) * (long - 1)


def decode_busy(torch, eng, prompts, new):
    """The card's busy share over the decode part of ``generate`` of ``new``
    tokens under ``torch.profiler``: from the end of the last prefill
    kernel to the end of the last kernel, the union of kernel intervals
    (graph replays' kernels included) over that span
    (``tools/torch_serve_profile.py``); and its kernels."""
    from tools.torch_serve_profile import profile_window

    r = profile_window(torch, lambda: eng.generate(prompts,
                                                   max_new_tokens=new),
                       decode_after="paged_prefill")["decode"]
    return r["busy_share"], r["kernels"]


def phase_serve(torch, np, model, params):
    """The per-token path (one CUDA graph replay per decode step): greedy
    ``generate`` on 8 prompts, 32 new tokens; returns the launch counts and
    the tokens."""
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    cfg = model.config
    lens = SERVE_PROMPT_LENS
    eng = serve_engine(torch, model, params)
    prompts = serve_prompts(np, cfg)
    eng.generate([prompts[0][:64]], max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()

    pa.reset_launch_counts()
    eng.host_dispatches = 0
    outs, ttft, decode_s, n_decode = timed_generate(torch, eng, prompts, 32)
    launches = dict(pa.LAUNCHES)
    dispatches = eng.host_dispatches

    for i, o in enumerate(outs):
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"prompt {i}: bad output {o}")
    probe = eng.put([7], [prompts[2]])[7]
    if not bool(torch.isfinite(probe).all()):
        raise AssertionError("non-finite logits")
    eng.flush([7])
    if launches["ragged_prefill_attention"] < 1 or \
            launches["paged_decode_attention"] < 1:
        raise AssertionError(f"the serving path missed the kernel: "
                             f"{launches}")
    busy, kernels = decode_busy(torch, eng, prompts, 32)
    log("serve", f"{len(lens)} prompts ({sum(lens)} tokens), 32 new tokens "
        f"each, greedy, per-token decode (CUDA graph replays): TTFT (all 8 "
        f"first tokens) {ttft * 1e3:.1f} ms, prefill {sum(lens) / ttft:.0f} "
        f"tok/s, decode {n_decode / decode_s:.1f} tok/s ({n_decode} tokens "
        f"in {decode_s:.3f} s = generate({DECODE_TIMED}) - generate(1), "
        f"least of 3 each), host dispatches {dispatches} over 3 x "
        f"(generate(1) + generate(32) + generate({DECODE_TIMED})) "
        f"({dispatches / 3 / (n_decode + 34 * len(lens)):.3f} per token), "
        f"launches prefill "
        f"{launches['ragged_prefill_attention']} decode "
        f"{launches['paged_decode_attention']}; decode window (profiled): "
        f"card {100 * busy:.1f} % busy, {kernels} kernels; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("serve", f"tokens[0][:8] = {outs[0][:8]}")
    del eng
    torch.cuda.empty_cache()
    return launches, outs


def phase_serve_fused(torch, np, model, params, want):
    """Fused decode: ``decode_steps_per_dispatch`` 8, every rung captured
    by ``warmup(fused_ladder=True)``; the per-token phase's prompts and
    greedy tokens. Decode launches are counted per graph replay."""
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    eng = serve_engine(torch, model, params, decode_steps_per_dispatch=8)
    prompts = serve_prompts(np, model.config)
    t0 = time.perf_counter()
    eng.warmup(fused_ladder=True)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rungs = [key[0] for key in eng._decode_multi]
    if rungs != [8, 4, 2] or eng.seqs or eng.host_dispatches or \
            eng.allocator.free_blocks != eng.config.num_blocks:
        raise AssertionError(f"warmup: rungs {rungs}, seqs {list(eng.seqs)},"
                             f" dispatches {eng.host_dispatches}, free "
                             f"{eng.allocator.free_blocks}")
    pa.reset_launch_counts()
    outs, ttft, decode_s, n_decode = timed_generate(torch, eng, prompts, 32)
    launches = dict(pa.LAUNCHES)
    dispatches = eng.host_dispatches
    if outs != want:
        raise AssertionError(f"fused decode tokens differ from the per-token "
                             f"path's: {outs} vs {want}")
    replays = {k: r.launches[0].get("paged_decode_attention", 0)
               for k, r in eng._decode_multi.items()}
    if launches["paged_decode_attention"] < min(replays.values()):
        raise AssertionError(f"fused decode missed the kernel: {launches}")
    busy, kernels = decode_busy(torch, eng, prompts, 32)
    log("serve-fused", f"K=8, warmup (rungs {rungs}) {warm:.1f} s; 8 prompts"
        f", 32 greedy tokens each, equal to the per-token path's: TTFT "
        f"{ttft * 1e3:.1f} ms, decode {n_decode / decode_s:.1f} tok/s "
        f"({n_decode} tokens in {decode_s:.3f} s, least of 3 each), host "
        f"dispatches {dispatches} over 3 x (generate(1) + generate(32) + "
        f"generate({DECODE_TIMED})) "
        f"({dispatches / 3 / (n_decode + 34 * len(prompts)):.3f} per token), "
        f"launches via replays {launches} (per replay of rung K: "
        f"{ {k[0]: n for k, n in replays.items()} }); decode window "
        f"(profiled): card {100 * busy:.1f} % busy, {kernels} kernels")
    del eng
    torch.cuda.empty_cache()


PREFIX_HEAD = 1024
PREFIX_TAILS = (64, 96, 128, 160, 192, 224, 256, 200)


def phase_prefix(torch, np, model, params):
    """8 prompts sharing a 1024-token head with 64-256-token tails, after
    one request carrying that head: the prefix cache on vs off. Greedy
    tokens equal; prefill tokens computed and TTFT for each."""
    rng = np.random.RandomState(3)
    vocab = model.config.vocab_size
    head = rng.randint(1, vocab, PREFIX_HEAD).tolist()
    prompts = [head + rng.randint(1, vocab, n).tolist() for n in PREFIX_TAILS]
    first = head + rng.randint(1, vocab, 32).tolist()
    res = {}
    for arm in ("off", "on"):
        eng = serve_engine(torch, model, params)
        if arm == "on":
            eng.install_prefix_cache()
        eng.generate([first], max_new_tokens=2)   # warm-up, fills the cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ttft_toks = eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        outs = eng.generate(prompts, max_new_tokens=16)
        stats = eng.prefix_cache.stats() if arm == "on" else {}
        saved = stats.get("tokens_saved", 0)
        res[arm] = (outs, ttft, stats, saved)
        if [o[0] for o in outs] != [t[0] for t in ttft_toks]:
            raise AssertionError(f"prefix {arm}: first tokens differ")
        del eng
        torch.cuda.empty_cache()
    if res["on"][0] != res["off"][0]:
        raise AssertionError("prefix cache changed the greedy tokens")
    total = 2 * sum(len(p) for p in prompts)    # two generate calls
    on_saved = res["on"][3]
    if on_saved < 2 * len(prompts) * PREFIX_HEAD:
        raise AssertionError(f"prefix cache saved {on_saved} tokens, want "
                             f"the head of every prompt: {res['on'][2]}")
    log("prefix", f"8 prompts of a {PREFIX_HEAD}-token head + {PREFIX_TAILS}"
        f" tails, 16 greedy tokens each, equal with the cache on and off: "
        f"prefill tokens computed {total} off vs {total - on_saved} on; TTFT"
        f" {res['off'][1] * 1e3:.1f} ms off vs {res['on'][1] * 1e3:.1f} ms "
        f"on; cache stats {res['on'][2]}")


@contextlib.contextmanager
def hold_flash_prefill(num_layers):
    """While open, every call of the v2 model's ``_packed_flash_attention``
    (the ``flash`` prefill impl) in the first and last layer of a forward
    is held row by row (``hold_rows`` over query and head, bf16 ``TOL``)
    against the plain ``_paged_attention`` on the same inputs, at the
    serving path's own shapes; padded query rows (``token_seq == S``) are
    not held. Yields a list that gets (queries, gathered keys, row err)
    per held call."""
    from deepspeedsyclsupport_tpu_torch.inference.v2 import model as v2m

    packed, held, calls = v2m._packed_flash_attention, [], [0]

    def checked(q, k_cache, v_cache, token_seq, token_pos, block_tables,
                block_size, alibi=None, window=None):
        args = (q, k_cache, v_cache, token_seq, token_pos, block_tables,
                block_size)
        out = packed(*args, alibi=alibi, window=window)
        layer = calls[0] % num_layers
        calls[0] += 1
        if layer in (0, num_layers - 1):
            want = v2m._paged_attention(*args, alibi=alibi, window=window)
            live = token_seq < block_tables.shape[0]
            err, _ = hold_rows(f"flash prefill, layer {layer} of forward "
                               f"{calls[0] // num_layers}", out[live],
                               want[live], TOL["bfloat16"])
            held.append((int(live.sum()),
                         block_tables.numel() * block_size, err))
        return out

    v2m._packed_flash_attention = checked
    try:
        yield held
    finally:
        v2m._packed_flash_attention = packed
    if not held:
        raise AssertionError("flash prefill: no attention call was held")


def phase_flash_prefill(torch, np, model, params, want):
    """``prefill_attn="flash"`` at llama2-7b full depth, bf16: KV gathered
    once per sequence, the flash forward kernel with segments and
    positions, on the serving path. Logged against the per-token phase's
    ``"kernel"`` prefill: the prompts' last-token logits (max difference,
    the logits' spread, the top-2 gaps) and where the greedy tokens part.
    The two prefills round their attention outputs to bf16 from sums in
    other orders, and 32 random-weight layers amplify that to a few bf16
    ulps of the logits, whose top two tie (gap 0) for some prompts, and
    greedy tokens part within a few tokens. The flash prefill's logits and
    greedy tokens are held in float32 at 4 layers (``phase_parity``).
    Held here: the flash kernel's attention rows against the plain paged
    attention on the same inputs, in the first and last layer of every
    chunked-prefill forward of the 8 prompts (``hold_flash_prefill``); the
    flash kernel launched in every layer; finite logits."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    prompts = serve_prompts(np, model.config)
    uids = list(range(len(prompts)))
    logits = {}
    for impl in ("kernel", "flash"):
        eng = serve_engine(torch, model, params, prefill_attn=impl)
        if impl == "flash":
            with hold_flash_prefill(model.config.num_layers) as held:
                out = eng.put(uids, prompts)
        else:
            out = eng.put(uids, prompts)
        logits[impl] = torch.stack([out[u] for u in uids])
        del eng, out
        torch.cuda.empty_cache()
    lk, lf = logits["kernel"], logits["flash"]
    if not bool(torch.isfinite(lf).all()):
        raise AssertionError("flash prefill: non-finite logits")
    top2 = lk.topk(2, dim=-1).values
    eng = serve_engine(torch, model, params, prefill_attn="flash")
    eng.generate([prompts[0][:64]], max_new_tokens=2)   # warm-up
    fa.reset_launch_counts()
    outs, ttft, decode_s, n_decode = timed_generate(torch, eng, prompts, 32)
    launches = dict(fa.LAUNCHES)
    if launches["flash_fwd"] < model.config.num_layers:
        raise AssertionError(f"flash prefill missed the kernel: {launches}")
    parted = [next((j for j, (a, b) in enumerate(zip(o, w)) if a != b),
                   None) for o, w in zip(outs, want)]
    log("flash-prefill", f"8 prompts, 32 greedy tokens each through "
        f"{fa.kernel_name('fwd', torch.bfloat16, model.config.head_dim)}: "
        f"TTFT {ttft * 1e3:.1f} ms, decode {n_decode / decode_s:.1f} tok/s,"
        f" flash launches {launches}; attention rows held against the "
        f"plain paged attention in {len(held)} calls (layers 0 and "
        f"{model.config.num_layers - 1} of each forward; up to "
        f"{max(n for n, _, _ in held)} queries against "
        f"{max(c for _, c, _ in held)} gathered keys): worst row-relative "
        f"err {max(e for _, _, e in held):.3g} (tol {TOL['bfloat16']}); "
        f"against the kernel prefill (logged): "
        f"last-token logits max abs diff "
        + ", ".join(f"{float(x):.3g}" for x in (lf - lk).abs().amax(-1))
        + f" (logit std {float(lk.std()):.3g}), top-2 gap "
        + ", ".join(f"{float(x):.3g}" for x in top2[:, 0] - top2[:, 1])
        + f", first differing greedy token per prompt {parted}")
    del eng
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- session
# The session cell: 48 requests from seed 0 in two tenants, prompts uniform
# over 128-1024 tokens, 32-128 new tokens, a TTFT SLA of 1.5 s and a rate
# SLA of 15 tok/s; 16 arrive at 4 req/s, then 32 at once. The KV pool of
# 32 blocks (2048 tokens: ~3 of these requests) makes the burst evict, and
# evicted streams are requeued (tools/session_evictions.py counts the
# evictions per pool size and policy: requeue evicts more often than
# reject, whose victims leave).
SESSION_REQUESTS = 48
SESSION_PACED = 16
SESSION_RATE = 4.0            # req/s of the paced arrivals
SESSION_TTFT_SLA = 1.5
SESSION_RATE_SLA = 15.0
SESSION_BLOCKS = 32
SESSION_DECODE_NEW = 128      # new tokens of the journal on / off runs


def session_traffic(np, vocab, burst=True):
    """[(arrival s, uid, prompt, new tokens, tenant)], seed 0."""
    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, SESSION_REQUESTS)
    news = rng.randint(32, 129, SESSION_REQUESTS)
    prompts = [rng.randint(1, vocab, n).tolist() for n in lens]
    n = SESSION_REQUESTS if burst else SESSION_PACED
    return [(min(i, SESSION_PACED) / SESSION_RATE, i, prompts[i],
             int(news[i]), "ab"[i % 2]) for i in range(n)]


def drive_session(sess, traffic, sla=True):
    """Submit each request at its arrival time (the session's clock) and
    step the session until every request is done. Returns the events, the
    submit verdicts, the submit times and the wall seconds."""
    pending = list(traffic)
    events, verdicts, submitted = [], {}, {}
    start = sess.clock()
    while pending or not sess.idle:
        now = sess.clock()
        while pending and pending[0][0] <= now - start:
            _t, uid, toks, n, tenant = pending.pop(0)
            submitted[uid] = sess.clock()
            verdicts[uid] = sess.submit(
                uid, toks, n, tenant=tenant,
                ttft_sla_s=SESSION_TTFT_SLA if sla else None,
                rate_sla=SESSION_RATE_SLA if sla else None)
        if not sess.idle:
            events += sess.step()
        elif pending:
            time.sleep(max(0.0, pending[0][0] - (sess.clock() - start)))
    return events, verdicts, submitted, sess.clock() - start


def delivered(events):
    """uid -> [(t, tokens)] of the token events."""
    out = {}
    for e in events:
        if e.kind == "token":
            out.setdefault(e.uid, []).append((e.t, list(e.tokens)))
    return out


def session_latency(np, events, submitted, traffic):
    """TTFT per request, ITL samples (a fused round's gap over its tokens,
    per token), and the tokens of requests that met both SLAs."""
    toks = delivered(events)
    finish = {e.uid: e.reason for e in events if e.kind == "finish"}
    want = {uid: n for _t, uid, _p, n, _tn in traffic}
    ttft, itl, good = {}, [], 0
    for uid, evs in toks.items():
        ttft[uid] = evs[0][0] - submitted[uid]
        for (t0, _a), (t1, b) in zip(evs, evs[1:]):
            itl += [(t1 - t0) / len(b)] * len(b)
        n = sum(len(b) for _t, b in evs)
        span = evs[-1][0] - evs[0][0]
        rate = (n - 1) / span if span > 0 else float("inf")
        if finish.get(uid) in ("done", "eos") and n == want[uid] and \
                ttft[uid] <= SESSION_TTFT_SLA and rate >= SESSION_RATE_SLA:
            good += n
    return ttft, np.asarray(itl), good


def decode_run(torch, eng, prompts, journal_dir=None):
    """16 requests at once, ``SESSION_DECODE_NEW`` greedy tokens each, no
    SLA: the decode tok/s from the moment every request has its first token
    to idle, with the journal on (``journal_dir``) or off."""
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        ServingPolicyConfig, ServingSession, journal_path)

    policy = ServingPolicyConfig(
        journal_path=journal_path(journal_dir) if journal_dir else None)
    sess = ServingSession(eng, policy)
    for uid, p in enumerate(prompts):
        sess.submit(uid, p, SESSION_DECODE_NEW)
    seen = set()
    while len(seen) < len(prompts) and not sess.idle:
        for e in sess.step():
            if e.kind == "token":
                seen.add(e.uid)
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    while not sess.idle:
        n += sum(len(e.tokens) for e in sess.step() if e.kind == "token")
    torch.cuda.synchronize()
    sess.close()
    return n / (time.perf_counter() - t0), n


def phase_session(torch, np, model, params):
    """``ServingSession`` over llama2-7b at full width and depth (bf16):
    the SLA gate, slack-ordered batches, KV-pressure eviction (victims
    requeued), K-capped
    fused decode (K = 8, every rung captured by ``warmup``), the prefix
    cache, the journal and the stuck-decode watchdog (60 s), under the
    session cell's traffic. Holds: one terminal outcome per request, the
    journal's reconstructed outputs equal the delivered tokens, the trace
    join closes every admitted request once, eviction ran, the watchdog
    never fired, B1 launched in the window. Then decode tok/s with the
    journal on and off (16 requests at once, same traffic both times) and
    the card's busy share over that decode window."""
    import shutil
    import tempfile

    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        ServingPolicyConfig, ServingSession, journal_path, load_journal,
        reconstruct_outputs)
    from deepspeedsyclsupport_tpu_torch.monitor import reqtrace
    from deepspeedsyclsupport_tpu_torch.monitor.telemetry import (
        metrics_registry, resilience_counters)
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa
    from tools.torch_serve_profile import profile_window

    traffic = session_traffic(np, model.config.vocab_size)
    eng = serve_engine(torch, model, params, decode_steps_per_dispatch=8,
                       num_blocks=SESSION_BLOCKS)
    t0 = time.perf_counter()
    eng.warmup(fused_ladder=True)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    jdir = tempfile.mkdtemp(prefix="dstpu_session_")
    metrics_registry.reset()
    resilience_counters.reset()
    sess = ServingSession(eng, ServingPolicyConfig(
        prefix_cache={"enabled": True}, journal_path=journal_path(jdir),
        watchdog_enabled=True, watchdog_deadline_s=60.0, trace_stages=True,
        preempt_policy="requeue"))
    pa.reset_launch_counts()
    eng.host_dispatches = 0
    events, verdicts, submitted, wall = drive_session(sess, traffic)
    torch.cuda.synchronize()
    launches = dict(pa.LAUNCHES)
    sess.close()
    c = dict(sess.counters)

    # hold 1: exactly one terminal outcome per request
    terminal = {uid: int(v == "shed") for uid, v in verdicts.items()}
    for e in events:
        if e.kind in ("finish", "shed"):
            terminal[e.uid] += 1
    bad = {u: n for u, n in terminal.items() if n != 1}
    if len(terminal) != SESSION_REQUESTS or bad:
        raise AssertionError(f"session: terminal outcomes per uid {bad} "
                             f"({len(terminal)} requests)")
    # hold 2: the journal is the delivery record
    states, _t = load_journal(jdir)
    got = {u: [t for _tt, b in evs for t in b]
           for u, evs in delivered(events).items()}
    rebuilt = reconstruct_outputs(states)
    for uid in verdicts:
        if rebuilt.get(uid, []) != got.get(uid, []):
            raise AssertionError(f"session uid {uid}: journal outputs "
                                 f"{rebuilt.get(uid)} != delivered "
                                 f"{got.get(uid)}")
    # hold 3: the trace join closes every admitted request exactly once
    records = [r for p in sorted(os.listdir(jdir)) if p.endswith(".jsonl")
               for r in reqtrace.load_stream(os.path.join(jdir, p))]
    traces = reqtrace.join_traces([("0", "0", records)])
    for uid, v in verdicts.items():
        tr = traces.get(uid)
        closes = tr["closes"] if tr is not None else 0
        if closes != (0 if v == "shed" else 1):
            raise AssertionError(f"session uid {uid} ({v}): {closes} "
                                 f"closes in the joined trace")
    # holds 4-6: eviction ran, the watchdog never fired, B1 launched
    hangs = [r for r in records if r.get("name") == "serve/hang"]
    if c["evicted"] < 1:
        raise AssertionError(f"session: no eviction with {SESSION_BLOCKS} "
                             f"blocks: {c}")
    if hangs or resilience_counters.get("serve_hang_aborts"):
        raise AssertionError(f"session: the watchdog fired: {hangs}")
    if launches["ragged_prefill_attention"] < 1 or \
            launches["paged_decode_attention"] < 1:
        raise AssertionError(f"session missed the kernels: {launches}")
    rounds = [r["data"].get("mode") for r in records
              if r.get("name") == "serve/stage"
              and r["data"].get("stage") == "decode_round"]
    ttft, itl, good = session_latency(np, events, submitted, traffic)
    tt = np.asarray(list(ttft.values()))
    n_tok = sum(len(t) for t in got.values())
    log("session", f"{SESSION_REQUESTS} requests (2 tenants, prompts "
        f"128-1024, 32-128 new, TTFT SLA {SESSION_TTFT_SLA} s, rate SLA "
        f"{SESSION_RATE_SLA} tok/s; {SESSION_PACED} at {SESSION_RATE:g} "
        f"req/s then {SESSION_REQUESTS - SESSION_PACED} at once), K=8 "
        f"(warmup {warm:.1f} s), {SESSION_BLOCKS} KV blocks (victims "
        f"requeued), prefix cache, "
        f"journal, watchdog 60 s: admitted {c['admitted']}, queued "
        f"{c['queued']}, shed {c['shed']}, evicted {c['evicted']}, "
        f"completed {c['completed']} in {wall:.2f} s; TTFT p50 "
        f"{np.percentile(tt, 50) * 1e3:.1f} ms p99 "
        f"{np.percentile(tt, 99) * 1e3:.1f} ms ({len(tt)} requests), ITL "
        f"p50 {np.percentile(itl, 50) * 1e3:.2f} ms p99 "
        f"{np.percentile(itl, 99) * 1e3:.2f} ms; {n_tok} tokens delivered, "
        f"goodput (both SLAs met) {good / wall:.1f} tok/s of "
        f"{n_tok / wall:.1f}; host dispatches {eng.host_dispatches / n_tok:.3f}"
        f" a token; rounds fused {rounds.count('fused')} of {len(rounds)} "
        f"({rounds.count('fused') / max(1, len(rounds)):.1%}); B1 launches "
        f"prefill {launches['ragged_prefill_attention']} decode "
        f"{launches['paged_decode_attention']} (a graph replay counts the "
        f"launches its capture recorded); capacity model: prefill "
        f"{sess.capacity.prefill_tok_s:.0f} tok/s (best "
        f"{sess.capacity.prefill_tok_s_best:.0f}), decode "
        f"{sess.capacity.decode_step_s * 1e3:.2f} ms a step; prefix "
        f"{sess.prefix_stats()}")
    log("session", f"holds: one terminal outcome per request, journal "
        f"outputs = delivered tokens ({len(states)} journaled), "
        f"{len(traces)} traces joined, every admitted one closed once, "
        f"evictions {c['evicted']}, no serve/hang record")
    shutil.rmtree(jdir, ignore_errors=True)
    del eng, sess
    torch.cuda.empty_cache()

    # decode tok/s with the journal on and off, 16 requests at once
    eng = serve_engine(torch, model, params, decode_steps_per_dispatch=8)
    eng.warmup(fused_ladder=True)
    prompts = [p for _t, _u, p, _n, _tn in traffic[:16]]
    rates = {}
    for arm in ("on", "off", "on", "off"):
        jd = tempfile.mkdtemp(prefix="dstpu_decode_") if arm == "on" else None
        rate, n = decode_run(torch, eng, prompts, jd)
        rates.setdefault(arm, []).append(rate)
        if jd:
            shutil.rmtree(jd, ignore_errors=True)
    jd = tempfile.mkdtemp(prefix="dstpu_decode_")
    prof = profile_window(torch, lambda: decode_run(torch, eng, prompts, jd),
                          decode_after="paged_prefill")["decode"]
    shutil.rmtree(jd, ignore_errors=True)
    log("session", f"decode, 16 requests at once, {SESSION_DECODE_NEW} "
        f"greedy tokens each ({n} tokens after the last first token), K=8:"
        f" journal on {', '.join(f'{r:.1f}' for r in rates['on'])} tok/s, "
        f"off {', '.join(f'{r:.1f}' for r in rates['off'])} tok/s (runs "
        f"in the order on, off, on, off); decode window (profiled, journal "
        f"on): card {100 * prof['busy_share']:.1f} % busy, "
        f"{prof['kernels']} kernels")
    del eng
    torch.cuda.empty_cache()


def phase_session_parity(torch, np):
    """The session traffic's paced part (no burst, no eviction) through
    ``ServingSession`` at llama2-7b width cut to 4 layers, float32 (TF32
    off), K = 8: each completed request's greedy tokens equal
    ``generate`` of its prompt alone."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        ServingPolicyConfig, ServingSession)

    model = build_model(SERVE_MODEL, num_layers=4, dtype="float32")
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(1),
        device=DEV, dtype=torch.float32)
    traffic = session_traffic(np, model.config.vocab_size, burst=False)
    eng = InferenceEngineV2(model, params, dtype=torch.float32,
                            block_size=64, max_context=2048,
                            max_sequences=16, decode_steps_per_dispatch=8,
                            device=DEV)
    eng.warmup(fused_ladder=True)
    sess = ServingSession(eng, ServingPolicyConfig())
    events, verdicts, _sub, wall = drive_session(sess, traffic)
    c = dict(sess.counters)
    got = {u: [t for _tt, b in evs for t in b]
           for u, evs in delivered(events).items()}
    done = [e.uid for e in events if e.kind == "finish"
            and e.reason in ("done", "eos")]
    if c["evicted"] or not done:
        raise AssertionError(f"session-parity: {c}, completed {done}")
    want = {uid: n for _t, uid, _p, n, _tn in traffic}
    for _t, uid, p, n, _tn in traffic:
        if uid not in done:
            continue
        ref = eng.generate([p], max_new_tokens=n)[0]
        if got[uid] != ref or len(ref) != want[uid]:
            raise AssertionError(f"session-parity uid {uid}: session "
                                 f"{got[uid]} vs generate {ref}")
    log("session-parity", f"{SERVE_MODEL} width, 4 layers, fp32 (TF32 off),"
        f" K=8, {len(traffic)} requests at {SESSION_RATE:g} req/s with the "
        f"SLAs: {c} in {wall:.2f} s; every completed request's greedy "
        f"tokens ({len(done)}) equal generate of its prompt alone")
    del eng, sess, params
    torch.cuda.empty_cache()


# --------------------------------------------------------------- supervise
SUPERVISE_PROMPTS = 4
SUPERVISE_NEW = 16
SUPERVISE_CRASH_TOKENS = 8


def phase_supervise(torch, np):
    """``ReplicaSupervisor`` running ``serve_worker`` in a child process on
    the card: llama2-7b at full width and depth in float32, 4 prompts of
    64-256 tokens, 16 greedy tokens each. First an uninterrupted run, then
    one with ``serve_crash`` after 8 emitted tokens in the first
    incarnation. Holds: the worker's exit codes are (0) and (1, 0), and the
    crashed run's journal-reconstructed outputs equal the uninterrupted
    run's. Logs the time to recover."""
    import shutil
    import tempfile
    from pathlib import Path

    from deepspeedsyclsupport_tpu_torch.inference.v2 import ReplicaSupervisor

    from deepspeedsyclsupport_tpu_torch.models import get_config

    root = Path(__file__).resolve().parent
    rng = np.random.RandomState(5)
    vocab = get_config(SERVE_MODEL).vocab_size
    prompts = [rng.randint(1, vocab, n).tolist()
               for n in rng.randint(64, 257, SUPERVISE_PROMPTS)]
    tmp = tempfile.mkdtemp(prefix="dstpu_supervise_")
    torch.cuda.empty_cache()

    def run(name, inject):
        jdir = os.path.join(tmp, f"j_{name}")
        spec = {"model": SERVE_MODEL, "dtype": "float32", "device": DEV,
                "engine": {"dtype": "float32", "block_size": 64,
                           "max_context": 2048, "max_sequences": 16,
                           "num_blocks": 32},
                "journal_dir": jdir, "out": os.path.join(tmp, f"{name}.json"),
                "requests": [{"uid": u, "tokens": p,
                              "max_new_tokens": SUPERVISE_NEW}
                             for u, p in enumerate(prompts)]}
        path = os.path.join(tmp, f"spec_{name}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = {"PYTHONPATH": str(root)}
        if inject:
            env["DSTPU_FAULT_INJECTION"] = json.dumps(inject)
        rs = ReplicaSupervisor(
            [sys.executable, "-m",
             "deepspeedsyclsupport_tpu_torch.inference.v2.supervisor",
             "--worker", "--spec", path], restart_limit=1, poll_s=0.2,
            backoff_seconds=0.0, env=env,
            health_file=os.path.join(tmp, f"health_{name}.json"))
        t0 = time.perf_counter()
        rc = rs.run()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"supervise {name}: rc {rc}, launches "
                                 f"{rs.launch_history}")
        with open(spec["out"]) as f:
            return [h["rc"] for h in rs.launch_history], json.load(f), wall

    rcs0, base, wall0 = run("clean", None)
    rcs1, crash, wall1 = run("crash", {"serve_crash": {
        "tokens": SUPERVISE_CRASH_TOKENS, "attempt": 0}})
    shutil.rmtree(tmp, ignore_errors=True)
    if rcs0 != [0] or rcs1 != [1, 0]:
        raise AssertionError(f"supervise: worker rcs {rcs0} and {rcs1}, "
                             f"want [0] and [1, 0]")
    if crash["outputs"] != base["outputs"]:
        supervise_gap(torch, prompts, base["outputs"], crash["outputs"])
        raise AssertionError(f"supervise: outputs after the crash "
                             f"{crash['outputs']} != {base['outputs']}")
    log("supervise", f"{SERVE_MODEL} fp32 in a supervised child, "
        f"{SUPERVISE_PROMPTS} prompts {[len(p) for p in prompts]}, "
        f"{SUPERVISE_NEW} greedy tokens: uninterrupted rcs {rcs0} "
        f"({wall0:.1f} s); serve_crash after {SUPERVISE_CRASH_TOKENS} tokens "
        f"rcs {rcs1} ({wall1:.1f} s), replayed "
        f"{sorted(crash['recovery']['replayed'])}, time_to_recover_s "
        f"{crash['recovery']['time_to_recover_s']}; outputs equal the "
        f"uninterrupted run's")


def supervise_gap(torch, prompts, base, crash):
    """On a differing token: the top-2 logit gap of the uninterrupted
    run's context at the first differing step (the worker's weights)."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    model = build_model(SERVE_MODEL, dtype="float32")
    eng = InferenceEngineV2(model, model.init_params(device=DEV),
                            dtype=torch.float32, block_size=64,
                            max_context=2048, max_sequences=16,
                            num_blocks=32, device=DEV)
    for uid, want in base.items():
        have = crash.get(uid, [])
        j = next((i for i, (a, b) in enumerate(zip(want, have)) if a != b),
                 None)
        if j is None:
            continue
        lg = eng.put([0], [prompts[int(uid)] + want[:j]])[0]
        eng.flush([0])
        top = lg.topk(2).values
        log("supervise", f"uid {uid}: first differing step {j} ({want[j]} vs"
            f" {have[j]}), top-2 logit gap {float(top[0] - top[1]):.4g}")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- snapshot
def phase_snapshot(torch, np):
    """``serialize`` then ``deserialize(device="cuda")`` at llama2-7b width
    cut to 4 layers, bf16: prefill logits bit-equal to the original
    engine's, greedy tokens equal; GB written, seconds and GB/s each way
    (the read follows the write, so the page cache may serve it)."""
    import shutil
    import tempfile

    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.checkpoint.engine import DATA_FILE

    model = build_model(SERVE_MODEL, num_layers=4)
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(2), device=DEV,
        dtype=torch.bfloat16)
    eng = serve_engine(torch, model, params)
    del params
    tmp = tempfile.mkdtemp(prefix="dstpu_snapshot_")
    path = os.path.join(tmp, "snap")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.serialize(path)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(path, DATA_FILE))
    t0 = time.perf_counter()
    eng2 = InferenceEngineV2.deserialize(path, device=DEV)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    prompts = serve_prompts(np, model.config)
    uids = list(range(len(prompts)))
    logits = []
    for e in (eng, eng2):
        out = e.put(uids, prompts)
        logits.append(torch.stack([out[u] for u in uids]))
        e.flush(uids)
    if not torch.equal(logits[0], logits[1]):
        raise AssertionError(f"snapshot: prefill logits differ by "
                             f"{float((logits[0] - logits[1]).abs().max())}")
    outs = [e.generate(prompts, max_new_tokens=16) for e in (eng, eng2)]
    if outs[0] != outs[1]:
        raise AssertionError("snapshot: greedy tokens differ")
    log("snapshot", f"{SERVE_MODEL} width, 4 layers, bf16: {nbytes / 1e9:.3f}"
        f" GB written in {write_s:.2f} s ({nbytes / 1e9 / write_s:.2f} GB/s, "
        f"layers restacked a leaf at a time, fsynced), read onto the card in "
        f"{read_s:.2f} s ({nbytes / 1e9 / read_s:.2f} GB/s); 8 prompts' "
        f"prefill logits bit-equal, 16 greedy tokens equal")
    del eng, eng2
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- mixtral
MOE_MODEL = "mixtral-8x7b"
MOE_HOLD_TOKENS = (4608, 8)    # the serve prompts' prefill rows; 8 decodes


def _tensors(tree):
    """Every tensor of a params tree (a quantized leaf's codes and
    scales)."""
    from deepspeedsyclsupport_tpu_torch.compression.quantize import (
        QuantTensor)

    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, QuantTensor):
        yield from (tree.q, tree.scale)
    else:
        yield tree


def moe_params(torch, seed, wdtype, **overrides):
    """``mixtral-8x7b`` (with ``overrides``) built one layer at a time, its
    layer weights int8 (``quantize_tree``, group 64): each layer is drawn
    in ``wdtype`` on the card from a one-layer copy of the config with its
    own seed, the projections into the residual (``wo``, ``w_down``)
    rescaled to the full depth's std, quantized, and its float copy freed
    before the next (the whole tree in bf16 would be 93 GB). Layer 0's
    draw also gives the embedding, final norm and head, kept in
    ``wdtype`` as the engine leaves them; the later draws use a tied
    8-token vocabulary, so each of them draws its layer alone."""
    from deepspeedsyclsupport_tpu_torch import build_model
    from deepspeedsyclsupport_tpu_torch.compression.quantize import (
        quantize_tree)

    model = build_model(MOE_MODEL, **overrides)
    cfg = model.config
    first = build_model(MOE_MODEL, **dict(overrides, num_layers=1))
    rest = build_model(MOE_MODEL, **dict(overrides, num_layers=1,
                                         vocab_size=8, tie_embeddings=True))
    depth = math.sqrt(2 * 1) / math.sqrt(2 * cfg.num_layers)
    params, layers = None, []
    for li in range(cfg.num_layers):
        tree = (rest if layers else first).init_params(
            generator=torch.Generator(device=DEV).manual_seed(seed + li),
            device=DEV, dtype=wdtype)
        layer = tree.pop("layers")[0]
        if params is None:
            params = tree
        del tree
        layer["attn"]["wo"].mul_(depth)
        layer["moe"]["w_down"].mul_(depth)
        layers.append(quantize_tree(layer, 64))
        del layer
    params["layers"] = layers
    return model, params


@contextlib.contextmanager
def hold_moe_grouped(num_layers):
    """While open, the card's bf16 MoE route (``experts_grouped``, as
    ``moe_mlp_nodrop`` calls it inside the engine) is held in the first and
    last layer of every forward, row by row (bf16 ``TOL``), against
    ``experts_plain`` on the same served activations, gates, expert
    choices and dequantized experts. Runs eagerly: a CUDA graph capture
    cannot hold. Yields a list that gets (rows held, row err) per held
    call."""
    from deepspeedsyclsupport_tpu_torch.parallel import moe

    grouped, held, calls = moe.experts_grouped, [], [0]

    def checked(p, x, gate, experts, act):
        out = grouped(p, x, gate, experts, act)
        layer = calls[0] % num_layers
        calls[0] += 1
        if layer in (0, num_layers - 1):
            err, _ = hold_rows(
                f"MoE grouped route in the engine, layer {layer} of forward "
                f"{calls[0] // num_layers}", out,
                moe.experts_plain(p, x, gate, experts, act), TOL["bfloat16"])
            held.append((x.shape[0], err))
        return out

    moe.experts_grouped = checked
    try:
        yield held
    finally:
        moe.experts_grouped = grouped
    if not held:
        raise AssertionError("no grouped MoE call was held in the engine")


@contextlib.contextmanager
def hold_paged(kind, num_layers):
    """While open, the registered ``kernel`` implementation of ``kind``
    (``prefill_attn``: the ragged paged prefill over atoms;
    ``decode_attn``: the split-KV decode) is held in the first and last
    layer of every forward, row by row (``hold_rows`` over token and head,
    bf16 ``TOL``) against the plain version on the same inputs: the
    prefill against ``_paged_attention`` on the packed rows (padded rows
    not held), the decode against ``paged_decode_attention_reference``
    (inactive slots not held). Runs eagerly: a CUDA graph capture cannot
    hold. Yields a list that gets (rows held, row err) per held call."""
    import dataclasses

    from deepspeedsyclsupport_tpu_torch.inference.v2 import model as v2m
    from deepspeedsyclsupport_tpu_torch.inference.v2 import module_registry
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    reg = module_registry._REGISTRY[kind]
    spec, held, calls = reg["kernel"], [], [0]

    def checked(q, ctx):
        out = spec.fn(q, ctx)
        layer = calls[0] % num_layers
        calls[0] += 1
        if layer not in (0, num_layers - 1):
            return out
        if kind == "prefill_attn":
            want = v2m._paged_attention(
                q, ctx.k_cache, ctx.v_cache, ctx.token_seq, ctx.token_pos,
                ctx.block_tables, ctx.block_size, alibi=ctx.alibi,
                window=ctx.window)
            live = ctx.token_seq < ctx.block_tables.shape[0]
        else:
            want = pa.paged_decode_attention_reference(
                q, ctx.k_cache, ctx.v_cache, ctx.block_tables, ctx.seq_lens,
                block_size=ctx.block_size, alibi=ctx.alibi,
                window=ctx.window)
            live = ctx.seq_lens > 0
        err, _ = hold_rows(f"{kind} kernel, layer {layer} of forward "
                           f"{calls[0] // num_layers}", out[live], want[live],
                           TOL["bfloat16"])
        held.append((int(live.sum()), err))
        return out

    reg["kernel"] = dataclasses.replace(spec, fn=checked)
    try:
        yield held
    finally:
        reg["kernel"] = spec
    if not held:
        raise AssertionError(f"{kind}: no kernel call was held")


def hold_moe_routes(torch, moe_p):
    """The card's bf16 MoE route (grouped GEMMs) against the plain version
    on one Mixtral layer's dequantized experts, at the serve prompts'
    prefill rows and at 8 decode rows, routed by the router and skewed
    (expert 0 takes every token, the last expert none); rows held at the
    bf16 ``TOL``. Returns {(tokens, routing): (err, grouped ms, plain
    ms)}."""
    from deepspeedsyclsupport_tpu_torch.compression.quantize import (
        dequantize_tree)
    from deepspeedsyclsupport_tpu_torch.parallel import moe

    p = dequantize_tree(moe_p, torch.bfloat16)
    e = p["w_gate"].shape[0]
    act = moe._activation("silu")
    gen = torch.Generator(device=DEV).manual_seed(5)
    out = {}
    for t in MOE_HOLD_TOKENS:
        x = torch.randn((t, p["router"].shape[0]), generator=gen, device=DEV,
                        dtype=torch.float32).to(torch.bfloat16)
        gate, experts = moe.topk_route(x, p["router"], 2)
        skew = torch.stack([torch.zeros(t, dtype=torch.long, device=DEV),
                            1 + torch.arange(t, device=DEV) % (e - 2)],
                           dim=1)
        for routing, ex in (("router", experts), ("skewed", skew)):
            got = moe.experts_grouped(p, x, gate, ex, act)
            want = moe.experts_plain(p, x, gate, ex, act)
            err, _ = hold_rows(f"MoE grouped route, T={t}, {routing}", got,
                               want, TOL["bfloat16"])
            reps = 20 if t < 64 else 5
            out[(t, routing)] = (
                err, cuda_ms(torch, lambda: moe.experts_grouped(
                    p, x, gate, ex, act), reps),
                cuda_ms(torch, lambda: moe.experts_plain(
                    p, x, gate, ex, act), reps))
    return out


def hold_dequant(torch, np, qt):
    """Dequantization on the card against the plain formula on the host
    (codes times scale in float64, exact, rounded once to float32 and then
    to the type), bit for bit, int8 and int4, bf16 and float32, on one
    expert matrix. ``qt``: the layer's int8 ``w_gate``; its expert 0 is
    also quantized to int4 on the card."""
    from deepspeedsyclsupport_tpu_torch.compression.quantize import (
        QuantTensor, quantize_leaf)

    q8 = QuantTensor(qt.q[0], qt.scale[0], qt.group_size, qt.bits)
    q4 = quantize_leaf(q8.dequantize(torch.bfloat16), 64, bits=4)
    for qx in (q8, q4):
        codes = qx.q.cpu().numpy()
        if qx.bits == 4:
            b = codes.astype(np.int64)
            codes = np.stack([(b & 0xF) - 8, ((b >> 4) & 0xF) - 8],
                             -1).reshape(codes.shape[0], -1)
        g = qx.group_size
        scale = qx.scale.cpu().numpy().astype(np.float64)
        plain = (codes.reshape(codes.shape[0], -1, g).astype(np.float64)
                 * scale[..., None]).astype(np.float32).reshape(codes.shape)
        for dt in (torch.bfloat16, torch.float32):
            card = qx.dequantize(dt).cpu()
            want = torch.from_numpy(plain).to(dt)
            if not torch.equal(card.view(torch.int16 if dt == torch.bfloat16
                                         else torch.int32),
                               want.view(torch.int16 if dt == torch.bfloat16
                                         else torch.int32)):
                raise AssertionError(f"int{qx.bits} dequantize to {dt} on the"
                                     f" card differs from the plain formula")
    return tuple(q.shape for q in (q8, q4))


def phase_mixtral(torch, np):
    """``mixtral-8x7b`` at full width and depth on one card: int8 layer
    weights (built one layer at a time), bf16 compute, served by
    ``InferenceEngineV2(quantize_weights=True)`` through the Hopper paged
    kernels (GQA group 4) and the grouped-GEMM MoE route. Holds: B1's
    prefill and decode at these shapes (layers 0 and 31, row by row), the
    MoE route against the plain version, dequantization bit for bit, and a
    2-layer float32 parity of the kernel and plain engines."""
    import gc

    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2
    from deepspeedsyclsupport_tpu_torch.inference.v2 import model as v2m
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa
    from tools.torch_serve_profile import profile_window

    gc.collect()
    torch.cuda.empty_cache()
    log("mixtral", f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated on the card before the phase")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = moe_params(torch, 100, torch.bfloat16)
    torch.cuda.synchronize()
    cfg = model.config
    L = cfg.num_layers
    built_s = time.perf_counter() - t0
    nbytes = {"int8 codes": 0, "fp32 scales": 0, "bf16": 0}
    for t in _tensors(params):
        key = ("int8 codes" if t.dtype == torch.int8 else "fp32 scales"
               if t.dtype == torch.float32 else "bf16")
        nbytes[key] += t.numel() * t.element_size()
    log("mixtral", f"{MOE_MODEL}: {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_experts} experts x FFN {cfg.intermediate_size}, top-"
        f"{cfg.num_experts_per_tok}, {cfg.num_heads} q / {cfg.num_kv_heads} "
        f"KV heads; built layer by layer in {built_s:.1f} s: "
        + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in nbytes.items())
        + f"; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    eng = serve_engine(torch, model, params, quantize_weights=True,
                       prefill_attn="kernel", decode_attn="kernel")
    pool = 2 * eng.kv.k.numel() * eng.kv.k.element_size()
    log("mixtral", f"engine: {eng.config.num_blocks} KV blocks of "
        f"{eng.config.block_size} tokens (+ the sink), pool {pool / 1e9:.2f}"
        f" GB; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = serve_prompts(np, cfg)
    uids = list(range(len(prompts)))
    torch.cuda.reset_peak_memory_stats()     # the serving peak from here

    # holds 1 and 2: B1 and the grouped MoE route at Mixtral's serve
    # shapes, in the engine's prefill and one eager decode
    with hold_paged("prefill_attn", L) as held_p, \
            hold_moe_grouped(L) as held_mp:
        out = eng.put(uids, prompts)
    nxt = [int(out[u].argmax()) for u in uids]
    descs = [eng.seqs[u] for u in uids]
    positions, tables, active = eng._slot_arrays(descs)
    toks = np.zeros((eng.config.max_sequences,), np.int32)
    toks[:len(nxt)] = nxt
    with hold_paged("decode_attn", L) as held_d, \
            hold_moe_grouped(L) as held_md:
        v2m.decode_forward(model, eng.params, eng.kv,
                           *(torch.from_numpy(a).to(DEV) for a in (
                               toks, positions, tables, active)),
                           block_size=eng.config.block_size,
                           attn_impl="kernel")
    eng.flush(uids)
    del out
    log("mixtral", f"B1 held against the plain paged attention in layers 0 "
        f"and {L - 1}: prefill {len(held_p)} calls (up to "
        f"{max(n for n, _ in held_p)} rows), worst row err "
        f"{max(e for _, e in held_p):.3g}; decode {len(held_d)} calls, worst "
        f"{max(e for _, e in held_d):.3g} (tol {TOL['bfloat16']})")
    log("mixtral", f"MoE grouped route held against the plain version on the"
        f" served activations in layers 0 and {L - 1}: prefill "
        f"{len(held_mp)} calls (up to {max(n for n, _ in held_mp)} rows), "
        f"worst row err {max(e for _, e in held_mp):.3g}; decode "
        f"{len(held_md)} calls ({held_md[0][0]} rows), worst "
        f"{max(e for _, e in held_md):.3g} (tol {TOL['bfloat16']})")

    # serve: warmup, then generate through the per-token decode graph
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    pa.reset_launch_counts()
    eng.host_dispatches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0 - ttft
    n_decode = len(prompts) * 31
    launches = dict(pa.LAUNCHES)
    for i, o in enumerate(outs):
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"mixtral prompt {i}: bad output {o}")
        if o[0] != first[i][0]:
            raise AssertionError(f"mixtral prompt {i}: first token {o[0]} "
                                 f"differs between runs ({first[i][0]})")
    n_pre, n_dec = (launches["ragged_prefill_attention"],
                    launches["paged_decode_attention"])
    if n_pre < L or n_dec < 31 * L or n_pre % L or n_dec % L:
        raise AssertionError(f"mixtral serve missed the kernels: {launches}")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_window(torch, lambda: eng.generate(prompts,
                                                      max_new_tokens=8),
                          decode_after="paged_prefill")["decode"]
    busy, kernels = prof["busy_share"], prof["kernels"]
    log("mixtral", f"{len(prompts)} prompts ({sum(SERVE_PROMPT_LENS)} "
        f"tokens), 32 greedy tokens each, int8 weights, bf16: warmup "
        f"{warm:.1f} s; TTFT (all first tokens) {ttft * 1e3:.1f} ms; "
        f"decode {n_decode / decode_s:.2f} tok/s ({n_decode} tokens in "
        f"{decode_s:.3f} s = generate(32) - generate(1)), "
        f"{decode_s / 31 * 1e3:.1f} ms a step; B1 launches prefill {n_pre} "
        f"decode {n_dec} ({L} a forward), host dispatches "
        f"{eng.host_dispatches}; serving peak {peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}; "
        f"decode window of generate(8) (profiled): card {100 * busy:.1f} % "
        f"busy, {kernels} kernels")
    log("mixtral", "decode window of generate(8) (profiled), kernel ms a "
        "step (7 steps): by class " + ", ".join(
            f"{k} {v / 7:.2f}" for k, v in prof["by_class_ms"].items())
        + "; top " + "; ".join(f"{k} {v / 7:.2f}"
                               for k, v in prof["top_ms"].items()))
    log("mixtral", f"tokens[0][:8] = {outs[0][:8]}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # holds 2 and 3: the MoE route and dequantization on one layer
    routes = hold_moe_routes(torch, params["layers"][0]["moe"])
    log("mixtral", "MoE grouped route vs plain, layer 0's experts, bf16: "
        + "; ".join(f"T={t} {r}: row err {e:.3g}, {g:.3f} ms vs plain "
                    f"{p:.3f} ms" for (t, r), (e, g, p) in routes.items())
        + f" (tol {TOL['bfloat16']}; skewed: expert 0 every token, the "
        f"last none)")
    shapes = hold_dequant(torch, np, params["layers"][0]["moe"]["w_gate"])
    log("mixtral", f"dequantize on the card = the plain formula bit for bit "
        f"(bf16 and float32), int8 and int4, expert 0's w_gate "
        f"{list(shapes[0])}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # hold 4: float32 parity at Mixtral width, 2 layers, int8
    model, params = moe_params(torch, 200, torch.float32, num_layers=2,
                               dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (300, 130, 77)]
    res = {}
    for impl in ("kernel", "xla"):
        eng = InferenceEngineV2(
            model, params, dtype=torch.float32, block_size=64,
            max_context=512, max_tokens_per_batch=256, max_sequences=4,
            prefill_attn=impl, decode_attn=impl, quantize_weights=True,
            device=DEV)
        out = eng.put([0, 1, 2], prompts)
        logits = torch.stack([out[u] for u in range(3)])
        eng.flush([0, 1, 2])
        res[impl] = (logits, eng.generate(prompts, max_new_tokens=8))
        del eng, out
        gc.collect()
    err = float((res["kernel"][0] - res["xla"][0]).abs().max())
    if not err <= PARITY_TOL or res["kernel"][1] != res["xla"][1]:
        raise AssertionError(f"mixtral fp32 parity: logits {err} (tol "
                             f"{PARITY_TOL}), tokens kernel "
                             f"{res['kernel'][1]} plain {res['xla'][1]}")
    log("mixtral", f"{MOE_MODEL} width, 2 layers, fp32 (TF32 off), int8, "
        f"prompts {[len(p) for p in prompts]}: last-token logits kernel vs "
        f"plain {err:.3g} (tol {PARITY_TOL}); greedy 8 tokens identical; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_fp16(torch, np):
    """A short float16 serve at llama2-7b width (4 layers): the engine
    through the kernels (float16 prefill on the Hopper route, split-KV
    decode) against the engine through the plain path, greedy tokens
    equal; TTFT and decode tok/s of the kernel engine."""
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.ops import paged_attention as pa

    model = build_model(SERVE_MODEL, num_layers=4, dtype="float16")
    cfg = model.config
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(2), device=DEV,
        dtype=torch.float16)
    rng = np.random.RandomState(2)
    lens = SERVE_PROMPT_LENS
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]
    new = 16
    res = {}
    for impl in ("kernel", "xla"):
        eng = InferenceEngineV2(model, params, dtype=torch.float16,
                                block_size=64, max_context=2048,
                                max_sequences=16, prefill_attn=impl,
                                decode_attn=impl, device=DEV)
        eng.generate([prompts[0][:64]], max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        t1 = time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        res[impl] = (outs, ttft, time.perf_counter() - t1 - ttft,
                     dict(pa.LAUNCHES))
        del eng
        torch.cuda.empty_cache()
    outs, ttft, decode_s, launches = res["kernel"]
    if outs != res["xla"][0]:
        raise AssertionError(f"fp16 greedy tokens differ: kernel {outs} "
                             f"plain {res['xla'][0]}")
    if min(launches.values()) < 1 or any(res["xla"][3].values()):
        raise AssertionError(f"fp16 serve launches: kernel {launches}, "
                             f"plain {res['xla'][3]}")
    routes = (pa.kernel_name("prefill", torch.float16, cfg.head_dim),
              pa.kernel_name("decode", torch.float16, cfg.head_dim))
    n_decode = sum(len(o) - 1 for o in outs)
    log("serve", f"fp16 {SERVE_MODEL} width, 4 layers, {len(lens)} prompts "
        f"({sum(lens)} tokens), {new} greedy tokens each through {routes[0]}"
        f" / {routes[1]}: tokens equal to the plain path's; TTFT "
        f"{ttft * 1e3:.1f} ms (plain {res['xla'][1] * 1e3:.1f}), decode "
        f"{n_decode / decode_s:.1f} tok/s (plain "
        f"{n_decode / res['xla'][2]:.1f}), launches {launches}")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ train
def phase_train(torch, np):
    """llama2-1b at full width and depth through initialize/train_batch;
    returns the flash launch counts of the run."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    model = build_model(TRAIN_MODEL)
    cfg = model.config
    t0 = time.perf_counter()
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    eng, *_ = initialize(model=model, params=params, config=TRAIN_CONFIG,
                         device=DEV)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    gas = eng.gradient_accumulation_steps()
    n_tok = eng.train_batch_size() * TRAIN_SEQ
    log("train", f"{TRAIN_MODEL}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads x {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, {sum(t.numel() for t in eng._leaf_tensors) / 1e9:.3f}"
        f"B params (fp32 master, bf16 compute), batch {eng.train_batch_size()}"
        f" x {TRAIN_SEQ} = {n_tok} tokens/step in {gas} micro-batches; built "
        f"in {time.perf_counter() - t0:.1f} s")
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (eng.train_batch_size(), TRAIN_SEQ))
    batch = {"input_ids": torch.from_numpy(ids).to(DEV)}
    per_step = cfg.num_layers * gas
    want = {"flash_fwd": per_step * (2 if eng.module.config.remat else 1),
            "flash_dq": per_step, "flash_dkv": per_step, "flash_dbias": 0}
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    steps = []
    for step in range(TRAIN_STEPS):
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = eng.train_batch(batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = {k: fa.LAUNCHES[k] - before[k] for k in before}
        steps.append((loss, gn, dt))
        log("train", f"step {step + 1}{' (warm-up)' if step == 0 else ''}: "
            f"{dt * 1e3:.1f} ms, {n_tok / dt:.0f} tokens/s, loss {loss:.4f}, "
            f"grad_norm {gn:.4f}, lr {eng.get_lr():.3e}, flash launches "
            f"{got}")
        if got != want:
            raise AssertionError(f"step {step + 1}: flash launches {got}, "
                                 f"want {want} ({cfg.num_layers} layers x "
                                 f"{gas} micro-batches)")
        if any(fa.COPIES.values()):
            raise AssertionError(f"step {step + 1}: operands copied for "
                                 f"TMA {fa.COPIES}")
    launches = dict(fa.LAUNCHES)
    losses = [x[0] for x in steps]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train losses {losses}: not finite or not "
                             f"falling")
    timed = [x[2] for x in steps[1:]]
    log("train", f"{len(timed)} timed steps: mean {1e3 * sum(timed) / len(timed):.1f}"
        f" ms/step, {n_tok * len(timed) / sum(timed):.0f} tokens/s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash launches "
        f"over {TRAIN_STEPS} steps {launches}, kernels "
        f"{flash_routes(fa, torch.bfloat16, cfg.head_dim)}, operands copied "
        f"for TMA {fa.COPIES}")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_train_parity(torch, np):
    """2 layers of llama2-1b width in float32: kernels vs plain path vs
    kernels with activation checkpointing, 3 steps each."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize

    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-4,
                                                     "weight_decay": 0.1}},
           "gradient_clipping": 1.0}
    vocab = build_model(TRAIN_MODEL).config.vocab_size
    ids = np.random.RandomState(2).randint(0, vocab, (2, 2048))
    batch = {"input_ids": torch.from_numpy(ids).to(DEV)}
    runs = {}
    for name, impl, extra in (("kernel", "flash", {}), ("xla", "xla", {}),
                              ("remat", "flash",
                               {"activation_checkpointing": {}})):
        model = build_model(TRAIN_MODEL, num_layers=2, dtype="float32",
                            attn_impl=impl)
        params = model.init_params(
            generator=torch.Generator(device=DEV).manual_seed(1), device=DEV)
        eng, *_ = initialize(model=model, params=params,
                             config=dict(cfg, **extra), device=DEV)
        del params
        runs[name] = [(float(m["loss"]), float(m["grad_norm"]))
                      for m in (eng.train_batch(batch) for _ in range(3))]
        del eng
        torch.cuda.empty_cache()
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for (kl, kg), (xl, xg) in zip(runs["kernel"], runs["xla"]):
        worst["loss"] = max(worst["loss"], abs(kl - xl) / abs(xl))
        worst["grad_norm"] = max(worst["grad_norm"], abs(kg - xg) / abs(xg))
    if any(worst[k] > TRAIN_PARITY_TOL[k] for k in worst):
        raise AssertionError(f"train parity kernel vs xla {runs}: relative "
                             f"{worst} > {TRAIN_PARITY_TOL}")
    if runs["remat"] != runs["kernel"]:
        raise AssertionError(f"activation checkpointing changed the numbers:"
                             f" {runs['remat']} vs {runs['kernel']}")
    log("trainpar", f"{TRAIN_MODEL} width, 2 layers, fp32 (TF32 off), B=2 "
        f"S=2048, 3 steps: (loss, grad_norm) kernel {runs['kernel']}, xla "
        f"{runs['xla']}; worst relative diff {worst} (tol "
        f"{TRAIN_PARITY_TOL}); kernel with activation checkpointing "
        f"identical")


# ------------------------------------------------------------------ parity
def phase_parity(torch, np):
    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model

    # attn_impl="xla": the dense oracle keeps plain attention
    model = build_model(SERVE_MODEL, num_layers=4, dtype="float32",
                        attn_impl="xla")
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(1),
        device=DEV, dtype=torch.float32)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, model.config.vocab_size, n).tolist()
               for n in (300, 130, 77)]
    new = 8
    res = {}
    for impl in ("kernel", "xla", "flash"):
        eng = InferenceEngineV2(model, params, dtype=torch.float32,
                                block_size=64, max_context=512,
                                max_tokens_per_batch=256, max_sequences=4,
                                prefill_attn=impl,
                                decode_attn="kernel" if impl == "flash"
                                else impl, device=DEV)
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
    e_flash = float((res["flash"][0] - dense).abs().max())
    if not max(e_xla, e_dense, e_flash) <= PARITY_TOL:
        raise AssertionError(f"logits: kernel vs xla {e_xla}, kernel vs "
                             f"dense {e_dense}, flash prefill vs dense "
                             f"{e_flash} (tol {PARITY_TOL})")
    if not res["kernel"][1] == res["xla"][1] == res["flash"][1] == greedy:
        raise AssertionError(f"greedy tokens differ: kernel "
                             f"{res['kernel'][1]} xla {res['xla'][1]} flash "
                             f"{res['flash'][1]} dense {greedy}")
    log("parity", f"{SERVE_MODEL} width, 4 layers, fp32 (TF32 off), prompts "
        f"{[len(p) for p in prompts]}: last-token logits kernel vs xla "
        f"{e_xla:.3g}, kernel vs dense {e_dense:.3g}, flash prefill vs dense"
        f" {e_flash:.3g} (tol {PARITY_TOL}); greedy {new} tokens identical "
        f"across kernel, xla, flash prefill and dense")
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------- evoformer
# OpenFold / AlphaFold 2 fine-tuning crop (N_res 384, N_seq 512):
# MSARowAttentionWithPairBias (c_hidden_msa_att 32, no_heads_msa 8) and
# TriangleAttention starting node (c_hidden_pair_att 32, no_heads_pair 4)
EVO_CASES = [
    dict(name="msa-row-pair-bias", b=1, n=512, s=384, h=8, d=32),
    dict(name="triangle-start", b=1, n=384, s=384, h=4, d=32),
]
EVO_MASKED = 0.1            # share of keys at -1e9 in the mask bias


def evo_inputs(torch, c, dtype, seed):
    """q, k, v, dO [B, N, S, H, D], mask bias [B, N, 1, 1, S] (0 or -1e9)
    and pair bias [B, 1, H, S, S], random from a seed, on the card."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (c["b"], c["n"], c["s"], c["h"], c["d"])
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV).to(tdt)
                   for _ in range(4))
    keep = torch.rand((c["b"], c["n"], 1, 1, c["s"]), generator=gen,
                      device=DEV) >= EVO_MASKED
    mask_bias = torch.where(keep, 0.0, -1e9).to(tdt)
    pair = torch.randn((c["b"], 1, c["h"], c["s"], c["s"]), generator=gen,
                       device=DEV).to(tdt)
    return q, k, v, do, mask_bias, pair


def bias_bounds(dtype, *, rows, h, d, s, pairs, extra_bytes, dbias_bytes):
    """Least time for each kernel's work at a shape with biases or a layout:
    inputs read once and outputs written once over 3.35 TB/s (the biases and
    layout as the kernels take them: ``extra_bytes``; the float32 dbias
    ``dbias_bytes``, 0 without one), and flops on the visible pairs (fwd 4D,
    dQ 6D, dK/dV 8D per pair and head; dbias 4D per pair and head of every
    replica: its s and dp) over the dtype's peak. ``rows``: the (flattened)
    batch; ``pairs``: visible (i, j) per row and head; H = KVH."""
    es = 4 if dtype == "float32" else 2
    qb, row = rows * s * h * d * es, rows * h * s * 4
    work = {"flash_fwd": (4 * qb + row + extra_bytes,
                          4 * d * pairs * h * rows),
            "flash_dq": (5 * qb + 2 * row + extra_bytes,
                         6 * d * pairs * h * rows),
            "flash_dkv": (6 * qb + 2 * row + extra_bytes,
                          8 * d * pairs * h * rows)}
    if dbias_bytes:
        work["flash_dbias"] = (4 * qb + 2 * row + extra_bytes + dbias_bytes,
                               4 * d * pairs * h * rows)
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / MEM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def sdpa_bias_times(torch, q, k, v, do, mask_bias, pair):
    """The yardstick: one ``scaled_dot_product_attention`` call on [B*N, H,
    S, D] views with a float ``attn_mask`` [B*N, H, S, S]. Forward with mask
    + pair bias summed beforehand (not timed); forward + backward with the
    sum built in the graph from a pair bias that requires grad (grads of q,
    k, v and the pair bias, the sum over N included), minus the forward.
    Returns (fwd ms, bwd ms or None, note)."""
    import torch.nn.functional as F

    b, n, s, h, d = q.shape
    qs, ks, vs, go = (t.reshape(b * n, s, h, d).transpose(1, 2)
                      for t in (q, k, v, do))

    def attn_mask(p):
        return (mask_bias + p).reshape(b * n, h, s, s)

    with torch.no_grad():
        summed = attn_mask(pair)
        fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=summed), reps=5)
        del summed
    leaves = [t.detach().requires_grad_() for t in (qs, ks, vs, pair)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves[:3],
                                             attn_mask=attn_mask(leaves[3]))
        torch.autograd.grad(out, leaves, go)

    try:
        both = cuda_ms(torch, fwd_bwd, reps=3, warmup=1)
    except (RuntimeError, torch.OutOfMemoryError) as e:
        # a yardstick the port never calls: PyTorch may refuse this grad
        torch.cuda.empty_cache()
        return fwd, None, f"bwd n/a ({type(e).__name__}: {str(e)[:160]})"
    return fwd, both - fwd, "bwd = fwd+bwd - fwd, with the pair bias's grad"


def check_evoformer(torch, c, dtype, seed):
    """One ``DS4Sci_EvoformerAttention`` forward + backward through the
    kernels (launches counted around it alone), its outputs held against the
    plain versions, then each kernel timed at this shape."""
    from deepspeedsyclsupport_tpu_torch.ops import DS4Sci_EvoformerAttention
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    q, k, v, do, mask_bias, pair = evo_inputs(torch, c, dtype, seed)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, pair)]
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = DS4Sci_EvoformerAttention(*leaves[:3], [mask_bias, leaves[3]])
    out.backward(do)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    want = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_dbias": 1}
    if launches != want:
        raise AssertionError(f"evoformer {c['name']} {dtype}: launches "
                             f"{launches}, want {want}")

    b, n, s, h, d = (c[x] for x in ("b", "n", "s", "h", "d"))
    rows = b * n
    qf, kf, vf, dof = (t.reshape(rows, s, h, d) for t in (q, k, v, do))
    mask = fa.make_mask(qf, kf, causal=False,
                        k_bias=mask_bias.reshape(rows, s))
    bias = fa.check_bias(pair[:, 0], qf, kf)
    tol = TOL[dtype]
    o_ref, lse_ref = fa.flash_attention_fwd_reference(qf, kf, vf, mask, bias)
    delta_ref = fa.attention_delta(dof, o_ref)
    refs = fa.flash_attention_bwd_reference(qf, kf, vf, dof, lse_ref,
                                            delta_ref, mask, bias=bias)
    dpair_ref = fa.flash_dbias_reference(qf, kf, vf, dof, lse_ref, delta_ref,
                                         mask, bias)
    o, lse = fa.flash_fwd(qf, kf, vf, mask, bias=bias)
    torch.cuda.synchronize()
    errs = {"o": hold("o", out.detach().reshape(rows, s, h, d), o_ref, tol),
            "o_row": hold_rows("o", out.detach().reshape(rows, s, h, d),
                               o_ref, tol),
            "lse": hold("lse", lse, lse_ref, LSE_TOL, relative=False)}
    for name, got, ref in zip(("dq", "dk", "dv", "dpair"), leaves,
                              (*refs, dpair_ref[:, None])):
        errs[name] = hold(f"evoformer {c['name']} {dtype} {name}",
                          got.grad.reshape(ref.shape), ref, tol)
    errs.update(hold_kernel_rows(
        fa, f"evoformer {c['name']} {dtype}",
        (qf, kf, vf, dof, lse_ref, delta_ref, mask), refs, tol, bias))
    e2e = e2e_rows([t.grad.reshape(r.shape) for t, r in zip(leaves, refs)],
                   refs)
    del out, leaves, o_ref, refs, dpair_ref

    delta = fa.attention_delta(dof, o)
    args = (qf, kf, vf, dof, lse, delta, mask)
    ms = {"flash_fwd": cuda_ms(torch, lambda: fa.flash_fwd(
              qf, kf, vf, mask, bias=bias), reps=3),
          "flash_dq": cuda_ms(torch, lambda: fa.flash_dq(*args, bias=bias),
                              reps=3),
          "flash_dkv": cuda_ms(torch, lambda: fa.flash_dkv(*args, bias=bias),
                               reps=3),
          "flash_dbias": cuda_ms(torch, lambda: fa.flash_dbias(*args, bias),
                                 reps=3)}
    plain = {
        "flash_fwd": cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            qf, kf, vf, mask, bias), reps=1, warmup=1),
        "flash_dq": cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            *args, parts="dq", bias=bias), reps=1, warmup=1),
        "flash_dkv": cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            *args, parts="dkv", bias=bias), reps=1, warmup=1),
        "flash_dbias": cuda_ms(torch, lambda: fa.flash_dbias_reference(
            *args, bias), reps=1, warmup=1)}
    library, note = {}, f"not timed in {dtype}"
    if dtype == "bfloat16":
        sf, sb, note = sdpa_bias_times(torch, q, k, v, do, mask_bias, pair)
        library = {"flash_fwd": sf, "flash_dq": sb, "flash_dkv": sb,
                   "flash_dbias": sb}
    bounds = bias_bounds(dtype, rows=rows, h=h, d=d, s=s, pairs=s * s,
                         extra_bytes=4 * (bias.numel() + rows * s),
                         dbias_bytes=4 * bias.numel())
    return dict(case=c["name"], dtype=dtype, errs=errs, ms=ms, plain=plain,
                library=library, note=note, bounds=bounds, launches=launches,
                wall_ms=wall_ms, routes=flash_routes(fa, q.dtype, d), e2e=e2e)


def check_full_bias(torch, dtype, seed):
    """A full-shape pair bias [B, H, S, S] through ``flash_attention``
    forward + backward: its gradient comes from the dQ kernel (no dbias
    launch), held against the plain versions."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 4, 1024, 8, 64
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                               device=DEV).to(tdt) for _ in range(4))
    bias = torch.randn((b, h, s, s), generator=gen, device=DEV).to(tdt)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    fa.reset_launch_counts()
    out = fa.flash_attention(*leaves[:3], causal=True, bias=leaves[3])
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    want = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_dbias": 0}
    if launches != want:
        raise AssertionError(f"full-shape bias {dtype}: launches {launches},"
                             f" want {want}")
    mask = fa.make_mask(q, k, causal=True)
    b32 = fa.check_bias(bias, q, k)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask, b32)
    delta = fa.attention_delta(do, o_ref)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse_ref, delta,
                                            mask, bias=b32)
    dbias_ref = fa.flash_dbias_reference(q, k, v, do, lse_ref, delta, mask,
                                         b32)
    tol = TOL[dtype]
    errs = {"o": hold("full-bias o", out.detach(), o_ref, tol),
            "o_row": hold_rows("full-bias o", out.detach(), o_ref, tol)}
    for name, t, ref in zip(("dq", "dk", "dv", "dbias"), leaves,
                            (*refs, dbias_ref)):
        errs[name] = hold(f"full-bias {dtype} {name}", t.grad, ref, tol)
    errs.update(hold_kernel_rows(fa, f"full-bias {dtype}",
                                 (q, k, v, do, lse_ref, delta, mask), refs,
                                 tol, b32))
    return errs, launches, e2e_rows([t.grad for t in leaves[:3]], refs)


def hold_e2e_dq(what, e2e, name):
    """The end-to-end dQ row error of ``e2e`` (``e2e_rows``) held at
    ``E2E_DQ_ROW_LIMIT[name]``: popped from ``e2e`` and returned as a log
    note."""
    lim = E2E_DQ_ROW_LIMIT[name]
    err = e2e.pop("e2e_dq_row")
    if not err <= lim:
        raise AssertionError(f"{what}: end-to-end dQ row error {err} > {lim}")
    return f" | end to end e2e_dq_row {err:.3g} (held, lim {lim:.3g})"


def phase_evoformer(torch, np):
    rows, launches = {}, {}
    for dtype in ("bfloat16", "float16", "float32"):
        for i, c in enumerate(EVO_CASES):
            r = check_evoformer(torch, c, dtype, seed=30 + i)
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
            err = ", ".join(f"{k} {e:.3g} (lim {lim:.3g})"
                            for k, (e, lim) in r["errs"].items())
            held = (hold_e2e_dq(f"evoformer {c['name']} {dtype}", r["e2e"],
                                c["name"]) if dtype == "bfloat16" else "")
            times = " | ".join(
                f"{n[6:]} {r['ms'][n]:.3f} ms (plain {r['plain'][n]:.3f}, "
                f"bound {r['bounds'][n][0]:.4f} {r['bounds'][n][1]}"
                + (f", sdpa {r['library'][n]:.3f}"
                   if r["library"].get(n) is not None else "") + ")"
                for n in ("flash_fwd", "flash_dq", "flash_dkv",
                          "flash_dbias"))
            log("evoformer", f"{c['name']} {dtype} B={c['b']} N={c['n']} "
                f"S={c['s']} H={c['h']} D={c['d']}: fwd+bwd through "
                f"DS4Sci_EvoformerAttention {r['wall_ms']:.1f} ms wall, "
                f"launches {r['launches']}, kernels {r['routes']}; {err}"
                f"{held} | end to end (not held) " + ", ".join(
                    f"{k} {e:.3g}" for k, e in r["e2e"].items())
                + f" | {times} | sdpa: {r['note']}")
            rows[(c["name"], dtype)] = r
            torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        errs, got, e2e = check_full_bias(torch, dtype, seed=40)
        held = (hold_e2e_dq("full-shape bias bf16", e2e, "full-bias")
                if dtype == "bfloat16" else "")
        log("evoformer", f"full-shape pair bias [4, 8, 1024, 1024] through "
            f"flash_attention {dtype}, causal, D=64: launches {got}; "
            + ", ".join(f"{k} {e:.3g} (lim {lim:.3g})"
                        for k, (e, lim) in errs.items())
            + held + " | end to end (not held) "
            + ", ".join(f"{k} {e:.3g}" for k, e in e2e.items()))
        torch.cuda.empty_cache()
    return rows, launches


# ------------------------------------------------------------------ sparse
# google/bigbird-roberta-base: 12 heads x 64, block_size 64,
# num_random_blocks 3, 4096 positions; an encoder, so non-causal
SPARSE = dict(b=2, s=4096, h=12, d=64, block=64, random=3, window=3,
              global_blocks=1)


def phase_sparse(torch, np):
    """``sparse_attention`` forward + backward at the BigBird shape through
    the kernels (launches counted around it alone), held against the plain
    versions, then timed; returns the launches."""
    import torch.nn.functional as F

    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa
    from deepspeedsyclsupport_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, sparse_attention)

    c = SPARSE
    cfg = BigBirdSparsityConfig(c["h"], c["block"],
                                num_random_blocks=c["random"],
                                num_sliding_window_blocks=c["window"],
                                num_global_blocks=c["global_blocks"])
    gen = torch.Generator(device=DEV).manual_seed(50)
    shape = (c["b"], c["s"], c["h"], c["d"])
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = sparse_attention(*leaves, cfg, causal=False)
    out.backward(do)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    want = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_dbias": 0}
    if launches != want:
        raise AssertionError(f"sparse: launches {launches}, want {want}")

    layout = torch.from_numpy(cfg.make_layout(c["s"], causal=False))
    mask = fa.make_mask(q, k, causal=False, block_layout=layout,
                        block_q=c["block"], block_k=c["block"])
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask)
    delta = fa.attention_delta(do, o_ref)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse_ref, delta, mask)
    _, lse = fa.flash_fwd(q, k, v, mask)
    tol = TOL["bfloat16"]
    errs = {"o": hold("sparse o", out.detach(), o_ref, tol),
            "o_row": hold_rows("sparse o", out.detach(), o_ref, tol),
            "lse": hold("sparse lse", lse, lse_ref, LSE_TOL,
                        relative=False)}
    for name, t, ref in zip(("dq", "dk", "dv"), leaves, refs):
        errs[name] = hold(f"sparse {name}", t.grad, ref, tol)
    errs.update(hold_kernel_rows(fa, "sparse",
                                 (q, k, v, do, lse_ref, delta, mask), refs,
                                 tol))
    e2e = e2e_rows([t.grad for t in leaves], refs)
    del out, leaves, o_ref, refs

    args = (q, k, v, do, lse_ref, delta, mask)
    ms = {"flash_fwd": cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, mask),
                               reps=5),
          "flash_dq": cuda_ms(torch, lambda: fa.flash_dq(*args), reps=3),
          "flash_dkv": cuda_ms(torch, lambda: fa.flash_dkv(*args), reps=3)}
    plain = {
        "flash_fwd": cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q, k, v, mask), reps=1, warmup=1),
        "flash_dq": cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            *args, parts="dq"), reps=1, warmup=1),
        "flash_dkv": cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            *args, parts="dkv"), reps=1, warmup=1)}
    # yardstick: SDPA with the layout expanded to a boolean [1, S, S] mask
    blk = c["block"]
    dense = layout.to(DEV).bool().repeat_interleave(blk, 1).repeat_interleave(
        blk, 2)
    pairs = int(dense.sum()) // dense.shape[0]      # per row and head
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with torch.no_grad():
        sf = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=dense), reps=5)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=dense)
        torch.autograd.grad(o, (qs, ks, vs), do.transpose(1, 2))

    sb = cuda_ms(torch, fwd_bwd, reps=3, warmup=1) - sf
    bounds = bias_bounds("bfloat16", rows=c["b"], h=c["h"], d=c["d"],
                         s=c["s"], pairs=pairs,
                         extra_bytes=4 * layout.numel(), dbias_bytes=0)
    log("sparse", f"BigBird B={c['b']} S={c['s']} H={c['h']} D={c['d']} "
        f"block {blk}, layout {tuple(layout.shape)} with "
        f"{int(layout.sum())} live blocks ({pairs / c['s'] ** 2:.1%} of "
        f"pairs), bf16, non-causal: fwd+bwd through sparse_attention "
        f"{wall_ms:.1f} ms wall, launches {launches}, kernels "
        f"{flash_routes(fa, torch.bfloat16, c['d'])}; "
        + ", ".join(f"{k} {e:.3g} (lim {lim:.3g})"
                    for k, (e, lim) in errs.items())
        + " | end to end (not held) "
        + ", ".join(f"{k} {e:.3g}" for k, e in e2e.items())
        + " | " + " | ".join(
            f"{n[6:]} {ms[n]:.3f} ms (plain {plain[n]:.3f}, bound "
            f"{bounds[n][0]:.4f} {bounds[n][1]})" for n in ms)
        + f" | sdpa with the layout as a boolean mask: fwd {sf:.3f} ms, "
        f"bwd {sb:.3f} ms (fwd+bwd - fwd)")
    del dense, qs, ks, vs
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import numpy as np
    import torch

    if sys.argv[1:] == ["--rehearse"]:
        if not torch.cuda.is_available():
            return 2
        rehearse_child(torch, np)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no result",
              file=sys.stderr)
        return 2
    from deepspeedsyclsupport_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("device", f"{card} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    phase_build(_build)
    phase_rehearse()
    rows = phase_kernels(torch, np)
    flash_rows = phase_flash(torch, np)
    model, params = serve_params(torch)
    launches, serve_outs = phase_serve(torch, np, model, params)
    phase_serve_fused(torch, np, model, params, serve_outs)
    phase_prefix(torch, np, model, params)
    phase_flash_prefill(torch, np, model, params, serve_outs)
    phase_session(torch, np, model, params)
    phase_session_parity(torch, np)
    phase_supervise(torch, np)
    phase_snapshot(torch, np)
    del model, params
    torch.cuda.empty_cache()
    phase_mixtral(torch, np)
    phase_serve_fp16(torch, np)
    launches.update(phase_train(torch, np))
    phase_parity(torch, np)
    phase_train_parity(torch, np)
    evo_rows, evo_launches = phase_evoformer(torch, np)
    phase_sparse(torch, np)

    log("kernels", " | ".join(f"{k}: ported (cuda, {src}), checked"
                              for k, src in TPU_KERNELS)
        + f" | all phases in {time.perf_counter() - t_start:.1f} s")
    entries = []
    for name, key in (("ragged_prefill_attention",
                       ("prefill", "llama2-7b", "bfloat16")),
                      ("paged_decode_attention",
                       ("decode", "decode-llama2-7b", "bfloat16"))):
        r = rows[key]
        entries.append({
            "name": name, "route": "cuda", "kernel": r["route"],
            "source": SOURCE, "replaces": REPLACES,
            "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                               if k[0] == key[0]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # the flash rows: times at the training path's shape (llama2-1b, bf16);
    # max_abs_err over every flash case and dtype of that kernel's outputs
    outputs = {"flash_fwd": ("o", "lse"), "flash_dq": ("dq",),
               "flash_dkv": ("dk", "dv")}
    main_row = flash_rows[("llama2-1b", "bfloat16")]
    for name, outs in outputs.items():
        entries.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["errs"][o][0] for r in flash_rows.values()
                               for o in outs),
            "ms": main_row["ms"][name], "plain_ms": main_row["plain"][name],
            "bound_ms": main_row["bounds"][name][0],
            "bound_by": main_row["bounds"][name][1],
            "library_ms": main_row["library"][name]})
    # the reduced dbias: times at the MSA shape (bf16); launches over the
    # evoformer phase's runs; max_abs_err over its dPair checks
    msa = evo_rows[(EVO_CASES[0]["name"], "bfloat16")]
    entries.append({
        "name": "flash_dbias", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES["flash_dbias"],
        "launches": evo_launches["flash_dbias"],
        "max_abs_err": max(r["errs"]["dpair"][0] for r in evo_rows.values()),
        "ms": msa["ms"]["flash_dbias"],
        "plain_ms": msa["plain"]["flash_dbias"],
        "bound_ms": msa["bounds"]["flash_dbias"][0],
        "bound_by": msa["bounds"]["flash_dbias"][1],
        "library_ms": msa["library"].get("flash_dbias")})
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
