#!/usr/bin/env python3
"""Drive the PyTorch port's serving (dense and MoE, quantized; the SLA
serving session, its supervisor, the engine snapshot and the serving fleet
with cross-replica failover), training (dense and MoE, with checkpoints,
resume, preemption and the training sentinel; ZeRO and tensor parallelism
over torch.distributed, four ranks on the one card), the lse-returning flash
attention, evoformer and block-sparse attention paths on one NVIDIA GPU
and check them.

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
   flash-lse — ``flash_attention(..., return_lse=True)`` forward and
             backward with a random dLSE (ring attention's block combiner)
             at llama2-1b's shape, a ring block whose first 2048 query rows
             and last 2048 keys see nothing, and the MSA pair-bias shape
             (the reducing dbias on delta - dLSE), in bf16, fp16 and
             float32: one launch of each kernel a call, O and LSE against
             the plain forward, the grads end to end by their largest
             magnitude and the backward kernels on the plain forward's
             LSE and delta - dLSE also row by row, exact -1e30 LSE and zero
             O / dQ / dK / dV where nothing is visible, bits repeat.
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
             the card's busy share over that decode window. Probes (read
             only): each admitted request's gate-projected TTFT beside its
             measured one with the worst requests' waterfalls, and for
             every ``put`` the card's span beside the host's.
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
   fleet   — after the parent frees its model: a ``ReplicaPool`` of two
             ``ProcessReplica``s (supervised workers, llama2-7b float32 at
             full depth each, the model's default seed) behind a
             ``FleetRouter``: 6 prompts of 64-256 tokens, 16 greedy
             tokens, clean, then again under new uids with replica 0
             killed once 8 tokens of each of its streams were seen, then
             replica 0 respawned. Held: one close per uid, the claim =
             the dead replica's in-flight uids, outputs equal the clean
             run's, failover replays = streams in flight, the respawned
             replica recovers nothing. Logged: kill to first replayed
             token, time to ready, device memory, the router's stats.
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
   train-resume — the same width and config at 8 of its 16 layers
             (depth cut): 3 steps, a native
             ``save_checkpoint`` (~6.2 GB), steps 4-6; a fresh engine
             (another init, built after the first is deleted)
             loads ``latest`` and takes steps 4-6 on the
             same batches: loss and grad_norm bit-equal, flash launches
             held every step. Then the async engine's ``save`` return
             against its ``wait()``, rotation (``keep_last_n`` 1), and the
             step with the training sentinel armed against unarmed. Tag
             GB, save and load GB/s and the free disk logged; a disk that
             cannot hold the tags fails the phase.
   preempt — ``DSElasticAgent`` runs a child (this script with
             ``--preempt-child``: llama2-1b width, 2 layers) with
             ``DSTPU_FAULT_INJECTION={"preempt_at_step": 3}``: rc 217, one
             free restart that resumes from ``latest``, losses bit-equal to
             an uninterrupted child's; then the newest tag torn, and a
             fresh engine's resume falls back to the older one
             (``corrupt_tags_skipped`` 1).
   sentinel — the training sentinel at llama2-1b width, 2 layers, over a
             ``CheckpointableDataLoader``: a ``nan_step`` discarded on the
             card (params bit-unchanged, journaled as a skip); three
             ``loss_spike`` steps after a promoted tag roll back, and the
             replay is bit-equal to the clean run; step time armed vs
             unarmed.
7. parity  — the serving width cut to 4 layers in float32: the engine
             through the kernel against the engine through the plain path,
             the engine through the flash prefill and the dense
             ``CausalLM.apply`` (plain attention): logits and greedy tokens.
8. trainpar— llama2-1b width cut to 2 layers, float32, TF32 off, B=2,
             S=2048, 3 steps through the kernels, the plain path and the
             kernels with activation checkpointing.
   train-moe— mixtral-8x7b at its published widths cut to 2 layers
             (3.165B params), bf16, ``TRAIN_CONFIG``'s optimizer, B 1 x S
             4096, remat, through the capacity-buffer MoE: ms a step,
             tokens/s, peak memory, loss and moe_aux_loss a step, rows
             dropped at capacity per layer, flash launches held a step;
             then 1 layer in float32, B 1 x S 2048, 3 steps: kernels vs
             plain path (``TRAIN_PARITY_TOL``), remat bit-identical to
             itself.
9. evoformer— ``DS4Sci_EvoformerAttention`` forward + backward at two
             OpenFold shapes (MSA row attention with pair bias, N_seq 512 x
             N_res 384, 8 heads x 32; triangle attention, 384 x 384, 4 heads
             x 32) in bf16, fp16 and float32, random inputs from a seed:
             launch counts zeroed just before each call and read just after
             (one of each flash kernel, the reducing dbias kernel included:
             ``flash_dbias_sm90_kernel`` in bf16 / fp16); O, LSE, dQ, dK, dV
             and dPair held against the plain versions, and in bf16 and
             fp16 the end-to-end dQ rows (``E2E_DQ_ROW_LIMIT``); kernel
             times, bounds, and SDPA with a float mask (mask + pair bias)
             as the yardstick. Then one full-shape pair bias through
             ``flash_attention`` (dbias from the dQ kernel) in bf16, fp16
             and float32, its end-to-end dQ rows held in bf16 and fp16.
10. sparse — ``sparse_attention`` at BigBird-RoBERTa-base widths (12 heads
             x 64, block 64, 3 random + 3 window + 1 global blocks, B=2,
             S=4096, non-causal, bf16): launches around the call, outputs
             against the plain versions, times, bounds and SDPA with the
             expanded layout as a mask.
11. dist    — distributed training (``comm/`` on torch.distributed, the
             named mesh, ZeRO, TP): (a) ``init_distributed`` at a world of
             one (NCCL) and a topology of all ones, llama2-1b at full depth
             in bf16 through the ZeRO-3 config for 3 steps of phase 6's
             batch: losses and grad norms bit-equal to phase 6's first 3,
             flash launches held a step; (b) four ranks of this script
             (``--dist-rank``) on the one card over gloo (NCCL takes one
             rank a card): every façade op held exact on CUDA tensors, then
             the JAX package's dryrun_multichip twins (dp1/fsdp2/tp2 ZeRO-3,
             the same axes at ZeRO-2 in fp16, MiCS shard groups of 2) at
             llama2-1b widths cut to 2 layers, B 4 x S 2048, fp32 with TF32
             off (the fp16 twin fp16), 3 steps, held against world-1 runs
             of the same configs (loss 1e-4, grad_norm 1e-3; fp16: skips
             and scales equal, loss ``DIST_FP16_LOSS_TOL``); per rank and
             step the bytes handed to each collective held equal to the
             plan's count, flash launches held; peak memory beside
             ``predict_memory_per_device``, step times, host-staged ops;
             (c) the pipeline and sequence-parallel twins the same way
             (``DIST_PS_TWINS``, 4 layers); (d) MoE across ranks: the
             train-moe model at a world of one on NCCL through ZeRO-2,
             bit-equal to that phase's steps, then ``DIST_MOE_TWINS``
             (mixtral-8x7b widths: fsdp2 x ep2 and ep2 x tp2 at 1 layer,
             pp2 x ep2 at 2) on four ranks, each against its world-1 run,
             every collective's bytes against ``dist_moe_bytes``; (e)
             ZeRO++ and the optimizers beyond Adam (``dist_zeropp``): each
             new optimizer on the card against the CPU, then on four ranks
             at llama2-1b widths, 2 layers (``DIST_ZPP_TWINS``): hpZ alone
             against plain ZeRO-3 (fp32: gathered leaves EQUAL to the
             plain gather, losses ``DIST_ZPP_TOL``), qwZ + qgZ + hpZ in
             bf16 (gathered leaves and reduced shards EQUAL to their
             world-1 compositions of ``quantize_int8`` /
             ``dequantize_int8``, ZeRO++ bytes EQUAL to
             ``dist_zeropp_bytes``, 3 finite falling losses), 1-bit Adam
             and 1-bit LAMB at ZeRO-2 across the freeze step against their
             world-1 NCCL runs (fp32, ``DIST_ONEBIT_TOL``).
12. kernels — every TPU kernel of the JAX package and its status here.

Then a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure prints its error
and exits non-zero without that last line.
"""
import contextlib
import gc
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
# fp16: twice the JAX package's own fp16 end-to-end dQ row error against
# fp64 at the same cut shapes (tools/flash_e2e_row_error.py --dtype float16,
# CPU): 0.004915 at the full-shape bias, 0.002442 at MSA, 0.001686 at
# triangle.
E2E_DQ_ROW_LIMIT = {
    "bfloat16": {"full-bias": 2 * 0.0389, "msa-row-pair-bias": 2 * 0.0088,
                 "triangle-start": 2 * 0.0088, "llama2-1b": 2 * 0.0038},
    "float16": {"full-bias": 2 * 0.004915,
                "msa-row-pair-bias": 2 * 0.002442,
                "triangle-start": 2 * 0.001686}}
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
            if c["name"] in E2E_DQ_ROW_LIMIT.get(dtype, {}):
                err += hold_e2e_dq(f"flash {c['name']} {dtype}",
                                   dict(r["e2e"]), c["name"], dtype)
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


# --------------------------------------------------------------- flash-lse
LSE_CASES = [
    # llama2-1b's training shape, causal
    dict(name="llama2-1b", b=2, s=4096, h=16, kvh=16, d=128, causal=True),
    # a ring-attention block: queries at positions 4096-8191 against keys at
    # 6144-10239, so query rows 0-2047 see no key and keys 2048-4095 no query
    dict(name="ring-block", b=1, s=4096, h=16, kvh=16, d=128, causal=True,
         q0=4096, k0=6144),
    # MSA row attention's shape with its pair bias (the reducing dbias)
    dict(name="msa-pair-bias", b=512, s=384, h=8, kvh=8, d=32, causal=False,
         pair=True),
]


def lse_inputs(torch, c, dtype, seed):
    """q, k, v, dO, dLSE [B, S, H] float32 and the keyword arguments of
    ``flash_attention`` (positions, pair bias), random from a seed."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    qs = (c["b"], c["s"], c["h"], c["d"])
    ks = (c["b"], c["s"], c["kvh"], c["d"])
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV).to(tdt)
                   for shape in (qs, ks, ks, qs))
    dlse = torch.randn((c["b"], c["s"], c["h"]), generator=gen, device=DEV)
    kw = dict(causal=c["causal"])
    if "q0" in c:
        ar = torch.arange(c["s"], dtype=torch.int32, device=DEV)[None]
        kw["q_positions"] = (ar + c["q0"]).expand(c["b"], -1)
        kw["kv_positions"] = (ar + c["k0"]).expand(c["b"], -1)
    if c.get("pair"):
        kw["bias"] = torch.randn((1, c["h"], c["s"], c["s"]), generator=gen,
                                 device=DEV).to(tdt)
    return q, k, v, do, dlse, kw


def lse_call(torch, fa, q, k, v, do, dlse, kw):
    """The lse variant forward and backward through the autograd Function
    (the kernels on the card): o, lse and the grads of q, k, v (and the
    pair bias) for cotangents dO and dLSE."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kw = dict(kw)
    if "bias" in kw:
        kw["bias"] = kw["bias"].detach().requires_grad_()
        leaves.append(kw["bias"])
    o, lse = fa.flash_attention(*leaves[:3], return_lse=True, **kw)
    grads = torch.autograd.grad((o, lse), leaves, (do, dlse))
    return o.detach(), lse.detach(), grads


def check_lse(torch, c, dtype, seed):
    """One case of the lse variant: end to end through the kernels against
    the plain versions; the backward kernels alone on the plain forward's
    LSE and delta - dLSE, by the largest magnitude and row by row; exact
    -1e30 / 0 where nothing is visible; the same bits on repeat."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    q, k, v, do, dlse, kw = lse_inputs(torch, c, dtype, seed)
    tol = TOL[dtype]
    bias = kw.get("bias")
    b32 = None if bias is None else fa.check_bias(bias, q, k)
    mask = fa.make_mask(q, k, kw["causal"], None, None,
                        kw.get("q_positions"), kw.get("kv_positions"))
    fa.reset_launch_counts()
    o, lse, grads = lse_call(torch, fa, q, k, v, do, dlse, kw)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    want = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
            "flash_dbias": 1 if bias is not None else 0}
    if launches != want:
        raise AssertionError(f"flash-lse {c['name']} {dtype}: launches "
                             f"{launches}, want {want}")
    o2, lse2, grads2 = lse_call(torch, fa, q, k, v, do, dlse, kw)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2))):
        raise AssertionError(f"flash-lse {c['name']} {dtype}: the bits "
                             f"differ on repeat")
    del o2, lse2, grads2
    # the plain versions: forward, then the backward with delta - dLSE
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, mask, b32)
    delta = (fa.attention_delta(do, o_ref)
             - dlse.transpose(1, 2)).contiguous()
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse_ref, delta,
                                            mask, bias=b32)
    if b32 is not None:
        refs = refs + (fa.flash_dbias_reference(q, k, v, do, lse_ref, delta,
                                                mask, b32),)
    name = f"flash-lse {c['name']} {dtype}"
    errs = {"o": hold(f"{name} o", o, o_ref, tol),
            "o_row": hold_rows(f"{name} o", o, o_ref, tol),
            "lse": hold(f"{name} lse", lse, lse_ref.transpose(1, 2), LSE_TOL,
                        relative=False)}
    for n, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
        errs[f"e2e_{n}"] = hold(f"{name} end-to-end {n}", g, r, tol)
    # the backward kernels on the plain forward's LSE and delta - dLSE
    args = (q, k, v, do, lse_ref, delta, mask)
    errs.update(hold_kernel_rows(fa, name, args, refs[:3], tol, bias=b32))
    if b32 is not None:
        errs["dbias"] = hold(f"{name} dbias", fa.flash_dbias(*args, b32),
                             refs[3], tol)
    dead = {}
    if "q0" in c:
        rows = c["k0"] - c["q0"]            # query rows that see no key
        keys = c["k0"] + c["s"] - (c["q0"] + c["s"])  # keys seen by none
        exact = {"lse": bool((lse[:, :rows] == fa.NEG_INF).all()),
                 "o": bool((o[:, :rows] == 0).all()),
                 "dq": bool((grads[0][:, :rows] == 0).all()),
                 "dk": bool((grads[1][:, -keys:] == 0).all()),
                 "dv": bool((grads[2][:, -keys:] == 0).all()),
                 "plain lse": bool((lse_ref[:, :, :rows] == fa.NEG_INF).all())}
        if not all(exact.values()):
            raise AssertionError(f"{name}: rows with nothing visible are not "
                                 f"exact: {exact}")
        dead = {"query rows": rows, "keys": keys}
    del refs, o_ref, lse_ref
    ms = cuda_ms(torch, lambda: lse_call(torch, fa, q, k, v, do, dlse, kw),
                 reps=3, warmup=1)
    return errs, dead, launches, ms


def phase_flash_lse(torch, np):
    """``flash_attention(..., return_lse=True)`` forward and backward with a
    random dLSE (the block combiner of ring attention) at llama2-1b's shape,
    a ring block with fully masked rows and the MSA pair-bias shape, in
    bf16, fp16 and float32 (each dtype's routes); returns the launches."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    total = dict.fromkeys(fa.LAUNCHES, 0)
    for dtype in ("bfloat16", "float16", "float32"):
        for i, c in enumerate(LSE_CASES):
            errs, dead, launches, ms = check_lse(torch, c, dtype, 40 + i)
            for n, x in launches.items():
                total[n] += x
            log("flash-lse", f"{c['name']} {dtype} B={c['b']} S={c['s']} "
                f"H={c['h']} D={c['d']}: "
                + ", ".join(f"{n} {e:.3g} (lim {lim:.3g})"
                            for n, (e, lim) in errs.items())
                + (f" | exact -1e30 LSE, zero O and dQ over {dead['query rows']}"
                   f" query rows, zero dK and dV over {dead['keys']} keys"
                   if dead else "")
                + f" | launches {launches}; bits repeat; fwd+bwd {ms:.3f} ms;"
                f" kernels {flash_routes(fa, getattr(torch, dtype), c['d'])}")
            torch.cuda.empty_cache()
    return total


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


def session_probes(torch, sess, eng):
    """Two read-only probes of a session run (ROADMAP C, the TTFT tail):
    the TTFT the admission gate projected for each request it admitted
    (time since arrival plus ``sla_headroom`` x the prefill ETA it
    computed), and for every ``put`` the host span of the call beside the
    card's span between events recorded around it: the card finishing
    later than the call returns by at least their difference, the clock
    read after ``put`` then comes before the forward's results exist."""
    proj, spans, last = {}, [], {}
    cap = sess.capacity
    eta_fn, gate, put = cap.prefill_eta_s, sess._gate, eng.put

    def eta(tokens, best=False):
        last["eta"] = eta_fn(tokens, best=best)
        return last["eta"]

    def gate_probe(req, now, ahead_tokens=0):
        last.clear()
        verdict = gate(req, now, ahead_tokens)
        if verdict == "admit" and "eta" in last and req.uid not in proj:
            proj[req.uid] = (now - req.arrival_s
                             + sess.policy.sla_headroom * last["eta"])
        return verdict

    def put_probe(*args, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        t = time.perf_counter()
        out = put(*args, **kw)
        spans.append((time.perf_counter() - t, e0, e1))
        e1.record()
        return out

    cap.prefill_eta_s, sess._gate, eng.put = eta, gate_probe, put_probe
    return proj, spans


def log_ttft_tail(np, ttft, proj, spans, traces, verdicts):
    """The TTFT tail beside the gate's projections, the worst requests'
    waterfalls, and where the clock read after ``put`` falls."""
    lag = np.asarray([e0.elapsed_time(e1) / 1e3 - host
                      for host, e0, e1 in spans])
    worst = sorted(ttft, key=lambda u: -ttft[u])[:5]
    miss = [u for u in ttft if ttft[u] > SESSION_TTFT_SLA]

    def one(u):
        p = f"{proj[u] * 1e3:.1f}" if u in proj else "none"
        stages = traces[u]["stages"] if u in traces else {}
        return (f"uid {u} {ttft[u] * 1e3:.1f} vs {p} ({verdicts[u]}) "
                + json.dumps({k: round(v, 4) for k, v in stages.items()}))

    log("session", f"TTFT tail: {len(miss)} of {len(ttft)} over the "
        f"{SESSION_TTFT_SLA} s SLA, {sum(u in proj for u in miss)} of them "
        f"admitted on the gate's projection (sla_headroom x prefill ETA); "
        f"worst 5 (measured vs projected ms, submit verdict, waterfall "
        f"stages in s): " + "; ".join(one(u) for u in worst)
        + f" | {len(spans)} put calls: the card's span minus the host's "
        f"(the least time the results land after the clock read) > 0 in "
        f"{int((lag > 0).sum())}, p50 {np.percentile(lag, 50) * 1e3:.2f} "
        f"ms, p99 {np.percentile(lag, 99) * 1e3:.2f} ms, max "
        f"{lag.max() * 1e3:.2f} ms")


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
    proj, spans = session_probes(torch, sess, eng)
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
    log_ttft_tail(np, ttft, proj, spans, traces, verdicts)
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


# ------------------------------------------------------------------- fleet
FLEET_PROMPTS = 6
FLEET_NEW = 16
FLEET_KILL_TOKENS = 8        # tokens seen from each of replica 0's streams
FLEET_ENGINE = {"dtype": "float32", "block_size": 64, "max_context": 2048,
                "max_sequences": 16, "num_blocks": 32}
FLEET_TIMEOUT_S = 300


def gpu_process_mib():
    """``(pid, MiB)`` of device memory in use for each process nvidia-smi
    lists (in a container it may list fewer processes than run)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return [tuple(x.strip() for x in line.split(","))
            for line in out.strip().splitlines() if line]


def live_cuda_tensors(torch, n=8):
    """``(MiB, shape, dtype, referrer types)`` of the ``n`` largest CUDA
    tensors the collector can see: what a phase left behind."""
    found = []
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            found.append((obj.untyped_storage().nbytes(), obj))
    found.sort(key=lambda x: -x[0])
    return [(round(nb / 2**20), tuple(t.shape), str(t.dtype),
             sorted({type(r).__name__ for r in gc.get_referrers(t)}))
            for nb, t in found[:n]]


def phase_fleet(torch, np):
    """A ``ReplicaPool`` of two ``ProcessReplica``s (supervised workers, each
    serving llama2-7b at full width and depth in float32 from the model's
    default seed) behind a ``FleetRouter`` on the one card: the supervise
    phase's kind of prompts, 16 greedy tokens, first clean, then the same
    prompts under new uids with replica 0 killed (SIGKILL to its process
    group) once the router has seen 8 tokens of each of its streams; then
    replica 0 respawned. Holds: every uid closes once (router events and
    journals); the claim covers exactly the dead replica's in-flight uids;
    the killed run's outputs (the fleet-wide journal merge) equal the clean
    run's prompt for prompt; the survivor's failover replays equal the
    streams in flight; the respawned replica recovers none of the claimed
    streams. The heartbeat timeout is sized from a build of the worker's
    engine timed here. Logs the time from the kill to the first replayed
    token, each replica's time to ready, device memory per process and the
    router's ``stats()``."""
    import shutil
    import tempfile
    from collections import Counter

    from deepspeedsyclsupport_tpu_torch import InferenceEngineV2, build_model
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        load_journal, reconstruct_outputs)
    from deepspeedsyclsupport_tpu_torch.inference.v2.fleet import (
        FleetConfig, FleetRequest, FleetRouter, ProcessReplica, ReplicaPool,
        read_claims)
    from deepspeedsyclsupport_tpu_torch.models import get_config

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > 2**30:
        raise AssertionError(f"fleet: the parent holds {held / 2**30:.2f} GiB"
                             f" on the card; two fp32 replicas need it free;"
                             f" the largest live tensors "
                             f"{live_cuda_tensors(torch)}")
    t0 = time.perf_counter()
    model = build_model(SERVE_MODEL, dtype="float32")
    eng = InferenceEngineV2(model, model.init_params(device=DEV),
                            config=dict(FLEET_ENGINE), device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del eng, model
    torch.cuda.empty_cache()
    # the reference's 30 s covers the worker's start-up (import, CUDA
    # init); the build is added four times over (two share the card)
    hb_timeout = math.ceil(30 + 4 * build_s)
    rng = np.random.RandomState(5)
    vocab = get_config(SERVE_MODEL).vocab_size
    prompts = [rng.randint(1, vocab, n).tolist()
               for n in rng.randint(64, 257, FLEET_PROMPTS)]
    root = tempfile.mkdtemp(prefix="dstpu_fleet_")
    worker = {"model": SERVE_MODEL, "dtype": "float32", "device": DEV,
              "engine": dict(FLEET_ENGINE)}
    reps = [ProcessReplica(str(i), os.path.join(root, f"replica{i}"),
                           dict(worker), supervisor_args=[
                               "--heartbeat-timeout", str(hb_timeout)])
            for i in range(2)]
    pool = ReplicaPool(reps)
    router = FleetRouter(reps, FleetConfig(
        affinity="none", log_path=os.path.join(root, "router.jsonl")))
    mem = {}

    def sample_mem(when):
        free, total = torch.cuda.mem_get_info()
        mem[when] = (gpu_process_mib(), round((total - free) / 2**20))

    def wait_ready(which, t_start):
        """Seconds from ``t_start`` until each replica probes ready with a
        probe written after the call (a dead generation's probe may still
        be fresh)."""
        wall = time.time()
        ready = {}
        deadline = time.monotonic() + hb_timeout + FLEET_TIMEOUT_S
        while len(ready) < len(which):
            for r in which:
                if r.replica_id not in ready and r.ready() and \
                        r.health()["t"] > wall:
                    ready[r.replica_id] = round(time.perf_counter() - t_start,
                                                2)
                if r.proc.poll() is not None:
                    raise AssertionError(f"fleet: replica {r.replica_id}'s "
                                         f"supervisor exited rc "
                                         f"{r.proc.poll()} before ready")
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: replicas not ready: {ready}")
            time.sleep(0.1)
        return ready

    def drive(base, kill=False):
        uids = [base + i for i in range(FLEET_PROMPTS)]
        for u, p in zip(uids, prompts):
            outcome, _rid = router.submit(FleetRequest(
                uid=u, tokens=p, max_new_tokens=FLEET_NEW))
            if outcome != "routed":
                raise AssertionError(f"fleet: uid {u} {outcome} at the edge")
        seen, closes = Counter(), Counter()
        victims, t_kill, first_replay = None, None, None
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while not router.idle:
            for ev in router.poll():
                if ev.kind == "token":
                    seen[ev.uid] += len(ev.tokens)
                    if victims and first_replay is None and \
                            ev.uid in victims and ev.replica_id == "1":
                        first_replay = time.perf_counter() - t_kill
                else:
                    closes[ev.uid] += 1
            if kill and victims is None:
                mine = [u for u, f in router.flights.items()
                        if f.replica_id == "0"]
                if mine and all(seen[u] >= FLEET_KILL_TOKENS for u in mine):
                    sample_mem("at the kill")
                    victims = sorted(mine)
                    reps[0].kill()
                    t_kill = time.perf_counter()
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: {len(router.flights)} streams "
                                     f"still in flight")
            time.sleep(0.01)
        if any(closes[u] != 1 for u in uids):
            raise AssertionError(f"fleet: closes per uid {dict(closes)}")
        return uids, victims, first_replay

    try:
        t_start = time.perf_counter()
        pool.start()
        ready = wait_ready(reps, t_start)
        sample_mem("ready")
        t = time.perf_counter()
        clean, _, _ = drive(0)
        clean_s = time.perf_counter() - t
        sample_mem("after the clean run")
        killed, victims, first_replay = drive(100, kill=True)
        if not victims:
            raise AssertionError("fleet: replica 0 held no stream to kill")
        stats = router.stats()
        claim = read_claims(reps[0].journal_dir)
        dead_states, _ = load_journal(reps[0].journal_dir)
        in_flight = sorted(u for u, st in dead_states.items() if st.in_flight)
        if sorted(int(u) for u in claim.uids) != victims or \
                in_flight != victims:
            raise AssertionError(f"fleet: claim {sorted(claim.uids)}, dead "
                                 f"replica in flight {in_flight}, router's "
                                 f"victims {victims}")
        if stats["failover_replays"] != len(victims) or \
                stats["per_replica"]["1"]["failover_in"] != len(victims):
            raise AssertionError(f"fleet: failover replays {stats}, want "
                                 f"{len(victims)}")
        states, _ = load_journal([r.journal_dir for r in reps])
        outs = reconstruct_outputs(states)
        closes = Counter()
        for r in reps:
            for name in os.listdir(r.journal_dir):
                if name.startswith("journal_rank"):
                    with open(os.path.join(r.journal_dir, name)) as f:
                        for line in f:
                            if '"serve/close"' in line:
                                closes[json.loads(line)["data"]["uid"]] += 1
        if any(closes[u] != 1 for u in clean + killed):
            raise AssertionError(f"fleet: journal closes {dict(closes)}")
        diff = [i for i in range(FLEET_PROMPTS)
                if outs[killed[i]] != outs[clean[i]]]
        if diff or any(len(outs[u]) != FLEET_NEW for u in clean):
            raise AssertionError(f"fleet: outputs after the kill differ from "
                                 f"the clean run's for prompts {diff}")
        t = time.perf_counter()
        pool.respawn("0")
        respawn = wait_ready([reps[0]], t)
        router.close()
        rcs = pool.stop(timeout=120.0)
        with open(reps[0].spec["out"]) as f:
            recovery = json.load(f)["recovery"]
        if recovery["replayed"] or set(recovery["skipped_closed"]) \
                & set(victims):
            raise AssertionError(f"fleet: the respawned replica recovered "
                                 f"{recovery}")
        if any(rc != 0 for rc in rcs.values()):
            raise AssertionError(f"fleet: supervisors exited {rcs}")
    finally:
        router.close()
        pool.stop(timeout=60.0)
    shutil.rmtree(root, ignore_errors=True)
    log("fleet", f"{SERVE_MODEL} fp32 full depth, 2 supervised replicas on "
        f"one card ({FLEET_ENGINE['num_blocks']} KV blocks each): engine "
        f"built in {build_s:.1f} s here, heartbeat timeout {hb_timeout} s; "
        f"time to ready per replica {ready} s; {FLEET_PROMPTS} prompts "
        f"{[len(p) for p in prompts]}, {FLEET_NEW} greedy tokens: clean in "
        f"{clean_s:.1f} s; killed replica 0 with {len(victims)} streams in "
        f"flight {victims}: first replayed token on replica 1 "
        f"{first_replay:.3f} s after the kill; outputs equal the clean run's;"
        f" every uid closed once; claim = in flight; respawned replica 0 "
        f"ready in {respawn['0']} s, recovered {recovery['replayed']}; "
        f"supervisor rcs {rcs}; device memory (nvidia-smi (pid, MiB) per "
        f"process; MiB in use on the card) {mem}; router stats {stats}")


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
    return launches, steps


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


# ---------------------------------------------------------------- train-moe
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 4
MOE_TRAIN_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=1,
                        gradient_accumulation_steps=1,
                        activation_checkpointing={})
# fp32 master, fp32 grad and Adam's two fp32 moments
STATE_BYTES_PER_PARAM = 16


def moe_dropped(moe):
    """Wrap ``moe._capacity_route`` to collect each call's count of (token,
    choice) rows dropped at capacity, as a device tensor (read after the
    step). Returns the list and the restore function."""
    calls, route = [], moe._capacity_route

    def counting(*a, **kw):
        out = route(*a, **kw)
        calls.append((~out[2]).sum())
        return out

    moe._capacity_route = counting

    def restore():
        moe._capacity_route = route
    return calls, restore


def phase_train_moe(torch, np):
    """``mixtral-8x7b`` at its published widths cut to 2 layers, through
    ``initialize`` -> ``train_batch`` (bf16, ``TRAIN_CONFIG``'s AdamW,
    WarmupLR and clipping, remat, B 1 x S 4096): the capacity-buffer MoE in
    every layer, attention through the flash kernels (launches held a
    step). Then the same widths at 1 layer in float32, B 1 x S 2048, 3
    steps: kernels against the plain path (``TRAIN_PARITY_TOL``) and the
    kernels with remat bit-identical to themselves. Returns the launches
    and the steps' ``(loss, moe_aux_loss, grad_norm, seconds)``."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa
    from deepspeedsyclsupport_tpu_torch.parallel import moe

    model = build_model(MOE_MODEL, num_layers=MOE_TRAIN_LAYERS)
    cfg = model.config
    free, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    n_params = sum(t.numel() for t in _tensors(params))
    need = n_params * STATE_BYTES_PER_PARAM
    log("train-moe", f"{MOE_MODEL} widths, {cfg.num_layers} layers: hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} q / {cfg.num_kv_heads} KV heads "
        f"x {cfg.head_dim}, {cfg.num_experts} experts x FFN "
        f"{cfg.intermediate_size}, top-{cfg.num_experts_per_tok}, capacity "
        f"factor {cfg.capacity_factor}: {n_params / 1e9:.3f}B params, state "
        f"{need / 2**30:.2f} GiB at {STATE_BYTES_PER_PARAM} B a param "
        f"(card {free / 2**30:.2f} of {total / 2**30:.2f} GiB free)")
    # [0]: the rest of the tuple holds the optimizer and its state
    eng = initialize(model=model, params=params, config=MOE_TRAIN_CONFIG,
                     device=DEV)[0]
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_tok = eng.train_batch_size() * TRAIN_SEQ
    cap = moe.capacity(n_tok, cfg)
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                           (eng.train_batch_size(), TRAIN_SEQ))
    batch = {"input_ids": torch.from_numpy(ids).to(DEV)}
    want = flash_per_step(eng)
    calls, restore = moe_dropped(moe)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    steps = []
    try:
        for step in range(MOE_TRAIN_STEPS):
            del calls[:]
            before = dict(fa.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = eng.train_batch(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            got = {k: fa.LAUNCHES[k] - before[k] for k in before}
            # the forward's routing: the first call of each layer (remat
            # routes each layer again in the backward)
            dropped = [int(x) for x in calls[:cfg.num_layers]]
            rec = (float(m["loss"]), float(m["moe_aux_loss"]),
                   float(m["grad_norm"]), dt)
            steps.append(rec)
            log("train-moe", f"step {step + 1}{' (warm-up)' if step == 0 else ''}"
                f": {dt * 1e3:.1f} ms, {n_tok / dt:.0f} tokens/s, loss "
                f"{rec[0]:.4f}, moe_aux_loss {rec[1]:.4f}, grad_norm "
                f"{rec[2]:.4f}, dropped (token, choice) rows per layer "
                f"{dropped} of {n_tok * cfg.num_experts_per_tok} (capacity "
                f"{cap} a expert), flash launches {got}")
            if got != want:
                raise AssertionError(f"train-moe step {step + 1}: flash "
                                     f"launches {got}, want {want}")
            if not all(math.isfinite(x) for x in rec[:3]):
                raise AssertionError(f"train-moe step {step + 1}: {rec}")
    finally:
        restore()
    launches = dict(fa.LAUNCHES)
    timed = [x[3] for x in steps[1:]]
    log("train-moe", f"{len(timed)} timed steps: mean "
        f"{1e3 * sum(timed) / len(timed):.1f} ms/step, "
        f"{n_tok * len(timed) / sum(timed):.0f} tokens/s, loss "
        f"{steps[0][0]:.4f} -> {steps[-1][0]:.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; built in "
        f"{build_s:.1f} s; flash launches over {MOE_TRAIN_STEPS} steps "
        f"{launches}")
    if steps[-1][0] >= steps[0][0]:
        raise AssertionError(f"train-moe losses {[x[0] for x in steps]}: "
                             f"not falling")
    del eng
    torch.cuda.empty_cache()
    train_moe_parity(torch, np)
    return launches, steps


def train_moe_parity(torch, np):
    """``MOE_MODEL`` widths at 1 layer, float32 (TF32 off), B 1 x S 2048, 3
    steps: the kernels against the plain path, and the kernels with remat
    against themselves (bit-identical)."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize

    cfg = {"train_micro_batch_size_per_gpu": 1,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-4,
                                                     "weight_decay": 0.1}},
           "gradient_clipping": 1.0}
    vocab = build_model(MOE_MODEL).config.vocab_size
    ids = np.random.RandomState(4).randint(0, vocab, (1, 2048))
    batch = {"input_ids": torch.from_numpy(ids).to(DEV)}
    runs = {}
    for name, impl, extra in (("kernel", "flash", {}), ("xla", "xla", {}),
                              ("remat", "flash",
                               {"activation_checkpointing": {}}),
                              ("remat again", "flash",
                               {"activation_checkpointing": {}})):
        model = build_model(MOE_MODEL, num_layers=1, dtype="float32",
                            attn_impl=impl)
        params = model.init_params(
            generator=torch.Generator(device=DEV).manual_seed(1), device=DEV)
        eng = initialize(model=model, params=params,
                         config=dict(cfg, **extra), device=DEV)[0]
        del params
        runs[name] = [(float(m["loss"]), float(m["moe_aux_loss"]),
                       float(m["grad_norm"]))
                      for m in (eng.train_batch(batch) for _ in range(3))]
        del eng
        torch.cuda.empty_cache()
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for (kl, _ka, kg), (xl, _xa, xg) in zip(runs["kernel"], runs["xla"]):
        worst["loss"] = max(worst["loss"], abs(kl - xl) / abs(xl))
        worst["grad_norm"] = max(worst["grad_norm"], abs(kg - xg) / abs(xg))
    if any(worst[k] > TRAIN_PARITY_TOL[k] for k in worst):
        raise AssertionError(f"train-moe parity kernel vs xla {runs}: "
                             f"relative {worst} > {TRAIN_PARITY_TOL}")
    if runs["remat again"] != runs["remat"]:
        raise AssertionError(f"train-moe with remat is not bit-identical to "
                             f"itself: {runs['remat']} vs "
                             f"{runs['remat again']}")
    log("train-moe", f"parity: {MOE_MODEL} widths, 1 layer, fp32 (TF32 off), "
        f"B=1 S=2048, 3 steps: (loss, moe_aux_loss, grad_norm) kernel "
        f"{runs['kernel']}, xla {runs['xla']}; worst relative diff {worst} "
        f"(tol {TRAIN_PARITY_TOL}); remat {runs['remat']}, bit-identical on "
        f"a second run; remat vs no remat "
        f"{'identical' if runs['remat'] == runs['kernel'] else 'differs'}")


# ------------------------------------------------------------- resilience
RESUME_STEPS = 3            # steps before the save, and again after it
# train-resume's depth: half of llama2-1b's 16 layers (a 6.2 GB tag instead
# of 11.3 GB) keeps chip_smoke near half its time limit beside phase dist
# (d); every hold of the phase stands at any depth
RESUME_LAYERS = 8
TAG_BYTES_PER_PARAM = 12    # fp32 master + Adam's two fp32 moments
SENTINEL_SEQ = 2048
SENTINEL_CFG = {"enabled": True, "warmup_steps": 3, "window": 8,
                "skip_limit": 3, "rollback_limit": 2, "last_good_k": 1,
                "lag": 1, "z_warn": 20.0, "z_skip": 50.0}
PREEMPT_STEPS = 5
PREEMPT_AT = 3
PREEMPT_TIMEOUT_S = 300


def train_engine(torch, seed, extra=None, num_layers=None, loss_fn=None):
    """``TRAIN_MODEL`` (cut to ``num_layers`` when given) from a seeded
    init through ``initialize`` with ``TRAIN_CONFIG`` plus ``extra``."""
    from deepspeedsyclsupport_tpu_torch import build_model, initialize

    model = build_model(TRAIN_MODEL, **(
        {"num_layers": num_layers} if num_layers else {}))
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(seed), device=DEV)
    eng = initialize(model=model, params=params, config=dict(
        TRAIN_CONFIG, **(extra or {})), device=DEV,
        loss_fn=loss_fn(model) if loss_fn else None)[0]
    del params
    torch.cuda.empty_cache()
    return eng


def train_batches(np, vocab, n, seed, seq=TRAIN_SEQ, weight=False):
    """``n`` batches of ``TRAIN_CONFIG``'s 4 sequences from ``seed``; with
    ``weight``, a float ``weight`` per sequence (ones) that
    ``weighted_loss`` multiplies in, so an injected numerical fault (which
    poisons floating leaves only) reaches the loss."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"input_ids": rng.randint(0, vocab, (4, seq)).astype(np.int64)}
        if weight:
            b["weight"] = np.ones((4,), np.float32)
        out.append(b)
    return out


def weighted_loss(model):
    def loss(params, batch, rng=None, train=True):
        lm, metrics = model.loss(params, {"input_ids": batch["input_ids"]},
                                 rng, train=train)
        return lm * batch["weight"].mean(), metrics
    return loss


def train_steps(torch, eng, batches, want=None):
    """(loss, grad_norm, seconds) of one ``train_batch`` per batch, each
    timed between syncs; with ``want``, the flash launches of every step
    are held to it."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    out = []
    for b in batches:
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = eng.train_batch(b)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out.append((loss, gn, time.perf_counter() - t))
        got = {k: fa.LAUNCHES[k] - before[k] for k in before}
        if want is not None and got != want:
            raise AssertionError(f"step {eng.global_steps}: flash launches "
                                 f"{got}, want {want}")
    return out


def flash_per_step(eng):
    per_step = eng.module.config.num_layers * \
        eng.gradient_accumulation_steps()
    return {"flash_fwd": per_step * (2 if eng.module.config.remat else 1),
            "flash_dq": per_step, "flash_dkv": per_step, "flash_dbias": 0}


def ckpt_dir(need_bytes):
    """A fresh directory where ``need_bytes`` fit: under the temporary
    directory, else under the checkout's build directory. Raises when
    neither can hold them (never skips). Returns (path, free bytes)."""
    import shutil
    import tempfile

    roots = [tempfile.gettempdir(),
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "torch_kernels")]
    seen = []
    for root in roots:
        os.makedirs(root, exist_ok=True)
        free = shutil.disk_usage(root).free
        seen.append(f"{root}: {free / 1e9:.1f} GB free")
        if free >= need_bytes:
            return tempfile.mkdtemp(prefix="dstpu_ckpt_", dir=root), free
    raise AssertionError(f"no disk holds {need_bytes / 1e9:.1f} GB of "
                         f"checkpoints ({'; '.join(seen)})")


def phase_train_resume(torch, np):
    """llama2-1b at full width, ``RESUME_LAYERS`` deep, bf16,
    ``TRAIN_CONFIG``: 3 steps,
    a native ``save_checkpoint``, steps 4-6; a fresh engine (built after
    the first is deleted, from another init) loads ``latest``
    and takes steps 4-6 on the same batches: loss and grad_norm
    bit-equal, flash launches held every step. Then the async engine's
    ``save`` return against its ``wait()``, and the step time with the
    training sentinel armed against unarmed (alternating). GB a tag, save
    and load GB/s and the free disk are logged."""
    import shutil

    from deepspeedsyclsupport_tpu_torch.checkpoint.engine import (
        DATA_FILE, INDEX_FILE, list_tags)

    vocab = None
    a = train_engine(torch, 0, {"checkpoint": {"keep_last_n": 1}},
                     num_layers=RESUME_LAYERS)
    vocab = a.module.config.vocab_size
    n_params = sum(t.numel() for t in a._leaf_tensors)
    # the async save writes the new tag before rotation drops the old one
    root, free = ckpt_dir(2 * TAG_BYTES_PER_PARAM * n_params)
    journal = os.path.join(root, "journal")
    want = flash_per_step(a)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in b.items()}
               for b in train_batches(np, vocab, 2 * RESUME_STEPS, seed=3)]
    try:
        train_steps(torch, a, batches[:RESUME_STEPS], want)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = a.save_checkpoint(root)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in (DATA_FILE, INDEX_FILE))
        ref = train_steps(torch, a, batches[RESUME_STEPS:], want)
        del a
        torch.cuda.empty_cache()
        b = train_engine(torch, 1, {
            "checkpoint": {"engine": "async", "keep_last_n": 1},
            "sentinel": {"enabled": True, "journal_dir": journal}},
            num_layers=RESUME_LAYERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, _ = b.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not loaded.endswith(f"global_step{RESUME_STEPS}") or \
                b.global_steps != RESUME_STEPS:
            raise AssertionError(f"train-resume: loaded {loaded} at step "
                                 f"{b.global_steps}")
        got = train_steps(torch, b, batches[RESUME_STEPS:], want)
        if [x[:2] for x in got] != [x[:2] for x in ref]:
            raise AssertionError(f"train-resume: resumed (loss, grad_norm) "
                                 f"{[x[:2] for x in got]} != uninterrupted "
                                 f"{[x[:2] for x in ref]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.save_checkpoint(root)
        ret_s = time.perf_counter() - t0
        b.checkpoint_engine.wait()
        wait_s = time.perf_counter() - t0
        tags = list_tags(root)
        if tags != [f"global_step{2 * RESUME_STEPS}"]:
            raise AssertionError(f"train-resume: tags after the async save "
                                 f"and rotation (keep_last_n 1): {tags}")
        # armed vs unarmed, alternating on one engine (nothing is gated:
        # the loss cap is +inf before the sentinel's 20-step warm-up); each
        # window of 3 steps runs without a sync between them, as training
        # does, so the armed gate's host read shows its real cost
        sentinel, times = b._sentinel, {"armed": [], "unarmed": []}
        for arm in ("armed", "unarmed") * 4:
            b._sentinel = sentinel if arm == "armed" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in batches[:RESUME_STEPS]:
                b.train_batch(x)
            torch.cuda.synchronize()
            times[arm].append((time.perf_counter() - t0) / RESUME_STEPS)
        b._sentinel = sentinel
        del b
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the median window: one window in several can stall on the host
    armed, unarmed = (float(np.median(times[k])) for k in ("armed",
                                                            "unarmed"))
    gb = nbytes / 1e9
    log("train-resume", f"{TRAIN_MODEL} full width, {RESUME_LAYERS} "
        f"layers (depth cut), bf16, "
        f"{n_params / 1e9:.3f}B params: a tag is {gb:.2f} GB (fp32 params "
        f"and moments, layers stacked); {free / 1e9:.0f} GB free under "
        f"{os.path.dirname(root)}; native save {save_s:.2f} s "
        f"({gb / save_s:.2f} GB/s, crc32 kept while writing, fsynced), load "
        f"onto the card by a fresh engine {load_s:.2f} s "
        f"({gb / load_s:.2f} GB/s, read just after the write: the page "
        f"cache may serve it); steps {RESUME_STEPS + 1}-{2 * RESUME_STEPS} "
        f"resumed (loss, grad_norm) {[x[:2] for x in got]} bit-equal to the "
        f"uninterrupted run's; flash launches {want} every step; async "
        f"engine: save returned in {ret_s * 1e3:.0f} ms (device -> pinned "
        f"host copy, synchronized), durable after {wait_s:.2f} s, "
        f"rotation kept {tags}; step with the sentinel armed (median "
        f"window) {armed * 1e3:.1f} ms vs unarmed {unarmed * 1e3:.1f} ms "
        f"({100 * (armed - unarmed) / unarmed:+.2f} %; windows of "
        f"{RESUME_STEPS} steps without a sync between them, alternating, "
        f"{len(times['armed'])} each: armed "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times['armed'])}, unarmed "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times['unarmed'])} ms)")


def preempt_child(torch, np, ckpt, log_path):
    """The ``preempt`` phase's worker (``--preempt-child``): llama2-1b
    width cut to 2 layers, preemption handling armed; resumes from
    ``ckpt`` when a tag is there, trains to ``PREEMPT_STEPS`` steps (one
    line of step, loss and grad_norm in hex each) and saves."""
    from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
        configure_fault_injection)

    eng = train_engine(torch, 0, num_layers=2)
    eng.enable_preemption_handling(ckpt)
    if eng.load_checkpoint(ckpt)[0] is not None:
        # the preemption is one event of the run: the injection spec is
        # re-read by every incarnation
        configure_fault_injection({})
    vocab = eng.module.config.vocab_size
    batches = train_batches(np, vocab, PREEMPT_STEPS, seed=4,
                            seq=SENTINEL_SEQ)
    for b in batches[eng.global_steps:]:
        m = eng.train_batch(b)
        with open(log_path, "a") as f:
            f.write(json.dumps([eng.global_steps, float(m["loss"]).hex(),
                                float(m["grad_norm"]).hex()]) + "\n")
    eng.save_checkpoint(ckpt)


def phase_preempt(torch, np):
    """``DSElasticAgent`` runs ``preempt_child`` with
    ``DSTPU_FAULT_INJECTION={"preempt_at_step": 3}``: rc 217 (an emergency
    save at step 3), one free restart that resumes from ``latest`` and
    finishes; its losses bit-equal to an uninterrupted child's (run beside
    it). Then the newest tag is torn: a fresh engine's resume falls back to
    the older one and ``corrupt_tags_skipped`` counts it."""
    import functools
    import shutil

    from deepspeedsyclsupport_tpu_torch.checkpoint.engine import DATA_FILE
    from deepspeedsyclsupport_tpu_torch.elasticity import DSElasticAgent
    from deepspeedsyclsupport_tpu_torch.monitor.monitor import (
        resilience_counters)

    root, _free = ckpt_dir(10 * 2 ** 30)
    dirs = {k: os.path.join(root, k) for k in ("agent", "ref")}
    logs = {k: os.path.join(root, f"{k}.jsonl") for k in dirs}
    env = {k: v for k, v in os.environ.items()
           if k != "DSTPU_FAULT_INJECTION"}
    t0 = time.perf_counter()
    ref = None
    try:
        ref = subprocess.Popen([sys.executable, __file__, "--preempt-child",
                                dirs["ref"], logs["ref"]], env=env)
        agent = DSElasticAgent(
            [sys.executable, __file__, "--preempt-child", dirs["agent"],
             logs["agent"]], {"elasticity": {"enabled": False}},
            restart_limit=0, env={"WORLD_SIZE": "1", "DSTPU_FAULT_INJECTION":
                                  json.dumps({"preempt_at_step":
                                              PREEMPT_AT})})
        run = subprocess.run
        subprocess.run = functools.partial(run, timeout=PREEMPT_TIMEOUT_S)
        try:
            rc = agent.run()
        finally:
            subprocess.run = run
        ref_rc = ref.wait(timeout=PREEMPT_TIMEOUT_S)
        wall = time.perf_counter() - t0
        rcs = [h["rc"] for h in agent.launch_history]
        if rc != 0 or ref_rc != 0 or rcs != [217, 0] or \
                agent.preemption_count != 1 or agent.restart_count != 0:
            raise AssertionError(f"preempt: agent rc {rc}, launches {rcs}, "
                                 f"preemptions {agent.preemption_count}, "
                                 f"failures {agent.restart_count}; "
                                 f"uninterrupted child rc {ref_rc}")
        lines = {k: [json.loads(x) for x in open(p).read().splitlines()]
                 for k, p in logs.items()}
        want = [x for x in lines["ref"] if x[0] != PREEMPT_AT]
        if lines["agent"] != want:
            raise AssertionError(f"preempt: resumed steps {lines['agent']} "
                                 f"!= the uninterrupted child's {want}")
        # tear the newest tag: the resume falls back past it
        newest = os.path.join(dirs["agent"], f"global_step{PREEMPT_STEPS}")
        with open(os.path.join(newest, DATA_FILE), "rb+") as f:
            f.truncate(1024)
        resilience_counters.reset()
        eng = train_engine(torch, 9, num_layers=2)
        path, _ = eng.load_checkpoint(dirs["agent"])
        skipped = resilience_counters.get("corrupt_tags_skipped")
        if not path.endswith(f"global_step{PREEMPT_AT}") or skipped != 1:
            raise AssertionError(f"preempt: fallback resumed {path}, "
                                 f"corrupt_tags_skipped {skipped}")
        b = train_batches(np, eng.module.config.vocab_size, PREEMPT_STEPS,
                          seed=4, seq=SENTINEL_SEQ)[PREEMPT_AT]
        step4 = float(eng.train_batch(b)["loss"]).hex()
        del eng
        torch.cuda.empty_cache()
    finally:
        if ref is not None and ref.poll() is None:
            ref.kill()
            ref.wait()
        shutil.rmtree(root, ignore_errors=True)
    log("preempt", f"{TRAIN_MODEL} width, 2 layers, bf16, S={SENTINEL_SEQ}: "
        f"DSElasticAgent, preempt_at_step {PREEMPT_AT}: launches rc {rcs} "
        f"(one free restart, resumed from latest = global_step{PREEMPT_AT}),"
        f" steps {[x[0] for x in lines['agent']]} (loss, grad_norm) "
        f"bit-equal to an uninterrupted child's; {wall:.1f} s for both "
        f"children; newest tag torn -> a fresh engine resumed "
        f"{os.path.basename(path)}, corrupt_tags_skipped {skipped}; its next"
        f" loss in this process {step4} vs the children's "
        f"{lines['ref'][PREEMPT_AT][1]} (logged)")


def phase_sentinel(torch, np):
    """The training sentinel at llama2-1b width, 2 layers, over a
    ``CheckpointableDataLoader``: a ``nan_step`` batch discarded on the
    card (params bit-unchanged, journaled as a skip); three ``loss_spike``
    steps after a promoted tag roll back, and the replay is bit-equal to
    the run that never saw the bad batches; the step time armed vs
    unarmed."""
    import shutil
    import tempfile

    from deepspeedsyclsupport_tpu_torch.checkpoint.engine import (
        read_last_good)
    from deepspeedsyclsupport_tpu_torch.monitor.monitor import (
        resilience_counters)
    from deepspeedsyclsupport_tpu_torch.runtime.dataloader import (
        CheckpointableDataLoader)
    from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
        configure_fault_injection)

    root = tempfile.mkdtemp(prefix="dstpu_sentinel_")

    def engine(name, armed=True):
        extra = {"sentinel": dict(SENTINEL_CFG, journal_dir=os.path.join(
            root, name))} if armed else {}
        return train_engine(torch, 5, extra, num_layers=2,
                            loss_fn=weighted_loss)

    def journal(name):
        with open(os.path.join(root, name,
                               "health_journal_rank0.jsonl")) as f:
            return [json.loads(x) for x in f.read().splitlines()]

    def drive(eng, data, steps, save_at=None):
        loader = eng.register_dataloader(CheckpointableDataLoader(data, DEV))
        it, losses, times = iter(loader), {}, []
        while eng.global_steps < steps:
            before = eng.global_steps
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = eng.train_batch(next(it))
            if out is not None and eng.global_steps == before + 1:
                losses[eng.global_steps] = float(out["loss"]).hex()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            if save_at is not None and eng.global_steps == save_at:
                eng.save_checkpoint(os.path.join(root, "ckpt"))
                save_at = None
        return losses, times

    try:
        vocab = None
        configure_fault_injection({"nan_step": {"rank": 0, "step": 2}})
        eng = engine("nan")
        vocab = eng.module.config.vocab_size
        data = train_batches(np, vocab, 12, seed=6, seq=SENTINEL_SEQ,
                             weight=True)
        loader = iter(eng.register_dataloader(
            CheckpointableDataLoader(data, DEV)))
        eng.train_batch(next(loader))
        before = [t.detach().clone() for t in eng._leaf_tensors]
        m = eng.train_batch(next(loader))
        same = all(torch.equal(a, t.detach())
                   for a, t in zip(before, eng._leaf_tensors))
        eng.train_batch(next(loader))       # its boundary decides step 2
        skips = [r for r in journal("nan") if r["event"] == "skip"]
        if bool(m["finite"]) or not same or \
                [(r["position"], r["cause"]) for r in skips] != \
                [(1, "nonfinite")]:
            raise AssertionError(f"sentinel: NaN step finite "
                                 f"{bool(m['finite'])}, params unchanged "
                                 f"{same}, journaled skips {skips}")
        del eng, before
        configure_fault_injection({})
        clean = data[:4] + data[7:]
        ref, t_armed = drive(engine("clean"), clean, 8)
        plain, t_plain = drive(engine("plain", armed=False), clean, 8)
        if plain != ref:
            raise AssertionError(f"sentinel: armed {ref} != unarmed {plain}")
        resilience_counters.reset()
        # steps 5-7 (positions 4-6): the loss cap is warm from step 5 on;
        # the verdict on step 7 (lag 1) rolls back at step 8's boundary
        configure_fault_injection({"loss_spike": {
            "rank": 0, "step": 5, "count": 3, "factor": 1e3}})
        eng = engine("fault")
        got, _ = drive(eng, data, 8, save_at=3)
        j = journal("fault")
        if got != ref:
            raise AssertionError(f"sentinel: replay {got} != clean {ref}")
        events = [(r["event"], r.get("position")) for r in j]
        want = ([("skip", p) for p in (4, 5, 6)] + [("rollback", None)]
                + [("skip_replay", p) for p in (4, 5, 6)])
        if events != want or resilience_counters.get("rollbacks") != 1 or \
                read_last_good(os.path.join(root, "ckpt")) != "global_step3":
            raise AssertionError(f"sentinel: journal {events}, rollbacks "
                                 f"{resilience_counters.get('rollbacks')}, "
                                 f"last_good {read_last_good(root)}")
        del eng
        torch.cuda.empty_cache()
    finally:
        configure_fault_injection({})
        shutil.rmtree(root, ignore_errors=True)
    armed = sum(t_armed[2:]) / len(t_armed[2:])
    unarmed = sum(t_plain[2:]) / len(t_plain[2:])
    log("sentinel", f"{TRAIN_MODEL} width, 2 layers, bf16, B=4 "
        f"S={SENTINEL_SEQ}, {SENTINEL_CFG}: a nan_step at step 2 discarded "
        f"on the card (params bit-unchanged, journaled skip at position 1); "
        f"loss_spike x1e3 at steps 5-7 after global_step3 was promoted: "
        f"skips at positions 4-6, one rollback, the replay's 8 losses "
        f"bit-equal to the clean run's (which equal the unarmed run's); "
        f"journal {events}; step armed {armed * 1e3:.2f} ms vs unarmed "
        f"{unarmed * 1e3:.2f} ms ({100 * (armed - unarmed) / unarmed:+.1f} "
        f"%, steps 3-8 of each run)")


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


def hold_e2e_dq(what, e2e, name, dtype):
    """The end-to-end dQ row error of ``e2e`` (``e2e_rows``) held at
    ``E2E_DQ_ROW_LIMIT[dtype][name]``: popped from ``e2e`` and returned as
    a log note."""
    lim = E2E_DQ_ROW_LIMIT[dtype][name]
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
                                c["name"], dtype)
                    if c["name"] in E2E_DQ_ROW_LIMIT.get(dtype, {}) else "")
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
    for dtype in ("bfloat16", "float16", "float32"):
        errs, got, e2e = check_full_bias(torch, dtype, seed=40)
        held = (hold_e2e_dq(f"full-shape bias {dtype}", e2e, "full-bias",
                            dtype)
                if "full-bias" in E2E_DQ_ROW_LIMIT.get(dtype, {}) else "")
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


# -------------------------------------------------------------------- dist
DIST_STEPS = 3
DIST_LAYERS = 2
DIST_SEQ = 2048
DIST_WORLD = 4
DIST_TIMEOUT_S = 600
DIST_BASE = {
    "train_batch_size": 4, "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-4,
                                              "weight_decay": 0.1}},
    "gradient_clipping": 1.0, "comms_logger": {"enabled": True}}
# the three legs of the JAX package's dryrun_multichip ported so far
# (__graft_entry__.py:132, :135, :214): name -> (config, model dtype)
DIST_TWINS = {
    "dp1_fsdp2_tp2_zero3": (dict(DIST_BASE, zero_optimization={"stage": 3},
                                 parallelism={"dp": 1, "fsdp": 2, "tp": 2}),
                            "float32"),
    # the JAX leg's fp16 section: dynamic scaling from its default 2^16,
    # well below where llama2-1b's widths overflow (~2^24 at step 1: there
    # one split of the matmuls overflowed and the other did not)
    "fp16_zero2": (dict(DIST_BASE, zero_optimization={"stage": 2},
                        parallelism={"dp": 1, "fsdp": 2, "tp": 2},
                        fp16={"enabled": True}), "float16"),
    "mics2_zero3": (dict(DIST_BASE, zero_optimization={
        "stage": 3, "mics_shard_size": 2}), "float32"),
}
# fp16 twin against its world-1 run: fp16 activations and grads (2^-11
# relative a rounding) rounded at other places when the matmuls split over
# two ranks, over 2 layers and the vocab-parallel loss
DIST_FP16_LOSS_TOL = 1e-2
# (c): the pipeline and sequence-parallel legs of dryrun_multichip
# (__graft_entry__.py:149-188) at llama2-1b widths cut to 4 layers: name ->
# (config, model dtype, model overrides)
DIST_PS_LAYERS = 4
DIST_PS_TWINS = {
    "pp2_tp2_zero1": (dict(DIST_BASE, zero_optimization={"stage": 1},
                           parallelism={"dp": 1, "tp": 2},
                           pipeline={"stages": 2, "micro_batches": 2}),
                      "float32", {}),
    # one layer a stage: the 3-deep warmup and drain
    "pp4_zero1": (dict(DIST_BASE, zero_optimization={"stage": 1},
                       parallelism={"dp": 1},
                       pipeline={"stages": 4, "micro_batches": 4}),
                  "float32", {}),
    "pp2_fsdp2_zero1": (dict(DIST_BASE, zero_optimization={"stage": 1},
                             parallelism={"dp": 1, "fsdp": 2},
                             pipeline={"stages": 2, "micro_batches": 2}),
                        "float32", {}),
    "ulysses_sp2_tp2_zero1": (dict(DIST_BASE, zero_optimization={"stage": 1},
                                   parallelism={"dp": 1, "sp": 2, "tp": 2}),
                              "float32", {"attn_impl": "ulysses:flash"}),
    "ring_flash_sp4_zero0": (dict(DIST_BASE, zero_optimization={"stage": 0},
                                  parallelism={"dp": 1, "sp": 4}),
                             "float32", {"attn_impl": "ring:flash"}),
}
# the same two in bf16 (the Hopper routes of the flash kernels)
DIST_PS_BF16 = {
    f"{name}_bf16": (dict(DIST_PS_TWINS[name][0], bf16={"enabled": True}),
                     "bfloat16", DIST_PS_TWINS[name][2])
    for name in ("pp2_tp2_zero1", "ring_flash_sp4_zero0")}
# bf16 twins against their world-1 bf16 runs: a split moves where the
# activations round to bf16 (2^-9 relative a rounding, 4x fp16's), over 4
# layers, the pipeline's micro-batch sums and the ring's LSE merges, and
# Adam carries it into steps 2-3: the fp16 twin's limit, no looser
DIST_BF16_LOSS_TOL = DIST_FP16_LOSS_TOL


def dist_reference_config(cfg):
    """A twin's config on one card without a process group: the same
    optimizer, precision and stage, no mesh sizes."""
    out = {k: v for k, v in cfg.items()
           if k not in ("parallelism", "pipeline")}
    out["zero_optimization"] = {"stage": cfg["zero_optimization"]["stage"]}
    return out


def dist_batch(np, vocab, seq=None, rows=None):
    return {"input_ids": np.random.RandomState(3).randint(
        0, vocab, (rows or DIST_BASE["train_batch_size"],
                   seq or DIST_SEQ)).astype(np.int64)}


def dist_model(dtype, num_layers=None, model=None, **overrides):
    from deepspeedsyclsupport_tpu_torch import build_model

    return build_model(model or TRAIN_MODEL,
                       num_layers=num_layers or DIST_LAYERS, dtype=dtype,
                       **dict({"attn_impl": "flash"}, **overrides))


def dist_comm_bytes(torch, eng, rows, seq, applied):
    """The bytes each collective of one step is handed, by logger key,
    from the plan and the shapes alone: ZeRO-3 gathers each fsdp-sharded
    leaf in the forward and (a matrix the backward keeps) again in the
    backward, and reduce-scatters its full gradient; stage 2
    reduce-scatters each update-sharded gradient and (an applied step)
    all-gathers the updated shards; TP all-reduces [rows, S, H] twice a
    sublayer, once at the embedding and once at the head, and the loss's
    max, sum and gold logit [rows, S] in fp32; plus the grads' reductions
    over data / (data, fsdp) and the step's scalars."""
    from deepspeedsyclsupport_tpu_torch.runtime.zero import _walk

    topo, stage = eng.topology, eng.zero_stage
    cfg = eng.module.config
    cb = torch.empty((), dtype=eng.compute_dtype).element_size()
    gas = eng.gradient_accumulation_steps()
    sizes = topo.axis_sizes
    tp, fsdp, data = sizes["model"], sizes["fsdp"], sizes["data"]
    want = {}

    def add(key, n):
        if n:
            want[key] = want.get(key, 0) + int(n)

    batch_key = f"all_reduce[{('data', 'fsdp')}]"
    float_paths = set(eng._float_paths)
    for path, t in _walk(eng.params):
        if path not in float_paths:
            continue
        spec = eng._specs[path]
        d = eng._shard_dim(spec)
        k = eng._float_paths.index(path)
        ud = eng._update_dim[k]
        if stage >= 3 and d is not None:
            saved = path[-1] != "embedding"   # a lookup keeps the ids only
            add("all_gather[fsdp]", gas * t.numel() * cb * (1 + saved))
            add("reduce_scatter[fsdp]", gas * t.numel() * fsdp * cb)
            if data > 1:
                add("all_reduce[data]", t.numel() * 4)
        elif stage == 2 and ud is not None:
            add("reduce_scatter[fsdp]", t.numel() * 4)
            if data > 1:
                add("all_reduce[data]", t.numel() * 4 // fsdp)
            if applied:
                add("all_gather[fsdp]", t.numel() * 4 // fsdp)
        elif fsdp * data > 1:
            add(batch_key, t.numel() * 4)
    if tp > 1:
        act = rows * seq * cfg.hidden_size * cb
        add("all_reduce[model]", gas * (cfg.num_layers * 4 * act + 2 * act
                                        + 3 * rows * seq * 4))
    add(batch_key, gas * 4 + 4 * (gas + gas))   # token counts; loss, lm_loss
    everyone = f"all_reduce[{tuple(sizes)}]"
    add(everyone, 4 * (2 if eng.fp16_enabled else 1))   # norm (+ verdict)
    return want


def dist_p2p_bytes(torch, eng, rows, seq):
    """The bytes one step hands each point-to-point and all-to-all op, by
    logger key, from the schedule and the shapes alone. Pipeline: each
    micro-batch's activation ``[rows / n, S, H]`` goes to the next stage
    and its gradient comes back (send and recv log the tensor handed, each
    way). Ulysses: a layer's q, k, v and output through an all-to-all,
    and their gradients back (the transposes). Ring: K and V rotate n - 1
    times a layer, and their gradients as often back."""
    topo = eng.topology
    cfg = eng.module.config
    cb = torch.empty((), dtype=eng.compute_dtype).element_size()
    gas = eng.gradient_accumulation_steps()
    pp, sp, tp = (topo.axis_sizes[a] for a in ("pipe", "seq", "model"))
    want = {}
    if pp > 1:
        n = cfg.pipe_microbatches or pp
        act = rows // n * seq * cfg.hidden_size * cb
        s = topo.axis_index("pipe")
        ways = (s < pp - 1) + (s > 0)
        want["send[pipe]"] = want["recv[pipe]"] = gas * n * act * ways
    if sp > 1:
        layers = cfg.num_layers
        c = seq // sp
        q = rows * c * cfg.num_heads // tp * cfg.head_dim * cb
        kv = rows * c * cfg.num_kv_heads // tp * cfg.head_dim * cb
        impl = cfg.attn_impl.split(":")[0]
        if impl == "ulysses":
            g = sp * tp
            kvh = cfg.num_kv_heads
            rep = 1 if kvh % g == 0 else math.lcm(kvh, g) // kvh
            want["all_to_all[seq]"] = gas * layers * 2 * (2 * q + 2 * kv *
                                                         rep)
        else:
            want["ppermute[seq]"] = gas * layers * 4 * (sp - 1) * kv
    return want


def dist_flash_per_step(eng):
    """Flash launches a rank and step: the stage's layers x the pipeline's
    micro-batches (x 2 forwards under remat), x the ring's blocks."""
    cfg = eng.module.config
    topo = eng.topology
    per = len(eng.params["layers"]) * eng.gradient_accumulation_steps()
    if topo.axis_sizes["pipe"] > 1:
        per *= cfg.pipe_microbatches or topo.axis_sizes["pipe"]
    if cfg.attn_impl.startswith("ring"):
        per *= topo.axis_sizes["seq"]
    return {"flash_fwd": per * (2 if cfg.remat else 1), "flash_dq": per,
            "flash_dkv": per, "flash_dbias": 0}


def dist_memory_prediction(torch, eng, rows, seq):
    """``predict_memory_per_device`` for this rank's params (the model's
    count over tp, its experts also over ep) and the activations of one
    micro-batch: 3 x 4 bytes a token of the logits' V / tp, and (10 + 24 /
    tp) x H bytes a token a layer at 2-byte activations (the flash kernels
    keep no S x S score), twice that at 4 bytes; an MoE layer adds its
    expert buffers (the tokens k times and the rank's ``E / ep`` capacity
    buffers in and out ``[C, D]``, its GLU's four ``[C, F / tp]``) and its
    float32 combine ``[T, D]`` twice."""
    from deepspeedsyclsupport_tpu_torch.parallel.moe import capacity
    from deepspeedsyclsupport_tpu_torch.runtime.zero import (
        is_expert_leaf, predict_memory_per_device)

    cfg = eng.module.config
    sizes = eng.topology.axis_sizes
    tp, ep = sizes["model"], sizes["expert"]
    seq //= sizes["seq"]
    n = sum(math.prod(s) for s in eng._full_shapes.values())
    experts = sum(math.prod(s) for p, s in eng._full_shapes.items()
                  if is_expert_leaf(p))
    cb = torch.empty((), dtype=eng.compute_dtype).element_size()
    layers = len(eng.params["layers"])
    act = layers * rows * seq * cfg.hidden_size * (
        10 + 24 / tp) * cb / 2 + 4 * rows * seq * cfg.vocab_size / tp * 3
    if cfg.any_moe:
        t = rows * seq // ((cfg.pipe_microbatches or sizes["pipe"])
                           if sizes["pipe"] > 1 else 1)
        c = capacity(t * eng.dp_world_size * sizes["seq"], cfg)
        el = cfg.num_experts // ep
        act += layers * (cb * (el * c * (2 * cfg.hidden_size + 4 *
                                         cfg.intermediate_size / tp)
                               + 2 * cfg.num_experts_per_tok * t *
                               cfg.hidden_size)
                         + 4 * 2 * t * cfg.hidden_size)
    return predict_memory_per_device(
        n // tp, sizes["fsdp"], eng.zero_stage, compute_bytes=cb,
        activation_bytes=act, expert_params=experts // tp, ep=ep), n


def dist_facade_check(torch, device):
    """Every façade op on this rank's tensors over the world's ``data``
    axis, held EXACT against its known result (integers as floats)."""
    from deepspeedsyclsupport_tpu_torch import comm
    from deepspeedsyclsupport_tpu_torch.comm.topology import build_topology

    topo = build_topology(dp=-1)
    n, r = comm.get_world_size(), comm.get_rank()
    topo.init_groups(hierarchical=[("data", 2)])
    x = torch.tensor([float(r + 1)], device=device)
    g = torch.arange(6.0, device=device).reshape(3, 2) + 6 * r
    full = torch.arange(4.0 * n, device=device).reshape(n, 4) * (r + 1)
    rows = torch.arange(16.0, device=device).reshape(4, 4)
    want = {
        "all_reduce": (comm.all_reduce(x, "data"), [n * (n + 1) / 2]),
        "all_reduce_max": (comm.all_reduce(x, "data", op="max"), [n]),
        "all_gather": (comm.all_gather(g, "data"),
                       torch.arange(6.0 * n).reshape(3 * n, 2).tolist()),
        "reduce_scatter": (comm.reduce_scatter(full, "data"),
                           (torch.arange(4.0 * n).reshape(n, 4)[r:r + 1]
                            * (n * (n + 1) / 2)).tolist()),
        "all_to_all": (comm.all_to_all(rows + 100 * r, "data", split_axis=1,
                                       concat_axis=1),
                       torch.cat([rows[:, r * 4 // n:(r + 1) * 4 // n]
                                  + 100 * j for j in range(n)],
                                 dim=1).tolist()),
        "broadcast": (comm.broadcast(x, "data", src=n - 1), [float(n)]),
        "ppermute": (comm.send_recv_next(x, "data"),
                     [float((r - 1) % n + 1)]),
        # the rest of the façade: root-based ops, aliases, the
        # two-hop all-to-all (EQUAL to the plain one) and the untiled one
        "reduce": (comm.reduce(x, "data", dst=n - 1),
                   [n * (n + 1) / 2 if r == n - 1 else float(r + 1)]),
        "gather": (comm.gather(x, "data", dst=0),
                   [[float(i + 1)] for i in range(n)]),
        "scatter": (comm.scatter(torch.arange(float(n), device=device)
                                 [:, None] + 10 * r, "data", src=1),
                    [float(r + 10)]),
        "hierarchical_all_to_all": (
            comm.hierarchical_all_to_all(rows + 100 * r, "data", 2,
                                         split_axis=1, concat_axis=1),
            comm.all_to_all(rows + 100 * r, "data", split_axis=1,
                            concat_axis=1).tolist()),
        "all_to_all_untiled": (
            comm.all_to_all(rows[:n] + 100 * r, "data", 0, 1, tiled=False),
            [[float(4 * r + c + 100 * j) for j in range(n)]
             for c in range(4)]),
        "all_gather_into_tensor": (comm.all_gather_into_tensor(x, "data"),
                                   [float(i + 1) for i in range(n)]),
        "reduce_scatter_tensor": (
            comm.reduce_scatter_tensor(full, "data"),
            (torch.arange(4.0 * n).reshape(n, 4)[r:r + 1]
             * (n * (n + 1) / 2)).tolist()),
        "inference_all_reduce": (comm.inference_all_reduce(x, "data"),
                                 [n * (n + 1) / 2]),
    }
    comm.monitored_barrier(timeout=60)
    bad = {k: (got.tolist(), w) for k, (got, w) in want.items()
           if got.tolist() != (w if isinstance(w, list) else w)}
    if bad:
        raise AssertionError(f"rank {r}: façade ops on {device} tensors "
                             f"disagree {bad}")
    return sorted(want)


def dist_rank_child(torch, np, spec_path):
    """One rank of the dist phase (``--dist-rank``): the façade check, then
    each twin's ``DIST_STEPS`` steps; writes ``rank<r>.json``. A twin is
    (config, dtype) or (config, dtype, model overrides); the spec's
    ``plan`` names the bytes plan held: ``"all"`` (every collective,
    :func:`dist_comm_bytes`) or ``"p2p"`` (point-to-point and all-to-all,
    :func:`dist_p2p_bytes`)."""
    import torch.distributed as tdist

    from deepspeedsyclsupport_tpu_torch import comm, initialize
    from deepspeedsyclsupport_tpu_torch.comm.comms_logging import comms_logger
    from deepspeedsyclsupport_tpu_torch.comm.topology import (
        MeshTopology, reset_world_topology)
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa
    from deepspeedsyclsupport_tpu_torch.runtime import shard_params
    from deepspeedsyclsupport_tpu_torch.runtime.config import DSTpuConfig

    with open(spec_path) as f:
        spec = json.load(f)
    dev = spec["device"]
    cuda = dev == "cuda"
    comm.init_distributed(device_type=dev, timeout_s=DIST_TIMEOUT_S)
    rank = comm.get_rank()
    out = {"rank": rank, "backend": tdist.get_backend(),
           "facade": dist_facade_check(torch, dev), "twins": {}}
    reset_world_topology()
    plan = {"all": dist_comm_bytes, "moe": dist_moe_bytes,
            "zeropp": dist_zeropp_bytes,
            "p2p": lambda torch, eng, rows, seq, applied: dist_p2p_bytes(
                torch, eng, rows, seq)}[spec.get("plan", "all")]
    for name, (cfg, dtype, *over) in spec["twins"].items():
        over = dict(over[0]) if over else {}
        n_steps = over.pop("steps", spec["steps"])
        model = dist_model(dtype, over.pop("num_layers", spec["layers"]),
                           spec["model"], **over)
        # the full tree is drawn (as the world-1 run draws it) and cut to
        # this rank's shards one rank at a time: four full trees at once
        # do not fit beside the ranks' state at Mixtral's widths
        par = DSTpuConfig.from_config(cfg).parallelism
        sizes = MeshTopology({"data": par.dp, "fsdp": par.fsdp,
                              "model": par.tp, "pipe": par.pp,
                              "expert": par.ep, "seq": par.sp},
                             world_size=comm.get_world_size())
        for turn in range(comm.get_world_size()):
            if turn == rank:
                full = model.init_params(generator=torch.Generator(
                    device=dev).manual_seed(1), device=dev)
                params = shard_params(full, model.config, sizes,
                                      cfg["zero_optimization"]["stage"])
                del full
                if cuda:
                    torch.cuda.empty_cache()
            comm.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        eng = initialize(model=model, params=params, config=cfg,
                         device=dev)[0]
        del params
        staged0 = comm.staged_ops()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in dist_batch(
            np, model.config.vocab_size, spec["seq"],
            cfg["train_batch_size"]).items()}
        rows = cfg["train_batch_size"] // eng.dp_world_size
        checks = dist_zeropp_checks(torch, eng, batch) \
            if getattr(eng, "_zeropp", None) is not None else {}
        p0 = [t.detach().clone() for t in eng._leaf_tensors] \
            if spec.get("plan") == "zeropp" and eng.zero_stage < 3 else None
        steps = []
        for _ in range(n_steps):
            comms_logger.reset()
            fa.reset_launch_counts()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = eng.train_batch(batch)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            if cuda:
                torch.cuda.synchronize()
            finite = bool(m["finite"])
            steps.append({
                "loss": loss, "grad_norm": gn, "finite": finite,
                "moe_aux_loss": float(m.get("moe_aux_loss", float("nan"))),
                "scale": float(m["loss_scale"]),
                "s": time.perf_counter() - t0,
                "bytes": {k: v["total_bytes"] for k, v in
                          comms_logger.snapshot().items()},
                "want_bytes": plan(torch, eng, rows, spec["seq"], finite),
                "want_launches": dist_flash_per_step(eng),
                "launches": dict(fa.LAUNCHES)})
        pred, n_params = dist_memory_prediction(torch, eng, rows,
                                                spec["seq"])
        out["twins"][name] = {
            "steps": steps, "skipped": eng.skipped_steps,
            "peak": torch.cuda.max_memory_allocated() if cuda else 0,
            "predicted": pred, "n_params": n_params,
            "local_params": sum(t.numel() for t in eng._leaf_tensors),
            "staged": {k: v - staged0.get(k, 0) for k, v in
                       comm.staged_ops().items() if v > staged0.get(k, 0)},
            "sizes": eng.topology.axis_sizes,
            "stage_layers": len(eng.params["layers"]),
            "checks": checks,
            "delta": [float((t.detach() - p).norm()) for t, p in zip(
                eng._leaf_tensors, p0)] if p0 is not None else []}
        del eng, p0
        reset_world_topology()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    comm.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_dist_ranks(spec, out_dir, world=DIST_WORLD,
                     timeout=DIST_TIMEOUT_S):
    """``world`` ranks of this script (``--dist-rank``) with the torch
    launcher's environment; waits for all, kills any left on a failure,
    and returns their ``rank<r>.json``."""
    spec = dict(spec, out=out_dir)
    path = os.path.join(out_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), **spec.get("env", {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = [], []
    try:
        t_end = time.time() + timeout
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=max(1.0, t_end - time.time()))
            logs.append(text)
            if p.returncode != 0:
                failed.append((r, p.returncode, text[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError(f"dist ranks failed: {failed}")
    return [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in range(world)]


def dist_reference(torch, np, cfg, dtype, layers=DIST_LAYERS):
    """A twin's world-1 run: the single-card engine, no process group (one
    card runs every ZeRO stage as one program)."""
    from deepspeedsyclsupport_tpu_torch import initialize

    model = dist_model(dtype, layers)
    params = model.init_params(generator=torch.Generator(
        device=DEV).manual_seed(1), device=DEV)
    eng = initialize(model=model, params=params,
                     config=dist_reference_config(cfg), device=DEV)[0]
    del params
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in dist_batch(np, model.config.vocab_size).items()}
    out = []
    for _ in range(DIST_STEPS):
        m = eng.train_batch(batch)
        out.append({"loss": float(m["loss"]), "grad_norm": float(
            m["grad_norm"]), "finite": bool(m["finite"]),
            "scale": float(m["loss_scale"])})
    skipped = eng.skipped_steps
    del eng
    torch.cuda.empty_cache()
    return out, skipped


def phase_dist(torch, np, train_steps, moe_steps):
    """(a) NCCL at a world of one: llama2-1b at full depth through the
    ZeRO-3 config, bit-equal to the train phase's single-card steps;
    (b) four ranks on the one card over gloo: the dryrun_multichip twins
    at llama2-1b widths, 2 layers, fp32 (fp16 twin: fp16), held against
    their world-1 runs; (c) four ranks the same way: the pipeline (pp2 x
    tp2, pp4, pp2 x fsdp2), Ulysses (sp2 x tp2) and ring:flash (sp4) twins
    at 4 layers, fp32, then pp2 x tp2 and the ring in bf16, each held
    against its world-1 run, its point-to-point and all-to-all bytes and
    its flash launches against the plan; (d) MoE across ranks
    (:func:`dist_moe`); (e) ZeRO++ and the 1-bit optimizers
    (:func:`dist_zeropp`). Returns the flash launches of (a) + (b), of
    (c), of (d) and of (e)."""
    import tempfile

    import torch.distributed as tdist

    from deepspeedsyclsupport_tpu_torch import comm
    from deepspeedsyclsupport_tpu_torch.comm.comms_logging import comms_logger
    from deepspeedsyclsupport_tpu_torch.comm.topology import (
        reset_world_topology)
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    # ---- (a) world 1, NCCL
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{free_port()}",
                          world_size=1, rank=0, device_type="cuda")
    backend = tdist.get_backend()
    if backend != "nccl":
        raise AssertionError(f"world 1 on one card chose {backend}")
    eng = train_engine(torch, 0, extra={"zero_optimization": {"stage": 3},
                                        "comms_logger": {"enabled": True}})
    cfg = eng.module.config
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (eng.train_batch_size(), TRAIN_SEQ))
    batch = {"input_ids": torch.from_numpy(ids).to(DEV)}
    fa.reset_launch_counts()
    launches = {k: 0 for k in fa.LAUNCHES}
    got, times, step_bytes = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(DIST_STEPS):
        comms_logger.reset()
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = eng.train_batch(batch)
        got.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        step_bytes.append(sum(v["total_bytes"] for v in
                              comms_logger.snapshot().values()))
        per = {k: fa.LAUNCHES[k] - before[k] for k in before}
        if per != flash_per_step(eng):
            raise AssertionError(f"dist world 1 step {step + 1}: flash "
                                 f"launches {per}, want "
                                 f"{flash_per_step(eng)}")
    for k in launches:
        launches[k] += fa.LAUNCHES[k]
    want = [(x[0], x[1]) for x in train_steps[:DIST_STEPS]]
    log("dist", f"(a) world 1, {backend}, topology "
        f"{eng.topology.axis_sizes}, ZeRO-3, {TRAIN_MODEL} full depth bf16, "
        f"phase 6's batch: (loss, grad_norm) {got} vs the single-card "
        f"engine {want}: {'bit-equal' if got == want else 'DIFFER'}; "
        f"ms/step {[round(t * 1e3, 1) for t in times]}, bytes handed to "
        f"collectives a step {step_bytes}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
        f"launches {launches}")
    if got != want:
        raise AssertionError(f"world-1 NCCL ZeRO-3 {got} != single card "
                             f"{want}")
    del eng
    reset_world_topology()
    comm.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) four ranks over gloo on the one card
    refs = {"float32": dist_reference(torch, np, DIST_TWINS[
        "dp1_fsdp2_tp2_zero3"][0], "float32"),
        "float16": dist_reference(torch, np, DIST_TWINS["fp16_zero2"][0],
                                  "float16")}
    log("dist", f"(b) world-1 references ({TRAIN_MODEL} widths, "
        f"{DIST_LAYERS} layers, B {DIST_BASE['train_batch_size']} x S "
        f"{DIST_SEQ}, TF32 off): {refs}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = spawn_dist_ranks(
            {"device": "cuda", "twins": DIST_TWINS, "steps": DIST_STEPS,
             "layers": DIST_LAYERS, "seq": DIST_SEQ, "model": TRAIN_MODEL},
            d)
        wall = time.perf_counter() - t0
    log("dist", f"(b) {DIST_WORLD} ranks, backend {ranks[0]['backend']}, "
        f"façade ops held exact on CUDA tensors {ranks[0]['facade']}, host-"
        f"staged (backend, op) {sorted(comm.HOST_STAGED)}; ranks ran in "
        f"{wall:.1f} s")
    hold_dist_twins("(b)", DIST_TWINS, ranks, refs, launches,
                    {"float16": {"loss": DIST_FP16_LOSS_TOL}}, full_plan=True)

    return (launches, dist_pipe_seq(torch, np),
            dist_moe(torch, np, moe_steps), dist_zeropp(torch, np))


def dist_pipe_seq(torch, np):
    """Phase ``dist`` (c): the pipeline and sequence-parallel twins on four
    ranks over gloo, held against their world-1 runs; returns their flash
    launches."""
    import tempfile

    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    t_c = time.perf_counter()
    twins = dict(DIST_PS_TWINS, **DIST_PS_BF16)
    refs = {dtype: dist_reference(torch, np, twins[name][0], dtype,
                                  DIST_PS_LAYERS)
            for name, dtype in (("pp2_tp2_zero1", "float32"),
                                ("pp2_tp2_zero1_bf16", "bfloat16"))}
    log("dist", f"(c) world-1 references ({TRAIN_MODEL} widths, "
        f"{DIST_PS_LAYERS} layers, B {DIST_BASE['train_batch_size']} x S "
        f"{DIST_SEQ}): {refs}")
    launches_ps = {k: 0 for k in fa.LAUNCHES}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = spawn_dist_ranks(
            {"device": "cuda", "twins": twins, "steps": DIST_STEPS,
             "layers": DIST_PS_LAYERS, "seq": DIST_SEQ, "model": TRAIN_MODEL,
             "plan": "p2p"}, d)
        wall = time.perf_counter() - t0
    log("dist", f"(c) {DIST_WORLD} ranks, backend {ranks[0]['backend']}; "
        f"ranks ran in {wall:.1f} s")
    hold_dist_twins("(c)", twins, ranks, refs, launches_ps,
                    {"bfloat16": {"loss": DIST_BF16_LOSS_TOL}},
                    full_plan=False)
    log("dist", f"(c) took {time.perf_counter() - t_c:.1f} s; flash "
        f"launches on its legs {launches_ps}")
    return launches_ps


# (d): MoE across ranks, the train-moe model (MOE_MODEL at its published
# widths), depth cut: name -> (config, dtype, model overrides)
DIST_MOE_TWINS = {
    # the JAX leg "moe dp/fsdp/tp/ep zero2" without tp: the batch split
    # over two ranks (global slots and the aux), the experts over two
    "moe_fsdp2_ep2_zero2": (dict(DIST_BASE, zero_optimization={"stage": 2},
                                 parallelism={"dp": 1, "fsdp": 2, "ep": 2}),
                            "float32", {"num_layers": 1}),
    # the expert region over (expert, model)
    "moe_ep2_tp2_zero2": (dict(DIST_BASE, zero_optimization={"stage": 2},
                               parallelism={"dp": 1, "tp": 2, "ep": 2}),
                          "float32", {"num_layers": 1}),
    # MoE under the pipeline: a layer a stage, the aux through the
    # executor, each layer under activation checkpointing (its recompute
    # posts the expert region's forward again). B 2: a rank holds 16.1 GB
    # of fp32 Adam state (1.01 B params: the embedding and head on both
    # stages), so four ranks leave ~15 GiB of the card for activations
    "moe_pp2_ep2_zero1": (dict(DIST_BASE, zero_optimization={"stage": 1},
                               train_batch_size=2,
                               activation_checkpointing={},
                               parallelism={"dp": 1, "ep": 2},
                               pipeline={"stages": 2, "micro_batches": 2}),
                          "float32", {"num_layers": 2}),
}


def pipelined_moe_loss(model, n_micro):
    """The loss the JAX pipeline computes, on one card without a pipeline
    (the world-1 run of a pipelined MoE twin): the micro-batches split
    strided, each routed over its own tokens, the LM loss the global
    masked mean, the aux summed over the micro-batches and the layers."""
    import torch

    def loss_fn(params, batch, rng=None, train=True):
        labels, mask = model.targets(batch)
        count = mask.sum().clamp_min(1.0)
        lm, aux = 0.0, 0.0
        for m in range(n_micro):
            logits, a = model._forward(params, batch["input_ids"][m::n_micro],
                                       rng=rng, train=train)
            lm = lm + model.nll_sum(logits, labels[m::n_micro],
                                    mask[m::n_micro]) / count
            aux = aux + a
        return lm + model.config.aux_loss_coef * aux, {
            "lm_loss": lm.detach(), "moe_aux_loss": torch.as_tensor(
                aux).detach()}

    return loss_fn


def dist_moe_reference(torch, np, name):
    """A (d) twin's world-1 run: the single-card engine on the twin's
    model and config without mesh sizes (a pipelined twin: the loss of
    :func:`pipelined_moe_loss`), 3 steps."""
    from deepspeedsyclsupport_tpu_torch import initialize

    cfg, dtype, over = DIST_MOE_TWINS[name]
    over = dict(over)
    layers = over.pop("num_layers")
    model = dist_model(dtype, layers, MOE_MODEL, **over)
    params = model.init_params(generator=torch.Generator(
        device=DEV).manual_seed(1), device=DEV)
    loss_fn = None
    if "pipeline" in cfg:
        loss_fn = pipelined_moe_loss(model, cfg["pipeline"]["micro_batches"])
    eng = initialize(model=model, params=params, loss_fn=loss_fn,
                     config=dist_reference_config(cfg), device=DEV)[0]
    del params
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in dist_batch(
        np, model.config.vocab_size, rows=cfg["train_batch_size"]).items()}
    cuda = DEV == "cuda"     # the CPU rehearses the phase
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(DIST_STEPS):
        m = eng.train_batch(batch)
        out.append({"loss": float(m["loss"]), "grad_norm": float(
            m["grad_norm"]), "finite": bool(m["finite"]),
            "scale": float(m["loss_scale"]),
            "moe_aux_loss": float(m["moe_aux_loss"])})
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    skipped = eng.skipped_steps
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, skipped, peak


def dist_moe_bytes(torch, eng, rows, seq, applied):
    """The bytes each collective of one step of an MoE twin is handed, by
    logger key, from the plan and the shapes alone (ZeRO stages 0-2;
    under activation checkpointing a layer's forward collectives twice,
    up to its last saved tensor).
    Per MoE layer and micro-batch of T tokens: the routing counts
    ``[1, k, E]`` int64 all-gathered over the live batch axes; the expert
    region (``parallel/moe.expert_region``: expert, and model under TP)
    all-reduces the partial output ``[T, D]`` float32 forward, and the
    tokens' gradient ``[T, D]`` and the combine weights' ``[k T]`` float32
    backward. TP: a layer's attention all-reduces ``[T, H]`` twice, the
    embedding once and the head once (first and last stage), the loss
    ``[T]`` thrice in float32. Pipeline: each micro-batch's activation
    ``[rows / n, S, H]`` one way and its gradient back; the step's three
    scalars (loss, lm_loss, moe_aux_loss) a micro-batch over (pipe, data,
    fsdp), the token count on the last stage. Grads: over the batch axes
    (stage 2 reduce-scatters onto the update's fsdp shard, an applied step
    all-gathers the updated shards at stages 1-2), the entries replicated
    over ``pipe`` also over ``pipe``; the norm over the world."""
    from deepspeedsyclsupport_tpu_torch.parallel.moe import expert_region
    from deepspeedsyclsupport_tpu_torch.runtime.zero import _walk

    topo, stage = eng.topology, eng.zero_stage
    if stage > 2:
        raise ValueError("dist_moe_bytes plans ZeRO stages 0-2")
    cfg = eng.module.config
    cb = torch.empty((), dtype=eng.compute_dtype).element_size()
    gas = eng.gradient_accumulation_steps()
    sizes = topo.axis_sizes
    tp, fsdp, data, pp = (sizes[a] for a in ("model", "fsdp", "data",
                                              "pipe"))
    n_micro = (cfg.pipe_microbatches or pp) if pp > 1 else 1
    s = topo.axis_index("pipe")
    first, last = s == 0, s == pp - 1
    want = {}

    def add(key, n):
        if n:
            want[key] = want.get(key, 0) + int(n)

    batch_key = f"all_reduce[{('data', 'fsdp')}]"
    for path, t in _walk(eng.params):
        if path not in set(eng._float_paths):
            continue
        ud = eng._update_dim[eng._float_paths.index(path)]
        n = t.numel() * 4
        if stage == 2 and ud is not None:
            add("reduce_scatter[fsdp]", n)
            n //= fsdp
            if data > 1:
                add("all_reduce[data]", n)
        else:
            if fsdp * data > 1:
                add(batch_key, n)
            if ud is not None:
                n //= fsdp
        if ud is not None and applied:
            add("all_gather[fsdp]", n)
        if pp > 1 and path[0] != "layers":
            add("all_reduce[pipe]", n)
    rows_m = rows // n_micro
    t_m = rows_m * seq
    batch = topo.live(("data", "fsdp"))
    region = expert_region(eng.module.parallel)
    fwd = 2 if cfg.remat else 1     # a layer's recompute posts its forward
    per_layer = {}
    if batch:
        key = batch[0] if len(batch) == 1 else batch
        per_layer[f"all_gather[{key}]"] = fwd * cfg.num_experts_per_tok * \
            cfg.num_experts * 8
    if region is not None:
        # the region's forward all-reduce is the layer's last op: the
        # recompute (non-reentrant checkpoint) stops at the last tensor
        # the backward saved, before it
        per_layer[f"all_reduce[{region}]"] = t_m * cfg.hidden_size * 4 \
            + t_m * cfg.hidden_size * cb + cfg.num_experts_per_tok * t_m * 4
    act = t_m * cfg.hidden_size * cb
    if tp > 1:
        per_layer["all_reduce[model]"] = (fwd + 1) * act
    micros = gas * n_micro
    for key, n in per_layer.items():
        add(key, micros * len(eng.params["layers"]) * n)
    if tp > 1:
        add("all_reduce[model]", micros * (act * first
                                           + (act + 3 * t_m * 4) * last))
    if pp > 1:
        way = rows_m * seq * cfg.hidden_size * cb
        add("send[pipe]", micros * way * ((s < pp - 1) + (s > 0)))
        add("recv[pipe]", micros * way * ((s < pp - 1) + (s > 0)))
        add(batch_key, gas * 4 * last)
        add(f"all_reduce[{('pipe', 'data', 'fsdp')}]", 4 * 3 * gas)
    else:
        add(batch_key, gas * 4 + 4 * 3 * gas)
    add(f"all_reduce[{tuple(sizes)}]", 4)
    return want


def dist_moe(torch, np, moe_steps):
    """Phase ``dist`` (d): MoE across ranks at ``MOE_MODEL``'s published
    widths. (d0) the train-moe phase's model, config and batch through the
    distributed engine at a world of one on NCCL (ZeRO-2, ep 1), held
    BIT-EQUAL to that phase's first 3 steps; then each four-rank twin of
    ``DIST_MOE_TWINS`` over gloo held against its world-1 run (run first,
    alone on the card, and freed), its bytes a step EQUAL to
    :func:`dist_moe_bytes` and its flash launches to the plan's. Returns
    the flash launches of (d)."""
    import tempfile

    import torch.distributed as tdist

    from deepspeedsyclsupport_tpu_torch import build_model, comm, initialize
    from deepspeedsyclsupport_tpu_torch.comm.topology import (
        reset_world_topology)
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    t_d = time.perf_counter()
    launches = {k: 0 for k in fa.LAUNCHES}
    # ---- (d0) world 1, NCCL, the train-moe model
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{free_port()}",
                          world_size=1, rank=0, device_type="cuda")
    backend = tdist.get_backend()
    model = build_model(MOE_MODEL, num_layers=MOE_TRAIN_LAYERS)
    params = model.init_params(
        generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    eng = initialize(model=model, params=params, config=dict(
        MOE_TRAIN_CONFIG, zero_optimization={"stage": 2}), device=DEV)[0]
    del params
    torch.cuda.empty_cache()
    ids = np.random.RandomState(3).randint(0, model.config.vocab_size,
                                           (eng.train_batch_size(), TRAIN_SEQ))
    batch = {"input_ids": torch.from_numpy(ids).to(DEV)}
    got, times = [], []
    for step in range(DIST_STEPS):
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = eng.train_batch(batch)
        got.append((float(m["loss"]), float(m["moe_aux_loss"]),
                    float(m["grad_norm"])))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        per = {k: fa.LAUNCHES[k] - before[k] for k in before}
        if per != dist_flash_per_step(eng):
            raise AssertionError(f"dist (d0) step {step + 1}: flash launches"
                                 f" {per}, want {dist_flash_per_step(eng)}")
        for k in per:
            launches[k] += per[k]
    want = [tuple(x[:3]) for x in moe_steps[:DIST_STEPS]]
    log("dist", f"(d0) world 1, {backend}, topology {eng.topology.axis_sizes},"
        f" ZeRO-2, {MOE_MODEL} widths {MOE_TRAIN_LAYERS} layers bf16, the "
        f"train-moe batch: (loss, moe_aux_loss, grad_norm) {got} vs the "
        f"single-card engine {want}: "
        f"{'bit-equal' if got == want else 'DIFFER'}; ms/step "
        f"{[round(t * 1e3, 1) for t in times]}")
    if backend != "nccl" or got != want:
        raise AssertionError(f"(d0) {backend}: {got} != single card {want}")
    del eng
    reset_world_topology()
    comm.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d1)-(d3) four ranks over gloo, each against its world-1 run
    refs, ref_peaks = {}, {}
    for name in DIST_MOE_TWINS:
        if name == "moe_ep2_tp2_zero2":      # the same world-1 run as d1
            refs[name] = refs["moe_fsdp2_ep2_zero2"]
            continue
        out, skipped, peak = dist_moe_reference(torch, np, name)
        refs[name], ref_peaks[name] = (out, skipped), peak
    gc.collect()
    torch.cuda.empty_cache()
    log("dist", f"(d) the parent holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved before "
        f"the ranks start")
    log("dist", f"(d) world-1 references ({MOE_MODEL} widths, B "
        f"{DIST_BASE['train_batch_size']} x S {DIST_SEQ}, fp32, TF32 off; "
        f"the pipelined twin's with the JAX pipeline's loss): {refs}; peak "
        f"GiB {({k: round(v / 2**30, 2) for k, v in ref_peaks.items()})}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        # four ranks' fp32 Adam state fills most of the card: segments
        # that grow in place keep the allocator's cache from splitting it
        ranks = spawn_dist_ranks(
            {"device": "cuda", "twins": DIST_MOE_TWINS, "steps": DIST_STEPS,
             "layers": 1, "seq": DIST_SEQ, "model": MOE_MODEL,
             "plan": "moe", "env": {
                 "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}},
            d)
        wall = time.perf_counter() - t0
    log("dist", f"(d) {DIST_WORLD} ranks, backend {ranks[0]['backend']}, "
        f"façade ops held exact on CUDA tensors {ranks[0]['facade']}; ranks "
        f"ran in {wall:.1f} s")
    hold_dist_twins("(d)", DIST_MOE_TWINS, ranks, refs, launches, {},
                    full_plan=True)
    log("dist", f"(d) took {time.perf_counter() - t_d:.1f} s; flash "
        f"launches on its legs {launches}")
    return launches


# (e): ZeRO++ and the 1-bit optimizers across four ranks at TRAIN_MODEL's
# widths, DIST_LAYERS layers, B 4 x S DIST_SEQ: name -> (config, dtype,
# overrides; "steps" a twin's own count)
DIST_ZPP_BASE = dict(DIST_BASE, parallelism={"dp": 1, "fsdp": 4})
DIST_ZPP_TWINS = {
    # (e1) hpZ alone against plain ZeRO-3 on the same ranks, fp32: the
    # hierarchical gather only moves data (bf16 would reduce the plain
    # path's gradients in bf16 and the ZeRO++ step's in fp32)
    "zero3_fsdp4": (dict(DIST_ZPP_BASE, zero_optimization={"stage": 3}),
                    "float32", {"steps": 2}),
    "zeropp_hpz2_fsdp4": (dict(DIST_ZPP_BASE, zero_optimization={
        "stage": 3, "zero_hpz_partition_size": 2}), "float32", {"steps": 2}),
    # (e2) qwZ + qgZ + hpZ in bf16
    "zeropp_qwz_qgz_hpz2_fsdp4_bf16": (dict(
        DIST_ZPP_BASE, bf16={"enabled": True}, zero_optimization={
            "stage": 3, "zero_quantized_weights": True,
            "zero_quantized_gradients": True,
            "zero_hpz_partition_size": 2}), "bfloat16", {"steps": 3}),
    # (e3) the 1-bit optimizers at ZeRO-2 across their freeze step, fp32,
    # against the world-1 NCCL run (eps 1e-3: at 1e-8 a momentum within
    # rounding of zero takes the other sign, over a variance near zero)
    "onebitadam_zero2_fsdp4": (dict(
        DIST_ZPP_BASE, zero_optimization={"stage": 2}, optimizer={
            "type": "OneBitAdam", "params": {"lr": 3e-4, "freeze_step": 2,
                                             "eps": 1e-3}}),
        "float32", {"steps": 4}),
    "onebitlamb_zero2_fsdp4": (dict(
        DIST_ZPP_BASE, zero_optimization={"stage": 2}, optimizer={
            "type": "OneBitLamb", "params": {
                "lr": 3e-4, "freeze_step": 2, "eps": 1e-3,
                "weight_decay": 0.1}}), "float32", {"steps": 4}),
}
DIST_ONEBIT = ("onebitadam_zero2_fsdp4", "onebitlamb_zero2_fsdp4")
# fp32 holds: hpZ vs plain ZeRO-3 and four ranks vs world 1 split only the
# order of float32 sums
DIST_ZPP_TOL = {"loss": 1e-5, "grad_norm": 1e-4}
DIST_ONEBIT_TOL = 1e-5
# (e4): each optimizer beyond Adam, one card against the CPU, on two
# layers of TRAIN_MODEL's wq and attention norm (two stacked leaves)
DIST_OPT_CASES = [
    ("Lamb", {"weight_decay": 0.1}), ("FusedLamb", {}),
    ("Lion", {"weight_decay": 0.1}), ("FusedLion", {}),
    ("SGD", {"momentum": 0.9}), ("Adagrad", {}),
    ("OneBitAdam", {"freeze_step": 1, "weight_decay": 0.1}),
    ("ZeroOneAdam", {"var_freeze_step": 1, "var_update_scaler": 1,
                     "local_step_scaler": 1, "local_step_clipper": 2}),
    ("OneBitLamb", {"freeze_step": 1, "weight_decay": 0.1}),
]
DIST_OPT_STEPS = 3
# card vs CPU: 1e-5 of a tensor's largest magnitude; a sign (Lion, the
# 1-bit operator) of a value within float32 rounding of zero may differ,
# at most on one element in a million
DIST_OPT_TOL, DIST_OPT_FLIPS = 1e-5, 1e-6


def dist_zeropp_bytes(torch, eng, rows, seq, applied):
    """The ZeRO++ step's wire bytes a rank and step, from the plan: each
    fsdp-sharded leaf of the JAX tree (a stacked leaf over the layers)
    gathered once (int8 under qwZ: a byte an element plus a float32 scale
    a 256-block, times the fsdp ranks) and its float32 gradient reduced
    every micro-batch (qgZ likewise, of the full gradient)."""
    from deepspeedsyclsupport_tpu_torch.runtime.zeropp import wire_bytes

    zc = eng.config.zeropp
    topo = eng.topology
    n = topo.axis_sizes["fsdp"]
    seen, gather, reduce = set(), 0, 0
    for path in eng._float_paths:
        spec = eng._specs[path]
        if eng._shard_dim(spec) is None:
            continue
        key = ("layers",) + path[2:] if path[0] == "layers" else path
        if key in seen:
            continue
        seen.add(key)
        local = math.prod(topo.shard_shape(eng._full_shapes[path], spec))
        if path[0] == "layers":
            local *= len(eng.params["layers"])
        gather += wire_bytes(local, 4, zc.zero_quantized_weights) * n
        reduce += wire_bytes(local * n, 4, zc.zero_quantized_gradients) \
            * eng.gradient_accumulation_steps()
    q = {True: "_int8", False: ""}
    return {f"zeropp_gather{q[zc.zero_quantized_weights]}[fsdp]": gather,
            f"zeropp_reduce{q[zc.zero_quantized_gradients]}[fsdp]": reduce}


def dist_zeropp_checks(torch, eng, batch):
    """(e1) / (e2) on this rank before its first step. The step's gathered
    leaves against the plain all-gather of the held shards (hpZ alone:
    EQUAL), or against the world-1 composition of ``quantize_int8`` /
    ``dequantize_int8`` on the shards the int8 hop carries (qwZ: each
    secondary shard, the concatenation of the primaries ``o h + i``, or
    each primary when the gather is flat: EQUAL). Under qgZ, one
    micro-batch's gradients of the stacked ``wq`` and ``w_gate``: the
    reduced shard EQUAL to the mean of the dequantized chunks every rank
    sends this one."""
    from deepspeedsyclsupport_tpu_torch.comm import comm
    from deepspeedsyclsupport_tpu_torch.comm.quantized import _block_quant
    from deepspeedsyclsupport_tpu_torch.compression.quantize import (
        dequantize_int8)
    from deepspeedsyclsupport_tpu_torch.runtime import zeropp

    zpp = eng._zeropp
    n, h = zpp.n, zpp.h
    group, _, _ = comm._resolve("fsdp")
    r = eng.topology.axis_index("fsdp")

    def composed(x):
        q, s, pad = _block_quant(x, 256)
        d = dequantize_int8(q, s, 256, torch.float32)
        return (d[:-pad] if pad else d).reshape(x.shape)

    out = {"leaves": 0, "gathered_equal": 0, "reduced": 0,
           "reduced_equal": 0}
    with torch.no_grad():
        full = zpp.gather()
        for leaf, f in zip(zpp.leaves, full):
            if leaf.k is None:
                continue
            moved = zpp._local(leaf).movedim(leaf.k, 0).contiguous()
            prim = comm._gather_stacked(group, n, moved)
            if not zpp.qw:
                want = prim.reshape(f.shape)
            elif 1 < h < n:
                want = torch.empty_like(prim)
                for i in range(h):
                    sec = torch.cat([prim[o * h + i]
                                     for o in range(n // h)])
                    deq = composed(sec).reshape((n // h,) + moved.shape)
                    for o in range(n // h):
                        want[o * h + i] = deq[o]
                want = want.reshape(f.shape)
            else:
                want = torch.stack([composed(p) for p in prim]).reshape(
                    f.shape)
            out["leaves"] += 1
            out["gathered_equal"] += int(torch.equal(f, want))
    if zpp.qg:
        for f in full:
            f.requires_grad_(True)
        mb = eng._micro_batches(batch, eng.gradient_accumulation_steps())[0]
        with eng._local_loss():
            loss, _ = eng._loss_and_metrics(zpp.params_tree(full), mb,
                                            gathered=True)
        loss.backward()
        names = [("layers",) + p[2:] if p[0] == "layers" else p
                 for p in (eng._float_paths[lf.idxs[0]]
                           for lf in zpp.leaves)]
        for name, leaf, f in zip(names, zpp.leaves, full):
            if name not in (("layers", "attn", "wq"),
                            ("layers", "mlp", "w_gate")):
                continue
            g = f.grad
            got = zeropp.reduce_leaf(g, True)
            chunks = comm._gather_stacked(group, n, g).reshape(n, n, -1)[:, r]
            want = torch.stack([composed(c) for c in chunks]).mean(
                dim=0).reshape(got.shape).to(g.dtype)
            out["reduced"] += 1
            out["reduced_equal"] += int(torch.equal(got, want))
    del full
    return out


def dist_optimizers_card_vs_cpu(torch, np):
    """(e4): each optimizer beyond Adam for ``DIST_OPT_STEPS`` steps on the
    card and on the CPU from the same seeded params and gradients (two
    layers of ``TRAIN_MODEL``'s ``wq`` and attention norm, the layers of
    each one leaf): params and every state tensor held within
    ``DIST_OPT_TOL`` of the tensor's largest magnitude, at most a
    ``DIST_OPT_FLIPS`` share of elements outside it."""
    from deepspeedsyclsupport_tpu_torch import build_model
    from deepspeedsyclsupport_tpu_torch.runtime.optimizers import (
        LeafStats, build_optimizer)

    cfg = build_model(TRAIN_MODEL).config
    d = cfg.hidden_size
    shapes = [(d, d), (d,)] * 2
    rng = np.random.RandomState(11)
    init = [0.02 * rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[0.01 * rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(DIST_OPT_STEPS)]
    group = [0, 1, 0, 1]
    sizes = [2 * math.prod(s) for s in shapes[:2]]
    paths = [("layers", "attn", "wq"), ("layers", "attn_norm", "scale")] * 2
    rows = {}
    for kind, extra in DIST_OPT_CASES:
        runs = {}
        t_card = 0.0
        for dev in (DEV, "cpu"):
            params = [torch.from_numpy(x).to(dev) for x in init]
            opt = build_optimizer(kind, dict(lr=1e-3, **extra))
            opt.init(params, paths, LeafStats(group, sizes))
            card = dev == DEV and torch.cuda.is_available()
            if card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for g in grads:
                opt.step([torch.from_numpy(x).to(dev) for x in g])
            if card:
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t0
            state = {f"param{i}": p for i, p in enumerate(params)}
            for k, v in vars(opt).items():
                if isinstance(v, list) and v and isinstance(
                        v[0], torch.Tensor) and k != "params":
                    state.update({f"{k}{i}": t for i, t in enumerate(v)})
                elif isinstance(v, torch.Tensor):
                    state[k] = v
            runs[dev] = {k: v.detach().cpu() for k, v in state.items()}
        worst, flips, total = 0.0, 0, 0
        for k, want in runs["cpu"].items():
            got = runs[DEV][k]
            scale = float(want.abs().max()) or 1.0
            off = (got - want).abs() / scale
            flips += int((off > DIST_OPT_TOL).sum())
            total += want.numel()
            worst = max(worst, float(off.max()))
        rows[kind] = {"worst": worst, "off": flips, "elements": total,
                      "card_ms_a_step": round(
                          t_card * 1e3 / DIST_OPT_STEPS, 2)}
        if flips > DIST_OPT_FLIPS * total:
            raise AssertionError(f"(e4) {kind}: {flips} of {total} elements "
                                 f"off the CPU's by > {DIST_OPT_TOL} "
                                 f"(worst {worst})")
    return rows


def dist_zeropp(torch, np):
    """Phase ``dist`` (e): ZeRO++ and the 1-bit optimizers. (e4) each new
    optimizer on the card against the CPU; (e3) 1-bit Adam and 1-bit LAMB
    at ZeRO-2 through the distributed engine at a world of one on NCCL
    (the references); then four ranks over gloo with ``DIST_ZPP_TWINS``:
    (e1) hpZ alone against plain ZeRO-3 (gathered leaves EQUAL to the
    plain gather, losses and grad norms within ``DIST_ZPP_TOL``), (e2)
    qwZ + qgZ + hpZ in bf16 (gathered leaves and reduced shards EQUAL to
    their world-1 compositions, ZeRO++ bytes EQUAL to the plan, 3 finite
    falling losses), (e3) against the references within
    ``DIST_ONEBIT_TOL`` (loss, grad norm, each tensor's update norm).
    Every twin's flash launches EQUAL to the plan. Returns (e)'s flash
    launches."""
    import tempfile

    from deepspeedsyclsupport_tpu_torch import comm, initialize
    from deepspeedsyclsupport_tpu_torch.comm.topology import (
        reset_world_topology)
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa

    t_e = time.perf_counter()
    launches = {k: 0 for k in fa.LAUNCHES}
    opt_rows = dist_optimizers_card_vs_cpu(torch, np)
    log("dist", f"(e4) each optimizer beyond Adam, {DIST_OPT_STEPS} steps on "
        f"the card vs the CPU (worst relative, elements off, ms a step on "
        f"the card): {opt_rows}")
    # ---- (e3) world-1 NCCL references
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{free_port()}",
                          world_size=1, rank=0, device_type=DEV)
    refs = {}
    for name in DIST_ONEBIT:
        cfg, dtype, over = DIST_ZPP_TWINS[name]
        model = dist_model(dtype)
        params = model.init_params(generator=torch.Generator(
            device=DEV).manual_seed(1), device=DEV)
        eng = initialize(model=model, params=params,
                         config=dist_reference_config(cfg), device=DEV)[0]
        del params
        p0 = [t.detach().clone() for t in eng._leaf_tensors]
        batch = {k: torch.from_numpy(v).to(DEV) for k, v in dist_batch(
            np, model.config.vocab_size).items()}
        steps = []
        for _ in range(over["steps"]):
            m = eng.train_batch(batch)
            steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"])})
        refs[name] = (steps, [float((t.detach() - p).norm())
                              for t, p in zip(eng._leaf_tensors, p0)])
        del eng, p0
        reset_world_topology()
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    comm.destroy_process_group()
    log("dist", f"(e3) world-1 NCCL references ({TRAIN_MODEL} widths, "
        f"{DIST_LAYERS} layers, fp32): "
        f"{ {k: v[0] for k, v in refs.items()} }")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = spawn_dist_ranks(
            {"device": DEV, "twins": DIST_ZPP_TWINS,
             "steps": DIST_STEPS,
             "layers": DIST_LAYERS, "seq": DIST_SEQ, "model": TRAIN_MODEL,
             "plan": "zeropp"}, d)
        wall = time.perf_counter() - t0
    log("dist", f"(e) {DIST_WORLD} ranks, backend {ranks[0]['backend']}; "
        f"ranks ran in {wall:.1f} s")
    hold_zeropp_twins(ranks, refs, launches)
    log("dist", f"(e) took {time.perf_counter() - t_e:.1f} s; flash "
        f"launches on its legs {launches}")
    return launches


def hold_zeropp_twins(ranks, refs, launches):
    """Hold (e1)-(e3) (see :func:`dist_zeropp`); adds each twin's flash
    launches to ``launches`` and logs each twin."""
    def steps_of(r, name):
        return [(x["loss"], x["grad_norm"]) for x in
                r["twins"][name]["steps"]]

    def rel(a, b):
        return abs(a - b) / abs(b)

    for name in DIST_ZPP_TWINS:
        r0 = ranks[0]["twins"][name]
        if any(steps_of(r, name) != steps_of(ranks[0], name)
               for r in ranks[1:]):
            raise AssertionError(f"{name}: ranks report different global "
                                 f"numbers")
        for r in ranks:
            t = r["twins"][name]
            ch = t["checks"]
            if ch and (ch["gathered_equal"] != ch["leaves"]
                       or ch["reduced_equal"] != ch["reduced"]):
                raise AssertionError(f"{name} rank {r['rank']}: checks {ch}")
            for i, st in enumerate(t["steps"]):
                if "zeropp" in name:
                    got = {k: v for k, v in st["bytes"].items()
                           if k.startswith("zeropp")}
                    if got != st["want_bytes"]:
                        raise AssertionError(
                            f"{name} rank {r['rank']} step {i + 1}: ZeRO++ "
                            f"bytes {got} != plan {st['want_bytes']}")
                # (the plain versions run on a rehearsal's CPU ranks)
                if DEV == "cuda" and st["launches"] != st["want_launches"]:
                    raise AssertionError(
                        f"{name} rank {r['rank']}: flash launches "
                        f"{st['launches']}, want {st['want_launches']}")
                for k, v in st["launches"].items():
                    launches[k] += v
        steps = r0["steps"]
        if not all(x["finite"] and math.isfinite(x["loss"]) for x in steps):
            raise AssertionError(f"{name}: {steps}")
        held = ""
        if name == "zeropp_hpz2_fsdp4":
            want = ranks[0]["twins"]["zero3_fsdp4"]["steps"]
            worst = {k: max(rel(g[k], w[k]) for g, w in zip(steps, want))
                     for k in DIST_ZPP_TOL}
            if any(worst[k] > DIST_ZPP_TOL[k] for k in worst):
                raise AssertionError(f"{name} vs plain ZeRO-3: worst "
                                     f"{worst} > {DIST_ZPP_TOL}")
            held = f"vs plain ZeRO-3 worst relative {worst}"
        elif "qwz" in name:
            losses = [x["loss"] for x in steps]
            if any(b >= a for a, b in zip(losses, losses[1:])):
                raise AssertionError(f"{name}: losses {losses} not falling")
            held = "losses falling"
        elif name in refs:
            ref, ref_delta = refs[name]
            worst = max(max(rel(g[k], w[k]) for k in ("loss", "grad_norm"))
                        for g, w in zip(steps, ref))
            worst_d = max(rel(a, b) for a, b in zip(r0["delta"], ref_delta)
                          if b)
            if worst > DIST_ONEBIT_TOL or worst_d > DIST_ONEBIT_TOL:
                raise AssertionError(
                    f"{name} vs world 1: worst relative {worst} (loss, "
                    f"grad_norm), {worst_d} (update norms) > "
                    f"{DIST_ONEBIT_TOL}")
            held = (f"vs world 1 worst relative {worst} (loss, grad_norm), "
                    f"{worst_d} (each tensor's update norm)")
        per_rank = " | ".join(
            f"rank {r['rank']}: peak {r['twins'][name]['peak'] / 2**30:.2f}"
            f" GiB, ms/step "
            f"{[round(x['s'] * 1e3, 1) for x in r['twins'][name]['steps']]}"
            f", checks {r['twins'][name]['checks']}" for r in ranks)
        log("dist", f"(e) {name} {r0['sizes']}: (loss, grad_norm) "
            f"{[(x['loss'], x['grad_norm']) for x in steps]}; {held}; rank "
            f"0 bytes a step {steps[-1]['bytes']}, ZeRO++ plan "
            f"{steps[-1]['want_bytes']}; flash launches a step "
            f"{steps[-1]['launches']}; {per_rank}")


P2P_OPS = ("send", "recv", "all_to_all", "ppermute")


def hold_dist_twins(label, twins, ranks, refs, launches, tols, full_plan):
    """Hold each twin's ranks: the same global numbers on every rank;
    against its world-1 run (finite, scale and skips EQUAL; loss and
    grad_norm within ``TRAIN_PARITY_TOL`` or ``tols[dtype]``); a rank's
    bytes a step EQUAL to the plan (``full_plan``: every collective; else
    the point-to-point and all-to-all ops); its flash launches a step EQUAL
    to :func:`dist_flash_per_step`'s. Adds the launches to ``launches``
    and logs each twin."""
    for name, (cfg_t, dtype, *_) in twins.items():
        ref, ref_skipped = refs[name] if name in refs else refs[dtype]
        r0 = ranks[0]["twins"][name]
        for r in ranks[1:]:
            if [(x["loss"], x["grad_norm"]) for x in r["twins"][name][
                    "steps"]] != [(x["loss"], x["grad_norm"])
                                  for x in r0["steps"]]:
                raise AssertionError(f"{name}: ranks report different "
                                     f"global numbers")
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for g, w in zip(r0["steps"], ref):
            if (g["finite"], g["scale"]) != (w["finite"], w["scale"]):
                raise AssertionError(f"{name}: finite / scale {g} vs {w}")
            for k in worst:
                if w["finite"]:
                    worst[k] = max(worst[k], abs(g[k] - w[k]) / abs(w[k]))
        tol = tols.get(dtype, TRAIN_PARITY_TOL)
        if r0["skipped"] != ref_skipped or \
                any(worst[k] > tol[k] for k in tol):
            raise AssertionError(f"{name}: {r0['steps']} vs world 1 {ref} "
                                 f"(skipped {r0['skipped']} vs "
                                 f"{ref_skipped}): worst {worst} > {tol}")
        for r in ranks:
            for i, st in enumerate(r["twins"][name]["steps"]):
                got = st["bytes"] if full_plan else {
                    k: v for k, v in st["bytes"].items()
                    if k.split("[")[0] in P2P_OPS}
                if got != st["want_bytes"]:
                    raise AssertionError(
                        f"{name} rank {r['rank']} step {i + 1}: collective "
                        f"bytes {got} != plan {st['want_bytes']}")
                if st["launches"] != st["want_launches"]:
                    raise AssertionError(
                        f"{name} rank {r['rank']}: flash launches "
                        f"{st['launches']}, want {st['want_launches']}")
                for k, v in st["launches"].items():
                    launches[k] += v
        per_rank = " | ".join(
            f"rank {r['rank']}: peak {r['twins'][name]['peak'] / 2**30:.2f}"
            f" GiB (predicted {r['twins'][name]['predicted'] / 2**30:.2f}),"
            f" {r['twins'][name]['stage_layers']} layers, "
            f"{r['twins'][name]['local_params'] / 1e6:.1f}M of "
            f"{r['twins'][name]['n_params'] / 1e6:.1f}M params held, ms/step"
            f" {[round(x['s'] * 1e3, 1) for x in r['twins'][name]['steps']]}"
            f", flash launches a step {r['twins'][name]['steps'][-1]['launches']}"
            f", staged {r['twins'][name]['staged']}" for r in ranks)
        held = "" if full_plan else " (send / recv / all_to_all / ppermute)"
        log("dist", f"{label} {name} {r0['sizes']}: (loss, grad_norm, "
            f"finite, scale) {[(x['loss'], x['grad_norm'], x['finite'], x['scale']) for x in r0['steps']]}"
            f" vs world 1 {[(x['loss'], x['grad_norm'], x['finite'], x['scale']) for x in ref]};"
            f" skipped {r0['skipped']} vs {ref_skipped}; worst relative "
            f"{worst} (tol {tol}); rank 0 collective bytes a step "
            f"{r0['steps'][-1]['bytes']}, plan{held} "
            f"{r0['steps'][-1]['want_bytes']}; {per_rank}")


def main() -> int:
    import numpy as np
    import torch

    if sys.argv[1:] == ["--rehearse"]:
        if not torch.cuda.is_available():
            return 2
        rehearse_child(torch, np)
        return 0
    if sys.argv[1:2] == ["--dist-rank"]:
        with open(sys.argv[2]) as f:
            if json.load(f)["device"] == "cuda" and \
                    not torch.cuda.is_available():
                return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist_rank_child(torch, np, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--preempt-child"]:
        if not torch.cuda.is_available():
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        preempt_child(torch, np, *sys.argv[2:4])
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

    phase_s, phase_left = {}, {}

    def run(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        name = fn.__name__[len("phase_"):]
        phase_s[name] = round(time.perf_counter() - t, 1)
        # a phase's objects may sit in reference cycles until the collector
        # runs, and when it runs depends on the threads' timing: collect
        # here, so that every phase starts from what is really live
        left = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        phase_left[name] = (round(left / 2**30, 2),
                            round(torch.cuda.memory_allocated() / 2**30, 2))
        return out

    run(phase_build, _build)
    run(phase_rehearse)
    rows = run(phase_kernels, torch, np)
    flash_rows = run(phase_flash, torch, np)
    lse_launches = run(phase_flash_lse, torch, np)
    model, params = serve_params(torch)
    launches, serve_outs = run(phase_serve, torch, np, model, params)
    run(phase_serve_fused, torch, np, model, params, serve_outs)
    run(phase_prefix, torch, np, model, params)
    run(phase_flash_prefill, torch, np, model, params, serve_outs)
    run(phase_session, torch, np, model, params)
    run(phase_session_parity, torch, np)
    run(phase_supervise, torch, np)
    run(phase_snapshot, torch, np)
    del model, params
    torch.cuda.empty_cache()
    run(phase_fleet, torch, np)
    run(phase_mixtral, torch, np)
    run(phase_serve_fp16, torch, np)
    train_launches, train_steps = run(phase_train, torch, np)
    launches.update(train_launches)
    run(phase_train_resume, torch, np)
    run(phase_preempt, torch, np)
    run(phase_sentinel, torch, np)
    run(phase_parity, torch, np)
    run(phase_train_parity, torch, np)
    moe_launches, moe_steps = run(phase_train_moe, torch, np)
    evo_rows, evo_launches = run(phase_evoformer, torch, np)
    run(phase_sparse, torch, np)
    dist_launches, ps_launches, moe_dist_launches, zpp_launches = run(
        phase_dist, torch, np, train_steps, moe_steps)

    log("phases", f"GiB allocated on the card after each phase (before, "
        f"after the collector) {phase_left}")
    log("phases", f"seconds per phase {phase_s}; flash launches on the "
        f"train-moe path {moe_launches}, on the flash-lse phase "
        f"{lse_launches}, on the dist path {dist_launches}, on its pipeline "
        f"and sequence-parallel legs {ps_launches}, on its MoE legs "
        f"{moe_dist_launches}, on its ZeRO++ and 1-bit legs {zpp_launches}")
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
            "library_ms": main_row["library"][name],
            "launches_dist": dist_launches[name],
            "launches_dist_pipe_seq": ps_launches[name],
            "launches_dist_moe": moe_dist_launches[name],
            "launches_dist_zeropp": zpp_launches[name]})
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
