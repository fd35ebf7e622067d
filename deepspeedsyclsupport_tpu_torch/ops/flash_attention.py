"""Flash attention: the CUDA kernels' wrappers, plain versions and autograd.

Port of ``deepspeedsyclsupport_tpu/ops/flash_attention.py``. The TPU kernels
``_fwd_kernel`` (:145), ``_dq_kernel`` (:208), ``_dkv_kernel`` (:273) and
``_dbias_kernel`` (:330) are replaced by the hand-written CUDA kernels in
``csrc/flash_attention.cu``, wired as a ``torch.autograd.Function`` as the
JAX package wires them as a ``jax.custom_vjp`` (:646-693).

* :func:`flash_attention` — the public function, layout ``[B, S, H, D]`` /
  ``[B, Skv, KVH, D]`` as in the JAX package (:752). Differentiable,
  including the additive pair ``bias`` (the evoformer pair bias); the k-row
  bias and the block-sparse layout ride along, non-differentiable. With
  ``return_lse=True`` it also returns the LSE ``[B, Sq, H]`` float32, both
  differentiable (the block combiner ring attention needs; JAX :696-734):
  the backward runs the same kernels with ``delta - dlse`` in delta's
  slot.
* :func:`flash_attention_fwd` / :func:`flash_attention_bwd` — the wrappers.
  A CUDA tensor launches the kernels (or raises); a CPU tensor takes the
  plain versions. There is no other fallback.
* :func:`flash_attention_fwd_reference` / :func:`flash_attention_bwd_reference`
  / :func:`flash_dbias_reference` — the plain PyTorch versions: exact
  attention in float32 returning ``(o, lse)``, the flash-2 backward
  formulas of ``_dq_kernel`` / ``_dkv_kernel`` from the saved ``lse`` and
  ``delta``, and the pair-bias gradient reduced over the (batch, head)
  replicas that share each bias entry. All loop over blocks of query rows
  so that long sequences fit in memory.
* :data:`LAUNCHES` — how many times each kernel was launched; only a launch
  counts, never a CPU call.
* The work each launch did, reported to the active op counter
  (``profiling/flops_profiler.report_kernel``), which no dispatch mode
  could see through ``ctypes``: FLOPs counted as the plain versions'
  products count them (:data:`PLAIN_PRODUCTS`, dense ``2·Sq·Skv·D`` each
  per batch and q head, so the count is the same whichever runs), the
  bytes of each input read once and each output written once, and the
  visible (query, key) pairs (:func:`visible_pairs`). A CPU call reports
  nothing: the counter counts its plain version's ops itself.
* Routes on the card, decided in the library before launch
  (:func:`kernel_name`): bfloat16 and float16 take the Hopper kernels
  (wgmma products, TMA loads) for the forward at every head dim and for dQ,
  dK/dV and the reducing dbias at D <= 128; float32, and dQ, dK/dV and
  dbias above D = 128, the CUDA-core ones. TMA reads an operand in place when :func:`tma_ready` says
  so; otherwise the wrapper copies it first and counts the copy in
  :data:`COPIES` under the kernel's name.
"""
import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_dbias": 0}
# operands each wrapper copied because TMA could not read them in place
COPIES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_dbias": 0}

# elements of one [B, H, rows, Skv] score block in the plain versions
_REF_BLOCK_ELEMS = 1 << 26


# products of the plain versions each kernel is billed: the forward's QK^T
# and PV; dQ the backward's recomputed QK^T and dO V^T and dS K
# (flash_attention_bwd_reference computes the first two once for both
# kernels); dK/dV dS^T Q and P^T dO; the reducing dbias the recomputed
# QK^T and dO V^T of flash_dbias_reference (which dQ is billed too when it
# writes a full-shape pair bias's gradient)
PLAIN_PRODUCTS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 2,
                  "flash_dbias": 2}


def visible_pairs(mask: "Mask", b: int, h: int, sq: int,
                  skv: int) -> Optional[int]:
    """(query, key) pairs the mask lets through, over every batch and q
    head, from the shapes alone (query row i at position ``i + Skv - Sq``);
    None when they depend on data (segments, positions, a block layout)."""
    if mask.seg_q is not None or mask.pos_q is not None or \
            mask.pos_k is not None or mask.layout is not None:
        return None
    if not mask.causal:
        return b * h * sq * skv
    total = 0
    for i in range(sq):
        pq = i + skv - sq
        hi = min(pq, skv - 1)
        lo = 0 if mask.window is None else max(0, pq - mask.window + 1)
        total += max(0, hi - lo + 1)
    return b * h * total


def _report(counter: str, q, k, mask: "Mask", tensors,
            extra_products: int = 0) -> None:
    """Report one launch's work to the active op counter (if any):
    ``tensors`` are its inputs and outputs, each moved once."""
    from ..profiling import flops_profiler

    if flops_profiler.active_counter() is None:
        return
    b, sq, h, d = q.shape
    skv = k.shape[1]
    flops = 2.0 * (PLAIN_PRODUCTS[counter] + extra_products) \
        * b * h * sq * skv * d
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    flops_profiler.report_kernel(counter, flops, float(nbytes),
                                 visible_pairs(mask, b, h, sq, skv))


def reset_launch_counts() -> None:
    """Zero :data:`LAUNCHES` and :data:`COPIES`."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in COPIES:
        COPIES[name] = 0


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Mask(NamedTuple):
    """What decides which (query, key) pairs are visible and what is added
    to their scores, apart from the differentiable pair bias, normalised:
    int32 ``[B, S]`` tensors (or None for the defaults), ALiBi slopes
    float32 ``[H]`` (or None), the window (None for none), the k-row bias
    float32 ``[Bk, Skv]`` (or None), the block layout int32 ``[Hl, nq,
    nkv]`` (or None) and its block sizes ``(block_q, block_k)``."""
    causal: bool
    seg_q: Optional[torch.Tensor]
    seg_k: Optional[torch.Tensor]
    pos_q: Optional[torch.Tensor]
    pos_k: Optional[torch.Tensor]
    alibi: Optional[torch.Tensor]
    window: Optional[int]
    k_bias: Optional[torch.Tensor] = None
    layout: Optional[torch.Tensor] = None
    layout_block: Tuple[int, int] = (0, 0)


def make_mask(q, k, causal: bool = True, segment_ids=None,
              kv_segment_ids=None, q_positions=None, kv_positions=None,
              alibi=None, window: Optional[int] = None, k_bias=None,
              block_layout=None, block_q: int = 512,
              block_k: int = 512) -> Mask:
    """Check and normalise the masking arguments as the JAX public function
    does (:794-898): ``kv_segment_ids`` needs ``segment_ids``; bare
    ``segment_ids`` need Sq == Skv; ``window`` needs ``causal``; ``k_bias``
    is ``[Bk, Skv]`` with ``Bk | B``; ``block_layout`` is ``[1|H, nq, nkv]``
    over blocks of ``min(block, round_up(S, 128))`` rows and columns, the
    JAX function's clamp, so that the same call gives the same mask."""
    if window is not None and not causal:
        # the window bound is one-sided (pos_q - pos_k < window): without
        # causality it would permit unbounded attention to the future
        raise ValueError("window requires causal=True (the sliding window "
                         "only bounds attention to the past)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    dev = q.device

    def ids(t, n, name):
        t = torch.as_tensor(t, device=dev).to(torch.int32)
        if t.shape != (b, n):
            raise ValueError(f"{name} must be [{b}, {n}], got "
                             f"{tuple(t.shape)}")
        return t.contiguous()

    seg_q = seg_k = None
    if kv_segment_ids is not None:
        if segment_ids is None:
            raise ValueError("kv_segment_ids needs segment_ids [B,Sq] and "
                             "kv_segment_ids [B,Skv]")
        seg_q = ids(segment_ids, sq, "segment_ids")
        seg_k = ids(kv_segment_ids, skv, "kv_segment_ids")
    elif segment_ids is not None:
        if sq != skv:
            raise ValueError("segment_ids requires Sq == Skv == ids length")
        seg_q = seg_k = ids(segment_ids, sq, "segment_ids")
    pos_q = None if q_positions is None else ids(q_positions, sq,
                                                 "q_positions")
    pos_k = None if kv_positions is None else ids(kv_positions, skv,
                                                  "kv_positions")
    slopes = None
    if alibi is not None:
        slopes = torch.as_tensor(alibi, device=dev).to(
            torch.float32).reshape(-1).contiguous()
        if slopes.shape != (h,):
            raise ValueError(f"alibi slopes must be [{h}], got "
                             f"{tuple(slopes.shape)}")
    kb = None
    if k_bias is not None:
        kb = torch.as_tensor(k_bias, device=dev).detach()
        if kb.dim() != 2 or kb.shape[1] != skv or kb.shape[0] < 1 or \
                b % kb.shape[0]:
            raise ValueError(f"k_bias shape {tuple(kb.shape)} incompatible "
                             f"with kv ({b},{skv})")
        kb = kb.to(torch.float32).contiguous()
    layout, blocks = None, (0, 0)
    if block_layout is not None:
        blocks = (min(int(block_q), round_up(sq, 128)),
                  min(int(block_k), round_up(skv, 128)))
        nq_b, nkv_b = -(-sq // blocks[0]), -(-skv // blocks[1])
        layout = torch.as_tensor(block_layout, device=dev)
        if (layout.dim() != 3 or layout.shape[0] not in (1, h)
                or tuple(layout.shape[1:]) != (nq_b, nkv_b)):
            raise ValueError(
                f"block_layout shape {tuple(layout.shape)} must be "
                f"[1|{h}, {nq_b}, {nkv_b}] for the padded block grid")
        layout = layout.to(torch.int32).contiguous()
    return Mask(bool(causal), seg_q, seg_k, pos_q, pos_k, slopes,
                None if window is None else int(window), kb, layout, blocks)


def check_bias(bias, q, k) -> torch.Tensor:
    """The pair bias ``[Bb, Hb, Sq, Skv]`` with ``Bb | B`` and ``Hb | H``
    (broadcast over contiguous groups of batches and heads), checked as the
    JAX public function does (:865-869); returned as float32, contiguous and
    detached, the form the kernels and plain versions take."""
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    if bias.dim() != 4 or tuple(bias.shape[2:]) != (sq, skv) or \
            min(bias.shape[:2]) < 1 or b % bias.shape[0] or h % bias.shape[1]:
        raise ValueError(f"bias shape {tuple(bias.shape)} incompatible with "
                         f"q/kv ({b},{h},{sq},{skv})")
    return bias.detach().to(device=q.device,
                            dtype=torch.float32).contiguous()


def is_broadcast(bias, q) -> bool:
    """Whether the pair bias is shared by several batches or heads (its
    gradient then needs the reducing kernel)."""
    return bias.shape[0] < q.shape[0] or bias.shape[1] < q.shape[2]


# ------------------------------------------------------------------ reference
def _block_rows(b, h, sq, skv) -> int:
    return max(1, min(sq, _REF_BLOCK_ELEMS // max(1, b * h * skv)))


def _expand_bias(bias, b, h, kvh, r0, r1):
    """Rows [r0, r1) of the pair bias for every (batch, q head): ``[B, KVH,
    G, rows, Skv]``; batch i reads bias batch i // (B / Bb), head j bias head
    j // (H / Hb), the JAX index maps (:461-464)."""
    bb, hb, _, skv = bias.shape
    x = bias[:, None, :, None, r0:r1].expand(bb, b // bb, hb, h // hb,
                                             r1 - r0, skv)
    return x.reshape(b, kvh, h // kvh, r1 - r0, skv)


def _scores(q, k, m: Mask, r0: int, r1: int, bias=None):
    """Scaled (+ALiBi, +pair bias, +k-row bias) scores and the visibility
    mask (with the block layout) for query rows [r0, r1): ``s`` [B, KVH, G,
    rows, Skv] float32, ``mask`` broadcastable to it. GQA groups q heads as
    ``h = kv_head * G + g``. ``bias``: float32 ``[Bb, Hb, Sq, Skv]``."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    qb = q[:, r0:r1].float().reshape(b, r1 - r0, kvh, g, d)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qb, k.float()) / math.sqrt(d)
    if m.pos_q is None:
        pq = (torch.arange(r0, r1, device=dev) + (skv - sq))[None].expand(
            b, -1)
    else:
        pq = m.pos_q[:, r0:r1].long()
    pk = (torch.arange(skv, device=dev)[None].expand(b, -1)
          if m.pos_k is None else m.pos_k.long())
    pq = pq[:, None, None, :, None]                     # [B,1,1,rows,1]
    pk = pk[:, None, None, None, :]                     # [B,1,1,1,Skv]
    if m.alibi is not None:
        slope = m.alibi.reshape(kvh, g)[None, :, :, None, None]
        s = s + slope * (pk - pq).float()
    if bias is not None:
        s = s + _expand_bias(bias, b, h, kvh, r0, r1)
    if m.k_bias is not None:
        s = s + m.k_bias.repeat_interleave(b // m.k_bias.shape[0], 0)[
            :, None, None, None, :]
    mask = torch.ones((), dtype=torch.bool, device=dev)
    if m.causal:
        mask = mask & (pk <= pq)
    if m.window is not None:
        mask = mask & (pq - pk < m.window)
    if m.seg_q is not None:
        mask = mask & (m.seg_q[:, r0:r1][:, None, None, :, None]
                       == m.seg_k[:, None, None, None, :])
    if m.layout is not None:
        bq, bk = m.layout_block
        lay = m.layout[:, torch.arange(r0, r1, device=dev) // bq][
            :, :, torch.arange(skv, device=dev) // bk] != 0
        lay = (lay.reshape(1, kvh, g, r1 - r0, skv) if lay.shape[0] > 1
               else lay[None, None])
        mask = mask & lay
    return s, mask


def flash_attention_fwd_reference(q, k, v, mask: Mask, bias=None):
    """Exact attention in float32. Returns ``(o, lse)``: o [B, Sq, H, D] in
    q's dtype, lse [B, H, Sq] float32 = m + log(max(l, 1e-30)) with m the
    row max over visible scores, at least -1e30: a row with nothing visible
    (or only -inf biases) gets o = 0 and lse ~ -1e30, as the kernel does.
    ``bias``: float32 ``[Bb, Hb, Sq, Skv]`` (see :func:`check_bias`)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    vf = v.float()
    step = _block_rows(b, h, sq, skv)
    for r0 in range(0, sq, step):
        r1 = min(sq, r0 + step)
        s, vis = _scores(q, k, mask, r0, r1, bias)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        mx = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.where(vis, torch.exp(s - mx), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        ob = torch.einsum("bkgqj,bjkd->bqkgd", p, vf) \
            / l.permute(0, 3, 1, 2, 4)
        o[:, r0:r1] = ob.reshape(b, r1 - r0, h, d).to(q.dtype)
        lse[:, :, r0:r1] = (mx + torch.log(l)).reshape(b, h, r1 - r0)
    return o, lse


def _probs(q, k, vf, do, lse, delta, mask: Mask, bias, r0: int, r1: int):
    """``p = where(visible, exp(s - lse), 0)`` and ``ds = p * (dO V^T -
    delta)`` [B, KVH, G, rows, Skv] for query rows [r0, r1), and those rows
    of dO as float32 [B, rows, KVH, G, D]."""
    b, _, h, d = q.shape
    kvh = k.shape[2]
    g, n = h // kvh, r1 - r0
    s, vis = _scores(q, k, mask, r0, r1, bias)
    lse_b = lse[:, :, r0:r1].reshape(b, kvh, g, n, 1)
    dl_b = delta[:, :, r0:r1].reshape(b, kvh, g, n, 1)
    p = torch.where(vis, torch.exp(s - lse_b), torch.zeros_like(s))
    dob = do[:, r0:r1].float().reshape(b, n, kvh, g, d)
    dp = torch.einsum("bqkgd,bjkd->bkgqj", dob, vf)
    return p, p * (dp - dl_b), dob


def flash_attention_bwd_reference(q, k, v, do, lse, delta, mask: Mask,
                                  parts: str = "all", bias=None):
    """The flash-2 backward of ``_dq_kernel``/``_dkv_kernel`` in float32:
    ``p = where(visible, exp(s - lse), 0)``, ``ds = p * (dO V^T - delta)``,
    ``dq = scale * ds K``, ``dk = scale * ds^T Q`` and ``dv = p^T dO``, the
    GQA group summed. lse/delta: [B, H, Sq] float32. Returns float32
    ``(dq, dk, dv)``; ``parts="dq"`` or ``"dkv"`` computes only those (the
    others are None). The pair bias's gradient is
    :func:`flash_dbias_reference`."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    want_dq, want_dkv = parts in ("all", "dq"), parts in ("all", "dkv")
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
        if want_dq else None
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device) \
        if want_dkv else None
    dv = torch.zeros_like(dk) if want_dkv else None
    step = _block_rows(b, h, sq, skv)
    for r0 in range(0, sq, step):
        r1 = min(sq, r0 + step)
        n = r1 - r0
        p, ds, dob = _probs(q, k, vf, do, lse, delta, mask, bias, r0, r1)
        if want_dq:
            dq[:, r0:r1] = (scale * torch.einsum(
                "bkgqj,bjkd->bqkgd", ds, kf)).reshape(b, n, h, d)
        if want_dkv:
            qb = q[:, r0:r1].float().reshape(b, n, kvh, g, d)
            dk += scale * torch.einsum("bkgqj,bqkgd->bjkd", ds, qb)
            dv += torch.einsum("bkgqj,bqkgd->bjkd", p, dob)
    return dq, dk, dv


def flash_dbias_reference(q, k, v, do, lse, delta, mask: Mask, bias):
    """The pair bias's gradient in float32, ``[Bb, Hb, Sq, Skv]``: ``ds``
    (the gradient of the scores, which the bias is added to) summed over
    the B / Bb batches and H / Hb heads that read each bias entry. For a
    full-shape bias that is ``ds`` itself, what ``_dq_kernel`` emits; for a
    broadcast one what ``_dbias_kernel`` accumulates."""
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    bb, hb = bias.shape[:2]
    vf = v.float()
    out = torch.empty((bb, hb, sq, skv), dtype=torch.float32, device=q.device)
    step = _block_rows(b, h, sq, skv)
    for r0 in range(0, sq, step):
        r1 = min(sq, r0 + step)
        _, ds, _ = _probs(q, k, vf, do, lse, delta, mask, bias, r0, r1)
        out[:, :, r0:r1] = ds.reshape(bb, b // bb, hb, h // hb, r1 - r0,
                                      skv).sum(dim=(1, 3))
    return out


# --------------------------------------------------------------------- kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_OPERANDS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
# pointer arguments before the strides: each kernel's own, then seg_q, seg_k,
# pos_q, pos_k, alibi, bias, kbias, layout
_PTRS = {"fwd": 13, "dq": 16, "dkv": 16, "dbias": 16}
_GRID_MAX = 65535     # the batch rides gridDim.z, the heads gridDim.y
# CTAs the reducing dbias kernels' replica chunks aim for, constants so that
# the chunk count, and with it the bits, follow from the shapes alone: the
# CUDA-core kernel's 64 x 64 tiles of 256 threads 16 deep on 132 SMs (the
# depth it was tuned at), flash_dbias_sm90_kernel's 128 x 64 tiles (one CTA
# of 384 threads an SM) about eight waves of 128
_DBIAS_CTAS = 16 * 132
_DBIAS_SM90_CTAS = 1024
_DBIAS_MAX_CHUNKS = 16


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.dsst_flash_fwd.argtypes is None:
        for kind, n_ptr in _PTRS.items():
            fn = getattr(lib, f"dsst_flash_{kind}")
            # + the strides and bias_dims arrays (pointers too)
            fn.argtypes = ([ctypes.c_void_p] * (n_ptr + 2)
                           + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.dsst_flash_error_string.argtypes = [ctypes.c_int]
        lib.dsst_flash_error_string.restype = ctypes.c_char_p
        lib.dsst_flash_kernel.argtypes = [ctypes.c_int] * 3
        lib.dsst_flash_kernel.restype = ctypes.c_char_p
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(q, k, v, mask: Mask, bias=None, **extra) -> None:
    """What the kernels take: CUDA tensors on one device, one floating type
    (float32, bfloat16, float16), ``[B, S, H, D]`` with a unit innermost
    stride, D <= 256, H a multiple of KVH, B and H at most 65535, a float32
    contiguous pair bias ``[Bb, Hb, Sq, Skv]`` with ``Bb | B``, ``Hb | H``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash-attention kernels run on CUDA tensors, "
                         f"got {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash-attention kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    named = dict(q=q, k=k, v=v, **extra)
    for name, t in named.items():
        if t.device != dev or t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, S, H, D] with a unit "
                             f"innermost stride, got shape {tuple(t.shape)} "
                             f"strides {t.stride()}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if h % k.shape[2] or not 0 < d <= 256:
        raise ValueError(f"head dim {d} (<= 256); {h} q heads over "
                         f"{k.shape[2]} kv heads")
    if b > _GRID_MAX or h > _GRID_MAX:
        raise ValueError(f"batch {b} and heads {h} must each be at most "
                         f"{_GRID_MAX} (the kernels' grid y and z)")
    for t in (mask.seg_q, mask.seg_k, mask.pos_q, mask.pos_k, mask.alibi,
              mask.k_bias, mask.layout):
        if t is not None and t.device != dev:
            raise ValueError(f"mask tensors must be on {dev}, got "
                             f"{t.device}")
    if bias is not None:
        if bias.device != dev or bias.dtype != torch.float32 or \
                not bias.is_contiguous():
            raise TypeError(f"bias must be contiguous float32 on {dev}, got "
                            f"{bias.dtype} on {bias.device}")
        check_bias(bias, q, k)


def _strides(**named) -> ctypes.Array:
    st = (ctypes.c_longlong * (3 * len(_OPERANDS)))()
    for i, name in enumerate(_OPERANDS):
        t = named.get(name)
        if t is not None:
            st[3 * i:3 * i + 3] = [t.stride(0), t.stride(1), t.stride(2)]
    return st


def _bias_dims(mask: Mask, bias, chunks: int = 1) -> ctypes.Array:
    """(Bb, Hb, Bk, Hl, nq, nkv, block_q, block_k, dbias chunks) for the C
    interface."""
    dims = (ctypes.c_int * 9)()
    dims[8] = chunks
    if bias is not None:
        dims[0:2] = [bias.shape[0], bias.shape[1]]
    if mask.k_bias is not None:
        dims[2] = mask.k_bias.shape[0]
    if mask.layout is not None:
        dims[3:8] = [*mask.layout.shape, *mask.layout_block]
    return dims


def _launch(kind: str, counter: str, ptrs, strides, q, k, mask: Mask,
            bias=None, chunks: int = 1):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    lib = _library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"dsst_flash_{kind}")(
            *ptrs, _ptr(mask.seg_q), _ptr(mask.seg_k), _ptr(mask.pos_q),
            _ptr(mask.pos_k), _ptr(mask.alibi), _ptr(bias),
            _ptr(mask.k_bias), _ptr(mask.layout), strides,
            _bias_dims(mask, bias, chunks), b, sq, skv, h, kvh, d,
            int(mask.causal),
            mask.window or 0, 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash-attention {kind} kernel launch failed: "
                           f"{lib.dsst_flash_error_string(rc).decode()} "
                           f"(cuda error {rc})")
    LAUNCHES[counter] += 1


def _out(t: Optional[torch.Tensor], like: torch.Tensor, name: str):
    """A caller's output tensor (any strides with a unit innermost one, so a
    view into a larger buffer works), or a new one shaped like ``like``."""
    if t is None:
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)
    if t.shape != like.shape or t.dtype != like.dtype or \
            t.device != like.device or t.stride(-1) != 1:
        raise ValueError(f"{name} must be {like.dtype} {tuple(like.shape)} on "
                         f"{like.device} with a unit innermost stride")
    return t


# the kernels that read q, k, v (and dO) through TMA (wgmma products)
_TMA_KERNELS = frozenset({"flash_fwd_sm90_kernel", "flash_dq_sm90_kernel",
                          "flash_dkv_sm90_kernel", "flash_dbias_sm90_kernel"})
_KINDS = {"fwd": 0, "dq": 1, "dkv": 2, "dbias": 3}


def kernel_name(kind: str, dtype: torch.dtype, d: int) -> str:
    """The kernel the built library launches for ``kind`` (``"fwd"``,
    ``"dq"``, ``"dkv"`` or ``"dbias"``), ``dtype`` and head dim ``d``, as
    the library reports it (the route is decided there, before launch):
    the ``*_sm90_kernel`` ones (wgmma + TMA) for a bfloat16 / float16
    forward and, at ``d <= 128``, dQ, dK/dV and dbias; the CUDA-core ones
    otherwise. Needs the CUDA build."""
    name = _library().dsst_flash_kernel(_KINDS[kind], _DTYPE_CODES[dtype],
                                        int(d))
    if name is None:
        raise ValueError(f"no flash kernel of kind {kind!r}")
    return name.decode()


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` (``[B, S, H, D]``, unit innermost stride)
    in place: a 16-byte aligned base, and the byte stride of each batch,
    sequence and head dimension with more than one entry a positive
    multiple of 16."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) > 0 and t.stride(i) * es % 16 == 0
        for i in range(3) if t.shape[i] > 1)


def tma_operand(t: torch.Tensor, counter: str = "flash_fwd") -> torch.Tensor:
    """``t`` itself when :func:`tma_ready`, else a copy in a new buffer
    whose rows are padded to a multiple of 8 elements (the view of its first
    D columns), counted in ``COPIES[counter]``."""
    if tma_ready(t):
        return t
    b, s, h, d = t.shape
    buf = torch.empty((b, s, h, round_up(d, 8)), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :d]
    view.copy_(t)
    COPIES[counter] += 1
    return view


def flash_fwd(q, k, v, mask: Mask, out: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None):
    """Launch the forward kernel (:func:`kernel_name`): ``(o [B,Sq,H,D], lse
    [B,H,Sq] float32)``; ``out`` optionally receives o. ``bias``: float32
    contiguous ``[Bb, Hb, Sq, Skv]``; the k-row bias and the layout come in
    ``mask``. Where that kernel reads by TMA, a q, k or v that TMA cannot
    read in place is copied first (:func:`tma_operand`)."""
    _check(q, k, v, mask, bias)
    o = _out(out, q, "out")
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    if not q.numel() or not k.shape[1]:     # nothing visible anywhere
        o.zero_()
        lse.fill_(NEG_INF)
        return o, lse
    if kernel_name("fwd", q.dtype, q.shape[3]) in _TMA_KERNELS:
        q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    _launch("fwd", "flash_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()), _strides(q=q, k=k, v=v, o=o), q, k, mask, bias)
    _report("flash_fwd", q, k, mask, (q, k, v, bias, o, lse))
    return o, lse


def _check_rows(q, lse, delta):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != want or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 {want} on "
                             f"{q.device}")


def flash_dq(q, k, v, do, lse, delta, mask: Mask,
             out: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             dbias: Optional[torch.Tensor] = None):
    """Launch the dQ kernel (:func:`kernel_name`); dq in q's dtype (float32
    accumulation). ``dbias``: optionally a contiguous float32 ``[B, H, Sq,
    Skv]`` that receives ``ds``, the gradient of a full-shape pair bias
    (zero where no score is visible). Where the kernel reads by TMA, a q, k,
    v or dO it cannot read in place is copied first (:func:`tma_operand`,
    counted in ``COPIES["flash_dq"]``)."""
    _check(q, k, v, mask, bias, do=do)
    _check_rows(q, lse, delta)
    dq = _out(out, q, "out")
    if dbias is not None:
        want = (q.shape[0], q.shape[2], q.shape[1], k.shape[1])
        if tuple(dbias.shape) != want or dbias.dtype != torch.float32 or \
                not dbias.is_contiguous() or dbias.device != q.device:
            raise ValueError(f"dbias must be contiguous float32 {want} on "
                             f"{q.device}")
        dbias.zero_()       # the kernel writes only the tiles it walks
    if not q.numel() or not k.shape[1]:
        return dq.zero_()
    if kernel_name("dq", q.dtype, q.shape[3]) in _TMA_KERNELS:
        q, k, v, do = (tma_operand(t, "flash_dq") for t in (q, k, v, do))
    _launch("dq", "flash_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(dbias)),
            _strides(q=q, k=k, v=v, do=do, dq=dq), q, k, mask, bias)
    _report("flash_dq", q, k, mask, (q, k, v, do, lse, delta, bias, dq,
                                     dbias),
            extra_products=0 if dbias is None else
            PLAIN_PRODUCTS["flash_dbias"])
    return dq


def flash_dkv(q, k, v, do, lse, delta, mask: Mask, out=(None, None),
              bias: Optional[torch.Tensor] = None):
    """Launch the dK/dV kernel (:func:`kernel_name`); group-summed dk, dv
    in k's dtype, every row written (zeros for keys no query sees). Where
    the kernel reads by TMA, a q, k, v or dO it cannot read in place is
    copied first (counted in ``COPIES["flash_dkv"]``)."""
    _check(q, k, v, mask, bias, do=do)
    _check_rows(q, lse, delta)
    dk, dv = _out(out[0], k, "out[0]"), _out(out[1], v, "out[1]")
    if not q.numel() or not k.numel():
        return dk.zero_(), dv.zero_()
    if kernel_name("dkv", q.dtype, q.shape[3]) in _TMA_KERNELS:
        q, k, v, do = (tma_operand(t, "flash_dkv") for t in (q, k, v, do))
    _launch("dkv", "flash_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            _strides(q=q, k=k, v=v, do=do, dk=dk, dv=dv), q, k, mask, bias)
    _report("flash_dkv", q, k, mask, (q, k, v, do, lse, delta, bias, dk,
                                      dv))
    return dk, dv


_LAYOUT_WITH_BROADCAST = (
    "block_layout with a BROADCAST differentiable bias is not supported "
    "(the reduced-dbias kernel ignores layouts); use a full-shape bias or "
    "drop the layout")


def dbias_on_sm90(dtype: torch.dtype, d: int) -> bool:
    """Whether the reducing dbias runs ``flash_dbias_sm90_kernel`` (the
    library's ``bwd_on_sm90``: bfloat16 / float16 at D <= 128; the card
    tests hold the two to agree through :func:`kernel_name`)."""
    return dtype in (torch.bfloat16, torch.float16) and d <= 128


def dbias_chunks(q, k, bias) -> int:
    """How many fixed ranges the reducing kernel cuts each bias entry's
    replicas into, from the shapes and the route alone: enough for the
    route's CTA target (``_DBIAS_SM90_CTAS`` or ``_DBIAS_CTAS``), at most
    16 ranges and one replica each. The partial sums are added in range
    order, so the same inputs give the same bits on any card."""
    b, sq, h, d = q.shape
    if dbias_on_sm90(q.dtype, d):
        rows, cols, target = 128, 64, _DBIAS_SM90_CTAS
    else:
        rows = cols = 64 if d <= 128 else 32
        target = _DBIAS_CTAS
    entries = bias.shape[0] * bias.shape[1]
    ctas = -(-sq // rows) * -(-k.shape[1] // cols) * entries
    nrep = (b // bias.shape[0]) * (h // bias.shape[1])
    want = -(-target // ctas)
    return max(1, min(want, nrep, _DBIAS_MAX_CHUNKS, _GRID_MAX // entries))


def flash_dbias(q, k, v, do, lse, delta, mask: Mask, bias: torch.Tensor):
    """Launch the reducing dbias kernel (:func:`kernel_name`): the gradient
    of the pair bias ``bias`` (float32 contiguous ``[Bb, Hb, Sq, Skv]``),
    float32 of its shape, summed in a fixed order over the B / Bb batches
    and H / Hb heads that read each entry (with :func:`dbias_chunks` ranges
    of them summed by a second kernel in range order). It does not take a
    block layout. Where the kernel reads by TMA, a q, k, v or dO it cannot
    read in place is copied first (counted in ``COPIES["flash_dbias"]``)."""
    if mask.layout is not None:
        raise NotImplementedError(_LAYOUT_WITH_BROADCAST)
    _check(q, k, v, mask, bias, do=do)
    _check_rows(q, lse, delta)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    if not q.numel() or not k.shape[1]:
        return dbias.zero_()
    chunks = dbias_chunks(q, k, bias)
    scratch = None if chunks == 1 else torch.empty(
        (chunks, *bias.shape), dtype=torch.float32, device=q.device)
    if kernel_name("dbias", q.dtype, q.shape[3]) in _TMA_KERNELS:
        q, k, v, do = (tma_operand(t, "flash_dbias") for t in (q, k, v, do))
    _launch("dbias", "flash_dbias",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dbias.data_ptr(),
             _ptr(scratch)), _strides(q=q, k=k, v=v, do=do), q, k, mask,
            bias, chunks)
    _report("flash_dbias", q, k, mask, (q, k, v, do, lse, delta, bias,
                                        dbias))
    return dbias


def flash_attention_fwd(q, k, v, mask: Mask, bias=None):
    """``(o, lse)``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. ``bias``: float32 contiguous ``[Bb, Hb, Sq, Skv]``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, mask, bias)
    return flash_fwd(q, k, v, mask, bias=bias)


def flash_attention_bwd(q, k, v, do, lse, delta, mask: Mask, bias=None):
    """``(dq, dk, dv, dbias)``: dq/dk/dv in the inputs' dtypes, dbias
    float32 of the bias's shape (None without a bias). For a CUDA tensor
    the dQ and dK/dV kernels, with dbias from the dQ kernel for a
    full-shape bias and from the reducing kernel for a broadcast one; for a
    CPU tensor the plain versions."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                                   mask, bias=bias)
        dbias = None if bias is None else flash_dbias_reference(
            q, k, v, do, lse, delta, mask, bias)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias
    dbias = None
    if bias is not None and not is_broadcast(bias, q):
        dbias = torch.empty((q.shape[0], q.shape[2], q.shape[1], k.shape[1]),
                            dtype=torch.float32, device=q.device)
    dq = flash_dq(q, k, v, do, lse, delta, mask, bias=bias, dbias=dbias)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, mask, bias=bias)
    if bias is not None and dbias is None:
        dbias = flash_dbias(q, k, v, do, lse, delta, mask, bias)
    return dq, dk, dv, dbias


def attention_delta(do, o) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` [B, H, Sq] float32, a torch op outside the
    kernels as in the JAX package (:674)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """Forward saves ``o``, ``lse`` and the float32 pair bias; backward
    computes ``delta`` and runs dQ and dK/dV (and the pair bias's gradient),
    returning grads in the inputs' dtypes. The k-row bias gets zeros, as
    the JAX package's ``f_bwd`` gives it (:683-690): it is a mask.

    With ``return_lse`` the forward also returns the LSE transposed to
    ``[B, Sq, H]`` and the backward takes its cotangent ``dlse``: since
    dLSE_i/dS_ij = P_ij, ``dS_ij = P_ij (dO_i . V_j - (delta_i -
    dlse_i))``, so the same kernels run with ``delta - dlse`` in delta's
    slot, the reducing dbias kernel included; dV has no lse term (JAX
    ``_make_flash_lse``, :696-734). No new kernel: delta is computed here,
    outside the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, bias, k_bias, mask: Mask,
                return_lse: bool = False):
        b32 = None if bias is None else check_bias(bias, q, k)
        o, lse = flash_attention_fwd(q, k, v, mask, b32)
        ctx.save_for_backward(q, k, v, o, lse, b32)
        ctx.mask = mask
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.k_bias_like = None if k_bias is None else (
            k_bias.shape, k_bias.dtype, k_bias.device)
        if return_lse:
            return o, lse.transpose(1, 2).contiguous()
        return o

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, o, lse, b32 = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = attention_delta(do, o)
        if dlse is not None:
            delta = (delta - dlse.float().transpose(1, 2)).contiguous()
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, do, lse, delta, ctx.mask, b32)
        if dbias is not None:
            dbias = dbias.to(ctx.bias_dtype)
        dkb = None
        if ctx.k_bias_like is not None and ctx.needs_input_grad[4]:
            shape, dtype, dev = ctx.k_bias_like
            dkb = torch.zeros(shape, dtype=dtype, device=dev)
        return dq, dk, dv, dbias, dkb, None, None


# -------------------------------------------------------------------- public
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    alibi=None, window: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None,
                    k_bias: Optional[torch.Tensor] = None,
                    block_layout=None, block_q: int = 512, block_k: int = 512,
                    return_lse: bool = False):
    """Flash attention over ``q [B,Sq,H,D]``, ``k/v [B,Skv,KVH,D]``.
    Differentiable; GQA when ``KVH < H``; ``segment_ids [B,Sq]`` masks across
    packed-sequence boundaries; ``kv_segment_ids`` with explicit
    ``q_positions``/``kv_positions`` give position-space causality;
    ``alibi``: per-head slopes [H]; ``window``: sliding window (needs
    ``causal``). ``bias``: additive logit bias ``[Bb, Hb, Sq, Skv]`` with
    ``Bb | B`` and ``Hb | H`` broadcast over contiguous groups,
    differentiable (the evoformer pair bias); ``k_bias``: per-key row bias
    ``[Bk, Skv]`` broadcast over q rows and heads, non-differentiable (its
    gradient is zeros: the evoformer mask bias). Both are added after the
    1/sqrt(D) scaling. ``block_layout``: block-sparsity mask ``[Hl,
    ceil(Sq/bq), ceil(Skv/bk)]`` (0 = dead block), ``Hl`` in {1, H}, over
    blocks of ``bq = min(block_q, round_up(Sq, 128))`` rows and ``bk`` the
    same for keys; ``block_q``/``block_k`` mean nothing else. Returns
    ``[B,Sq,H,D]`` in q's dtype, or with ``return_lse`` ``(o, lse)``, lse
    ``[B,Sq,H]`` float32 (-1e30 for a row with nothing visible), both
    differentiable. Scale 1/sqrt(D)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,Sq,H,D] and k/v [B,Skv,KVH,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if bias is not None:
        check_bias(bias, q, k)
    mask = make_mask(q, k, causal, segment_ids, kv_segment_ids, q_positions,
                     kv_positions, alibi, window, k_bias, block_layout,
                     block_q, block_k)
    if mask.layout is not None and bias is not None and \
            is_broadcast(bias, q):
        # refused here, not deep inside the backward: the reducing kernel
        # takes no layout
        raise NotImplementedError(_LAYOUT_WITH_BROADCAST)
    return FlashAttention.apply(
        q, k, v, bias, k_bias if isinstance(k_bias, torch.Tensor) else None,
        mask, bool(return_lse))
