"""Flash attention: the CUDA kernels' wrappers, plain versions and autograd.

Port of ``deepspeedsyclsupport_tpu/ops/flash_attention.py``. The TPU kernels
``_fwd_kernel`` (:145), ``_dq_kernel`` (:208) and ``_dkv_kernel`` (:273) are
replaced by the hand-written CUDA kernels in ``csrc/flash_attention.cu``,
wired as a ``torch.autograd.Function`` as the JAX package wires them as a
``jax.custom_vjp`` (:646-693).

* :func:`flash_attention` — the public function, layout ``[B, S, H, D]`` /
  ``[B, Skv, KVH, D]`` as in the JAX package (:752). Differentiable.
* :func:`flash_attention_fwd` / :func:`flash_attention_bwd` — the wrappers.
  A CUDA tensor launches the kernels (or raises); a CPU tensor takes the
  plain versions. There is no other fallback.
* :func:`flash_attention_fwd_reference` / :func:`flash_attention_bwd_reference`
  — the plain PyTorch versions: exact attention in float32 returning
  ``(o, lse)``, and the flash-2 backward formulas of ``_dq_kernel`` /
  ``_dkv_kernel`` from the saved ``lse`` and ``delta``. Both loop over
  blocks of query rows so that long sequences fit in memory.
* :data:`LAUNCHES` — how many times each kernel was launched; only a launch
  counts, never a CPU call.

Not ported here: the pair bias and its dbias kernel (``_dbias_kernel``,
:330), the k-row bias, block-sparse layouts and the lse-returning variant.
Each raises ``NotImplementedError`` naming its ``ROADMAP.md`` entry.
"""
import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _build

NEG_INF = -1e30

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

# elements of one [B, H, rows, Skv] score block in the plain versions
_REF_BLOCK_ELEMS = 1 << 26


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Mask(NamedTuple):
    """What decides which (query, key) pairs are visible, normalised: int32
    ``[B, S]`` tensors (or None for the defaults), ALiBi slopes float32
    ``[H]`` (or None), the window (None for none)."""
    causal: bool
    seg_q: Optional[torch.Tensor]
    seg_k: Optional[torch.Tensor]
    pos_q: Optional[torch.Tensor]
    pos_k: Optional[torch.Tensor]
    alibi: Optional[torch.Tensor]
    window: Optional[int]


def make_mask(q, k, causal: bool = True, segment_ids=None,
              kv_segment_ids=None, q_positions=None, kv_positions=None,
              alibi=None, window: Optional[int] = None) -> Mask:
    """Check and normalise the masking arguments as the JAX public function
    does (:794-862): ``kv_segment_ids`` needs ``segment_ids``; bare
    ``segment_ids`` need Sq == Skv; ``window`` needs ``causal``."""
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
    return Mask(bool(causal), seg_q, seg_k, pos_q, pos_k, slopes,
                None if window is None else int(window))


# ------------------------------------------------------------------ reference
def _block_rows(b, h, sq, skv) -> int:
    return max(1, min(sq, _REF_BLOCK_ELEMS // max(1, b * h * skv)))


def _scores(q, k, m: Mask, r0: int, r1: int):
    """Scaled (+ALiBi) scores and the visibility mask for query rows
    [r0, r1): ``s`` [B, KVH, G, rows, Skv] float32, ``mask`` broadcastable
    to it. GQA groups q heads as ``h = kv_head * G + g``."""
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
    mask = torch.ones((), dtype=torch.bool, device=dev)
    if m.causal:
        mask = mask & (pk <= pq)
    if m.window is not None:
        mask = mask & (pq - pk < m.window)
    if m.seg_q is not None:
        mask = mask & (m.seg_q[:, r0:r1][:, None, None, :, None]
                       == m.seg_k[:, None, None, None, :])
    return s, mask


def flash_attention_fwd_reference(q, k, v, mask: Mask):
    """Exact attention in float32. Returns ``(o, lse)``: o [B, Sq, H, D] in
    q's dtype, lse [B, H, Sq] float32 = m + log(max(l, 1e-30)) with m the
    row max over visible scores (-1e30 when none): a row with nothing
    visible gets o = 0 and lse ~ -1e30, as the kernel does."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    vf = v.float()
    step = _block_rows(b, h, sq, skv)
    for r0 in range(0, sq, step):
        r1 = min(sq, r0 + step)
        s, vis = _scores(q, k, mask, r0, r1)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        mx = s.amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - mx), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        ob = torch.einsum("bkgqj,bjkd->bqkgd", p, vf) \
            / l.permute(0, 3, 1, 2, 4)
        o[:, r0:r1] = ob.reshape(b, r1 - r0, h, d).to(q.dtype)
        lse[:, :, r0:r1] = (mx + torch.log(l)).reshape(b, h, r1 - r0)
    return o, lse


def flash_attention_bwd_reference(q, k, v, do, lse, delta, mask: Mask,
                                  parts: str = "all"):
    """The flash-2 backward of ``_dq_kernel``/``_dkv_kernel`` in float32:
    ``p = where(visible, exp(s - lse), 0)``, ``ds = p * (dO V^T - delta)``,
    ``dq = scale * ds K``, ``dk = scale * ds^T Q`` and ``dv = p^T dO``, the
    GQA group summed. lse/delta: [B, H, Sq] float32. Returns float32
    ``(dq, dk, dv)``; ``parts="dq"`` or ``"dkv"`` computes only those (the
    others are None)."""
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
        s, vis = _scores(q, k, mask, r0, r1)
        lse_b = lse[:, :, r0:r1].reshape(b, kvh, g, n, 1)
        dl_b = delta[:, :, r0:r1].reshape(b, kvh, g, n, 1)
        p = torch.where(vis, torch.exp(s - lse_b), torch.zeros_like(s))
        dob = do[:, r0:r1].float().reshape(b, n, kvh, g, d)
        dp = torch.einsum("bqkgd,bjkd->bkgqj", dob, vf)
        ds = p * (dp - dl_b)
        if want_dq:
            dq[:, r0:r1] = (scale * torch.einsum(
                "bkgqj,bjkd->bqkgd", ds, kf)).reshape(b, n, h, d)
        if want_dkv:
            qb = q[:, r0:r1].float().reshape(b, n, kvh, g, d)
            dk += scale * torch.einsum("bkgqj,bqkgd->bjkd", ds, qb)
            dv += torch.einsum("bkgqj,bqkgd->bjkd", p, dob)
    return dq, dk, dv


# --------------------------------------------------------------------- kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_OPERANDS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
_PTRS = {"fwd": 10, "dq": 12, "dkv": 13}   # pointer arguments before strides


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.dsst_flash_fwd.argtypes is None:
        for kind, n_ptr in _PTRS.items():
            fn = getattr(lib, f"dsst_flash_{kind}")
            fn.argtypes = ([ctypes.c_void_p] * (n_ptr + 1)
                           + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.dsst_flash_error_string.argtypes = [ctypes.c_int]
        lib.dsst_flash_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(q, k, v, mask: Mask, **extra) -> None:
    """What the kernels take: CUDA tensors on one device, one floating type
    (float32, bfloat16, float16), ``[B, S, H, D]`` with a unit innermost
    stride, D <= 256, H a multiple of KVH."""
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
    for t in (mask.seg_q, mask.seg_k, mask.pos_q, mask.pos_k, mask.alibi):
        if t is not None and t.device != dev:
            raise ValueError(f"mask tensors must be on {dev}, got "
                             f"{t.device}")


def _strides(**named) -> ctypes.Array:
    st = (ctypes.c_longlong * (3 * len(_OPERANDS)))()
    for i, name in enumerate(_OPERANDS):
        t = named.get(name)
        if t is not None:
            st[3 * i:3 * i + 3] = [t.stride(0), t.stride(1), t.stride(2)]
    return st


def _launch(kind: str, counter: str, ptrs, strides, q, k, mask: Mask):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    lib = _library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"dsst_flash_{kind}")(
            *ptrs, _ptr(mask.seg_q), _ptr(mask.seg_k), _ptr(mask.pos_q),
            _ptr(mask.pos_k), _ptr(mask.alibi), strides, b, sq, skv, h, kvh,
            d, int(mask.causal), mask.window or 0, 1.0 / math.sqrt(d),
            _DTYPE_CODES[q.dtype],
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


def flash_fwd(q, k, v, mask: Mask, out: Optional[torch.Tensor] = None):
    """Launch the forward kernel: ``(o [B,Sq,H,D], lse [B,H,Sq] float32)``;
    ``out`` optionally receives o."""
    _check(q, k, v, mask)
    o = _out(out, q, "out")
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    if not q.numel() or not k.shape[1]:     # nothing visible anywhere
        o.zero_()
        lse.fill_(NEG_INF)
        return o, lse
    _launch("fwd", "flash_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()), _strides(q=q, k=k, v=v, o=o), q, k, mask)
    return o, lse


def _check_rows(q, lse, delta):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != want or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 {want} on "
                             f"{q.device}")


def flash_dq(q, k, v, do, lse, delta, mask: Mask,
             out: Optional[torch.Tensor] = None):
    """Launch the dQ kernel; dq in q's dtype (float32 accumulation)."""
    _check(q, k, v, mask, do=do)
    _check_rows(q, lse, delta)
    dq = _out(out, q, "out")
    if not q.numel() or not k.shape[1]:
        return dq.zero_()
    _launch("dq", "flash_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            _strides(q=q, k=k, v=v, do=do, dq=dq), q, k, mask)
    return dq


def flash_dkv(q, k, v, do, lse, delta, mask: Mask, out=(None, None)):
    """Launch the dK/dV kernel; group-summed dk, dv in k's dtype."""
    _check(q, k, v, mask, do=do)
    _check_rows(q, lse, delta)
    dk, dv = _out(out[0], k, "out[0]"), _out(out[1], v, "out[1]")
    if not q.numel() or not k.numel():
        return dk.zero_(), dv.zero_()
    _launch("dkv", "flash_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            _strides(q=q, k=k, v=v, do=do, dk=dk, dv=dv), q, k, mask)
    return dk, dv


def flash_attention_fwd(q, k, v, mask: Mask):
    """``(o, lse)``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, mask)
    return flash_fwd(q, k, v, mask)


def flash_attention_bwd(q, k, v, do, lse, delta, mask: Mask):
    """``(dq, dk, dv)`` in the inputs' dtypes: the dQ and dK/dV kernels for
    a CUDA tensor, the plain version for a CPU tensor."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                                   mask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return (flash_dq(q, k, v, do, lse, delta, mask),
            *flash_dkv(q, k, v, do, lse, delta, mask))


def attention_delta(do, o) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` [B, H, Sq] float32, a torch op outside the
    kernels as in the JAX package (:674)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """Forward saves ``o`` and ``lse``; backward computes ``delta`` and runs
    dQ and dK/dV, returning grads in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, mask: Mask):
        o, lse = flash_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse,
                                         attention_delta(do, o), ctx.mask)
        return dq, dk, dv, None


# -------------------------------------------------------------------- public
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    alibi=None, window: Optional[int] = None,
                    bias=None, k_bias=None, block_layout=None,
                    return_lse: bool = False) -> torch.Tensor:
    """Flash attention over ``q [B,Sq,H,D]``, ``k/v [B,Skv,KVH,D]``.
    Differentiable; GQA when ``KVH < H``; ``segment_ids [B,Sq]`` masks across
    packed-sequence boundaries; ``kv_segment_ids`` with explicit
    ``q_positions``/``kv_positions`` give position-space causality;
    ``alibi``: per-head slopes [H]; ``window``: sliding window (needs
    ``causal``). Returns ``[B,Sq,H,D]`` in q's dtype. Scale 1/sqrt(D)."""
    if bias is not None or k_bias is not None:
        raise NotImplementedError(
            "flash_attention bias/k_bias (the evoformer pair bias and its "
            "dbias kernel) are not ported yet: ROADMAP.md, queue A.3.5 "
            "(ops/evoformer_attn.py, needs kernel B5)")
    if block_layout is not None:
        raise NotImplementedError(
            "flash_attention block_layout (block-sparse attention) is not "
            "ported yet: ROADMAP.md, queue A.3.5 (ops/sparse_attention.py)")
    if return_lse:
        raise NotImplementedError(
            "flash_attention return_lse (the lse-returning variant ring "
            "attention needs) is not ported yet: ROADMAP.md, queue A.3.1 "
            "(ring attention)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,Sq,H,D] and k/v [B,Skv,KVH,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    mask = make_mask(q, k, causal, segment_ids, kv_segment_ids, q_positions,
                     kv_positions, alibi, window)
    return FlashAttention.apply(q, k, v, mask)
