"""Ragged paged attention: the CUDA kernel's wrappers and plain versions.

Port of ``deepspeedsyclsupport_tpu/ops/paged_attention.py``. The TPU kernel
``_prefill_kernel`` (:96) is replaced by the hand-written CUDA kernel in
``csrc/paged_attention.cu``; decode is its BQ=1 call, as in the JAX package.

* :func:`ragged_prefill_attention` / :func:`paged_decode_attention` — the
  wrappers. A CUDA tensor launches the kernel (or raises); a CPU tensor
  takes the plain version. There is no other fallback.
* :func:`ragged_prefill_attention_reference` /
  :func:`paged_decode_attention_reference` — the plain PyTorch versions
  (ports of the JAX package's jnp oracles, :266 and :62). They gather each
  atom's KV into ``[A, max_ctx, KVH, D]``, which the kernel never builds.
* :data:`LAUNCHES` — how many times each wrapper launched the kernel; only
  a launch counts, never a CPU call.
"""
import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

LAUNCHES = {"ragged_prefill_attention": 0, "paged_decode_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------------ reference
def ragged_prefill_attention_reference(q_atoms, k_cache, v_cache, atom_tables,
                                       atom_pos0, atom_qlen, *,
                                       block_size: int, alibi=None,
                                       window: Optional[int] = None):
    """Exact attention of each atom's rows over its sequence's paged KV.
    q_atoms: [A, BQ, H, D]; k/v_cache: [num_slots, KVH, D]; atom_tables:
    [A, Bps]; atom_pos0/atom_qlen: [A]. Rows with nothing visible are 0."""
    a, bq, h, d = q_atoms.shape
    kvh = k_cache.shape[1]
    dev = q_atoms.device
    bps = atom_tables.shape[1]
    j = torch.arange(bps * block_size, device=dev)
    slot = atom_tables.long()[:, j // block_size] * block_size \
        + j % block_size                                  # [A, C]
    k_seq = k_cache[slot].float()                         # [A, C, KVH, D]
    v_seq = v_cache[slot].float()
    if kvh != h:
        k_seq = k_seq.repeat_interleave(h // kvh, dim=2)
        v_seq = v_seq.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("aqhd,achd->ahqc", q_atoms.float(), k_seq) \
        / math.sqrt(d)
    r = torch.arange(bq, device=dev)[None, None, :, None]
    q_pos = atom_pos0.long()[:, None, None, None] + r
    jj = j[None, None, None, :]
    if alibi is not None:
        logits = logits + alibi.float()[None, :, None, None] * (
            jj - q_pos).float()
    mask = (jj <= q_pos) & (r < atom_qlen.long()[:, None, None, None])
    if window is not None:
        mask = mask & (q_pos - jj < window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("ahqc,achd->aqhd", p, v_seq)
    return out.to(q_atoms.dtype)


def _decode_atoms(seq_lens):
    """Decode slot -> BQ=1 atom: its query is the newest cached token."""
    seq_lens = seq_lens.to(torch.int32)
    return (torch.clamp(seq_lens - 1, min=0),
            (seq_lens > 0).to(torch.int32))


def paged_decode_attention_reference(q, k_cache, v_cache, block_tables,
                                     seq_lens, *, block_size: int,
                                     alibi=None, window: Optional[int] = None):
    """Decode as the BQ=1 case of the ragged reference. q: [S, H, D];
    seq_lens: [S] valid KV tokens per slot (0 = dead slot, exact zeros)."""
    pos0, qlen = _decode_atoms(seq_lens)
    return ragged_prefill_attention_reference(
        q[:, None], k_cache, v_cache, block_tables, pos0, qlen,
        block_size=block_size, alibi=alibi, window=window)[:, 0]


# --------------------------------------------------------------------- kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.dsst_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dsst_error_string.argtypes = [ctypes.c_int]
        lib.dsst_error_string.restype = ctypes.c_char_p
    return lib


def _launch(counter: str, q_atoms, k_cache, v_cache, atom_tables, atom_pos0,
            atom_qlen, block_size: int, alibi,
            window: Optional[int]) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch on the
    current stream and count the launch under ``LAUNCHES[counter]``. Raises
    on anything the kernel does not take and on a refused launch."""
    dev = q_atoms.device
    if dev.type != "cuda":
        raise ValueError(f"the paged-attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    if q_atoms.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged-attention kernel takes float32 or bfloat16, "
                        f"got {q_atoms.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev or t.dtype != q_atoms.dtype:
            raise TypeError(f"{name} must be {q_atoms.dtype} on {dev}, got "
                            f"{t.dtype} on {t.device}")
    for name, t in (("q", q_atoms), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_atoms.dim() != 4 or k_cache.dim() != 3 or \
            k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes: q {tuple(q_atoms.shape)} must be [A, BQ, "
                         f"H, D], k/v {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} must be [slots, KVH, D]")
    a, bq, h, d = q_atoms.shape
    kvh = k_cache.shape[1]
    if k_cache.shape[2] != d or h % kvh or not 0 < d <= 256:
        raise ValueError(f"head dims: q {d}, pool {k_cache.shape[2]} (<= 256);"
                         f" {h} q heads over {kvh} kv heads")
    if atom_tables.dim() != 2 or atom_tables.shape[0] != a or \
            atom_pos0.shape != (a,) or atom_qlen.shape != (a,):
        raise ValueError("atom_tables must be [A, Bps], pos0/qlen [A]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q_atoms)
    if a == 0 or bq == 0:
        return out
    tables = atom_tables.to(device=dev, dtype=torch.int32).contiguous()
    pos0 = atom_pos0.to(device=dev, dtype=torch.int32).contiguous()
    qlen = atom_qlen.to(device=dev, dtype=torch.int32).contiguous()
    slopes = None
    if alibi is not None:
        slopes = torch.as_tensor(alibi).to(device=dev,
                                           dtype=torch.float32).contiguous()
        if slopes.shape != (h,):
            raise ValueError(f"alibi slopes must be [{h}], got "
                             f"{tuple(slopes.shape)}")
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.dsst_paged_attention(
            q_atoms.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), tables.data_ptr(), pos0.data_ptr(),
            qlen.data_ptr(), None if slopes is None else slopes.data_ptr(),
            a, bq, h, kvh, d, atom_tables.shape[1], block_size,
            0 if window is None else int(window), 1.0 / math.sqrt(d),
            _DTYPE_CODES[q_atoms.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged-attention kernel launch failed: "
                           f"{lib.dsst_error_string(rc).decode()} (cuda "
                           f"error {rc})")
    LAUNCHES[counter] += 1
    return out


def ragged_prefill_attention(q_atoms, k_cache, v_cache, atom_tables,
                             atom_pos0, atom_qlen, *, block_size: int,
                             alibi=None, window: Optional[int] = None):
    """Ragged paged attention over atoms. q_atoms: [A, BQ, H, D]; k/v_cache:
    one layer's pool [num_slots, KVH, D] (a view into the ``[L, ...]`` pool:
    its data pointer is the pool's base plus the layer offset, no copy);
    atom_tables: [A, Bps]; atom_pos0/atom_qlen: [A]; ``alibi``: slopes [H];
    ``window``: sliding-window bound. Returns [A, BQ, H, D]."""
    if q_atoms.device.type == "cpu":
        return ragged_prefill_attention_reference(
            q_atoms, k_cache, v_cache, atom_tables, atom_pos0, atom_qlen,
            block_size=block_size, alibi=alibi, window=window)
    return _launch("ragged_prefill_attention", q_atoms, k_cache, v_cache,
                   atom_tables, atom_pos0, atom_qlen, block_size, alibi,
                   window)


def paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens, *,
                           block_size: int, alibi=None,
                           window: Optional[int] = None):
    """One query token per slot over its paged KV. q: [S, H, D];
    block_tables: [S, Bps]; seq_lens: [S]. Returns [S, H, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_cache, v_cache, block_tables, seq_lens,
            block_size=block_size, alibi=alibi, window=window)
    pos0, qlen = _decode_atoms(seq_lens)
    return _launch("paged_decode_attention", q[:, None], k_cache, v_cache,
                   block_tables, pos0, qlen, block_size, alibi, window)[:, 0]
