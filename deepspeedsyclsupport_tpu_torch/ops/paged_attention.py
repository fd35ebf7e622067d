"""Ragged paged attention: the CUDA kernels' wrappers and plain versions.

Port of ``deepspeedsyclsupport_tpu/ops/paged_attention.py``. The TPU kernel
``_prefill_kernel`` (:96) is replaced by the hand-written CUDA kernels in
``csrc/paged_attention.cu``; decode is its BQ=1 call, as in the JAX package.
The library picks one of three routes before launch (:func:`kernel_name`):

* ``paged_decode_split_kernel`` (+ ``paged_decode_combine_kernel``), every
  dtype, for atoms of at most 16 lanes (BQ * H / KVH <= 16: decode): split
  KV in fixed chunks of :data:`SPLIT_CHUNK` positions, partials in float32
  scratch (:func:`split_plan`) folded in chunk order;
* ``paged_prefill_sm90_kernel``, bfloat16 / float16 prefill at D <= 128 (a
  multiple of 8), ``block_size`` a multiple or a divisor (>= 8) of 64, H /
  KVH dividing 128, and q and the pool 16-byte aligned so TMA reads them in
  place: wgmma products, P as hi + lo operands of the dtype in P V;
* ``paged_attention_kernel``, the CUDA-core version, for everything else
  (float32 prefill, D > 128, a pool TMA cannot read in place). The pool is
  never copied on any route.

* :func:`ragged_prefill_attention` / :func:`paged_decode_attention` — the
  wrappers. A CUDA tensor launches a kernel (or raises); a CPU tensor takes
  the plain version. There is no other fallback.
* :func:`ragged_prefill_attention_reference` /
  :func:`paged_decode_attention_reference` — the plain PyTorch versions
  (ports of the JAX package's jnp oracles, :266 and :62). They gather each
  atom's KV into ``[A, max_ctx, KVH, D]``, which the kernels never build.
* :data:`LAUNCHES` — how many times each wrapper launched the kernel (one
  count per call, whatever the route); only a launch counts, never a CPU
  call.
"""
import ctypes
import math
from typing import Optional, Tuple

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
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the split route (csrc/paged_attention.cu `kChunk`, `split_plan`)
SPLIT_CHUNK = 256          # KV positions per CTA, a constant on every card
SPLIT_MAX_LANES = 16       # atoms of at most this many lanes take the route


def split_plan(a: int, bq: int, h: int, kvh: int, d: int, bps: int,
               block_size: int) -> Tuple[int, int, int, int]:
    """The split route's grid for ``a`` atoms: ``(chunks per atom, lanes per
    tile, lane tiles, scratch floats)``, from shapes alone (no value read
    from the card). Chunks cover the table's capacity ``bps * block_size``;
    a CTA holds D / 32 columns of up to 1024 / DMAX lanes (DMAX the head dim
    rounded up to 64, 128 or 256); the scratch holds one partial (m, l and D
    accumulator columns, float32) per atom, kv head, lane tile, chunk and
    lane. The library checks the scratch it is given against its own
    plan."""
    lanes = bq * (h // kvh)
    nch = -(-bps * block_size // SPLIT_CHUNK)
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    lt = min(1024 // dmax, lanes)
    ltiles = -(-lanes // lt)
    return nch, lt, ltiles, a * kvh * ltiles * nch * lt * (d + 2)


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.dsst_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dsst_paged_kernel.argtypes = [ctypes.c_int] * 7
        lib.dsst_paged_kernel.restype = ctypes.c_char_p
        lib.dsst_error_string.argtypes = [ctypes.c_int]
        lib.dsst_error_string.restype = ctypes.c_char_p
    return lib


def kernel_name(kind: str, dtype: torch.dtype, d: int, *,
                block_size: int = 64, bq: Optional[int] = None,
                group: int = 1, aligned: bool = True) -> str:
    """The kernel the built library launches, as it reports it (the route
    is decided there, before launch): ``kind`` ``"prefill"`` (atoms of
    ``bq`` rows, 128 unless given) or ``"decode"`` (BQ = 1), ``group`` q
    heads per kv head, ``aligned``: q and the pool start on 16 bytes (see
    :func:`kernel_for` for given tensors). Needs the CUDA build."""
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind must be 'prefill' or 'decode', got {kind!r}")
    rows = 1 if kind == "decode" else (128 if bq is None else int(bq))
    name = _library().dsst_paged_kernel(rows, group, 1, int(d),
                                        int(block_size), _DTYPE_CODES[dtype],
                                        int(aligned))
    if name is None:
        raise ValueError(f"no paged kernel for bq {rows}, group {group}")
    return name.decode()


def kernel_for(q_atoms, k_cache, v_cache, block_size: int) -> str:
    """The kernel :func:`ragged_prefill_attention` launches for these
    tensors (q ``[A, BQ, H, D]``; for decode pass ``q[:, None]``)."""
    _, bq, h, d = q_atoms.shape
    return kernel_name("prefill", q_atoms.dtype, d, block_size=block_size,
                       bq=bq, group=h // k_cache.shape[1],
                       aligned=all(t.data_ptr() % 16 == 0
                                   for t in (q_atoms, k_cache, v_cache)))


def _launch(counter: str, q_atoms, k_cache, v_cache, atom_tables, atom_pos0,
            atom_qlen, block_size: int, alibi, window: Optional[int],
            seq_lens=None) -> torch.Tensor:
    """Check what the kernels take, allocate the output (and the split
    route's scratch), launch on the current stream and count the launch
    under ``LAUNCHES[counter]``. Decode passes ``seq_lens`` (BQ = 1) in
    place of ``atom_pos0`` / ``atom_qlen``: the kernels derive them, so the
    call launches nothing else. Raises on anything the kernels do not take
    and on a refused launch. Reads nothing back from the card."""
    dev = q_atoms.device
    if dev.type != "cuda":
        raise ValueError(f"the paged-attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    if q_atoms.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged-attention kernel takes float32, bfloat16 or "
                        f"float16, got {q_atoms.dtype}")
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
    num_slots, kvh = k_cache.shape[:2]
    if k_cache.shape[2] != d or h % kvh or not 0 < d <= 256:
        raise ValueError(f"head dims: q {d}, pool {k_cache.shape[2]} (<= 256);"
                         f" {h} q heads over {kvh} kv heads")
    rows = ((seq_lens,) if seq_lens is not None
            else (atom_pos0, atom_qlen))
    if atom_tables.dim() != 2 or atom_tables.shape[0] != a or \
            any(t.shape != (a,) for t in rows):
        raise ValueError("atom_tables must be [A, Bps], pos0/qlen or "
                         "seq_lens [A]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q_atoms)
    if a == 0 or bq == 0:
        return out
    bps = atom_tables.shape[1]
    tables = atom_tables.to(device=dev, dtype=torch.int32).contiguous()
    rows = [t.to(device=dev, dtype=torch.int32).contiguous() for t in rows]
    slopes = None
    if alibi is not None:
        slopes = torch.as_tensor(alibi).to(device=dev,
                                           dtype=torch.float32).contiguous()
        if slopes.shape != (h,):
            raise ValueError(f"alibi slopes must be [{h}], got "
                             f"{tuple(slopes.shape)}")
    scratch, n_scratch = None, 0
    if bq * (h // kvh) <= SPLIT_MAX_LANES:
        n_scratch = split_plan(a, bq, h, kvh, d, bps, block_size)[3]
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    lib = _library()
    pos0, qlen, lens = ((None, None, rows[0].data_ptr()) if seq_lens
                        is not None else (rows[0].data_ptr(),
                                          rows[1].data_ptr(), None))
    with torch.cuda.device(dev):
        rc = lib.dsst_paged_attention(
            q_atoms.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), tables.data_ptr(), pos0, qlen, lens,
            None if slopes is None else slopes.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n_scratch,
            a, bq, h, kvh, d, bps, block_size, num_slots,
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
    return _launch("paged_decode_attention", q[:, None], k_cache, v_cache,
                   block_tables, None, None, block_size, alibi, window,
                   seq_lens=seq_lens)[:, 0]
