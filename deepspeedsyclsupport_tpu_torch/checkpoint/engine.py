"""Checkpoint engine: the single-process native format.

Port of ``deepspeedsyclsupport_tpu/checkpoint/engine.py``'s native backend.
The format is the reference's, byte for byte: leaves are streamed into one
raw binary file (``state.bin``) with a JSON index (``state_index.json``:
name, offset, nbytes, dtype, shape and crc32 per leaf), a meta file
(``dstpu_meta.json``) carrying the caller's metadata and an integrity
manifest (per-file size and crc32), and the two-phase pod commit records
(``dstpu_rank_<r>.json``, ``dstpu_commit.json``). Leaf names are the JAX
package's: ``/``-joined dict keys (sorted, as ``jax.tree_util`` flattens a
dict) and list indices. bfloat16 goes through its raw bytes (the index
still says ``"bfloat16"``), so no ``ml_dtypes`` is needed. A checkpoint
written by either package loads in the other.

A leaf may be a tensor, a numpy array or a zero-argument callable returning
one: the writer calls it when it reaches that leaf, so a caller can build
each leaf (a restacked layer weight, say) one at a time. A ``NamedTuple``
is named by its fields in their order, as ``jax.tree_util`` names one (the
loss scaler's ``scaler/scale``, ``scaler/good_steps``, ...).

Tag history as in the JAX package: the ``latest`` pointer, tags listed
newest first by their recorded ``global_steps``, quarantine of a corrupt
tag (renamed ``<tag>.corrupt``), the fallback walk past corrupt or torn
tags (:func:`find_latest_valid_tag`, :func:`load_latest_valid`), the
training sentinel's ``last_good`` pointer (:func:`promote_last_good`,
:func:`find_last_good_tag`) and rotation (:func:`rotate_checkpoints`).

Not ported yet: the orbax backend (multi-host writes, ROADMAP.md A.3.1) and
pods of more than one rank that share no process group (A.3.3b's pod
commit).
"""
import itertools
import json
import os
import re
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.fault_injection import get_fault_injector, retry_io
from ..utils.logging import logger

META_FILE = "dstpu_meta.json"
INDEX_FILE = "state_index.json"
DATA_FILE = "state.bin"
STATE_DIR = "state"  # the JAX package's orbax subdir (a tag listed, never read)
LATEST_FILE = "latest"  # tag-pointer file
# Health-gated tag pointer (runtime/sentinel.py): the newest tag the training
# sentinel PROMOTED after K healthy steps beyond it, so a divergence rollback
# never resumes from a checkpoint that may already hold the poisoned state
# ``latest`` points at.
LAST_GOOD_FILE = "last_good"
INTEGRITY_KEY = "__integrity__"  # manifest section inside META_FILE
# Two-phase pod commit: phase 1 = every rank durably writes its own rank
# manifest after its payload; phase 2 = rank 0 writes the commit record
# (expected rank set + per-rank manifest digests) once every rank's phase 1
# is done. A tag with rank manifests but no (or a mismatched) commit record
# is a torn pod and never verifies.
COMMIT_FILE = "dstpu_commit.json"
_RANK_MANIFEST_RE = re.compile(r"^dstpu_rank_(\d+)\.json$")

#: index dtype names (numpy's, as the JAX package writes them) <-> torch
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def rank_manifest_name(rank: int) -> str:
    """Phase-1 per-rank manifest filename inside a tag directory."""
    return f"dstpu_rank_{int(rank)}.json"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification (torn write / bit rot)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


def _counters():
    from ..monitor.monitor import resilience_counters

    return resilience_counters


def _key_str(k) -> str:
    """Path segment: a dict key or a list index, no brackets."""
    return str(k)


def _flatten(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    a ``NamedTuple``'s fields in their order and by name, sequences in
    order; ``None`` is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for k in tree._fields:
            out.extend(_flatten(getattr(tree, k), prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + (i,)))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _leaf_paths(tree) -> List[str]:
    return ["/".join(_key_str(k) for k in path) for path, _ in _flatten(tree)]


def _legacy_names(name: str):
    """Clean name -> the bracketed reprs older checkpoints may have stored
    (``['key']`` for a dict key, ``[idx]`` for an index). A numeric segment
    is ambiguous, so yield every combination."""
    options = [([f"[{s}]", f"['{s}']"] if s.isdigit() else [f"['{s}']"])
               for s in name.split("/")]
    for combo in itertools.product(*options):
        yield "/".join(combo)


def dtype_name(dtype: torch.dtype) -> str:
    """The index's name of a torch dtype (numpy's spelling)."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype for {dtype}") from None


def _leaf_bytes(leaf) -> Tuple[memoryview, str, List[int]]:
    """(raw bytes, dtype name, shape) of one leaf; a callable is called.
    The bytes are a view of a host copy, not a second copy."""
    if callable(leaf):
        leaf = leaf()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:   # numpy has no bfloat16: raw bits
            t = t.view(torch.int16)
        return _raw(t.numpy()), name, list(leaf.shape)
    arr = np.asarray(leaf)
    return _raw(arr), str(arr.dtype), list(arr.shape)


def _raw(arr: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A + B from crc32(A), crc32(B) and len(B): zlib's
    ``crc32_combine`` (which Python's ``zlib`` does not expose), the
    zero-extension of A by len(B) bytes in GF(2). The file's crc32 comes
    from its leaves' crc32s, so no byte is checksummed twice."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]   # one zero bit
    even = [_gf2_times(odd, odd[n]) for n in range(32)]  # two zero bits
    odd = [_gf2_times(even, even[n]) for n in range(32)]  # four zero bits
    while True:
        even = [_gf2_times(odd, odd[n]) for n in range(32)]
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = [_gf2_times(even, even[n]) for n in range(32)]
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def save_tree(path: str, state: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write a state tree + JSON metadata under ``path``.

    Every file write is fsynced and wrapped in :func:`retry_io`; the meta
    file carries an integrity manifest (per-file size + crc32, per-leaf
    crc32 in the index) that :func:`verify_tree` and :func:`load_tree`
    check, so a torn or bit-rotted checkpoint is detected at load time."""
    from ..utils.podid import pod_identity

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    rank, _world = pod_identity()
    if rank == 0:
        # every member of a pod holds the same full state: rank 0 owns the
        # payload and the others only take part in the commit below
        digests = _save_native(path, state)
        meta = dict(meta)
        meta[INTEGRITY_KEY] = {"version": 1, "files": digests}
        meta_path = os.path.join(path, META_FILE)
        _durable_write(meta_path, json.dumps(_jsonable(meta), indent=2),
                       what=f"checkpoint meta write {meta_path}")
    pod_commit(path, meta)
    # torn-write simulation happens after the save claims durability: the
    # failure mode under test is "save completed, file is still short"
    fi = get_fault_injector()
    for fname in (DATA_FILE, INDEX_FILE, META_FILE):
        p = os.path.join(path, fname)
        if os.path.exists(p):
            fi.maybe_truncate(p)
    fi.maybe_tear_pod(path, rank)


def _durable_write(path: str, text: str, what: str,
                   rename_to: Optional[str] = None) -> None:
    """One retry unit for a small durable text file: fault-injection hook,
    write, fsync, optional atomic rename."""

    def write():
        get_fault_injector().maybe_fail_write(rename_to or path)
        with open(path, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        if rename_to is not None:
            os.replace(path, rename_to)

    retry_io(write, what=what)


def _file_digest(path: str) -> Dict[str, int]:
    crc = 0
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            nbytes += len(chunk)
    return {"nbytes": nbytes, "crc32": crc}


# ------------------------------------------------------------ pod commit
POD_COMMIT_TIMEOUT_ENV = "DSTPU_POD_COMMIT_TIMEOUT_S"
_POD_COMMIT_TIMEOUT_S = 120.0
_POD_COMMIT_POLL_S = 0.05


def pod_commit(path: str, meta: Dict[str, Any],
               timeout_s: Optional[float] = None) -> bool:
    """Two-phase all-ranks commit of one checkpoint directory.

    Phase 1 (every rank): atomically publish this rank's manifest. Phase 2
    (rank 0): once every expected rank's manifest is present — after a
    ``torch.distributed`` barrier when a process group spans the pod, else
    by polling the shared directory — write the commit record naming the
    rank set and each rank's manifest digest. A single process runs the
    same protocol with ``world_size=1`` so the format stays uniform.
    Returns whether this rank considers the checkpoint committed."""
    import time

    from ..utils.podid import pod_identity

    t0 = time.perf_counter()
    rank, world = pod_identity()
    rm = {"version": 1, "rank": int(rank), "world_size": int(world),
          "global_steps": meta.get("global_steps")}
    rm_path = os.path.join(path, rank_manifest_name(rank))
    # atomic publish (tmp + rename): a polling rank 0 must never read a
    # half-written sibling manifest as evidence
    _durable_write(rm_path + f".tmp{os.getpid()}",
                   json.dumps(_jsonable(rm), sort_keys=True),
                   what=f"rank manifest write {rm_path}",
                   rename_to=rm_path)
    committed = True
    import torch.distributed as dist

    if world > 1 and dist.is_available() and dist.is_initialized():
        # the barrier is the phase-1 -> 2 hand-off: no rank passes it
        # before its manifest is durable
        dist.barrier()
    if rank == 0:
        committed = _commit_as_rank0(path, meta, world, timeout_s)
    from ..monitor.telemetry import metrics_registry

    metrics_registry.histogram("ckpt_pod_commit_s").observe(
        time.perf_counter() - t0)
    return committed


def _commit_as_rank0(path: str, meta: Dict[str, Any], world: int,
                     timeout_s: Optional[float]) -> bool:
    """Rank 0's phase 2: gather every rank's manifest, cross-check the
    step, write the commit record."""
    import time

    if timeout_s is None:
        try:
            timeout_s = float(os.environ.get(POD_COMMIT_TIMEOUT_ENV,
                                             _POD_COMMIT_TIMEOUT_S))
        except ValueError:
            timeout_s = _POD_COMMIT_TIMEOUT_S
    want_steps = meta.get("global_steps")
    deadline = time.monotonic() + timeout_s
    digests: Dict[int, int] = {}
    while True:
        for r in range(world):
            if r in digests:
                continue
            p = os.path.join(path, rank_manifest_name(r))
            try:
                with open(p, "rb") as f:
                    raw = f.read()
                rm = json.loads(raw.decode())
            except (OSError, ValueError):
                continue  # not there yet (publish is atomic, so no partials)
            if want_steps is not None and \
                    rm.get("global_steps") != want_steps:
                continue  # a stale manifest from an older save
            digests[r] = zlib.crc32(raw)
        if len(digests) == world:
            break
        if time.monotonic() >= deadline:
            logger.error(
                "pod commit of %s: only %d/%d rank manifest(s) appeared "
                "within %.0fs — leaving it UNCOMMITTED (torn pod)", path,
                len(digests), world, timeout_s)
            return False
        time.sleep(_POD_COMMIT_POLL_S)
    commit = {"version": 1, "world_size": int(world),
              "global_steps": want_steps,
              "ranks": {str(r): d for r, d in sorted(digests.items())}}
    commit_path = os.path.join(path, COMMIT_FILE)
    _durable_write(commit_path + f".tmp{os.getpid()}",
                   json.dumps(_jsonable(commit), indent=2, sort_keys=True),
                   what=f"pod commit write {commit_path}",
                   rename_to=commit_path)
    _counters().incr("pod_commits")
    return True


def pod_complete(path: str) -> Tuple[bool, str]:
    """Did every rank of the saving pod commit? ``(ok, reason)``. A
    directory with neither commit record nor rank manifests predates the
    protocol and counts as complete; manifests without a matching commit
    record are a torn pod."""
    try:
        names = os.listdir(path)
    except OSError as e:
        return False, f"unreadable tag dir: {e}"
    manifests = {int(m.group(1)): n for n in names
                 for m in [_RANK_MANIFEST_RE.match(n)] if m}
    commit_path = os.path.join(path, COMMIT_FILE)
    if not os.path.exists(commit_path):
        if manifests:
            return False, (f"torn pod: {len(manifests)} rank manifest(s) "
                           f"but no {COMMIT_FILE} (commit phase never ran)")
        return True, "ok (pre-pod-commit tag)"
    try:
        with open(commit_path) as f:
            commit = json.load(f)
        ranks = {int(r): int(d) for r, d in commit["ranks"].items()}
        world = int(commit["world_size"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        return False, f"unreadable {COMMIT_FILE}: {e!r}"
    if sorted(ranks) != list(range(world)):
        return False, (f"torn pod: commit names ranks {sorted(ranks)} but "
                       f"world_size is {world}")
    for r, want in sorted(ranks.items()):
        p = os.path.join(path, rank_manifest_name(r))
        try:
            with open(p, "rb") as f:
                got = zlib.crc32(f.read())
        except OSError:
            return False, f"torn pod: rank {r} manifest missing"
        if got != want:
            return False, (f"torn pod: rank {r} manifest digest {got} != "
                           f"committed {want}")
    return True, "ok"


def is_torn_pod(path: str) -> bool:
    """True when the tag carries pod-commit files that do NOT add up to a
    complete pod: the quarantine predicate of the resume-time sweep (a tag
    without the protocol's files is old, not torn)."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    has_protocol = (COMMIT_FILE in names
                    or any(_RANK_MANIFEST_RE.match(n) for n in names))
    return has_protocol and not pod_complete(path)[0]


def load_tree(path: str, template: Dict[str, Any], device=None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore ``path`` into ``template``'s structure.

    ``template`` maps top-level key -> example tree whose leaves carry
    ``shape`` and ``dtype`` (tensors on the ``meta`` device will do). Each
    leaf is read, checked against its crc32, cast to the example's dtype
    where the checkpoint's differs, and placed on ``device`` (default: the
    card), one leaf at a time. Returns ``(state, meta)``."""
    from ..device import resolve_device

    path = os.path.abspath(path)
    state = _load_native(path, template, resolve_device(device))
    meta_path = os.path.join(path, META_FILE)
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


# ---------------------------------------------------------------- native backend
def _save_native(path: str, state) -> Dict[str, Dict[str, int]]:
    """Write ``state.bin`` and its index; returns the integrity manifest's
    per-file digests (size and crc32). The file's crc32 is kept while
    writing, combined from the leaves' (``_crc32_combine``), so no file is
    read back."""
    flat = _flatten(state)
    names = ["/".join(_key_str(k) for k in p) for p, _ in flat]
    data_path = os.path.join(path, DATA_FILE)
    index_path = os.path.join(path, INDEX_FILE)
    index: List[Dict[str, Any]] = []
    data_digest: Dict[str, int] = {}

    def write_data():
        # the whole file is one retry unit: "wb" re-truncates, so a retry
        # after a partial write starts from a clean slate
        index.clear()
        get_fault_injector().maybe_fail_write(data_path)
        offset = crc = 0
        with open(data_path, "wb") as f:
            for name, (_p, leaf) in zip(names, flat):
                data, dtype, shape = _leaf_bytes(leaf)
                leaf_crc = zlib.crc32(data)
                index.append({"name": name, "offset": offset,
                              "nbytes": len(data), "dtype": dtype,
                              "shape": shape, "crc32": leaf_crc})
                f.write(data)
                crc = _crc32_combine(crc, leaf_crc, len(data))
                offset += len(data)
                del data
            f.flush()
            os.fsync(f.fileno())
        data_digest.update(nbytes=offset, crc32=crc)

    retry_io(write_data, what=f"checkpoint data write {data_path}")
    text = json.dumps(index)
    _durable_write(index_path, text,
                   what=f"checkpoint index write {index_path}")
    from ..monitor.telemetry import metrics_registry

    metrics_registry.counter("ckpt_bytes_written").incr(
        sum(e["nbytes"] for e in index))
    raw = text.encode()
    return {DATA_FILE: dict(data_digest),
            INDEX_FILE: {"nbytes": len(raw), "crc32": zlib.crc32(raw)}}


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from ``leaves`` (an
    iterator, in ``_flatten``'s order)."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, k), leaves)
                                for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if template is None:
        return None
    return next(leaves)


def _load_native(path: str, template, device: torch.device):
    with open(os.path.join(path, INDEX_FILE)) as f:
        index = json.load(f)
    by_name = {e["name"]: e for e in index}
    flat = _flatten(template)

    def leaves():
        with open(os.path.join(path, DATA_FILE), "rb") as f:
            for p, ex in flat:
                name = "/".join(_key_str(k) for k in p)
                if name not in by_name:
                    # pre-``_key_str`` bracketed formats
                    name = next((c for c in _legacy_names(name)
                                 if c in by_name), name)
                if name not in by_name:
                    raise KeyError(f"checkpoint missing leaf {name!r}")
                e = by_name[name]
                f.seek(e["offset"])
                buf = bytearray(e["nbytes"])
                got = f.readinto(buf)
                if got != e["nbytes"]:
                    raise CheckpointCorruptionError(
                        path, f"leaf {name!r} torn: wanted {e['nbytes']} "
                              f"bytes at offset {e['offset']}, file had "
                              f"{got}")
                if "crc32" in e and zlib.crc32(buf) != e["crc32"]:
                    raise CheckpointCorruptionError(
                        path, f"leaf {name!r} checksum mismatch "
                              f"(stored {e['crc32']}, got {zlib.crc32(buf)})")
                dtype = _DTYPES[e["dtype"]]
                t = (torch.frombuffer(buf, dtype=dtype) if len(buf)
                     else torch.empty((0,), dtype=dtype)).reshape(e["shape"])
                if tuple(t.shape) != tuple(ex.shape):
                    raise ValueError(
                        f"shape mismatch for {name!r}: checkpoint "
                        f"{tuple(t.shape)} vs model {tuple(ex.shape)}")
                ex_dtype = getattr(ex, "dtype", None)
                if ex_dtype is not None and t.dtype != ex_dtype:
                    # dtype-changing restore: cast at the boundary
                    t = t.to(ex_dtype)
                # own the memory on the CPU (frombuffer views the read
                # buffer); the card gets a copy either way
                yield t.to(device) if device.type != "cpu" else t.clone()

    return _unflatten(template, leaves())


# ------------------------------------------------------------ integrity
def verify_tree(path: str, deep: bool = True) -> Tuple[bool, str]:
    """Offline integrity check of one checkpoint directory: meta parses, the
    pod committed, the index is intact and the data file matches the
    manifest. Returns ``(ok, reason)`` instead of raising.

    ``deep=True`` re-reads every byte and checks crc32s; ``deep=False``
    checks structure and file sizes only (catches torn writes)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return False, "missing directory"
    meta_path = os.path.join(path, META_FILE)
    if not os.path.exists(meta_path):
        return False, f"missing {META_FILE}"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (ValueError, OSError) as e:
        return False, f"unreadable {META_FILE}: {e}"
    ok_pod, pod_reason = pod_complete(path)
    if not ok_pod:
        return False, pod_reason
    index_path = os.path.join(path, INDEX_FILE)
    if not os.path.exists(index_path):
        return False, f"missing {INDEX_FILE}"
    try:
        with open(index_path) as f:
            index = json.load(f)
    except (ValueError, OSError) as e:
        return False, f"unreadable {INDEX_FILE}: {e}"
    data_path = os.path.join(path, DATA_FILE)
    if not os.path.exists(data_path):
        return False, f"missing {DATA_FILE}"
    try:
        expected = max((e["offset"] + e["nbytes"] for e in index), default=0)
        size = os.path.getsize(data_path)
        if size < expected:
            return False, (f"torn {DATA_FILE}: {size} bytes on disk, index "
                           f"expects {expected}")
        manifest = meta.get(INTEGRITY_KEY)
        if manifest:
            for fname, want in manifest.get("files", {}).items():
                p = os.path.join(path, fname)
                if not os.path.exists(p):
                    return False, f"missing {fname}"
                if not deep:
                    size = os.path.getsize(p)
                    if size != want.get("nbytes"):
                        return False, (f"{fname} size mismatch: manifest "
                                       f"says {want.get('nbytes')}, on disk "
                                       f"{size}")
                    continue
                got = _file_digest(p)
                if got != want:
                    return False, (f"{fname} manifest mismatch: stored "
                                   f"{want}, on disk {got}")
        elif deep:
            # pre-manifest checkpoint: fall back to per-leaf crcs if present
            with open(data_path, "rb") as f:
                for e in index:
                    if "crc32" not in e:
                        continue
                    f.seek(e["offset"])
                    if zlib.crc32(f.read(e["nbytes"])) != e["crc32"]:
                        return False, (f"leaf {e['name']!r} checksum "
                                       f"mismatch")
    except (KeyError, TypeError, ValueError, AttributeError, OSError) as e:
        # valid JSON whose entries are damaged is corruption, never an
        # exception: callers walk past bad checkpoints on this answer
        return False, f"malformed index/manifest: {e!r}"
    return True, "ok"


# ------------------------------------------------------------ tag history
def _read_latest(load_dir: str) -> Optional[str]:
    latest = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        tag = f.read().strip()
    return tag or None


def _tag_steps(tag_dir: str) -> int:
    """The ``global_steps`` a tag's meta records; -1 when it is unreadable
    (a torn meta still ranks, by mtime only)."""
    try:
        with open(os.path.join(tag_dir, META_FILE)) as f:
            return int(json.load(f).get("global_steps", -1))
    except (OSError, ValueError, TypeError):
        return -1


def list_tags(load_dir: str) -> List[str]:
    """Checkpoint tags under ``load_dir``, newest first (by recorded
    ``global_steps``, then mtime: mtime alone lies after copies)."""
    out = []
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    for name in names:
        p = os.path.join(load_dir, name)
        if not os.path.isdir(p) or name.startswith(".staging") \
                or _QUARANTINE_RE.search(name):
            continue
        if not (os.path.exists(os.path.join(p, META_FILE))
                or os.path.exists(os.path.join(p, INDEX_FILE))
                or os.path.isdir(os.path.join(p, STATE_DIR))):
            continue
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            continue  # renamed or deleted under the walk (a quarantine)
        out.append((_tag_steps(p), mtime, name))
    out.sort(reverse=True)
    return [name for _, _, name in out]


def _candidate_tags(load_dir: str) -> Tuple[Optional[str], List[str]]:
    """The candidate order every fallback walk shares: the tag ``latest``
    names first, then the others newest first."""
    pointed = _read_latest(load_dir)
    candidates = [pointed] if pointed is not None else []
    candidates.extend(t for t in list_tags(load_dir) if t != pointed)
    return pointed, candidates


# names quarantine_tag makes: <tag>.corrupt, <tag>.corrupt.1, ... (list_tags
# skips every generation, or a quarantined tag would re-enter the walk)
_QUARANTINE_RE = re.compile(r"\.corrupt(\.\d+)?$")


def quarantine_tag(path: str) -> str:
    """Rename a corrupt tag out of the candidate walk, keeping it on disk as
    evidence, under a name no earlier quarantine took."""
    dst = path + ".corrupt"
    n = 1
    while os.path.exists(dst):
        dst = f"{path}.corrupt.{n}"
        n += 1
    os.replace(path, dst)
    return dst


def find_latest_valid_tag(load_dir: str, deep: bool = True
                          ) -> Tuple[Optional[str], List[Tuple[str, str]]]:
    """Newest tag that passes :func:`verify_tree`, ``latest``'s first,
    walking back past corrupt or torn tags. Returns ``(tag or None,
    [(skipped tag, reason), ...])``; ``deep=False`` skips the crc re-read
    (right when the caller streams the tag next: the reader checks every
    leaf's crc32)."""
    skipped: List[Tuple[str, str]] = []
    _, candidates = _candidate_tags(load_dir)
    for tag in candidates:
        ok, reason = verify_tree(os.path.join(load_dir, tag), deep=deep)
        if ok:
            return tag, skipped
        skipped.append((tag, reason))
    return None, skipped


def promote_last_good(save_dir: str, tag: str) -> None:
    """Durably point ``last_good`` at ``tag`` (the training sentinel, once
    it has seen K healthy steps beyond the tag's step)."""
    path = os.path.join(save_dir, LAST_GOOD_FILE)
    _durable_write(path + f".tmp{os.getpid()}", tag,
                   what=f"last_good pointer -> {tag}", rename_to=path)


def read_last_good(load_dir: str) -> Optional[str]:
    try:
        with open(os.path.join(load_dir, LAST_GOOD_FILE)) as f:
            tag = f.read().strip()
    except OSError:
        return None
    return tag or None


def find_last_good_tag(load_dir: str, deep: bool = False
                       ) -> Tuple[Optional[str], List[Tuple[str, str]]]:
    """Newest promoted tag that passes :func:`verify_tree`: the tag
    ``last_good`` names, then only tags whose recorded ``global_steps`` is
    no newer (an unpromoted newer tag may hold diverged state). Returns
    ``(tag or None, [(skipped tag, reason), ...])``."""
    skipped: List[Tuple[str, str]] = []
    promoted = read_last_good(load_dir)
    if promoted is None:
        return None, skipped
    tags = list_tags(load_dir)
    steps_of = {t: _tag_steps(os.path.join(load_dir, t)) for t in tags}
    cap = steps_of.get(promoted, -1)
    candidates = [promoted] + [t for t in tags if t != promoted
                               and 0 <= steps_of[t] <= cap]
    for tag in candidates:
        ok, reason = verify_tree(os.path.join(load_dir, tag), deep=deep)
        if ok:
            return tag, skipped
        skipped.append((tag, reason))
    return None, skipped


def load_latest_valid(load_dir: str, template: Dict[str, Any], device=None
                      ) -> Tuple[Optional[str], Any, Dict[str, Any]]:
    """Load the newest verified checkpoint under ``load_dir``, falling back
    through tag history on corruption. Candidates are verified shallowly
    (the reader checks every leaf's crc32 and raises
    :class:`CheckpointCorruptionError`, which quarantines the tag and moves
    on). Returns ``(tag, state, meta)``, or ``(None, None, {})``."""
    counters = _counters()
    pointed, candidates = _candidate_tags(load_dir)
    skipped_any = False
    for tag in candidates:
        path = os.path.join(load_dir, tag)
        ok, reason = verify_tree(path, deep=False)
        if not ok:
            logger.warning("skipping corrupt checkpoint %s: %s", path, reason)
            counters.incr("corrupt_tags_skipped")
            skipped_any = True
            continue
        try:
            state, meta = load_tree(path, template, device=device)
        except CheckpointCorruptionError as e:
            logger.warning("checkpoint %s corrupt on read (%s); quarantining",
                           path, e.reason)
            counters.incr("corrupt_tags_skipped")
            skipped_any = True
            quarantine_tag(path)
            continue
        if tag != pointed or skipped_any:
            counters.incr("fallback_loads")
            logger.warning("fallback load: resumed %s (latest pointer was "
                           "%r)", path, pointed)
        return tag, state, meta
    return None, None, {}


def rotate_checkpoints(save_dir: str, keep_last_n: int) -> List[str]:
    """Delete old tags, keeping the newest ``keep_last_n`` verified ones.
    Deletes only verified tags older than those; never the tag ``latest``
    or ``last_good`` names, never a corrupt one (evidence). Returns the
    deleted tags."""
    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    pinned = {_read_latest(save_dir), read_last_good(save_dir)}
    # shallow: rotation runs after every save, and a full crc pass would
    # re-read every kept tag each time
    verified = [t for t in list_tags(save_dir)
                if verify_tree(os.path.join(save_dir, t), deep=False)[0]]
    doomed = [t for t in verified[keep_last_n:] if t not in pinned]
    for tag in doomed:
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        logger.info("rotated out checkpoint %s", os.path.join(save_dir, tag))
    if doomed:
        _counters().incr("checkpoints_rotated", len(doomed))
    return doomed


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj
