"""Collective census vs analytic expectation for one train step.

Port of ``deepspeedsyclsupport_tpu/analysis/collectives.py``: the same
expectation, classes and checker, with the same names, fields and rules.
What differs is where the census comes from. The JAX package parses the
compiled step's HLO (one entry per collective INSTRUCTION: a loop body's
collective counts once); the port has no compiled program, so its census
is the comms logger's record window of the last step
(``comm/comms_logging.py``): one entry per collective CALL the step made,
in ``hlo_comms.parse_collectives``'s conventions (HLO opcode, RESULT
bytes, a group of one member no entry).

What can be *exactly* predicted and what can't (as in the JAX package):

* **param-gather** traffic (ZeRO-3 all-gather of fsdp-sharded params) is
  canonical: one full-bytes all-gather per sharded param per use. The
  port gathers a leaf in each micro-batch's forward and again in its
  backward (it keeps no gathered param between them) except where the
  backward does not read it (the embedding's lookup keeps the ids);
* **grad-sync** traffic is semantically fixed but its lowering is a
  choice: the port reduce-scatters a ZeRO-2/3 gradient, whose RESULT is
  the shard, so the classifier (which matches full leaf bytes) puts it in
  ``other``, in the JAX package and in the port alike. The classes are
  checked as totals, not opcode lists;
* anything unclassified is a **reshard suspect** (``resharding.py``).

``_leaf_entries`` reads the port's tree: nested dicts and lists of
tensors (a ``capture.abstract_step_args`` stand-in of the full shapes, or
numpy arrays), each leaf's spec from ``param_shardings``: a dict keyed by
path (the engine's ``_specs``, ``(dim entries of axis names)``) or a tree
of specs or of objects with a ``spec`` (a JAX ``NamedSharding``).
"""
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: collectives ≤ this payload are scalar control sync (loss means, overflow
#: flags, grad-norm reductions) — never param/grad traffic
SCALAR_BYTES = 64

#: the keys of one census entry
CENSUS_KEYS = ("op", "bytes", "shape", "group_size")


def collective_census(window: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """Every data-moving collective of a step: ``[{op, bytes, shape,
    group_size}]``, from a comms-logger record window (the engine keeps
    its last step's)."""
    out = [dict(e) for e in window]
    for e in out:
        missing = [k for k in CENSUS_KEYS if k not in e]
        if missing:
            raise ValueError(f"census entry {e} lacks {missing}")
    return out


# ----------------------------------------------------------------- the tree
def _walk(tree, path=()):
    """(path, leaf) pairs of nested dicts and lists (dict keys sorted, as
    ``jax.tree_util.tree_leaves`` orders them)."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _spec_walk(tree, path=()):
    """(path, spec) pairs of a tree of specs: a tuple, or an object with a
    ``spec`` (``NamedSharding``), is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _spec_walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_walk(v, path + (i,))
    else:
        yield path, getattr(tree, "spec", tree)


def _specs_by_path(shardings: Any) -> Dict[Tuple, Any]:
    if shardings is None:
        return {}
    if isinstance(shardings, dict) and shardings and all(
            isinstance(k, tuple) for k in shardings):
        return {k: getattr(v, "spec", v) for k, v in shardings.items()}
    return dict(_spec_walk(shardings))


def _itemsize(leaf) -> int:
    size = getattr(leaf, "element_size", None)
    if callable(size):
        return int(size())
    return np.dtype(getattr(leaf, "dtype", np.float32)).itemsize


def _leaf_entries(tree: Any, shardings: Any = None,
                  itemsize: int = None) -> List[Tuple[int, bool]]:
    """[(full_bytes, fsdp_sharded)] per array leaf of ``tree``.
    ``itemsize`` overrides each leaf's dtype width — ``itemsize=1`` yields
    the int8-transport byte signature of every leaf (the quantized
    collectives' payload size, ``comm/quantized.py``)."""
    specs = _specs_by_path(shardings)
    out = []
    for path, leaf in _walk(tree):
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if not shape:
            continue  # scalars sync in the scalar class
        nbytes = int(math.prod(shape)) * (itemsize or _itemsize(leaf))
        spec = specs.get(path, getattr(getattr(leaf, "sharding", None),
                                       "spec", None)) or ()
        axes = {a for e in spec for a in
                ((e,) if not isinstance(e, tuple) else e) if a}
        out.append((nbytes, "fsdp" in axes))
    return out


# ---------------------------------------------------------------- expectation
@dataclass
class CollectiveExpectation:
    """Analytic per-step expectation derived from the parallelism config.

    Byte counts are payload bytes (full logical result), matching the
    census; wire bytes per device are ``(N-1)/N`` of that for ring
    implementations — a constant factor that cancels in expected-vs-observed
    comparison.
    """
    param_gather_count: int          # sharded params × gathers_per_param
    param_gather_bytes: int          # Σ full bytes of fsdp-sharded params
    grad_sync_count: int             # grad leaves needing cross-batch sum
    grad_sync_bytes: int             # Σ full bytes of those grads
    group_size: int                  # devices in the batch-splitting group
    scalar_sync_max_bytes: int = 16 * SCALAR_BYTES
    notes: Dict[str, Any] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return self.param_gather_bytes + self.grad_sync_bytes


def expected_train_collectives(params: Any, topo: Any, stage: int,
                               param_shardings: Any = None,
                               grad_shardings: Any = None,
                               gathers_per_param: int = 1,
                               ) -> CollectiveExpectation:
    """Canonical per-step expectation for one train step (JAX
    ``expected_train_collectives``, the same rules):

    * stage 3: each fsdp-sharded param is all-gathered
      ``gathers_per_param`` times; every grad leaf is summed across
      (data, fsdp).
    * stage 0-2: params replicated (no gather class); every grad leaf is
      summed across the batch-splitting axes.

    ``topo``: anything with ``axis_sizes`` (None: one device).
    """
    entries = _leaf_entries(params, param_shardings)
    grad_entries = (_leaf_entries(params, grad_shardings)
                    if grad_shardings is not None else entries)
    sharded = [(b, s) for b, s in entries if s] if stage >= 3 else []
    axes = getattr(topo, "axis_sizes", None) or {}
    group = axes.get("data", 1) * axes.get("fsdp", 1)
    # a group of 1 moves no bytes: no collective runs over a single-member
    # axis, so the expectation must be zero or the conservation check
    # flags a correct single-device step
    if axes.get("fsdp", 1) == 1:
        sharded = []
    if group == 1:
        grad_entries = []
    return CollectiveExpectation(
        param_gather_count=len(sharded) * gathers_per_param,
        param_gather_bytes=sum(b for b, _ in sharded) * gathers_per_param,
        grad_sync_count=len(grad_entries),
        grad_sync_bytes=sum(b for b, _ in grad_entries),
        group_size=group,
        notes={"stage": stage, "gathers_per_param": gathers_per_param,
               "n_param_leaves": len(entries),
               "n_sharded_params": len(sharded)})


# ------------------------------------------------------------- classification
@dataclass
class CollectiveClasses:
    """Observed census split into traffic classes."""
    param_gather: List[Dict[str, Any]] = field(default_factory=list)
    grad_sync: List[Dict[str, Any]] = field(default_factory=list)
    scalar_sync: List[Dict[str, Any]] = field(default_factory=list)
    other: List[Dict[str, Any]] = field(default_factory=list)

    def bytes_of(self, cls: str) -> int:
        return sum(e["bytes"] for e in getattr(self, cls))

    def counts(self) -> Dict[str, int]:
        return {c: len(getattr(self, c)) for c in
                ("param_gather", "grad_sync", "scalar_sync", "other")}

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {c: {"count": len(getattr(self, c)),
                    "total_bytes": self.bytes_of(c)}
                for c in ("param_gather", "grad_sync", "scalar_sync", "other")}


GRAD_SYNC_OPS = ("all-reduce", "reduce-scatter")


def classify_collectives(census: Sequence[Dict[str, Any]],
                         params: Any,
                         param_shardings: Any = None,
                         ) -> CollectiveClasses:
    """Attribute each observed collective to a traffic class by byte-matching
    against the param tree (JAX ``classify_collectives``, the same rules):

    * ``param_gather`` — an all-gather whose payload equals a sharded
      param's full bytes;
    * ``grad_sync`` — an all-reduce/reduce-scatter whose payload equals any
      param leaf's full bytes (grads are param-shaped);
    * ``scalar_sync`` — payload ≤ ``SCALAR_BYTES`` (loss/overflow/norm);
    * ``other`` — everything else: quantization scale sidecars, the
      reduce-scatters whose result is a shard, and genuine resharding
      traffic.

    Quantized transports (ZeRO++ qwZ int8 all-gather / qgZ int8
    all-to-all quant-reduce, ``comm/quantized.py``) are recognized by the
    ONE-byte-per-element signature; their fp32 block scales land in
    ``other``/``scalar_sync``. (A same-dtype leaf whose byte size collides
    with another leaf's element count is caught by the full-dtype clauses
    first.)
    """
    entries = _leaf_entries(params, param_shardings)
    param_sizes = {b for b, _ in entries}
    sharded_sizes = {b for b, s in entries if s}
    q_entries = _leaf_entries(params, param_shardings, itemsize=1)
    q_param_sizes = {b for b, _ in q_entries}
    q_sharded_sizes = {b for b, s in q_entries if s}
    out = CollectiveClasses()
    for rec in census:
        if rec["bytes"] <= SCALAR_BYTES:
            out.scalar_sync.append(rec)
        elif rec["op"] == "all-gather" and rec["bytes"] in sharded_sizes:
            out.param_gather.append(rec)
        elif rec["op"] == "all-gather" and rec["bytes"] in q_sharded_sizes:
            out.param_gather.append(rec)
        elif rec["op"] in GRAD_SYNC_OPS and rec["bytes"] in param_sizes:
            out.grad_sync.append(rec)
        elif rec["op"] in GRAD_SYNC_OPS + ("all-to-all",) \
                and rec["bytes"] in q_param_sizes:
            out.grad_sync.append(rec)
        else:
            out.other.append(rec)
    return out


# -------------------------------------------------------------------- checker
@dataclass
class CollectiveCheck:
    ok: bool
    classes: CollectiveClasses
    expectation: CollectiveExpectation
    problems: List[str] = field(default_factory=list)

    def report(self) -> str:
        lines = [f"collective census check: {'OK' if self.ok else 'FAIL'}"]
        exp = self.expectation
        s = self.classes.summary()
        lines.append(f"  param_gather: observed {s['param_gather']['count']} "
                     f"ops / {s['param_gather']['total_bytes']} B, expected "
                     f"{exp.param_gather_count} / {exp.param_gather_bytes} B")
        lines.append(f"  grad_sync:    observed {s['grad_sync']['count']} "
                     f"ops / {s['grad_sync']['total_bytes']} B, expected "
                     f"{exp.grad_sync_count} / {exp.grad_sync_bytes} B")
        lines.append(f"  scalar_sync:  {s['scalar_sync']['count']} ops / "
                     f"{s['scalar_sync']['total_bytes']} B")
        lines.append(f"  other:        {s['other']['count']} ops / "
                     f"{s['other']['total_bytes']} B")
        lines.extend(f"  PROBLEM: {p}" for p in self.problems)
        return "\n".join(lines)


def check_collectives(census: Sequence[Dict[str, Any]],
                      expectation: CollectiveExpectation,
                      params: Any,
                      param_shardings: Any = None,
                      exact: bool = True,
                      other_budget_bytes: int = 0) -> CollectiveCheck:
    """Compare an observed census against the analytic expectation (JAX
    ``check_collectives``, the same rules and messages).

    ``exact=True`` demands class totals equal the expectation and the
    ``other`` class stay within ``other_budget_bytes``. ``exact=False``
    only enforces the conservation law — observed param-gather bytes never
    *exceed* the expectation and grad sync is not silently missing when
    the expectation requires it.
    """
    classes = classify_collectives(census, params, param_shardings)
    problems: List[str] = []
    pg_bytes, gs_bytes = classes.bytes_of("param_gather"), classes.bytes_of("grad_sync")
    if exact:
        if len(classes.param_gather) != expectation.param_gather_count:
            problems.append(
                f"param_gather count {len(classes.param_gather)} != expected "
                f"{expectation.param_gather_count}")
        if pg_bytes != expectation.param_gather_bytes:
            problems.append(f"param_gather bytes {pg_bytes} != expected "
                            f"{expectation.param_gather_bytes}")
        if gs_bytes != expectation.grad_sync_bytes:
            problems.append(f"grad_sync bytes {gs_bytes} != expected "
                            f"{expectation.grad_sync_bytes}")
        if classes.bytes_of("other") > other_budget_bytes:
            problems.append(
                f"unclassified collective traffic {classes.bytes_of('other')} B "
                f"exceeds budget {other_budget_bytes} B (resharding suspect — "
                f"see resharding_audit)")
    else:
        if pg_bytes > expectation.param_gather_bytes:
            problems.append(f"param_gather bytes {pg_bytes} exceed analytic "
                            f"budget {expectation.param_gather_bytes}")
        if expectation.grad_sync_bytes and not (
                gs_bytes or classes.other):
            problems.append("no grad-sync traffic observed but the config "
                            "requires cross-batch gradient summation")
    scalar = classes.bytes_of("scalar_sync")
    if scalar > expectation.scalar_sync_max_bytes:
        problems.append(f"scalar sync {scalar} B exceeds "
                        f"{expectation.scalar_sync_max_bytes} B — a tensor is "
                        f"hiding in the scalar class or control sync grew")
    groups = {e.get("group_size") for e in census if e.get("group_size")}
    bad_groups = groups - {expectation.group_size, None}
    if bad_groups and exact:
        problems.append(f"collectives over unexpected group sizes "
                        f"{sorted(bad_groups)} (expected "
                        f"{expectation.group_size})")
    return CollectiveCheck(ok=not problems, classes=classes,
                           expectation=expectation, problems=problems)
