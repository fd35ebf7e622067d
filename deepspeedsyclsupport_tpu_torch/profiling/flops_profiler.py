"""FLOPS profiler: one real step's aten ops, counted under a dispatch mode.

Port of ``deepspeedsyclsupport_tpu/profiling/flops_profiler.py``
(reference ``deepspeed/profiling/flops_profiler/profiler.py``). The JAX
package counts a traced jaxpr; an eager port has no program to read, so
:class:`OpCounter` (a ``TorchDispatchMode``) sees every aten op one real
step runs — forward, backward (the autograd engine's ops reach the mode
on its threads too) and the optimizer — and prices each with the JAX
package's rules (``eqn_flops``):

* a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a convolution):
  ``2·M·N·K`` (times the batch); ``addmm``'s bias add is elementwise;
* an elementwise op (``torch.Tag.pointwise``, the ``_foreach_`` family):
  the result's element count — comparisons, logical and bitwise ops and
  dtype conversions cost nothing, as in JAX's ``_CHEAP`` list;
* a reduction (``torch.Tag.reduction``, softmax, the norms): the INPUT's
  element count.

Bytes (the roofline's HBM floor, ``analysis/roofline.py``): products,
reductions and data movement read their inputs and write their results;
an elementwise op counts its result only (its inputs fuse into their
producer, the JAX rule); a view moves nothing. Collectives (``c10d``)
count their payload as comm bytes in the ``collective`` region.

The port's CUDA kernels are ``ctypes`` calls that no dispatch mode sees:
their wrappers report their own work to the active counter
(:func:`report_kernel`), counted as their plain versions' products count
it, and a wrapper on a CPU tensor takes its plain version, whose ops the
mode counts, and does not report — each product is counted once.

Every op is attributed to an MFU region (``monitor/mfu.py``): the
innermost :func:`~..monitor.mfu.region_scope` open on the op's thread;
an op the autograd engine runs for a node takes the region its forward op
ran in (the node's sequence number lies in a scope's interval of them);
else ``other``.
"""
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..device import resolve_device
from ..monitor import mfu
from ..utils.logging import logger


@dataclass
class Profile:
    total_flops: float                 # analytical, fwd(+bwd if one ran)
    total_params: int
    by_primitive: Dict[str, float] = field(default_factory=dict)  # aten op

    def flops_str(self) -> str:
        return _human(self.total_flops, "FLOPs")

    def summary(self, top: int = 10) -> str:
        lines = [f"params: {_human(self.total_params, '')}",
                 f"flops:  {self.flops_str()}"]
        worst = sorted(self.by_primitive.items(), key=lambda kv: -kv[1])[:top]
        width = max((len(k) for k, _ in worst), default=0)
        for k, v in worst:
            share = 100.0 * v / max(self.total_flops, 1.0)
            lines.append(f"  {k:<{width}} {_human(v, 'FLOPs'):>12} "
                         f"({share:4.1f}%)")
        return "\n".join(lines)


def _human(x: float, unit: str) -> str:
    for scale, pfx in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= scale:
            return f"{x / scale:.2f} {pfx}{unit}"
    return f"{x:.0f} {unit}"


# ------------------------------------------------------------------ the rules
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "cumsum", "argmax", "argmin", "norm",
               "linalg_vector_norm", "var", "std", "_softmax",
               "_log_softmax", "_foreach_norm", "all", "any"}
# pointwise-tagged ops that JAX's _CHEAP list does not cost
_FREE = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
         "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
         "bitwise_not", "bitwise_xor", "isnan", "isinf", "isfinite",
         "_to_copy", "copy", "copy_", "clone", "_foreach_copy_"}
_FACTORIES_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
                   "new_empty_strided"}
_REDUCTION_TAG = getattr(torch.Tag, "reduction", None)


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts: List[torch.Tensor]) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def product_flops(name: str, args: Tuple, out: Any = None) -> float:
    """``2·M·N·K`` (times the batch) of a product's operands; a
    convolution's ``2 · output elements · (Cin / groups) · kernel
    elements`` (its weight is ``[Cout, Cin / groups, *kernel]``)."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * out.numel() * float(args[1][0].numel())


def op_cost(func, args: Tuple, kwargs: Dict[str, Any], out: Any
            ) -> List[Tuple[str, float, float]]:
    """``[(kind, flops, bytes), ...]`` of one aten op under the rules above
    (kind ``matmul``, ``elementwise``, ``reduction``, ``collective``,
    ``movement`` or ``view``); ``addmm`` / ``baddbmm`` give a product and
    an elementwise part."""
    name = func.overloadpacket.__name__
    ns = func.namespace
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    inplace = name.endswith("_") and not name.startswith("__")
    result = outs or (_tensors(args[0]) if args else [])
    if ns in ("c10d", "_c10d_functional", "c10d_functional"):
        return [("collective", 0.0, _nbytes(result or ins))]
    if _is_view(func) and not inplace:
        return [("view", 0.0, 0.0)]
    if name in _PRODUCTS:
        f = product_flops(name, args, outs[0] if outs else None)
        cost = [("matmul", f, _nbytes(ins) + _nbytes(outs))]
        if name in ("addmm", "baddbmm"):
            cost.append(("elementwise", float(outs[0].numel()), 0.0))
        return cost
    if name in _REDUCTIONS or (_REDUCTION_TAG is not None
                               and _REDUCTION_TAG in func.tags):
        src = _tensors(args[0]) if args else ins
        return [("reduction", float(sum(t.numel() for t in src)),
                 _nbytes(ins) + _nbytes(outs))]
    if name in _FACTORIES_FREE:
        return [("movement", 0.0, 0.0)]
    pointwise = torch.Tag.pointwise in func.tags or (
        name.startswith("_foreach_") and name not in _FREE)
    if pointwise and name not in _FREE:
        n = float(sum(t.numel() for t in result))
        return [("elementwise", n, _nbytes(result))]
    return [("movement", 0.0, _nbytes(ins) + _nbytes(outs))]


# ------------------------------------------------------------ the counter
_ACTIVE: List["OpCounter"] = []


def active_counter() -> Optional["OpCounter"]:
    """The innermost counter counting now (None: none)."""
    return _ACTIVE[-1] if _ACTIVE else None


def report_kernel(name: str, flops: float, nbytes: float,
                  pairs: Optional[float] = None) -> None:
    """A hand-written kernel's own count, reported by its wrapper when it
    launches (a dispatch mode cannot see a ``ctypes`` call): ``flops``
    counted as its plain version's products count them, ``nbytes`` each
    input read once and each output written once, ``pairs`` the visible
    (query, key) pairs it needed. No-op when no counter is active."""
    c = active_counter()
    if c is not None:
        c.add(name, "matmul", flops, nbytes, pairs=pairs)


class OpCounter(TorchDispatchMode):
    """Counts one stretch of real execution, op by op, per MFU region.

    ``records``: ``{(region, kind, op): [calls, flops, bytes]}``;
    ``pairs``: ``{(region, op): visible pairs}`` of the kernels that
    reported them. Use as a context manager around the step."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch wraps a mode's __torch_dispatch__ in a lazy
        # torch._disable_dynamo unless this says no: its first call imports
        # torch._dynamo (seconds) inside the counted step, and that import
        # keeps the frames of its caller — the engine's step — alive
        return False

    def __init__(self):
        super().__init__()
        self.records: Dict[Tuple[str, str, str], List[float]] = {}
        self.pairs: Dict[Tuple[str, str], float] = {}
        self._local = threading.local()
        # (thread, first sequence number, end, region) of each region
        # scope: an autograd node made inside one belongs to its region
        self._intervals: List[Tuple[int, int, int, str]] = []
        self._prev_observer: Any = None
        # what else rides the dispatch: objects with ``observe(func, args,
        # kwargs, out)`` (the dtype audit, ``analysis/dtype_audit.py``)
        self.observers: List[Any] = []

    # ------------------------------------------------ the scope observer
    def _stack(self) -> List[Tuple[str, int]]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def enter(self, region: str):
        self._stack().append((region, _seq()))
        return region

    def exit(self, token) -> None:
        stack = self._stack()
        if stack:
            region, lo = stack.pop()
            self._intervals.append((threading.get_ident(), lo, _seq(),
                                    region))

    def region(self) -> str:
        """The region of the op about to be counted on this thread."""
        stack = self._stack()
        if stack:
            return stack[-1][0]
        node = torch._C._current_autograd_node()
        if node is None:
            return "other"
        seq = node._sequence_nr()
        me = threading.get_ident()
        best = None
        for mine in (True, False):
            for thread, lo, hi, region in self._intervals:
                if (thread == me) == mine and lo <= seq < hi and (
                        best is None or lo > best[0]):
                    best = (lo, region)
            if best is not None:
                return best[1]
        return "other"

    # ---------------------------------------------------------- counting
    def add(self, op: str, kind: str, flops: float, nbytes: float,
            region: Optional[str] = None,
            pairs: Optional[float] = None) -> None:
        region = region or self.region()
        if kind == "collective":
            region = "collective"
        row = self.records.setdefault((region, kind, op), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if pairs is not None:
            key = (region, op)
            self.pairs[key] = self.pairs.get(key, 0.0) + float(pairs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for obs in self.observers:
            obs.observe(func, args, kwargs, out)
        try:
            cost = op_cost(func, args, kwargs, out)
        except Exception as e:  # an op the rules cannot read: say so
            logger.warning("flops profiler: %s not counted (%s)", func, e)
            return out
        region = self.region()
        for kind, flops, nbytes in cost:
            self.add(func.overloadpacket.__name__, kind, flops, nbytes,
                     region=region)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        self._prev_observer = mfu._observer
        mfu.set_scope_observer(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            mfu.set_scope_observer(self._prev_observer)
            _ACTIVE.remove(self)

    # ---------------------------------------------------------- readouts
    def total_flops(self, kind: Optional[str] = None) -> float:
        return float(sum(v[1] for (r, k, o), v in self.records.items()
                         if kind is None or k == kind))

    def by_op(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (_, _, op), v in self.records.items():
            if v[1]:
                out[op] = out.get(op, 0.0) + v[1]
        return out

    def by_region(self) -> Dict[str, Dict[str, float]]:
        """``{region: {"flops", "hbm_bytes", "comm_bytes", "n_ops",
        "matmul_flops"}}`` over every region of ``monitor/mfu.REGIONS``
        but ``host``."""
        out = {r: {"flops": 0.0, "hbm_bytes": 0.0, "comm_bytes": 0.0,
                   "n_ops": 0, "matmul_flops": 0.0}
               for r in mfu.REGIONS if r != "host"}
        for (region, kind, _), (calls, flops, nbytes) in \
                self.records.items():
            row = out.setdefault(region, {"flops": 0.0, "hbm_bytes": 0.0,
                                          "comm_bytes": 0.0, "n_ops": 0,
                                          "matmul_flops": 0.0})
            row["flops"] += flops
            row["n_ops"] += int(calls)
            if kind == "collective":
                row["comm_bytes"] += nbytes
            else:
                row["hbm_bytes"] += nbytes
            if kind == "matmul":
                row["matmul_flops"] += flops
        return out


def _seq() -> int:
    """The sequence number the next autograd node made on this thread
    will take."""
    return int(torch._C._autograd._get_sequence_nr())


# ------------------------------------------------------------------ public API
def profile_fn(fn: Callable, *args, **kwargs) -> Profile:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return its :class:`Profile` (``total_params``: the elements of
    ``args[0]``'s tensors)."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return profile_of(c, args[0] if args else None)


def profile_of(counter: OpCounter, params: Any = None) -> Profile:
    n_params = int(sum(t.numel() for t in _tensors(params))) \
        if params is not None else 0
    return Profile(total_flops=counter.total_flops(),
                   total_params=n_params, by_primitive=counter.by_op())


def get_model_profile(model, batch_size: int = 1, seq_len: int = 128,
                      params: Any = None, device: Any = None) -> Profile:
    """Model-level convenience (reference ``get_model_profile``): one
    forward of a ``CausalLM``-protocol model on ``device``, counted.
    ``None`` means the card (:func:`resolve_device`); ``params``, when
    given, must lie on that device."""
    dev = resolve_device(device)
    params = params if params is not None else model.init_params(
        device=dev)
    ids = torch.zeros((batch_size, seq_len), dtype=torch.long, device=dev)
    return profile_fn(lambda p, x: model.apply(p, x), params, ids)


class FlopsProfiler:
    """Engine-attached profiler (reference ``FlopsProfiler`` lifecycle):
    the engine counts step ``flops_profiler.profile_step`` under an
    :class:`OpCounter` (:meth:`wants`) and hands it here (:meth:`record`),
    which logs the profile and writes ``output_file``. It holds the
    ``flops_profiler`` config, not the engine (an engine must be freed
    when its last reference goes, without waiting for the collector)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.profile: Optional[Profile] = None
        self.counter: Optional[OpCounter] = None

    def wants(self, step: int) -> bool:
        return self.cfg.enabled and step == self.cfg.profile_step

    def record(self, counter: OpCounter, step: int, params: Any) -> Profile:
        self.counter = counter
        self.profile = profile_of(counter, params)
        text = f"flops profiler @ step {step}:\n{self.profile.summary()}"
        if self.cfg.output_file:
            with open(self.cfg.output_file, "w") as f:
                f.write(text + "\n")
        logger.info(text)
        return self.profile
