"""Dtype-promotion audit: float32 upcasts hiding inside a bf16 / fp16 step.

Port of ``deepspeedsyclsupport_tpu/analysis/dtype_audit.py``. The JAX
package walks the step's jaxpr, where every promotion is a
``convert_element_type`` equation. The port watches the step's aten ops
as they run (a ``TorchDispatchMode``, or riding the flops profiler's
``OpCounter`` dispatch as one of its observers): an op whose result is
float32 and one of whose floating inputs is bf16 / fp16 upcasts that
input, whether it is a cast (``_to_copy``, ``copy_``) or a promotion
inside the op (``add`` of a bf16 and a float32 tensor). Eager execution
has no loop to multiply by: the same upcast (source dtype and shape) made
``k`` times in a step is one entry of ``mult`` ``k``, its bytes ``k``
times one copy's (JAX: a scan body's trip count).

Sanctioned promotions (the master-weight pattern) are excluded by shape,
as in the JAX package: param-shaped upcasts (``allowed_shapes``; a leading
stacked dim allowed before a matrix shape) are the point of mixed
precision. What gets flagged are *activation-shaped* upcasts of at least
``min_elements`` elements.
"""
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

LOW_DTYPES = ("bfloat16", "float16")
#: upcasts below this element count are noise (loss terms, norms, indices)
DEFAULT_MIN_ELEMENTS = 4096
_LOW = {torch.bfloat16, torch.float16}


@dataclass
class DtypeReport:
    ok: bool
    upcasts: List[Dict[str, Any]] = field(default_factory=list)
    total_upcast_bytes: int = 0      # extra bytes materialized at f32
    sanctioned: int = 0              # param-shaped (master-weight) upcasts

    def report(self) -> str:
        lines = [f"dtype audit: {'OK' if self.ok else 'FAIL'} "
                 f"({len(self.upcasts)} activation upcasts, "
                 f"{self.total_upcast_bytes} B widened, "
                 f"{self.sanctioned} param-shaped upcasts sanctioned)"]
        for u in self.upcasts:
            lines.append(f"  UPCAST {u['from']} -> {u['to']} at shape "
                         f"{u['shape']} x{u['mult']:g} ({u['bytes']} B)")
        return "\n".join(lines)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


class DtypeAudit(TorchDispatchMode):
    """Records the upcasts of the ops it sees: as a context manager around
    the code to audit, or as an ``OpCounter`` observer (:meth:`observe`).
    :meth:`report` applies the allowed shapes and the size floor."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False   # as OpCounter: no torch._dynamo import mid-step

    def __init__(self):
        super().__init__()
        # (source dtype, shape) -> times seen
        self.seen: Dict[Tuple[str, Tuple[int, ...]], int] = {}

    def observe(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        if not outs or outs[0].dtype != torch.float32:
            return
        for t in _tensors((args, kwargs)):
            if t.dtype in _LOW:
                key = (str(t.dtype).replace("torch.", ""), tuple(t.shape))
                self.seen[key] = self.seen.get(key, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.observe(func, args, kwargs, out)
        return out

    def report(self, allowed_shapes: Optional[Sequence[Tuple[int, ...]]]
               = None, min_elements: int = DEFAULT_MIN_ELEMENTS
               ) -> DtypeReport:
        allowed: Set[Tuple[int, ...]] = {tuple(s) for s in
                                         (allowed_shapes or ())}
        upcasts: List[Dict[str, Any]] = []
        sanctioned = total = 0
        for (src, shape), mult in self.seen.items():
            n = 1
            for d in shape:
                n *= d
            if n < min_elements:
                continue
            if shape in allowed or (len(shape) > 2 and shape[1:] in allowed):
                # param-shaped (incl. a stacked leading dim before a
                # MATRIX): the master-weight upcast, sanctioned; a 1-D
                # allowed shape (a bias) does not excuse (batch, dim)
                sanctioned += 1
                continue
            nbytes = int(n * 2 * mult)   # the f32 copy minus the source
            upcasts.append({"from": src, "to": "float32", "shape": shape,
                            "mult": mult, "bytes": nbytes})
            total += nbytes
        return DtypeReport(ok=not upcasts, upcasts=upcasts,
                           total_upcast_bytes=total, sanctioned=sanctioned)


def dtype_audit(fn: Callable, *args: Any,
                allowed_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                min_elements: int = DEFAULT_MIN_ELEMENTS,
                **kwargs: Any) -> DtypeReport:
    """Run ``fn(*args, **kwargs)`` under a :class:`DtypeAudit` and report
    its low -> f32 promotions (JAX ``dtype_audit`` traces ``fn`` instead;
    here it runs, on whatever device its inputs are)."""
    with DtypeAudit() as audit:
        fn(*args, **kwargs)
    return audit.report(allowed_shapes, min_elements)
