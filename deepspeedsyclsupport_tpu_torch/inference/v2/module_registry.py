"""Pluggable layer-implementation registry + selection heuristics.

Analog of the reference's v2 module system (``inference/v2/modules/
module_registry.py`` ConfigBundle/registry and ``modules/heuristics.py``
``instantiate_attn``-style pickers): each module KIND (prefill attention,
decode attention) has named implementations registered with an availability
predicate and a preference priority; configs name an impl — or ``auto``,
which resolves to the highest-priority implementation available in the
current context. Third-party code can register additional implementations
and select them by name from the same config key, which is what makes the
surface a registry rather than a closed enum.

A copy of ``deepspeedsyclsupport_tpu/inference/v2/module_registry.py``. In the
PyTorch port the callers key ``auto`` on the tensors' device type
(``context["backend"] == "cuda"``) where the JAX package keys on
``jax.default_backend() == "tpu"``.
"""
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

__all__ = ["register_impl", "get_impl", "list_impls", "select_impl",
           "ImplSpec"]


@dataclass(frozen=True)
class ImplSpec:
    kind: str
    name: str
    fn: Callable
    # availability in a given context dict (backend, shipped metadata, ...)
    available: Callable[[Dict[str, Any]], bool]
    priority: int  # higher wins under "auto"
    # eligibility for AUTO selection only — an impl can be explicitly
    # selectable (debug/interpret variants) yet never auto-picked
    auto_eligible: Callable[[Dict[str, Any]], bool] = lambda ctx: True
    # impl-declared facts the caller may consult (e.g. needs_atoms: the
    # engine ships atom metadata only to impls that consume it)
    metadata: Optional[Dict[str, Any]] = None


_REGISTRY: Dict[str, Dict[str, ImplSpec]] = defaultdict(dict)


def register_impl(kind: str, name: str, *, priority: int = 0,
                  available: Optional[Callable[[Dict[str, Any]], bool]] = None,
                  auto_eligible: Optional[Callable[[Dict[str, Any]], bool]]
                  = None,
                  metadata: Optional[Dict[str, Any]] = None
                  ) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as implementation ``name`` of ``kind``.
    Re-registering a name replaces it (user overrides win)."""

    def deco(fn: Callable) -> Callable:
        avail = available or (lambda ctx: True)
        _REGISTRY[kind][name] = ImplSpec(
            kind=kind, name=name, fn=fn, available=avail, priority=priority,
            auto_eligible=auto_eligible or avail, metadata=metadata or {})
        return fn

    return deco


def get_impl(kind: str, name: str) -> ImplSpec:
    impls = _REGISTRY.get(kind, {})
    if name not in impls:
        raise KeyError(f"no {kind!r} implementation named {name!r}; "
                       f"registered: {sorted(impls) or 'none'}")
    return impls[name]


def list_impls(kind: str) -> List[str]:
    return sorted(_REGISTRY.get(kind, {}))


def select_impl(kind: str, requested: str,
                context: Optional[Dict[str, Any]] = None) -> ImplSpec:
    """Resolve a config value to an implementation (the heuristics seam,
    reference ``modules/heuristics.py``): explicit names are validated
    against availability; ``auto`` picks the highest-priority available
    impl."""
    context = context or {}
    if requested != "auto":
        spec = get_impl(kind, requested)
        if not spec.available(context):
            raise ValueError(
                f"{kind} implementation {requested!r} is not available in "
                f"this context ({context}); available: "
                f"{[s.name for s in _available(kind, context)]}")
        return spec
    candidates = [s for s in _available(kind, context)
                  if s.auto_eligible(context)]
    if not candidates:
        raise RuntimeError(f"no {kind!r} implementation available "
                           f"(context {context})")
    return candidates[0]


def _available(kind: str, context: Dict[str, Any]) -> List[ImplSpec]:
    impls = [s for s in _REGISTRY.get(kind, {}).values()
             if s.available(context)]
    return sorted(impls, key=lambda s: -s.priority)
