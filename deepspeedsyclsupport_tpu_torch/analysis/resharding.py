"""Resharding detector: traffic and layouts the plan did not ask for.

Port of ``deepspeedsyclsupport_tpu/analysis/resharding.py``, two-sided as
there:

* **boundary**: the layout each leaf has at step entry vs the layout the
  plan gives it. The JAX package compares the shardings a compiled
  executable wants with the ones the caller's arrays carry. The port's
  leaves carry no sharding; what can disagree is the tensor a rank holds:
  the engine hands each leaf's local shape and the shape its ``_specs``
  entry makes of the full leaf (``MeshTopology.shard_shape``), and a
  mismatch is a leaf that is not the shard its spec says.
* **internal**: collective traffic the census could not attribute to the
  canonical classes (``collectives.py``'s ``other`` class), in a
  resharding spelling (all-to-all, collective-permute) or an unattributed
  all-gather. The port's census has no partitioner in it, so this side is
  the signal that a façade call moved data outside the plan.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .collectives import classify_collectives

RESHARD_OPS = ("all-to-all", "collective-permute")


@dataclass
class ReshardingReport:
    ok: bool
    boundary_mismatches: List[Dict[str, Any]] = field(default_factory=list)
    internal_suspects: List[Dict[str, Any]] = field(default_factory=list)
    suspect_bytes: int = 0

    def report(self) -> str:
        lines = [f"resharding audit: {'OK' if self.ok else 'FAIL'} "
                 f"({len(self.boundary_mismatches)} boundary, "
                 f"{len(self.internal_suspects)} internal, "
                 f"{self.suspect_bytes} B/step)"]
        for b in self.boundary_mismatches:
            lines.append(f"  BOUNDARY arg {b['index']}: given {b['given']} "
                         f"!= compiled {b['wanted']}")
        for s in self.internal_suspects:
            lines.append(f"  INTERNAL {s['op']} {s['shape']} "
                         f"({s['bytes']} B)")
        return "\n".join(lines)


def _norm(spec: Any) -> Any:
    """A spec or shape with trailing empty entries dropped (implicit)."""
    t = [tuple(e) if isinstance(e, (tuple, list)) else e for e in spec]
    while t and t[-1] in (None, ()):
        t.pop()
    return tuple(t)


def resharding_audit(census: Optional[Sequence[Dict[str, Any]]] = None,
                     params: Any = None,
                     param_shardings: Any = None,
                     given_in_shardings: Optional[Sequence[Any]] = None,
                     wanted_in_shardings: Optional[Sequence[Any]] = None,
                     ) -> ReshardingReport:
    """Audit one step for resharding traffic.

    ``params``/``param_shardings`` feed the census classifier so canonical
    param/grad traffic is not blamed; without them every collective in a
    reshard-spelling opcode is a suspect. ``given_in_shardings`` and
    ``wanted_in_shardings``: per leaf, the layout it has and the one the
    plan gives it (specs or local shapes; ``None`` entries skip the
    comparison).
    """
    census = list(census or ())
    if params is not None:
        other = classify_collectives(census, params, param_shardings).other
    else:
        other = [r for r in census if r["op"] in RESHARD_OPS]
    suspects = [r for r in other
                if r["op"] in RESHARD_OPS or r["op"] == "all-gather"]
    boundary: List[Dict[str, Any]] = []
    if given_in_shardings is not None:
        for i, (giv, want) in enumerate(zip(given_in_shardings,
                                            wanted_in_shardings or ())):
            if giv is None or want is None:
                continue
            if _norm(giv) != _norm(want):
                boundary.append({"index": i, "given": str(giv),
                                 "wanted": str(want)})
    return ReshardingReport(
        ok=not boundary and not suspects,
        boundary_mismatches=boundary, internal_suspects=suspects,
        suspect_bytes=sum(s["bytes"] for s in suspects))
