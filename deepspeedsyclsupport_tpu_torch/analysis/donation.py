"""Donation audit: state tensors a step failed to update in place.

Port of ``deepspeedsyclsupport_tpu/analysis/donation.py``. Under XLA a
donated buffer that the compiled step does not alias to an output is
copied every step, doubling its memory; the JAX package reads the compiled
module's ``input_output_alias`` header. The port's counterpart is the
eager step's in-place update: a param, master or moment tensor must keep
its storage across a step (the optimizer writes it with in-place ops). A
tensor whose storage was reallocated is "missed": for the step the old and
new buffers were both alive, the same doubling. The audit compares each
tensor's ``untyped_storage().data_ptr()`` before and after one step.

Parsing the alias header (``parse_aliased_params``) has no counterpart:
there is no compiled module (a documented n/a).
"""
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Tuple

import torch


@dataclass
class DonationReport:
    ok: bool
    donated: List[str] = field(default_factory=list)       # tree paths
    not_donated: List[Dict[str, Any]] = field(default_factory=list)
    wasted_bytes: int = 0          # memory doubled by missed donations
    unmapped: bool = False         # the two snapshots name different leaves

    def report(self) -> str:
        lines = [f"donation audit: {'OK' if self.ok else 'FAIL'} "
                 f"({len(self.donated)} donated, "
                 f"{len(self.not_donated)} missed, "
                 f"{self.wasted_bytes} B doubled)"]
        for miss in self.not_donated:
            lines.append(f"  NOT DONATED: {miss['path']} "
                         f"{miss['shape']}:{miss['dtype']} "
                         f"({miss['bytes']} B)")
        if self.unmapped:
            lines.append("  (leaves unverified: the snapshots before and "
                         "after the step name different tensors)")
        return "\n".join(lines)


def storage_snapshot(named: Iterable[Tuple[str, torch.Tensor]]
                     ) -> Dict[str, Dict[str, Any]]:
    """``{path: {"ptr", "shape", "dtype", "bytes"}}`` of each tensor's
    storage (cheap: no device work)."""
    return {path: {"ptr": t.untyped_storage().data_ptr(),
                   "shape": tuple(t.shape),
                   "dtype": str(t.dtype).replace("torch.", ""),
                   "bytes": t.numel() * t.element_size()}
            for path, t in named}


def donation_audit(before: Dict[str, Dict[str, Any]],
                   after: Dict[str, Dict[str, Any]]) -> DonationReport:
    """Audit one step from its two :func:`storage_snapshot`s: every tensor
    of ``before`` that kept its storage is donated; one whose storage
    changed is missed, its bytes wasted. A scalar (a step counter) costs
    nothing and is not reported, as in the JAX package."""
    donated, missed, wasted = [], [], 0
    for path, b in before.items():
        a = after.get(path)
        if a is not None and a["ptr"] == b["ptr"]:
            donated.append(path)
            continue
        if a is None or not b["shape"]:
            continue
        missed.append({"path": path, "shape": b["shape"],
                       "dtype": b["dtype"], "bytes": b["bytes"]})
        wasted += b["bytes"]
    unmapped = set(before) != set(after)
    return DonationReport(ok=not missed and not unmapped, donated=donated,
                          not_donated=missed, wasted_bytes=wasted,
                          unmapped=unmapped)
