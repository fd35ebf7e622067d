"""Baseline workflow: existing lint debt is visible, only NEW debt fails.

Port of ``deepspeedsyclsupport_tpu/analysis/baseline.py``. The port's
baseline file (``deepspeedsyclsupport_tpu_torch/analysis/
dslint_baseline.json``) maps violation keys to occurrence counts. Keys are line-number independent
(``rule|path|stripped-source-line``), so moving code doesn't churn the
baseline while editing a violating line makes it new — the edit is the
moment to fix it.

* ``--check``: fail (exit 1) on violations whose key is absent from the
  baseline or whose count grew. Baselined entries that no longer fire are
  reported as stale (fix them by regenerating) but do not fail.
* ``--update-baseline``: rewrite the file from the current tree.
"""
import json
import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .codelint import Violation

BASELINE_VERSION = 1
DEFAULT_BASELINE = os.path.join("deepspeedsyclsupport_tpu_torch", "analysis",
                                "dslint_baseline.json")


def load_baseline(path: str) -> Dict[str, int]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path} has version "
                         f"{data.get('version')!r}, expected "
                         f"{BASELINE_VERSION}; regenerate with "
                         f"--update-baseline")
    return {k: int(v) for k, v in data.get("violations", {}).items()}


def save_baseline(path: str, violations: Sequence[Violation]) -> Dict[str, int]:
    counts = dict(sorted(Counter(v.key for v in violations).items()))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"version": BASELINE_VERSION,
                   "comment": "dslint debt baseline — regenerate with "
                              "`python -m deepspeedsyclsupport_tpu_torch."
                              "analysis.codelint --update-baseline`; "
                              "keys are rule|path|source-line",
                   "violations": counts}, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return counts


@dataclass
class BaselineCheck:
    new: List[Violation] = field(default_factory=list)
    baselined: List[Violation] = field(default_factory=list)
    stale_keys: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.new


def check_against_baseline(violations: Sequence[Violation],
                           baseline: Dict[str, int]) -> BaselineCheck:
    res = BaselineCheck()
    seen: Counter = Counter()
    for v in violations:
        seen[v.key] += 1
        if seen[v.key] <= baseline.get(v.key, 0):
            res.baselined.append(v)
        else:
            res.new.append(v)
    res.stale_keys = sorted(k for k, n in baseline.items()
                            if seen.get(k, 0) < n)
    return res
