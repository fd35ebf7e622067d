"""Journal-based cross-replica failover: the claim file.

Of ``deepspeedsyclsupport_tpu/inference/v2/fleet/failover.py`` the port
carries, so far, the read side of the claim protocol, which a restarted
``serve_worker`` consults: a router that failed a dead replica's streams
over to a survivor writes ``failover_claim.json`` into the dead replica's
journal dir before re-admitting anything, and the worker's recovery (and
its spool ingestion) skips the claimed uids, so every stream is replayed
exactly once. The router and the rest of failover are ROADMAP.md A.2.8.
"""
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

CLAIM_FILE = "failover_claim.json"


@dataclass
class FailoverClaim:
    """On-disk claim record: uid → claimer, plus the wall stamp of each
    claim batch (cross-process by definition, hence wall clock)."""

    uids: Dict[str, str] = field(default_factory=dict)
    stamped: List[float] = field(default_factory=list)

    def covers(self, uid: int) -> bool:
        return str(uid) in self.uids


def _claim_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, CLAIM_FILE)


def read_claims(journal_dir: str) -> FailoverClaim:
    """Parse the claim file (empty claim when absent/corrupt — a torn
    claim write never blocks recovery, it just risks a local replay that
    the writer's atomic rename prevents anyway)."""
    try:
        with open(_claim_path(journal_dir)) as f:
            d = json.load(f)
        return FailoverClaim(uids=dict(d.get("uids", {})),
                             stamped=list(d.get("stamped", [])))
    except (OSError, ValueError):
        return FailoverClaim()
