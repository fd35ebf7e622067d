"""Journal-based cross-replica failover: the claim protocol.

Port of ``deepspeedsyclsupport_tpu/inference/v2/fleet/failover.py``; the
claim file's JSON keys and its ``stamped`` wall seconds are the
reference's, so a claim written by either package is read by the other.

A dead replica's request journals name its in-flight streams (admit
without close). Two parties could replay them: the router (onto a
*surviving* replica) and the replica's own supervisor-restarted worker.
The **claim file** arbitrates so every stream is replayed exactly once:

* the router writes ``failover_claim.json`` into the dead replica's
  journal dir *before* re-admitting anything — atomically, carrying the
  claimed uids;
* a restarted worker's recovery (and its spool ingestion) reads the claim
  file and skips claimed uids — they are someone else's streams now;
* a second router pass (or a restarted router) over the same journal dir
  sees its own prior claims and replays nothing twice.

The router only claims once a replica is *dead* (supervisor process gone,
or health stale past ``dead_after_s``): a replica that is merely
restarting keeps its streams and replays them locally, which is cheaper
than a cross-replica re-prefill when the restart wins the race.
"""
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

from ..supervisor import ReplayRequest, load_journal
from ....utils.logging import logger

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
    the atomic-rename protocol below prevents anyway)."""
    try:
        with open(_claim_path(journal_dir)) as f:
            d = json.load(f)
        return FailoverClaim(uids=dict(d.get("uids", {})),
                             stamped=list(d.get("stamped", [])))
    except (OSError, ValueError):
        return FailoverClaim()


def atomic_write_json(path: str, payload: Dict) -> None:
    """tmp+rename JSON write — the one copy of the idiom the fleet's
    on-disk protocol files (claims, spool requests, specs) all ride."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def write_claims(journal_dir: str, claim: FailoverClaim) -> None:
    atomic_write_json(_claim_path(journal_dir),
                      {"uids": claim.uids, "stamped": claim.stamped})


def claim_in_flight(journal_dir: str, *,
                    claimer: str = "router") -> Dict[int, ReplayRequest]:
    """Load the dead replica's journals, return the in-flight streams not
    yet claimed, and durably claim them for ``claimer``.

    The claim is written BEFORE the caller replays anything: if the
    claimer dies mid-failover, a successor sees the claim and the streams
    stay with the (dead) claimer rather than being replayed twice — the
    conservative side of exactly-once. Closed streams and previously
    claimed uids are never returned.
    """
    states, _last_t = load_journal(journal_dir)
    claim = read_claims(journal_dir)
    fresh = {uid: st for uid, st in states.items()
             if not st.closed and not claim.covers(uid)}
    if not fresh:
        return {}
    for uid in fresh:
        claim.uids[str(uid)] = claimer
    claim.stamped.append(time.time())  # cross-process claim stamp
    try:
        write_claims(journal_dir, claim)
    except OSError as e:
        # without a durable claim the restarted worker may also replay —
        # refuse to double-serve: better to leave the streams to the
        # local-restart path than to emit duplicate tokens
        logger.error("failover: cannot write claim in %s (%s) — leaving "
                     "streams to the local-restart path", journal_dir, e)
        return {}
    logger.info("failover: claimed %d in-flight stream(s) in %s for %s",
                len(fresh), journal_dir, claimer)
    return fresh


def claim_uids(journal_dir: str, uids, *, claimer: str = "router") -> None:
    """Claim uids that never reached the replica's journal (requests lost
    in transport — spooled but unconsumed at death). A respawned worker
    must skip their spool files: the claimer resubmitted them elsewhere."""
    claim = read_claims(journal_dir)
    new = [u for u in uids if not claim.covers(u)]
    if not new:
        return
    for uid in new:
        claim.uids[str(uid)] = claimer
    claim.stamped.append(time.time())  # cross-process claim stamp
    try:
        write_claims(journal_dir, claim)
    except OSError as e:  # best effort: transport loss is already terminal
        logger.warning("failover: cannot extend claim in %s: %s",
                       journal_dir, e)
