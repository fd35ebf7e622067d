"""Fleet CLI — spawn a replica pool, route a request list, survive
replica deaths, write the merged delivery record.

Port of ``deepspeedsyclsupport_tpu/inference/v2/fleet/cli.py``::

    python -m deepspeedsyclsupport_tpu_torch.inference.v2.fleet --spec fleet.json

Spec keys:

* ``root`` — fleet directory (one subdir per replica + ``router.jsonl``)
* ``n_replicas`` — pool size
* ``worker`` — per-replica worker spec (``model``/``dtype``/``device``/
  ``engine``/``policy``/``recover``; journal/spool/health paths are filled
  in; ``device`` defaults to the card, ``"cpu"`` runs on the CPU)
* ``supervisor_args`` — extra ``ReplicaSupervisor`` CLI args (e.g.
  ``["--restart-limit", "0"]`` so a crashed replica stays dead and its
  streams fail over instead of restarting locally, or
  ``["--heartbeat-timeout", "300"]`` for a worker whose model takes longer
  than the default 30 s to build before its first beat)
* ``env`` — per-replica env overrides keyed by replica index as a string
  (fault injection rides here)
* ``router`` — :class:`~.router.FleetConfig` fields
* ``requests`` — ``[{"uid", "tokens", "max_new_tokens", ...}]``
* ``out`` — merged-output JSON path; ``timeout_s`` — wall bound

The merged output's token sequences come from the fleet-wide journal merge
(:func:`~..supervisor.load_journal` across every replica's journal dir) —
the journals are the delivery record, so the output is exact no matter how
many deaths/failovers the run survived.
"""
import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from .pool import ProcessReplica, ReplicaPool
from .router import FleetConfig, FleetRequest, FleetRouter
from ..supervisor import load_journal, reconstruct_outputs
from ....utils.logging import logger


def fleet_journal_files(root: str, n_replicas: int) -> List[str]:
    """Every replica's journal files under a fleet root (mtime-ordered by
    ``load_journal`` itself)."""
    return [os.path.join(root, f"replica{i}", "journal")
            for i in range(n_replicas)]


def run_fleet(spec: Dict[str, Any]) -> Dict[str, Any]:
    root = spec["root"]
    n = int(spec.get("n_replicas", 2))
    os.makedirs(root, exist_ok=True)
    per_env = {str(k): dict(v) for k, v in (spec.get("env") or {}).items()}
    common_env = per_env.pop("*", {})  # env for every replica; per-index
    #                                    entries override (fault injection)
    replicas = [
        ProcessReplica(
            str(i), os.path.join(root, f"replica{i}"),
            dict(spec.get("worker") or {}),
            supervisor_args=spec.get("supervisor_args") or (),
            env={**common_env, **per_env.get(str(i), {})},
            dead_after_s=float((spec.get("router") or {})
                               .get("dead_after_s", 5.0)))
        for i in range(n)]
    pool = ReplicaPool(replicas)
    rcfg = FleetConfig(**{**(spec.get("router") or {}),
                          "log_path": (spec.get("router") or {}).get(
                              "log_path",
                              os.path.join(root, "router.jsonl"))})
    router = FleetRouter(replicas, rcfg)
    timeout_s = float(spec.get("timeout_s", 300.0))
    pool.start()
    try:
        if not pool.wait_ready(timeout=timeout_s):
            raise RuntimeError("fleet: replicas never became ready")
        pending = [FleetRequest(
            uid=int(r["uid"]), tokens=[int(t) for t in r["tokens"]],
            max_new_tokens=int(r["max_new_tokens"]),
            tenant=r.get("tenant", "default"),
            ttft_sla_s=r.get("ttft_sla_s"),
            rate_sla=float(r.get("rate_sla", 0.0)))
            for r in spec.get("requests", [])]
        closed: Dict[int, str] = {}
        deadline = time.monotonic() + timeout_s
        while pending or not router.idle:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet: timed out with {len(router.flights)} stream(s) "
                    f"in flight ({len(pending)} unsubmitted)")
            while pending:
                req = pending.pop(0)
                outcome, _rid = router.submit(req)
                if outcome == "shed":
                    closed[req.uid] = "shed:edge"
            for ev in router.poll():
                if ev.kind in ("finish", "shed"):
                    closed[ev.uid] = ev.reason or ev.kind
            time.sleep(0.02)
        stats = router.stats()
    finally:
        router.close()
        pool.stop(timeout=60.0)
    # ground truth: the fleet-wide journal merge (replayed admits carry the
    # watermark prefix, so cross-replica streams reconstruct exactly)
    states, _ = load_journal(fleet_journal_files(root, n))
    outputs = reconstruct_outputs(states)
    result = {
        "outputs": {str(u): t for u, t in outputs.items()},
        "closed": {str(u): st.reason for u, st in states.items()
                   if st.closed},
        "edge": {str(u): r for u, r in closed.items()},
        "router": stats,
    }
    out_path = spec.get("out")
    if out_path:
        tmp = f"{out_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, out_path)
    logger.info("fleet: %d request(s) done — %d routed, %d shed, "
                "%d failover replay(s)", len(states), stats["routed"],
                stats["shed"], stats["failover_replays"])
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive a multi-process serving fleet from a spec.")
    ap.add_argument("--spec", required=True, help="fleet spec JSON")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    run_fleet(spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
