"""Replica pool: process lifecycle + the process-backed router endpoint.

Port of ``deepspeedsyclsupport_tpu/inference/v2/fleet/pool.py``. A replica
process runs this package's own supervisor module
(``python -m deepspeedsyclsupport_tpu_torch.inference.v2.supervisor``) with
the checkout that holds this package on its ``PYTHONPATH``; its worker
serves on the card unless the spec says ``"device": "cpu"``.

A :class:`ProcessReplica` is one supervised serving replica — a
:class:`~..supervisor.ReplicaSupervisor` process whose worker runs the
journaled serving loop in **spool mode** (``supervisor.serve_worker`` with
``spool_dir`` set). The router talks to it exclusively through the
filesystem, which is also the fault boundary:

* requests IN: atomically-renamed JSON files in ``spool/`` (the worker
  ingests them in sequence order; consumed uids are recorded by the
  journal, so a restart never double-serves);
* tokens/outcomes OUT: the request-journal JSONL stream, tailed
  incrementally (``serve/emit`` → token events, ``serve/close`` →
  finish/shed) — the journal already IS the delivery record, so the
  transport adds no second source of truth;
* health: the supervisor's atomic ``health.json`` probe (readiness from
  heartbeat freshness; ``draining`` during the supervisor's drain
  window).

:class:`ReplicaPool` orchestrates N of them: start/stop, **rolling
restart** (drain one replica at a time — the router steers new work away
the moment ``health.json`` says draining — then respawn and wait ready
before touching the next), and hot respawn of replicas whose supervisor
gave up. Worker crashes inside a living supervisor restart through the
existing elastic machinery without the pool doing anything.
"""
import glob as _glob
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from .failover import atomic_write_json as _atomic_write_json
from .router import FleetEvent, FleetRequest, ReplicaEndpoint
from ..supervisor import ReplayRequest
from ....utils.logging import logger


class _JournalTail:
    """Incremental reader over a journal dir's ``journal_rank*.jsonl``
    files: returns only records appended since the last call, tolerating
    torn tails (a partial line stays buffered until its newline lands)."""

    def __init__(self, journal_dir: str):
        self.journal_dir = journal_dir
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, str] = {}

    def read_new(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        pattern = os.path.join(self.journal_dir, "journal_rank*.jsonl")
        for path in sorted(_glob.glob(pattern),
                           key=lambda p: (os.path.getmtime(p), p)):
            try:
                with open(path) as f:
                    f.seek(self._offsets.get(path, 0))
                    chunk = f.read()
                    self._offsets[path] = f.tell()
            except OSError:
                continue
            if not chunk:
                continue
            buf = self._partial.get(path, "") + chunk
            lines = buf.split("\n")
            self._partial[path] = lines[-1]
            for line in lines[:-1]:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return out


class ProcessReplica(ReplicaEndpoint):
    """One supervised replica process behind the router's endpoint seam.

    ``root`` holds everything the replica owns::

        root/spec.json      worker spec (journal/spool/health paths inside)
        root/journal/       request journals + heartbeat + failover claim
        root/spool/         inbound request files (router-written)
        root/health.json    supervisor readiness probe
        root/stop           stop marker (worker exits when idle)
    """

    def __init__(self, replica_id: str, root: str,
                 spec: Optional[Dict[str, Any]] = None, *,
                 supervisor_args: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None,
                 dead_after_s: float = 5.0,
                 python: str = sys.executable):
        self.replica_id = str(replica_id)
        self.root = root
        self.journal_dir = os.path.join(root, "journal")
        self.spool_dir = os.path.join(root, "spool")
        self.health_file = os.path.join(root, "health.json")
        self.spec_path = os.path.join(root, "spec.json")
        self.stop_file = os.path.join(root, "stop")
        self.supervisor_args = list(supervisor_args)
        self.extra_env = dict(env or {})
        self.dead_after_s = float(dead_after_s)
        self.python = python
        self.proc: Optional[subprocess.Popen] = None
        self.generation = -1
        self._expected_down = False
        self._tail = _JournalTail(self.journal_dir)
        self._seq = 0
        self._admitted: set = set()
        self._closed: set = set()
        os.makedirs(self.journal_dir, exist_ok=True)
        os.makedirs(self.spool_dir, exist_ok=True)
        spec = dict(spec or {})
        # the worker's fleet contract: serve the spool, probe-able health,
        # journals under journal_dir, stop marker honored
        spec.setdefault("model", "tiny")
        spec["journal_dir"] = self.journal_dir
        spec["spool_dir"] = self.spool_dir
        spec["stop_file"] = self.stop_file
        spec.setdefault("out", os.path.join(root, "out.json"))
        self.spec = spec
        self.max_live = int((spec.get("engine") or {})
                            .get("max_sequences", 64))
        _atomic_write_json(self.spec_path, spec)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Spawn (or respawn) the supervisor. Each generation gets its own
        journal namespace (``DSTPU_FLEET_GEN``) so ``load_journal``'s
        oldest-first merge stays correct across respawns."""
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError(f"replica {self.replica_id} already running")
        self.generation += 1
        self._expected_down = False
        try:
            os.unlink(self.stop_file)
        except OSError:
            pass
        env = dict(os.environ)
        env.update(self.extra_env)
        env["DSTPU_FLEET_GEN"] = str(self.generation)
        # the worker must import this package even when the pool runs from
        # an unrelated cwd (tests, operators driving a checkout)
        import deepspeedsyclsupport_tpu_torch as _pkg

        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        # the default heartbeat timeout is the reference's; a worker that
        # beats late (a large model's build on the card) is given more by
        # supervisor_args, which come after it: argparse keeps the last
        cmd = [self.python, "-m",
               "deepspeedsyclsupport_tpu_torch.inference.v2.supervisor",
               "--spec", self.spec_path,
               "--health-file", self.health_file,
               "--heartbeat-timeout", "30",
               *self.supervisor_args]
        # own session: a hard kill() can take the worker down with the
        # supervisor instead of orphaning it mid-decode
        self.proc = subprocess.Popen(cmd, env=env, start_new_session=True)
        logger.info("replica %s: supervisor pid %d (gen %d)",
                    self.replica_id, self.proc.pid, self.generation)

    def drain(self) -> None:
        """Request the supervisor's drain: SIGTERM to the supervisor, which
        forwards to the worker; live streams finish, health goes
        ``draining`` → ``stopped``, no relaunch."""
        self._expected_down = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()

    def request_stop(self) -> None:
        """Graceful idle stop: the worker exits 0 once its streams and
        spool are drained (no signal involved)."""
        self._expected_down = True
        with open(self.stop_file, "w") as f:
            f.write("stop")

    def kill(self) -> None:
        """Hard replica death (chaos path): SIGKILL the supervisor's whole
        session — worker included — leaving journals truthfully unclosed."""
        self._expected_down = False
        if self.proc is not None and self.proc.poll() is None:
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
            except (OSError, ProcessLookupError):
                self.proc.kill()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if self.proc is None:
            return None
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    # --------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        try:
            with open(self.health_file) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def ready(self) -> bool:
        h = self.health()
        if h.get("state") != "serving" or not h.get("ready"):
            return False
        # staleness gate: a probe the supervisor stopped refreshing is a
        # probe nobody should trust (cross-process wall stamp by contract)
        t = h.get("t")
        return t is not None and \
            time.time() - float(t) <= self.dead_after_s

    def draining(self) -> bool:
        return self.health().get("state") == "draining"

    def dead(self) -> bool:
        """Failover-eligible: the supervisor is gone (or its probe went
        stale) and the pool was not taking it down on purpose. A replica
        mid-drain or mid-respawn keeps its streams — the local restart
        path replays them more cheaply than a cross-replica re-prefill."""
        if self._expected_down:
            return False
        if self.proc is not None and self.proc.poll() is not None:
            return True
        h = self.health()
        t = h.get("t")
        if t is None:
            return False  # never came up: not up to the router to bury it
        return time.time() - float(t) > self.dead_after_s

    # ------------------------------------------------------------ transport
    def _spool(self, payload: Dict[str, Any]) -> None:
        self._seq += 1
        # stamp the hand-off time: the worker's `spool_wait` stage is the
        # gap between this write and its admit-side pickup
        payload = {**payload, "spooled_t": time.time()}
        name = f"req_{self._seq:06d}_{payload['uid']}.json"
        _atomic_write_json(os.path.join(self.spool_dir, name), payload)

    def submit(self, req: FleetRequest) -> str:
        self._spool({"uid": req.uid, "tokens": list(req.tokens),
                     "max_new_tokens": req.max_new_tokens,
                     "tenant": req.tenant,
                     **({"ttft_sla_s": req.ttft_sla_s}
                        if req.ttft_sla_s is not None else {}),
                     "rate_sla": req.rate_sla})
        return "dispatched"

    def replay(self, rr: ReplayRequest) -> str:
        self._spool({"uid": rr.uid, "tokens": list(rr.tokens),
                     "max_new_tokens": rr.max_new_tokens,
                     "tenant": rr.tenant, "rate_sla": rr.rate_sla,
                     "replayed": True, "out": list(rr.out)})
        return "dispatched"

    def load(self) -> Dict[str, int]:
        # journal-derived estimate: admits seen minus closes seen (queued
        # depth is replica-internal; the backlog estimate in the router's
        # views covers the un-prefilled share)
        return {"live": len(self._admitted - self._closed), "queued": 0}

    def poll_events(self) -> List[FleetEvent]:
        out: List[FleetEvent] = []
        for rec in self._tail.read_new():
            name = rec.get("name")
            data = rec.get("data") or {}
            uid = data.get("uid")
            if uid is None:
                continue
            uid = int(uid)
            t = float(rec.get("t", 0.0))
            if name == "serve/admit":
                self._admitted.add(uid)
            elif name == "serve/emit":
                out.append(FleetEvent("token", uid, t,
                                      replica_id=self.replica_id,
                                      tokens=[int(x) for x in
                                              data.get("tokens", [])]))
            elif name == "serve/close":
                self._closed.add(uid)
                reason = data.get("reason", "")
                kind = "shed" if (reason == "replay_shed"
                                  or reason.startswith("shed")) else "finish"
                out.append(FleetEvent(kind, uid, t,
                                      replica_id=self.replica_id,
                                      reason=reason))
        return out


class ReplicaPool:
    """Start/stop/drain orchestration over N :class:`ProcessReplica`s."""

    def __init__(self, replicas: Sequence[ProcessReplica]):
        self.replicas: Dict[str, ProcessReplica] = {
            r.replica_id: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise ValueError("replica ids must be unique")

    def start(self) -> None:
        for r in self.replicas.values():
            r.start()

    def wait_ready(self, timeout: float = 120.0,
                   poll_s: float = 0.1) -> bool:
        """Block until every live replica probes ready (engine built, first
        heartbeat fresh). False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(r.ready() for r in self.replicas.values()
                   if r.proc is not None and r.proc.poll() is None):
                if any(r.proc is not None and r.proc.poll() is None
                       for r in self.replicas.values()):
                    return True
            time.sleep(poll_s)
        return False

    def stop(self, timeout: float = 60.0) -> Dict[str, Optional[int]]:
        """Graceful fleet stop: stop markers first (workers exit when
        idle), drain (SIGTERM) past half the budget, SIGKILL at the end."""
        for r in self.replicas.values():
            r.request_stop()
        deadline = time.monotonic() + timeout
        rcs: Dict[str, Optional[int]] = {}
        terminated = False
        while time.monotonic() < deadline:
            live = [r for r in self.replicas.values()
                    if r.proc is not None and r.proc.poll() is None]
            if not live:
                break
            if not terminated and deadline - time.monotonic() < timeout / 2:
                terminated = True
                for r in live:
                    r.drain()
            time.sleep(0.1)
        for rid, r in self.replicas.items():
            if r.proc is not None and r.proc.poll() is None:
                r.kill()
            rcs[rid] = r.wait(timeout=5.0)
        return rcs

    def respawn(self, replica_id: str) -> None:
        """Bring a down replica back (new generation). The restarted
        worker replays its UNCLAIMED journaled streams itself; claimed
        ones belong to whoever failed them over."""
        r = self.replicas[replica_id]
        if r.proc is not None and r.proc.poll() is None:
            raise RuntimeError(f"replica {replica_id} is still running")
        r.start()

    def rolling_restart(self, wait_ready_s: float = 120.0,
                        poll_s: float = 0.1) -> None:
        """Drain→stop→respawn→ready, one replica at a time. The router
        needs no hook: health goes ``draining`` (out of rotation) the
        moment the supervisor sees the SIGTERM, and back to ``serving``
        once the respawned worker heartbeats."""
        for rid in sorted(self.replicas):
            r = self.replicas[rid]
            if r.proc is None or r.proc.poll() is not None:
                continue
            logger.info("rolling restart: draining replica %s", rid)
            r.drain()
            deadline = time.monotonic() + wait_ready_s
            while r.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(poll_s)
            if r.proc.poll() is None:
                logger.error("rolling restart: replica %s did not drain in "
                             "%.0fs — killing", rid, wait_ready_s)
                r.kill()
                r.wait(timeout=10.0)
            r.start()
            deadline = time.monotonic() + wait_ready_s
            while not r.ready() and time.monotonic() < deadline:
                time.sleep(poll_s)
            if not r.ready():
                raise RuntimeError(
                    f"rolling restart: replica {rid} not ready within "
                    f"{wait_ready_s}s of respawn")
            logger.info("rolling restart: replica %s back in rotation", rid)
