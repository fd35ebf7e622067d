"""Serving-plane fault tolerance: request journal + replica supervisor.

Port of ``deepspeedsyclsupport_tpu/inference/v2/supervisor.py``. Journal
records use the reference's schema (``serve/admit``, ``serve/emit``,
``serve/close``, ``serve/stage``, ``serve/arm``, ``serve/hang``), so a
journal written by either package loads in the other. The worker's spec is
the reference's plus one key, ``device`` (default: the card; the port never
drops to the CPU on its own, so tests pass ``"cpu"``).

The training plane has structured resilience contracts (rc 217
preemption, rc 218 collective hang, crc32 pod commits); this module
mirrors them onto the v2 serving engine, which an MII-style frontend keeps
alive for weeks — one wedged decode step or engine crash must cost the
affected streams a re-prefill, not every in-flight stream its output:

* :class:`RequestJournal` — every admitted request's immutable prompt, SLA
  fields and emitted-token watermark as a rank-local JSONL (one
  flushed-per-record stream riding the ``FlightRecorder``/``JsonlMonitor``
  machinery from ``monitor/telemetry.py``), so in-flight state survives the
  process. The journal is written *before* tokens are released to the
  caller, which is what makes replay exactly-once: a token the client saw
  is on disk, a token not on disk was never delivered.
* :func:`load_journal` / :func:`recover_requests` — rebuild the in-flight
  request set from one or more incarnations' journals (truncation-salvaged:
  a torn tail line is expected for a crash) and replay it into a fresh
  :class:`~.serving.ServingSession` from each stream's watermark. TTFT is
  already burned, so replay re-gates on the rate SLA only (the requeue
  rule); provably-unmeetable streams are shed with terminal accounting
  (``Serve/recovery.replay_sheds``), the rest re-prefill prompt+prefix and
  continue — zero duplicate, zero missing tokens.
* :class:`ReplicaSupervisor` — a serving-flavored
  :class:`~...elasticity.elastic_agent.DSElasticAgent`: restarts a
  dead/hung engine worker (rc 219 ``SERVE_HANG_EXIT_CODE`` — the
  stuck-decode watchdog's structured exit — is its own restart class,
  never billed as a crash), exposes health/readiness (heartbeat-derived
  state file) and drains before stopping: a SIGTERM to the supervisor
  forwards to the worker, which finishes its live streams and exits 0
  instead of being killed mid-decode. A worker spec with a ``topology``
  of more than one rank is served by a pod of rank processes: one rank's
  death tears the pod down and the restart replays rank 0's journals.
* a worker CLI (``python -m deepspeedsyclsupport_tpu_torch.inference.v2.
  supervisor --worker --spec spec.json``) — the minimal journaled serving loop the
  two-process chaos tests (and operators smoke-testing a replica) drive.

The JAX package's ``docs/serving.md`` ("failure contract") gives the rc-219
semantics, the journal format and the replay-vs-shed decision table.
"""
import argparse
import glob as _glob
import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ...comm.watchdog import SERVE_HANG_EXIT_CODE  # noqa: F401 (re-export)
from ...elasticity.elastic_agent import DSElasticAgent
from ...utils.logging import logger


# =========================================================================
# Request journal (write side)
# =========================================================================


class RequestJournal:
    """Rank-local JSONL request journal: admission, emission watermarks and
    terminal outcomes, flushed per record so the stream is truthful at any
    crash point.

    Record names (``kind: "event"`` in the shared flight-recorder schema,
    so ``tools/trace_report.py`` parses the stream unmodified):

    * ``serve/admit`` — immutable prompt + SLA fields; ``replayed: true``
      entries carry the ``out`` prefix recovered from a prior incarnation
      (the watermark the new stream continues from).
    * ``serve/emit`` — tokens released to the caller this event, plus the
      cumulative ``emitted`` watermark.
    * ``serve/close`` — terminal: ``done | eos | context | evicted |
      shed:<why> | replay_shed``. A request with an admit and no close is
      *in flight* — the replay set.

    The journal also doubles as the serve watchdog's telemetry sink
    (:attr:`recorder` / :meth:`dump`), so ``serve/arm``/``serve/hang``
    deadline records land in the same on-disk stream the post-mortem reads.
    """

    def __init__(self, path: str, flush_interval: int = 1):
        from ...monitor.monitor import JsonlMonitor
        from ...monitor.telemetry import FlightRecorder

        self.path = path
        self.recorder = FlightRecorder(capacity=256)
        self._jsonl = JsonlMonitor(path=path, flush_interval=flush_interval)
        self._jsonl.attach_recorder(self.recorder)
        self._closed = False
        self.recorder.record(
            "meta", "serve_journal/start",
            data={"version": 1, "pid": os.getpid(),
                  "attempt": os.environ.get("DSTPU_ELASTIC_ATTEMPT", "0")})

    # ------------------------------------------------------------- writing
    def admit(self, uid: int, tokens: Sequence[int], max_new_tokens: int, *,
              tenant: str = "default", rate_sla: float = 0.0,
              ttft_sla_s: Optional[float] = None,
              out: Sequence[int] = (), replayed: bool = False) -> None:
        self.recorder.record(
            "event", "serve/admit",
            data={"uid": int(uid), "tokens": [int(t) for t in tokens],
                  "max_new_tokens": int(max_new_tokens), "tenant": tenant,
                  "rate_sla": float(rate_sla),
                  **({"ttft_sla_s": float(ttft_sla_s)}
                     if ttft_sla_s is not None else {}),
                  **({"out": [int(t) for t in out], "replayed": True}
                     if replayed else {})})

    def emit(self, uid: int, tokens: Sequence[int], emitted: int) -> None:
        self.recorder.record(
            "event", "serve/emit",
            data={"uid": int(uid), "tokens": [int(t) for t in tokens],
                  "emitted": int(emitted)})

    def close_request(self, uid: int, reason: str) -> None:
        self.recorder.record("event", "serve/close",
                             data={"uid": int(uid), "reason": reason})

    def stage(self, uid: int, stage: str, dur: Optional[float] = None,
              **data: Any) -> None:
        """``serve/stage`` lifecycle-edge record (request-time attribution:
        ``monitor/reqtrace.py`` joins these into per-request span trees).
        Rides the same flushed stream as admit/emit/close — no second
        transport, and the recorder's wall ``t`` is the one clock base the
        offline join orders on. ``stage`` must be declared in
        ``reqtrace.SERVE_STAGES`` (dslint's ``undeclared-stage-name`` rule
        enforces literals at lint time; this validates dynamic calls).
        ``uid`` −1 marks session-scope records (decode rounds carry the
        scheduled uid list in ``data`` instead)."""
        from ...monitor.reqtrace import check_stage

        check_stage(stage)
        self.recorder.record(
            "event", "serve/stage",
            data={"uid": int(uid), "stage": stage,
                  **({"dur": float(dur)} if dur is not None else {}),
                  **data})

    # ------------------------------------------------- watchdog sink duties
    def dump(self, reason: str = "manual") -> None:
        """Telemetry-compatible flush hook (the serve watchdog calls
        ``telemetry.dump(...)`` before exiting rc 219)."""
        self.recorder.dump(reason)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._jsonl.close()
        except Exception as e:  # journal teardown must never kill serving
            logger.warning("request journal close failed: %s", e)


# =========================================================================
# Journal recovery (read side)
# =========================================================================


@dataclass
class ReplayRequest:
    """One request's journaled state, merged across incarnations."""

    uid: int
    tokens: List[int]
    max_new_tokens: int
    tenant: str = "default"
    rate_sla: float = 0.0
    out: List[int] = field(default_factory=list)  # emitted-token watermark
    closed: bool = False
    reason: str = ""

    @property
    def in_flight(self) -> bool:
        return not self.closed


def _journal_files(paths: Any) -> List[str]:
    """Expand file / directory / glob / list inputs into journal files,
    oldest incarnation first (mtime, then name — attempt-suffixed names
    from one supervisor tick can share an mtime granule)."""
    if isinstance(paths, (list, tuple)):
        out: List[str] = []
        for p in paths:
            out.extend(_journal_files(p))
        seen: set = set()
        uniq = [p for p in out if not (p in seen or seen.add(p))]
        return sorted(uniq, key=lambda p: (os.path.getmtime(p), p))
    if os.path.isdir(paths):
        found = _glob.glob(os.path.join(paths, "journal_rank*.jsonl"))
    elif _glob.has_magic(paths):
        found = _glob.glob(paths)
    else:
        found = [paths] if os.path.exists(paths) else []
    return sorted(found, key=lambda p: (os.path.getmtime(p), p))


def load_journal(paths: Any) -> Tuple[Dict[int, ReplayRequest], float]:
    """Merge journal stream(s) into per-uid replay states.

    Returns ``(states, last_t)`` where ``last_t`` is the newest wall
    timestamp seen across all records (0.0 if none) — the
    time-to-recover baseline. A torn final line (crash mid-write) is
    skipped, not fatal: everything before it was flushed durably.
    """
    states: Dict[int, ReplayRequest] = {}
    last_t = 0.0
    for path in _journal_files(paths):
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            logger.warning("journal %s unreadable (%s); skipped", path, e)
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail — expected for a crash dump
            last_t = max(last_t, float(rec.get("t", 0.0)))
            name = rec.get("name")
            data = rec.get("data") or {}
            if "uid" not in data:
                continue
            uid = int(data["uid"])
            if name == "serve/admit":
                # an admit RESETS the state: a replayed admit carries the
                # prefix recovered so far; emits that follow continue it
                states[uid] = ReplayRequest(
                    uid=uid, tokens=list(data.get("tokens", [])),
                    max_new_tokens=int(data.get("max_new_tokens", 0)),
                    tenant=data.get("tenant", "default"),
                    rate_sla=float(data.get("rate_sla", 0.0)),
                    out=list(data.get("out", [])))
            elif name == "serve/emit" and uid in states:
                states[uid].out.extend(int(t) for t in data.get("tokens", []))
            elif name == "serve/close" and uid in states:
                states[uid].closed = True
                states[uid].reason = data.get("reason", "")
    return states, last_t


def recover_requests(session: Any, states: Dict[int, ReplayRequest],
                     last_t: float = 0.0) -> Dict[str, Any]:
    """Replay every in-flight journaled request into ``session`` from its
    emitted-token watermark; returns the recovery summary.

    Closed requests are skipped (their output is already delivered and on
    disk). Each in-flight request goes through
    :meth:`~.serving.ServingSession.replay` — rate-SLA re-gate only,
    terminal shed accounting for unmeetable ones. The recovery duration
    (now − newest pre-crash journal record) lands in the
    ``Serve/recovery.time_to_recover_s`` histogram.
    """
    summary: Dict[str, Any] = {"replayed": [], "shed": [], "completed": [],
                               "skipped_closed": [],
                               "time_to_recover_s": None}
    for uid in sorted(states):
        st = states[uid]
        if st.closed:
            summary["skipped_closed"].append(uid)
            continue
        outcome = session.replay(uid, st.tokens, st.max_new_tokens,
                                 emitted_tokens=st.out, tenant=st.tenant,
                                 rate_sla=st.rate_sla)
        key = {"replayed": "replayed", "shed": "shed",
               "completed": "completed"}[outcome]
        summary[key].append(uid)
    if last_t > 0:
        # wall-clock on purpose: the baseline is a DEAD process's wall
        # timestamp — monotonic clocks don't survive the process
        # (across ranks rank 0's wall clock, so every rank observes the
        # same value)
        rank0 = getattr(session, "rank0", None)
        dt = max(0.0, (time.time() if rank0 is None
                       else rank0.value(time.time)) - last_t)
        summary["time_to_recover_s"] = round(dt, 3)
        if getattr(session, "_metrics", None) is not None:
            session._metrics.histogram(
                "Serve/recovery.time_to_recover_s").observe(dt)
    if (summary["replayed"] or summary["shed"] or summary["completed"]) \
            and getattr(session, "lead", True):
        logger.info("journal recovery: %d replayed, %d shed, %d already "
                    "complete, %d closed (t_recover=%ss)",
                    len(summary["replayed"]), len(summary["shed"]),
                    len(summary["completed"]), len(summary["skipped_closed"]),
                    summary["time_to_recover_s"])
    return summary


def reconstruct_outputs(states: Dict[int, ReplayRequest]) -> Dict[int, List[int]]:
    """Per-uid generated-token sequences as the client saw them (the
    journal's emit stream IS the delivery record) — what the chaos tests
    compare against an uninterrupted run for token-sequence equality."""
    return {uid: list(st.out) for uid, st in states.items()}


# =========================================================================
# Replica supervisor
# =========================================================================


class ReplicaSupervisor(DSElasticAgent):
    """Keep one serving replica alive: restart on crash/hang, drain on stop.

    A serving-flavored :class:`DSElasticAgent`: per-cause restart
    accounting (rc 219 stuck-decode hangs are their own class — bounded by
    ``serve_hang_limit``, never billed against ``restart_limit``), plus

    * **drain-before-stop** — :meth:`install_drain_handler` registers a
      store-only SIGTERM/SIGINT handler; the supervising loop forwards the
      signal to the worker, which finishes its live streams (its own
      drain contract) and exits 0 within ``drain_grace`` — SIGKILL only
      past the grace. No relaunch follows a drain.
    * **health/readiness probe** — ``health_file`` is atomically rewritten
      with ``{"state", "worker_pid", "attempt", "ready", "t"}`` at every
      poll; ``ready`` is derived from the worker's telemetry heartbeat
      freshness when a heartbeat watch is configured (a readiness gate a
      load balancer can poll without touching the worker).

    With ``nprocs`` the worker is a pod of that many rank processes
    (:meth:`_spawn`, :meth:`_launch`).
    """

    def __init__(self, cmd: Sequence[str], *,
                 health_file: Optional[str] = None,
                 drain_grace: float = 30.0,
                 poll_s: float = 0.2,
                 **kw):
        kw.setdefault("restart_limit", 3)
        super().__init__(cmd, {"elasticity": {"enabled": False}}, **kw)
        self.health_file = health_file
        self.drain_grace = float(drain_grace)
        self.poll_s = float(poll_s)
        self.drained = False
        # store-only flag a SIGTERM handler may set (async-signal-safe:
        # the supervising loop drains it — never the handler itself)
        self._drain_pending = False

    # ------------------------------------------------------------- signals
    def install_drain_handler(self,
                              signals: Iterable[int] = (signal.SIGTERM,
                                                        signal.SIGINT)
                              ) -> None:
        """Main-thread-only (CPython): SIGTERM/SIGINT request a drain."""
        for s in signals:
            signal.signal(s, self._on_drain_signal)

    def _on_drain_signal(self, signum, frame) -> None:
        # attribute store ONLY — see runtime/resilience.py for why a
        # handler must not log, lock or touch subprocess state
        self._drain_pending = True

    # -------------------------------------------------------------- health
    def _write_health(self, state: str, pid: Optional[int],
                      rc: Optional[int] = None) -> None:
        if not self.health_file:
            return
        ready = False
        if state == "serving":
            from ...monitor.telemetry import Heartbeat

            ages = [Heartbeat.age(p) for p in self._heartbeat_files()]
            ages = [a for a in ages if a is not None]
            if self.heartbeat_timeout is not None:
                ready = bool(ages) and max(ages) <= self.heartbeat_timeout
            else:  # no watch configured: a live worker is ready
                ready = True
        rec = {"state": state, "worker_pid": pid, "ready": ready,
               "attempt": (self.restart_count + self.preemption_count
                           + self.comm_hang_count + self.serve_hang_count),
               # wall timestamp: the probe reader is another process
               "t": time.time()}
        if rc is not None:
            rec["rc"] = rc
        tmp = f"{self.health_file}.tmp{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.health_file) or ".",
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.health_file)
        except OSError as e:  # probe failure must never kill supervision
            logger.warning("health file write failed: %s", e)

    def discover_world_size(self) -> int:
        """A pod's world is its ranks."""
        return self.nprocs or super().discover_world_size()

    # -------------------------------------------------------------- launch
    def _spawn(self, env: Dict[str, str]) -> List[subprocess.Popen]:
        """The worker, or with ``nprocs`` a pod of rank processes on this
        host: each gets ``RANK`` / ``LOCAL_RANK`` / ``WORLD_SIZE`` /
        ``DSTPU_POD_RANKS`` and the pod one rendezvous, ``MASTER_ADDR``
        127.0.0.1 at a port free at this launch (a restarted pod
        rendezvouses anew). The ranks stay in the supervisor's session, so
        a signal to its process group reaches every one."""
        if self.nprocs is None:
            return [subprocess.Popen(self.cmd, env=env)]
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        return [subprocess.Popen(self.cmd, env={
            **env, "RANK": str(r), "LOCAL_RANK": str(r),
            "WORLD_SIZE": str(self.nprocs), "DSTPU_POD_RANKS":
            str(self.nprocs), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}) for r in range(self.nprocs)]

    def _launch(self, env: Dict[str, str]) -> int:
        """One worker attempt under the serving contract: poll for exit,
        refresh the health probe, escalate a stale heartbeat exactly like
        the base agent, and honor a pending drain request by forwarding
        SIGTERM and waiting out ``drain_grace``.

        A pod (``nprocs``) is one replica: the probe names rank 0's pid, a
        drain's SIGTERM goes to every rank (rank 0 decides the drain and
        broadcasts it, the others follow), and the moment one rank exits
        non-zero the others are torn down (they wait in a collective their
        peer will never join); the pod's rc is the base agent's
        :meth:`~DSElasticAgent._pod_rc`, and the restart replays rank 0's
        journals."""
        for path in self._heartbeat_files():
            try:  # a leftover beat from the last incarnation is stale
                os.unlink(path)
            except OSError:
                pass
        launched_at = time.monotonic()
        procs = self._spawn(env)
        lead = procs[0]
        self._write_health("serving", lead.pid)
        rcs: Dict[int, int] = {}
        killed: set = set()

        def poll() -> None:
            for i, p in enumerate(procs):
                if i not in rcs and p.poll() is not None:
                    rcs[i] = p.returncode

        def stop_all(sig_fn, grace: float) -> None:
            live = [i for i in range(len(procs)) if i not in rcs]
            for i in live:
                killed.add(i)
                try:
                    sig_fn(procs[i])
                except OSError:  # pragma: no cover - died under us
                    pass
            deadline = time.monotonic() + grace
            for i in live:
                try:
                    procs[i].wait(timeout=max(0.1,
                                              deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    logger.error("replica supervisor: pid %d did not exit "
                                 "within %.1fs — killing", procs[i].pid,
                                 grace)
                    procs[i].kill()
                    procs[i].wait()
            poll()

        while True:
            poll()
            if len(rcs) == len(procs):
                break
            failed = [i for i, rc in rcs.items() if rc != 0]
            if failed:
                # a rank died: the survivors wait on it in a collective
                logger.error("replica supervisor: rank(s) %s exited %s — "
                             "tearing the pod down", failed,
                             [rcs[i] for i in failed])
                stop_all(lambda p: p.kill(), self.teardown_grace)
                break
            if self._drain_pending and not self.drained:
                self.drained = True
                self._stop_requested = True  # no relaunch after a drain
                self._write_health("draining", lead.pid)
                logger.info("replica supervisor: drain requested — "
                            "forwarding SIGTERM to worker pid(s) %s",
                            [p.pid for p in procs])
                for i, p in enumerate(procs):
                    if i not in rcs:
                        p.terminate()
                deadline = time.monotonic() + self.drain_grace
                while len(rcs) < len(procs) and \
                        time.monotonic() < deadline:
                    poll()
                    time.sleep(0.05)
                if len(rcs) < len(procs):
                    logger.error("replica supervisor: worker did not drain "
                                 "within %.1fs — killing", self.drain_grace)
                    stop_all(lambda p: p.kill(), self.hang_grace)
                break
            if (self.heartbeat_file is not None
                    and self.heartbeat_timeout is not None
                    and self._heartbeat_stale(launched_at)):
                from ...monitor.monitor import resilience_counters

                self.hang_count += 1
                resilience_counters.incr("hang_restarts")
                logger.error("replica supervisor: heartbeat stale > %.1fs — "
                             "worker hung; stack-dumping then killing pid(s) "
                             "%s", self.heartbeat_timeout,
                             [p.pid for p in procs])
                if hasattr(signal, "SIGUSR1"):
                    for i, p in enumerate(procs):
                        if i not in rcs:
                            try:
                                p.send_signal(signal.SIGUSR1)
                            except OSError:  # pragma: no cover - died
                                pass
                    self._sleep(self.hang_grace)
                    poll()
                stop_all(lambda p: p.terminate(), self.hang_grace)
                break
            self._write_health("serving", lead.pid)
            self._sleep(self.poll_s)
        for i, p in enumerate(procs):
            if i not in rcs:  # pragma: no cover - defensive
                rcs[i] = p.wait()
        if len(procs) == 1:
            rc = rcs[0]
        else:
            rc = self._pod_rc(rcs, {i: r for i, r in rcs.items()
                                    if i not in killed})
        self._write_health("stopped" if (rc == 0 or self.drained)
                           else "restarting", None, rc)
        return rc


# =========================================================================
# Worker CLI (the journaled serving loop the chaos tests drive)
# =========================================================================


def journal_path(journal_dir: str, rank: int = 0,
                 attempt: Any = None) -> str:
    """Per-incarnation journal filename — the ONE place the
    ``journal_rank<r>.att<N>.jsonl`` convention lives (``_journal_files``
    discovers it, the worker and bench construct it). ``attempt`` defaults
    to this incarnation's ``DSTPU_ELASTIC_ATTEMPT``. Under a fleet pool,
    ``DSTPU_FLEET_GEN`` (the supervisor *generation* — bumped on every
    pool respawn) namespaces the attempt so a respawned supervisor's
    attempt 0 never appends to a dead generation's file — appending would
    scramble ``_journal_files``'s oldest-first mtime merge."""
    if attempt is None:
        attempt = os.environ.get("DSTPU_ELASTIC_ATTEMPT", "0")
    gen = os.environ.get("DSTPU_FLEET_GEN")
    if gen is not None:
        attempt = f"{gen}.{attempt}"
    return os.path.join(journal_dir, f"journal_rank{rank}.att{attempt}.jsonl")


def topology_world(axes: Optional[Dict[str, int]]) -> int:
    """Ranks of a worker spec's ``topology`` (the product of its axes; 1
    without one)."""
    n = 1
    for v in (axes or {}).values():
        n *= int(v)
    return n


def serve_worker(spec_path: str) -> int:
    """Minimal journaled serving replica: build the engine from a JSON
    spec, recover in-flight requests from prior incarnations' journals,
    serve the spec's request list to completion, write the reconstructed
    per-uid outputs, exit 0.

    Spec keys: ``model`` (name, default "tiny"), ``dtype``, ``device``
    (default: the card), ``engine``
    (``RaggedInferenceConfig`` dict), ``policy`` (``ServingPolicyConfig``
    dict — ``journal_path`` is filled in per incarnation), ``journal_dir``
    (required), ``out`` (output JSON path), ``requests``:
    ``[{"uid", "tokens", "max_new_tokens", "tenant"?, "rate_sla"?}]``;
    ``snapshot`` (optional): an engine snapshot (``serialize``, either
    package's) to serve instead of the model's seeded init;
    ``num_layers`` (optional): the model cut to that depth.

    ``topology`` (optional): mesh axes, ``build_topology``'s keywords
    (``{"tp": 2}``, ``{"ep": 2, "tp": 2}``; data ranks fill the rest), of
    an engine across
    :func:`topology_world` ranks. Each rank is a process of a pod
    (``ReplicaSupervisor`` starts them with ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``) that starts the process group and
    builds the engine with that topology. Rank 0 alone reads the requests,
    the spool, the stop file and the prior journals, and writes the
    journal, the metrics and ``out``; each loop it broadcasts what it read
    (admissions, replays, the drain and stop decisions) and every rank
    serves the same. Every rank beats ``heartbeat_rank<r>.json``.

    Fleet mode (``inference/v2/fleet``) adds: ``spool_dir`` — serve
    request files a router drops there (``replayed: true`` entries go
    through :meth:`~.serving.ServingSession.replay`; replica-side sheds
    are journaled admit+close so the router observes closure);
    ``stop_file`` — exit 0 once it exists and everything is drained;
    ``recover`` (default true) — replay prior incarnations' journals at
    startup. Streams claimed by a router failover
    (``fleet/failover_claim.json`` in the journal dir) are never
    recovered or re-ingested here — they belong to a surviving replica.
    """
    with open(spec_path) as f:
        spec = json.load(f)
    journal_dir = spec["journal_dir"]
    os.makedirs(journal_dir, exist_ok=True)

    from ...device import resolve_device

    device = resolve_device(spec.get("device"))
    if topology_world(spec.get("topology")) <= 1:
        return _serve(spec, journal_dir, device, None)
    from ...comm import comm
    from ...comm.topology import build_topology

    comm.init_distributed(device_type=device.type)
    try:
        # the spec's axes are build_topology's (tp, ep, ...): data ranks
        # fill the world
        topo = build_topology(**{"dp": -1, **spec["topology"]})
        return _serve(spec, journal_dir, device, topo)
    finally:
        comm.destroy_process_group()


def _serve(spec: Dict[str, Any], journal_dir: str, device, topo) -> int:
    """:func:`serve_worker`'s loop on one rank."""
    from ...models import build_model
    from ...monitor.telemetry import Heartbeat
    from .config import ServingPolicyConfig
    from .engine_v2 import InferenceEngineV2
    from .fleet.failover import read_claims
    from .serving import ServingSession

    if spec.get("snapshot"):
        eng = InferenceEngineV2.deserialize(
            spec["snapshot"], device=device, topology=topo,
            **spec.get("engine", {}))
    else:
        model = build_model(spec.get("model", "tiny"),
                            dtype=spec.get("dtype", "float32"),
                            **({"num_layers": int(spec["num_layers"])}
                               if spec.get("num_layers") else {}))
        params = model.init_params(device=device)
        eng = InferenceEngineV2(model, params, config=spec.get("engine", {}),
                                device=device, topology=topo)
        del params
    rank0 = eng.rank0
    lead = rank0 is None or rank0.lead
    rank = 0 if rank0 is None else rank0.rank

    def agree(fn):
        """Rank 0's ``fn()`` on every rank (``fn`` runs on rank 0 only)."""
        return fn() if rank0 is None else rank0.obj(fn)

    jpath = journal_path(journal_dir)
    policy = ServingPolicyConfig.from_config(
        {**spec.get("policy", {}), "journal_path": jpath})

    def recovery():
        # recover BEFORE constructing the session so the fresh journal's
        # first records are the replayed admits (prior incarnations stay
        # read-only)
        prior = [p for p in _journal_files(journal_dir) if p != jpath]
        states, last_t = load_journal(prior)
        claim = read_claims(journal_dir)
        # router-claimed streams were failed over to a surviving replica —
        # recovering them here would double-serve (the exactly-once
        # contract)
        recoverable = {u: st for u, st in states.items()
                       if not claim.covers(u)}
        # journaled, claimed, replayed or replay-shed — never resubmit
        handled = set(states) | {int(u) for u in claim.uids}
        return recoverable, last_t, handled, spec.get("requests", [])

    recoverable, last_t, handled, requests = agree(recovery)
    session = ServingSession(eng, policy)
    if spec.get("recover", True):
        summary = recover_requests(session, recoverable, last_t)
    else:
        summary = {"replayed": [], "shed": [], "completed": [],
                   "skipped_closed": sorted(recoverable),
                   "time_to_recover_s": None}
    heartbeat = Heartbeat(os.path.join(journal_dir,
                                       f"heartbeat_rank{rank}.json"),
                          interval_s=0.2)
    # drain contract: SIGTERM = stop ADMITTING (spec resubmits AND spool
    # ingestion) and finish live streams — store-only handler, drained by
    # the loop; across ranks rank 0's flag decides
    drain = {"pending": False}

    def _on_term(signum, frame):
        drain["pending"] = True

    signal.signal(signal.SIGTERM, _on_term)

    outcomes: Dict[int, str] = {}

    def _admit(r: Dict[str, Any]) -> None:
        uid = int(r["uid"])
        if uid in handled:
            return
        handled.add(uid)
        if r.get("claimed"):
            return  # failed over elsewhere while we were down
        if r.get("spool_wait") is not None:
            # replica spool-ingestion edge: how long the request file sat
            # in the spool before this loop picked it up
            session.note_stage(uid, "spool_wait", dur=r["spool_wait"])
        if r.get("replayed"):
            outcomes[uid] = session.replay(
                uid, r["tokens"], int(r["max_new_tokens"]),
                emitted_tokens=r.get("out", ()),
                tenant=r.get("tenant", "default"),
                rate_sla=r.get("rate_sla"))
            return
        outcomes[uid] = session.submit(
            uid, r["tokens"], int(r["max_new_tokens"]),
            tenant=r.get("tenant", "default"),
            ttft_sla_s=r.get("ttft_sla_s"),
            rate_sla=r.get("rate_sla"))
        if outcomes[uid] == "shed" and session.journal is not None:
            # submit-time sheds are synchronous to a LOCAL caller, but a
            # router only sees the journal — give it the terminal record
            session.journal.admit(uid, r["tokens"],
                                  int(r["max_new_tokens"]),
                                  tenant=r.get("tenant", "default"),
                                  rate_sla=r.get("rate_sla") or 0.0)
            session.journal.close_request(uid, "shed:replica")

    for r in requests:
        _admit(r)

    spool_dir = spec.get("spool_dir")
    stop_file = spec.get("stop_file")
    consumed: set = set()
    spool_seen = {"mtime": -1}

    def _read_spool(force: bool = False) -> List[Dict[str, Any]]:
        """Rank 0: new spool files in sequence order, as the records to
        admit (a claimed uid's record marked ``claimed``). The scan is
        gated on the directory's mtime — this runs every scheduler tick,
        and re-listing (plus re-parsing the claim file) for a spool that
        has not changed is pure waste in the decode hot loop. ``force``
        bypasses the gate (the stop check, and a periodic sweep covering
        coarse-mtime filesystems where a rename inside the same timestamp
        granule would otherwise be invisible)."""
        try:
            mtime = os.stat(spool_dir).st_mtime_ns
        except OSError:
            return []
        if not force and mtime == spool_seen["mtime"]:
            return []
        try:
            names = sorted(os.listdir(spool_dir))
        except OSError:
            return []
        fresh = [nm for nm in names
                 if nm.endswith(".json") and nm not in consumed]
        if not fresh:
            spool_seen["mtime"] = mtime
            return []
        out: List[Dict[str, Any]] = []
        retry = False
        fresh_claim = read_claims(journal_dir)
        for name in fresh:
            try:
                with open(os.path.join(spool_dir, name)) as f:
                    r = json.load(f)
            except (OSError, ValueError):
                retry = True
                continue  # racing the atomic rename — retry next pass
            consumed.add(name)
            uid = int(r["uid"])
            if fresh_claim.covers(uid):
                out.append({"uid": uid, "claimed": True})
                continue
            sp = r.pop("spooled_t", None)
            if sp is not None:
                # wall stamps on both sides (the router's _spool writes
                # spooled_t)
                r["spool_wait"] = max(0.0, time.time() - float(sp))
            out.append(r)
        if not retry:  # a deferred file keeps the scan hot until it lands
            spool_seen["mtime"] = mtime
        return out

    def _ingest(records: List[Dict[str, Any]]) -> int:
        """Admit rank 0's spool records on this rank; how many were new."""
        n = 0
        for r in records:
            if not r.get("claimed") and int(r["uid"]) not in handled:
                n += 1
            _admit(r)
        return n

    prom_path = os.path.join(journal_dir, "metrics_rank0.prom")
    rounds = 0
    if spool_dir:
        while True:
            draining, fresh = agree(lambda: (
                drain["pending"], [] if drain["pending"]
                else _read_spool(force=(rounds % 64 == 0))))
            _ingest(fresh)
            events = session.step() if not session.idle else []
            rounds += 1
            heartbeat.beat(rounds)
            if rounds % 512 == 0:
                # serving-plane textfile export: same atomic-rename
                # contract as the training side's Telemetry.export_textfile
                session.export_metrics(prom_path)
            if draining:
                if session.idle:
                    break
                continue
            if stop_file and session.idle:
                stop, fresh = agree(lambda: (
                    os.path.exists(stop_file),
                    _read_spool(force=True) if os.path.exists(stop_file)
                    else []))
                if stop:
                    # one last ingest (forced): a request spooled between
                    # the previous pass and the stop marker must not strand
                    if not _ingest(fresh):
                        break
                    continue
            if not events:
                time.sleep(0.002)
    else:
        while not session.idle:
            events = session.step()
            rounds += 1
            heartbeat.beat(rounds)
            if not events:
                time.sleep(0.001)
    session.export_metrics(prom_path)
    session.close()
    # the attention kernels' launches in this incarnation, over its ranks
    from ...ops import flash_attention, paged_attention

    launches = {**paged_attention.LAUNCHES,
                "flash_fwd": flash_attention.LAUNCHES["flash_fwd"]}
    if rank0 is not None:
        launches = rank0.total(launches)
    out_path = spec.get("out")
    if not lead or not out_path:
        return 0
    # the journal (all incarnations) is the delivery record — reconstruct
    # the full per-uid sequences from it so the output survives any number
    # of crash/replay cycles
    final_states, _ = load_journal(journal_dir)
    outputs = reconstruct_outputs(final_states)
    tmp = f"{out_path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"outputs": {str(u): t for u, t in outputs.items()},
                   "recovery": summary,
                   "closed": {str(u): st.reason
                              for u, st in final_states.items()
                              if st.closed},
                   "stats": session.stats(),
                   "recovery_counters": dict(session.recovery_counters),
                   "launches": launches,
                   "drained": draining if spool_dir else drain["pending"]},
                  f)
    os.replace(tmp, out_path)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI — supervisor mode (default) spawns and supervises the worker::

        python -m deepspeedsyclsupport_tpu_torch.inference.v2.supervisor \\
            --spec spec.json [--restart-limit N] [--serve-hang-limit N] \\
            [--health-file health.json] [--heartbeat-timeout S]

    ``--worker`` runs the serving loop itself (the supervisor's child). A
    spec whose ``topology`` spans more than one rank is served by a pod of
    that many worker processes (:meth:`ReplicaSupervisor._spawn`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True,
                    help="worker spec JSON (see serve_worker docstring)")
    ap.add_argument("--worker", action="store_true",
                    help="run the serving worker loop (child mode)")
    ap.add_argument("--restart-limit", type=int, default=3)
    ap.add_argument("--serve-hang-limit", type=int, default=None,
                    help="consecutive stuck-decode exits (rc 219) before "
                         "the supervisor gives up (default: unbounded)")
    ap.add_argument("--storm-limit", type=int, default=None)
    ap.add_argument("--backoff-seconds", type=float, default=0.5)
    ap.add_argument("--drain-grace", type=float, default=30.0)
    ap.add_argument("--health-file", default=None)
    ap.add_argument("--heartbeat-timeout", type=float, default=None)
    args = ap.parse_args(argv)
    if args.worker:
        return serve_worker(args.spec)
    with open(args.spec) as f:
        spec = json.load(f)
    journal_dir = spec["journal_dir"]
    world = topology_world(spec.get("topology"))
    sup = ReplicaSupervisor(
        [sys.executable, "-m",
         "deepspeedsyclsupport_tpu_torch.inference.v2.supervisor",
         "--worker", "--spec", args.spec],
        restart_limit=args.restart_limit,
        serve_hang_limit=args.serve_hang_limit,
        storm_limit=args.storm_limit,
        backoff_seconds=args.backoff_seconds,
        drain_grace=args.drain_grace,
        health_file=args.health_file
        or os.path.join(journal_dir, "health.json"),
        heartbeat_file=os.path.join(journal_dir, "heartbeat_rank0.json"),
        heartbeat_timeout=args.heartbeat_timeout,
        nprocs=world if world > 1 else None)
    sup.install_drain_handler()
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
