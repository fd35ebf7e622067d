"""Elastic training agent — fault-tolerant restart supervision.

Port of ``deepspeedsyclsupport_tpu/elasticity/elastic_agent.py``: monitor
one worker, or with ``nprocs`` a local pod of rank processes, and on
failure re-discover the membership, re-resolve the elastic batch config
and restart, with the reference's per-cause restart accounting
(preemption 217, collective hang 218, serving decode hang 219, divergence
220, any other failure) and capped exponential backoff, plus the heartbeat
watch that tells a hung worker from a slow one.

In pod mode each rank gets ``RANK``, ``LOCAL_RANK`` and ``DSTPU_POD_RANKS``;
the rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``) comes from
the environment the caller hands the agent, which adds none of its own, as
the JAX agent adds none. A restarted pod rendezvouses anew: a worker that
wants a fresh port per incarnation derives it from
``DSTPU_ELASTIC_ATTEMPT``.
"""
import os
import random
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .elasticity import ElasticityError, compute_elastic_config
from ..comm.watchdog import COMM_HANG_EXIT_CODE, SERVE_HANG_EXIT_CODE
from ..runtime.resilience import PREEMPTION_EXIT_CODE
from ..runtime.sentinel import DIVERGENCE_EXIT_CODE
from ..utils.logging import logger


def _parse_hostfile(path: str) -> List[Tuple[str, int]]:
    """Hostfile format ``hostname slots=N`` per line (a copy of the JAX
    package's ``launcher/runner.py`` ``parse_hostfile``)."""
    out: List[Tuple[str, int]] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=", 1)[1])
            out.append((parts[0], slots))
    if not out:
        raise ValueError(f"hostfile {path} has no host entries")
    return out


class DSElasticAgent:
    """Supervise an elastic training command (reference ``DSElasticAgent``).

    Restart accounting distinguishes three exit classes:

    * ``PREEMPTION_EXIT_CODE`` (217) — the worker caught SIGTERM, wrote an
      emergency checkpoint and exited cleanly. The restart is *free* (a
      preempted VM is fleet weather, not a crash loop) and relaunch is
      paced at the base backoff.
    * ``COMM_HANG_EXIT_CODE`` (218) — the collective watchdog
      (``comm/watchdog.py``) declared a hung all-reduce and aborted with
      stacks + flight recorder on disk. Counted separately
      (``comm_hang_restarts``, bounded by ``comm_hang_limit``) and backed
      off exponentially — a broken link would hot-loop — but never billed
      against ``restart_limit``: the code didn't crash, the fabric (or one
      host) did.
    * ``SERVE_HANG_EXIT_CODE`` (219) — the serving plane's stuck-decode
      watchdog (``inference/v2/serving.py``) declared a wedged decode
      dispatch: same treatment as 218 (own streak counter
      ``serve_hang_restarts``, bounded by ``serve_hang_limit``,
      exponential backoff, never billed to ``restart_limit``) — the
      restarted replica replays its request journal
      (``inference/v2/supervisor.py``).
    * ``DIVERGENCE_EXIT_CODE`` (220) — the training-health sentinel
      (``runtime/sentinel.py``) exhausted its skip/rollback ladder against
      a numerical fault (NaN'd state, runaway loss). Own streak counter
      (``divergence_restarts``, bounded by ``divergence_limit``),
      exponential backoff, never billed to ``restart_limit``: the restart
      resumes from the promoted *last-good* checkpoint and replays the
      health journal's skip decisions — but a model that diverges
      repeatedly from its best known state needs an operator, so the
      streak limit matters more here than for the hang classes.
    * any other non-zero rc — a real failure: counted against
      ``restart_limit`` and backed off exponentially
      (``backoff_seconds * 2^failures`` + jitter, capped at
      ``backoff_ceiling``) so a hard crash loop cannot hammer the cluster
      scheduler or a shared filesystem.

    With ``nprocs`` set the agent supervises a local POD: it spawns one
    process per rank (``RANK``/``LOCAL_RANK`` exported) and, the moment any
    rank exits non-zero, terminates the siblings immediately — they are
    wedged in a collective their dead peer will never join, and waiting for
    them to cascade into their own timeouts wastes the whole recovery
    budget. ``storm_limit`` caps TOTAL relaunches of any cause so no
    combination of free-restart classes can loop forever.
    """

    def __init__(self, cmd: Sequence[str], ds_config: Dict[str, Any],
                 min_nodes: int = 1, max_nodes: int = -1,
                 restart_limit: int = 3,
                 backoff_seconds: float = 0.0,
                 backoff_ceiling: float = 60.0,
                 backoff_jitter: float = 0.25,
                 backoff_seed: Optional[int] = None,
                 preemption_limit: Optional[int] = None,
                 comm_hang_limit: Optional[int] = None,
                 serve_hang_limit: Optional[int] = None,
                 divergence_limit: Optional[int] = None,
                 storm_limit: Optional[int] = None,
                 nprocs: Optional[int] = None,
                 teardown_grace: float = 5.0,
                 env: Optional[Dict[str, str]] = None,
                 hostfile: Optional[str] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 heartbeat_file: Optional[str] = None,
                 heartbeat_timeout: Optional[float] = None,
                 heartbeat_poll: float = 1.0,
                 hang_grace: float = 5.0):
        self.cmd = list(cmd)
        self.ds_config = ds_config
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.restart_limit = restart_limit
        self.backoff_seconds = backoff_seconds
        self.backoff_ceiling = backoff_ceiling
        self.backoff_jitter = backoff_jitter
        # consecutive preemptions before the agent gives up and returns the
        # preemption rc (None = unbounded): a fleet-wide drain that SIGTERMs
        # every relaunch would otherwise loop forever
        self.preemption_limit = preemption_limit
        # consecutive watchdog comm-hang exits (rc 218) before giving up —
        # a persistently broken interconnect is not self-healing
        self.comm_hang_limit = comm_hang_limit
        # consecutive stuck-decode exits (rc 219, the serving-plane
        # watchdog) before giving up — same reasoning as comm hangs
        self.serve_hang_limit = serve_hang_limit
        # consecutive divergence exits (rc 220, the training-health
        # sentinel) before giving up — a run that keeps diverging from its
        # last-good checkpoint needs a human, not a restart loop
        self.divergence_limit = divergence_limit
        # restart-storm cap: TOTAL relaunches of ANY cause (failure,
        # preemption, comm hang). The per-class limits each bound their own
        # streak; this bounds their sum, so alternating causes can't dodge
        # every limit (None = unbounded).
        self.storm_limit = storm_limit
        # pod supervision: spawn nprocs rank processes per launch and tear
        # the survivors down promptly when any rank dies
        self.nprocs = nprocs
        self.teardown_grace = teardown_grace
        # seedable jitter so the fault-injection suite replays identically
        self._rng = random.Random(backoff_seed)
        self._sleep = sleep_fn or time.sleep
        self.extra_env = dict(env or {})
        self.hostfile = hostfile
        # Heartbeat watch (telemetry's per-rank freshness file,
        # ``monitor/telemetry.py::Heartbeat``): when the worker's heartbeat
        # goes stale past ``heartbeat_timeout`` the step is HUNG, not slow —
        # demand a faulthandler stack dump (SIGUSR1, registered by the
        # worker's telemetry), give it ``hang_grace`` seconds, then kill and
        # restart. None disables the watch.
        self.heartbeat_file = heartbeat_file
        self.heartbeat_timeout = heartbeat_timeout
        self.heartbeat_poll = heartbeat_poll
        self.hang_grace = hang_grace
        self.hang_count = 0
        self.restart_count = 0  # failures only — preemptions are free
        self.preemption_count = 0
        self.comm_hang_count = 0
        self.serve_hang_count = 0
        self.divergence_count = 0
        self.teardown_count = 0
        self.launch_history: List[Dict[str, Any]] = []
        # set by serving-mode subclasses (ReplicaSupervisor's drain path):
        # stop supervising after the current launch instead of relaunching
        self._stop_requested = False

    def next_backoff(self, consecutive_failures: int) -> float:
        """Capped exponential backoff + jitter for the Nth consecutive
        failure (1-based). Jitter is multiplicative in
        ``[1, 1 + backoff_jitter]`` — always *added* so the cap stays a true
        ceiling on the base and concurrent agents still de-synchronize."""
        if self.backoff_seconds <= 0:
            return 0.0
        base = min(self.backoff_ceiling,
                   self.backoff_seconds * (2 ** max(0, consecutive_failures - 1)))
        return base * (1.0 + self.backoff_jitter * self._rng.random())

    # ------------------------------------------------------------ membership
    def discover_world_size(self) -> int:
        """Cards in the current deployment: WORLD_SIZE env, hostfile slots,
        or the local CUDA device count (1 without a card)."""
        if "WORLD_SIZE" in os.environ:
            return int(os.environ["WORLD_SIZE"])
        if self.hostfile and os.path.exists(self.hostfile):
            return sum(slots for _, slots in _parse_hostfile(self.hostfile))
        import torch

        return max(1, torch.cuda.device_count())

    def _resolve(self, world: int) -> Dict[str, str]:
        e = dict(self.ds_config.get("elasticity", {}))
        if not e.get("enabled", False):
            return {}
        r = compute_elastic_config(self.ds_config,
                                   target_deployment_size=world)
        return {
            "DSTPU_ELASTIC_BATCH": str(r.final_batch_size),
            "DSTPU_ELASTIC_MICRO_BATCH": str(r.micro_batch_per_gpu),
            "DSTPU_ELASTIC_GAS": str(r.gradient_accumulation_steps),
        }

    # ------------------------------------------------------------- heartbeat
    def _heartbeat_files(self) -> List[str]:
        """``heartbeat_file`` may be a glob (``heartbeat_rank*.json``) so a
        multi-rank local job is watched pod-wide — telemetry writes one
        freshness file PER RANK, and under SPMD one hung rank hangs every
        rank at the next collective."""
        import glob

        if self.heartbeat_file and glob.has_magic(self.heartbeat_file):
            return sorted(glob.glob(self.heartbeat_file))
        return [self.heartbeat_file] if self.heartbeat_file else []

    def _heartbeat_stale(self, launched_at: float) -> bool:
        from ..monitor.telemetry import Heartbeat

        ages = [Heartbeat.age(p) for p in self._heartbeat_files()]
        ages = [a for a in ages if a is not None]
        if not ages:
            # no beat yet: a worker that hangs in init (distributed setup,
            # first compile) never writes one — count staleness from launch.
            # Enabling the watch therefore REQUIRES worker telemetry
            # heartbeats; size the timeout to cover startup + first compile.
            # launched_at is monotonic: an NTP step during init must not
            # spuriously declare (or mask) a hang.
            ages = [time.monotonic() - launched_at]
        # the STALEST rank decides: one hung rank is a hung pod
        return max(ages) > self.heartbeat_timeout

    def _launch(self, env: Dict[str, str]) -> int:
        """Run one worker attempt. Without a heartbeat watch this is a plain
        blocking wait; with one, poll the freshness file and escalate on
        staleness: SIGUSR1 (worker faulthandler dumps all stacks) → grace →
        SIGTERM → SIGKILL. A hang-killed worker returns a negative rc and is
        counted as a failure by :meth:`run`."""
        if self.nprocs is not None:
            return self._launch_pod(env)
        if self.heartbeat_file is None or self.heartbeat_timeout is None:
            return subprocess.run(self.cmd, env=env).returncode
        import signal

        # a leftover heartbeat from the previous incarnation is stale by
        # definition — without this every relaunch would be declared hung
        # (and killed) before the fresh worker reaches its first beat
        for path in self._heartbeat_files():
            try:
                os.unlink(path)
            except OSError:
                pass
        launched_at = time.monotonic()
        proc = subprocess.Popen(self.cmd, env=env)
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            if self._heartbeat_stale(launched_at):
                break
            self._sleep(self.heartbeat_poll)
        from ..monitor.monitor import resilience_counters

        self.hang_count += 1
        resilience_counters.incr("hang_restarts")
        logger.error("elastic agent: heartbeat %s stale > %.1fs — worker "
                     "hung; requesting stack dump then killing pid %d",
                     self.heartbeat_file, self.heartbeat_timeout, proc.pid)
        if hasattr(signal, "SIGUSR1"):
            try:  # worker telemetry registered faulthandler on SIGUSR1
                proc.send_signal(signal.SIGUSR1)
            except OSError:  # pragma: no cover - it died under us
                pass
            self._sleep(self.hang_grace)
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=self.hang_grace)
            except subprocess.TimeoutExpired:  # pragma: no cover
                proc.kill()
        return proc.wait()

    # ------------------------------------------------------------- pod mode
    def _launch_pod(self, env: Dict[str, str]) -> int:
        """Spawn ``nprocs`` rank processes and supervise them as ONE pod.

        The moment any rank self-exits non-zero the siblings are terminated
        immediately (SIGTERM → ``teardown_grace`` → SIGKILL): under SPMD
        they are wedged inside a collective their dead peer will never
        join, and letting each discover that through its own timeout
        multiplies the recovery latency by the world size. The pod rc is
        the most *specific* self-exit cause observed — rc 218 (comm hang)
        over rc 217 (preemption) over the first plain failure — so the
        restart accounting in :meth:`run` classifies the pod by its root
        cause, not by whichever sibling our SIGTERM reaped first."""
        import signal

        for path in self._heartbeat_files():
            try:  # a leftover beat from the last incarnation is stale
                os.unlink(path)
            except OSError:
                pass
        procs: List[subprocess.Popen] = []
        for r in range(self.nprocs):
            penv = dict(env)
            penv["RANK"] = str(r)
            penv.setdefault("LOCAL_RANK", str(r))
            # declare the pod to the workers (utils/podid.py): the
            # checkpoint commit protocol and fault injection need the
            # identity even when no process group is up. Force-set
            # like RANK above — a stale DSTPU_POD_RANKS inherited from the
            # shell would make rank 0 wait for manifests from ranks this
            # pod doesn't have, leaving every save torn.
            penv["DSTPU_POD_RANKS"] = str(self.nprocs)
            procs.append(subprocess.Popen(self.cmd, env=penv))
        launched_at = time.monotonic()
        rcs: Dict[int, Optional[int]] = {}
        killed: set = set()
        tore_down = False
        while len(rcs) < len(procs):
            for i, p in enumerate(procs):
                if i not in rcs:
                    rc = p.poll()
                    if rc is not None:
                        rcs[i] = rc
            # a clean preemption (rc 217) does NOT trigger teardown: the
            # scheduler SIGTERMed every rank, and the siblings are busy
            # writing their own emergency checkpoints — killing them after
            # teardown_grace would tear exactly the saves the rc-217
            # free-restart contract exists to preserve. They exit 217 on
            # their own; crashes and watchdog aborts (218) tear down NOW.
            self_failed = {i: rc for i, rc in rcs.items()
                           if rc not in (0, PREEMPTION_EXIT_CODE)
                           and i not in killed}
            if self_failed and not tore_down and len(rcs) < len(procs):
                tore_down = True
                self._teardown_siblings(procs, rcs, killed, self_failed)
                continue  # collect the terminated siblings' rcs
            if len(rcs) == len(procs):
                break
            if self.heartbeat_file is not None \
                    and self.heartbeat_timeout is not None \
                    and self._heartbeat_stale(launched_at):
                from ..monitor.monitor import resilience_counters

                self.hang_count += 1
                resilience_counters.incr("hang_restarts")
                logger.error("elastic agent: pod heartbeat stale > %.1fs — "
                             "stack-dumping and killing all ranks",
                             self.heartbeat_timeout)
                if hasattr(signal, "SIGUSR1"):
                    for i, p in enumerate(procs):
                        if i not in rcs:
                            try:
                                p.send_signal(signal.SIGUSR1)
                            except OSError:
                                pass
                    self._sleep(self.hang_grace)
                for i, p in enumerate(procs):
                    if i not in rcs:
                        killed.add(i)
                        try:
                            p.terminate()
                        except OSError:  # pragma: no cover
                            pass
                self._kill_procs(procs, rcs)
                break
            self._sleep(self.heartbeat_poll)
        for i, p in enumerate(procs):
            if i not in rcs:
                rcs[i] = p.wait()
        self_exits = {i: rc for i, rc in rcs.items()
                      if i not in killed and rc is not None}
        return self._pod_rc(rcs, self_exits)

    def _teardown_siblings(self, procs, rcs, killed, self_failed) -> None:
        """Prompt pod teardown: a rank died, so end the survivors NOW."""
        from ..monitor.monitor import resilience_counters

        self.teardown_count += 1
        resilience_counters.incr("pod_teardowns")
        logger.error("elastic agent: rank(s) %s exited %s — tearing down "
                     "%d sibling rank(s) immediately (no cascade wait)",
                     sorted(self_failed), sorted(self_failed.values()),
                     sum(1 for i in range(len(procs)) if i not in rcs))
        for i, p in enumerate(procs):
            if i in rcs:
                continue
            rc = p.poll()
            if rc is not None:
                # it self-exited in the window since the last poll round:
                # record the real rc instead of writing it off as our kill
                # (a sibling's own rc 218 must keep its cause attribution)
                rcs[i] = rc
                continue
            killed.add(i)
            try:
                p.terminate()
            except OSError:  # pragma: no cover - died under us
                pass
        self._kill_procs(procs, rcs)

    def _kill_procs(self, procs, rcs) -> None:
        """Grace-bounded reap: SIGTERM was sent; escalate to SIGKILL."""
        deadline = time.monotonic() + self.teardown_grace
        for i, p in enumerate(procs):
            if i in rcs:
                continue
            timeout = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()

    def _pod_rc(self, rcs: Dict[int, int], self_exits: Dict[int, int]) -> int:
        """Aggregate a pod's exit: most specific self-exit cause wins."""
        fails = {i: rc for i, rc in self_exits.items() if rc != 0}
        if not fails:
            # every rank either succeeded or only died by our hand
            # (heartbeat-hang kills land here: negative rc, counted by run)
            non_zero = [rc for rc in rcs.values() if rc != 0]
            return 0 if not non_zero else non_zero[0]
        for cause in (COMM_HANG_EXIT_CODE, SERVE_HANG_EXIT_CODE,
                      DIVERGENCE_EXIT_CODE, PREEMPTION_EXIT_CODE):
            if cause in fails.values():
                return cause
        return fails[min(fails)]

    # ------------------------------------------------------------------ run
    def run(self) -> int:
        """Launch; restart on failure up to ``restart_limit`` times. A
        ``PREEMPTION_EXIT_CODE`` exit restarts for free (the worker saved an
        emergency checkpoint on SIGTERM — see ``runtime/resilience.py``) and
        resets the failure backoff; any other non-zero rc counts against the
        limit and backs off exponentially. Returns the final exit code
        (0 on success)."""
        from ..monitor.monitor import resilience_counters

        consecutive_failures = 0
        consecutive_preemptions = 0
        consecutive_comm_hangs = 0
        consecutive_serve_hangs = 0
        consecutive_divergences = 0
        while True:
            world = self.discover_world_size()
            if world < self.min_nodes:
                raise ElasticityError(
                    f"deployment of {world} below min_nodes {self.min_nodes}")
            if 0 < self.max_nodes < world:
                world = self.max_nodes
            attempt = (self.restart_count + self.preemption_count
                       + self.comm_hang_count + self.serve_hang_count
                       + self.divergence_count)
            env = dict(os.environ)
            env.update(self.extra_env)
            env.update(self._resolve(world))
            env["DSTPU_ELASTIC_RESTART_COUNT"] = str(self.restart_count)
            env["DSTPU_ELASTIC_PREEMPTION_COUNT"] = str(self.preemption_count)
            env["DSTPU_ELASTIC_COMM_HANG_COUNT"] = str(self.comm_hang_count)
            env["DSTPU_ELASTIC_SERVE_HANG_COUNT"] = str(self.serve_hang_count)
            env["DSTPU_ELASTIC_DIVERGENCE_COUNT"] = str(self.divergence_count)
            # total prior relaunches of any cause: workers use it to rotate
            # rendezvous ports / name per-incarnation artifacts
            env["DSTPU_ELASTIC_ATTEMPT"] = str(attempt)
            env["DSTPU_ELASTIC_WORLD_SIZE"] = str(world)
            logger.info("elastic agent: launching (attempt %d, world=%d)",
                        attempt + 1, world)
            rc = self._launch(env)
            self.launch_history.append(
                {"world": world, "rc": rc,
                 "restart": self.restart_count,
                 "preempted": rc == PREEMPTION_EXIT_CODE,
                 "comm_hang": rc == COMM_HANG_EXIT_CODE,
                 "serve_hang": rc == SERVE_HANG_EXIT_CODE,
                 "divergence": rc == DIVERGENCE_EXIT_CODE})
            if rc == 0:
                return 0
            if self._stop_requested:
                # a drain was requested mid-launch (ReplicaSupervisor's
                # SIGTERM forwarding): supervision ends with this rc —
                # relaunching a replica the operator asked to stop would
                # fight the deployment controller
                logger.info("elastic agent: stop requested — not "
                            "relaunching (rc=%d)", rc)
                return rc
            resilience_counters.incr("restarts")
            total_relaunches = (self.restart_count + self.preemption_count
                                + self.comm_hang_count
                                + self.serve_hang_count
                                + self.divergence_count)
            if self.storm_limit is not None \
                    and total_relaunches >= self.storm_limit:
                logger.error("elastic agent: restart storm — %d total "
                             "relaunches reached storm_limit %d (last "
                             "rc=%d); giving up",
                             total_relaunches, self.storm_limit, rc)
                return rc
            if rc in (COMM_HANG_EXIT_CODE, SERVE_HANG_EXIT_CODE,
                      DIVERGENCE_EXIT_CODE):
                # a watchdog/sentinel abort — collective hang (218),
                # serving decode hang (219) or training divergence (220):
                # stacks, flight recorder, request/health journals are on
                # disk; the restart recovers from the last pod-complete
                # (for 220: last *promoted* last-good) checkpoint and
                # replays journaled streams. Not billed against
                # restart_limit (the code didn't crash), but backed off
                # exponentially — a severed link, a wedging dispatch or a
                # persistently diverging model would otherwise hot-loop —
                # and bounded by its own per-cause consecutive limit.
                consecutive_failures = 0
                consecutive_preemptions = 0
                if rc == SERVE_HANG_EXIT_CODE:
                    consecutive_comm_hangs = 0
                    consecutive_divergences = 0
                    consecutive_serve_hangs += 1
                    self.serve_hang_count += 1
                    streak, limit = (consecutive_serve_hangs,
                                     self.serve_hang_limit)
                    what, counter = "serve hang", "serve_hang_restarts"
                    resume = ("restarting; the replica will replay its "
                              "request journal")
                    msg_what = "stuck-decode hang"
                    nth = self.serve_hang_count
                elif rc == DIVERGENCE_EXIT_CODE:
                    consecutive_comm_hangs = 0
                    consecutive_serve_hangs = 0
                    consecutive_divergences += 1
                    self.divergence_count += 1
                    streak, limit = (consecutive_divergences,
                                     self.divergence_limit)
                    what, counter = "divergence", "divergence_restarts"
                    resume = ("restarting from the promoted last-good "
                              "checkpoint; the health journal's skip "
                              "decisions replay deterministically")
                    msg_what = "training divergence"
                    nth = self.divergence_count
                else:
                    consecutive_serve_hangs = 0
                    consecutive_divergences = 0
                    consecutive_comm_hangs += 1
                    self.comm_hang_count += 1
                    streak, limit = (consecutive_comm_hangs,
                                     self.comm_hang_limit)
                    what, counter = "comm hang", "comm_hang_restarts"
                    resume = ("restarting from the newest pod-complete "
                              "checkpoint")
                    msg_what = "pod comm hang"
                    nth = self.comm_hang_count
                resilience_counters.incr(counter)
                if limit is not None and streak > limit:
                    logger.error("elastic agent: %d consecutive %s exits "
                                 "exceeds limit %d — giving up",
                                 streak, what, limit)
                    return rc
                delay = self.next_backoff(streak)
                logger.warning("elastic agent: %s (rc=%d, #%d) — "
                               "%s in %.2fs", msg_what, rc, nth, resume,
                               delay)
                if delay > 0:
                    self._sleep(delay)
                continue
            if rc == PREEMPTION_EXIT_CODE:
                # clean preemption: durable emergency checkpoint exists, the
                # eviction wasn't the worker's fault — the restart is free,
                # but not a hot loop: a fleet-wide drain SIGTERMs every
                # relaunch seconds after startup, so pace relaunches at the
                # jittered base backoff and bound the streak
                self.preemption_count += 1
                consecutive_preemptions += 1
                consecutive_failures = 0
                consecutive_comm_hangs = 0
                consecutive_serve_hangs = 0
                consecutive_divergences = 0
                if self.preemption_limit is not None \
                        and consecutive_preemptions > self.preemption_limit:
                    logger.error("elastic agent: %d consecutive preemptions "
                                 "exceeds limit %d — giving up",
                                 consecutive_preemptions,
                                 self.preemption_limit)
                    return rc
                logger.warning("elastic agent: worker preempted (rc=%d, "
                               "preemption #%d) — restarting without "
                               "consuming restart budget",
                               rc, self.preemption_count)
                delay = self.next_backoff(1)  # base only: no failure streak
                if delay > 0:
                    self._sleep(delay)
                continue
            self.restart_count += 1
            consecutive_failures += 1
            consecutive_preemptions = 0
            consecutive_comm_hangs = 0
            consecutive_serve_hangs = 0
            consecutive_divergences = 0
            if self.restart_count > self.restart_limit:
                logger.error("elastic agent: restart limit %d exhausted "
                             "(last rc=%d)", self.restart_limit,
                             rc)
                return rc
            delay = self.next_backoff(consecutive_failures)
            logger.warning("elastic agent: worker failed rc=%d — "
                           "re-discovering membership and restarting "
                           "in %.2fs", rc, delay)
            if delay > 0:
                self._sleep(delay)
