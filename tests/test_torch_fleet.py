"""PyTorch port: the serving fleet (``inference/v2/fleet``) against the JAX
package's.

Both routers front two in-process ``LocalReplica``s of ``tiny`` sessions
(float32 on the CPU, the same JAX-initialised weights) under ONE synthetic
clock pattern: a clock that advances 10 ms on every call, shared by the
router and both sessions of a package, with the router module's wall clock
pinned (``LocalReplica`` maps session times to wall time through an offset
read at construction). The port calls the clock where the reference does,
so both make the same admission, placement and failover decisions. Held
EQUAL, case by case: the delivered ``FleetEvent`` stream, each ``submit``
verdict, ``counters``, ``failover_counters``, ``per_replica``, ``stats()``,
``summary_events()`` and the router's trace records (``drain_trace()``).
Cases: tenant affinity with the prefix cache and both SLA edge sheds,
prompt affinity, no affinity with ``admission: "none"`` and a replica
killed mid-decode, and a fleet whose replicas all die (the failover shed
and the no-ready-replica edge shed).

Around them: a killed replica's in-flight streams fail over exactly once
and the journals' outputs equal an unkilled run's; claim files and
journals cross-load both ways; ``_JournalTail`` tolerates torn tails;
``ProcessReplica`` health follows the probe and its staleness, and its
launch command is the port's own supervisor with the reference's
heartbeat timeout, which ``supervisor_args`` override. One test runs the
fleet CLI with two worker processes on the CPU, one of which crashes
mid-decode; it has its own timeout and asserts no duration.
"""
import functools
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.inference.v2 import (
    InferenceEngineV2 as JaxEngine, ServingPolicyConfig as JaxPolicy,
    ServingSession as JaxSession)
from deepspeedsyclsupport_tpu.inference.v2 import supervisor as jax_sup
from deepspeedsyclsupport_tpu.inference.v2.fleet import failover as jax_fo
from deepspeedsyclsupport_tpu.inference.v2.fleet import pool as jax_pool
from deepspeedsyclsupport_tpu.inference.v2.fleet import router as jax_router
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.monitor import telemetry as jax_tel
from deepspeedsyclsupport_tpu.utils import fault_injection as jax_fi
from deepspeedsyclsupport_tpu_torch.inference.v2 import (
    InferenceEngineV2, ServingPolicyConfig, ServingSession)
from deepspeedsyclsupport_tpu_torch.inference.v2 import supervisor as sup
from deepspeedsyclsupport_tpu_torch.inference.v2.fleet import failover
from deepspeedsyclsupport_tpu_torch.inference.v2.fleet import pool
from deepspeedsyclsupport_tpu_torch.inference.v2.fleet import router
from deepspeedsyclsupport_tpu_torch.models import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.monitor import telemetry as tel
from deepspeedsyclsupport_tpu_torch.utils import fault_injection as fi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
                 max_sequences=4)
WALL = 1.0e9          # the router modules' pinned wall clock
CHILD_TIMEOUT = 300


class TickClock:
    """Advances ``dt`` on every call (shared by a router and its
    replicas' sessions)."""

    def __init__(self, t: float = 100.0, dt: float = 0.01):
        self.t = t
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@functools.lru_cache(maxsize=None)
def _weights():
    model = jax_build_model("tiny", dtype="float32")
    params = model.init_params(jax.random.PRNGKey(11))
    return model, params, jax.tree.map(np.asarray, params)


def _engine(pkg):
    model, params, np_params = _weights()
    if pkg == "jax":
        return JaxEngine(model, params, dtype=jnp.float32, **ENGINE_KW)
    tmodel = build_model("tiny", dtype="float32")
    return InferenceEngineV2(tmodel, params_from_jax(np_params, tmodel.config,
                                                     device="cpu"),
                             device="cpu", dtype=torch.float32, **ENGINE_KW)


def _mods(pkg):
    if pkg == "jax":
        return (JaxSession, JaxPolicy, jax_router, jax_sup, jax_tel, jax_fi)
    return ServingSession, ServingPolicyConfig, router, sup, tel, fi


def _prompts(n, seed, lo=3, hi=14, head=()):
    rng = np.random.RandomState(seed)
    return [list(head) + rng.randint(1, 500, rng.randint(lo, hi)).tolist()
            for _ in range(n)]


# uid, prompt, max_new_tokens, tenant, ttft_sla_s, rate_sla
def _tenant_traffic():
    reqs = [(u, p, 4 + u % 4, "a" if u % 3 else "b", None, 0.0)
            for u, p in enumerate(_prompts(8, 0, head=range(30, 46)))]
    reqs.append((20, [5, 6, 7], 4, "a", None, 1e6))        # rate_unmeetable
    reqs.append((21, [8, 9, 10], 4, "b", 1e-6, 0.0))       # deadline
    return reqs


def _prompt_traffic():
    heads = ([40, 41, 42, 43], [50, 51, 52, 53])
    return [(u, list(heads[u % 2]) + p, 5, "default", None, 0.0)
            for u, p in enumerate(_prompts(6, 1, lo=2, hi=6))]


def _plain_traffic(n=6, seed=2):
    return [(u, p, 6 + u % 3, "default", None, 0.0)
            for u, p in enumerate(_prompts(n, seed))]


CASES = {
    "tenant": dict(cfg=dict(affinity="tenant"), traffic=_tenant_traffic,
                   policy=dict(prefix_cache={"enabled": True})),
    "prompt": dict(cfg=dict(affinity="prompt", affinity_prefix_tokens=4),
                   traffic=_prompt_traffic),
    "none_kill": dict(cfg=dict(affinity="none", admission="none"),
                      traffic=_plain_traffic, kill=("0",), journal=True),
    "all_die": dict(cfg=dict(affinity="none"), traffic=_plain_traffic,
                    kill=("0", "1"), journal=True, late=(30, [1, 2, 3])),
}


def _ev(events):
    return [(e.kind, e.uid, e.t, e.replica_id, [int(x) for x in e.tokens],
             e.reason) for e in events]


def _journal(path):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("t", None)
            out.append(rec)
    return out


def _closes(dirs):
    n = {}
    for d in dirs:
        for name in sorted(os.listdir(d)):
            if not name.startswith("journal_rank"):
                continue
            for rec in _journal(os.path.join(d, name)):
                if rec.get("name") == "serve/close":
                    uid = rec["data"]["uid"]
                    n[uid] = n.get(uid, 0) + 1
    return n


def _run(pkg, case, root, monkeypatch, kill=True):
    """Drive one case through one package's fleet; everything that must be
    equal between the packages, and what the holds below read."""
    spec = CASES[case]
    Session, Policy, rmod, smod, tmod, fmod = _mods(pkg)
    tmod.metrics_registry.reset()
    tmod.resilience_counters.reset()
    fmod.configure_fault_injection(None)
    monkeypatch.setattr(rmod, "time", types.SimpleNamespace(time=lambda: WALL))
    clock = TickClock()
    reps, dirs = [], []
    for rid in ("0", "1"):
        jdir = None
        policy = dict(spec.get("policy", {}))
        if spec.get("journal"):
            jdir = os.path.join(root, pkg, case, f"replica{rid}", "journal")
            os.makedirs(jdir)
            dirs.append(jdir)
            policy["journal_path"] = smod.journal_path(jdir, attempt=0)
        sess = Session(_engine(pkg), Policy(**policy), clock=clock)
        reps.append(rmod.LocalReplica(rid, sess, journal_dir=jdir))
    fleet = rmod.FleetRouter(reps, rmod.FleetConfig(**spec["cfg"]),
                             clock=clock)
    events, verdicts, in_flight = [], [], {}
    delivered = 0
    pending = list(spec["traffic"]())
    to_kill = list(spec.get("kill", ())) if kill else []
    polls = 0
    while pending or not fleet.idle:
        if pending:
            u, p, n, tenant, ttft, rate = pending.pop(0)
            verdicts.append(fleet.submit(rmod.FleetRequest(
                uid=u, tokens=p, max_new_tokens=n, tenant=tenant,
                ttft_sla_s=ttft, rate_sla=rate)))
        got = fleet.poll()
        events += got
        delivered += sum(len(e.tokens) for e in got if e.kind == "token")
        polls += 1
        assert polls < 400, "fleet did not converge"
        if to_kill and delivered >= 5 * (1 + len(spec.get("kill")) -
                                         len(to_kill)):
            rid = to_kill.pop(0)
            in_flight[rid] = sorted(u for u, f in fleet.flights.items()
                                    if f.replica_id == rid)
            reps[int(rid)].kill()
    if spec.get("late"):
        u, p = spec["late"]
        verdicts.append(fleet.submit(rmod.FleetRequest(
            uid=u, tokens=p, max_new_tokens=3)))
    out = {"events": _ev(events), "verdicts": verdicts,
           "counters": dict(fleet.counters),
           "failover": dict(fleet.failover_counters),
           "per_replica": {r: dict(c) for r, c in fleet.per_replica.items()},
           "stats": fleet.stats(), "summary": fleet.summary_events(step=1),
           "trace": fleet.drain_trace(), "in_flight": in_flight}
    fleet.close()
    for r in reps:
        r.close()
    if dirs:
        out["journals"] = {
            os.path.relpath(os.path.join(d, f), os.path.join(root, pkg)):
                _journal(os.path.join(d, f))
            for d in dirs for f in sorted(os.listdir(d))
            if f.startswith("journal_rank")}
        out["outputs"] = smod.reconstruct_outputs(smod.load_journal(dirs)[0])
        out["closes"] = _closes(dirs)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_matches_jax(case, tmp_path, monkeypatch):
    want = _run("jax", case, str(tmp_path), monkeypatch)
    got = _run("torch", case, str(tmp_path), monkeypatch)
    assert got == want
    # each case exercises what it names
    c = got["counters"]
    n_req = len(CASES[case]["traffic"]())
    if case == "tenant":
        assert c["affinity_hits"] > 0
        sheds = [r["data"].get("reason") for r in got["trace"]
                 if r["name"] == "fleet/shed"]
        assert {"rate_unmeetable", "deadline_unmeetable"} <= set(sheds)
        assert got["stats"]["realized_reuse"]["prefix_hits"] > 0
    if case == "prompt":
        assert c["affinity_hits"] > 0
    if case == "none_kill":
        assert got["failover"]["deaths"] == 1
        assert got["failover"]["replays"] == len(got["in_flight"]["0"]) > 0
        assert c["completed"] == n_req
    if case == "all_die":
        assert got["failover"]["deaths"] == 2
        assert got["failover"]["replay_sheds"] > 0
        assert got["verdicts"][-1] == ("shed", None)
        assert c["completed"] + c["shed"] == n_req + 1


def test_failover_exactly_once_equals_unkilled_run(tmp_path, monkeypatch):
    """The killed replica's in-flight streams replay once on the survivor:
    every uid closes once across both replicas' journals, and the journals'
    outputs equal the same fleet's run without the kill."""
    killed = _run("torch", "none_kill", str(tmp_path / "k"), monkeypatch)
    whole = _run("torch", "none_kill", str(tmp_path / "w"), monkeypatch,
                 kill=False)
    assert whole["failover"]["deaths"] == 0
    assert killed["outputs"] == whole["outputs"]
    assert killed["closes"] == {u: 1 for u in whole["outputs"]}
    replays = [r["data"]["uid"] for r in killed["trace"]
               if r["name"] == "fleet/failover"]
    assert sorted(replays) == killed["in_flight"]["0"]


# ------------------------------------------------------ claims, journals
def _write_journal(mod, jdir):
    os.makedirs(jdir, exist_ok=True)
    j = mod.RequestJournal(os.path.join(jdir, "journal_rank0.att0.jsonl"))
    j.admit(1, [1, 2], 6)
    j.emit(1, [10], 1)
    j.admit(2, [3], 4)
    j.close_request(2, "done")
    j.admit(3, [4, 5, 6], 5)
    j.emit(3, [7, 8], 2)
    j.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_claims_cross_load(writer, tmp_path):
    """Journal and claims written by one package: the other's reader sees
    the same states and claims, and a second claim pass by either returns
    nothing (exactly once across packages)."""
    w_sup, w_fo = (jax_sup, jax_fo) if writer == "jax" else (sup, failover)
    r_fo = failover if writer == "jax" else jax_fo
    jdir = str(tmp_path / "j")
    _write_journal(w_sup, jdir)
    first = w_fo.claim_in_flight(jdir, claimer="router")
    assert sorted(first) == [1, 3]
    assert (first[1].out, first[3].out) == ([10], [7, 8])
    w_fo.claim_uids(jdir, [9], claimer="router")
    mine, ref = r_fo.read_claims(jdir), w_fo.read_claims(jdir)
    assert (mine.uids, mine.stamped) == (ref.uids, ref.stamped)
    assert mine.uids == {"1": "router", "3": "router", "9": "router"}
    assert len(mine.stamped) == 2 and mine.stamped[0] > 1e9  # wall seconds
    assert r_fo.claim_in_flight(jdir, claimer="router") == {}
    r_fo.claim_uids(jdir, [9, 11], claimer="router")
    assert w_fo.read_claims(jdir).covers(11)
    with open(os.path.join(jdir, "failover_claim.json")) as f:
        assert set(json.load(f)) == {"uids", "stamped"}


def test_claim_write_failure_leaves_streams_local(tmp_path, monkeypatch):
    jdir = str(tmp_path / "j")
    _write_journal(sup, jdir)

    def refuse(*_a, **_k):
        raise OSError("read-only")

    monkeypatch.setattr(failover, "write_claims", refuse)
    assert failover.claim_in_flight(jdir) == {}
    failover.claim_uids(jdir, [9])      # best effort: no raise
    assert failover.read_claims(jdir).uids == {}


# ------------------------------------------------------------ process plane
def test_journal_tail_torn_tail_matches_jax(tmp_path):
    path = str(tmp_path / "journal_rank0.att0.jsonl")
    mine, ref = pool._JournalTail(str(tmp_path)), \
        jax_pool._JournalTail(str(tmp_path))
    chunks = [json.dumps({"kind": "event", "name": "serve/admit",
                          "data": {"uid": 1}}) + "\n"
              + '{"kind": "event", "name": "serve/emi',
              't", "data": {"uid": 1, "tokens": [5]}}\n',
              "", "not json\n" + json.dumps({"name": "serve/close",
                                             "data": {"uid": 1}}) + "\n"]
    names = []
    for chunk in chunks:
        with open(path, "a") as f:
            f.write(chunk)
        got = mine.read_new()
        assert got == ref.read_new()
        names.append([r["name"] for r in got])
    assert names == [["serve/admit"], ["serve/emit"], [], ["serve/close"]]


def _health(pr, state, ready, t=None):
    with open(pr.health_file, "w") as f:
        json.dump({"state": state, "ready": ready,
                   "t": time.time() if t is None else t}, f)


def test_process_replica_health(tmp_path):
    pr = pool.ProcessReplica("0", str(tmp_path / "r0"), {"model": "tiny"},
                             dead_after_s=5.0)
    assert not pr.ready() and not pr.dead()   # no probe: never came up
    _health(pr, "serving", True)
    assert pr.ready() and not pr.dead()
    _health(pr, "serving", True, t=time.time() - 60)
    assert not pr.ready() and pr.dead()       # stale probe
    pr._expected_down = True                  # drain / respawn keeps streams
    assert not pr.dead()
    pr._expected_down = False
    _health(pr, "draining", True)
    assert not pr.ready() and pr.draining()
    _health(pr, "serving", False)
    assert not pr.ready()


def test_process_replica_transport_matches_jax(tmp_path):
    """Spool files and journal-derived events equal the JAX pool's."""
    reps = {"torch": pool.ProcessReplica("0", str(tmp_path / "t"),
                                         {"model": "tiny"}),
            "jax": jax_pool.ProcessReplica("0", str(tmp_path / "j"),
                                           {"model": "tiny"})}
    rmods = {"torch": router, "jax": jax_router}
    seen = {}
    for pkg, pr in reps.items():
        pr.submit(rmods[pkg].FleetRequest(uid=3, tokens=[1, 2],
                                          max_new_tokens=4, tenant="t",
                                          ttft_sla_s=0.5))
        pr.replay(sup.ReplayRequest(uid=4, tokens=[5], max_new_tokens=3,
                                    out=[9]))
        files = sorted(os.listdir(pr.spool_dir))
        recs = []
        for name in files:
            with open(os.path.join(pr.spool_dir, name)) as f:
                rec = json.load(f)
            assert abs(time.time() - rec.pop("spooled_t")) < 60.0
            recs.append(rec)
        j = sup.RequestJournal(os.path.join(pr.journal_dir,
                                            "journal_rank0.att0.jsonl"))
        j.admit(1, [1], 4)
        j.emit(1, [9, 8], 2)
        j.close_request(1, "done")
        j.admit(2, [2], 4)
        j.close_request(2, "replay_shed")
        j.admit(5, [2], 4)
        j.close()
        evs = [(e.kind, e.uid, e.replica_id, e.tokens, e.reason)
               for e in pr.poll_events()]
        with open(pr.spec_path) as f:
            spec = json.load(f)
        seen[pkg] = (files, recs, evs, pr.load(), pr.max_live,
                     sorted(spec))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][3] == {"live": 1, "queued": 0}


def test_process_replica_launches_port_supervisor(tmp_path, monkeypatch):
    """``start`` runs the port's supervisor module with the checkout on
    ``PYTHONPATH`` and the reference's 30 s heartbeat timeout, which
    ``supervisor_args`` (appended after it) override: the supervisor's own
    CLI parser keeps the last value."""
    launched = []

    class FakePopen:
        pid = 4242

        def __init__(self, cmd, env=None, start_new_session=False):
            launched.append((cmd, env, start_new_session))

        def poll(self):
            return None

    monkeypatch.setattr(pool.subprocess, "Popen", FakePopen)
    pr = pool.ProcessReplica("0", str(tmp_path / "r0"),
                             {"model": "tiny", "device": "cpu"},
                             supervisor_args=["--heartbeat-timeout", "300"])
    pr.start()
    cmd, env, own_session = launched[0]
    assert cmd[1:3] == ["-m",
                        "deepspeedsyclsupport_tpu_torch.inference.v2."
                        "supervisor"]
    assert own_session and env["DSTPU_FLEET_GEN"] == "0"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    i = cmd.index("--heartbeat-timeout")
    assert cmd[i + 1] == "30" and cmd[-2:] == ["--heartbeat-timeout", "300"]
    with pytest.raises(RuntimeError):
        pr.start()                      # still running

    made = {}

    class FakeSupervisor:
        def __init__(self, cmd, **kw):
            made.update(kw)

        def install_drain_handler(self):
            pass

        def run(self):
            return 0

    monkeypatch.setattr(sup, "ReplicaSupervisor", FakeSupervisor)
    assert sup.main(cmd[3:]) == 0
    assert made["heartbeat_timeout"] == 300.0
    assert made["health_file"] == pr.health_file


def test_fleet_config_validation_matches_jax():
    for bad in (dict(admission="x"), dict(affinity="y"),
                dict(dead_after_s=0), dict(slo_window_s=-1),
                dict(slo_budget=0), dict(slo_budget=1.5)):
        with pytest.raises(ValueError) as mine:
            router.FleetConfig(**bad)
        with pytest.raises(ValueError) as ref:
            jax_router.FleetConfig(**bad)
        assert str(mine.value) == str(ref.value)
    assert vars(router.FleetConfig()) == vars(jax_router.FleetConfig())
    assert router.FLEET_EVENT_NAMES == jax_router.FLEET_EVENT_NAMES
    for name in router.FLEET_EVENT_NAMES:
        assert tel.is_declared(name), name


# ------------------------------------------------- the CLI, two processes
def test_fleet_cli_replica_crash_fails_over(tmp_path):
    """``python -m deepspeedsyclsupport_tpu_torch.inference.v2.fleet`` with
    two worker processes on the CPU; replica 0's worker crashes after 4
    emitted tokens and its supervisor may not restart it, so its in-flight
    streams fail over to replica 1. The fleet-wide journal merge equals
    ``generate`` of each prompt with the workers' seeded weights, every
    stream closes once, and the claim covers exactly the dead replica's
    in-flight uids."""
    engine = dict(ENGINE_KW, dtype="float32")
    prompts = _prompts(6, 3)
    gen = 8
    spec = {"root": str(tmp_path / "fleet"), "n_replicas": 2,
            "worker": {"model": "tiny", "dtype": "float32", "device": "cpu",
                       "engine": engine},
            "supervisor_args": ["--restart-limit", "0"],
            "env": {"0": {fi.ENV_SPEC: json.dumps(
                {"serve_crash": {"tokens": 4}})}},
            "router": {"affinity": "none", "dead_after_s": 5.0},
            "requests": [{"uid": u, "tokens": p, "max_new_tokens": gen}
                         for u, p in enumerate(prompts)],
            "out": str(tmp_path / "out.json"), "timeout_s": 240}
    spec_path = str(tmp_path / "fleet.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(fi.ENV_SPEC, None)
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeedsyclsupport_tpu_torch.inference.v2."
         "fleet", "--spec", spec_path], env=env, capture_output=True,
        text=True, timeout=CHILD_TIMEOUT, cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    with open(spec["out"]) as f:
        out = json.load(f)
    model = build_model("tiny", dtype="float32")
    eng = InferenceEngineV2(model, model.init_params(device="cpu"),
                            device="cpu", **engine)
    want = {str(u): eng.generate([p], max_new_tokens=gen)[0]
            for u, p in enumerate(prompts)}
    assert out["outputs"] == want
    assert set(out["closed"]) == set(want)
    stats = out["router"]
    assert stats["failover_deaths"] == 1 and stats["replicas_dead"] == ["0"]
    dirs = [os.path.join(spec["root"], f"replica{i}", "journal")
            for i in range(2)]
    assert _closes(dirs) == {u: 1 for u in range(len(prompts))}
    claimed = {int(u) for u in failover.read_claims(dirs[0]).uids}
    assert stats["failover_replays"] == len(claimed) > 0
    states, _ = sup.load_journal(dirs[0])
    assert {u for u, st in states.items() if st.in_flight} <= claimed
    assert not claimed & {u for u, st in states.items() if st.closed}
    # the JAX package merges the port's journals to the same outputs
    jstates, _ = jax_sup.load_journal(dirs)
    assert {str(u): t for u, t in
            jax_sup.reconstruct_outputs(jstates).items()} == want


def test_pool_rolling_restart_one_replica_at_a_time(tmp_path):
    """``ReplicaPool.rolling_restart`` drains, respawns and waits ready one
    replica at a time, in id order; ``respawn`` refuses a live replica
    (process-free: the replicas' process calls are scripted)."""
    steps = []

    class FakeProc:
        def __init__(self):
            self.rc = None

        def poll(self):
            return self.rc

    class Scripted(pool.ProcessReplica):
        def start(self):
            steps.append(("start", self.replica_id))
            self.proc = FakeProc()

        def drain(self):
            steps.append(("drain", self.replica_id))
            self.proc.rc = 0

        def ready(self):
            return self.proc is not None and self.proc.rc is None

    reps = [Scripted(str(i), str(tmp_path / f"r{i}"), {"model": "tiny"})
            for i in (1, 0)]
    p = pool.ReplicaPool(reps)
    p.start()
    assert p.wait_ready(timeout=5.0, poll_s=0.01)
    with pytest.raises(RuntimeError, match="still running"):
        p.respawn("0")
    del steps[:]
    p.rolling_restart(wait_ready_s=5.0, poll_s=0.01)
    assert steps == [("drain", "0"), ("start", "0"),
                     ("drain", "1"), ("start", "1")]
    with pytest.raises(ValueError, match="unique"):
        pool.ReplicaPool([reps[0], reps[0]])
