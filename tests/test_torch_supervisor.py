"""PyTorch port: the replica supervisor, the elastic agent's restart
accounting and the serving worker, against the JAX package's.

The agent's per-cause accounting is held equal to the JAX agent's on
scripted exit-code sequences. Three tests start the port's serving worker
in child processes on the CPU (spec ``device: "cpu"``): a ``decode_wedge``
injection that the stuck-decode watchdog turns into rc 219 with a
``serve/hang`` record in the journal; a supervised ``serve_crash`` whose
restarted worker replays the journal to outputs equal to ``generate``; and
the supervisor CLI on a clean run. Their waits are generous and nothing
here asserts a duration.
"""
import json
import os
import subprocess
import sys

import pytest

from deepspeedsyclsupport_tpu.elasticity import elastic_agent as jax_agent
from deepspeedsyclsupport_tpu.elasticity import elasticity as jax_elasticity
from deepspeedsyclsupport_tpu.inference.v2 import supervisor as jax_sup
from deepspeedsyclsupport_tpu_torch.elasticity import elastic_agent, elasticity
from deepspeedsyclsupport_tpu_torch.inference.v2 import (
    InferenceEngineV2, ReplicaSupervisor, supervisor as sup)
from deepspeedsyclsupport_tpu_torch.models import build_model
from deepspeedsyclsupport_tpu_torch.monitor.telemetry import (
    Heartbeat, resilience_counters)
from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
    ENV_SPEC, configure_fault_injection)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "deepspeedsyclsupport_tpu_torch.inference.v2.supervisor"
ENGINE = {"dtype": "float32", "block_size": 8, "max_context": 64,
          "max_tokens_per_batch": 16, "max_sequences": 4}
PROMPTS = {1: [7, 3, 11], 2: [4, 100, 42, 8, 19], 3: [9, 9, 2]}
GEN = 6
CHILD_TIMEOUT = 300


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv(ENV_SPEC, raising=False)
    monkeypatch.delenv("DSTPU_ELASTIC_ATTEMPT", raising=False)
    configure_fault_injection(None)
    resilience_counters.reset()
    yield
    configure_fault_injection(None)
    resilience_counters.reset()


# ------------------------------------------------------------- the agent
def _scripted(mod, rcs, **kw):
    class Scripted(mod.DSElasticAgent):
        def discover_world_size(self):
            return 1

        def _launch(self, env):
            self.envs.append({k: v for k, v in env.items()
                              if k.startswith("DSTPU_ELASTIC")})
            return self._rcs.pop(0)

    agent = Scripted(["true"], {"elasticity": {"enabled": False}},
                     backoff_seconds=0.0, **kw)
    agent._rcs = list(rcs)
    agent.envs = []
    return agent


SCRIPTS = {
    "serve_hang_free": ([219, 219, 0], dict(restart_limit=0)),
    "serve_hang_limit": ([219] * 5, dict(serve_hang_limit=2)),
    "crash_resets_streak": ([219, 1, 219, 0],
                            dict(restart_limit=2, serve_hang_limit=1)),
    "preemption_free": ([217, 217, 1, 0], dict(restart_limit=1)),
    "comm_hang": ([218, 218, 218], dict(comm_hang_limit=1)),
    "divergence": ([220, 220], dict(divergence_limit=1)),
    "restart_limit": ([1, 1, 1], dict(restart_limit=1)),
    "storm": ([217, 218, 219, 220, 1], dict(storm_limit=3)),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_agent_accounting_matches_jax(script):
    rcs, kw = SCRIPTS[script]
    res = []
    for mod in (jax_agent, elastic_agent):
        agent = _scripted(mod, rcs, **kw)
        rc = agent.run()
        res.append((rc, agent.restart_count, agent.preemption_count,
                    agent.comm_hang_count, agent.serve_hang_count,
                    agent.divergence_count, agent.launch_history,
                    agent.envs))
    assert res[1] == res[0]


def test_agent_pod_mode_is_not_ported():
    """The pod mode is ported now (tests/test_torch_pod_agent.py holds it
    against the JAX agent): a pod of two ``true`` ranks returns 0 with no
    teardown."""
    agent = elastic_agent.DSElasticAgent(["true"], {}, nprocs=2)
    assert agent._launch(dict(os.environ)) == 0
    assert agent.teardown_count == 0


def test_agent_backoff_and_elastic_config_match_jax():
    mine = elastic_agent.DSElasticAgent(["true"], {}, backoff_seconds=0.5,
                                        backoff_seed=7)
    ref = jax_agent.DSElasticAgent(["true"], {}, backoff_seconds=0.5,
                                   backoff_seed=7)
    assert [mine.next_backoff(n) for n in range(1, 9)] == \
        [ref.next_backoff(n) for n in range(1, 9)]
    cfg = {"elasticity": {"enabled": True, "max_train_batch_size": 2000,
                          "micro_batch_sizes": [2, 4, 6],
                          "min_gpus": 1, "max_gpus": 64}}
    for world in (1, 4, 8, 12):
        assert vars(elasticity.compute_elastic_config(cfg, world)) == \
            vars(jax_elasticity.compute_elastic_config(cfg, world))
    agent = elastic_agent.DSElasticAgent(["true"], cfg)
    assert agent._resolve(8) == jax_agent.DSElasticAgent(["true"], cfg) \
        ._resolve(8)


# -------------------------------------------------------- the supervisor
def test_worker_crash_restarts_then_succeeds(tmp_path):
    """First incarnation crashes, the second succeeds; the health probe
    ends in ``stopped``."""
    marker = str(tmp_path / "ran_once")
    health = str(tmp_path / "health.json")
    rs = ReplicaSupervisor(
        [sys.executable, "-c",
         f"import os, sys; p = {marker!r}\n"
         "if os.path.exists(p): sys.exit(0)\n"
         "open(p, 'w').close(); sys.exit(1)"],
        restart_limit=2, backoff_seconds=0.0, health_file=health,
        poll_s=0.02)
    assert rs.run() == 0
    assert rs.restart_count == 1
    assert [h["rc"] for h in rs.launch_history] == [1, 0]
    assert json.load(open(health))["state"] == "stopped"


def test_health_ready_tracks_heartbeat(tmp_path):
    hb_path = str(tmp_path / "heartbeat_rank0.json")
    health = str(tmp_path / "health.json")
    rs = ReplicaSupervisor(["true"], health_file=health,
                           heartbeat_file=hb_path, heartbeat_timeout=5.0)
    rs._write_health("serving", 123)
    assert json.load(open(health))["ready"] is False   # no beat yet
    Heartbeat(hb_path).beat(1, force=True)
    rs._write_health("serving", 123)
    h = json.load(open(health))
    assert h["ready"] is True and h["worker_pid"] == 123
    with open(hb_path, "w") as f:   # a beat well past the timeout
        json.dump({"t": 0.0, "step": 7, "pid": 1}, f)
    rs._write_health("serving", 123)
    assert json.load(open(health))["ready"] is False


def test_drain_signal_only_stores_a_flag():
    rs = ReplicaSupervisor(["true"])
    rs._on_drain_signal(15, None)
    assert rs._drain_pending and not rs.drained


def test_journal_path_matches_jax(monkeypatch):
    for attempt in (None, 0, 3):
        assert sup.journal_path("/j", 1, attempt) == \
            jax_sup.journal_path("/j", 1, attempt)
    monkeypatch.setenv("DSTPU_FLEET_GEN", "2")
    monkeypatch.setenv("DSTPU_ELASTIC_ATTEMPT", "4")
    assert sup.journal_path("/j") == jax_sup.journal_path("/j") == \
        "/j/journal_rank0.att2.4.jsonl"


def test_worker_skips_claimed_streams(tmp_path):
    """``read_claims``: a claimed uid is neither recovered nor re-served."""
    from deepspeedsyclsupport_tpu.inference.v2.fleet import failover as jf
    from deepspeedsyclsupport_tpu_torch.inference.v2.fleet import failover

    assert not failover.read_claims(str(tmp_path)).covers(1)
    with open(tmp_path / failover.CLAIM_FILE, "w") as f:
        json.dump({"uids": {"1": "router"}, "stamped": [1.5]}, f)
    mine, ref = failover.read_claims(str(tmp_path)), \
        jf.read_claims(str(tmp_path))
    assert (mine.uids, mine.stamped) == (ref.uids, ref.stamped)
    assert mine.covers(1) and not mine.covers(2)


# ------------------------------------------- the worker in child processes
def _spec(tmp_path, name, policy=None):
    jdir = str(tmp_path / f"j_{name}")
    os.makedirs(jdir, exist_ok=True)
    spec = {"model": "tiny", "dtype": "float32", "device": "cpu",
            "engine": ENGINE, "journal_dir": jdir,
            "out": str(tmp_path / f"out_{name}.json"),
            "requests": [{"uid": u, "tokens": p, "max_new_tokens": GEN}
                         for u, p in sorted(PROMPTS.items())]}
    if policy:
        spec["policy"] = policy
    path = str(tmp_path / f"spec_{name}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path, spec


def _env(inject=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(ENV_SPEC, None)
    env.pop("DSTPU_ELASTIC_ATTEMPT", None)
    if inject:
        env[ENV_SPEC] = json.dumps(inject)
    return env


def _generate():
    """What the worker serves, in this process: the same seeded weights."""
    model = build_model("tiny", dtype="float32")
    eng = InferenceEngineV2(model, model.init_params(device="cpu"),
                            device="cpu", **ENGINE)
    return {str(u): eng.generate([p], max_new_tokens=GEN)[0]
            for u, p in sorted(PROMPTS.items())}


def test_decode_wedge_exits_219_with_hang_record(tmp_path):
    spec_path, spec = _spec(tmp_path, "wedge", policy={
        "watchdog_enabled": True, "watchdog_deadline_s": 2.0,
        "watchdog_poll_s": 0.1})
    proc = subprocess.run(
        [sys.executable, "-m", MODULE, "--worker", "--spec", spec_path],
        env=_env({"decode_wedge": {"round": 4}}), capture_output=True,
        text=True, timeout=CHILD_TIMEOUT, cwd=REPO)
    assert proc.returncode == 219, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "exiting rc=219" in proc.stdout + proc.stderr
    names = []
    for p in sup._journal_files(spec["journal_dir"]):
        with open(p) as f:
            names += [json.loads(line)["name"] for line in f if line.strip()]
    assert "serve/hang" in names and "serve/arm" in names
    states, _ = sup.load_journal(spec["journal_dir"])
    assert any(st.in_flight for st in states.values())


def test_supervised_crash_replay_equals_generate(tmp_path):
    """A real worker dies mid-decode (``serve_crash`` after 7 tokens, first
    incarnation only); the supervisor restarts it; the restarted worker
    replays the journal from each stream's watermark. rc sequence (1, 0);
    outputs equal ``generate`` of each prompt."""
    spec_path, spec = _spec(tmp_path, "crash")
    os.environ[ENV_SPEC] = json.dumps(
        {"serve_crash": {"tokens": 7, "attempt": 0}})
    try:
        rs = ReplicaSupervisor(
            [sys.executable, "-m", MODULE, "--worker", "--spec", spec_path],
            restart_limit=2, backoff_seconds=0.0, poll_s=0.05,
            env={"PYTHONPATH": _env()["PYTHONPATH"]},
            health_file=os.path.join(spec["journal_dir"], "health.json"))
        assert rs.run() == 0
    finally:
        del os.environ[ENV_SPEC]
    assert [h["rc"] for h in rs.launch_history] == [1, 0]
    with open(spec["out"]) as f:
        out = json.load(f)
    want = _generate()
    assert out["outputs"] == want
    assert sorted(out["recovery"]["replayed"]) == sorted(PROMPTS)
    assert out["recovery_counters"]["replays"] == len(PROMPTS)
    assert out["recovery"]["time_to_recover_s"] is not None
    states, _ = sup.load_journal(spec["journal_dir"])
    assert all(st.closed for st in states.values())
    # the JAX package reads the port's journals to the same outputs
    jstates, _ = jax_sup.load_journal(spec["journal_dir"])
    assert jax_sup.reconstruct_outputs(jstates) == \
        sup.reconstruct_outputs(states)


def test_supervisor_cli_clean_run(tmp_path):
    spec_path, spec = _spec(tmp_path, "clean")
    proc = subprocess.run(
        [sys.executable, "-m", MODULE, "--spec", spec_path,
         "--backoff-seconds", "0.1"], env=_env(), capture_output=True,
        text=True, timeout=CHILD_TIMEOUT, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(spec["out"]) as f:
        out = json.load(f)
    assert out["outputs"] == _generate()
    assert out["recovery"]["replayed"] == []
    assert out["stats"]["completed"] == len(PROMPTS)
    health = json.load(open(os.path.join(spec["journal_dir"],
                                         "health.json")))
    assert health["state"] == "stopped"
    prom = open(os.path.join(spec["journal_dir"], "metrics_rank0.prom")).read()
    assert "dstpu_Serve_completed" in prom
