"""PyTorch port: the elastic agent's pod mode (``DSElasticAgent(nprocs=...)``)
against the JAX agent, on the same scripted children, on the CPU.

Each scenario runs both agents over 4 child processes a launch; a child
writes the environment it was given, waits for its siblings' (a rank torn
down before it wrote would be a race, not a difference), then exits with the rc its scenario
names for its rank and attempt, or waits (at most 300 s) to be torn down.
The pod rc of every launch, the teardown count, the per-cause restart
counts, the final rc and each child's exported environment are EQUAL
between the two agents. No duration is asserted.

``causes``: the children hold until the agent's first poll has passed, so
one poll sees every rc at once (no teardown) and the pod rc is the most
specific cause, 218 over 217 over a plain failure. ``_pod_rc``'s order is
also held on its own for every pair of causes.
"""
import json
import os
import sys
import textwrap

import pytest

from deepspeedsyclsupport_tpu.elasticity import elastic_agent as jagent
from deepspeedsyclsupport_tpu_torch.elasticity import elastic_agent as tagent

CHILD = textwrap.dedent('''
    import json, os, sys, time
    out, scenario = sys.argv[1], sys.argv[2]
    rank = int(os.environ["RANK"])
    attempt = int(os.environ["DSTPU_ELASTIC_ATTEMPT"])
    keys = ("RANK", "LOCAL_RANK", "DSTPU_POD_RANKS", "WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT", "DSTPU_ELASTIC_ATTEMPT",
            "DSTPU_ELASTIC_RESTART_COUNT", "DSTPU_ELASTIC_PREEMPTION_COUNT",
            "DSTPU_ELASTIC_COMM_HANG_COUNT", "DSTPU_ELASTIC_WORLD_SIZE")
    with open(os.path.join(out, f"env_{attempt}_{rank}.json"), "w") as f:
        json.dump({k: os.environ.get(k) for k in keys}, f)
    deadline = time.time() + 300
    while len([n for n in os.listdir(out) if n.startswith(
            f"env_{attempt}_")]) < 4 and time.time() < deadline:
        time.sleep(0.01)         # every rank has written its environment
    plan = json.loads(sys.argv[3])
    rc = plan[min(attempt, len(plan) - 1)][rank]
    if rc is None:                     # wait to be torn down
        time.sleep(300)
        sys.exit(0)
    if scenario == "causes" and attempt == 0:
        while not os.path.exists(os.path.join(out, "go")) and \\
                time.time() < deadline:
            time.sleep(0.01)
    sys.exit(rc)
''')

# scenario -> per attempt, per rank: the rc (None: wait to be torn down)
PLANS = {
    "crash": [[None, 3, None, None], [0, 0, 0, 0]],
    "preempt": [[217, 217, 217, 217], [0, 0, 0, 0]],
    "causes": [[1, 217, 218, 0], [0, 0, 0, 0]],
}


def _run(pkg, scenario, tmp_path, monkeypatch):
    out = tmp_path / f"{pkg.__name__.split('.')[0]}_{scenario}"
    out.mkdir()
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    monkeypatch.setenv("WORLD_SIZE", "4")

    def sleep(s):
        import time

        # "causes": the first wait after the first poll releases the
        # children together and outlasts their exits
        first = scenario == "causes" and not (out / "go").exists()
        (out / "go").touch()
        time.sleep(1.0 if first else min(s, 0.05))

    agent = pkg.DSElasticAgent(
        [sys.executable, str(child), str(out), scenario,
         json.dumps(PLANS[scenario])],
        {"elasticity": {"enabled": False}}, nprocs=4, restart_limit=1,
        teardown_grace=10.0, heartbeat_poll=0.05, sleep_fn=sleep,
        env={"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29555"})
    rc = agent.run()
    envs = {}
    for name in sorted(os.listdir(out)):
        if name.startswith("env_"):
            with open(out / name) as f:
                envs[name] = json.load(f)
    return {"rc": rc, "teardowns": agent.teardown_count,
            "restarts": agent.restart_count,
            "preemptions": agent.preemption_count,
            "comm_hangs": agent.comm_hang_count,
            "history": [h["rc"] for h in agent.launch_history],
            "envs": envs}


@pytest.mark.parametrize("scenario", list(PLANS))
def test_pod_agent_matches_jax(scenario, tmp_path, monkeypatch):
    got = _run(tagent, scenario, tmp_path, monkeypatch)
    want = _run(jagent, scenario, tmp_path, monkeypatch)
    assert got == want
    assert got["rc"] == 0 and len(got["envs"]) == 8
    assert {e["DSTPU_POD_RANKS"] for e in got["envs"].values()} == {"4"}
    assert {e["MASTER_PORT"] for e in got["envs"].values()} == {"29555"}
    first = got["history"][0]
    if scenario == "crash":
        # rank 1's crash tore the 3 siblings down
        assert (first, got["teardowns"], got["restarts"]) == (3, 1, 1)
    elif scenario == "preempt":
        assert (first, got["teardowns"], got["preemptions"]) == (217, 0, 1)
    else:
        assert (first, got["teardowns"], got["comm_hangs"]) == (218, 0, 1)


@pytest.mark.parametrize("rcs", [
    {0: 1, 1: 217}, {0: 217, 1: 218}, {0: 220, 1: 219}, {0: 1, 1: 2},
    {0: 0, 1: 0}, {0: 220, 1: 217, 2: 3}])
def test_pod_rc_prefers_the_most_specific_cause_like_jax(rcs):
    def pod_rc(pkg):
        return pkg.DSElasticAgent(["true"], {}, nprocs=len(rcs))._pod_rc(
            dict(rcs), dict(rcs))

    assert pod_rc(tagent) == pod_rc(jagent)
