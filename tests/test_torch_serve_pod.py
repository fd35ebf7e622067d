"""PyTorch port: the serving plane across ranks on the CPU. A replica whose
worker spec has a ``topology`` of two ranks (``tp2``) is a pod of two gloo
rank processes behind its ``ReplicaSupervisor``; a fleet's replicas can be
such pods.

Both runs serve ``tiny`` in float32 from one engine snapshot that the JAX
package wrote from its worker's own init (``model.init_params()``), so the
JAX package's ``serve_worker`` and fleet CLI, run at a world of one on the
same specs (they ignore ``topology``, ``device`` and ``snapshot``), serve
the same weights. Greedy tokens are held EQUAL.

* The supervisor CLI over a tp2 pod: every rank of the first incarnation
  wedges its decode at round ``WEDGE_ROUND`` (fault injection) and rank 1
  is then SIGKILLed from outside; the supervisor tears the pod down,
  relaunches it (attempt 1 in its health file) and rank 0 replays its
  journal. The outputs EQUAL the JAX ``serve_worker``'s; rank 0's journal
  records EQUAL, record for record with times (wall stamps, stage
  durations) and pids dropped, those of
  the port at a world of one killed at the same round; one close per uid;
  rank 0 alone journals, every rank beats.
* The fleet CLI (``run_fleet``) over two pod replicas, replica 0 wedged at
  ``WEDGE_ROUND`` and killed by ``ProcessReplica.kill()``: no rank of it
  survives the kill, the router fails its streams over, and the merged
  output EQUALS the JAX fleet CLI's on the same spec.

Each pod is spawned once (two incarnations for the supervised one); the
file's runs go side by side.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "deepspeedsyclsupport_tpu_torch.inference.v2.supervisor"
ENGINE = {"dtype": "float32", "block_size": 8, "max_context": 64,
          "max_tokens_per_batch": 16, "max_sequences": 4}
PROMPTS = {1: [7, 3, 11], 2: [4, 100, 42, 8, 19], 3: [9, 9, 2],
           4: [300, 12, 5, 77, 6, 1]}
GEN = 8
WEDGE_ROUND = 4
WEDGE = json.dumps({"decode_wedge": {"round": WEDGE_ROUND, "attempt": 0}})
STALE_S = 1.5          # a heartbeat this old: the rank is in the wedge
TIMEOUT = 180


def _requests(base=0):
    return [{"uid": base + u, "tokens": t, "max_new_tokens": GEN}
            for u, t in PROMPTS.items()]


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The JAX engine's snapshot of ``tiny`` at the JAX worker's init."""
    import jax.numpy as jnp  # noqa: F401  (the JAX engine's dtype module)

    from deepspeedsyclsupport_tpu.inference.v2 import (
        InferenceEngineV2 as JaxEngine)
    from deepspeedsyclsupport_tpu.models import build_model

    model = build_model("tiny", dtype="float32")
    path = str(tmp_path_factory.mktemp("pod_snap") / "snap")
    JaxEngine(model, model.init_params(), config=dict(ENGINE)).serialize(
        path)
    return path


def _env(extra=None):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                **(extra or {}))


def _alive(pid):
    """Running (a zombie is dead)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _wedged_pid(jdir, rank, deadline):
    """The pid of ``rank`` once its heartbeat has gone stale (it sits in
    the injected wedge)."""
    from deepspeedsyclsupport_tpu_torch.monitor.telemetry import Heartbeat

    path = os.path.join(jdir, f"heartbeat_rank{rank}.json")
    while time.monotonic() < deadline:
        age = Heartbeat.age(path)
        if age is not None and age > STALE_S:
            return Heartbeat.read(path)["pid"]
        time.sleep(0.05)
    raise TimeoutError(f"{path} never went stale")


def _records(jdir):
    """Rank 0's journal records, incarnation by incarnation, without their
    times (wall stamps, stage durations) and pids."""
    out = []
    for name in sorted(os.listdir(jdir)):
        if not name.startswith("journal_rank"):
            continue
        with open(os.path.join(jdir, name)) as f:
            for line in f:
                rec = json.loads(line)
                rec.pop("t", None)
                for key in ("pid", "dur"):
                    (rec.get("data") or {}).pop(key, None)
                out.append((name, rec))
    return out


# ---------------------------------------------------------------- supervisor
@pytest.fixture(scope="module")
def supervised(tmp_path_factory, snapshot):
    """The pod and the world-1 port replica under their supervisors, each
    wedged and killed once, beside the JAX ``serve_worker`` at world 1."""
    from deepspeedsyclsupport_tpu.inference.v2 import supervisor as jax_sup

    root = tmp_path_factory.mktemp("supervised")
    runs = {}
    for name, topo in (("pod", {"tp": 2}), ("world1", None)):
        spec = {"model": "tiny", "dtype": "float32", "device": "cpu",
                "snapshot": snapshot, "engine": dict(ENGINE),
                "journal_dir": str(root / name / "journal"),
                "out": str(root / name / "out.json"),
                "requests": _requests(),
                **({"topology": topo} if topo else {})}
        os.makedirs(root / name)
        path = str(root / name / "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        log = open(root / name / "log.txt", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", MODULE, "--spec", path,
             "--restart-limit", "1", "--backoff-seconds", "0"],
            env=_env({"DSTPU_FAULT_INJECTION": WEDGE}), cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT)
        runs[name] = {"spec": spec, "proc": proc, "log": log}
    killed, errors = {}, []

    def watch():
        deadline = time.monotonic() + TIMEOUT
        try:
            for name, rank in (("pod", 1), ("world1", 0)):
                pid = _wedged_pid(runs[name]["spec"]["journal_dir"], rank,
                                  deadline)
                os.kill(pid, signal.SIGKILL)
                killed[name] = pid
        except Exception as e:  # surfaced by the fixture below
            errors.append(e)

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        # the JAX worker at a world of one on the same spec (own paths)
        jax_spec = dict(runs["pod"]["spec"],
                        journal_dir=str(root / "jax" / "journal"),
                        out=str(root / "jax" / "out.json"))
        os.makedirs(root / "jax")
        with open(root / "jax" / "spec.json", "w") as f:
            json.dump(jax_spec, f)
        assert jax_sup.serve_worker(str(root / "jax" / "spec.json")) == 0
        watcher.join(TIMEOUT)
        for r in runs.values():
            r["rc"] = r["proc"].wait(timeout=TIMEOUT)
    finally:
        for r in runs.values():
            if r["proc"].poll() is None:
                r["proc"].kill()
            r["log"].close()
    logs = {n: open(root / n / "log.txt").read()[-3000:] for n in runs}
    assert not errors, (errors, logs)
    assert all(r["rc"] == 0 for r in runs.values()), logs
    with open(root / "jax" / "out.json") as f:
        jax_out = json.load(f)
    return runs, killed, jax_out


def test_pod_restart_outputs_equal_jax_serve_worker(supervised):
    runs, killed, jax_out = supervised
    assert set(killed) == {"pod", "world1"}
    for name in runs:
        with open(runs[name]["spec"]["out"]) as f:
            out = json.load(f)
        assert out["outputs"] == jax_out["outputs"], name
        assert all(len(t) == GEN for t in out["outputs"].values())
        assert sorted(out["recovery"]["replayed"]) == sorted(PROMPTS), name
        assert set(out["closed"].values()) == {"done"}
        # the plain route on the CPU; counted over the pod's ranks
        assert out["launches"] == {"flash_fwd": 0,
                                   "paged_decode_attention": 0,
                                   "ragged_prefill_attention": 0}


def test_pod_restarted_once_and_replayed_rank0_journal(supervised):
    """The supervisor relaunched the pod once (health ``attempt`` 1);
    rank 0 alone journaled, both ranks beat; one close per uid."""
    runs, killed, _ = supervised
    jdir = runs["pod"]["spec"]["journal_dir"]
    with open(os.path.join(jdir, "health.json")) as f:
        health = json.load(f)
    assert health["attempt"] == 1 and health["state"] == "stopped"
    names = sorted(os.listdir(jdir))
    assert [n for n in names if n.startswith("journal_rank")] == \
        ["journal_rank0.att0.jsonl", "journal_rank0.att1.jsonl"]
    assert {"heartbeat_rank0.json", "heartbeat_rank1.json"} <= set(names)
    closes = [rec["data"]["uid"] for _n, rec in _records(jdir)
              if rec["name"] == "serve/close"]
    assert sorted(closes) == sorted(PROMPTS)
    assert not _alive(killed["pod"])


def test_pod_journal_records_equal_world_one(supervised):
    """Record for record (times and pids dropped), both incarnations."""
    runs, _, _ = supervised
    pod = _records(runs["pod"]["spec"]["journal_dir"])
    one = _records(runs["world1"]["spec"]["journal_dir"])
    assert pod == one
    assert any(rec["name"] == "serve/admit" and rec["data"].get("replayed")
               for _n, rec in pod)


# --------------------------------------------------------------------- fleet
@pytest.fixture(scope="module")
def fleet(tmp_path_factory, snapshot, monkeypatch_module):
    """The port's fleet CLI over two tp2 pods, replica 0 wedged and killed
    with ``ProcessReplica.kill()``, beside the JAX fleet CLI on the same
    spec."""
    from deepspeedsyclsupport_tpu.inference.v2.fleet import cli as jax_cli
    from deepspeedsyclsupport_tpu_torch.inference.v2.fleet import cli, pool

    root = tmp_path_factory.mktemp("fleet")
    spec = {"n_replicas": 2,
            "worker": {"model": "tiny", "dtype": "float32", "device": "cpu",
                       "snapshot": snapshot, "engine": dict(ENGINE),
                       "topology": {"tp": 2}},
            "supervisor_args": ["--restart-limit", "0"],
            "env": {"*": {"OMP_NUM_THREADS": "1"},
                    "0": {"DSTPU_FAULT_INJECTION": WEDGE}},
            "router": {"affinity": "none"},
            "requests": _requests(100) + _requests(200),
            "timeout_s": TIMEOUT}
    started = {}
    start = pool.ProcessReplica.start

    def recording_start(self):
        started[self.replica_id] = self
        start(self)

    monkeypatch_module.setattr(pool.ProcessReplica, "start", recording_start)
    port_spec = dict(spec, root=str(root / "port"),
                     out=str(root / "port_out.json"))
    result, errors = {}, []

    def run():
        try:
            result["out"] = cli.run_fleet(port_spec)
        except Exception as e:  # surfaced below
            errors.append(e)

    def run_jax():
        # the JAX fleet at a world of one on the same spec
        try:
            result["jax"] = jax_cli.run_fleet(dict(
                spec, root=str(root / "jax"), out=str(root / "jax_out.json"),
                env={}))
        except Exception as e:  # surfaced below
            errors.append(e)

    runners = [threading.Thread(target=fn) for fn in (run, run_jax)]
    for t in runners:
        t.start()
    rank_pids, alive_after = None, None
    try:
        deadline = time.monotonic() + TIMEOUT
        jdir = str(root / "port" / "replica0" / "journal")
        _wedged_pid(jdir, 1, deadline)
        from deepspeedsyclsupport_tpu_torch.monitor.telemetry import Heartbeat

        rank_pids = [Heartbeat.read(os.path.join(
            jdir, f"heartbeat_rank{r}.json"))["pid"] for r in range(2)]
        sup_pid = started["0"].proc.pid
        started["0"].kill()
        time.sleep(1.0)
        alive_after = [p for p in rank_pids + [sup_pid] if _alive(p)]
    finally:
        for t in runners:
            t.join(TIMEOUT)
    assert not errors, errors
    return result["out"], result["jax"], rank_pids, alive_after


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_kill_takes_every_rank_of_the_pod(fleet):
    _out, _jax, rank_pids, alive_after = fleet
    assert len(set(rank_pids)) == 2
    assert alive_after == []


def test_fleet_of_pods_outputs_equal_jax_fleet_cli(fleet):
    out, jax_out, _pids, _alive = fleet
    assert out["outputs"] == jax_out["outputs"]
    assert sorted(out["outputs"]) == sorted(
        str(r["uid"]) for r in _requests(100) + _requests(200))
    assert all(len(t) == GEN for t in out["outputs"].values())
    assert set(out["closed"].values()) == {"done"}
    assert out["router"]["failover_replays"] > 0


# ------------------------------------------------------- the pod's launcher
RANK_SCRIPT = r"""
import json, os, signal, sys, time
d, mode = sys.argv[1], sys.argv[2]
rank = os.environ["RANK"]
def term(signum, frame):
    open(os.path.join(d, "term" + rank), "w").close()
    sys.exit(0)
signal.signal(signal.SIGTERM, term if mode == "drain" else signal.SIG_IGN)
with open(os.path.join(d, "env" + rank + ".json"), "w") as f:
    json.dump(dict({k: os.environ.get(k) for k in (
        "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
        "DSTPU_POD_RANKS", "DSTPU_ELASTIC_WORLD_SIZE")},
        pid=os.getpid()), f)
if mode == "die" and rank == "1":
    while not os.path.exists(os.path.join(d, "env0.json")):
        time.sleep(0.01)       # rank 0 is up (ignoring SIGTERM) first
    sys.exit(3)
while True:
    time.sleep(0.05)
"""


def _pod(tmp_path, mode, **kw):
    from deepspeedsyclsupport_tpu_torch.inference.v2 import ReplicaSupervisor

    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    return ReplicaSupervisor(
        [sys.executable, str(script), str(tmp_path), mode], nprocs=2,
        poll_s=0.05, backoff_seconds=0.0, teardown_grace=5.0,
        health_file=str(tmp_path / "health.json"), **kw)


def _envs(tmp_path, deadline):
    while time.monotonic() < deadline:
        try:
            return [json.loads((tmp_path / f"env{r}.json").read_text())
                    for r in range(2)]
        except (OSError, ValueError):
            time.sleep(0.05)
    raise TimeoutError("the ranks never started")


def test_pod_drain_reaches_every_rank(tmp_path):
    """A drain forwards SIGTERM to every rank of the pod; the ranks share
    one rendezvous; no relaunch follows."""
    sup = _pod(tmp_path, "drain", drain_grace=20.0)
    rc = {}
    runner = threading.Thread(target=lambda: rc.setdefault("rc", sup.run()))
    runner.start()
    envs = _envs(tmp_path, time.monotonic() + 60)
    sup._drain_pending = True          # what the SIGTERM handler stores
    runner.join(60)
    assert rc["rc"] == 0 and sup.drained
    assert (tmp_path / "term0").exists() and (tmp_path / "term1").exists()
    assert [e["RANK"] for e in envs] == ["0", "1"]
    assert {e["WORLD_SIZE"] for e in envs} == {"2"}
    assert {e["DSTPU_POD_RANKS"] for e in envs} == {"2"}
    assert {e["DSTPU_ELASTIC_WORLD_SIZE"] for e in envs} == {"2"}
    assert len({e["MASTER_PORT"] for e in envs}) == 1
    assert json.loads((tmp_path / "health.json").read_text())["state"] == \
        "stopped"
    assert len(sup.launch_history) == 1


def test_pod_torn_down_when_a_rank_dies(tmp_path):
    """Rank 1 exits 3: rank 0 (which ignores SIGTERM, as a rank waiting in
    a collective may) is killed at once, and the pod's rc is rank 1's."""
    sup = _pod(tmp_path, "die", restart_limit=0)
    t0 = time.monotonic()
    assert sup.run() == 3
    assert time.monotonic() - t0 < 30
    assert [h["rc"] for h in sup.launch_history] == [3]
    rank0 = json.loads((tmp_path / "env0.json").read_text())
    assert rank0["RANK"] == "0" and not _alive(rank0["pid"])
    assert json.loads((tmp_path / "health.json").read_text())["state"] == \
        "restarting"


def test_rank0_values_at_a_world_of_one():
    """``comm.rank0`` over a gloo group of one rank: every value is this
    rank's own."""
    import socket

    import torch.distributed as dist

    from deepspeedsyclsupport_tpu_torch.comm.rank0 import Rank0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        r0 = Rank0()
        assert r0.lead and r0.value(lambda: 2.5) == 2.5
        assert r0.value(lambda: -1e6 + 0.01) == -1e6 + 0.01   # float64
        assert r0.obj(lambda: {"a": [1, 2]}) == {"a": [1, 2]}
        assert r0.total({"x": 3, "y": 0}) == {"x": 3, "y": 0}
    finally:
        dist.destroy_process_group()
