"""PyTorch port: training observability against the JAX package, on the CPU.

Telemetry, the goodput ledger, the monitors, the sentinel's ``Health/*``
events, the pod report and the step watchdog, each held against the JAX
package's on the same inputs:

* the telemetry facade and the goodput accounter on ONE fake clock, fed
  the same calls: the JSONL records, the goodput summary and events and
  the Prometheus text are EQUAL (``Compile/*`` aside: the port compiles
  nothing and reads 0, by design, ROADMAP.md §C);
* a 4-step ``tiny`` engine run with telemetry and the CSV monitor against
  the JAX engine: the same CSV files and step columns, losses within 1e-5
  (float32 summation order, as ``test_torch_train.py``), the (kind, name,
  step) record sequences EQUAL but for the JAX compile records
  (``compile/train_step``, ``Compile/*``), the heartbeat's step EQUAL;
* ``Health/*`` on the NaN-injected sentinel run of
  ``test_torch_sentinel.py``: EQUAL;
* four port ``Telemetry(rank=r)`` in one process, with skewed clocks and
  anchors, write rank streams; both packages' ``pod_report_from_paths``
  over them: EQUAL reports;
* one child process with ``telemetry.watchdog`` on and an injected hang
  inside a step exits 218; an engine with telemetry leaves no thread
  behind once its telemetry is closed.
"""
import csv
import json
import math
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import deepspeedsyclsupport_tpu as dstpu
from deepspeedsyclsupport_tpu.comm.topology import build_topology
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.monitor import monitor as jmon
from deepspeedsyclsupport_tpu.monitor import pod as jpod
from deepspeedsyclsupport_tpu.monitor import telemetry as jtel
from deepspeedsyclsupport_tpu.runtime.config import (
    TelemetryConfig as JTelCfg)
from deepspeedsyclsupport_tpu.utils.fault_injection import (
    configure_fault_injection as jconfigure)
from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.monitor import monitor as tmon
from deepspeedsyclsupport_tpu_torch.monitor import pod as tpod
from deepspeedsyclsupport_tpu_torch.monitor import telemetry as ttel
from deepspeedsyclsupport_tpu_torch.runtime import engine as teng
from deepspeedsyclsupport_tpu_torch.runtime.config import (
    DSTpuConfig, TelemetryConfig as TTelCfg)
from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
    configure_fault_injection as tconfigure)
from tests.test_torch_sentinel import (SENTINEL, _jax_engine as
                                       _jax_simple_engine,
                                       _port_engine as _port_simple_engine)
from tests.unit.simple_model import random_dataset, simple_config

REPO = Path(__file__).resolve().parent.parent
SEQ = 32


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("DSTPU_FAULT_INJECTION", raising=False)
    monkeypatch.delenv("DSTPU_TELEMETRY", raising=False)
    for pkg in (jtel, ttel):
        pkg.metrics_registry.reset()
        pkg.resilience_counters.reset()
        # anchor epochs count per process: earlier engines in this worker
        # must not shift them
        monkeypatch.setattr(pkg, "_anchor_counter", 0)
    for reset in (jconfigure, tconfigure):
        reset(None)
    yield
    for reset in (jconfigure, tconfigure):
        reset(None)


class _Clock:
    """One fake clock for ``time.time``, ``perf_counter`` and
    ``monotonic``: it moves only when the test moves it."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for name in ("time", "perf_counter", "monotonic"):
        monkeypatch.setattr(time, name, c)
    return c


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _no_compile(events):
    return [e for e in events if not e[0].startswith("Compile/")]


# ====================================================== telemetry + goodput
TEL = {"enabled": True, "memory_interval_steps": 2,
       "stack_dump_on_hang": False, "textfile": {"enabled": True,
                                                 "interval_s": 0.5},
       "heartbeat": {"interval_s": 0.1}}


def _drive_telemetry(pkg, cfg_cls, jsonl_cls, out, clock):
    cfg = cfg_cls.from_dict(dict(TEL, output_dir=str(out)))
    jsonl = jsonl_cls(path=str(out / "flightrec_rank0.jsonl"),
                      flush_interval=1)
    tel = pkg.Telemetry(cfg, jsonl=jsonl, rank=0)
    tel.goodput = pkg.GoodputAccounter(clock=clock)
    tel.heartbeat._clock = clock
    tel.anchor("engine_init")
    events = []
    for step in range(1, 6):
        clock.t += 0.4
        tel.on_step_end(step, dur=0.25 + 0.01 * step)
        if step == 3:
            with tel.ckpt_span("save", step=step):
                clock.t += 1.5
            tel.record_health(step, {
                "action": "warn", "cause": "spike", "position": 2,
                "skipped": False, "loss_z": 5.5, "grad_norm_z": 1.25,
                "nonfinite": 0, "streak": 0,
                "region_norms": {"attn": 0.5, "mlp": 0.25}})
        if step % 2 == 0:
            events.extend(tel.periodic_events(step * 4))
    summary = tel.goodput.summary()
    goodput_events = tel.goodput.events(20)
    prom = Path(tel.export_textfile()).read_text()
    tel.close()
    return (_records(out / "flightrec_rank0.jsonl"), summary,
            goodput_events, _no_compile(events), prom,
            json.loads((out / "heartbeat_rank0.json").read_text()))


def test_telemetry_and_goodput_equal_jax_on_one_clock(tmp_path, clock):
    start = clock.t
    want = _drive_telemetry(jtel, JTelCfg, jmon.JsonlMonitor,
                            tmp_path / "jax", clock)
    clock.t = start
    for pkg in (jtel, ttel):
        pkg.metrics_registry.reset()
    got = _drive_telemetry(ttel, TTelCfg, tmon.JsonlMonitor,
                           tmp_path / "torch", clock)
    names = ("JSONL records", "goodput summary", "goodput events",
             "periodic events", "Prometheus text", "heartbeat")
    for name, g, w in zip(names, got, want):
        assert g == w, name
    kinds = {(r["kind"], r["name"]) for r in got[0]}
    assert {("span", "step"), ("span", "ckpt/save"),
            ("event", "health/step"), ("gauge", "memory/hbm"),
            ("meta", "align/anchor")} <= kinds
    assert math.isclose(sum(got[1][c] for c in ttel.GoodputAccounter
                            .CATEGORIES), got[1]["total"])


def test_compile_stats_read_zero_and_tree_shapes():
    assert ttel.compile_stats() == (0, 0.0)
    batch = {"input_ids": np.zeros((4, SEQ), np.int32),
             "seg": [np.zeros((2,), np.float32)]}
    assert ttel.tree_shapes(batch) == jtel.tree_shapes(batch)
    new = {"input_ids": np.zeros((4, 16), np.int32)}
    assert ttel.shape_diff(ttel.tree_shapes(batch), ttel.tree_shapes(new)) \
        == jtel.shape_diff(jtel.tree_shapes(batch), jtel.tree_shapes(new))


# ============================================================ engine run
ENGINE_CFG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}},
    "steps_per_print": 2,
}


def _observed(out):
    return dict(ENGINE_CFG,
                telemetry={"enabled": True, "output_dir": str(out),
                           "memory_interval_steps": 1,
                           "stack_dump_on_hang": False,
                           # a beat every step: the file's step is then no
                           # function of how fast the steps ran
                           "heartbeat": {"interval_s": 0.0}},
                csv_monitor={"enabled": True, "output_path": str(out),
                             "job_name": "csv"})


def _batches(n=4):
    rng = np.random.RandomState(11)
    return [{"input_ids": rng.randint(0, 512, (4, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _csv(out):
    d = out / "csv"
    rows = {}
    for f in sorted(os.listdir(d)):
        with open(d / f) as fh:
            rows[f] = [(int(r[0]), float(r[1])) for r in csv.reader(fh)]
    return rows


def _summary(out):
    recs = _records(out / "flightrec_rank0.jsonl")
    return [(r["kind"], r["name"], r.get("step")) for r in recs
            if not r["name"].startswith(("compile/", "Compile/"))]


def test_engine_run_with_telemetry_and_csv_matches_jax(tmp_path):
    jmodel = jax_build_model("tiny", dtype="float32")
    jparams = jax.tree.map(np.asarray,
                           jmodel.init_params(jax.random.PRNGKey(3)))
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    topo = build_topology(dp=1, devices=jax.devices()[:1])
    jeng = dstpu.initialize(model=jmodel, config=_observed(jout),
                            topology=topo,
                            params=jax.tree.map(jax.numpy.asarray,
                                                jparams))[0]
    model = build_model("tiny", dtype="float32")
    teng_ = teng.initialize(model=model, params=params_from_jax(
        jparams, model.config, device="cpu"), config=_observed(tout),
        device="cpu")[0]
    for b in _batches():
        jeng.train_batch({k: jax.numpy.asarray(v) for k, v in b.items()})
        teng_.train_batch(b)
    for eng in (jeng, teng_):
        eng.telemetry.close()
        eng.monitor.close()
    want, got = _csv(jout), _csv(tout)
    assert sorted(got) == sorted(want)
    for f in want:
        assert [s for s, _ in got[f]] == [s for s, _ in want[f]], f
    np.testing.assert_allclose(
        [v for _, v in got["Train%2FSamples%2Ftrain_loss.csv"]],
        [v for _, v in want["Train%2FSamples%2Ftrain_loss.csv"]],
        rtol=1e-5)
    assert _summary(tout) == _summary(jout)
    hb = [json.loads((o / "heartbeat_rank0.json").read_text())["step"]
          for o in (jout, tout)]
    assert hb == [4, 4]
    # the window needs a card: a CPU engine's ledger raises with why
    with pytest.raises(RuntimeError, match="no MFU trace window"):
        teng_.mfu_ledger()


def test_engine_leaves_no_thread_after_close(tmp_path):
    cfg = simple_config(telemetry={
        "enabled": True, "output_dir": str(tmp_path),
        "stack_dump_on_hang": False,
        "watchdog": {"enabled": True, "deadline_s": 30.0}})
    before = set(threading.enumerate())
    eng = _port_simple_engine(cfg)
    for b in random_dataset(eng.train_batch_size(), n_batches=2, seed=1):
        eng.train_batch(b)
    assert eng.telemetry.watchdog is not None
    eng.telemetry.close()
    assert set(threading.enumerate()) <= before


# ================================================================ Health/*
def _health_run(make, configure, out):
    configure({"nan_step": {"rank": 0, "step": 3}})
    cfg = simple_config(
        sentinel=dict(SENTINEL, skip_limit=99),
        telemetry={"enabled": True, "output_dir": str(out),
                   "stack_dump_on_hang": False, "heartbeat":
                   {"enabled": False}})
    eng = make(cfg)
    for b in random_dataset(eng.train_batch_size(), n_batches=8, seed=3):
        eng.train_batch(b)
    recs = [json.dumps(r["data"], sort_keys=True) for r in
            eng.telemetry.recorder.snapshot()
            if r["name"] == "health/step"]
    events = eng.telemetry.health_events(32)
    eng.telemetry.close()
    return recs, json.dumps(events)


def test_health_events_on_a_nan_run_equal_jax(tmp_path):
    want = _health_run(_jax_simple_engine, jconfigure, tmp_path / "jax")
    got = _health_run(_port_simple_engine, tconfigure, tmp_path / "torch")
    assert len(got[0]) == 1 and '"action": "skip"' in got[0][0]
    assert got == want


# ============================================================== pod report
OFFSETS = (0.0, 3.25, -1.5, 0.75)      # each rank's clock skew, seconds
STRAGGLER = 2


def test_pod_report_over_port_rank_streams_equals_jax(tmp_path, clock,
                                                      monkeypatch):
    tels = []
    true_t = 5000.0
    for r, off in enumerate(OFFSETS):
        clock.t = true_t + off
        cfg = TTelCfg.from_dict(dict(TEL, output_dir=str(tmp_path)))
        jsonl = tmon.JsonlMonitor(
            path=str(tmp_path / f"flightrec_rank{r}.jsonl"),
            flush_interval=1)
        tel = ttel.Telemetry(cfg, jsonl=jsonl, rank=r)
        # each rank is its own process: its anchor epochs count from 1
        monkeypatch.setattr(ttel, "_anchor_counter", 0)
        tel.anchor("engine_init")
        tels.append(tel)
    for step in range(1, 7):
        true_t += 1.0
        for r, tel in enumerate(tels):
            dur = 0.5 + (0.3 if r == STRAGGLER else 0.0) + 0.01 * step
            clock.t = true_t + OFFSETS[r] + dur
            tel.on_step_end(step, dur=dur)
    for tel in tels:
        tel.close()
    want = jpod.pod_report_from_paths([str(tmp_path)])
    got = tpod.pod_report_from_paths([str(tmp_path)])
    assert got.to_dict() == want.to_dict()
    assert got.render() == want.render()
    assert tpod.validate_pod_report(got.to_dict()) == []
    d = got.to_dict()
    assert d["align"]["method"] == "anchor" and d["ranks"] == [0, 1, 2, 3]
    assert d["n_steps"] == 6
    # the anchors recover the skews exactly
    for r, off in enumerate(OFFSETS):
        assert d["align"]["offsets_s"][str(r)] == pytest.approx(off)
    assert max(d["straggler"]["counts"], key=d["straggler"]["counts"].get) \
        == str(STRAGGLER)


# ================================================================ watchdog
# the child imports torch and the port only (not jax): a two-layer tanh
# MLP regression, tests/unit/simple_model.py's, on numpy data
_WATCHDOG_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    from deepspeedsyclsupport_tpu_torch.runtime import engine as teng

    def loss(params, batch, rng=None):
        h = batch["x"]
        for i in range(2):
            h = torch.tanh(h @ params[f"w{{i}}"])
        return ((h - batch["y"]) ** 2).mean()

    rng = np.random.default_rng(0)
    params = {{f"w{{i}}": rng.normal(0, 0.1, (8, 8)).astype(np.float32)
              for i in range(2)}}
    cfg = {{"train_micro_batch_size_per_gpu": 2,
           "optimizer": {{"type": "Adam", "params": {{"lr": 1e-2}}}},
           "telemetry": {{"enabled": True, "output_dir": {out!r},
                         "stack_dump_on_hang": False,
                         "watchdog": {{"enabled": True, "deadline_s": 1.0,
                                      "poll_s": 0.05}}}}}}
    eng = teng.initialize(loss_fn=loss, params=params, config=cfg,
                          device="cpu")[0]
    for _ in range(4):
        x = rng.normal(0, 1, (2, 8)).astype(np.float32)
        eng.train_batch({{"x": x, "y": np.tanh(x)}})
    sys.exit(0)
""")


def test_watchdog_child_exits_218_on_a_hang_inside_a_step(tmp_path):
    from deepspeedsyclsupport_tpu_torch.comm.watchdog import (
        COMM_HANG_EXIT_CODE)

    env = dict(os.environ, PYTHONPATH=str(REPO),
               DSTPU_FAULT_INJECTION=json.dumps({"hang_step": {
                   "rank": 0, "step": 2, "phase": "in", "seconds": 60}}))
    code = _WATCHDOG_CHILD.format(repo=str(REPO), out=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == COMM_HANG_EXIT_CODE == 218, proc.stderr[-2000:]
    recs = _records(tmp_path / "flightrec_rank0.jsonl")
    assert [r["step"] for r in recs if r["name"] == "comm/hang"] == [2]


# ================================================================= config
def test_observability_sections_parse_as_jax():
    from deepspeedsyclsupport_tpu.runtime.config import DSTpuConfig as JCfg

    d = dict(ENGINE_CFG, wall_clock_breakdown=True,
             telemetry={"enabled": True, "mfu": {"enabled": True,
                                                 "step": 4},
                        "watchdog": {"enabled": True, "deadline_s": 5},
                        "textfile": {"enabled": True}},
             csv_monitor={"enabled": True, "job_name": "j"},
             tensorboard={"enabled": True}, wandb={"enabled": True,
                                                   "project": "p"},
             jsonl_monitor={"enabled": True},
             flops_profiler={"enabled": True, "profile_step": 2,
                             "output_file": "f.txt"},
             jax_profiler={"enabled": True, "start_step": 3})
    got, want = DSTpuConfig.from_config(d, 1), JCfg.from_config(d, 1)
    for sec in ("telemetry", "monitor", "flops_profiler"):
        assert vars(getattr(got, sec)) == vars(getattr(want, sec)), sec
    assert got.wall_clock_breakdown is True
    for bad in ({"offload_optimizer": {"device": "cpu"}},):
        with pytest.raises(NotImplementedError, match="A.3.2"):
            DSTpuConfig.from_config(dict(ENGINE_CFG, zero_optimization=dict(
                stage=2, **bad)), 1)


def test_monitor_master_backends_as_jax(tmp_path):
    """CSV on rank 0 (no process group: this process), W&B disabled with a
    warning where ``wandb`` is missing, a CSV directory that cannot be
    made raises, as the JAX package's MonitorMaster does."""
    from deepspeedsyclsupport_tpu.runtime.config import MonitorConfig as JMC
    from deepspeedsyclsupport_tpu_torch.runtime.config import (
        MonitorConfig as TMC)

    d = {"csv_monitor": {"enabled": True, "output_path": str(tmp_path),
                         "job_name": "j"},
         "wandb": {"enabled": True, "project": "p"}}
    tm = tmon.MonitorMaster(TMC.from_config_dict(d))
    jm = jmon.MonitorMaster(JMC.from_config_dict(d))
    assert [type(m).__name__ for m in tm.monitors] == \
        [type(m).__name__ for m in jm.monitors]
    assert [m.enabled for m in tm.monitors] == [m.enabled for m in
                                                jm.monitors]
    tm.write_events([("Train/Samples/train_loss", 1.5, 4)])
    tm.close()
    assert (tmp_path / "j" / "Train%2FSamples%2Ftrain_loss.csv"
            ).read_text() == "4,1.5\n"
    (tmp_path / "file").write_text("")
    bad = {"csv_monitor": {"enabled": True,
                           "output_path": str(tmp_path / "file")}}
    for cls, cfg in ((tmon.MonitorMaster, TMC), (jmon.MonitorMaster, JMC)):
        with pytest.raises(OSError):
            cls(cfg.from_config_dict(bad))


def test_jax_profiler_section_opens_a_torch_profiler_window(tmp_path):
    """The ``jax_profiler`` key (kept for config compatibility) brackets
    ``num_steps`` steps from ``start_step`` with a ``torch.profiler``
    trace; the window closes inside its last step."""
    from deepspeedsyclsupport_tpu_torch.monitor import mfu as tmfu

    eng = _port_simple_engine(simple_config(jax_profiler={
        "enabled": True, "start_step": 1, "num_steps": 2,
        "trace_dir": str(tmp_path)}))
    data = random_dataset(eng.train_batch_size(), n_batches=4, seed=1)
    eng.train_batch(data[0])
    assert not eng._tracing
    eng.train_batch(data[1])
    assert eng._tracing
    eng.train_batch(data[2])
    assert not eng._tracing
    events, meta = tmfu.parse_trace(str(tmp_path / "rank0.trace.json.gz"))
    assert not meta["truncated"]
    # a step's products: 2 forward, 3 backward (no gradient for the input)
    assert sum(e["name"] == "aten::mm" for e in events) == 2 * 5


@pytest.mark.parametrize("mode", ["counted", "window", "trace"])
def test_an_observed_engine_is_freed_with_its_last_reference(tmp_path, mode):
    """No reference cycle through the observability objects: an engine
    with telemetry, the CSV monitor and a counted step goes when its last
    reference does, without the collector (a later phase on the card must
    find its memory free). A process's first ``torch.profiler`` start
    imports ``torch._inductor`` lazily (``profile.prepare_trace``), which
    leaves a cycle through the caller's frames: an engine that opened the
    MFU window or a ``jax_profiler`` trace window is freed at the next
    collection (closing the trace window drops its exit hook)."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        extra = {}
        if mode == "trace":
            extra["jax_profiler"] = {"enabled": True, "start_step": 2,
                                     "num_steps": 1,
                                     "trace_dir": str(tmp_path / "tr")}
        eng = _port_simple_engine(simple_config(
            telemetry=dict({"enabled": True, "output_dir": str(tmp_path),
                            "stack_dump_on_hang": False},
                           **({"mfu": {"enabled": True, "step": 2}}
                              if mode == "window" else {})),
            csv_monitor={"enabled": True, "output_path": str(tmp_path)},
            flops_profiler={"enabled": True, "profile_step": 1}, **extra))
        for b in random_dataset(eng.train_batch_size(), n_batches=3,
                                seed=1):
            eng.train_batch(b)
        assert eng.flops_profiler.profile is not None
        assert (eng._mfu_window is not None) == (mode == "window")
        assert not eng._tracing
        if mode == "trace":
            assert (tmp_path / "tr" / "rank0.trace.json.gz").exists()
        eng.telemetry.close()
        ref = weakref.ref(eng)
        del eng
        if mode != "counted":
            gc.collect()
        assert ref() is None
    finally:
        gc.enable()


def test_timers_equal_jax_on_one_clock(tmp_path, clock):
    """``SynchronizedWallClockTimer`` and ``ThroughputTimer``: the same
    elapsed times, means, log lines and ``timer/<name>`` spans in the
    active recorder (a CPU timer's sync is a no-op)."""
    from deepspeedsyclsupport_tpu.utils import timer as jtimer
    from deepspeedsyclsupport_tpu_torch.utils import timer as ttimer

    got = []
    for pkg, tel_pkg, cfg_cls, jsonl_cls in (
            (jtimer, jtel, JTelCfg, jmon.JsonlMonitor),
            (ttimer, ttel, TTelCfg, tmon.JsonlMonitor)):
        out = tmp_path / pkg.__name__.split(".")[0]
        tel = tel_pkg.Telemetry(cfg_cls.from_dict(dict(
            TEL, output_dir=str(out), heartbeat={"enabled": False})),
            jsonl=jsonl_cls(path=str(out / "t.jsonl"), flush_interval=1))
        timers = pkg.SynchronizedWallClockTimer()
        tput = pkg.ThroughputTimer(batch_size=8, start_step=1,
                                   steps_per_output=2)
        for i in range(3):
            timers(pkg.FORWARD_GLOBAL_TIMER).start(sync=True)
            tput.start()
            clock.t += 0.25 * (i + 1)
            timers(pkg.FORWARD_GLOBAL_TIMER).stop(sync=True)
            tput.stop()
        fwd = timers(pkg.FORWARD_GLOBAL_TIMER)
        got.append((fwd.mean(), timers.log([pkg.FORWARD_GLOBAL_TIMER],
                                          reset=False),
                    fwd.elapsed(), tput.avg_samples_per_sec(),
                    [(r["name"], r["dur"]) for r in tel.recorder.snapshot()
                     if r["name"].startswith("timer/")]))
        tel.close()
    assert got[0] == got[1]
    assert got[1][4] == [("timer/fwd", 0.25), ("timer/fwd", 0.5),
                         ("timer/fwd", 0.75)]
