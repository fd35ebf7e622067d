"""PyTorch port: the serving plane's telemetry, request tracing, fault
injection and watchdog against the JAX package's.

The same operations go through both packages' modules and the results are
held equal: Prometheus text for the same registry snapshot, histogram
quantiles, the event-name registry (strict ``check_events`` accepts every
``Serve/*`` name the session emits), flight-recorder records and JSONL
lines (wall stamps dropped), fault-injector decisions, the KV allocator's
``kv_alloc_fail`` hook, and the request-trace stage registry.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.inference.v2 import ragged as jax_ragged
from deepspeedsyclsupport_tpu.inference.v2 import serving as jax_serving
from deepspeedsyclsupport_tpu.monitor import monitor as jax_monitor
from deepspeedsyclsupport_tpu.monitor import reqtrace as jax_reqtrace
from deepspeedsyclsupport_tpu.monitor import telemetry as jax_tel
from deepspeedsyclsupport_tpu.utils import fault_injection as jax_fi
from deepspeedsyclsupport_tpu_torch.comm.watchdog import (
    COMM_HANG_EXIT_CODE, SERVE_HANG_EXIT_CODE, CollectiveWatchdog)
from deepspeedsyclsupport_tpu_torch.inference.v2 import ragged, serving
from deepspeedsyclsupport_tpu_torch.inference.v2.supervisor import (
    RequestJournal)
from deepspeedsyclsupport_tpu_torch.monitor import monitor, reqtrace
from deepspeedsyclsupport_tpu_torch.monitor import telemetry as tel
from deepspeedsyclsupport_tpu_torch.utils import fault_injection as fi


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv(fi.ENV_SPEC, raising=False)
    monkeypatch.delenv("DSTPU_ELASTIC_ATTEMPT", raising=False)
    for mod in (tel, jax_tel):
        mod.metrics_registry.reset()
        mod.resilience_counters.reset()
    for mod in (fi, jax_fi):
        mod.configure_fault_injection(None)
    yield
    for mod in (tel, jax_tel):
        mod.metrics_registry.reset()
        mod.resilience_counters.reset()
    for mod in (fi, jax_fi):
        mod.configure_fault_injection(None)


def _fill(mod, seed=0):
    """The same counters, gauges and histogram observations in ``mod``'s
    registry; returns its snapshot."""
    reg = mod.MetricsRegistry()
    rng = np.random.RandomState(seed)
    for name in serving.SERVE_COUNTERS:
        reg.counter(name).incr(int(rng.randint(0, 50)))
    for name in serving.SERVE_GAUGES:
        reg.gauge(name).set(float(rng.rand()))
    for name in serving.SERVE_HISTOGRAMS:
        h = reg.histogram(name)
        for v in rng.exponential(0.3, size=40):
            h.observe(float(v))
    return reg


def test_prometheus_text_matches_jax(tmp_path):
    mine, ref = _fill(tel), _fill(jax_tel)
    assert mine.snapshot() == ref.snapshot()
    labels = {"replica": "0", "rank": "0"}
    text = tel.render_prometheus(mine.snapshot(), labels=labels)
    assert text == jax_tel.render_prometheus(ref.snapshot(), labels=labels)
    assert "dstpu_Serve_ttft_s_bucket" in text
    extra = {"Resilience/serve_hang_aborts": 2}
    p = tel.export_metrics_textfile(str(tmp_path / "m" / "a.prom"),
                                    mine.snapshot(), extra_counters=extra)
    q = jax_tel.export_metrics_textfile(str(tmp_path / "b.prom"),
                                        ref.snapshot(), extra_counters=extra)
    assert open(p).read() == open(q).read()
    assert not [n for n in os.listdir(tmp_path / "m") if ".tmp" in n]


def test_histogram_quantiles_match_jax():
    mine, ref = _fill(tel, 1), _fill(jax_tel, 1)
    for name in serving.SERVE_HISTOGRAMS:
        a, b = mine.histogram(name), ref.histogram(name)
        assert a.quantiles((0.1, 0.5, 0.9, 0.95, 0.99, 1.0)) == \
            b.quantiles((0.1, 0.5, 0.9, 0.95, 0.99, 1.0))
    assert tel.DURATION_BUCKETS_S == jax_tel.DURATION_BUCKETS_S
    assert tel.histogram_quantile((1.0, 2.0), [0, 0, 0], 0, 0.5) is None


def test_event_registry_matches_jax_and_is_strict(monkeypatch):
    assert tel.EVENT_NAMES == jax_tel.EVENT_NAMES
    assert tel.EVENT_PREFIXES == jax_tel.EVENT_PREFIXES
    assert tel.ResilienceCounters.NAMES == jax_tel.ResilienceCounters.NAMES
    assert serving.SERVE_EVENT_NAMES == jax_serving.SERVE_EVENT_NAMES
    monkeypatch.setenv("DSTPU_STRICT_EVENTS", "1")
    names = list(serving.SERVE_EVENT_NAMES)
    names += [f"{h}/{q}" for h in serving.SERVE_HISTOGRAMS
              for q in ("p50", "p95", "p99")]
    names += [f"Serve/stage.{s}" for s in reqtrace.SERVE_STAGES]
    events = [(n, 1.0, 0) for n in names]
    assert tel.check_events(events) == events
    with pytest.raises(tel.UndeclaredEventError):
        tel.check_events([("Serve/ttft", 1.0, 0)])
    with pytest.raises(tel.UndeclaredEventError):
        tel.check_events([("loss", 1.0, 0)])
    tel.declare_events(["Custom2/thing"])
    assert tel.is_declared("Custom2/thing")


def test_flight_recorder_and_jsonl_match_jax(tmp_path):
    lines = {}
    for name, tmod, mmod in (("torch", tel, monitor),
                             ("jax", jax_tel, jax_monitor)):
        path = str(tmp_path / name / "rec.jsonl")
        rec = tmod.FlightRecorder(capacity=4)
        sink = mmod.JsonlMonitor(path=path, flush_interval=3)
        sink.attach_recorder(rec)
        tmod.metrics_registry.counter("Serve/shed").incr(2)
        rec.event("serve/admit", step=1, uid=3)
        rec.record("span", "decode", step=2, dur=0.5, data={"k": 4})
        sink.write_events([("Serve/queue_depth", np.float32(2.0), 5)])
        assert len(rec) == 3
        for i in range(5):
            rec.event("tick", step=i)
        assert len(rec) == 4                  # the ring keeps the newest
        rec.dump("test")
        sink.close()
        with open(path) as f:
            lines[name] = [{k: v for k, v in json.loads(line).items()
                            if k != "t"} for line in f]
    assert lines["torch"] == lines["jax"]
    assert lines["torch"][-1]["kind"] == "dump"


def test_heartbeat(tmp_path):
    path = str(tmp_path / "hb" / "heartbeat_rank0.json")
    clock = iter([100.0, 100.5, 102.0])
    hb = tel.Heartbeat(path, interval_s=1.0, clock=lambda: next(clock))
    assert hb.beat(1)
    assert not hb.beat(2)            # inside the interval
    assert hb.beat(3)
    assert tel.Heartbeat.read(path)["step"] == 3
    assert tel.Heartbeat.age(path, now=110.0) == pytest.approx(8.0)
    assert tel.Heartbeat.age(str(tmp_path / "none.json")) is None


# ----------------------------------------------------------- fault injection
def _fault_trace(mod, tmp_path):
    spec = {"write_fail": {"match": "state.bin", "count": 2},
            "truncate": {"match": "x.bin", "keep_bytes": 3},
            "serve_crash": {"tokens": 7, "rc": 9},
            "decode_wedge": {"round": 2, "seconds": 0.01},
            "kv_alloc_fail": {"count": 2}, "preempt_at_step": 3,
            "kill_step": {"rank": 1, "step": 4, "rc": 5}}
    inj = mod.configure_fault_injection(spec)
    out = [inj.armed]
    for path in ("a/state.bin", "b.json", "c/state.bin", "d/state.bin"):
        try:
            inj.maybe_fail_write(path)
            out.append("ok")
        except OSError as e:
            out.append(type(e).__name__)
    p = tmp_path / f"{mod.__name__}.x.bin"
    p.write_bytes(b"0123456789")
    out.append(inj.maybe_truncate(str(p)))
    out.append(p.read_bytes())
    out += [inj.should_serve_crash(r, t) for r, t in
            ((1, 0), (2, 6), (3, 7), (4, 99))]
    out += [inj.maybe_wedge_decode(r) for r in (1, 2, 3)]
    out += [inj.should_fail_kv_alloc() for _ in range(3)]
    out += [inj.should_preempt(s) for s in (1, 3, 4)]
    out += [inj.should_kill(r, s) for r, s in ((0, 4), (1, 3), (1, 4),
                                                (1, 5))]
    mod.configure_fault_injection(None)
    return out


def test_fault_injector_matches_jax(tmp_path):
    assert _fault_trace(fi, tmp_path) == _fault_trace(jax_fi, tmp_path)


def test_fault_injector_env_and_attempt_gate(monkeypatch):
    monkeypatch.setenv(fi.ENV_SPEC, json.dumps(
        {"serve_crash": {"round": 1, "attempt": 1}}))
    fi.configure_fault_injection(None)
    inj = fi.get_fault_injector()
    assert inj.armed and inj.should_serve_crash(5, 0) is None
    monkeypatch.setenv("DSTPU_ELASTIC_ATTEMPT", "1")
    assert inj.should_serve_crash(5, 0) == 1
    monkeypatch.setenv(fi.ENV_SPEC, "{not json")
    fi.configure_fault_injection(None)
    with pytest.raises(ValueError, match=fi.ENV_SPEC):
        fi.get_fault_injector()


@pytest.mark.parametrize("mode", ["nan_step", "loss_spike", "bad_batch"])
def test_corrupt_batch_matches_jax(mode):
    spec = {mode: {"rank": 0, "step": 2, "count": 1, "factor": 10.0,
                   "fill": 7.0}}
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    mine = fi.FaultInjector(spec)
    ref = jax_fi.FaultInjector(spec)
    batch = {"x": torch.from_numpy(x), "ids": torch.from_numpy(ids),
             "gate": torch.ones(2)}
    jbatch = {"x": jnp.asarray(x), "ids": jnp.asarray(ids),
              "gate": jnp.ones(2)}
    assert mine.corrupt_batch(0, 1, batch) is batch        # before `step`
    got = mine.corrupt_batch(0, 2, batch, skip_keys=("gate",))
    want = ref.corrupt_batch(0, 2, jbatch, skip_keys=("gate",))
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["ids"] is batch["ids"] and got["gate"] is batch["gate"]
    assert mine.corrupt_batch(0, 3, batch) is batch        # count spent


def test_retry_io_counts_and_gives_up():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "done"

    assert fi.retry_io(flaky, base_delay=0.0) == "done"
    assert tel.resilience_counters.get("io_retries") == 2
    with pytest.raises(OSError):
        fi.retry_io(lambda: (_ for _ in ()).throw(OSError("down")),
                    attempts=2, base_delay=0.0)
    assert tel.resilience_counters.get("io_giveups") == 1


def test_kv_alloc_fail_hook_matches_jax():
    outs = []
    for alloc_mod, fmod in ((ragged, fi), (jax_ragged, jax_fi)):
        fmod.configure_fault_injection({"kv_alloc_fail": {"count": 2}})
        alloc = alloc_mod.BlockedAllocator(6)
        res = [alloc.try_allocate(0), alloc.try_allocate(2),
               alloc.try_allocate(2), alloc.try_allocate(2),
               alloc.try_allocate(9), alloc.free_blocks]
        outs.append(res)
        fmod.configure_fault_injection(None)
    assert outs[0] == outs[1]
    assert outs[0][1] is None and outs[0][3] is not None


# ----------------------------------------------------------------- watchdog
def test_watchdog_fires_rc219_into_the_journal(tmp_path):
    """The deadline path without exiting: the injected ``exit_fn`` receives
    rc 219, the journal holds ``serve/arm`` then ``serve/hang`` (flushed),
    and the abort is counted."""
    jpath = str(tmp_path / "journal_rank0.att0.jsonl")
    journal = RequestJournal(jpath)
    exited = []
    wd = CollectiveWatchdog(
        deadline_s=0.05, warmup_deadline_s=0.05, poll_s=0.01,
        telemetry=journal, exit_fn=exited.append,
        exit_code=SERVE_HANG_EXIT_CODE, abort_counter="serve_hang_aborts",
        arm_name="serve/arm", hang_name="serve/hang", what="serving decode",
        stack_path=str(tmp_path / "stacks.txt")).start()
    wd.arm(7)
    for _ in range(500):
        if exited:
            break
        import time

        time.sleep(0.01)
    wd.stop()
    journal.close()
    assert exited == [SERVE_HANG_EXIT_CODE] and COMM_HANG_EXIT_CODE == 218
    assert tel.resilience_counters.get("serve_hang_aborts") == 1
    with open(jpath) as f:
        names = [json.loads(line)["name"] for line in f]
    assert names.index("serve/arm") < names.index("serve/hang")
    assert "serve watchdog fired" in open(tmp_path / "stacks.txt").read()


def test_watchdog_disarm_prevents_fire():
    exited = []
    wd = CollectiveWatchdog(deadline_s=0.05, poll_s=0.01,
                            exit_fn=exited.append).start()
    assert wd.arm(1) == pytest.approx(0.5)        # warm-up: 10x
    wd.disarm(1)
    assert wd.arm(2) == pytest.approx(0.05)
    wd.disarm(2)
    import time

    time.sleep(0.15)
    wd.stop()
    assert not exited
    with pytest.raises(ValueError):
        CollectiveWatchdog(deadline_s=0)


# ----------------------------------------------------------------- reqtrace
def test_stage_registry_matches_jax():
    assert reqtrace.SERVE_STAGES == jax_reqtrace.SERVE_STAGES
    assert reqtrace.FLEET_STAGES == jax_reqtrace.FLEET_STAGES
    assert reqtrace.check_stage("prefill") == "prefill"
    for mod in (reqtrace, jax_reqtrace):
        with pytest.raises(ValueError):
            mod.check_stage("plcement")
    assert reqtrace.file_attempt("d/journal_rank0.att2.1.jsonl") == \
        jax_reqtrace.file_attempt("d/journal_rank0.att2.1.jsonl")
