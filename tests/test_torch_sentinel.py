"""PyTorch port: the training-health sentinel against the JAX package's,
on the CPU.

The JAX package's ``tests/unit/test_sentinel.py`` classes, each run
through both sentinels on the same inputs: robust statistics, region
attribution and the health scalars (float32 on both sides: 1e-6), the
verdict ladder (journals, decisions and state EQUAL), the last-good gate
(the same tags chosen over one directory), and the engine paths: a spike
and a NaN discarded before they reach the params, and the rollback whose
replay is bit-identical to the run that never saw the bad batches, with
the JAX engine's journal EQUAL and its losses within 1e-5 (float32 summation
order, as ``test_torch_train.py``). The wall-clock overhead test is not
ported.
"""
import json
import math
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeedsyclsupport_tpu as dstpu
from deepspeedsyclsupport_tpu.checkpoint import engine as jckpt
from deepspeedsyclsupport_tpu.monitor.monitor import (
    resilience_counters as jcounters)
from deepspeedsyclsupport_tpu.runtime import sentinel as jsen
from deepspeedsyclsupport_tpu.runtime.config import SentinelConfig as JCfg
from deepspeedsyclsupport_tpu.runtime.dataloader import (
    CheckpointableDataLoader as JLoader)
from deepspeedsyclsupport_tpu.utils.fault_injection import (
    configure_fault_injection as jconfigure)
from deepspeedsyclsupport_tpu_torch.checkpoint import engine as tckpt
from deepspeedsyclsupport_tpu_torch.monitor.monitor import (
    resilience_counters as tcounters)
from deepspeedsyclsupport_tpu_torch.runtime import engine as teng
from deepspeedsyclsupport_tpu_torch.runtime import sentinel as tsen
from deepspeedsyclsupport_tpu_torch.runtime.config import (
    DSTpuConfig, SentinelConfig as TCfg)
from deepspeedsyclsupport_tpu_torch.runtime.dataloader import (
    CheckpointableDataLoader as TLoader)
from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
    configure_fault_injection as tconfigure)
from tests.unit.simple_model import SimpleModel, random_dataset, simple_config

SENTINEL = {"enabled": True, "warmup_steps": 4, "window": 8,
            "skip_limit": 3, "rollback_limit": 2, "last_good_k": 1,
            "lag": 1}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("DSTPU_FAULT_INJECTION", raising=False)
    for reset in (jconfigure, tconfigure):
        reset(None)
    jcounters.reset()
    tcounters.reset()
    yield
    for reset in (jconfigure, tconfigure):
        reset(None)
    jcounters.reset()
    tcounters.reset()


def _fake_engine(**kw):
    kw.setdefault("global_steps", 0)
    kw.setdefault("telemetry", None)
    kw.setdefault("fp16_enabled", False)
    kw.setdefault("scaler_state", SimpleNamespace(
        overflows=0, scale=1.0, good_steps=0))
    return SimpleNamespace(**kw)


def _metrics(loss, grad_norm=1.0, finite=True, nonfinite=0, **regions):
    m = {"loss": np.float32(loss), "grad_norm": np.float32(grad_norm),
         "finite": np.asarray(finite),
         "health_nonfinite": np.int32(nonfinite)}
    for r, v in regions.items():
        m[f"health_rn_{r}"] = np.float32(v)
    return m


def _journal(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


# ============================================================ robust stats
SERIES = {
    "band": [10.0, 10.2, 9.8, 10.1, 9.9, 10.0],
    "flat": [5.0] * 8,
    "nonfinite": [1.0, float("nan"), float("inf"), 2.0],
    "ramp": [0.5 * i + 0.1 * (-1) ** i for i in range(20)],
}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_robust_stat_matches_jax(name):
    js, ts = jsen.RobustStat(8, 0.2), tsen.RobustStat(8, 0.2)
    for v in SERIES[name]:
        js.update(v)
        ts.update(v)
        for probe in (0.0, 5.0 + 1e-6, 10.0, 30.0, float("nan"),
                      float("inf")):
            assert ts.z(probe) == js.z(probe)
        assert (len(ts), ts.median(), ts.spread(), ts.ewma) == \
            (len(js), js.median(), js.spread(), js.ewma)
    assert ts.state_dict() == js.state_dict()
    t2 = tsen.RobustStat(8, 0.2)
    t2.load_state_dict(js.state_dict())
    assert list(t2.values) == list(js.values) and t2.ewma == js.ewma


# ====================================================== region attribution
PATHS = ["model/wte/embedding", "layers/3/attn/q_proj/kernel",
         "layers/3/mlp/w_in", "lm_head/kernel", "layer_0/w",
         "embed/embedding", "layers/attn/wq", "layers/mlp/w_gate",
         "final_norm/scale", "layers/attn_norm/scale", "pos_embed/table"]


def test_region_attribution_matches_jax():
    assert tsen.GRAD_REGIONS == jsen.GRAD_REGIONS
    assert tsen.SCOPE_REGIONS == jsen.SCOPE_REGIONS
    assert [tsen.region_of_param(p) for p in PATHS] == \
        [jsen.region_of_param(p) for p in PATHS]


def test_health_metrics_match_jax():
    rng = np.random.RandomState(0)
    grads = {"attn": {"q_proj": np.asarray([1.0, np.nan, np.inf],
                                           np.float32)},
             "embed": {"embedding": rng.randn(7, 5).astype(np.float32)},
             "mlp": {"w_in": rng.randn(4, 6).astype(np.float32),
                     "w_out": rng.randn(6, 4).astype(np.float32)},
             "final_norm": {"scale": rng.randn(5).astype(np.float32)}}
    want = {k: np.asarray(jax.device_get(v))
            for k, v in jsen.health_metrics(grads).items()}
    named = list(teng._leaves(grads))
    got = tsen.health_metrics([torch.from_numpy(t) for _, t in named],
                              ["/".join(p) for p, _ in named])
    assert set(got) == set(want)
    assert int(got["health_nonfinite"]) == int(want["health_nonfinite"]) == 2
    for k in want:
        if k != "health_nonfinite" and np.isfinite(want[k]):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=k)
        elif k != "health_nonfinite":
            assert not math.isfinite(float(got[k]))


# ========================================================== verdict ladder
def _twins(tmp_path, engine_kw=None, **cfg):
    """A JAX and a port sentinel, same config, separate journal dirs."""
    out = []
    for name, mod, Cfg in (("jax", jsen, JCfg), ("torch", tsen, TCfg)):
        c = {"enabled": True, "warmup_steps": 4, "window": 8, "lag": 1,
             "journal_dir": str(tmp_path / name)}
        c.update(cfg)
        fired = []
        s = mod.TrainingSentinel(_fake_engine(**(engine_kw or {})),
                                 Cfg(**c), exit_fn=fired.append)
        out.append((s, fired, str(tmp_path / name /
                                  "health_journal_rank0.jsonl")))
    return out


def _warm(s, n=6, loss=1.0):
    for i in range(n):
        s._process(i + 1, i, _metrics(loss + 0.01 * i))


LADDER = {
    "nonfinite_skip": (dict(), lambda s: (
        setattr(s, "_position", 4),
        s._process(4, 3, _metrics(float("nan"), finite=False, nonfinite=7,
                                  attn=2.0, mlp=1.0)))),
    "fp16_overflow": (dict(engine_kw={"fp16_enabled": True}), lambda s:
                      s._process(4, 3, _metrics(1.0, finite=False,
                                                nonfinite=9))),
    "spike_after_warmup": (dict(z_skip=8.0), lambda s: (
        s._process(1, 0, _metrics(500.0)), _warm(s),
        s._process(9, 8, _metrics(500.0)))),
    "warn_rung": (dict(z_warn=4.0, z_skip=1e9, skip_limit=1), lambda s: (
        _warm(s), s._process(9, 8, _metrics(
            s._loss_stat.median() + 6.0 * s._loss_stat.spread())))),
    "streak_abort": (dict(skip_limit=2, rollback_limit=0), lambda s: (
        s._process(3, 2, _metrics(float("nan"), finite=False)),
        s._process(4, 3, _metrics(float("nan"), finite=False)))),
    "lag_queue": (dict(lag=2, skip_limit=99), lambda s: _offered(s, 9)),
}


def _offered(s, steps, bad=5):
    """``steps`` batches through offer_batch and the step boundary, the
    ``bad``-th NaN; lag 2 decides each two boundaries later."""
    for i in range(steps):
        s.offer_batch()
        s.at_step_boundary(i + 1, _metrics(
            float("nan") if i == bad else 1.0 + 0.01 * i, finite=i != bad))


@pytest.mark.parametrize("name", sorted(LADDER))
def test_verdict_ladder_matches_jax(tmp_path, name):
    kw, script = LADDER[name]
    (js, jfired, jpath), (ts, tfired, tpath) = _twins(tmp_path, **kw)
    script(js)
    script(ts)
    assert _journal(tpath) == _journal(jpath)
    assert _journal(tpath), "the scenario journaled nothing"
    assert ts.state_dict() == js.state_dict()
    assert tfired == jfired
    assert ts._bad_positions == js._bad_positions
    assert [float(x) for x in ts.gate_array()] == \
        [float(x) for x in js.gate_array()]
    assert tcounters.get("skipped_batches") == \
        jcounters.get("skipped_batches")
    if name == "streak_abort":
        assert tfired == [tsen.DIVERGENCE_EXIT_CODE]
        assert _journal(tpath)[-1]["event"] == "abort"


def test_gate_array_caps_only_after_warmup(tmp_path):
    (js, _, _), (ts, _, _) = _twins(tmp_path)
    cap, scale = ts.gate_array()
    assert math.isinf(cap) and scale == 1.0
    _warm(js)
    _warm(ts)
    assert ts.gate_array().tolist() == js.gate_array().tolist()
    assert math.isfinite(ts.gate_array()[0])


def test_journal_replay_and_state_union_match_jax(tmp_path):
    for mod, Cfg, name in ((jsen, JCfg, "jax"), (tsen, TCfg, "torch")):
        d = str(tmp_path / name)
        cfg = Cfg(enabled=True, warmup_steps=4, window=8, lag=1,
                  skip_limit=99, journal_dir=d)
        s = mod.TrainingSentinel(_fake_engine(), cfg)
        s._position = 5
        s._process(5, 4, _metrics(float("nan"), finite=False))
        sd = s.state_dict()
        s._process(6, 5, _metrics(float("nan"), finite=False))
        s.load_state_dict(sd)   # a rollback: the meta is older than now
        assert s._bad_positions == {4, 5}
        s.close()
        reborn = mod.TrainingSentinel(_fake_engine(), cfg)
        assert reborn._bad_positions == {4, 5}
        assert [reborn.offer_batch() for _ in range(7)] == \
            [False] * 4 + [True, True, False]
        reborn.close()
    assert _journal(str(tmp_path / "torch" / "health_journal_rank0.jsonl")) \
        == _journal(str(tmp_path / "jax" / "health_journal_rank0.jsonl"))


def test_sentinel_config_validation_matches_jax():
    for bad in ({"z_warn": 9.0, "z_skip": 8.0}, {"lag": 0},
                {"window": 2}, {"skip_limit": 0}):
        with pytest.raises(ValueError):
            JCfg.from_dict(bad)
        with pytest.raises(ValueError):
            TCfg.from_dict(bad)
    d = dict(SENTINEL, lr_cut=0.5, lr_cut_steps=2, journal_dir="/x")
    assert vars(TCfg.from_dict(d)) == vars(JCfg.from_dict(d))


# ========================================================== last-good gate
def _tags(save_dir, steps, pkg):
    for s in steps:
        rng = np.random.default_rng(s)
        pkg.save_tree(str(save_dir / f"global_step{s}"),
                      {"w": rng.normal(size=(4,)).astype(np.float32)},
                      {"global_steps": s})


@pytest.mark.parametrize("case", ["round_trip", "unpromoted_newer",
                                  "corrupt_promoted", "none_promoted",
                                  "rotation_spares_promoted"])
def test_last_good_gate_matches_jax(tmp_path, case):
    _tags(tmp_path, (1, 2, 3, 5, 6), tckpt)
    promoted = {"round_trip": "global_step3", "unpromoted_newer":
                "global_step3", "corrupt_promoted": "global_step5",
                "none_promoted": None,
                "rotation_spares_promoted": "global_step1"}[case]
    if promoted:
        tckpt.promote_last_good(str(tmp_path), promoted)
        assert (tmp_path / tckpt.LAST_GOOD_FILE).read_text() == promoted
    assert tckpt.read_last_good(str(tmp_path)) == \
        jckpt.read_last_good(str(tmp_path)) == promoted
    if case == "corrupt_promoted":
        (tmp_path / "global_step5" / tckpt.COMMIT_FILE).unlink()
    if case == "rotation_spares_promoted":
        doomed = tckpt.rotate_checkpoints(str(tmp_path), keep_last_n=1)
        assert sorted(doomed) == ["global_step2", "global_step3",
                                  "global_step5"]
        assert sorted(tckpt.list_tags(str(tmp_path))) == \
            ["global_step1", "global_step6"]
    got = tckpt.find_last_good_tag(str(tmp_path))
    assert got == jckpt.find_last_good_tag(str(tmp_path))
    want = {"round_trip": "global_step3", "unpromoted_newer": "global_step3",
            "corrupt_promoted": "global_step3", "none_promoted": None,
            "rotation_spares_promoted": "global_step1"}[case]
    assert got[0] == want


# ============================================================ engine paths
class TorchSimpleModel:
    """``tests/unit/simple_model.py``'s two-layer tanh MLP regression."""

    def __init__(self, nlayers=2):
        self.nlayers = nlayers

    def loss(self, params, batch, rng=None):
        h = batch["x"]
        for i in range(self.nlayers):
            lyr = params[f"layer_{i}"]
            h = torch.tanh(h @ lyr["w"] + lyr["b"])
        return ((h - batch["y"].to(h.dtype)) ** 2).mean()


def _port_engine(cfg):
    params = SimpleModel().init_params()
    return teng.initialize(loss_fn=TorchSimpleModel().loss,
                           params=params, config=cfg, device="cpu")[0]


def _jax_engine(cfg):
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    # one device, as the port: the suite's conftest gives JAX eight
    topo = build_topology(dp=1, devices=jax.devices()[:1])
    return dstpu.initialize(model=SimpleModel(), config=cfg,
                            topology=topo)[0]


def _drive(engine, loader, target_steps, save_at=None, save_dir=None):
    """Train from ``loader`` to ``target_steps``: {step: loss}."""
    engine.register_dataloader(loader)
    it = iter(loader)
    losses, saved = {}, False
    while engine.global_steps < target_steps:
        before = engine.global_steps
        out = engine.train_batch(next(it))
        if out is not None and engine.global_steps == before + 1:
            losses[engine.global_steps] = float(out["loss"])
        if save_at is not None and not saved and \
                engine.global_steps == save_at:
            engine.save_checkpoint(str(save_dir))
            saved = True
    return losses


def test_armed_sentinel_changes_nothing_on_a_clean_run():
    data = random_dataset(2, n_batches=6, seed=4)
    runs = []
    for sentinel in (None, dict(SENTINEL)):
        cfg = simple_config(**({"sentinel": sentinel} if sentinel else {}))
        eng = _port_engine(cfg)
        runs.append([(float(m["loss"]), float(m["grad_norm"]))
                     for m in map(eng.train_batch, data)])
        params = [t.detach().clone() for t in eng._leaf_tensors]
    assert runs[0] == runs[1]
    assert all(torch.isfinite(p).all() for p in params)


@pytest.mark.parametrize("fault", ["loss_spike", "nan_step"])
def test_engine_discards_the_bad_step_like_jax(tmp_path, fault):
    spec = {"loss_spike": {"rank": 0, "step": 8, "factor": 1e6},
            "nan_step": {"rank": 0, "step": 3}}[fault]
    results = {}
    for name, make, configure in (("jax", _jax_engine, jconfigure),
                                  ("torch", _port_engine, tconfigure)):
        configure({fault: spec})
        cfg = simple_config(sentinel=dict(
            SENTINEL, skip_limit=99, journal_dir=str(tmp_path / name)))
        eng = make(cfg)
        data = random_dataset(eng.train_batch_size(), n_batches=10, seed=3)
        losses = {}
        for b in data:
            m = eng.train_batch(b)
            losses[eng.global_steps] = float(m["loss"])
        results[name] = (losses, _journal(str(
            tmp_path / name / "health_journal_rank0.jsonl")), eng)
    (jl, jj, _), (tl, tj, teng_) = results["jax"], results["torch"]
    assert [(r["event"], r["step"], r["position"], r.get("cause"))
            for r in tj] == [(r["event"], r["step"], r["position"],
                              r.get("cause")) for r in jj]
    assert len([r for r in tj if r["event"] == "skip"]) == 1
    bad = spec["step"]
    for s in sorted(jl):
        if math.isnan(jl[s]):
            assert math.isnan(tl[s]) and s == bad
        else:
            np.testing.assert_allclose(tl[s], jl[s], rtol=1e-5,
                                       err_msg=f"step {s}")
    # the gated step left the params (and the optimizer) untouched
    assert teng_.optimizer.count == 9
    if fault == "nan_step":
        assert all(math.isfinite(tl[s]) for s in tl if s != bad)


def test_gated_step_keeps_params_bit_equal():
    tconfigure({"nan_step": {"rank": 0, "step": 2}})
    eng = _port_engine(simple_config(sentinel=dict(SENTINEL, skip_limit=99,
                                                   journal_dir=None)))
    data = random_dataset(2, n_batches=3, seed=6)
    eng.train_batch(data[0])
    before = [t.detach().clone() for t in eng._leaf_tensors]
    mu = [t.clone() for t in eng.optimizer.mu]
    count, lr = eng.optimizer.count, eng.get_lr()
    m = eng.train_batch(data[1])
    assert not bool(m["finite"]) and int(m["health_nonfinite"]) > 0
    for a, b in zip(before, eng._leaf_tensors):
        assert torch.equal(a, b.detach())
    for a, b in zip(mu, eng.optimizer.mu):
        assert torch.equal(a, b)
    assert (eng.optimizer.count, eng.get_lr()) == (count, lr)
    assert eng.global_steps == 2 and eng.skipped_steps == 1


def test_rollback_replay_is_bit_identical_and_matches_jax(tmp_path):
    runs = {}
    for name, make, configure, Loader, kw in (
            ("jax", _jax_engine, jconfigure, JLoader, "topology"),
            ("torch", _port_engine, tconfigure, TLoader, "device")):
        cfg = simple_config(sentinel=dict(
            SENTINEL, journal_dir=str(tmp_path / f"{name}_clean")))
        clean = make(cfg)
        arg = clean.topology if name == "jax" else "cpu"
        data = random_dataset(clean.train_batch_size(), n_batches=12,
                              seed=9)
        ref = _drive(clean, Loader(data[:4] + data[7:], arg),
                     target_steps=8)
        configure({"nan_step": {"rank": 0, "step": 5, "count": 3}})
        cfg = simple_config(sentinel=dict(
            SENTINEL, journal_dir=str(tmp_path / f"{name}_fault")))
        eng = make(cfg)
        got = _drive(eng, Loader(data, arg), target_steps=8, save_at=3,
                     save_dir=tmp_path / f"{name}_ckpt")
        runs[name] = (ref, got, _journal(str(
            tmp_path / f"{name}_fault" / "health_journal_rank0.jsonl")))
    ref, got, journal = runs["torch"]
    # the port's replay: bit for bit the run that never saw the bad batches
    assert {s: float(v).hex() for s, v in got.items()} == \
        {s: float(v).hex() for s, v in ref.items()}
    assert sorted(got) == list(range(1, 9))
    assert tckpt.read_last_good(str(tmp_path / "torch_ckpt")) == \
        "global_step3"
    assert tcounters.get("skipped_batches") == 3
    assert tcounters.get("rollbacks") == 1

    def events(j):
        return [{k: v for k, v in r.items() if k != "duration_s"}
                for r in j]
    assert events(journal) == events(runs["jax"][2])
    for s in ref:
        np.testing.assert_allclose(got[s], runs["jax"][1][s], rtol=1e-5)


def test_divergence_past_ladder_exits_220(tmp_path):
    class _Diverged(SystemExit):
        pass

    def _exit(code):
        raise _Diverged(code)

    tconfigure({"nan_step": {"rank": 0, "step": 2, "count": 99}})
    eng = _port_engine(simple_config(sentinel=dict(
        SENTINEL, skip_limit=2, rollback_limit=0,
        journal_dir=str(tmp_path / "journal"))))
    eng._sentinel._exit_fn = _exit
    data = random_dataset(eng.train_batch_size(), n_batches=8, seed=2)
    with pytest.raises(_Diverged) as ei:
        for b in data:
            eng.train_batch(b)
    assert ei.value.code == tsen.DIVERGENCE_EXIT_CODE
    j = _journal(str(tmp_path / "journal" / "health_journal_rank0.jsonl"))
    assert j[-1]["event"] == "abort"
    # the scaler's overflow ledger joined the post-mortem record
    assert j[-1]["scaler"] == {"overflows": eng.skipped_steps, "scale": 1.0,
                               "good_steps": 0}


def test_sentinel_section_is_accepted_and_ported():
    cfg = DSTpuConfig.from_config(simple_config(sentinel=dict(SENTINEL)))
    assert cfg.sentinel.enabled and cfg.sentinel.skip_limit == 3
    eng = _port_engine(simple_config(sentinel=dict(SENTINEL,
                                                   journal_dir=None)))
    assert isinstance(eng._sentinel, tsen.TrainingSentinel)
