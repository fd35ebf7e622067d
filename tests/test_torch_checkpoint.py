"""PyTorch port: training checkpoints, resume and preemption against the
JAX package, on the CPU.

* For the same state (the JAX engine's, carried across with
  ``params_from_jax`` and ``engine_state_from_jax``) both packages write
  byte-identical ``state.bin``, ``state_index.json``, ``dstpu_meta.json``,
  commit records and ``latest``: gradient clipping on and off, AdamW and
  classic Adam, fp32 and bf16 compute.
* Each package resumes from the other's tag; a save / restart / resume run
  on ``tiny`` matches the uninterrupted JAX run at ``test_torch_train.py``'s
  tolerances (loss 1e-5, grad_norm 1e-4 relative) and the port's own
  uninterrupted run bit for bit.
* Tag history, rotation, quarantine, the staging sweep and the async
  engine, from the JAX package's ``tests/unit/test_resilience.py`` and
  ``tests/unit/test_checkpoint.py``, with the JAX package's readers asked
  the same questions of the same directories.
* Preemption: ``preempt_at_step`` and SIGTERM save and exit 217, and the
  elastic agent restarts a preempted worker (one child process, with its
  own timeout) for free.
"""
import filecmp
import functools
import json
import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeedsyclsupport_tpu as dstpu
from deepspeedsyclsupport_tpu.checkpoint import engine as jckpt
from deepspeedsyclsupport_tpu.comm.topology import build_topology
from deepspeedsyclsupport_tpu.utils.fault_injection import (
    configure_fault_injection as jconfigure)
from deepspeedsyclsupport_tpu_torch import engine_state_from_jax
from deepspeedsyclsupport_tpu_torch.checkpoint import ckpt_engine as ce
from deepspeedsyclsupport_tpu_torch.checkpoint.engine import (
    COMMIT_FILE, DATA_FILE, INDEX_FILE, META_FILE, CheckpointCorruptionError,
    find_latest_valid_tag, list_tags, load_latest_valid, load_tree,
    quarantine_tag, rotate_checkpoints, save_tree, verify_tree)
from deepspeedsyclsupport_tpu_torch.monitor.monitor import (
    resilience_counters)
from deepspeedsyclsupport_tpu_torch.runtime.resilience import (
    PREEMPTION_EXIT_CODE)
from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
    configure_fault_injection)
from tests.test_torch_train import ENGINE_CFG, _batch, _jax_tiny, _port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("DSTPU_FAULT_INJECTION", raising=False)
    configure_fault_injection(None)
    jconfigure(None)
    resilience_counters.reset()
    yield
    configure_fault_injection(None)
    jconfigure(None)
    resilience_counters.reset()


def _cfg(clip=True, opt="AdamW", dtype="float32", **extra):
    cfg = {k: v for k, v in ENGINE_CFG.items() if k != "gradient_clipping"}
    if clip:
        cfg["gradient_clipping"] = ENGINE_CFG["gradient_clipping"]
    if opt == "Adam":
        cfg["optimizer"] = {"type": "Adam", "params": {
            "lr": 3e-3, "betas": [0.9, 0.95], "adam_w_mode": False}}
    if dtype == "bfloat16":
        cfg["bf16"] = {"enabled": True}
    cfg.update(extra)
    return cfg


def _jax_engine(cfg, jparams):
    jmodel, _ = _jax_tiny()
    topo = build_topology(dp=1, devices=jax.devices()[:1])
    return dstpu.initialize(model=jmodel, config=cfg, topology=topo,
                            params=jax.tree.map(jnp.asarray, jparams))[0]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _trajectory(eng, batches, jax_side=False):
    out = []
    for b in batches:
        m = eng.train_batch(_jb(b) if jax_side else b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _close(got, want):
    for i, ((gl, gg), (wl, wg)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"loss {i}")
        np.testing.assert_allclose(gg, wg, rtol=1e-4, err_msg=f"gn {i}")


# ======================================================= byte identity
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["AdamW", "Adam"])
@pytest.mark.parametrize("clip", [True, False])
def test_same_state_writes_identical_files(tmp_path, clip, opt, dtype):
    cfg = _cfg(clip, opt, dtype)
    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    jeng = _jax_engine(cfg, jparams)
    _trajectory(jeng, [_batch(10 + i) for i in range(2)], jax_side=True)
    jeng.save_checkpoint(str(tmp_path / "jax"), client_state={"k": [1, 2]})
    # the same state in the port: params, optimizer state, scaler, counts
    eng, _ = _port_engine(cfg, dtype, jax.tree.map(np.asarray, jeng.params))
    eng.load_engine_state(engine_state_from_jax(
        jax.tree.map(np.asarray, jeng.opt_state),
        jax.tree.map(np.asarray, jeng.scaler_state)))
    eng.global_steps, eng.micro_steps = jeng.global_steps, jeng.micro_steps
    eng.save_checkpoint(str(tmp_path / "torch"), client_state={"k": [1, 2]})
    tag = "global_step2"
    names = sorted(os.listdir(tmp_path / "jax" / tag))
    assert names == sorted(os.listdir(tmp_path / "torch" / tag))
    assert {DATA_FILE, INDEX_FILE, META_FILE, COMMIT_FILE} <= set(names)
    for name in names + ["../latest"]:
        assert filecmp.cmp(tmp_path / "jax" / tag / name,
                           tmp_path / "torch" / tag / name,
                           shallow=False), name
    with open(tmp_path / "torch" / tag / INDEX_FILE) as f:
        leaves = {e["name"]: e for e in json.load(f)}
    pre = "opt_state/1/" if clip else "opt_state/"
    assert leaves[pre + "count"]["dtype"] == "int32"
    assert (pre + "hyperparams/weight_decay" in leaves) == (opt == "AdamW")
    assert list(leaves)[-4:] == ["scaler/scale", "scaler/good_steps",
                                 "scaler/hysteresis_left",
                                 "scaler/overflows"]
    assert leaves["params/layers/attn/wq"]["shape"][0] == 2  # stacked


@pytest.mark.parametrize("section", [
    {}, {"engine": "async", "keep_last_n": 3}, {"async_save": True},
    {"tag_validation": "fail"}, {"engine": "nebula"}, {"keep_last_n": -1},
    {"engine": "native", "async_save": True}, {"tag_validation": "maybe"}])
def test_checkpoint_config_matches_jax(section):
    from deepspeedsyclsupport_tpu.runtime.config import CheckpointConfig as J
    from deepspeedsyclsupport_tpu_torch.runtime.config import (
        CheckpointConfig as T)

    try:
        want = J.from_dict(section)
    except ValueError:
        with pytest.raises(ValueError):
            T.from_dict(section)
        return
    got = T.from_dict(section)
    assert (got.engine, got.keep_last_n, got.tag_validation) == \
        (want.engine, want.keep_last_n, want.tag_validation)


# ================================================= resume across packages
BATCHES = [_batch(20 + i) for i in range(6)]


@functools.lru_cache(maxsize=None)
def _jax_uninterrupted():
    """The JAX engine's 6-step trajectory on ``BATCHES`` (shared)."""
    _, jparams = _jax_tiny()
    return _trajectory(_jax_engine(ENGINE_CFG, jax.tree.map(np.asarray,
                                                            jparams)),
                       BATCHES, True)


def test_port_resumes_from_a_jax_tag(tmp_path):
    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    batches, want = BATCHES, _jax_uninterrupted()
    jeng = _jax_engine(ENGINE_CFG, jparams)
    _trajectory(jeng, batches[:3], True)
    jeng.save_checkpoint(str(tmp_path))
    eng, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    path, client = eng.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and client == {}
    assert (eng.global_steps, eng.micro_steps) == (3, 6)
    assert eng.get_lr() == pytest.approx(float(jeng.get_lr()), rel=1e-7)
    _close(_trajectory(eng, batches[3:]), want[3:])


def test_jax_resumes_from_a_port_tag(tmp_path):
    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    batches, want = BATCHES, _jax_uninterrupted()
    eng, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    _trajectory(eng, batches[:3])
    eng.save_checkpoint(str(tmp_path))
    jeng = _jax_engine(ENGINE_CFG, jparams)
    path, _ = jeng.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and jeng.global_steps == 3
    _close(_trajectory(jeng, batches[3:], True), want[3:])


@pytest.mark.parametrize("engine", ["native", "async"])
def test_save_restart_resume_matches_uninterrupted(tmp_path, engine):
    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    cfg = dict(ENGINE_CFG, checkpoint={"engine": engine})
    batches = [_batch(40 + i, kinds=("segments",)) for i in range(6)]
    want = _trajectory(_jax_engine(cfg, jparams), batches, True)
    plain, _ = _port_engine(cfg, "float32", jparams)
    own = _trajectory(plain, batches)
    first, _ = _port_engine(cfg, "float32", jparams)
    _trajectory(first, batches[:3])
    first.save_checkpoint(str(tmp_path), client_state={"epoch": 0})
    first.checkpoint_engine.wait()
    del first
    resumed, _ = _port_engine(cfg, "float32", jparams)
    _, client = resumed.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 0}
    got = _trajectory(resumed, batches[3:])
    assert got == own[3:]             # bit for bit against the port
    _close(got, want[3:])             # and at tolerance against JAX
    for (_, a), (_, b) in zip(teng_leaves(plain), teng_leaves(resumed)):
        assert torch.equal(a, b)


def teng_leaves(eng):
    from deepspeedsyclsupport_tpu_torch.runtime.engine import _leaves

    return list(_leaves(eng.params))


def test_load_without_optimizer_states(tmp_path):
    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    eng, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    _trajectory(eng, [_batch(50), _batch(51)])
    eng.save_checkpoint(str(tmp_path))
    fresh, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    fresh.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert fresh.optimizer.count == 0 and fresh.global_steps == 2
    assert all(float(m.abs().max()) == 0 for m in fresh.optimizer.mu)
    for (_, a), (_, b) in zip(teng_leaves(eng), teng_leaves(fresh)):
        assert torch.equal(a, b)


def test_reference_format_tag_is_refused(tmp_path):
    _, jparams = _jax_tiny()
    eng, _ = _port_engine(ENGINE_CFG, "float32",
                          jax.tree.map(np.asarray, jparams))
    (tmp_path / "ref").mkdir()
    (tmp_path / "ref" / "mp_rank_00_model_states.pt").write_bytes(b"x")
    (tmp_path / "latest").write_text("ref")
    with pytest.raises(NotImplementedError, match=r"A\.3\.5"):
        eng.load_checkpoint(str(tmp_path))


# ============================================================ tag history
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(8, 8)).astype(np.float32),
                       "b": np.zeros((8,), np.float32)},
            "step": np.int32(seed)}


def _template(tree):
    return {k: jax.tree.map(lambda a: torch.empty(
        np.shape(a), dtype=torch.from_numpy(np.asarray(a)).dtype,
        device="meta"), v) for k, v in tree.items()}


def _write_tag(save_dir, tag, seed, update_latest=True):
    state = _tree(seed)
    save_tree(str(save_dir / tag), state, {"global_steps": seed})
    if update_latest:
        ce._write_latest(str(save_dir / "latest"), tag)
    return state


def _assert_tree_equal(got, want):
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(
        g.numpy() if isinstance(g, torch.Tensor) else g, w), got, want)


def _jax_agrees(d):
    """The JAX package's readers give the same answers over ``d``."""
    assert list_tags(str(d)) == jckpt.list_tags(str(d))
    assert find_latest_valid_tag(str(d)) == jckpt.find_latest_valid_tag(
        str(d))


def test_transient_write_errors_self_heal(tmp_path):
    configure_fault_injection({"write_fail": {"match": DATA_FILE,
                                              "count": 2}})
    state = _write_tag(tmp_path, "t1", seed=1)
    assert resilience_counters.get("io_retries") == 2
    assert verify_tree(str(tmp_path / "t1")) == (True, "ok")
    got, meta = load_tree(str(tmp_path / "t1"), _template(state),
                          device="cpu")
    _assert_tree_equal(got, state)
    assert meta["global_steps"] == 1
    assert jckpt.verify_tree(str(tmp_path / "t1")) == (True, "ok")


@pytest.mark.parametrize("damage", ["torn", "bit_rot", "malformed_index",
                                    "missing_meta"])
def test_verify_detects_damage_like_jax(tmp_path, damage):
    _write_tag(tmp_path, "t1", seed=1)
    tag = tmp_path / "t1"
    data = tag / DATA_FILE
    if damage == "torn":
        data.write_bytes(data.read_bytes()[:-16])
    elif damage == "bit_rot":
        raw = bytearray(data.read_bytes())
        raw[7] ^= 0xFF
        data.write_bytes(bytes(raw))
    elif damage == "malformed_index":
        (tag / INDEX_FILE).write_text('[{"bogus": 1}]')
    else:
        os.unlink(tag / META_FILE)
    for deep in (True, False):
        got = verify_tree(str(tag), deep=deep)
        assert got == jckpt.verify_tree(str(tag), deep=deep)
        assert got[0] == (damage == "bit_rot" and not deep)
    _jax_agrees(tmp_path)


def test_load_rejects_corrupt_leaf(tmp_path):
    state = _write_tag(tmp_path, "t1", seed=1)
    data = tmp_path / "t1" / DATA_FILE
    raw = bytearray(data.read_bytes())
    raw[3] ^= 0xFF
    data.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptionError):
        load_tree(str(tmp_path / "t1"), _template(state), device="cpu")


def test_truncated_newest_falls_back(tmp_path):
    s1 = _write_tag(tmp_path, "step1", seed=1)
    configure_fault_injection({"truncate": {"match": DATA_FILE,
                                            "keep_bytes": 32, "count": 1}})
    _write_tag(tmp_path, "step2", seed=2)   # torn after the save returned
    assert not verify_tree(str(tmp_path / "step2"))[0]
    _jax_agrees(tmp_path)
    tag, state, meta = load_latest_valid(str(tmp_path), _template(s1),
                                         device="cpu")
    assert tag == "step1" and meta["global_steps"] == 1
    _assert_tree_equal(state, s1)
    assert resilience_counters.get("corrupt_tags_skipped") == 1
    assert resilience_counters.get("fallback_loads") == 1


def test_dangling_latest_and_nothing_loadable(tmp_path):
    s1 = _write_tag(tmp_path, "step1", seed=1)
    ce._write_latest(str(tmp_path / "latest"), "no_such_tag")
    tag, skipped = find_latest_valid_tag(str(tmp_path))
    assert tag == "step1" and [t for t, _ in skipped] == ["no_such_tag"]
    _jax_agrees(tmp_path)
    assert load_latest_valid(str(tmp_path), _template(s1),
                             device="cpu")[0] == "step1"
    data = tmp_path / "step1" / DATA_FILE
    data.write_bytes(data.read_bytes()[:8])
    assert load_latest_valid(str(tmp_path), _template(s1),
                             device="cpu") == (None, None, {})


def test_quarantine_names_never_collide(tmp_path):
    for expect in ("tag.corrupt", "tag.corrupt.1", "tag.corrupt.2"):
        d = tmp_path / "tag"
        d.mkdir()
        (d / "junk").write_text("x")
        assert quarantine_tag(str(d)) == str(tmp_path / expect)
        assert (tmp_path / expect).is_dir() and not d.exists()
    assert list_tags(str(tmp_path)) == []


def test_engine_quarantines_verified_then_torn_tag(tmp_path, monkeypatch):
    from deepspeedsyclsupport_tpu_torch.checkpoint import engine as ckpt_eng

    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    eng, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    eng.train_batch(_batch(60))
    eng.save_checkpoint(str(tmp_path), tag="old")
    eng.train_batch(_batch(61))
    eng.save_checkpoint(str(tmp_path), tag="new")
    data = tmp_path / "new" / DATA_FILE
    raw = bytearray(data.read_bytes())
    raw[3] ^= 0xFF      # same size: only the read's crc32 sees it
    data.write_bytes(bytes(raw))
    real_verify = ckpt_eng.verify_tree
    monkeypatch.setattr(
        ckpt_eng, "verify_tree",
        lambda path, deep=True: ((True, "ok") if os.path.isdir(path)
                                 else real_verify(path, deep)))
    fresh, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "old") and fresh.global_steps == 1
    assert (tmp_path / "new.corrupt").is_dir()
    # the quarantine, then the dangling `latest` on the retry
    assert resilience_counters.get("corrupt_tags_skipped") == 2
    assert resilience_counters.get("fallback_loads") == 1
    with pytest.raises(CheckpointCorruptionError):
        raw = bytearray((tmp_path / "old" / DATA_FILE).read_bytes())
        raw[3] ^= 0xFF
        (tmp_path / "old" / DATA_FILE).write_bytes(bytes(raw))
        fresh.load_checkpoint(str(tmp_path), tag="old")  # never walked past


def test_atomic_latest_pointer(tmp_path):
    (tmp_path / "t").mkdir()
    configure_fault_injection({"write_fail": {"match": "latest",
                                              "count": 1}})
    latest = str(tmp_path / "t" / "latest")
    ce._write_latest(latest, "tag42")
    assert open(latest).read() == "tag42"
    assert not os.path.exists(latest + ".tmp")
    assert resilience_counters.get("io_retries") == 1


# =========================================================== staging sweep
def test_staging_sweep_on_async_save(tmp_path):
    orphan = tmp_path / ".staging-dead"
    orphan.mkdir()
    (orphan / "junk").write_text("x")
    eng = ce.build_checkpoint_engine("async")
    state = _tree(3)
    eng.save(str(tmp_path / "t3"), state, {"global_steps": 3},
             latest_file=str(tmp_path / "latest"), tag="t3")
    eng.wait()
    assert not orphan.exists()
    assert resilience_counters.get("staging_sweeps") == 1
    assert verify_tree(str(tmp_path / "t3"))[0]
    assert open(tmp_path / "latest").read() == "t3"
    got, _ = eng.load(str(tmp_path / "t3"), _template(state), device="cpu")
    _assert_tree_equal(got, state)


@pytest.mark.parametrize("case", ["promote", "over_torn_target",
                                  "never_over_committed"])
def test_staging_sweep(tmp_path, case):
    if case == "promote":
        state = _tree(7)
        save_tree(str(tmp_path / ".staging-step7"), state,
                  {"global_steps": 7})
        (tmp_path / ".staging-torn").mkdir()
        (tmp_path / ".staging-torn" / "junk").write_text("x")
        assert ce.sweep_staging_dirs(str(tmp_path)) == 2
        assert resilience_counters.get("staging_promotions") == 1
        assert resilience_counters.get("staging_sweeps") == 1
        tag, steps = "step7", 7
    elif case == "over_torn_target":
        state = _tree(9)
        save_tree(str(tmp_path / ".staging-step9"), state,
                  {"global_steps": 9})
        (tmp_path / "step9").mkdir()
        (tmp_path / "step9" / DATA_FILE).write_bytes(b"\x00" * 8)
        ce.sweep_staging_dirs(str(tmp_path))
        assert (tmp_path / "step9.corrupt").is_dir()   # kept as evidence
        tag, steps = "step9", 9
    else:
        state = _write_tag(tmp_path, "step8", seed=8)
        save_tree(str(tmp_path / ".staging-step8"), _tree(99),
                  {"global_steps": 99})
        ce.sweep_staging_dirs(str(tmp_path))
        tag, steps = "step8", 8
    assert not any(n.startswith(".staging") for n in os.listdir(tmp_path))
    got, meta = load_tree(str(tmp_path / tag), _template(state),
                          device="cpu")
    _assert_tree_equal(got, state)
    assert meta["global_steps"] == steps
    _jax_agrees(tmp_path)


def test_torn_pod_tag_is_quarantined_by_the_sweep(tmp_path):
    _write_tag(tmp_path, "step1", seed=1)
    _write_tag(tmp_path, "step2", seed=2)
    os.unlink(tmp_path / "step2" / COMMIT_FILE)   # manifests, no commit
    assert not verify_tree(str(tmp_path / "step2"))[0]
    ce.sweep_staging_dirs(str(tmp_path))
    assert (tmp_path / "step2.corrupt").is_dir()
    assert resilience_counters.get("torn_pod_quarantined") == 1
    assert list_tags(str(tmp_path)) == ["step1"]


# ================================================================ async
def test_async_save_returns_a_copy_not_a_view(tmp_path):
    """The writer must save the bytes of the step it was given, though the
    optimizer updates the tensors in place the moment ``save`` returns."""
    configure_fault_injection({"async_delay": 0.3})
    w = torch.arange(16, dtype=torch.float32)
    eng = ce.build_checkpoint_engine("async")
    eng.save(str(tmp_path / "t"), {"w": w, "layer": lambda: w * 2},
             {"global_steps": 1})
    w.add_(100.0)                        # the next step, in place
    eng.wait()
    got, _ = load_tree(str(tmp_path / "t"), {
        "w": torch.empty(16, device="meta"),
        "layer": torch.empty(16, device="meta")}, device="cpu")
    assert torch.equal(got["w"], torch.arange(16, dtype=torch.float32))
    assert torch.equal(got["layer"], 2 * torch.arange(16,
                                                      dtype=torch.float32))


def test_failed_async_save_surfaces_on_wait_and_cleans_staging(tmp_path):
    configure_fault_injection({"write_fail": {"match": DATA_FILE,
                                              "count": 99},
                               "async_delay": 0.01})
    eng = ce.build_checkpoint_engine("async")
    eng.save(str(tmp_path / "t1"), _tree(1), {},
             latest_file=str(tmp_path / "latest"), tag="t1")
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        eng.wait()
    assert not any(n.startswith(".staging") for n in os.listdir(tmp_path))
    assert not os.path.exists(tmp_path / "latest")
    with pytest.raises(ValueError, match="unknown checkpoint engine"):
        ce.build_checkpoint_engine("nebula")


def test_async_save_then_immediate_load(tmp_path):
    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    cfg = dict(ENGINE_CFG, checkpoint={"engine": "async"})
    eng, _ = _port_engine(cfg, "float32", jparams)
    assert eng.checkpoint_engine.name == "async"
    configure_fault_injection({"async_delay": 0.2})
    eng.train_batch(_batch(70))
    eng.save_checkpoint(str(tmp_path))
    eng.train_batch(_batch(71))          # in place, while the writer runs
    path, _ = eng.load_checkpoint(str(tmp_path))   # waits for the writer
    assert path.endswith("global_step1") and eng.global_steps == 1


# ============================================================== rotation
def test_rotate_keeps_newest_verified(tmp_path):
    for i in (1, 2, 3, 4):
        _write_tag(tmp_path, f"step{i}", seed=i)
    assert sorted(rotate_checkpoints(str(tmp_path), keep_last_n=2)) == \
        ["step1", "step2"]
    assert sorted(list_tags(str(tmp_path))) == ["step3", "step4"]
    assert resilience_counters.get("checkpoints_rotated") == 2


def test_rotate_never_deletes_corrupt_or_pointed(tmp_path):
    for i in (1, 2, 3):
        _write_tag(tmp_path, f"step{i}", seed=i)
    data = tmp_path / "step2" / DATA_FILE
    data.write_bytes(data.read_bytes()[:8])
    ce._write_latest(str(tmp_path / "latest"), "step1")
    assert rotate_checkpoints(str(tmp_path), keep_last_n=1) == []
    with pytest.raises(ValueError):
        rotate_checkpoints(str(tmp_path), keep_last_n=0)


def test_engine_keep_last_n(tmp_path):
    _, jparams = _jax_tiny()
    cfg = dict(ENGINE_CFG, checkpoint={"keep_last_n": 2})
    eng, _ = _port_engine(cfg, "float32", jax.tree.map(np.asarray, jparams))
    for i in range(4):
        eng.train_batch(_batch(80 + i))
        eng.save_checkpoint(str(tmp_path))
    assert sorted(list_tags(str(tmp_path))) == ["global_step3",
                                                "global_step4"]
    assert eng.load_checkpoint(str(tmp_path))[0].endswith("global_step4")


# ============================================================ preemption
class _Preempted(Exception):
    def __init__(self, code):
        super().__init__(f"exit({code})")
        self.code = code


def _raise_exit(code):
    raise _Preempted(code)


def test_preemption_saves_and_resume_matches_uninterrupted(tmp_path):
    _, jparams = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jparams)
    batches = [_batch(90 + i) for i in range(5)]
    plain, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    want = _trajectory(plain, batches)
    eng, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    eng.enable_preemption_handling(str(tmp_path),
                                   install_signal_handlers=False,
                                   exit_fn=_raise_exit)
    configure_fault_injection({"preempt_at_step": 3})
    with pytest.raises(_Preempted) as ei:
        _trajectory(eng, batches)
    assert ei.value.code == PREEMPTION_EXIT_CODE
    assert resilience_counters.get("preemptions") == 1
    assert resilience_counters.get("emergency_saves") == 1
    assert verify_tree(str(tmp_path / "global_step3")) == (True, "ok")
    configure_fault_injection(None)
    resumed, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    assert resumed.load_checkpoint(str(tmp_path))[0] is not None
    assert _trajectory(resumed, batches[3:]) == want[3:]


def test_sigterm_triggers_emergency_save(tmp_path):
    _, jparams = _jax_tiny()
    eng, _ = _port_engine(ENGINE_CFG, "float32",
                          jax.tree.map(np.asarray, jparams))
    rm = eng.enable_preemption_handling(str(tmp_path), exit_fn=_raise_exit)
    try:
        eng.train_batch(_batch(95))
        os.kill(os.getpid(), signal.SIGTERM)
        with pytest.raises(_Preempted) as ei:
            eng.train_batch(_batch(96))   # honoured at the step boundary
        assert ei.value.code == PREEMPTION_EXIT_CODE
        assert verify_tree(str(tmp_path / "global_step2"))[0]
    finally:
        rm.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not rm._on_signal


WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    from deepspeedsyclsupport_tpu_torch import build_model
    from deepspeedsyclsupport_tpu_torch.runtime.engine import initialize
    from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
        configure_fault_injection)
    ckpt, log = sys.argv[1], sys.argv[2]
    model = build_model("tiny", dtype="float32")
    eng = initialize(model=model, config={cfg!r}, device="cpu")[0]
    eng.enable_preemption_handling(ckpt, install_signal_handlers=False)
    if eng.load_checkpoint(ckpt)[0] is not None:
        # the injected preemption is one event of the run: the spec is
        # re-read by every incarnation
        configure_fault_injection({{}})
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 512, (4, 32)) for _ in range(5)]
    for b in batches[eng.global_steps:]:
        m = eng.train_batch({{"input_ids": b}})
        with open(log, "a") as f:
            f.write(json.dumps([eng.global_steps, float(m["loss"])]) + "\\n")
""")


def test_agent_restarts_a_preempted_worker_free(tmp_path, monkeypatch):
    from deepspeedsyclsupport_tpu_torch.elasticity import DSElasticAgent

    # every child is killed after 240 s
    monkeypatch.setattr(subprocess, "run",
                        functools.partial(subprocess.run, timeout=240))

    cfg = {k: v for k, v in ENGINE_CFG.items()}
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, cfg=cfg))
    runs = {}
    for name, spec in (("plain", None), ("preempted", {"preempt_at_step":
                                                      3})):
        env = {"DSTPU_FAULT_INJECTION": json.dumps(spec)} if spec else {}
        log = tmp_path / f"{name}.jsonl"
        agent = DSElasticAgent(
            [sys.executable, str(script), str(tmp_path / name), str(log)],
            {"elasticity": {"enabled": False}}, restart_limit=0,
            env=dict(env, OMP_NUM_THREADS="1", WORLD_SIZE="1"))
        assert agent.run() == 0
        runs[name] = (agent, [json.loads(x) for x in
                              log.read_text().splitlines()])
    agent, lines = runs["preempted"]
    assert agent.preemption_count == 1 and agent.restart_count == 0
    assert [h["preempted"] for h in agent.launch_history] == [True, False]
    # step 3 saved and exited at its boundary, before the worker logged it
    assert [s for s, _ in lines] == [1, 2, 4, 5]
    # the resumed losses, bit for bit
    assert lines == [ln for ln in runs["plain"][1] if ln[0] != 3]

