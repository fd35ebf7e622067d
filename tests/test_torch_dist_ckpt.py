"""PyTorch port: checkpoints, preemption and the sentinel across ranks,
over 4 gloo ranks against the JAX engine on 4 of the conftest's host
devices, on the CPU.

One spawn (``tests/torch_dist_worker.py``, kind ``ckpt``) runs every leg in
turn; the JAX engine runs its legs beside it. Weights are the JAX ``tiny``
(``tiny-moe``) inits (seeds 3 and 4: the resumed ranks start from the
other), batches numpy draws. Legs and limits:

* save and resume, dp2 x fsdp2 ZeRO-3, pp2 x dp2 and ep2 x fsdp2
  (``tiny-moe``): 2 steps, a save, 2 steps; fresh ranks load ``latest`` and
  repeat the last 2: loss, grad_norm and the final params BIT-EQUAL. The
  tag's params EQUAL the ranks' gathered ones at the save (a pipeline's
  stage blocks and the expert shards in the JAX stacked leaves).
* against the JAX tag: the names, shapes and dtypes of ``state_index.json``
  EQUAL the JAX engine's for the same config; each package loads the
  other's tag and takes one step (loss 1e-5, grad_norm 1e-4 relative).
* reshard: the port's tag loads at fsdp4 ZeRO-3, tp2 x dp2 ZeRO-1 and at
  world 1; every rank's params and moments EQUAL the cut of the whole
  leaves; the next step matches the JAX engine resharded the same way
  (loss 1e-5, grad_norm 1e-4).
* the async engine: its tag commits with 4 rank manifests; a newer tag
  torn between the commit's phases is quarantined by rank 0's sweep and
  every rank resumes the older one.
* tag validation (``Fail`` raises on every rank and writes nothing,
  ``Warn`` logs, ``Ignore`` is silent) and resume-tag agreement (rank 0's
  wins); ``pod_identity`` answers the group's rank and world.
* preemption on rank 1 alone: all 4 ranks save at the same step and exit
  217 through ``exit_fn``; the tag is pod-complete.
* the sentinel with a NaN on rank 1: every rank skips the same step, and
  rank 0's journal's (event, step, position, cause) EQUAL the JAX
  sentinel's; the other steps' losses 1e-5.
"""
import concurrent.futures as futures
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.utils.fault_injection import (
    configure_fault_injection as jconfigure)
from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.checkpoint import engine as tckpt
from deepspeedsyclsupport_tpu_torch.comm.topology import MeshTopology
from deepspeedsyclsupport_tpu_torch.runtime import engine as teng
from tests.torch_dist_worker import flat, launch, read_tag

SEQ = 32
BASE = {
    "train_batch_size": 8, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3,
                                              "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
    "gradient_clipping": 0.5, "steps_per_print": 1000,
}
SENTINEL = {"enabled": True, "warmup_steps": 2, "window": 8,
            "skip_limit": 99, "rollback_limit": 2, "last_good_k": 1,
            "lag": 1}


def cfg(stage, **par):
    out = dict(BASE, zero_optimization={"stage": stage}, parallelism=par)
    if par.get("pp", 1) > 1:
        out["pipeline"] = {"stages": par["pp"]}
    return out


Z3 = cfg(3, dp=2, fsdp=2)
# name -> (model, config, JAX topology sizes (dp, fsdp, tp))
RESUME = {"resume_zero3": ("tiny", Z3),
          "resume_pp2": ("tiny", cfg(1, dp=2, pp=2)),
          "resume_ep2": ("tiny-moe", cfg(1, fsdp=2, ep=2))}
RESHARD = {"fsdp4_zero3": (cfg(3, fsdp=4), (1, 4, 1)),
           "tp2_dp2_zero1": (cfg(1, dp=2, tp=2), (2, 1, 2))}


def _batches():
    out = []
    for i in range(6):
        rng = np.random.RandomState(300 + i)
        out.append({"input_ids": rng.randint(0, 512, (8, SEQ)).astype(
            np.int32), "loss_mask": np.ones((8, SEQ), np.float32)})
    return out


def _init(name, seed):
    m = jax_build_model(name, dtype="float32")
    return m, jax.tree.map(np.asarray, m.init_params(jax.random.PRNGKey(seed)))


def _jax_engine(config, sizes, params, devices=4, model="tiny"):
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    jmodel = jax_build_model(model, dtype="float32")
    dp, fsdp, tp = sizes
    config = {k: v for k, v in config.items() if k != "parallelism"}
    topo = build_topology(dp=dp, fsdp=fsdp, tp=tp,
                          devices=jax.devices()[:devices])
    return dstpu.initialize(model=jmodel, config=config, topology=topo,
                            params=jax.tree.map(jnp.asarray, params))[0]


def _jrow(m):
    return [float(m["loss"]), float(m["grad_norm"]), float(bool(m["finite"])),
            float(m["loss_scale"])]


def _jsteps(eng, batches):
    return [_jrow(eng.train_batch({k: jnp.asarray(v) for k, v in b.items()}))
            for b in batches]


def _journal(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX tag first (the ranks load it), then the spawn beside the
    JAX sentinel leg; returns ``(out, {leg: [rank npz]}, jax results)``."""
    out = tmp_path_factory.mktemp("dist_ckpt")
    batches = _batches()
    arrays = {}
    for prefix, name, seed in (("init/", "tiny", 3), ("alt/", "tiny", 4),
                               ("moe/", "tiny-moe", 3),
                               ("moealt/", "tiny-moe", 4)):
        for k, v in flat(_init(name, seed)[1]):
            arrays[prefix + k] = v
    np.savez(out / "params.npz", **arrays)
    paths = []
    for i, b in enumerate(batches):
        paths.append(str(out / f"batch{i}.npz"))
        np.savez(paths[-1], **b)
    jres = {}
    # the JAX engine's tag at dp2 x fsdp2 ZeRO-3 after 2 steps, and its
    # third step
    jeng = _jax_engine(Z3, (2, 2, 1), _init("tiny", 3)[1])
    jres["steps"] = _jsteps(jeng, batches[:2])
    jeng.save_checkpoint(str(out / "jax_tag"))
    jres["steps"] += _jsteps(jeng, batches[2:3])
    del jeng
    legs = []
    for name, (model, c) in RESUME.items():
        moe = model == "tiny-moe"
        legs.append({"type": "resume", "name": name, "model": model,
                     "config": c, "steps": 4, "save_at": 2,
                     "params_prefix": "moe/" if moe else "init/",
                     "alt_prefix": "moealt/" if moe else "alt/",
                     **({"jax_tag": str(out / "jax_tag" / "global_step2")}
                        if name == "resume_zero3" else {})})
    tag = str(out / "ckpt_resume_zero3" / "global_step2")
    for name, (c, _) in RESHARD.items():
        legs.append({"type": "reshard", "name": name, "config": c,
                     "alt_prefix": "alt/", "load": tag, "step": 2})
    for kind in ("async", "tags", "preempt", "sentinel"):
        c = dict(Z3, checkpoint={"engine": "async"}) if kind == "async" \
            else Z3
        legs.append({"type": kind, "name": kind, "config": c,
                     "params_prefix": "init/", "sentinel": SENTINEL,
                     "steps": 5})
    spec = {"kind": "ckpt", "params": str(out / "params.npz"),
            "batches": paths, "legs": legs}
    with futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, spec, out, 4, 420.0)
        jres["sentinel"] = _jax_sentinel(out, batches)
        # the JAX engine on the ranks' first tag, resharded, once it is
        # committed (the ranks go on with their other legs meanwhile)
        commit = os.path.join(tag, tckpt.COMMIT_FILE)
        while not os.path.exists(commit) and not ranks.done():
            time.sleep(0.1)
        if os.path.exists(commit):
            jres["on_port_tag"] = {
                name: _jax_on_tag(tag, c, sizes, devices)
                for name, (c, sizes, devices) in dict(
                    {"zero3": (Z3, (2, 2, 1), 4),
                     "world1": (Z3, (1, 1, 1), 1)},
                    **{k: v + (4,) for k, v in RESHARD.items()}).items()}
        ranks.result()
    got = {leg["name"]: [dict(np.load(out / f"{leg['name']}_rank{r}.npz"))
                         for r in range(4)] for leg in legs}
    return out, got, jres


def _jax_on_tag(tag, config, sizes, devices):
    """The JAX engine from another init, ``tag`` loaded at ``sizes`` on
    ``devices`` host devices, one step on batch 2."""
    jeng = _jax_engine(config, sizes, _init("tiny", 4)[1], devices=devices)
    jeng.load_checkpoint(*os.path.split(tag))
    return _jsteps(jeng, _batches()[2:3])


def _jax_sentinel(out, batches):
    """The JAX engine with the sentinel at dp2 x fsdp2 ZeRO-3, a NaN
    poisoning step 3's batch: ``(losses by step, journal)``."""
    jconfigure({"nan_step": {"rank": 0, "step": 3}})
    try:
        d = str(out / "jax_sentinel")
        eng = _jax_engine(dict(Z3, sentinel=dict(SENTINEL, journal_dir=d)),
                          (2, 2, 1), _init("tiny", 3)[1])
        losses = [r[0] for r in _jsteps(eng, batches[:5])]
    finally:
        jconfigure(None)
    return losses, _journal(os.path.join(d, "health_journal_rank0.jsonl"))


def _world1(tag_dir, tag, model="tiny"):
    """The port's single-card engine from another init, ``tag`` loaded."""
    m = build_model(model, dtype="float32")
    c = {k: v for k, v in Z3.items() if k != "parallelism"}
    eng = teng.initialize(model=m, config=c, device="cpu",
                          params=params_from_jax(_init(model, 4)[1],
                                                 m.config, device="cpu"))[0]
    eng.load_checkpoint(tag_dir, tag)
    return eng


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5,
                               err_msg=f"{what}: loss")
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4,
                               err_msg=f"{what}: grad_norm")


# ------------------------------------------------------------- resume
@pytest.mark.parametrize("name", list(RESUME))
def test_resume_is_bit_equal_and_the_tag_holds_the_gathered_params(run,
                                                                   name):
    out, got, _ = run
    ranks = got[name]
    for r in ranks:
        np.testing.assert_array_equal(r["steps1"], ranks[0]["steps1"])
        np.testing.assert_array_equal(r["steps2"], ranks[0]["steps2"])
        assert str(r["loaded"]) == str(ranks[0]["path"])
    # the resumed ranks, from another init, repeat steps 3-4 bit for bit
    np.testing.assert_array_equal(ranks[0]["steps2"], ranks[0]["steps1"][2:])
    final = {k: v for k, v in ranks[0].items() if k.startswith("final1/")}
    assert final
    for k, v in final.items():
        np.testing.assert_array_equal(ranks[0]["final2/" + k[7:]], v,
                                      err_msg=k)
    # the tag's leaves are the JAX stacked [L, ...] ([E, ...]) ones, and
    # equal the ranks' gathered params at the save
    model = build_model(RESUME[name][0], dtype="float32")
    tag = read_tag(str(ranks[0]["path"]))
    assert all(v.shape[0] == model.config.num_layers
               for k, v in tag.items() if k.startswith("layers/"))
    mine = dict(flat({k: v for k, v in params_from_jax(
        {k: v for k, v in _unflat(tag).items()}, model.config,
        device="cpu").items()}))
    saved = {k[6:]: v for k, v in ranks[0].items() if k.startswith("saved/")}
    assert set(mine) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    ok, reason = tckpt.verify_tree(str(ranks[0]["path"]))
    assert ok, reason
    with open(os.path.join(str(ranks[0]["path"]), tckpt.COMMIT_FILE)) as f:
        assert sorted(json.load(f)["ranks"]) == ["0", "1", "2", "3"]


def _unflat(named):
    tree = {}
    for key, v in named.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ------------------------------------------------------- against JAX
def _index(path):
    with open(os.path.join(path, tckpt.INDEX_FILE)) as f:
        return [(e["name"], e["shape"], e["dtype"]) for e in json.load(f)]


def test_tag_index_equals_the_jax_engines(run):
    out, got, _ = run
    assert _index(str(got["resume_zero3"][0]["path"])) == _index(
        str(out / "jax_tag" / "global_step2"))


def test_each_package_loads_the_others_tag(run):
    out, got, jres = run
    ranks = got["resume_zero3"]
    # the port's ranks on the JAX tag, against the JAX engine's own step 3
    for r in ranks:
        _close(r["steps_jax_tag"], jres["steps"][2:3], "port on the JAX tag")
    # the JAX engine on the port's tag, against the port's own step 3
    _close(jres["on_port_tag"]["zero3"], ranks[0]["steps1"][2:3],
           "JAX on the port's tag")


# ------------------------------------------------------------ reshard
@pytest.mark.parametrize("name", list(RESHARD) + ["world1"])
def test_reshard_cuts_the_whole_leaves_and_matches_jax(run, name):
    out, got, jres = run
    tag_dir = str(out / "ckpt_resume_zero3")
    whole = _world1(tag_dir, "global_step2")
    assert whole.global_steps == 2 and whole.optimizer.count == 2
    if name == "world1":
        # the whole leaves EQUAL the tag's
        tag = read_tag(os.path.join(tag_dir, "global_step2"))
        want = dict(flat({k: v for k, v in params_from_jax(
            _unflat(tag), whole.module.config, device="cpu").items()}))
        for k, v in flat(whole.params):
            np.testing.assert_array_equal(v.detach().numpy(),
                                          want[k].numpy(), err_msg=k)
        mine = [[float(v) for v in (m["loss"], m["grad_norm"],
                                    bool(m["finite"]), m["loss_scale"])]
                for m in [whole.train_batch(_batches()[2])]]
    else:
        c, sizes = RESHARD[name]
        dp, fsdp, tp = sizes
        topo = MeshTopology({"data": dp, "fsdp": fsdp, "model": tp},
                            world_size=4)
        stage = c["zero_optimization"]["stage"]
        full_params = whole.params
        for r, res in enumerate(got[name]):
            shards = dict(flat(teng.shard_params(
                full_params, whole.module.config, topo, stage, rank=r)))
            for k, v in shards.items():
                np.testing.assert_array_equal(res[f"local/{k}"],
                                              v.detach().numpy(),
                                              err_msg=f"rank {r} {k}")
            assert int(res["count"]) == 2
            for i, (mu, nu) in enumerate(zip(whole.optimizer.mu,
                                             whole.optimizer.nu)):
                spec = tuple(tuple(e) for e in json.loads(
                    str(res[f"spec/{i}"])))
                cut = topo.shard_slices(tuple(mu.shape), spec, r)
                np.testing.assert_array_equal(res[f"mu/{i}"],
                                              mu[cut].numpy())
                np.testing.assert_array_equal(res[f"nu/{i}"],
                                              nu[cut].numpy())
            np.testing.assert_array_equal(res["steps"], got[name][0]["steps"])
        mine = got[name][0]["steps"]
    _close(mine, jres["on_port_tag"][name], f"reshard {name}")


# -------------------------------------------------------------- async
def test_async_engine_commits_and_a_torn_pod_tag_is_passed_over(run):
    out, got, _ = run
    ranks = got["async"]
    first = str(ranks[0]["first"])
    assert first.endswith("global_step1")
    with open(os.path.join(first, tckpt.COMMIT_FILE)) as f:
        assert sorted(json.load(f)["ranks"]) == ["0", "1", "2", "3"]
    # the torn global_step2 was quarantined; every rank resumed step 1
    d = str(out / "ckpt_async")
    assert os.path.isdir(os.path.join(d, "global_step2.corrupt"))
    assert not os.path.exists(os.path.join(d, "global_step2"))
    assert not [n for n in os.listdir(d) if n.startswith(".staging")]
    for r in ranks:
        assert str(r["loaded"]) == first and int(r["steps"]) == 1


# ------------------------------------------------------- tags, identity
def test_tag_validation_and_resume_tag_agreement(run):
    _, got, _ = run
    for r, res in enumerate(got["tags"]):
        assert "differs across ranks" in str(res["Fail/raised"]), r
        assert bool(res["saved_nothing"])
        assert str(res["Warn/raised"]) == ""
        assert any("differs across ranks" in m
                   for m in json.loads(str(res["Warn/logged"])))
        assert str(res["Ignore/raised"]) == ""
        assert json.loads(str(res["Ignore/logged"])) == []
        # every rank adopts rank 0's resolution
        assert str(res["agreed"]) == "global_step0"
        assert res["pod"].tolist() == [r, 4]


# --------------------------------------------------------- preemption
def test_preemption_on_one_rank_saves_every_rank_at_one_step(run):
    out, got, _ = run
    for res in got["preempt"]:
        # step 2's boundary saved and exited before train_batch returned
        assert int(res["rc"]) == 217 and int(res["at"]) == 2
        assert len(res["steps"]) == 1
    tag = str(out / "ckpt_preempt" / "global_step2")
    ok, reason = tckpt.verify_tree(tag)
    assert ok, reason
    with open(os.path.join(tag, tckpt.COMMIT_FILE)) as f:
        assert sorted(json.load(f)["ranks"]) == ["0", "1", "2", "3"]
    assert tckpt._read_latest(str(out / "ckpt_preempt")) == "global_step2"


# ----------------------------------------------------------- sentinel
def test_sentinel_skips_one_step_on_every_rank_like_jax(run):
    out, got, jres = run
    ranks = got["sentinel"]
    for r in ranks:
        np.testing.assert_array_equal(r["steps"], ranks[0]["steps"])
        assert int(r["count"]) == 4          # the NaN step was discarded
    for k, v in ranks[0].items():
        if k.startswith("final/"):
            assert np.isfinite(v).all(), k
    d = str(out / "ckpt_sentinel")
    journal = _journal(os.path.join(d, "health_journal_rank0.jsonl"))
    assert not [n for n in os.listdir(d) if n.startswith("health_journal")
                and n != "health_journal_rank0.jsonl"]
    jlosses, jjournal = jres["sentinel"]

    def events(j):
        return [(e["event"], e["step"], e["position"], e.get("cause"))
                for e in j]

    assert events(journal) == events(jjournal)
    assert [e["event"] for e in journal] == ["skip"]
    losses = ranks[0]["steps"][:, 0]
    assert np.isnan(losses[2]) and np.isnan(jlosses[2])
    keep = [0, 1, 3, 4]
    np.testing.assert_allclose(losses[keep], np.asarray(jlosses)[keep],
                               rtol=1e-5)
