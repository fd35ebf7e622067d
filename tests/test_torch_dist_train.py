"""PyTorch port: ZeRO stages 0-3 (stage 1 fed by the topology-aware
loader, stage 3 also under activation checkpointing) and a per-rank-uneven
loss mask over 4 gloo ranks against the JAX engine on the same 4-device
topology, on the CPU (tensor parallelism, fp16 and MiCS:
``test_torch_dist_train_tp.py``, which shares this module's legs and
checks).

The ranks run once per module (``tests/torch_dist_worker.py``, one
subprocess a rank through ``comm.init_distributed``'s env:// path, every
leg in turn); the JAX engine runs each leg on 4 of the 8 host devices the
suite's conftest forces. Weights are the JAX ``tiny`` init (seed 3), the
batches numpy draws from a seed. Tolerances (those of
``tests/test_torch_train.py``'s fp32 trajectory, with its reasons): loss
1e-5, grad_norm 1e-4 relative a step; the gathered params and each rank's
shards 1e-5 of the JAX params (and of ``shard_params_from_jax`` of them).
Every leg's finite flags, loss scales and skipped steps are EQUAL; the
fp16 leg (initial scale 2^21) overflows on its first step and updates on
the next two, in both packages, its loss and grad_norm within the same
tolerances; its params: 99 % of the elements within 1e-4, every element
within 4 lr (Adam divides fp16-rounded gradients, and an element whose
gradient cancels to rounding noise takes a full step of either sign), and
its ``eval_batch`` on them at 1e-4. ``eval_batch`` after training is held
like the loss.

The ``zero2`` and ``zero3`` legs also write the comm census
(``Engine.emit_comm_census``: telemetry on, the last step counted op by
op; ``tests/torch_dist_worker.run_census``). Its class totals are held
EXACTLY to the JAX package's analytic ``expected_train_collectives`` on
the JAX engine's params and shardings, in the port's schedule (ZeRO-3
gathers a leaf in each micro-batch's forward and again for its backward,
the embedding once; a reduce-scatter's result is the shard): the
differences ``check_collectives(exact=True)`` names are the ones that
schedule predicts, and ``exact=False`` holds. The census per opcode equals
the plan from the shapes alone (``chip_smoke.py``'s ``dist_comm_bytes``,
in result bytes), the JAX classifier on the same census gives EQUAL
classes, and at ``zero2`` the param-gather class and the verdict EQUAL the
JAX engine's ``graph_report``. The pod report over the four rank streams
fills its per-class table (its ``bytes_match`` cross-check reads the same
record window and is reported, not held), ``python -m
deepspeedsyclsupport_tpu_torch.monitor.pod --json`` EQUALS
``tools/pod_report.py --json`` on them, the MFU roofline's ``collective``
region carries the census bytes, and every ``graph_report`` analyzer is
``ok``.
"""
import concurrent.futures as futures
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu_torch import build_model
from deepspeedsyclsupport_tpu_torch.comm.topology import MeshTopology
from deepspeedsyclsupport_tpu_torch.runtime import shard_params_from_jax
from tests.torch_dist_worker import flat, launch

SEQ = 32
STEPS = 3
BASE = {
    "train_batch_size": 8, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3,
                                              "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
    "gradient_clipping": 0.5, "steps_per_print": 1000,
}


def _cfg(stage, par=None, **extra):
    cfg = dict(BASE, zero_optimization={"stage": stage}, **extra)
    if par is not None:
        cfg["parallelism"] = par
    return cfg


# name -> (config, dtype, JAX topology sizes (dp, fsdp, tp), how the port
# gets its mesh: "config" sizes or an explicit "topology", params "full"
# or "local" shards)
LEGS = {
    "zero0": (_cfg(0, {"dp": 1, "fsdp": 4}), "float32", (1, 4, 1),
              "config", "full"),
    "zero1": (_cfg(1, {"dp": 1, "fsdp": 4}), "float32", (1, 4, 1),
              "config", "full"),
    "zero2": (_cfg(2), "float32", (1, 4, 1), "config", "full"),
    "zero3": (_cfg(3), "float32", (1, 4, 1), "topology", "local"),
    "dp1_fsdp2_tp2_zero3": (_cfg(3, {"dp": 1, "fsdp": 2, "tp": 2}),
                            "float32", (1, 2, 2), "config", "full"),
    "fp16_zero2": (_cfg(2, {"dp": 1, "fsdp": 2, "tp": 2},
                        fp16={"enabled": True, "initial_scale_power": 21,
                              "hysteresis": 1}),
                   "float16", (1, 2, 2), "config", "full"),
    "mics2": (dict(_cfg(3), zero_optimization={"stage": 3,
                                               "mics_shard_size": 2}),
              "float32", (2, 2, 1), "config", "local"),
    "uneven_mask_zero3": (_cfg(3), "float32", (1, 4, 1), "config", "full"),
    # ZeRO-3 under activation checkpointing: the recompute gathers again
    "zero3_remat": (dict(_cfg(3), activation_checkpointing={}), "float32",
                    (1, 4, 1), "config", "full"),
    # biases of column- and row-parallel layers under TP (non-zero); Adam
    # eps 1e-3 as in test_torch_dist_pipe.py: at 1e-8 the JAX engine on
    # these 4 devices departs from its own one-device run by 3.5e-5 on an
    # embedding element (6.0e-8 over every leaf at 1e-3)
    "tp2_dp2_bias": (dict(_cfg(1, {"dp": 2, "tp": 2}), optimizer={
        "type": "AdamW", "params": dict(BASE["optimizer"]["params"],
                                        eps=1e-3)}), "float32", (2, 1, 2),
                     "config", "full"),
    # custom losses: a closure over the caller's model on the batch axes,
    # a subclass's bound loss under TP, a loss that is no mean over rows
    "custom_rowmean_zero3": (_cfg(3, {"dp": 2, "fsdp": 2}), "float32",
                             (2, 2, 1), "config", "full"),
    "custom_bound_tp2": (_cfg(1, {"dp": 2, "tp": 2}), "float32", (2, 1, 2),
                         "config", "full"),
    "custom_weighted_zero3": (_cfg(3, {"dp": 2, "fsdp": 2}), "float32",
                              (2, 2, 1), "config", "full"),
}
# legs' model options, custom losses (tests/torch_dist_worker.py
# ``custom_loss``) and weights; a ``use_bias`` leg's biases are seeded
# non-zero (every init makes them zero, and a bias added or summed tp
# times would pass a test built from it)
EXTRA = {
    "tp2_dp2_bias": {"model_kw": {"use_bias": True, "mlp_type": "mlp"}},
    "custom_rowmean_zero3": {"loss": "closure"},
    "custom_bound_tp2": {"loss": "bound"},
    "custom_weighted_zero3": {"loss": "weighted"},
}
# the JAX engine's results of each leg, computed while the ranks run
_JAX = {}
# legs that write the comm census, and the JAX side of their holds (its
# analytic expectation on its own params and shardings; at zero2 its
# graph_report's classes)
CENSUS_LEGS = ("zero2", "zero3")
_JAX_CENSUS = {}
# under TP a closure over the caller's model, and a vocabulary tp does not
# divide, raise at initialize
TP_SCOPE = [{"config": _cfg(1, {"dp": 2, "tp": 2}), "model_kw": {},
             "loss": "closure"},
            {"config": _cfg(1, {"dp": 2, "tp": 2}),
             "model_kw": {"vocab_size": 511}}]
# legs whose ranks train on the rows DSTpuDataLoader(topology=) hands
# them (each rank's own, micro-batch by micro-batch) instead of the global
# batch
LOADER_LEGS = ("zero1",)


def _batches(uneven, weighted=False):
    out = []
    for i in range(STEPS):
        rng = np.random.RandomState(100 + i)
        b = {"input_ids": rng.randint(0, 512, (8, SEQ)).astype(np.int32)}
        if uneven:
            # each rank's rows keep a different share of their tokens, so
            # a mean of per-rank means would differ from the global mean
            keep = np.repeat([0.9, 0.2, 0.6, 0.05], 2)[:, None]
            b["loss_mask"] = (rng.rand(8, SEQ) < keep).astype(np.float32)
        if weighted:
            b["weight"] = rng.uniform(0.2, 2.0, 8).astype(np.float32)
        out.append(b)
    return out


def _batch_kind(name):
    return (name.startswith("uneven"), name == "custom_weighted_zero3")


def _jax_params(dtype, model_kw=None):
    jmodel = jax_build_model("tiny", dtype=dtype, **(model_kw or {}))
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jax.random.PRNGKey(3)))
    if model_kw:
        # non-zero biases, drawn from a seed
        rng = np.random.RandomState(7)
        for layer_keys in (("attn", "bq"), ("attn", "bk"), ("attn", "bv"),
                           ("attn", "bo"), ("mlp", "b1"), ("mlp", "b2")):
            node = params["layers"]
            for k in layer_keys[:-1]:
                node = node[k]
            if layer_keys[-1] in node:
                v = node[layer_keys[-1]]
                node[layer_keys[-1]] = (0.1 * rng.randn(*v.shape)).astype(
                    v.dtype)
    return jmodel, params


def _jax_loss(kind, jmodel):
    """The JAX counterpart of the worker's ``custom_loss(kind, ...)``."""
    def loss(params, batch, rng=None, train=True):
        lm, metrics = jmodel.loss(params, {"input_ids": batch["input_ids"]},
                                  rng, train=train)
        if kind == "bound":
            lm = 2.0 * lm
        if kind == "weighted":
            lm = lm * batch["weight"].mean()
        return lm, metrics
    return loss


def _jax_run(name):
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    cfg, dtype, (dp, fsdp, tp), _, _ = LEGS[name]
    extra = EXTRA.get(name, {})
    jmodel, params = _jax_params(dtype, extra.get("model_kw"))
    topo = build_topology(dp=dp, fsdp=fsdp, tp=tp, devices=jax.devices()[:4])
    loss_fn = _jax_loss(extra["loss"], jmodel) if "loss" in extra else None
    eng, *_ = dstpu.initialize(model=jmodel, config=cfg, topology=topo,
                               loss_fn=loss_fn,
                               params=jax.tree.map(jnp.asarray, params))
    steps = []
    batches = _batches(*_batch_kind(name))
    for b in batches:
        m = eng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        steps.append([float(m["loss"]), float(m["grad_norm"]),
                      float(bool(m["finite"])), float(m["loss_scale"])])
    ev = float(eng.eval_batch({k: jnp.asarray(v)
                               for k, v in batches[0].items()}))
    if name in CENSUS_LEGS:
        from deepspeedsyclsupport_tpu import analysis as JA

        exp = JA.expected_train_collectives(
            eng.params, eng.topology, eng.zero_stage,
            param_shardings=eng.param_shardings)
        out = {"expectation": dataclasses.asdict(exp)}
        if name == "zero2":
            chk = eng.graph_report(analyzers=("collectives",))["collectives"]
            out["classes"], out["ok"] = chk.classes.summary(), chk.ok
        _JAX_CENSUS[name] = out
    return (np.array(steps), int(eng.skipped_steps),
            jax.tree.map(np.asarray, eng.params), ev)


MODULE_LEGS = ["zero0", "zero1", "zero2", "zero3", "uneven_mask_zero3",
               "zero3_remat"]


def run_ranks(tmp_path_factory, names, configs=()):
    """The ``names`` legs on 4 gloo ranks, once, then ``configs`` through
    ``initialize`` (``torch_dist_worker.run_scope``): ``{leg: [rank 0..3
    npz dicts]}``, and under ``"scope"`` each rank's messages."""
    out = tmp_path_factory.mktemp("dist_train")
    arrays, batch_paths = {}, {}
    for dtype in ("float32", "float16"):
        for k, v in flat(_jax_params(dtype)[1]):
            arrays[f"{dtype}/{k}"] = v
    for k, v in flat(_jax_params("float32", EXTRA["tp2_dp2_bias"][
            "model_kw"])[1]):
        arrays[f"bias/{k}"] = v
    np.savez(out / "params.npz", **arrays)
    for kind in ((False, False), (True, False), (False, True)):
        paths = []
        for i, b in enumerate(_batches(*kind)):
            paths.append(str(out / f"batch{int(kind[0])}{int(kind[1])}_"
                                   f"{i}.npz"))
            np.savez(paths[-1], **b)
        batch_paths[kind] = paths
    legs = []
    for name in names:
        cfg, dtype, (dp, fsdp, tp), mesh, params = LEGS[name]
        extra = EXTRA.get(name, {})
        legs.append({"name": name, "config": cfg, "dtype": dtype,
                     "params_prefix": "bias/" if "model_kw" in extra
                     else f"{dtype}/", "steps": STEPS,
                     "model_kw": extra.get("model_kw", {}),
                     "loss": extra.get("loss"),
                     "sizes": {"data": dp, "fsdp": fsdp, "model": tp},
                     "pass_topology": mesh == "topology",
                     "local_params": params == "local",
                     "loader": name in LOADER_LEGS,
                     "census": name in CENSUS_LEGS,
                     "batches": batch_paths[_batch_kind(name)]})
    # the JAX engine runs the legs beside the ranks (its compiles and
    # steps release the GIL); check_leg reads its results
    with futures.ThreadPoolExecutor(2) as pool:
        spawn = pool.submit(launch, {
            "kind": "train", "params": str(out / "params.npz"),
            "batches": batch_paths[(False, False)], "legs": legs,
            "configs": list(configs)}, out)
        for name in names:
            if EXTRA.get(name, {}).get("loss") != "weighted":
                _JAX[name] = _jax_run(name)
        spawn.result()
    got = {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                  for r in range(4)] for name in names}
    if configs:
        got["scope"] = [json.load(open(out / f"scope_rank{r}.json"))
                        for r in range(4)]
    got["out"] = str(out)
    return got


def _close_params(pairs, dtype):
    """``pairs``: [(what, got, want)] over a tree."""
    if dtype != "float16":
        for what, got, want in pairs:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=what)
        return
    # fp16: Adam's update is a ratio of fp16-rounded gradients (2^-11
    # relative each), and an element whose gradient cancels to rounding
    # noise gets a full step (lr / (1 + eps / |g|)) of either sign, in
    # either package: 99 % of the tree's elements within 1e-4 (lr / 30),
    # every element within the two applied steps of opposite sign (4 lr)
    near = total = 0
    for what, got, want in pairs:
        near += int((np.abs(got - want) <= 1e-4).sum())
        total += want.size
        np.testing.assert_allclose(got, want, atol=4 * 3e-3, rtol=0,
                                   err_msg=what)
    assert near >= 0.99 * total, (near, total)


def check_leg(ranks, name):
    cfg, dtype, (dp, fsdp, tp), _, _ = LEGS[name]
    model_kw = EXTRA.get(name, {}).get("model_kw", {})
    want, skipped, jfinal, jeval = _JAX.pop(name, None) or _jax_run(name)
    got = ranks[name]
    for r in range(4):   # every rank reports the same global numbers
        np.testing.assert_array_equal(got[r]["steps"], got[0]["steps"])
    steps = got[0]["steps"]
    # the layout saves across ranks: the tag's params EQUAL the gathered
    assert all(bool(r["ckpt_equal"]) for r in got)
    # finite and loss_scale a step, and the skipped count, EQUAL
    np.testing.assert_array_equal(steps[:, 2:], want[:, 2:])
    assert int(got[0]["skipped"]) == skipped
    if dtype == "float16":
        assert skipped == 1 and steps[1:, 2].all()   # one overflow, then on
    np.testing.assert_allclose(steps[:, 0], want[:, 0], rtol=1e-5,
                               err_msg="loss")
    np.testing.assert_allclose(steps[:, 1], want[:, 1], rtol=1e-4,
                               err_msg="grad_norm")
    # eval_batch on the global batch after training: the global loss (fp16:
    # on params that departed as below, 1e-4)
    for r in got:
        np.testing.assert_allclose(float(r["eval"]), jeval,
                                   rtol=1e-4 if dtype == "float16" else 1e-5,
                                   err_msg="eval_batch")
    model = build_model("tiny", dtype=dtype, **model_kw)
    full = {k[len("full/"):]: v for k, v in got[0].items()
            if k.startswith("full/")}
    from deepspeedsyclsupport_tpu_torch import params_from_jax

    want_full = dict(flat({k: v for k, v in params_from_jax(
        jfinal, model.config, device="cpu").items()}))
    assert set(full) == set(want_full)
    _close_params([(k, v, want_full[k].numpy()) for k, v in full.items()],
                  dtype)
    # each rank's shards are shard_params_from_jax of the JAX params
    topo = MeshTopology({"data": dp, "fsdp": fsdp, "model": tp},
                        world_size=4)
    stage = cfg["zero_optimization"]["stage"]
    for r in range(4):
        shards = dict(flat(shard_params_from_jax(jfinal, model.config, topo,
                                                 stage, rank=r)))
        for k, v in shards.items():
            assert got[r][f"local/{k}"].shape == v.shape, (r, k)
        _close_params([(f"rank {r} {k}", got[r][f"local/{k}"], v)
                       for k, v in shards.items()], dtype)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, MODULE_LEGS)


@pytest.mark.parametrize("name", MODULE_LEGS)
def test_leg_matches_jax_engine(ranks, name):
    check_leg(ranks, name)


# ============================================================== the census
def _census(ranks, name):
    """Each rank's census record (``torch_dist_worker.run_census``)."""
    return [json.loads(str(r["census"])) for r in ranks[name]]


def _plan(c):
    """The leg's plan: a flat tree of its full leaves (numpy zeros, keyed
    by path), their specs and update specs (the same keys)."""
    tree = {p: np.zeros(shape, np.float32) for p, shape, _, _ in c["plan"]}
    specs = {(p,): tuple(tuple(e) for e in spec)
             for p, _, spec, _ in c["plan"]}
    update = {(p,): tuple(tuple(e) for e in u) for p, _, _, u in c["plan"]}
    return tree, specs, update


def _schedule(name, c):
    """The leg's census per opcode and class from the JAX expectation and
    the plan (``chip_smoke.py``'s ``dist_comm_bytes`` in result bytes):
    ``{op: bytes}`` of the all-gathers, reduce-scatters and non-scalar
    all-reduces, and the param-gather class's (count, bytes)."""
    want = _JAX_CENSUS[name]["expectation"]
    tree, specs, update = _plan(c)
    gas, fsdp = c["gas"], 4
    full = {p: a.nbytes for (p,), a in zip(specs, tree.values())}
    split = {p for (p,), spec in specs.items()
             if any("fsdp" in e for e in spec)}
    G = want["grad_sync_bytes"]
    if name == "zero3":
        S = want["param_gather_bytes"]
        assert S == sum(full[p] for p in split)   # the plan's = JAX's
        E = sum(full[p] for p in split if p.endswith("embedding"))
        n = len(split) - sum(p.endswith("embedding") for p in split)
        ops = {"all-gather": gas * (2 * S - E),
               "reduce-scatter": gas * S // fsdp, "all-reduce": G - S}
        return ops, (gas * (2 * n + (len(split) - n)), gas * (2 * S - E))
    U = sum(full[p] for (p,), u in update.items()
            if any("fsdp" in e for e in u))
    return ({"all-gather": U, "reduce-scatter": U // fsdp,
             "all-reduce": G - U}, (0, 0))


@pytest.mark.parametrize("name", CENSUS_LEGS)
def test_census_equals_the_jax_expectation_in_the_port_schedule(ranks, name):
    """Counts and bytes exact. Every rank writes the same census."""
    from deepspeedsyclsupport_tpu_torch import analysis as A
    from deepspeedsyclsupport_tpu_torch.comm.hlo_comms import (
        summarize_collectives)

    cs = _census(ranks, name)
    c = cs[0]
    assert all(r["payload"] == c["payload"] for r in cs)
    assert c["payload"]["group_size"] == c["payload"]["n_devices"] == 4
    want = _JAX_CENSUS[name]["expectation"]
    ops, (pg_count, pg_bytes) = _schedule(name, c)
    # the census per opcode: the plan from the shapes alone
    summary = summarize_collectives(e for e in c["window"]
                                    if e["bytes"] > 64)
    assert {op: v["total_bytes"] for op, v in summary.items()} == ops
    classes = c["payload"]["classes"]
    assert (classes["param_gather"]["count"],
            classes["param_gather"]["total_bytes"]) == (pg_count, pg_bytes)
    rest = ops["reduce-scatter"] + ops["all-reduce"] + (
        ops["all-gather"] if name == "zero2" else 0)
    assert classes["grad_sync"]["total_bytes"] + \
        classes["other"]["total_bytes"] == rest
    # the port's expectation on its per-layer tree: the JAX engine's bytes
    tree, specs, _ = _plan(c)
    topo = type("T", (), {"axis_sizes": {"data": 1, "fsdp": 4}})()
    exp = A.expected_train_collectives(tree, topo, int(name[-1]),
                                       param_shardings=specs)
    assert (exp.param_gather_bytes, exp.grad_sync_bytes, exp.group_size) \
        == (want["param_gather_bytes"], want["grad_sync_bytes"],
            want["group_size"])
    # exact: the differences the schedule predicts, by name
    chk = A.check_collectives(c["window"], exp, tree, specs, exact=True)
    gs, other = (classes["grad_sync"]["total_bytes"],
                 classes["other"]["total_bytes"])
    named = []
    if name == "zero3":
        named += [f"param_gather count {pg_count} != expected "
                  f"{exp.param_gather_count}",
                  f"param_gather bytes {pg_bytes} != expected "
                  f"{exp.param_gather_bytes}"]
    named.append(f"grad_sync bytes {gs} != expected {exp.grad_sync_bytes}")
    if other:
        named.append(f"unclassified collective traffic {other} B exceeds "
                     f"budget 0 B (resharding suspect — see "
                     f"resharding_audit)")
    assert chk.problems == named
    # not exact, at the schedule's gathers (2 x gas): the engine's verdict
    assert c["ok"]["collectives"] and c["problems"] == []
    assert c["expectation"]["param_gather_bytes"] == (
        2 * c["gas"] * exp.param_gather_bytes)


@pytest.mark.parametrize("name", CENSUS_LEGS)
def test_census_classes_equal_the_jax_classifier(ranks, name):
    """The JAX classifier and checker on the port's census and tree."""
    from deepspeedsyclsupport_tpu import analysis as JA
    from deepspeedsyclsupport_tpu_torch import analysis as A
    from tests.test_torch_analysis import _jax_shardings

    c = _census(ranks, name)[0]
    tree, specs, _ = _plan(c)
    jsh = _jax_shardings(tree, specs, {"data": 1, "fsdp": 4})
    got = A.classify_collectives(c["window"], tree, specs)
    assert got.summary() == c["payload"]["classes"]
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JA.classify_collectives(c["window"], tree, jsh))
    topo = type("T", (), {"axis_sizes": {"data": 1, "fsdp": 4}})()
    for exact in (True, False):
        p = A.check_collectives(c["window"], A.expected_train_collectives(
            tree, topo, int(name[-1]), specs), tree, specs, exact=exact)
        j = JA.check_collectives(c["window"], JA.expected_train_collectives(
            tree, topo, int(name[-1]), jsh), tree, jsh, exact=exact)
        assert (p.ok, p.problems) == (j.ok, j.problems)


def test_zero2_census_equals_the_jax_graph_report(ranks):
    """The JAX engine's compiled zero2 step (its own census test holds
    exact=False): the same empty param-gather class and the same verdict.
    Its grad-sync and other classes are XLA's combined all-reduces (a
    tuple of leaves a collective), not comparable class by class."""
    c = _census(ranks, "zero2")[0]
    j = _JAX_CENSUS["zero2"]
    assert c["payload"]["classes"]["param_gather"] == \
        j["classes"]["param_gather"] == {"count": 0, "total_bytes": 0}
    assert c["ok"]["collectives"] is j["ok"] is True


@pytest.mark.parametrize("name", CENSUS_LEGS)
def test_graph_report_and_mfu_roofline_on_the_legs(ranks, name):
    """Every analyzer ``ok``; the roofline's collective region is the
    counted step's census; the straggler columns reduced over the world."""
    cs = _census(ranks, name)
    for c in cs:
        assert all(c["ok"].values()), c["reports"]
        assert c["roofline_collective_bytes"] == c["mfu_census_bytes"] == \
            sum(e["bytes"] for e in c["window"])
    rows = [[ln.split() for ln in c["straggler"].splitlines()
             if ln.startswith("train_batch")][0] for c in cs]
    assert len({(r[2], r[3]) for r in rows}) == 1   # min, max: the world's
    for r in rows:
        assert float(r[2]) <= float(r[1]) <= float(r[3])


def _pod_tool():
    spec = importlib.util.spec_from_file_location(
        "_pod_report", os.path.join(os.path.dirname(__file__), "..",
                                    "tools", "pod_report.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("name", CENSUS_LEGS)
def test_pod_report_fills_the_class_table(ranks, name, tmp_path, capsys):
    from deepspeedsyclsupport_tpu_torch.monitor import pod

    d = os.path.join(ranks["out"], f"pod_{name}")
    rep = pod.pod_report_from_paths([d])
    got = rep.to_dict()
    assert pod.validate_pod_report(got) == []
    assert got["ranks"] == [0, 1, 2, 3] and got["n_steps"] == STEPS
    classes = got["decomposition"]["classes"]
    census = _census(ranks, name)[0]["payload"]["classes"]
    assert {k: (v["count"], v["bytes_per_step"])
            for k, v in classes.items()} == \
        {k: (v["count"], v["total_bytes"]) for k, v in census.items()}
    # the cross-check reads the same record window: reported, not held
    assert rep.bytes_match is True
    # the port's CLI and the tool on the same streams: EQUAL
    outs = []
    for main in (pod.main, _pod_tool().main):
        path = tmp_path / f"{len(outs)}.json"
        capsys.readouterr()
        assert main([d, "--json", str(path)]) == 0
        outs.append((json.loads(path.read_text()),
                     capsys.readouterr().out.replace(str(path), "")))
    assert outs[0] == outs[1]
    assert "no comm/census record" not in outs[0][1]
