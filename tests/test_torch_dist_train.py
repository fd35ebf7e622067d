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
"""
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
}
# legs whose ranks train on the rows DSTpuDataLoader(topology=) hands
# them (each rank's own, micro-batch by micro-batch) instead of the global
# batch
LOADER_LEGS = ("zero1",)


def _batches(uneven):
    out = []
    for i in range(STEPS):
        rng = np.random.RandomState(100 + i)
        b = {"input_ids": rng.randint(0, 512, (8, SEQ)).astype(np.int32)}
        if uneven:
            # each rank's rows keep a different share of their tokens, so
            # a mean of per-rank means would differ from the global mean
            keep = np.repeat([0.9, 0.2, 0.6, 0.05], 2)[:, None]
            b["loss_mask"] = (rng.rand(8, SEQ) < keep).astype(np.float32)
        out.append(b)
    return out


def _jax_params(dtype):
    jmodel = jax_build_model("tiny", dtype=dtype)
    return jmodel, jax.tree.map(np.asarray,
                                jmodel.init_params(jax.random.PRNGKey(3)))


def _jax_run(name):
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    cfg, dtype, (dp, fsdp, tp), _, _ = LEGS[name]
    jmodel, params = _jax_params(dtype)
    topo = build_topology(dp=dp, fsdp=fsdp, tp=tp, devices=jax.devices()[:4])
    eng, *_ = dstpu.initialize(model=jmodel, config=cfg, topology=topo,
                               params=jax.tree.map(jnp.asarray, params))
    steps = []
    batches = _batches(name.startswith("uneven"))
    for b in batches:
        m = eng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        steps.append([float(m["loss"]), float(m["grad_norm"]),
                      float(bool(m["finite"])), float(m["loss_scale"])])
    ev = float(eng.eval_batch({k: jnp.asarray(v)
                               for k, v in batches[0].items()}))
    return (np.array(steps), int(eng.skipped_steps),
            jax.tree.map(np.asarray, eng.params), ev)


MODULE_LEGS = ["zero0", "zero1", "zero2", "zero3", "uneven_mask_zero3",
               "zero3_remat"]


def run_ranks(tmp_path_factory, names):
    """The ``names`` legs on 4 gloo ranks, once: ``{leg: [rank 0..3 npz
    dicts]}``."""
    out = tmp_path_factory.mktemp("dist_train")
    arrays, batch_paths = {}, {}
    for dtype in ("float32", "float16"):
        for k, v in flat(_jax_params(dtype)[1]):
            arrays[f"{dtype}/{k}"] = v
    np.savez(out / "params.npz", **arrays)
    for uneven in (False, True):
        paths = []
        for i, b in enumerate(_batches(uneven)):
            paths.append(str(out / f"batch{int(uneven)}_{i}.npz"))
            np.savez(paths[-1], **b)
        batch_paths[uneven] = paths
    legs = []
    for name in names:
        cfg, dtype, (dp, fsdp, tp), mesh, params = LEGS[name]
        legs.append({"name": name, "config": cfg, "dtype": dtype,
                     "params_prefix": f"{dtype}/", "steps": STEPS,
                     "sizes": {"data": dp, "fsdp": fsdp, "model": tp},
                     "pass_topology": mesh == "topology",
                     "local_params": params == "local",
                     "loader": name in LOADER_LEGS,
                     "batches": batch_paths[name.startswith("uneven")]})
    launch({"kind": "train", "params": str(out / "params.npz"),
            "batches": batch_paths[False], "legs": legs}, out)
    return {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                   for r in range(4)] for name in names}


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
    want, skipped, jfinal, jeval = _jax_run(name)
    got = ranks[name]
    for r in range(4):   # every rank reports the same global numbers
        np.testing.assert_array_equal(got[r]["steps"], got[0]["steps"])
    steps = got[0]["steps"]
    # a checkpoint across ranks still raises, naming its queue
    assert all("A.3.1" in str(r["ckpt_refused"]) for r in got)
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
    model = build_model("tiny", dtype=dtype)
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
