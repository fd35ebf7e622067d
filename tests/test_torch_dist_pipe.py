"""PyTorch port: pipeline parallelism (the 1F1B host-loop executor over
``pipe``) over 4 gloo ranks against the JAX engine's SPMD pipeline on 4 of
the conftest's 8 host devices, on the CPU: the ``dryrun_multichip`` legs
"pipeline pp2/dp/tp zero1", "pipeline pp4/dp zero1" (4 layers, one a
stage, 4 micro-batches: the 3-deep warmup and drain) and "pipeline
pp2/fsdp2 zero1", plus pp2 x fsdp2 at ZeRO-3 from shards made by
``shard_params_from_jax``, and pp2 x sp2 through ``ring:xla`` (which the
JAX engine cannot run: against its run on one device); every leg
evaluates through ``eval_batch`` after training. (3D, Ulysses and ring: ``test_torch_dist_sp.py``, which
shares this module's runner and checks.) The façade's point-to-point ops
over ``pipe`` and the gradients of the differentiable ``ppermute`` and
``all_to_all`` are held exact against their known results.

The ranks run once per module (``tests/torch_dist_worker.py``). Weights are
the JAX ``tiny`` init (seed 3), batches numpy draws from a seed, two
gradient-accumulation micro-batches a step. Tolerances are those of
``tests/test_torch_dist_train.py``: loss 1e-5 and grad_norm 1e-4 relative a
step, the gathered params and each rank's shards 1e-5, ``eval_batch``
1e-5. Adam's eps is 1e-3 here: a pipeline sums the gradient micro-batch
by micro-batch (the port's 1F1B runs the head on each; the JAX pipeline
runs it on the reassembled batch), and at the default 1e-8 AdamW turns a
gradient element that cancels to rounding noise into a step of up to lr
of either sign (the JAX package's own pp2 x tp2 run departs from its
unpipelined run on 3 elements of 139 k, up to 1.2e-4; the port's from the
JAX pipeline on 35, up to 7.2e-4). With eps 1e-3 the port's params of
pp2 x tp2 and pp2 x fsdp2 ZeRO-3 agree with the JAX pipeline's to 6e-8.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.comm.topology import MeshTopology
from deepspeedsyclsupport_tpu_torch.runtime import shard_params_from_jax
from tests.torch_dist_worker import flat, launch

SEQ = 32
STEPS = 3
BASE = {
    "train_batch_size": 8, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3,
                                              "betas": [0.9, 0.95],
                                              "eps": 1e-3,
                                              "weight_decay": 0.1}},
    "gradient_clipping": 0.5, "steps_per_print": 1000,
}
AXES = {"dp": "data", "fsdp": "fsdp", "tp": "model", "pp": "pipe",
        "sp": "seq"}


def leg(stage, axes, micro=None, model_kw=None, local=False, world=4,
        jax_axes=None):
    """A leg: the port's config (its mesh from the ``parallelism`` and
    ``pipeline`` sections), the JAX topology ``axes`` (build_topology's
    names; ``jax_axes`` where the JAX engine runs another), model
    overrides, and whether the port's ranks start from
    ``shard_params_from_jax`` shards."""
    par = {k: v for k, v in axes.items() if k in ("dp", "fsdp", "tp", "sp")}
    cfg = dict(BASE, zero_optimization={"stage": stage}, parallelism=par)
    if axes.get("pp", 1) > 1:
        cfg["pipeline"] = {"stages": axes["pp"], "micro_batches": micro}
    return {"config": cfg, "axes": axes, "model_kw": model_kw or {},
            "local": local, "world": world, "jax_axes": jax_axes or axes}


LEGS = {
    "pp2_tp2_zero1": leg(1, dict(dp=1, tp=2, pp=2), micro=2),
    "pp4_zero1": leg(1, dict(dp=1, pp=4), micro=4,
                     model_kw={"num_layers": 4}),
    "pp2_fsdp2_zero1": leg(1, dict(dp=1, fsdp=2, pp=2), micro=2),
    "pp2_fsdp2_zero3": leg(3, dict(dp=1, fsdp=2, pp=2), micro=2,
                           local=True),
    # the pipeline composed with the ring (the JAX engine cannot nest its
    # ring's shard_map in the pipeline's): against its unpipelined,
    # unsplit run on one device, the function both compute
    "pp2_sp2_ring_xla_zero1": leg(1, dict(dp=1, pp=2, sp=2), micro=2,
                                  model_kw={"attn_impl": "ring:xla"},
                                  jax_axes=dict(dp=1)),
}


def _batches():
    out = []
    for i in range(STEPS):
        rng = np.random.RandomState(200 + i)
        out.append({"input_ids": rng.randint(0, 512, (8, SEQ)).astype(
            np.int32)})
    return out


def _jax_params(model_kw):
    jmodel = jax_build_model("tiny", dtype="float32", **model_kw)
    return jmodel, jax.tree.map(np.asarray,
                                jmodel.init_params(jax.random.PRNGKey(3)))


def _sizes(axes):
    return {AXES[k]: v for k, v in axes.items()}


def _jax_run(spec, jax_model_kw):
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    jmodel, params = _jax_params(jax_model_kw)
    axes = spec["jax_axes"]
    topo = build_topology(devices=jax.devices()[:int(np.prod(list(
        axes.values())))], **axes)
    cfg = spec["config"]
    if axes != spec["axes"]:
        cfg = {k: v for k, v in cfg.items()
               if k not in ("parallelism", "pipeline")}
    eng, *_ = dstpu.initialize(model=jmodel, config=cfg, topology=topo,
                               params=jax.tree.map(jnp.asarray, params))
    steps = []
    batches = _batches()
    for b in batches:
        m = eng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        steps.append([float(m["loss"]), float(m["grad_norm"])])
    ev = float(eng.eval_batch({k: jnp.asarray(v)
                               for k, v in batches[0].items()}))
    return np.array(steps), jax.tree.map(np.asarray, eng.params), ev


def run_ranks(tmp_path_factory, legs, world):
    """``legs`` on ``world`` gloo ranks, once: ``{leg: [rank npz
    dicts]}``."""
    out = tmp_path_factory.mktemp("dist_pipe")
    arrays, paths = {}, []
    kws = {}
    for name, spec in legs.items():
        key = f"p{len(kws)}"
        kws.setdefault(tuple(sorted(spec["model_kw"].items())), key)
    for kw, key in kws.items():
        for k, v in flat(_jax_params(dict(kw))[1]):
            arrays[f"{key}/{k}"] = v
    np.savez(out / "params.npz", **arrays)
    for i, b in enumerate(_batches()):
        paths.append(str(out / f"batch{i}.npz"))
        np.savez(paths[-1], **b)
    spec_legs = []
    for name, spec in legs.items():
        key = kws[tuple(sorted(spec["model_kw"].items()))]
        spec_legs.append({
            "name": name, "config": spec["config"], "dtype": "float32",
            "params_prefix": f"{key}/", "steps": STEPS,
            "sizes": _sizes(spec["axes"]), "pass_topology": False,
            "local_params": spec["local"], "loader": False,
            "model_kw": spec["model_kw"], "batches": paths})
    launch({"kind": "train", "params": str(out / "params.npz"),
            "legs": spec_legs}, out, world=world)
    return {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                   for r in range(world)] for name in legs}


def check_leg(ranks, spec, jax_model_kw=None):
    """The port's ranks against the JAX engine on the same topology."""
    want, jfinal, jeval = _jax_run(spec, dict(spec["model_kw"],
                                              **(jax_model_kw or {})))
    got = ranks
    world = spec["world"]
    for r in range(world):   # every rank reports the same global numbers
        np.testing.assert_array_equal(got[r]["steps"], got[0]["steps"])
    steps = got[0]["steps"]
    # checkpoints across ranks still raise, naming their queue
    assert all("A.3.1" in str(r["ckpt_refused"]) for r in got)
    np.testing.assert_array_equal(steps[:, 2], 1.0)
    np.testing.assert_allclose(steps[:, 0], want[:, 0], rtol=1e-5,
                               err_msg="loss")
    np.testing.assert_allclose(steps[:, 1], want[:, 1], rtol=1e-4,
                               err_msg="grad_norm")
    for r in got:
        np.testing.assert_allclose(float(r["eval"]), jeval, rtol=1e-5,
                                   err_msg="eval_batch")
    model = build_model("tiny", dtype="float32", **spec["model_kw"])
    full = {k[len("full/"):]: v for k, v in got[0].items()
            if k.startswith("full/")}
    want_full = dict(flat(params_from_jax(jfinal, model.config,
                                          device="cpu")))
    assert set(full) == set(want_full)
    close_params([(k, v, want_full[k].numpy()) for k, v in full.items()])
    # each rank's shards (its stage's layers) are shard_params_from_jax's
    topo = MeshTopology(_sizes(spec["axes"]), world_size=world)
    stage = spec["config"]["zero_optimization"]["stage"]
    for r in range(world):
        shards = dict(flat(shard_params_from_jax(jfinal, model.config, topo,
                                                 stage, rank=r)))
        assert set(shards) == {k[len("local/"):] for k in got[r]
                               if k.startswith("local/")}, r
        close_params([(f"rank {r} {k}", got[r][f"local/{k}"], v)
                      for k, v in shards.items()])


def close_params(pairs):
    """``pairs``: [(what, got, want)] over a tree, each within 1e-5."""
    for what, got, want in pairs:
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                   err_msg=what)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, LEGS, 4)


@pytest.mark.parametrize("name", list(LEGS))
def test_leg_matches_jax_engine(ranks, name):
    check_leg(ranks[name], LEGS[name])


def test_p2p_and_differentiable_collectives(tmp_path):
    """send / recv both ways along a 4-rank ``pipe`` (async and waited),
    ``p2p`` (index 3 gets index 1's value, the rest keep theirs), the bytes
    logged for each; ``ppermute``'s gradient is the inverse permutation's
    and ``all_to_all``'s the swapped all-to-all's; ``PipelineModule``'s
    forward through the executor over 4 stages (EXACT)."""
    launch({"kind": "p2p"}, tmp_path, world=4)
    got = [dict(np.load(tmp_path / f"p2p_rank{r}.npz")) for r in range(4)]
    for r, g in enumerate(got):
        x = np.arange(3.0) + 10 * r
        assert g["recv_prev"].tolist() == (x - 10 if r else x).tolist()
        assert g["recv_next"].tolist() == (
            2 * (x + 10) if r < 3 else x).tolist()
        assert g["p2p"].tolist() == (np.arange(3.0) + 10 if r == 3
                                     else x).tolist()
        # d/dx of sum(ppermute(x)_dst * (dst + 1)): the receiver's weight
        assert g["ppermute_grad"].tolist() == [(r + 1) % 4 + 1] * 3
        # rank j's output: piece j of every rank i at columns 2i, 2i+1
        assert g["all_to_all"].tolist() == [[
            float(2 * r + c + 100 * i) for i in range(4) for c in (0, 1)]]
        assert g["all_to_all_grad"].tolist() == [
            [float(2 * r + 8 * j), float(2 * r + 1 + 8 * j)]
            for j in range(4)]
        # PipelineModule over 4 stages, 2 micro-batches: every rank returns
        # the last stage's output
        want = np.arange(8.0).reshape(4, 2) + 1
        for layer in range(4):
            want = want * (layer + 2) + 1
        assert g["pipeline_module"].tolist() == want.tolist()
        logged = json.loads(str(g["logger"]))
        n_send = (r < 3) + (r > 0)
        assert logged["send[pipe]"] == 12 * n_send
        assert logged["recv[pipe]"] == 12 * n_send
