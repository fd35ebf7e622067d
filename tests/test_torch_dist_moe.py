"""PyTorch port: MoE training across ranks (expert parallelism over
``expert``, MoE under the 1F1B pipeline) over gloo ranks against the JAX
engine on the same topology of the conftest's host devices, on the CPU.

Legs (``tiny-moe``: 4 experts, top-2, 2 layers):

* the ``dryrun_multichip`` leg "moe dp/fsdp/tp/ep zero2" on 8 ranks (dp1 x
  fsdp2 x tp2 x ep2, its config: Adam lr 1e-3, B 4 x S 32), 3 steps;
* fsdp4 (ep 1) at ZeRO-3 with capacity factor 0.5, where rows ARE
  dropped: each rank's first routing (its logits, and its rows' experts,
  slots and kept flags) is recorded, and the kept (token, choice) set with
  its slots, put in global token order, is EQUAL to the JAX
  ``topk_gating``'s dispatch on the ranks' logits put together;
* ep4 (one expert a rank) at ZeRO-1;
* pp2 x ep2 and pp2 x fsdp2 at ZeRO-1, 2 micro-batches, against the JAX
  engine's pipeline, which sums the aux over layers AND micro-batches;
* fsdp2 x sp2 through ``ring:xla`` at ZeRO-1: MoE under sequence
  parallelism, routed in the global row-major token order.

Every leg also evaluates through ``eval_batch`` after training. Each
port rank reports the same global numbers. Tolerances are those of
``tests/test_torch_dist_train.py``: loss, ``lm_loss`` and
``moe_aux_loss`` 1e-5 and grad_norm 1e-4 relative a step, the gathered
params and each rank's shards (``shard_params_from_jax`` of the JAX
params) 1e-5, ``eval_batch`` 1e-5. Adam's eps is 1e-3 on the five
4-rank legs, for ``tests/test_torch_dist_pipe.py``'s reason: a split
changes the order of a gradient's sums (a pipeline's micro-batches, ep4's
expert GEMMs as a batch of one expert instead of four, fsdp4's
reductions), and at eps 1e-8 AdamW turns a gradient element that cancels
to rounding noise into a step of up to lr either way. At eps 1e-8 the JAX
package departs from its own one-device run too: on ep4 on 15 expert
elements by up to 6.9e-6, on fsdp4 at capacity factor 0.5 by up to
3.0e-5 (and the port's single-card engine from the JAX one there by
2.0e-4), with every loss within 1e-6; at eps 1e-3 each pair agrees to
1e-6. The 8-rank dryrun leg keeps its own optimizer (Adam, eps 1e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.parallel import moe as jax_moe
from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.comm.topology import MeshTopology
from deepspeedsyclsupport_tpu_torch.runtime import shard_params_from_jax
from tests.test_torch_dist_pipe import close_params
from tests.torch_dist_worker import flat, launch

SEQ = 32
STEPS = 3
MODEL = "tiny-moe"
BASE = {
    "train_batch_size": 8, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3,
                                              "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
    "gradient_clipping": 0.5, "steps_per_print": 1000,
}
# the dryrun_multichip leg's config (__graft_entry__.py:96-104 at 8
# devices: dp x fsdp = 2 batch ranks, 2 rows each)
DRYRUN = {
    "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
    "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
    "steps_per_print": 1000,
}
AXES = {"dp": "data", "fsdp": "fsdp", "tp": "model", "pp": "pipe",
        "ep": "expert", "sp": "seq"}


def leg(stage, axes, *, base=BASE, micro=None, model_kw=None, world=4,
        rows=8, eps=None, record_route=False):
    par = {k: v for k, v in axes.items()
           if k in ("dp", "fsdp", "tp", "ep", "sp")}
    cfg = dict(base, zero_optimization={"stage": stage}, parallelism=par)
    if eps is not None:
        cfg["optimizer"] = {"type": cfg["optimizer"]["type"], "params": dict(
            cfg["optimizer"]["params"], eps=eps)}
    if axes.get("pp", 1) > 1:
        cfg["pipeline"] = {"stages": axes["pp"], "micro_batches": micro}
    return {"config": cfg, "axes": axes, "model_kw": model_kw or {},
            "world": world, "rows": rows, "record_route": record_route}


LEGS8 = {
    "moe_dp1_fsdp2_tp2_ep2_zero2": leg(2, dict(dp=1, fsdp=2, tp=2, ep=2),
                                       base=DRYRUN, world=8, rows=4),
}
LEGS4 = {
    "moe_fsdp4_zero3_drops": leg(3, dict(dp=1, fsdp=4),
                                 model_kw={"capacity_factor": 0.5},
                                 record_route=True, eps=1e-3),
    "moe_ep4_zero1": leg(1, dict(dp=1, ep=4), eps=1e-3),
    "moe_pp2_ep2_zero1": leg(1, dict(dp=1, pp=2, ep=2), micro=2, eps=1e-3),
    "moe_pp2_fsdp2_zero1": leg(1, dict(dp=1, fsdp=2, pp=2), micro=2,
                               eps=1e-3),
    # MoE under sequence parallelism (the JAX engine runs it): a rank's
    # tokens are a chunk of each of its rows, routed in the global
    # row-major token order
    "moe_fsdp2_sp2_ring_zero1": leg(1, dict(dp=1, fsdp=2, sp=2),
                                    model_kw={"attn_impl": "ring:xla"},
                                    eps=1e-3),
}


def _batches(rows):
    return [{"input_ids": np.random.RandomState(300 + i).randint(
        0, 512, (rows, SEQ)).astype(np.int32)} for i in range(STEPS)]


def _jax_params(model_kw):
    jmodel = jax_build_model(MODEL, dtype="float32", **model_kw)
    return jmodel, jax.tree.map(np.asarray,
                                jmodel.init_params(jax.random.PRNGKey(5)))


def _sizes(axes):
    return {AXES[k]: v for k, v in axes.items()}


def _jax_run(spec):
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    jmodel, params = _jax_params(spec["model_kw"])
    axes = spec["axes"]
    topo = build_topology(devices=jax.devices()[:spec["world"]], **axes)
    eng, *_ = dstpu.initialize(model=jmodel, config=spec["config"],
                               topology=topo,
                               params=jax.tree.map(jnp.asarray, params))
    steps = []
    batches = _batches(spec["rows"])
    for b in batches:
        m = eng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        steps.append([float(m[k]) for k in ("loss", "grad_norm", "lm_loss",
                                            "moe_aux_loss")])
    ev = float(eng.eval_batch({k: jnp.asarray(v)
                               for k, v in batches[0].items()}))
    return np.array(steps), jax.tree.map(np.asarray, eng.params), ev


def _run_ranks(tmp_path_factory, legs, world):
    out = tmp_path_factory.mktemp("dist_moe")
    arrays, kws, spec_legs = {}, {}, []
    for spec in legs.values():
        kws.setdefault(tuple(sorted(spec["model_kw"].items())),
                       f"p{len(kws)}")
    for kw, key in kws.items():
        for k, v in flat(_jax_params(dict(kw))[1]):
            arrays[f"{key}/{k}"] = v
    np.savez(out / "params.npz", **arrays)
    for name, spec in legs.items():
        paths = []
        for i, b in enumerate(_batches(spec["rows"])):
            paths.append(str(out / f"{name}_batch{i}.npz"))
            np.savez(paths[-1], **b)
        key = kws[tuple(sorted(spec["model_kw"].items()))]
        spec_legs.append({
            "name": name, "config": spec["config"], "dtype": "float32",
            "model": MODEL, "params_prefix": f"{key}/", "steps": STEPS,
            "sizes": _sizes(spec["axes"]), "pass_topology": False,
            "local_params": False, "loader": False,
            "model_kw": spec["model_kw"], "batches": paths,
            "record_route": spec["record_route"]})
    launch({"kind": "train", "params": str(out / "params.npz"),
            "legs": spec_legs}, out, world=world)
    return {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                   for r in range(world)] for name in legs}


def _check_leg(got, spec):
    want, jfinal, jeval = _jax_run(spec)
    world = spec["world"]
    for r in range(world):   # every rank reports the same global numbers
        np.testing.assert_array_equal(got[r]["steps"], got[0]["steps"])
    steps = got[0]["steps"]
    np.testing.assert_array_equal(steps[:, 2], 1.0)
    np.testing.assert_allclose(steps[:, 0], want[:, 0], rtol=1e-5,
                               err_msg="loss")
    np.testing.assert_allclose(steps[:, 1], want[:, 1], rtol=1e-4,
                               err_msg="grad_norm")
    np.testing.assert_allclose(steps[:, 4], want[:, 2], rtol=1e-5,
                               err_msg="lm_loss")
    np.testing.assert_allclose(steps[:, 5], want[:, 3], rtol=1e-5,
                               err_msg="moe_aux_loss")
    for r in got:
        np.testing.assert_allclose(float(r["eval"]), jeval, rtol=1e-5,
                                   err_msg="eval_batch")
    # checkpoints across ranks still raise, naming their queue
    assert all("A.3.1" in str(r["ckpt_refused"]) for r in got)
    model = build_model(MODEL, dtype="float32", **spec["model_kw"])
    full = {k[len("full/"):]: v for k, v in got[0].items()
            if k.startswith("full/")}
    want_full = dict(flat(params_from_jax(jfinal, model.config,
                                          device="cpu")))
    assert set(full) == set(want_full)
    close_params([(k, v, want_full[k].numpy()) for k, v in full.items()])
    topo = MeshTopology(_sizes(spec["axes"]), world_size=world)
    stage = spec["config"]["zero_optimization"]["stage"]
    for r in range(world):
        shards = dict(flat(shard_params_from_jax(jfinal, model.config, topo,
                                                 stage, rank=r)))
        assert set(shards) == {k[len("local/"):] for k in got[r]
                               if k.startswith("local/")}, r
        close_params([(f"rank {r} {k}", got[r][f"local/{k}"], v)
                      for k, v in shards.items()])
    return want


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _run_ranks(tmp_path_factory, LEGS4, 4)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return _run_ranks(tmp_path_factory, LEGS8, 8)


def test_dryrun_moe_leg_on_8_ranks(ranks8):
    name = "moe_dp1_fsdp2_tp2_ep2_zero2"
    _check_leg(ranks8[name], LEGS8[name])


@pytest.mark.parametrize("name", list(LEGS4))
def test_leg_matches_jax_engine(ranks4, name):
    want = _check_leg(ranks4[name], LEGS4[name])
    assert (want[:, 3] > 0).all()           # an aux loss was carried


def test_dropped_rows_equal_the_jax_dispatch(ranks4):
    """The first routing of the fsdp4 leg (layer 0, micro-batch 0 of step
    1): the 4 ranks' logits in rank order are the micro-batch's global
    logits; their kept (token, choice) rows at their slots are EQUAL to the
    JAX ``topk_gating``'s dispatch on those logits at the global capacity,
    and rows were dropped."""
    got = ranks4["moe_fsdp4_zero3_drops"]
    cfg = build_model(MODEL, capacity_factor=0.5).config
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    cap = int(got[0]["route/0/cap"])
    logits = np.concatenate([r["route/0/logits"] for r in got])
    t = logits.shape[0]
    assert cap == max(int(np.ceil(t * 0.5 * k / e)), k)
    want, _, _ = jax_moe.topk_gating(jnp.asarray(logits), k, cap)
    dispatch = np.zeros((t, e, cap))
    dropped = 0
    tl = t // len(got)
    for r, g in enumerate(got):
        keep = g["route/0/keep"].astype(bool)
        ex, pos = g["route/0/expert"], g["route/0/pos"]
        tok = r * tl + np.tile(np.arange(tl), k)
        dispatch[tok[keep], ex[keep], pos[keep]] += 1
        dropped += int((~keep).sum())
    np.testing.assert_array_equal(dispatch, np.asarray(want))
    assert dropped >= 1
    assert dropped == t * k - int(np.asarray(want).sum())
