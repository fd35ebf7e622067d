"""PyTorch port: the named mesh and ZeRO's placement plan against the JAX
package's, in one process (no process group: a topology of 4 ranks plans
without one).

* ``MeshTopology``: axis order, sizes, ``-1`` and its validation, specs,
  coordinates (``tests/unit/test_topology.py``'s cases, world 8).
* ``ParallelismConfig``: the sizes (MiCS included) EQUAL to the JAX
  package's for the same config dicts.
* The plan: for every leaf of ``tiny`` and ``small``, ZeRO stages 0-3 over
  (dp, fsdp, tp) in {(4,1,1), (1,4,1), (1,2,2), (2,2,1)}, the port's shard
  shape of each layer's leaf EQUALS ``NamedSharding.shard_shape`` of the
  JAX stacked leaf with the layer dim dropped, for the params and for
  Adam's moments; ``predict_memory_per_device`` EQUAL.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from deepspeedsyclsupport_tpu.comm.topology import build_topology as jbuild
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.runtime import zero as jzero
from deepspeedsyclsupport_tpu.runtime.config import (
    ParallelismConfig as JParallelism)
from deepspeedsyclsupport_tpu_torch import build_model
from deepspeedsyclsupport_tpu_torch.comm.topology import (
    AXIS_ORDER, MeshTopology, build_topology, get_world_topology,
    reset_world_topology)
from deepspeedsyclsupport_tpu_torch.runtime import zero as tzero
from deepspeedsyclsupport_tpu_torch.runtime.config import ParallelismConfig

MESHES = [(4, 1, 1), (1, 4, 1), (1, 2, 2), (2, 2, 1)]


@pytest.fixture(autouse=True)
def _fresh_port_topology():
    yield
    reset_world_topology()


# ----------------------------------------------------------------- topology
def test_default_all_data_and_mixed_axes():
    topo = build_topology(dp=-1, world_size=8)
    assert topo.axis_sizes["data"] == 8 and topo.world_size() == 8
    assert topo.get_data_parallel_world_size() == 8
    topo = build_topology(dp=-1, tp=2, fsdp=2, world_size=8)
    assert topo.axis_sizes == {"pipe": 1, "data": 2, "fsdp": 2, "expert": 1,
                               "seq": 1, "model": 2}
    assert topo.get_model_parallel_world_size() == 2
    assert topo.get_fsdp_world_size() == 2
    assert topo.get_data_parallel_world_size() == 4
    assert get_world_topology() is topo


def test_axis_order_and_rank_places():
    assert AXIS_ORDER == ("pipe", "data", "fsdp", "expert", "seq", "model")
    # rank r sits where device r sits in the JAX mesh
    jt = jbuild(dp=2, fsdp=2, tp=2, devices=jax.devices()[:8])
    tt = MeshTopology({"data": 2, "fsdp": 2, "model": 2}, world_size=8)
    ids = np.vectorize(lambda d: d.id)(jt.mesh.devices)
    for r in range(8):
        c = tt.coords(r)
        assert ids[tuple(c[a] for a in AXIS_ORDER)] == r
    assert tt.group_ranks("model", 5) == [4, 5]
    assert tt.group_ranks("fsdp", 5) == [5, 7]
    assert tt.group_ranks(("data", "fsdp"), 5) == [1, 3, 5, 7]
    assert tt.axis_index(("data", "fsdp"), 6) == 3


def test_invalid_sizes():
    with pytest.raises(ValueError):
        MeshTopology({"data": 3, "model": 2}, world_size=8)
    with pytest.raises(ValueError):
        MeshTopology({"data": -1, "model": -1}, world_size=8)
    with pytest.raises(ValueError):
        MeshTopology({"bogus": 2}, world_size=8)
    with pytest.raises(ValueError, match="AXIS_ORDER"):
        MeshTopology({"data": 2, "fsdp": 4}, world_size=8)._check_order(
            ("fsdp", "data"))


def test_specs_and_shards():
    topo = build_topology(dp=-1, tp=2, world_size=8)
    assert topo.sharding(("data", "fsdp"), None, "model") == (
        ("data", "fsdp"), (), ("model",))
    assert topo.data_sharding(3) == (("data", "fsdp"), (), ())
    assert topo.replicated() == ()
    assert topo.batch_axes == ("data",)
    spec = topo.sharding("data", "model")
    assert topo.shard_shape((8, 6), spec) == (2, 3)
    assert topo.shard_slices((8, 6), spec, rank=5) == (slice(4, 6),
                                                       slice(3, 6))
    with pytest.raises(ValueError):
        topo.shard_shape((6, 6), spec)
    with pytest.raises(ValueError):
        topo.sharding("bogus")


def test_one_rank_without_a_process_group():
    topo = MeshTopology({}, world_size=1)
    assert topo.get_group("data") is None and topo.coords() == dict.fromkeys(
        AXIS_ORDER, 0)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "dp%d_fsdp%d_tp%d" % d)
def test_loader_rows_by_coordinate(dims):
    """Each rank's rows are the JAX loader's ``data_sharding`` shard on the
    device of the same place; ranks that differ only on ``model`` get the
    same rows; with 2 micro-batches each rank's rows come micro-batch by
    micro-batch, as the engine cuts a global batch."""
    from deepspeedsyclsupport_tpu.runtime.dataloader import (
        DSTpuDataLoader as JLoader)
    from deepspeedsyclsupport_tpu_torch.runtime.dataloader import rank_rows

    dp, fsdp, tp = dims
    x = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    jt = jbuild(dp=dp, fsdp=fsdp, tp=tp, devices=jax.devices()[:4])
    placed = next(iter(JLoader([{"x": x}], jt, prefetch=0)))["x"]
    tt = MeshTopology({"data": dp, "fsdp": fsdp, "model": tp}, world_size=4)
    for shard in placed.addressable_shards:
        r = shard.device.id
        np.testing.assert_array_equal(rank_rows(x, tt, rank=r),
                                      np.asarray(shard.data))
        got = rank_rows(torch.from_numpy(x), tt, gas=2, rank=r).numpy()
        n, c = dp * fsdp, tt.axis_index(("data", "fsdp"), r)
        mb = 4 // n
        want = np.concatenate([x[i * 4 + c * mb:i * 4 + (c + 1) * mb]
                               for i in range(2)])
        np.testing.assert_array_equal(got, want)


def test_loader_rows_shared_over_expert():
    """ep2 x fsdp2 x tp2: the ranks that differ only on ``expert`` (or
    ``model``) read the same rows, the JAX loader's shard of their
    (data, fsdp) coordinate (tokens are replicated over both axes)."""
    from deepspeedsyclsupport_tpu.runtime.dataloader import (
        DSTpuDataLoader as JLoader)
    from deepspeedsyclsupport_tpu_torch.runtime.dataloader import rank_rows

    x = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    jt = jbuild(dp=1, fsdp=2, tp=2, ep=2, devices=jax.devices()[:8])
    placed = next(iter(JLoader([{"x": x}], jt, prefetch=0)))["x"]
    tt = MeshTopology({"fsdp": 2, "expert": 2, "model": 2}, world_size=8)
    by_fsdp = {}
    for shard in placed.addressable_shards:
        r = shard.device.id
        got = rank_rows(x, tt, rank=r)
        np.testing.assert_array_equal(got, np.asarray(shard.data))
        by_fsdp.setdefault(tt.axis_index("fsdp", r), []).append(got)
    assert len(by_fsdp) == 2
    for rows in by_fsdp.values():     # 4 ranks (expert x model) each
        assert len(rows) == 4 and all((g == rows[0]).all() for g in rows)


# ------------------------------------------------------------------- config
@pytest.mark.parametrize("d,stage", [
    ({}, 0), ({}, 1), ({}, 3),
    ({"parallelism": {"tp": 2}}, 3),
    ({"tensor_parallel": {"tp_size": 2}}, 0),
    ({"parallelism": {"fsdp": 2}}, 2),
    ({"parallelism": {"dp": 2}}, 1),
    ({"parallelism": {"dp": 2, "fsdp": 2, "tp": 2}}, 3),
    ({"zero_optimization": {"mics_shard_size": 2}}, 3),
    ({"zero_optimization": {"mics_shard_size": 4},
      "parallelism": {"dp": 2}}, 3),
    ({"parallelism": {"fsdp": 2, "tp": 2, "ep": 2}}, 2),
    ({"moe": {"expert_parallel_size": 4}}, 1),
    ({"parallelism": {"ep": 2}, "moe": {"expert_parallel_size": 4}}, 0),
])
def test_parallelism_config_equals_jax(d, stage):
    mics = int(d.get("zero_optimization", {}).get("mics_shard_size", -1))
    want = JParallelism.from_config_dict(d, stage, mics_shard_size=mics)
    got = ParallelismConfig.from_config_dict(d, stage, mics_shard_size=mics)
    assert (got.dp, got.fsdp, got.tp, got.ep) == (want.dp, want.fsdp,
                                                  want.tp, want.ep)


def test_mics_conflict_raises_as_in_jax():
    d = {"parallelism": {"fsdp": 4}}
    with pytest.raises(ValueError, match="conflicts"):
        JParallelism.from_config_dict(d, 3, mics_shard_size=2)
    with pytest.raises(ValueError, match="conflicts"):
        ParallelismConfig.from_config_dict(d, 3, mics_shard_size=2)


# --------------------------------------------------------------------- plan
def _jax_plan(name, dims, stage):
    dp, fsdp, tp = dims
    jmodel = jax_build_model(name)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    topo = jbuild(dp=dp, fsdp=fsdp, tp=tp, devices=jax.devices()[:4])
    ps = jzero.tree_param_shardings(shapes, topo, stage,
                                    extra_rules=jmodel.sharding_rules)
    tx = optax.adam(1e-3)
    opt = jax.eval_shape(tx.init, shapes)
    os_ = jzero.tree_optimizer_shardings(opt, shapes, ps, topo, stage)
    params = {jax.tree_util.keystr(k): s.shard_shape(v.shape)
              for (k, v), s in zip(
                  jax.tree_util.tree_flatten_with_path(shapes)[0],
                  jax.tree_util.tree_leaves(ps))}
    mu = {jax.tree_util.keystr(k): s.shard_shape(v.shape)
          for (k, v), s in zip(
              jax.tree_util.tree_flatten_with_path(opt[0].mu)[0],
              jax.tree_util.tree_leaves(os_[0].mu))}
    return params, mu


def _key(path):
    """The JAX keystr of a port path (layer index dropped)."""
    names = [p for p in path if not isinstance(p, int)]
    return "".join(f"['{n}']" for n in names)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "dp%d_fsdp%d_tp%d" % d)
@pytest.mark.parametrize("name", ["tiny", "small"])
def test_shard_shapes_equal_jax(name, dims, stage):
    want_p, want_m = _jax_plan(name, dims, stage)
    model = build_model(name)
    full = model.init_params(device="meta")
    dp, fsdp, tp = dims
    topo = MeshTopology({"data": dp, "fsdp": fsdp, "model": tp},
                        world_size=4)
    specs = tzero.tree_param_shardings(full, topo, stage,
                                       extra_rules=model.sharding_rules)
    moments = tzero.tree_optimizer_shardings(full, specs, topo, stage)
    seen = set()
    for path, leaf in tzero._walk(full):
        k = _key(path)
        seen.add(k)
        layer = path[0] == "layers"
        for spec, want in ((specs[path], want_p[k]), (moments[path],
                                                      want_m[k])):
            got = topo.shard_shape(tuple(leaf.shape), spec)
            assert got == (tuple(want[1:]) if layer else tuple(want)), (
                k, spec, want)
    assert seen == set(want_p)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", [{}, {"compute_bytes": 2},
                                {"activation_bytes": 3e9, "remat": True,
                                 "num_layers": 16},
                                {"offload": True, "compute_bytes": 2}])
def test_predict_memory_equals_jax(stage, kw):
    for fsdp in (1, 2, 4):
        assert tzero.predict_memory_per_device(1_100_048_384, fsdp, stage,
                                               **kw) == \
            jzero.predict_memory_per_device(1_100_048_384, fsdp, stage, **kw)


def test_a_plan_on_the_layer_dim_raises():
    # a stacked [4000, 3] leaf with no rule: stage 3 picks its largest
    # divisible dim, which is the layer dim the port's list cannot split
    tree = {"layers": [{"w": torch.empty(3, device="meta")}
                       for _ in range(4000)]}
    topo = MeshTopology({"fsdp": 4}, world_size=4)
    with pytest.raises(ValueError, match="layer dim"):
        tzero.tree_param_shardings(tree, topo, 3)
    assert set(tzero.tree_param_shardings(tree, topo, 2).values()) == {((),)}


@pytest.mark.parametrize("section", [
    {"parallelism": {"pp": 2}}, {"pipeline": {"stages": 4}},
    {"parallelism": {"ep": 2}}, {"moe": {"expert_parallel_size": 2}},
    {"parallelism": {"sp": 2}}, {"sequence_parallel_size": 2},
    {"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
    {"zero_optimization": {"stage": 3, "zero_quantized_gradients": True}},
    {"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
    {"elasticity": {"enabled": True}},
    # with expert parallelism, ZeRO++ parses (the engine's scope refuses
    # it across ranks) and elasticity is still refused
    {"moe": {"expert_parallel_size": 2}, "zero_optimization": {
        "stage": 3, "zero_quantized_weights": True}},
    {"parallelism": {"ep": 2}, "elasticity": {"enabled": True}},
])
def test_unported_parts_of_distributed_training_raise(section):
    """Elasticity stays refused, naming A.3.1; data, fsdp, tp and MiCS are
    accepted, and so are the pipeline and sequence sizes (A.3.1.1-2), the
    expert sizes (A.3.1.3) and the ZeRO++ flags (A.3.1 item 1), parsed as
    the JAX package parses them."""
    from deepspeedsyclsupport_tpu.runtime.config import ZeroConfig
    from deepspeedsyclsupport_tpu_torch.runtime.config import DSTpuConfig

    d = dict(train_batch_size=8, **section)
    if "zero_optimization" in section:
        got = DSTpuConfig.from_config(d).zeropp
        want = ZeroConfig.from_dict(section["zero_optimization"])
        assert (got.zero_quantized_weights, got.zero_quantized_gradients,
                got.zero_hpz_partition_size) == (
            want.zero_quantized_weights, want.zero_quantized_gradients,
            want.zero_hpz_partition_size)
        assert got.enabled
    unported = "elasticity" in section
    if not unported:
        got = DSTpuConfig.from_config(d).parallelism
        want = JParallelism.from_config_dict(d, 0)
        assert (got.pp, got.sp, got.ep, got.pp_microbatches) == (
            want.pp, want.sp, want.ep, want.pp_microbatches)
        assert max(got.pp, got.sp, got.ep) > 1 or \
            "zero_optimization" in section
        return
    with pytest.raises(NotImplementedError, match=r"A\.3\.1"):
        DSTpuConfig.from_config(d)
    DSTpuConfig.from_config({"train_batch_size": 8, "parallelism": {
        "dp": 2, "fsdp": 2, "tp": 2}, "zero_optimization": {"stage": 3}})
    DSTpuConfig.from_config({"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "mics_shard_size": 2}})


# ---------------------------------------------------------- expert axis
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["tiny-moe", "mixtral-8x7b"])
def test_expert_shard_shapes_equal_jax(name, stage):
    """ep2 x fsdp2 x tp2 on 8 ranks: every leaf's shard shape (params and
    Adam's moments) EQUAL to the JAX plan's, the expert leaves split over
    ``expert`` on their leading dim (moments too: ZeRO-1/2 keep the
    param's expert and TP axes; stage 0 leaves them whole); the memory
    report and prediction count a rank's E / ep experts."""
    jmodel = jax_build_model(name)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    jt = jbuild(dp=1, fsdp=2, tp=2, ep=2, devices=jax.devices()[:8])
    ps = jzero.tree_param_shardings(shapes, jt, stage,
                                    extra_rules=jmodel.sharding_rules)
    opt = jax.eval_shape(optax.adam(1e-3).init, shapes)
    os_ = jzero.tree_optimizer_shardings(opt, shapes, ps, jt, stage)
    want_p = {jax.tree_util.keystr(k): s.shard_shape(v.shape)
              for (k, v), s in zip(
                  jax.tree_util.tree_flatten_with_path(shapes)[0],
                  jax.tree_util.tree_leaves(ps))}
    want_m = {jax.tree_util.keystr(k): s.shard_shape(v.shape)
              for (k, v), s in zip(
                  jax.tree_util.tree_flatten_with_path(opt[0].mu)[0],
                  jax.tree_util.tree_leaves(os_[0].mu))}
    model = build_model(name)
    full = model.init_params(device="meta")
    topo = MeshTopology({"fsdp": 2, "expert": 2, "model": 2}, world_size=8)
    specs = tzero.tree_param_shardings(full, topo, stage,
                                       extra_rules=model.sharding_rules)
    moments = tzero.tree_optimizer_shardings(full, specs, topo, stage)
    e = model.config.num_experts
    for path, leaf in tzero._walk(full):
        k = _key(path)
        layer = path[0] == "layers"
        for spec, want in ((specs[path], want_p[k]), (moments[path],
                                                      want_m[k])):
            got = topo.shard_shape(tuple(leaf.shape), spec)
            assert got == (tuple(want[1:]) if layer else tuple(want)), (
                k, spec, want)
        if tzero.is_expert_leaf(path):
            # stage 0 leaves the moments whole, as the JAX package does
            assert "expert" in specs[path][0] and (
                stage == 0 or "expert" in moments[path][0])
            assert topo.shard_shape(tuple(leaf.shape),
                                    specs[path])[0] == e // 2
    n = sum(int(np.prod(leaf.shape)) for _, leaf in tzero._walk(full))
    experts = tzero.expert_param_count(full)
    assert experts == sum(int(np.prod(leaf.shape))
                          for p, leaf in tzero._walk(full)
                          if p[-1] in ("w_gate", "w_up", "w_down")
                          and "moe" in p)
    mine = n - experts // 2
    msg = tzero.describe_memory_plan(full, topo, stage)
    assert f"{mine / 1e6:.1f}M params" in msg and "expert=2" in msg
    assert tzero.predict_memory_per_device(
        n, 2, stage, expert_params=experts, ep=2) == \
        jzero.predict_memory_per_device(mine, 2, stage)
