"""PyTorch port: the pipeline's and sequence parallelism's host-side parts
against the JAX package's, in one process.

* ``TrainSchedule`` / ``InferenceSchedule``: every stage's instruction
  stream EQUAL to the JAX package's for 1-4 stages x 1-8 micro-batches;
  ``partition_balanced`` / ``partition_uniform`` EQUAL; ``PipelineModule``
  refuses what the JAX one refuses.
* The plan under a pipeline: for ``tiny`` (4 layers at pp4) and ``small``,
  pp2 / pp4 meshes and ZeRO stages 0-3, every rank's layers are its
  stage's block and each leaf's param and moment shard shape EQUALS
  ``NamedSharding.shard_shape`` of the JAX stacked leaf (layer dim: the
  block's length; JAX keeps stage-0 moments whole over ``pipe``, so a
  moment's layer dim is compared from stage 1).
* The zigzag plan of ring attention EQUAL for n = 2..8, and a corrupted
  matching raises ``ValueError`` (the JAX package asserts).
* The refusals kept under a pipeline (random-LTD, progressive layer drop,
  ``scan_layers=False``, layers that do not divide), and the attention
  seam's: ``ring`` with ``segment_ids``, ALiBi or a window under ``ring`` /
  ``ulysses``. With no ``seq`` axis both run the local attention, equal
  to the plain path.
* The loader: every ``pipe`` and ``seq`` rank of a (data, fsdp)
  coordinate reads the same rows.
"""
import importlib

import jax
import numpy as np
import optax
import pytest
import torch

from deepspeedsyclsupport_tpu.comm.topology import build_topology as jbuild
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.parallel import pipeline as jpipe
from deepspeedsyclsupport_tpu.runtime import zero as jzero
from deepspeedsyclsupport_tpu_torch import build_model
from deepspeedsyclsupport_tpu_torch.comm.topology import (
    MeshTopology, reset_world_topology)
from deepspeedsyclsupport_tpu_torch.models import layers as tl
from deepspeedsyclsupport_tpu_torch.parallel import pipeline as tpipe
from deepspeedsyclsupport_tpu_torch.parallel import ring_attention as tring
from deepspeedsyclsupport_tpu_torch.runtime import zero as tzero

jring = importlib.import_module(
    "deepspeedsyclsupport_tpu.parallel.ring_attention")


@pytest.fixture(autouse=True)
def _fresh_port_topology():
    yield
    reset_world_topology()


# ------------------------------------------------------------- schedules
def _stream(sched):
    return [[(type(c).__name__, c.kwargs) for c in step]
            for step in sched.steps()]


@pytest.mark.parametrize("kind", ["TrainSchedule", "InferenceSchedule"])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_schedules_equal_jax(kind, stages):
    for micro in range(1, 9):
        for stage in range(stages):
            got = getattr(tpipe, kind)(micro, stages, stage)
            want = getattr(jpipe, kind)(micro, stages, stage)
            assert _stream(got) == _stream(want), (micro, stage)
            assert got.num_pipe_buffers() == want.num_pipe_buffers()
            assert (got.is_first_stage, got.is_last_stage) == (
                want.is_first_stage, want.is_last_stage)
    with pytest.raises(ValueError, match="stage_id"):
        getattr(tpipe, kind)(2, stages, stages)


def test_partitions_equal_jax():
    rng = np.random.RandomState(0)
    for n in range(1, 13):
        for parts in range(1, n + 1):
            w = rng.rand(n).tolist()
            assert tpipe.partition_balanced(w, parts) == \
                jpipe.partition_balanced(w, parts)
            assert tpipe.partition_uniform(n, parts) == \
                jpipe.partition_uniform(n, parts)
    for mod in (tpipe, jpipe):
        with pytest.raises(ValueError, match="cannot split"):
            mod.partition_balanced([1.0, 2.0], 3)


def test_pipeline_module_refuses_as_jax():
    jtopo = jbuild(pp=2, devices=jax.devices()[:2])
    ttopo = MeshTopology({"pipe": 2}, world_size=2)
    for mod, topo in ((jpipe, jtopo), (tpipe, ttopo)):
        with pytest.raises(NotImplementedError, match="uniform"):
            mod.PipelineModule(lambda p, h: h, 4, topo,
                               partition_method="parameters")
        with pytest.raises(ValueError, match="divide evenly"):
            mod.PipelineModule(lambda p, h: h, 3, topo)
        assert mod.PipelineModule(lambda p, h: h, 4, topo).parts == [0, 2, 4]
    # a world of one runs the stack as it is
    one = tpipe.PipelineModule(lambda p, h: h * p, 2,
                               MeshTopology({}, world_size=1),
                               embed_fn=lambda e, x: x + e, remat=False)
    out = one({"embed": 1.0, "layers": [2.0, 3.0]}, torch.ones(2, 3))
    assert torch.equal(out, torch.full((2, 3), 12.0))


# ------------------------------------------------------------- the plan
PIPE_MESHES = [(2, 4, 1), (4, 2, 1), (2, 2, 2)]


def _jax_plan(name, mesh, stage, layers):
    pp, fsdp, tp = mesh
    jmodel = jax_build_model(name, pipe_stages=pp, **layers)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    topo = jbuild(dp=1, fsdp=fsdp, tp=tp, pp=pp, devices=jax.devices()[:8])
    ps = jzero.tree_param_shardings(shapes, topo, stage,
                                    extra_rules=jmodel.sharding_rules)
    opt = jax.eval_shape(optax.adam(1e-3).init, shapes)
    os_ = jzero.tree_optimizer_shardings(opt, shapes, ps, topo, stage)

    def shard_shapes(tree, shardings):
        return {jax.tree_util.keystr(k): s.shard_shape(v.shape)
                for (k, v), s in zip(
                    jax.tree_util.tree_flatten_with_path(tree)[0],
                    jax.tree_util.tree_leaves(shardings))}

    return shard_shapes(shapes, ps), shard_shapes(opt[0].mu, os_[0].mu)


def _key(path):
    return "".join(f"['{n}']" for n in path if not isinstance(n, int))


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("mesh", PIPE_MESHES,
                         ids=lambda m: "pp%d_fsdp%d_tp%d" % m)
@pytest.mark.parametrize("name", ["tiny", "small"])
def test_pipe_shard_shapes_equal_jax(name, mesh, stage):
    pp, fsdp, tp = mesh
    layers = {"num_layers": 4} if name == "tiny" else {}
    want_p, want_m = _jax_plan(name, mesh, stage, layers)
    model = build_model(name, pipe_stages=pp, **layers)
    whole = model.init_params(device="meta")
    n_layers = len(whole["layers"])
    topo = MeshTopology({"pipe": pp, "fsdp": fsdp, "model": tp},
                        world_size=8)
    for rank in range(8):
        full = tzero.stage_tree(whole, topo, rank)
        s = topo.coords(rank)["pipe"]
        block = n_layers // pp
        assert [id(p) for p in full["layers"]] == [
            id(p) for p in whole["layers"][s * block:(s + 1) * block]]
        specs = tzero.tree_param_shardings(
            full, topo, stage, extra_rules=model.sharding_rules,
            n_layers=n_layers)
        moments = tzero.tree_optimizer_shardings(full, specs, topo, stage,
                                                 n_layers=n_layers)
        seen = set()
        for path, leaf in tzero._walk(full):
            k = _key(path)
            seen.add(k)
            layer = path[0] == "layers"
            for spec, want, kind in ((specs[path], want_p[k], "param"),
                                     (moments[path], want_m[k], "moment")):
                got = topo.shard_shape(tuple(leaf.shape), spec)
                assert got == (tuple(want[1:]) if layer else tuple(want)), (
                    k, kind, spec, want)
                if layer and (kind == "param" or stage >= 1):
                    assert want[0] == len(full["layers"]), (k, kind, want)
        assert seen == set(want_p)


def test_a_plan_off_pipe_on_the_layer_dim_raises():
    # a stacked [4000, 3] leaf with no rule: stage 3 picks its largest
    # divisible dim, the layer dim, over fsdp: not a layout of the list
    tree = {"layers": [{"w": torch.empty(3, device="meta")}
                       for _ in range(4000)]}
    topo = MeshTopology({"pipe": 2, "fsdp": 4}, world_size=8)
    with pytest.raises(ValueError, match="pipe alone"):
        tzero.tree_param_shardings(tree, topo, 3)
    with pytest.raises(ValueError, match="divide evenly"):
        tzero.layer_block(3, topo)
    assert tzero.layer_block(4000, topo, rank=5) == (2000, 4000)


def test_memory_plan_names_the_stage_block():
    model = build_model("small", pipe_stages=2)
    whole = model.init_params(device="meta")
    topo = MeshTopology({"pipe": 2, "fsdp": 4}, world_size=8)
    msg = tzero.describe_memory_plan(whole, topo, 3)
    assert "pipe stage 0 of 2 holds layers 0-3 of 8" in msg
    flat = MeshTopology({"fsdp": 8}, world_size=8)
    assert "pipe" not in tzero.describe_memory_plan(whole, flat, 3)


# ------------------------------------------------------------- ring plan
@pytest.mark.parametrize("n", range(2, 9))
def test_zigzag_plan_equal_jax(n):
    assert tring._zigzag_plan(n) == jring._zigzag_plan(n)


def test_zigzag_plan_raises_on_a_bad_matching():
    n = 3
    edges = [{"chunk": h, "src": h // 2, "front": h % 2 == 0,
              "dst": h if h < n else 2 * n - 1 - h, "lo": h < n}
             for h in range(2 * n)]
    color = tring._two_color(edges)
    tring._pack(edges, color, n, "src", "dst", "front", "lo")
    bad = [0] * len(color)
    with pytest.raises(ValueError, match="bad matching"):
        tring._pack(edges, bad, n, "src", "dst", "front", "lo")


# ------------------------------------------------------------- refusals
def test_refusals_kept_under_a_pipeline():
    ids = torch.tensor([[1, 2, 3, 4]])
    model = build_model("tiny", dtype="float32", pipe_stages=2)
    params = model.init_params(device="cpu")
    plain = build_model("tiny", dtype="float32")
    # called directly, the pipelined model runs its layers in order: the
    # pipeline's function
    assert torch.equal(model.apply(params, ids), plain.apply(params, ids))
    for over, what in (({"random_ltd": True}, "random-LTD"),
                       ({"scan_layers": False}, "scan_layers=True")):
        m = build_model("tiny", dtype="float32", pipe_stages=2, **over)
        with pytest.raises(ValueError, match=what):
            m.loss(params, {"input_ids": ids})
    with pytest.raises(ValueError, match="progressive layer"):
        model.loss(params, {"input_ids": ids, "pld_theta": 0.5})


def _qkv(seed=0, b=2, s=16, h=4, kvh=2, d=8):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
            for n in (h, kvh, kvh)]


def test_sequence_parallel_seam():
    q, k, v = _qkv()
    seg = torch.zeros(2, 16, dtype=torch.int32)
    for impl in ("ring", "ring:flash", "ring:xla"):
        with pytest.raises(ValueError, match="segment_ids"):
            tl.attention(q, k, v, impl=impl, segment_ids=seg)
    for impl in ("ring", "ulysses:flash"):
        with pytest.raises(NotImplementedError, match="alibi"):
            tl.attention(q, k, v, impl=impl, window=4)
        with pytest.raises(NotImplementedError, match="alibi"):
            tl.attention(q, k, v, impl=impl, alibi=torch.ones(4))
    # no seq axis: the local attention, equal to the plain path
    want = tl.attention(q, k, v, impl="xla")
    for impl in ("ring", "ring:flash", "ring:xla", "ulysses",
                 "ulysses:flash", "ulysses:xla"):
        torch.testing.assert_close(tl.attention(q, k, v, impl=impl), want,
                                   atol=2e-5, rtol=2e-5)


def test_loader_rows_shared_by_pipe_and_seq_ranks():
    """Every pipe rank and every seq rank of a (data, fsdp) coordinate
    reads the same rows (the engine cuts the sequence after the labels
    shift); the rows depend on (data, fsdp) alone."""
    from deepspeedsyclsupport_tpu_torch.runtime.dataloader import rank_rows

    topo = MeshTopology({"pipe": 2, "data": 2, "fsdp": 2, "seq": 2},
                        world_size=16)
    x = np.arange(16 * 3).reshape(16, 3)
    by_coord = {}
    for r in range(16):
        c = topo.coords(r)
        rows = rank_rows(x, topo, gas=2, rank=r)
        key = (c["data"], c["fsdp"])
        if key in by_coord:
            assert np.array_equal(rows, by_coord[key])
        by_coord[key] = rows
    flat = MeshTopology({"data": 2, "fsdp": 2}, world_size=4)
    for r in range(4):
        c = flat.coords(r)
        assert np.array_equal(rank_rows(x, flat, gas=2, rank=r),
                              by_coord[(c["data"], c["fsdp"])])
