"""PyTorch port: the rest of the collectives façade on 8 gloo ranks against
the JAX ``comm`` functions under ``shard_map`` on the suite's 8 host
devices, the same numpy inputs (rank r holds the JAX array's block r):

* ``hierarchical_all_to_all`` at group sizes 1, 2, 4 and 8 and (split,
  concat) axes (0, 0), (1, 0) and (0, 2), EQUAL to the JAX op, and its
  gradient EQUAL to ``jax.grad`` through the JAX op (the inverse
  exchange);
* ``all_to_all(tiled=False)``;
* the root-based ops and aliases: ``reduce``, ``gather``, ``scatter``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``, ``inference_all_reduce``; and the group
  bookkeeping ``get_global_rank``, ``get_world_group``,
  ``get_all_ranks_from_group``;
* the bytes each op hands the comms logger, from the shapes.

The values are small integers in float32, so EQUAL is exact. Also the
``moe.layer.MoE`` compat shim against the JAX package's, in this
process. The ranks run once (``tests/torch_dist_worker.py``).
"""
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import deepspeedsyclsupport_tpu.comm as jdist
from deepspeedsyclsupport_tpu.comm.topology import build_topology
from tests.torch_dist_worker import HIER_SHAPES, launch

N = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_comm_more")
    launch({"kind": "comm_more"}, out, world=N)
    return [dict(np.load(out / f"comm_more_rank{r}.npz")) for r in range(N)]


def _jax(fn, *xs, out_spec=P("data")):
    topo = build_topology(dp=N, devices=jax.devices()[:N])
    return shard_map(fn, mesh=topo.mesh, in_specs=(P("data"),) * len(xs),
                     out_specs=out_spec, check_vma=False)(
        *(jnp.asarray(x) for x in xs))


def _global(case):
    shape = HIER_SHAPES[case]
    return np.arange(N * int(np.prod(shape)), dtype=np.float32).reshape(
        (N * shape[0],) + shape[1:])


def _blocks(a, r):
    n = a.shape[0] // N
    return np.asarray(a)[r * n:(r + 1) * n]


@pytest.mark.parametrize("case", list(HIER_SHAPES),
                         ids=lambda c: "split%d_concat%d" % c)
@pytest.mark.parametrize("gs", [1, 2, 4, 8])
def test_hierarchical_all_to_all(ranks, gs, case):
    sa, ca = case
    x = _global(case)

    def fwd(v):
        return jdist.hierarchical_all_to_all(v, "data", gs, split_axis=sa,
                                             concat_axis=ca)

    y = np.asarray(_jax(fwd, x))
    # the port's weights: arange over the output + 1000 x rank
    w = np.concatenate([np.arange(y.size // N, dtype=np.float32).reshape(
        (y.shape[0] // N,) + y.shape[1:]) + 1000.0 * r for r in range(N)])
    g = np.asarray(_jax(lambda v, wv: jax.grad(
        lambda u: (fwd(u) * wv).sum())(v), x, w))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"hier_{gs}_{sa}{ca}"],
                                      _blocks(y, r))
        np.testing.assert_array_equal(got[f"hier_{gs}_{sa}{ca}_grad"],
                                      _blocks(g, r))


def test_untiled_all_to_all(ranks):
    x = np.concatenate([np.arange(24.0, dtype=np.float32).reshape(8, 3)
                        + 100 * r for r in range(N)])
    want = np.asarray(_jax(lambda v: jdist.all_to_all(
        v, "data", 0, 1, tiled=False), x))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["a2a_untiled"], _blocks(want, r))


ROOTED = {
    "reduce": lambda v: jdist.reduce(v, "data", dst=2),
    "gather": lambda v: jdist.gather(v, "data", dst=1),
    "scatter": lambda v: jdist.scatter(v, "data", src=3)[None],
    "all_gather_into_tensor": lambda v: jdist.all_gather_into_tensor(
        v, "data"),
    "reduce_scatter_tensor": lambda v: jdist.reduce_scatter_tensor(
        v, "data"),
    "all_to_all_single": lambda v: jdist.all_to_all_single(v, "data"),
    "inference_all_reduce": lambda v: jdist.inference_all_reduce(v, "data"),
}


@pytest.mark.parametrize("op", list(ROOTED))
def test_root_based_ops_and_aliases(ranks, op):
    x = np.concatenate([np.arange(16.0, dtype=np.float32).reshape(8, 2)
                        + 100 * r for r in range(N)])
    want = np.asarray(_jax(ROOTED[op], x))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(
            got[op], _blocks(want, r).reshape(got[op].shape))


def test_group_bookkeeping(ranks):
    g = jdist.new_group([2, 5, 7])
    want = {"global_rank": jdist.get_global_rank(g, 1),
            "global_rank_none": jdist.get_global_rank(None, 3),
            "world": jdist.get_all_ranks_from_group(),
            "group": jdist.get_all_ranks_from_group(g),
            "world_group": jdist.get_all_ranks_from_group(
                jdist.get_world_group())}
    assert want["world"] == list(range(N))
    for r in ranks:
        assert json.loads(str(r["books"])) == want


def test_comms_logger_bytes(ranks):
    """Each op's bytes from the shapes: the hierarchical exchange logs its
    input forward and its gradient backward (group sizes 2 and 4; 1 and 8
    are the plain all-to-all), the aliases log as the op they call, the
    monitored barrier 4 bytes under ``world``."""
    f32 = 4
    hier = sum(int(np.prod(s)) * f32 for s in HIER_SHAPES.values())
    want = {"hierarchical_all_to_all[data]": 2 * 2 * hier,
            "all_to_all[data]": 2 * 2 * hier + 24 * f32 + 16 * f32,
            "reduce[data]": 16 * f32, "gather[data]": 16 * f32,
            "scatter[data]": 16 * f32, "all_gather[data]": 16 * f32,
            "reduce_scatter[data]": 16 * f32, "all_reduce[data]": 16 * f32,
            "monitored_barrier[world]": f32}
    for r in ranks:
        assert json.loads(str(r["logger"])) == want


@pytest.mark.parametrize("kw,warned", [
    ({}, []),
    ({"use_residual": True}, ["use_residual"]),
    ({"noisy_gate_policy": "RSample"}, ["noisy_gate_policy"]),
    ({"drop_tokens": False}, ["drop_tokens"]),
    ({"use_residual": True, "noisy_gate_policy": "Jitter",
      "drop_tokens": False},
     ["use_residual", "noisy_gate_policy", "drop_tokens"]),
])
def test_moe_layer_shim_matches_jax(kw, warned, caplog):
    """``moe.layer.MoE``: the same captured fields and ``ModelConfig``
    mapping as the JAX shim, and a warning for each knob without a mapping
    (the same knobs as the JAX shim warns about)."""
    from deepspeedsyclsupport_tpu.moe.layer import MoE as JMoE
    from deepspeedsyclsupport_tpu_torch import moe as tmoe_pkg
    from deepspeedsyclsupport_tpu_torch.moe.layer import MoE as TMoE
    from deepspeedsyclsupport_tpu_torch.parallel import moe as tmoe

    assert tmoe_pkg.layer.moe_mlp is tmoe.moe_mlp
    args = dict(hidden_size=64, num_experts=8, ep_size=2, k=2,
                capacity_factor=1.25, **kw)
    warnings = {}
    for name, cls in (("jax", JMoE), ("port", TMoE)):
        lg = logging.getLogger("dstpu")
        seen = []
        handler = logging.Handler()
        handler.emit = lambda rec, seen=seen: seen.append(rec.getMessage())
        lg.addHandler(handler)
        try:
            m = cls(**args)
        finally:
            lg.removeHandler(handler)
        warnings[name] = seen
        assert (m.hidden_size, m.num_experts, m.ep_size, m.k,
                m.capacity_factor, m.use_residual) == (
            64, 8, 2, 2, 1.25, kw.get("use_residual", False))
        assert m.model_config_kwargs() == {"num_experts": 8,
                                           "num_experts_per_tok": 2,
                                           "capacity_factor": 1.25}
    for name in ("jax", "port"):
        assert len(warnings[name]) == len(warned), warnings
        for knob, msg in zip(warned, warnings[name]):
            assert knob in msg, (knob, msg)
