"""PyTorch port: the collectives façade on 4 gloo ranks against the JAX
``comm`` functions under ``shard_map`` on 4 of the suite's 8 host devices,
the same numpy inputs (rank r holds the JAX array's shard r). The cases are
``tests/unit/test_comm.py``'s: every all-reduce op, all-gather (tiled on
two axes and stacked), reduce-scatter on two axes, all-to-all, the
ppermute ring both ways, the shift without wrap, a partial permutation,
broadcast over NaN, the coalesced variant, a 2-D mesh's single axes and
their pair, the kill switch and the logger's records. Integers exact,
floats 1e-6. The ranks run once (``tests/torch_dist_worker.py``). Also
``init_distributed``'s discovery of a launcher's environment and the
backend rule, in this process.
"""
import json

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
from deepspeedsyclsupport_tpu.comm.comms_logging import comms_logger
from deepspeedsyclsupport_tpu.comm.topology import build_topology
from deepspeedsyclsupport_tpu_torch.comm import comm as tcomm
from tests.torch_dist_worker import launch

X = np.arange(4.0, dtype=np.float32) + 1.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_comm")
    launch({"kind": "comm"}, out)
    return [dict(np.load(out / f"comm_rank{r}.npz")) for r in range(4)]


def _jax(fn, x, in_spec=P("data"), out_spec=P("data"), dims=None):
    """``fn`` under ``shard_map`` on 4 devices ('data' = 4, or the
    ``dims`` (dp, fsdp) mesh); returns the global result."""
    dp, fsdp = dims or (4, 1)
    topo = build_topology(dp=dp, fsdp=fsdp, devices=jax.devices()[:4])
    return np.asarray(shard_map(fn, mesh=topo.mesh, in_specs=in_spec,
                                out_specs=out_spec, check_vma=False)(
        jnp.asarray(x)))


def _per_rank(ranks, key):
    return [r[key] for r in ranks]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_all_reduce_ops(ranks, op):
    want = _jax(lambda v: jdist.all_reduce(v, "data", op=op), X)
    for r, got in enumerate(_per_rank(ranks, f"all_reduce_{op}")):
        _close(got, want[r:r + 1])


def test_all_reduce_prod_and_ints(ranks):
    # the JAX façade has no prod; the product of the shards is numpy's
    for got in _per_rank(ranks, "all_reduce_prod"):
        _close(got, [np.prod(X)])
    xi = np.arange(8, dtype=np.int32)
    want = _jax(lambda v: jdist.all_reduce(v, "data"), xi)
    for r, got in enumerate(_per_rank(ranks, "all_reduce_int")):
        _close(got.astype(np.int32), want[2 * r:2 * r + 2])
    want = _jax(lambda v: jdist.pmean(v, "data"), X)
    for r, got in enumerate(_per_rank(ranks, "pmean")):
        _close(got, want[r:r + 1])


@pytest.mark.parametrize("case,axis,tiled,out_spec", [
    ("all_gather0", 0, True, P(None)),
    ("all_gather1", 1, True, P(None)),
    ("all_gather_stack", 0, False, P(None))])
def test_all_gather(ranks, case, axis, tiled, out_spec):
    g = np.arange(24.0, dtype=np.float32).reshape(12, 2)
    fn = (lambda v: jdist.all_gather(v, "data", axis=axis, tiled=tiled))
    # every rank holds the whole result: read device 0's copy
    topo = build_topology(dp=4, devices=jax.devices()[:4])
    want = np.asarray(shard_map(
        lambda v: fn(v)[None], mesh=topo.mesh, in_specs=P("data"),
        out_specs=P("data"), check_vma=False)(jnp.asarray(g)))[0]
    for got in _per_rank(ranks, case):
        _close(got, want)


@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_scatter(ranks, axis):
    x = np.concatenate([np.arange(32.0, dtype=np.float32).reshape(8, 4)
                        * (r + 1) for r in range(4)])
    out_spec = P("data") if axis == 0 else P(None, "data")
    want = _jax(lambda v: jdist.reduce_scatter(v, "data", axis=axis), x,
                out_spec=out_spec)
    for r, got in enumerate(_per_rank(ranks, f"reduce_scatter{axis}")):
        _close(got, want[2 * r:2 * r + 2] if axis == 0
               else want[:, r:r + 1])


def test_all_to_all(ranks):
    x = np.arange(64.0, dtype=np.float32).reshape(4, 16)
    want = _jax(lambda v: jdist.all_to_all(v, "data", split_axis=1,
                                           concat_axis=0), x,
                in_spec=P("data", None), out_spec=P("data", None))
    for r, got in enumerate(_per_rank(ranks, "all_to_all")):
        _close(got, want[4 * r:4 * r + 4])


@pytest.mark.parametrize("case", ["ring_next", "ring_prev", "shift_next",
                                  "shift_prev", "ppermute"])
def test_ppermute(ranks, case):
    fns = {"ring_next": lambda v: jdist.send_recv_next(v, "data"),
           "ring_prev": lambda v: jdist.send_recv_prev(v, "data"),
           "shift_next": lambda v: jdist.send_recv_next(v, "data",
                                                        wrap=False),
           "shift_prev": lambda v: jdist.send_recv_prev(v, "data",
                                                        wrap=False),
           "ppermute": lambda v: jdist.ppermute(v, "data",
                                                [(0, 2), (2, 0), (1, 3)])}
    want = _jax(fns[case], X)
    for r, got in enumerate(_per_rank(ranks, case)):
        _close(got, want[r:r + 1])


def test_broadcast_masks_nan_and_coalesced(ranks):
    x = np.where(np.arange(4) == 3, 42.0, np.nan).astype(np.float32)
    want = _jax(lambda v: jdist.broadcast(v, "data", src=3), x)
    for r, got in enumerate(_per_rank(ranks, "broadcast")):
        _close(got, want[r:r + 1])
    topo = build_topology(dp=4, devices=jax.devices()[:4])
    a, b = shard_map(lambda v: tuple(jdist.all_reduce_coalesced(
        [v, 2 * v], "data")), mesh=topo.mesh, in_specs=P("data"),
        out_specs=(P("data"), P("data")), check_vma=False)(jnp.asarray(X))
    for r, got in enumerate(_per_rank(ranks, "coalesced")):
        _close(got, [np.asarray(a)[r], np.asarray(b)[r]])


@pytest.mark.parametrize("case,fn", [
    ("mesh_fsdp", lambda v: jdist.all_reduce(v, "fsdp")),
    ("mesh_data", lambda v: jdist.all_reduce(v, "data"))])
def test_two_axis_mesh(ranks, case, fn):
    want = _jax(fn, X, in_spec=P(("data", "fsdp")),
                out_spec=P(("data", "fsdp")), dims=(2, 2))
    for r, got in enumerate(_per_rank(ranks, case)):
        _close(got, want[r:r + 1])
    topo = build_topology(dp=2, fsdp=2, devices=jax.devices()[:4])
    pair = np.asarray(shard_map(
        lambda v: jdist.all_gather(v, ("data", "fsdp"))[None],
        mesh=topo.mesh, in_specs=P(("data", "fsdp")),
        out_specs=P(("data", "fsdp")), check_vma=False)(jnp.asarray(X)))[0]
    for got in _per_rank(ranks, "mesh_both"):
        _close(got, pair)


def test_kill_switch(ranks, monkeypatch):
    monkeypatch.setenv("DSTPU_COMM_ALL_REDUCE_OFF", "1")
    want = _jax(lambda v: jdist.all_reduce(v, "data"), X)
    for r, got in enumerate(_per_rank(ranks, "kill_switch")):
        _close(got, want[r:r + 1])


def test_comms_logger_records(ranks):
    comms_logger.reset()
    comms_logger.configure(enabled=True)
    g = np.arange(24.0, dtype=np.float32).reshape(12, 2)
    topo = build_topology(dp=4, devices=jax.devices()[:4])
    jax.jit(shard_map(lambda v: jdist.all_reduce(v, "data"), mesh=topo.mesh,
                      in_specs=P("data"), out_specs=P("data"),
                      check_vma=False))(jnp.asarray(X))
    jax.jit(shard_map(lambda v: jdist.all_gather(v, "data")[None],
                      mesh=topo.mesh, in_specs=P("data"),
                      out_specs=P("data"), check_vma=False))(jnp.asarray(g))
    want = comms_logger.snapshot()
    comms_logger.configure(enabled=False)
    comms_logger.reset()
    for r in ranks:
        assert json.loads(str(r["logger"])) == want
        assert bool(r["table_has_op"])
        # timed: the call's seconds beside its count and bytes
        timed = json.loads(str(r["timed"]))
        assert (timed["count"], timed["total_bytes"]) == (1, 4)
        assert timed["seconds"] > 0


# ----------------------------------------------------------- bootstrap
@pytest.mark.parametrize("env,want", [
    ({}, {"init_method": None, "world_size": None, "rank": 0,
          "local_rank": 0}),
    ({"MASTER_ADDR": "h0", "MASTER_PORT": "29411", "WORLD_SIZE": "8",
      "RANK": "5", "LOCAL_RANK": "1"},
     {"init_method": "tcp://h0:29411", "world_size": 8, "rank": 5,
      "local_rank": 1}),
    ({"MASTER_ADDR": "h0", "OMPI_COMM_WORLD_SIZE": "4",
      "OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_LOCAL_RANK": "3"},
     {"init_method": "tcp://h0:1234", "world_size": 4, "rank": 3,
      "local_rank": 3}),
    ({"MASTER_ADDR": "h1", "MASTER_PORT": "7", "PMI_SIZE": "2",
      "PMI_RANK": "1"},
     {"init_method": "tcp://h1:7", "world_size": 2, "rank": 1,
      "local_rank": 0}),
    ({"SLURM_NTASKS": "16", "SLURM_PROCID": "9", "SLURM_LOCALID": "1",
      "SLURM_STEP_ID": "0", "SLURM_JOB_NODELIST": "n01,n02"},
     {"init_method": "tcp://n01:29500", "world_size": 16, "rank": 9,
      "local_rank": 1}),
    # an sbatch shell that is not an srun step is one process
    ({"SLURM_NTASKS": "16", "SLURM_PROCID": "0"},
     {"init_method": None, "world_size": None, "rank": 0, "local_rank": 0}),
])
def test_init_distributed_discovers_the_launcher(env, want):
    assert tcomm.discover(env=env) == want


@pytest.mark.parametrize("env,match", [
    ({"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "0"}, "MPI"),
    ({"PMI_SIZE": "4"}, "PMI"),
    ({"SLURM_NTASKS": "4", "SLURM_STEP_ID": "0",
      "SLURM_JOB_NODELIST": "n[01-04]"}, "SLURM")])
def test_launch_without_an_address_raises(env, match):
    with pytest.raises(RuntimeError, match=match):
        tcomm.discover(env=env)


def test_backend_rule_and_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "OMPI_COMM_WORLD_SIZE",
              "PMI_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    assert tcomm.choose_backend("cpu", 4, 0)[0] == "gloo"
    assert tcomm.choose_backend("cuda", 1, 1)[0] == "nccl"
    assert tcomm.choose_backend("cuda", 8, 8)[0] == "nccl"
    # ranks sharing one card: NCCL refuses two ranks on a device
    assert tcomm.choose_backend("cuda", 4, 1)[0] == "gloo"
    # a plain process: nothing to start, and the world is one
    assert tcomm.init_distributed() is False
    assert tcomm.get_world_size() == 1 and tcomm.get_rank() == 0
