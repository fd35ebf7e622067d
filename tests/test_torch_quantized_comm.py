"""PyTorch port: the quantized collectives (``comm/quantized.py``) and
ZeRO++'s gathers and reduces (``runtime/zeropp.py``) on 4 gloo ranks
against the JAX functions under ``shard_map`` on 4 of the conftest's host
devices (mesh axis ``fsdp``), on the CPU.

The ranks are spawned once for every case (``tests/torch_dist_worker.py``
kind ``quant``). Held: each rank's int8 codes and float32 scales EQUAL to
the JAX ``_block_quant`` of the same input (eager, so XLA's folding of
the division by 127 into a product moves no scale); every output within
1e-6 of the JAX function's (the jitted JAX program may round a scale one
ulp away); the plain hierarchical gather EQUAL to the flat one for every
``h``; the logger's bytes for ZeRO++'s leaf gather and reduce EQUAL to the
JAX step's plan (``size + ceil(size / 256) * 4`` a rank for int8).
"""
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deepspeedsyclsupport_tpu.comm import quantized as jq
from deepspeedsyclsupport_tpu.runtime import zeropp as jzpp
from deepspeedsyclsupport_tpu_torch.comm import quantized as tq
from tests.torch_dist_worker import QUANT_SHAPES, launch, quant_input

WORLD = 4
TOL = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("quant")
    launch({"kind": "quant"}, out, world=WORLD)
    return [dict(np.load(out / f"quant_rank{r}.npz")) for r in range(WORLD)]


def _global(name):
    """The ranks' inputs stacked along dim 0 (as ``shard_map`` shards)."""
    return np.concatenate([quant_input(name, r, QUANT_SHAPES[name]).numpy()
                           for r in range(WORLD)])


def _shard_map(fn, x, out_spec=P("fsdp")):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("fsdp",))
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("fsdp"), out_specs=out_spec,
        check_vma=False))(jnp.asarray(x)))


def _per_rank(got, key):
    return [g[key] for g in got]


@pytest.mark.parametrize("name", ["gather", "gather_pad"])
def test_quantized_all_gather_matches_jax(ranks, name):
    for r in range(WORLD):
        x = quant_input(name, r, QUANT_SHAPES[name])
        q, s, pad = tq._block_quant(x, 256)
        jqq, js, jpad = jq._block_quant(jnp.asarray(x.numpy()), 256)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert pad == jpad
    want = _shard_map(lambda v: jq.quantized_all_gather(v, "fsdp"),
                      _global(name))
    m = QUANT_SHAPES[name][0]
    for r, got in enumerate(_per_rank(ranks, name)):
        np.testing.assert_allclose(got, want[r * WORLD * m:(r + 1) * WORLD *
                                             m], rtol=TOL, atol=TOL)
    wb = _shard_map(lambda v: jq.quantized_all_gather(
        v, "fsdp", dtype=jnp.bfloat16).astype(jnp.float32), _global(name))
    np.testing.assert_array_equal(ranks[0][name + "_bf16"],
                                  wb[:WORLD * m])


@pytest.mark.parametrize("name", ["reduce", "reduce_pad"])
def test_all_to_all_quant_reduce_matches_jax(ranks, name):
    x = _global(name)
    per = QUANT_SHAPES[name][0]
    for r in range(WORLD):
        # the codes and scales each rank sends: its chunks, padded
        flat = torch.from_numpy(x[r * per:(r + 1) * per]).reshape(WORLD, -1)
        pad = (-flat.shape[1]) % 256
        flat = torch.cat([flat, flat.new_zeros(WORLD, pad)], dim=1)
        q, s = tq.quantize_int8(flat, 256)
        from deepspeedsyclsupport_tpu.compression.quantize import (
            quantize_int8)

        jqq, js = quantize_int8(jnp.asarray(flat.numpy()), 256)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    want = _shard_map(lambda v: jq.all_to_all_quant_reduce(v, "fsdp"), x)
    m = per // WORLD
    for r, got in enumerate(_per_rank(ranks, name)):
        np.testing.assert_allclose(got, want[r * m:(r + 1) * m], rtol=TOL,
                                   atol=TOL)


def test_sign_compress_and_compressed_allreduce_match_jax(ranks):
    x = np.array([[-1.5, 0.0, 2.0], [0.25, -0.0, -3.0]], np.float32)
    got = tq.sign_compress(torch.from_numpy(x))
    want = jq.sign_compress(jnp.asarray(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int8 and int(got[0][0, 1]) == 1
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=TOL, atol=TOL)
    xs, es = _global("onebit"), np.concatenate([
        0.1 * quant_input("onebit_err", r, QUANT_SHAPES["onebit"]).numpy()
        for r in range(WORLD)])
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("fsdp",))
    avg, err = jax.jit(jax.shard_map(
        lambda a, e: jq.compressed_allreduce(a, e, "fsdp"), mesh=mesh,
        in_specs=(P("fsdp"), P("fsdp")), out_specs=(P("fsdp"), P("fsdp")),
        check_vma=False))(jnp.asarray(xs), jnp.asarray(es))
    n = QUANT_SHAPES["onebit"][0]
    for r, g in enumerate(ranks):
        np.testing.assert_allclose(g["onebit"], np.asarray(avg)[
            r * n:(r + 1) * n], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g["onebit_err"], np.asarray(err)[
            r * n:(r + 1) * n], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h", [1, 2, 4])
def test_hierarchical_all_gather(ranks, h):
    """Plain: EQUAL to the flat gather (hpZ only moves data); quantized:
    the JAX two-hop gather's values (int8 blocks of the secondary
    shards)."""
    x = _global("hier")
    m = QUANT_SHAPES["hier"][0]
    for r, g in enumerate(ranks):
        np.testing.assert_array_equal(g[f"hier_{h}_0"], x)
    want = _shard_map(partial(jzpp.hierarchical_all_gather, n=WORLD, h=h,
                              quantized=True, group_size=256), x)
    for r, g in enumerate(ranks):
        np.testing.assert_allclose(g[f"hier_{h}_1"],
                                   want[r * WORLD * m:(r + 1) * WORLD * m],
                                   rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ranks[0]["leaf_gather"],
                                  ranks[0]["hier_2_1"])
    np.testing.assert_array_equal(ranks[0]["leaf_gather_plain"], x)


def test_leaf_reduce_and_logged_bytes(ranks):
    x = _global("reduce")
    per = QUANT_SHAPES["reduce"][0]
    m = per // WORLD
    chunks = x.reshape(WORLD, per, -1)
    for r, g in enumerate(ranks):
        np.testing.assert_array_equal(g["leaf_reduce"], g["reduce"])
        np.testing.assert_allclose(
            g["leaf_reduce_plain"], chunks[:, r * m:(r + 1) * m].mean(0),
            rtol=TOL, atol=TOL)
    gather = int(np.prod(QUANT_SHAPES["hier"]))
    reduce = int(np.prod(QUANT_SHAPES["reduce"]))
    plan = {"zeropp_gather_int8[fsdp]": (gather + -(-gather // 256) * 4)
            * WORLD,
            "zeropp_gather[fsdp]": gather * 4 * WORLD,
            "zeropp_reduce_int8[fsdp]": reduce + -(-reduce // 256) * 4,
            "zeropp_reduce[fsdp]": reduce * 4}
    for g in ranks:
        assert json.loads(str(g["logger"])) == plan
