"""PyTorch port: the data loaders against the JAX package's, on the CPU.

The same datasets (numpy, from a seed) through both packages' loaders:
the batches each yields, in order, across epochs, with and without
prefetch and shuffling, are EQUAL, and so are their ``state_dict``s after
every batch; a saved position resumes both on the same batch; a rewind of
``CheckpointableDataLoader`` takes effect on the very next batch.
``initialize(training_data=...)`` returns the loader it registers, and its
position rides the checkpoint meta as the JAX engine writes it.
"""
import json

import jax
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.comm.topology import build_topology
from deepspeedsyclsupport_tpu.runtime import dataloader as jdl
from deepspeedsyclsupport_tpu_torch import build_model
from deepspeedsyclsupport_tpu_torch.runtime import dataloader as tdl
from deepspeedsyclsupport_tpu_torch.runtime.engine import initialize
from tests.test_torch_train import ENGINE_CFG

TOPO = None


def _topo():
    global TOPO
    if TOPO is None:
        TOPO = build_topology(dp=1, devices=jax.devices()[:1])
    return TOPO


def _data(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(2, 4)).astype(np.float32),
             "ids": rng.integers(0, 9, (2, 3)).astype(np.int32)}
            for _ in range(n)]


def _np(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor)
                else np.asarray(jax.device_get(v))) for k, v in batch.items()}


def _lockstep(a, b):
    """Pairs of batches from two iterables, which must end together."""
    ia, ib = iter(a), iter(b)
    while True:
        xa, xb = next(ia, None), next(ib, None)
        assert (xa is None) == (xb is None)
        if xa is None:
            return
        yield xa, xb


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_generator_loader_order_and_state_match_jax(prefetch):
    data = _data()
    j = jdl.DSTpuDataLoader(data, _topo(), prefetch=prefetch)
    t = tdl.DSTpuDataLoader(data, "cpu", prefetch=prefetch)
    assert len(t) == len(j) == 6
    for _epoch in range(2):
        for jb, tb in _lockstep(j, t):
            _same(jb, tb)
            assert t.state_dict() == j.state_dict()
            assert t.position == j.position
        assert t.state_dict() == j.state_dict() == {"epoch": _epoch + 1,
                                                    "offset": 0}


def test_generator_loader_fast_forwards_on_resume():
    data = _data()
    src = tdl.DSTpuDataLoader(data, "cpu", prefetch=0)
    it = iter(src)
    for _ in range(3):
        next(it)
    sd = src.state_dict()
    assert sd == {"epoch": 0, "offset": 3}
    for resumed in (tdl.DSTpuDataLoader(data, "cpu", prefetch=0),
                    jdl.DSTpuDataLoader(data, _topo(), prefetch=0)):
        resumed.load_state_dict(sd)
        # the batch the saved run would have trained next, not a replay
        np.testing.assert_array_equal(_np(next(iter(resumed)))["x"],
                                      data[3]["x"])


def test_loader_copies_and_applies_batch_fn():
    data = _data(2)
    t = tdl.DSTpuDataLoader(data, "cpu", prefetch=0,
                            batch_fn=lambda b: {"x": b["x"] * 2})
    got = next(iter(t))
    np.testing.assert_array_equal(got["x"].numpy(), data[0]["x"] * 2)
    got["x"].add_(1.0)          # a copy: the dataset is untouched
    np.testing.assert_array_equal(next(iter(
        tdl.DSTpuDataLoader(data, "cpu", prefetch=0)))["x"].numpy(),
        data[0]["x"])
    gen = tdl.DSTpuDataLoader((b for b in data), "cpu", prefetch=0)
    with pytest.raises(TypeError):
        len(gen)


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 7), (True, 8)])
def test_checkpointable_order_and_state_match_jax(shuffle, seed):
    data = _data(5)
    j = jdl.CheckpointableDataLoader(data, _topo(), shuffle=shuffle,
                                     seed=seed)
    t = tdl.CheckpointableDataLoader(data, "cpu", shuffle=shuffle, seed=seed)
    for epoch in range(3):
        np.testing.assert_array_equal(t._order(epoch), j._order(epoch))
        for jb, tb in _lockstep(j, t):
            _same(jb, tb)
            assert t.state_dict() == j.state_dict()
    if shuffle:
        assert not np.array_equal(t._order(0), t._order(1))


def test_checkpointable_rewinds_mid_iteration_like_jax():
    data = _data(5)
    loaders = (jdl.CheckpointableDataLoader(data, _topo(), shuffle=True,
                                            seed=3),
               tdl.CheckpointableDataLoader(data, "cpu", shuffle=True,
                                            seed=3))
    got = []
    for loader in loaders:
        it = iter(loader)
        for _ in range(4):
            next(it)
        loader.load_state_dict({"epoch": 0, "offset": 1, "seed": 3})
        got.append((next(it), loader.position, loader.state_dict()))
    _same(got[0][0], got[1][0])
    assert got[0][1:] == got[1][1:] == (2, {"epoch": 0, "offset": 2,
                                            "shuffle": True, "seed": 3})
    with pytest.raises(TypeError):
        tdl.CheckpointableDataLoader(iter([]), "cpu")


def test_repeating_loader_restarts():
    data = _data(2)
    r = tdl.RepeatingLoader(tdl.CheckpointableDataLoader(data, "cpu"))
    xs = [_np(next(r))["x"] for _ in range(5)]
    for i, x in enumerate(xs):
        np.testing.assert_array_equal(x, data[i % 2]["x"])


def test_initialize_registers_the_loader_and_saves_its_position(tmp_path):
    rng = np.random.RandomState(0)
    data = [{"input_ids": rng.randint(0, 512, (4, 32)).astype(np.int32)}
            for _ in range(5)]
    eng, _, loader, _ = initialize(model=build_model("tiny"),
                                   config=ENGINE_CFG, training_data=data,
                                   device="cpu")
    assert isinstance(loader, tdl.DSTpuDataLoader)
    assert eng._dataloader is loader and loader.prefetch == 2
    loader.prefetch = 0                 # exact positions (see the module)
    it = iter(loader)
    for _ in range(3):
        eng.train_batch(next(it))
    path = eng.save_checkpoint(str(tmp_path))
    with open(f"{path}/dstpu_meta.json") as f:
        assert json.load(f)["dataloader"] == {"epoch": 0, "offset": 3}
    fresh, _, loader2, _ = initialize(model=build_model("tiny"),
                                      config=ENGINE_CFG, training_data=data,
                                      device="cpu")
    loader2.prefetch = 0
    fresh.load_checkpoint(str(tmp_path))
    assert loader2.state_dict() == {"epoch": 0, "offset": 3}
    np.testing.assert_array_equal(next(iter(loader2))["input_ids"].numpy(),
                                  data[3]["input_ids"])
