"""PyTorch port: tensor parallelism (dp1 / fsdp2 / tp2 at ZeRO-3), the same
axes at ZeRO-2 in fp16, and MiCS (``mics_shard_size`` 2) over 4 gloo ranks
against the JAX engine on the same 4-device topology, on the CPU: the legs,
tolerances and checks of ``test_torch_dist_train.py``.
"""
import pytest

from tests import test_torch_dist_train as base

MODULE_LEGS = ["dp1_fsdp2_tp2_zero3", "fp16_zero2", "mics2"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return base.run_ranks(tmp_path_factory, MODULE_LEGS)


@pytest.mark.parametrize("name", MODULE_LEGS)
def test_leg_matches_jax_engine(ranks, name):
    base.check_leg(ranks, name)
