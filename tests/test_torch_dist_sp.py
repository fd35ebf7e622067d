"""PyTorch port: 3D parallelism and sequence parallelism over 8 gloo ranks
against the JAX engine on the conftest's 8 host devices, on the CPU: the
``dryrun_multichip`` legs "3d pp2/tp/fsdp2 zero1" (pp2 x fsdp2 x tp2),
"ulysses dp/sp/tp zero1" (dp1 / sp4 / tp2, 8 query heads over 2 KV heads:
the GQA replication up to the lcm) and "ring dp/sp zero0" (dp2 / sp4) with
both inner attentions: ``ring:xla`` (the zigzag body, C = 8) and
``ring:flash`` (one flash call a KV block, merged in LSE space), each held
against the JAX engine running the same ``attn_impl``. The port's Ulysses
runs ``ulysses:flash`` (on the CPU the flash kernels' plain versions)
against the JAX package's ``ulysses`` (its plain inner off a TPU).

Runner, batches, weights and tolerances: ``test_torch_dist_pipe.py``.
"""
import pytest

from tests import test_torch_dist_pipe as base

LEGS = {
    "pp2_fsdp2_tp2_zero1": base.leg(1, dict(dp=1, fsdp=2, tp=2, pp=2),
                                    micro=2, world=8),
    "ulysses_sp4_tp2_zero1": base.leg(1, dict(dp=1, sp=4, tp=2), model_kw={
        "attn_impl": "ulysses:flash", "num_heads": 8}, world=8),
    "ring_xla_dp2_sp4_zero0": base.leg(0, dict(dp=2, sp=4), model_kw={
        "attn_impl": "ring:xla"}, world=8),
    "ring_flash_dp2_sp4_zero0": base.leg(0, dict(dp=2, sp=4), model_kw={
        "attn_impl": "ring:flash"}, world=8),
}
# the JAX engine's attn_impl where it differs from the port's
JAX_MODEL_KW = {"ulysses_sp4_tp2_zero1": {"attn_impl": "ulysses"}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return base.run_ranks(tmp_path_factory, LEGS, 8)


@pytest.mark.parametrize("name", list(LEGS))
def test_leg_matches_jax_engine(ranks, name):
    base.check_leg(ranks[name], LEGS[name], JAX_MODEL_KW.get(name))
