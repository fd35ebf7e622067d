"""PyTorch port: tensor parallelism (dp1 / fsdp2 / tp2 at ZeRO-3), the same
axes at ZeRO-2 in fp16, MiCS (``mics_shard_size`` 2), biases under TP and
custom losses over 4 gloo ranks against the JAX engine on the same
4-device topology, on the CPU: the legs, tolerances and checks of
``test_torch_dist_train.py``.

* ``tp2_dp2_bias``: ``tiny`` with ``use_bias`` and the two-matrix MLP, its
  biases seeded non-zero; ``bq`` / ``bk`` / ``bv`` / ``b1`` cut to the rank's
  columns, ``bo`` / ``b2`` added once after the reduce: loss 1e-5,
  grad_norm 1e-4, params (biases included) 1e-5.
* ``custom_rowmean_zero3``: a closure over the caller's model (a mean over
  rows: no token is masked) at dp2 x fsdp2 ZeRO-3, each rank's value on its
  rows averaged over the ranks: as the JAX engine's on the global batch.
* ``custom_bound_tp2``: a subclass's ``loss`` (twice the model's) under
  tp2, rebound to the engine's parallel view.
* a closure under tp2, and a vocabulary tp does not divide, raise at
  ``initialize`` with messages that say why; ``custom_weighted_zero3``
  (the loss times the rows' mean weight: no mean over rows) departs from
  the JAX engine by design, and equals the mean over the ranks of each
  rank's own value (ROADMAP.md §C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import test_torch_dist_train as base

MODULE_LEGS = ["dp1_fsdp2_tp2_zero3", "fp16_zero2", "mics2", "tp2_dp2_bias",
               "custom_rowmean_zero3", "custom_bound_tp2"]
WEIGHTED = "custom_weighted_zero3"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return base.run_ranks(tmp_path_factory, MODULE_LEGS + [WEIGHTED],
                          configs=base.TP_SCOPE)


@pytest.mark.parametrize("name", MODULE_LEGS)
def test_leg_matches_jax_engine(ranks, name):
    base.check_leg(ranks, name)


def test_closure_loss_under_tp_raises_why(ranks):
    """A closure loss under tp2 raises with module 3's message; so does a
    vocabulary of 511 rows (the plan would leave it whole, and the
    vocab-parallel lookup and loss would read it as a shard)."""
    for msgs in ranks["scope"]:
        closure, vocab = msgs
        assert closure.startswith("NotImplementedError"), closure
        assert "must be a bound method of the model" in closure
        assert "no parallel plan" in closure and "['model']" in closure
        assert vocab.startswith("ValueError"), vocab
        assert "must divide the 511 rows of the vocabulary" in vocab


def test_weighted_loss_is_the_mean_of_the_ranks_values(ranks):
    """Each rank's value on its rows (gas 2: micro-batch ``i``'s row ``4 i
    + c`` on batch rank ``c``), averaged over ranks and micro-batches: the
    port's first loss; the JAX engine's global loss differs."""
    got = ranks[WEIGHTED]
    for r in got:
        np.testing.assert_array_equal(r["steps"], got[0]["steps"])
    jmodel, params = base._jax_params("float32")
    b = base._batches(False, True)[0]
    p = jax.tree.map(jnp.asarray, params)

    def lm(rows):
        return float(jmodel.loss(p, {"input_ids": jnp.asarray(
            b["input_ids"][rows])}, None, train=True)[0])

    mine = np.mean([np.mean([lm([4 * i + c]) * b["weight"][4 * i + c]
                             for c in range(4)]) for i in range(2)])
    np.testing.assert_allclose(got[0]["steps"][0, 0], mine, rtol=1e-5)
    jax_global = np.mean([lm(list(range(4 * i, 4 * i + 4)))
                          * b["weight"][4 * i:4 * i + 4].mean()
                          for i in range(2)])
    assert abs(got[0]["steps"][0, 0] - jax_global) > 1e-3 * jax_global
