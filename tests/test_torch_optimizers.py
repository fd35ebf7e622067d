"""PyTorch port: the optimizers beyond Adam against the JAX package's
``build_optimizer``, on the CPU.

Every type of the JAX package's list (Lamb, Lion, SGD with momentum,
Adagrad and the 1-bit family) steps the ``tiny`` model's params (the JAX
tree, layers stacked ``[L, ...]``; the port's engine holds them as a list
of layers) on the same numpy gradients for 5 steps under a warmup
schedule: the 1-bit ones cross their freeze step (0/1 Adam through its
variance steps, a 1-bit gradient step, the freeze, a sync and a local
step). The port's update runs through its engine at world 1, so a
whole-leaf statistic (Lamb's norms, the 1-bit scales, 1-bit LAMB's maxima)
is taken over the stacked leaf's layers together (``LeafStats``).

Held: the params after 5 steps, and the state the port would checkpoint
(``Engine._state_tree``), against the JAX ``opt_state`` leaf for leaf:
the same leaf names, dtypes and shapes, values within 1e-6 (float32 on
both sides; the order of the sums and of the elementwise ops differs);
the learning rate each injected optimizer reports. Then a state the JAX
package wrote after 3 steps resumes in the port (``engine_state_from_jax``
-> ``load_engine_state``) and the last 2 steps agree again.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.runtime import lr_schedules as jsched
from deepspeedsyclsupport_tpu.runtime import optimizers as jopt
from deepspeedsyclsupport_tpu_torch import (build_model, engine_state_from_jax,
                                            params_from_jax)
from deepspeedsyclsupport_tpu_torch.checkpoint.engine import _flatten
from deepspeedsyclsupport_tpu_torch.runtime import engine as teng
from deepspeedsyclsupport_tpu_torch.runtime import optimizers as topt

STEPS = 5
RESUME_AT = 3
WARMUP = dict(warmup_min_lr=1e-3, warmup_max_lr=1e-2, warmup_num_steps=4)
CASES = {
    "lamb": ("Lamb", {"weight_decay": 0.01,
                      "no_decay_patterns": ["scale"]}),
    "fusedlamb": ("FusedLamb", {"betas": [0.9, 0.95], "eps": 1e-6}),
    "lion": ("Lion", {"weight_decay": 0.1}),
    "fusedlion": ("FusedLion", {"weight_decay": 0.1, "betas": [0.9, 0.99],
                                "no_decay_patterns": ["lm_head/"]}),
    "sgd": ("SGD", {"momentum": 0.9}),
    "adagrad": ("Adagrad", {"eps": 1e-7}),
    "onebitadam": ("OneBitAdam", {"freeze_step": 2, "weight_decay": 0.01}),
    "zerooneadam": ("ZeroOneAdam", {"var_freeze_step": 3,
                                    "var_update_scaler": 1,
                                    "local_step_scaler": 1,
                                    "local_step_clipper": 2,
                                    "weight_decay": 0.01}),
    "onebitlamb": ("OneBitLamb", {"freeze_step": 2, "weight_decay": 0.01}),
}
TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _jax_tree():
    jmodel = jax_build_model("tiny", dtype="float32")
    return jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(7)))


def _jax_params():
    """One init for every case; each gets its own copy (the port's engine
    may hold the arrays' memory and step them in place)."""
    return jax.tree.map(np.copy, _jax_tree())


@functools.lru_cache(maxsize=None)
def _grads(seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (0.1 * rng.randn(*x.shape)).astype(
        np.float32), _jax_tree())


def _engine(kind, params, np_tree):
    model = build_model("tiny", dtype="float32")
    cfg = {"train_batch_size": 2, "steps_per_print": 1000,
           "optimizer": {"type": kind, "params": dict(lr=1e-2, **params)},
           "scheduler": {"type": "WarmupLR", "params": WARMUP}}
    eng = teng.initialize(model=model, config=cfg, device="cpu",
                          params=params_from_jax(np_tree, model.config,
                                                 device="cpu"))[0]
    return eng


def _port_grads(eng, tree):
    vals = eng._unlayout(tree)
    return [torch.from_numpy(np.array(vals[i])) for i in eng._float_pos]


def _resolved(tree):
    return teng._tree_map(lambda x: x() if callable(x) else x, tree)


def _by_name(tree):
    return {"/".join(str(k) for k in path): np.asarray(
        leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf)
        for path, leaf in _flatten(tree)}


def _hold_state(eng, state, jp, where):
    got = _resolved(eng._state_tree())
    gp, wp = _by_name(got["params"]), _by_name(jp)
    assert set(gp) == set(wp)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{where}: params {k}")
    gs, ws = _by_name(got["opt_state"]), _by_name(
        jax.tree.map(np.asarray, state))
    assert set(gs) == set(ws), (where, sorted(set(gs) ^ set(ws)))
    for k in ws:
        assert gs[k].dtype == ws[k].dtype and gs[k].shape == ws[k].shape, (
            where, k, gs[k].dtype, ws[k].dtype, gs[k].shape, ws[k].shape)
        np.testing.assert_allclose(gs[k], ws[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{where}: opt_state {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax_and_resumes(case):
    kind, params = CASES[case]
    np_tree = _jax_params()
    tx = jopt.build_optimizer(kind, dict(lr=1e-2, **params),
                              jsched.build_schedule("WarmupLR", WARMUP, 1e-2))
    jp = jax.tree.map(jnp.asarray, np_tree)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    eng = _engine(kind, params, np_tree)
    injected = eng.optimizer.injected
    saved = None
    for step in range(STEPS):
        g = _grads(50 + step)
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        eng.optimizer.step(_port_grads(eng, g))
        if injected:
            assert topt.current_lr(eng.optimizer) == pytest.approx(
                float(jopt.current_lr(state)), rel=1e-6)
        if step + 1 == RESUME_AT:
            saved = (jax.tree.map(np.asarray, state),
                     jax.tree.map(np.asarray, jp))
    _hold_state(eng, state, jp, f"{case} after {STEPS} steps")

    # a JAX-written state (after RESUME_AT steps) resumes in the port
    res = _engine(kind, params, np_tree)
    res.load_engine_state(engine_state_from_jax(
        saved[0], teng._host_scaler(res.scaler_state)), params=saved[1])
    assert res.optimizer.count == RESUME_AT
    for step in range(RESUME_AT, STEPS):
        res.optimizer.step(_port_grads(res, _grads(50 + step)))
    _hold_state(res, state, jp, f"{case} resumed at {RESUME_AT}")


def test_leaf_stats_sum_the_pieces_of_a_leaf():
    """A stacked leaf's layers are one leaf: Lamb's trust ratio on the
    port's per-layer tensors is the whole leaf's (the engine's LeafStats),
    not each layer's."""
    np_tree = _jax_params()
    eng = _engine("Lamb", {}, np_tree)
    st = eng.optimizer.stats
    paths = [p for p, _ in teng._leaves(eng.params)]
    wq = [i for i, j in enumerate(eng._float_pos)
          if paths[j] == ("layers", "attn", "wq")]
    assert len(wq) == 2 and st.group[wq[0]] == st.group[wq[1]]
    assert st.sizes[st.group[wq[0]]] == np_tree["layers"]["attn"]["wq"].size
    parts = [torch.tensor(float(i + 1)) for i in range(len(st.group))]
    sums = st.sum(parts)
    assert float(sums[st.group[wq[0]]]) == wq[0] + wq[1] + 2
    assert float(st.max(parts)[st.group[wq[0]]]) == max(wq) + 1


def test_onebit_family_refuses_no_decay_patterns():
    for kind in ("OneBitAdam", "ZeroOneAdam", "OneBitLamb"):
        with pytest.raises(ValueError, match="no_decay_patterns"):
            topt.build_optimizer(kind, {"no_decay_patterns": ["bias"]})
        with pytest.raises(ValueError, match="no_decay_patterns"):
            jopt.build_optimizer(kind, {"no_decay_patterns": ["bias"]})
