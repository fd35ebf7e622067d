"""PyTorch port: MoE training through the capacity path
(``parallel/moe.py`` ``topk_gating`` / ``moe_mlp``, ``CausalLM.loss`` on
MoE models, the engine) against the JAX package's.

The same numpy inputs go through both in float32. Tolerances: the dispatch
one-hot EXACT (the same choices and slots), combine weights 1e-6 (two
softmax implementations), the aux loss 1e-6; ``moe_mlp``'s output 2e-5
and its gradients 2e-4 (``jax.grad``), the JAX flash tests' limits; the
loss of ``tiny-moe`` and its ``moe_aux_loss`` 1e-5, gradients 1e-4; the
engine's 5-step trajectory loss 1e-5 and grad_norm 1e-4, as ``tiny``'s
(``tests/test_torch_train.py``). Ties between router probabilities go to
the lower expert index in both. One engine step trains on a batch of one
repeated token, whose rows all pick the same experts, so tokens are
dropped at capacity there (counted). The router jitter draws from a
``torch.Generator``, which the JAX package's ``jax.random`` cannot match:
its draw repeats for an equally seeded generator, and activation
checkpointing redraws the same noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.models import get_config as jax_get_config
from deepspeedsyclsupport_tpu.parallel import moe as jax_moe
from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.models import get_config
from deepspeedsyclsupport_tpu_torch.parallel import moe
from deepspeedsyclsupport_tpu_torch.runtime import engine as teng

T, D, F, E = 48, 64, 128, 8
SEQ = 32


def _logits(seed, t=T, e=E, ties=True):
    rng = np.random.RandomState(seed)
    lg = rng.randn(t, e).astype(np.float32)
    if ties:
        lg[3] = 0.5                   # every expert tied
        lg[7, [1, 4, 6]] = 3.0        # a three-way tie at the top
    return lg


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cap", [2, 7, 12, 96])
def test_topk_gating_matches_jax(k, cap):
    lg = _logits(k * 100 + cap)
    d_want, c_want, a_want = jax_moe.topk_gating(jnp.asarray(lg), k, cap)
    d_got, c_got, a_got = moe.topk_gating(torch.from_numpy(lg), k, cap)
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_want), atol=1e-6)
    np.testing.assert_allclose(float(a_got), float(a_want), rtol=1e-6)
    kept = float(d_got.sum())
    if cap >= T * k:                    # room for every row in any expert
        assert kept == T * k
    if cap == 2:
        assert kept < T * k             # dropped at capacity
    # each slot holds at most one row
    assert float(d_got.sum(0).max()) <= 1.0


def test_ties_go_to_the_lower_expert():
    lg = np.zeros((4, E), np.float32)
    d, _, _ = moe.topk_gating(torch.from_numpy(lg), 2, 8)
    assert d.sum(dim=(0, 2)).tolist() == [4.0, 4.0] + [0.0] * (E - 2)


def _inputs(seed, b=2, s=24, route_bias=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, D).astype(np.float32)
    router = rng.randn(D, E).astype(np.float32)
    if route_bias:                     # most tokens pick experts 0 and 1
        x[..., 0] = 2.0
        router[0] = 0.0
        router[0, :2] = 4.0
    p = {"router": router,
         "w_gate": (rng.randn(E, D, F) * 0.1).astype(np.float32),
         "w_up": (rng.randn(E, D, F) * 0.1).astype(np.float32),
         "w_down": (rng.randn(E, F, D) * 0.1).astype(np.float32)}
    return x, p


def _cfgs(k, **over):
    over = dict(hidden_size=D, intermediate_size=F, num_experts=E,
                num_experts_per_tok=k, **over)
    return jax_get_config("tiny-moe", **over), get_config("tiny-moe", **over)


@pytest.mark.parametrize("k,act,skew", [(1, "silu", False), (2, "silu", False),
                                        (2, "silu", True), (2, "gelu", True)])
def test_moe_mlp_and_grads_match_jax(k, act, skew):
    x, p = _inputs(k, route_bias=skew)
    jcfg, cfg = _cfgs(k, activation=act)
    cot = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def jf(p, x):
        o, a = jax_moe.moe_mlp(p, x, jcfg)
        return (o * cot).sum() + 3.0 * a, (o, a)

    (_, (o_want, a_want)), (gp, gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    o, a = moe.moe_mlp(tp, tx, cfg)
    ((o * torch.from_numpy(cot)).sum() + 3.0 * a).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_want),
                               atol=2e-5)
    np.testing.assert_allclose(float(a.detach()), float(a_want), rtol=1e-6)
    for n in p:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(gp[n]),
                                   atol=2e-4, rtol=2e-4, err_msg=n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=2e-4,
                               rtol=2e-4)
    if skew:   # the skew drops rows at capacity
        logits = torch.from_numpy(x.reshape(-1, D) @ p["router"])
        _, _, keep, _, _ = moe._capacity_route(
            logits, k, moe.capacity(x.shape[0] * x.shape[1], cfg))
        assert not bool(keep.all())


# ---------------------------------------------------------------- the model
def _jax_moe_model(seed=3, **kw):
    jmodel = jax_build_model("tiny-moe", dtype="float32", **kw)
    return jmodel, jmodel.init_params(jax.random.PRNGKey(seed))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _batch(seed, b=4, repeat=None):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (b, SEQ)).astype(np.int32)
    if repeat is not None:
        ids[:] = repeat
    return {"input_ids": ids}


def test_moe_loss_and_grads_match_jax():
    jmodel, jparams = _jax_moe_model()
    batch = _batch(7)
    (want, jm), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}), has_aux=True)(jparams)
    model = build_model("tiny-moe", dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.config,
                             device="cpu")
    for _, t in _flat(params):
        t.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for name in ("lm_loss", "moe_aux_loss"):
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    want_g = dict(_flat(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                        model.config, device="cpu")))
    assert any("moe/router" in n for n in want_g)
    for name, t in _flat(params):
        np.testing.assert_allclose(t.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    # eval forwards run the capacity path too
    logits = model.apply(params, torch.from_numpy(batch["input_ids"]))
    want_logits = jmodel.apply(jparams, jnp.asarray(batch["input_ids"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4)


def _losses_and_grads(model, params, batch, rng):
    leaves = [t.detach().clone().requires_grad_(True)
              for _, t in _flat(params)]
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        return next(it)

    loss, _ = model.loss(rebuild(params), batch, rng)
    loss.backward()
    return float(loss), [t.grad for t in leaves]


def test_router_jitter_draws_from_its_generator():
    """The port's jitter noise comes from the generator: equal seeds give
    equal losses and grads (with and without activation checkpointing,
    which must redraw the same noise), another seed another loss, and
    jitter 0 ignores the generator."""
    _, jparams = _jax_moe_model()
    batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    runs = {}
    for remat in (False, True):
        model = build_model("tiny-moe", dtype="float32", router_jitter=0.5,
                            remat=remat)
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 model.config, device="cpu")
        for seed in (1, 1, 2):
            runs.setdefault((remat, seed), []).append(_losses_and_grads(
                model, params, batch, torch.Generator().manual_seed(seed)))
    a, b = runs[(False, 1)]
    c = runs[(True, 1)][0]
    assert a[0] == b[0] == c[0]
    for x, y, z in zip(a[1], b[1], c[1]):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
        torch.testing.assert_close(x, z, atol=0, rtol=0)
    assert runs[(False, 2)][0][0] != a[0]
    plain = build_model("tiny-moe", dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), plain.config,
                             device="cpu")
    l1 = _losses_and_grads(plain, params, batch,
                           torch.Generator().manual_seed(1))[0]
    l2 = _losses_and_grads(plain, params, batch, None)[0]
    assert l1 == l2 != a[0]


def test_moe_remat_grads_equal_plain_grads():
    _, jparams = _jax_moe_model()
    batch = {k: torch.from_numpy(v) for k, v in _batch(8).items()}
    grads = []
    for remat in (False, True):
        model = build_model("tiny-moe", dtype="float32", remat=remat)
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 model.config, device="cpu")
        grads.append(_losses_and_grads(model, params, batch, None))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# -------------------------------------------------------------------- engine
ENGINE_CFG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                 "warmup_max_lr": 3e-3,
                                                 "warmup_num_steps": 3}},
    "gradient_clipping": 0.5, "steps_per_print": 1000,
}


def test_engine_trajectory_matches_jax(monkeypatch):
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    # step 3 trains on one repeated token: every row routes alike
    batches = [_batch(100 + i, repeat=17 if i == 2 else None)
               for i in range(5)]
    jmodel, jparams = _jax_moe_model()
    jparams = jax.tree.map(np.asarray, jparams)   # the engine donates
    topo = build_topology(dp=1, devices=jax.devices()[:1])
    jeng, *_ = dstpu.initialize(model=jmodel, config=ENGINE_CFG,
                                topology=topo,
                                params=jax.tree.map(jnp.asarray, jparams))
    want = []
    for b in batches:
        m = jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["moe_aux_loss"])))

    dropped = []
    route = moe._capacity_route

    def counting(*a, **kw):
        out = route(*a, **kw)
        dropped.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(moe, "_capacity_route", counting)
    model = build_model("tiny-moe", dtype="float32")
    params = params_from_jax(jparams, model.config, device="cpu")
    eng = teng.initialize(model=model, params=params, config=ENGINE_CFG,
                          device="cpu")[0]
    n_moe = model.config.num_layers * 2            # layers x micro-batches
    for i, b in enumerate(batches):
        m = eng.train_batch(b)
        np.testing.assert_allclose(float(m["loss"]), want[i][0], rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), want[i][1],
                                   rtol=1e-4, err_msg=f"grad_norm, step {i}")
        np.testing.assert_allclose(float(m["moe_aux_loss"]), want[i][2],
                                   rtol=1e-5, err_msg=f"aux, step {i}")
    per_step = [sum(dropped[i * n_moe:(i + 1) * n_moe]) for i in range(5)]
    assert per_step[2] > 0, per_step         # dropped at capacity


def test_engine_refuses_expert_parallelism():
    """Expert parallelism is ported: ``moe.expert_parallel_size`` is
    accepted and, with no process group, asks for one, with ZeRO++ flags
    too (ZeRO++ is ported; across ranks its scope refuses ``expert`` with
    the JAX engine's ValueError, tests/test_torch_dist_zeropp.py). What
    stays refused for an MoE model, naming A.3.1: elasticity."""
    model = build_model("tiny-moe", dtype="float32")
    for section in ({}, {"zero_optimization": {
            "stage": 3, "zero_quantized_weights": True}}):
        with pytest.raises(RuntimeError, match="init_distributed"):
            teng.initialize(model=model, config=dict(
                ENGINE_CFG, moe={"expert_parallel_size": 2}, **section),
                device="cpu")
    with pytest.raises(NotImplementedError, match="A.3.1"):
        teng.initialize(model=model, config=dict(
            ENGINE_CFG, moe={"expert_parallel_size": 2},
            elasticity={"enabled": True}), device="cpu")


def test_engine_jitter_draws_per_seed_and_step():
    """Through the engine the jitter's generator is seeded from the
    config's ``seed`` and the step: equal seeds train equal trajectories,
    another seed another one."""
    _, jparams = _jax_moe_model()
    batches = [{k: torch.from_numpy(v) for k, v in _batch(20 + i).items()}
               for i in range(2)]
    runs = []
    for seed in (5, 5, 6):
        model = build_model("tiny-moe", dtype="float32", router_jitter=0.5)
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 model.config, device="cpu")
        eng = teng.initialize(model=model, params=params,
                              config=dict(ENGINE_CFG, seed=seed),
                              device="cpu")[0]
        runs.append([float(eng.train_batch(b)["loss"]) for b in batches])
    assert runs[0] == runs[1] != runs[2]
