"""PyTorch port: the training path against the JAX package, on the CPU.

Inputs and weights come from numpy with a seed (weights through the JAX
model's ``init_params`` and ``params_from_jax``). Tolerances, with reasons:

* LR schedules: 1e-6 relative, or 1e-6 of the peak LR near a cosine's
  floor (the JAX package evaluates them in float32, the port in float64).
* One optimizer step against optax: 1e-6 (float32 on both sides; only the
  order of the elementwise ops differs).
* ``CausalLM.loss`` and its grads on ``tiny`` fp32: 1e-5 / 1e-4 (matmul
  summation order, as in ``test_torch_layers.py``).
* Engine trajectory (``tiny`` fp32, 5 steps): per-step loss 1e-5, grad_norm
  1e-4 relative, final params 1e-5 (Adam divides by sqrt(nu) + eps, which
  magnifies float32 rounding of the grads in the first steps; the grads
  themselves agree to ~1e-6).
* The same in bf16: 5e-2 on the loss and 0.1 relative on grad_norm (both
  packages round activations and grads to bf16, at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.runtime import loss_scaler as jls
from deepspeedsyclsupport_tpu.runtime import lr_schedules as jsched
from deepspeedsyclsupport_tpu.runtime import optimizers as jopt
from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.runtime import engine as teng
from deepspeedsyclsupport_tpu_torch.runtime import loss_scaler as tls
from deepspeedsyclsupport_tpu_torch.runtime import lr_schedules as tsched
from deepspeedsyclsupport_tpu_torch.runtime import optimizers as topt
from deepspeedsyclsupport_tpu_torch.runtime.config import DSTpuConfig

SEQ = 32


# ----------------------------------------------------------------- schedules
SCHEDULES = {
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_max_lr=3e-3,
                     warmup_num_steps=20),
    "WarmupLR_linear": dict(warmup_min_lr=0.0, warmup_max_lr=1e-3,
                            warmup_num_steps=10, warmup_type="linear"),
    "WarmupDecayLR": dict(total_num_steps=40, warmup_min_lr=0.0,
                          warmup_max_lr=2e-3, warmup_num_steps=8),
    "WarmupCosineLR": dict(total_num_steps=45, warmup_min_ratio=0.1,
                           warmup_num_steps=5, cos_min_ratio=0.01,
                           warmup_max_lr=1e-3),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                     cycle_first_step_size=10, cycle_second_step_size=15,
                     decay_step_size=5, decay_lr_rate=0.1),
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4,
                        lr_range_test_step_size=7,
                        lr_range_test_step_rate=2.0,
                        lr_range_test_staircase=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    kind = name.split("_")[0]
    want = jsched.build_schedule(kind, SCHEDULES[name], 1e-3)
    got = tsched.build_schedule(kind, SCHEDULES[name], 1e-3)
    for step in range(51):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=3e-9, err_msg=f"step {step}")


def test_constant_schedule():
    assert tsched.build_schedule(None, {}, 3e-4)(17) == 3e-4


# ---------------------------------------------------------------- optimizers
def _opt_tree(seed):
    rng = np.random.RandomState(seed)
    return {"layers": {"attn": {"wq": rng.randn(3, 4, 5).astype(np.float32)},
                       "attn_norm": {"scale": rng.randn(3, 5).astype(
                           np.float32)}},
            "embed": {"embedding": rng.randn(7, 5).astype(np.float32)},
            "lm_head": {"bias": rng.randn(7).astype(np.float32)}}


@pytest.mark.parametrize("kind,extra", [
    ("AdamW", {"weight_decay": 0.1}),
    ("Adam", {"weight_decay": 0.05,
              "no_decay_patterns": ["scale", "bias", "lm_head/"]}),
    ("Adam", {"adam_w_mode": False, "weight_decay": 0.3}),
])
def test_optimizer_steps_match_optax(kind, extra):
    cfg = dict(lr=1e-2, betas=[0.9, 0.95], eps=1e-6, **extra)
    sched = tsched.warmup_lr(1e-3, 1e-2, 4)
    jsch = jsched.warmup_lr(1e-3, 1e-2, 4)
    params, tx = _opt_tree(0), jopt.build_optimizer(kind, cfg, jsch)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    # the port: the same leaves in the port's order, with JAX-style paths
    named = list(teng._leaves(params))
    leaves = [torch.from_numpy(np.array(t)) for _, t in named]
    opt = topt.build_optimizer(kind, cfg, sched)
    opt.init(leaves, [p for p, _ in named])
    assert topt.current_lr(opt) == pytest.approx(float(
        jopt.current_lr(state)))
    for step in range(3):
        grads = _opt_tree(10 + step)
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(np.array(t))
                  for _, t in teng._leaves(grads)])
        assert topt.current_lr(opt) == pytest.approx(
            float(jopt.current_lr(state)), rel=1e-6)
    for (path, _), got in zip(named, leaves):
        want = jp
        for seg in path:
            want = want[seg]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6, err_msg="/".join(path))


def test_unported_optimizers_raise():
    """No optimizer type of the JAX package is left unported (A.3.6 is
    done, ``tests/test_torch_optimizers.py`` holds each against it): every
    name builds, and a name neither package knows raises ValueError in
    both."""
    for kind in ("Lamb", "FusedLamb", "Lion", "FusedLion", "SGD", "Adagrad",
                 "OneBitAdam", "ZeroOneAdam", "OneBitLamb"):
        assert topt.build_optimizer(kind, {}, None) is not None
        jopt.build_optimizer(kind, {}, None)
    for mod in (topt, jopt):
        with pytest.raises(ValueError, match="unknown optimizer"):
            mod.build_optimizer("Adafactor", {}, None)


# --------------------------------------------------------------- loss scaler
def test_loss_scaler_trajectory_matches_jax():
    rng = np.random.RandomState(0)
    finite_seq = rng.rand(60) > 0.3
    for dynamic, window, hys in ((True, 3, 2), (True, 5, 1), (False, 4, 2)):
        js = jls.init_loss_scale(2.0 ** 10, dynamic, hysteresis=hys)
        ts = tls.init_loss_scale(2.0 ** 10, dynamic, hysteresis=hys)
        for f in finite_seq:
            js = jls.update_loss_scale(js, jnp.asarray(bool(f)),
                                       dynamic=dynamic, scale_window=window,
                                       min_scale=4.0, hysteresis=hys)
            ts = tls.update_loss_scale(ts, bool(f), dynamic=dynamic,
                                       scale_window=window, min_scale=4.0,
                                       hysteresis=hys)
            assert (ts.scale, ts.good_steps, ts.hysteresis_left,
                    ts.overflows) == (float(js.scale), int(js.good_steps),
                                      int(js.hysteresis_left),
                                      int(js.overflows))


def test_grads_finite_and_unscale():
    g = [torch.ones(3), torch.full((2,), 4.0)]
    assert bool(tls.grads_finite(g))
    tls.unscale_grads(g, tls.init_loss_scale(4.0, True))
    assert g[1].tolist() == [1.0, 1.0]
    assert not bool(tls.grads_finite([torch.ones(2),
                                      torch.tensor([float("inf")])]))


# ---------------------------------------------------------------- model loss
def _jax_tiny(dtype="float32", seed=3, **kw):
    jmodel = jax_build_model("tiny", dtype=dtype, **kw)
    return jmodel, jmodel.init_params(jax.random.PRNGKey(seed))


def _batch(seed, b=4, kinds=()):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (b, SEQ)).astype(np.int32)
    batch = {"input_ids": ids}
    if "labels" in kinds:
        labels = np.roll(ids, -1, axis=1)
        labels[:, -3:] = -1
        labels[0, 5] = -1
        batch["labels"] = labels.astype(np.int32)
    if "loss_mask" in kinds:
        batch["loss_mask"] = (rng.rand(b, SEQ) > 0.25).astype(np.float32)
    if "segments" in kinds:
        batch["segment_ids"] = np.repeat([[0, 1]], SEQ // 2, axis=1).repeat(
            b, axis=0).astype(np.int32)
    return batch


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


LOSS_CASES = {"shift": (), "labels": ("labels",),
              "labels_loss_mask": ("labels", "loss_mask"),
              "shift_loss_mask_segments": ("loss_mask", "segments")}


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_jax(case, impl):
    jmodel, jparams = _jax_tiny()
    batch = _batch(7, kinds=LOSS_CASES[case])
    (want, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}), has_aux=True)(jparams)
    model = build_model("tiny", dtype="float32", attn_impl=impl)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.config,
                             device="cpu")
    for _, t in _flat(params):
        t.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["lm_loss"]),
                               float(jmetrics["lm_loss"]), rtol=1e-5)
    want_g = dict(_flat(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                        model.config, device="cpu")))
    for name, t in _flat(params):
        np.testing.assert_allclose(t.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_remat_grads_equal_plain_grads():
    """Per-layer checkpointing recomputes the same numbers: grads equal."""
    _, jparams = _jax_tiny()
    batch = {k: torch.from_numpy(v) for k, v in _batch(8).items()}
    grads = []
    for remat in (False, True):
        model = build_model("tiny", dtype="float32", attn_impl="flash",
                            remat=remat)
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 model.config, device="cpu")
        leaves = [t.requires_grad_(True) for _, t in _flat(params)]
        model.loss(params, batch)[0].backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
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


def _jax_engine_run(cfg, dtype, batches):
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.comm.topology import build_topology

    jmodel, jparams = _jax_tiny(dtype)
    jparams = jax.tree.map(np.asarray, jparams)   # the engine donates its copy
    topo = build_topology(dp=1, devices=jax.devices()[:1])
    eng, *_ = dstpu.initialize(model=jmodel, config=cfg, topology=topo,
                               params=jax.tree.map(jnp.asarray, jparams))
    out = []
    for b in batches:
        m = eng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, jparams, jax.tree.map(np.asarray, eng.params)


def _port_engine(cfg, dtype, jparams, impl="flash"):
    model = build_model("tiny", dtype=dtype, attn_impl=impl)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.config,
                             device="cpu")
    return teng.initialize(model=model, params=params, config=cfg,
                           device="cpu")[0], model


def test_engine_trajectory_matches_jax_fp32():
    batches = [_batch(100 + i, kinds=("segments",)) for i in range(5)]
    want, jparams, jfinal = _jax_engine_run(ENGINE_CFG, "float32", batches)
    eng, model = _port_engine(ENGINE_CFG, "float32", jparams)
    for i, b in enumerate(batches):
        m = eng.train_batch(b)
        assert set(m) >= {"loss", "lm_loss", "grad_norm", "finite",
                          "loss_scale"}
        np.testing.assert_allclose(float(m["loss"]), want[i][0], rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), want[i][1],
                                   rtol=1e-4, err_msg=f"grad_norm, step {i}")
        assert bool(m["finite"]) and m["loss_scale"] == 1.0
    assert eng.global_steps == 5 and eng.micro_steps == 10
    final = dict(_flat(params_from_jax(jfinal, model.config, device="cpu")))
    for name, t in _flat(eng.params):
        np.testing.assert_allclose(t.detach().numpy(), final[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert eng.get_lr() == pytest.approx(
        tsched.warmup_lr(0, 3e-3, 3)(4), rel=1e-9)


def test_engine_trajectory_matches_jax_bf16():
    cfg = dict(ENGINE_CFG, bf16={"enabled": True})
    batches = [_batch(200 + i) for i in range(3)]
    want, jparams, _ = _jax_engine_run(cfg, "bfloat16", batches)
    eng, _ = _port_engine(cfg, "bfloat16", jparams)
    assert eng.compute_dtype == torch.bfloat16
    for i, b in enumerate(batches):
        m = eng.train_batch(b)
        np.testing.assert_allclose(float(m["loss"]), want[i][0], atol=5e-2,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), want[i][1],
                                   rtol=0.1, err_msg=f"grad_norm, step {i}")
    # master params stay float32, grads come back float32
    assert all(t.dtype == torch.float32 for _, t in _flat(eng.params))


def test_fp16_overflow_skips_the_step():
    # no warmup: WarmupLR's first update runs at lr 0
    cfg = {k: v for k, v in ENGINE_CFG.items() if k != "scheduler"}
    cfg["fp16"] = {"enabled": True, "initial_scale_power": 24,
                   "hysteresis": 1}
    _, jparams = _jax_tiny("float16")
    eng, _ = _port_engine(cfg, "float16", jparams)
    before = [t.detach().clone() for _, t in _flat(eng.params)]
    m = eng.train_batch(_batch(300))
    assert not bool(m["finite"])
    assert eng.skipped_steps == 1 and eng.get_loss_scale() == 2.0 ** 23
    for b, (_, t) in zip(before, _flat(eng.params)):
        torch.testing.assert_close(t.detach(), b, atol=0, rtol=0)
    for i in range(12):      # the scale halves until a step goes through
        m = eng.train_batch(_batch(301 + i))
        if bool(m["finite"]):
            break
    assert bool(m["finite"]) and eng.skipped_steps == i + 1
    assert any(not torch.equal(b, t.detach())
               for b, (_, t) in zip(before, _flat(eng.params)))


def test_eager_forward_backward_step_equals_train_batch():
    _, jparams = _jax_tiny()
    batches = [_batch(400 + i) for i in range(2)]
    fused, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    eager, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    for b in batches:
        want = fused.train_batch(b)
        for half in (slice(0, 2), slice(2, 4)):
            loss = eager({k: v[half] for k, v in b.items()})
            eager.backward(loss)
        assert eager.is_gradient_accumulation_boundary()
        got = eager.step()
        assert float(got["loss"]) == float(want["loss"])
        assert float(got["grad_norm"]) == float(want["grad_norm"])
    for (_, a), (_, b) in zip(_flat(fused.params), _flat(eager.params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert eager.global_steps == fused.global_steps == 2
    ev = eager.eval_batch(batches[0])
    assert not ev.requires_grad and float(ev) == float(
        fused.eval_batch(batches[0]))


def test_activation_checkpointing_config_sets_remat():
    _, jparams = _jax_tiny()
    cfg = dict(ENGINE_CFG, activation_checkpointing={
        "partition_activations": False})
    eng, model = _port_engine(cfg, "float32", jparams)
    assert eng.module.config.remat and not model.config.remat
    plain, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    b = _batch(500)
    assert float(eng.train_batch(b)["loss"]) == float(
        plain.train_batch(b)["loss"])
    with pytest.raises(NotImplementedError, match="A.3.7"):
        DSTpuConfig.from_config(dict(ENGINE_CFG, activation_checkpointing={
            "policy": "dots_saveable"}))


@pytest.mark.parametrize("section,entry", [
    ({"zero_optimization": {"stage": 2, "offload_optimizer":
                            {"device": "cpu"}}}, "A.3.2"),
    # ZeRO++ is ported (A.3.1.1); under ZeRO-Offload it waits with offload
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True,
                            "offload_optimizer": {"device": "cpu"}}},
     "A.3.2"),
    ({"zero_optimization": {"stage": 3, "zero_quantized_gradients": True,
                            "offload_param": {"device": "cpu"}}}, "A.3.2"),
    ({"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2,
                            "offload_optimizer": {"device": "nvme"}}},
     "A.3.2"),
    ({"elasticity": {"enabled": True}}, "A.3.1"),
    ({"checkpoint": {"load_universal": True}}, "A.3.5"),
    ({"checkpoint": {"use_node_local_storage": True}}, "A.3.1"),
    ({"telemetry": {"enabled": True}}, "A.3.4"),
    ({"tensorboard": {"enabled": True}}, "A.3.4"),
    ({"flops_profiler": {"enabled": True}}, "A.3.4"),
    ({"compression_training": {"weight_quantization": {
        "shared_parameters": {"enabled": True}}}}, "A.3.7"),
    ({"curriculum_learning": {"enabled": True}}, "A.3.7"),
    ({"progressive_layer_drop": {"enabled": True}}, "A.3.7"),
    ({"data_efficiency": {"data_routing": {"random_ltd": {
        "enabled": True}}}}, "A.3.7"),
])
def test_unported_config_sections_raise(section, entry):
    with pytest.raises(NotImplementedError, match=entry.replace(".", r"\.")):
        DSTpuConfig.from_config(dict(ENGINE_CFG, **section))


def test_config_batch_invariant_and_zero_stages():
    cfg = DSTpuConfig.from_config({"train_batch_size": 8,
                                   "gradient_accumulation_steps": 4,
                                   "zero_optimization": {"stage": 3}}, 1)
    assert (cfg.train_micro_batch_size_per_gpu, cfg.zero_stage) == (2, 3)
    with pytest.raises(ValueError, match="invariant"):
        DSTpuConfig.from_config({"train_batch_size": 8,
                                 "train_micro_batch_size_per_gpu": 3,
                                 "gradient_accumulation_steps": 2}, 1)
    with pytest.raises(ValueError, match="both"):
        DSTpuConfig.from_config({"train_batch_size": 2, "fp16": {
            "enabled": True}, "bf16": {"enabled": True}})


def test_initialize_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.initialize(model=build_model("tiny"), config=ENGINE_CFG)


def test_unported_engine_features_raise():
    _, jparams = _jax_tiny()
    eng, _ = _port_engine(ENGINE_CFG, "float32", jparams)
    with pytest.raises(NotImplementedError, match=r"A\.3\.5"):
        eng.save_16bit_model("somewhere")
    from deepspeedsyclsupport_tpu_torch.comm.topology import MeshTopology

    # an expert mesh is ported (tests/test_torch_dist_moe.py) and asks for
    # a process group, with ZeRO++ too (whose scope, refusing expert,
    # tests/test_torch_dist_zeropp.py holds across ranks); ZeRO++ on one
    # card raises the JAX engine's ValueError (fsdp 1)
    with pytest.raises(RuntimeError, match="init_distributed"):
        teng.initialize(model=build_model("tiny"), config=ENGINE_CFG,
                        topology=MeshTopology({"expert": 2}, world_size=2),
                        device="cpu")
    zpp = dict(ENGINE_CFG, zero_optimization={
        "stage": 3, "zero_quantized_weights": True})
    with pytest.raises(RuntimeError, match="init_distributed"):
        teng.initialize(model=build_model("tiny"), config=zpp,
                        topology=MeshTopology({"expert": 2}, world_size=2),
                        device="cpu")
    with pytest.raises(ValueError, match="fsdp>1"):
        teng.initialize(model=build_model("tiny"), config=zpp, device="cpu")
