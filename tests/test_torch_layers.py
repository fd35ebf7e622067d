"""PyTorch port: model building blocks against ``models/layers.py`` of the
JAX package (norms, RoPE with partial rotary, ALiBi slopes, both MLP
shapes, every activation), and the dense CausalLM forward against the JAX
model. Inputs come from numpy with a seed.

Tolerance 1e-5 for the elementwise blocks (float32 on both sides; only
transcendental-function rounding differs) and 2e-4 for whole forwards
(matmul summation order differs, as in the JAX package's engine tests).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.models import get_config
from deepspeedsyclsupport_tpu.models import layers as jl
from deepspeedsyclsupport_tpu_torch.models import layers as tl
from deepspeedsyclsupport_tpu_torch.models import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.models.config import (
    get_config as torch_get_config)

TOL = 1e-5
FWD_TOL = 2e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norms(norm_type):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3
    p = {"scale": rng.randn(64).astype(np.float32),
         "bias": rng.randn(64).astype(np.float32)}
    cfg = get_config("tiny", norm_type=norm_type)
    want = jl.norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                   cfg)
    got = tl.norm(torch.from_numpy(x),
                  {k: torch.from_numpy(v) for k, v in p.items()}, cfg)
    _close(got, want)


def test_norm_keeps_bf16():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    assert tl.rms_norm(x, torch.ones(16), 1e-5).dtype == torch.bfloat16


@pytest.mark.parametrize("rotary_dim", [None, 8, 4])
def test_apply_rope(rotary_dim):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = rng.randint(0, 300, (2, 7)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                         rotary_dim)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                        rotary_dim)
    _close(got, want)
    # 1-D positions broadcast over the batch, as in the JAX package
    want1 = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), 500.0,
                          rotary_dim)
    got1 = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                         500.0, rotary_dim)
    _close(got1, want1)


@pytest.mark.parametrize("heads", [1, 4, 8, 12, 32, 71])
def test_alibi_slopes(heads):
    np.testing.assert_array_equal(tl.alibi_slopes(heads),
                                  jl.alibi_slopes(heads))


@pytest.mark.parametrize("mlp_type,activation,use_bias", [
    ("glu", "silu", False), ("glu", "gelu", False), ("mlp", "gelu", True),
    ("mlp", "gelu_exact", True), ("mlp", "relu", False)])
def test_mlp_blocks(mlp_type, activation, use_bias):
    rng = np.random.RandomState(2)
    d, f = 16, 24
    cfg = get_config("tiny", mlp_type=mlp_type, activation=activation,
                     use_bias=use_bias)
    names = (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))) \
        if mlp_type == "glu" else (("fc1", (d, f)), ("fc2", (f, d)),
                                   ("b1", (f,)), ("b2", (d,)))
    p = {n: rng.randn(*s).astype(np.float32) * 0.3 for n, s in names}
    x = rng.randn(2, 5, d).astype(np.float32)
    want = jl.mlp_block({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), cfg)
    got = tl.mlp_block({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), cfg)
    _close(got, want)


def test_config_copy_matches():
    """The port's config module is a copy: every preset is identical."""
    from deepspeedsyclsupport_tpu.models.config import PRESETS
    from deepspeedsyclsupport_tpu_torch.models.config import (
        PRESETS as TORCH_PRESETS)

    assert sorted(PRESETS) == sorted(TORCH_PRESETS)
    for name in PRESETS:
        assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(
            TORCH_PRESETS[name]), name


ARCHS = {
    "llama": dict(),
    "gqa_window": dict(sliding_window=4),
    "bloom_alibi": dict(pos_embed="alibi", norm_type="layernorm",
                        mlp_type="mlp", activation="gelu", use_bias=True,
                        embed_norm=True, tie_embeddings=True),
    "neox_parallel_partial": dict(norm_type="layernorm", mlp_type="mlp",
                                  activation="gelu_exact", use_bias=True,
                                  rotary_pct=0.5, parallel_block=True),
    "opt_learned": dict(pos_embed="learned", pos_embed_offset=2,
                        norm_type="layernorm", mlp_type="mlp",
                        activation="relu", use_bias=True,
                        tie_embeddings=True),
    "phi_shared_norm": dict(norm_type="layernorm", mlp_type="mlp",
                            activation="gelu", use_bias=True, rotary_pct=0.5,
                            parallel_block=True, shared_block_norm=True,
                            lm_head_bias=True),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dense_forward_matches_jax(arch):
    kw = dict(ARCHS[arch], dtype="float32")
    jmodel = jax_build_model("tiny", **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    ids = np.random.RandomState(4).randint(0, 512, (2, 11)).astype(np.int32)
    want = jmodel.apply(jparams, jnp.asarray(ids))
    model = build_model("tiny", **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.config,
                             device="cpu")
    got = model.apply(params, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    _close(got, want, FWD_TOL)


def test_init_params_shapes_and_scales_match_jax():
    """Seeded torch init: same tree, shapes and scales as the JAX package
    (the bits differ: the generators differ)."""
    cfg = torch_get_config("small", num_layers=2)
    tparams = build_model(cfg).init_params(device="cpu")
    jparams = jax_build_model("small", num_layers=2).init_params()
    jtree = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    flat_t = dict(_flatten(tparams))
    flat_j = dict(_flatten(jtree))
    assert sorted(flat_t) == sorted(flat_j)
    for k, t in flat_t.items():
        assert t.shape == flat_j[k].shape, k
        if t.numel() > 1000:    # random matrices: same std within 5 %
            assert abs(t.std().item() / flat_j[k].std().item() - 1) < 0.05, k


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
