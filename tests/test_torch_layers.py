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


# ------------------------------------------------------------------ attention
def _attn_inputs(seed, b=2, sq=12, skv=None, h=4, kvh=2, d=16):
    rng = np.random.RandomState(seed)
    skv = sq if skv is None else skv
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, kvh, d).astype(np.float32),
            rng.randn(b, skv, kvh, d).astype(np.float32))


ATTN_CASES = {
    "causal": (dict(), dict(causal=True)),
    "non_causal": (dict(), dict(causal=False)),
    "window": (dict(), dict(causal=True, window=5)),
    "segments": (dict(), dict(causal=True, segment_ids="seg")),
    "alibi": (dict(h=4, kvh=4), dict(causal=True, alibi="slopes")),
    "cross_8_12": (dict(sq=8, skv=12), dict(causal=True)),
    "positions": (dict(), dict(causal=True, q_positions="perm",
                               kv_positions="perm")),
}


def _attn_kwargs(case, q):
    kw = dict(ATTN_CASES[case][1])
    b, s = q.shape[:2]
    if kw.get("segment_ids") == "seg":
        kw["segment_ids"] = np.repeat([[0, 1, 2]], s // 3, axis=1).repeat(
            b, axis=0).astype(np.int32)
    if kw.get("alibi") == "slopes":
        kw["alibi"] = tl.alibi_slopes(q.shape[2])
    if kw.get("q_positions") == "perm":
        perm = np.stack([np.random.RandomState(i).permutation(s)
                         for i in range(b)]).astype(np.int32)
        kw["q_positions"] = kw["kv_positions"] = perm
    return kw


def _jnp(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _torch(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_reference_attention_matches_jax(case):
    q, k, v = _attn_inputs(len(case), **ATTN_CASES[case][0])
    kw = _attn_kwargs(case, q)
    want = jl.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **_jnp(kw))
    got = tl.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                 **_torch(kw))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
@pytest.mark.parametrize("case", ["causal", "segments", "alibi", "window",
                                  "cross_8_12", "positions"])
def test_attention_dispatch_matches_jax(case, impl):
    """Every impl the port has agrees with the JAX package's plain path
    (no case here has a fully masked row, where flash gives 0 and the plain
    path a uniform row, in both packages)."""
    q, k, v = _attn_inputs(40 + len(case), **ATTN_CASES[case][0])
    kw = _attn_kwargs(case, q)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        impl="xla", **_jnp(kw))
    got = tl.attention(*map(torch.from_numpy, (q, k, v)), impl=impl,
                       **_torch(kw))
    _close(got, want, 2e-5)


def test_attention_dispatch_refuses_what_it_does_not_do():
    q, k, v = map(torch.from_numpy, _attn_inputs(0))
    # sequence parallelism is ported (A.3.1.2); what it does not take stays
    # refused: ALiBi and windows under ring / ulysses (as in the JAX
    # package), segment ids under ring (tests/test_torch_pipeline.py)
    for impl in ("ring", "ulysses", "ring:flash", "ulysses:xla"):
        with pytest.raises(NotImplementedError, match="alibi"):
            tl.attention(q, k, v, impl=impl, window=3)
    for impl in ("ring:flsh", "pallas", "flash:xla"):
        with pytest.raises(ValueError, match="impl"):
            tl.attention(q, k, v, impl=impl)
    with pytest.raises(ValueError, match="window requires causal"):
        tl.attention(q, k, v, causal=False, window=3)


@pytest.mark.parametrize("arch", ["llama", "gqa_window", "bloom_alibi",
                                  "neox_parallel_partial"])
def test_attention_block_matches_jax(arch):
    cfg_kw = dict(ARCHS[arch], dtype="float32")
    jmodel = jax_build_model("tiny", **cfg_kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(5))
    jattn = jax.tree.map(lambda t: np.asarray(t)[1],
                         jparams["layers"]["attn"])
    x = np.random.RandomState(6).randn(2, 10, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    want, _ = jl.attention_block({k: jnp.asarray(t) for k, t in jattn.items()},
                                 jnp.asarray(x), jmodel.config,
                                 jnp.asarray(pos))
    cfg = torch_get_config("tiny", **cfg_kw)
    got = tl.attention_block({k: torch.from_numpy(np.array(t))
                              for k, t in jattn.items()},
                             torch.from_numpy(x), cfg,
                             torch.from_numpy(np.array(pos)),
                             window=cfg.sliding_window)
    _close(got, want, FWD_TOL)


def test_matmul_promotes_as_jax_does():
    a = torch.ones(2, 3, dtype=torch.bfloat16)
    b = torch.full((3, 4), 0.5)
    out = tl.matmul(a, b)
    assert out.dtype == torch.float32 and float(out[0, 0]) == 1.5
