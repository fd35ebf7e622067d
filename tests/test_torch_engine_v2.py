"""PyTorch port: the ragged serving engine against the JAX package's.

The same weights (JAX-initialised, converted with ``params_from_jax``) are
served by both engines on ``tiny`` in float32, on the CPU: the JAX engine
with ``prefill_attn="kernel_interpret"`` (its Pallas kernel in interpret
mode) or ``"xla"``, the port with ``"kernel"`` (the CUDA kernel's wrapper,
which takes its plain version on CPU tensors) or ``"xla"``. ``put`` logits
(ragged prefill, then the decode path) agree to 2e-4, as in the JAX
package's own engine tests (``tests/unit/test_inference_v2.py:259``);
greedy ``generate`` tokens are identical. One GQA+window config and one
ALiBi config (overrides of ``tiny``) ride along, and one float16 serve of
``tiny`` through both engines' kernel paths (logits at 4e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.inference.v2 import (
    InferenceEngineV2 as JaxEngine)
from deepspeedsyclsupport_tpu.inference.v2.model import (
    build_decode_forward_fn, build_ragged_forward_fn)
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu_torch.inference.v2 import (
    InferenceEngineV2, SequenceDescriptor, build_ragged_batch)
from deepspeedsyclsupport_tpu_torch.inference.v2.model import (
    decode_forward, ragged_forward)
from deepspeedsyclsupport_tpu_torch.models import build_model, params_from_jax

TOL = 2e-4
ARCHS = {"tiny": {}, "gqa_window": {"sliding_window": 4},
         "alibi": {"pos_embed": "alibi"}}
ENGINE_KW = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
                 max_sequences=4, atom_q_size=8)
PROMPT = [int(t) for t in np.random.RandomState(0).randint(1, 500, size=20)]
PROMPTS = [[7, 3, 11], [4, 100, 42, 8, 19], list(range(30, 52)), [9],
           [5, 6, 7, 8, 9, 10, 11]]
NEW_TOKENS = 6


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    model = jax_build_model("tiny", dtype="float32", **ARCHS[arch])
    params = model.init_params(jax.random.PRNGKey(11))
    return model, params, jax.tree.map(np.asarray, params)


def _torch_model(arch):
    _, _, np_params = _jax_model(arch)
    model = build_model("tiny", dtype="float32", **ARCHS[arch])
    return model, params_from_jax(np_params, model.config, device="cpu")


def _serve(eng, as_np):
    """put a prompt longer than the token budget (ragged path, split), then
    one decode token (decode path), then greedy generate."""
    prefill = as_np(eng.put([1], [PROMPT])[1])
    nxt = int(np.argmax(prefill))
    decode = as_np(eng.put([1], [[nxt]])[1])
    eng.flush([1])
    return prefill, decode, eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, impl):
    model, params, _ = _jax_model(arch)
    eng = JaxEngine(model, params, dtype=jnp.float32, prefill_attn=impl,
                    **ENGINE_KW)
    return _serve(eng, np.asarray)


def _torch_serve(arch, impl, **kw):
    model, params = _torch_model(arch)
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            prefill_attn=impl, decode_attn=impl,
                            **dict(ENGINE_KW, **kw))
    return _serve(eng, lambda t: t.numpy())


@pytest.mark.parametrize("arch,jax_impl,torch_impl", [
    ("tiny", "kernel_interpret", "kernel"), ("tiny", "xla", "xla"),
    ("gqa_window", "kernel_interpret", "kernel"),
    ("alibi", "kernel_interpret", "kernel")])
def test_engine_matches_jax(arch, jax_impl, torch_impl):
    jp, jd, jtoks = _jax_serve(arch, jax_impl)
    tp, td, ttoks = _torch_serve(arch, torch_impl)
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(td, jd, atol=TOL, rtol=TOL)
    assert ttoks == jtoks
    assert all(len(t) == NEW_TOKENS for t in ttoks)


FP16_TOL = 4e-3


def test_engine_matches_jax_fp16():
    """float16 serving (the dtype the port's kernel once refused): the same
    float32 weights served by both engines in float16 on ``tiny``, the JAX
    engine through its Pallas kernel in interpret mode, the port through
    its kernel wrapper (the plain version on CPU tensors). Both compute in
    float16 and round at different places, so the logits are held at the
    card's float16 tolerance, 4e-3 (an ulp of float16 at |x| ~ 2); greedy
    tokens are identical."""
    _, jax_params, np_params = _jax_model("tiny")
    jax_eng = JaxEngine(jax_build_model("tiny", dtype="float16"), jax_params,
                        dtype=jnp.float16, prefill_attn="kernel_interpret",
                        **ENGINE_KW)
    jp, jd, jtoks = _serve(jax_eng, lambda x: np.asarray(x, np.float32))
    model = build_model("tiny", dtype="float16")
    eng = InferenceEngineV2(model, params_from_jax(np_params, model.config,
                                                   device="cpu"),
                            device="cpu", dtype=torch.float16,
                            prefill_attn="kernel", decode_attn="kernel",
                            **ENGINE_KW)
    assert eng.kv.k.dtype == torch.float16
    tp, td, ttoks = _serve(eng, lambda t: t.float().numpy())
    np.testing.assert_allclose(tp, jp, atol=FP16_TOL, rtol=FP16_TOL)
    np.testing.assert_allclose(td, jd, atol=FP16_TOL, rtol=FP16_TOL)
    assert ttoks == jtoks
    assert all(len(t) == NEW_TOKENS for t in ttoks)


def test_kernel_and_plain_paths_agree_with_dense():
    """Port-internal: the atom path, the plain path and the dense model give
    the same last-token logits."""
    model, params = _torch_model("tiny")
    dense = model.apply(params, torch.tensor([PROMPT]))[0, -1]
    for impl in ("kernel", "xla"):
        eng = InferenceEngineV2(model, params, device="cpu",
                                dtype=torch.float32, prefill_attn=impl,
                                **ENGINE_KW)
        np.testing.assert_allclose(eng.put([1], [PROMPT])[1].numpy(),
                                   dense.numpy(), atol=TOL, rtol=TOL)


def test_lane_padded_pool_matches():
    """A forced head-dim pad (the JAX package's TPU layout) changes the pool
    width but not the logits: q is pre-scaled at the attention seam."""
    jp, jd, jtoks = _jax_serve("tiny", "kernel_interpret")
    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            prefill_attn="kernel", decode_attn="pallas",
                            head_dim_lane_pad=128, **ENGINE_KW)
    assert eng.kv.k.shape[-1] == 128
    tp, td, ttoks = _serve(eng, lambda t: t.numpy())
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(td, jd, atol=TOL, rtol=TOL)
    assert ttoks == jtoks


def _descs(mod_seq):
    a = mod_seq(uid=1, pending=list(range(3, 14)), n_cached=0, blocks=[5, 2])
    b = mod_seq(uid=2, pending=[40, 41, 42], n_cached=6, blocks=[7, 0])
    return [(a, 11), (b, 3)]


def test_ragged_and_decode_forward_match_jax():
    """The forwards themselves, on one hand-built batch: logits and the KV
    pool after the in-place append agree with the JAX programs'."""
    from deepspeedsyclsupport_tpu.inference.v2.kv_cache import (
        init_blocked_kv as jax_init_kv)
    from deepspeedsyclsupport_tpu.inference.v2.config import (
        RaggedInferenceConfig as JaxCfg)
    from deepspeedsyclsupport_tpu.inference.v2.ragged import (
        SequenceDescriptor as JaxSeq)
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        RaggedInferenceConfig, init_blocked_kv)

    jmodel, jparams, _ = _jax_model("gqa_window")
    model, params = _torch_model("gqa_window")
    kw = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
              max_sequences=4, num_blocks=10)
    jkv = jax_init_kv(jmodel.config, JaxCfg(dtype=jnp.float32, **kw))
    tkv = init_blocked_kv(model.config,
                          RaggedInferenceConfig(dtype=torch.float32, **kw),
                          torch.device("cpu"))
    jb = build_ragged_batch(_descs(JaxSeq), 16, 4, 8, atom_q=8)
    tb = build_ragged_batch(_descs(SequenceDescriptor), 16, 4, 8, atom_q=8)
    names = ("tokens", "token_seq", "token_pos", "block_tables",
             "last_tok_idx", "atom_qidx", "atom_pos0", "atom_qlen",
             "atom_tables", "atom_inv")
    fwd = build_ragged_forward_fn(jmodel, 8, attn_impl="kernel_interpret")
    jlog, jkv = fwd(jparams, jkv, *[jnp.asarray(getattr(jb, n))
                                    for n in names])
    tlog, tkv = ragged_forward(model, params, tkv,
                               *[torch.from_numpy(getattr(tb, n))
                                 for n in names], block_size=8,
                               attn_impl="kernel")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), atol=TOL,
                               rtol=TOL)
    # decode: both sequences append one token at their next position
    tokens = np.array([7, 9, 0, 0], np.int32)
    positions = np.array([11, 9, 0, 0], np.int32)
    active = np.array([True, True, False, False])
    tables = tb.block_tables
    dfwd = build_decode_forward_fn(jmodel, 8)
    jlog, jkv = dfwd(jparams, jkv, jnp.asarray(tokens),
                     jnp.asarray(positions), jnp.asarray(tables),
                     jnp.asarray(active))
    tlog, tkv = decode_forward(model, params, tkv, torch.from_numpy(tokens),
                               torch.from_numpy(positions),
                               torch.from_numpy(tables),
                               torch.from_numpy(active), block_size=8,
                               attn_impl="kernel")
    np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tkv.v.numpy(), np.asarray(jkv.v), atol=TOL,
                               rtol=TOL)


def test_params_from_jax_round_trip():
    model, params = _torch_model("alibi")
    _, _, np_params = _jax_model("alibi")
    assert len(params["layers"]) == model.config.num_layers
    for li, layer in enumerate(params["layers"]):
        for group, leaves in layer.items():
            for name, t in leaves.items():
                np.testing.assert_array_equal(
                    t.numpy(), np_params["layers"][group][name][li])
    np.testing.assert_array_equal(params["embed"]["embedding"].numpy(),
                                  np_params["embed"]["embedding"])
    bf = params_from_jax(np_params, model.config, dtype=torch.bfloat16,
                         device="cpu")
    assert bf["layers"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_engine_without_device_needs_cuda():
    model, params = _torch_model("tiny")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model, params, dtype=torch.float32, **ENGINE_KW)


@pytest.mark.parametrize("kind,name", [
    ("prefill_attn", "flash"), ("prefill_attn", "kernel_interpret"),
    ("decode_attn", "pallas_interpret"), ("decode_attn", "flash")])
def test_unported_impls_name_the_registered_ones(kind, name):
    model, params = _torch_model("tiny")
    with pytest.raises(ValueError, match="registered: .*kernel.*xla"):
        InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                          **dict(ENGINE_KW, **{kind: name}))


@pytest.mark.parametrize("kw,what", [
    (dict(decode_steps_per_dispatch=4), "fused-K decode"),
    (dict(quantize_weights=True), "quantized weights")])
def test_unported_features_raise(kw, what):
    model, params = _torch_model("tiny")
    with pytest.raises(NotImplementedError, match=what):
        InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                          **dict(ENGINE_KW, **kw))


def test_unported_methods_and_moe_raise():
    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **ENGINE_KW)
    for call in (lambda: eng.warmup(), lambda: eng.serialize("x"),
                 lambda: eng.install_prefix_cache(),
                 lambda: InferenceEngineV2.deserialize("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    moe = build_model("tiny-moe", dtype="float32")
    with pytest.raises(NotImplementedError, match="MoE"):
        InferenceEngineV2(moe, {}, device="cpu", **ENGINE_KW)
    # per-layer windows make layers differ: the ragged engine refuses them,
    # as the JAX package's does (it needs identical, stacked layers)
    neo = build_model("tiny", attn_windows=(None, 4))
    with pytest.raises(ValueError, match="attn_windows"):
        InferenceEngineV2(neo, params, device="cpu", **ENGINE_KW)


def test_structured_admission_and_token_validation():
    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **ENGINE_KW)
    out = eng.put([7, 7], [[1, 2, 3], [4, 5]])
    assert 7 in out.admission.admitted and 7 in out.admission.rejected
    assert eng.seqs[7].n_cached == 3
    assert not eng.can_schedule([9], [65])          # over max_context
    with pytest.raises(ValueError, match="vocabulary"):
        eng.put([8], [[model.config.vocab_size]])
    used = eng.allocator.free_blocks
    eng.flush([7])
    assert eng.allocator.free_blocks > used
    assert eng.query(7) is None
    cfg = dataclasses.asdict(eng.config)
    assert cfg["dtype"] == torch.float32
