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
``tiny`` through both engines' kernel paths (logits at 4e-3). MoE models
(``tiny-moe``) and quantized weights (int8, int4) are held the same way.
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
from deepspeedsyclsupport_tpu_torch.compression.quantize import (
    QuantTensor, quantize_tree)
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
    # the port's pool ends in the sink block, where the rows the JAX
    # package drops are written: compare the allocatable blocks
    slots = jkv.k.shape[1]
    assert tkv.k.shape[1] == slots + 8
    np.testing.assert_allclose(tkv.k.numpy()[:, :slots], np.asarray(jkv.k),
                               atol=TOL, rtol=TOL)
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
    np.testing.assert_allclose(tkv.v.numpy()[:, :slots], np.asarray(jkv.v),
                               atol=TOL, rtol=TOL)


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
    ("prefill_attn", "kernel_interpret"),
    ("decode_attn", "pallas_interpret"), ("decode_attn", "flash")])
def test_unported_impls_name_the_registered_ones(kind, name):
    model, params = _torch_model("tiny")
    with pytest.raises(ValueError, match="registered: .*kernel.*xla"):
        InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                          **dict(ENGINE_KW, **{kind: name}))


@pytest.mark.parametrize("call", ["apply", "loss"])
def test_unported_features_raise(call):
    """MoE models run the dense model's MoE trunk (the capacity-buffer
    ``moe_mlp``, ``tests/test_torch_moe_train.py``); a model built for a
    pipelined trunk (A.3.1.1), called directly, runs the layers its params
    hold in order, which is the pipeline's function: equal to the
    unpipelined model's."""
    ids = torch.tensor([[1, 2, 3]])
    plain = build_model("tiny", dtype="float32")
    for name, over, pipelined in (("tiny-moe", {}, False),
                                  ("tiny", {"pipe_stages": 2}, True)):
        model = build_model(name, dtype="float32", **over)
        params = model.init_params(device="cpu")

        def fn(m):
            return {"apply": lambda: m.apply(params, ids),
                    "loss": lambda: m.loss(params, {"input_ids": ids})[0]
                    }[call]()

        out = fn(model)
        if pipelined:
            assert torch.equal(out, fn(plain))
        else:
            assert set(params["layers"][0]["moe"]) == {
                "router", "w_gate", "w_up", "w_down"}
            assert torch.isfinite(out).all()


def test_unported_methods_and_moe_raise(tmp_path):
    """The engine snapshot used to raise: it is ported now and round-trips
    (``tests/test_torch_snapshot.py`` holds it against the JAX package's);
    MoE and quantized models build (they used to raise); per-layer windows
    still raise."""
    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **ENGINE_KW)
    eng.serialize(str(tmp_path / "snap"))
    again = InferenceEngineV2.deserialize(str(tmp_path / "snap"),
                                          device="cpu", **ENGINE_KW)
    assert torch.equal(again.put([0], [PROMPT])[0], eng.put([0], [PROMPT])[0])
    moe = build_model("tiny-moe", dtype="float32")
    InferenceEngineV2(moe, moe.init_params(device="cpu"), device="cpu",
                      quantize_weights=True, **ENGINE_KW)
    # per-layer windows make layers differ: the ragged engine refuses them,
    # as the JAX package's does (it needs identical, stacked layers)
    neo = build_model("tiny", attn_windows=(None, 4))
    with pytest.raises(ValueError, match="attn_windows"):
        InferenceEngineV2(neo, params, device="cpu", **ENGINE_KW)


# --------------------------------------------- MoE and quantized weights
# The JAX engine with ZeRO-Inference weights (quantize_weights: int8 / int4,
# group 64) and MoE models (exact top-k through ragged_dot) against the
# port's: put logits at TOL, greedy tokens equal. "moe-wide-int8" has
# hidden 512 and 8 experts, so its router [512, 8] reaches min_size and is
# quantized with one scale a row.
MOE_CASES = {
    "moe": ("tiny-moe", (), {}),
    "int8": ("tiny", (), dict(quantize_weights=True)),
    "int4": ("tiny", (), dict(quantize_weights=True, quant_bits=4)),
    "moe-wide-int8": ("tiny-moe", (("hidden_size", 512), ("num_experts", 8)),
                      dict(quantize_weights=True)),
}


@functools.lru_cache(maxsize=None)
def _jax_preset(preset, over):
    model = jax_build_model(preset, dtype="float32", **dict(over))
    params = model.init_params(jax.random.PRNGKey(11))
    return model, params, jax.tree.map(np.asarray, params)


def _torch_preset(preset, over=()):
    _, _, np_params = _jax_preset(preset, over)
    model = build_model(preset, dtype="float32", **dict(over))
    return model, params_from_jax(np_params, model.config, device="cpu")


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_and_quantized_engine_match_jax(case):
    preset, over, qkw = MOE_CASES[case]
    jmodel, jparams, _ = _jax_preset(preset, over)
    jp, jd, jtoks = _serve(JaxEngine(jmodel, jparams, dtype=jnp.float32,
                                     **ENGINE_KW, **qkw), np.asarray)
    model, params = _torch_preset(preset, over)
    if model.config.any_moe:     # params_from_jax unstacks the moe subtree
        np_moe = _jax_preset(preset, over)[2]["layers"]["moe"]
        for li, layer in enumerate(params["layers"]):
            for name, t in layer["moe"].items():
                np.testing.assert_array_equal(t.numpy(), np_moe[name][li])
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **ENGINE_KW, **qkw)
    layer = eng.params["layers"][0]
    if qkw:
        wq = layer["attn"]["wq"]
        assert isinstance(wq, QuantTensor)
        assert wq.bits == qkw.get("quant_bits", 8)
        assert not isinstance(layer["attn_norm"]["scale"], QuantTensor)
    router = layer["moe"]["router"] if model.config.any_moe else None
    assert isinstance(router, QuantTensor) == (case == "moe-wide-int8")
    tp, td, ttoks = _serve(eng, lambda t: t.numpy())
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(td, jd, atol=TOL, rtol=TOL)
    assert ttoks == jtoks
    assert all(len(t) == NEW_TOKENS for t in ttoks)


def test_fused_decode_matches_jax_moe():
    """Fused K = 4 decode of an int8 MoE model: greedy tokens, host
    dispatches and the rungs run equal the JAX engine's."""
    kw = dict(ENGINE_KW, decode_steps_per_dispatch=4, quantize_weights=True)
    jmodel, jparams, _ = _jax_preset("tiny-moe", ())
    jeng = JaxEngine(jmodel, jparams, dtype=jnp.float32, **kw)
    want = jeng.generate(FUSED_PROMPTS, max_new_tokens=9)
    model, params = _torch_preset("tiny-moe")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **kw)
    assert eng.generate(FUSED_PROMPTS, max_new_tokens=9) == want
    assert eng.host_dispatches == jeng.host_dispatches
    assert list(eng._decode_multi) == list(jeng._decode_multi)


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


# ------------------------------------------------------------ fused decode
# The JAX package's fused K-step decode (tests/unit/test_inference_v2.py
# TestMultiStepDecode): the port runs the same ladder and retirement rules,
# so greedy tokens AND host dispatch counts equal the JAX engine's. On the
# CPU the port's bodies run eagerly (CUDA graphs on the card).
FUSED_PROMPTS = [[7, 3, 11], [4, 100, 42, 8, 19], [9]]
LONG_PROMPT = [int(t) for t in
               np.random.RandomState(2).randint(1, 500, size=14)]
WAVES = [[int(t) for t in np.random.RandomState(1).randint(1, 500, size=n)]
         for n in (2, 5, 3, 4, 2)]
# name -> (engine overrides, prompts, generate kwargs); "eos" takes its
# token from the per-token greedy output of its prompts
FUSED_CASES = {
    "budget": ({}, FUSED_PROMPTS, dict(max_new_tokens=9)),
    "eos": ({}, FUSED_PROMPTS[:2], dict(max_new_tokens=8)),
    "context-cap": (dict(max_context=16), [LONG_PROMPT],
                    dict(max_new_tokens=8)),
    "waves": (dict(max_sequences=2), WAVES, dict(max_new_tokens=4)),
    "kv-pressure": (dict(num_blocks=4, max_context=32),
                    [[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                    dict(max_new_tokens=6)),
}


@functools.lru_cache(maxsize=None)
def _jax_eos():
    model, params, _ = _jax_model("tiny")
    base = JaxEngine(model, params, dtype=jnp.float32, **ENGINE_KW).generate(
        FUSED_CASES["eos"][1], max_new_tokens=8)
    return base[0][2]


def _fused_case(name, k):
    over, prompts, gen_kw = FUSED_CASES[name]
    gen_kw = dict(gen_kw)
    if name == "eos":
        gen_kw["eos_token_id"] = _jax_eos()
    return dict(ENGINE_KW, decode_steps_per_dispatch=k, **over), prompts, \
        gen_kw


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_decode_matches_jax(case, k):
    """Greedy tokens, host dispatches, the rungs run and the pool after
    retirement equal the JAX engine's, with retirement on budget, EOS and
    the context cap inside the fused loop, admission waves and KV-pressure
    fallback to the per-token path."""
    kw, prompts, gen_kw = _fused_case(case, k)
    jmodel, jparams, _ = _jax_model("tiny")
    jeng = JaxEngine(jmodel, jparams, dtype=jnp.float32, **kw)
    want = jeng.generate(prompts, **gen_kw)
    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **kw)
    got = eng.generate(prompts, **gen_kw)
    assert got == want
    assert eng.host_dispatches == jeng.host_dispatches
    assert list(eng._decode_multi) == list(jeng._decode_multi)
    assert not eng.seqs
    assert eng.allocator.free_blocks == jeng.allocator.free_blocks \
        == eng.config.num_blocks
    if case == "eos":
        assert got[0][-1] == gen_kw["eos_token_id"]


def test_fused_decode_reduces_dispatches_and_samples_in_budget():
    """12 tokens at K = 6 take a third of the per-token path's dispatches
    (the JAX package's test_dispatch_count_amortized); sampled fused decode
    with tensor temperature / top_p stays within budget and flushes."""
    model, params = _torch_model("tiny")
    make = functools.partial(InferenceEngineV2, model, params, device="cpu",
                             dtype=torch.float32)
    per_tok = make(**ENGINE_KW)
    per_tok.generate([[5, 6, 7]], max_new_tokens=12)
    fused = make(decode_steps_per_dispatch=6, **ENGINE_KW)
    fused.generate([[5, 6, 7]], max_new_tokens=12)
    assert fused.host_dispatches <= per_tok.host_dispatches // 3
    eng = make(decode_steps_per_dispatch=4, **ENGINE_KW)
    for t, p, eos in [(0.7, 0.9, None), (1.3, 0.8, 42), (0.5, 0.95, 7)]:
        got = eng.generate([[7, 3, 11], [4, 9]], max_new_tokens=7,
                           do_sample=True, temperature=t, top_k=20, top_p=p,
                           eos_token_id=eos)
        assert all(1 <= len(g) <= 7 for g in got)
        assert not eng.seqs
    # temperature / top_p / eos are inputs: one body per structure
    assert len(eng._decode_multi) == 1


@pytest.mark.parametrize("k,ladder", [(1, False), (4, False), (8, True)])
def test_warmup_leaves_engine_clean_and_serving_exact(k, ladder):
    """warmup() admits, prefills and decodes a reserved sequence and, with
    K > 1, runs the fused rung K (every rung with ``fused_ladder``); it
    leaves no sequence, every block free and ``host_dispatches`` 0, the
    same rungs as the JAX engine's warmup, and serving exact."""
    kw = dict(ENGINE_KW, decode_steps_per_dispatch=k)
    jmodel, jparams, _ = _jax_model("tiny")
    jeng = JaxEngine(jmodel, jparams, dtype=jnp.float32, **kw)
    jeng.warmup(fused_ladder=ladder)
    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **kw)
    eng.warmup(fused_ladder=ladder)
    assert not eng.seqs and eng.host_dispatches == 0
    assert eng.allocator.free_blocks == eng.config.num_blocks
    assert list(eng._decode_multi) == list(jeng._decode_multi)
    got = eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    assert got == jeng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    assert eng.host_dispatches == jeng.host_dispatches


def test_warmup_raises_when_it_cannot_admit():
    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **dict(ENGINE_KW, max_sequences=1))
    eng.put([3], [[1, 2, 3]])
    with pytest.raises(RuntimeError, match="warmup could not admit"):
        eng.warmup()
    assert list(eng.seqs) == [3]


# ---------------------------------------------------- the flash prefill impl
FLASH_TOL = 2e-5


def test_flash_prefill_matches_jax_flash():
    """``prefill_attn="flash"`` (KV gathered once per sequence, the flash
    kernel's wrapper with segments and positions; its plain version on the
    CPU) against the JAX engine's ``flash`` impl (its Pallas kernels in
    interpret mode, as the JAX package's tests run it): ragged prefill and
    decode logits within 2e-5 in float32, greedy tokens equal; ``auto``
    never selects it."""
    jmodel, jparams, _ = _jax_model("gqa_window")
    jeng = JaxEngine(jmodel, jparams, dtype=jnp.float32, prefill_attn="flash",
                     **ENGINE_KW)
    jp, jd, jtoks = _serve(jeng, np.asarray)
    model, params = _torch_model("gqa_window")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            prefill_attn="flash", **ENGINE_KW)
    tp, td, ttoks = _serve(eng, lambda t: t.numpy())
    np.testing.assert_allclose(tp, jp, atol=FLASH_TOL, rtol=FLASH_TOL)
    np.testing.assert_allclose(td, jd, atol=FLASH_TOL, rtol=FLASH_TOL)
    assert ttoks == jtoks
    from deepspeedsyclsupport_tpu_torch.inference.v2.module_registry import (
        select_impl)
    for backend in ("cpu", "cuda"):
        assert select_impl("prefill_attn", "auto", {
            "backend": backend, "has_atoms": True}).name != "flash"


# --------------------------------------------------------- capture safety
def _decode_inputs(model, s=4, bps=8, bs=8):
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        RaggedInferenceConfig, init_blocked_kv)

    kv = init_blocked_kv(model.config, RaggedInferenceConfig(
        dtype=torch.float32, block_size=bs, max_context=bps * bs,
        max_sequences=s, num_blocks=s * bps), torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    kv.k.normal_(generator=g)
    kv.v.normal_(generator=g)
    tables = torch.arange(s * bps, dtype=torch.int32).reshape(s, bps)
    positions = torch.tensor([5, 17, 0, 30], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    logits0 = torch.randn((s, model.config.vocab_size), generator=g)
    return kv, tables, positions, active, logits0


def test_decode_bodies_read_nothing_back_to_the_host(monkeypatch):
    """What a CUDA graph cannot hold: a value read back to the host
    (``nonzero``, ``item``, ``tolist``, ``bool``) or a tensor made from host
    data. ``decode_forward`` and ``decode_multi_forward`` (greedy and
    sampled, tensor temperature / top_p / eos, ALiBi) run with all of those
    patched to raise, after one unpatched call that builds the cached
    device constants (the capture's warm-up run); the third model is an
    int8 MoE model (dequantized per layer, experts through the CPU's plain
    route)."""
    from deepspeedsyclsupport_tpu_torch.inference.v2.model import (
        decode_multi_forward)

    moe_model, moe_params = _torch_preset("tiny-moe")
    moe_params["layers"] = quantize_tree(moe_params["layers"], 64)
    for model, params in (_torch_model("tiny"), _torch_model("alibi"),
                          (moe_model, moe_params)):
        kv, tables, positions, active, logits0 = _decode_inputs(model)
        tokens = torch.tensor([3, 9, 0, 4], dtype=torch.int32)
        steps = torch.tensor([3, 1, 0, 5], dtype=torch.int32)
        temp, top_p = torch.tensor(0.8), torch.tensor(0.9)
        eos = torch.tensor(-1, dtype=torch.int32)

        def run():
            decode_forward(model, params, kv, tokens, positions, tables,
                           active, block_size=8, attn_impl="kernel")
            for struct in ((False, 0, False), (True, 5, True)):
                decode_multi_forward(
                    model, params, kv, logits0, positions, tables, active,
                    steps, torch.Generator().manual_seed(1), temp, top_p,
                    eos, block_size=8, num_steps=3, samp_struct=struct,
                    max_context=64, attn_impl="kernel")

        run()

        def refuse(*a, **k):
            raise AssertionError("host read or host tensor in a decode body")

        with monkeypatch.context() as m:
            for name in ("nonzero", "item", "tolist", "__bool__"):
                m.setattr(torch.Tensor, name, refuse)
            m.setattr(torch, "tensor", refuse)
            m.setattr(torch, "from_numpy", refuse)
            run()


def test_sink_block_is_never_allocated_or_read():
    """The pool's last block (the sink) takes the rows the JAX package
    drops: no allocation hands it out, no block table names it, and a sink
    full of NaN changes no logit or token (fused and per-token decode)."""
    model, params = _torch_model("tiny")
    for k in (1, 4):
        kw = dict(ENGINE_KW, decode_steps_per_dispatch=k)
        ref = InferenceEngineV2(model, params, device="cpu",
                                dtype=torch.float32, **kw)
        want = ref.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
        eng = InferenceEngineV2(model, params, device="cpu",
                                dtype=torch.float32, **kw)
        bs, nb = eng.config.block_size, eng.config.num_blocks
        assert eng.kv.k.shape[1] == (nb + 1) * bs
        eng.kv.k[:, nb * bs:] = float("nan")
        eng.kv.v[:, nb * bs:] = float("nan")
        seen = set()
        put = eng.put

        def spying_put(uids, toks, **kw_):
            out = put(uids, toks, **kw_)
            for d in eng.seqs.values():
                seen.update(d.blocks)
            assert all(bool(torch.isfinite(lg).all()) for lg in out.values())
            return out

        eng.put = spying_put
        assert eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS) == want
        assert seen and max(seen) < nb
        assert eng.allocator.free_blocks == nb
        # dead rows were written there (a padded prefill, an idle slot)
        assert not bool(torch.isnan(eng.kv.k[:, nb * bs:]).all())


def test_engine_is_freed_by_its_last_reference():
    """The decode bodies hold the model, params and pool, not the engine:
    dropping the last reference frees the engine and its KV pool at once
    (on the card, its CUDA graphs and their memory too), with the garbage
    collector off."""
    import gc
    import weakref

    model, params = _torch_model("tiny")
    eng = InferenceEngineV2(model, params, device="cpu", dtype=torch.float32,
                            **dict(ENGINE_KW, decode_steps_per_dispatch=4))
    eng.install_prefix_cache()
    eng.warmup(fused_ladder=True)
    eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    refs = (weakref.ref(eng), weakref.ref(eng.kv.k))
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
