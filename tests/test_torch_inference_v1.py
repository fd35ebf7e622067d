"""PyTorch port: the v1 inference engine (``init_inference``) against the
JAX package's on ``tiny``, float32, on the CPU.

The same weights (the JAX init, converted with ``params_from_jax``) are
served by both engines. Mirrors the JAX package's ``tests/unit/
test_inference.py`` (greedy = the full forward's argmax loop; a
right-padded ragged batch = each prompt alone, ALiBi and sliding window
included; EOS padding; ``max_seq_len``; the chunked prefill's causality;
reproducible sampling; config parsing and the unknown-key rejection) and
``tests/unit/test_zero_inference.py`` (int8 / int4 weights, ``quant`` with
tp > 1 raises, ``kv_offload`` parity). Tolerances are the JAX package's
own: tokens EQUAL (to the JAX engine's as well as to the port's full
forward), logits 2e-4. On the CPU the port's attention is the plain
version; the tp2 leg runs in ``tests/test_torch_dist_serve.py``'s spawn.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.inference import init_inference as jax_init
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.models import get_config as jax_get_config
from deepspeedsyclsupport_tpu_torch import init_inference
from deepspeedsyclsupport_tpu_torch.compression.quantize import (
    QuantTensor, quantize_tree)
from deepspeedsyclsupport_tpu_torch.inference import (DSTpuInferenceConfig,
                                                      InferenceEngine)
from deepspeedsyclsupport_tpu_torch.models import (build_model, get_config,
                                                   params_from_jax)

TOL = 2e-4
ARCHS = {"tiny": {}, "alibi": {"pos_embed": "alibi"},
         "window": {"sliding_window": 4}}
P1 = np.array([7, 3, 11], dtype=np.int64)
P2 = np.array([4, 100, 42, 8, 19], dtype=np.int64)
PROMPT = np.array([1, 5, 9, 200, 3], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _models(arch="tiny"):
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32",
                               **ARCHS[arch])
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(21))
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32",
                              **ARCHS[arch])
    m = build_model(cfg)
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")


def _engines(arch="tiny", **cfg):
    jm, jp, m, p = _models(arch)
    cfg.setdefault("dtype", "fp32")
    return (jax_init(model=jm, params=jp, config=dict(cfg)),
            init_inference(model=m, params=p, config=dict(cfg),
                           device="cpu"))


def _naive_greedy(model, params, prompt, n):
    """The full forward each step, argmax of the last position."""
    seq = list(prompt)
    out = []
    for _ in range(n):
        logits = model.apply(params, torch.tensor([seq]))
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        seq.append(nxt)
    return out


def _ragged_batch():
    batch = np.zeros((2, 5), np.int64)
    batch[0, :3] = P1
    batch[1] = P2
    return batch


def _jgen(eng, ids, **kw):
    return np.asarray(eng.generate(jnp.asarray(ids, jnp.int32), **kw))


def _tgen(eng, ids, **kw):
    return eng.generate(torch.as_tensor(ids), **kw).numpy()


class TestGenerate:
    def test_greedy_matches_full_forward_and_jax(self):
        _, _, m, p = _models()
        je, te = _engines()
        got = _tgen(te, PROMPT[None], max_new_tokens=8)
        assert got.shape == (1, 8)
        assert list(got[0]) == _naive_greedy(m, p, PROMPT, 8)
        np.testing.assert_array_equal(got, _jgen(je, PROMPT[None],
                                                 max_new_tokens=8))

    @pytest.mark.parametrize("arch", list(ARCHS))
    def test_ragged_batch_matches_individual_and_jax(self, arch):
        _, _, m, p = _models(arch)
        je, te = _engines(arch)
        got = _tgen(te, _ragged_batch(), prompt_lens=[3, 5],
                    max_new_tokens=6)
        assert list(got[0]) == _naive_greedy(m, p, P1, 6)
        assert list(got[1]) == _naive_greedy(m, p, P2, 6)
        np.testing.assert_array_equal(got, _jgen(
            je, _ragged_batch(), prompt_lens=jnp.array([3, 5]),
            max_new_tokens=6))

    def test_eos_padding(self):
        je, te = _engines(pad_token_id=0)
        first = _tgen(te, PROMPT[None], max_new_tokens=4)
        eos = int(first[0, 1])
        got = _tgen(te, PROMPT[None], max_new_tokens=6, eos_token_id=eos)
        assert got[0, 1] == eos
        assert all(t == 0 for t in got[0, 2:])
        np.testing.assert_array_equal(got, _jgen(
            je, PROMPT[None], max_new_tokens=6, eos_token_id=eos))

    def test_eos_rebind(self):
        _, te = _engines(pad_token_id=0)
        first = _tgen(te, PROMPT[None], max_new_tokens=4)
        eos_a, eos_b = int(first[0, 1]), int(first[0, 2])
        got_a = _tgen(te, PROMPT[None], max_new_tokens=4, eos_token_id=eos_a)
        got_b = _tgen(te, PROMPT[None], max_new_tokens=4, eos_token_id=eos_b)
        assert all(t == 0 for t in got_a[0, 2:])
        assert got_b[0, 1] == eos_a and got_b[0, 2] == eos_b
        assert all(t == 0 for t in got_b[0, 3:])

    def test_max_seq_len_enforced(self):
        _, te = _engines(max_seq_len=16)
        with pytest.raises(ValueError, match="max_seq_len"):
            te.generate(torch.ones((1, 10), dtype=torch.long),
                        max_new_tokens=10)

    def test_max_out_tokens_clamps(self):
        _, te = _engines(max_out_tokens=3)
        assert _tgen(te, PROMPT[None], max_new_tokens=8).shape == (1, 3)

    def test_chunked_prefill_causality(self):
        """``decode_step`` over a 6-token chunk with an all-visible
        ``kv_mask`` stays causal within the chunk: its logits are the full
        forward's, and the JAX package's."""
        jm, jp, m, p = _models()
        ids = [[1, 5, 9, 200, 3, 17]]
        full = m.apply(p, torch.tensor(ids))
        cache = m.init_kv_cache(1, 8, dtype=torch.float32, device="cpu")
        kv_mask = (torch.arange(8) < 6)[None]
        logits, cache2 = m.decode_step(p, cache, torch.tensor(ids),
                                       positions=torch.arange(6)[None],
                                       kv_mask=kv_mask)
        np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=TOL,
                                   atol=TOL)
        jcache = jm.init_kv_cache(1, 8, dtype=jnp.float32)
        jlogits, _ = jm.decode_step(jp, jcache, jnp.asarray(ids),
                                    positions=jnp.arange(6)[None],
                                    kv_mask=jnp.asarray(kv_mask.numpy()))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
        assert cache2.write_pos == 6

    def test_decode_step_writes_the_cache_in_place(self):
        _, _, m, p = _models()
        cache = m.init_kv_cache(1, 8, dtype=torch.float32, device="cpu")
        ptr = (cache.k.data_ptr(), cache.v.data_ptr())
        _, cache = m.decode_step(p, cache, torch.tensor([[1, 5, 9]]))
        _, cache = m.decode_step(p, cache, torch.tensor([[4]]))
        assert (cache.k.data_ptr(), cache.v.data_ptr()) == ptr
        assert cache.write_pos == 4
        assert cache.k[:, :, :4].abs().sum() > 0
        assert cache.k[:, :, 4:].abs().sum() == 0

    def test_sampling_reproducible_and_diverse(self):
        _, te = _engines()
        prompt = np.array([[1, 5, 9]])

        def draw(seed):
            return _tgen(te, prompt, max_new_tokens=8, do_sample=True,
                         temperature=2.0,
                         generator=torch.Generator().manual_seed(seed))

        np.testing.assert_array_equal(draw(7), draw(7))
        assert not np.array_equal(draw(7), draw(8))

    def test_forward_logits(self):
        je, te = _engines()
        ids = np.array([[1, 2, 3, 4]])
        np.testing.assert_allclose(
            te(torch.as_tensor(ids)).numpy(),
            np.asarray(je(jnp.asarray(ids, jnp.int32))), rtol=TOL, atol=TOL)
        assert te.host_dispatches == 1


class TestConfig:
    def test_reference_style_config(self):
        cfg = DSTpuInferenceConfig.from_config(
            {"dtype": "fp16", "mp_size": 4, "replace_with_kernel_inject": True,
             "max_out_tokens": 256})
        assert cfg.tensor_parallel.tp_size == 4
        assert cfg.dtype == torch.float16
        assert cfg.max_out_tokens == 256

    @pytest.mark.parametrize("bad", [{"definitely_not_a_key": 1},
                                     {"dtype": "fp8"},
                                     {"quant": {"bits": 3}}])
    def test_bad_config_rejected(self, bad):
        with pytest.raises(ValueError):
            DSTpuInferenceConfig.from_config(bad)

    def test_kv_offload_key_parses(self):
        assert DSTpuInferenceConfig.from_config(
            {"kv_offload": True}).kv_offload
        assert not DSTpuInferenceConfig.from_config({}).kv_offload

    def test_entry_point_runs_on_the_card_unless_asked(self):
        _, _, m, p = _models()
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_inference(model=m, params=p, dtype="fp32")

    def test_string_model_names_the_roadmap_item(self):
        with pytest.raises(NotImplementedError, match="A.3.5.4"):
            init_inference(model="/some/hf/dir", device="cpu")

    def test_tp_without_a_process_group_raises(self):
        _, _, m, p = _models()
        with pytest.raises(RuntimeError, match="init_distributed"):
            InferenceEngine(m, p, DSTpuInferenceConfig.from_config(
                {"dtype": "fp32", "tensor_parallel": {"tp_size": 2}}),
                device="cpu")


class TestZeroInference:
    def test_int8_serving(self):
        jm, jp, m, p = _models()
        fp = init_inference(model=m, params=p, dtype="fp32", max_seq_len=64,
                            device="cpu")
        q = init_inference(model=m, params=p, dtype="fp32", max_seq_len=64,
                           quant={"enabled": True, "group_size": 64,
                                  "min_size": 512}, device="cpu")
        nbytes = lambda layers: sum(
            x.q.numel() + 4 * x.scale.numel() if isinstance(x, QuantTensor)
            else x.numel() * x.element_size()
            for layer in layers for x in _leaves(layer))
        assert nbytes(q.params["layers"]) < nbytes(fp.params["layers"]) / 2.5
        # the codes are quantize_tree's (the JAX rules, test_torch_quantize)
        want = quantize_tree(p["layers"], 64, 512)
        got = q.params["layers"]
        for a, b in zip(_leaves(got[0]), _leaves(want[0])):
            if isinstance(a, QuantTensor):
                assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        prompt = np.array([[3, 17, 88, 5]])
        lf, lq = fp(torch.as_tensor(prompt)), q(torch.as_tensor(prompt))
        assert int(torch.argmax(lq[0, -1])) == int(torch.argmax(lf[0, -1]))
        jq = jax_init(model=jm, params=jp, dtype="float32", max_seq_len=64,
                      quant={"enabled": True, "group_size": 64,
                             "min_size": 512})
        np.testing.assert_allclose(
            lq.numpy(), np.asarray(jq(jnp.asarray(prompt, jnp.int32))),
            rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(
            _tgen(q, prompt, max_new_tokens=4),
            _jgen(jq, prompt, max_new_tokens=4))

    def test_int4_serving(self):
        je, te = _engines(quant={"enabled": True, "bits": 4,
                                 "group_size": 32})
        got = _tgen(te, PROMPT[None], max_new_tokens=4)
        np.testing.assert_array_equal(got, _jgen(je, PROMPT[None],
                                                 max_new_tokens=4))
        assert any(isinstance(x, QuantTensor) and x.bits == 4
                   for x in _leaves(te.params["layers"][0]))

    def test_quant_rejects_tp(self):
        _, _, m, p = _models()
        with pytest.raises(ValueError, match="tensor_parallel"):
            init_inference(model=m, params=p, dtype="float32",
                           tensor_parallel={"tp_size": 2}, quant=True,
                           device="cpu")

    @pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
    def test_kv_offload_parity(self, quant):
        cfg = {"quant": {"enabled": True}} if quant else {}
        _, base = _engines(**cfg)
        _, off = _engines(kv_offload=True, **cfg)
        want = _tgen(base, _ragged_batch(), prompt_lens=[3, 5],
                     max_new_tokens=8)
        got = _tgen(off, _ragged_batch(), prompt_lens=[3, 5],
                    max_new_tokens=8)
        np.testing.assert_array_equal(got, want)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
