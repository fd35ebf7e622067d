"""PyTorch port: the engine snapshot (``serialize`` / ``deserialize``) and
the native checkpoint format against the JAX package's.

``tiny`` on the CPU, the same JAX-initialised weights in both engines. A
snapshot written by the JAX engine is served by the port
(``deserialize(device="cpu")``) and one written by the port by the JAX
engine: prefill logits within 2e-4 of the writer's engine (the engine
tests' tolerance; the two packages sum in other orders) and greedy tokens
equal. For the same params both packages write the same ``state.bin``
bytes, the same index (names, shapes, dtypes, crc32) and the same meta, in
float32 and in bfloat16. A quantized engine saves dequantized weights; a
torn or bit-flipped ``state.bin`` raises ``CheckpointCorruptionError``.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.checkpoint import engine as jax_ckpt
from deepspeedsyclsupport_tpu.inference.v2 import (
    InferenceEngineV2 as JaxEngine)
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu_torch.checkpoint import engine as ckpt
from deepspeedsyclsupport_tpu_torch.compression.quantize import QuantTensor
from deepspeedsyclsupport_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeedsyclsupport_tpu_torch.models import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
    configure_fault_injection)

TOL = 2e-4
ENGINE_KW = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
                 max_sequences=4)
PROMPTS = [[7, 3, 11, 40, 2], [4, 100, 42, 8, 19, 6, 1, 77, 3]]
NEW = 6


@functools.lru_cache(maxsize=None)
def _weights():
    model = jax_build_model("tiny", dtype="float32")
    params = model.init_params(jax.random.PRNGKey(5))
    return model, params, jax.tree.map(np.asarray, params)


def _jax_engine(dtype=jnp.float32, **kw):
    model, params, _ = _weights()
    return JaxEngine(model, params, dtype=dtype, **dict(ENGINE_KW, **kw))


def _torch_engine(dtype=torch.float32, **kw):
    _, _, np_params = _weights()
    model = build_model("tiny", dtype="float32")
    return InferenceEngineV2(model, params_from_jax(np_params, model.config,
                                                    device="cpu"),
                             device="cpu", dtype=dtype,
                             **dict(ENGINE_KW, **kw))


def _serve(eng, as_np):
    out = eng.put([0, 1], PROMPTS)
    logits = np.stack([as_np(out[u]) for u in (0, 1)])
    eng.flush([0, 1])
    return logits, eng.generate(PROMPTS, max_new_tokens=NEW)


def _np(t):
    return t.float().numpy()


def test_jax_snapshot_serves_in_the_port(tmp_path):
    jeng = _jax_engine()
    jeng.serialize(str(tmp_path / "snap"))
    want_logits, want_toks = _serve(jeng, np.asarray)
    eng = InferenceEngineV2.deserialize(str(tmp_path / "snap"),
                                        device="cpu")
    assert eng.device.type == "cpu"
    assert eng.config.dtype == torch.float32
    assert isinstance(eng.params["layers"], list)
    logits, toks = _serve(eng, _np)
    np.testing.assert_allclose(logits, want_logits, atol=TOL, rtol=TOL)
    assert toks == want_toks


def test_port_snapshot_serves_in_jax(tmp_path):
    eng = _torch_engine()
    eng.serialize(str(tmp_path / "snap"))
    want_logits, want_toks = _serve(eng, _np)
    jeng = JaxEngine.deserialize(str(tmp_path / "snap"))
    logits, toks = _serve(jeng, np.asarray)
    np.testing.assert_allclose(logits, want_logits, atol=TOL, rtol=TOL)
    assert toks == want_toks
    # and back in the port: bit-equal logits
    again = InferenceEngineV2.deserialize(str(tmp_path / "snap"),
                                          device="cpu")
    np.testing.assert_array_equal(_serve(again, _np)[0], want_logits)


def _read(path, name):
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_bytes_equal_jax(tmp_path, dtype):
    _jax_engine(dtype=jnp.dtype(dtype)).serialize(str(tmp_path / "j"))
    _torch_engine(dtype=getattr(torch, dtype)).serialize(str(tmp_path / "t"))
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    index = json.loads(_read(t, ckpt.INDEX_FILE))
    assert index == json.loads(_read(j, ckpt.INDEX_FILE))
    assert {e["dtype"] for e in index} == {dtype}
    assert any(e["name"] == "params/layers/attn/wq"
               and e["shape"][0] == 2 for e in index)
    assert _read(t, ckpt.DATA_FILE) == _read(j, ckpt.DATA_FILE)
    assert json.loads(_read(t, ckpt.META_FILE)) == \
        json.loads(_read(j, ckpt.META_FILE))
    for fname in (ckpt.COMMIT_FILE, ckpt.rank_manifest_name(0)):
        assert _read(t, fname) == _read(j, fname)
    assert ckpt.verify_tree(j) == (True, "ok")
    assert jax_ckpt.verify_tree(t) == (True, "ok")


def test_quantized_engine_saves_dequantized_weights(tmp_path):
    eng = _torch_engine(quantize_weights=True)
    layer0 = eng.params["layers"][0]
    assert isinstance(layer0["attn"]["wq"], QuantTensor)
    eng.serialize(str(tmp_path / "q"))
    index = {e["name"]: e for e in
             json.loads(_read(str(tmp_path / "q"), ckpt.INDEX_FILE))}
    assert index["params/layers/attn/wq"]["dtype"] == "float32"
    template = {"params": {"layers": {"attn": {"wq": torch.empty(
        index["params/layers/attn/wq"]["shape"], device="meta")}}}}
    state, meta = ckpt.load_tree(str(tmp_path / "q"), template, device="cpu")
    want = torch.stack([lay["attn"]["wq"].dequantize(torch.float32)
                        for lay in eng.params["layers"]])
    assert torch.equal(state["params"]["layers"]["attn"]["wq"], want)
    assert meta["engine_config"]["quantize_weights"] is True
    # served again (re-quantized) by both packages, tokens as the writer's
    toks = _serve(eng, _np)[1]
    assert _serve(InferenceEngineV2.deserialize(str(tmp_path / "q"),
                                                device="cpu"), _np)[1] == toks
    assert _serve(JaxEngine.deserialize(str(tmp_path / "q")),
                  np.asarray)[1] == toks


def test_torn_and_flipped_state_raise(tmp_path):
    path = str(tmp_path / "snap")
    _torch_engine().serialize(path)
    data = os.path.join(path, ckpt.DATA_FILE)
    raw = _read(path, ckpt.DATA_FILE)
    with open(data, "wb") as f:
        f.write(raw[:len(raw) // 2])
    ok, reason = ckpt.verify_tree(path)
    assert not ok and "torn" in reason
    assert not jax_ckpt.verify_tree(path)[0]
    with pytest.raises(ckpt.CheckpointCorruptionError, match="torn"):
        InferenceEngineV2.deserialize(path, device="cpu")
    flipped = bytearray(raw)
    flipped[len(raw) - 5] ^= 0xFF
    with open(data, "wb") as f:
        f.write(bytes(flipped))
    assert "manifest mismatch" in ckpt.verify_tree(path)[1]
    assert ckpt.verify_tree(path, deep=False) == (True, "ok")
    with pytest.raises(ckpt.CheckpointCorruptionError, match="checksum"):
        InferenceEngineV2.deserialize(path, device="cpu")


def test_injected_truncate_and_write_fail(tmp_path):
    """``save_tree`` under the fault injector: a transient write failure
    self-heals through ``retry_io``; an injected torn write is caught at
    load."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [lambda: torch.ones(4, dtype=torch.bfloat16),
                  np.arange(3, dtype=np.int32)]}
    template = {"s": {"a": torch.empty(2, 3, device="meta"),
                      "b": [torch.empty(4, dtype=torch.bfloat16,
                                        device="meta"),
                            torch.empty(3, dtype=torch.int32,
                                        device="meta")]}}
    configure_fault_injection({"write_fail": {"match": "state.bin",
                                              "count": 1}})
    try:
        ckpt.save_tree(str(tmp_path / "ok"), {"s": tree}, {"step": 1})
    finally:
        configure_fault_injection(None)
    state, meta = ckpt.load_tree(str(tmp_path / "ok"), template,
                                 device="cpu")
    assert torch.equal(state["s"]["a"], tree["a"])
    assert torch.equal(state["s"]["b"][0], torch.ones(4,
                                                      dtype=torch.bfloat16))
    assert state["s"]["b"][1].dtype == torch.int32
    assert meta["step"] == 1
    configure_fault_injection({"truncate": {"match": "state.bin",
                                            "keep_bytes": 10}})
    try:
        ckpt.save_tree(str(tmp_path / "torn"), {"s": tree}, {})
    finally:
        configure_fault_injection(None)
    with pytest.raises(ckpt.CheckpointCorruptionError):
        ckpt.load_tree(str(tmp_path / "torn"), template, device="cpu")


def test_leaf_names_and_pod_commit(tmp_path):
    tree = {"z": {"b": 1, "a": [2, 3]}, "a": np.zeros(2)}
    assert ckpt._leaf_paths(tree) == jax_ckpt._leaf_paths(tree) == \
        ["a", "z/a/0", "z/a/1", "z/b"]
    assert list(ckpt._legacy_names("a/0")) == \
        list(jax_ckpt._legacy_names("a/0"))
    path = str(tmp_path / "c")
    ckpt.save_tree(path, {"s": tree}, {"global_steps": 4})
    assert ckpt.pod_complete(path) == (True, "ok")
    os.unlink(os.path.join(path, ckpt.COMMIT_FILE))
    ok, reason = ckpt.pod_complete(path)
    assert not ok and "torn pod" in reason
    assert not ckpt.verify_tree(path)[0]
