"""Inference configuration of the v1 engine.

Port of ``deepspeedsyclsupport_tpu/inference/config.py``
(``DSTpuInferenceConfig``, the reference's ``DeepSpeedInferenceConfig``):
the same key families — dtype, tensor_parallel, generation limits, the
ZeRO-Inference ``quant`` section and ``kv_offload`` — with the same
defaults and checks. The knobs that only steer the reference's CUDA kernel
injection are accepted and ignored, as in the JAX package, so
reference-style config dicts keep working; an unknown key raises. ``dtype``
is a torch dtype.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

_IGNORED_KEYS = {
    "replace_with_kernel_inject", "enable_cuda_graph", "use_triton",
    "triton_autotune", "cuda_graph_max_batch_size", "injection_policy",
    "injection_policy_tuple", "replace_method", "moe_experts",
    "save_mp_checkpoint_path",
}

_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "torch.bfloat16": torch.bfloat16,
    "fp16": torch.float16, "half": torch.float16, "torch.half": torch.float16,
    "float16": torch.float16, "torch.float16": torch.float16,
    "fp32": torch.float32, "float": torch.float32, "float32": torch.float32,
    "torch.float32": torch.float32,
    "int8": torch.int8,
}


@dataclass
class TensorParallelConfig:
    """Reference ``DeepSpeedTPConfig``."""
    tp_size: int = 1
    enabled: bool = True


@dataclass
class ZeroInferenceQuantConfig:
    """ZeRO-Inference weight quantization: the layer weights held as int8
    (or packed int4) codes with blockwise float32 scales, dequantized a
    layer at a time."""
    enabled: bool = False
    group_size: int = 64    # elements per scale block
    min_size: int = 4096    # leaves smaller than this stay full precision
    bits: int = 8           # 8 (int8) or 4 (packed int4)

    @classmethod
    def from_value(cls, v) -> "ZeroInferenceQuantConfig":
        if isinstance(v, ZeroInferenceQuantConfig):
            return v
        if isinstance(v, bool):
            return cls(enabled=v)
        d = dict(v or {})
        bits = int(d.get("bits", 8))
        if bits not in (4, 8):
            raise ValueError(f"quant.bits must be 4 or 8, got {bits}")
        return cls(enabled=bool(d.get("enabled", False)),
                   group_size=int(d.get("group_size", 64)),
                   min_size=int(d.get("min_size", 4096)),
                   bits=bits)


@dataclass
class DSTpuInferenceConfig:
    dtype: Any = torch.bfloat16
    tensor_parallel: TensorParallelConfig = field(
        default_factory=TensorParallelConfig)
    max_out_tokens: int = 1024          # clamps generate's max_new_tokens
    min_out_tokens: int = 1             # an admission hint (not enforced)
    max_seq_len: int = 2048             # prompt + generation KV budget
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0
    quant: ZeroInferenceQuantConfig = field(
        default_factory=ZeroInferenceQuantConfig)
    # ZeRO-Inference's other half: the decode KV cache in host memory, one
    # layer's slice streamed through the card at a time
    kv_offload: bool = False

    @classmethod
    def from_config(cls, config: Optional[Dict[str, Any]] = None, **kw
                    ) -> "DSTpuInferenceConfig":
        cfg = dict(config or {})
        cfg.update(kw)
        for k in list(cfg):
            if k in _IGNORED_KEYS:
                cfg.pop(k)
        tp = cfg.pop("tensor_parallel", None) or {}
        if isinstance(tp, TensorParallelConfig):
            tp_cfg = tp
        else:
            if isinstance(tp, int):
                tp = {"tp_size": tp}
            tp_cfg = TensorParallelConfig(**tp)
        if "mp_size" in cfg:  # the reference's legacy alias
            tp_cfg.tp_size = cfg.pop("mp_size")
        cfg["quant"] = ZeroInferenceQuantConfig.from_value(
            cfg.pop("quant", None))
        dtype = cfg.pop("dtype", torch.bfloat16)
        if isinstance(dtype, str):
            try:
                dtype = _DTYPES[dtype.lower()]
            except KeyError:
                raise ValueError(
                    f"unknown inference dtype {dtype!r}; one of "
                    f"{sorted(_DTYPES)}") from None
        known = set(cls.__dataclass_fields__)
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(
                f"unknown inference config keys: {sorted(unknown)}")
        return cls(dtype=dtype, tensor_parallel=tp_cfg, **cfg)
