"""Ragged engine configuration.

Port of ``RaggedInferenceConfig`` (``deepspeedsyclsupport_tpu/inference/v2/
config.py``): the same knobs, defaults and validation, with ``dtype`` a
torch dtype (strings such as ``"bf16"`` are accepted by :meth:`from_config`).
``ServingPolicyConfig`` is not ported yet (ROADMAP.md, queue A).
"""
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ...device import parse_dtype


@dataclass
class RaggedInferenceConfig:
    block_size: int = 64            # KV tokens per block
    max_tokens_per_batch: int = 768  # SplitFuse token budget per forward
    max_sequences: int = 64         # concurrent sequences per forward
    max_context: int = 2048         # per-sequence KV budget
    num_blocks: Optional[int] = None  # KV pool; default half the worst case
    dtype: Any = torch.bfloat16
    seed: int = 0
    # ZeRO-Inference: int8 / int4 layer weights, dequantized per layer
    quantize_weights: bool = False
    quant_group_size: int = 64
    quant_bits: int = 8
    # mixed/prefill-batch attention impl, resolved through the registry
    # (module_registry.py): "auto" or a registered name — kernel (the CUDA
    # ragged paged-attention kernel over atoms) or xla (the plain version)
    prefill_attn: str = "auto"
    # decode attention impl: "auto", kernel (alias pallas) or xla
    decode_attn: str = "auto"
    atom_q_size: Optional[int] = None  # q rows per atom (default <=128)
    max_prefill_fraction: float = 1.0
    eviction_policy: str = "longest_context"
    # fused multi-step decode: up to this many decode steps per dispatch
    # (one CUDA graph replay per rung of the ladder K, K/2, ..., 2)
    decode_steps_per_dispatch: int = 1
    # KV-pool head-dim alignment (kv_cache.lane_padded_head_dim): None =
    # auto (no padding on CUDA); an int forces that multiple
    head_dim_lane_pad: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.dtype, str):
            self.dtype = parse_dtype(self.dtype)
        if not isinstance(self.prefill_attn, str) or not self.prefill_attn:
            raise ValueError(
                f"prefill_attn must name a registered implementation or "
                f"'auto', got {self.prefill_attn!r}")
        if not 0.0 < self.max_prefill_fraction <= 1.0:
            raise ValueError(f"max_prefill_fraction must be in (0, 1], got "
                             f"{self.max_prefill_fraction}")
        if self.eviction_policy not in ("longest_context", "lru", "newest",
                                        "slack"):
            raise ValueError(f"eviction_policy must be longest_context|lru|"
                             f"newest|slack, got {self.eviction_policy!r}")
        if self.atom_q_size is None:
            self.atom_q_size = min(128, self.max_tokens_per_batch)
        if self.atom_q_size < 1:
            raise ValueError(f"atom_q_size must be >= 1, got "
                             f"{self.atom_q_size}")
        if self.decode_steps_per_dispatch < 1:
            raise ValueError(f"decode_steps_per_dispatch must be >= 1, got "
                             f"{self.decode_steps_per_dispatch}")
        if self.quant_bits not in (4, 8):
            raise ValueError(f"quant_bits must be 4 or 8, got "
                             f"{self.quant_bits}")
        if self.num_blocks is None:
            per_seq = math.ceil(self.max_context / self.block_size)
            self.num_blocks = max(per_seq, self.max_sequences * per_seq // 2)
        if self.max_context % self.block_size:
            raise ValueError("max_context must be a multiple of block_size")

    @property
    def blocks_per_seq(self) -> int:
        return self.max_context // self.block_size

    @classmethod
    def from_config(cls, config: Optional[Dict] = None, **kw):
        cfg = dict(config or {})
        cfg.update(kw)
        known = set(cls.__dataclass_fields__)
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(f"unknown ragged config keys: {sorted(unknown)}")
        return cls(**cfg)

