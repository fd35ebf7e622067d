"""Ragged engine configuration.

Port of ``RaggedInferenceConfig`` (``deepspeedsyclsupport_tpu/inference/v2/
config.py``): the same knobs, defaults and validation, with ``dtype`` a
torch dtype (strings such as ``"bf16"`` are accepted by :meth:`from_config`);
and ``ServingPolicyConfig``, the SLA serving policy's knobs, copied with
every field, default and check.
"""
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

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


@dataclass
class ServingPolicyConfig:
    """SLA serving-policy knobs (``serving.ServingSession`` — see
    ``docs/serving.md`` for the overload-behavior contract these encode).

    The reference's FastGen SLA is two-part per request: first token within
    a TTFT bound AND a sustained decode token rate. Under overload the
    policy's job is to keep the *admitted* streams meeting that SLA by
    queueing or shedding new arrivals, preempting the lowest-slack stream
    when the KV pool exhausts, and ordering work by slack — instead of the
    admit-everyone collapse.
    """

    # --- admission gate -------------------------------------------------
    admission: str = "sla"     # "sla" (project deadlines) | "none" (FIFO —
    #                            queue on structural limits only)
    ttft_sla_s: Optional[float] = None  # default TTFT deadline per request
    #                                     (None = requests carry no deadline
    #                                     unless submit() sets one)
    token_rate_sla: float = 0.0   # per-stream decode tokens/s target
    shed_policy: str = "queue"    # "queue": hold unadmittable requests until
    #                               their deadline is provably unmeetable;
    #                               "reject": shed immediately when not
    #                               admissible at submit time
    max_queue_s: float = 30.0     # queued longer than this is shed outright
    sla_headroom: float = 1.15    # safety factor on projected service times
    rate_feasibility_margin: float = 0.8  # shed on rate ONLY when the
    #   measured per-stream decode rate is clearly below the SLA
    #   (measured < margin * required): the EWMA breathes several percent
    #   under load, and a borderline stream still delivers ~SLA — TTFT
    #   projection is the overload valve, this check only catches
    #   hardware-can-never-do-it targets
    # --- overload eviction ---------------------------------------------
    preempt_policy: str = "reject"  # KV-exhaustion victim handling:
    #                                 "reject" (finish with partial output) |
    #                                 "requeue" (re-prefill later; its SLA is
    #                                 re-projected at re-admission)
    # --- batch composition ----------------------------------------------
    tenant_token_budget: Optional[Union[int, Dict[str, int]]] = None
    #   max prefill tokens one tenant may take per scheduling round (int =
    #   every tenant; dict keys tenants, "*" = default; None = no cap)
    aging_weight: float = 2.0     # starvation aging: seconds of slack credit
    #                               per second a chunk waits unserved
    # --- capacity model (EWMA priors; measured values take over) --------
    ewma_alpha: float = 0.25
    prefill_tok_s_prior: float = 1000.0
    decode_step_s_prior: float = 0.05
    # telemetry: emit Serve/* metrics through monitor.telemetry
    telemetry: bool = True
    # --- fault tolerance (docs/serving.md "failure contract") -----------
    # request journal: every admitted request's immutable prompt, SLA
    # fields and emitted-token watermark as a rank-local JSONL (flushed
    # per record), so in-flight state survives the process and a replica
    # supervisor can replay from the watermark. None = no journal.
    journal_path: Optional[str] = None
    # stuck-decode watchdog: arm a deadline around each scheduling round's
    # device dispatches; on expiry dump stacks, flush the journal/telemetry
    # and exit rc 219 (SERVE_HANG_EXIT_CODE) — the serving twin of the
    # rc-218 collective-hang contract
    watchdog_enabled: bool = False
    watchdog_deadline_s: float = 60.0
    watchdog_warmup_deadline_s: Optional[float] = None  # default 10x: the
    #   first round compiles (prefill + sampler + fused rungs)
    watchdog_poll_s: float = 0.25
    # structured backpressure: consecutive no-progress scheduling rounds
    # (no events, no dispatches) with live streams before the session
    # preempts the lowest-slack stream to un-wedge the batch — the KV
    # exhaustion self-healing valve (never an exception out of step())
    stall_patience_rounds: int = 3
    # --- cross-request prefix cache (docs/serving.md "prefix reuse") ----
    # None = off. A dict installs engine.prefix_cache at session build:
    #   enabled:           bool, default True (False keeps the dict but
    #                      skips installation — A/B switch)
    #   scope:             "tenant" (default; probes never cross tenants)
    #                      | "global"
    #   min_block_hits:    offers of a block hash before it is pinned
    #                      (default 1 — pin on first commit)
    #   max_pinned_blocks: index pin cap (default: half the KV pool)
    prefix_cache: Optional[Dict[str, Any]] = None
    # --- request-time attribution (docs/observability.md) ---------------
    # serve/stage lifecycle records in the journal + the in-memory
    # trace_log ring monitor/reqtrace.py joins into per-request waterfalls
    trace_stages: bool = True
    # SLO burn accounting (Serve/slo.* gauges): sliding-window length and
    # the error budget the burn rate is priced against (miss_frac/budget)
    slo_window_s: float = 60.0
    slo_budget: float = 0.05
    extra: Dict[str, Any] = field(default_factory=dict)  # forward-compat bag

    def __post_init__(self):
        if self.admission not in ("sla", "none"):
            raise ValueError(f"admission must be sla|none, got "
                             f"{self.admission!r}")
        if self.shed_policy not in ("queue", "reject"):
            raise ValueError(f"shed_policy must be queue|reject, got "
                             f"{self.shed_policy!r}")
        if self.preempt_policy not in ("reject", "requeue"):
            raise ValueError(f"preempt_policy must be reject|requeue, got "
                             f"{self.preempt_policy!r}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")
        if self.sla_headroom < 1.0:
            raise ValueError(f"sla_headroom must be >= 1.0, got "
                             f"{self.sla_headroom}")
        if not 0.0 < self.rate_feasibility_margin <= 1.0:
            raise ValueError(f"rate_feasibility_margin must be in (0, 1], "
                             f"got {self.rate_feasibility_margin}")
        if self.ttft_sla_s is not None and self.ttft_sla_s <= 0:
            raise ValueError(f"ttft_sla_s must be positive, got "
                             f"{self.ttft_sla_s}")
        if self.watchdog_deadline_s <= 0 or self.watchdog_poll_s <= 0:
            raise ValueError(
                f"watchdog deadline_s/poll_s must be > 0, got "
                f"{self.watchdog_deadline_s}/{self.watchdog_poll_s}")
        if self.watchdog_warmup_deadline_s is not None \
                and self.watchdog_warmup_deadline_s < self.watchdog_deadline_s:
            raise ValueError(
                f"watchdog_warmup_deadline_s "
                f"({self.watchdog_warmup_deadline_s}) must be >= "
                f"watchdog_deadline_s ({self.watchdog_deadline_s}): the "
                f"first round includes compilation")
        if self.stall_patience_rounds < 1:
            raise ValueError(f"stall_patience_rounds must be >= 1, got "
                             f"{self.stall_patience_rounds}")
        if self.slo_window_s <= 0:
            raise ValueError(f"slo_window_s must be > 0, got "
                             f"{self.slo_window_s}")
        if not 0.0 < self.slo_budget <= 1.0:
            raise ValueError(f"slo_budget must be in (0, 1], got "
                             f"{self.slo_budget}")
        if self.prefix_cache is not None:
            known = {"enabled", "scope", "min_block_hits",
                     "max_pinned_blocks"}
            unknown = set(self.prefix_cache) - known
            if unknown:
                raise ValueError(f"unknown prefix_cache keys: "
                                 f"{sorted(unknown)} (known: {sorted(known)})")
            scope = self.prefix_cache.get("scope", "tenant")
            if scope not in ("tenant", "global"):
                raise ValueError(f"prefix_cache.scope must be tenant|global, "
                                 f"got {scope!r}")
            if int(self.prefix_cache.get("min_block_hits", 1)) < 1:
                raise ValueError("prefix_cache.min_block_hits must be >= 1")
            mpb = self.prefix_cache.get("max_pinned_blocks")
            if mpb is not None and int(mpb) < 1:
                raise ValueError("prefix_cache.max_pinned_blocks must be "
                                 ">= 1 or None")

    @classmethod
    def from_config(cls, config: Optional[Dict] = None, **kw):
        cfg = dict(config or {})
        cfg.update(kw)
        known = set(cls.__dataclass_fields__)
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(
                f"unknown serving policy keys: {sorted(unknown)}")
        return cls(**cfg)
