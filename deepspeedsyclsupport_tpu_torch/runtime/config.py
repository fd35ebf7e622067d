"""JSON config for the training engine.

Port of ``deepspeedsyclsupport_tpu/runtime/config.py`` (``DSTpuConfig``) for
the sections the engine uses: the batch family and its invariant
(``resolve_batch_sizes``, ``config.py:750-795``), ``optimizer``,
``scheduler``, ``fp16``, ``bf16``, ``zero_optimization.stage``,
``mics_shard_size`` and the ZeRO++ flags (``zero_quantized_weights``,
``zero_quantized_gradients``, ``zero_hpz_partition_size``:
:class:`ZeroPPConfig`), the mesh sizes (``parallelism.dp / fsdp / tp / pp /
sp``, ``tensor_parallel.tp_size``, ``pipeline.stages`` / ``micro_batches``,
``sequence_parallel_size``, ``parallelism.ep`` /
``moe.expert_parallel_size``: :class:`ParallelismConfig`),
``gradient_clipping``, ``activation_checkpointing``, ``checkpoint``,
``sentinel``, ``comms_logger``, ``seed`` and ``steps_per_print``. Key names
are the reference's, so one JSON file drives both packages.

ZeRO stages 0-3 are placement policies over the data / fsdp axes of the
mesh (``runtime/zero.py``); on one card there is nothing to shard, so every
stage runs the same program, as the JAX package does on one device.

Every enabled section the port does not do yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` entry: offload (and so
ZeRO++ under offload), elasticity, telemetry, monitors,
the flops profiler, compression/QAT, curriculum learning, progressive layer
drop and random-LTD. None is silently ignored.
"""
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from . import constants as C

AUTO = "auto"
logger = logging.getLogger(__name__)


def _sub(d: Dict[str, Any], key: str) -> Dict[str, Any]:
    v = d.get(key, {})
    if v in (None, False):
        return {}
    if v is True:
        return {"enabled": True}
    if not isinstance(v, dict):
        raise ValueError(f"config section {key!r} must be a dict, got {type(v)}")
    return v


def _any_enabled(d: Any) -> bool:
    """True when a (nested) section carries ``"enabled": true`` anywhere."""
    if not isinstance(d, dict):
        return False
    return bool(d.get("enabled", False)) or any(
        _any_enabled(v) for v in d.values())


def _unported(what: str, entry: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, "
                               f"queue {entry}")


def _refuse_unported(d: Dict[str, Any]) -> None:
    zero = _sub(d, C.ZERO_OPTIMIZATION)
    for key in (C.OFFLOAD_OPTIMIZER, C.OFFLOAD_PARAM):
        if str(_sub(zero, key).get("device", "none")) not in ("none", "None"):
            raise _unported(f"zero_optimization.{key} (ZeRO-Offload)",
                            "A.3.2 (offload)")
    checks = [
        (C.ELASTICITY, "elasticity (elastic batch sizes over a changing "
         "card count)", "A.3.1 (distributed training)"),
        (C.TELEMETRY, "telemetry", "A.3.4 (observability)"),
        (C.MONITOR_TENSORBOARD, "the tensorboard monitor",
         "A.3.4 (observability)"),
        (C.MONITOR_WANDB, "the wandb monitor", "A.3.4 (observability)"),
        (C.MONITOR_CSV, "the csv monitor", "A.3.4 (observability)"),
        (C.MONITOR_JSONL, "the jsonl monitor", "A.3.4 (observability)"),
        (C.FLOPS_PROFILER, "the flops profiler", "A.3.4 (observability)"),
        ("jax_profiler", "profiler trace windows", "A.3.4 (observability)"),
        (C.COMPRESSION_TRAINING, "compression / QAT",
         "A.3.7 (training-time model options)"),
        ("curriculum_learning", "curriculum learning",
         "A.3.7 (training-time model options)"),
        ("progressive_layer_drop", "progressive layer drop",
         "A.3.7 (training-time model options)"),
    ]
    for key, what, entry in checks:
        if _any_enabled(_sub(d, key)):
            raise _unported(what, entry)
    de = _sub(d, C.DATA_EFFICIENCY)
    if _any_enabled(_sub(de, "data_sampling")):
        raise _unported("curriculum learning (data_efficiency)",
                        "A.3.7 (training-time model options)")
    if _any_enabled(_sub(de, "data_routing")):
        raise _unported("random-LTD (data_efficiency.data_routing)",
                        "A.3.7 (training-time model options)")


@dataclass
class OptimizerConfig:
    """``optimizer`` section; ``type`` lower-cased as in the reference."""
    type: str = C.OPTIMIZER_TYPE_DEFAULT
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OptimizerConfig":
        return cls(type=str(d.get("type", C.OPTIMIZER_TYPE_DEFAULT)).lower(),
                   params=dict(d.get("params", {})))

    @property
    def lr(self) -> float:
        return float(self.params.get("lr", 1e-3))


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SchedulerConfig":
        return cls(type=d.get("type"), params=dict(d.get("params", {})))


@dataclass
class Fp16Config:
    """``fp16`` section incl. the dynamic loss-scaling knobs."""
    enabled: bool = False
    loss_scale: float = 0.0  # 0 -> dynamic
    initial_scale_power: int = C.INITIAL_LOSS_SCALE_POWER_DEFAULT
    loss_scale_window: int = C.LOSS_SCALE_WINDOW_DEFAULT
    hysteresis: int = C.HYSTERESIS_DEFAULT
    min_loss_scale: float = C.MIN_LOSS_SCALE_DEFAULT

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Fp16Config":
        return cls(enabled=bool(d.get("enabled", False)),
                   loss_scale=float(d.get("loss_scale", 0.0)),
                   initial_scale_power=int(d.get(
                       C.INITIAL_LOSS_SCALE_POWER,
                       C.INITIAL_LOSS_SCALE_POWER_DEFAULT)),
                   loss_scale_window=int(d.get(C.LOSS_SCALE_WINDOW,
                                               C.LOSS_SCALE_WINDOW_DEFAULT)),
                   hysteresis=int(d.get(C.HYSTERESIS, C.HYSTERESIS_DEFAULT)),
                   min_loss_scale=float(d.get(C.MIN_LOSS_SCALE,
                                              C.MIN_LOSS_SCALE_DEFAULT)))

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == 0.0

    @property
    def initial_scale(self) -> float:
        return float(self.loss_scale) if self.loss_scale \
            else 2.0 ** self.initial_scale_power


@dataclass
class ActivationCheckpointingConfig:
    """``activation_checkpointing``: section presence turns per-layer
    recomputation on unless ``enabled`` is false (``engine.py:366-395``).
    Only the ``nothing_saveable`` policy exists here (the port of
    ``jax.checkpoint`` is ``torch.utils.checkpoint``, which saves nothing of
    the layer)."""
    enabled: bool = True
    policy: str = "nothing_saveable"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ActivationCheckpointingConfig":
        policy = str(d.get("policy", "nothing_saveable"))
        enabled = bool(d.get("enabled", True))
        if enabled and d.get("cpu_checkpointing", False):
            raise _unported("activation_checkpointing.cpu_checkpointing "
                            "(activation offload)", "A.3.2 (offload)")
        if enabled and policy != "nothing_saveable":
            raise _unported(f"activation_checkpointing.policy {policy!r} "
                            f"(only nothing_saveable, torch.utils.checkpoint)",
                            "A.3.7 (training-time model options)")
        return cls(enabled=enabled, policy=policy)


@dataclass
class CheckpointConfig:
    """``checkpoint`` section (JAX ``runtime/config.py:557``): the engine
    (``native``, synchronous, or ``async``; ``async_save`` is the
    reference's spelling of the same choice), rotation (``keep_last_n``
    newest verified tags kept after each durable save; 0 keeps all) and
    ``tag_validation`` (a cross-rank check, validated here and moot on one
    process)."""
    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    engine: str = "native"  # native | async (checkpoint/ckpt_engine.py)
    keep_last_n: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CheckpointConfig":
        tv = str(d.get("tag_validation", "Warn")).capitalize()
        if tv not in ("Ignore", "Warn", "Fail"):
            raise ValueError(f"checkpoint.tag_validation must be "
                             f"Ignore|Warn|Fail, got {tv}")
        async_save = bool(d.get("async_save", False))
        engine = str(d.get("engine", "async" if async_save else "native"))
        if engine not in ("native", "async"):
            raise ValueError(f"checkpoint.engine must be native|async, got "
                             f"{engine!r}")
        if "engine" in d and "async_save" in d and \
                async_save != (engine == "async"):
            raise ValueError(
                f"contradictory checkpoint config: engine={engine!r} with "
                f"async_save={async_save}")
        keep_last_n = int(d.get("keep_last_n", 0))
        if keep_last_n < 0:
            raise ValueError(
                f"checkpoint.keep_last_n must be >= 0, got {keep_last_n}")
        if d.get("load_universal"):
            raise _unported("checkpoint.load_universal (universal "
                            "checkpoints)", "A.3.5 (checkpoint formats)")
        if d.get("use_node_local_storage"):
            raise _unported("checkpoint.use_node_local_storage (per-node "
                            "storage of a multi-node run)",
                            "A.3.1 (distributed training)")
        return cls(tag_validation=tv, engine=engine, keep_last_n=keep_last_n)


@dataclass
class SentinelConfig:
    """``sentinel`` section (JAX ``runtime/config.py:448``): the training
    health sentinel (``runtime/sentinel.py``). Detection arms after
    ``warmup_steps`` healthy steps; robust z over a ``window`` of history
    warns at ``z_warn`` and discards the update at ``z_skip``;
    ``skip_limit`` consecutive anomalies roll back to the last-good tag
    (promoted ``last_good_k`` healthy steps beyond its save), at most
    ``rollback_limit`` times before the rc-220 abort; ``lr_cut`` scales the
    grads for ``lr_cut_steps`` steps after a rollback; a step's verdict is
    taken ``lag`` steps later."""
    enabled: bool = False
    warmup_steps: int = 20
    window: int = 64
    ewma_alpha: float = 0.1
    z_warn: float = 4.0
    z_skip: float = 8.0
    skip_limit: int = 3
    rollback_limit: int = 2
    last_good_k: int = 4
    lr_cut: float = 1.0
    lr_cut_steps: int = 0
    lag: int = 1
    checkpoint_dir: Optional[str] = None   # default: where the engine saved
    journal_dir: Optional[str] = None      # default: checkpoint_dir

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SentinelConfig":
        z_warn = float(d.get("z_warn", 4.0))
        z_skip = float(d.get("z_skip", 8.0))
        if z_skip < z_warn:
            raise ValueError(f"sentinel.z_skip ({z_skip}) must be >= z_warn "
                             f"({z_warn}) — the ladder escalates, it does "
                             f"not invert")
        lag = int(d.get("lag", 1))
        if lag < 1:
            raise ValueError(f"sentinel.lag must be >= 1, got {lag} — lag 0 "
                             f"would block the host on the in-flight step")
        for key, lo in (("warmup_steps", 1), ("window", 4),
                        ("skip_limit", 1), ("rollback_limit", 0),
                        ("last_good_k", 1), ("lr_cut_steps", 0)):
            if int(d.get(key, lo)) < lo:
                raise ValueError(f"sentinel.{key} must be >= {lo}, got "
                                 f"{d.get(key)}")
        return cls(
            enabled=bool(d.get("enabled", False)),
            warmup_steps=int(d.get("warmup_steps", 20)),
            window=int(d.get("window", 64)),
            ewma_alpha=float(d.get("ewma_alpha", 0.1)),
            z_warn=z_warn, z_skip=z_skip,
            skip_limit=int(d.get("skip_limit", 3)),
            rollback_limit=int(d.get("rollback_limit", 2)),
            last_good_k=int(d.get("last_good_k", 4)),
            lr_cut=float(d.get("lr_cut", 1.0)),
            lr_cut_steps=int(d.get("lr_cut_steps", 0)),
            lag=lag,
            checkpoint_dir=d.get("checkpoint_dir"),
            journal_dir=d.get("journal_dir"))


@dataclass
class ParallelismConfig:
    """Mesh axis sizes (JAX ``ParallelismConfig``, ``config.py:211-240``):
    the ``parallelism`` section, or the reference's ``tensor_parallel.
    tp_size``. MiCS (``zero_optimization.mics_shard_size``) puts the ZeRO
    shard group on fsdp (``fsdp = mics_shard_size``) and replicates over
    data (``dp = -1``); ZeRO stage >= 1 with no sizes puts every rank on
    fsdp, stage 0 on data. ``-1`` is the rest of the world. ``pp`` is
    ``parallelism.pp`` or ``pipeline.stages``, ``pp_microbatches``
    ``pipeline.micro_batches`` (None: one a stage), ``sp``
    ``parallelism.sp`` or ``sequence_parallel_size``, ``ep``
    ``parallelism.ep`` or ``moe.expert_parallel_size``."""
    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    pp_microbatches: Optional[int] = None

    @classmethod
    def from_config_dict(cls, d: Dict[str, Any], zero_stage: int,
                         mics_shard_size: int = -1) -> "ParallelismConfig":
        p = _sub(d, C.PARALLELISM)
        tp = int(p.get("tp", _sub(d, C.TENSOR_PARALLEL).get("tp_size", 1)))
        pipe_sec = _sub(d, C.PIPELINE)
        pp = int(p.get("pp", pipe_sec.get("stages", 1)))
        pp_micro = pipe_sec.get("micro_batches")
        pp_micro = int(pp_micro) if pp_micro is not None else None
        ep = int(p.get("ep", _sub(d, C.MOE).get("expert_parallel_size", 1)))
        sp = int(p.get("sp", d.get(C.SEQUENCE_PARALLEL_SIZE, 1)))
        fsdp = int(p.get("fsdp", 0)) or 0
        dp = int(p.get("dp", 0)) or 0
        if mics_shard_size and mics_shard_size > 0:
            if fsdp and fsdp != mics_shard_size:
                raise ValueError(
                    f"mics_shard_size {mics_shard_size} conflicts with "
                    f"explicit fsdp={fsdp}")
            fsdp, dp = mics_shard_size, (dp or -1)
        elif not fsdp and not dp:
            if zero_stage >= 1:
                fsdp, dp = -1, 1
            else:
                dp, fsdp = -1, 1
        elif not fsdp:
            fsdp = 1
        elif not dp:
            dp = 1
        return cls(dp=dp, fsdp=fsdp, tp=tp, pp=pp, ep=ep, sp=sp,
                   pp_microbatches=pp_micro)


@dataclass
class CommsLoggerConfig:
    """``comms_logger`` (reference keys): ``enabled``, ``verbose``, and
    ``timed`` (a device sync around each collective; off by default)."""
    enabled: bool = False
    verbose: bool = False
    timed: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CommsLoggerConfig":
        return cls(enabled=bool(d.get("enabled", False)),
                   verbose=bool(d.get("verbose", False)),
                   timed=bool(d.get("timed", False)))


@dataclass
class ZeroPPConfig:
    """ZeRO++'s flags in ``zero_optimization`` with the JAX defaults
    (``config.py:168-170``): qwZ (int8 weight gathers), qgZ (int8 gradient
    reduce) and hpZ's secondary partition size (1 = none)."""
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ZeroPPConfig":
        return cls(
            zero_quantized_weights=bool(d.get("zero_quantized_weights",
                                              False)),
            zero_quantized_gradients=bool(d.get("zero_quantized_gradients",
                                                False)),
            zero_hpz_partition_size=int(d.get("zero_hpz_partition_size", 1)))

    @property
    def enabled(self) -> bool:
        return (self.zero_quantized_weights or self.zero_quantized_gradients
                or self.zero_hpz_partition_size > 1)


@dataclass
class DSTpuConfig:
    """Top-level typed config of the single-card engine (reference:
    ``DeepSpeedConfig``). ``zero_stage`` 0-3 all run one program on one
    card, as on one JAX device. ``activation_checkpointing`` is None when
    the section is absent (the model's own ``remat`` then stands)."""

    raw: Dict[str, Any]
    train_batch_size: int
    train_micro_batch_size_per_gpu: int
    gradient_accumulation_steps: int
    optimizer: OptimizerConfig
    scheduler: SchedulerConfig
    fp16: Fp16Config
    bf16_enabled: bool
    zero_stage: int
    activation_checkpointing: Optional[ActivationCheckpointingConfig]
    gradient_clipping: float = C.GRADIENT_CLIPPING_DEFAULT
    steps_per_print: int = C.STEPS_PER_PRINT_DEFAULT
    seed: int = C.SEED_DEFAULT
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    sentinel: SentinelConfig = field(default_factory=SentinelConfig)
    parallelism: ParallelismConfig = field(default_factory=ParallelismConfig)
    mics_shard_size: int = -1
    comms_logger: CommsLoggerConfig = field(
        default_factory=CommsLoggerConfig)
    zeropp: ZeroPPConfig = field(default_factory=ZeroPPConfig)

    @classmethod
    def from_config(cls, config, dp_world_size: Optional[int] = None
                    ) -> "DSTpuConfig":
        if isinstance(config, DSTpuConfig):
            return config
        if isinstance(config, (str, os.PathLike)):
            with open(config) as f:
                d = json.load(f)
        elif isinstance(config, dict):
            d = dict(config)
        else:
            raise TypeError(f"config must be dict or path, got {type(config)}")
        for key in sorted(set(d) & C.IGNORED_REFERENCE_KEYS):
            logger.warning("config key %r has no analog here; ignored", key)
        _refuse_unported(d)
        fp16 = Fp16Config.from_dict(_sub(d, C.FP16))
        bf16 = bool(_sub(d, C.BF16).get("enabled", False))
        if fp16.enabled and bf16:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        stage = int(_sub(d, C.ZERO_OPTIMIZATION).get(C.ZERO_STAGE,
                                                     C.ZERO_STAGE_DEFAULT))
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0-3, got {stage}")
        mics = int(_sub(d, C.ZERO_OPTIMIZATION).get("mics_shard_size", -1))
        ac = None
        if C.ACTIVATION_CHECKPOINTING in d:
            ac = ActivationCheckpointingConfig.from_dict(
                _sub(d, C.ACTIVATION_CHECKPOINTING))
        cfg = cls(
            raw=d, train_batch_size=0, train_micro_batch_size_per_gpu=0,
            gradient_accumulation_steps=0,
            optimizer=OptimizerConfig.from_dict(_sub(d, C.OPTIMIZER)),
            scheduler=SchedulerConfig.from_dict(_sub(d, C.SCHEDULER)),
            fp16=fp16, bf16_enabled=bf16, zero_stage=stage,
            activation_checkpointing=ac,
            gradient_clipping=float(d.get(C.GRADIENT_CLIPPING,
                                          C.GRADIENT_CLIPPING_DEFAULT)),
            steps_per_print=int(d.get(C.STEPS_PER_PRINT,
                                      C.STEPS_PER_PRINT_DEFAULT)),
            seed=int(d.get(C.SEED, C.SEED_DEFAULT)),
            checkpoint=CheckpointConfig.from_dict(_sub(d, C.CHECKPOINT)),
            sentinel=SentinelConfig.from_dict(_sub(d, "sentinel")),
            parallelism=ParallelismConfig.from_config_dict(
                d, stage, mics_shard_size=mics),
            mics_shard_size=mics,
            comms_logger=CommsLoggerConfig.from_dict(
                _sub(d, C.COMMS_LOGGER)),
            zeropp=ZeroPPConfig.from_dict(_sub(d, C.ZERO_OPTIMIZATION)))
        if dp_world_size is not None:
            cfg.resolve_batch_sizes(dp_world_size)
        return cfg

    def resolve_batch_sizes(self, dp_world_size: int = 1) -> None:
        """Enforce/derive ``train_batch = micro_batch × grad_accum ×
        dp_world`` (reference ``_set_batch_related_parameters``)."""
        d = self.raw
        tb = d.get(C.TRAIN_BATCH_SIZE)
        mb = d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        gas = d.get(C.GRADIENT_ACCUMULATION_STEPS)
        tb = None if tb == AUTO else tb
        mb = None if mb == AUTO else mb
        gas = None if gas == AUTO else gas
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ValueError(
                    f"batch invariant violated: train_batch_size={tb} != "
                    f"micro({mb}) × grad_accum({gas}) × dp_world"
                    f"({dp_world_size})")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size={tb} not divisible by micro({mb}) × "
                    f"dp_world({dp_world_size})")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size={tb} not divisible by grad_accum"
                    f"({gas}) × dp_world({dp_world_size})")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            mb = max(1, tb // dp_world_size)
            gas = tb // (mb * dp_world_size)
            if tb != mb * gas * dp_world_size:
                raise ValueError(f"train_batch_size={tb} not divisible by "
                                 f"dp_world({dp_world_size})")
        else:
            raise ValueError("at least one of train_batch_size / "
                             "train_micro_batch_size_per_gpu must be "
                             "configured")
        self.train_batch_size = int(tb)
        self.train_micro_batch_size_per_gpu = int(mb)
        self.gradient_accumulation_steps = int(gas)

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.bf16_enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
