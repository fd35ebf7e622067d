"""Config key names and defaults (analog of ``deepspeed/runtime/constants.py``).

Key names intentionally match the reference JSON schema so existing DeepSpeed configs
parse unmodified (``train_batch_size``, ``zero_optimization``, ``bf16`` …). Keys whose
semantics are meaningless under XLA (cuda streams, nccl buckets) are accepted and
ignored with a warning rather than rejected, mirroring the reference's tolerance of
unknown accelerator-specific keys.

This file is a verbatim copy of ``deepspeedsyclsupport_tpu/runtime/
constants.py`` (stdlib-only): the PyTorch port keeps its own copy so that it
imports nothing of the JAX package.
"""

# ---------------------------------------------------------------- batch family
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

# ---------------------------------------------------------------- optimizer
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = "adamw"
SCHEDULER = "scheduler"
MAX_GRAD_NORM = "max_grad_norm"
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

# ---------------------------------------------------------------- precision
FP16 = "fp16"
BF16 = "bf16"
FP32 = "fp32"
INITIAL_LOSS_SCALE_POWER = "initial_scale_power"
INITIAL_LOSS_SCALE_POWER_DEFAULT = 16
LOSS_SCALE_WINDOW = "loss_scale_window"
LOSS_SCALE_WINDOW_DEFAULT = 1000
MIN_LOSS_SCALE = "min_loss_scale"
MIN_LOSS_SCALE_DEFAULT = 1.0
HYSTERESIS = "hysteresis"
HYSTERESIS_DEFAULT = 2

# ---------------------------------------------------------------- zero
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = 0

# ---------------------------------------------------------------- parallelism
PARALLELISM = "parallelism"  # dstpu extension: mesh axis sizes
PIPELINE = "pipeline"
MOE = "moe"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
TENSOR_PARALLEL = "tensor_parallel"

# ---------------------------------------------------------------- misc engine
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
DUMP_STATE = "dump_state"
SEED = "seed"
SEED_DEFAULT = 42

# ---------------------------------------------------------------- subsystems
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
COMMS_LOGGER = "comms_logger"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
MONITOR_JSONL = "jsonl_monitor"
TELEMETRY = "telemetry"
FLOPS_PROFILER = "flops_profiler"
ELASTICITY = "elasticity"
COMPRESSION_TRAINING = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
CHECKPOINT = "checkpoint"
OFFLOAD_OPTIMIZER = "offload_optimizer"
OFFLOAD_PARAM = "offload_param"
AUTOTUNING = "autotuning"

# Keys from the reference schema that have no XLA analog; accepted + ignored.
IGNORED_REFERENCE_KEYS = frozenset({
    "communication_data_type",
    "sparse_gradients",
    "fp16_master_weights_and_gradients",
    "amp",
    "disable_allgather",
    "cuda_graphs",
    "memory_breakdown",
    "sparse_attention",
})
