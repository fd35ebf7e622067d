"""Training runtime of the port: config, LR schedules, optimizers, loss
scaling, the engine (one card, or ZeRO / TP ranks over ``torch.distributed``
with the placement plan of ``zero.py``), its data loaders, preemption
handling and the training-health sentinel."""
from .engine import (Engine, engine_state_from_jax, gather_params,  # noqa: F401
                     initialize, shard_params, shard_params_from_jax)
