"""Training runtime of the port: config, LR schedules, optimizers, loss
scaling, the single-card engine, its data loaders, preemption handling and
the training-health sentinel."""
from .engine import Engine, engine_state_from_jax, initialize  # noqa: F401
