"""Training runtime of the port: config, LR schedules, optimizers, loss
scaling and the single-card engine."""
from .engine import Engine, initialize  # noqa: F401
