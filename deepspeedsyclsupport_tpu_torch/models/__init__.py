"""Model families of the PyTorch port (dense causal LM first)."""
from .config import ModelConfig, PRESETS, get_config  # noqa: F401
from .transformer import CausalLM, build_model, params_from_jax  # noqa: F401
