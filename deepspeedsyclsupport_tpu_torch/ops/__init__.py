"""Kernels of the PyTorch port: hand-written CUDA for Hopper (``csrc/``),
each beside its plain PyTorch version."""
from .evoformer_attn import DS4Sci_EvoformerAttention  # noqa: F401
from .sparse_attention import sparse_attention  # noqa: F401
