"""Kernels of the PyTorch port: hand-written CUDA for Hopper (``csrc/``),
each beside its plain PyTorch version."""
