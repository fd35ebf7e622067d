"""Parallel layers of the PyTorch port (MoE serving)."""
