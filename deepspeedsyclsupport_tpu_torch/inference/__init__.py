"""Inference engines of the PyTorch port (the v2 ragged engine first)."""
