"""Weight compression of the PyTorch port (quantized serving weights)."""
