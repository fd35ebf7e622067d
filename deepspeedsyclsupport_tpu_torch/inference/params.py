"""Inference weight placement.

Replaces ``place_inference_params`` (``deepspeedsyclsupport_tpu/inference/
params.py:17``): on one GPU there is no mesh and no sharding rule, so
placement is casting the floating leaves to the serving dtype and moving
every leaf to the device. A quantized leaf (``QuantTensor``) moves whole:
its codes keep int8 / uint8 and its scales float32.
"""
from typing import Any

import torch

from ..compression.quantize import QuantTensor


def place_inference_params(params: Any, dtype: torch.dtype,
                           device: torch.device) -> Any:
    """A new tree: floating leaves cast to ``dtype``, all leaves on
    ``device``. Leaves already in place are shared, not copied."""
    if isinstance(params, dict):
        return {k: place_inference_params(v, dtype, device)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(place_inference_params(v, dtype, device)
                            for v in params)
    if isinstance(params, QuantTensor):
        return params.to(device)
    t = torch.as_tensor(params)
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)
