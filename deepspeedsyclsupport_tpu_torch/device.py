"""Device and dtype resolution shared by the port's entry points."""
from typing import Optional, Union

import torch

_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "torch.bfloat16": torch.bfloat16,
    "fp16": torch.float16, "half": torch.float16, "float16": torch.float16,
    "torch.float16": torch.float16, "torch.half": torch.float16,
    "fp32": torch.float32, "float": torch.float32, "float32": torch.float32,
    "torch.float32": torch.float32,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Without one this raises: an entry point never
    drops to the CPU on its own; a caller that wants the CPU asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return dev


def parse_dtype(name: str) -> torch.dtype:
    """A dtype name as the JAX package's configs spell it ("bf16",
    "bfloat16", "float32", ...) as a torch dtype."""
    try:
        return _DTYPES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None
