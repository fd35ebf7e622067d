"""Inference engines of the PyTorch port:

* :mod:`.engine` — the v1 engine (``init_inference`` / ``InferenceEngine``):
  a placed model (tensor parallel across ranks) and a generate loop over a
  static KV cache;
* :mod:`.v2` — the ragged continuous-batching engine over a paged KV cache.
"""
from .config import DSTpuInferenceConfig  # noqa: F401
from .engine import InferenceEngine, init_inference  # noqa: F401
