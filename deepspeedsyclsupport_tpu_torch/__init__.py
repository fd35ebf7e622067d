"""deepspeedsyclsupport_tpu_torch — the PyTorch and CUDA port of
``deepspeedsyclsupport_tpu``, built slice by slice beside it.

It imports ``torch`` and never ``jax`` or the JAX package. Entry points run
on the card (``device=None`` means CUDA, and raises without one); the CPU is
used only when a caller passes ``device="cpu"``.

Ported so far:

* the serving path — a dense causal LM (``models``) served by the ragged
  continuous-batching engine (``inference.v2.InferenceEngineV2``), whose
  attention is the hand-written CUDA ragged paged-attention kernel
  (``ops.paged_attention``, source ``csrc/paged_attention.cu``);
* the training path — ``initialize`` -> ``Engine.train_batch`` on one card
  (``runtime``), whose attention forward and backward are the hand-written
  CUDA flash kernels (``ops.flash_attention``, source
  ``csrc/flash_attention.cu``) wired as a ``torch.autograd.Function``,
  with checkpoints in the JAX package's format, resume, preemption
  handling, the data loaders and the training-health sentinel.
"""
from .models import (CausalLM, ModelConfig, PRESETS, build_model,  # noqa: F401
                     get_config, params_from_jax)
from .inference.v2 import InferenceEngineV2, RaggedInferenceConfig  # noqa: F401
from .runtime import Engine, engine_state_from_jax, initialize  # noqa: F401

__version__ = "0.1.0"
