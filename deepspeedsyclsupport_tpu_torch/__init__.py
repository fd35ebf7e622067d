"""deepspeedsyclsupport_tpu_torch — the PyTorch and CUDA port of
``deepspeedsyclsupport_tpu``, built slice by slice beside it.

It imports ``torch`` and never ``jax`` or the JAX package. Entry points run
on the card (``device=None`` means CUDA, and raises without one); the CPU is
used only when a caller passes ``device="cpu"``.

Ported so far:

* the serving path — a dense causal LM (``models``) served by the ragged
  continuous-batching engine (``inference.v2.InferenceEngineV2``), whose
  attention is the hand-written CUDA ragged paged-attention kernel
  (``ops.paged_attention``, source ``csrc/paged_attention.cu``), and the
  serving fleet (``inference.v2.fleet``);
* the training path — ``initialize`` -> ``Engine.train_batch`` on one card
  or over ``torch.distributed`` (``runtime``, ``comm``, ``parallel``):
  ZeRO 0-3 and ZeRO++ over the named mesh, tensor, pipeline, sequence and
  expert parallelism, whose attention forward and backward are the
  hand-written CUDA flash kernels (``ops.flash_attention``, source
  ``csrc/flash_attention.cu``) wired as a ``torch.autograd.Function``;
  the Adam, Lamb, Lion, SGD, Adagrad and 1-bit optimizers, checkpoints in
  the JAX package's format, resume, preemption handling, the data loaders
  and the training-health sentinel.

The top-level names are the JAX package's (``__init__.py``) as far as they
are ported: ``initialize``, ``init_distributed``, ``MeshTopology``,
``build_topology`` and ``get_world_topology``.
"""
from .models import (CausalLM, ModelConfig, PRESETS, build_model,  # noqa: F401
                     get_config, params_from_jax)
from .inference.v2 import InferenceEngineV2, RaggedInferenceConfig  # noqa: F401
from .runtime import Engine, engine_state_from_jax, initialize  # noqa: F401
from .comm import init_distributed  # noqa: F401
from .comm.topology import (MeshTopology, build_topology,  # noqa: F401
                            get_world_topology)

__version__ = "0.1.0"
