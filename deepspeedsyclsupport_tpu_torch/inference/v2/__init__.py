"""Ragged continuous-batching serving engine (port of the JAX package's
``inference/v2``):

* :mod:`.config` — engine knobs (``RaggedInferenceConfig``)
* :mod:`.ragged` — refcounted ``BlockedAllocator``, sequence descriptors and
  the host-built ragged batch metadata (atoms included)
* :mod:`.scheduler` — Dynamic SplitFuse token-budget scheduler
* :mod:`.kv_cache` — the paged KV pool on the device
* :mod:`.module_registry` — pluggable attention implementations
* :mod:`.model` — ragged and decode forwards over the paged pool
* :mod:`.engine_v2` — ``InferenceEngineV2`` (``put/query/flush/
  can_schedule``, ``generate``)
"""
from .config import RaggedInferenceConfig  # noqa: F401
from .engine_v2 import (AdmissionResult, InferenceEngineV2,  # noqa: F401
                        PutResult)
from .kv_cache import BlockedKV, init_blocked_kv, kv_pool_stats  # noqa: F401
from .ragged import (BlockedAllocator, RaggedBatch,  # noqa: F401
                     SequenceDescriptor, build_ragged_batch)
from .scheduler import SlackPolicy, schedule_chunks  # noqa: F401
