"""Ragged continuous-batching serving engine (port of the JAX package's
``inference/v2``):

* :mod:`.config` — engine knobs (``RaggedInferenceConfig``) and the SLA
  serving policy's (``ServingPolicyConfig``)
* :mod:`.ragged` — refcounted ``BlockedAllocator``, sequence descriptors and
  the host-built ragged batch metadata (atoms included)
* :mod:`.scheduler` — Dynamic SplitFuse token-budget scheduler
* :mod:`.kv_cache` — the paged KV pool on the device
* :mod:`.module_registry` — pluggable attention implementations
* :mod:`.model` — ragged and decode forwards over the paged pool
* :mod:`.engine_v2` — ``InferenceEngineV2`` (``put/query/flush/
  can_schedule``, ``generate``, ``serialize``/``deserialize``)
* :mod:`.serving` — ``ServingSession``: SLA admission, slack-ordered batch
  composition, KV-pressure eviction, K-capped fused decode
* :mod:`.supervisor` — request journal, crash-replay recovery, the replica
  supervisor and its worker CLI (rc 219 stuck-decode contract)
* :mod:`.fleet` — the failover claim file the worker reads
"""
from .config import RaggedInferenceConfig, ServingPolicyConfig  # noqa: F401
from .engine_v2 import (AdmissionResult, InferenceEngineV2,  # noqa: F401
                        PutResult)
from .kv_cache import BlockedKV, init_blocked_kv, kv_pool_stats  # noqa: F401
from .ragged import (BlockedAllocator, RaggedBatch,  # noqa: F401
                     SequenceDescriptor, build_ragged_batch)
from .scheduler import SlackPolicy, schedule_chunks  # noqa: F401
from .serving import CapacityModel, ServeEvent, ServingSession  # noqa: F401
from .supervisor import (RequestJournal, ReplayRequest,  # noqa: F401
                         ReplicaSupervisor, SERVE_HANG_EXIT_CODE,
                         journal_path, load_journal, reconstruct_outputs,
                         recover_requests)
