"""Pod identity: which rank am I, how many ranks share this run's storage.

Port of ``deepspeedsyclsupport_tpu/utils/podid.py``. A multi-process run
answers through ``torch.distributed`` when it is initialized (the JAX
package asks ``jax.distributed``); otherwise ``DSTPU_POD_RANKS`` declares a
pod of independent single-process members and the standard ``RANK`` env
names the member; otherwise the solo default ``(0, 1)``. The checkpoint
commit protocol and rank-targeted fault injection resolve identity here.
"""
import os
from typing import Tuple

ENV_POD_RANKS = "DSTPU_POD_RANKS"


def pod_identity() -> Tuple[int, int]:
    """``(rank, world)``. Malformed env degrades to solo rather than
    crashing a run over a bad launcher variable."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    try:
        world = int(os.environ.get(ENV_POD_RANKS, "1") or 1)
    except ValueError:
        world = 1
    if world > 1:
        try:
            rank = int(os.environ.get("RANK", "0") or 0)
        except ValueError:
            rank = 0
        return rank, world
    return 0, 1


def pod_rank() -> int:
    return pod_identity()[0]
