"""Collectives of the port: the façade on ``torch.distributed`` over the
named mesh (``comm.py``, ``topology.py``), the comms logger and the hang
watchdog (rc 218 / 219)."""
from .comm import (  # noqa: F401
    HOST_STAGED,
    all_gather,
    all_gather_coalesced,
    all_reduce,
    all_reduce_coalesced,
    all_to_all,
    axis_index,
    axis_size,
    barrier,
    broadcast,
    choose_backend,
    destroy_process_group,
    discover,
    get_device_count,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    new_group,
    p2p,
    pmean,
    ppermute,
    recv,
    reduce_scatter,
    send,
    send_recv_next,
    send_recv_prev,
    staged_ops,
)
from .comms_logging import CommsLogger, comms_logger, get_comms_logger  # noqa: F401
from .topology import (  # noqa: F401
    AXIS_ORDER,
    MeshTopology,
    build_topology,
    get_world_topology,
    reset_world_topology,
    set_world_topology,
)
