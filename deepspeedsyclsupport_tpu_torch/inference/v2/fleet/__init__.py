"""Serving fleet control plane over N replica serving processes (port of
``deepspeedsyclsupport_tpu/inference/v2/fleet``).

* :mod:`.router` — :class:`FleetRouter`: fleet-edge admission (the
  per-replica ``CapacityModel`` math aggregated across ready replicas, so
  hopeless requests shed at the edge before any replica queues), placement
  by SLA slack + measured capacity + tenant/session **affinity**, and
  health gating (stale heartbeat or draining replicas drop out of
  rotation).
* :mod:`.pool` — :class:`ReplicaPool`: start/stop/drain orchestration over
  the :class:`~..supervisor.ReplicaSupervisor` drain contract — rolling
  restart drains one replica at a time while the router steers new work
  away; crashed workers hot-respawn through the supervisor's elastic
  machinery, and the pool respawns supervisors that give up.
* :mod:`.failover` — journal-based **cross-replica** failover: when a
  replica dies for good, the router claims its request journals' in-flight
  streams and re-admits each on a *surviving* replica from its
  emitted-token watermark (context rebuilt prompt+prefix, exactly-once
  closes).
* :mod:`.cli` — ``python -m deepspeedsyclsupport_tpu_torch.inference.v2.fleet
  --spec fleet.json``: the multi-process fleet loop.

``Fleet/*`` telemetry names are declared in ``monitor/telemetry.py``.
"""
from .failover import (FailoverClaim, claim_in_flight,  # noqa: F401
                       claim_uids, read_claims)
from .pool import ProcessReplica, ReplicaPool  # noqa: F401
from .router import (FleetConfig, FleetEvent, FleetRequest,  # noqa: F401
                     FleetRouter, LocalReplica, ReplicaEndpoint,
                     slack_affinity_placement)
