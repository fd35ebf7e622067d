"""Rank 0's host readings, the same on every rank.

Host policy that every rank of a serving world runs (the SLA session's
admission, evictions and fused-round K; the engine's aging stamps; the
serving worker's loop) must decide alike on each rank, or the ranks'
collectives part ways. Where such policy reads the host (a clock, the
spool directory, a stop file, a signal), rank 0 alone reads it and
broadcasts what it read. The broadcasts run over a gloo group of their own
(``new_group(backend="gloo")``): a host scalar never passes through NCCL,
needs no device sync and cannot sit inside a CUDA graph.

Every rank must make the same calls in the same order (each is a
collective); only rank 0 evaluates the function it is given. The group is
made at the first call (``new_group`` is itself a collective), so ranks
may build the object one at a time.
"""
from typing import Any, Callable, Dict

import torch


class Rank0:
    """Broadcasts of rank 0's host values over a gloo group of the default
    group's ranks."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._group = group
        self.rank = dist.get_rank()
        self.lead = self.rank == 0

    @property
    def group(self):
        if self._group is None:
            import torch.distributed as dist

            self._group = dist.new_group(backend="gloo")
        return self._group

    def value(self, fn: Callable[[], float]) -> float:
        """One float: ``fn()`` on rank 0 (float64 on the wire)."""
        import torch.distributed as dist

        buf = torch.tensor([fn() if self.lead else 0.0], dtype=torch.float64)
        dist.broadcast(buf, src=0, group=self.group)
        return buf.item()

    def obj(self, fn: Callable[[], Any]) -> Any:
        """Any picklable object: ``fn()`` on rank 0."""
        import torch.distributed as dist

        box = [fn() if self.lead else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def total(self, counts: Dict[str, int]) -> Dict[str, int]:
        """Integer counts summed over the ranks (every rank passes the same
        keys)."""
        import torch.distributed as dist

        keys = sorted(counts)
        buf = torch.tensor([int(counts[k]) for k in keys], dtype=torch.int64)
        dist.all_reduce(buf, group=self.group)
        return dict(zip(keys, buf.tolist()))
