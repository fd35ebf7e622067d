"""Card-feeding data loader.

Port of ``deepspeedsyclsupport_tpu/runtime/dataloader.py``. It takes any
host iterable of batches (dicts, lists or tuples of numpy arrays or
tensors) and hands the engine batches already on its device: on the card
each leaf is copied into pinned host memory and then to the card with a
``non_blocking`` copy (PyTorch's pinned allocator keeps the buffer until
the copy has run), ``prefetch`` batches ahead, so the copies overlap the
step in flight.

With a ``topology`` (``comm/topology.py``) each batch of the dataset is a
GLOBAL batch and each rank is handed its rows of it by its (data, fsdp)
coordinate, as the JAX loader's ``data_sharding`` places them
(``dataloader.py:29-110``, ``topology.py:148``): block ``c`` of ``n``. With
``gradient_accumulation_steps`` > 1 the rows come in the order the engine's
micro-batches take them (the JAX engine cuts the global batch into
micro-batches first and splits each over the ranks). Ranks that differ
only on ``model`` or ``expert`` get the same rows (the JAX package
replicates tokens over both: an MoE layer's expert ranks see the same
tokens and each runs its own experts on them).

Iterator state is checkpointable (``state_dict`` / ``load_state_dict``:
epoch and offset within it, plus the shuffle seed), the engine carries it in
the checkpoint meta, and the training sentinel's rollback rewinds it.
:class:`CheckpointableDataLoader` reads a ``Sequence`` by index and derives
every batch from its ``(epoch, offset)`` state, so a rewind takes effect on
the very next ``__next__``; its per-epoch shuffle is
``np.random.default_rng((seed, epoch)).permutation``, the JAX loader's
order exactly.
"""
import itertools
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..comm.topology import MeshTopology
from ..device import resolve_device


def rank_rows(x, topology: MeshTopology, gas: int = 1,
              rank: Optional[int] = None):
    """``rank``'s (default: this process's) rows of a global batch leaf
    ``x`` (see the module docstring): for each of the ``gas`` micro-batches
    of consecutive rows, its ``c``-th of ``n`` blocks, (data, fsdp) index
    ``c``. Every ``pipe``, ``seq``, ``expert`` and ``model`` rank of a
    (data, fsdp) coordinate reads the same rows: a pipeline's stages all
    need them (the first the
    ids, the last the labels), and a ``seq`` rank's chunk of each row is
    cut by the engine after the labels' shift."""
    n = topology.get_data_parallel_world_size()
    if n == 1:
        return x
    c = topology.axis_index(("data", "fsdp"), rank)
    lead = x.shape[0]
    if lead % (gas * n):
        raise ValueError(f"global batch of {lead} rows does not split into "
                         f"{gas} micro-batches over {n} ranks")
    per = lead // gas
    mb = per // n
    parts = [x[i * per + c * mb:i * per + (c + 1) * mb] for i in range(gas)]
    if isinstance(x, torch.Tensor):
        return torch.cat(parts) if gas > 1 else parts[0]
    return np.concatenate(parts) if gas > 1 else parts[0]


def _to_device(batch: Any, device: torch.device) -> Any:
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    t = torch.as_tensor(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch)
    if device.type == "cuda":
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    # a copy: the caller may mutate what it is handed
    return t.to(device, copy=True)


class DSTpuDataLoader:
    """Generator loader over any iterable (``__iter__`` starts an epoch
    from the saved offset). ``device``: None means the card; a
    ``MeshTopology`` in its place is the ``topology`` (the JAX loader's
    ``DSTpuDataLoader(dataset, topology)``), the device then the card."""

    def __init__(self, dataset: Iterable, device=None,
                 batch_fn: Optional[Callable[[Any], Any]] = None,
                 prefetch: int = 2, topology: Optional[MeshTopology] = None,
                 gradient_accumulation_steps: int = 1):
        if isinstance(device, MeshTopology):
            topology, device = device, None
        self.dataset = dataset
        self.device = resolve_device(device)
        self.batch_fn = batch_fn
        self.prefetch = max(0, prefetch)
        self.topology = topology
        self.gas = int(gradient_accumulation_steps)
        self._len = None
        self._epoch = 0    # completed passes over the dataset
        self._offset = 0   # batches yielded within the current epoch
        try:
            self._len = len(dataset)  # type: ignore[arg-type]
        except TypeError:
            pass

    def __len__(self):
        if self._len is None:
            raise TypeError("underlying dataset has no length")
        return self._len

    # ------------------------------------------------------------ state
    @property
    def position(self) -> int:
        """Batches yielded over the loader's life (epoch-major) when the
        dataset is sized; the offset within the epoch otherwise."""
        if self._len is None:
            return self._offset
        return self._epoch * self._len + self._offset

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "offset": self._offset}

    def load_state_dict(self, sd: dict) -> None:
        """Restore the stream position; takes effect at the next
        ``__iter__``, which skips the epoch's first ``offset`` batches."""
        self._epoch = int(sd.get("epoch", 0))
        self._offset = int(sd.get("offset", 0))

    def _rows(self, batch):
        if isinstance(batch, dict):
            return {k: self._rows(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._rows(v) for v in batch)
        x = batch if isinstance(batch, torch.Tensor) else np.asarray(batch)
        return rank_rows(x, self.topology, self.gas)

    def _place(self, batch):
        if self.topology is not None:
            batch = self._rows(batch)
        return _to_device(batch, self.device)

    def __iter__(self) -> Iterator[Any]:
        it = iter(self.dataset)
        if self._offset:
            # resume: burn the head of the epoch the saved run consumed
            it = itertools.islice(it, self._offset, None)
        if self.batch_fn is not None:
            it = (self.batch_fn(b) for b in it)

        def track(source):
            # count BEFORE yield: while batch k trains the offset is k+1, so
            # a save at that step resumes on the next batch. (With prefetch
            # the count runs ahead by the ring; exact positions want
            # prefetch=0 or CheckpointableDataLoader.)
            for b in source:
                self._offset += 1
                yield b
            self._epoch += 1
            self._offset = 0

        placed = (self._place(b) for b in track(it))
        if self.prefetch == 0:
            yield from placed
            return
        # keep `prefetch` batches in flight: their copies are queued ahead
        # of the consumer's step
        buf = list(itertools.islice(placed, self.prefetch))
        for nxt in placed:
            yield buf.pop(0)
            buf.append(nxt)
        yield from buf


class CheckpointableDataLoader(DSTpuDataLoader):
    """Random-access loader over a ``Sequence`` with a deterministic
    per-epoch shuffle and a rewind that takes effect at once: ``__iter__``
    returns ``self`` and each ``__next__`` derives its index from the
    ``(epoch, offset)`` state. No prefetch (a rewind would have to drop
    batches in flight)."""

    def __init__(self, dataset: Sequence, device=None,
                 batch_fn: Optional[Callable[[Any], Any]] = None,
                 shuffle: bool = False, seed: int = 0,
                 topology: Optional[MeshTopology] = None,
                 gradient_accumulation_steps: int = 1):
        super().__init__(
            dataset, device, batch_fn=batch_fn, prefetch=0,
            topology=topology,
            gradient_accumulation_steps=gradient_accumulation_steps)
        if self._len is None:
            raise TypeError("CheckpointableDataLoader needs a Sequence "
                            "dataset (random access + __len__)")
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self._perm_epoch = None
        self._perm = None

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "offset": self._offset,
                "shuffle": self.shuffle, "seed": self.seed}

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        if "seed" in sd:
            self.seed = int(sd["seed"])

    def _order(self, epoch: int) -> np.ndarray:
        if self._perm_epoch != epoch:
            if self.shuffle:
                rng = np.random.default_rng((self.seed, epoch))
                self._perm = rng.permutation(self._len)
            else:
                self._perm = np.arange(self._len)
            self._perm_epoch = epoch
        return self._perm

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._offset >= self._len:
            self._epoch += 1
            self._offset = 0
            raise StopIteration
        idx = int(self._order(self._epoch)[self._offset])
        self._offset += 1
        b = self.dataset[idx]
        if self.batch_fn is not None:
            b = self.batch_fn(b)
        return self._place(b)


class RepeatingLoader:
    """Restart an iterator on exhaustion (reference ``RepeatingLoader``)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)
