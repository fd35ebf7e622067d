"""Named-axis process mesh.

Port of ``deepspeedsyclsupport_tpu/comm/topology.py``. The JAX package
builds one ``jax.sharding.Mesh`` over its devices with the six named axes
of :data:`AXIS_ORDER`; here the same axes name the dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, rank ``r`` at the place device ``r`` has in the JAX mesh
(``np.arange(world).reshape(sizes in AXIS_ORDER)``), so that a shard the
JAX package puts on device ``r`` is the shard rank ``r`` holds here.

A topology can be built without a process group (``world_size=``): it then
plans (coordinates, shard shapes, specs) and builds no group; the groups
are made by :meth:`MeshTopology.init_groups`, a collective that every rank
calls once the default group exists. At a world of one with no process
group every axis has size 1 and :meth:`get_group` returns None, which the
collectives take as "nothing to exchange".

Where the JAX package returns a ``NamedSharding``, :meth:`sharding`,
:meth:`replicated` and :meth:`data_sharding` return a plain spec: a tuple
with one entry per tensor dim, each a tuple of axis names (``()``:
replicated on that dim). A dim split over several axes is split
row-major over them in the order named, as ``PartitionSpec`` does.
"""
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# Outer-to-inner layout order, as the JAX package's (``topology.py:34``).
AXIS_ORDER: Tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq",
                               "model")

Spec = Tuple[Tuple[str, ...], ...]
Axes = Union[str, Sequence[str]]

_WORLD_TOPOLOGY: Optional["MeshTopology"] = None

# the axis tuples a training step reduces over, each built by init_groups
# as named and as its live part (the axes of size > 1): the batch axes
# with seq (the loss's token count; an MoE layer's routing counts), the
# same with pipe (the step's losses and metrics), data with seq (ZeRO-2/3
# grads under sequence parallelism) and the expert region (an MoE layer's
# partial outputs over expert and model). A group made in the middle of a
# step could deadlock a pipeline: its stages reach it at other times.
COMBINED: Tuple[Tuple[str, ...], ...] = (
    ("data", "fsdp"), ("data", "fsdp", "seq"), ("pipe", "data", "fsdp"),
    ("pipe", "data", "fsdp", "seq"), ("data", "seq"), ("expert", "model"))


def spec_entry(entry) -> Tuple[str, ...]:
    """One ``PartitionSpec`` entry (None, a name or a tuple of names) as a
    tuple of names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(a for a in entry if a is not None)


def as_spec(*spec_axes) -> Spec:
    return tuple(spec_entry(e) for e in spec_axes)


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _world_of_default_group() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank_of_default_group() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MeshTopology:
    """One named mesh over every parallelism axis (JAX ``MeshTopology``).

    ``axis_sizes`` maps axis name -> size; absent axes have size 1; at most
    one axis may be ``-1``, meaning the rest of the world. ``world_size``
    defaults to the default process group's (1 without one).
    The ``DeviceMesh``'s device type is ``"cuda"`` under an NCCL default
    group, else ``"cpu"`` (gloo: the groups serve CPU and CUDA tensors
    alike)."""

    def __init__(self, axis_sizes: Dict[str, int],
                 world_size: Optional[int] = None):
        n = int(world_size) if world_size is not None \
            else _world_of_default_group()
        unknown = set(axis_sizes) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"Unknown mesh axes {unknown}; valid: "
                             f"{AXIS_ORDER}")
        sizes = {ax: int(axis_sizes.get(ax, 1)) for ax in AXIS_ORDER}
        wild = [ax for ax, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError("At most one axis may be -1 (auto-fill)")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n % fixed != 0:
                raise ValueError(f"World size {n} not divisible by fixed "
                                 f"axes product {fixed}")
            sizes[wild[0]] = n // fixed
        total = math.prod(sizes.values())
        if total != n:
            raise ValueError(f"Mesh axes {sizes} multiply to {total} but the "
                             f"world has {n} ranks")
        self.axis_sizes: Dict[str, int] = sizes
        self.shape: Tuple[int, ...] = tuple(sizes[a] for a in AXIS_ORDER)
        self._ranks = np.arange(n).reshape(self.shape)
        self._mesh = None
        self._groups: Dict[Tuple[str, ...], Any] = {}
        # (axis, src index, dst index) -> this rank's direction group
        self._p2p: Dict[Tuple[str, int, int], Any] = {}
        # (axis, group size) -> this rank's (intra, inter) groups
        self._hier: Dict[Tuple[str, int], Tuple[Any, Any]] = {}

    # ----------------------------------------------------------- the mesh
    @property
    def rank(self) -> int:
        return _rank_of_default_group()

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` (default: this process)."""
        r = self.rank if rank is None else int(rank)
        return dict(zip(AXIS_ORDER, (int(i) for i in np.unravel_index(
            r, self.shape))))

    def axis_index(self, axis: Axes, rank: Optional[int] = None) -> int:
        """Index of ``rank`` along ``axis`` (several axes: row-major over
        them in the order named)."""
        c = self.coords(rank)
        idx = 0
        for a in _axes(axis):
            idx = idx * self.axis_sizes[a] + c[a]
        return idx

    def axis_size(self, axis: Axes) -> int:
        return math.prod(self.axis_sizes[a] for a in _axes(axis))

    def group_ranks(self, axis: Axes, rank: Optional[int] = None
                    ) -> List[int]:
        """Global ranks of ``rank``'s group along ``axis``, by index along
        it."""
        c = self.coords(rank)
        axes = _axes(axis)
        out = []
        for idx in np.ndindex(*(self.axis_sizes[a] for a in axes)):
            cc = dict(c, **dict(zip(axes, idx)))
            out.append(int(self._ranks[tuple(cc[a] for a in AXIS_ORDER)]))
        return out

    def _check_order(self, axes: Tuple[str, ...]) -> None:
        pos = [AXIS_ORDER.index(a) for a in axes]
        if pos != sorted(pos) or len(set(pos)) != len(pos):
            # a process group orders its ranks by global rank, which is the
            # mesh's row-major order: a group over axes named out of that
            # order would concatenate its shards in another order
            raise ValueError(f"axes {axes} must be named in AXIS_ORDER order "
                             f"{AXIS_ORDER}")

    @property
    def mesh(self):
        """The ``DeviceMesh`` (built by :meth:`init_groups`)."""
        if self._mesh is None:
            self.init_groups()
        return self._mesh

    def live(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` without those of size 1."""
        return tuple(a for a in axes if self.axis_sizes[a] > 1)

    def init_groups(self, combined: Optional[Iterable[Sequence[str]]] = None,
                    hierarchical: Iterable[Tuple[str, int]] = ()) -> None:
        """Build the ``DeviceMesh`` (one group per axis), a group for
        each multi-axis tuple of ``combined`` (default: each tuple of
        :data:`COMBINED` and its live part), the sub-groups of
        :meth:`hierarchical_groups` for each ``(axis, group size)`` of
        ``hierarchical``, and, when ``pipe`` is longer than 1, the direction
        groups of :meth:`p2p_group`. A collective: every rank of the default
        group calls it, with the same arguments."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if not (dist.is_available() and dist.is_initialized()):
            if self._ranks.size == 1:
                return
            raise RuntimeError("MeshTopology.init_groups needs the default "
                               "process group (comm.init_distributed)")
        if dist.get_world_size() != self._ranks.size:
            raise ValueError(f"the topology spans {self._ranks.size} ranks, "
                             f"the process group {dist.get_world_size()}")
        if self._mesh is None:
            self._mesh = DeviceMesh(
                "cuda" if dist.get_backend() == "nccl" else "cpu",
                torch.from_numpy(self._ranks.copy()),
                mesh_dim_names=AXIS_ORDER)
        if combined is None:
            combined = [t for axes in COMBINED
                        for t in (axes, self.live(axes)) if len(t) > 1]
        for axes in combined:
            self._combined_group(tuple(axes))
        for axis, gs in hierarchical:
            self.hierarchical_groups(axis, gs)
        self._direction_groups("pipe")

    def hierarchical_groups(self, axis: str, group_size: int):
        """``(intra, inter)``: this rank's process groups for a two-hop
        all-to-all along ``axis`` in groups of ``group_size`` consecutive
        indices: its group (indices ``G gs .. G gs + gs - 1``) and the ranks
        at its place in every group (indices ``g gs + l``). Built by
        :meth:`init_groups`, else here, which is then a collective like
        it: every rank of the default group asks together."""
        import torch.distributed as dist

        key = (axis, int(group_size))
        if key in self._hier:
            return self._hier[key]
        gs = int(group_size)
        n = self.axis_sizes[axis]
        if n % gs:
            raise ValueError(f"axis {axis} of size {n} not divisible by "
                             f"group_size {gs}")
        ng = n // gs
        mine = [None, None]
        seen = set()
        for r in range(self._ranks.size):   # every group, in one order
            ranks = tuple(self.group_ranks(axis, r))
            if ranks in seen:
                continue
            seen.add(ranks)
            for which, sets in enumerate((
                    [[g * gs + l for l in range(gs)] for g in range(ng)],
                    [[g * gs + l for g in range(ng)] for l in range(gs)])):
                for idx in sets:
                    members = [ranks[i] for i in idx]
                    group = dist.new_group(members)
                    if self.rank in members:
                        mine[which] = group
        self._hier[key] = (mine[0], mine[1])
        return self._hier[key]

    def _direction_groups(self, axis: str) -> None:
        """Two groups of two ranks for each pair of neighbours along
        ``axis`` (index i -> i+1 and i+1 -> i), every rank creating every
        group in one order."""
        import torch.distributed as dist

        n = self.axis_sizes[axis]
        if n == 1 or any(k[0] == axis for k in self._p2p):
            return
        seen = set()
        for r in range(self._ranks.size):
            ranks = tuple(self.group_ranks(axis, r))
            if ranks in seen:
                continue
            seen.add(ranks)
            for i in range(n - 1):
                for src, dst in ((i, i + 1), (i + 1, i)):
                    g = dist.new_group([ranks[src], ranks[dst]])
                    if self.rank in (ranks[src], ranks[dst]):
                        self._p2p[(axis, src, dst)] = g

    def p2p_group(self, axis: str, src: int, dst: int):
        """The process group a send from index ``src`` to index ``dst``
        along ``axis`` goes through: the pair's direction group when
        :meth:`init_groups` built one (neighbours along ``pipe``, where a
        pipeline's activations go one way and its gradients the other),
        else the axis's group."""
        group = self.get_group(axis)   # builds the mesh (direction groups)
        return self._p2p.get((axis, src, dst), group)

    def _combined_group(self, axes: Tuple[str, ...]):
        import torch.distributed as dist

        self._check_order(axes)
        if axes in self._groups:
            return self._groups[axes]
        mine = None
        seen = set()
        for r in range(self._ranks.size):   # every group, in one order
            ranks = tuple(self.group_ranks(axes, r))
            if ranks in seen:
                continue
            seen.add(ranks)
            g = dist.new_group(list(ranks))
            if self.rank in ranks:
                mine = g
        self._groups[axes] = mine
        return mine

    def get_group(self, axis: Axes):
        """The process group of this rank along ``axis`` (a name, or a tuple
        named in ``AXIS_ORDER`` order); None with no process group at a
        world of one."""
        import torch.distributed as dist

        axes = _axes(axis)
        if not (dist.is_available() and dist.is_initialized()):
            if self._ranks.size == 1:
                return None
            raise RuntimeError("no process group: call "
                               "comm.init_distributed first")
        if set(axes) == set(AXIS_ORDER):
            self._check_order(axes)
            return dist.group.WORLD
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if self._mesh is None:
            self.init_groups(combined=())
        if axes not in self._groups:
            # a collective like init_groups: every rank asks together
            return self._combined_group(axes)
        return self._groups[axes]

    # ------------------------------------------- accessors (groups.py parity)
    def get_data_parallel_world_size(self) -> int:
        """Replicas of the batch = data x fsdp (ZeRO shards are data-
        parallel replicas to the model)."""
        return self.axis_sizes["data"] * self.axis_sizes["fsdp"]

    def get_model_parallel_world_size(self) -> int:
        return self.axis_sizes["model"]

    def get_pipe_parallel_world_size(self) -> int:
        return self.axis_sizes["pipe"]

    def get_expert_parallel_world_size(self) -> int:
        return self.axis_sizes["expert"]

    def get_sequence_parallel_world_size(self) -> int:
        return self.axis_sizes["seq"]

    def get_fsdp_world_size(self) -> int:
        return self.axis_sizes["fsdp"]

    def world_size(self) -> int:
        return int(self._ranks.size)

    # ------------------------------------------------------------ specs
    def sharding(self, *spec_axes) -> Spec:
        """The spec for per-dim axis names:
        ``topo.sharding(("data", "fsdp"), None, "model")`` splits dim 0
        over data x fsdp, replicates dim 1 and splits dim 2 over model."""
        spec = as_spec(*spec_axes)
        for entry in spec:
            unknown = set(entry) - set(AXIS_ORDER)
            if unknown:
                raise ValueError(f"unknown mesh axes {unknown}")
        return spec

    def replicated(self) -> Spec:
        return ()

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Axes over which the global batch is split (data + fsdp)."""
        return tuple(ax for ax in ("data", "fsdp")
                     if self.axis_sizes[ax] > 1) or ("data",)

    def data_sharding(self, ndim: int) -> Spec:
        """Input-batch spec: dim 0 over (data, fsdp), the rest
        replicated."""
        return as_spec(("data", "fsdp"), *([None] * (ndim - 1)))

    def shard_shape(self, shape: Sequence[int], spec: Spec
                    ) -> Tuple[int, ...]:
        """The shape of one shard of a ``shape`` tensor laid out by
        ``spec`` (``NamedSharding.shard_shape``)."""
        out = list(shape)
        for i, entry in enumerate(spec):
            n = self.axis_size(entry) if entry else 1
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                                 f"by {entry} ({n})")
            out[i] //= n
        return tuple(out)

    def shard_slices(self, shape: Sequence[int], spec: Spec,
                     rank: Optional[int] = None) -> Tuple[slice, ...]:
        """The index of ``rank``'s shard in the full tensor."""
        local = self.shard_shape(shape, spec)
        out = []
        for i, n in enumerate(local):
            entry = spec[i] if i < len(spec) else ()
            k = self.axis_index(entry, rank) if entry else 0
            out.append(slice(k * n, (k + 1) * n))
        return tuple(out)

    def __repr__(self):
        return f"MeshTopology({self.axis_sizes})"


def build_topology(dp: int = -1, fsdp: int = 1, tp: int = 1, pp: int = 1,
                   ep: int = 1, sp: int = 1,
                   world_size: Optional[int] = None) -> MeshTopology:
    """Build and install the world topology (reference
    ``groups.initialize()``)."""
    topo = MeshTopology({"data": dp, "fsdp": fsdp, "model": tp, "pipe": pp,
                         "expert": ep, "seq": sp}, world_size=world_size)
    set_world_topology(topo)
    return topo


def set_world_topology(topo: Optional[MeshTopology]) -> None:
    global _WORLD_TOPOLOGY
    _WORLD_TOPOLOGY = topo


def get_world_topology() -> MeshTopology:
    global _WORLD_TOPOLOGY
    if _WORLD_TOPOLOGY is None:
        _WORLD_TOPOLOGY = build_topology()
    return _WORLD_TOPOLOGY


def reset_world_topology() -> None:
    global _WORLD_TOPOLOGY
    _WORLD_TOPOLOGY = None
