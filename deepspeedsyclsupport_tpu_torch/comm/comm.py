"""Collectives façade on ``torch.distributed``.

Port of ``deepspeedsyclsupport_tpu/comm/comm.py``. A JAX call names a mesh
axis inside ``shard_map``; here the same call names an axis (or a tuple of
axes) of the world topology (``comm/topology.py``), which resolves it to
that axis's process group, and runs the collective eagerly on this rank's
tensor. The results are the JAX package's: ``all_gather`` concatenates
(``tiled``) or stacks the shards along ``axis``, ``reduce_scatter`` sums
and hands out the pieces along ``axis``, ``all_to_all`` splits along
``split_axis`` and concatenates what arrives along ``concat_axis``,
``ppermute`` zero-fills a rank nobody sends to. Each call returns a new
tensor and leaves its input as it was. ``ppermute`` and ``all_to_all`` are
differentiable on a tensor that needs a gradient (their backward is the
transpose JAX's AD derives: the inverse permutation, and the all-to-all
with its split and concat axes swapped); the others are not: the model's
autograd functions (``parallel/tensor_parallel.py``, ``runtime/zero.py``)
call them in their forward and backward.

``hierarchical_all_to_all`` is the all-to-all in two hops (within groups
of consecutive indices, then across them, over sub-groups the topology
builds); ``reduce``, ``gather`` and ``scatter`` give every rank the JAX
package's defined value (the root's result, or the stack on every rank);
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single`` and ``inference_all_reduce`` are the reference's
aliases of the ops they name; ``monitored_barrier``, ``get_global_rank``,
``get_world_group`` and ``get_all_ranks_from_group`` its bookkeeping over
torch's process groups.

``send`` / ``recv`` are the reference's one-sided point-to-point ops (the
JAX façade maps both to the collective ``p2p``, because under SPMD every
device runs the same call; here a process is a rank). Between neighbours
of an axis that the topology built direction groups for (``pipe``) each
direction has a process group of its own, so a send one way never queues
behind a send the other way on one communicator.

The backend is chosen once, by :func:`init_distributed`, from an explicit
argument, else by :func:`choose_backend`'s rule (NCCL when every rank has a
card of its own; gloo for CPU tensors and for ranks that share one card),
and logged. On gloo a CUDA tensor goes through the ops gloo takes for CUDA
tensors as it is; the ops of :data:`HOST_STAGED` are staged through pinned
host memory (copied out, run on the host copy, copied back). That rule is
one table keyed on (backend, op): nothing here catches a collective's
failure and tries another way.

Kill switches (``DSTPU_COMM_<OP>_OFF``, the reference's ``DS_COMM_*_OFF``)
turn a collective into the identity; every call is recorded by the comms
logger (``comm/comms_logging.py``) under ``"<op>[<axis>]"`` with the bytes
of the tensor handed to it.
"""
import logging
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .comms_logging import comms_logger
from . import topology as topo_mod

logger = logging.getLogger(__name__)

__all__ = [
    "all_reduce", "pmean", "all_gather", "reduce_scatter", "all_to_all",
    "hierarchical_all_to_all", "ppermute", "send_recv_next",
    "send_recv_prev", "broadcast", "all_reduce_coalesced",
    "all_gather_coalesced", "axis_size", "axis_index", "init_distributed",
    "is_initialized", "barrier", "get_world_size", "get_rank",
    "get_local_rank", "get_device_count", "new_group",
    "destroy_process_group", "choose_backend", "HOST_STAGED", "staged_ops",
    # the reference's surface (root-based ops, p2p, aliases)
    "reduce", "gather", "scatter", "send", "recv", "p2p",
    "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
    "inference_all_reduce", "monitored_barrier", "get_global_rank",
    "get_world_group", "get_all_ranks_from_group",
]

_DEFAULT_SLURM_PORT = 29500
# (backend, op) pairs whose CUDA tensors are staged through pinned host
# memory. On torch 2.11 gloo takes CUDA tensors for all_reduce,
# all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and
# broadcast (and reduce and scatter), and its send / recv fail on
# them ("writev: Bad address"); chip_smoke.py's dist phase holds every façade
# op on CUDA tensors over gloo and prints which calls were staged
HOST_STAGED = frozenset({("gloo", "ppermute"), ("gloo", "send"),
                         ("gloo", "recv")})
_STAGED_CALLS: Dict[str, int] = {}


# ---------------------------------------------------------------------------
# kill switches and logging (JAX comm.py:56-72)
# ---------------------------------------------------------------------------
def _off(op: str) -> bool:
    return os.environ.get(f"DSTPU_COMM_{op}_OFF", "").lower() in (
        "1", "true", "yes")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _log(op: str, axis, x, seconds: Optional[float] = None):
    comms_logger.append(op, axis, _nbytes(x),
                        tuple(getattr(x, "shape", ())), seconds)


def staged_ops() -> Dict[str, int]:
    """Calls staged through host memory so far, by op."""
    return dict(_STAGED_CALLS)


# ---------------------------------------------------------------------------
# axis resolution
# ---------------------------------------------------------------------------
def _resolve(axis_name):
    """(group, size, axes) of ``axis_name`` on the world topology. The
    group is None when there is no process group (a world of one)."""
    topo = topo_mod.get_world_topology()
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return topo.get_group(axes), topo.axis_size(axes), axes


def axis_size(axis_name) -> int:
    return topo_mod.get_world_topology().axis_size(
        (axis_name,) if isinstance(axis_name, str) else tuple(axis_name))


def axis_index(axis_name) -> int:
    return topo_mod.get_world_topology().axis_index(axis_name)


def _staged(group, op: str, x: torch.Tensor) -> bool:
    import torch.distributed as dist

    if x.device.type != "cuda" or group is None:
        return False
    if (dist.get_backend(group), op) in HOST_STAGED:
        _STAGED_CALLS[op] = _STAGED_CALLS.get(op, 0) + 1
        return True
    return False


def _to_host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def _run(op: str, axis_name, x: torch.Tensor, fn):
    """Log ``x`` under ``op``, then ``fn(group, n, x)``: on the host copy of
    ``x`` when (backend, op) is staged (the result copied back to ``x``'s
    device), timed when the logger is."""
    group, n, _ = _resolve(axis_name)
    timed = comms_logger.enabled and comms_logger.timed
    if timed and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    if _staged(group, op, x):
        out = fn(group, n, _to_host(x)).to(x.device, non_blocking=True)
    else:
        out = fn(group, n, x)
    seconds = None
    if timed:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        seconds = time.perf_counter() - t0
    _log(op, axis_name, x, seconds)
    return out


# ---------------------------------------------------------------------------
# named-axis collectives
# ---------------------------------------------------------------------------
def _reduce_op(op: str):
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
           "mean": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM}
    if op not in ops:
        raise ValueError(f"unsupported reduce op {op!r}")
    return ops[op]


def all_reduce(x: torch.Tensor, axis_name, op: str = "sum") -> torch.Tensor:
    """Reduce across a mesh axis: ``sum``, ``max``, ``min``, ``prod``, or
    ``mean`` / ``avg`` (the sum over the axis size, as ``lax.pmean``)."""
    if _off("ALL_REDUCE"):
        return x
    red = _reduce_op(op)

    def fn(group, n, t):
        import torch.distributed as dist

        out = t.clone()
        if group is not None:
            dist.all_reduce(out, op=red, group=group)
        return out / n if op in ("mean", "avg") else out

    return _run("all_reduce", axis_name, x, fn)


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    if _off("ALL_REDUCE"):
        return x

    def fn(group, n, t):
        import torch.distributed as dist

        out = t.clone()
        if group is not None:
            dist.all_reduce(out, group=group)
        return out / n

    return _run("all_reduce_mean", axis_name, x, fn)


def _gather_stacked(group, n, t: torch.Tensor) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` by its index along the axis."""
    import torch.distributed as dist

    t = t.contiguous()
    if group is None:
        return t[None].clone()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device) if t.dim() else \
        torch.empty((n,), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1) if not t.dim() else t,
                                group=group)
    return out.reshape((n,) + tuple(t.shape))


def all_gather(x: torch.Tensor, axis_name, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along the mesh axis: concatenated along ``axis``
    (``tiled``) or stacked in a new dim ``axis``."""
    if _off("ALL_GATHER"):
        return x

    def fn(group, n, t):
        g = _gather_stacked(group, n, t)
        if not tiled:
            return g.movedim(0, axis)
        return torch.cat(list(g.unbind(0)), dim=axis)

    return _run("all_gather", axis_name, x, fn)


def reduce_scatter(x: torch.Tensor, axis_name, axis: int = 0
                   ) -> torch.Tensor:
    """Sum over the mesh axis, then piece ``i`` (of ``n`` along ``axis``)
    to the rank at index ``i``."""
    if _off("REDUCE_SCATTER"):
        return x

    def fn(group, n, t):
        import torch.distributed as dist

        if t.shape[axis] % n:
            raise ValueError(f"dim {axis} of {tuple(t.shape)} does not "
                             f"divide by the axis size {n}")
        tm = t.movedim(axis, 0).contiguous()
        if group is None:
            return tm.movedim(0, axis).clone()
        out = torch.empty((tm.shape[0] // n,) + tuple(tm.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, tm, group=group)
        return out.movedim(0, axis)

    return _run("reduce_scatter", axis_name, x, fn)


def _exchange(inp: torch.Tensor, group) -> torch.Tensor:
    """``inp`` [m, ...]: piece ``j`` to the group's rank ``j``; returns
    [m, ...], piece ``i`` from the group's rank ``i``."""
    import torch.distributed as dist

    inp = inp.contiguous()
    out = torch.empty_like(inp)
    if group is None:
        out.copy_(inp)
    else:
        dist.all_to_all_single(out, inp, group=group)
    return out


def _all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    def fn(group, n, t):
        if tiled:
            if t.shape[split_axis] % n:
                raise ValueError(f"split dim {t.shape[split_axis]} not "
                                 f"divisible by axis size {n}")
            out = _exchange(torch.stack(t.chunk(n, dim=split_axis), 0),
                            group)
            return torch.cat(list(out.unbind(0)), dim=concat_axis)
        if t.shape[split_axis] != n:
            raise ValueError(f"untiled all_to_all: split dim "
                             f"{t.shape[split_axis]} must equal the axis "
                             f"size {n}")
        return _exchange(t.movedim(split_axis, 0), group).movedim(
            0, concat_axis)

    return _run("all_to_all", axis_name, x, fn)


class _AllToAll(torch.autograd.Function):
    """all_to_all; backward: the all-to-all with split and concat swapped
    (its transpose: the piece rank i sent to rank j goes back)."""

    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, tiled):
        ctx.args = (axis_name, split_axis, concat_axis, tiled)
        return _all_to_all(x, axis_name, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis, tiled = ctx.args
        return _all_to_all(g.contiguous(), axis_name, concat_axis,
                           split_axis, tiled), None, None, None, None


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """``lax.all_to_all``. ``tiled``: piece ``j`` of ``x`` along
    ``split_axis`` (of ``n`` equal pieces) goes to the rank at index ``j``,
    and what arrives is concatenated along ``concat_axis`` by sender index.
    Untiled: ``split_axis`` has size ``n``, index ``j`` of it goes to rank
    ``j``, and what arrives is stacked in a new dim ``concat_axis`` (of the
    result, whose ``split_axis`` is gone) by sender index.
    Differentiable."""
    if _off("ALL_TO_ALL"):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, axis_name, split_axis, concat_axis, tiled)
    return _all_to_all(x, axis_name, split_axis, concat_axis, tiled)


def _hierarchical(x, axis_name, gs, split_axis, concat_axis):
    topo = topo_mod.get_world_topology()
    intra, inter = topo.hierarchical_groups(axis_name, gs)

    def fn(group, n, t):
        if t.shape[split_axis] % n:
            raise ValueError(f"split dim {t.shape[split_axis]} not "
                             f"divisible by axis size {n}")
        ng = n // gs
        # parts [ng, gs, ...]: chunk (tg, tl) goes to index tg * gs + tl
        parts = torch.stack(t.chunk(n, dim=split_axis), 0)
        parts = parts.reshape((ng, gs) + tuple(parts.shape[1:]))
        # hop 1, within the group: z[tg, sl] = source (G, sl)'s (tg, my l)
        z = _exchange(parts.transpose(0, 1), intra).transpose(0, 1)
        # hop 2, across groups: w[sg, sl] = source (sg, sl)'s (my g, my l)
        w = _exchange(z, inter)
        w = w.reshape((n,) + tuple(w.shape[2:]))   # source-major
        return torch.cat(list(w.unbind(0)), dim=concat_axis)

    return _run("hierarchical_all_to_all", axis_name, x, fn)


class _HierarchicalAllToAll(torch.autograd.Function):
    """hierarchical_all_to_all; backward: the same exchange with split and
    concat swapped (the plain all-to-all's transpose)."""

    @staticmethod
    def forward(ctx, x, axis_name, gs, split_axis, concat_axis):
        ctx.args = (axis_name, gs, split_axis, concat_axis)
        return _hierarchical(x, axis_name, gs, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis_name, gs, split_axis, concat_axis = ctx.args
        return _hierarchical(g.contiguous(), axis_name, gs, concat_axis,
                             split_axis), None, None, None, None


def hierarchical_all_to_all(x: torch.Tensor, axis_name, group_size: int,
                            split_axis: int = 0,
                            concat_axis: int = 0) -> torch.Tensor:
    """``all_to_all(x, axis_name, split_axis, concat_axis)`` in two hops
    (JAX ``hierarchical_all_to_all``, the reference's hierarchical MoE
    dispatch): with the axis's ``n`` ranks in groups of ``group_size``
    consecutive indices, every rank first exchanges within its group, then
    once across groups (with the ranks of its place in the other groups),
    over the sub-groups ``MeshTopology.hierarchical_groups`` holds. The
    result is the plain all-to-all's; with ``group_size`` 1 or ``n`` it is
    the plain all-to-all. Differentiable."""
    if _off("ALL_TO_ALL"):
        return x
    n = axis_size(axis_name)
    gs = int(group_size)
    if n % gs:
        raise ValueError(f"axis size {n} not divisible by group_size {gs}")
    if gs == 1 or gs == n:
        return all_to_all(x, axis_name, split_axis, concat_axis)
    if torch.is_grad_enabled() and x.requires_grad:
        return _HierarchicalAllToAll.apply(x, axis_name, gs, split_axis,
                                           concat_axis)
    return _hierarchical(x, axis_name, gs, split_axis, concat_axis)


def _ppermute(x, axis_name, perm):
    topo = topo_mod.get_world_topology()

    def fn(group, n, t):
        import torch.distributed as dist

        me = topo.axis_index(axis_name)
        ranks = topo.group_ranks(axis_name)
        t = t.contiguous()
        out = torch.zeros_like(t)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(t)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, t, ranks[dst], group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    return _run("ppermute", axis_name, x, fn)


class _PPermute(torch.autograd.Function):
    """ppermute; backward: the inverse permutation (a cotangent goes back
    from each destination to its source; a rank that sent nothing gets
    zeros)."""

    @staticmethod
    def forward(ctx, x, axis_name, perm):
        ctx.axis_name, ctx.perm = axis_name, perm
        return _ppermute(x, axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((dst, src) for src, dst in ctx.perm)
        return _ppermute(g.contiguous(), ctx.axis_name, inv), None, None


def ppermute(x: torch.Tensor, axis_name,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Point-to-point permutation along the axis, ``perm`` pairs of
    (source index, destination index); a rank that no pair sends to gets
    zeros (``lax.ppermute``). One batch of isend / irecv. Differentiable."""
    if _off("P2P"):
        return x
    perm = tuple((int(s), int(d)) for s, d in perm)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, axis_name, perm)
    return _ppermute(x, axis_name, perm)


class _Sent:
    """An unfinished :func:`send`: ``wait()`` ends it (the host copy of a
    staged tensor lives until then)."""
    __slots__ = ("work", "buf")

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
        self.work = self.buf = None


def _peer(axis_name, me: int, other: int, send_side: bool):
    """(group, global rank of index ``other``) for a send from ``me`` to
    ``other`` (``send_side``) or from ``other`` to ``me``."""
    topo = topo_mod.get_world_topology()
    src, dst = (me, other) if send_side else (other, me)
    group = topo.p2p_group(axis_name, src, dst)
    return group, topo.group_ranks(axis_name)[other]


def send(x: torch.Tensor, dst: int, axis_name, src: Optional[int] = None,
         async_op: bool = False):
    """Reference ``comm.send``: ``x`` to the rank at index ``dst`` along the
    axis, from this rank (``src``, when given, must be this rank's index).
    With ``async_op`` returns a handle whose ``wait()`` ends the send
    (``x`` is to stay as it is until then, unless it was staged: then a
    host copy was sent); otherwise waits and returns None."""
    import torch.distributed as dist

    if _off("P2P"):
        return None
    me = axis_index(axis_name)
    if src is not None and src != me:
        raise ValueError(f"send from index {src} called on index {me}")
    group, peer = _peer(axis_name, me, dst, True)
    t = _to_host(x) if _staged(group, "send", x) else x.contiguous()
    work = dist.isend(t, peer, group=group) if group is not None else None
    _log("send", axis_name, x)
    handle = _Sent(work, t)
    if async_op:
        return handle
    handle.wait()
    return None


def recv(x: torch.Tensor, src: int, axis_name,
         dst: Optional[int] = None) -> torch.Tensor:
    """Reference ``comm.recv``: a tensor of ``x``'s shape, dtype and device
    from the rank at index ``src`` along the axis (``x`` is left as it
    was; ``dst``, when given, must be this rank's index)."""
    import torch.distributed as dist

    if _off("P2P"):
        return x
    me = axis_index(axis_name)
    if dst is not None and dst != me:
        raise ValueError(f"recv into index {dst} called on index {me}")
    group, peer = _peer(axis_name, me, src, False)
    staged = _staged(group, "recv", x)
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if staged \
        else torch.empty_like(x, memory_format=torch.contiguous_format)
    if group is not None:
        dist.recv(buf, peer, group=group)
    else:
        buf.copy_(x)
    _log("recv", axis_name, x)
    return buf.to(x.device, non_blocking=True) if staged else buf


def p2p(x: torch.Tensor, src: int, dst: int, axis_name) -> torch.Tensor:
    """The JAX façade's ``p2p`` (a collective over the axis): the rank at
    index ``dst`` returns the value of the rank at ``src``, every other
    rank its own. A ``ppermute`` of one pair, so differentiable."""
    moved = ppermute(x, axis_name, [(src, dst)])
    return moved if axis_index(axis_name) == dst else x


def send_recv_next(x: torch.Tensor, axis_name, n: Optional[int] = None,
                   wrap: bool = True) -> torch.Tensor:
    """Shift +1 along the axis (index i -> i+1); without ``wrap`` index 0
    receives zeros (the pipeline's p2p contract)."""
    n = n or axis_size(axis_name)
    pairs = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
    return ppermute(x, axis_name, pairs)


def send_recv_prev(x: torch.Tensor, axis_name, n: Optional[int] = None,
                   wrap: bool = True) -> torch.Tensor:
    """Shift -1 along the axis; see :func:`send_recv_next`."""
    n = n or axis_size(axis_name)
    pairs = [(i, (i - 1) % n) for i in (range(n) if wrap else range(1, n))]
    return ppermute(x, axis_name, pairs)


def broadcast(x: torch.Tensor, axis_name, src: int = 0) -> torch.Tensor:
    """The value of the rank at index ``src`` along the axis, on every rank
    of it (what the other ranks held, NaN included, is overwritten)."""
    if _off("BROADCAST"):
        return x
    topo = topo_mod.get_world_topology()

    def fn(group, n, t):
        import torch.distributed as dist

        out = t.clone()
        if group is not None:
            dist.broadcast(out, src=topo.group_ranks(axis_name)[src],
                           group=group)
        return out

    return _run("broadcast", axis_name, x, fn)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def all_reduce_coalesced(tensors, axis_name, op: str = "sum"):
    """:func:`all_reduce` over a list / dict tree of tensors."""
    return _tree_map(lambda t: all_reduce(t, axis_name, op), tensors)


def all_gather_coalesced(tensors, axis_name):
    """:func:`all_gather` over a list / dict tree of tensors."""
    return _tree_map(lambda t: all_gather(t, axis_name), tensors)


# ---------------------------------------------------------------------------
# the reference's surface: root-based ops and aliases (JAX comm.py:369-532).
# The results are the JAX package's: there every rank runs the op, so a
# rank that is not the root gets a defined value (named by each op).
# ---------------------------------------------------------------------------
def reduce(x: torch.Tensor, axis_name, dst: int = 0) -> torch.Tensor:
    """Sum onto the rank at index ``dst`` (reference ``comm.reduce``):
    ``dst`` returns the sum over the axis, every other rank its input (a
    copy)."""
    if _off("ALL_REDUCE"):
        return x
    topo = topo_mod.get_world_topology()

    def fn(group, n, t):
        import torch.distributed as dist

        out = t.clone()
        if group is not None:
            dist.reduce(out, dst=topo.group_ranks(axis_name)[dst],
                        group=group)
        return out if topo.axis_index(axis_name) == dst else t.clone()

    return _run("reduce", axis_name, x, fn)


def gather(x: torch.Tensor, axis_name, dst: int = 0) -> torch.Tensor:
    """Every rank's ``x`` stacked ``[n, ...]`` by index (reference
    ``comm.gather``). As in the JAX package EVERY rank returns the stack,
    so ``dst`` reads it and the others may ignore it."""
    del dst   # every rank gets the result, as in the JAX package
    if _off("ALL_GATHER"):
        return x
    return _run("gather", axis_name, x, _gather_stacked)


def scatter(x: torch.Tensor, axis_name, src: int = 0) -> torch.Tensor:
    """The rank at index ``src`` hands out ``x[i]`` (``x`` is ``[n, ...]``
    on every rank) to the rank at index ``i`` (reference
    ``comm.scatter``); each rank returns its ``[...]`` piece."""
    if _off("BROADCAST"):
        return x
    topo = topo_mod.get_world_topology()

    def fn(group, n, t):
        import torch.distributed as dist

        if t.shape[0] != n:
            raise ValueError(f"scatter input leading dim {t.shape[0]} != "
                             f"axis size {n}")
        out = torch.empty(tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        if group is None:
            out.copy_(t[0])
            return out
        me = topo.axis_index(axis_name)
        pieces = [p.contiguous() for p in t.unbind(0)] if me == src \
            else None
        dist.scatter(out, pieces, src=topo.group_ranks(axis_name)[src],
                     group=group)
        return out

    return _run("scatter", axis_name, x, fn)


def all_gather_into_tensor(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Reference ``all_gather_into_tensor``: :func:`all_gather` along dim
    0."""
    return all_gather(x, axis_name)


def reduce_scatter_tensor(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Reference ``reduce_scatter_tensor``: :func:`reduce_scatter` along
    dim 0."""
    return reduce_scatter(x, axis_name)


def all_to_all_single(x: torch.Tensor, axis_name, split_axis: int = 0,
                      concat_axis: int = 0, **kw) -> torch.Tensor:
    """Reference ``all_to_all_single``: :func:`all_to_all`, dim 0 both
    ways by default."""
    return all_to_all(x, axis_name, split_axis=split_axis,
                      concat_axis=concat_axis, **kw)


def inference_all_reduce(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Reference ``inference_all_reduce``: :func:`all_reduce` (sum)."""
    return all_reduce(x, axis_name)


def monitored_barrier(timeout=None) -> None:
    """Reference ``monitored_barrier``: logged (a 4-byte entry under
    ``world``, as the JAX package logs it), then a barrier over the default
    group; on gloo ``torch.distributed.monitored_barrier``, which names the
    ranks that did not arrive within ``timeout`` (seconds)."""
    import datetime

    import torch.distributed as dist

    _log("monitored_barrier", "world", torch.zeros((), dtype=torch.float32))
    if not is_initialized():
        return
    if dist.get_backend() == "gloo":
        kw = {} if timeout is None else {
            "timeout": datetime.timedelta(seconds=float(timeout))}
        dist.monitored_barrier(**kw)
    else:
        dist.barrier()


def get_global_rank(group=None, group_rank: int = 0) -> int:
    """Reference ``get_global_rank``: the global rank of ``group_rank`` in
    ``group`` (a process group of :func:`new_group`; None is the world,
    where the two are equal)."""
    import torch.distributed as dist

    if group is None or (is_initialized() and group is dist.group.WORLD):
        return int(group_rank)
    _member(group)
    if isinstance(group, dist.ProcessGroup):
        return int(dist.get_global_rank(group, group_rank))
    raise TypeError(f"get_global_rank needs a new_group() handle or None, "
                    f"got {group!r}")


def _member(group) -> None:
    """A torch process group is known to its members alone: a rank outside
    it holds a sentinel from ``new_group``, not a handle."""
    import torch.distributed as dist

    if group is dist.GroupMember.NON_GROUP_MEMBER:
        raise ValueError("this rank is not a member of the group "
                         "(new_group gives the others no handle)")


def get_world_group():
    """Reference ``get_world_group``: the default process group (None
    without one: a world of one)."""
    import torch.distributed as dist

    return dist.group.WORLD if is_initialized() else None


def get_all_ranks_from_group(group=None) -> list:
    """Reference ``get_all_ranks_from_group``: the global ranks of ``group``
    (default the world) in group-rank order."""
    import torch.distributed as dist

    if group is None:
        group = get_world_group()
    if group is None:
        return [0]
    _member(group)
    return [int(r) for r in dist.get_process_group_ranks(group)]


# ---------------------------------------------------------------------------
# process bootstrap (JAX comm.py:226-304)
# ---------------------------------------------------------------------------
def _int_env(env, name: str) -> Optional[int]:
    v = env.get(name)
    return int(v) if v is not None else None


def discover(env=None, init_method: Optional[str] = None,
             world_size: Optional[int] = None, rank: Optional[int] = None,
             auto_mpi_discovery: bool = True) -> Dict[str, Any]:
    """What a launcher's environment says: ``init_method`` (``tcp://host:
    port``), ``world_size``, ``rank`` and ``local_rank``, from explicit
    arguments first, then the torch launcher's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``LOCAL_RANK``, then (with
    ``auto_mpi_discovery``) OpenMPI's ``OMPI_COMM_WORLD_*``, PMI's and an
    ``srun`` step's SLURM variables, as the JAX package reads them. An MPI /
    PMI launch without an address raises."""
    env = os.environ if env is None else env
    nprocs = world_size if world_size is not None \
        else _int_env(env, "WORLD_SIZE")
    pid = rank if rank is not None else _int_env(env, "RANK")
    local = _int_env(env, "LOCAL_RANK")
    addr = init_method
    if addr is None and "MASTER_ADDR" in env:
        addr = f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '1234')}"
    if auto_mpi_discovery and "OMPI_COMM_WORLD_SIZE" in env:
        nprocs = nprocs if nprocs is not None \
            else int(env["OMPI_COMM_WORLD_SIZE"])
        pid = pid if pid is not None else int(env["OMPI_COMM_WORLD_RANK"])
        local = local if local is not None \
            else _int_env(env, "OMPI_COMM_WORLD_LOCAL_RANK")
        if addr is None and nprocs > 1:
            raise RuntimeError(
                "MPI launch detected but no rendezvous address; set "
                "MASTER_ADDR/MASTER_PORT to a host:port on rank 0")
    if auto_mpi_discovery and nprocs is None and "PMI_SIZE" in env:
        nprocs = int(env["PMI_SIZE"])
        pid = pid if pid is not None else int(env.get("PMI_RANK", 0))
        if addr is None and nprocs > 1:
            raise RuntimeError(
                "PMI launch detected but no rendezvous address; set "
                "MASTER_ADDR/MASTER_PORT to a host:port on rank 0")
    if auto_mpi_discovery and nprocs is None and "SLURM_NTASKS" in env \
            and "SLURM_STEP_ID" in env:
        nprocs = int(env["SLURM_NTASKS"])
        pid = pid if pid is not None else int(env.get("SLURM_PROCID", 0))
        local = local if local is not None \
            else _int_env(env, "SLURM_LOCALID")
        if addr is None and nprocs > 1:
            nodelist = env.get("SLURM_JOB_NODELIST") or \
                env.get("SLURM_NODELIST")
            if nodelist and "[" not in nodelist:
                addr = f"tcp://{nodelist.split(',')[0]}:{_DEFAULT_SLURM_PORT}"
            else:
                raise RuntimeError(
                    "SLURM launch detected but no rendezvous address and "
                    "the nodelist is compressed; set MASTER_ADDR/MASTER_PORT")
    return {"init_method": addr, "world_size": nprocs,
            "rank": pid if pid is not None else 0,
            "local_rank": local if local is not None else 0}


def choose_backend(device_type: str, world_size: int,
                   device_count: int) -> Tuple[str, str]:
    """(backend, why): NCCL when the ranks run on CUDA and each has a card
    of its own; gloo for CPU tensors, and for ranks that share a card (NCCL
    refuses two ranks on one device)."""
    if device_type != "cuda":
        return "gloo", "CPU tensors"
    if world_size <= device_count:
        return "nccl", f"{world_size} rank(s) on {device_count} card(s)"
    return "gloo", (f"{world_size} ranks share {device_count} card(s); NCCL "
                    f"takes one rank a card")


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device_type: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     timeout_s: Optional[float] = None) -> bool:
    """Start the default process group (reference ``init_distributed``).

    The address, world size and ranks come from the arguments, else the
    launcher's environment (:func:`discover`). With none (a plain single
    process) nothing is started and False is returned, as the JAX package
    does on one host; so does an already started group. ``backend`` is
    used as given; None applies :func:`choose_backend` to ``device_type``
    (default: ``"cuda"`` when a card is visible), the world size and the
    visible cards. The choice is logged. On CUDA each rank takes card
    ``local_rank % device_count``."""
    import datetime

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return False
    info = discover(init_method=init_method, world_size=world_size,
                    rank=rank, auto_mpi_discovery=auto_mpi_discovery)
    if info["init_method"] is None or not info["world_size"]:
        return False
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    why = "given"
    if backend is None:
        backend, why = choose_backend(device_type, info["world_size"],
                                      n_cards)
    if device_type == "cuda":
        torch.cuda.set_device(info["local_rank"] % max(n_cards, 1))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=info["init_method"],
                            world_size=info["world_size"], rank=info["rank"],
                            **kw)
    logger.info("init_distributed: rank %d of %d, backend %s (%s), %s",
                info["rank"], info["world_size"], backend, why,
                info["init_method"])
    return True


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    """Ranks of the default group (1 without one): one process a rank."""
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    """Rank within this host: the launcher's ``LOCAL_RANK`` (0 without)."""
    v = os.environ.get("LOCAL_RANK")
    return int(v) if v is not None else 0


def get_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def barrier() -> None:
    import torch.distributed as dist

    if is_initialized():
        dist.barrier()


def new_group(ranks: Sequence[int]):
    """A process group over ``ranks`` (a collective of the default group)."""
    import torch.distributed as dist

    return dist.new_group(list(ranks))


def destroy_process_group(group=None) -> None:
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group(group)
    if group is None:
        topo_mod.reset_world_topology()
