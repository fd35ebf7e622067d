"""ZeRO++: quantized and hierarchical ZeRO-3 communication.

Port of ``deepspeedsyclsupport_tpu/runtime/zeropp.py``. The reference turns
ZeRO++ on with engine flags (``zero_quantized_weights``,
``zero_quantized_gradients``, ``zero_hpz_partition_size``) that reroute
ZeRO-3's parameter gather and gradient reduce-scatter through int8
collectives and add a secondary parameter partition within a node (hpZ).
When they are set the engine's ``train_batch`` runs :class:`ZeroPPStep`,
the JAX package's explicit step (``build_zeropp_train_fn``), over the
(data, fsdp) mesh:

* **param gather**, once a step: each fsdp-sharded leaf of the JAX tree
  (a stacked ``[L, ...]`` layer leaf assembled from the port's per-layer
  shards) is gathered WHOLE from the float32 masters, its fsdp dim moved
  first; qwZ ships int8 blocks of 256 elements of that flattened tensor,
  across layers, with a float32 scale each
  (``comm/quantized.quantized_all_gather``). The leaves are cast to the
  compute dtype inside the loss, after the gather.
* **hpZ** (:func:`hierarchical_all_gather`): a plain gather over the outer
  groups (stride ``h``) builds the secondary partition, then a gather
  within each group of ``h`` consecutive ranks (quantized under qwZ) and a
  de-interleave give the full leaf (``MeshTopology.hierarchical_groups``,
  built up front by ``init_groups``). ``h <= 1`` or ``h >= fsdp`` is the
  flat gather.
* **loss**: each rank's LOCAL masked mean (the JAX body runs the engine's
  loss inside ``shard_map``), so the gradient is the mean of the ranks'
  local means and the reported loss their mean: equal to the global
  masked mean only when every rank counts the same tokens.
* **grad reduce**, every micro-batch: the full float32 gradient of each
  sharded leaf, fsdp dim first, is reduced to this rank's shard as the
  MEAN over fsdp (qgZ: ``all_to_all_quant_reduce``; else a reduce-scatter
  over ``n``); a replicated leaf's is averaged over fsdp. The shards are
  summed over micro-batches, divided by ``gas``, then averaged over
  ``data``.
* **update**: over the held shards (moments sharded alike): the grad norm
  ``sqrt(psum(Σ shard²) + Σ replicated²)``, clipping by ``min(1, clip /
  max(norm, 1e-6))`` with no ``clip_by_global_norm`` in the optimizer's
  state (the JAX chain drops it), the fp16 overflow verdict agreed over
  the ranks.
* **tensor parallelism**: a port rank holds its TP shard of each leaf and
  quantizes that, in blocks of its own (DeepSpeed's behaviour, no extra
  bytes); the JAX body quantizes the global TP view, so the two differ
  wherever a TP-split dim over ``tp`` is not a multiple of 256.

Scope (the engine raises JAX's ``ValueError`` outside it): ZeRO stage 3,
``fsdp > 1``, no ``pipe`` / ``seq`` / ``expert``, ``h`` divides ``fsdp``.
Each gather and reduce is recorded in the comms logger under the JAX
package's names (``zeropp_gather[_int8]``, ``zeropp_reduce[_int8]``) with
its wire bytes: ``size + ceil(size / 256) * 4`` a rank for int8, else
``size * itemsize`` (a gather counts its ``fsdp`` ranks' payloads).
"""
from typing import Dict, List, Optional, Tuple

import torch

from ..comm import comm
from ..comm.comms_logging import comms_logger
from ..comm.quantized import all_to_all_quant_reduce, quantized_all_gather
from .loss_scaler import scale_loss

AXIS = "fsdp"
GROUP_SIZE = 256


def wire_bytes(size: int, itemsize: int, quantized: bool,
               group_size: int = GROUP_SIZE) -> int:
    """A rank's payload of ``size`` elements: int8 codes plus one float32
    scale a block, or the elements as they are (JAX ``_wire_bytes``)."""
    if quantized:
        return size + (-(-size // group_size)) * 4
    return size * itemsize


def _gather_plain(group, n: int, x: torch.Tensor) -> torch.Tensor:
    return comm._gather_stacked(group, n, x).reshape(
        (n * x.shape[0],) + tuple(x.shape[1:]))


def check_scope(zero_stage: int, axis_sizes: Dict[str, int],
                h: int) -> None:
    """JAX ``engine.py:184-201``'s refusals, with its messages."""
    n = axis_sizes["fsdp"]
    bad = [a for a in ("pipe", "seq", "expert") if axis_sizes.get(a, 1) > 1]
    if zero_stage != 3 or n <= 1 or bad:
        raise ValueError(
            f"ZeRO++ flags need stage 3 on a data/fsdp[/model] mesh "
            f"with fsdp>1 (stage={zero_stage}, fsdp={n}, "
            f"unsupported axes in use: {bad})")
    if h > 1 and n % h:
        raise ValueError(
            f"zero_hpz_partition_size {h} must divide fsdp {n}")


def hierarchical_all_gather(x: torch.Tensor, n: int, h: int,
                            quantized: bool,
                            group_size: int = GROUP_SIZE) -> torch.Tensor:
    """The two-hop hpZ gather of this rank's dim-0 shard ``x`` ``[F/n,
    ...]`` over ``fsdp`` -> ``[F, ...]`` (JAX ``hierarchical_all_gather``).
    Hop 1, over the outer groups (the ranks at one place of every group of
    ``h`` consecutive ones): the secondary shard ``[F/h, ...]``, slices
    ``o h + i`` interleaved. Hop 2, within the group (int8 under qwZ): the
    secondaries, de-interleaved into the full leaf."""
    if h <= 1 or h >= n:
        if quantized:
            return quantized_all_gather(x, AXIS, group_size=group_size)
        group, n, _ = comm._resolve(AXIS)
        return _gather_plain(group, n, x)
    from ..comm.topology import get_world_topology

    intra, inter = get_world_topology().hierarchical_groups(AXIS, h)
    sec = _gather_plain(inter, n // h, x)
    if quantized:
        gathered = quantized_all_gather(sec, AXIS, group_size=group_size,
                                        group=intra)
        gathered = gathered.reshape((h,) + tuple(sec.shape))
    else:
        gathered = comm._gather_stacked(intra, h, sec)
    # gathered[i] = concat_o slice[o h + i]; reorder to slice j at row j
    shard = x.shape[0]
    full = gathered.reshape((h, n // h, shard) + tuple(x.shape[1:]))
    return full.transpose(0, 1).reshape((n * shard,) + tuple(x.shape[1:]))


def gather_leaf(moved: torch.Tensor, n: int, h: int,
                quantized: bool) -> torch.Tensor:
    """One leaf's gather (fsdp dim first) with its wire bytes recorded
    under the JAX package's name (``gather_leaf``)."""
    comms_logger.append("zeropp_gather" + ("_int8" if quantized else ""),
                        AXIS, wire_bytes(moved.numel(), moved.element_size(),
                                         quantized) * n, tuple(moved.shape))
    return hierarchical_all_gather(moved, n, h, quantized)


def reduce_leaf(g: torch.Tensor, quantized: bool) -> torch.Tensor:
    """One leaf's full gradient (fsdp dim first) -> this rank's shard, the
    mean over fsdp, its wire bytes recorded under the JAX package's name
    (``reduce_leaf``)."""
    comms_logger.append("zeropp_reduce" + ("_int8" if quantized else ""),
                        AXIS, wire_bytes(g.numel(), g.element_size(),
                                         quantized), tuple(g.shape))
    if quantized:
        return all_to_all_quant_reduce(g, AXIS, group_size=GROUP_SIZE)
    group, n, _ = comm._resolve(AXIS)
    return _reduce_scatter(group, n, g) / n


class _Leaf:
    """One leaf of the JAX params tree as the port holds it: the indices
    of its float tensors (one a layer of a stacked leaf), the dim of the
    JAX leaf split over fsdp (None: replicated over fsdp) and whether it
    is stacked."""

    def __init__(self, idxs: List[int], k: Optional[int], stacked: bool):
        self.idxs, self.k, self.stacked = idxs, k, stacked


class ZeroPPStep:
    """The ZeRO++ step of an engine (module docstring): :meth:`grads`
    gathers, runs each micro-batch's local loss backward on the gathered
    leaves and reduces the grads to this rank's shards."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.config.zeropp
        sizes = engine.topology.axis_sizes
        self.n = sizes[AXIS]
        self.h = cfg.zero_hpz_partition_size
        self.qw = cfg.zero_quantized_weights
        self.qg = cfg.zero_quantized_gradients
        self.data = sizes["data"]
        leaves: Dict[Tuple, _Leaf] = {}
        for i, path in enumerate(engine._float_paths):
            stacked = engine._stack_layers and path[0] == "layers"
            key = ("layers",) + tuple(path[2:]) if stacked else path
            d = engine._shard_dim(engine._specs[path])
            k = None if d is None else d + int(stacked)
            leaves.setdefault(key, _Leaf([], k, stacked)).idxs.append(i)
        self.leaves = list(leaves.values())

    # ------------------------------------------------------------ gather
    def _local(self, leaf: _Leaf) -> torch.Tensor:
        """This rank's piece of the JAX leaf: the layers' tensors stacked
        ``[L, ...]`` when the leaf is."""
        ts = [self.engine._leaf_tensors[i].detach() for i in leaf.idxs]
        return torch.stack(ts) if leaf.stacked else ts[0]

    def gather(self) -> List[torch.Tensor]:
        """Each leaf as a float32 tensor that autograd differentiates: the
        full leaf with its fsdp dim first (a sharded leaf), or this rank's
        tensor of a replicated one."""
        out = []
        for leaf in self.leaves:
            if leaf.k is None:
                out.append(self._local(leaf).requires_grad_(True))
                continue
            moved = self._local(leaf).movedim(leaf.k, 0).contiguous()
            out.append(gather_leaf(moved, self.n, self.h,
                                   self.qw).requires_grad_(True))
        return out

    def params_tree(self, full: List[torch.Tensor]):
        """The engine's params tree over views of the gathered leaves."""
        eng = self.engine
        views: List[Optional[torch.Tensor]] = [None] * len(
            eng._leaf_tensors)
        for leaf, f in zip(self.leaves, full):
            t = f if leaf.k is None else f.movedim(0, leaf.k)
            for j, i in enumerate(leaf.idxs):
                views[i] = t[j] if leaf.stacked else t
        by_path = dict(zip(eng._float_paths, views))
        from . import zero as zero_lib
        from .engine import _rebuild

        leaves = {p: by_path.get(p, t)
                  for p, t in zero_lib._walk(eng.params)}
        return _rebuild(eng.params, leaves)

    # ------------------------------------------------------------ reduce
    def reduce(self, full: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each gathered leaf's gradient -> this rank's shard of it, the
        mean over fsdp (a replicated leaf: its mean, one all-reduce for
        all of them), in the leaf's layout."""
        out: List[Optional[torch.Tensor]] = [None] * len(full)
        repl = []
        for j, (leaf, f) in enumerate(zip(self.leaves, full)):
            g = f.grad if f.grad is not None else torch.zeros_like(f)
            f.grad = None
            if leaf.k is None:
                repl.append((j, g))
            else:
                out[j] = reduce_leaf(g, self.qg)
        if repl:
            flat = torch.cat([g.reshape(-1) for _, g in repl])
            flat = comm.pmean(flat, AXIS)
            for (j, g), piece in zip(repl, flat.split(
                    [g.numel() for _, g in repl])):
                out[j] = piece.view_as(g)
        return out

    def to_tensors(self, shards: List[torch.Tensor]) -> List[torch.Tensor]:
        """Leaf shards (fsdp dim first) -> one grad a float tensor, in the
        held tensors' shapes."""
        grads: List[Optional[torch.Tensor]] = [None] * len(
            self.engine._leaf_tensors)
        for leaf, s in zip(self.leaves, shards):
            t = s if leaf.k is None else s.movedim(0, leaf.k)
            for j, i in enumerate(leaf.idxs):
                grads[i] = (t[j] if leaf.stacked else t).contiguous()
        return grads

    # ------------------------------------------------------------- step
    def grads(self, micro_batches) -> Tuple[List[torch.Tensor], List,
                                            List[Dict]]:
        """One step's gradient shards (still loss-scaled; averaged over
        micro-batches and ``data``), each micro-batch's local loss and
        metrics."""
        eng = self.engine
        full = self.gather()
        acc: Optional[List[torch.Tensor]] = None
        losses, metrics = [], []
        for i, mb in enumerate(micro_batches):
            tree = self.params_tree(full)
            with eng._local_loss():
                loss, m = eng._loss_and_metrics(
                    tree, mb, rng=eng._generator(eng.global_steps, i),
                    gathered=True)
            scale_loss(loss, eng.scaler_state).backward()
            del tree
            shards = self.reduce(full)
            acc = shards if acc is None else [a + s for a, s in
                                              zip(acc, shards)]
            losses.append(loss.detach())
            metrics.append({k: v.detach() for k, v in m.items()})
        del full
        if len(micro_batches) > 1:
            acc = [a / len(micro_batches) for a in acc]
        if self.data > 1:
            flat = comm.pmean(torch.cat([a.reshape(-1) for a in acc]),
                              "data")
            acc = [p.view_as(a) for a, p in zip(
                acc, flat.split([a.numel() for a in acc]))]
        return self.to_tensors(acc), losses, metrics


def _reduce_scatter(group, n: int, g: torch.Tensor) -> torch.Tensor:
    """The sum over the group, piece ``i`` along dim 0 to its rank ``i``."""
    if group is None:
        return g.clone()
    import torch.distributed as dist

    out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]),
                      dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, g.contiguous(), group=group)
    return out
