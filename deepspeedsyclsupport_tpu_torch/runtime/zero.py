"""ZeRO as placement policy, and ZeRO-3's gather-on-use.

Port of ``deepspeedsyclsupport_tpu/runtime/zero.py``. The rules are the JAX
package's, entry for entry (``choose_shard_dim``:51, ``param_sharding``
:66-122, ``tree_optimizer_shardings``:132, ``predict_memory_per_device``
:193, ``describe_memory_plan``:233); they return the plain specs of
``comm/topology.py`` (per dim, a tuple of axis names) where the JAX package
returns ``NamedSharding``\\ s:

=======  ==========================  ====================================
stage    sharded state               here
0        nothing                     params / moments replicated over fsdp
1        optimizer state             moments (and the update) on an fsdp
                                     shard, params replicated
2        + gradients                 grads reduce-scattered onto that shard
3        + parameters                params held as fsdp shards, gathered
                                     on use (:class:`ZeroShard`)
=======  ==========================  ====================================

The JAX package stacks a model's layers ``[L, ...]`` and plans on the
stacked leaves; the port keeps ``params["layers"]`` as a list. So the plan
is made on the stacked shape (the persistence threshold and the largest-dim
choice see ``[L, ...]``, as in the JAX package) and the layer dim is then
dropped. Under a pipelined trunk the JAX plan shards the layer dim over
``pipe`` (each stage owns a contiguous block of layers, JAX
``models/transformer.py:501-513``): here a rank keeps the block
:func:`layer_block` names as its list of layers, and the rest of each spec
is planned as without a pipeline. A plan that would shard the layer dim
over any other axis raises.

Under XLA the partitioner inserts ZeRO-3's gathers; here the model asks for
them: :func:`gather_params` all-gathers each :class:`ZeroShard` of a
layer's params just before the layer runs (``all_gather_into_tensor``
along the shard dim; its backward is ``reduce_scatter_tensor``, which is
ZeRO's gradient reduction over fsdp). The full copies live for the layer
only: under activation checkpointing the recompute gathers again; without
it, the tensors the backward keeps are saved as their shard and gathered
again when the backward reads them (:func:`run_gathered`).
"""
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..comm import comm
from ..comm.topology import MeshTopology, Spec, as_spec

# Params smaller than this stay replicated at stage 3, the reference's
# ``stage3_param_persistence_threshold``.
DEFAULT_PERSISTENCE_THRESHOLD = 10_000


def choose_shard_dim(shape: Sequence[int], n_shards: int,
                     threshold: int = DEFAULT_PERSISTENCE_THRESHOLD
                     ) -> Optional[int]:
    """The dim to shard over fsdp: the largest dim divisible by
    ``n_shards``; None if the tensor is under ``threshold`` elements or no
    dim divides."""
    if n_shards <= 1:
        return None
    size = math.prod(shape) if shape else 0
    if size < threshold:
        return None
    candidates = [i for i, d in enumerate(shape) if d % n_shards == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda i: shape[i])


def _strip(entry: Tuple[str, ...], ax: str) -> Tuple[str, ...]:
    return tuple(a for a in entry if a != ax)


def param_sharding(topo: MeshTopology, stage: int,
                   threshold: int = DEFAULT_PERSISTENCE_THRESHOLD,
                   extra_rules: Optional[Callable] = None
                   ) -> Callable[[Any, Sequence[int]], Spec]:
    """A ``(path, shape) -> spec`` rule for params (JAX
    ``param_sharding``). ``extra_rules(path, shape)`` may return a
    ``PartitionSpec``-like tuple: TP specs win on their dims; entries naming
    ``fsdp`` pin which dim shards at stage 3 and are stripped below it. Each
    dim must divide by the product of its axes' sizes; fsdp is shed first,
    then the TP axes, until it does. At stage 3 a leaf of ``threshold``
    elements or more with no fsdp dim yet shards its largest free divisible
    dim over fsdp."""
    n = topo.axis_sizes["fsdp"]

    def rule(path, shape) -> Spec:
        shape = tuple(int(d) for d in shape)
        ruled = extra_rules(path, shape) if extra_rules else None
        spec: List[Tuple[str, ...]] = list(as_spec(*ruled)) \
            if ruled is not None else []
        spec += [()] * (len(shape) - len(spec))
        if stage < 3:
            spec = [_strip(s, "fsdp") for s in spec]
        for i, s in enumerate(list(spec)):
            def divides(entry):
                prod = math.prod(topo.axis_sizes.get(a, 1) for a in entry)
                return i < len(shape) and shape[i] % max(prod, 1) == 0

            for ax in ("fsdp",) + s:
                if divides(spec[i]):
                    break
                spec[i] = _strip(spec[i], ax)
        if stage >= 3 and n > 1:
            used = {a for s in spec for a in s}
            if "fsdp" not in used and math.prod(shape or (0,)) >= threshold:
                # the largest free divisible dim (1 marks a taken dim:
                # indivisible by n > 1 and never the largest)
                free = tuple(d if not s else 1 for d, s in zip(shape, spec))
                i = choose_shard_dim(free, n, threshold=0)
                if i is not None:
                    spec[i] = ("fsdp",)
        return tuple(spec)

    return rule


def moment_spec(shape: Sequence[int], param_spec: Optional[Spec],
                topo: MeshTopology, stage: int,
                threshold: int = DEFAULT_PERSISTENCE_THRESHOLD) -> Spec:
    """The spec of an optimizer moment of ``shape`` beside its param's
    (JAX ``tree_optimizer_shardings``' rule): at stage 3 the param's; at
    stages 1-2 the param's TP axes plus fsdp on the largest free divisible
    dim, the size gate on the full tensor; else replicated."""
    shape = tuple(int(d) for d in shape)
    if not shape:
        return ()
    if stage >= 3 and param_spec is not None:
        return tuple(param_spec)
    if stage >= 1:
        base = list(param_spec) if param_spec is not None else []
        base += [()] * (len(shape) - len(base))
        if math.prod(shape) >= threshold:
            free = tuple(d if not s else 1 for d, s in zip(shape, base))
            dim = choose_shard_dim(free, topo.axis_sizes["fsdp"], threshold=0)
            if dim is not None:
                base[dim] = ("fsdp",)
        if any(base):
            return tuple(base)
    return ()


# ------------------------------------------------------------ the port's tree
def _walk(tree, path=()):
    """(path, leaf) pairs; a ``layers`` list yields its entries' leaves
    with the layer index in the path (``("layers", 3, "attn", "wq")``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def layer_block(n_layers: int, topo: MeshTopology,
                rank: Optional[int] = None) -> Tuple[int, int]:
    """``(lo, hi)``: the layers ``rank``'s pipe stage owns, the contiguous
    block ``[s L / pp, (s + 1) L / pp)`` (the whole stack without a
    pipeline)."""
    pp = topo.axis_sizes["pipe"]
    if n_layers % pp:
        raise ValueError(
            f"num_layers {n_layers} must divide evenly into {pp} pipe "
            f"stages for the SPMD pipeline (pad with identity layers to "
            f"round up, as the reference's uniform partitioner does "
            f"implicitly)")
    n = n_layers // pp
    s = topo.axis_index("pipe", rank)
    return s * n, (s + 1) * n


def stage_tree(params, topo: MeshTopology, rank: Optional[int] = None):
    """``params`` with its ``layers`` list cut to ``rank``'s pipe stage's
    block (:func:`layer_block`); the other entries, replicated over
    ``pipe``, as they are."""
    layers = params.get("layers") if isinstance(params, dict) else None
    if topo.axis_sizes["pipe"] == 1 or not isinstance(layers, list):
        return params
    lo, hi = layer_block(len(layers), topo, rank)
    return dict(params, layers=layers[lo:hi])


def _layer_entry(spec, jpath) -> Tuple[str, ...]:
    """The stacked layer dim's entry of a plan: ``()`` or ``("pipe",)``."""
    entry = tuple(spec[0]) if spec else ()
    if entry not in ((), ("pipe",)):
        raise ValueError(
            f"the plan shards the stacked layer dim of "
            f"{'/'.join(map(str, jpath))} over {entry}; the port keeps its "
            f"layers as a list and holds that dim split over pipe alone")
    return entry


def tree_param_shardings(params, topo: MeshTopology, stage: int,
                         threshold: int = DEFAULT_PERSISTENCE_THRESHOLD,
                         extra_rules: Optional[Callable] = None,
                         stacked: bool = True,
                         n_layers: Optional[int] = None
                         ) -> Dict[Tuple, Spec]:
    """``{path: spec}`` for every leaf of the port's params tree (paths as
    :func:`_walk` yields them; the JAX function maps the tree to
    ``NamedSharding`` objects). With ``stacked`` (a JAX model that scans its
    layers) a layer leaf is planned on ``[L, *shape]`` under the JAX path
    ``layers/...`` and its layer dim dropped (under a pipeline it is split
    over ``pipe``: ``params`` may then hold one stage's block, and
    ``n_layers`` names the whole stack's L)."""
    rule = param_sharding(topo, stage, threshold, extra_rules)
    layers = params.get("layers") if isinstance(params, dict) else None
    if n_layers is None:
        n_layers = len(layers) if isinstance(layers, list) else 0
    out: Dict[Tuple, Spec] = {}
    for path, leaf in _walk(params):
        shape = _shape(leaf)
        if stacked and n_layers and path[0] == "layers":
            jpath = ("layers",) + path[2:]
            spec = rule(jpath, (n_layers,) + shape)
            _layer_entry(spec, jpath)
            out[path] = tuple(spec[1:])
        else:
            jpath = path if path[:1] != ("layers",) else \
                ("layers", f"[{path[1]}]") + path[2:]
            out[path] = rule(jpath, shape)
    return out


def tree_optimizer_shardings(params, param_specs: Dict[Tuple, Spec],
                             topo: MeshTopology, stage: int,
                             threshold: int = DEFAULT_PERSISTENCE_THRESHOLD,
                             stacked: bool = True,
                             n_layers: Optional[int] = None
                             ) -> Dict[Tuple, Spec]:
    """``{path: spec}`` of each param leaf's Adam moments
    (:func:`moment_spec`; the JAX function walks optax's state, whose
    ``mu`` / ``nu`` leaves follow their params), planned on the stacked
    shape as :func:`tree_param_shardings` does (under a pipeline the layer
    dim is the param's, split over ``pipe``, and is dropped)."""
    layers = params.get("layers") if isinstance(params, dict) else None
    if n_layers is None:
        n_layers = len(layers) if isinstance(layers, list) else 0
    pipe = ("pipe",) if topo.axis_sizes["pipe"] > 1 else ()
    out: Dict[Tuple, Spec] = {}
    for path, leaf in _walk(params):
        shape = _shape(leaf)
        if stacked and n_layers and path[0] == "layers":
            spec = moment_spec((n_layers,) + shape,
                               (pipe,) + tuple(param_specs[path]), topo,
                               stage, threshold)
            _layer_entry(spec, path)
            out[path] = tuple(spec[1:])
        else:
            out[path] = moment_spec(shape, param_specs[path], topo, stage,
                                    threshold)
    return out


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def is_expert_leaf(path) -> bool:
    """A leaf split over ``expert`` on its leading dim: an MoE layer's
    ``moe/w_gate``, ``moe/w_up`` or ``moe/w_down``."""
    names = [str(k) for k in path if not isinstance(k, int)]
    return len(names) >= 2 and names[-2] == "moe" and \
        names[-1] in EXPERT_LEAVES


def expert_param_count(params) -> int:
    """The elements of ``params``' expert leaves (:func:`is_expert_leaf`)."""
    return sum(math.prod(_shape(p)) for path, p in _walk(params)
               if is_expert_leaf(path))


def predict_memory_per_device(n_params: int, fsdp: int, stage: int, *,
                              offload: bool = False,
                              compute_bytes: int = 4,
                              activation_bytes: float = 0.0,
                              remat: bool = False,
                              num_layers: int = 1,
                              expert_params: int = 0,
                              ep: int = 1) -> float:
    """Predicted peak device bytes for one training step (the JAX
    package's model, term for term): fp32 master, fp32 grads and Adam's two
    moments, each divided by fsdp from its stage on, the compute-dtype copy
    when it is not fp32, and the activations (one layer's worth plus the
    residual checkpoints under ``remat``). Of the ``n_params``,
    ``expert_params`` are experts split over ``ep`` ranks (a rank holds
    ``E / ep`` of them); with the defaults it is the JAX function."""
    if ep > 1 and expert_params:
        n_params = n_params - expert_params + expert_params / ep
    n = max(fsdp, 1)
    param_factor = n if stage >= 3 and n > 1 else 1
    grad_factor = n if stage >= 2 and n > 1 else 1
    opt_factor = n if stage >= 1 and n > 1 else 1
    if offload:
        mem = n_params * compute_bytes / param_factor
        mem += n_params * 4 / grad_factor
    else:
        mem = n_params * 4 / param_factor
        mem += n_params * 4 / grad_factor
        mem += n_params * 8 / opt_factor
        if compute_bytes != 4:
            mem += n_params * compute_bytes / param_factor
    if remat:
        layers = max(num_layers, 1)
        mem += min(activation_bytes, activation_bytes / layers * 2)
    else:
        mem += activation_bytes
    return mem


def describe_memory_plan(params, topo: MeshTopology, stage: int) -> str:
    """The partition report (reference ``see_memory_usage`` + stage-3
    partition logging; offload is A.3.2). Under a pipeline the count is
    this rank's stage's (its block of layers and the replicated rest: what
    :func:`predict_memory_per_device` is to be given) and the report says
    which block; under expert parallelism it counts this rank's
    ``E / ep`` experts."""
    pp, ep = topo.axis_sizes["pipe"], topo.axis_sizes["expert"]
    layers = params.get("layers") if isinstance(params, dict) else None
    mine = stage_tree(params, topo)
    n_params = sum(math.prod(_shape(p)) for _, p in _walk(mine))
    experts = expert_param_count(mine)
    if ep > 1 and experts:
        n_params -= experts - experts // ep
    n = topo.axis_sizes["fsdp"]
    param_factor = n if stage >= 3 and n > 1 else 1
    grad_factor = n if stage >= 2 and n > 1 else 1
    opt_factor = n if stage >= 1 and n > 1 else 1
    msg = (f"ZeRO stage {stage}: {n_params / 1e6:.1f}M params, fsdp={n}; "
           f"param mem 1/{param_factor}, grad mem 1/{grad_factor}, "
           f"optimizer mem 1/{opt_factor} per device")
    if ep > 1 and experts:
        msg += (f"; expert={ep}: a rank holds 1/{ep} of the experts' "
                f"{experts / 1e6:.1f}M")
    if pp > 1 and isinstance(layers, list):
        lo, hi = layer_block(len(layers), topo)
        msg += (f"; pipe stage {topo.axis_index('pipe')} of {pp} holds "
                f"layers {lo}-{hi - 1} of {len(layers)}")
    return msg


# ------------------------------------------------------------ gather on use
class ZeroShard:
    """A leaf of the loss's params held as this rank's shard along ``dim``
    over mesh axis ``axis``; :func:`gather_params` makes it whole."""
    __slots__ = ("data", "dim", "axis")

    def __init__(self, data: torch.Tensor, dim: int, axis: str = "fsdp"):
        self.data, self.dim, self.axis = data, dim, axis

    @property
    def shape(self):
        return self.data.shape


class _GatherOnUse(torch.autograd.Function):
    """all_gather along the shard dim; backward: reduce_scatter of the full
    gradient, which sums it over the axis and keeps this rank's piece."""

    @staticmethod
    def forward(ctx, shard, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return comm.all_gather(shard, axis, axis=dim)

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter(grad.contiguous(), ctx.axis,
                                   axis=ctx.dim), None, None


def has_shards(tree) -> bool:
    return any(isinstance(x, ZeroShard) for _, x in _walk(tree))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def gather_params(tree, keep: Optional[Dict[int, ZeroShard]] = None):
    """``tree`` with every :class:`ZeroShard` all-gathered (autograd-aware).
    ``keep`` collects ``id(full) -> shard`` for :func:`run_gathered`."""
    def one(x):
        if not isinstance(x, ZeroShard):
            return x
        full = _GatherOnUse.apply(x.data, x.dim, x.axis)
        if keep is not None:
            keep[id(full)] = x
        return full

    return _map(one, tree)


class _Regather:
    __slots__ = ("shard",)

    def __init__(self, shard: ZeroShard):
        self.shard = shard


def run_gathered(tree, fn: Callable, *args, regather: bool = True):
    """``fn(gathered tree, *args)``: the shards of ``tree`` gathered just
    before and dropped just after. With ``regather`` (no activation
    checkpointing around the call) a full copy that the backward keeps is
    saved as its shard and gathered again when the backward reads it, so
    no layer's full params outlive its forward."""
    if not has_shards(tree):
        return fn(tree, *args)
    if not (regather and torch.is_grad_enabled()):
        return fn(gather_params(tree), *args)
    keep: Dict[int, ZeroShard] = {}
    full = gather_params(tree, keep)

    def pack(t):
        s = keep.get(id(t))
        return _Regather(s) if s is not None else t

    def unpack(x):
        if isinstance(x, _Regather):
            s = x.shard
            with torch.no_grad():
                return comm.all_gather(s.data.detach(), s.axis, axis=s.dim)
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        return fn(full, *args)

