"""Training engine, on one card or over ``torch.distributed``.

Port of ``deepspeedsyclsupport_tpu/runtime/engine.py`` (``initialize``:64,
``Engine.train_batch``:989, the eager ``forward/backward/step``:1482-1592).
The JAX package compiles the whole step — forward, backward,
accumulation, clipping, update, loss-scale bookkeeping — into one jitted
program; here the same step runs eagerly:

* the params are float32 master tensors on the card; inside the loss they
  are cast to the compute dtype (``bf16``/``fp16`` config, else float32),
  so autograd returns float32 grads (``_cast_params``, :793-840);
* ``train_batch`` reshapes the global batch to ``(gas, micro, ...)``, runs
  each micro-batch's scaled loss backward (grads accumulate in ``.grad``),
  divides by ``gas``, then unscales, checks ``finite`` (fp16 only, as in
  the reference), takes the pre-clip global ``grad_norm``, clips (optax's
  ``clip_by_global_norm``) and applies the optimizer only when ``finite``
  (:862-917). Losses and metrics are averaged over micro-batches.

With fp16 the overflow gate reads ``finite`` on the host (one device sync
per step); so does the training sentinel's gate while it is armed
(``runtime/sentinel.py``: the step count and learning rate live on the
host, so a gated step is skipped there). Otherwise nothing in the step
waits for the card. ZeRO stages 0-3 are one program on one card.

Under a process group (``comm.init_distributed``) the engine builds the
named mesh from the config (``initialize(topology=...)`` or the
``parallelism`` sizes, JAX ``engine.py:130-134``) and keeps the JAX
package's step semantics (``engine.py:12-20``: one global step over a batch
split on (data, fsdp)):

* each rank holds its shards of the JAX layout (``runtime/zero.py``: TP
  dims always, fsdp at stage 3) and trains on its rows of the global batch;
  the model (a private view with a ``ParallelPlan``) runs TP on its shards
  and gathers ZeRO-3 leaves layer by layer;
* the loss is the GLOBAL masked mean: each rank's masked sum over the token
  count all-reduced over (data, fsdp), and the reported loss the sum of
  the shares;
* gradients are reduced over the batch axes: all-reduced at stages 0-1,
  reduce-scattered onto the update's fsdp shard at 2 (ZeRO-3's leaves are
  reduce-scattered by their gather's backward) and all-reduced over data;
* the update runs over this rank's shard of each leaf as
  ``zero.moment_spec`` lays it out (stages 1-2 then all-gather the updated
  shards), the count and learning rate on the host, equal on every rank;
* the global grad norm counts each replicated leaf once and each sharded
  leaf's shards once (one all-reduce over the world), and the fp16
  overflow verdict is agreed over the world before any rank skips, so the
  loss scaler stays identical everywhere.

Pipeline parallelism (mesh axis ``pipe``, ``parallel/pipeline.py``): a
rank holds its stage's block of layers and the entries replicated over
``pipe`` (embedding, final norm, head); each (gradient-accumulation)
micro-batch runs the 1F1B schedule through the host-loop executor
(``pipeline.micro_batches`` micro-batches, default one a stage); layer
grads are reduced over the batch axes, the replicated entries' also over
``pipe`` (the tied embedding's two uses meet there); a leaf of a stage's
block is counted in the grad norm by index 0 of every axis but ``pipe``;
the loss is broadcast from the last stage. Only ``train_batch`` and
``eval_batch`` drive a pipeline (the reference's ``PipelineEngine``
refuses ``forward`` / ``backward`` / ``step`` the same way).

Sequence parallelism (mesh axis ``seq``, ``attn_impl`` ``ring`` or
``ulysses``): each ``seq`` rank holds the contiguous tokens ``[r C, (r +
1) C)`` of its rows, with the labels and the loss mask taken on the whole
row first and positions global; the token count is summed over (data,
fsdp, seq) and every grad also over ``seq``.

Expert parallelism (mesh axis ``expert``, an MoE model): a rank holds
``num_experts / ep`` experts of each MoE layer (under tensor parallelism
their F / tp columns), its tokens are replicated over ``expert``, and each
MoE layer routes the global tokens of its micro-batch
(``parallel/moe.py``); the leaves replicated over ``expert`` get their
full gradient on every expert rank through the expert region, so no grad
is summed over ``expert``: every leaf's over the batch axes alone, and an
expert leaf counts as split in the grad norm. The loss carries each
rank's share of the aux loss, so the reported loss and ``moe_aux_loss``
count it once. Under a pipeline each stage seeds its own aux in its
backward and the aux is summed over stages, micro-batches and layers, as
the JAX pipeline sums it.

ZeRO++ (``zero_quantized_weights``, ``zero_quantized_gradients``,
``zero_hpz_partition_size``; ``runtime/zeropp.py``): ``train_batch`` runs
the JAX package's explicit step: the leaves gathered whole once a step
(int8 under qwZ, in two hops under hpZ), each rank's LOCAL mean loss, each
micro-batch's float32 gradient reduced to the shard as the mean over fsdp
(int8 under qgZ), clipping by hand with no ``clip_by_global_norm`` in
the optimizer's state; outside the JAX scope (stage 3, fsdp > 1, no
pipe / seq / expert, ``h`` dividing fsdp) it raises the JAX engine's
``ValueError``. ``eval_batch`` and the eager ``forward`` / ``backward`` /
``step`` keep the plain ZeRO-3 path and the global mean, as the JAX
engine's jitted eval and eager paths do (its eager step clips the ZeRO++
way too).

A whole-leaf statistic of an optimizer (Lamb's trust ratio, the 1-bit
family's scales) is over the JAX package's leaf: ``_leaf_stats`` tells
the optimizer which tensors make up each leaf (a stacked leaf's layers,
the ranks' shards) and sums their partials over the world.

``shard_params_from_jax`` and ``gather_params`` carry weights between the
JAX package's global tree and the ranks' shards; ``load_engine_state``
cuts full leaves (a JAX-written state) to this rank's shards. The
sentinel, preemption handling and checkpoints across ranks (A.3.3b) are
refused at a world above one.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``, ``:1732-1980``) are
the JAX package's native format, leaf for leaf: ``params`` with the layers
stacked ``[L, ...]`` (the JAX model's ``scan_layers`` layout; the port
holds a list of layers), ``opt_state`` in optax's layout
(``_Optimizer.state_tree``) and ``scaler``, so a tag written by either
package loads in the other. The step boundary (``_post_step``, ``:1601``) feeds the
sentinel and the preemption handler (``runtime/resilience.py``);
``initialize(training_data=...)`` builds and registers a
``runtime/dataloader.py`` loader whose position rides the checkpoint meta.
Offload and telemetry are not ported: they raise ``NotImplementedError``
naming their ``ROADMAP.md`` entry.
"""
import contextlib
import copy
import dataclasses
import glob
import inspect
import logging
import math
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import DSTpuConfig
from .loss_scaler import (LossScaleState, grads_finite, init_loss_scale,
                          scale_loss, unscale_grads, update_loss_scale)
from .lr_schedules import build_schedule
from .optimizers import build_optimizer, current_lr
from . import zero as zero_lib
from ..checkpoint.engine import LATEST_FILE
from ..comm import comm
from ..comm.comms_logging import comms_logger
from ..comm.topology import MeshTopology, build_topology, set_world_topology
from ..device import resolve_device
from ..utils.fault_injection import get_fault_injector

logger = logging.getLogger(__name__)


class _InitTuple(NamedTuple):
    """Return shape of :func:`initialize`: ``engine, optimizer, dataloader,
    lr_scheduler = initialize(...)``."""
    engine: "Engine"
    optimizer: Any
    training_data: Any
    lr_scheduler: Any


def initialize(model: Any = None, loss_fn: Optional[Callable] = None,
               params: Any = None, config: Any = None,
               topology: Any = None, training_data: Any = None,
               lr_schedule: Optional[Callable] = None, device=None,
               collate_fn: Optional[Callable] = None,
               config_params: Any = None) -> _InitTuple:
    """Build an :class:`Engine` (reference ``deepspeed.initialize``).

    ``model``: anything with ``loss(params, batch, rng, train=...)`` (the
    port's ``CausalLM``) — or pass ``loss_fn``. ``params``: the initial
    params tree (default ``model.init_params`` on the engine's device).
    ``training_data``: an iterable of batches; the returned loader
    (``runtime/dataloader.py``, ``collate_fn`` applied to each) is
    registered with the engine. ``device``: None means the card (and
    raises without one). ``topology``: the named mesh (default: built from
    the config's ``parallelism`` sizes when a process group exists); under
    a process group ``params`` may be the full tree (each rank keeps its
    shards) or this rank's shards (``shard_params_from_jax``)."""
    config = config if config is not None else config_params
    if config is None:
        raise ValueError("config (dict or json path) is required")
    dev = resolve_device(device)
    if loss_fn is None:
        if model is None or not hasattr(model, "loss"):
            raise ValueError("provide loss_fn, or a model with a .loss method")
        loss_fn = model.loss
    if params is None:
        if model is None or not hasattr(model, "init_params"):
            raise ValueError("provide params, or a model with init_params()")
        params = model.init_params(device=dev)
    engine = Engine(loss_fn=loss_fn, params=params, config=config,
                    lr_schedule=lr_schedule, module=model, device=dev,
                    topology=topology)
    dataloader = None
    if training_data is not None:
        from .dataloader import DSTpuDataLoader

        dataloader = engine.register_dataloader(DSTpuDataLoader(
            training_data, dev, batch_fn=collate_fn,
            topology=engine.topology if engine.distributed else None,
            gradient_accumulation_steps=engine.gradient_accumulation_steps()))
    return _InitTuple(engine, engine.optimizer, dataloader,
                      engine.lr_schedule)


def _leaves(tree, path=()):
    """(path segments without list indices, tensor) for every leaf, in a
    fixed order. ``layers`` is a list here; JAX stacks it, so its paths are
    ``layers/attn/wq`` without an index — kept so that ``no_decay_patterns``
    match the same leaves in both packages."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, path)
    else:
        yield path, tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _index_tree(tree, counter):
    """``tree``'s structure with each leaf replaced by its position in
    :func:`_leaves`' order."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, counter) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index_tree(v, counter) for v in tree]
    counter[0] += 1
    return counter[0] - 1


def _rebuild(tree, leaves: Dict[Tuple, Any], path=()):
    """``tree``'s structure with the leaf at each path (as
    ``zero._walk`` yields them) replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves, path + (i,)) for i, v in enumerate(tree)]
    return leaves[path]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _meta(leaf):
    """A checkpoint-template leaf (shape and dtype, no storage) for a
    tensor, a numpy value or a zero-argument callable returning one."""
    if callable(leaf):
        leaf = leaf()
    if leaf is None or isinstance(leaf, torch.Tensor) and leaf.is_meta:
        return leaf
    if isinstance(leaf, torch.Tensor):
        return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    return torch.empty(np.shape(leaf), device="meta",
                       dtype=torch.from_numpy(np.asarray(leaf)).dtype)


def _host_scaler(s: LossScaleState) -> LossScaleState:
    """A scaler as the JAX package stores it: float32 scale, int32
    counters."""
    return LossScaleState(np.float32(s.scale), np.int32(s.good_steps),
                          np.int32(s.hysteresis_left), np.int32(s.overflows))


def _py_scaler(s) -> LossScaleState:
    """A stored scaler (tensors or numpy) as the port keeps it."""
    return LossScaleState(float(s.scale), int(s.good_steps),
                          int(s.hysteresis_left), int(s.overflows))


def engine_state_from_jax(opt_state: Any, scaler: Any) -> Dict[str, Any]:
    """The JAX engine's ``opt_state`` and ``scaler_state`` with numpy
    leaves (``jax.tree.map(np.asarray, ...)``: optax NamedTuples, tuples
    and dicts) -> the port's layout for :meth:`Engine.load_engine_state`:
    ``{"opt_state": nested dicts keyed by the JAX leaf names' segments,
    "scaler": LossScaleState}``. The counterpart of ``params_from_jax``."""
    from ..checkpoint.engine import _flatten

    nested: Dict[str, Any] = {}
    for path, leaf in _flatten(opt_state):
        node = nested
        for k in path[:-1]:
            node = node.setdefault(str(k), {})
        node[str(path[-1])] = np.asarray(leaf)
    return {"opt_state": nested,
            "scaler": _py_scaler(LossScaleState(*(np.asarray(x)
                                                  for x in scaler)))}


def shard_params(params: Any, cfg: Any, topology: MeshTopology, stage: int,
                 rank: Optional[int] = None) -> Any:
    """The port's full params tree (torch leaves, a list of layers) as
    ``rank``'s shards (default: this process's): the plan of
    ``runtime/zero.py`` with the port model's ``sharding_rules``, each
    shard a copy (the full tree can be freed). What ``initialize`` takes as
    this rank's params."""
    from ..models.transformer import CausalLM

    pp = topology.axis_sizes["pipe"]
    if pp > 1:
        cfg = dataclasses.replace(cfg, pipe_stages=pp)
    model = CausalLM(cfg)
    mine = zero_lib.stage_tree(params, topology, rank)
    specs = zero_lib.tree_param_shardings(
        mine, topology, stage, extra_rules=model.sharding_rules,
        stacked=bool(getattr(cfg, "scan_layers", True)),
        n_layers=len(params["layers"]))
    leaves = {path: t[topology.shard_slices(tuple(t.shape), specs[path],
                                            rank)].clone()
              for path, t in zero_lib._walk(mine)}
    return _rebuild(mine, leaves)


def shard_params_from_jax(np_tree: Any, cfg: Any, topology: MeshTopology,
                          stage: int, rank: Optional[int] = None) -> Any:
    """The JAX package's global params (numpy leaves, layers stacked
    ``[L, ...]`` or listed) as ``rank``'s shards (default: this process's)
    in the port's tree (a list of layers), numpy leaves
    (:func:`shard_params` of ``params_from_jax``)."""
    from ..models.transformer import params_from_jax

    full = params_from_jax(np_tree, cfg, device="cpu")
    return _tree_map(lambda t: t.numpy(),
                     shard_params(full, cfg, topology, stage, rank))


@torch.no_grad()
def gather_params(engine: "Engine") -> Any:
    """The full params tree (numpy, the port's layout) on rank 0, gathered
    from every rank's shards (under a pipeline every stage's block of
    layers); None on the other ranks. A collective: every rank calls
    it."""
    if not engine.distributed:
        return _tree_map(lambda t: t.detach().cpu().numpy(), engine.params)
    topo = engine.topology
    leaves = {}
    for path, t in zero_lib._walk(engine.params):
        t = t.detach()
        for d, entry in enumerate(engine._specs[path]):
            if entry and topo.axis_size(entry) > 1:
                t = comm.all_gather(t.contiguous(), entry, axis=d)
        leaves[path] = t
    pp = topo.axis_sizes["pipe"]
    n = len(engine.params["layers"])
    out = {}
    for path, t in leaves.items():
        if pp > 1 and path[0] == "layers":
            # layer i of every stage's block: [pp, ...] by stage
            for s, ts in enumerate(comm.all_gather(t, "pipe", tiled=False)):
                out[("layers", s * n + path[1]) + path[2:]] = ts
        else:
            out[path] = t
    if topo.rank != 0:
        return None
    template = engine.params if pp == 1 else dict(
        engine.params, layers=[engine.params["layers"][i % n]
                               for i in range(n * pp)])
    return _rebuild(template, {k: v.cpu().numpy() for k, v in out.items()})


class Engine:
    def __init__(self, loss_fn: Callable, params: Any, config: Any,
                 lr_schedule: Optional[Callable] = None, module: Any = None,
                 device=None, topology: Optional[MeshTopology] = None):
        self.device = resolve_device(device)
        self.config = DSTpuConfig.from_config(config)
        self.topology = self._build_topology(topology)
        self.distributed = self.topology is not None
        if self.config.zeropp.enabled and not self.distributed:
            from .zeropp import check_scope

            check_scope(self.config.zero_stage, {"fsdp": 1},
                        self.config.zeropp.zero_hpz_partition_size)
        self.dp_world_size = (self.topology.get_data_parallel_world_size()
                              if self.distributed else 1)
        self.config.resolve_batch_sizes(self.dp_world_size)
        self.module = module
        self.loss_fn_raw = loss_fn
        try:
            self._loss_accepts_train = "train" in inspect.signature(
                loss_fn).parameters
        except (TypeError, ValueError):
            self._loss_accepts_train = False
        self.zero_stage = self.config.zero_stage
        ac = self.config.activation_checkpointing
        mcfg = getattr(module, "config", None)
        if (ac is not None or self.distributed) and mcfg is not None:
            # a private view of the model (engine.py:430-459): remat set
            # from the config, the parallel plan under a process group; the
            # caller's model and config are left untouched
            view = copy.copy(module)
            if ac is not None and hasattr(mcfg, "remat"):
                view.config = dataclasses.replace(mcfg, remat=ac.enabled)
            if self.distributed and hasattr(mcfg, "pipe_stages"):
                # the pipelined trunk an explicit property of the view
                # (JAX engine.py:144-148)
                over = {"pipe_stages": self.topology.axis_sizes["pipe"]}
                if self.config.parallelism.pp_microbatches:
                    over["pipe_microbatches"] = \
                        self.config.parallelism.pp_microbatches
                view.config = dataclasses.replace(view.config, **over)
            if self.distributed:
                view.parallel = self._parallel_plan(view)
            if getattr(loss_fn, "__self__", None) is module:
                self.loss_fn_raw = getattr(view, loss_fn.__name__)
            elif self.distributed:
                raise NotImplementedError(
                    "under torch.distributed the loss must be the model's "
                    "own (its token count is all-reduced over the batch "
                    "axes); a custom loss_fn is not ported: ROADMAP.md, "
                    "queue A.3.1 (distributed training)")
            self.module = view
        elif self.distributed:
            raise NotImplementedError(
                "under torch.distributed the engine needs a model with a "
                "config and sharding_rules (the port's CausalLM): ROADMAP.md,"
                " queue A.3.1 (distributed training)")
        elif ac is not None:
            logger.warning("activation_checkpointing configured but the "
                           "model exposes no remat flag")

        # ------------------------------------------------------- precision
        self.compute_dtype = self.config.compute_dtype
        fp16 = self.config.fp16
        self.fp16_enabled = fp16.enabled
        self.scaler_state = init_loss_scale(
            fp16.initial_scale if fp16.enabled else 1.0,
            dynamic=fp16.enabled and fp16.dynamic, hysteresis=fp16.hysteresis)

        # ----------------------------------------------- master params
        def master(t):
            t = torch.as_tensor(t)
            if t.is_floating_point():
                return t.detach().to(self.device, torch.float32,
                                     copy=True).requires_grad_(True)
            return t.to(self.device)

        if self.distributed:
            params = self._plan(params)
        self.params = _tree_map(master, params)
        # the checkpoint layout: every leaf by its position in _leaves'
        # order; a "layers" list is stacked [L, ...] when the model's
        # config says the JAX model scans its layers
        all_named = list(_leaves(self.params))
        self._param_leaves = [t for _, t in all_named]
        self._index = _index_tree(self.params, [0])
        self._float_pos = [i for i, t in enumerate(self._param_leaves)
                           if t.is_floating_point()]
        self._stack_layers = bool(
            isinstance(self.params, dict)
            and isinstance(self.params.get("layers"), list)
            and self.params["layers"]
            and getattr(getattr(self.module, "config", None), "scan_layers",
                        False))
        named = [all_named[i] for i in self._float_pos]
        self._leaf_tensors: List[torch.Tensor] = [t for _, t in named]
        self._grad_paths = ["/".join(p) for p, _ in named]

        # ------------------------------------------------------- optimizer
        sched = self.config.scheduler
        self.lr_schedule = lr_schedule or build_schedule(
            sched.type, sched.params, self.config.optimizer.lr)
        self.optimizer = build_optimizer(self.config.optimizer.type,
                                         self.config.optimizer.params,
                                         self.lr_schedule)
        self.optimizer.init(self._update_views() if self.distributed
                            else self._leaf_tensors, [p for p, _ in named],
                            self._leaf_stats())
        self._zeropp = None
        if self.config.zeropp.enabled:
            from .zeropp import ZeroPPStep

            self._zeropp = ZeroPPStep(self)

        # ----------------------------------------------------- bookkeeping
        self.global_steps = 0
        self.micro_steps = 0
        self._accum_count = 0
        self._accum_losses: List[torch.Tensor] = []
        self._pending: Optional[torch.Tensor] = None
        self._last_grad_norm: Optional[torch.Tensor] = None
        self.losses = None

        # ------------------------------------------------------ resilience
        from ..checkpoint.ckpt_engine import build_checkpoint_engine
        from ..utils.podid import pod_rank

        self.checkpoint_engine = build_checkpoint_engine(
            self.config.checkpoint.engine)
        self._fi_rank = pod_rank()
        self._resilience = None   # ResilienceManager (preemption handling)
        self._dataloader = None   # registered loader (its position is saved)
        self._sentinel = None
        self._host_metrics: Optional[Dict[str, Any]] = None
        if self.config.sentinel.enabled:
            if self.distributed:
                raise NotImplementedError(
                    "the training sentinel under torch.distributed is not "
                    "ported yet: "
                    "ROADMAP.md, queue A.3.3b (pod-wide resilience)")
            from .sentinel import TrainingSentinel

            self._sentinel = TrainingSentinel(self, self.config.sentinel,
                                              rank=self._fi_rank)
        cl = self.config.comms_logger
        comms_logger.configure(enabled=cl.enabled, verbose=cl.verbose,
                               timed=cl.timed)

    # ============================================================ the mesh
    def _build_topology(self, topology: Optional[MeshTopology]
                        ) -> Optional[MeshTopology]:
        """The named mesh (JAX ``engine.py:130-134``): ``topology`` as
        given, else built from the config's sizes over the default process
        group. None on one card without a process group."""
        import torch.distributed as dist

        started = dist.is_available() and dist.is_initialized()
        p = self.config.parallelism
        if topology is None:
            if not started:
                if max(p.tp, p.fsdp, p.dp, p.pp, p.sp, p.ep) > 1:
                    raise RuntimeError(
                        f"parallelism dp={p.dp} fsdp={p.fsdp} tp={p.tp} "
                        f"pp={p.pp} sp={p.sp} ep={p.ep} needs a process "
                        f"group: call comm.init_distributed first")
                return None
            topology = build_topology(dp=p.dp, fsdp=p.fsdp, tp=p.tp,
                                      pp=p.pp, ep=p.ep, sp=p.sp)
        if not started:
            if topology.world_size() > 1:
                raise RuntimeError(f"{topology} spans "
                                   f"{topology.world_size()} ranks: call "
                                   f"comm.init_distributed first")
            return None
        set_world_topology(topology)
        zpp = self.config.zeropp
        hier = []
        if zpp.enabled:
            from .zeropp import check_scope

            check_scope(self.config.zero_stage, topology.axis_sizes,
                        zpp.zero_hpz_partition_size)
            h = zpp.zero_hpz_partition_size
            if 1 < h < topology.axis_sizes["fsdp"]:
                # hpZ's two hops, built before any step: a group made
                # mid-step can deadlock
                hier = [("fsdp", h)]
        topology.init_groups(hierarchical=hier)
        return topology

    def _parallel_plan(self, view):
        from ..models.transformer import ParallelPlan

        cfg = view.config
        sizes = self.topology.axis_sizes
        tp = sizes["model"]
        if sizes["seq"] > 1:
            impl = str(getattr(cfg, "attn_impl", "auto")).split(":")[0]
            if impl not in ("ring", "ulysses"):
                raise ValueError(
                    f"sequence parallelism (mesh axis 'seq' = {sizes['seq']})"
                    f" needs attn_impl 'ring' or 'ulysses' (a rank holds a "
                    f"chunk of each row; attn_impl={cfg.attn_impl!r} attends "
                    f"within it)")
        if sizes["pipe"] > 1:
            zero_lib.layer_block(cfg.num_layers, self.topology)
        ep = sizes["expert"]
        if getattr(cfg, "any_moe", False) and cfg.num_experts % ep:
            raise ValueError(f"expert parallelism {ep} must divide the "
                             f"{cfg.num_experts} experts")
        if tp > 1:
            if cfg.num_heads % tp or cfg.num_kv_heads % tp:
                raise ValueError(f"tensor parallelism {tp} must divide the "
                                 f"{cfg.num_heads} query and "
                                 f"{cfg.num_kv_heads} KV heads")
            if cfg.qkv_bias or (cfg.mlp_type == "mlp" and cfg.use_bias):
                raise NotImplementedError(
                    "biases of column-parallel layers under tensor "
                    "parallelism are not ported yet: ROADMAP.md, queue "
                    "A.3.1 (distributed training)")
        return ParallelPlan(tp=tp, batch_axes=self._batch_axes, ep=ep)

    @property
    def _batch_axes(self) -> Tuple[str, ...]:
        """The axes a token's loss and a param's grad are summed over
        besides the model's own: (data, fsdp), and seq under sequence
        parallelism."""
        seq = self.topology.axis_sizes["seq"] > 1
        return ("data", "fsdp") + (("seq",) if seq else ())

    def _plan(self, params):
        """Lay the params out on the mesh: the JAX plan on the model's full
        shapes (``zero.tree_param_shardings`` / ``tree_optimizer_shardings``),
        and this rank's shard of every leaf (a full leaf is sliced; a leaf
        of the shard's shape is taken as it is)."""
        topo, stage = self.topology, self.zero_stage
        mcfg = self.module.config
        whole = self.module.init_params(device="meta")
        n_layers = len(whole["layers"])
        # this stage's block of layers (a whole tree given is cut too)
        full = zero_lib.stage_tree(whole, topo)
        if len(params["layers"]) == n_layers:
            params = zero_lib.stage_tree(params, topo)
        stacked = bool(getattr(mcfg, "scan_layers", True))
        self._specs = zero_lib.tree_param_shardings(
            full, topo, stage, extra_rules=self.module.sharding_rules,
            stacked=stacked, n_layers=n_layers)
        moments = zero_lib.tree_optimizer_shardings(
            full, self._specs, topo, stage, stacked=stacked,
            n_layers=n_layers)
        # the update's layout: the moments' (stage 0 keeps them beside the
        # param's TP shard; the JAX package leaves stage-0 moments whole)
        self._full_shapes = {p: tuple(t.shape)
                             for p, t in zero_lib._walk(full)}
        pad = {p: len(s) for p, s in self._full_shapes.items()}
        self._specs = {p: tuple(s) + ((),) * (pad[p] - len(s))
                       for p, s in self._specs.items()}
        self._update_specs = {
            p: tuple(s) + ((),) * (pad[p] - len(s))
            for p, s in (moments if stage >= 1 else self._specs).items()}
        given = dict(zero_lib._walk(params))
        if set(given) != set(self._full_shapes):
            raise ValueError("params do not match the model's tree: "
                             f"{sorted(set(given) ^ set(self._full_shapes))}")
        out = {}
        for path, shape in self._full_shapes.items():
            t = torch.as_tensor(np.asarray(given[path]) if not isinstance(
                given[path], torch.Tensor) else given[path])
            local = topo.shard_shape(shape, self._specs[path])
            if tuple(t.shape) == shape:
                t = t[topo.shard_slices(shape, self._specs[path])]
            elif tuple(t.shape) != local:
                raise ValueError(f"param {path}: shape {tuple(t.shape)} is "
                                 f"neither the full {shape} nor this rank's "
                                 f"shard {local}")
            out[path] = t
        logger.info("%s", zero_lib.describe_memory_plan(whole, topo, stage))
        local = _rebuild(params, out)
        self._paths = [path for path, _ in zero_lib._walk(local)]
        return local

    @staticmethod
    def _shard_dim(spec) -> Optional[int]:
        """The dim ``spec`` splits over fsdp (None: none)."""
        for d, entry in enumerate(spec):
            if "fsdp" in entry:
                return d
        return None

    def _update_views(self) -> List[torch.Tensor]:
        """For each float leaf, the part this rank updates: the held tensor,
        or (stages 1-2) a view of its fsdp shard."""
        topo = self.topology
        k = topo.axis_index("fsdp")
        self._float_paths = [self._paths[i] for i in self._float_pos]
        self._update_dim: List[Optional[int]] = []
        self._owner: List[bool] = []
        views = []
        coords = topo.coords()
        with torch.no_grad():
            for path, t in zip(self._float_paths, self._leaf_tensors):
                held, upd = self._specs[path], self._update_specs[path]
                d = None
                if tuple(upd) != tuple(held):
                    d = self._shard_dim(upd)
                    if d is None or held[d]:
                        raise AssertionError(f"{path}: update {upd} vs "
                                             f"held {held}")
                    n = t.shape[d] // topo.axis_sizes["fsdp"]
                    views.append(t.narrow(d, k * n, n))
                else:
                    views.append(t)
                self._update_dim.append(d)
                used = {a for e in upd for a in e}
                if path[0] == "layers":
                    # a stage's block: split over pipe on the dropped
                    # layer dim
                    used.add("pipe")
                # counted once: the rank at index 0 of every axis the
                # update does not split
                self._owner.append(all(coords[a] == 0 for a in coords
                                       if a not in used))
        return views

    def _leaf_stats(self):
        """How the optimizer's tensors make up the JAX package's leaves
        (``optimizers.LeafStats``): a stacked layer leaf is its layers'
        tensors, and across ranks each tensor a shard of its leaf, counted
        by its owner and summed over the world, so a whole-leaf statistic
        (Lamb's norms, the 1-bit scales) is the world-1 one."""
        from .optimizers import LeafStats

        paths = [p for p, _ in _leaves(self.params)]
        paths = [paths[i] for i in self._float_pos]
        if not self.distributed:
            shapes = [tuple(t.shape) for t in self._leaf_tensors]
            layers = len(self.params["layers"]) if self._stack_layers else 1
        else:
            shapes = [self._full_shapes[p] for p in self._float_paths]
            layers = getattr(self.module.config, "num_layers", 1)
        keys: Dict[Tuple, int] = {}
        group, sizes = [], []
        for path, shape in zip(paths, shapes):
            stacked = self._stack_layers and path[0] == "layers"
            if path not in keys or not stacked:
                keys[path] = len(sizes)
                sizes.append(int(np.prod(shape)) * (layers if stacked
                                                    else 1))
            group.append(keys[path])
        if not self.distributed:
            return LeafStats(group, sizes)
        everyone = tuple(self.topology.axis_sizes)
        return LeafStats(group, sizes, owner=self._owner,
                         reduce=lambda v, op: comm.all_reduce(v, everyone,
                                                              op=op))

    # =============================================================== loss core
    def _cast_params(self, params):
        """The params in the compute dtype; at ZeRO-3 a leaf held as an
        fsdp shard is cast as a shard and handed over as a ``ZeroShard``,
        which the model gathers when its layer runs."""
        dtype = self.compute_dtype

        def cast(t):
            return t.to(dtype) if t.is_floating_point() else t

        if not self.distributed or self.zero_stage < 3:
            return _tree_map(cast, params)
        leaves = {}
        for path, t in zero_lib._walk(params):
            d = self._shard_dim(self._specs[path])
            leaves[path] = cast(t) if d is None else \
                zero_lib.ZeroShard(cast(t), d, "fsdp")
        return _rebuild(params, leaves)

    def _generator(self, *stream: int) -> torch.Generator:
        """The loss's random generator (an MoE router's jitter) for one
        micro-batch, seeded from ``config.seed`` and the step: the JAX
        engine folds the step (and micro-batch) into its key, so a resumed
        run draws what the uninterrupted one drew. The two packages' draws
        differ."""
        seed = hash((self.config.seed, *stream)) & (2 ** 63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _loss_and_metrics(self, params, batch, train: bool = True,
                          rng: Optional[torch.Generator] = None,
                          gathered: bool = False
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss on the params cast to the compute dtype (``gathered``:
        every leaf is whole, as ZeRO++ hands them, so none is a shard)."""
        p = _tree_map(lambda t: t.to(self.compute_dtype)
                      if t.is_floating_point() else t, params) \
            if gathered else self._cast_params(params)
        if rng is None:
            rng = self._generator(self.micro_steps)
        out = (self.loss_fn_raw(p, batch, rng, train=train)
               if self._loss_accepts_train else self.loss_fn_raw(p, batch,
                                                                  rng))
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        return loss.float(), dict(metrics)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _zero_grads(self) -> None:
        for t in self._leaf_tensors:
            t.grad = None

    def _grads(self) -> List[torch.Tensor]:
        return [t.grad if t.grad is not None else torch.zeros_like(t)
                for t in self._leaf_tensors]

    def _micro_backward(self, batch, rng: torch.Generator
                        ) -> Tuple[torch.Tensor, Dict]:
        if self._pipelined:
            return self._pipe_loss(batch, train=True, rng=rng)
        loss, metrics = self._loss_and_metrics(self.params, batch, rng=rng)
        scale_loss(loss, self.scaler_state).backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    @contextlib.contextmanager
    def _local_loss(self):
        """The model's loss as each rank's LOCAL masked mean (its token
        count not summed over the batch axes): the ZeRO++ step's loss, as
        the JAX body computes it inside ``shard_map``."""
        plan = self.module.parallel
        self.module.parallel = dataclasses.replace(plan, batch_axes=())
        try:
            yield
        finally:
            self.module.parallel = plan

    @property
    def _pipelined(self) -> bool:
        return self.distributed and self.topology.axis_sizes["pipe"] > 1

    def _pipe_loss(self, batch, train: bool,
                   rng: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One micro-batch through the pipeline (``parallel/pipeline.py``):
        forward and, when ``train``, the 1F1B backward with the loss scale;
        ``(this rank's share of the loss, its metrics)``: the LM loss's
        share (0 off the last stage) and, for an MoE model, the aux loss's
        (this stage's layers over the pipeline's micro-batches, summed as
        the JAX pipeline sums it) times ``aux_loss_coef`` added to it, so
        that the shares summed over pipe and the batch axes are the JAX
        package's loss, ``lm_loss`` and ``moe_aux_loss``."""
        from ..parallel.pipeline import pipelined_loss

        cfg = self.module.config
        n = cfg.pipe_microbatches or self.topology.axis_sizes["pipe"]
        out = pipelined_loss(self.module, self._cast_params(self.params),
                             batch, n, train=train,
                             loss_scale=self.scaler_state.scale, rng=rng)
        if not isinstance(out, tuple):
            return out, {"lm_loss": out}
        lm, aux = out
        return lm + cfg.aux_loss_coef * aux, {"lm_loss": lm,
                                              "moe_aux_loss": aux}

    @torch.no_grad()
    def _apply_grads(self, grads: List[torch.Tensor],
                     loss: Optional[torch.Tensor] = None,
                     gate: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Unscale, overflow check, pre-clip norm, clip, gated update and
        loss-scale transition (``engine.py:862-917``). Grads are modified in
        place.

        ``gate`` (the sentinel's ``[loss_cap, grad_scale]``, with the step's
        mean ``loss``) arms the health gate: the grads are scaled by
        ``grad_scale`` first; ``finite`` is computed in any precision, with
        the health scalars (on the unclipped grads, as the JAX package's
        optax chain clips after them); and the update is applied only when
        ``finite`` and ``loss <= loss_cap`` (read on the host). A gated step
        leaves the whole optimizer state as it was; the scaler moves on
        ``finite`` alone."""
        health: Dict[str, Any] = {}
        if gate is not None and float(gate[1]) != 1.0 and grads:
            torch._foreach_mul_(grads, float(gate[1]))
        unscale_grads(grads, self.scaler_state)
        norms = torch._foreach_norm(grads) if grads else []
        grad_norm = torch.linalg.vector_norm(torch.stack(norms)) if grads \
            else torch.zeros((), device=self.device)
        if gate is not None:
            from .sentinel import nonfinite_count, region_norms

            health = region_norms(self._grad_paths, norms)
            # one host read: the gate's inputs and the sentinel's scalars
            # (NaN compares false: a nonfinite loss is gated at any cap)
            host = dict(zip(("loss_ok", "loss", "grad_norm", *health),
                            torch.stack([(loss <= float(gate[0])).float(),
                                         loss, grad_norm, *health.values()]
                                        ).tolist()))
            # a finite global norm means no nonfinite element: the count (a
            # pass over the grads, a second read) only when it is not
            nonfinite = 0 if math.isfinite(host["grad_norm"]) else \
                int(nonfinite_count(grads))
            finite_h = nonfinite == 0
            apply = finite_h and host.pop("loss_ok") > 0
            health["health_nonfinite"] = torch.tensor(
                nonfinite, dtype=torch.int32, device=self.device)
            finite = torch.tensor(finite_h, device=self.device)
            self._host_metrics = dict(host, finite=finite_h,
                                      health_nonfinite=nonfinite)
        elif self.fp16_enabled:
            finite = grads_finite(grads)
            finite_h = apply = bool(finite)
        else:
            finite = torch.ones((), dtype=torch.bool, device=self.device)
            finite_h = apply = True
        clip = self.config.gradient_clipping
        if clip and clip > 0 and grads:
            # optax.clip_by_global_norm: scale only when norm > max_norm
            factor = torch.where(grad_norm < clip,
                                 torch.ones_like(grad_norm), clip / grad_norm)
            torch._foreach_mul_(grads, factor)
        if apply:
            self.optimizer.step(grads)
        fp16 = self.config.fp16
        self.scaler_state = update_loss_scale(
            self.scaler_state, finite_h,
            dynamic=self.fp16_enabled and fp16.dynamic,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
        self._last_grad_norm = grad_norm
        return {**health, "grad_norm": grad_norm, "finite": finite,
                "loss_scale": self.scaler_state.scale}

    # ======================================================== distributed
    def _batch_split(self) -> Tuple[int, int]:
        """(ranks the batch is split over, this rank's index among them)."""
        if not self.distributed:
            return 1, 0
        return (self.dp_world_size,
                self.topology.axis_index(("data", "fsdp")))

    def _micro_batches(self, batch: Dict[str, torch.Tensor], gas: int
                       ) -> List[Dict[str, torch.Tensor]]:
        """This rank's rows of each of the step's ``gas`` micro-batches. A
        global batch (leading dim ``train_batch_size``) is cut as the JAX
        engine cuts it: into ``gas`` micro-batches of consecutive rows, each
        split over (data, fsdp) in rank order; any other batch is this
        rank's own (a ``DSTpuDataLoader`` with the topology gives it in that
        order) and is cut into ``gas`` in order."""
        n, c = self._batch_split()
        lead = next(iter(batch.values())).shape[0]
        if n > 1 and lead == self.config.train_batch_size:
            per = lead // gas
            mb = per // n
            return [self._seq_chunk({
                k: v[i * per + c * mb:i * per + (c + 1) * mb]
                for k, v in batch.items()}) for i in range(gas)]
        return [self._seq_chunk({
            k: v.reshape(gas, v.shape[0] // gas, *v.shape[1:])[i]
            for k, v in batch.items()}) for i in range(gas)]

    def _seq_chunk(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """This ``seq`` rank's contiguous chunk ``[r C, (r + 1) C)`` of each
        row: the labels and loss mask taken on the whole row first (so a
        chunk's last label is the next chunk's first token), positions
        global (RoPE sees the same angles)."""
        if not self.distributed or self.topology.axis_sizes["seq"] == 1:
            return batch
        sp = self.topology.axis_sizes["seq"]
        ids = batch["input_ids"]
        rows, seq = ids.shape
        if seq % sp:
            raise ValueError(f"sequence length {seq} does not split over "
                             f"{sp} seq ranks")
        c = seq // sp
        r = self.topology.axis_index("seq")
        labels, mask = self.module.targets(batch)
        out = {"labels": labels, "loss_mask": mask,
               "positions": batch.get("positions", torch.arange(
                   seq, device=ids.device)[None].expand(rows, seq))}
        out.update({k: v for k, v in batch.items()
                    if k in ("input_ids", "segment_ids")})
        return {k: v[:, r * c:(r + 1) * c] for k, v in out.items()}

    def _rank_rows(self, batch: Dict[str, torch.Tensor], local: int
                   ) -> Dict[str, torch.Tensor]:
        """This rank's block of a batch split over (data, fsdp), unless the
        batch already has ``local`` rows."""
        n, c = self._batch_split()
        lead = next(iter(batch.values())).shape[0]
        if n == 1 or lead == local:
            return self._seq_chunk(batch)
        if lead % n:
            raise ValueError(f"batch of {lead} rows does not split over "
                             f"{n} ranks")
        m = lead // n
        return self._seq_chunk({k: v[c * m:(c + 1) * m]
                                for k, v in batch.items()})

    def _global_sum(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's shares summed over the batch axes, in one call; under
        a pipeline over ``pipe`` too (the LM loss's shares are 0 off the
        last stage, as JAX's ``broadcast_from_last`` reads them; an MoE
        aux's shares are every stage's), so every rank returns the same
        value."""
        if not self.distributed or not values:
            return values
        axes = self._batch_axes
        if self.topology.axis_sizes["pipe"] > 1:
            axes = ("pipe",) + axes
        return list(comm.all_reduce(torch.stack(values), axes).unbind(0))

    def _over_ranks(self, losses: List[torch.Tensor], metrics: List[Dict],
                    how: str) -> Tuple[List[torch.Tensor], List[Dict]]:
        """Each micro-batch's loss and metrics over the ranks in one call:
        ``"sum"`` of the ranks' shares (:meth:`_global_sum`), or the
        ``"mean"`` of their local values over (data, fsdp) (the ZeRO++
        step's: JAX ``global_mean``)."""
        keys = list(metrics[0])
        flat = losses + [m[k] for m in metrics for k in keys]
        vals = self._global_sum(flat) if how == "sum" else list(
            comm.all_reduce(torch.stack(flat), ("data", "fsdp"),
                            op="mean").unbind(0))
        n = len(losses)
        return vals[:n], [dict(zip(keys, vals[n + i * len(keys):
                                             n + (i + 1) * len(keys)]))
                          for i in range(n)]

    def _reduce(self, g: torch.Tensor, axes) -> torch.Tensor:
        return comm.all_reduce(g, axes) \
            if self.topology.axis_size(axes) > 1 else g

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum each leaf's grad over the batch axes into its update layout:
        stage 3's sharded leaves were reduce-scattered over fsdp by their
        gather's backward (all-reduce over data left); stage 2
        reduce-scatters onto the update's fsdp shard; otherwise all-reduce
        (stage 1 then keeps the update's shard). Under sequence parallelism
        every grad is also summed over ``seq`` (params are replicated
        there); under a pipeline the leaves replicated over ``pipe``
        (embedding, final norm, head: ``ReduceTiedGrads``) also over
        ``pipe``. Each leaf's unreduced gradient is released (from
        ``grads`` and its ``.grad``) as soon as its reduction is made."""
        topo, stage = self.topology, self.zero_stage
        k = topo.axis_index("fsdp")
        # the replicas of an fsdp shard (one axis named by itself, as the
        # comms logger keys its bytes)
        data = ("data", "seq") if "seq" in self._batch_axes else "data"
        pipe = topo.axis_sizes["pipe"] > 1
        out = []
        for i, g in enumerate(grads):
            path = self._float_paths[i]
            held = self._specs[path]
            d = self._update_dim[i]
            if stage >= 3 and self._shard_dim(held) is not None:
                g = self._reduce(g, data)
            elif stage == 2 and d is not None:
                g = self._reduce(comm.reduce_scatter(g, "fsdp", axis=d),
                                 data)
            else:
                g = self._reduce(g, self._batch_axes)
                if d is not None:
                    n = g.shape[d] // topo.axis_sizes["fsdp"]
                    g = g.narrow(d, k * n, n)
            if pipe and path[0] != "layers":
                g = comm.all_reduce(g, "pipe")
            out.append(g)
            # the unreduced gradient is dead once its reduction is made:
            # drop it now, not after the update (a ZeRO-2 leaf's full
            # gradient is twice its reduced shard)
            grads[i] = None
            self._leaf_tensors[i].grad = None
        return out

    @torch.no_grad()
    def _apply_grads_dist(self, grads: List[torch.Tensor]) -> Dict[str, Any]:
        """:meth:`_apply_grads` over this rank's update shards: the global
        norm from each leaf's owner (one all-reduce over the world), the
        fp16 verdict agreed over the world, then clip, update, and (stages
        1-2) the updated shards all-gathered into the held params."""
        everyone = tuple(self.topology.axis_sizes)
        unscale_grads(grads, self.scaler_state)
        norms = torch._foreach_norm(grads) if grads else []
        own = [n for n, o in zip(norms, self._owner) if o]
        local = torch.linalg.vector_norm(torch.stack(own)) if own \
            else torch.zeros((), device=self.device)
        grad_norm = comm.all_reduce(local * local, everyone).sqrt()
        if self.fp16_enabled:
            ok = grads_finite(grads).float() if grads else \
                torch.ones((), device=self.device)
            finite = comm.all_reduce(ok, everyone, op="min") > 0
            finite_h = apply = bool(finite)
        else:
            finite = torch.ones((), dtype=torch.bool, device=self.device)
            finite_h = apply = True
        clip = self.config.gradient_clipping
        if clip and clip > 0 and grads:
            if self.config.zeropp.enabled:
                # the JAX ZeRO++ step's manual clip (its optax chain has
                # no clip_by_global_norm)
                factor = torch.clamp(clip / grad_norm.clamp_min(1e-6),
                                     max=1.0)
            else:
                factor = torch.where(grad_norm < clip,
                                     torch.ones_like(grad_norm),
                                     clip / grad_norm)
            torch._foreach_mul_(grads, factor)
        if apply:
            self.optimizer.step(grads)
            for t, view, d in zip(self._leaf_tensors, self.optimizer.params,
                                  self._update_dim):
                if d is not None:
                    t.copy_(comm.all_gather(view.contiguous(), "fsdp",
                                            axis=d))
        fp16 = self.config.fp16
        self.scaler_state = update_loss_scale(
            self.scaler_state, finite_h,
            dynamic=self.fp16_enabled and fp16.dynamic,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
        self._last_grad_norm = grad_norm
        return {"grad_norm": grad_norm, "finite": finite,
                "loss_scale": self.scaler_state.scale}

    # ============================================================ fused path
    def train_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step on one global batch (leading dim =
        ``train_batch_size``), cut into ``gradient_accumulation_steps``
        micro-batches. Returns ``loss``, the loss function's metrics
        (``lm_loss``), ``grad_norm``, ``finite``, ``loss_scale`` and, with
        the sentinel armed, its ``health_*`` scalars; None when the sentinel
        drops a journaled bad batch before dispatch (the step count does
        not move, so the replayed run keeps the clean run's numbering)."""
        if self._sentinel is not None and self._sentinel.offer_batch():
            return None
        gas = self.config.gradient_accumulation_steps
        batch = self._to_device(batch)
        for k, v in batch.items():
            if v.shape[0] % gas:
                raise ValueError(f"batch[{k!r}] leading dim {v.shape[0]} is "
                                 f"not a multiple of gradient_accumulation_"
                                 f"steps={gas}")
        fi = get_fault_injector()
        if fi.armed:
            # numerical fault: poison the data of step global_steps + 1
            batch = fi.corrupt_batch(self._fi_rank, self.global_steps + 1,
                                     batch)
        gate = self._sentinel.gate_array() if self._sentinel is not None \
            else None
        self._zero_grads()
        if self._zeropp is not None:
            # the ZeRO++ step: gradient shards already averaged over the
            # micro-batches; the ranks' local losses averaged over them
            grads, losses, metrics = self._zeropp.grads(
                self._micro_batches(batch, gas))
            losses, metrics = self._over_ranks(losses, metrics, "mean")
        else:
            losses, metrics = [], []
            for i, mb in enumerate(self._micro_batches(batch, gas)):
                loss, m = self._micro_backward(
                    mb, self._generator(self.global_steps, i))
                losses.append(loss)
                metrics.append(m)
            grads = self._grads()
            if self.distributed:
                grads = self._reduce_grads(grads)
                losses, metrics = self._over_ranks(losses, metrics, "sum")
            if gas > 1:
                torch._foreach_div_(grads, float(gas))
        out = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        loss = torch.stack(losses).mean()
        out.update(self._apply_grads_dist(grads) if self.distributed
                   else self._apply_grads(grads, loss=loss, gate=gate))
        out["loss"] = loss
        self._zero_grads()
        self.global_steps += 1
        self.micro_steps += gas
        self._log(out)
        self._post_step(out)
        if fi.armed:
            rc = fi.should_kill(self._fi_rank, self.global_steps)
            if rc is not None:
                # a crash, not a preemption: no save, no cleanup
                logger.error("fault injection: rank %d dying with rc=%d "
                             "after step %d", self._fi_rank, rc,
                             self.global_steps)
                os._exit(rc)
        return out

    # ============================================================ eager path
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Loss on one micro-batch (reference ``engine.forward``). The
        autograd graph is kept for :meth:`backward`, which runs it instead
        of recomputing the forward as the JAX package must. Under a process
        group a global micro-batch is cut to this rank's rows and the loss
        is this rank's share of the global one (``self.losses`` too; the
        loss ``step`` reports is the global mean). Under a pipeline only
        :meth:`train_batch` / :meth:`eval_batch` run (as the reference's
        ``PipelineEngine``)."""
        if self._pipelined:
            raise RuntimeError("Only train_batch() and eval_batch() are "
                               "accessible in pipeline mode")
        batch = self._rank_rows(self._to_device(batch),
                                self.config.train_micro_batch_size_per_gpu)
        loss, _ = self._loss_and_metrics(self.params, batch)
        self._pending = loss
        self.losses = loss.detach()
        return loss

    def backward(self, loss: Optional[torch.Tensor] = None,
                 batch: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Accumulate one micro-batch's grads (reference ``engine.backward``)
        from the graph :meth:`forward` kept; with ``batch`` and no pending
        forward, runs the forward first."""
        if self._pending is None:
            if batch is None:
                raise RuntimeError("backward() needs forward() first or an "
                                   "explicit batch")
            self.forward(batch)
        if self._accum_count == 0:
            self._zero_grads()
        pending, self._pending = self._pending, None
        scale_loss(pending, self.scaler_state).backward()
        self._accum_losses.append(pending.detach())
        self._accum_count += 1
        self.micro_steps += 1
        return pending.detach()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._accum_count >= self.config.gradient_accumulation_steps

    def step(self) -> Dict[str, Any]:
        """Apply the accumulated grads, averaged over the micro-batches
        (reference ``engine.step``)."""
        if self._accum_count == 0:
            raise RuntimeError("step() before backward()")
        grads = self._grads()
        losses = self._accum_losses
        if self.distributed:
            grads = self._reduce_grads(grads)
            losses = self._global_sum(losses)
        if self._accum_count > 1:
            torch._foreach_div_(grads, float(self._accum_count))
        out = self._apply_grads_dist(grads) if self.distributed \
            else self._apply_grads(grads)
        out["loss"] = torch.stack(losses).mean()
        self._zero_grads()
        self._accum_count = 0
        self._accum_losses = []
        self.global_steps += 1
        self._log(out)
        self._post_step(out)
        return out

    def _post_step(self, out: Dict[str, Any]) -> None:
        """The step boundary (``engine.py:1601``): the sentinel queues this
        step's scalars (and decides the ones ``lag`` steps old); a pending
        preemption saves and exits here, where nothing is in flight."""
        if self._sentinel is not None:
            # the gate's host copy of the scalars when the step had one (no
            # second read), else the device metrics
            host, self._host_metrics = self._host_metrics, None
            self._sentinel.at_step_boundary(self.global_steps, host or out)
        if self._resilience is not None:
            self._resilience.at_step_boundary()

    def __call__(self, batch):
        return self.forward(batch)

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Loss on a batch without touching training state (under a process
        group: the global batch, each rank on its block of rows)."""
        batch = self._rank_rows(self._to_device(batch), -1)
        if self._pipelined:
            loss = self._pipe_loss(batch, train=False,
                                   rng=self._generator(self.micro_steps))[0]
        else:
            loss = self._loss_and_metrics(self.params, batch, train=False)[0]
        return self._global_sum([loss])[0]

    def _log(self, out: Dict[str, Any]) -> None:
        if self.global_steps % self.config.steps_per_print == 0:
            logger.info("step=%d loss=%.4f lr=%.3e scale=%.1f",
                        self.global_steps, float(out["loss"]), self.get_lr(),
                        self.get_loss_scale())

    # ============================================================= accessors
    @property
    def skipped_steps(self) -> int:
        return self.scaler_state.overflows

    def get_lr(self) -> float:
        return current_lr(self.optimizer)

    def get_loss_scale(self) -> float:
        return float(self.scaler_state.scale)

    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's pre-clip global grad norm (None before one)."""
        n = self._last_grad_norm
        return None if n is None else float(n)

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def register_dataloader(self, loader):
        """Attach the loader feeding ``train_batch``: its position
        (``state_dict``) rides the checkpoint meta, so a resume continues
        the stream and the sentinel's rollback rewinds it. ``initialize``
        registers the loader it builds."""
        self._dataloader = loader
        return loader

    # ============================================================ resilience
    def enable_preemption_handling(self, save_dir: str,
                                   install_signal_handlers: bool = True,
                                   exit_fn: Optional[Callable[[int], None]]
                                   = None):
        """Arm preemption handling: a SIGTERM / SIGINT (or an injected
        ``preempt_at_step``) saves a checkpoint into ``save_dir`` at the
        next step boundary, then exits with ``PREEMPTION_EXIT_CODE`` (217),
        which the elastic agent restarts for free. Returns the
        :class:`~.resilience.ResilienceManager`."""
        from .resilience import ResilienceManager

        self._resilience = ResilienceManager(self, save_dir, exit_fn=exit_fn)
        if install_signal_handlers:
            self._resilience.install()
        return self._resilience

    # ============================================================ checkpoint
    def _layout(self, values: List[Any], per_leaf: bool = False) -> Any:
        """One value per param leaf (None drops it) -> the JAX package's
        params tree. Stacked layer leaves are callables that stack when the
        writer reaches them, so one stacked leaf at a time is held; with
        ``per_leaf`` the values are each leaf's scalar (equal over a stacked
        leaf's layers) and a stacked leaf takes its first layer's."""
        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if isinstance(node, list):
                return [build(v) for v in node]
            return values[node]

        if not self._stack_layers:
            return build(self._index)
        out = {k: build(v) for k, v in self._index.items() if k != "layers"}
        layers = self._index["layers"]

        def stack(node, path):
            if isinstance(node, dict):
                return {k: stack(v, path + (k,)) for k, v in node.items()}
            parts = [values[_get(layer, path)] for layer in layers]
            if parts[0] is None or per_leaf:
                return parts[0]
            return lambda: torch.stack(parts)

        out["layers"] = stack(layers[0], ())
        return out

    def _unlayout(self, tree: Any, per_leaf: bool = False) -> List[Any]:
        """:meth:`_layout`'s inverse: one value per param leaf (layer ``i``
        of a stacked leaf is its ``[i]``; with ``per_leaf`` every layer
        takes the leaf's scalar)."""
        out: List[Any] = [None] * len(self._param_leaves)

        def walk(node, val):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, val[k])
            elif isinstance(node, list):
                for n, v in zip(node, val):
                    walk(n, v)
            else:
                out[node] = val

        if not self._stack_layers:
            walk(self._index, tree)
            return out
        for k, v in self._index.items():
            if k != "layers":
                walk(v, tree[k])
        for i, node in enumerate(self._index["layers"]):
            walk(node, tree["layers"] if per_leaf else
                 _tree_map(lambda x, i=i: x[i], tree["layers"]))
        return out

    def _moments_layout(self, values: List[Any],
                        per_leaf: bool = False) -> Any:
        """Optimizer values (one per floating param) in the params
        layout."""
        full: List[Any] = [None] * len(self._param_leaves)
        for i, v in zip(self._float_pos, values):
            full[i] = v
        return self._layout(full, per_leaf)

    @property
    def _clip(self) -> bool:
        """Whether the optimizer's optax chain starts with
        ``clip_by_global_norm`` (never under ZeRO++, which clips by
        hand)."""
        return bool(self.config.gradient_clipping
                    and self.config.gradient_clipping > 0
                    and not self.config.zeropp.enabled)

    def _state_tree(self, template: bool = False) -> Dict[str, Any]:
        """What a checkpoint holds: ``params``, ``opt_state`` and
        ``scaler`` in the JAX package's layout; with ``template``, leaves
        of the same shapes and dtypes on the ``meta`` device."""
        meta = ((lambda ts: [_meta(t) for t in ts]) if template
                else (lambda ts: [t.detach() for t in ts]))
        tree = {"params": self._layout(meta(self._param_leaves)),
                "opt_state": self.optimizer.state_tree(
                    lambda ts, per_leaf=False: self._moments_layout(
                        meta(ts), per_leaf), self._clip),
                "scaler": _host_scaler(self.scaler_state)}
        return _tree_map(_meta, tree) if template else tree

    @torch.no_grad()
    def load_engine_state(self, state: Dict[str, Any],
                          params: Any = None) -> None:
        """Take ``opt_state`` and ``scaler`` (the layout a checkpoint
        holds, or :func:`engine_state_from_jax`'s) and, when given,
        ``params`` in the JAX layout, copying into the engine's own
        tensors."""
        if params is not None:
            self._load_params(params)
        floats = set(self._float_pos)

        def unlayout(tree, per_leaf=False):
            vals = [v for i, v in enumerate(self._unlayout(tree, per_leaf))
                    if i in floats]
            return vals if per_leaf else self._update_shards(vals)

        self.optimizer.load_state_tree(state["opt_state"], unlayout,
                                       self._clip)
        self.scaler_state = _py_scaler(state["scaler"])

    def _update_shards(self, values: List[Any]) -> List[Any]:
        """Optimizer values, one per float leaf: under a process group a
        value of the leaf's full (per-layer) shape is cut to the part this
        rank updates (``zero.moment_spec``'s layout); others are taken as
        they are."""
        if not self.distributed:
            return values
        out = []
        for path, v in zip(self._float_paths, values):
            shape = self._full_shapes[path]
            if tuple(np.shape(v)) == shape:
                v = v[self.topology.shard_slices(shape,
                                                 self._update_specs[path])]
            out.append(v)
        return out

    @torch.no_grad()
    def _load_params(self, params: Any) -> None:
        """Params in the JAX layout into the held tensors; under a process
        group a leaf of the full (per-layer) shape is cut to this rank's
        shard."""
        srcs = self._unlayout(params)
        if self.distributed:
            srcs = [v[self.topology.shard_slices(
                self._full_shapes[p], self._specs[p])]
                if tuple(np.shape(v)) == self._full_shapes[p] else v
                for p, v in zip(self._paths, srcs)]
        for dst, src in zip(self._param_leaves, srcs):
            dst.copy_(src if isinstance(src, torch.Tensor)
                      else torch.from_numpy(np.array(src)))

    @staticmethod
    def _refuse_process_group(what: str) -> None:
        """Tag validation and resume-tag agreement across ranks (JAX
        ``engine.py:2040, 1982``) are the identity on one process; a
        process group of more is not ported."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                f"{what} across a process group is not ported yet: "
                f"ROADMAP.md, queue A.3.1 (distributed training)")

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True) -> str:
        """Save through the configured checkpoint engine (``native``, or
        ``async``, which returns after the host copy) as
        ``<save_dir>/<tag>`` (default ``global_step<N>``), then point
        ``latest`` at it and rotate (``checkpoint.keep_last_n``). Returns
        the tag's path."""
        tag = tag or f"global_step{self.global_steps}"
        self._refuse_process_group("checkpoint tag validation")
        path = os.path.join(save_dir, tag)
        meta = {"global_steps": self.global_steps,
                "micro_steps": self.micro_steps,
                "skipped_steps": self.skipped_steps,
                "config": {"zero_stage": self.zero_stage},
                "client_state": client_state or {}}
        if self._dataloader is not None and \
                hasattr(self._dataloader, "state_dict"):
            meta["dataloader"] = self._dataloader.state_dict()
        if self._sentinel is not None:
            meta["sentinel"] = self._sentinel.state_dict()
        post_commit = None
        keep = self.config.checkpoint.keep_last_n
        if keep and self._fi_rank == 0:
            from ..checkpoint.engine import rotate_checkpoints

            # rides the post-commit hook: rotation sees the new tag durable
            post_commit = lambda: rotate_checkpoints(save_dir, keep)  # noqa: E731
        self.checkpoint_engine.save(
            path, self._state_tree(), meta,
            latest_file=(os.path.join(save_dir, LATEST_FILE)
                         if save_latest else None),
            tag=tag, post_commit=post_commit)
        if self._sentinel is not None:
            # queued for last-good promotion K healthy steps from now
            self._sentinel.note_checkpoint(tag, self.global_steps, save_dir)
        logger.info("saved checkpoint %s (%s engine)", path,
                    self.checkpoint_engine.name)
        return path

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True
                        ) -> Tuple[Optional[str], Dict]:
        """Restore ``<load_dir>/<tag>``, or with no tag the newest verified
        one (``latest``'s first). A tag that verifies but tears before the
        read (``CheckpointCorruptionError``) is quarantined and the
        resolution retried; an explicit ``tag`` is never walked past.
        Returns ``(path or None, client_state)``."""
        from ..checkpoint.engine import (CheckpointCorruptionError,
                                         quarantine_tag)
        from ..monitor.monitor import resilience_counters

        while True:
            try:
                return self._load_checkpoint_once(load_dir, tag,
                                                  load_optimizer_states)
            except CheckpointCorruptionError as e:
                if tag is not None:
                    raise
                logger.warning("checkpoint %s corrupt on read (%s); "
                               "quarantining and retrying resolution",
                               e.path, e.reason)
                resilience_counters.incr("corrupt_tags_skipped")
                quarantine_tag(e.path)

    def _load_checkpoint_once(self, load_dir: str, tag: Optional[str],
                              load_optimizer_states: bool
                              ) -> Tuple[Optional[str], Dict]:
        # an async save may still be writing `latest`
        self.checkpoint_engine.wait()
        if self._fi_rank == 0:
            # a save killed before this restart left .staging-* orphans (or
            # a torn-pod tag): resume is the sweep point
            from ..checkpoint.ckpt_engine import sweep_staging_dirs

            sweep_staging_dirs(load_dir)
        if tag is None:
            tag = self._resolve_resume_tag(load_dir)
            if tag is None:
                return None, {}
        path = os.path.join(load_dir, tag)
        self._refuse_reference_format(path)
        state, meta = self.checkpoint_engine.load(
            path, self._state_tree(template=True), device=self.device)
        if load_optimizer_states:
            self.load_engine_state(state, params=state["params"])
        else:
            self._load_params(state["params"])
        del state
        self.global_steps = meta.get("global_steps", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        if self._dataloader is not None and "dataloader" in meta and \
                hasattr(self._dataloader, "load_state_dict"):
            self._dataloader.load_state_dict(meta["dataloader"])
        if self._sentinel is not None and "sentinel" in meta:
            self._sentinel.load_state_dict(meta["sentinel"])
        logger.info("loaded checkpoint %s", path)
        return path, meta.get("client_state", {})

    def _resolve_resume_tag(self, load_dir: str) -> Optional[str]:
        """The tag ``latest`` names if it verifies, else the newest that
        does (shallow: the read checks every leaf's crc32). None when
        nothing is loadable."""
        from ..checkpoint.engine import _read_latest, find_latest_valid_tag
        from ..monitor.monitor import resilience_counters

        pointed = _read_latest(load_dir)
        if pointed is not None:
            self._refuse_reference_format(os.path.join(load_dir, pointed))
        tag, skipped = find_latest_valid_tag(load_dir, deep=False)
        for skipped_tag, reason in skipped:
            logger.warning("skipping corrupt checkpoint %s: %s",
                           os.path.join(load_dir, skipped_tag), reason)
            resilience_counters.incr("corrupt_tags_skipped")
        self._refuse_process_group("resume-tag agreement")
        if tag is None:
            logger.warning("no loadable checkpoint in %s; nothing loaded",
                           load_dir)
            return None
        if tag != pointed or skipped:
            resilience_counters.incr("fallback_loads")
            logger.warning("fallback load: resuming %s (latest pointer was "
                           "%r)", os.path.join(load_dir, tag), pointed)
        return tag

    @staticmethod
    def _refuse_reference_format(path: str) -> None:
        if glob.glob(os.path.join(path, "mp_rank_*_model_states.pt")):
            raise NotImplementedError(
                f"{path} is a reference-format (mp_rank_*_model_states.pt) "
                f"checkpoint; its importer is not ported yet: ROADMAP.md, "
                f"queue A.3.5 (checkpoint formats, checkpoint/ds_import.py)")

    def save_16bit_model(self, *args, **kwargs):
        raise NotImplementedError(
            "save_16bit_model (a reference-format state dict) is not ported "
            "yet: ROADMAP.md, queue A.3.5 (checkpoint formats)")
