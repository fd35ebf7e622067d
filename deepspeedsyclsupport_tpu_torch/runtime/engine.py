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
cuts full leaves (a JAX-written state) to this rank's shards.

A custom ``loss_fn`` under a process group: a bound method of the model
(a subclass's ``loss``) is rebound to the engine's parallel view and runs
on every axis; any other runs only on the batch axes (data, fsdp, with
ZeRO 0-3, MiCS and ZeRO++), as DeepSpeed runs it: each rank calls it on
its own rows with the whole params (ZeRO-3 gathers them for the call),
and the loss is the mean of the ranks' values. That equals the JAX
engine's loss on the global batch for a loss that is a mean over rows
(each rank holds as many rows); for another it differs by design. On the
model axes (tensor, pipe, expert, seq) such a loss raises: it would run
the caller's model, which has no parallel plan, on this rank's shards.

Across ranks (A.3.3b) a checkpoint is the same single tag: every rank
gathers each leaf from its shards in the writer's order, one leaf at a
time, and rank 0 writes it (``checkpoint/engine.py``); the tag is checked
over the world first (``checkpoint.tag_validation``). A load resolves the
tag after rank 0's staging sweep, agrees it over the world (rank 0's
wins) and cuts the full leaves to each rank's shards, so a tag saved at
one world and layout loads at any other. The sentinel takes rank 0's
health scalars on every rank (one broadcast a step while armed) and so
the same decision everywhere; rank 0 writes its journal. A pending
preemption is OR-ed over the world at each step boundary while handling
is armed (``runtime/resilience.py``), so every rank saves at one step.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``, ``:1732-1980``) are
the JAX package's native format, leaf for leaf: ``params`` with the layers
stacked ``[L, ...]`` (the JAX model's ``scan_layers`` layout; the port
holds a list of layers), ``opt_state`` in optax's layout
(``_Optimizer.state_tree``) and ``scaler``, so a tag written by either
package loads in the other. The step boundary (``_post_step``, ``:1601``) feeds the
sentinel and the preemption handler (``runtime/resilience.py``);
``initialize(training_data=...)`` builds and registers a
``runtime/dataloader.py`` loader whose position rides the checkpoint meta.

Observability (JAX ``engine.py:314-361, 473-516, 1055-1182, 1401``): the
timers and the throughput timer, ``MonitorMaster`` (CSV / TensorBoard /
W&B on rank 0, JSONL on every rank), ``telemetry`` (``build_telemetry``:
the flight recorder's step spans, goodput, heartbeat, memory gauges and
textfile; an ``engine_init`` anchor after a barrier; the step watchdog
armed around each step when ``telemetry.watchdog`` is on), the
``Train/Samples/*`` events and telemetry's periodic ``Goodput/*``,
``Memory/*``, ``Compile/*``, ``Ckpt/*``, ``Health/*`` at print boundaries,
the flops profiler (``flops_profiler.profile_step`` counted op by op,
``profiling/flops_profiler.py``), ``torch.profiler`` trace windows (the
``jax_profiler`` key, ``telemetry.trace``, ``DSTPU_TRACE_START_STEP``)
and the MFU window (``telemetry.mfu``: the window under ``torch.profiler``,
priced by the first step counted op by op before it — the flops profiler's
step when that comes first, else the step just before the window;
:meth:`Engine.mfu_ledger`).

The comm census and the graph analyzers (JAX ``engine.py:1243-1360``,
``analysis/``): the engine opens the comms logger's census window around
every step (``comm/comms_logging.py``: one entry per collective call, in
HLO's conventions) and keeps the last step's, with each param and moment
tensor's storage and shape at step entry and, on a counted step, the
dtype audit riding the op counter. :meth:`Engine.graph_report`,
:meth:`Engine.emit_comm_census` and :meth:`Engine.xla_comms_summary` read
that record of the last step: there is no compiled program to read.
Offload raises ``NotImplementedError`` naming its ``ROADMAP.md`` entry.
"""
import contextlib
import copy
import dataclasses
import glob
import inspect
import json
import logging
import math
import os
import sys
import time
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
from ..monitor.mfu import region_scope
from ..utils.fault_injection import get_fault_injector
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                           STEP_GLOBAL_TIMER, SynchronizedWallClockTimer,
                           ThroughputTimer)

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
        # a loss_fn that is not the model's own, under a process group
        self._custom_loss = False
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
                self._check_custom_loss()
                self._custom_loss = True
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
        # the last step's census window and (storage, shape) of each
        # audited tensor at its entry; the last counted step's dtype audit
        self._last_census: Optional[List[Dict[str, Any]]] = None
        self._step_entry: Optional[List[Tuple[int, Tuple[int, ...]]]] = None
        self._dtype_audit = None

        # --------------------------------------------------- observability
        from ..utils.podid import pod_rank

        self._fi_rank = pod_rank()
        self._init_observability()

        # ------------------------------------------------------ resilience
        from ..checkpoint.ckpt_engine import build_checkpoint_engine

        self.checkpoint_engine = build_checkpoint_engine(
            self.config.checkpoint.engine)
        self._resilience = None   # ResilienceManager (preemption handling)
        self._dataloader = None   # registered loader (its position is saved)
        self._sentinel = None
        self._host_metrics: Optional[Dict[str, Any]] = None
        if self.config.sentinel.enabled:
            from .sentinel import TrainingSentinel

            # under a process group rank 0's journal is the pod's
            self._sentinel = TrainingSentinel(self, self.config.sentinel,
                                              rank=self._fi_rank,
                                              shared=self.distributed)
        cl = self.config.comms_logger
        comms_logger.configure(enabled=cl.enabled, verbose=cl.verbose,
                               timed=cl.timed)

    # ====================================================== observability
    def _init_observability(self) -> None:
        """Timers, monitors, telemetry, the watchdog, the flops profiler,
        the trace windows and the MFU window (JAX ``engine.py:314-361,
        473-516``)."""
        from ..monitor.monitor import MonitorMaster
        from ..monitor.telemetry import build_telemetry
        from ..profiling.flops_profiler import FlopsProfiler

        self._pending_events: List[Tuple[str, Any, int]] = []
        self._resilience_reported: Dict[str, int] = {}
        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.config.train_batch_size,
            steps_per_output=self.config.steps_per_print)
        self.monitor = MonitorMaster(self.config.monitor)
        # the flight recorder ring + rank-local JSONL, goodput, memory
        # gauges, heartbeat (monitor/telemetry.py); None when the section is
        # off and DSTPU_TELEMETRY doesn't force it
        self.telemetry = build_telemetry(self.config, self.monitor,
                                         device=self.device)
        if self.telemetry is not None:
            # barrier-anchored alignment point for cross-rank trace fusion
            # (monitor/pod.py): construction is collective under a process
            # group, so every rank stamps the same instant
            self.telemetry.anchor("engine_init")
        # the step watchdog (comm/watchdog.py): a deadline armed around each
        # step; expiry = stack dump + recorder flush + rc-218 exit
        self._watchdog = None
        tw = self.config.telemetry
        if self.telemetry is not None and tw.watchdog_enabled:
            from ..comm.watchdog import CollectiveWatchdog

            self._watchdog = CollectiveWatchdog(
                deadline_s=tw.watchdog_deadline_s,
                warmup_deadline_s=tw.watchdog_warmup_deadline_s,
                poll_s=tw.watchdog_poll_s, rank=self._fi_rank,
                telemetry=self.telemetry,
                stack_path=os.path.join(
                    tw.output_dir, f"stacks_rank{self._fi_rank}.txt"),
            ).start()
            # telemetry.close() stops the poll thread
            self.telemetry.watchdog = self._watchdog
        self.flops_profiler = FlopsProfiler(self.config.flops_profiler)
        # torch.profiler trace windows: the JAX package's ``jax_profiler``
        # section (the key kept for config compatibility), or
        # telemetry.trace, or DSTPU_TRACE_START_STEP without a config edit
        jp = dict(self.config.raw.get("jax_profiler", {}) or {})
        if tw.trace_start_step is not None and self.telemetry is not None:
            jp = {"enabled": True, "start_step": tw.trace_start_step,
                  "num_steps": tw.trace_num_steps,
                  "trace_dir": tw.trace_dir or jp.get("trace_dir")}
        env_start = os.environ.get("DSTPU_TRACE_START_STEP")
        if env_start:
            try:
                jp = {"enabled": True, "start_step": int(env_start),
                      "num_steps": int(os.environ.get(
                          "DSTPU_TRACE_NUM_STEPS", jp.get("num_steps", 3))),
                      "trace_dir": (os.environ.get("DSTPU_TRACE_DIR")
                                    or jp.get("trace_dir"))}
            except ValueError as e:
                logger.warning(
                    "ignoring malformed DSTPU_TRACE_START_STEP/"
                    "DSTPU_TRACE_NUM_STEPS (%s); no trace window armed", e)
        self._trace_cfg = jp if jp.get("enabled") else None
        self._profiler = None
        self._trace_dir: Optional[str] = None
        self._trace_origin: Optional[str] = None
        # the MFU window (telemetry.mfu): the first step counted op by op
        # before it (the flops profiler's, else the step just before) gives
        # the roofline's costs, the window runs under torch.profiler; step
        # 1 is never the window (lazy initialization runs in it)
        self._mfu_pending = bool(self.telemetry is not None
                                 and tw.mfu_enabled)
        self._mfu_first = max(int(tw.mfu_step), 2)
        self._mfu_costs = None
        self._mfu_census: Optional[List[Dict[str, Any]]] = None
        self._mfu_profiler = None
        self._mfu_window: Optional[Dict[str, Any]] = None
        self._mfu_trace_dir = os.path.join(
            tw.output_dir, f"mfu_trace_rank{self._fi_rank}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def _tracing(self) -> bool:
        return self._profiler is not None

    def _profile(self, trace_dir: str):
        """A started ``torch.profiler`` session: host ops and, on a card,
        its kernels."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def start_profile(self, trace_dir: Optional[str] = None) -> None:
        """Begin a ``torch.profiler`` capture (the JAX package's
        ``jax.profiler`` trace; Perfetto / chrome://tracing view it),
        written to ``<trace_dir>/rank<N>.trace.json.gz`` at
        :meth:`stop_profile`. Also usable manually around any region."""
        if self._tracing:
            return
        self._trace_dir = trace_dir or (self._trace_cfg or {}).get(
            "trace_dir") or os.path.join(os.getcwd(), "dstpu_traces")
        self._sync()
        self._profiler = self._profile(self._trace_dir)
        self._trace_origin = "manual"  # train_batch overrides for windows
        import atexit

        atexit.register(self.stop_profile)  # never exit with an open trace
        logger.info("torch.profiler trace started -> %s", self._trace_dir)

    def stop_profile(self) -> None:
        if not self._tracing:
            return
        import atexit

        atexit.unregister(self.stop_profile)  # a closed window pins nothing
        self._sync()
        prof, self._profiler = self._profiler, None
        prof.stop()
        path = os.path.join(self._trace_dir,
                            f"rank{self._fi_rank}.trace.json.gz")
        prof.export_chrome_trace(path)
        self._trace_origin = None
        logger.info("torch.profiler trace stopped -> %s", path)

    def _step_watch(self, stepno: int) -> Tuple[bool, bool]:
        """(count this step op by op, capture it as the MFU window). The
        flops profiler's step is counted; the MFU window needs a counted
        step before it (the profiler's, when that comes first, else the
        step just before the window) and never shares a step with a
        count."""
        count = self.flops_profiler.wants(stepno)
        capture = False
        if self._mfu_pending and not self._tracing:
            if self._mfu_costs is None:
                count = count or stepno >= self._mfu_first - 1
            elif stepno >= self._mfu_first and not count:
                capture = True
        return count, capture

    def _counted(self, counter, stepno: int) -> None:
        if self.flops_profiler.wants(stepno):
            self.flops_profiler.record(counter, stepno, self._leaf_tensors)
        if self._mfu_pending and self._mfu_costs is None:
            self._mfu_costs = counter
            self._mfu_census = self._last_census
        self._dtype_audit = counter.observers[0]

    def _finish_mfu_window(self, stepno: int, t_step: float) -> float:
        """Close the MFU window: sync (its step wall is the synced one),
        stop the profiler and write its trace. Returns the step's wall."""
        try:
            self._sync()
        finally:
            dur = time.perf_counter() - t_step
            prof, self._mfu_profiler = self._mfu_profiler, None
            prof.stop()
        path = os.path.join(self._mfu_trace_dir,
                            f"mfu_rank{self._fi_rank}.trace.json.gz")
        prof.export_chrome_trace(path)
        self._mfu_pending = False
        self._mfu_window = {"step": stepno, "step_s": dur, "steps": 1,
                            "trace_dir": self._mfu_trace_dir}
        if self.telemetry is not None:
            self.telemetry.recorder.record(
                "event", "mfu/window", step=stepno,
                data={"step_s": dur, "steps": 1,
                      "trace_dir": self._mfu_trace_dir})
        return dur

    def mfu_ledger(self, spec: Any = None, persist: bool = True
                   ) -> Dict[str, Any]:
        """The step-time attribution ledger (JAX ``engine.py:1401``):
        joins (1) the roofline partition of the counted step's aten ops
        into named regions (``analysis/roofline.py``), priced against the
        device's peak spec, and (2) the MFU window's kernels, each
        attributed to the region of the host code that launched it
        (``monitor/mfu.py``). Emits the ``MFU/*`` events, writes the
        artifacts next to the trace (opmap, roofline, window, ledger JSON)
        and returns the ledger dict. Raises when no window was captured,
        and when the window's trace holds no kernel (a CPU engine, or a
        profiler that recorded no device activity): a ledger of host ops
        would not say where the card's time went."""
        from ..monitor import mfu as mfu_mod

        if self._mfu_window is None or self._mfu_costs is None:
            raise RuntimeError(
                "no MFU trace window captured — enable telemetry.mfu "
                '({"telemetry": {"enabled": true, "mfu": {"enabled": '
                'true}}}) and run past telemetry.mfu.step (and step 2)')
        w = self._mfu_window
        trace_path = mfu_mod.find_trace(w["trace_dir"])
        if trace_path is None:
            raise RuntimeError(f"no trace file under {w['trace_dir']} — "
                               f"the profiler produced no artifacts")
        events, meta = mfu_mod.parse_trace(trace_path)
        opmap = mfu_mod.build_opmap(events)
        if not opmap:
            raise RuntimeError(
                f"the MFU window's trace ({trace_path}) holds no kernel "
                f"events: the profiler recorded no device activity "
                f"(engine on {self.device}); the ledger attributes the "
                f"card's time and has none to attribute")
        table = self._mfu_roofline(spec)
        measured = mfu_mod.measure_regions(mfu_mod.op_events(events), opmap,
                                           steps=w.get("steps", 1))
        led = mfu_mod.ledger(table, measured, w["step_s"],
                             truncated_trace=meta["truncated"])
        led["window"] = {"step": w["step"], "trace_path": trace_path}
        if persist:
            for fname, payload in (("mfu_opmap.json", opmap),
                                   ("mfu_roofline.json", table),
                                   ("mfu_window.json", w),
                                   ("mfu_ledger.json", led)):
                try:
                    with open(os.path.join(w["trace_dir"], fname),
                              "w") as f:
                        json.dump(payload, f)
                except (OSError, TypeError, ValueError) as e:
                    logger.warning("mfu artifact %s not written: %s",
                                   fname, e)
        if self.telemetry is not None:
            self.telemetry.recorder.record(
                "event", "mfu/ledger", step=w["step"],
                data={k: led[k] for k in
                      ("achieved_mfu", "roofline_mfu", "step_s",
                       "device_busy_s", "top_sinks")})
        if self.monitor.enabled:
            self.monitor.write_events(
                mfu_mod.ledger_events(led, step=w["step"]))
        return led

    # ================================================== census and analyzers
    def _audited(self) -> List[Tuple[str, torch.Tensor]]:
        """The state a step updates in place: each param (the float32
        master) and each of the optimizer's per-leaf tensor lists (its
        moments), named ``<list>/<leaf path>``."""
        paths = self._grad_paths
        named = [(f"params/{p}", t) for p, t in zip(paths,
                                                     self._leaf_tensors)]
        for attr, v in sorted(vars(self.optimizer).items()):
            if attr != "params" and isinstance(v, list) and \
                    len(v) == len(paths) and \
                    all(isinstance(x, torch.Tensor) for x in v):
                named += [(f"{attr}/{p}", x) for p, x in zip(paths, v)]
        return named

    def _open_census(self) -> None:
        """A step starts: open the comms logger's census window and note
        each audited tensor's storage and shape."""
        comms_logger.open_window()
        self._step_entry = [(t.untyped_storage().data_ptr(), tuple(t.shape))
                            for _, t in self._audited()]

    def xla_comms_summary(self, log: bool = True,
                          show_straggler: bool = False) -> Dict[str, Dict]:
        """The last step's collectives by opcode (JAX ``engine.py:1243``,
        ``{opcode: {count, total_bytes, example_shape, group_size}}``),
        merged into ``comms_logger`` under ``xla::<op>[train_step]`` keys
        (the JAX package's, so that the next dump's ``comm/snapshot``
        carries them to the pod report). Reads the façade's record of the
        last step (``comm/hlo_comms.py``), not a compiled program.
        ``show_straggler`` is collective: every rank calls it."""
        if not comms_logger.enabled or self._last_census is None:
            raise RuntimeError(
                "run train_batch() with comms_logger enabled first "
                "(config comms_logger.enabled: true)")
        from ..comm.hlo_comms import summarize_collectives

        summary = summarize_collectives(self._last_census)
        comms_logger.record_hlo(summary, tag="train_step")
        if log:
            comms_logger.log_summary(show_straggler=show_straggler)
        return summary

    def emit_comm_census(self) -> Dict[str, Any]:
        """Classify the last step's collectives into traffic classes
        (``analysis/collectives.py``) and persist the class summary as a
        ``comm/census`` flight-recorder event — the static half of the pod
        report's bytes/time/bandwidth join (``monitor/pod.py``). With
        ``comms_logger`` enabled the per-opcode mix is merged too
        (:meth:`xla_comms_summary`), so the next dump's ``comm/snapshot``
        carries it: the pod report's cross-check, which here reads the
        same record and so always matches. Returns the payload (JAX
        ``engine.py:1269``'s keys). Reads the façade's record of the last
        step, not a compiled program."""
        report = self.graph_report(analyzers=("collectives",))
        payload: Dict[str, Any] = {
            "classes": report["collectives"].classes.summary(),
            "group_size": report["collectives"].expectation.group_size,
            "n_devices": (self.topology.world_size() if self.distributed
                          else 1),
            "zero_stage": self.zero_stage,
        }
        if comms_logger.enabled:
            self.xla_comms_summary(log=False)
        if self.telemetry is not None:
            self.telemetry.record_census(payload)
        return payload

    GRAPH_ANALYZERS = ("collectives", "donation", "resharding", "dtype")

    def graph_report(self, gathers_per_param: Optional[int] = None,
                     analyzers: Tuple[str, ...] = GRAPH_ANALYZERS,
                     ) -> Dict[str, Any]:
        """The analyzers of ``analysis/`` over the last step (JAX
        ``engine.py:1295``, the same keys): ``census`` and ``collectives``
        (the census against the analytic expectation, ``exact=False`` as
        in the JAX package), ``donation`` (every param and moment tensor
        updated in place), ``resharding`` (each leaf the shard its spec
        says at step entry, and no unattributed gather or all-to-all) and
        ``dtype`` (activation-shaped upcasts of the last step counted op by
        op: ``flops_profiler`` or ``telemetry.mfu``). Reads the façade's
        record of the last step, not a compiled program; raises before a
        step has run.

        ``gathers_per_param`` defaults from the port's ZeRO-3 schedule: a
        leaf is gathered in each micro-batch's forward and again for its
        backward (recomputed or re-gathered), ``2 ×
        gradient_accumulation_steps``; a ceiling, as ``exact=False`` reads
        it (a leaf the backward does not read, the embedding, is gathered
        once)."""
        from ..analysis import (abstract_params, check_collectives,
                                collective_census, donation_audit,
                                expected_train_collectives, resharding_audit)
        from ..analysis.donation import storage_snapshot

        if self._last_census is None or self._step_entry is None:
            raise RuntimeError("run train_batch() first")
        if gathers_per_param is None:
            gathers_per_param = 2 * self.gradient_accumulation_steps() \
                if self.zero_stage >= 3 else 1
        params = abstract_params(self)
        specs = getattr(self, "_specs", None)
        report: Dict[str, Any] = {}
        if "collectives" in analyzers or "resharding" in analyzers:
            report["census"] = collective_census(self._last_census)
        if "collectives" in analyzers:
            expectation = expected_train_collectives(
                params, self.topology, self.zero_stage,
                param_shardings=specs, gathers_per_param=gathers_per_param)
            report["collectives"] = check_collectives(
                report["census"], expectation, params, specs, exact=False)
        if "donation" in analyzers:
            named = self._audited()
            after = storage_snapshot(named)
            before = {p: dict(after[p], ptr=ptr) for (p, _), (ptr, _) in
                      zip(named, self._step_entry)} \
                if len(named) == len(self._step_entry) else {}
            report["donation"] = donation_audit(before, after)
        if "resharding" in analyzers:
            given = [shape for _, shape in
                     self._step_entry[:len(self._leaf_tensors)]]
            wanted = [tuple(t.shape) for t in self._leaf_tensors]
            update_specs = specs
            if specs is not None:
                wanted = [self.topology.shard_shape(self._full_shapes[p],
                                                    specs[p])
                          for p in self._float_paths]
                # stages 1-2 all-gather each updated fsdp shard: a leaf
                # split over fsdp for its update is a sharded param here
                update_specs = {p: tuple(
                    tuple(sorted(set(a) | set(b))) for a, b in zip(
                        s, self._update_specs[p]))
                    for p, s in specs.items()}
            report["resharding"] = resharding_audit(
                census=report["census"], params=params,
                param_shardings=update_specs, given_in_shardings=given,
                wanted_in_shardings=wanted)
        if "dtype" in analyzers:
            if self._dtype_audit is None:
                raise RuntimeError(
                    "the dtype audit rides a step counted op by op: enable "
                    "flops_profiler (profile_step) or telemetry.mfu")
            shapes = {tuple(s.shape) for _, s in _leaves(params)}
            shapes |= {tuple(t.shape) for t in self._leaf_tensors}
            report["dtype"] = self._dtype_audit.report(allowed_shapes=shapes)
        return report

    def _mfu_roofline(self, spec: Any = None) -> Dict[str, Any]:
        """The MFU window's roofline table: the counted step's region
        costs, and its comm census's bytes in the ``collective`` region
        (JAX ``engine.py:1439-1442``). Under a process group the census
        replaces the op counter's own count of the ``c10d`` calls there
        (the same calls, counted by operand): the region is the census, as
        in the JAX ledger."""
        from ..analysis import roofline

        if self._mfu_costs is None:
            raise RuntimeError("no counted step for the MFU roofline — "
                               "enable telemetry.mfu")
        costs = roofline.region_costs(self._mfu_costs)
        census_bytes = None
        if self.distributed:
            costs["collective"]["comm_bytes"] = 0.0
            census_bytes = sum(e["bytes"] for e in self._mfu_census or ())
        spec = spec or roofline.device_spec(self.device)
        return roofline.roofline_table(costs, spec,
                                       census_bytes=census_bytes)

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
            tables = [("vocabulary", cfg.vocab_size)]
            if cfg.pos_embed == "learned":
                tables.append(("learned position table",
                               cfg.max_seq_len + cfg.pos_embed_offset))
            for what, rows in tables:
                if rows % tp:
                    # the plan would leave the table whole, and the
                    # vocab-parallel lookup and loss read it as a shard
                    raise ValueError(
                        f"tensor parallelism {tp} must divide the {rows} "
                        f"rows of the {what}: the port splits it over "
                        f"'model' (pad it to a multiple of {tp}, as 50304 "
                        f"for gpt2's 50257)")
        return ParallelPlan(tp=tp, batch_axes=self._batch_axes, ep=ep)

    def _check_custom_loss(self) -> None:
        """A custom ``loss_fn`` under a process group runs on the batch
        axes only (module docstring)."""
        sizes = self.topology.axis_sizes
        model_axes = [a for a in ("model", "pipe", "expert", "seq")
                      if sizes[a] > 1]
        if model_axes:
            raise NotImplementedError(
                f"a custom loss_fn under tensor, pipeline, expert or "
                f"sequence parallelism (mesh axes {model_axes} > 1) must be "
                f"a bound method of the model (a subclass's loss), which the "
                f"engine rebinds to its parallel view: a closure over the "
                f"caller's model would run that model, which has no parallel "
                f"plan, on this rank's shards. On the batch axes (data, "
                f"fsdp) any loss_fn runs: each rank's value on its own rows, "
                f"averaged over the ranks")

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

        def call(p):
            return (self.loss_fn_raw(p, batch, rng, train=train)
                    if self._loss_accepts_train
                    else self.loss_fn_raw(p, batch, rng))

        # a custom loss takes this rank's rows and the whole params, and
        # returns its share of the mean over the batch ranks (ZeRO++'s
        # gathered step means the ranks' local values itself)
        share = self._custom_loss and not gathered
        out = zero_lib.run_gathered(p, call) if share else call(p)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        loss, metrics = loss.float(), dict(metrics)
        if share:
            n = float(self.dp_world_size)
            loss = loss / n
            metrics = {k: v / n for k, v in metrics.items()}
        return loss, metrics

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
    def _apply_grads_dist(self, grads: List[torch.Tensor],
                          loss: Optional[torch.Tensor] = None,
                          gate: Optional[np.ndarray] = None
                          ) -> Dict[str, Any]:
        """:meth:`_apply_grads` over this rank's update shards: the global
        norm from each leaf's owner (one all-reduce over the world), the
        fp16 verdict agreed over the world, then clip, update, and (stages
        1-2) the updated shards all-gathered into the held params.

        ``gate`` (the sentinel's, with the step's global mean ``loss``)
        arms the health gate as on one card: the region norms join the
        norm's all-reduce, and rank 0's host scalars are broadcast, so
        every rank gates, and its sentinel decides, on the same bits."""
        everyone = tuple(self.topology.axis_sizes)
        health: Dict[str, Any] = {}
        if gate is not None and float(gate[1]) != 1.0 and grads:
            torch._foreach_mul_(grads, float(gate[1]))
        unscale_grads(grads, self.scaler_state)
        norms = torch._foreach_norm(grads) if grads else []
        own = [n for n, o in zip(norms, self._owner) if o]
        local = torch.linalg.vector_norm(torch.stack(own)) if own \
            else torch.zeros((), device=self.device)
        if gate is not None:
            grad_norm, finite_h, apply, health = self._dist_gate(
                grads, norms, local, loss, gate, everyone)
            finite = torch.tensor(finite_h, device=self.device)
        elif self.fp16_enabled:
            grad_norm = comm.all_reduce(local * local, everyone).sqrt()
            ok = grads_finite(grads).float() if grads else \
                torch.ones((), device=self.device)
            finite = comm.all_reduce(ok, everyone, op="min") > 0
            finite_h = apply = bool(finite)
        else:
            grad_norm = comm.all_reduce(local * local, everyone).sqrt()
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
        return {**health, "grad_norm": grad_norm, "finite": finite,
                "loss_scale": self.scaler_state.scale}

    def _dist_gate(self, grads, norms, local, loss, gate, everyone):
        """The sentinel's gate across ranks: ``(grad_norm, finite, apply,
        health)``.
        Each region's squared norm over this rank's owned shards rides the
        grad norm's all-reduce; rank 0's ``[loss_ok, loss, grad_norm,
        region norms]`` is broadcast to every rank; the nonfinite count
        (owned elements, an exact integer sum) only when the norm is not
        finite. Sets ``self._host_metrics`` as :meth:`_apply_grads`."""
        from .sentinel import nonfinite_count, region_of_param

        regions = sorted({region_of_param(p) for p in self._grad_paths})
        sq = torch.zeros(1 + len(regions), device=self.device)
        sq[0] = local * local
        for path, n, o in zip(self._grad_paths, norms, self._owner):
            if o:
                i = 1 + regions.index(region_of_param(path))
                sq[i] = sq[i] + n.float() * n.float()
        sq = comm.all_reduce(sq, everyone)
        grad_norm = sq[0].sqrt()
        vec = torch.stack([(loss <= float(gate[0])).float(), loss,
                           grad_norm, *sq[1:].sqrt()])
        vec = comm.broadcast(vec, everyone, src=0)
        keys = ("loss_ok", "loss", "grad_norm",
                *(f"health_rn_{r}" for r in regions))
        host = dict(zip(keys, vec.tolist()))
        nonfinite = 0
        if not math.isfinite(host["grad_norm"]):
            own = [g for g, o in zip(grads, self._owner) if o]
            count = nonfinite_count(own).to(self.device, torch.float64) \
                if own else torch.zeros((), dtype=torch.float64,
                                        device=self.device)
            nonfinite = int(comm.all_reduce(count, everyone))
        finite_h = nonfinite == 0
        apply = finite_h and host.pop("loss_ok") > 0
        health = {k: vec[3 + i] for i, k in enumerate(keys[3:])}
        health["health_nonfinite"] = torch.tensor(
            nonfinite, dtype=torch.int32, device=self.device)
        self._host_metrics = dict(host, finite=finite_h,
                                  health_nonfinite=nonfinite)
        return grad_norm, finite_h, apply, health

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
        stepno = self.global_steps + 1
        fi = get_fault_injector()
        if fi.armed:
            # a rank that never arrives at the step's collectives
            fi.maybe_hang_step(self._fi_rank, stepno)
            # numerical fault: poison the data of step global_steps + 1
            batch = fi.corrupt_batch(self._fi_rank, stepno, batch)
        gate = self._sentinel.gate_array() if self._sentinel is not None \
            else None
        if self._trace_cfg is not None and not self._tracing and \
                self.global_steps == int(self._trace_cfg.get("start_step",
                                                             1)):
            self.start_profile()
            self._trace_origin = "config"
        self.tput_timer.start()
        count, capture = self._step_watch(stepno)
        counter = None
        if count:
            from ..analysis.dtype_audit import DtypeAudit
            from ..profiling.flops_profiler import OpCounter

            counter = OpCounter()
            counter.observers.append(DtypeAudit())
        if capture:
            # the window holds exactly this step: the card's queue drained
            # first, so earlier steps' kernels stay out of it
            self._sync()
            self._mfu_profiler = self._profile(self._mfu_trace_dir)
        if self._watchdog is not None:
            self._watchdog.arm(stepno)
        t_step = time.perf_counter()
        try:
            if fi.armed:
                # a rank that arrived (armed) and wedged inside the step:
                # its own watchdog fires
                fi.maybe_hang_step(self._fi_rank, stepno, phase="in")
            self._open_census()
            with counter if counter is not None else contextlib.nullcontext():
                out = self._train_step(batch, gas, gate)
            if comms_logger.enabled:
                # opt-in: the straggler columns' wall-clock is the synced
                # step's (JAX engine.py:1138-1144)
                self._sync()
                comms_logger.record_wall("train_batch",
                                         time.perf_counter() - t_step)
            elif self.telemetry is not None and \
                    self.telemetry.cfg.sync_timing:
                self._sync()   # device-accurate step spans
        finally:
            self._last_census = comms_logger.close_window()
            if self._watchdog is not None:
                self._watchdog.disarm(stepno)
            if capture and sys.exc_info()[0] is not None:
                # an exception mid-step: close the profiler session
                prof, self._mfu_profiler = self._mfu_profiler, None
                prof.stop()
                capture = False
        step_dur = time.perf_counter() - t_step
        if capture:
            step_dur = self._finish_mfu_window(stepno, t_step)
        self.global_steps += 1
        self.micro_steps += gas
        if counter is not None:
            self._counted(counter, stepno)
        if self.telemetry is not None:
            # step span, goodput, heartbeat, textfile, memory gauges
            self.telemetry.on_step_end(self.global_steps, step_dur,
                                       batch=batch)
        if self._tracing and self._trace_origin == "config":
            start = int(self._trace_cfg.get("start_step", 1))
            if self.global_steps >= start + int(
                    self._trace_cfg.get("num_steps", 3)):
                self.stop_profile()
        self._log(out)
        self._post_step(out)
        if fi.armed:
            rc = fi.should_kill(self._fi_rank, self.global_steps)
            if rc is not None:
                # a crash, not a preemption: no save, no cleanup
                logger.error("fault injection: rank %d dying with rc=%d "
                             "after step %d", self._fi_rank, rc,
                             self.global_steps)
                if self.telemetry is not None:
                    try:
                        self.telemetry.dump("injected_kill")
                    except Exception:
                        pass
                os._exit(rc)
        return out

    def _train_step(self, batch: Dict[str, torch.Tensor], gas: int,
                    gate: Optional[np.ndarray]) -> Dict[str, Any]:
        """The step's work: every micro-batch's forward and backward, the
        gradient reduction and the update; returns the step's outputs."""
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
        with region_scope("optimizer"):
            out.update(self._apply_grads_dist(grads, loss=loss, gate=gate)
                       if self.distributed
                       else self._apply_grads(grads, loss=loss, gate=gate))
        out["loss"] = loss
        self._zero_grads()
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
        self.timers(FORWARD_GLOBAL_TIMER).start()
        if self._accum_count == 0 and self._pending is None:
            self._open_census()
        batch = self._rank_rows(self._to_device(batch),
                                self.config.train_micro_batch_size_per_gpu)
        loss, _ = self._loss_and_metrics(self.params, batch)
        self._pending = loss
        self.losses = loss.detach()
        self.timers(FORWARD_GLOBAL_TIMER).stop()
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
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        if self._accum_count == 0:
            self._zero_grads()
        pending, self._pending = self._pending, None
        scale_loss(pending, self.scaler_state).backward()
        self._accum_losses.append(pending.detach())
        self._accum_count += 1
        self.micro_steps += 1
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return pending.detach()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._accum_count >= self.config.gradient_accumulation_steps

    def step(self) -> Dict[str, Any]:
        """Apply the accumulated grads, averaged over the micro-batches
        (reference ``engine.step``)."""
        if self._accum_count == 0:
            raise RuntimeError("step() before backward()")
        self.timers(STEP_GLOBAL_TIMER).start()
        grads = self._grads()
        losses = self._accum_losses
        if self.distributed:
            grads = self._reduce_grads(grads)
            losses = self._global_sum(losses)
        if self._accum_count > 1:
            torch._foreach_div_(grads, float(self._accum_count))
        with region_scope("optimizer"):
            out = self._apply_grads_dist(grads) if self.distributed \
                else self._apply_grads(grads)
        out["loss"] = torch.stack(losses).mean()
        self._last_census = comms_logger.close_window()
        self._zero_grads()
        self._accum_count = 0
        self._accum_losses = []
        self.timers(STEP_GLOBAL_TIMER).stop()
        self.global_steps += 1
        if self.telemetry is not None:
            # eager-path step span: boundary-to-boundary wall (dur=None)
            self.telemetry.on_step_end(self.global_steps)
        self._log(out)
        self._post_step(out)
        return out

    def _post_step(self, out: Dict[str, Any]) -> None:
        """The step boundary (``engine.py:1601``): the throughput timer;
        the monitors' ``Train/Samples/*`` events buffered as device scalars
        and written (one host read) at print boundaries with the
        ``Resilience/*`` and telemetry's periodic events; the timers'
        breakdown (``wall_clock_breakdown``); the sentinel queues this
        step's scalars (and decides the ones ``lag`` steps old); a pending
        preemption saves and exits here, where nothing is in flight."""
        self.tput_timer.stop(report_speed=True)
        at_print = self.global_steps % self.config.steps_per_print == 0
        if self.monitor.enabled:
            samples = self.global_steps * self.config.train_batch_size
            ev = [("Train/Samples/train_loss", out["loss"], samples)
                  ] if "loss" in out else []
            ev.append(("Train/Samples/lr", ("__lr__", self.global_steps),
                       samples))
            if self.fp16_enabled:
                ev.append(("Train/Samples/loss_scale", out["loss_scale"],
                           samples))
            self._pending_events.extend(ev)
            if at_print:
                self._flush_monitor()
        if self.config.wall_clock_breakdown and at_print:
            self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER,
                             STEP_GLOBAL_TIMER])
        if self._sentinel is not None:
            # the gate's host copy of the scalars when the step had one (no
            # second read), else the device metrics
            host, self._host_metrics = self._host_metrics, None
            self._sentinel.at_step_boundary(self.global_steps, host or out)
        if self._resilience is not None:
            self._resilience.at_step_boundary()

    def _flush_monitor(self) -> None:
        """Write the buffered events (each device scalar read here), the
        changed resilience counters and telemetry's periodic events."""
        events = []
        for name, val, samples in self._pending_events:
            if isinstance(val, tuple) and val[0] == "__lr__":
                val = self.lr_schedule(val[1])
            events.append((name, float(val), samples))
        self._pending_events = []
        from ..monitor.monitor import resilience_counters

        samples = self.global_steps * self.config.train_batch_size
        for name, value in resilience_counters.snapshot().items():
            if value and value != self._resilience_reported.get(name):
                self._resilience_reported[name] = value
                events.append((f"Resilience/{name}", value, samples))
        if self.telemetry is not None:
            # Goodput/*, Memory/*, Compile/*, Ckpt/*, Health/*
            events.extend(self.telemetry.periodic_events(samples))
        if comms_logger.enabled:
            events.extend(comms_logger.summary_events(samples))
        if events:
            self.monitor.write_events(events)

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
    def _layout(self, values: List[Any], per_leaf: bool = False,
                specs: Optional[Dict[Tuple, Tuple]] = None,
                layers: Optional[int] = None) -> Any:
        """One value per param leaf (None drops it) -> the JAX package's
        params tree. Stacked layer leaves are callables that stack when the
        writer reaches them, so one stacked leaf at a time is held; with
        ``per_leaf`` the values are each leaf's scalar (equal over a stacked
        leaf's layers) and a stacked leaf takes its first layer's.

        ``specs`` (under a process group): each value is this rank's shard,
        laid out by ``specs[path]``; every leaf is a callable that gathers
        it whole (a collective: every rank calls it, in the writer's order),
        a stacked leaf's layers over ``pipe`` too. ``layers``: the stacked
        leaves of meta values lead with that many layers (a template of the
        whole pipeline's)."""
        def leaf(i):
            v = values[i]
            if v is None or per_leaf or specs is None:
                return v
            return lambda: self._whole(v, specs[self._paths[i]])

        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if isinstance(node, list):
                return [build(v) for v in node]
            return leaf(node)

        if not self._stack_layers:
            return build(self._index)
        out = {k: build(v) for k, v in self._index.items() if k != "layers"}

        def stack(node, path):
            if isinstance(node, dict):
                return {k: stack(v, path + (k,)) for k, v in node.items()}
            idx = [_get(layer, path) for layer in block]
            parts = [values[i] for i in idx]
            if parts[0] is None or per_leaf:
                return parts[0]
            if specs is not None:
                return lambda: self._whole_layers(
                    parts, [specs[self._paths[i]] for i in idx])
            if layers is not None:
                return torch.empty((layers,) + tuple(parts[0].shape),
                                   dtype=parts[0].dtype, device="meta")
            return lambda: torch.stack(parts)

        block = self._index["layers"]
        out["layers"] = stack(block[0], ())
        return out

    def _whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole leaf from this rank's shard ``t`` laid out by
        ``spec``: all-gathered over each dim's axes (a collective)."""
        t = t.detach()
        for d, entry in enumerate(spec):
            if entry and self.topology.axis_size(entry) > 1:
                t = comm.all_gather(t.contiguous(), entry, axis=d)
        return t

    def _whole_layers(self, parts, specs) -> torch.Tensor:
        """A stacked leaf ``[L, ...]``: this stage's layers, each gathered
        whole, then every stage's block over ``pipe`` in stage order."""
        x = torch.stack([self._whole(t, sp) for t, sp in zip(parts, specs)])
        if self._pipelined:
            x = comm.all_gather(x.contiguous(), "pipe", axis=0)
        return x

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
        n, first = len(self._index["layers"]), self._stage_first_layer()

        def layer(x, i):
            # a whole pipeline's stacked leaf, or this stage's block
            return x[first + i] if len(x) > n else x[i]

        for i, node in enumerate(self._index["layers"]):
            walk(node, tree["layers"] if per_leaf else
                 _tree_map(lambda x, i=i: layer(x, i), tree["layers"]))
        return out

    def _stage_first_layer(self) -> int:
        """The global index of this rank's first layer (0 without a
        pipeline)."""
        if not self._pipelined:
            return 0
        return self.topology.axis_index("pipe") * len(self._index["layers"])

    def _moments_layout(self, values: List[Any],
                        per_leaf: bool = False, **kw) -> Any:
        """Optimizer values (one per floating param) in the params
        layout (``kw``: :meth:`_layout`'s)."""
        full: List[Any] = [None] * len(self._param_leaves)
        for i, v in zip(self._float_pos, values):
            full[i] = v
        return self._layout(full, per_leaf, **kw)

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
        of the same shapes and dtypes on the ``meta`` device. Under a
        process group the leaves are whole: each a collective gather of
        this rank's shards (:meth:`_layout`), and a template's shapes the
        whole model's."""
        if not self.distributed:
            meta = ((lambda ts: [_meta(t) for t in ts]) if template
                    else (lambda ts: [t.detach() for t in ts]))
            tree = {"params": self._layout(meta(self._param_leaves)),
                    "opt_state": self.optimizer.state_tree(
                        lambda ts, per_leaf=False: self._moments_layout(
                            meta(ts), per_leaf), self._clip),
                    "scaler": _host_scaler(self.scaler_state)}
            return _tree_map(_meta, tree) if template else tree
        if self._pipelined and not self._stack_layers:
            raise NotImplementedError(
                "a pipeline's checkpoint is written in the stacked [L, ...] "
                "layout: the model's config needs scan_layers")
        if not template:
            upd = {p: self._update_specs[p] for p in self._float_paths}
            return {"params": self._layout(self._param_leaves,
                                           specs=self._specs),
                    "opt_state": self.optimizer.state_tree(
                        lambda ts, per_leaf=False: self._moments_layout(
                            ts, per_leaf, specs=upd), self._clip),
                    "scaler": _host_scaler(self.scaler_state)}
        # the whole model's shapes: each held leaf's full per-layer shape,
        # a stacked leaf every stage's layers
        n_layers = len(self._index["layers"]) * \
            self.topology.axis_sizes["pipe"] if self._stack_layers else None

        def whole(ts, paths):
            return [torch.empty(self._full_shapes[p], dtype=t.dtype,
                                device="meta") if isinstance(t, torch.Tensor)
                    else _meta(t) for t, p in zip(ts, paths)]

        tree = {"params": self._layout(whole(self._param_leaves, self._paths),
                                       layers=n_layers),
                "opt_state": self.optimizer.state_tree(
                    lambda ts, per_leaf=False: self._moments_layout(
                        [_meta(t) for t in ts] if per_leaf else
                        whole(ts, self._float_paths), per_leaf,
                        layers=n_layers), self._clip),
                "scaler": _host_scaler(self.scaler_state)}
        return _tree_map(_meta, tree)

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

    def _validate_tag(self, tag: str) -> None:
        """The tag agreed over the ranks before a save (JAX
        ``engine.py:2040``): the crc32 of the tag mod 2^16 summed over the
        world in one all-reduce; a sum other than the world times this
        rank's value means the tags differ (``Fail`` raises on every rank,
        ``Warn`` logs, ``Ignore`` skips the collective). One process:
        nothing to compare."""
        mode = self.config.checkpoint.tag_validation
        if mode == "Ignore" or not self.distributed:
            return
        import zlib

        h = float(zlib.crc32(tag.encode()) % (2 ** 16))
        total = comm.all_reduce(torch.tensor(
            [h], dtype=torch.float64, device=self.device),
            tuple(self.topology.axis_sizes))
        if float(total[0]) != h * self.topology.world_size():
            msg = f"checkpoint tag {tag!r} differs across ranks"
            if mode == "Fail":
                raise RuntimeError(msg)
            logger.warning(msg)

    # one slot a rank: the agreement's collective has a static shape, so a
    # tag is padded or cut to this many bytes
    _TAG_AGREE_BYTES = 256

    def _agree_resume_tag(self, tag: Optional[str]) -> Optional[str]:
        """Every rank's resolved resume tag all-gathered; every rank adopts
        rank 0's (JAX ``engine.py:1980-2008``). Ranks resolve over one
        shared directory, so they usually agree, but a save or quarantine
        racing a restart can split them, and ranks resuming different steps
        diverge for good. The gather is also the resume barrier. One
        process: the identity."""
        if not self.distributed or self.topology.world_size() == 1:
            return tag
        buf = torch.zeros(self._TAG_AGREE_BYTES, dtype=torch.int32)
        enc = (tag or "").encode()[:self._TAG_AGREE_BYTES]
        buf[:len(enc)] = torch.tensor(list(enc), dtype=torch.int32)
        rows = comm.all_gather(buf.to(self.device),
                               tuple(self.topology.axis_sizes), tiled=False)
        first = rows.reshape(self.topology.world_size(), -1)[0].cpu()
        agreed = bytes(int(c) for c in first if c).decode() or None
        if agreed != tag:
            from ..monitor.monitor import resilience_counters

            logger.warning(
                "resume-tag divergence: this rank resolved %r but the pod "
                "agreed on rank 0's %r; adopting the pod's choice", tag,
                agreed)
            resilience_counters.incr("fallback_loads")
        return agreed

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True) -> str:
        """Save through the configured checkpoint engine (``native``, or
        ``async``, which returns after the host copy) as
        ``<save_dir>/<tag>`` (default ``global_step<N>``), then point
        ``latest`` at it and rotate (``checkpoint.keep_last_n``). Returns
        the tag's path. Under a process group every rank calls it (the
        leaves' gathers are collectives) with the same ``save_dir``; rank
        0 writes the tag, ``latest`` and the rotation."""
        if self.telemetry is not None:
            with self.telemetry.ckpt_span("save", step=self.global_steps):
                return self._save_checkpoint_impl(save_dir, tag,
                                                  client_state, save_latest)
        return self._save_checkpoint_impl(save_dir, tag, client_state,
                                          save_latest)

    def _save_checkpoint_impl(self, save_dir: str, tag: Optional[str],
                              client_state: Optional[Dict],
                              save_latest: bool) -> str:
        tag = tag or f"global_step{self.global_steps}"
        self._validate_tag(tag)
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
                # every rank read the same bytes; rank 0 renames the tag
                if self._fi_rank == 0:
                    quarantine_tag(e.path)

    def _load_checkpoint_once(self, load_dir: str, tag: Optional[str],
                              load_optimizer_states: bool
                              ) -> Tuple[Optional[str], Dict]:
        # an async save may still be writing `latest` (a collective under a
        # process group)
        self.checkpoint_engine.wait()
        if self._fi_rank == 0:
            # a save killed before this restart left .staging-* orphans (or
            # a torn-pod tag): resume is the sweep point
            from ..checkpoint.ckpt_engine import sweep_staging_dirs

            sweep_staging_dirs(load_dir)
        if self.distributed:
            # no rank lists the tags while rank 0's sweep renames them
            comm.barrier()
        if tag is None:
            tag = self._resolve_resume_tag(load_dir)
            if tag is None:
                return None, {}
        path = os.path.join(load_dir, tag)
        self._refuse_reference_format(path)
        # under a process group every rank reads the whole leaves into host
        # memory and keeps its shards of them
        state, meta = self.checkpoint_engine.load(
            path, self._state_tree(template=True),
            device="cpu" if self.distributed else self.device)
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
        does (shallow: the read checks every leaf's crc32), agreed over the
        ranks (:meth:`_agree_resume_tag`). None when nothing is
        loadable."""
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
        tag = self._agree_resume_tag(tag)
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
