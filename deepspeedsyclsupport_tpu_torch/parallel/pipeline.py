"""Pipeline parallelism over the ``pipe`` mesh axis.

Port of ``deepspeedsyclsupport_tpu/parallel/pipeline.py``: the instruction
classes, :class:`PipeSchedule` / :class:`InferenceSchedule` /
:class:`TrainSchedule` (the reference's ``runtime/pipe/schedule.py``),
:func:`partition_balanced` / :func:`partition_uniform` and
:class:`PipelineModule` (uniform partitioning only), with the JAX names.

The execution is where the port departs from the JAX design. The JAX
package runs one SPMD program: a ``lax.scan`` over clock ticks, every
stage computing at every tick, activations rotating by ``ppermute`` and
the backward derived by AD. Here a process is a rank, which is the
reference ``PipelineEngine._exec_schedule``'s situation, and the JAX
module's own docstring names the instruction schedule as what drives such
a host-loop executor. :func:`run_schedule` walks this stage's
``steps()``:

* ``LoadMicroBatch`` / ``RecvActivation``: the first stage takes its
  micro-batch; a later one receives the activation, a leaf that needs a
  gradient when training;
* ``ForwardPass``: the stage's layers (under the model's remat setting);
  the last stage also takes the micro-batch's part of the loss;
* ``SendActivation``: the detached output goes to the next stage (a send
  that is waited for at the end of the walk);
* ``RecvGrad`` / ``BackwardPass`` / ``SendGrad``: the output's gradient
  arrives, ``torch.autograd.backward`` runs (on the last stage: the loss
  part, times the loss scale), and the received leaf's ``.grad`` goes back;
* ``ReduceTiedGrads`` / ``ReduceGrads`` / ``OptimizerStep`` end the walk:
  the engine reduces the grads (the entries replicated over ``pipe``, the
  tied embedding among them, also over ``pipe``) and steps once the step's
  last micro-batch has run.

Sends and receives go through ``comm.send`` / ``comm.recv`` over the
pair's direction group (``MeshTopology.p2p_group``), so an activation
going down and a gradient coming up never queue behind each other.
:func:`pipelined_loss` is the causal LM's stage program: micro-batches
split STRIDED as the JAX package splits them (micro-batch ``m`` is rows
``m, n + m, ...``, JAX ``:391-417``), the last stage's parts divided by the
global token count (counted before the first backward: it is data), so
the parts sum to the JAX package's global masked mean, and the gradient
is the sum over micro-batches.
"""
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..comm import comm
from ..comm.topology import MeshTopology, get_world_topology

# ============================================================================
# Instruction schedule (parity layer with runtime/pipe/schedule.py)
# ============================================================================


class PipeInstruction:
    """Base instruction (reference ``schedule.py:327``)."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
        return f"{type(self).__name__}({args})"

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class LoadMicroBatch(PipeInstruction):
    pass


class ForwardPass(PipeInstruction):
    pass


class BackwardPass(PipeInstruction):
    pass


class SendActivation(PipeInstruction):
    pass


class RecvActivation(PipeInstruction):
    pass


class SendGrad(PipeInstruction):
    pass


class RecvGrad(PipeInstruction):
    pass


class PipeSchedule:
    """Iterable of per-clock-tick instruction lists (reference
    ``schedule.py:12``)."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        if not 0 <= stage_id < stages:
            raise ValueError(f"stage_id {stage_id} not in [0, {stages})")
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def num_pipe_buffers(self) -> int:
        return 2

    def steps(self):
        raise NotImplementedError

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only fill/drain (reference ``schedule.py:135``)."""

    def steps(self):
        total = self.micro_batches + self.stages - 1
        out: List[List[PipeInstruction]] = []
        for t in range(total):
            cmds: List[PipeInstruction] = []
            mb = t - self.stage_id
            if 0 <= mb < self.micro_batches:
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buffer_id=mb % 2,
                                               micro_batch_id=mb))
                else:
                    cmds.append(RecvActivation(buffer_id=mb % 2,
                                               micro_batch_id=mb))
                cmds.append(ForwardPass(buffer_id=mb % 2, micro_batch_id=mb))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buffer_id=mb % 2,
                                               micro_batch_id=mb))
            out.append(cmds)
        return out


class TrainSchedule(PipeSchedule):
    """1F1B: warmup forwards, steady one-forward-one-backward, drain
    backwards, then grad reduce + optimizer step (reference
    ``schedule.py:189``)."""

    def num_pipe_buffers(self) -> int:
        # in-flight activations on this stage (reference ``schedule.py:312``)
        return max(2, min(self.micro_batches, self.stages - self.stage_id))

    def steps(self):
        m, s, i = self.micro_batches, self.stages, self.stage_id
        warmup = min(s - i - 1, m)
        nbuf = self.num_pipe_buffers()
        out: List[List[PipeInstruction]] = []

        def fwd(mb):
            cmds: List[PipeInstruction] = []
            buf = mb % nbuf
            if self.is_first_stage:
                cmds.append(LoadMicroBatch(buffer_id=buf, micro_batch_id=mb))
            else:
                cmds.append(RecvActivation(buffer_id=buf, micro_batch_id=mb))
            cmds.append(ForwardPass(buffer_id=buf, micro_batch_id=mb))
            if not self.is_last_stage:
                cmds.append(SendActivation(buffer_id=buf, micro_batch_id=mb))
            return cmds

        def bwd(mb):
            cmds: List[PipeInstruction] = []
            buf = mb % nbuf
            if not self.is_last_stage:
                cmds.append(RecvGrad(buffer_id=buf, micro_batch_id=mb))
            cmds.append(BackwardPass(buffer_id=buf, micro_batch_id=mb))
            if not self.is_first_stage:
                cmds.append(SendGrad(buffer_id=buf, micro_batch_id=mb))
            return cmds

        f_next = 0  # next microbatch to forward
        b_next = 0  # next microbatch to backward
        for _ in range(warmup):
            out.append(fwd(f_next))
            f_next += 1
        # steady 1F1B
        while f_next < m:
            out.append(fwd(f_next))
            f_next += 1
            out.append(bwd(b_next))
            b_next += 1
        # drain
        while b_next < m:
            out.append(bwd(b_next))
            b_next += 1
        out.append([ReduceTiedGrads(), ReduceGrads(), OptimizerStep()])
        return out


# ============================================================================
# Stage partitioning (parity with runtime/pipe/module.py partitioning)
# ============================================================================


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Split ``weights`` into ``num_parts`` contiguous chunks minimizing the
    max chunk sum (reference ``ds_utils.partition_balanced``). Returns part
    boundaries of length num_parts+1. DP over prefix sums, O(n²·p)."""
    n = len(weights)
    if num_parts > n:
        raise ValueError(f"cannot split {n} layers into {num_parts} stages")
    prefix = np.concatenate([[0.0], np.cumsum(weights)])
    # cost[j][k] = best max-sum splitting first j items into k parts
    INF = float("inf")
    cost = np.full((n + 1, num_parts + 1), INF)
    back = np.zeros((n + 1, num_parts + 1), dtype=int)
    cost[0][0] = 0.0
    for k in range(1, num_parts + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                c = max(cost[i][k - 1], prefix[j] - prefix[i])
                if c < cost[j][k]:
                    cost[j][k] = c
                    back[j][k] = i
    bounds = [n]
    j, k = n, num_parts
    while k > 0:
        j = back[j][k]
        bounds.append(j)
        k -= 1
    return list(reversed(bounds))


def partition_uniform(num_layers: int, num_parts: int) -> List[int]:
    """Uniform layer-count split (reference ``partition_method='uniform'``)."""
    return partition_balanced([1.0] * num_layers, num_parts)


# ============================================================================
# The host-loop executor
# ============================================================================


def run_schedule(schedule: PipeSchedule, first_input: Callable,
                 forward: Callable, last_part: Callable,
                 recv_like: Callable, *, train: bool,
                 loss_scale: float = 1.0, axis: str = "pipe",
                 aux_coef: float = 0.0,
                 aux_out: Optional[Dict[int, torch.Tensor]] = None
                 ) -> Dict[int, torch.Tensor]:
    """Walk ``schedule.steps()`` on this rank (the stage
    ``schedule.stage_id`` of ``axis``) up to its reduce / step
    instructions.

    ``first_input(m)``: the first stage's input of micro-batch ``m``;
    ``forward(m, x)``: this stage's output on ``x``, or ``(output, aux)``
    with ``aux`` a scalar of this stage's own (an MoE layer's load-balance
    loss); ``last_part(m, y)``: the last stage's scalar part of micro-batch
    ``m``; ``recv_like(m)``: an empty tensor of the activation's shape,
    dtype and device. With ``train`` the walk runs the backward (the last
    stage's parts times ``loss_scale``; a stage's ``aux`` seeded with
    ``aux_coef * loss_scale`` beside its output's gradient, so the aux's
    gradient reaches the stages before through the SendGrad of the
    activation it was computed from) and leaves the grads in the params'
    ``.grad``; without it (``InferenceSchedule``) autograd is off. Returns
    ``{m: the detached part}`` on the last stage, ``{}`` elsewhere;
    ``aux_out`` collects ``{m: the detached aux}`` on every stage."""
    first, last = schedule.is_first_stage, schedule.is_last_stage
    inputs: Dict[int, Any] = {}
    outputs: Dict[int, torch.Tensor] = {}
    auxes: Dict[int, torch.Tensor] = {}
    grads: Dict[int, torch.Tensor] = {}
    parts: Dict[int, torch.Tensor] = {}
    sends = []
    ends = (ReduceTiedGrads, ReduceGrads, OptimizerStep)
    with torch.set_grad_enabled(train):
        for cmds in schedule.steps():
            for cmd in cmds:
                if isinstance(cmd, ends):
                    break
                buf, m = cmd.buffer_id, cmd.micro_batch_id
                if isinstance(cmd, LoadMicroBatch):
                    inputs[buf] = None
                elif isinstance(cmd, RecvActivation):
                    x = comm.recv(recv_like(m), schedule.prev_stage, axis)
                    inputs[buf] = x.requires_grad_(True) if train else x
                elif isinstance(cmd, ForwardPass):
                    x = first_input(m) if first else inputs[buf]
                    y = forward(m, x)
                    if isinstance(y, tuple):
                        y, aux = y
                        if isinstance(aux, torch.Tensor):
                            if aux_out is not None:
                                aux_out[m] = aux.detach()
                            if train and aux.requires_grad:
                                auxes[buf] = aux
                    if last:
                        y = last_part(m, y)
                        parts[m] = y.detach()
                    outputs[buf] = y
                    if not train:
                        inputs.pop(buf)
                elif isinstance(cmd, SendActivation):
                    y = outputs[buf] if train else outputs.pop(buf)
                    sends.append(comm.send(y.detach(), schedule.next_stage,
                                           axis, async_op=True))
                elif isinstance(cmd, RecvGrad):
                    grads[buf] = comm.recv(outputs[buf],
                                           schedule.next_stage, axis)
                elif isinstance(cmd, BackwardPass):
                    y = outputs.pop(buf)
                    aux = auxes.pop(buf, None)
                    if aux is not None:
                        seed = y.new_tensor(loss_scale) if last \
                            else grads.pop(buf)
                        torch.autograd.backward(
                            [y, aux],
                            [seed, aux.new_tensor(aux_coef * loss_scale)])
                    elif last:
                        torch.autograd.backward(y * loss_scale)
                    else:
                        torch.autograd.backward(y, grads.pop(buf))
                    if first:
                        inputs.pop(buf)
                elif isinstance(cmd, SendGrad):
                    x = inputs.pop(buf)
                    g = x.grad if x.grad is not None else torch.zeros_like(x)
                    sends.append(comm.send(g, schedule.prev_stage, axis,
                                           async_op=True))
                else:
                    raise ValueError(f"unknown pipe instruction {cmd!r}")
    for s in sends:
        if s is not None:
            s.wait()
    return parts


def _strided(t: Optional[torch.Tensor], m: int, n: int):
    """Micro-batch ``m`` of ``n``: rows ``m, n + m, ...`` (JAX
    ``spmd_pipeline``'s strided split)."""
    return None if t is None else t[m::n]


def pipelined_loss(model, params, batch: Dict[str, torch.Tensor],
                   n_micro: int, *, train: bool = True,
                   loss_scale: float = 1.0, axis: str = "pipe",
                   rng: Optional[torch.Generator] = None):
    """One (gradient-accumulation) micro-batch of a causal LM through the
    pipeline: ``params`` hold this stage's block of layers (and the
    entries replicated over ``pipe``), ``batch`` this rank's rows, the
    same on every stage. Embedding on the first stage, the head and the
    loss on the last, ``n_micro`` micro-batches, strided. With ``train``
    the backward runs too (1F1B). Returns this rank's share of the LM
    loss: the sum of its parts on the last stage (each a micro-batch's
    masked sum over the token count summed over the batch axes), 0
    elsewhere. An MoE model returns ``(lm share, aux share)``: the aux is
    this stage's layers' load-balance loss summed over its layers and the
    micro-batches, as the JAX pipeline sums it (``aux.sum()``, not a
    mean); each micro-batch routes over its global tokens, and each stage
    seeds its aux with ``aux_loss_coef`` times the loss scale in its own
    backward. ``rng``: the router jitter's generator, from which one seed a
    micro-batch is drawn (on every stage alike)."""
    topo = get_world_topology()
    stages, stage = topo.axis_size(axis), topo.axis_index(axis)
    ids = batch["input_ids"]
    rows, seq = ids.shape
    if rows % n_micro:
        raise ValueError(f"batch {rows} not divisible by n_microbatches "
                         f"{n_micro}")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(seq, device=ids.device)[None].expand(
            rows, seq)
    segment_ids = batch.get("segment_ids")
    sched = (TrainSchedule if train else InferenceSchedule)(
        n_micro, stages, stage)
    labels = mask = count = None
    if sched.is_last_stage:
        labels, mask = model.targets(batch)
        count = model.token_count(mask).clamp_min(1.0)
    first_layer = stage * len(params["layers"])
    cfg = model.config
    from ..models.transformer import compute_dtype

    moe = bool(getattr(cfg, "any_moe", False))
    seeds = [None] * n_micro
    if moe and cfg.router_jitter > 0.0 and rng is not None:
        seeds = [int(torch.randint(2 ** 62, (1,), generator=rng,
                                   device=rng.device))
                 for _ in range(n_micro)]

    def first_input(m):
        return model.embed(params, _strided(ids, m, n_micro),
                           _strided(positions, m, n_micro))

    def forward(m, x):
        gen = None
        if seeds[m] is not None:
            gen = torch.Generator(device=x.device).manual_seed(seeds[m])
        y, aux = model.trunk(params["layers"], x,
                             _strided(positions, m, n_micro),
                             _strided(segment_ids, m, n_micro), rng=gen,
                             first=first_layer)
        return (y, aux) if moe else y

    def last_part(m, y):
        return model.nll_sum(model.head(params, y),
                             _strided(labels, m, n_micro),
                             _strided(mask, m, n_micro)) / count

    def recv_like(m):
        return torch.empty((rows // n_micro, seq, cfg.hidden_size),
                           dtype=compute_dtype(cfg), device=ids.device)

    auxes: Dict[int, torch.Tensor] = {}
    parts = run_schedule(sched, first_input, forward, last_part, recv_like,
                         train=train, loss_scale=loss_scale, axis=axis,
                         aux_coef=float(getattr(cfg, "aux_loss_coef", 0.0)),
                         aux_out=auxes)
    zero = torch.zeros((), device=ids.device)
    lm = torch.stack([parts[m] for m in sorted(parts)]).sum() if parts \
        else zero
    if not moe:
        return lm
    return lm, torch.stack([auxes[m] for m in sorted(auxes)]).sum()


# ============================================================================
# PipelineModule — layer-list façade (reference runtime/pipe/module.py)
# ============================================================================


class PipelineModule:
    """Partition a homogeneous layer stack onto pipe stages and expose a
    pipelined apply (reference ``PipelineModule``,
    ``runtime/pipe/module.py:636``).

    The contract is the JAX package's: one ``layer_fn(layer_params, h) ->
    h`` over a list of layer params, ``embed_fn`` / ``head_fn`` bracketing
    the pipelined trunk. Here ``params["layers"]`` holds this stage's block
    (:attr:`parts`), and :meth:`__call__` runs the forward through the
    host-loop executor (``InferenceSchedule``): ``x`` on every pipe rank
    (the first stage reads it), the last stage's output broadcast over
    ``pipe``. Training a pipelined model goes through the engine's
    ``train_batch``."""

    def __init__(self,
                 layer_fn: Callable,
                 num_layers: int,
                 topology: MeshTopology,
                 embed_fn: Optional[Callable] = None,
                 head_fn: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 partition_method: str = "uniform",
                 remat: bool = True):
        if partition_method != "uniform":
            raise NotImplementedError(
                "the SPMD pipeline only supports partition_method='uniform' "
                "(homogeneous stacked layers give equal stages by "
                "construction)")
        self.layer_fn = layer_fn
        self.num_layers = num_layers
        self.topology = topology
        self.embed_fn = embed_fn
        self.head_fn = head_fn
        self.loss_fn = loss_fn
        self.remat = remat
        stages = topology.axis_sizes["pipe"]
        if num_layers % max(stages, 1) != 0:
            raise ValueError(
                f"num_layers {num_layers} must divide evenly into {stages} "
                f"pipe stages for the SPMD pipeline (pad with identity layers "
                f"to round up, as the reference's uniform partitioner does "
                f"implicitly)")
        self.parts = partition_uniform(num_layers, stages)

    def _stage(self, layers, h):
        for lp in layers:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(self.layer_fn, lp, h, use_reentrant=False)
            else:
                h = self.layer_fn(lp, h)
        return h

    @torch.no_grad()
    def __call__(self, params: Any, x: torch.Tensor, *,
                 n_microbatches: Optional[int] = None) -> torch.Tensor:
        """params: {'embed': ..., 'layers': this stage's list, 'head': ...}
        (embed/head optional)."""
        topo = self.topology
        stages = topo.axis_sizes["pipe"]
        if self.embed_fn is not None:
            x = self.embed_fn(params.get("embed"), x)
        if stages == 1:
            y = self._stage(params["layers"], x)
        else:
            n = n_microbatches or stages
            if x.shape[0] % n:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"n_microbatches {n}")
            sched = InferenceSchedule(n, stages, topo.axis_index("pipe"))
            shape = (x.shape[0] // n,) + tuple(x.shape[1:])
            parts = run_schedule(
                sched, lambda m: x[m::n],
                lambda m, h: self._stage(params["layers"], h),
                lambda m, h: h,
                lambda m: torch.empty(shape, dtype=x.dtype, device=x.device),
                train=False)
            y = torch.empty_like(x)
            for m, part in parts.items():
                y[m::n] = part
            y = comm.broadcast(y, "pipe", src=stages - 1)
        if self.head_fn is not None:
            y = self.head_fn(params.get("head"), y)
        return y

    def loss(self, params: Any, batch: Any, rng=None):
        if self.loss_fn is None:
            raise ValueError("PipelineModule needs loss_fn for training")
        return self.loss_fn(self, params, batch, rng)
