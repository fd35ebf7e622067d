"""Decode bodies run as CUDA graphs on the card, eagerly on the CPU.

The JAX package jits serving's steady state into one compiled program per
shape: the per-token decode forward and the K-step fused decode
(``engine_v2._decode_multi_dispatch``). Their PyTorch counterpart is one
CUDA graph per body, here :class:`DecodeRunner`: the body is captured once
over static input tensors, and each call fills those inputs (host arrays
through pinned buffers, device tensors by a device copy) and replays the
graph, one host dispatch for some two thousand kernels. On a CPU device the
runner calls the body eagerly on the given inputs; there is no eager route
on the card, and a capture or replay that fails raises.

Before capture the body runs once on a side stream (one a device, shared
by every runner) with the ``idle`` inputs (every slot inactive, so it
writes only the KV pool's sink block): lazy initialisation (cuBLAS
workspaces, the kernels' build, cached device constants) happens there and
not inside the capture. A generator the body
samples from is registered with the graph, so each replay draws new
numbers. The wrappers count a kernel launch when Python calls them, which
during a capture launches nothing: each runner keeps the launches its
capture recorded and adds them to the wrappers' counts on every replay.
"""
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import flash_attention as _fa
from ...ops import paged_attention as _pa

_COUNTERS = (_pa.LAUNCHES, _fa.LAUNCHES)
# one warm-up stream per device for every runner: cuBLAS keeps a workspace
# for each stream it has run on until the process ends, so a stream of
# each runner's own would keep one more workspace for every capture
_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _counts() -> Tuple[Dict[str, int], ...]:
    return tuple(dict(c) for c in _COUNTERS)


def _add_counts(delta: Tuple[Dict[str, int], ...], sign: int) -> None:
    for counter, d in zip(_COUNTERS, delta):
        for name, n in d.items():
            counter[name] += sign * n


class DecodeRunner:
    """``body(**inputs) -> outputs`` as one CUDA graph (a CUDA ``device``)
    or eagerly (a CPU one). ``idle``: an input of each name, shape and
    dtype, every slot inactive (numpy arrays or device tensors); the graph's
    static inputs are allocated like them. ``pool``: a graph memory pool
    shared by the engine's runners (their outputs are consumed before the
    next replay). ``generator``: the generator the body samples from, if
    any."""

    def __init__(self, body: Callable, idle: Dict[str, object],
                 device: torch.device, pool=None,
                 generator: Optional[torch.Generator] = None):
        self.body = body
        self.device = device
        self.graph = None
        self.launches = tuple({} for _ in _COUNTERS)
        if device.type != "cuda":
            return
        self.static = {k: self._to_device(v).clone() for k, v in idle.items()}
        self.host = {k: torch.empty(tuple(v.shape), dtype=self.static[k].dtype,
                                    pin_memory=True)
                     for k, v in idle.items() if isinstance(v, np.ndarray)}
        self._filled = torch.cuda.Event()
        side = _WARMUP_STREAMS.get(device)
        if side is None:
            side = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(**self.static)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = _counts()
        with torch.cuda.graph(graph, pool=pool):
            self.outputs = body(**self.static)
        self.launches = tuple(
            {k: after[k] - b[k] for k in after if after[k] != b[k]}
            for after, b in zip(_counts(), before))
        _add_counts(self.launches, -1)   # the capture launched nothing
        self.graph = graph

    def _to_device(self, v) -> torch.Tensor:
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v).to(self.device)
        return v

    def __call__(self, **inputs):
        if self.graph is None:
            return self.body(**{k: self._to_device(v)
                                for k, v in inputs.items()})
        self._filled.synchronize()      # the pinned buffers are free again
        for name, v in inputs.items():
            if isinstance(v, np.ndarray):
                self.host[name].numpy()[...] = v
                v = self.host[name]
            self.static[name].copy_(v, non_blocking=True)
        self._filled.record()
        self.graph.replay()
        _add_counts(self.launches, 1)
        return self.outputs
