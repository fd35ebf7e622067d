"""Shape-only stand-ins of a step's arguments.

Port of ``deepspeedsyclsupport_tpu/analysis/capture.py``. The JAX package
keeps a step's avals (``ShapeDtypeStruct`` with shardings) to re-lower
the step without its buffers. The port has nothing to re-lower; what its
analyzers need is the tree's FULL shapes and dtypes, which a rank does not
hold (each holds its shards): ``meta``-device tensors give them without
memory. ``Engine.graph_report`` hands :func:`abstract_params` to the
collective census's expectation and classifier.
"""
from typing import Any, Optional, Sequence

import numpy as np
import torch


def abstract_leaf(x: Any, shape: Optional[Sequence[int]] = None
                  ) -> torch.Tensor:
    """A ``meta`` tensor of ``x``'s dtype and ``shape`` (default
    ``x``'s)."""
    dtype = x.dtype if isinstance(x.dtype, torch.dtype) else \
        torch.from_numpy(np.empty(0, x.dtype)).dtype
    return torch.empty(tuple(x.shape if shape is None else shape),
                       dtype=dtype, device="meta")


def abstract_step_args(tree: Any) -> Any:
    """``tree`` (nested dicts and lists) with every leaf an
    :func:`abstract_leaf`."""
    if isinstance(tree, dict):
        return {k: abstract_step_args(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [abstract_step_args(v) for v in tree]
    return abstract_leaf(tree)


def abstract_params(engine: Any) -> Any:
    """The engine's params at their full shapes (under a process group a
    rank holds shards; ``engine._full_shapes`` has the whole leaves')."""
    full = getattr(engine, "_full_shapes", None)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return abstract_leaf(node, full.get(path) if full else None)

    return walk(engine.params, ())
