"""Inference mesh set-up and weight placement, shared by both engines
(:func:`serving_mesh`, then :func:`place_inference_params`).

Port of ``place_inference_params`` (``deepspeedsyclsupport_tpu/inference/
params.py:17``). The JAX function places every leaf by stage-0 shardings
composed with the model's ``sharding_rules`` (its auto-TP) and casts the
floating leaves to the serving dtype. Here a process holds one rank's part:
:func:`serving_specs` plans each leaf with the same rules
(``runtime/zero.py`` at stage 0), and :func:`place_inference_params` cuts
each leaf to this rank's shard, then casts it and moves it to the device.
Without a topology (one card) there is nothing to cut: every leaf moves
whole. A quantized leaf (``QuantTensor``) moves whole: its codes keep int8 /
uint8 and its scales float32.
"""
from typing import Any, Dict, Optional, Tuple

import torch

from ..compression.quantize import QuantTensor


def serving_specs(params: Any, topology, rules, stacked: bool = True
                  ) -> Dict[Tuple, Any]:
    """``{path: spec}`` of every leaf of the port's params tree at ZeRO
    stage 0 under ``rules`` (paths as ``runtime/zero._walk`` yields them;
    a layer leaf planned on the JAX package's stacked shape when
    ``stacked``)."""
    from ..runtime import zero as zero_lib

    return zero_lib.tree_param_shardings(params, topology, 0,
                                         extra_rules=rules, stacked=stacked)


# the multi-axis process group the serving forwards use (an MoE layer's
# region under ep x tp), built with the mesh's axis groups up front
SERVE_GROUPS = (("expert", "model"),)


def serve_plan(topology, mcfg):
    """This rank's ``v2.model.ServePlan`` on ``topology``, after the
    checks that the model's layout can be cut over it: whole query and KV
    heads a rank, the vocabulary, learned positions, the MLP's intermediate
    width and the experts divisible by their axes. Serving runs over
    ``model``, ``expert``, ``data`` and ``fsdp`` (which serves as data:
    placement is stage 0); a pipeline or sequence axis raises."""
    from .v2.model import ServePlan

    sizes = topology.axis_sizes
    for ax in ("pipe", "seq"):
        if sizes[ax] > 1:
            raise ValueError(
                f"serving across ranks shards over the model and expert "
                f"axes (data ranks serve the same requests); the {ax} axis "
                f"of {topology} has size {sizes[ax]}")
    tp, ep = sizes["model"], sizes["expert"]
    need = [("num_heads", mcfg.num_heads, tp),
            ("num_kv_heads", mcfg.num_kv_heads, tp),
            ("vocab_size", mcfg.vocab_size, tp),
            ("intermediate_size", mcfg.intermediate_size, tp)]
    if mcfg.pos_embed == "learned":
        need.append(("the learned position table (max_seq_len + "
                     "pos_embed_offset)",
                     mcfg.max_seq_len + mcfg.pos_embed_offset, tp))
    if mcfg.any_moe:
        need.append(("num_experts", mcfg.num_experts, ep))
    for what, n, k in need:
        if n % k:
            raise ValueError(
                f"{what} ({n}) does not divide by {k} ranks of {topology}: "
                f"each rank must hold an equal, whole part (heads of the "
                f"paged pool, rows of the vocab-parallel embedding and "
                f"head, columns of the MLP, experts)")
    moe = bool(mcfg.any_moe)
    return ServePlan(tp=tp, tp_index=topology.axis_index("model"),
                     ep=ep if moe else 1,
                     ep_index=topology.axis_index("expert") if moe else 0)


def model_specs(model, topology) -> Dict[Tuple, Any]:
    """:func:`serving_specs` of ``model``'s whole params tree (planned on
    its shapes alone: the params may already be shards)."""
    return serving_specs(
        model.init_params(generator=torch.Generator(), device="meta"),
        topology, model.sharding_rules,
        stacked=bool(getattr(model.config, "scan_layers", True)))


def serving_mesh(model, topology):
    """``(topology, plan, specs)`` of serving ``model`` on ``topology``, as
    both engines set it up: all None for one card (no topology, or a
    topology of one rank without a process group; a larger one raises).
    Under a process group: the layout's checks and this rank's plan
    (:func:`serve_plan`), the topology installed as the world's with the
    groups serving uses (a collective: every rank calls this), and each
    leaf's spec (:func:`model_specs`)."""
    if topology is None:
        return None, None, None
    import torch.distributed as dist

    from ..comm.topology import set_world_topology

    if not (dist.is_available() and dist.is_initialized()):
        if topology.world_size() > 1:
            raise RuntimeError(f"{topology} spans {topology.world_size()} "
                               f"ranks: call comm.init_distributed first")
        return None, None, None
    plan = serve_plan(topology, model.config)
    set_world_topology(topology)
    topology.init_groups(combined=SERVE_GROUPS)
    return topology, plan, model_specs(model, topology)


def _place(t, dtype: torch.dtype, device: torch.device, index=None):
    if isinstance(t, QuantTensor):
        if index is not None:
            raise ValueError(
                "a params tree quantized before placement cannot be cut to "
                "a rank's shards; pass float weights and quantize_weights")
        return t.to(device)
    t = torch.as_tensor(t)
    whole = t
    if index is not None:
        t = t[index]
    t = t.to(device=device, dtype=dtype) if t.is_floating_point() \
        else t.to(device=device)
    if index is not None and t.untyped_storage().data_ptr() == \
            whole.untyped_storage().data_ptr():
        t = t.clone()   # a shard must not keep the whole leaf alive
    return t


def place_inference_params(params: Any, dtype: torch.dtype,
                           device: torch.device, topology=None,
                           specs: Optional[Dict[Tuple, Any]] = None) -> Any:
    """A new tree: floating leaves cast to ``dtype``, all leaves on
    ``device``. Leaves already in place are shared, not copied. With a
    ``topology`` and the tree's ``specs`` (:func:`serving_specs`), each
    leaf is first cut to this rank's shard."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        index = None
        if topology is not None:
            spec = specs[path]
            if any(topology.axis_size(e) > 1 for e in spec if e):
                index = topology.shard_slices(tuple(tree.shape), spec)
        return _place(tree, dtype, device, index)

    return walk(params, ())
