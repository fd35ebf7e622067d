"""One rank of the port's distributed CPU tests (not a test module).

Run as ``python tests/torch_dist_worker.py <spec.json>`` with the torch
launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``): it starts a gloo process group through
``comm.init_distributed`` (the env:// path), runs the spec's ``kind`` —
``"comm"`` (the façade's cases), ``"comm_more"`` (the rest of the
façade on 8 ranks), ``"p2p"`` (send / recv / p2p over ``pipe`` and the
differentiable collectives' gradients), ``"quant"`` (the quantized
collectives and ZeRO++'s gathers and reduces), ``"scope"`` (configs the
ZeRO++ step refuses), ``"train"`` (legs of ``tiny`` or ``tiny-moe``
through ``initialize`` -> ``train_batch``) or ``"ckpt"`` (checkpoints,
preemption and the sentinel across ranks) — and writes this rank's results
as ``<out>/<leg>_rank<r>.npz``. It imports torch and the port, never jax.
"""
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deepspeedsyclsupport_tpu_torch import comm  # noqa: E402
from deepspeedsyclsupport_tpu_torch.comm.comms_logging import comms_logger  # noqa: E402
from deepspeedsyclsupport_tpu_torch.comm.topology import (  # noqa: E402
    build_topology, reset_world_topology)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def unflat(arrays):
    tree = {}
    for key, v in arrays.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ------------------------------------------------------------------- comm
def run_comm(spec, rank, out):
    """The façade's cases on a 4-rank ``data`` axis, inputs as the JAX test
    shards them: rank r holds ``x[r]`` of the global array."""
    build_topology(dp=-1)
    res = {}
    x = torch.arange(4.0) + 1.0                       # global [1, 2, 3, 4]
    mine = x[rank:rank + 1]
    for op in ("sum", "max", "min", "prod", "mean"):
        res[f"all_reduce_{op}"] = comm.all_reduce(mine, "data", op=op)
    xi = torch.arange(8, dtype=torch.int64)[2 * rank:2 * rank + 2]
    res["all_reduce_int"] = comm.all_reduce(xi, "data")
    res["pmean"] = comm.pmean(mine, "data")
    g = torch.arange(24.0).reshape(4, 3, 2)[rank]     # [3, 2] each
    res["all_gather0"] = comm.all_gather(g, "data")
    res["all_gather1"] = comm.all_gather(g, "data", axis=1)
    res["all_gather_stack"] = comm.all_gather(g, "data", tiled=False)
    full = torch.arange(32.0).reshape(8, 4) * (rank + 1)
    res["reduce_scatter0"] = comm.reduce_scatter(full, "data")
    res["reduce_scatter1"] = comm.reduce_scatter(full, "data", axis=1)
    a2a = torch.arange(64.0).reshape(4, 16)[rank:rank + 1].reshape(1, 16)
    res["all_to_all"] = comm.all_to_all(a2a, "data", split_axis=1,
                                        concat_axis=0)
    res["ring_next"] = comm.send_recv_next(mine, "data")
    res["ring_prev"] = comm.send_recv_prev(mine, "data")
    res["shift_next"] = comm.send_recv_next(mine, "data", wrap=False)
    res["shift_prev"] = comm.send_recv_prev(mine, "data", wrap=False)
    res["ppermute"] = comm.ppermute(mine, "data", [(0, 2), (2, 0), (1, 3)])
    nanx = torch.where(torch.tensor(rank == 3), torch.tensor([42.0]),
                       torch.tensor([float("nan")]))
    res["broadcast"] = comm.broadcast(nanx, "data", src=3)
    res["coalesced"] = torch.cat(comm.all_reduce_coalesced(
        [mine, 2 * mine], "data"))
    # 2-D mesh: the reduce over one axis, and over both
    build_topology(dp=2, fsdp=2)
    res["mesh_fsdp"] = comm.all_reduce(mine, "fsdp")
    res["mesh_data"] = comm.all_reduce(mine, "data")
    res["mesh_both"] = comm.all_gather(mine, ("data", "fsdp"))
    build_topology(dp=-1)
    os.environ["DSTPU_COMM_ALL_REDUCE_OFF"] = "1"
    res["kill_switch"] = comm.all_reduce(mine, "data")
    del os.environ["DSTPU_COMM_ALL_REDUCE_OFF"]
    comms_logger.reset()
    comms_logger.configure(enabled=True)
    comm.all_reduce(mine, "data")
    comm.all_gather(g, "data")
    snap = comms_logger.snapshot()
    table = comms_logger.log_summary()
    comms_logger.reset()
    comms_logger.configure(timed=True)
    comm.all_reduce(mine, "data")
    timed = comms_logger.snapshot()["all_reduce[data]"]
    comms_logger.configure(enabled=False, timed=False)
    np.savez(os.path.join(out, f"comm_rank{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()},
             logger=np.array(json.dumps(snap)),
             timed=np.array(json.dumps(timed)),
             table_has_op=np.array("all_reduce" in table))


# -------------------------------------------------------------- comm_more
# hierarchical all-to-all cases: (split, concat) -> this rank's input shape
HIER_SHAPES = {(0, 0): (16, 3), (1, 0): (2, 16), (0, 2): (16, 2, 3)}


def hier_input(case, rank):
    """Rank ``rank``'s block of the global array ``arange`` shaped
    ``[8 * shape[0], *shape[1:]]``."""
    shape = HIER_SHAPES[case]
    n = int(np.prod(shape))
    return torch.arange(n * rank, n * (rank + 1),
                        dtype=torch.float32).reshape(shape)


def run_comm_more(spec, rank, out):
    """The rest of the façade on an 8-rank ``data`` axis: the hierarchical
    all-to-all (group sizes 1 / 2 / 4 / 8, three (split, concat) pairs, and
    its gradient), the untiled all-to-all, the root-based ops, the aliases
    and the group bookkeeping; the bytes the logger records."""
    from deepspeedsyclsupport_tpu_torch.comm.topology import (
        get_world_topology)

    topo = build_topology(dp=-1)
    topo.init_groups(hierarchical=[("data", 2), ("data", 4)])
    comms_logger.reset()
    comms_logger.configure(enabled=True)
    res = {}
    for (sa, ca) in HIER_SHAPES:
        for gs in (1, 2, 4, 8):
            key = f"hier_{gs}_{sa}{ca}"
            x = hier_input((sa, ca), rank).requires_grad_(True)
            y = comm.hierarchical_all_to_all(x, "data", gs, split_axis=sa,
                                             concat_axis=ca)
            w = torch.arange(y.numel(), dtype=torch.float32).reshape(
                y.shape) + 1000.0 * rank
            (y * w).sum().backward()
            res[key] = y.detach()
            res[key + "_grad"] = x.grad
    x = torch.arange(24.0).reshape(8, 3) + 100 * rank
    res["a2a_untiled"] = comm.all_to_all(x, "data", 0, 1, tiled=False)
    xr = torch.arange(16.0).reshape(8, 2) + 100 * rank
    res["reduce"] = comm.reduce(xr, "data", dst=2)
    res["gather"] = comm.gather(xr, "data", dst=1)
    res["scatter"] = comm.scatter(xr, "data", src=3)
    res["all_gather_into_tensor"] = comm.all_gather_into_tensor(xr, "data")
    res["reduce_scatter_tensor"] = comm.reduce_scatter_tensor(xr, "data")
    res["all_to_all_single"] = comm.all_to_all_single(xr, "data")
    res["inference_all_reduce"] = comm.inference_all_reduce(xr, "data")
    comm.monitored_barrier(timeout=60)
    g = comm.new_group([2, 5, 7])
    # a torch group is known to its members alone: the others hold no
    # handle (and say so), and report the members' answers
    member = rank in (2, 5, 7)
    books = {"global_rank": comm.get_global_rank(g, 1) if member else 5,
             "global_rank_none": comm.get_global_rank(None, 3),
             "world": comm.get_all_ranks_from_group(),
             "group": comm.get_all_ranks_from_group(g) if member
             else [2, 5, 7],
             "world_group": comm.get_all_ranks_from_group(
                 comm.get_world_group())}
    if not member:
        try:
            comm.get_global_rank(g, 1)
            books["non_member"] = "answered"
        except ValueError:
            pass
    snap = comms_logger.snapshot()
    comms_logger.configure(enabled=False)
    assert get_world_topology() is topo
    np.savez(os.path.join(out, f"comm_more_rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()},
             books=np.array(json.dumps(books)),
             logger=np.array(json.dumps({k: v["total_bytes"]
                                         for k, v in snap.items()})))


# -------------------------------------------------------------------- p2p
def run_p2p(spec, rank, out):
    """Point-to-point along a 4-rank ``pipe`` axis (its direction groups),
    the differentiable collectives' gradients and a ``PipelineModule``
    forward over the four stages."""
    build_topology(pp=4)
    comms_logger.reset()
    comms_logger.configure(enabled=True)
    res = {}
    x = torch.arange(3.0) + 10 * rank
    sent = comm.send(x, rank + 1, "pipe", async_op=True) if rank < 3 \
        else None
    res["recv_prev"] = comm.recv(torch.empty(3), rank - 1, "pipe") \
        if rank > 0 else x.clone()
    if sent is not None:
        sent.wait()
    # the other direction, waiting on each send
    if rank > 0:
        comm.send(2 * x, rank - 1, "pipe", src=rank)
    res["recv_next"] = comm.recv(torch.empty(3), rank + 1, "pipe",
                                 dst=rank) if rank < 3 else x.clone()
    res["p2p"] = comm.p2p(x, 1, 3, "pipe")
    snap = comms_logger.snapshot()
    comms_logger.configure(enabled=False)
    xg = x.clone().requires_grad_(True)
    y = comm.send_recv_next(xg, "pipe")
    (y * (rank + 1)).sum().backward()
    res["ppermute_grad"] = xg.grad
    a = (torch.arange(8.0).reshape(4, 2) + 100 * rank).requires_grad_(True)
    y = comm.all_to_all(a, "pipe", split_axis=0, concat_axis=1)
    res["all_to_all"] = y.detach()
    (y * (torch.arange(8.0) + 8 * rank)).sum().backward()
    res["all_to_all_grad"] = a.grad
    from deepspeedsyclsupport_tpu_torch.comm.topology import (
        get_world_topology)
    from deepspeedsyclsupport_tpu_torch.parallel.pipeline import (
        PipelineModule)

    # a stage a rank, layer i multiplies by i + 2 and adds 1
    pm = PipelineModule(lambda p, h: h * p + 1, 4, get_world_topology(),
                        embed_fn=lambda e, x: x + e, remat=False)
    res["pipeline_module"] = pm({"embed": 1.0, "layers": [2.0 + rank]},
                                torch.arange(8.0).reshape(4, 2),
                                n_microbatches=2)
    np.savez(os.path.join(out, f"p2p_rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()},
             logger=np.array(json.dumps({k: v["total_bytes"]
                                         for k, v in snap.items()})))


# ------------------------------------------------------------------ quant
def quant_input(name, rank, shape):
    """Rank ``rank``'s input of a quantized case: seeded normal values."""
    seed = sum(map(ord, name)) * 100 + rank
    return torch.from_numpy(np.random.RandomState(seed).randn(
        *shape).astype(np.float32))


QUANT_SHAPES = {"gather": (3, 100), "gather_pad": (5, 7),
                "reduce": (4 * 6, 90), "reduce_pad": (4 * 2, 5),
                "onebit": (33, 5), "hier": (6, 50)}


def run_quant(spec, rank, out):
    """The quantized collectives on a 4-rank ``fsdp`` axis (hpZ groups of
    2 built up front), and ZeRO++'s leaf gather and reduce with the bytes
    the logger records."""
    from deepspeedsyclsupport_tpu_torch.comm import quantized as q
    from deepspeedsyclsupport_tpu_torch.runtime import zeropp

    topo = build_topology(fsdp=4)
    topo.init_groups(hierarchical=[("fsdp", 2)])
    res = {}
    for name in ("gather", "gather_pad"):
        x = quant_input(name, rank, QUANT_SHAPES[name])
        res[name] = q.quantized_all_gather(x, "fsdp")
        res[name + "_bf16"] = q.quantized_all_gather(
            x, "fsdp", dtype=torch.bfloat16).float()
    for name in ("reduce", "reduce_pad"):
        res[name] = q.all_to_all_quant_reduce(
            quant_input(name, rank, QUANT_SHAPES[name]), "fsdp")
    x = quant_input("onebit", rank, QUANT_SHAPES["onebit"])
    err = 0.1 * quant_input("onebit_err", rank, QUANT_SHAPES["onebit"])
    res["onebit"], res["onebit_err"] = q.compressed_allreduce(x, err, "fsdp")
    x = quant_input("hier", rank, QUANT_SHAPES["hier"])
    for h in (1, 2, 4):
        for quantized in (False, True):
            res[f"hier_{h}_{int(quantized)}"] = zeropp.hierarchical_all_gather(
                x, 4, h, quantized)
    comms_logger.reset()
    comms_logger.configure(enabled=True)
    res["leaf_gather"] = zeropp.gather_leaf(x, 4, 2, True)
    res["leaf_gather_plain"] = zeropp.gather_leaf(x, 4, 2, False)
    g = quant_input("reduce", rank, QUANT_SHAPES["reduce"])
    res["leaf_reduce"] = zeropp.reduce_leaf(g, True)
    res["leaf_reduce_plain"] = zeropp.reduce_leaf(g, False)
    snap = comms_logger.snapshot()
    comms_logger.configure(enabled=False)
    np.savez(os.path.join(out, f"quant_rank{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()},
             logger=np.array(json.dumps({k: v["total_bytes"]
                                         for k, v in snap.items()})))


# ------------------------------------------------------------------ scope
def custom_loss(kind, model):
    """The loss ``kind`` names for ``model``: ``"closure"`` (the model's own
    loss through a closure over the caller's model, a mean over rows when
    no token is masked), ``"weighted"`` (that loss times the mean of a
    per-row ``weight``: not a mean over rows) or ``"bound"`` (a subclass's
    ``loss`` method, twice the model's: what the engine rebinds). Returns
    ``(model, loss_fn)``."""
    if kind == "bound":
        class Twice(type(model)):
            def loss(self, params, batch, rng=None, train=True):
                lm, metrics = super().loss(params, batch, rng, train=train)
                return 2.0 * lm, metrics

        sub = Twice.__new__(Twice)
        sub.__dict__.update(model.__dict__)
        return sub, sub.loss

    def closure(params, batch, rng=None, train=True):
        lm, metrics = model.loss(params, {"input_ids": batch["input_ids"]},
                                 rng, train=train)
        if kind == "weighted":
            lm = lm * batch["weight"].mean()
        return lm, metrics
    return model, closure


def run_scope(spec, rank, out):
    """Each config of the spec through ``initialize``: the ValueError (or
    NotImplementedError) message it raises, or ``""``."""
    from deepspeedsyclsupport_tpu_torch import build_model
    from deepspeedsyclsupport_tpu_torch.runtime import initialize

    msgs = []
    for case in spec["configs"]:
        try:
            model = build_model("tiny", dtype="float32", **case["model_kw"])
            loss_fn = None
            if case.get("loss"):
                model, loss_fn = custom_loss(case["loss"], model)
            initialize(model=model, loss_fn=loss_fn,
                       config=case["config"], device="cpu")
            msgs.append("")
        except (ValueError, NotImplementedError) as e:
            msgs.append(f"{type(e).__name__}: {e}")
        reset_world_topology()
    with open(os.path.join(out, f"scope_rank{rank}.json"), "w") as f:
        json.dump(msgs, f)


# ------------------------------------------------------------------ train
def read_tag(path, prefix="params/"):
    """A native tag's leaves under ``prefix``, whole: ``{name without the
    prefix: numpy array}`` (float32 / int leaves)."""
    with open(os.path.join(path, "state_index.json")) as f:
        index = json.load(f)
    out = {}
    with open(os.path.join(path, "state.bin"), "rb") as f:
        for e in index:
            if not e["name"].startswith(prefix):
                continue
            f.seek(e["offset"])
            out[e["name"][len(prefix):]] = np.frombuffer(
                f.read(e["nbytes"]), dtype=e["dtype"]).reshape(e["shape"])
    return out


def tag_equals(path, full, cfg):
    """Whether the tag's params, in the port's layout, EQUAL ``full``
    (``gather_params``' tree)."""
    from deepspeedsyclsupport_tpu_torch import params_from_jax

    got = dict(flat({k: v for k, v in _tree_np(params_from_jax(
        unflat(read_tag(path)), cfg, device="cpu")).items()}))
    want = dict(flat(full))
    return set(got) == set(want) and all(
        np.array_equal(got[k], want[k]) for k in want)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def run_census(eng):
    """The last step's census and analyzers (``Engine.emit_comm_census``,
    ``graph_report``), the roofline's collective bytes, the plan (each
    leaf's full shape and spec), the straggler table; the telemetry
    stream closed (the pod report reads it)."""
    payload = eng.emit_comm_census()
    rep = eng.graph_report()
    table = eng._mfu_roofline()
    out = {"payload": payload, "window": rep["census"],
           "ok": {k: rep[k].ok for k in ("collectives", "donation",
                                         "resharding", "dtype")},
           "problems": rep["collectives"].problems,
           "expectation": {k: getattr(rep["collectives"].expectation, k)
                           for k in ("param_gather_count",
                                     "param_gather_bytes", "grad_sync_count",
                                     "grad_sync_bytes", "group_size")},
           "reports": {k: rep[k].report() for k in (
               "collectives", "donation", "resharding", "dtype")},
           "roofline_collective_bytes":
               table["regions"]["collective"]["comm_bytes"],
           "mfu_census_bytes": sum(e["bytes"] for e in eng._mfu_census),
           "plan": [["/".join(map(str, p)), list(eng._full_shapes[p]),
                     [list(e) for e in eng._specs[p]],
                     [list(e) for e in eng._update_specs[p]]]
                    for p in eng._full_shapes],
           "gas": eng.gradient_accumulation_steps(),
           "straggler": comms_logger.log_summary(show_straggler=True)}
    eng.telemetry.close()
    return out


def run_train(spec, rank, out):
    from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
    from deepspeedsyclsupport_tpu_torch.comm.topology import MeshTopology
    from deepspeedsyclsupport_tpu_torch.runtime import (
        gather_params, initialize, shard_params_from_jax)

    raw = dict(np.load(spec["params"]))
    for leg in spec["legs"]:
        name, cfg = leg["name"], leg["config"]
        batches = [dict(np.load(p)) for p in leg["batches"]]
        model = build_model(leg.get("model", "tiny"), dtype=leg["dtype"],
                            **dict({"attn_impl": "flash"},
                                   **leg.get("model_kw", {})))
        np_tree = unflat({k: v for k, v in raw.items()
                          if k.startswith(leg["params_prefix"])}
                         )[leg["params_prefix"].rstrip("/")]
        topo = MeshTopology(leg["sizes"]) if leg["pass_topology"] else None
        if leg["local_params"]:
            params = shard_params_from_jax(
                np_tree, model.config, MeshTopology(leg["sizes"]),
                cfg["zero_optimization"]["stage"])
        else:
            params = params_from_jax(np_tree, model.config, device="cpu")
        loss_fn = None
        if leg.get("loss"):
            model, loss_fn = custom_loss(leg["loss"], model)
        if leg.get("census"):
            # telemetry into a pod stream directory; the last step counted
            # op by op (the MFU roofline and the dtype audit ride it)
            cfg = dict(cfg, comms_logger={"enabled": True}, telemetry={
                "enabled": True, "output_dir": os.path.join(
                    out, f"pod_{name}"),
                "mfu": {"enabled": True, "step": leg["steps"] + 1}})
        eng, *_ = initialize(model=model, params=params, config=cfg,
                             loss_fn=loss_fn, topology=topo, device="cpu")
        if leg.get("load_state"):
            # a state the JAX package wrote: full leaves, cut to this
            # rank's shards by load_engine_state
            from deepspeedsyclsupport_tpu_torch.runtime import (
                engine as teng, engine_state_from_jax)

            st = dict(np.load(leg["load_state"]))
            eng.load_engine_state(
                engine_state_from_jax(
                    unflat({k[4:]: v for k, v in st.items()
                            if k.startswith("opt/")}),
                    teng._host_scaler(eng.scaler_state)),
                params=unflat({k[7:]: v for k, v in st.items()
                               if k.startswith("params/")}))
        comms = []
        if leg.get("comms"):
            comms_logger.configure(enabled=True)
        steps = []
        if leg.get("loader"):
            # the ranks' own rows, as the topology-aware loader hands them
            from deepspeedsyclsupport_tpu_torch.runtime.dataloader import (
                DSTpuDataLoader)

            feed = list(DSTpuDataLoader(
                batches, "cpu", prefetch=0, topology=eng.topology,
                gradient_accumulation_steps=eng.gradient_accumulation_steps()))
        else:
            feed = batches
        routes = []
        if leg.get("record_route"):
            # each routing call of the first step: this rank's logits and
            # its (expert, slot, kept) rows
            from deepspeedsyclsupport_tpu_torch.parallel import moe

            route = moe._capacity_route

            def recording(logits, k, cap, *a, **kw):
                out = route(logits, k, cap, *a, **kw)
                routes.append((logits.detach(), out[0], out[1], out[2],
                               cap))
                return out

            moe._capacity_route = recording
        for i, b in enumerate(feed[:leg["steps"]]):
            comms_logger.reset()
            m = eng.train_batch(b)
            comms.append({k: v["total_bytes"] for k, v in
                          comms_logger.snapshot().items()})
            if i == 0 and leg.get("record_route"):
                moe._capacity_route = route
            steps.append([float(m["loss"]), float(m["grad_norm"]),
                          float(bool(m["finite"])), float(m["loss_scale"])]
                         + ([float(m["lm_loss"]), float(m["moe_aux_loss"])]
                            if "moe_aux_loss" in m else []))
        census = run_census(eng) if leg.get("census") else None
        full = gather_params(eng)
        comms_logger.configure(enabled=False)
        # every layout saves across ranks: the tag's params, read back on
        # rank 0, equal the gathered ones
        path = eng.save_checkpoint(os.path.join(out, f"ckpt_{name}"))
        res = {"steps": np.array(steps),
               "ckpt_equal": np.array(rank != 0 or tag_equals(
                   path, full, model.config)),
               "comms": np.array(json.dumps(comms)),
               "skipped": np.array(eng.skipped_steps),
               "eval": np.array(float(eng.eval_batch(batches[0])))}
        if census is not None:
            res["census"] = np.array(json.dumps(census))
        for i, (lg, ex, pos, keep, cap) in enumerate(routes):
            res[f"route/{i}/logits"] = lg.numpy()
            res[f"route/{i}/expert"] = ex.numpy()
            res[f"route/{i}/pos"] = pos.numpy()
            res[f"route/{i}/keep"] = keep.numpy()
            res[f"route/{i}/cap"] = np.array(cap)
        for k, v in flat(eng.params):
            res[f"local/{k}"] = v.detach().numpy()
        if leg.get("opt_state"):
            from deepspeedsyclsupport_tpu_torch.checkpoint.engine import (
                _flatten)

            # this rank's moments in the JAX layout (a checkpoint's
            # _state_tree gathers them whole)
            mine = eng.optimizer.state_tree(
                lambda ts, per_leaf=False: eng._moments_layout(
                    [t.detach() for t in ts], per_leaf), eng._clip)
            for path, v in _flatten(mine):
                v = v() if callable(v) else v
                res["opt/" + "/".join(map(str, path))] = np.asarray(
                    v.numpy() if isinstance(v, torch.Tensor) else v)
        if full is not None:
            for k, v in flat(full):
                res[f"full/{k}"] = v
        np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), **res)
        del eng
        reset_world_topology()
    if spec.get("configs"):
        # configs that raise at initialize, after the legs in one spawn
        run_scope(spec, rank, out)
    if spec.get("p2p"):
        # the point-to-point cases, after the legs in the same spawn
        run_p2p(spec, rank, out)


# ------------------------------------------------------------------- ckpt
class Exited(Exception):
    """An engine's ``exit_fn`` called (the rc in ``args[0]``)."""


def _raise_exit(rc):
    raise Exited(rc)


def run_ckpt(spec, rank, out):
    """Checkpoints across ranks, leg by leg (``leg["type"]``): ``resume``
    (train, save, train; fresh ranks from another init load ``latest`` and
    repeat the last steps; optionally a JAX-written tag loaded and stepped
    once), ``reshard`` (a tag loaded at this spawn's layout: the rank's
    params and moments, then one step), ``async`` (the async engine, a
    pod-torn newer tag, the agreed resume), ``tags`` (tag validation and
    resume-tag agreement), ``preempt`` (a preemption on rank 1 alone) and
    ``sentinel`` (a NaN on rank 1)."""
    import logging

    from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
    from deepspeedsyclsupport_tpu_torch.runtime import (gather_params,
                                                        initialize)
    from deepspeedsyclsupport_tpu_torch.utils.fault_injection import (
        configure_fault_injection)

    raw = dict(np.load(spec["params"]))
    batches = [dict(np.load(p)) for p in spec["batches"]]

    def engine(leg, prefix):
        model = build_model(leg.get("model", "tiny"), dtype="float32",
                            attn_impl="flash")
        tree = unflat({k: v for k, v in raw.items() if k.startswith(prefix)}
                      )[prefix.rstrip("/")]
        return initialize(model=model, config=leg["config"], device="cpu",
                          params=params_from_jax(tree, model.config,
                                                 device="cpu"))[0]

    def row(m):
        return [float(m["loss"]), float(m["grad_norm"]),
                float(bool(m["finite"])), float(m["loss_scale"])]

    def train(eng, idx):
        return [row(eng.train_batch(batches[i])) for i in idx]

    def full(eng, key, res):
        tree = gather_params(eng)
        if tree is not None:
            # a copy: on the CPU an unsharded leaf's array views the param
            res.update({f"{key}/{k}": np.array(v) for k, v in flat(tree)})

    for leg in spec["legs"]:
        name, kind = leg["name"], leg["type"]
        d = os.path.join(out, f"ckpt_{name}")
        res = {}
        if kind == "resume":
            eng = engine(leg, leg["params_prefix"])
            n, k = leg["steps"], leg["save_at"]
            steps = train(eng, range(k))
            full(eng, "saved", res)
            res["path"] = np.array(eng.save_checkpoint(d))
            steps += train(eng, range(k, n))
            full(eng, "final1", res)
            res["steps1"] = np.array(steps)
            del eng
            reset_world_topology()
            eng = engine(leg, leg["alt_prefix"])
            res["loaded"] = np.array(eng.load_checkpoint(d)[0])
            res["steps2"] = np.array(train(eng, range(k, n)))
            full(eng, "final2", res)
            if leg.get("jax_tag"):
                del eng
                reset_world_topology()
                eng = engine(leg, leg["alt_prefix"])
                eng.load_checkpoint(*os.path.split(leg["jax_tag"]))
                res["steps_jax_tag"] = np.array(train(eng, [k]))
        elif kind == "reshard":
            eng = engine(leg, leg["alt_prefix"])
            eng.load_checkpoint(*os.path.split(leg["load"]))
            # copies: the step below updates the tensors in place
            for k, v in flat(eng.params):
                res[f"local/{k}"] = v.detach().numpy().copy()
            for i, path in enumerate(eng._float_paths):
                res[f"mu/{i}"] = eng.optimizer.mu[i].numpy().copy()
                res[f"nu/{i}"] = eng.optimizer.nu[i].numpy().copy()
                res[f"spec/{i}"] = np.array(json.dumps(
                    [list(e) for e in eng._update_specs[path]]))
            res["count"] = np.array(eng.optimizer.count)
            res["steps"] = np.array(train(eng, [leg["step"]]))
        elif kind == "async":
            eng = engine(leg, leg["params_prefix"])
            train(eng, [0])
            first = eng.save_checkpoint(d)
            train(eng, [1])
            configure_fault_injection({"tear_pod": {"rank": 0,
                                                    "drop": "commit"}})
            eng.save_checkpoint(d)
            eng.checkpoint_engine.wait()
            configure_fault_injection({})
            res["first"] = np.array(first)
            res["loaded"] = np.array(eng.load_checkpoint(d)[0])
            res["steps"] = np.array(eng.global_steps)
        elif kind == "tags":
            eng = engine(leg, leg["params_prefix"])
            seen = []
            handler = logging.Handler()
            handler.emit = lambda r: seen.append(r.getMessage())
            log = logging.getLogger(
                "deepspeedsyclsupport_tpu_torch.runtime.engine")
            log.addHandler(handler)
            mine = f"t{rank % 2}"
            for mode in ("Fail", "Warn", "Ignore"):
                eng.config.checkpoint.tag_validation = mode
                del seen[:]
                try:
                    if mode == "Fail":
                        eng.save_checkpoint(d, tag=mine)
                    else:
                        eng._validate_tag(mine)
                    res[f"{mode}/raised"] = np.array("")
                except RuntimeError as e:
                    res[f"{mode}/raised"] = np.array(str(e))
                res[f"{mode}/logged"] = np.array(json.dumps(seen))
            eng.config.checkpoint.tag_validation = "Fail"
            eng._validate_tag("same")   # equal tags pass
            res["agreed"] = np.array(eng._agree_resume_tag(
                f"global_step{rank}"))
            log.removeHandler(handler)
            res["saved_nothing"] = np.array(not os.path.exists(d))
            from deepspeedsyclsupport_tpu_torch.utils.podid import (
                pod_identity)

            res["pod"] = np.array(pod_identity())
        elif kind == "preempt":
            eng = engine(leg, leg["params_prefix"])
            if rank == 1:
                configure_fault_injection({"preempt_at_step": 2})
            eng.enable_preemption_handling(d, install_signal_handlers=False,
                                           exit_fn=_raise_exit)
            rc, steps = None, []
            try:
                for i in range(4):
                    steps.append(row(eng.train_batch(batches[i])))
            except Exited as e:
                rc = e.args[0]
            configure_fault_injection({})
            res.update(rc=np.array(rc), at=np.array(eng.global_steps),
                       steps=np.array(steps))
        elif kind == "sentinel":
            if rank == 1:
                configure_fault_injection({"nan_step": {"rank": 1,
                                                        "step": 3}})
            cfg = dict(leg["config"], sentinel=dict(
                leg["sentinel"], journal_dir=d))
            eng = engine(dict(leg, config=cfg), leg["params_prefix"])
            steps = []
            for b in batches[:leg["steps"]]:
                m = eng.train_batch(b)
                steps.append(row(m))
            configure_fault_injection({})
            res["steps"] = np.array(steps)
            res["count"] = np.array(eng.optimizer.count)
            full(eng, "final", res)
        np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), **res)
        del eng
        reset_world_topology()


def launch(spec, out_dir, world: int = 4, timeout: float = 240.0,
           script: str = None):
    """Run ``spec`` on ``world`` ranks (one subprocess each, the env://
    variables set, a free localhost port) and wait for them; raises with
    the ranks' stderr when one fails. ``script``: the worker each rank
    runs (default: this file)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = dict(spec, out=str(out_dir))
    path = os.path.join(str(out_dir), f"spec_{spec['kind']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__), path],
            env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(f"rank {r} rc {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise RuntimeError("\n".join(errs))


def main():
    spec = json.load(open(sys.argv[1]))
    torch.manual_seed(0)
    assert comm.init_distributed(backend="gloo", device_type="cpu",
                                 timeout_s=120)
    rank = comm.get_rank()
    try:
        {"comm": run_comm, "comm_more": run_comm_more, "train": run_train,
         "p2p": run_p2p, "quant": run_quant, "scope": run_scope,
         "ckpt": run_ckpt}[
            spec["kind"]](spec, rank, spec["out"])
    finally:
        comm.destroy_process_group()


if __name__ == "__main__":
    main()
