"""One rank of the port's distributed CPU tests (not a test module).

Run as ``python tests/torch_dist_worker.py <spec.json>`` with the torch
launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``): it starts a gloo process group through
``comm.init_distributed`` (the env:// path), runs the spec's ``kind`` —
``"comm"`` (the façade's cases), ``"comm_more"`` (the rest of the
façade on 8 ranks), ``"p2p"`` (send / recv / p2p over ``pipe`` and the
differentiable collectives' gradients), ``"quant"`` (the quantized
collectives and ZeRO++'s gathers and reduces), ``"scope"`` (configs the
ZeRO++ step refuses) or ``"train"`` (legs of ``tiny`` or ``tiny-moe``
through ``initialize`` -> ``train_batch``) — and writes this rank's results as
``<out>/<leg>_rank<r>.npz``. It imports torch and the port, never jax.
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
def run_scope(spec, rank, out):
    """Each config of the spec through ``initialize``: the ValueError (or
    NotImplementedError) message it raises, or ``""``."""
    from deepspeedsyclsupport_tpu_torch import build_model
    from deepspeedsyclsupport_tpu_torch.runtime import initialize

    msgs = []
    for case in spec["configs"]:
        try:
            initialize(model=build_model("tiny", dtype="float32",
                                         **case["model_kw"]),
                       config=case["config"], device="cpu")
            msgs.append("")
        except (ValueError, NotImplementedError) as e:
            msgs.append(f"{type(e).__name__}: {e}")
        reset_world_topology()
    with open(os.path.join(out, f"scope_rank{rank}.json"), "w") as f:
        json.dump(msgs, f)


# ------------------------------------------------------------------ train
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
        eng, *_ = initialize(model=model, params=params, config=cfg,
                             topology=topo, device="cpu")
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
        full = gather_params(eng)
        try:   # checkpoints across ranks are not ported (A.3.3b)
            eng.save_checkpoint(os.path.join(out, f"ckpt_{name}_{rank}"))
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        comms_logger.configure(enabled=False)
        res = {"steps": np.array(steps), "ckpt_refused": np.array(refused),
               "comms": np.array(json.dumps(comms)),
               "skipped": np.array(eng.skipped_steps),
               "eval": np.array(float(eng.eval_batch(batches[0])))}
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

            for path, v in _flatten(eng._state_tree()["opt_state"]):
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


def launch(spec, out_dir, world: int = 4, timeout: float = 240.0):
    """Run ``spec`` on ``world`` ranks (one subprocess each, the env://
    variables set, a free localhost port) and wait for them; raises with
    the ranks' stderr when one fails."""
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
            [sys.executable, os.path.abspath(__file__), path], env=env,
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
         "p2p": run_p2p, "quant": run_quant, "scope": run_scope}[
            spec["kind"]](spec, rank, spec["out"])
    finally:
        comm.destroy_process_group()


if __name__ == "__main__":
    main()
