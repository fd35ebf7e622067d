"""One rank of the port's serving tests across ranks (not a test module).

Run as ``python tests/torch_serve_worker.py <spec.json>`` with the torch
launcher's environment (``tests/torch_dist_worker.launch(...,
script=...)``): it starts a gloo process group, runs each leg of the spec
in turn on the CPU and writes this rank's results as
``<out>/<leg>_rank<r>.npz``. The weights are the JAX package's inits,
passed as ``<out>/params.npz`` (``init/`` for ``tiny``, ``moe/`` for
``tiny-moe``). Leg kinds:

* ``put`` — ``InferenceEngineV2(topology=)``: a prompt's prefill logits, one
  decode step's logits, then greedy ``generate`` with the per-token decode
  and with the fused K-step decode;
* ``prefix`` — ``generate`` with the prefix cache on and off: tokens and
  the cache's statistics;
* ``snapshot`` — ``deserialize(topology=)`` of a JAX-written snapshot, its
  logits, and ``serialize`` of the engine back (rank 0 writes); then the
  error each broken copy of the snapshot raises (``leg["broken"]``: a
  flipped byte, a leaf's shape changed);
* ``int8`` — ``quantize_weights`` under TP or EP: this rank's codes and
  scales of layer 0 (``wq`` and the MLP's or the experts' ``w_gate`` /
  ``w_down``), and the logits;
* ``v1`` — ``init_inference`` with ``tensor_parallel``: greedy tokens of a
  right-padded batch, ``forward`` logits;
* ``session`` — ``ServingSession`` over the engine under :data:`SESSION`'s
  traffic: rank 0's session reads a :class:`TickClock`, every other rank's
  one that reads other values (never read: the session takes rank 0's);
  the events, counters, stats, summary and trace ring as JSON;
* ``replay`` — ``recover_requests`` of a journal (``leg["journal"]``,
  written by the port's session at a world of one) into a journaled
  session under ``TickClock(200)``, driven to idle: its events, counters,
  and the journal files each rank's session wrote (``leg["jdir"]``).

It imports torch and the port, never jax.
"""
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deepspeedsyclsupport_tpu_torch import comm  # noqa: E402
from deepspeedsyclsupport_tpu_torch.checkpoint.engine import (  # noqa: E402
    CheckpointCorruptionError)
from deepspeedsyclsupport_tpu_torch.comm.topology import (  # noqa: E402
    build_topology, reset_world_topology)
from deepspeedsyclsupport_tpu_torch.compression.quantize import (  # noqa: E402
    QuantTensor)
from deepspeedsyclsupport_tpu_torch.inference import init_inference  # noqa: E402
from deepspeedsyclsupport_tpu_torch.inference.v2 import (  # noqa: E402
    InferenceEngineV2, ServingPolicyConfig, ServingSession)
from deepspeedsyclsupport_tpu_torch.inference.v2 import (  # noqa: E402
    supervisor as sup)
from deepspeedsyclsupport_tpu_torch.monitor import (  # noqa: E402
    telemetry as tel)
from deepspeedsyclsupport_tpu_torch.models import (  # noqa: E402
    build_model, params_from_jax)
from tests.torch_dist_worker import unflat  # noqa: E402

ENGINE_KW = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
                 max_sequences=4)
PROMPT = [1, 5, 9, 200, 3, 77]
PROMPTS = [[1, 5, 9], [7, 2], [4, 100, 42, 8, 19]]
NEW = 8
# the prefix leg: a 16-token head (two 8-token blocks) shared by the tails
HEAD = list(range(40, 56))
TAILS = [[3, 7, 11], [9, 2], [5, 5, 6, 1]]
# the session legs' traffic: two tenants, 10 requests (the first 6 each
# followed by a round, the rest at once), a pool of 8 blocks with victims
# requeued (evictions), a tight TTFT SLA (sheds), fused K = 4
SESSION = dict(engine=dict(num_blocks=8, decode_steps_per_dispatch=4),
               policy=dict(preempt_policy="requeue", ttft_sla_s=0.15,
                           prefill_tok_s_prior=200.0),
               seed=1, n=10, paced=6)


class TickClock:
    """Advances ``dt`` on every call: sessions that call the clock in the
    same order see the same times."""

    def __init__(self, t: float = 100.0, dt: float = 0.01):
        self.t = t
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def session_requests():
    rng = np.random.RandomState(SESSION["seed"])
    return [(u, rng.randint(1, 500, rng.randint(6, 20)).tolist(),
             int(rng.randint(6, 14))) for u in range(SESSION["n"])]


def drive_session(sess, requests=None, max_rounds=500):
    """Submit the traffic (two tenants), stepping after each of the first
    ``SESSION["paced"]``, then step to idle; returns the events."""
    events = []
    for i, (u, toks, n) in enumerate(requests or session_requests()):
        sess.submit(u, toks, n, tenant="ab"[u % 2])
        if i < SESSION["paced"]:
            events += sess.step()
    rounds = 0
    while not sess.idle:
        events += sess.step()
        rounds += 1
        assert rounds < max_rounds, "session did not converge"
    return events


def session_result(sess, events):
    """Everything of a session run that must be equal, as plain data."""
    return {"events": [(e.kind, e.uid, e.t, [int(x) for x in e.tokens],
                        e.reason) for e in events],
            "counters": dict(sess.counters),
            "recovery": dict(sess.recovery_counters),
            "stats": sess.stats(),
            "summary": [list(x) for x in sess.summary_events(step=3)],
            "rounds": sorted([r["data"].get("mode"), r["data"].get("k")]
                             for r in sess.trace_log
                             if r["data"].get("stage") == "decode_round"),
            "dispatches": sess.eng.host_dispatches}


def rank_clock(rank):
    """Rank 0's clock, and on the others one that reads other values."""
    return TickClock() if rank == 0 else TickClock(5e5 + rank, 3.7)


def load_params(out, model_name):
    prefix = {"tiny": "init/", "tiny-moe": "moe/"}[model_name]
    with np.load(os.path.join(out, "params.npz")) as z:
        tree = unflat({k[len(prefix):]: z[k] for k in z.files
                       if k.startswith(prefix)})
    model = build_model(model_name, dtype="float32")
    return model, params_from_jax(tree, model.config, device="cpu")


def topo_of(axes):
    return build_topology(dp=-1, tp=axes.get("tp", 1), ep=axes.get("ep", 1))


def engine(model, params, topo, **kw):
    return InferenceEngineV2(model, params, device="cpu", topology=topo,
                             dtype=torch.float32, **dict(ENGINE_KW, **kw))


def run_put(leg, model, params, topo):
    eng = engine(model, params, topo)
    prefill = eng.put([1], [PROMPT])[1]
    nxt = int(torch.argmax(prefill))
    decode = eng.put([1], [[nxt]])[1]
    eng.flush([1])
    toks = eng.generate(PROMPTS, max_new_tokens=NEW)
    fused = engine(model, params, topo, decode_steps_per_dispatch=4)
    ftoks = fused.generate(PROMPTS, max_new_tokens=NEW)
    return {"prefill": prefill.numpy(), "decode": decode.numpy(),
            "tokens": np.array(toks), "fused_tokens": np.array(ftoks),
            "counts": np.array([eng.graph_replays, eng.eager_decodes,
                                fused.graph_replays, fused.eager_decodes,
                                fused.host_dispatches]),
            "kv_heads": np.array(eng.kv.k.shape[2])}


def run_prefix(leg, model, params, topo):
    res = {}
    for on in (True, False):
        eng = engine(model, params, topo)
        if on:
            eng.install_prefix_cache()
        first = eng.generate([HEAD + [1, 2]], max_new_tokens=4)
        toks = eng.generate([HEAD + t for t in TAILS], max_new_tokens=4)
        tag = "on" if on else "off"
        res[f"tokens_{tag}"] = np.array(first + toks)
        if on:
            st = eng.prefix_cache.stats()
            res["stats"] = np.array(json.dumps(st, sort_keys=True))
    return res


def run_snapshot(leg, model, params, topo):
    eng = InferenceEngineV2.deserialize(leg["snapshot"], device="cpu",
                                        topology=topo)
    logits = eng.put([1], [PROMPT])[1]
    eng.flush([1])
    eng.serialize(leg["save"])
    res = {"prefill": logits.numpy(),
           "wq_shape": np.array(eng.params["layers"][0]["attn"]["wq"].shape)}
    for tag, path in leg["broken"].items():
        try:
            InferenceEngineV2.deserialize(path, device="cpu", topology=topo)
            res[f"{tag}_error"] = np.array("loaded")
        except (CheckpointCorruptionError, ValueError) as err:
            res[f"{tag}_error"] = np.array(f"{type(err).__name__}: {err}")
    return res


def run_int8(leg, model, params, topo):
    eng = engine(model, params, topo, quantize_weights=True,
                 quant_group_size=leg["group"])
    res = {"prefill": eng.put([1], [PROMPT])[1].numpy()}
    eng.flush([1])
    layer = eng.params["layers"][0]
    mlp = layer["moe"] if "moe" in layer else layer["mlp"]
    for name, leaf in (("wq", layer["attn"]["wq"]),
                       ("w_gate", mlp["w_gate"]), ("w_down", mlp["w_down"])):
        assert isinstance(leaf, QuantTensor), name
        res[f"{name}_q"] = leaf.q.numpy()
        res[f"{name}_scale"] = leaf.scale.numpy()
        res[f"{name}_group"] = np.array(leaf.group_size)
    return res


def run_v1(leg, model, params, topo):
    eng = init_inference(model=model, params=params, device="cpu",
                         topology=topo, dtype="fp32",
                         tensor_parallel={"tp_size": leg["axes"]["tp"]})
    batch = np.zeros((2, 5), np.int64)
    batch[0, :3] = PROMPTS[0]
    batch[1] = PROMPTS[2]
    toks = eng.generate(torch.from_numpy(batch), prompt_lens=[3, 5],
                        max_new_tokens=NEW)
    logits = eng(torch.tensor([[1, 2, 3, 4]]))
    return {"tokens": toks.numpy(), "forward": logits.numpy(),
            "kv_heads": np.array(model.config.num_kv_heads // eng.tp)}


def run_session(leg, model, params, topo):
    tel.metrics_registry.reset()
    tel.resilience_counters.reset()
    eng = engine(model, params, topo, **SESSION["engine"])
    sess = ServingSession(eng, ServingPolicyConfig(**SESSION["policy"]),
                          clock=rank_clock(comm.get_rank()))
    res = session_result(sess, drive_session(sess))
    sess.close()
    return {"result": np.array(json.dumps(res))}


def run_replay(leg, model, params, topo):
    tel.metrics_registry.reset()
    tel.resilience_counters.reset()
    eng = engine(model, params, topo, decode_steps_per_dispatch=4)
    states, last_t = sup.load_journal(leg["journal"])
    clock = TickClock(200.0) if comm.get_rank() == 0 else \
        TickClock(-7.0, 0.5)
    sess = ServingSession(eng, ServingPolicyConfig(
        journal_path=sup.journal_path(leg["jdir"], attempt=1)), clock=clock)
    summary = sup.recover_requests(sess, states, last_t)
    events = []
    while not sess.idle:
        events += sess.step()
    res = dict(session_result(sess, events),
               replayed=sorted(summary["replayed"]))
    sess.close()
    comm.barrier()
    res["files"] = sorted(os.listdir(leg["jdir"]))
    return {"result": np.array(json.dumps(res))}


RUNNERS = {"put": run_put, "prefix": run_prefix, "snapshot": run_snapshot,
           "int8": run_int8, "v1": run_v1,
           "session": run_session, "replay": run_replay}


def main():
    spec = json.load(open(sys.argv[1]))
    torch.manual_seed(0)
    assert comm.init_distributed(backend="gloo", device_type="cpu",
                                 timeout_s=120)
    rank = comm.get_rank()
    out = spec["out"]
    try:
        for leg in spec["legs"]:
            model, params = load_params(out, leg["model"])
            topo = topo_of(leg["axes"])
            res = RUNNERS[leg["kind"]](leg, model, params, topo)
            np.savez(os.path.join(out, f"{leg['name']}_rank{rank}.npz"),
                     **res)
            reset_world_topology()
    finally:
        comm.destroy_process_group()


if __name__ == "__main__":
    main()
