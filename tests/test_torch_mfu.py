"""PyTorch port: the MFU ledger, the roofline and the flops profiler against
the JAX package, on the CPU.

* ``monitor/mfu.py``'s stdlib half (trace parse with torn-gzip salvage,
  the region measurement, the ledger, its events and its text): EQUAL to
  the JAX package's on the same inputs; ``analysis/roofline.py``'s
  ``roofline_table``: EQUAL on the same costs.
* The port's trace join on the CPU: one ``tiny`` engine step under
  ``torch.profiler`` (host ops only); every matmul of its forward AND
  backward lands in the region of a dot of the JAX engine's compiled step
  that does the same FLOPs (the JAX opmap, ``monitor/mfu.build_opmap``
  over its HLO), and every such dot is matched.
* ``region_costs`` and the flops profiler over one counted step: the
  matmul FLOPs of every region EQUAL the JAX jaxpr's ``dot_general``
  FLOPs of that region; the totals within the limits stated at
  ``TOTAL_TOL``, from the measured gaps: the two packages spell the same
  loss, norms and update with different elementwise ops.
* The flash wrappers' self-reported count (what a CUDA launch reports)
  EQUALS the plain version's dispatch count of its products at a
  non-causal shape; the visible-pair count equals a brute-force count.
* ``device_spec`` maps ``"NVIDIA H100 80GB HBM3"`` to the H100 row.

One JAX engine step is shared by the module (module-scope fixture).
"""
import gzip
import json
import math
import re
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch

import deepspeedsyclsupport_tpu as dstpu
from deepspeedsyclsupport_tpu.analysis import roofline as jroof
from deepspeedsyclsupport_tpu.analysis.jaxpr_walk import iter_eqns
from deepspeedsyclsupport_tpu.comm.topology import build_topology
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.monitor import mfu as jmfu
from deepspeedsyclsupport_tpu.profiling import flops_profiler as jfp
from deepspeedsyclsupport_tpu_torch import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.analysis import roofline as troof
from deepspeedsyclsupport_tpu_torch.monitor import mfu as tmfu
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as fa
from deepspeedsyclsupport_tpu_torch.profiling import flops_profiler as tfp
from deepspeedsyclsupport_tpu_torch.runtime import engine as teng

SEQ = 32
CFG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}},
    "steps_per_print": 1000,
}
# |port / JAX - 1| of the FLOP totals (all kinds): the whole step's, the
# product-dominated regions' and the rest's. Measured on this step (CPU):
# -0.0228 whole step; attn -0.0021, mlp +0.0022, head +0.0010; loss
# -0.170, optimizer -0.476, other -0.464 (elementwise ops spelled
# differently: optax's AdamW against the port's foreach AdamW, XLA's
# four-pass logsumexp and norm chains against torch's fused ops)
TOTAL_TOL = {"step": 0.03, "attn": 0.01, "mlp": 0.01, "head": 0.01,
             "loss": 0.5, "optimizer": 0.5, "other": 0.5}


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, 512, (4, SEQ)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX engine's compiled step (HLO text) and traced step (jaxpr)
    after one train_batch, with its initial params."""
    jmodel = jax_build_model("tiny", dtype="float32")
    jparams = jax.tree.map(np.asarray,
                           jmodel.init_params(jax.random.PRNGKey(3)))
    topo = build_topology(dp=1, devices=jax.devices()[:1])
    eng = dstpu.initialize(model=jmodel, config=CFG, topology=topo,
                           params=jax.tree.map(jax.numpy.asarray,
                                               jparams))[0]
    eng.train_batch({k: jax.numpy.asarray(v) for k, v in _batch().items()})
    avals = eng._last_train_avals
    hlo = eng._train_batch_fn.lower(*avals).compile().as_text()
    jaxpr = jax.make_jaxpr(eng._train_batch_raw)(*avals)
    return {"hlo": hlo, "jaxpr": jaxpr, "params": jparams}


def _port_engine(jparams, **extra):
    model = build_model("tiny", dtype="float32")
    params = params_from_jax(jparams, model.config, device="cpu")
    return teng.initialize(model=model, params=params,
                           config=dict(CFG, **extra), device="cpu")[0]


# ====================================================== the stdlib half
def _trace(tmp_path):
    """A two-thread Chrome trace: nested ops, a while-like container,
    an unmapped op."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1}]
    t = 100.0
    for tid in (1, 2):
        ev.append({"ph": "X", "name": "while.1", "pid": 1, "tid": tid,
                   "ts": t, "dur": 50.0})
        ev.append({"ph": "X", "name": "dot.2", "pid": 1, "tid": tid,
                   "ts": t + 5, "dur": 20.0})
        ev.append({"ph": "X", "name": "fusion.3", "pid": 1, "tid": tid,
                   "ts": t + 30, "dur": 10.0})
        ev.append({"ph": "X", "name": "ghost.9", "pid": 1, "tid": tid,
                   "ts": t + 60, "dur": 5.0, "args": {"hlo_op": "g"}})
        t += 25.0
    ev.append({"ph": "X", "name": "all-reduce.4", "pid": 1, "tid": 3,
               "ts": 120.0, "dur": 40.0})
    raw = json.dumps({"traceEvents": ev}).encode()
    whole = tmp_path / "t.trace.json.gz"
    whole.write_bytes(gzip.compress(raw))
    torn = tmp_path / "torn.trace.json.gz"
    torn.write_bytes(gzip.compress(raw)[: int(len(gzip.compress(raw))
                                              * 0.7)])
    return whole, torn


OPMAP = {"while.1": {"region": "other", "category": "control",
                     "opcode": "while"},
         "dot.2": {"region": "attn", "category": "dot", "opcode": "dot"},
         "fusion.3": {"region": "mlp", "category": "fusion",
                      "opcode": "fusion"},
         "all-reduce.4": {"region": "collective", "category": "collective",
                          "opcode": "all-reduce"}}


def test_stdlib_half_equals_jax(tmp_path):
    whole, torn = _trace(tmp_path)
    costs = {"attn": {"flops": 4e9, "hbm_bytes": 1e8, "comm_bytes": 0.0,
                      "n_eqns": 3},
             "mlp": {"flops": 8e9, "hbm_bytes": 3e8, "comm_bytes": 0.0,
                     "n_eqns": 2},
             "collective": {"flops": 0.0, "hbm_bytes": 0.0,
                            "comm_bytes": 5e7, "n_eqns": 1}}
    spec = dict(name="h100-sxm", peak_flops=989e12, hbm_gbps=3350.0,
                ici_gbps=450.0)
    jt = jroof.roofline_table(costs, jroof.DeviceSpec(**spec),
                              census_bytes=1e6)
    tt = troof.roofline_table(costs, troof.DeviceSpec(**spec),
                              census_bytes=1e6)
    assert tt == jt
    for path in (whole, torn):
        jev, jmeta = jmfu.parse_trace(str(path))
        tev, tmeta = tmfu.parse_trace(str(path))
        assert (tev, tmeta) == (jev, jmeta)
        jm = jmfu.measure_regions(jev, OPMAP, steps=1)
        tm = tmfu.measure_regions(tev, OPMAP, steps=1)
        assert tm == jm
        for step_s in (1e-4, 5e-5):
            jl = jmfu.ledger(jt, jm, step_s, jmeta["truncated"])
            tl = tmfu.ledger(tt, tm, step_s, tmeta["truncated"])
            assert tl == jl
            assert tmfu.ledger_events(tl, 7) == jmfu.ledger_events(jl, 7)
            assert tmfu.render_ledger(tl) == jmfu.render_ledger(jl)
            assert tmfu.validate_ledger(tl) == []
    assert tmfu.parse_trace(str(torn))[1]["truncated"]
    assert tmfu.find_trace(str(tmp_path)) is not None


def test_region_scope_raises_on_an_undeclared_region():
    with pytest.raises(ValueError, match="undeclared MFU region"):
        tmfu.region_scope("atn")
    assert tmfu.SCOPE_REGIONS == jmfu.SCOPE_REGIONS
    assert tmfu.REGIONS == jmfu.REGIONS


def test_device_spec_maps_h100_to_its_row():
    spec = troof.device_spec("NVIDIA H100 80GB HBM3")
    assert spec is troof.DEVICE_SPECS["h100-sxm"]
    assert (spec.peak_flops, spec.hbm_gbps, spec.ici_gbps) == \
        (989e12, 3350.0, 450.0)
    assert not any(k.startswith("tpu") for k in troof.DEVICE_SPECS)
    other = troof.device_spec("NVIDIA A100-SXM4-80GB")
    assert "unknown" in other.name and other.peak_flops == spec.peak_flops
    assert troof.device_spec("cpu", calibrate_cpu=False).name == "cpu"


# ======================================================= the trace join
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
_DOT_RE = re.compile(r"\bdot\(%([\w.\-]+), %[\w.\-]+\).*?"
                     r"lhs_contracting_dims=\{([\d,]*)\}")


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def _jax_dot_regions(hlo):
    """{FLOPs of a dot: {regions of the dots doing them}} over the JAX
    compiled step (region from the JAX opmap; shapes from the operands'
    definitions)."""
    opmap = jmfu.build_opmap(hlo)
    shapes = {}
    for line in hlo.splitlines():
        d = _DEF_RE.match(line)
        if d:
            shapes[d.group(1)] = _ints(d.group(2))
    out = defaultdict(set)
    for line in hlo.splitlines():
        d, m = _DEF_RE.match(line), _DOT_RE.search(line)
        if not d or not m:
            continue
        lhs = shapes[m.group(1)]
        flops = 2.0 * math.prod(_ints(d.group(2))) * math.prod(
            lhs[c] for c in _ints(m.group(2)))
        out[flops].add(opmap[d.group(1)]["region"])
    return out


def _port_dot_flops(ev):
    dims = ev["args"]["Input Dims"]
    name = ev["name"]
    if name == "aten::mm":
        (m, k), (_, n) = dims[:2]
        return 2.0 * m * k * n
    if name == "aten::addmm":
        (m, k), (_, n) = dims[1:3]
        return 2.0 * m * k * n
    if name == "aten::bmm":
        (b, m, k), (_, _, n) = dims[:2]
        return 2.0 * b * m * k * n
    raise AssertionError(f"unexpected product {name}")


def test_cpu_trace_join_puts_every_matmul_in_the_jax_dot_region(
        jax_step, tmp_path):
    want = _jax_dot_regions(jax_step["hlo"])
    assert want, "no dot parsed from the JAX step's HLO"
    eng = _port_engine(jax_step["params"])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        eng.train_batch(_batch())
    path = str(tmp_path / "step.trace.json.gz")
    prof.export_chrome_trace(path)
    events, _ = tmfu.parse_trace(path)
    opmap = tmfu.build_opmap(events, cpu_ops=True)
    got = defaultdict(list)
    for key, info in opmap.items():
        if info["opcode"] in ("aten::mm", "aten::addmm", "aten::bmm"):
            ev = events[int(key.split(":", 1)[0])]
            got[_port_dot_flops(ev)].append(info["region"])
    # 2 layers x 2 micro-batches: attn 4 projections + 2 products, mlp 3
    # projections, the head 1, each with two products in the backward
    n = sum(len(v) for v in got.values())
    assert n == 3 * (2 * 2 * (4 + 2 + 3) + 2 * 1)
    for flops, regions in got.items():
        assert flops in want, f"no JAX dot does {flops} FLOPs"
        assert set(regions) <= want[flops], (flops, regions, want[flops])
    assert set(want) == set(got)
    assert {r for rs in got.values() for r in rs} == {"attn", "mlp", "head"}


# ============================================== region costs + profiler
def _jax_matmul_by_region(jaxpr):
    out = defaultdict(float)
    for eqn, mult in iter_eqns(jaxpr.jaxpr):
        if eqn.primitive.name == "dot_general":
            region = jroof._eqn_region(eqn) or "other"
            out[region] += jfp._dot_flops(eqn) * mult
    return out


def test_region_costs_and_flops_profiler_match_the_jaxpr(jax_step,
                                                         tmp_path):
    out_file = tmp_path / "flops.txt"
    eng = _port_engine(jax_step["params"], flops_profiler={
        "enabled": True, "profile_step": 1, "output_file": str(out_file)})
    eng.train_batch(_batch())
    counter = eng.flops_profiler.counter
    costs = troof.region_costs(counter)
    jcosts = jroof.region_costs(jax_step["jaxpr"])
    jmat = _jax_matmul_by_region(jax_step["jaxpr"])
    for region in tmfu.REGIONS:
        if region == "host":
            continue
        assert costs[region]["matmul_flops"] == jmat.get(region, 0.0), \
            region
    assert sum(jmat.values()) > 0
    total = sum(c["flops"] for c in costs.values())
    jtotal = sum(c["flops"] for c in jcosts.values())
    assert abs(total / jtotal - 1) <= TOTAL_TOL["step"]
    for region, c in jcosts.items():
        if c["flops"]:
            assert abs(costs[region]["flops"] / c["flops"] - 1) <= \
                TOTAL_TOL[region], region
        else:
            assert costs[region]["flops"] == 0.0, region
    # the profiler's profile is the counter's total, written to the file
    prof = eng.flops_profiler.profile
    assert prof.total_flops == total
    assert prof.total_params == sum(t.numel() for t in eng._leaf_tensors)
    assert "flops profiler @ step 1" in out_file.read_text()
    # the roofline prices every region against the calibrated CPU spec
    table = troof.roofline_table(costs, troof.device_spec("cpu"))
    assert table["total_flops"] == total
    assert table["regions"]["attn"]["bound_by"] in ("compute", "memory")


# ==================================================== flash self-report
def test_flash_self_report_equals_the_plain_dispatch_count():
    g = torch.Generator().manual_seed(0)
    b, sq, skv, h, kvh, d = 2, 48, 40, 4, 2, 16
    q = torch.randn(b, sq, h, d, generator=g, requires_grad=True)
    k = torch.randn(b, skv, kvh, d, generator=g, requires_grad=True)
    v = torch.randn(b, skv, kvh, d, generator=g, requires_grad=True)
    with tfp.OpCounter() as plain:
        fa.flash_attention(q, k, v, causal=False).sum().backward()
    mask = fa.make_mask(q, k, causal=False)
    do = torch.zeros_like(q)
    lse = torch.zeros(b, h, sq)
    with tfp.OpCounter() as reported:
        # exactly what flash_fwd, flash_dq and flash_dkv report at launch
        fa._report("flash_fwd", q, k, mask, (q, k, v))
        fa._report("flash_dq", q, k, mask, (q, k, v, do, lse))
        fa._report("flash_dkv", q, k, mask, (q, k, v, do, lse))
    assert reported.total_flops("matmul") == plain.total_flops("matmul")
    assert sum(reported.pairs.values()) == 3 * b * h * sq * skv
    assert {r for r, _ in reported.pairs} == {"other"}


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_visible_pairs_count_the_mask(causal, window):
    b, sq, skv, h = 2, 24, 32, 3
    q = torch.zeros(b, sq, h, 8)
    k = torch.zeros(b, skv, h, 8)
    mask = fa.make_mask(q, k, causal=causal, window=window)
    pq = torch.arange(sq)[:, None] + skv - sq
    pk = torch.arange(skv)[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        vis &= pk <= pq
    if window is not None:
        vis &= pq - pk < window
    assert fa.visible_pairs(mask, b, h, sq, skv) == b * h * int(vis.sum())
    seg = torch.zeros(b, sq, dtype=torch.int32)
    assert fa.visible_pairs(fa.make_mask(q, q, segment_ids=seg), b, h, sq,
                            sq) is None


def test_get_model_profile_counts_the_jax_forward_products(jax_step):
    """One forward of ``tiny`` (the reference's ``get_model_profile``):
    the port's products EQUAL the JAX profile's ``dot_general`` FLOPs."""
    jmodel = jax_build_model("tiny", dtype="float32")
    want = jfp.get_model_profile(jmodel, batch_size=2, seq_len=SEQ,
                                 params=jax_step["params"])
    model = build_model("tiny", dtype="float32")
    got = tfp.get_model_profile(model, batch_size=2, seq_len=SEQ,
                                params=params_from_jax(
                                    jax_step["params"], model.config,
                                    device="cpu"),
                                device="cpu")
    assert got.by_primitive["mm"] + got.by_primitive["bmm"] == \
        want.by_primitive["dot_general"]
    assert got.total_params == want.total_params
    assert "flops:" in got.summary()


def test_get_model_profile_without_a_device_means_the_card():
    """An entry point never drops to the CPU on its own: with no device,
    ``get_model_profile`` runs on the card, and raises where there is
    none."""
    model = build_model("tiny", dtype="float32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfp.get_model_profile(model, batch_size=1, seq_len=8)
        return
    got = tfp.get_model_profile(model, batch_size=1, seq_len=8)
    assert got.total_flops > 0
