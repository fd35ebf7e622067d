"""PyTorch port: the comm census's analytic half, the graph analyzers, the
codebase lint and the MFU report CLI, against the JAX package, on the CPU.

* ``expected_train_collectives``: EQUAL (every field) to the JAX
  package's on the same param tree and specs, stages 0-3 over dp x fsdp
  meshes (a group of one member included), on JAX ``test_analysis.py``'s
  ``RectModel`` and on the ``tiny`` model's per-layer tree with the port's
  plan; the JAX function is its analytic one, never its compiled census.
* ``classify_collectives`` / ``check_collectives``: EQUAL classes, ``ok``
  and problems on the same synthetic census lists (the quantized
  one-byte-per-element signatures and the scalar class included), exact
  and not.
* The donation, dtype and resharding audits reach the verdicts of the JAX
  unit cases they mirror (``tests/unit/test_analysis.py:123-292``); on the
  ``tiny`` bf16 engine the dtype audit's verdict and its set of upcast
  shapes EQUAL the JAX engine's (both packages compute norms, RoPE and the
  loss in float32).
* The codelint rules and the baseline round-trip mirror
  ``test_analysis.py:342-517`` on fixture files; ``analysis.codelint
  --check`` exits 0 on the port's tree against the port's baseline and 1
  on a copy under ``tmp_path`` with a seeded violation.
* ``python -m deepspeedsyclsupport_tpu_torch.monitor.mfu``: ``--json``
  output and exit codes EQUAL to ``tools/mfu_report.py``'s on the same
  trace window (whole, torn, empty); a window in the port's opmap
  convention (keyed by trace position) is read by the port's CLI alone.

Counts and bytes are compared exactly.
"""
import dataclasses
import gzip
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu import analysis as JA
from deepspeedsyclsupport_tpu.analysis import baseline as JB
from deepspeedsyclsupport_tpu.comm.topology import build_topology as jax_topo
from deepspeedsyclsupport_tpu_torch import analysis as A
from deepspeedsyclsupport_tpu_torch import build_model, initialize
from deepspeedsyclsupport_tpu_torch.analysis import baseline as B
from deepspeedsyclsupport_tpu_torch.analysis import codelint
from deepspeedsyclsupport_tpu_torch.comm.hlo_comms import (
    COLLECTIVE_OPS, summarize_collectives)
from deepspeedsyclsupport_tpu_torch.comm.comms_logging import HLO_OPCODES
from deepspeedsyclsupport_tpu_torch.comm.topology import MeshTopology
from deepspeedsyclsupport_tpu_torch.runtime import zero as zero_lib

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
D_IN, D_OUT = 256, 2048      # JAX test_analysis.py RectModel


# ======================================================== trees and specs
def _rect(stage, fsdp):
    """RectModel's tree and specs: w fsdp-sharded at stage 3 (it crosses
    the persistence threshold), b replicated."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(0, 0.1, (D_IN, D_OUT)).astype(np.float32),
            "b": np.zeros((D_OUT,), np.float32)}
    w = (("fsdp",), ()) if stage >= 3 and fsdp > 1 else ((), ())
    return tree, {("w",): w, ("b",): ((),)}


def _tiny(stage, topo):
    """The ``tiny`` model's per-layer tree (numpy) and the port's plan."""
    model = build_model("tiny", dtype="float32")
    meta = model.init_params(device="meta")
    specs = zero_lib.tree_param_shardings(
        meta, topo, stage, extra_rules=model.sharding_rules, stacked=True,
        n_layers=len(meta["layers"]))
    tree = zero_lib._map(lambda t: np.zeros(tuple(t.shape), np.float32),
                         meta)
    return tree, specs


def _jax_shardings(tree, specs, sizes):
    """The port's specs as JAX ``NamedSharding``s on a mesh of the same
    sizes (a tree of the tree's structure)."""
    from jax.sharding import NamedSharding, PartitionSpec

    topo = jax_topo(dp=sizes["data"], fsdp=sizes["fsdp"],
                    devices=jax.devices()[:sizes["data"] * sizes["fsdp"]])

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        spec = PartitionSpec(*[e if e else None for e in specs[path]])
        return NamedSharding(topo.mesh, spec)

    return walk(tree, ())


MESHES = [(1, 4), (2, 2), (4, 1), (1, 1)]


@pytest.mark.parametrize("model", ["rect", "tiny"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("dp,fsdp", MESHES)
def test_expected_train_collectives_equals_jax(model, stage, dp, fsdp):
    sizes = {"data": dp, "fsdp": fsdp}
    topo = MeshTopology(sizes, world_size=dp * fsdp)
    tree, specs = _rect(stage, fsdp) if model == "rect" else \
        _tiny(stage, topo)
    jsh = _jax_shardings(tree, specs, sizes)
    for gpp in (1, 2):
        got = A.expected_train_collectives(tree, topo, stage,
                                           param_shardings=specs,
                                           gathers_per_param=gpp)
        want = JA.expected_train_collectives(tree, topo, stage,
                                             param_shardings=jsh,
                                             gathers_per_param=gpp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_bytes == want.total_bytes
    if model == "rect" and stage == 3 and (dp, fsdp) == (1, 4):
        # the JAX test's analytic numbers
        assert got.param_gather_count == 2
        assert got.param_gather_bytes == 2 * D_IN * D_OUT * 4
        assert got.grad_sync_bytes == (D_IN + 1) * D_OUT * 4
    if dp * fsdp == 1:   # the group-of-one rule
        assert got.param_gather_bytes == got.grad_sync_bytes == 0


# ================================================= classes and the checker
W_BYTES, B_BYTES = D_IN * D_OUT * 4, D_OUT * 4
CENSUS = {
    "canonical": [
        {"op": "all-gather", "bytes": W_BYTES, "shape": "f32[256,2048]",
         "group_size": 4},
        {"op": "all-reduce", "bytes": W_BYTES, "shape": "f32[256,2048]",
         "group_size": 4},
        {"op": "all-reduce", "bytes": B_BYTES, "shape": "f32[2048]",
         "group_size": 4},
        {"op": "all-reduce", "bytes": 4, "shape": "f32[]",
         "group_size": 4}],
    "quantized": [
        # qwZ: w's int8 gather (one byte an element) and its scales
        {"op": "all-gather", "bytes": D_IN * D_OUT, "shape": "s8[524288]",
         "group_size": 4},
        {"op": "all-gather", "bytes": D_IN * D_OUT // 256 * 4,
         "shape": "f32[2048]", "group_size": 4},
        # qgZ: b's int8 all-to-all and w's
        {"op": "all-to-all", "bytes": D_OUT, "shape": "s8[2048]",
         "group_size": 4},
        {"op": "all-to-all", "bytes": D_IN * D_OUT, "shape": "s8[524288]",
         "group_size": 4},
        {"op": "all-reduce", "bytes": 64, "shape": "f32[16]",
         "group_size": 4}],
    "reduce_scatter": [
        # the shard of a reduce-scatter, an unattributed gather of ids, a
        # permute, a group of 2 on a mesh of 4
        {"op": "all-gather", "bytes": W_BYTES, "shape": "f32[256,2048]",
         "group_size": 4},
        {"op": "reduce-scatter", "bytes": W_BYTES // 4,
         "shape": "f32[64,2048]", "group_size": 4},
        {"op": "all-gather", "bytes": 512, "shape": "s32[4,32]",
         "group_size": 4},
        {"op": "collective-permute", "bytes": 2048, "shape": "f32[8,64]",
         "group_size": 2},
        {"op": "all-reduce", "bytes": B_BYTES, "shape": "f32[2048]",
         "group_size": 4}],
    "scalar_heavy": [{"op": "all-reduce", "bytes": 64, "shape": "f32[16]",
                      "group_size": 4}] * 20,
}


@pytest.mark.parametrize("case", sorted(CENSUS))
def test_classify_and_check_equal_jax(case):
    sizes = {"data": 1, "fsdp": 4}
    topo = MeshTopology(sizes, world_size=4)
    tree, specs = _rect(3, 4)
    jsh = _jax_shardings(tree, specs, sizes)
    census = CENSUS[case]
    got = A.classify_collectives(census, tree, specs)
    want = JA.classify_collectives(census, tree, jsh)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    exp = A.expected_train_collectives(tree, topo, 3, param_shardings=specs)
    jexp = JA.expected_train_collectives(tree, topo, 3,
                                         param_shardings=jsh)
    for exact in (True, False):
        c = A.check_collectives(census, exp, tree, specs, exact=exact)
        j = JA.check_collectives(census, jexp, tree, jsh, exact=exact)
        assert (c.ok, c.problems) == (j.ok, j.problems)
        assert c.report() == j.report()
    if case == "canonical":
        assert A.check_collectives(census, exp, tree, specs).ok
    if case == "quantized":
        assert got.counts() == {"param_gather": 1, "grad_sync": 2,
                                "scalar_sync": 1, "other": 1}


def test_census_summary_and_opcodes():
    """``summarize_collectives``' shape (JAX ``hlo_comms``) over a census,
    and every façade op spelled with an HLO collective opcode."""
    assert set(HLO_OPCODES.values()) <= set(COLLECTIVE_OPS)
    s = summarize_collectives(CENSUS["reduce_scatter"])
    assert s["all-gather"] == {"count": 2, "total_bytes": W_BYTES + 512,
                               "example_shape": "f32[256,2048]",
                               "group_size": 4}
    assert s["collective-permute"]["group_size"] == 2
    assert A.collective_census(CENSUS["canonical"]) == CENSUS["canonical"]
    with pytest.raises(ValueError):
        A.collective_census([{"op": "all-gather", "bytes": 4}])


def test_comms_logger_rest_equals_jax():
    """``record_hlo`` (idempotent), ``record_wall``, the straggler rows of
    a world of one and the ``Comm/`` events: EQUAL to the JAX logger's on
    the same records."""
    from deepspeedsyclsupport_tpu.comm.comms_logging import \
        CommsLogger as JaxLogger
    from deepspeedsyclsupport_tpu_torch.comm.comms_logging import CommsLogger

    loggers = (CommsLogger(enabled=True), JaxLogger(enabled=True))
    summary = summarize_collectives(CENSUS["reduce_scatter"])
    for lg in loggers:
        lg.append("all_reduce", ("data", "fsdp"), 4096, (1024,))
        lg.append("all_gather", "fsdp", 512, (128,))
        for _ in range(2):
            lg.record_hlo(summary, tag="train_step")
        lg.record_wall("train_batch", 0.25)
        lg.record_wall("train_batch", 0.5)
    port, jax_ = loggers
    assert port.snapshot() == jax_.snapshot()
    assert port.summary_events(7) == jax_.summary_events(7)
    assert port._straggler_rows(port._wall) == \
        jax_._straggler_rows(jax_._wall) == [("train_batch", 0.75, 0.75,
                                              0.75)]
    assert "train_batch" in port.log_summary(show_straggler=True)
    window = port.close_window()
    assert window == []
    port.open_window()
    t = torch.zeros(3, 5, dtype=torch.bfloat16)
    port.record_call("all_gather", t, 4)
    port.record_call("all_reduce", t, 1)        # a group of one: no entry
    port.record_call("monitored_barrier", t, 4)  # moves no data: no entry
    assert port.close_window() == [{"op": "all-gather", "bytes": 30,
                                    "shape": "bf16[3,5]", "group_size": 4}]


# ================================================================ donation
def _engine(dtype="float32", steps=1, **extra):
    model = build_model("tiny", dtype=dtype)
    cfg = dict({"train_batch_size": 4, "steps_per_print": 10_000,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "flops_profiler": {"enabled": True, "profile_step": steps,
                                   "output_file": os.devnull}}, **extra)
    eng = initialize(model=model, config=cfg, device="cpu")[0]
    ids = np.random.RandomState(0).randint(0, 512, (4, 32))
    for _ in range(steps):
        eng.train_batch({"input_ids": ids})
    return eng


@pytest.fixture(scope="module")
def fp32_engine():
    return _engine()


@pytest.fixture(scope="module")
def bf16_engine():
    """bf16 with activation checkpointing (the JAX bench config)."""
    return _engine("bfloat16", bf16={"enabled": True},
                   activation_checkpointing={"enabled": True})


def test_engine_step_updates_params_and_moments_in_place(fp32_engine):
    rep = fp32_engine.graph_report(analyzers=("donation",))["donation"]
    assert rep.ok, rep.report()
    assert any(p.startswith("params/") for p in rep.donated)
    assert any(p.startswith("mu/") for p in rep.donated)
    assert any(p.startswith("nu/") for p in rep.donated)
    assert rep.wasted_bytes == 0


def test_bench_shaped_config_updates_in_place(bf16_engine):
    rep = bf16_engine.graph_report(analyzers=("donation",))["donation"]
    assert rep.ok, rep.report()


def test_missed_donation_is_flagged_with_wasted_bytes():
    x = torch.ones(512, 512)
    before = A.donation.storage_snapshot([("arg0", x)])
    rep = A.donation_audit(before,
                           A.donation.storage_snapshot([("arg0", x * 2.0)]))
    assert not rep.ok
    assert len(rep.not_donated) == 1
    assert rep.not_donated[0]["bytes"] == 512 * 512 * 4
    assert rep.wasted_bytes == 512 * 512 * 4
    x.mul_(2.0)
    rep = A.donation_audit(before, A.donation.storage_snapshot([("arg0", x)]))
    assert rep.ok, rep.report()
    assert rep.donated and not rep.not_donated


def test_untouched_tensor_is_moot_not_missed():
    x, unused = torch.ones(256, 256), torch.ones(128, 128)
    before = A.donation.storage_snapshot([("a", x), ("u", unused)])
    x.add_(1.0)
    rep = A.donation_audit(before, A.donation.storage_snapshot(
        [("a", x), ("u", unused)]))
    assert rep.ok, rep.report()
    # a snapshot that lost a tensor cannot be trusted
    assert not A.donation_audit(before, A.donation.storage_snapshot(
        [("a", x)])).ok


# =================================================================== dtype
X, W = (64, 256), (256, 256)


def _pair(dtype):
    return (torch.randn(*X, dtype=dtype), torch.randn(*W, dtype=dtype))


def _jax_pair():
    return (jax.ShapeDtypeStruct(X, jnp.bfloat16),
            jax.ShapeDtypeStruct(W, jnp.bfloat16))


def test_activation_upcast_flagged_param_upcast_sanctioned():
    def f(x, w):
        h = (x @ w).float()        # activation upcast: BAD
        g = w.float()              # master-weight: sanctioned
        return h.sum() + g.sum()

    def jf(x, w):
        return (x @ w).astype(jnp.float32).sum() + \
            w.astype(jnp.float32).sum()

    rep = A.dtype_audit(f, *_pair(torch.bfloat16), allowed_shapes=[W])
    jrep = JA.dtype_audit(jf, *_jax_pair(), allowed_shapes=[W])
    assert (rep.ok, len(rep.upcasts)) == (jrep.ok, len(jrep.upcasts))
    assert rep.upcasts[0]["shape"] == jrep.upcasts[0]["shape"] == X
    assert rep.sanctioned >= 1 and jrep.sanctioned >= 1


def test_clean_bf16_graph_passes():
    rep = A.dtype_audit(lambda x, w: torch.tanh(x @ w).max(),
                        *_pair(torch.bfloat16))
    assert rep.ok, rep.report()
    assert JA.dtype_audit(lambda x, w: jnp.tanh(x @ w).max(),
                          *_jax_pair()).ok


def test_float32_sum_accumulator_upcast_is_flagged():
    """JAX's ``sum`` accumulates a bf16 array in float32 (a convert the
    audit sees); torch spells that accumulator ``dtype=torch.float32``."""
    rep = A.dtype_audit(lambda x, w: (x @ w).sum(dtype=torch.float32),
                        *_pair(torch.bfloat16))
    jrep = JA.dtype_audit(lambda x, w: (x @ w).sum(), *_jax_pair())
    assert not rep.ok and not jrep.ok
    assert rep.upcasts[0]["shape"] == jrep.upcasts[0]["shape"] == X


def test_small_upcasts_below_floor_ignored():
    assert A.dtype_audit(lambda x: x.float().sum(),
                         torch.ones(64, dtype=torch.bfloat16)).ok


def test_repeated_upcast_multiplied_by_its_count():
    """A loop's upcast, made 4 times: one entry of ``mult`` 4 (JAX: a scan
    body's trip count)."""
    def f(xs):
        c = torch.zeros(())
        for x in xs:
            c = c + x.float().sum()
        return c

    rep = A.dtype_audit(f, torch.ones(4, 64, 256, dtype=torch.bfloat16))
    assert not rep.ok
    (u,) = rep.upcasts
    assert u["mult"] == 4
    assert u["bytes"] == 64 * 256 * 2 * 4


@pytest.fixture(scope="module")
def jax_bf16_dtype():
    """The JAX engine's dtype audit of one ``tiny`` bf16 step."""
    import deepspeedsyclsupport_tpu as dstpu
    from deepspeedsyclsupport_tpu.models import build_model as jbuild

    jm = jbuild("tiny", dtype="bfloat16")
    topo = jax_topo(dp=1, devices=jax.devices()[:1])
    eng = dstpu.initialize(model=jm, config={
        "train_batch_size": 4, "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "steps_per_print": 10_000}, topology=topo,
        params=jm.init_params(jax.random.PRNGKey(3)))[0]
    ids = np.random.RandomState(0).randint(0, 512, (4, 32)).astype(np.int32)
    eng.train_batch({"input_ids": jnp.asarray(ids)})
    return eng.graph_report(analyzers=("dtype",))["dtype"]


def test_engine_dtype_verdict_equals_jax(jax_bf16_dtype, bf16_engine,
                                        fp32_engine):
    """The same model in both packages computes its norms, RoPE and loss
    in float32: the same activation-shaped upcasts, the same verdict."""
    rep = bf16_engine.graph_report(analyzers=("dtype",))["dtype"]
    assert rep.ok == jax_bf16_dtype.ok is False
    assert {u["shape"] for u in rep.upcasts} == \
        {u["shape"] for u in jax_bf16_dtype.upcasts}
    assert fp32_engine.graph_report(analyzers=("dtype",))["dtype"].ok


def test_graph_report_before_a_step_and_without_a_count_raises():
    model = build_model("tiny", dtype="float32")
    eng = initialize(model=model, config={
        "train_batch_size": 4, "optimizer": {"type": "AdamW",
                                             "params": {"lr": 1e-3}}},
        device="cpu")[0]
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.graph_report()
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.emit_comm_census()
    eng.train_batch({"input_ids": np.zeros((4, 32), np.int64)})
    rep = eng.graph_report(analyzers=("collectives", "donation",
                                      "resharding"))
    assert all(rep[k].ok for k in ("collectives", "donation", "resharding"))
    assert rep["census"] == []   # a world of one moves no bytes
    with pytest.raises(RuntimeError, match="counted"):
        eng.graph_report(analyzers=("dtype",))


# ============================================================== resharding
def test_boundary_mismatch_detected():
    spec_x, spec_rep = (("x",), ()), ((), ())
    ok = A.resharding_audit(given_in_shardings=[spec_x],
                            wanted_in_shardings=[spec_x])
    assert ok.ok, ok.report()
    bad = A.resharding_audit(given_in_shardings=[spec_rep],
                             wanted_in_shardings=[spec_x])
    assert not bad.ok
    assert bad.boundary_mismatches[0]["index"] == 0
    # local shapes the same way: a leaf that is not its spec's shard
    assert not A.resharding_audit(given_in_shardings=[(16, 4)],
                                  wanted_in_shardings=[(2, 4)]).ok


def test_internal_reshard_spellings_are_suspects():
    census = [
        {"op": "all-to-all", "bytes": 4096, "shape": "f32[8,128]",
         "group_size": 8},
        {"op": "collective-permute", "bytes": 2048, "shape": "f32[8,64]",
         "group_size": 8},
    ]
    rep = A.resharding_audit(census=census)
    jrep = JA.resharding_audit("unused-hlo-text", census=census)
    assert (rep.ok, rep.suspect_bytes) == (jrep.ok, jrep.suspect_bytes)
    assert not rep.ok
    assert len(rep.internal_suspects) == 2
    assert rep.suspect_bytes == 4096 + 2048


# ================================================================ codelint
def _lint_file(tmp_path, relpath, source, rules=None):
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return codelint.lint_paths(str(tmp_path), relpaths=[relpath],
                               rules=rules)


class TestSignalHandlerSafety:
    RULE = [codelint.SignalHandlerSafety()]

    def test_logging_in_registered_handler_flagged(self, tmp_path):
        src = ("import signal, logging\n"
               "def handler(signum, frame):\n"
               "    logging.warning('dying %d', signum)\n"
               "def install():\n"
               "    signal.signal(signal.SIGTERM, handler)\n")
        vs = _lint_file(tmp_path, "launcher/x.py", src, self.RULE)
        assert any(v.rule == "signal-handler-safety" for v in vs)

    def test_store_only_handler_clean(self, tmp_path):
        src = ("import signal\n"
               "class S:\n"
               "    pass\n"
               "STATE = S()\n"
               "def _on_signal(signum, frame):\n"
               "    STATE.flag = signum\n"
               "def install():\n"
               "    signal.signal(signal.SIGTERM, _on_signal)\n")
        assert _lint_file(tmp_path, "launcher/x.py", src, self.RULE) == []

    def test_lock_and_raise_flagged(self, tmp_path):
        src = ("import signal\n"
               "import threading\n"
               "L = threading.Lock()\n"
               "def _on_signal(signum, frame):\n"
               "    with L:\n"
               "        raise SystemExit(1)\n")
        assert len(_lint_file(tmp_path, "x.py", src, self.RULE)) >= 2


class TestWallClockRule:
    RULE = [codelint.WallClockInStepPath()]

    def test_flagged_in_step_path(self, tmp_path):
        src = "import time\ndef step():\n    t0 = time.time()\n"
        vs = _lint_file(tmp_path, "runtime/zero.py", src, self.RULE)
        assert [v.rule for v in vs] == ["wall-clock-in-step-path"]

    def test_ignored_off_step_path(self, tmp_path):
        src = "import time\ndef step():\n    t0 = time.time()\n"
        assert _lint_file(tmp_path, "utils/other.py", src, self.RULE) == []

    def test_suppression_comment(self, tmp_path):
        src = ("import time\n"
               "def stamp():\n"
               "    # human-facing wall timestamp, not a duration\n"
               "    return time.time()  "
               "# dslint: allow(wall-clock-in-step-path)\n")
        assert _lint_file(tmp_path, "runtime/zero.py", src, self.RULE) == []


class TestHostSyncRule:
    RULE = [codelint.HostSyncInStepPath()]

    @pytest.mark.parametrize("call", ["loss.item()", "x.cpu()",
                                      "x.tolist()", "x.detach().numpy()",
                                      "torch.cuda.synchronize()"])
    def test_flagged_in_hot_function(self, tmp_path, call):
        src = f"import torch\ndef hot_loop(x, loss):\n    return {call}\n"
        vs = _lint_file(tmp_path, "runtime/zero.py", src, self.RULE)
        assert [v.rule for v in vs] == ["host-sync-in-step-path"]
        assert "hot_loop" in vs[0].message

    def test_sanctioned_site_clean(self, tmp_path):
        src = ("import torch\n"
               "def barrier():\n"
               "    torch.cuda.synchronize()\n")
        assert _lint_file(tmp_path, "comm/comm.py", src, self.RULE) == []
        src = ("class Engine:\n"
               "    def _post_step(self, loss):\n"
               "        return loss.item()\n")
        assert _lint_file(tmp_path, "runtime/engine.py", src,
                          self.RULE) == []

    def test_non_sync_spellings_clean(self, tmp_path):
        # ``d.item(0)`` (an argument: no tensor's ``item``) is no sync; off
        # the step path a sync is allowed
        assert _lint_file(tmp_path, "runtime/zero.py",
                          "def f(d):\n    return d.item(0)\n",
                          self.RULE) == []
        assert _lint_file(tmp_path, "utils/other.py",
                          "def f(x):\n    return x.cpu()\n",
                          self.RULE) == []


class TestEventNameRule:
    def test_undeclared_name_in_declared_group_flagged(self, tmp_path):
        src = "def f(m):\n    m.write_events([('Goodput/typo_xyz', 1, 0)])\n"
        vs = _lint_file(tmp_path, "runtime/x.py", src,
                        [codelint.UndeclaredEventName()])
        assert [v.rule for v in vs] == ["undeclared-event-name"]

    def test_declared_and_prefix_names_clean(self, tmp_path):
        src = ("def f(m):\n"
               "    m.write_events([('Goodput/compile_s', 1, 0)])\n"
               "    m.write_events([('Comm/anything_goes', 1, 0)])\n"
               "    base = 'Comm/'\n")
        assert _lint_file(tmp_path, "runtime/x.py", src,
                          [codelint.UndeclaredEventName()]) == []

    def test_foreign_groups_and_tests_ignored(self, tmp_path):
        src = "p = 'some/file/path.py'\nq = 'Goodput/typo'\n"
        assert _lint_file(tmp_path, "tests/unit/x.py", src,
                          [codelint.UndeclaredEventName()]) == []
        assert _lint_file(tmp_path, "runtime/x.py",
                          "p = 'some/file/path.py'\n",
                          [codelint.UndeclaredEventName()]) == []


def test_rules_equal_the_jax_packages_on_one_file(tmp_path):
    """The rules the two packages share by name flag the same lines of one
    fixture (the host-sync rule differs by design: torch's spellings)."""
    from deepspeedsyclsupport_tpu.analysis import codelint as jlint

    src = ("import signal, logging, time\n"
           "def handler(signum, frame):\n"
           "    logging.warning('x')\n"
           "def install():\n"
           "    signal.signal(signal.SIGTERM, handler)\n"
           "def step(m):\n"
           "    t = time.time()\n"
           "    m.write_events([('Goodput/typo_xyz', 1, 0)])\n"
           "    m.write_events([('Goodput/compile_s', t, 0)])\n")
    path = tmp_path / "runtime" / "zero.py"
    path.parent.mkdir(parents=True)
    path.write_text(src)
    for name in ("SignalHandlerSafety", "WallClockInStepPath",
                 "UndeclaredEventName"):
        got = codelint.lint_paths(str(tmp_path), ["runtime/zero.py"],
                                  [getattr(codelint, name)()])
        want = jlint.lint_paths(str(tmp_path), ["runtime/zero.py"],
                                [getattr(jlint, name)()])
        assert [(v.rule, v.line, v.snippet) for v in got] == \
            [(v.rule, v.line, v.snippet) for v in want]
        assert got
    assert [c.name for c in codelint.ALL_RULES] == \
        [c.name for c in jlint.ALL_RULES]


# ================================================================ baseline
def _v(rule, path, snippet, line=1):
    return codelint.Violation(rule, path, line, "msg", snippet)


class TestBaseline:
    def test_round_trip_and_check(self, tmp_path):
        bl_path = str(tmp_path / "bl.json")
        old = [_v("r", "a.py", "x = 1"), _v("r", "a.py", "x = 1", line=9),
               _v("r", "b.py", "y = 2")]
        B.save_baseline(bl_path, old)
        baseline = B.load_baseline(bl_path)
        assert baseline == {"r|a.py|x = 1": 2, "r|b.py|y = 2": 1}
        assert JB.load_baseline(bl_path) == baseline
        now = [_v("r", "a.py", "x = 1", line=30),
               _v("r", "a.py", "x = 1", line=41),
               _v("r", "c.py", "z = 3")]
        chk = B.check_against_baseline(now, baseline)
        assert not chk.ok
        assert [v.path for v in chk.new] == ["c.py"]
        assert len(chk.baselined) == 2
        assert chk.stale_keys == ["r|b.py|y = 2"]

    def test_count_growth_is_new(self):
        baseline = {"r|a.py|x = 1": 1}
        now = [_v("r", "a.py", "x = 1"), _v("r", "a.py", "x = 1", line=7)]
        chk = B.check_against_baseline(now, baseline)
        assert len(chk.new) == 1 and len(chk.baselined) == 1

    def test_missing_baseline_is_empty(self, tmp_path):
        assert B.load_baseline(str(tmp_path / "nope.json")) == {}

    def test_version_mismatch_raises(self, tmp_path):
        p = tmp_path / "bl.json"
        p.write_text(json.dumps({"version": 99, "violations": {}}))
        with pytest.raises(ValueError):
            B.load_baseline(str(p))


# ===================================================================== CLI
def _cli(args, cwd=REPO, root=REPO):
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.run([sys.executable, "-m"] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_lint_check_passes_on_the_port_tree(capsys):
    """The gate: no new violation against the port's baseline."""
    assert codelint.main(["--check"]) == 0
    assert "0 new" in capsys.readouterr().out


def test_lint_list_rules(capsys):
    assert codelint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("signal-handler-safety", "undeclared-event-name",
                 "wall-clock-in-step-path", "host-sync-in-step-path"):
        assert rule in out


def test_lint_check_fails_on_a_seeded_violation(tmp_path):
    pkg = tmp_path / "deepspeedsyclsupport_tpu_torch"
    shutil.copytree(os.path.join(REPO, "deepspeedsyclsupport_tpu_torch"),
                    pkg, ignore=shutil.ignore_patterns("__pycache__",
                                                       "csrc"))
    with open(pkg / "runtime" / "zero.py", "a") as f:
        f.write("\n\ndef _canary(t):\n    return t.item()\n")
    # the module entry point, in a process of its own, over the copy
    r = _cli(["deepspeedsyclsupport_tpu_torch.analysis.codelint", "--check"],
             cwd=str(tmp_path), root=str(tmp_path))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "[host-sync-in-step-path]" in r.stdout and "[NEW]" in r.stdout
    assert "1 new" in r.stdout


# -------------------------------------------------------------- mfu report
OPMAP = {"while.1": {"region": "other", "category": "control",
                     "opcode": "while"},
         "dot.2": {"region": "attn", "category": "dot", "opcode": "dot"},
         "fusion.3": {"region": "mlp", "category": "fusion",
                      "opcode": "fusion"},
         "all-reduce.4": {"region": "collective", "category": "collective",
                          "opcode": "all-reduce"}}


def _window(d, cat=None, opmap=OPMAP, torn=False):
    """A trace window with its sidecars (``Engine.mfu_ledger``'s files):
    two threads of nested ops, a collective, an unmapped op."""
    d.mkdir()
    ev = []
    t = 100.0
    for tid in (1, 2):
        for name, off, dur in (("while.1", 0, 50.0), ("dot.2", 5, 20.0),
                               ("fusion.3", 30, 10.0), ("ghost.9", 60, 5.0)):
            e = {"ph": "X", "name": name, "pid": 1, "tid": tid,
                 "ts": t + off, "dur": dur}
            if cat:
                e["cat"] = cat
            ev.append(e)
        t += 25.0
    ev.append(dict({"ph": "X", "name": "all-reduce.4", "pid": 1, "tid": 3,
                    "ts": 120.0, "dur": 40.0}, **({"cat": cat} if cat
                                                  else {})))
    raw = gzip.compress(json.dumps({"traceEvents": ev}).encode())
    (d / "w.trace.json.gz").write_bytes(raw[:int(len(raw) * 0.7)] if torn
                                        else raw)
    (d / "mfu_opmap.json").write_text(json.dumps(opmap))
    costs = {"attn": {"flops": 4e9, "hbm_bytes": 1e8, "comm_bytes": 0.0},
             "mlp": {"flops": 8e9, "hbm_bytes": 3e8, "comm_bytes": 0.0}}
    table = A.roofline_table(costs, A.DEVICE_SPECS["h100-sxm"],
                             census_bytes=5e7)
    (d / "mfu_roofline.json").write_text(json.dumps(table))
    (d / "mfu_window.json").write_text(json.dumps(
        {"step": 3, "step_s": 1e-4, "steps": 1}))
    return d


def _mfu_cli(port, d, out, capsys):
    """(rc, stdout) of the port's CLI or of ``tools/mfu_report.py``, run in
    this process (the tool loads the JAX package's stdlib module by
    path)."""
    import importlib.util

    from deepspeedsyclsupport_tpu_torch.monitor import mfu

    if port:
        main = mfu.main
    else:
        spec = importlib.util.spec_from_file_location(
            "_mfu_report", os.path.join(REPO, "tools", "mfu_report.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        main = tool.main
    capsys.readouterr()
    rc = main([str(d), "--json", str(out)])
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("kind", ["whole", "torn", "empty"])
def test_mfu_cli_equals_the_tool(tmp_path, capsys, kind):
    d = tmp_path / "w"
    if kind == "empty":
        d.mkdir()
    else:
        _window(d, torn=kind == "torn")
    prc, pout = _mfu_cli(True, d, tmp_path / "port.json", capsys)
    trc, tout = _mfu_cli(False, d, tmp_path / "tool.json", capsys)
    assert prc == trc == (2 if kind == "empty" else 0)
    if kind != "empty":
        assert json.loads((tmp_path / "port.json").read_text()) == \
            json.loads((tmp_path / "tool.json").read_text())
        assert pout.replace("port.json", "") == tout.replace("tool.json", "")
    if kind == "whole":
        # the module entry point, in a process of its own: the same output
        # and nothing on stderr
        r = _cli(["deepspeedsyclsupport_tpu_torch.monitor.mfu", str(d),
                  "--json", str(tmp_path / "cli.json")])
        assert r.returncode == 0 and r.stderr == "", r.stderr
        assert json.loads((tmp_path / "cli.json").read_text()) == \
            json.loads((tmp_path / "tool.json").read_text())


def test_mfu_cli_reads_the_ports_opmap(tmp_path, capsys):
    """The port's opmap is keyed by trace position (``monitor/mfu.
    op_events``): the port's CLI joins it, the tool (name-keyed) cannot."""
    plain = _window(tmp_path / "plain")
    order = [e["name"] for e in json.loads(gzip.decompress(
        (plain / "w.trace.json.gz").read_bytes()))["traceEvents"]]
    keyed = {f"{i}:{n}": OPMAP[n] for i, n in enumerate(order) if n in OPMAP}
    d = _window(tmp_path / "port", cat="kernel", opmap=keyed)
    assert _mfu_cli(True, d, tmp_path / "port.json", capsys)[0] == 0
    led = json.loads((tmp_path / "port.json").read_text())
    assert led["regions"]["attn"]["measured_s"] > 0
    assert _mfu_cli(False, d, tmp_path / "tool.json", capsys)[0] == 2
