"""PyTorch port: ``ServingSession`` and the request journal against the JAX
package's.

Both sessions drive ``tiny`` in float32 on the CPU (the same JAX-initialised
weights, converted with ``params_from_jax``) under ONE synthetic clock
pattern: a clock that advances 10 ms on every call. The port calls
``self.clock()`` where the reference does, in the same order, so both see
the same times, the same capacity estimates and so the same gate, ordering,
eviction and fused-round decisions. Greedy sampling makes the tokens
comparable (the two packages' random streams differ). Held EQUAL, case by
case: the ``ServeEvent`` stream (kind, uid, t, tokens, reason),
``counters``, ``recovery_counters``, ``stats()``, ``summary_events()``,
``host_dispatches`` and, where a journal is on, every journal record with
its wall stamp dropped. Cases: per-token, fused K = 4, a KV pool small
enough to evict (requeue), the prefix cache on, sheds under a tight TTFT
SLA, injected ``kv_alloc_fail`` streaks, and ``replay`` after a crash.
Journals written by either package load (``load_journal``) and join
(``join_traces``) in the other with equal results.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.inference.v2 import (
    InferenceEngineV2 as JaxEngine, ServingPolicyConfig as JaxPolicy,
    ServingSession as JaxSession)
from deepspeedsyclsupport_tpu.inference.v2 import supervisor as jax_sup
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu.monitor import reqtrace as jax_reqtrace
from deepspeedsyclsupport_tpu.monitor import telemetry as jax_tel
from deepspeedsyclsupport_tpu.utils import fault_injection as jax_fi
from deepspeedsyclsupport_tpu_torch.inference.v2 import (
    InferenceEngineV2, ServingPolicyConfig, ServingSession)
from deepspeedsyclsupport_tpu_torch.inference.v2 import supervisor as sup
from deepspeedsyclsupport_tpu_torch.models import build_model, params_from_jax
from deepspeedsyclsupport_tpu_torch.monitor import reqtrace
from deepspeedsyclsupport_tpu_torch.monitor import telemetry as tel
from deepspeedsyclsupport_tpu_torch.utils import fault_injection as fi

ENGINE_KW = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
                 max_sequences=4)


class TickClock:
    """Advances ``dt`` on every call: two sessions that call the clock in
    the same order see the same times."""

    def __init__(self, t: float = 100.0, dt: float = 0.01):
        self.t = t
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@functools.lru_cache(maxsize=None)
def _weights():
    model = jax_build_model("tiny", dtype="float32")
    params = model.init_params(jax.random.PRNGKey(11))
    return model, params, jax.tree.map(np.asarray, params)


def _requests(n, seed=0, lo=3, hi=20, new=(3, 9), prefix=()):
    rng = np.random.RandomState(seed)
    return [(u, list(prefix) + rng.randint(1, 500, rng.randint(lo, hi))
             .tolist(), int(rng.randint(*new))) for u in range(n)]


CASES = {
    "per_token": dict(engine={}, policy=dict(ttft_sla_s=2.0,
                                             token_rate_sla=1.0),
                      requests=_requests(6)),
    "fused": dict(engine=dict(decode_steps_per_dispatch=4),
                  policy=dict(ttft_sla_s=2.0, token_rate_sla=1.0),
                  requests=_requests(6, new=(6, 14))),
    "evict": dict(engine=dict(num_blocks=9),
                  policy=dict(preempt_policy="requeue"),
                  requests=_requests(5, seed=1, lo=10, hi=18, new=(8, 14))),
    "prefix": dict(engine={}, policy=dict(prefix_cache={"enabled": True}),
                   requests=_requests(5, seed=2, lo=2, hi=6,
                                      prefix=list(range(40, 60)))),
    "shed": dict(engine={}, policy=dict(ttft_sla_s=0.15,
                                        prefill_tok_s_prior=200.0),
                 requests=_requests(10, seed=3, lo=10, hi=20), burst=True),
    "kv_alloc_fail": dict(engine=dict(decode_steps_per_dispatch=4),
                          policy={}, requests=_requests(4, seed=4),
                          faults={"kv_alloc_fail": {"count": 5}}),
}


def _engine(pkg, engine_kw):
    model, params, np_params = _weights()
    kw = dict(ENGINE_KW, **engine_kw)
    if pkg == "jax":
        return JaxEngine(model, params, dtype=jnp.float32, **kw)
    tmodel = build_model("tiny", dtype="float32")
    return InferenceEngineV2(tmodel, params_from_jax(np_params, tmodel.config,
                                                     device="cpu"),
                             device="cpu", dtype=torch.float32, **kw)


def _mods(pkg):
    if pkg == "jax":
        return JaxSession, JaxPolicy, jax_tel, jax_fi
    return ServingSession, ServingPolicyConfig, tel, fi


def _reset(pkg):
    _s, _p, t, f = _mods(pkg)
    t.metrics_registry.reset()
    t.resilience_counters.reset()
    f.configure_fault_injection(None)


def _ev(events):
    return [(e.kind, e.uid, e.t, [int(x) for x in e.tokens], e.reason)
            for e in events]


def _journal(path):
    """The journal's records without their wall stamps."""
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("t", None)
            out.append(rec)
    return out


def _drive(sess, events, max_rounds=500):
    rounds = 0
    while not sess.idle:
        events += sess.step()
        rounds += 1
        assert rounds < max_rounds, "session did not converge"


def _run(pkg, case, journal=None):
    """Drive one case through one package's session; everything that must
    be equal between the packages."""
    spec = CASES[case]
    Session, Policy, _t, faults = _mods(pkg)
    _reset(pkg)
    eng = _engine(pkg, spec["engine"])
    policy = dict(spec["policy"])
    if journal is not None:
        policy["journal_path"] = journal
    sess = Session(eng, Policy(**policy), clock=TickClock())
    if spec.get("faults"):
        faults.configure_fault_injection(spec["faults"])
    events, verdicts = [], []
    try:
        for u, toks, n in spec["requests"]:
            verdicts.append(sess.submit(u, toks, n,
                                        tenant="a" if u % 2 else "b"))
            if not spec.get("burst"):
                events += sess.step()
        _drive(sess, events)
    finally:
        faults.configure_fault_injection(None)
    out = {"events": _ev(events), "verdicts": verdicts,
           "counters": dict(sess.counters),
           "recovery": dict(sess.recovery_counters), "stats": sess.stats(),
           "summary": sess.summary_events(step=3),
           "dispatches": eng.host_dispatches,
           "rounds": sorted((r["data"].get("mode"), r["data"].get("k"))
                            for r in sess.trace_log
                            if r["data"].get("stage") == "decode_round")}
    sess.close()
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    return _run("jax", case)


@pytest.mark.parametrize("case", list(CASES))
def test_session_matches_jax(case):
    want = _jax_run(case)
    got = _run("torch", case)
    assert got == want
    # each case exercises what it names
    c = got["counters"]
    assert c["completed"] + c["shed"] == len(CASES[case]["requests"])
    if case == "fused" or case == "kv_alloc_fail":
        assert any(m == "fused" for m, _k in got["rounds"])
    if case == "evict":
        assert c["evicted"] > 0
    if case == "prefix":
        assert got["stats"]["prefix_hits"] > 0
    if case == "shed":
        assert c["shed"] > 0 and c["completed"] > 0


def test_session_tokens_match_generate():
    """Every completed request's greedy tokens equal ``generate`` of its
    prompt alone (no eviction, no shed)."""
    res = _run("torch", "fused")
    got = {}
    for kind, uid, _t, toks, _r in res["events"]:
        if kind == "token":
            got.setdefault(uid, []).extend(toks)
    eng = _engine("torch", {})
    for u, toks, n in CASES["fused"]["requests"]:
        assert got[u] == eng.generate([toks], max_new_tokens=n)[0], u


def test_journal_records_match_jax(tmp_path):
    """The same traffic journaled by both packages: equal records (wall
    stamps dropped), and each package's reader gives equal states and
    joins on either journal."""
    paths = {pkg: str(tmp_path / pkg / "journal_rank0.att0.jsonl")
             for pkg in ("jax", "torch")}
    for pkg, p in paths.items():
        os.makedirs(os.path.dirname(p))
        _run(pkg, "fused", journal=p)
    recs = {pkg: _journal(p) for pkg, p in paths.items()}
    names = {r["name"] for r in recs["torch"]}
    assert {"serve_journal/start", "serve/admit", "serve/emit",
            "serve/close", "serve/stage"} <= names
    assert recs["torch"] == recs["jax"]

    def states(loader, path):
        st, _t = loader(path)
        return {u: vars(s) for u, s in st.items()}

    for p in paths.values():
        assert states(sup.load_journal, p) == states(jax_sup.load_journal, p)
        streams = [("0", "0", reqtrace.load_stream(p))]
        mine = reqtrace.join_traces(streams)
        ref = jax_reqtrace.join_traces(
            [("0", "0", jax_reqtrace.load_stream(p))])
        assert mine == ref
        assert all(tr["closes"] == 1 for tr in mine.values())
        assert reqtrace.attribution(mine) == jax_reqtrace.attribution(ref)
    assert states(sup.load_journal, paths["jax"]) == \
        states(jax_sup.load_journal, paths["torch"])


def _crash_replay(pkg, tmp_path, cut_rounds=4):
    """A journaled session stops after ``cut_rounds`` rounds (the crash:
    session abandoned, engine flushed); a new session on the same engine
    recovers from the journal and runs to idle. Returns the replay
    session's events and the journal's reconstructed outputs."""
    Session, Policy, _t, _f = _mods(pkg)
    jsup = jax_sup if pkg == "jax" else sup
    _reset(pkg)
    eng = _engine(pkg, {"decode_steps_per_dispatch": 4})
    jdir = tmp_path / pkg
    jdir.mkdir()
    first = Session(eng, Policy(journal_path=jsup.journal_path(
        str(jdir), attempt=0)), clock=TickClock())
    for u, toks, n in CASES["fused"]["requests"]:
        first.submit(u, toks, n)
    for _ in range(cut_rounds):
        first.step()
    first.journal.close()
    eng.flush(list(eng.seqs))
    states, last_t = jsup.load_journal(str(jdir))
    second = Session(eng, Policy(journal_path=jsup.journal_path(
        str(jdir), attempt=1)), clock=TickClock(200.0))
    summary = jsup.recover_requests(second, states, last_t)
    events = []
    _drive(second, events)
    second.close()
    outputs = jsup.reconstruct_outputs(jsup.load_journal(str(jdir))[0])
    return (_ev(events), dict(second.counters),
            dict(second.recovery_counters), second.stats(),
            sorted(summary["replayed"]), outputs)


def test_replay_matches_jax_and_uninterrupted_run(tmp_path):
    want = _crash_replay("jax", tmp_path)
    got = _crash_replay("torch", tmp_path)
    assert got == want
    assert got[4], "the cut left no request in flight"
    assert got[2]["replays"] == len(got[4])
    whole = _run("torch", "fused")
    full = {}
    for kind, uid, _t, toks, _r in whole["events"]:
        if kind == "token":
            full.setdefault(uid, []).extend(toks)
    assert got[5] == full


def test_recover_from_torn_journal(tmp_path):
    """A journal cut mid-record (the crash's torn tail) recovers to the
    uninterrupted run's outputs."""
    eng = _engine("torch", {})
    jdir = tmp_path / "j"
    jdir.mkdir()
    p0 = sup.journal_path(str(jdir), attempt=0)
    sess = ServingSession(eng, ServingPolicyConfig(journal_path=p0),
                          clock=TickClock())
    reqs = CASES["per_token"]["requests"]
    for u, toks, n in reqs:
        sess.submit(u, toks, n)
    for _ in range(6):
        sess.step()
    sess.journal.close()
    eng.flush(list(eng.seqs))
    size = os.path.getsize(p0)
    with open(p0, "rb+") as f:
        f.truncate(size - 7)          # tear the last record
    states, last_t = sup.load_journal(str(jdir))
    assert any(s.in_flight for s in states.values())
    sess2 = ServingSession(eng, ServingPolicyConfig(
        journal_path=sup.journal_path(str(jdir), attempt=1)),
        clock=TickClock(200.0))
    sup.recover_requests(sess2, states, last_t)
    _drive(sess2, [])
    sess2.close()
    outputs = sup.reconstruct_outputs(sup.load_journal(str(jdir))[0])
    for u, toks, n in reqs:
        assert outputs[u] == eng.generate([toks], max_new_tokens=n)[0], u


def test_session_generator_defaults_to_engine_seed_plus_one():
    eng = _engine("torch", {})
    sess = ServingSession(eng, ServingPolicyConfig(telemetry=False))
    want = torch.Generator().manual_seed(eng.config.seed + 1)
    assert torch.equal(sess.generator.get_state(), want.get_state())
    g = torch.Generator().manual_seed(5)
    assert ServingSession(eng, generator=g).generator is g


def test_sampled_session_draws_from_its_generator():
    """With sampling on, two sessions with equally seeded generators give
    the same tokens; the port's randomness is the explicit generator."""
    from deepspeedsyclsupport_tpu_torch.inference.sampling import (
        SamplingParams)

    outs = []
    for _ in range(2):
        eng = _engine("torch", {"decode_steps_per_dispatch": 4})
        sess = ServingSession(eng, ServingPolicyConfig(),
                              clock=TickClock(),
                              sampling=SamplingParams(True, 0.8, 0, 0.9),
                              generator=torch.Generator().manual_seed(3))
        for u, toks, n in CASES["fused"]["requests"]:
            sess.submit(u, toks, n)
        events = []
        _drive(sess, events)
        outs.append(_ev(events))
    assert outs[0] == outs[1]
