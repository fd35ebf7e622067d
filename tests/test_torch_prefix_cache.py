"""PyTorch port: the cross-request KV prefix cache against the JAX package's.

The port's ``prefix_cache.py`` is a copy of the JAX package's host-only
module, and the engine hooks (``install_prefix_cache``,
``map_cached_prefix``, ``_commit_prefix``, ``_ensure_writable``, the
``cached_prefix`` pricing of ``check_schedule``) are ports of its engine's.
Each unit scenario of the JAX package's ``TestPrefixCacheUnits`` runs on
both classes and must give the same answers and counters; the engine
scenarios of ``TestEnginePrefixIntegration`` run on both engines (``tiny``,
float32, the same weights through ``params_from_jax``) and must give the
same tokens, ``n_cached`` / ``cached_prefix_len``, block tables, hit
statistics and admission decisions, with the cache on and off.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.inference.v2 import (
    InferenceEngineV2 as JaxEngine)
from deepspeedsyclsupport_tpu.inference.v2 import kv_cache as jkv
from deepspeedsyclsupport_tpu.inference.v2 import prefix_cache as jpc
from deepspeedsyclsupport_tpu.inference.v2.ragged import (
    BlockedAllocator as JaxAllocator)
from deepspeedsyclsupport_tpu.models import build_model as jax_build_model
from deepspeedsyclsupport_tpu_torch.inference.v2 import (
    BlockedAllocator, InferenceEngineV2)
from deepspeedsyclsupport_tpu_torch.inference.v2 import kv_cache as tkv
from deepspeedsyclsupport_tpu_torch.inference.v2 import prefix_cache as tpc
from deepspeedsyclsupport_tpu_torch.models import build_model, params_from_jax

IMPLS = {"jax": (jpc, JaxAllocator), "torch": (tpc, BlockedAllocator)}
ENGINE_KW = dict(block_size=8, max_context=64, max_tokens_per_batch=16,
                 max_sequences=4)
# SYSTEM covers two full 8-token blocks; tails diverge per request
SYSTEM = list(range(40, 56))
TAILS = {1: [3, 7, 11], 2: [9, 2], 3: [5, 5, 6, 1], 4: [8]}


def _index_prompt(mod, pc, alloc, tokens, tenant="default"):
    """Allocate and offer every full block of ``tokens`` (the engine's
    commit path in miniature); the index pin is then the blocks' only
    holder."""
    bs = pc.block_size
    blocks = alloc.allocate(len(tokens) // bs)
    h = b""
    for i, b in enumerate(blocks):
        h = mod.chain_hash(h, tokens[i * bs:(i + 1) * bs])
        pc.offer(tenant, h, b)
    alloc.release(blocks)
    return blocks


# ------------------------------------------------------------ unit scenarios
def _probe_block_aligned(mod, alloc_cls):
    a = alloc_cls(8)
    pc = mod.PrefixCache(a, 4)
    toks = list(range(100, 108))
    blocks = _index_prompt(mod, pc, a, toks)
    out = [pc.probe(toks), pc.probe(toks + [1]),
           pc.probe([toks[0] + 1] + toks[1:] + [1])]
    return blocks, [(b, c) for b, _, c in out], pc.stats()


def _peek_no_side_effects(mod, alloc_cls):
    a = alloc_cls(8)
    pc = mod.PrefixCache(a, 4)
    _index_prompt(mod, pc, a, list(range(8)))
    before = dict(pc.counters)
    return pc.peek(list(range(8)) + [9]), before == pc.counters


def _tenant_scoping(mod, alloc_cls):
    a = alloc_cls(8)
    pc = mod.PrefixCache(a, 4, scope="tenant")
    toks = list(range(9))
    _index_prompt(mod, pc, a, toks[:8], tenant="alice")
    g = mod.PrefixCache(alloc_cls(8), 4, scope="global")
    _index_prompt(mod, g, g.allocator, toks[:8], tenant="alice")
    return (pc.peek(toks, tenant="alice"), pc.peek(toks, tenant="bob"),
            g.peek(toks, tenant="bob"))


def _min_block_hits(mod, alloc_cls):
    a = alloc_cls(8)
    pc = mod.PrefixCache(a, 4, min_block_hits=2)
    (b,) = a.allocate(1)
    h = mod.chain_hash(b"", [1, 2, 3, 4])
    first = (pc.offer("default", h, b), pc.pinned_blocks, a.refcount(b))
    second = (pc.offer("default", h, b), pc.pinned_blocks, a.refcount(b))
    return first, second


def _max_pinned_lru(mod, alloc_cls):
    a = alloc_cls(8)
    pc = mod.PrefixCache(a, 4, max_pinned_blocks=2)
    b1 = _index_prompt(mod, pc, a, [1, 2, 3, 4])[0]
    b2 = _index_prompt(mod, pc, a, [5, 6, 7, 8])[0]
    pc.probe([1, 2, 3, 4, 9])            # b2 becomes the LRU entry
    b3 = _index_prompt(mod, pc, a, [9, 10, 11, 12])[0]
    return (pc.pinned_blocks, a.refcount(b1), a.refcount(b2),
            a.refcount(b3), pc.counters["unpins"])


def _reclaim_skips_shared(mod, alloc_cls):
    a = alloc_cls(8)
    pc = mod.PrefixCache(a, 4)
    b1 = _index_prompt(mod, pc, a, [1, 2, 3, 4])[0]
    b2 = _index_prompt(mod, pc, a, [5, 6, 7, 8])[0]
    a.retain([b1])                       # a live stream maps b1
    out = (pc.reclaimable(), pc.reclaim(2), a.refcount(b1), a.refcount(b2))
    a.release([b1])
    return out


def _invalidate(mod, alloc_cls):
    a = alloc_cls(8)
    pc = mod.PrefixCache(a, 4)
    _index_prompt(mod, pc, a, list(range(8)))
    _index_prompt(mod, pc, a, list(range(20, 28)))
    return a.free_blocks, pc.invalidate(), pc.pinned_blocks, a.free_blocks


def _validation(mod, alloc_cls):
    a = alloc_cls(4)
    out = []
    for kw in (dict(scope="everyone"), dict(min_block_hits=0),
               dict(max_pinned_blocks=0)):
        try:
            mod.PrefixCache(a, 4, **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


UNITS = {"probe_block_aligned": _probe_block_aligned,
         "peek_no_side_effects": _peek_no_side_effects,
         "tenant_scoping": _tenant_scoping,
         "min_block_hits": _min_block_hits,
         "max_pinned_lru": _max_pinned_lru,
         "reclaim_skips_shared": _reclaim_skips_shared,
         "invalidate": _invalidate,
         "validation": _validation}


@pytest.mark.parametrize("name", list(UNITS))
def test_prefix_cache_units_match_jax(name):
    """The JAX package's ``TestPrefixCacheUnits`` scenarios give the same
    blocks, lengths, refcounts and counters on both classes."""
    got = UNITS[name](*IMPLS["torch"])
    assert got == UNITS[name](*IMPLS["jax"])
    if name == "probe_block_aligned":
        blocks, probes, _ = got
        # >= 1 novel token: two full blocks probe as one; divergence misses
        assert probes == [(blocks[:1], 4), (blocks, 8), ([], 0)]
    if name == "validation":
        assert all(got)


def test_chain_hash_matches_jax():
    h = b""
    for block in ([1, 2, 3], [4, 5, 6], [7]):
        assert tpc.chain_hash(h, block) == jpc.chain_hash(h, block)
        h = tpc.chain_hash(h, block)


# ------------------------------------------------------- engine integration
@functools.lru_cache(maxsize=None)
def _jax_model():
    model = jax_build_model("tiny", dtype="float32")
    params = model.init_params(jax.random.PRNGKey(11))
    return model, params, jax.tree.map(np.asarray, params)


def _engines(**kw):
    """(JAX engine, port engine) on the same weights."""
    jmodel, jparams, np_params = _jax_model()
    model = build_model("tiny", dtype="float32")
    params = params_from_jax(np_params, model.config, device="cpu")
    kw = dict(ENGINE_KW, **kw)
    return (JaxEngine(jmodel, jparams, dtype=jnp.float32, **kw),
            InferenceEngineV2(model, params, device="cpu",
                              dtype=torch.float32, **kw))


def _greedy(eng, uid, prompt, n, argmax):
    """Greedy decode through put(): mapped prefixes, the copy-on-write
    guard and the commit path on every step."""
    logits = eng.put([uid], [list(prompt)])[uid]
    out = []
    for _ in range(n):
        out.append(argmax(logits))
        logits = eng.put([uid], [[out[-1]]])[uid]
    eng.flush([uid])
    return out


def _jargmax(x):
    return int(jnp.argmax(x))


def _targmax(x):
    return int(torch.argmax(x))


def _seq_state(eng, uid):
    d = eng.seqs[uid]
    return (d.n_cached, d.cached_prefix_len, list(d.blocks),
            list(d.block_hashes), list(d.history))


def test_mapped_prefix_shares_blocks_and_stats():
    """A second stream with the same 16-token head maps the donor's two
    blocks: descriptors, refcounts, ``kv_pool_stats`` and the cache's
    statistics equal the JAX engine's."""
    engines = _engines()
    res = []
    for eng, stats in zip(engines, (jkv.kv_pool_stats, tkv.kv_pool_stats)):
        pc = eng.install_prefix_cache()
        assert eng.install_prefix_cache() is pc        # idempotent
        eng.put([1], [SYSTEM + TAILS[1]])
        eng.put([2], [SYSTEM + TAILS[2]])
        donor = eng.seqs[1].blocks[:2]
        row = (_seq_state(eng, 1), _seq_state(eng, 2),
               [eng.allocator.refcount(b) for b in donor],
               stats(eng.kv, eng.allocator), pc.stats())
        eng.flush([1, 2])
        row += (pc.reclaimable(),)
        eng.uninstall_prefix_cache()
        row += (eng.allocator.free_blocks,)
        res.append(row)
    assert res[1] == res[0]
    t = res[1]
    assert t[1][1] == 16 and t[1][2][:2] == t[0][2][:2]
    assert t[2] == [3, 3]          # donor stream + index pin + sharer
    assert t[4]["hits"] == 1 and t[4]["tokens_saved"] == 16
    assert t[5] == 2 and t[6] == engines[1].config.num_blocks


@pytest.mark.parametrize("k", [1, 4])
def test_tokens_equal_with_the_cache_on_and_off(k):
    """Streams sharing SYSTEM give the same greedy tokens with the cache on
    and off, and equal to the JAX engine's; two of three probes hit, and
    block-aligned sharing never copies on write. With K = 4 ``generate``
    runs fused decode over mapped prefixes."""
    jeng, eng = _engines(decode_steps_per_dispatch=k)
    off = InferenceEngineV2(eng.model, eng.params, device="cpu",
                            dtype=torch.float32,
                            **dict(ENGINE_KW, decode_steps_per_dispatch=k))
    want = [_greedy(off, u, SYSTEM + TAILS[u], 5, _targmax)
            for u in (1, 2, 3)]
    jpcache, pc = jeng.install_prefix_cache(), eng.install_prefix_cache()
    got = [_greedy(eng, u, SYSTEM + TAILS[u], 5, _targmax) for u in (1, 2, 3)]
    assert got == want == [_greedy(jeng, u, SYSTEM + TAILS[u], 5, _jargmax)
                           for u in (1, 2, 3)]
    assert pc.stats() == jpcache.stats()
    assert pc.counters["hits"] == 2 and pc.counters["cow_copies"] == 0
    prompts = [SYSTEM + TAILS[u] for u in (1, 2, 3, 4)]
    assert eng.generate(prompts, max_new_tokens=7) == \
        off.generate(prompts, max_new_tokens=7) == \
        jeng.generate(prompts, max_new_tokens=7)
    assert pc.stats() == jpcache.stats()
    assert eng.host_dispatches == jeng.host_dispatches
    assert list(eng._decode_multi) == list(jeng._decode_multi)


def test_donor_preempt_keeps_sharer_intact():
    res = []
    for eng, argmax in zip(_engines(), (_jargmax, _targmax)):
        pc = eng.install_prefix_cache()
        eng.put([1], [SYSTEM + TAILS[1]])
        logits = eng.put([2], [SYSTEM + TAILS[2]])[2]
        shared = list(eng.seqs[2].blocks[:2])
        eng.preempt(1)
        row = [pc.pinned_blocks,
               [eng.allocator.refcount(b) for b in shared]]
        out = []
        for _ in range(5):
            out.append(argmax(logits))
            logits = eng.put([2], [[out[-1]]])[2]
        res.append(row + [out])
    assert res[1] == res[0]
    assert res[1][:2] == [2, [2, 2]]


def test_check_schedule_prices_novel_blocks_only():
    """A live donor holds 3 blocks (2 indexed, shared with the index, so
    not reclaimable) of 5: a cold 17-token request is rejected for KV, the
    same request with its 16-token cached prefix priced at one novel block
    is admitted, on both engines, with the same reasons."""
    res = []
    for eng in _engines(num_blocks=5, max_context=40):
        eng.install_prefix_cache()
        eng.put([1], [SYSTEM + [1]])
        cold = eng.check_schedule([2], [17], cached_prefix={2: 0})
        warm = eng.check_schedule([2], [17], cached_prefix={2: 16})
        res.append((cold.admitted, dict(cold.reasons), warm.admitted,
                    dict(warm.reasons), eng.prefix_cache.reclaimable()))
        eng.flush([1])
    assert res[1] == res[0]
    assert res[1][0] == () and "kv" in res[1][1][2] and res[1][2] == (2,)


def test_forced_shared_write_copies_once():
    """A write into a block another stream still maps (forced here; block
    alignment never does it) copies that block first: one copy-on-write,
    counted, the writer's table repointed to a fresh block holding the
    same rows, and the sharer's KV unchanged."""
    _, eng = _engines()
    pc = eng.install_prefix_cache()
    bs = eng.config.block_size
    eng.put([1], [SYSTEM + TAILS[1]])
    eng.put([2], [SYSTEM + TAILS[2]])
    d2 = eng.seqs[2]
    shared = d2.blocks[1]
    before = {li: eng.kv.k[li, shared * bs:(shared + 1) * bs].clone()
              for li in range(eng.kv.k.shape[0])}
    n_cached, d2.n_cached = d2.n_cached, 15   # rewrite its 16th token
    eng._ensure_writable(d2, 1)
    d2.n_cached = n_cached
    assert pc.counters["cow_copies"] == 1
    fresh = d2.blocks[1]
    assert fresh != shared and eng.allocator.refcount(fresh) == 1
    assert eng.allocator.refcount(shared) == 2   # donor + index pin
    for li, rows in before.items():
        assert torch.equal(eng.kv.k[li, fresh * bs:(fresh + 1) * bs], rows)
        assert torch.equal(eng.kv.k[li, shared * bs:(shared + 1) * bs], rows)
    eng.kv.k[:, fresh * bs:(fresh + 1) * bs] = 0.0   # the writer's update
    for li, rows in before.items():
        assert torch.equal(eng.kv.k[li, shared * bs:(shared + 1) * bs], rows)
    d2.n_cached = 15
    eng._ensure_writable(d2, 1)                      # nothing shared now
    d2.n_cached = n_cached
    assert pc.counters["cow_copies"] == 1
