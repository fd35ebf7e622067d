"""PyTorch port: the host-side serving machinery (refcounted allocator,
SplitFuse scheduler, ragged batch builder with atoms) is a copy of the JAX
package's; on seeded random workloads both must give array-identical
results, step by step."""
import numpy as np
import pytest

from deepspeedsyclsupport_tpu.inference.v2 import ragged as jr
from deepspeedsyclsupport_tpu.inference.v2 import scheduler as js
from deepspeedsyclsupport_tpu_torch.inference.v2 import ragged as tr
from deepspeedsyclsupport_tpu_torch.inference.v2 import scheduler as ts


def _workload(seed):
    """A random mix of decoding and prompt-phase sequences."""
    rng = np.random.RandomState(seed)
    seqs = []
    for uid in range(rng.randint(2, 9)):
        if rng.rand() < 0.4:
            seqs.append(dict(uid=uid, pending=[int(rng.randint(1, 500))],
                             n_cached=int(rng.randint(1, 60))))
        else:
            seqs.append(dict(uid=uid, pending=[int(t) for t in rng.randint(
                1, 500, size=rng.randint(1, 70))], n_cached=0))
        seqs[-1]["last_scheduled"] = int(rng.randint(-1, 5))
    knobs = dict(max_tokens=int(rng.choice([16, 32, 64])),
                 max_sequences=int(rng.choice([4, 8])), block_size=8,
                 max_context=128,
                 max_prefill_fraction=float(rng.choice([1.0, 0.5, 0.25])))
    return seqs, knobs, int(rng.randint(8, 40))


def _run(mod_ragged, mod_sched, seqs, knobs, num_blocks, atom_q):
    """Drive scheduler + batch builder until nothing is schedulable;
    returns every batch's arrays and the allocator's final state."""
    alloc = mod_ragged.BlockedAllocator(num_blocks)
    descs = []
    for s in seqs:
        d = mod_ragged.SequenceDescriptor(uid=s["uid"],
                                          pending=list(s["pending"]),
                                          n_cached=s["n_cached"],
                                          last_scheduled=s["last_scheduled"])
        if d.n_cached:
            got = alloc.try_allocate(d.blocks_needed(0, knobs["block_size"]))
            if got is None:
                continue
            d.blocks = got
        descs.append(d)
    trace = []
    for tick in range(200):
        chunks = mod_sched.schedule_chunks(descs, alloc, **knobs)
        if not chunks:
            break
        batch = mod_ragged.build_ragged_batch(
            chunks, knobs["max_tokens"], knobs["max_sequences"],
            knobs["max_context"] // knobs["block_size"], atom_q=atom_q)
        trace.append(batch)
        for d, n in chunks:
            d.last_scheduled = tick
            del d.pending[:n]
            d.n_cached += n
        # retire finished sequences (refcounted release)
        for d in [d for d in descs if not d.pending]:
            alloc.free(d.blocks)
            descs.remove(d)
    return trace, (alloc.free_blocks, alloc.logical_blocks,
                   sorted(alloc._free))


FIELDS = ("tokens", "token_seq", "token_pos", "block_tables", "last_tok_idx",
          "seq_active", "atom_qidx", "atom_pos0", "atom_qlen", "atom_tables",
          "atom_inv")


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("atom_q", [None, 4, 16])
def test_schedule_and_batches_identical(seed, atom_q):
    seqs, knobs, num_blocks = _workload(seed)
    jt, jstate = _run(jr, js, seqs, knobs, num_blocks, atom_q)
    tt, tstate = _run(tr, ts, seqs, knobs, num_blocks, atom_q)
    assert jstate == tstate
    assert len(jt) == len(tt) and len(jt) > 0
    for jb, tb in zip(jt, tt):
        assert jb.uids == tb.uids
        for f in FIELDS:
            a, b = getattr(jb, f), getattr(tb, f)
            if a is None:
                assert b is None, f
            else:
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_allocator_refcounts_identical():
    rng = np.random.RandomState(0)
    ja, ta = jr.BlockedAllocator(16), tr.BlockedAllocator(16)
    held = []
    for _ in range(200):
        op = rng.randint(3)
        if op == 0:
            n = int(rng.randint(0, 6))
            got_j, got_t = ja.try_allocate(n), ta.try_allocate(n)
            assert got_j == got_t
            if got_j:
                held.append(list(got_j))
        elif op == 1 and held:
            blocks = held[rng.randint(len(held))]
            ja.retain(blocks)
            ta.retain(blocks)
            held.append(list(blocks))
        elif held:
            blocks = held.pop(rng.randint(len(held)))
            ja.release(blocks)
            ta.release(blocks)
        assert (ja.free_blocks, ja.logical_blocks, ja.shared_blocks) == \
            (ta.free_blocks, ta.logical_blocks, ta.shared_blocks)
    with pytest.raises(ValueError):
        ta.release([99])
    with pytest.raises(RuntimeError):
        ta.allocate(17)


def test_slack_policy_order_identical():
    """With an SLA policy both schedulers order chunks by the same slack."""
    rng = np.random.RandomState(1)
    knobs = dict(max_tokens=32, max_sequences=8, block_size=8,
                 max_context=128)
    draws = list(zip(rng.randint(1, 20, 6), rng.rand(6), rng.rand(6)))
    out = []
    for mr, ms in ((jr, js), (tr, ts)):
        descs = [mr.SequenceDescriptor(
            uid=u, pending=list(range(1, 1 + int(n))), arrival_s=float(a),
            deadline_s=float(a) + float(dl), tenant=f"t{u % 2}")
            for u, (n, a, dl) in enumerate(draws)]
        pol = ms.SlackPolicy(now=0.5, prefill_tok_s=100.0,
                             tenant_budget={"t0": 10, "*": 30})
        chunks = ms.schedule_chunks(descs, mr.BlockedAllocator(64),
                                    policy=pol, **knobs)
        out.append([(d.uid, n) for d, n in chunks])
    assert out[0] == out[1] and out[0]
