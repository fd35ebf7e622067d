"""PyTorch port: the MoE routing over the GLOBAL token set, without
processes (``parallel/moe.py``: ``segment_counts``, ``global_slots``,
``_capacity_route`` with a ``tokens`` layout).

Under a process group each rank routes its own tokens from its logits and
every rank's per-segment counts; the result must be the routing of the
whole micro-batch on one card, which is the JAX package's ``topk_gating``
(``tests/test_torch_moe_train.py`` holds that one against JAX). The global
logits are split into R shards as the engine splits tokens: contiguous
blocks of rows over the batch ranks, and under sequence parallelism each
row's positions in contiguous chunks over ``seq``. The slots, the kept
set and the combine weights are EQUAL to the whole's rows; the ranks' aux
shares sum to the whole's aux within 1e-6 (float32 sums in another
order), and to the JAX ``topk_gating``'s aux within 1e-6. Jitter: each
rank's noise is its tokens' part of the global draw, so the routing with
jitter is EQUAL too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.parallel import moe as jax_moe
from deepspeedsyclsupport_tpu_torch.parallel import moe


class _Shard:
    """A :class:`moe._Tokens` for rank ``(r, q)`` of ``nb`` batch ranks
    and ``sp`` seq ranks, its gather answered from every rank's counts."""

    def __init__(self, r, q, nb, sp, rows, counts_of):
        self.n, self.sp = nb * sp, sp
        self.g = rows if sp > 1 else 1
        self.segments = self.n * self.g
        self.mine = (r * self.g) * sp + q + sp * torch.arange(self.g)
        self._counts_of = counts_of

    def gather(self, counts):
        got = torch.stack(self._counts_of())        # [n, G, k, E] by r, q
        got = got.view(self.n // self.sp, self.sp, *counts.shape)
        return got.transpose(1, 2).reshape(self.segments,
                                           *counts.shape[1:])


def _logits(seed, b, s, e, skew):
    rng = np.random.RandomState(seed)
    lg = rng.randn(b, s, e).astype(np.float32)
    lg[..., 0] += skew              # most tokens prefer expert 0: drops
    lg[0, 1] = 0.25                 # every expert tied
    return lg


def _shards(lg, nb, sp):
    """Rank (r, q)'s tokens: rows block r, positions chunk q, [T_r, E]."""
    b, s, e = lg.shape
    rb, c = b // nb, s // sp
    return {(r, q): torch.from_numpy(np.ascontiguousarray(
        lg[r * rb:(r + 1) * rb, q * c:(q + 1) * c])).reshape(-1, e)
            for r in range(nb) for q in range(sp)}


def _rank_routes(lg, k, cap, nb, sp, jitter=0.0, seed=0):
    b, s, e = lg.shape
    shards = _shards(lg, nb, sp)
    top = {rq: moe._topk(x, k)[2] if jitter == 0.0 else None
           for rq, x in shards.items()}
    rows = b // nb

    def counts_of_all():
        # every rank's [G, k, E] counts, in (r, q) order (the all-gather)
        out = []
        for (r, q), x in sorted(shards.items()):
            noise = None
            if jitter:
                sh = _Shard(r, q, nb, sp, rows, None)
                full = moe._jitter((b * s, e), x.dtype, x.device,
                                   torch.Generator().manual_seed(seed),
                                   jitter)
                noise = full.view(sh.segments, -1, e)[sh.mine].reshape(
                    x.shape)
            te = moe._topk(x, k, noise)[2] if jitter else top[(r, q)]
            out.append(moe.segment_counts(te, e, rows if sp > 1 else 1))
        return out

    got = {}
    for (r, q), x in shards.items():
        tok = _Shard(r, q, nb, sp, rows, counts_of_all)
        gen = torch.Generator().manual_seed(seed) if jitter else None
        got[(r, q)] = moe._capacity_route(x, k, cap, gen, jitter,
                                          tokens=tok)
    return got


def _whole_rows(b, s, nb, sp, r, q):
    """The global token indices of rank (r, q)'s tokens, in its order."""
    rb, c = b // nb, s // sp
    return np.array([row * s + pos for row in range(r * rb, (r + 1) * rb)
                     for pos in range(q * c, (q + 1) * c)])


CASES = [
    # (B, S, E, k, nb, sp, capacity)
    (4, 8, 4, 2, 4, 1, 3),
    (4, 8, 4, 2, 2, 1, 9),
    (8, 6, 8, 2, 4, 1, 2),
    (4, 8, 4, 1, 2, 1, 5),
    (2, 16, 8, 2, 2, 2, 4),
    (4, 8, 4, 2, 1, 4, 6),
    (4, 12, 4, 2, 2, 3, 64),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B%d_S%d_E%d_k%d_"
                         "nb%d_sp%d_C%d" % c)
@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_rank_routes_equal_the_whole(case, jitter):
    b, s, e, k, nb, sp, cap = case
    lg = _logits(sum(case), b, s, e, skew=1.5)
    whole = torch.from_numpy(lg).reshape(-1, e)
    gen = torch.Generator().manual_seed(7) if jitter else None
    w_exp, w_pos, w_keep, w_gate, w_aux = moe._capacity_route(
        whole, k, cap, gen, jitter)
    t = b * s
    got = _rank_routes(lg, k, cap, nb, sp, jitter, seed=7)
    aux = 0.0
    for (r, q), (expert, pos, keep, gate, a) in got.items():
        idx = _whole_rows(b, s, nb, sp, r, q)
        rows = np.concatenate([c * t + idx for c in range(k)])
        np.testing.assert_array_equal(expert.numpy(), w_exp.numpy()[rows])
        np.testing.assert_array_equal(pos.numpy(), w_pos.numpy()[rows])
        np.testing.assert_array_equal(keep.numpy(), w_keep.numpy()[rows])
        np.testing.assert_array_equal(gate.numpy(), w_gate.numpy()[rows])
        aux += float(a)
    np.testing.assert_allclose(aux, float(w_aux), rtol=1e-6)
    if jitter == 0.0:
        d_want, _, a_want = jax_moe.topk_gating(
            jnp.asarray(lg.reshape(-1, e)), k, cap)
        np.testing.assert_allclose(aux, float(a_want), rtol=1e-6)
        # the kept (token, choice) set and its slots: the JAX dispatch's
        kept = np.zeros((t, e, cap))
        for c in range(k):
            sl = slice(c * t, (c + 1) * t)
            m = w_keep.numpy()[sl]
            kept[np.arange(t)[m], w_exp.numpy()[sl][m],
                 w_pos.numpy()[sl][m]] += 1
        np.testing.assert_array_equal(kept, np.asarray(d_want))
    if cap < t * k / e:
        assert not bool(w_keep.all())      # rows were dropped


def test_one_segment_is_the_single_card_cumsum():
    """``global_slots`` over one segment holding every token is the
    single-card cumsum over the choice-major rows, exactly."""
    rng = np.random.RandomState(0)
    top_e = torch.from_numpy(rng.randint(0, 6, (40, 2)))
    counts = moe.segment_counts(top_e, 6)
    assert counts.shape == (1, 2, 6)
    expert, pos = moe.global_slots(top_e, counts, torch.zeros(1, dtype=torch.int64))
    flat = top_e.t().reshape(-1)
    oh = torch.nn.functional.one_hot(flat, 6)
    want = (oh.cumsum(0) - oh).gather(1, flat[:, None])[:, 0]
    assert torch.equal(expert, flat) and torch.equal(pos, want)
