"""PyTorch port: exact top-k MoE serving (``parallel/moe.py``) against the
JAX package's ``moe_mlp_nodrop``.

The same numpy router, experts and tokens go through both in float32, with
k = 1 and k = 2 over 8 experts, one expert left without a token. Outputs
agree to 2e-4, the JAX package's engine tolerance: both sum the same
products in float32 in other orders. The card's grouped-GEMM route over
the sorted rows runs here on CPU tensors and is held against the plain
version at 2e-5 (float32 products of width 64 and 128 in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.models import get_config as jax_get_config
from deepspeedsyclsupport_tpu.parallel.moe import moe_mlp_nodrop as jax_moe
from deepspeedsyclsupport_tpu_torch.models import get_config
from deepspeedsyclsupport_tpu_torch.parallel import moe

TOL = 2e-4
ROUTE_TOL = 2e-5
T, D, F, E = 24, 64, 128, 8
EMPTY = 5          # the expert no token chooses


def _inputs(seed=0):
    """Tokens with a constant first feature and a router whose column for
    EMPTY is strongly negative on it: that expert's logit is ~ -300 for
    every token, so it gets no row."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, D).astype(np.float32)
    x[:, 0] = 3.0
    router = rng.randn(D, E).astype(np.float32)
    router[0] = 0.0
    router[0, EMPTY] = -100.0
    p = {"router": router,
         "w_gate": (rng.randn(E, D, F) * 0.1).astype(np.float32),
         "w_up": (rng.randn(E, D, F) * 0.1).astype(np.float32),
         "w_down": (rng.randn(E, F, D) * 0.1).astype(np.float32)}
    return x, p


def _cfgs(k):
    over = dict(hidden_size=D, intermediate_size=F, num_experts=E,
                num_experts_per_tok=k)
    return jax_get_config("tiny-moe", **over), get_config("tiny-moe", **over)


def _torch(p):
    return {n: torch.from_numpy(v) for n, v in p.items()}


@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_nodrop_matches_jax(k):
    x, p = _inputs()
    jcfg, cfg = _cfgs(k)
    want = np.asarray(jax_moe({n: jnp.asarray(v) for n, v in p.items()},
                              jnp.asarray(x), jcfg))
    got = moe.moe_mlp_nodrop(_torch(p), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    _, experts = moe.topk_route(torch.from_numpy(x),
                                torch.from_numpy(p["router"]), k)
    assert not bool((experts == EMPTY).any())
    assert len(set(experts.flatten().tolist())) >= 4


def test_topk_route_orders_choices_by_expert():
    """Choices come in ascending expert order with their own gates; the
    gates are the JAX package's renormalised top-k probabilities."""
    x, p = _inputs(1)
    gate, experts = moe.topk_route(torch.from_numpy(x),
                                   torch.from_numpy(p["router"]), 3)
    assert bool((experts[:, 1:] > experts[:, :-1]).all())
    logits = x @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.take_along_axis(probs, experts.numpy(), axis=1)
    want /= want.sum(-1, keepdims=True)
    np.testing.assert_allclose(gate.numpy(), want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_card_routes_match_plain(k):
    """The card's grouped route (here on CPU tensors) against the plain
    version,
    with an empty expert, and a skewed routing: every token's first choice
    expert 0, its others among 1-3 and 4-6, expert 7 none."""
    x, p = _inputs(2)
    tx, tp = torch.from_numpy(x), _torch(p)
    act = moe._activation("silu")
    gate, experts = moe.topk_route(tx, tp["router"], k)
    r = torch.arange(T) % 3
    skew = torch.stack([torch.zeros(T, dtype=torch.long), 1 + r, 4 + r],
                       dim=1)[:, :k]
    for ex in (experts, skew):
        want = moe.experts_plain(tp, tx, gate, ex, act)
        got = moe.experts_grouped(tp, tx, gate, ex, act)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ROUTE_TOL,
                                   rtol=ROUTE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cpu_tensors_take_the_plain_version(dtype, monkeypatch):
    """On CPU tensors ``moe_mlp_nodrop`` runs the plain version, whatever
    the dtype (bf16 included: the grouped route is the card's), and gives
    its bits."""
    x, p = _inputs(3)
    tx = torch.from_numpy(x).to(dtype)
    tp = {n: v.to(dtype) for n, v in _torch(p).items()}
    cfg = _cfgs(2)[1]

    def refuse(*a, **k):
        raise AssertionError("the grouped route ran on CPU tensors")

    monkeypatch.setattr(moe, "experts_grouped", refuse)
    got = moe.moe_mlp_nodrop(tp, tx, cfg)
    gate, experts = moe.topk_route(tx, tp["router"], 2)
    want = moe.experts_plain(tp, tx, gate, experts,
                             moe._activation(cfg.activation))
    assert got.dtype == dtype and torch.equal(got, want)


def test_grouped_route_needs_grouped_mm(monkeypatch):
    """No silent fallback: without torch._grouped_mm the grouped route
    raises."""
    x, p = _inputs()
    tx, tp = torch.from_numpy(x), _torch(p)
    gate, experts = moe.topk_route(tx, tp["router"], 2)
    monkeypatch.delattr(torch, "_grouped_mm", raising=False)
    with pytest.raises(RuntimeError, match="_grouped_mm"):
        moe.experts_grouped(tp, tx, gate, experts, moe._activation("silu"))


def test_routes_read_nothing_back_to_the_host(monkeypatch):
    """What a CUDA graph cannot hold (a value read back to the host, a
    tensor made from host data) appears in no route's Python code."""
    x, p = _inputs()
    tx, tp = torch.from_numpy(x), _torch(p)
    cfg = _cfgs(2)[1]

    def refuse(*a, **k):
        raise AssertionError("host read or host tensor in a MoE route")

    with monkeypatch.context() as m:
        for name in ("nonzero", "item", "tolist", "__bool__"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch, "tensor", refuse)
        m.setattr(torch, "from_numpy", refuse)
        gate, experts = moe.topk_route(tx, tp["router"], 2)
        act = moe._activation(cfg.activation)
        moe.experts_grouped(tp, tx, gate, experts, act)
        moe.moe_mlp_nodrop(tp, tx, cfg)
