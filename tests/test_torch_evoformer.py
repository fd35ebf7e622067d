"""PyTorch port: ``DS4Sci_EvoformerAttention`` against the JAX package's
(``deepspeedsyclsupport_tpu/ops/evoformer_attn.py``, its Pallas flash kernel
in interpret mode), on numpy inputs made from a seed.

Shapes are those of ``tests/unit/test_evoformer_attn.py`` (B=2 MSA stacks of
N=3 rows, S=64, H=4, D=32). Tolerances are that test's own: 2e-5 for the
forward and 5e-4 for the gradients of q, k, v and the pair bias (float32 on
both sides; only summation order and the exp of the two backends differ,
and the pair-bias gradient sums N rows more).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeedsyclsupport_tpu.ops.evoformer_attn import (
    evoformer_attention as jax_evoformer)
from deepspeedsyclsupport_tpu_torch.ops import DS4Sci_EvoformerAttention
from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa
from deepspeedsyclsupport_tpu_torch.ops.evoformer_attn import (
    evoformer_attention)

B, N, S, H, D = 2, 3, 64, 4, 32
FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def _msa(seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, N, S, H, D).astype(np.float32) for _ in range(3))
    mask_bias = np.where(rng.rand(B, N, 1, 1, S) > 0.2, 0.0,
                         -1e9).astype(np.float32)
    pair = rng.randn(B, 1, H, S, S).astype(np.float32)
    return q, k, v, mask_bias, pair


BIASES = {"both": (True, True), "none": (False, False),
          "mask_only": (True, False), "pair_only": (False, True)}


def _biases(which, mask_bias, pair, conv):
    use_mask, use_pair = BIASES[which]
    return [conv(mask_bias) if use_mask else None,
            conv(pair) if use_pair else None]


@pytest.mark.parametrize("which", sorted(BIASES))
def test_forward_matches_jax(which):
    q, k, v, mb, pair = _msa(len(which))
    want = jax_evoformer(*map(jnp.asarray, (q, k, v)),
                         _biases(which, mb, pair, jnp.asarray),
                         interpret=True)
    got = evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                              _biases(which, mb, pair, torch.from_numpy))
    assert got.shape == (B, N, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("which", ["both", "pair_only", "mask_only"])
def test_grads_match_jax(which):
    """Grads of q, k, v and the pair bias; the pair bias's sums over the N
    rows that share it."""
    q, k, v, mb, pair = _msa(10 + len(which))
    use_mask, use_pair = BIASES[which]
    w = np.random.RandomState(3).randn(B, N, S, H, D).astype(np.float32)

    def jloss(q_, k_, v_, p_):
        biases = [jnp.asarray(mb) if use_mask else None,
                  p_ if use_pair else None]
        return jnp.sum(jax_evoformer(q_, k_, v_, biases, interpret=True)
                       * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, pair)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, pair)]
    biases = [torch.from_numpy(mb) if use_mask else None,
              leaves[3] if use_pair else None]
    (evoformer_attention(*leaves[:3], biases)
     * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves[:3] + (leaves[3:] if use_pair else []), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_alias_and_exports():
    assert DS4Sci_EvoformerAttention is evoformer_attention
    from deepspeedsyclsupport_tpu_torch import ops

    assert ops.DS4Sci_EvoformerAttention is evoformer_attention


def test_masked_key_does_not_influence_output():
    """A key masked by a -1e9 mask bias in every row: perturbing its k and v
    leaves the output as it was (the JAX test's invariance)."""
    q, k, v, _, _ = _msa(3)
    mask_bias = np.zeros((B, N, 1, 1, S), np.float32)
    mask_bias[..., 7] = -1e9
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 7] = -55.0
    v2[:, :, 7] = 123.0
    out1, out2 = (evoformer_attention(
        *map(torch.from_numpy, (q, kk, vv)), [torch.from_numpy(mask_bias)])
        for kk, vv in ((k, v), (k2, v2)))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


def test_minus_inf_mask_on_every_key_matches_jax():
    """A row whose mask bias is -inf on every key: o = 0 and finite zero
    grads there, as the JAX function gives."""
    q, k, v, _, pair = _msa(4)
    mask_bias = np.zeros((B, N, 1, 1, S), np.float32)
    mask_bias[1, 2] = -np.inf
    biases_j = [jnp.asarray(mask_bias), jnp.asarray(pair)]
    want = jax_evoformer(*map(jnp.asarray, (q, k, v)), biases_j,
                         interpret=True)
    want_gq = jax.grad(lambda q_: jnp.sum(jax_evoformer(
        q_, jnp.asarray(k), jnp.asarray(v), biases_j, interpret=True)))(
        jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    out = evoformer_attention(tq, *map(torch.from_numpy, (k, v)),
                              [torch.from_numpy(mask_bias),
                               torch.from_numpy(pair)])
    out.sum().backward()
    assert float(out.detach()[1, 2].abs().max()) == 0.0
    assert bool(torch.isfinite(tq.grad).all())
    assert float(tq.grad[1, 2].abs().max()) == 0.0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_gq),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_mask_bias_gradient_is_zeros():
    """The mask bias is non-differentiable by design: its gradient is zeros,
    as the JAX package's backward gives it."""
    q, k, v, mb, pair = _msa(5)
    tmb = torch.from_numpy(mb).requires_grad_()
    evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                        [tmb, torch.from_numpy(pair)]).sum().backward()
    assert tmb.grad is not None and float(tmb.grad.abs().max()) == 0.0


def test_bad_shapes_rejected():
    q, k, v, _, _ = _msa(6)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="B, N, S, H, D"):
        evoformer_attention(tq[0], tk[0], tv[0])
    with pytest.raises(ValueError, match="unrecognized"):
        evoformer_attention(tq, tk, tv, [torch.zeros((B, N, H, S, S))])
    with pytest.raises(ValueError, match="rank must be 5"):
        evoformer_attention(tq, tk, tv, [torch.zeros((B, H, S, S))])


def test_cpu_tensors_never_launch():
    q, k, v, mb, pair = _msa(7)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, pair)]
    tfa.reset_launch_counts()
    evoformer_attention(*leaves[:3], [torch.from_numpy(mb), leaves[3]]
                        ).sum().backward()
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)
    assert leaves[3].grad.shape == pair.shape
