"""PyTorch port: the precision of the Hopper flash kernels end to end
(ROADMAP C2), on the CPU.

The bf16 / fp16 kernels hand P (the forward's P V, the backward's dV) and
dS (dQ, dK) to the tensor cores as operands of the input type; the JAX
package keeps both in float32. Since C2 was closed every route, biased or
not, multiplies each as two operands, hi = T(x) and lo = T(x - hi), into
one float32 accumulator (before it, one operand T(x): "rounded"). ``tools/flash_e2e_row_error.py``
emulates both arithmetics end to end (forward, delta from the bf16 O,
backward); this test runs it at the cut MSA shape of ``chip_smoke.py``
phase 9 (N_seq 512 -> 8 rows of S = 384, H = 8, D = 32, mask bias and a
pair bias broadcast over the rows, bf16 inputs from a seed) beside ``jax.vjp``
of the JAX package's flash attention (Pallas kernels in interpret mode) and
an fp64 oracle, with the row error of ``chip_smoke.py`` (each row's max
error over its largest |grad|, at least 1 % of the tensor's).

What it shows. The new arithmetic errs against fp64 as the reference does
(within twice its error; equal here). The old one errs
about as the reference does in dQ and dK: the dQ excess seen on an H100
(0.0385 over 512 rows against the reference's 0.0088 over 8) came from the
row count, the max over 64 times more rows, not from the kernels. What the old
arithmetic does cost: dV errs ~1.8 times the reference (P rounded before
P^T dO), and the end-to-end dQ departs from the plain version, which
``chip_smoke.py`` holds the kernels against, by ~2.5 times the new
arithmetic's departure (the forward's rounded P moves delta).
"""
import functools
import importlib.util
from pathlib import Path

TOOL = Path(__file__).resolve().parent.parent / "tools" / \
    "flash_e2e_row_error.py"
SEED = 0
GRADS = ("dq", "dk", "dv")
# The unbiased causal shape (the tool's "causal": S 1024, H 8, D 64, the
# llama2-1b training route's arithmetic). End-to-end dQ rows against the
# plain version are held at twice the departure of the JAX package's own
# algebra (P and dS in float32, O in bf16: the tool's "none" variant),
# 0.0038 at seed 0, since both sides may err by it. ``chip_smoke.py``
# holds llama2-1b's end-to-end dQ rows on the card at the same limit.
CAUSAL_E2E_DQ_ROW_LIMIT = 2 * 0.0038


@functools.lru_cache(maxsize=None)
def _tool():
    spec = importlib.util.spec_from_file_location("flash_e2e_row_error",
                                                  TOOL)
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    return t


@functools.lru_cache(maxsize=None)
def _run():
    """Row errors at the cut MSA shape: the JAX package's, the old (P and
    dS rounded) and the new (split) arithmetic's against fp64, and both
    arithmetics' dQ against the plain version end to end."""
    from deepspeedsyclsupport_tpu_torch.ops import flash_attention as tfa

    t = _tool()
    c = t.shapes(8)["msa"]
    arrays = t.inputs(c, SEED)
    ref = t.oracle(*arrays, c["causal"])
    tq, tk, tv, tdo, mask, bias = t.torch_case(c, arrays, "bfloat16")
    o, lse = tfa.flash_attention_fwd_reference(tq, tk, tv, mask, bias)
    plain_dq = tfa.flash_attention_bwd_reference(
        tq, tk, tv, tdo, lse, tfa.attention_delta(tdo, o), mask, "dq",
        bias=bias)[0].numpy()
    out = {"jax": [t.row_err(g, r)
                   for g, r in zip(t.jax_grads(c, arrays), ref)]}
    for name, variant in (("old", "rounded"), ("new", "split")):
        grads = t.emulate_port(tq, tk, tv, tdo, mask, bias,
                               *t.VARIANTS[variant])
        out[name] = [t.row_err(g.numpy(), r) for g, r in zip(grads, ref)]
        out[name + "_e2e"] = t.row_err(grads[0].numpy(), plain_dq)
    return out


def test_split_operands_err_as_the_reference_does():
    """dQ, dK and dV of the new arithmetic within twice the JAX package's
    own row error against fp64, on the same inputs."""
    r = _run()
    for name, new, ref in zip(GRADS, r["new"], r["jax"]):
        assert new <= 2 * ref, f"{name}: split row error {new} > 2 x {ref}"


def test_rounded_p_nearly_doubles_the_dv_error():
    """The old arithmetic: dV's row error against fp64 is more than 1.5
    times the JAX package's (P rounded to bf16 before P^T dO), while dQ's
    stays within twice the reference's at this row count."""
    r = _run()
    assert r["old"][2] > 1.5 * r["jax"][2], (r["old"][2], r["jax"][2])
    assert r["old"][0] <= 2 * r["jax"][0], (r["old"][0], r["jax"][0])


def test_split_operands_follow_the_plain_version_end_to_end():
    """End to end against the plain version (float32 algebra, delta from its
    own bf16 O), the measure ``chip_smoke.py`` holds on the card: the old
    arithmetic departs more than twice as far as the new one, whose
    departure is within twice the JAX package's own dQ error."""
    r = _run()
    assert r["old_e2e"] > 2 * r["new_e2e"], (r["old_e2e"], r["new_e2e"])
    assert r["new_e2e"] <= 2 * r["jax"][0]


@functools.lru_cache(maxsize=None)
def _causal():
    """At the unbiased causal shape: each arithmetic's (none, rounded,
    split) row errors against fp64 and its dQ against the plain version
    end to end (``tools/flash_e2e_row_error.py``'s ``port_rows``)."""
    t = _tool()
    c = t.shapes(8)["causal"]
    return t.port_rows(c, t.inputs(c, SEED),
                       "bfloat16", variants=("none", "rounded", "split"))


def test_unbiased_causal_split_holds_the_e2e_dq_limit():
    """ROADMAP C2 on the unbiased routes: end to end against the plain
    version, the split arithmetic's dQ rows stay within
    ``CAUSAL_E2E_DQ_ROW_LIMIT``, whose source (the JAX algebra's own
    departure) is checked here too; the rounded arithmetic (the unbiased
    routes before the fix) exceeds it."""
    r = _causal()
    lim = CAUSAL_E2E_DQ_ROW_LIMIT
    assert r["none"]["dq_vs_plain_row"] <= lim / 2 + 1e-4, r["none"]
    assert r["split"]["dq_vs_plain_row"] <= lim, r["split"]
    assert r["rounded"]["dq_vs_plain_row"] > lim, r["rounded"]


def test_unbiased_causal_split_errs_as_the_reference_algebra():
    """Against fp64 the split arithmetic's dQ, dK and dV rows err within
    twice the JAX algebra's (``none``); the rounded one errs 1.3 times or
    more in dV (P rounded before P^T dO)."""
    r = _causal()
    for name in GRADS:
        key = f"{name}_row"
        assert r["split"][key] <= 2 * r["none"][key], (name, r)
    assert r["rounded"]["dv_row"] > 1.3 * r["none"]["dv_row"], r
