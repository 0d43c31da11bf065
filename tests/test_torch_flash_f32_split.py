"""The float32 flash kernels' split, on the CPU: their arithmetic emulated
in plain PyTorch, chip_smoke's float32 flash rows and its train_f32 phase.

``csrc/flash_attention.cu`` runs float32 attention on the bf16 tensor
cores: each float32 operand of a product (Q, K, V, dO, and P and dS,
formed in registers) is split into ``F32_TERMS`` (three) bf16 terms,
hi = bf16(x), then bf16 of what is left, and a product keeps the term
pairs whose indexes sum below the count (six of nine), summed in float32.
The module's ``flash_attention_split_fwd_ref`` and
``flash_attention_split_bwd_ref`` repeat that in float32 (the forward's P
against the row's maximum: its split is relative, as the kernel's against
its running maximum). With three terms they land within the card's
float32 tolerances (out and lse 1e-4, gradients 1e-4 of their largest
magnitude) of ``flash_attention_fwd_ref`` / ``flash_attention_bwd_ref``,
of the reference's ``flash_attention_ref`` and of ``jax.grad`` of it, and
within half of them of a float64 evaluation; with one term (plain bf16
operands) they miss them. On scores in the hundreds (q and k as large as
on the reference init's first train call) three terms land as near
float64 as plain float32 does, within twice its distance, and two terms
do not: why the kernels take three. On the card the kernels themselves
are held by ``chip_smoke.py``'s kernels phase, its float32 rows'
float64 witness (``f64_witness``, the same rule) and
``tests/test_torch_flash_attention.py -m gpu``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    F32_TERMS, flash_attention_bwd_ref, flash_attention_fwd_ref,
    flash_attention_split_bwd_ref, flash_attention_split_fwd_ref)

# (B, Hkv, G, T, hd, options): hd 64 at G 4, 192 at MLA's scale, 256 with
# a window and a softcap
CASES = {
    "hd64": (1, 2, 4, 256, 64, {}),
    "hd192": (1, 4, 1, 256, 192, {"scale": 1 / math.sqrt(192)}),
    "hd256": (1, 2, 2, 300, 256, {"window": 70, "softcap": 50.0}),
}
TOL = 1e-4  # out and lse; gradients: of their largest magnitude
# the same shapes with q and k scaled so that scores reach the hundreds
# (max |s| about 320, 160 and 170 before the softcap), as a hard max on
# the reference init
LARGE = {"hd64": 8.0, "hd192": 6.0, "hd256": 6.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _errors(got_fwd, got_bwd, want_fwd, want_bwd):
    """(out, lse, gradients over their largest magnitude) apart."""
    scale = max(float(w.abs().max()) for w in want_bwd)
    return (float((got_fwd[0].double() - want_fwd[0]).abs().max()),
            float((got_fwd[1].double() - want_fwd[1]).abs().max()),
            max(float((g.double() - w).abs().max())
                for g, w in zip(got_bwd, want_bwd)) / scale)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    B, Hkv, G, T, hd, kw = CASES[request.param]
    rng = np.random.default_rng(hd)
    arrays = [rng.normal(size=s).astype(np.float32) for s in (
        (B, Hkv, G, T, hd), (B, Hkv, T, hd), (B, Hkv, T, hd),
        (B, Hkv, G, T, hd))]
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = flash_attention_fwd_ref(q, k, v, **kw)
    plain = ((o, lse), flash_attention_bwd_ref(q, k, v, o, lse, do, **kw))
    f64 = [t.double() for t in (q, k, v)]
    o64, lse64 = flash_attention_fwd_ref(*f64, **kw)
    exact = ((o64, lse64), flash_attention_bwd_ref(
        *f64, o.double(), lse.double(), do.double(), **kw))
    return arrays, kw, plain, exact


def _emulated(case, terms):
    arrays, kw, plain, _ = case
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = plain[0]
    return (flash_attention_split_fwd_ref(q, k, v, terms=terms, **kw),
            flash_attention_split_bwd_ref(q, k, v, o, lse, do, terms=terms,
                                          **kw))


def test_split_is_within_the_card_tolerances(case):
    """Three terms: within the card's float32 tolerances of the plain
    versions, and within half of them of a float64 evaluation."""
    assert F32_TERMS == 3
    _, _, plain, exact = case
    got = _emulated(case, F32_TERMS)
    for want, allowed in ((plain, TOL), (exact, TOL / 2)):
        out, lse, grads = _errors(*got, *want)
        assert out <= allowed and lse <= allowed and grads <= allowed, \
            (out, lse, grads)


def test_split_matches_the_reference_and_jax_grad(case):
    """The same against ``repro.kernels.ref.flash_attention_ref`` and
    ``jax.grad`` of it in float32."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref
    arrays, kw, _, _ = case
    jq, jk, jv = (jnp.asarray(a) for a in arrays[:3])
    cot = jnp.asarray(arrays[3])

    def f(q, k, v):
        return jnp.sum(ref.flash_attention_ref(q, k, v, **kw) * cot)
    want_out = np.asarray(ref.flash_attention_ref(jq, jk, jv, **kw))
    want = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jq, jk, jv)]
    (out, _), grads = _emulated(case, F32_TERMS)
    assert np.abs(out.numpy() - want_out).max() <= TOL
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(grads, want):
        assert np.abs(g.numpy() - w).max() <= TOL * scale


def test_three_terms_reach_float32_rounding(case):
    """Three terms (six term products) land as near the float64
    evaluation as the plain float32 version does: within twice its
    distance."""
    _, _, plain, exact = case
    got = _errors(*_emulated(case, 3), *exact)
    ref = _errors(*plain, *exact)
    assert all(g <= 2 * r for g, r in zip(got, ref)), (got, ref)


@pytest.fixture(scope="module", params=sorted(LARGE))
def large(request):
    """A CASES shape with q and k times LARGE: the plain float32 version's
    and a float64 evaluation's forward and backward, each backward from
    its own forward, as the kernels' runs from theirs."""
    B, Hkv, G, T, hd, kw = CASES[request.param]
    rng = np.random.default_rng(hd + 1)
    arrays = [rng.normal(size=s).astype(np.float32) for s in (
        (B, Hkv, G, T, hd), (B, Hkv, T, hd), (B, Hkv, T, hd),
        (B, Hkv, G, T, hd))]
    arrays[0] *= LARGE[request.param]
    arrays[1] *= LARGE[request.param]
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = flash_attention_fwd_ref(q, k, v, **kw)
    plain = ((o, lse), flash_attention_bwd_ref(q, k, v, o, lse, do, **kw))
    f64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = flash_attention_fwd_ref(*f64[:3], **kw)
    exact = ((o64, lse64), flash_attention_bwd_ref(*f64[:3], o64, lse64,
                                                   f64[3], **kw))
    return (q, k, v, do), kw, plain, exact


def _emulated_chain(large, terms):
    (q, k, v, do), kw, _, _ = large
    o, lse = flash_attention_split_fwd_ref(q, k, v, terms=terms, **kw)
    return (o, lse), flash_attention_split_bwd_ref(q, k, v, o, lse, do,
                                                   terms=terms, **kw)


def test_split_holds_float32_on_large_scores(large):
    """Scores in the hundreds: the kernels' arithmetic (F32_TERMS terms,
    the backward from its own forward) within twice the plain float32
    version's distance from float64 (f64_witness' rule on the card, there
    with the card's 1e-4 tolerance as a floor; none here)."""
    _, _, plain, exact = large
    got = _errors(*_emulated_chain(large, F32_TERMS), *exact)
    ref = _errors(*plain, *exact)
    assert all(g <= 2 * r for g, r in zip(got, ref)), (got, ref)


def test_two_terms_miss_float32_on_large_scores(large):
    """Two terms (2^-16 an operand) part the scores from float32 by
    2^-16 of |q| |k|: on scores in the hundreds out, lse and the
    gradients all lie more than twice plain float32's distance from
    float64."""
    _, _, plain, exact = large
    got = _errors(*_emulated_chain(large, 2), *exact)
    ref = _errors(*plain, *exact)
    assert all(g > 2 * r for g, r in zip(got, ref)), (got, ref)


def test_one_term_misses_the_tolerances(case):
    """bf16 operands, P and dS alone: the split is what buys 1e-4."""
    _, _, plain, _ = case
    out, lse, grads = _errors(*_emulated(case, 1), *plain)
    assert out > TOL and lse > TOL and grads > TOL, (out, lse, grads)


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


@pytest.mark.parametrize("name,shape,fwd,bound,by,f32_bound", [
    # 7f and 7bf: train_f32's first call, q [4, 8, 4, 2048, 64], causal
    ("flash_attention_f32", (4, 8, 4, 2048, 2048, 64), True,
     0.41711, "operations", 1.02616),
    ("flash_attention_bwd_f32", (4, 8, 4, 2048, 2048, 64), False,
     1.04277, "operations", 2.56541),
    # 7mf: row 7m's call in float32, q [1, 128, 1, 513, 192], causal
    ("flash_attention_hd192_f32", (1, 128, 1, 513, 513, 192), True,
     0.07863, "operations", 0.19344)])
def test_chip_smoke_f32_rows_count_the_split(name, shape, fwd, bound, by,
                                             f32_bound):
    """The float32 rows' bound: each float32 product as the split's six
    bf16 products at 989 TFLOP/s against each operand read and each result
    written once (3.35 TB/s), the float32-rate figure (67 TFLOP/s)
    beside it; counted exactly from the call's shapes."""
    cs = _chip_smoke()
    B, Hkv, G, Tq, Tk, hd = shape
    pairs = B * Hkv * G * Tq * (Tq + 1) // 2
    q_n, k_n, rows = B * Hkv * G * Tq * hd, B * Hkv * Tk * hd, B * Hkv * G * Tq
    nbytes = ((2 if fwd else 4) * (q_n + k_n)) * 4 + rows * 4
    ops = (4 if fwd else 10) * hd * pairs
    row = cs.flash_row(name, "x", 1, 0.0, 1.0, 1.0, 1.0, nbytes, ops,
                       "float32", list(shape))
    assert row["bound_ms"] == max(nbytes / 3.35e12, 6 * ops / 989e12) * 1e3
    assert row["bound_by"] == by
    assert row["float32_bound_ms"] == max(nbytes / 3.35e12,
                                          ops / 67e12) * 1e3
    assert row["bound_ms"] == pytest.approx(bound, abs=5e-6)
    assert row["float32_bound_ms"] == pytest.approx(f32_bound, abs=5e-6)
    assert name in cs.F32_FLASH_KERNELS and name in cs.ROWS


def test_chip_smoke_train_f32_rehearsal():
    """train_f32 at the tiny config on the CPU: float32 params through
    train's checks, the recorder's first call, and the train launcher with
    its defaults on the tiny config (no kernel launches here)."""
    cs = _chip_smoke()
    rec = cs.FlashRecorder()
    res = cs.train_f32(rec, tiny=True, device="cpu", seq=64)
    assert res["dtype"] == "float32" and len(res["losses"]) == 6
    assert all(v == 0 for v in res["launches"].values())
    assert res["launcher_launches"] == {}
    q, k, v, kw = rec.args
    assert q.dtype == torch.float32 and q.shape == (4, 2, 4, 64, 32)
    assert rec.dout.shape == q.shape
    assert "train_f32" in cs.PHASES
