"""The port's chunked gated linear attention, held three ways.

* On the CPU, the plain version ``chunked_gla_ref`` against the JAX
  kernel as ``tests/test_kernels.py`` runs it (Pallas,
  ``interpret=True``) and against ``repro.models.ssm.chunked_gla``, over
  that file's grid of shapes and chunks, on the same numpy inputs: atol
  1e-4 in float32 and 5e-2 in bfloat16 (that file's tolerances), with an
  rtol of 1e-5 in float32 beside it, since y reaches ~50 there and the two
  frameworks sum up to 128 x 64 products in other orders. Then the
  tiny xLSTM's mLSTM shape (dk 256, dv 257, chunk 64, k float32 beside
  bfloat16 q and v), lengths that are not chunk multiples and an initial
  state against ``chunked_gla`` (the Pallas kernel takes neither), and
  ``gla_step_ref`` against ``repro.models.ssm.gla_step``.
* The kernel's numerical design, before any card run: a plain-torch
  emulation of its chunk-parallel order (the states entering each chunk
  first, then every chunk's outputs from them) and of its operand split
  (each float32 operand as ``TERMS[y's dtype]`` bf16 terms, a bf16 one as
  it is, the term pairs whose indexes sum below that, float32 sums),
  against the
  JAX kernel in interpret mode and ``chunked_gla`` at the card's
  tolerances: the grid, the tiny mLSTM shape, log_a at mLSTM's clamp over
  whole chunks; and one term, which does not hold them.
* Operands read in place: the mLSTM's (transposed q and k, v padded by
  ``aligned_empty``) and Mamba2's broadcast q and k need no copy; a row
  that is not 16-byte aligned is copied in its own dtype.
* The backward: ``chunked_gla_bwd_ref`` (the plain backward written out)
  against ``jax.vjp`` of the reference's ``chunked_gla`` over the grid, T
  off the chunk, with and without an initial state and a final-state
  gradient, and the tiny mLSTM's and mamba2's calls; at log_a's clamp,
  where the reference's own gradient is NaN, against float64 autograd of
  ``chunked_gla_ref``; the d log_a identity against autograd; and
  ``_emulate_bwd``, the backward kernels' order and operand split in plain
  torch, at the card's tolerances (one term misses them).
* The dispatch: ``ops.gla_scan_op`` is the plain version on the CPU, and
  differentiable there; the launchers refuse a CPU tensor.
* On a CUDA card (``-m gpu``), the kernel against the plain version,
  within 1e-4 (float32) or 2^-7 (a bfloat16 unit in the last place) of
  the largest |y| and |S| (also on the mLSTM's operands read in place,
  with and without log_a at the clamp); the backward kernels against the
  plain backward over the same cases, on the mLSTM's and mamba2's
  operand layouts, and through ``ops.gla_scan_op`` under autograd. These
  skip when no card is present. The card's machine has no JAX, so the
  reference is imported inside the CPU tests only and the card runs this
  file with ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_gla_scan.py``.
"""
import math

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.gla_scan import (TERMS, aligned, aligned_empty,
                                          chunked_gla_bwd_ref,
                                          chunked_gla_ref, gla_scan,
                                          gla_scan_bwd, gla_scan_fwd,
                                          gla_step_ref, in_place)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, H, T, dk, dv, *, k_scale=1.0, state=False):
    """q, k, v normal, log_a = -|normal| * 0.2 (as tests/test_kernels.py),
    and optionally a normal initial state, all float32 numpy."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, H, T, dk)).astype(np.float32),
              (rng.normal(size=(B, H, T, dk)) * k_scale).astype(np.float32),
              rng.normal(size=(B, H, T, dv)).astype(np.float32),
              (-np.abs(rng.normal(size=(B, H, T))) * 0.2).astype(np.float32)]
    if state:
        arrays.append(rng.normal(size=(B, H, dk, dv)).astype(np.float32))
    return arrays


def _jax(arrays, dtypes):
    import jax.numpy as jnp
    return [jnp.asarray(a).astype(getattr(jnp, d))
            for a, d in zip(arrays, dtypes)]


def _torch(arrays, dtypes, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, d))
            for a, d in zip(arrays, dtypes)]


GRID = [(2, 2, 64, 16, 16, 16), (1, 4, 128, 32, 64, 32),
        (2, 1, 256, 64, 64, 128), (1, 2, 96, 16, 16, 32)]


@pytest.mark.parametrize("B,H,T,dk,dv,c", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_chunked_gla(B, H, T, dk, dv, c, dtype):
    from repro.kernels.gla_scan import gla_scan as jax_gla_scan
    from repro.models.ssm import chunked_gla
    arrays = _inputs(B * 100 + T, B, H, T, dk, dv)
    dtypes = [dtype] * 3 + ["float32"]
    jq, jk, jv, jla = _jax(arrays, dtypes)
    y_pallas, s_pallas = jax_gla_scan(jq, jk, jv, jla, chunk=c,
                                      interpret=True)
    y_ref, s_ref = chunked_gla(jq, jk, jv, jla, c)
    y, s = chunked_gla_ref(*_torch(arrays, dtypes), c)
    assert y.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    rtol = 1e-5 if dtype == "float32" else 0
    for want_y, want_s in ((y_pallas, s_pallas), (y_ref, s_ref)):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want_y, np.float32), atol=tol,
                                   rtol=rtol)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=tol,
                                   rtol=rtol)


def test_plain_tiny_mlstm_shape():
    """The tiny xLSTM's mLSTM call: dk 256, dv 257 (hd + the normalizer's
    ones channel), chunk 64, q and v bfloat16 and k float32 (k times the
    float32 input gate promotes). y comes back bfloat16: both round the
    float32 result once, so within one bf16 unit in the last place (2^-7)
    of the largest |y|; the float32 state within 1e-4 of the largest |S|
    (float32 sums of 256 products in another order)."""
    from repro.models.ssm import chunked_gla
    arrays = _inputs(7, 2, 2, 130, 256, 257, k_scale=1 / 16)
    arrays[2][..., -1] = 1.0
    dtypes = ["bfloat16", "float32", "bfloat16", "float32"]
    y_ref, s_ref = chunked_gla(*_jax(arrays, dtypes), 64)
    y, s = chunked_gla_ref(*_torch(arrays, dtypes), 64)
    assert y.dtype == torch.bfloat16
    y_ref = np.asarray(y_ref, np.float32)
    s_ref = np.asarray(s_ref)
    np.testing.assert_allclose(y.float().numpy(), y_ref,
                               atol=2.0 ** -7 * np.abs(y_ref).max())
    np.testing.assert_allclose(s.numpy(), s_ref,
                               atol=1e-4 * np.abs(s_ref).max())


@pytest.mark.parametrize("T,c", [(100, 32), (5, 16), (61, 64), (257, 256)])
@pytest.mark.parametrize("state", [False, True])
def test_plain_any_length_and_initial_state(T, c, state):
    """T not a multiple of the chunk (padded with no-op steps), T below
    it (one short chunk), and a carried initial state, against
    ``chunked_gla`` in float32 (atol 1e-4, rtol 1e-5 as above)."""
    from repro.models.ssm import chunked_gla
    arrays = _inputs(T + c, 2, 2, T, 16, 24, state=state)
    dtypes = ["float32"] * len(arrays)
    jargs = _jax(arrays, dtypes)
    targs = _torch(arrays, dtypes)
    y_ref, s_ref = chunked_gla(*jargs[:4], c,
                               jargs[4] if state else None)
    y, s = chunked_gla_ref(*targs[:4], c, targs[4] if state else None)
    assert y.shape == (2, 2, T, 24)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4,
                               rtol=1e-5)


def test_plain_strong_decay_stays_finite():
    """mLSTM's clamp at -30 a step drives lb to ~ -7680 over a chunk of
    256: the plain version forms exp(lb_i - lb_j) only below the diagonal
    and stays finite, as the reference does, and so does its gradient.
    There a float32 unit in the last place of lb is ~5e-4, so every decay
    factor carries ~1e-3 relative rounding in either framework (both are
    6.8e-3 from the float64 recurrence on these inputs, where |y| reaches
    33.5): y is held within 1e-3 of the largest |y|, the state within
    1e-4."""
    from repro.models.ssm import chunked_gla
    arrays = _inputs(3, 1, 2, 300, 16, 8)
    arrays[3][:] = -30.0
    arrays[3][:, :, ::7] = -0.01
    y_ref, s_ref = chunked_gla(*_jax(arrays, ["float32"] * 4), 256)
    q, k, v, la = (t.requires_grad_(True)
                   for t in _torch(arrays, ["float32"] * 4))
    y, s = chunked_gla_ref(q, k, v, la, 256)
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(y.detach().numpy(), y_ref,
                               atol=1e-3 * np.abs(y_ref).max())
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref),
                               atol=1e-4)
    (y.sum() + s.sum()).backward()
    for t in (q, k, v, la):
        assert torch.isfinite(t.grad).all()


def test_gla_step_ref_matches_jax():
    from repro.models.ssm import gla_step
    rng = np.random.default_rng(5)
    S = rng.normal(size=(2, 3, 8, 9)).astype(np.float32)
    q, k = (rng.normal(size=(2, 3, 8)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(2, 3, 9)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(2, 3)))).astype(np.float32)
    arrays = [S, q, k, v, la]
    for dtypes in (["float32"] * 5,
                   ["float32", "bfloat16", "float32", "bfloat16",
                    "float32"]):
        y_ref, s_ref = gla_step(*_jax(arrays, dtypes))
        y, s = gla_step_ref(*_torch(arrays, dtypes))
        assert y.dtype == getattr(torch, dtypes[3])
        tol = 1e-5 if dtypes[1] == "float32" else 5e-2
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(y_ref, np.float32), atol=tol)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5)


def test_plain_chunked_equals_steps():
    """The port's own invariant, as tests/test_ssm.py holds the
    reference's: the chunked form equals the step recurrence."""
    q, k, v, la = _torch(_inputs(11, 2, 2, 24, 16, 16), ["float32"] * 4)
    for chunk in (4, 8, 64):
        y_par, s_par = chunked_gla_ref(q, k, v, la, chunk)
        S = torch.zeros((2, 2, 16, 16))
        ys = []
        for t in range(24):
            y, S = gla_step_ref(S, q[:, :, t], k[:, :, t], v[:, :, t],
                                la[:, :, t])
            ys.append(y)
        torch.testing.assert_close(y_par, torch.stack(ys, dim=2), atol=1e-4,
                                   rtol=0)
        torch.testing.assert_close(s_par, S, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the kernel's numerical design, emulated on the CPU
# ---------------------------------------------------------------------------
def _split(x, terms):
    """x (float32) as ``terms`` bf16 values, largest first, that sum to it
    (to ~2^-17 for two)."""
    out, rest = [], x.float()
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _tc(eq, a, b, terms):
    """``einsum(eq, a, b)`` as the kernel's tensor cores take it: a
    float32 operand split into ``terms`` bf16 terms, a bf16 one exact as
    it is; the products of the term pairs whose indexes sum below
    ``terms`` (each exact in float32), summed in float32."""
    A = _split(a, terms) if a.dtype == torch.float32 else [a.float()]
    B = _split(b, terms) if b.dtype == torch.float32 else [b.float()]
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(A)
               for j, y in enumerate(B) if i + j < terms)


def _emulate(q, k, v, log_a, chunk, initial_state=None, terms=None):
    """The kernel's order and products in plain torch (``terms`` bf16
    terms of a float32 operand, by default the kernel's for v's dtype):
    lb per chunk; the
    states entering every chunk, S <- exp(lb_last) S + (k exp(lb_last -
    lb))^T v; then each chunk's outputs from its entering state, the
    scores P = (q k^T) exp(lb_i - lb_j) masked after the product, y =
    P v + exp(lb_i) q S_n (no q S term while S is the zero state). P, S
    and the decayed k are float32 operands, so split."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    terms = terms or TERMS[v.dtype]
    c = min(chunk, T)
    n = -(-T // c)
    pad = n * c - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_a = F.pad(log_a, (0, pad))
    qc, kc, vc = (t.reshape(B, H, n, c, -1) for t in (q, k, v))
    lb = torch.cumsum(log_a.float().reshape(B, H, n, c), dim=-1)
    S = torch.zeros((B, H, dk, dv)) if initial_state is None \
        else initial_state.float()
    states = []
    for i in range(n):
        states.append(S)
        last = lb[:, :, i, -1:]
        dec = torch.exp(last - lb[:, :, i])
        U = _tc("bhjd,bhjv->bhdv", kc[:, :, i].float() * dec[..., None],
                vc[:, :, i], terms)
        S = torch.exp(last)[..., None] * S + U
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool))
    ys = []
    for i in range(n):
        li = lb[:, :, i]
        D = torch.exp(torch.where(causal, li[..., :, None] - li[..., None, :],
                                  -torch.inf))
        P = _tc("bhid,bhjd->bhij", qc[:, :, i], kc[:, :, i], terms) * D
        y = _tc("bhij,bhjv->bhiv", P, vc[:, :, i], terms)
        if i > 0 or initial_state is not None:
            y = y + torch.exp(li)[..., None] * _tc(
                "bhid,bhdv->bhiv", qc[:, :, i], states[i], terms)
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :T].to(v.dtype), S


def _card_tol(y, want_y, s, want_s):
    """The card's tolerances, relative to the largest |y| and |S|: 1e-4 in
    float32, 2^-7 for a bf16 y (each side rounds a float32 result once);
    the state 1e-4."""
    want_y = np.asarray(want_y, np.float32)
    want_s = np.asarray(want_s, np.float32)
    rel = 1e-4 if y.dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=0,
                               atol=rel * np.abs(want_y).max())
    np.testing.assert_allclose(s.numpy(), want_s, rtol=0,
                               atol=1e-4 * np.abs(want_s).max())


def _strong_decay(la, c):
    """log_a at mLSTM's clamp, -30, over every other chunk of c steps."""
    T = la.shape[-1]
    for t0 in range(0, T, 2 * c):
        la[..., t0:t0 + c] = -30.0
    return la


@pytest.mark.parametrize("B,H,T,dk,dv,c", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_matches_pallas_and_chunked_gla(B, H, T, dk, dv, c,
                                                        dtype):
    from repro.kernels.gla_scan import gla_scan as jax_gla_scan
    from repro.models.ssm import chunked_gla
    arrays = _inputs(B * 100 + T, B, H, T, dk, dv, k_scale=1 / math.sqrt(dk))
    dtypes = [dtype] * 3 + ["float32"]
    jargs = _jax(arrays, dtypes)
    y, s = _emulate(*_torch(arrays, dtypes), c)
    assert y.dtype == getattr(torch, dtype)
    for want in (jax_gla_scan(*jargs, chunk=c, interpret=True),
                 chunked_gla(*jargs, c)):
        _card_tol(y, want[0], s, want[1])


@pytest.mark.parametrize("state", [False, True])
def test_split_emulation_tiny_mlstm_shape(state):
    """dk 256, dv 257 (the ones column last), chunk 64, T off the chunk; q
    and v bf16, k float32 (split), and an initial state."""
    from repro.models.ssm import chunked_gla
    arrays = _inputs(8, 2, 2, 130, 256, 257, k_scale=1 / 16, state=state)
    arrays[2][..., -1] = 1.0
    dtypes = ["bfloat16", "float32", "bfloat16"] + ["float32"] * (
        len(arrays) - 3)
    jargs = _jax(arrays, dtypes)
    targs = _torch(arrays, dtypes)
    y, s = _emulate(*targs[:4], 64, targs[4] if state else None)
    want = chunked_gla(*jargs[:4], 64, jargs[4] if state else None)
    _card_tol(y, want[0], s, want[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_strong_decay(dtype):
    """log_a at mLSTM's clamp over whole chunks (lb to ~ -7680) beside
    ordinary chunks: nothing overflows, and the card's tolerances hold
    (off the diagonal, each decay of a clamped chunk is below exp(-30))."""
    from repro.models.ssm import chunked_gla
    arrays = _inputs(13, 1, 2, 600, 64, 40, k_scale=1 / 8)
    _strong_decay(arrays[3], 128)
    dtypes = [dtype] * 3 + ["float32"]
    y, s = _emulate(*_torch(arrays, dtypes), 128)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    want_y, want_s = chunked_gla(*_jax(arrays, dtypes), 128)
    _card_tol(y, want_y, s, want_s)


def test_one_term_does_not_hold_the_tolerances():
    """The fewest terms: one bf16 term per float32 operand is ~3e-3 off
    the float32 result, outside 1e-4; two hold it (~1e-5: the kernel's
    for a bf16 y); three come within 1e-6 (~2e-7: the kernel's for a
    float32 y, whose model, the float32 xlstm-350m held within 1e-3 over
    24 layers on the card, drifts past that with two)."""
    arrays = _inputs(21, 1, 4, 128, 32, 64, k_scale=1 / math.sqrt(32))
    args = _torch(arrays, ["float32"] * 4)
    want_y, want_s = chunked_gla_ref(*args, 32)
    assert TERMS == {torch.bfloat16: 2, torch.float32: 3}
    for terms, tol, holds in ((1, 1e-4, False), (2, 1e-4, True),
                              (3, 1e-6, True)):
        y, s = _emulate(*args, 32, terms=terms)
        err = max(float((y - want_y).abs().max() / want_y.abs().max()),
                  float((s - want_s).abs().max() / want_s.abs().max()))
        assert (err <= tol) == holds, (terms, err)


# ---------------------------------------------------------------------------
# the backward: the plain version against the reference's gradient, and the
# kernels' numerical design emulated on the CPU
# ---------------------------------------------------------------------------
def _bwd_inputs(seed, B, H, T, dk, dv, *, state, dstate, k_scale=1.0):
    """_inputs' q, k, v, log_a and initial state (or None), then dy and
    the final state's gradient (or None), all float32 numpy."""
    arrays = _inputs(seed, B, H, T, dk, dv, k_scale=k_scale, state=state)
    if not state:
        arrays.append(None)
    rng = np.random.default_rng(seed + 1)
    arrays.append(rng.normal(size=(B, H, T, dv)).astype(np.float32))
    arrays.append(rng.normal(size=(B, H, dk, dv)).astype(np.float32)
                  if dstate else None)
    return arrays


def _jax_vjp(arrays, c, dtypes):
    """jax.vjp of the reference's chunked_gla on (q, k, v, log_a[, initial
    state]) in ``dtypes`` (q's, k's, v's), at (dy in v's dtype, the final
    state's gradient, zero where None); float32 numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import chunked_gla
    q, k, v, la, s0, dy, ds = arrays
    args = [jnp.asarray(a).astype(getattr(jnp, d))
            for a, d in zip((q, k, v, la), (*dtypes, "float32"))]
    if s0 is None:
        (_, s), vjp = jax.vjp(lambda *a: chunked_gla(*a, c), *args)
    else:
        (_, s), vjp = jax.vjp(lambda *a: chunked_gla(*a[:4], c, a[4]),
                              *args, jnp.asarray(s0))
    ct = (jnp.asarray(dy).astype(getattr(jnp, dtypes[2])),
          jnp.zeros_like(s) if ds is None else jnp.asarray(ds))
    return [np.asarray(g, np.float32) for g in vjp(ct)]


def _torch_bwd_args(arrays, dtypes):
    """(q, k, v, log_a, initial state, dy, dstate) as torch tensors, q, k,
    v and dy in ``dtypes`` (dy in v's)."""
    q, k, v, la, s0, dy, ds = arrays
    t = lambda a, d="float32": None if a is None else \
        torch.from_numpy(a).to(getattr(torch, d))      # noqa: E731
    return (t(q, dtypes[0]), t(k, dtypes[1]), t(v, dtypes[2]), t(la), t(s0),
            t(dy, dtypes[2]), t(ds))


def _rel(got, want):
    """The largest error over the reference's largest magnitude."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("B,H,T,dk,dv,c", GRID + [(2, 2, 100, 16, 24, 32)])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dstate", [False, True])
def test_plain_bwd_matches_jax_vjp(B, H, T, dk, dv, c, state, dstate):
    """chunked_gla_bwd_ref against jax.vjp of the reference's chunked_gla
    on the same numpy inputs, float32, the grid and T off the chunk, with
    and without an initial state and a final-state gradient: every
    gradient within 1e-5 of its largest magnitude (float32 sums of up to
    256 products in another order; measured ~1e-6)."""
    arrays = _bwd_inputs(B * 100 + T, B, H, T, dk, dv, state=state,
                         dstate=dstate, k_scale=1 / math.sqrt(dk))
    want = _jax_vjp(arrays, c, ["float32"] * 3)
    q, k, v, la, s0, dy, ds = _torch_bwd_args(arrays, ["float32"] * 3)
    got = chunked_gla_bwd_ref(q, k, v, la, c, s0, dy, ds)
    assert (got[4] is not None) == state
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("kind", ["mlstm", "mamba2"])
def test_plain_bwd_tiny_ssm_shapes_match_jax_vjp(kind):
    """The tiny models' calls: the mLSTM's (dk 256, dv 257, chunk 64, q and
    v bf16 beside a float32 k, T off the chunk, an initial state and a
    final-state gradient) and mamba2's (q and k bf16 broadcast over 4
    heads, dk 16, v float32 of 64, chunk 256 over T 40). The reference's
    gradients come back in their operands' dtypes, its bf16 ones rounded
    once from float32: the plain backward, rounded alike, within one bf16
    unit in the last place (2^-7) of each bf16 gradient's largest
    magnitude and 1e-5 of each float32 one."""
    if kind == "mlstm":
        arrays = _bwd_inputs(8, 2, 2, 130, 256, 257, state=True, dstate=True,
                             k_scale=1 / 16)
        arrays[2][..., -1] = 1.0
        dtypes, c = ["bfloat16", "float32", "bfloat16"], 64
    else:
        arrays = _bwd_inputs(9, 2, 1, 40, 16, 64, state=False, dstate=True,
                             k_scale=1 / 4)
        arrays[:2] = [np.broadcast_to(a, (2, 4, 40, 16)).copy()
                      for a in arrays[:2]]
        rng = np.random.default_rng(10)
        arrays[2:4] = [rng.normal(size=(2, 4, 40, 64)).astype(np.float32),
                       (-np.abs(rng.normal(size=(2, 4, 40)))).astype(
                           np.float32)]
        arrays[5] = rng.normal(size=(2, 4, 40, 64)).astype(np.float32)
        arrays[6] = rng.normal(size=(2, 4, 16, 64)).astype(np.float32)
        dtypes, c = ["bfloat16", "bfloat16", "float32"], 256
    want = _jax_vjp(arrays, c, dtypes)
    args = _torch_bwd_args(arrays, dtypes)
    got = chunked_gla_bwd_ref(*args[:4], c, *args[4:])
    for g, w, d in zip(got, want, dtypes + ["float32"] * 2):
        rel = 2.0 ** -7 if d == "bfloat16" else 1e-5
        assert _rel(g.to(getattr(torch, d)), w) <= rel


def test_plain_bwd_strong_decay_against_float64_autograd():
    """log_a at mLSTM's clamp (-30) over whole chunks: the reference's own
    gradient is NaN there (it forms exp(lb_i - lb_j) above the diagonal
    too, where it overflows, and masks after: 0 x inf; ROADMAP queue 3),
    so the plain backward is held against float64 autograd of
    chunked_gla_ref instead: within 1e-5 of each gradient's largest
    magnitude, and finite."""
    arrays = _bwd_inputs(13, 1, 2, 600, 64, 40, state=True, dstate=True,
                         k_scale=1 / 8)
    _strong_decay(arrays[3], 128)
    want = _jax_vjp(arrays, 128, ["float32"] * 3)
    assert not all(np.isfinite(w).all() for w in want)
    q, k, v, la, s0, dy, ds = _torch_bwd_args(arrays, ["float32"] * 3)
    got = chunked_gla_bwd_ref(q, k, v, la, 128, s0, dy, ds)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v, la, s0)]
    y, s = chunked_gla_ref(*leaves[:4], 128, leaves[4])
    want64 = torch.autograd.grad((y * dy.double()).sum()
                                 + (s * ds.double()).sum(), leaves)
    for g, w in zip(got, want64):
        assert torch.isfinite(g).all()
        assert _rel(g, w.numpy()) <= 1e-5


def test_plain_bwd_log_decay_identity_against_autograd():
    """The d log_a identity in float64: the reverse cumulative sum of
    q . dq - k . dk, plus <dstate, S_T> at the last step, equals autograd
    of chunked_gla_ref to 1e-10 of its largest magnitude (B 2, H 3, T 70,
    off the chunk of 16, with an initial state and a final-state
    gradient); and so do the other gradients."""
    arrays = _bwd_inputs(5, 2, 3, 70, 8, 6, state=True, dstate=True)
    args = [None if a is None else torch.from_numpy(a).double()
            for a in arrays]
    q, k, v, la, s0, dy, ds = args
    got = chunked_gla_bwd_ref(q, k, v, la, 16, s0, dy, ds)
    assert all(g.dtype == torch.float64 for g in got)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, la, s0)]
    y, s = chunked_gla_ref(*leaves[:4], 16, leaves[4])
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-10


def _emulate_bwd(q, k, v, log_a, chunk, initial_state, dy, dstate,
                 terms=None):
    """The backward kernels' order and products in plain torch, as
    ``_emulate`` is the forward's: lb per chunk; the chunk-entry states as
    the forward forms them; dS right to left from the final state's
    gradient, dS <- exp(lb_last) dS + (q exp(lb))^T dy, keeping the dS
    that leaves each chunk; then per chunk P = (q k^T) D and dA = (dy v^T)
    D, masked after the product, and dq = dA k + exp(lb_i) dy S_n^T (no
    state term while S_n is the zero state), dk = dA^T q + exp(lb_last -
    lb_j) v dS^T, dv = P^T dy + exp(lb_last - lb_j) k dS (no dS term while
    dS is zero). P, dA, S_n, dS and the decayed q and k are float32
    operands, so split (``_tc``); dq, dk and dv are rounded to their
    operands' dtypes, and d log_a is the reverse cumulative sum of q . dq
    - k . dk from the float32 products (plus <dstate, S_T> at the last
    step)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    terms = terms or TERMS[v.dtype]
    c = min(chunk, T)
    n = -(-T // c)
    pad = n * c - T
    q0, k0, v0 = q, k, v
    if pad:
        q, k, v, dy = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, dy))
        log_a = F.pad(log_a, (0, pad))
    qc, kc, vc, yc = (t.reshape(B, H, n, c, -1) for t in (q, k, v, dy))
    lb = torch.cumsum(log_a.float().reshape(B, H, n, c), dim=-1)
    S = torch.zeros((B, H, dk, dv)) if initial_state is None \
        else initial_state.float()
    states = []
    for i in range(n):
        states.append(S)
        last = lb[:, :, i, -1:]
        S = torch.exp(last)[..., None] * S + _tc(
            "bhjd,bhjv->bhdv",
            kc[:, :, i].float() * torch.exp(last - lb[:, :, i])[..., None],
            vc[:, :, i], terms)
    dS = torch.zeros((B, H, dk, dv)) if dstate is None else dstate.float()
    leaving = [None] * n
    for i in reversed(range(n)):
        leaving[i] = dS
        li = lb[:, :, i]
        dS = torch.exp(li[..., -1])[..., None, None] * dS + _tc(
            "bhid,bhiv->bhdv", qc[:, :, i].float() * torch.exp(li)[..., None],
            yc[:, :, i], terms)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool))
    grads = ([], [], [])
    for i in range(n):
        li = lb[:, :, i]
        D = torch.exp(torch.where(causal, li[..., :, None] - li[..., None, :],
                                  -torch.inf))
        P = _tc("bhid,bhjd->bhij", qc[:, :, i], kc[:, :, i], terms) * D
        dA = _tc("bhiv,bhjv->bhij", yc[:, :, i], vc[:, :, i], terms) * D
        dec = torch.exp(li[..., -1:] - li)[..., None]
        gq = _tc("bhij,bhjd->bhid", dA, kc[:, :, i], terms)
        gk = _tc("bhij,bhid->bhjd", dA, qc[:, :, i], terms)
        gv = _tc("bhij,bhiv->bhjv", P, yc[:, :, i], terms)
        if i > 0 or initial_state is not None:
            gq = gq + torch.exp(li)[..., None] * _tc(
                "bhiv,bhdv->bhid", yc[:, :, i], states[i], terms)
        if i < n - 1 or dstate is not None:
            gk = gk + dec * _tc("bhjv,bhdv->bhjd", vc[:, :, i], leaving[i],
                                terms)
            gv = gv + dec * _tc("bhjd,bhdv->bhjv", kc[:, :, i], leaving[i],
                                terms)
        for out, g in zip(grads, (gq, gk, gv)):
            out.append(g)
    gq, gk, gv = (torch.cat(g, dim=2)[:, :, :T] for g in grads)
    delta = (q0.float() * gq).sum(-1) - (k0.float() * gk).sum(-1)
    if dstate is not None:
        delta[..., -1] += (dstate.float() * S).sum((-2, -1))
    dla = torch.flip(torch.cumsum(torch.flip(delta, (-1,)), -1), (-1,))
    return (gq.to(q0.dtype), gk.to(k0.dtype), gv.to(v0.dtype), dla,
            None if initial_state is None else dS)


def _bwd_card_tol(got, want, dtypes):
    """The backward's card tolerances, relative to each gradient's largest
    magnitude: 1e-4 for a float32 gradient (float32 sums in another
    order; the emulation measures ~1e-6 with three terms), one bf16 unit
    in the last place (2^-7) for a bf16 one (each side rounds a float32
    result once), and 1e-4 for d log_a and the initial state's gradient,
    float32 always (the emulation: ~1e-5 with two terms, ~1e-6 with
    three)."""
    for g, w, d in zip(got, want, list(dtypes) + ["float32"] * 2):
        if g is None:
            assert w is None
            continue
        rel = 2.0 ** -7 if d == "bfloat16" else 1e-4
        assert _rel(g, w) <= rel


@pytest.mark.parametrize("B,H,T,dk,dv,c", GRID + [(2, 2, 100, 16, 24, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
def test_split_emulation_bwd_matches_jax_vjp(B, H, T, dk, dv, c, dtype,
                                             state):
    """The backward's order and operand split against jax.vjp of the
    reference's chunked_gla (whose bf16 gradients are rounded once from
    float32), at the card's tolerances: the grid and T off the chunk,
    float32 and bf16 operands, an initial state and a final-state
    gradient or neither."""
    arrays = _bwd_inputs(B * 100 + T, B, H, T, dk, dv, state=state,
                         dstate=state, k_scale=1 / math.sqrt(dk))
    dtypes = [dtype] * 3
    want = _jax_vjp(arrays, c, dtypes)
    args = _torch_bwd_args(arrays, dtypes)
    got = _emulate_bwd(*args[:4], c, *args[4:])
    _bwd_card_tol(got, want + [None] * (5 - len(want)), dtypes)


@pytest.mark.parametrize("state", [False, True])
def test_split_emulation_bwd_tiny_mlstm_shape(state):
    """The tiny mLSTM's call (dk 256, dv 257 with the ones column, chunk
    64, T off the chunk; q and v bf16, k float32, two terms) against the
    plain backward at the card's tolerances."""
    arrays = _bwd_inputs(8, 2, 2, 130, 256, 257, state=state, dstate=state,
                         k_scale=1 / 16)
    arrays[2][..., -1] = 1.0
    dtypes = ["bfloat16", "float32", "bfloat16"]
    args = _torch_bwd_args(arrays, dtypes)
    got = _emulate_bwd(*args[:4], 64, *args[4:])
    want = chunked_gla_bwd_ref(*args[:4], 64, *args[4:])
    want = [None if w is None else w.to(g.dtype).float().numpy()
            for g, w in zip(got, want)]
    _bwd_card_tol(got, want, dtypes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_bwd_strong_decay(dtype):
    """log_a at mLSTM's clamp over whole chunks beside ordinary chunks:
    every gradient finite, and within the card's tolerances of the plain
    backward (the reference's own gradient is NaN there)."""
    arrays = _bwd_inputs(13, 1, 2, 600, 64, 40, state=True, dstate=True,
                         k_scale=1 / 8)
    _strong_decay(arrays[3], 128)
    dtypes = [dtype] * 3
    args = _torch_bwd_args(arrays, dtypes)
    got = _emulate_bwd(*args[:4], 128, *args[4:])
    assert all(torch.isfinite(g.float()).all() for g in got)
    want = chunked_gla_bwd_ref(*args[:4], 128, *args[4:])
    _bwd_card_tol(got, [w.to(g.dtype).float().numpy()
                        for g, w in zip(got, want)], dtypes)


def test_one_term_does_not_hold_the_bwd_tolerances():
    """As for the forward: one bf16 term of each float32 operand misses
    1e-4 of the float32 gradients; the kernel's three hold it."""
    arrays = _bwd_inputs(21, 1, 4, 128, 32, 64, state=True, dstate=True,
                         k_scale=1 / math.sqrt(32))
    args = _torch_bwd_args(arrays, ["float32"] * 3)
    want = chunked_gla_bwd_ref(*args[:4], 32, *args[4:])
    for terms, holds in ((1, False), (3, True)):
        got = _emulate_bwd(*args[:4], 32, *args[4:], terms=terms)
        err = max(_rel(g, w.numpy()) for g, w in zip(got, want))
        assert (err <= 1e-4) == holds, (terms, err)


# ---------------------------------------------------------------------------
# operands read in place
# ---------------------------------------------------------------------------
def test_mlstm_and_mamba2_operands_are_read_in_place():
    """The layouts the model hands the kernel need no copy: mLSTM's q and
    k, (B, H, T, hd) views of (B, T, H, hd) tensors (k float32), its v
    padded by ``aligned_empty``; Mamba2's q and k broadcast over the heads
    (stride 0) and its transposed v."""
    B, T, H, hd = 2, 5, 3, 512
    q = torch.zeros((B, T, H, hd), dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros((B, T, H, hd)).transpose(1, 2)
    v = aligned_empty((B, H, T, hd + 1), torch.bfloat16, "cpu")
    assert v.shape == (B, H, T, hd + 1) and v.stride(2) == hd + 8
    shared = torch.zeros((B, T, 64), dtype=torch.bfloat16)[:, None]
    mv = torch.zeros((B, T, H, 64)).transpose(1, 2)
    for t in (q, k, v, shared.expand(B, H, T, 64), mv):
        assert aligned(t) and in_place(t) is t


def test_unaligned_operands_are_copied_in_their_own_dtype():
    """A contiguous bf16 row of 513 is 2-byte aligned: copied into a
    padded buffer, still bf16 (never widened to float32); a dtype the
    kernel does not take is cast to float32; a last dimension that is
    not unit-stride is copied."""
    v = torch.randn(2, 3, 4, 513).to(torch.bfloat16)
    assert not aligned(v)
    got = in_place(v)
    assert got.dtype == torch.bfloat16 and aligned(got)
    assert torch.equal(got, v)
    h = torch.randn(2, 3, 4, 8).to(torch.float16)
    assert not aligned(h) and in_place(h).dtype == torch.float32
    t = torch.randn(2, 3, 8, 4).transpose(2, 3)
    assert not aligned(t) and torch.equal(in_place(t), t)


def test_mlstm_forward_hands_the_kernel_aligned_operands(monkeypatch):
    """``mlstm_forward`` builds v = [v, 1] in an ``aligned_empty`` buffer,
    so on the card the kernel reads all three operands in place; the
    values are those of the concatenation."""
    from repro_torch.configs.base import SSMCfg
    from repro_torch.models import ssm
    s = SSMCfg(kind="mlstm", n_heads=2, expand=2, chunk_size=8)
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_mlstm(gen, 64, s, dtype=torch.float32, device="cpu")
    x = torch.randn((2, 11, 64), generator=gen)
    seen = []

    def spy(q, k, v, log_a, **kw):
        seen.append((q, k, v))
        return chunked_gla_ref(q, k, v, log_a, kw["chunk"],
                               kw.get("initial_state"))
    monkeypatch.setattr(ops, "gla_scan_op", spy)
    ssm.mlstm_forward(p, s, 64, x)
    (q, k, v), = seen
    assert all(aligned(t) for t in (q, k, v))
    assert v.shape[-1] == 64 + 1 and bool((v[..., -1] == 1).all())


def test_chip_smoke_gla_bound_counts_the_split_products():
    """chip_smoke's row-8 bound: each product's bf16 tensor-core products
    are its operands' term pairs whose indexes sum below the kernel's term
    count: two at the mLSTM call (bf16 q and v, float32 k; P, S and the
    decayed k in two terms), so twice the float32 work; six for every
    product when all three are float32 (three terms each)."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke as cs
    finally:
        sys.path.pop(0)
    assert [cs.split_products(a, b, 2) for a, b in
            ((1, 1), (1, 2), (2, 1), (2, 2))] == [1, 2, 2, 3]
    assert [cs.split_products(a, b, 3) for a, b in
            ((1, 3), (3, 1), (3, 3))] == [3, 3, 6]
    shape = (8, 4, 2000, 512)
    f32 = cs.gla_ops(shape, 513, 256, False)
    assert cs.gla_tc_ops(shape, 513, 256, False,
                         (torch.bfloat16, torch.float32,
                          torch.bfloat16)) == 2 * f32
    assert cs.gla_tc_ops(shape, 513, 256, True, (torch.float32,) * 3) == \
        6 * cs.gla_ops(shape, 513, 256, True)


def test_chip_smoke_gla_bwd_bound_counts_the_split_products():
    """chip_smoke's row-8b bound: per chunk, two state products (the
    chunk-entry states again and the dS sweep), P and dA, dq's, dk's and
    dv's products over the pairs, and the three state terms (dq's none on
    the first chunk from the zero state, dk's and dv's none on the last
    without a final-state gradient), each times its operands' term pairs:
    six for every product when all three operands are float32; at the
    mLSTM call (bf16 q and v, float32 k, two terms) 2 and 2 for the state
    products, 2, 3 and 2 for the dk-wide pair products (P, dA k, dA^T q),
    1 and 2 for the dv-wide ones (dA, P^T dy), 2, 2 and 3 for the state
    terms (dy S^T, v dS^T, k dS)."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke as cs
    finally:
        sys.path.pop(0)

    def count(shape, dv, c, state, dstate, w):
        B, H, T, dk = shape
        ops = 0
        for t0 in range(0, T, c):
            r = min(c, T - t0)
            pairs = r * (r + 1) // 2
            first = t0 == 0 and not state
            last = t0 + c >= T and not dstate
            ops += 2 * B * H * (
                r * dk * dv * w["states"] + pairs * dk * w["pairs_dk"]
                + pairs * dv * w["pairs_dv"]
                + (0 if first else r * dk * dv * w["dq"])
                + (0 if last else r * dk * dv * w["dkdv"]))
        return ops
    f32 = dict(states=12, pairs_dk=18, pairs_dv=12, dq=6, dkdv=12)
    mlstm = dict(states=4, pairs_dk=7, pairs_dv=3, dq=2, dkdv=5)
    for shape, dv, c in (((4, 4, 1024, 512), 513, 256),
                         ((2, 3, 333, 64), 40, 128)):
        for state, dstate in ((False, False), (True, True), (False, True)):
            assert cs.gla_bwd_tc_ops(shape, dv, c, state, dstate,
                                     (torch.float32,) * 3) == count(
                shape, dv, c, state, dstate, f32)
            assert cs.gla_bwd_tc_ops(
                shape, dv, c, state, dstate,
                (torch.bfloat16, torch.float32, torch.bfloat16)) == count(
                shape, dv, c, state, dstate, mlstm)


def test_launcher_refuses_cpu_tensors():
    q, k, v, la = _torch(_inputs(1, 1, 1, 8, 4, 4), ["float32"] * 4)
    with pytest.raises(ValueError, match="CUDA"):
        gla_scan_fwd(q, k, v, la, chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        gla_scan_bwd(q, k, v, la, torch.zeros_like(v), chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        gla_scan(q, k, v, la, chunk=4)


def test_bwd_refuses_dtype_combinations_no_model_hands_it():
    """The backward is built for the models' operand dtypes (all float32,
    all bf16, the mLSTM's and mamba2's) and refuses the forward's other
    four, before anything else."""
    q, k, v, la = _torch(_inputs(1, 1, 1, 8, 4, 4), ["float32"] * 4)
    bf = torch.bfloat16
    for a, b, c in ((q, k.to(bf), v), (q.to(bf), k, v), (q, k, v.to(bf)),
                    (q, k.to(bf), v.to(bf))):
        with pytest.raises(TypeError, match="gla_scan_bwd takes"):
            gla_scan_bwd(a, b, c, la, torch.zeros_like(c), chunk=4)


def test_op_on_cpu_is_the_plain_version_and_differentiable():
    arrays = _inputs(2, 1, 2, 40, 8, 6, state=True)
    q, k, v, la, s0 = _torch(arrays, ["float32"] * 5)
    got = ops.gla_scan_op(q, k, v, la, chunk=16, initial_state=s0)
    want = chunked_gla_ref(q, k, v, la, 16, s0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    q.requires_grad_(True)
    y, _ = ops.gla_scan_op(q, k, v, la, chunk=16)
    y.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


GPU_CASES = [
    # the reference grid, then the tiny and full-width mLSTM shapes (k
    # float32 beside bf16 q and v), T off the chunk, a short T
    ("grid", 2, 2, 64, 16, 16, 16, None),
    ("grid", 1, 4, 128, 32, 64, 32, None),
    ("grid", 2, 1, 256, 64, 64, 128, None),
    ("grid", 1, 2, 96, 16, 16, 32, None),
    ("tiny mLSTM", 2, 2, 130, 256, 257, 64, "mixed"),
    ("mLSTM", 1, 4, 600, 512, 513, 256, "mixed"),
    ("T off chunk", 2, 2, 100, 16, 24, 32, None),
    ("short T", 1, 3, 5, 8, 40, 64, None),
    ("dk 8 chunk 5", 2, 3, 37, 8, 12, 5, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("label,B,H,T,dk,dv,c,mix", GPU_CASES,
                         ids=[f"{c[0]}-T{c[3]}-dk{c[4]}" for c in GPU_CASES])
def test_gpu_kernel_matches_plain(cuda, dtype, state, label, B, H, T, dk,
                                  dv, c, mix):
    arrays = _inputs(T + dk, B, H, T, dk, dv, k_scale=1 / math.sqrt(dk),
                     state=state)
    dtypes = [dtype] * 3 + ["float32"] * (len(arrays) - 3)
    if mix:
        dtypes[1] = "float32"
    args = _torch(arrays, dtypes, cuda)
    s0 = args[4] if state else None
    before = gla_scan_fwd.launches
    y, s = gla_scan_fwd(*args[:4], chunk=c, initial_state=s0)
    want_y, want_s = chunked_gla_ref(*args[:4], c, s0)
    torch.cuda.synchronize()
    assert gla_scan_fwd.launches == before + 1
    assert y.dtype == want_y.dtype and s.dtype == torch.float32
    rel = 1e-4 if dtype == "float32" else 2.0 ** -7
    for got, want in ((y, want_y), (s, want_s)):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=rel * scale)


@pytest.mark.gpu
def test_gpu_mamba2_broadcast_operands(cuda):
    """Mamba2 hands the kernel q and k broadcast over the heads (stride 0)
    and a float32 v."""
    rng = np.random.default_rng(4)
    B, H, T, dk, dv = 2, 4, 300, 64, 96
    C = torch.from_numpy(rng.normal(size=(B, T, dk)).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(B, T, dk)).astype(np.float32))
    q = C.to(cuda, torch.bfloat16)[:, None].expand(B, H, T, dk)
    k = Bm.to(cuda, torch.bfloat16)[:, None].expand(B, H, T, dk)
    v, la = _torch([rng.normal(size=(B, H, T, dv)).astype(np.float32),
                    (-np.abs(rng.normal(size=(B, H, T)))).astype(
                        np.float32)], ["float32"] * 2, cuda)
    y, s = gla_scan_fwd(q, k, v, la, chunk=256)
    want_y, want_s = chunked_gla_ref(q, k, v, la, 256)
    for got, want in ((y, want_y), (s, want_s)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.gpu
def test_gpu_op_launches_the_kernel_and_its_backward(cuda):
    """Through ``ops.gla_scan_op``, the forward launches gla_scan and the
    backward gla_scan_bwd, once each, and the gradients of a loss on y
    and the final state match the plain backward (float32: 1e-4 of each
    gradient's largest magnitude)."""
    q, k, v, la = (t.requires_grad_(True) for t in _torch(
        _inputs(9, 1, 2, 70, 16, 8), ["float32"] * 4, cuda))
    before, before_bwd = gla_scan_fwd.launches, gla_scan_bwd.launches
    y, s = ops.gla_scan_op(q, k, v, la, chunk=32)
    assert gla_scan_fwd.launches == before + 1
    assert y.requires_grad
    dy = torch.randn(y.shape, device=cuda, generator=torch.Generator(
        cuda).manual_seed(1))
    (y * dy).sum().backward(retain_graph=True)
    assert gla_scan_bwd.launches == before_bwd + 1
    want = chunked_gla_bwd_ref(q.detach(), k.detach(), v.detach(),
                               la.detach(), 32, None, dy)
    for leaf, w in zip((q, k, v, la), want):
        torch.testing.assert_close(leaf.grad, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
    for leaf in (q, k, v, la):
        leaf.grad = None
    s.sum().backward()
    want = chunked_gla_bwd_ref(q.detach(), k.detach(), v.detach(),
                               la.detach(), 32, None, torch.zeros_like(dy),
                               torch.ones_like(s))
    assert gla_scan_bwd.launches == before_bwd + 2
    for leaf, w in zip((q, k, v, la), want):
        torch.testing.assert_close(leaf.grad, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


def _gpu_bwd_close(got, want, dtypes):
    """The card's backward tolerances, relative to each gradient's largest
    magnitude: a bf16 gradient within one bf16 unit in the last place
    (2^-7; each side rounds a float32 result once), a float32 one within
    1e-4 (float32 sums in another order); d log_a, float32 always, within
    1e-4 with three terms (a float32 v) and 5e-4 with two (a bf16 v: the
    reverse sum over T of q . dq - k . dk from products ~1e-5 off), and
    the initial state's gradient within 1e-4."""
    two_terms = dtypes[2] == "bfloat16"
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            assert w is None
            continue
        rel = (2.0 ** -7 if i < 3 and dtypes[i] == "bfloat16"
               else 5e-4 if i == 3 and two_terms else 1e-4)
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float().to(g.device), rtol=0,
                                   atol=rel * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("label,B,H,T,dk,dv,c,mix", GPU_CASES,
                         ids=[f"{c[0]}-T{c[3]}-dk{c[4]}" for c in GPU_CASES])
def test_gpu_bwd_matches_plain(cuda, dtype, state, label, B, H, T, dk, dv,
                               c, mix):
    """gla_scan_bwd against chunked_gla_bwd_ref over the forward's card
    cases, with an initial state and a final-state gradient or neither:
    one launch, each gradient in its operand's dtype."""
    arrays = _bwd_inputs(T + dk, B, H, T, dk, dv, state=state, dstate=state,
                         k_scale=1 / math.sqrt(dk))
    dtypes = [dtype, "float32" if mix else dtype, dtype]
    q, k, v, la, s0, dy, ds = (None if t is None else t.to(cuda)
                               for t in _torch_bwd_args(arrays, dtypes))
    before = gla_scan_bwd.launches
    got = gla_scan_bwd(q, k, v, la, dy, chunk=c, initial_state=s0,
                       dstate=ds)
    want = chunked_gla_bwd_ref(q, k, v, la, c, s0, dy, ds)
    torch.cuda.synchronize()
    assert gla_scan_bwd.launches == before + 1
    assert [g.dtype for g in got[:3]] == [q.dtype, k.dtype, v.dtype]
    want = [None if w is None else w.to(g.dtype)
            for g, w in zip(got, want)]
    _gpu_bwd_close(got, want, dtypes)


@pytest.mark.gpu
@pytest.mark.parametrize("dstate", [False, True])
def test_gpu_bwd_mamba2_broadcast_operands(cuda, dstate):
    """Mamba2's layout: q and k bf16 broadcast over the heads (stride 0),
    v float32 (three terms); dq and dk come back dense per head, and
    autograd's expand sums them over the heads."""
    rng = np.random.default_rng(6)
    B, H, T, dk, dv = 2, 4, 300, 64, 96
    C, Bm = (torch.from_numpy(rng.normal(size=(B, T, dk)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(2))
    q, k = C[:, None].expand(B, H, T, dk), Bm[:, None].expand(B, H, T, dk)
    v, la, dy = _torch([rng.normal(size=(B, H, T, dv)).astype(np.float32),
                        (-np.abs(rng.normal(size=(B, H, T)))).astype(
                            np.float32),
                        rng.normal(size=(B, H, T, dv)).astype(np.float32)],
                       ["float32"] * 3, cuda)
    ds = torch.from_numpy(rng.normal(size=(B, H, dk, dv)).astype(
        np.float32)).to(cuda) if dstate else None
    got = gla_scan_bwd(q, k, v, la, dy, chunk=256, dstate=ds)
    assert got[0].shape == (B, H, T, dk) and got[0].stride(1) != 0
    want = chunked_gla_bwd_ref(q, k, v, la, 256, None, dy, ds)
    _gpu_bwd_close(got, [w.to(g.dtype) for g, w in zip(got[:4], want)]
                   + [None], ["bfloat16", "bfloat16", "float32"])
    C.requires_grad_(True)
    y, _ = ops.gla_scan_op(C[:, None].expand(B, H, T, dk), k, v, la,
                           chunk=256)
    (y * dy).sum().backward()
    torch.testing.assert_close(C.grad.float(),
                               want[0].sum(1).to(torch.bfloat16).float(),
                               rtol=0, atol=2.0 ** -6 * float(
                                   want[0].sum(1).abs().max()))


def _mlstm_operands(seed, B, H, T, hd, device):
    """q, k, v as ``mlstm_forward`` hands them to the kernel: q bf16 and k
    float32, (B, H, T, hd) views of (B, T, H, hd) tensors; v bf16, the
    first hd + 1 columns of an ``aligned_empty`` buffer, the last ones."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(
        np.float32)).to(device, torch.bfloat16).transpose(1, 2)
    k = torch.from_numpy((rng.normal(size=(B, T, H, hd)) / math.sqrt(
        hd)).astype(np.float32)).to(device).transpose(1, 2)
    v = aligned_empty((B, H, T, hd + 1), torch.bfloat16, device)
    v[..., :hd] = torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(
        np.float32)).to(device, torch.bfloat16).transpose(1, 2)
    v[..., hd] = 1
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("state", [False, True])
def test_gpu_mlstm_operands_in_place(cuda, strong, state):
    """The full-width mLSTM call's operands as the model lays them out
    (strided q and k, v of pitch 520), read without a copy, with log_a at
    the clamp over whole chunks or not, with an initial state (and a
    final-state gradient) or not: within 2^-7 of the largest |y| and 1e-4
    of the largest |S|; the backward on the same operands at
    ``_gpu_bwd_close``'s tolerances."""
    B, H, T, hd, c = 1, 4, 700, 512, 256
    q, k, v = _mlstm_operands(T + hd, B, H, T, hd, cuda)
    assert all(aligned(t) for t in (q, k, v))
    rng = np.random.default_rng(3)
    la = (-np.abs(rng.normal(size=(B, H, T))) * 0.2).astype(np.float32)
    if strong:
        _strong_decay(la, c)
    la = torch.from_numpy(la).to(cuda)
    s0 = torch.from_numpy(rng.normal(size=(B, H, hd, hd + 1)).astype(
        np.float32)).to(cuda) if state else None
    y, s = gla_scan_fwd(q, k, v, la, chunk=c, initial_state=s0)
    want_y, want_s = chunked_gla_ref(q, k, v, la, c, s0)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == v.shape
    for got, want, rel in ((y, want_y, 2.0 ** -7), (s, want_s, 1e-4)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=rel * float(want.float().abs().max()))
    dy = torch.from_numpy(rng.normal(size=(B, H, T, hd + 1)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    ds = torch.from_numpy(rng.normal(size=(B, H, hd, hd + 1)).astype(
        np.float32)).to(cuda) if state else None
    before = gla_scan_bwd.launches
    got = gla_scan_bwd(q, k, v, la, dy, chunk=c, initial_state=s0, dstate=ds)
    assert gla_scan_bwd.launches == before + 1
    want = chunked_gla_bwd_ref(q, k, v, la, c, s0, dy, ds)
    _gpu_bwd_close(got, [None if w is None else w.to(g.dtype)
                         for g, w in zip(got, want)],
                   ["bfloat16", "float32", "bfloat16"])
