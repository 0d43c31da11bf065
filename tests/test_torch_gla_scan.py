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
* The dispatch: ``ops.gla_scan_op`` is the plain version on the CPU, and
  differentiable there; the launcher refuses a CPU tensor.
* On a CUDA card (``-m gpu``), the kernel against the plain version,
  within 1e-4 (float32) or 2^-7 (a bfloat16 unit in the last place) of
  the largest |y| and |S|, and the backward of the kernel raising. These
  skip when no card is present. The card's machine has no JAX, so the
  reference is imported inside the CPU tests only and the card runs this
  file with ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_gla_scan.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.gla_scan import (chunked_gla_ref, gla_scan,
                                          gla_scan_fwd, gla_step_ref)


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


def test_launcher_refuses_cpu_tensors():
    q, k, v, la = _torch(_inputs(1, 1, 1, 8, 4, 4), ["float32"] * 4)
    with pytest.raises(ValueError, match="CUDA"):
        gla_scan_fwd(q, k, v, la, chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        gla_scan(q, k, v, la, chunk=4)


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
def test_gpu_op_launches_the_kernel_and_its_backward_raises(cuda):
    q, k, v, la = (t.requires_grad_(True) for t in _torch(
        _inputs(9, 1, 2, 70, 16, 8), ["float32"] * 4, cuda))
    before = gla_scan_fwd.launches
    y, s = ops.gla_scan_op(q, k, v, la, chunk=32)
    assert gla_scan_fwd.launches == before + 1
    assert y.requires_grad
    with pytest.raises(NotImplementedError, match="gla backward"):
        (y.sum() + s.sum()).backward()
