"""The port's paged decode attention, held two ways.

* On the CPU, the plain PyTorch version ``paged_attention_ref`` against
  the JAX ``paged_attention`` as ``tests/test_kernels.py`` runs it
  (Pallas, ``interpret=True``), on the same numpy inputs and the same
  sweeps: shapes, ragged context edges x G {1, 4}, sliding window, and
  softcap. Tolerances are those of ``tests/test_kernels.py``: atol 2e-5
  in float32 (the two sum in another order), 3e-2 in bfloat16 (one
  rounding of a float32 result to bf16). Rows with ``ctx_lens == 0`` are
  padding: the JAX kernel leaves garbage there and the port writes
  zeros, so they are masked out of the comparison and checked for zeros.
* On a CUDA card (``-m gpu``), the hand-written kernel against its plain
  version, 1e-4 in float32 and 3e-2 in bfloat16 (the ragged kernel's
  tolerances); these skip when no card is present. The card's machine
  has no JAX, so the reference is imported inside the CPU tests only and
  the card runs this file alone:
  ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_paged_attention.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_quant_ref,
                                                 paged_attention_ref)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them and slow these
    tests many times over, so each worker's torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}          # as tests/test_kernels.py


def _jax():
    """The JAX reference kernel, imported where a CPU test needs it."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention as jax_paged
    return SimpleNamespace(jnp=jnp, paged=jax_paged)


def _t(a, dtype=None):
    """numpy -> torch (bfloat16 goes through float32, exact)."""
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _inputs(rng, B, Hkv, G, hd, page, max_pages, n_pages, lens=None):
    q = rng.normal(size=(B, Hkv, G, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, page, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, Hkv, hd)).astype(np.float32)
    bt = rng.integers(0, n_pages, (B, max_pages)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, page * max_pages + 1, (B,))
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _both(inputs, dtype="float32", **kw):
    q, kp, vp, bt, lens = inputs
    J = _jax()
    jnp = J.jnp
    jd, td = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    want = J.paged(jnp.asarray(q, jd), jnp.asarray(kp, jd),
                   jnp.asarray(vp, jd), jnp.asarray(bt), jnp.asarray(lens),
                   interpret=True, **kw)
    got = paged_attention_ref(_t(q, td), _t(kp, td), _t(vp, td), _t(bt),
                              _t(lens), **kw)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def _assert_close(got, want, lens, atol):
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=0)
    assert np.all(got[~live] == 0.0)


# ---------------------------------------------------------------------------
# plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Hkv,G,hd,page,max_pages,n_pages", [
    (2, 2, 4, 64, 16, 8, 32),
    (4, 1, 8, 128, 8, 16, 64),
    (1, 4, 1, 32, 32, 4, 16),
    (3, 2, 2, 64, 16, 5, 20),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas(B, Hkv, G, hd, page, max_pages, n_pages,
                                    dtype):
    rng = np.random.default_rng(B * 7 + page)
    inputs = _inputs(rng, B, Hkv, G, hd, page, max_pages, n_pages)
    want, got = _both(inputs, dtype)
    _assert_close(got, want, inputs[-1], TOL[dtype])


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("ctx", [1, 8, 16, 23, 32])
def test_paged_plain_context_edges(G, ctx):
    """ctx = 1, on a page boundary (8, 16), mid-page (23) and the full
    table (32 = page * max_pages), the others ragged around it; the last
    row is padding (ctx_lens = 0) and must come back as zeros."""
    rng = np.random.default_rng(G * 100 + ctx)
    lens = [ctx, max(1, ctx - 1), min(32, ctx + 1), 0]
    inputs = _inputs(rng, 4, 2, G, 32, 8, 4, 16, lens=lens)
    want, got = _both(inputs)
    _assert_close(got, want, inputs[-1], 2e-5)


@pytest.mark.parametrize("window,softcap", [(1, None), (7, None),
                                            (16, None), (None, 30.0),
                                            (9, 25.0)])
def test_paged_plain_window_softcap(window, softcap):
    rng = np.random.default_rng(0 if window is None else window)
    inputs = _inputs(rng, 3, 2, 2, 32, 8, 4, 16, lens=[29, 5, 0])
    want, got = _both(inputs, window=window, softcap=softcap)
    _assert_close(got, want, inputs[-1], 2e-5)


def test_paged_plain_equals_ragged_at_one_token_per_sequence():
    """The decode is the ragged kernel's degenerate case: token b of
    sequence b at position ctx_lens[b] - 1 (the plain versions, exact up
    to float32 summation order)."""
    from repro_torch.kernels.ragged_paged_attention import \
        ragged_paged_attention_ref
    rng = np.random.default_rng(2)
    q, kp, vp, bt, lens = map(_t, _inputs(rng, 3, 2, 4, 64, 16, 4, 16,
                                          lens=[64, 17, 0]))
    got = paged_attention_ref(q, kp, vp, bt, lens, window=20)
    want = ragged_paged_attention_ref(q, kp, vp, bt,
                                      torch.arange(3, dtype=torch.int32),
                                      lens - 1, window=20)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version, the launcher refuses them
# ---------------------------------------------------------------------------
def test_op_dispatches_cpu_to_plain_version():
    rng = np.random.default_rng(5)
    q, kp, vp, bt, lens = map(_t, _inputs(rng, 3, 2, 2, 32, 8, 4, 16))
    before = paged_attention.launches
    out = ops.paged_attention_op(q, kp, vp, bt, lens, window=5)
    assert torch.equal(out, paged_attention_ref(q, kp, vp, bt, lens,
                                                window=5))
    assert paged_attention.launches == before
    # quantized pools with their scales take the dequantizing plain version
    kq, vq = kp.mul(40).round().to(torch.int8), vp.mul(40).round().to(
        torch.int8)
    ks = torch.rand(kp.shape[0], kp.shape[2])
    out = ops.paged_attention_op(q, kq, vq, bt, lens, k_scale=ks,
                                 v_scale=ks)
    assert torch.equal(out, paged_attention_quant_ref(q, kq, vq, ks, ks, bt,
                                                      lens))
    assert paged_attention.launches == before


def test_launcher_refuses_cpu_tensors():
    """A wrapper launches its kernel or raises; it never falls back."""
    z = torch.zeros
    i32 = torch.int32
    before = paged_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(z(2, 1, 4, 32), z(4, 8, 1, 32), z(4, 8, 1, 32),
                        z(2, 3, dtype=i32), z(2, dtype=i32))
    assert paged_attention.launches == before


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window,softcap", [(None, None), (9, None),
                                            (None, 30.0)])
def test_gpu_paged_kernel_matches_plain(cuda, dtype, G, window, softcap):
    """llama3.2-1b's widths (Hkv 8, hd 64, page 16), ctx edges {1, page
    boundary, full table} and a padded row."""
    rng = np.random.default_rng(11)
    td = TORCH_DTYPES[dtype]
    lens = [1, 16, 17, 16 * 16, 100, 0]
    q, kp, vp, bt, lens = _inputs(rng, 6, 8, G, 64, 16, 16, 128, lens=lens)
    args = [_t(q, td), _t(kp, td), _t(vp, td), _t(bt), _t(lens)]
    args = [a.to(cuda) for a in args]
    before = paged_attention.launches
    got = ops.paged_attention_op(*args, window=window, softcap=softcap)
    want = paged_attention_ref(*args, window=window, softcap=softcap)
    assert paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               atol=1e-4 if dtype == "float32" else 3e-2,
                               rtol=0)
    assert torch.all(got[-1] == 0)
