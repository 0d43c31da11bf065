"""The port's flash attention, held three ways.

* On the CPU, the plain forward against the JAX kernel as
  ``tests/test_kernels.py`` runs it (Pallas, ``interpret=True``, blocks of
  64) and against ``repro.kernels.ref.flash_attention_ref``, over that
  file's shape and masking grids (atol 2e-5 in float32, 2e-2 in bf16, its
  tolerances); lengths that are not block multiples against the JAX
  reference alone (the Pallas kernel asserts block multiples).
* The plain backward against ``jax.grad`` of the JAX reference, on one
  seeded cotangent, in float32 (atol 2e-5: float32 products summed in
  another order, on gradients of magnitude ~1), and the autograd Function
  by ``torch.autograd.gradcheck`` in float64.
* On a CUDA card (``-m gpu``), the kernels against the plain versions,
  forward and backward, and two backward launches at head_dim 192 and
  256 bit for bit equal in bf16 and float32; these skip when no card is
  present. The card's
  machine has no JAX, so the reference is imported inside the CPU tests
  only and the card runs this file with
  ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_fwd, flash_attention_fwd_ref, flash_attention_ref)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Hkv, G, Tq, Tk, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hkv, G, Tq, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, hd)).astype(np.float32))


def _jax(arrays, dtype):
    import jax.numpy as jnp
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


SHAPES = [(1, 1, 1, 128, 128, 64), (2, 2, 4, 128, 128, 64),
          (1, 2, 2, 64, 128, 32), (2, 1, 8, 128, 128, 128)]
MASKS = [(None, None, True), (64, None, True), (None, 30.0, True),
         (32, 50.0, True), (None, None, False)]


@pytest.mark.parametrize("B,Hkv,G,Tq,Tk,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_and_ref(B, Hkv, G, Tq, Tk, hd, dtype):
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention as jax_flash
    arrays = _inputs(B * 10 + G, B, Hkv, G, Tq, Tk, hd)
    jq, jk, jv = _jax(arrays, dtype)
    pallas = np.asarray(jax_flash(jq, jk, jv, bq=64, bk=64, interpret=True),
                        np.float32)
    want = np.asarray(ref.flash_attention_ref(jq, jk, jv), np.float32)
    got = flash_attention_ref(*_torch(arrays, dtype)).float().numpy()
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, pallas, atol=tol)
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("window,softcap,causal", MASKS)
def test_plain_forward_masking_matches_pallas(window, softcap, causal):
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention as jax_flash
    arrays = _inputs(5, 1, 2, 2, 128, 128, 64)
    jq, jk, jv = _jax(arrays, "float32")
    kw = dict(causal=causal, window=window, softcap=softcap)
    pallas = jax_flash(jq, jk, jv, bq=64, bk=64, interpret=True, **kw)
    want = ref.flash_attention_ref(jq, jk, jv, **kw)
    got = flash_attention_ref(*_torch(arrays, "float32"), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Tq,Tk,window", [(63, 63, None), (100, 100, 17),
                                          (1, 1, None), (37, 90, None)])
def test_plain_forward_any_length(Tq, Tk, window):
    """Lengths that are not block multiples, and Tq < Tk."""
    from repro.kernels import ref
    arrays = _inputs(Tq, 2, 2, 4, Tq, Tk, 32)
    want = ref.flash_attention_ref(*_jax(arrays, "float32"), window=window)
    got = flash_attention_ref(*_torch(arrays, "float32"), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Tq,Tk,window,softcap,causal", [
    (48, 48, None, None, True), (48, 48, 9, None, True),
    (48, 48, None, 20.0, True), (40, 64, 12, 30.0, True),
    (48, 48, None, None, False)])
def test_plain_backward_matches_jax_grad(Tq, Tk, window, softcap, causal):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref
    arrays = _inputs(Tq + Tk, 2, 2, 4, Tq, Tk, 32)
    cot = np.random.default_rng(99).normal(
        size=arrays[0].shape).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def f(q, k, v):
        return jnp.sum(ref.flash_attention_ref(q, k, v, **kw) * cot)
    want = jax.grad(f, argnums=(0, 1, 2))(*_jax(arrays, "float32"))
    q, k, v = _torch(arrays, "float32")
    out, lse = flash_attention_fwd_ref(q, k, v, **kw)
    got = flash_attention_bwd_ref(q, k, v, out, lse, torch.from_numpy(cot),
                                  **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    # the autograd Function on CPU tensors runs the same plain versions
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    (flash_attention(qs, ks, vs, **kw) * torch.from_numpy(cot)).sum() \
        .backward()
    for t, w in zip((qs, ks, vs), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("window,softcap,causal,Tq", [
    (None, None, True, 6), (3, None, True, 6), (None, 2.0, True, 4),
    (None, None, False, 6)])
def test_autograd_function_gradcheck_float64(window, softcap, causal, Tq):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 2, Tq, 4), generator=g, dtype=torch.float64)
    k = torch.randn((1, 2, 6, 4), generator=g, dtype=torch.float64)
    v = torch.randn((1, 2, 6, 4), generator=g, dtype=torch.float64)
    args = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                        window=window, softcap=softcap),
        args)


def test_tq_above_tk_raises():
    q = torch.zeros((1, 1, 1, 5, 32))
    k = torch.zeros((1, 1, 4, 32))
    for fn in (flash_attention, flash_attention_ref, ops.flash_attention_op):
        with pytest.raises(ValueError, match="Tq 5 > Tk 4"):
            fn(q, k, k)


def test_launchers_refuse_cpu_tensors():
    q = torch.zeros((1, 1, 1, 4, 32))
    k = torch.zeros((1, 1, 4, 32))
    lse = torch.zeros((1, 1, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, k, q, lse, q)


def test_op_on_cpu_is_the_plain_version():
    arrays = _inputs(3, 1, 2, 4, 20, 20, 32)
    q, k, v = _torch(arrays, "float32")
    torch.testing.assert_close(
        ops.flash_attention_op(q, k, v, window=5, softcap=10.0),
        flash_attention_ref(q, k, v, window=5, softcap=10.0), rtol=0,
        atol=0)


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,Tq,Tk,window,softcap,causal,hd", [
    (4, 64, 64, None, None, True, 64), (4, 100, 100, None, None, True, 64),
    (1, 70, 200, 33, None, True, 64), (4, 63, 63, None, 30.0, True, 64),
    (8, 50, 50, None, None, False, 64), (4, 1, 1, None, None, True, 64),
    # the bf16 kernels' 64-row tiles: lengths one past and one short of a
    # tile, an offset Tk - Tq that is not a tile multiple, windows ending
    # on and one past a tile boundary, G 1 and 16, hd 32 and 128
    (4, 65, 65, None, None, True, 64), (4, 127, 127, None, None, True, 64),
    (4, 129, 129, None, None, True, 64), (4, 100, 163, None, None, True, 64),
    (4, 200, 200, 64, None, True, 64), (4, 200, 200, 65, None, True, 64),
    (1, 129, 129, None, None, True, 64), (16, 130, 130, None, None, True, 64),
    (4, 129, 129, None, None, True, 32), (4, 100, 163, 65, None, True, 32),
    (4, 129, 129, None, None, True, 128), (2, 100, 163, None, 20.0, True, 128),
    (4, 127, 129, None, None, False, 128),
    # head_dim 192 (MLA's qk width) and 256 (gemma2, GPT-J): the bf16
    # backward's TMA-fed wgmma kernels, the float32 split kernels' 16- and
    # 32-row tiles
    (1, 65, 65, None, None, True, 192), (1, 129, 129, None, None, True, 192),
    (16, 100, 163, None, None, True, 192), (2, 200, 200, 65, 50.0, True, 192),
    (2, 1, 1, None, None, True, 256), (2, 129, 129, None, 50.0, True, 256),
    (1, 100, 163, 33, None, True, 256), (16, 100, 100, None, None, True, 256),
    (1, 90, 130, None, None, False, 256), (2, 300, 300, 100, 50.0, True, 256),
    # their edges: T past a 64-row tile over B x Hkv = 4 distinct heads
    # (a tile's rows past T read as zeros), Tq < Tk, G 2 and
    # max_heads(hd) = 16, a window of 70 (no tile multiple) with softcap
    (2, 77, 77, None, None, True, 192), (2, 77, 77, None, None, True, 256),
    (2, 100, 300, None, None, True, 192), (2, 100, 300, None, None, True, 256),
    (16, 77, 200, None, None, True, 192), (16, 77, 200, None, None, True, 256),
    (2, 257, 257, 70, 50.0, True, 192), (2, 257, 257, 70, 50.0, True, 256)])
def test_gpu_kernels_match_plain(cuda, dtype, G, Tq, Tk, window, softcap,
                                 causal, hd):
    arrays = _inputs(Tq, 2, 2, G, Tq, Tk, hd)
    q, k, v = _torch(arrays, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(1),
                     device=cuda).to(q.dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = flash_attention_fwd_ref(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want_grads = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    # gradients: 1e-4 (float32) or two bf16 units in the last place of
    # the largest magnitude among dq, dk and dv; at T = 1 one key takes the
    # whole softmax and dq, dk cancel to rounding noise around 0
    rel = 1e-4 if dtype == "float32" else 2.0 ** -6
    scale = max(float(w.float().abs().max()) for w in want_grads)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=rel * scale)


@pytest.mark.gpu
def test_gpu_autograd_function_launches_kernels(cuda):
    arrays = _inputs(7, 1, 2, 4, 33, 33, 32)
    q, k, v = (t.requires_grad_(True) for t in _torch(arrays, "float32",
                                                      cuda))
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    ops.flash_attention_op(q, k, v).sum().backward()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    flash_attention(qc, kc, vc).sum().backward()
    for a, b in ((q, qc), (k, kc), (v, vc)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [192, 256])
def test_gpu_wide_backward_is_deterministic(cuda, hd, dtype):
    """Every dq, dk and dv element has one owner (no atomics): two launches
    on the same inputs give the same bits, in bf16 and in float32 (the
    split kernels)."""
    arrays = _inputs(hd, 2, 2, 2, 200, 300, hd)
    q, k, v = _torch(arrays, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(2),
                     device=cuda).to(q.dtype)
    kw = dict(window=70, softcap=50.0)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    first = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    second = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_chip_smoke_parent_kernels_carry_the_flash_backward():
    """``chip_smoke.py --parent`` times the parent's flash backward in turns
    with this tree's: ``parent_kernels`` gives it through the other tree's
    own module, which launches a CUDA kernel or raises."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    ns = chip_smoke.parent_kernels(root)
    assert ns.flash_bwd is not flash_attention_bwd
    assert ns.flash_bwd.__name__ == "flash_attention_bwd"
    q = torch.zeros((1, 1, 1, 4, 256), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 4, 256), dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ns.flash_bwd(q, k, k, q, lse, q)
