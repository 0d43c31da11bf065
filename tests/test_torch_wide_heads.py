"""head_dim 256 (GPT-J-6B, gemma2-9b) in the port's attention kernels.

* On the CPU, the plain versions at head_dim 256 against the JAX Pallas
  kernels as ``tests/test_kernels.py`` runs them (``interpret=True``), on
  the same numpy inputs: ragged and paged attention with float32 queries
  over float32 and int8 pools (G 1 and 2, windows 7 and 40, softcap 50,
  padded rows), and the flash forward (causal, window, softcap, no causal
  mask). Then the wrappers' operand checks: ragged, paged and the flash
  forward take head_dim 256 (and still refuse 512, and a float32 G whose
  CUDA-core tiles pass 48 KB); the flash backward takes 192 and 256 (its
  launcher refuses only CPU tensors, and autograd on the CPU runs the
  plain backward at both widths).
* On a CUDA card (``-m gpu``), each kernel at head_dim 256 against its
  plain version, one launch a call; these skip when no card is present.
  The card's machine has no JAX, so the reference is imported inside the
  CPU tests only and the card runs this file with
  ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_wide_heads.py``.

Tolerances: float32 atol 2e-5 of the values' largest magnitude (the
attention of ``tests/test_kernels.py``: float32 sums in another order;
int8 payloads dequantize exactly in float32); on the card 1e-4 (float32)
and 3e-2 (bf16), chip_smoke's.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ragged_paged_attention as ra


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HD = 256
PAGE, MAX_PAGES, N_PAGES = 16, 8, 32


def _pools(rng, Hkv, pool):
    """K and V pools (N_PAGES, PAGE, Hkv, HD): float32 normals, or int8
    payloads with per-(page, kv head) float32 scales in [0.005, 0.02)."""
    shape = (N_PAGES, PAGE, Hkv, HD)
    if pool == "float32":
        return [rng.normal(size=shape).astype(np.float32)
                for _ in range(2)], None
    payload = [rng.integers(-127, 128, shape).astype(np.int8)
               for _ in range(2)]
    scales = [(rng.random((N_PAGES, Hkv)) * 0.015 + 0.005).astype(np.float32)
              for _ in range(2)]
    return payload, scales


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(want).max()))


CASES = [(G, window, softcap, pool)
         for G in (1, 2)
         for window, softcap in ((None, None), (7, None), (40, None),
                                 (None, 50.0), (40, 50.0))
         for pool in ("float32", "int8")]


@pytest.mark.parametrize("G,window,softcap,pool", CASES)
def test_ragged_plain_matches_pallas_at_hd256(G, window, softcap, pool):
    """A mixed batch of 9 flat rows over 3 sequences, one of them padded
    (tok_pos -1), contexts up to the full 128-slot table."""
    import jax.numpy as jnp
    from repro.kernels.ragged_paged_attention import ragged_paged_attention
    rng = np.random.default_rng(G * 100 + (window or 0) + len(pool))
    Hkv = 16 // (8 * G)          # 2 kv heads at G 1, 1 at G 2
    q = rng.normal(size=(9, Hkv, G, HD)).astype(np.float32)
    (kp, vp), scales = _pools(rng, Hkv, pool)
    bt = rng.integers(0, N_PAGES, (3, MAX_PAGES)).astype(np.int32)
    tok_seq = np.array([0, 0, 0, 1, 1, 2, 2, 2, 0], np.int32)
    tok_pos = np.array([50, 51, 52, 0, 127, 100, 101, 102, -1], np.int32)
    kw = dict(window=window, softcap=softcap)
    jscales = {} if scales is None else dict(
        k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
    want = ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(tok_seq), jnp.asarray(tok_pos), interpret=True,
        **jscales, **kw)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    routing = [torch.from_numpy(a) for a in (bt, tok_seq, tok_pos)]
    if scales is None:
        got = ra.ragged_paged_attention_ref(*args, *routing, **kw)
    else:
        got = ra.ragged_paged_attention_quant_ref(
            *args, *map(torch.from_numpy, scales), *routing, **kw)
    _close(got.numpy()[:-1], np.asarray(want)[:-1])
    assert not got[-1].any()                     # the padded row


@pytest.mark.parametrize("G,window,softcap,pool", CASES)
def test_paged_plain_matches_pallas_at_hd256(G, window, softcap, pool):
    """A decode bucket of 4 sequences: the first token, a page edge, one
    past it, the full table."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention
    rng = np.random.default_rng(G * 10 + (window or 1) + len(pool))
    Hkv = 16 // (8 * G)
    q = rng.normal(size=(4, Hkv, G, HD)).astype(np.float32)
    (kp, vp), scales = _pools(rng, Hkv, pool)
    bt = rng.integers(0, N_PAGES, (4, MAX_PAGES)).astype(np.int32)
    ctx_lens = np.array([1, 16, 17, PAGE * MAX_PAGES], np.int32)
    kw = dict(window=window, softcap=softcap)
    jscales = {} if scales is None else dict(
        k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
    want = paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(bt), jnp.asarray(ctx_lens),
                           interpret=True, **jscales, **kw)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    routing = [torch.from_numpy(a) for a in (bt, ctx_lens)]
    if scales is None:
        got = pa.paged_attention_ref(*args, *routing, **kw)
    else:
        got = pa.paged_attention_quant_ref(
            *args, *map(torch.from_numpy, scales), *routing, **kw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("G,Hkv", [(1, 2), (2, 1)])
@pytest.mark.parametrize("window,softcap,causal", [
    (None, None, True), (64, None, True), (None, 50.0, True),
    (32, 50.0, True), (None, None, False)])
def test_flash_plain_forward_matches_pallas_at_hd256(G, Hkv, window,
                                                     softcap, causal):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(G + (window or 0))
    q = rng.normal(size=(1, Hkv, G, 128, HD)).astype(np.float32)
    k, v = (rng.normal(size=(1, Hkv, 128, HD)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           bq=64, bk=64, interpret=True, **kw)
    got = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the wrappers' operand checks
# ---------------------------------------------------------------------------
def _paged_operands(hd, G, dtype, Hkv=2):
    z = torch.zeros
    i32 = torch.int32
    return (z(3, Hkv, G, hd, dtype=dtype), z(8, 16, Hkv, hd, dtype=dtype),
            z(8, 16, Hkv, hd, dtype=dtype), None, None, z(3, 4, dtype=i32))


@pytest.mark.parametrize("dtype,G", [(torch.bfloat16, 2),
                                     (torch.bfloat16, 1),
                                     (torch.float32, 2)])
def test_attention_wrappers_take_head_dim_256(dtype, G):
    """The operand checks behind the launchers (the launchers refuse a CPU
    tensor before them) take head_dim 256 on both routes, and still refuse
    512."""
    assert 256 in ra.HEAD_DIMS and 256 in pa.HEAD_DIMS
    i32 = torch.int32
    for hd, ok in ((256, True), (512, False)):
        q, kp, vp, ks, vs, bt = _paged_operands(hd, G, dtype)
        checks = (
            lambda: ra._check(q, kp, vp, ks, vs, bt,
                              torch.zeros(3, dtype=i32),
                              torch.zeros(3, dtype=i32)),
            lambda: pa._check(q, kp, vp, ks, vs, bt,
                              torch.ones(3, dtype=i32)))
        for check in checks:
            if ok:
                assert check() == 0                 # pools in q's type
            else:
                with pytest.raises(ValueError, match="head_dim in"):
                    check()


def test_attention_wrappers_refuse_float32_tiles_past_48kb():
    """The CUDA-core kernels stage float32 tiles in at most 48 KB: at
    head_dim 256 that holds G up to 7 over 16-slot pages."""
    i32 = torch.int32
    q, kp, vp, ks, vs, bt = _paged_operands(256, 8, torch.float32, Hkv=1)
    with pytest.raises(ValueError, match="shared memory"):
        ra._check(q, kp, vp, ks, vs, bt, torch.zeros(3, dtype=i32),
                  torch.zeros(3, dtype=i32))
    with pytest.raises(ValueError, match="shared memory"):
        pa._check(q, kp, vp, ks, vs, bt, torch.ones(3, dtype=i32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_takes_head_dim_256(dtype):
    assert 256 in fa.HEAD_DIMS
    q = torch.zeros((1, 2, 2, 8, 256), dtype=dtype)
    k = torch.zeros((1, 2, 8, 256), dtype=dtype)
    fa._check("flash_attention", q, k, k)
    # a float32 block of 4096 / hd rows holds all G heads of a position
    with pytest.raises(ValueError, match="head_dim"):
        fa._check("flash_attention", torch.zeros((1, 1, 17, 8, 256),
                                                 dtype=dtype), k[:, :1],
                  k[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, k)


def test_flash_backward_takes_head_dims_192_and_256():
    """The backward kernels take head_dim 192 and 256 (no refusal left):
    on the CPU the launcher refuses the tensors for lying on the CPU, as
    at every head_dim, and the autograd Function runs the plain backward
    at both widths, equal to ``flash_attention_bwd_ref`` on its saved
    output and lse."""
    g = torch.Generator().manual_seed(0)
    for hd in (192, 256):
        q = torch.zeros((1, 1, 1, 4, hd))
        k = torch.zeros((1, 1, 4, hd))
        lse = torch.zeros((1, 1, 1, 4))
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_bwd(q, k, k, q, lse, q)
        qr = torch.randn((1, 1, 2, 6, hd), generator=g, requires_grad=True)
        kr = torch.randn((1, 1, 6, hd), generator=g, requires_grad=True)
        vr = torch.randn((1, 1, 6, hd), generator=g, requires_grad=True)
        do = torch.randn((1, 1, 2, 6, hd), generator=g)
        kw = dict(softcap=50.0, window=4)
        (fa.flash_attention(qr, kr, vr, **kw) * do).sum().backward()
        q0, k0, v0 = (t.detach() for t in (qr, kr, vr))
        out, lse = fa.flash_attention_fwd_ref(q0, k0, v0, **kw)
        want = fa.flash_attention_bwd_ref(q0, k0, v0, out, lse, do, **kw)
        for t, w in zip((qr, kr, vr), want):
            assert torch.isfinite(t.grad).all()
            torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# on the card: each kernel at head_dim 256 against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,window,softcap", [(1, None, None), (2, 40, 50.0),
                                              (2, None, 50.0)])
def test_gpu_paged_kernels_at_hd256(cuda, dtype, G, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(G)
    Hkv = 16 // G // 2
    n_pages, max_pages = 256, 64
    q = torch.randn((6, Hkv, G, HD), generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn((n_pages, 16, Hkv, HD), generator=g,
                          device=cuda).to(dtype) for _ in range(2))
    bt = torch.randint(0, n_pages, (6, max_pages), generator=g, device=cuda,
                       dtype=torch.int32)
    ctx = torch.tensor([1, 64, 65, 687, 1024, 0], dtype=torch.int32,
                       device=cuda)
    kw = dict(window=window, softcap=softcap)
    before = (ra.ragged_paged_attention.launches, pa.paged_attention.launches)
    seq = torch.arange(6, dtype=torch.int32, device=cuda)
    got_r = ra.ragged_paged_attention(q, kp, vp, bt, seq, ctx - 1, **kw)
    got_p = pa.paged_attention(q, kp, vp, bt, ctx, **kw)
    want = ra.ragged_paged_attention_ref(q, kp, vp, bt, seq, ctx - 1, **kw)
    assert (ra.ragged_paged_attention.launches,
            pa.paged_attention.launches) == (before[0] + 1, before[1] + 1)
    for got in (got_r, got_p):
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=CARD_TOL[dtype], rtol=0)
        assert torch.all(got[-1] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window,softcap", [(None, None), (100, 50.0)])
def test_gpu_flash_forward_at_hd256(cuda, dtype, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((1, 8, 2, 300, HD), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, 8, 300, HD), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    assert fa.flash_attention_fwd.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(),
                               atol=CARD_TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse.float(), atol=1e-4, rtol=0)
