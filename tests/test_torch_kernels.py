"""The port's kernels, held two ways.

* On the CPU, each plain PyTorch version against the JAX function as
  ``tests/test_kernels.py`` runs it (Pallas, ``interpret=True``), on the
  same numpy inputs and the same sweeps: ragged context edges x G {1, 4},
  padded rows and all-invalid buckets, window and softcap, swap round
  trips over payload- and scale-shaped leaves.
* On a CUDA card (``-m gpu``), each hand-written kernel against its plain
  version; these skip when no card is present. The card's machine has no
  JAX, so the reference is imported inside the CPU tests only and the
  card runs this file alone:
  ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_kernels.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.kv_append import kv_append, kv_append_ref
from repro_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_quant_ref,
    ragged_paged_attention_ref)
from repro_torch.kernels.swap_pack import (SwapStager, slab_pages,
                                           swap_pack, swap_pack_ref,
                                           swap_pack_tree, swap_unpack,
                                           swap_unpack_ref, swap_unpack_tree)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them and slow these
    tests many times over, so each worker's torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}
RAGGED_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # as tests/test_kernels.py


def _jax():
    """The JAX reference kernels, imported where a CPU test needs them."""
    import jax.numpy as jnp
    from repro.kernels.kv_append import kv_append
    from repro.kernels.ragged_paged_attention import ragged_paged_attention
    from repro.kernels.swap_pack import swap_pack, swap_unpack
    return SimpleNamespace(jnp=jnp, kv_append=kv_append,
                           ragged=ragged_paged_attention,
                           swap_pack=swap_pack, swap_unpack=swap_unpack)


def _t(a, dtype=None):
    """numpy -> torch (bfloat16 goes through float32, exact)."""
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _ragged_inputs(rng, N, Hkv, G, hd, page, max_pages, n_pages, B,
                   tok_seq=None, tok_pos=None):
    q = rng.normal(size=(N, Hkv, G, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, page, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, Hkv, hd)).astype(np.float32)
    bt = rng.integers(0, n_pages, (B, max_pages)).astype(np.int32)
    if tok_seq is None:
        tok_seq = rng.integers(0, B, (N,))
    if tok_pos is None:
        tok_pos = rng.integers(0, page * max_pages, (N,))
    return (q, kp, vp, bt, np.asarray(tok_seq, np.int32),
            np.asarray(tok_pos, np.int32))


def _ragged_both(inputs, dtype="float32", **kw):
    q, kp, vp, bt, ts, tp = inputs
    J = _jax()
    jnp = J.jnp
    jd, td = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    want = J.ragged(jnp.asarray(q, jd), jnp.asarray(kp, jd),
                    jnp.asarray(vp, jd), jnp.asarray(bt), jnp.asarray(ts),
                    jnp.asarray(tp), interpret=True, **kw)
    got = ragged_paged_attention_ref(_t(q, td), _t(kp, td), _t(vp, td),
                                     _t(bt), _t(ts), _t(tp), **kw)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


# ---------------------------------------------------------------------------
# ragged paged attention: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,Hkv,G,hd,page,max_pages,n_pages,B", [
    (1, 2, 4, 64, 16, 8, 32, 1),     # a single decode token
    (9, 2, 4, 64, 16, 8, 32, 3),     # mixed ragged batch
    (6, 1, 8, 128, 8, 16, 64, 2),
    (5, 4, 1, 32, 32, 4, 16, 5),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_plain_matches_pallas(N, Hkv, G, hd, page, max_pages, n_pages,
                                     B, dtype):
    rng = np.random.default_rng(N * 13 + page)
    want, got = _ragged_both(_ragged_inputs(rng, N, Hkv, G, hd, page,
                                            max_pages, n_pages, B), dtype)
    np.testing.assert_allclose(got, want, atol=RAGGED_TOL[dtype], rtol=0)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("ctx", [1, 8, 16, 23, 32])
def test_ragged_plain_context_edges(G, ctx):
    """ctx = 1, on a page boundary (8, 16), mid-page (23) and the full
    table (32 = page * max_pages), the others ragged around it; the last
    row is padding (tok_pos = -1) and must come back as zeros."""
    rng = np.random.default_rng(G * 100 + ctx)
    pos = [ctx - 1, max(0, ctx - 2), min(31, ctx), -1]
    inputs = _ragged_inputs(rng, 4, 2, G, 32, 8, 4, 16, 2,
                            tok_seq=[0, 1, 0, 1], tok_pos=pos)
    want, got = _ragged_both(inputs)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.all(got[3] == 0.0)


@pytest.mark.parametrize("window,softcap", [(7, None), (16, None),
                                            (None, 30.0), (9, 25.0)])
def test_ragged_plain_window_softcap(window, softcap):
    rng = np.random.default_rng(0 if window is None else window)
    inputs = _ragged_inputs(rng, 6, 2, 2, 32, 8, 4, 16, 2,
                            tok_seq=[0, 0, 0, 1, 1, 0],
                            tok_pos=[0, 12, 31, 7, 8, 29])
    want, got = _ragged_both(inputs, window=window, softcap=softcap)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_ragged_plain_all_padded_bucket():
    rng = np.random.default_rng(7)
    inputs = _ragged_inputs(rng, 4, 2, 4, 32, 8, 4, 16, 2,
                            tok_pos=[-1, -1, -1, -1])
    want, got = _ragged_both(inputs)
    assert np.all(got == 0.0) and np.all(want == 0.0)


def test_ragged_plain_chunk_internal_causality():
    """Perturbing position p's K/V slot changes only queries at >= p."""
    rng = np.random.default_rng(1)
    q, kp, vp, bt, ts, tp = _ragged_inputs(rng, 4, 2, 2, 32, 8, 4, 16, 1,
                                           tok_seq=[0] * 4,
                                           tok_pos=[4, 5, 6, 7])
    base = ragged_paged_attention_ref(*map(_t, (q, kp, vp, bt, ts, tp)))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[bt[0, 0], 6] += 3.0
    vp2[bt[0, 0], 6] -= 2.0
    pert = ragged_paged_attention_ref(*map(_t, (q, kp2, vp2, bt, ts, tp)))
    d = (pert - base).abs().amax(dim=(1, 2, 3)).numpy()
    assert np.all(d[:2] == 0.0) and np.all(d[2:] > 0.0)


# ---------------------------------------------------------------------------
# kv_append: plain version vs the Pallas kernel, bit-exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [1, 4, 9])
def test_kv_append_plain_matches_pallas(dtype, N):
    rng = np.random.default_rng(N)
    n_pages, page, Hkv, hd = 12, 8, 2, 16
    J = _jax()
    jnp = J.jnp
    jd, td = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    kp, vp = (rng.normal(size=(n_pages, page, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(N, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    slots = rng.choice(n_pages * page, N, replace=False)
    ids = (slots // page).astype(np.int32)
    offs = (slots % page).astype(np.int32)
    valid = rng.integers(0, 2, N).astype(np.int32)
    wk, wv = J.kv_append(*(jnp.asarray(a, jd) for a in (kp, vp, kn, vn)),
                           jnp.asarray(ids), jnp.asarray(offs),
                           jnp.asarray(valid), interpret=True)
    gk, gv = kv_append_ref(*(_t(a, td) for a in (kp, vp, kn, vn)),
                           _t(ids), _t(offs), _t(valid))
    np.testing.assert_array_equal(gk.float().numpy(),
                                  np.asarray(wk.astype(jnp.float32)))
    np.testing.assert_array_equal(gv.float().numpy(),
                                  np.asarray(wv.astype(jnp.float32)))


def test_kv_append_plain_invalid_rows_leave_pool_untouched():
    """An all-invalid bucket, several rows aliasing one slot."""
    rng = np.random.default_rng(0)
    kp = _t(rng.normal(size=(6, 4, 2, 8)).astype(np.float32))
    vp = _t(rng.normal(size=(6, 4, 2, 8)).astype(np.float32))
    before = (kp.clone(), vp.clone())
    kn = _t(rng.normal(size=(5, 2, 8)).astype(np.float32))
    ids = torch.tensor([2, 2, 2, 5, 0], dtype=torch.int32)
    offs = torch.tensor([1, 1, 3, 0, 0], dtype=torch.int32)
    kv_append_ref(kp, vp, kn, kn, ids, offs, torch.zeros(5, dtype=torch.int32))
    assert torch.equal(kp, before[0]) and torch.equal(vp, before[1])


# ---------------------------------------------------------------------------
# kv_append over pools of two widths (MLA's latent c and rope key kr)
# ---------------------------------------------------------------------------
def _latent_append_case(rng, n_pages=6, page=4, L=32, R=16, N=5):
    """c and kr pools viewed as (n_pages, page, 1, width), their rows, and
    N distinct slots."""
    cp = _t(rng.normal(size=(n_pages, page, 1, L)).astype(np.float32))
    kp = _t(rng.normal(size=(n_pages, page, 1, R)).astype(np.float32))
    cn = _t(rng.normal(size=(N, 1, L)).astype(np.float32))
    kn = _t(rng.normal(size=(N, 1, R)).astype(np.float32))
    slots = rng.permutation(n_pages * page)[:N]
    return cp, kp, cn, kn, _t((slots // page).astype(np.int32)), \
        _t((slots % page).astype(np.int32))


def test_kv_append_check_takes_differing_last_widths():
    from repro_torch.kernels import kv_append as ka
    cp, kp, cn, kn, ids, offs = _latent_append_case(np.random.default_rng(0))
    ka._check(cp, kp, cn, kn, ids, offs, torch.ones(5, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["page_count", "page_size", "heads",
                                 "row_width"])
def test_kv_append_check_refuses_mismatched_pools(bad):
    """The pools may differ in their last width only: other page counts,
    page sizes or head counts, and rows that do not match their pool,
    are refused."""
    from repro_torch.kernels import kv_append as ka
    cp, kp, cn, kn, ids, offs = _latent_append_case(np.random.default_rng(1))
    if bad == "page_count":
        kp = torch.zeros((7, 4, 1, 16))
    elif bad == "page_size":
        kp = torch.zeros((6, 8, 1, 16))
    elif bad == "heads":
        kp, kn = torch.zeros((6, 4, 2, 16)), torch.zeros((5, 2, 16))
    else:
        kn = torch.zeros((5, 1, 32))
    with pytest.raises(ValueError, match="not taken"):
        ka._check(cp, kp, cn, kn, ids, offs, torch.ones(5, dtype=torch.int32))


def test_kv_append_plain_writes_both_widths():
    """Each valid row lands in its slot of both pools, at each pool's own
    width; an invalid row and every other slot stay as they were."""
    cp, kp, cn, kn, ids, offs = _latent_append_case(np.random.default_rng(2))
    before = (cp.clone(), kp.clone())
    valid = torch.tensor([1, 1, 0, 1, 1], dtype=torch.int32)
    kv_append_ref(cp, kp, cn, kn, ids, offs, valid)
    for pool, old, rows in ((cp, before[0], cn), (kp, before[1], kn)):
        want = old.clone()
        for i in range(5):
            if valid[i]:
                want[ids[i], offs[i]] = rows[i]
        assert torch.equal(pool, want)


# ---------------------------------------------------------------------------
# swap pack / unpack: plain version vs the Pallas kernels, bit-exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leaf", ["payload", "scales"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_move", [1, 5, 16])
def test_swap_plain_matches_pallas(leaf, dtype, n_move):
    """Payload-shaped (n_pages, page, Hkv, hd) and scale-shaped
    (n_pages, Hkv) leaves; the port's pools carry a leading layer-period
    axis, here of size 1."""
    rng = np.random.default_rng(n_move)
    shape = (32, 8, 2, 16) if leaf == "payload" else (32, 2)
    base = (rng.normal(size=shape) * 10).astype(np.float32)
    if dtype == "int8":
        base = np.clip(np.rint(base), -127, 127)
    J = _jax()
    jnp = J.jnp
    jd, td = getattr(jnp, dtype), TORCH_DTYPES[dtype]
    ids = rng.choice(32, n_move, replace=False).astype(np.int32)
    jpool, jids = jnp.asarray(base, jd), jnp.asarray(ids)
    tpool, tids = _t(base, td)[None], _t(ids)
    staged = J.swap_pack(jpool, jids, interpret=True)
    slab = swap_pack_ref(tpool, tids)
    np.testing.assert_array_equal(slab[0].float().numpy(),
                                  np.asarray(staged.astype(jnp.float32)))
    zeroed = J.swap_unpack(jpool, jnp.zeros_like(staged), jids,
                           interpret=True)
    tzeroed = swap_unpack_ref(tpool.clone(), torch.zeros_like(slab), tids)
    np.testing.assert_array_equal(tzeroed[0].float().numpy(),
                                  np.asarray(zeroed.astype(jnp.float32)))
    restored = swap_unpack_ref(tzeroed, slab, tids)
    assert torch.equal(restored, tpool)


def test_swap_stager_cpu_roundtrip_over_stacked_pools():
    """The stager over a pool pytree stacked over 3 layer periods: pack,
    collect, clobber, unpack restores every leaf exactly; on the CPU the
    kernels' launch counts do not move."""
    rng = np.random.default_rng(4)
    pools = ({"b0": {"k": _t(rng.normal(size=(3, 10, 4, 2, 8))
                             .astype(np.float32)),
                     "v": _t(rng.normal(size=(3, 10, 4, 2, 8))
                             .astype(np.float32))}},)
    orig = {k: v.clone() for k, v in pools[0]["b0"].items()}
    launches = (swap_pack.launches, swap_unpack.launches)
    st = SwapStager()
    ticket = st.pack(pools, [7, 2, 5])
    assert st.inflight == 1
    host = st.collect(ticket)
    assert st.inflight == 0 and host[0]["b0"]["k"].shape == (3, 3, 4, 2, 8)
    for leaf in pools[0]["b0"].values():
        leaf[:, [7, 2, 5]] = 0.0
    st.unpack(pools, [7, 2, 5], slab_pages(host, 3))
    for k in orig:
        assert torch.equal(pools[0]["b0"][k], orig[k])
    assert (st.packed_pages, st.collected_pages, st.unpacked_pages) == \
        (3, 3, 3)
    assert (swap_pack.launches, swap_unpack.launches) == launches
    with pytest.raises(KeyError):
        st.collect(ticket)
    with pytest.raises(ValueError):
        st.pack(pools, [10])


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain versions, launchers refuse them
# ---------------------------------------------------------------------------
def test_ops_dispatch_cpu_to_plain_versions():
    rng = np.random.default_rng(5)
    q, kp, vp, bt, ts, tp = map(_t, _ragged_inputs(rng, 3, 2, 2, 32, 8, 4,
                                                   16, 1))
    before = ragged_paged_attention.launches
    out = ops.ragged_paged_attention_op(q, kp, vp, bt, ts, tp)
    assert torch.equal(out, ragged_paged_attention_ref(q, kp, vp, bt, ts, tp))
    assert ragged_paged_attention.launches == before
    # quantized pools with their scales take the dequantizing plain version
    kq, vq = kp.clamp(-1, 1).mul(127).round().to(torch.int8), \
        kp.mul(100).round().to(torch.int8)
    ks = torch.rand(kp.shape[0], kp.shape[2])
    out = ops.ragged_paged_attention_op(q, kq, vq, bt, ts, tp, k_scale=ks,
                                        v_scale=ks)
    assert torch.equal(out, ragged_paged_attention_quant_ref(
        q, kq, vq, ks, ks, bt, ts, tp))
    assert ragged_paged_attention.launches == before


@pytest.mark.parametrize("launcher", ["ragged", "kv_append", "swap_pack",
                                      "swap_unpack", "swap_pack_tree",
                                      "swap_unpack_tree"])
def test_kernel_launchers_refuse_cpu_tensors(launcher):
    """A wrapper launches its kernel or raises; it never falls back."""
    z = torch.zeros
    i32 = torch.int32
    calls = {
        "ragged": lambda: ragged_paged_attention(
            z(1, 1, 1, 32), z(2, 4, 1, 32), z(2, 4, 1, 32),
            z(1, 2, dtype=i32), z(1, dtype=i32), z(1, dtype=i32)),
        "kv_append": lambda: kv_append(
            z(2, 4, 1, 32), z(2, 4, 1, 32), z(1, 1, 32), z(1, 1, 32),
            z(1, dtype=i32), z(1, dtype=i32), z(1, dtype=i32)),
        "swap_pack": lambda: swap_pack(z(1, 4, 8), z(2, dtype=i32)),
        "swap_unpack": lambda: swap_unpack(z(1, 4, 8), z(1, 2, 8),
                                           z(2, dtype=i32)),
        "swap_pack_tree": lambda: swap_pack_tree(
            [z(1, 4, 8)], z(2, dtype=i32), z(64, dtype=torch.uint8)),
        "swap_unpack_tree": lambda: swap_unpack_tree(
            [z(1, 4, 8)], z(64, dtype=torch.uint8), z(2, dtype=i32)),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[launcher]()


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (9, None),
                                            (None, 30.0)])
def test_gpu_ragged_kernel_matches_plain(cuda, dtype, window, softcap):
    rng = np.random.default_rng(11)
    td = TORCH_DTYPES[dtype]
    q, kp, vp, bt, ts, tp = _ragged_inputs(rng, 40, 8, 4, 64, 16, 16, 128,
                                           5)
    tp[-3:] = -1
    args = [_t(q, td), _t(kp, td), _t(vp, td), _t(bt), _t(ts), _t(tp)]
    args = [a.to(cuda) for a in args]
    before = ragged_paged_attention.launches
    got = ops.ragged_paged_attention_op(*args, window=window,
                                        softcap=softcap)
    want = ragged_paged_attention_ref(*args, window=window, softcap=softcap)
    assert ragged_paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               atol=1e-4 if dtype == "float32" else 3e-2,
                               rtol=0)
    assert torch.all(got[-3:] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kv_append_matches_plain(cuda, dtype):
    td = TORCH_DTYPES[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    kp = torch.randn((32, 16, 8, 64), generator=g, device=cuda).to(td)
    vp = torch.randn_like(kp)
    kn = torch.randn((20, 8, 64), generator=g, device=cuda).to(td)
    slots = torch.randperm(32 * 16, generator=g, device=cuda)[:20]
    ids, offs = (slots // 16).int(), (slots % 16).int()
    valid = torch.randint(0, 2, (20,), generator=g, device=cuda).int()
    want = kv_append_ref(kp.clone(), vp.clone(), kn, kn, ids, offs, valid)
    got = ops.kv_append_op(kp, vp, kn, kn, ids, offs, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,R", [(32, 16), (512, 64)])
def test_gpu_kv_append_latent_widths_match_plain(cuda, dtype, L, R):
    """MLA's append: c and kr rows of their own widths in one launch,
    padded rows dropped; byte for byte the plain version's."""
    td = TORCH_DTYPES[dtype]
    g = torch.Generator(device=cuda).manual_seed(2)
    cp = torch.randn((32, 16, 1, L), generator=g, device=cuda).to(td)
    kp = torch.randn((32, 16, 1, R), generator=g, device=cuda).to(td)
    cn = torch.randn((20, 1, L), generator=g, device=cuda).to(td)
    kn = torch.randn((20, 1, R), generator=g, device=cuda).to(td)
    slots = torch.randperm(32 * 16, generator=g, device=cuda)[:20]
    ids, offs = (slots // 16).int(), (slots % 16).int()
    valid = torch.randint(0, 2, (20,), generator=g, device=cuda).int()
    want = kv_append_ref(cp.clone(), kp.clone(), cn, kn, ids, offs, valid)
    before = kv_append.launches
    got = ops.kv_append_op(cp, kp, cn, kn, ids, offs, valid)
    assert kv_append.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_gpu_swap_stager_roundtrip(cuda):
    """Pack on the compute stream, host copy on the copy stream, collect,
    clobber, unpack: exact; each kernel launched once for the whole tree,
    and the collected slab is one pinned buffer."""
    g = torch.Generator(device=cuda).manual_seed(1)
    pools = ({"b0": {"k": torch.randn((4, 64, 16, 8, 64), generator=g,
                                      device=cuda).bfloat16(),
                     "v": torch.randn((4, 64, 16, 8, 64), generator=g,
                                      device=cuda).bfloat16()}},)
    orig = {k: v.clone() for k, v in pools[0]["b0"].items()}
    before = (swap_pack.launches, swap_unpack.launches)
    st = SwapStager()
    ids = [3, 60, 17, 8]
    host = st.collect(st.pack(pools, ids))
    assert host[0]["b0"]["k"].is_pinned()
    for leaf in pools[0]["b0"].values():
        leaf[:, ids] = 0
    st.unpack(pools, ids, slab_pages(host, len(ids)))
    torch.cuda.synchronize()
    for k in orig:
        assert torch.equal(pools[0]["b0"][k], orig[k])
    assert (swap_pack.launches, swap_unpack.launches) == \
        (before[0] + 1, before[1] + 1)
