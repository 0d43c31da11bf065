"""The port's quantized KV pools (DESIGN.md §17), held against the JAX
reference on the CPU, and its kernels against their plain versions on a
card.

* Kernel level, exact: the port's ``kv_append_quant_ref`` equals the JAX
  ``kv_append_quant`` (Pallas, ``interpret=True``, as
  ``tests/test_quantized_kv.py`` runs it) on every page but the Pallas
  path's write-discard page, and ``ref.kv_append_quant_ref`` on every
  page, for int8, float8_e4m3 and float8_e5m2: payload bytes through a
  uint8 view, scales exactly. The rounds cover duplicate page ids,
  invalid rows, zero-scale pages and a scale that grows mid-page.
* Kernel level, attention: ``ragged_paged_attention_quant_ref`` and
  ``paged_attention_quant_ref`` against the reference's within 1e-5 in
  float32 (the two sum in another order).
* Model level: ``forward_mixed_paged``, ``decode_step_paged`` and
  ``extend_step_paged`` over int8 pools against the JAX model on bridged
  weights: logits within 1e-4 (as ``tests/test_torch_model.py``; 5e-4
  for the extend, whose chunks rescale every page they touch, so the
  scales' difference below moves whole pages of old rows), greedy ids
  equal, scales within 2e-5 relative (the amax of K/V rows whose
  products XLA and PyTorch sum in other orders; the float pools' 2e-5 of
  ``tests/test_torch_model.py``), payload within one quantization step (a
  row value on a rounding edge may land on either side).
* Engine level: ``Engine(kv_dtype=...)`` equals the JAX engine in greedy
  streams, counters, scheduler stats, ledger causes, clock and
  ``kv_token_bytes`` on the tiny llama agent workload, prefix cache on,
  and ends with no stale scales and, once the cache is emptied, every
  page free.
* The teacher-forced int8 logit check of ``tests/test_quantized_kv.py``,
  calibrated: the port's worst error/spread ratio equals the reference's
  measured ratio on the same weights and tokens within 1e-4 relative.
* On a CUDA card (``-m gpu``): ``page_requant`` and the fused
  ``kv_append_quant`` kernel bit for bit against their plain versions, the scaled attention kernels
  within 1e-4 (float32 q) and 3e-2 (bf16 q). The card's machine has no
  JAX, so the reference is imported inside the CPU tests only and the card
  runs this file alone: ``PYTHONPATH=src python -m pytest -q
  --noconftest -m gpu tests/test_torch_kv_quant.py``.
"""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.kv_quant import (KV_QUANT_DTYPES,
                                          attention_pool_code,
                                          dequant_gathered, gather_pages,
                                          kv_append_quant,
                                          kv_append_quant_ref,
                                          kv_quant_dtype, kv_quant_qmax,
                                          page_requant, page_requant_ref,
                                          quantize_rows)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_quant_ref)
from repro_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_quant_ref)
from repro_torch.kernels.swap_pack import SwapStager, slab_pages

ALL_KV_DTYPES = sorted(KV_QUANT_DTYPES)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them and slow these
    tests many times over, so each worker's torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """The JAX reference, imported where a CPU test needs it."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jq
    from repro.kernels import ref
    from repro.kernels.paged_attention import paged_attention as jpaged
    from repro.kernels.ragged_paged_attention import \
        ragged_paged_attention as jragged
    return SimpleNamespace(jax=jax, jnp=jnp, q=jq, ref=ref, paged=jpaged,
                           ragged=jragged)


def _u8(x) -> np.ndarray:
    """Payload bytes of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _to_jax(t: torch.Tensor):
    """torch -> JAX through a numpy copy (float8 through its bytes): on
    the CPU a JAX array may alias the numpy buffer, and JAX runs
    asynchronously, so an in-place torch update after the call must not
    reach the array."""
    J = _jax()
    if t.element_size() == 1 and t.dtype != torch.int8:
        jd = {torch.float8_e4m3fn: J.jnp.float8_e4m3fn,
              torch.float8_e5m2: J.jnp.float8_e5m2}[t.dtype]
        return J.jnp.asarray(t.view(torch.uint8).numpy().view(jd).copy())
    return J.jnp.asarray(t.numpy().copy())


# ---------------------------------------------------------------------------
# kernel level: the quantized append, exact
# ---------------------------------------------------------------------------
N_PAGES, PAGE, HKV, HD, DISCARD = 8, 4, 2, 16, 7
# duplicate pages within a call (0, 2), an invalid row, varying offsets;
# page 5 stays zero-scale until the third round, where page 0's scale
# grows mid-page (rows 8x larger land beside the first round's)
ROUNDS = [
    (np.array([0, 0, 2, 3, 2, 5]), np.array([0, 1, 2, 0, 3, 1]),
     np.array([1, 1, 1, 1, 1, 0]), 3.0),
    (np.array([2, 3, 3, 1, 6, 0]), np.array([0, 1, 2, 3, 0, 2]),
     np.array([1, 1, 1, 1, 0, 1]), 1.5),
    (np.array([0, 5, 0, 4]), np.array([3, 0, 0, 2]),
     np.array([1, 1, 1, 1]), 24.0),
]


def _rows(rng, n, mag):
    return (rng.normal(size=(n, HKV, HD)) * mag).astype(np.float32)


def _zero_port(qd):
    z = torch.zeros((N_PAGES, PAGE, HKV, HD), dtype=qd)
    s = torch.zeros((N_PAGES, HKV))
    return [z.clone(), z.clone(), s.clone(), s.clone()]


@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_kv_append_quant_ref_matches_jax(name):
    J = _jax()
    jnp = J.jnp
    qd = kv_quant_dtype(name)
    jd = J.q.kv_quant_jnp_dtype(name)
    port = _zero_port(qd)
    zk = jnp.zeros((N_PAGES, PAGE, HKV, HD), jd)
    zs = jnp.zeros((N_PAGES, HKV), jnp.float32)
    pal, ref = (zk, zk, zs, zs), (zk, zk, zs, zs)
    rng = np.random.default_rng(7)
    for pids, offs, valid, mag in ROUNDS:
        k_new, v_new = _rows(rng, len(pids), mag), _rows(rng, len(pids), mag)
        ids = [a.astype(np.int32) for a in (pids, offs, valid)]
        out = kv_append_quant_ref(*port, torch.from_numpy(k_new),
                                  torch.from_numpy(v_new),
                                  *map(torch.from_numpy, ids),
                                  discard_pid=DISCARD)
        assert all(a is b for a, b in zip(out, port))      # in place
        pal = J.q.kv_append_quant(*pal, jnp.asarray(k_new),
                                  jnp.asarray(v_new),
                                  *map(jnp.asarray, ids), DISCARD,
                                  interpret=True)
        ref = J.ref.kv_append_quant_ref(*ref, jnp.asarray(k_new),
                                        jnp.asarray(v_new),
                                        *map(jnp.asarray, ids))
    live = np.setdiff1d(np.arange(N_PAGES), [DISCARD])
    for i, label in ((0, "k"), (1, "v")):
        assert np.array_equal(_u8(port[i]), _u8(ref[i])), label
        assert np.array_equal(_u8(port[i])[live], _u8(pal[i])[live]), label
    for i in (2, 3):
        assert np.array_equal(port[i].numpy(), np.asarray(ref[i]))
        assert np.array_equal(port[i].numpy(), np.asarray(pal[i]))
    # the rounds did what they claim: a zero-scale page came alive late and
    # page 0's scale grew in the third round
    assert float(port[2][5].min()) > 0 and float(port[2][7].max()) == 0


@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_page_requant_ref_matches_jax(name):
    """Phase B alone: the first row naming a page rescales it; duplicates
    and out-of-range rows write nothing (the Pallas kernel sends them to
    the discard page, left out of the comparison)."""
    J = _jax()
    qd = kv_quant_dtype(name)
    rng = np.random.default_rng(3)
    qmax = kv_quant_qmax(qd)
    f = (rng.uniform(-1, 1, (N_PAGES, PAGE, HKV, HD)) * qmax)
    kp = quantize_rows(torch.from_numpy(f.astype(np.float32)),
                       torch.ones(N_PAGES, PAGE, HKV), qd)
    vp = quantize_rows(torch.from_numpy((f * 0.5).astype(np.float32)),
                       torch.ones(N_PAGES, PAGE, HKV), qd)
    pids = np.array([1, 4, 1, N_PAGES, 0, 4], np.int32)
    ratio_k = rng.uniform(0.05, 1.0, (6, HKV)).astype(np.float32)
    ratio_v = rng.uniform(0.05, 1.0, (6, HKV)).astype(np.float32)
    ratio_k[4] = 1.0                           # ratio 1 is the identity
    first = np.array([True, True, False, True, True, False])
    rpids = np.where(first & (pids < N_PAGES), pids, DISCARD).astype(np.int32)
    jk, jv = J.q.page_requant(_to_jax(kp), _to_jax(vp),
                              J.jnp.asarray(ratio_k), J.jnp.asarray(ratio_v),
                              J.jnp.asarray(rpids), interpret=True)
    before = _u8(kp).copy()
    page_requant_ref(kp, vp, torch.from_numpy(ratio_k),
                     torch.from_numpy(ratio_v), torch.from_numpy(pids),
                     discard_pid=DISCARD)
    live = np.setdiff1d(np.arange(N_PAGES), [DISCARD])
    assert np.array_equal(_u8(kp)[live], _u8(jk)[live])
    assert np.array_equal(_u8(vp)[live], _u8(jv)[live])
    assert np.array_equal(_u8(kp)[[0, 2, 3, DISCARD]],
                          before[[0, 2, 3, DISCARD]])


@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_kv_append_quant_dequant_recovers_rows(name):
    """Dequantizing the written slots recovers the rows within the
    reference's per-dtype envelope (tests/test_quantized_kv.py)."""
    bound = {"int8": 0.006, "float8_e4m3": 0.05, "float8_e5m2": 0.15}
    qd = kv_quant_dtype(name)
    kp, vp, ks, vs = _zero_port(qd)
    rows = torch.from_numpy(_rows(np.random.default_rng(4), 4, 3.0))
    pids = torch.tensor([1, 1, 2, 4], dtype=torch.int32)
    offs = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    kv_append_quant_ref(kp, vp, ks, vs, rows, rows, pids, offs,
                        torch.ones(4, dtype=torch.int32))
    deq = dequant_gathered(gather_pages(kp, pids.long()), ks[pids.long()])
    got = deq[torch.arange(4), offs.long()]
    rel = float((got - rows).abs().max() / rows.abs().max())
    assert rel < bound[name], rel


# ---------------------------------------------------------------------------
# kernel level: attention over quantized pools
# ---------------------------------------------------------------------------
def _quant_pools(rng, name, n_pages, page, Hkv, hd):
    qd = kv_quant_dtype(name)
    out = []
    for _ in range(2):
        f = torch.from_numpy(rng.normal(size=(n_pages, page, Hkv, hd))
                             .astype(np.float32))
        scale = f.abs().amax(dim=(1, 3)) / kv_quant_qmax(qd)
        out += [quantize_rows(f, scale[:, None], qd), scale]
    return out                                   # kq, kscale, vq, vscale


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 20.0)])
@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_ragged_quant_ref_matches_jax(name, window, softcap):
    J = _jax()
    rng = np.random.default_rng(9)
    N, Hkv, G, hd, page, n_pages = 5, 2, 2, 16, 4, 16
    q = rng.normal(size=(N, Hkv, G, hd)).astype(np.float32)
    kq, ks, vq, vs = _quant_pools(rng, name, n_pages, page, Hkv, hd)
    bt = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    tok_seq = np.array([0, 0, 0, 1, 1], np.int32)
    tok_pos = np.array([4, 5, 11, 0, -1], np.int32)
    got = ragged_paged_attention_quant_ref(
        torch.from_numpy(q), kq, vq, ks, vs, *map(torch.from_numpy,
                                                  (bt, tok_seq, tok_pos)),
        softcap=softcap, window=window).numpy()
    jargs = (J.jnp.asarray(q), _to_jax(kq), _to_jax(vq))
    kw = dict(softcap=softcap, window=window)
    want = J.ref.ragged_paged_attention_quant_ref(
        *jargs, _to_jax(ks), _to_jax(vs), *map(J.jnp.asarray,
                                               (bt, tok_seq, tok_pos)), **kw)
    pal = J.ragged(*jargs, *map(J.jnp.asarray, (bt, tok_seq, tok_pos)),
                   k_scale=_to_jax(ks), v_scale=_to_jax(vs), interpret=True,
                   **kw)
    live = tok_pos >= 0
    np.testing.assert_allclose(got[live], np.asarray(want)[live], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got[live], np.asarray(pal)[live], atol=1e-5,
                               rtol=0)
    assert np.all(got[~live] == 0.0)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 20.0)])
@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_paged_quant_ref_matches_jax(name, window, softcap):
    J = _jax()
    rng = np.random.default_rng(10)
    B, Hkv, G, hd, page, n_pages = 3, 2, 2, 16, 4, 16
    q = rng.normal(size=(B, Hkv, G, hd)).astype(np.float32)
    kq, ks, vq, vs = _quant_pools(rng, name, n_pages, page, Hkv, hd)
    bt = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    ctx = np.array([7, 12, 0], np.int32)
    got = paged_attention_quant_ref(
        torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(bt),
        torch.from_numpy(ctx), softcap=softcap, window=window).numpy()
    jargs = (J.jnp.asarray(q), _to_jax(kq), _to_jax(vq))
    kw = dict(softcap=softcap, window=window)
    want = J.ref.paged_attention_quant_ref(
        *jargs, _to_jax(ks), _to_jax(vs), J.jnp.asarray(bt),
        J.jnp.asarray(ctx), **kw)
    pal = J.paged(*jargs, J.jnp.asarray(bt), J.jnp.asarray(ctx),
                  k_scale=_to_jax(ks), v_scale=_to_jax(vs), interpret=True,
                  **kw)
    live = ctx > 0
    np.testing.assert_allclose(got[live], np.asarray(want)[live], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got[live], np.asarray(pal)[live], atol=1e-5,
                               rtol=0)
    assert np.all(got[~live] == 0.0)


def test_quant_ops_dispatch_cpu_to_plain_versions():
    rng = np.random.default_rng(2)
    kq, ks, vq, vs = _quant_pools(rng, "int8", 16, 4, 2, 16)
    q = torch.from_numpy(rng.normal(size=(2, 2, 2, 16)).astype(np.float32))
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    ctx = torch.tensor([9, 3], dtype=torch.int32)
    before = (paged_attention.launches, ragged_paged_attention.launches,
              page_requant.launches, kv_append_quant.launches)
    got = ops.paged_attention_op(q, kq, vq, bt, ctx, k_scale=ks, v_scale=vs)
    assert torch.equal(got, paged_attention_quant_ref(q, kq, vq, ks, vs, bt,
                                                      ctx))
    seq = torch.arange(2, dtype=torch.int32)
    got = ops.ragged_paged_attention_op(q, kq, vq, bt, seq, ctx - 1,
                                        k_scale=ks, v_scale=vs)
    assert torch.equal(got, ragged_paged_attention_quant_ref(
        q, kq, vq, ks, vs, bt, seq, ctx - 1))
    rows = torch.ones(2, 2, 16)
    ids = torch.tensor([3, 3], dtype=torch.int32)
    offs = torch.tensor([0, 1], dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.int32)
    pools = [t.clone() for t in (kq, vq, ks, vs)]
    want = kv_append_quant_ref(*pools, rows, rows, ids, offs, ones)
    pools = [t.clone() for t in (kq, vq, ks, vs)]
    got = ops.kv_append_quant_op(*pools, rows, rows, ids, offs, ones,
                                 discard_pid=15)
    assert all(torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b)
               for a, b in zip(got, want))
    assert (paged_attention.launches, ragged_paged_attention.launches,
            page_requant.launches, kv_append_quant.launches) == before


def test_quant_launchers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never falls back."""
    kq, ks, vq, vs = _quant_pools(np.random.default_rng(1), "int8", 4, 4, 1,
                                  32)
    i32 = torch.int32
    before = (page_requant.launches, paged_attention.launches,
              kv_append_quant.launches)
    with pytest.raises(ValueError, match="CUDA"):
        page_requant(kq, vq, torch.ones(1, 1), torch.ones(1, 1),
                     torch.zeros(1, dtype=i32))
    with pytest.raises(ValueError, match="CUDA"):
        kv_append_quant(kq, vq, ks, vs, torch.ones(1, 1, 32),
                        torch.ones(1, 1, 32), torch.zeros(1, dtype=i32),
                        torch.zeros(1, dtype=i32), torch.ones(1, dtype=i32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(torch.zeros(1, 1, 2, 32), kq, vq,
                        torch.zeros(1, 2, dtype=i32),
                        torch.ones(1, dtype=i32), k_scale=ks, v_scale=vs)
    assert (page_requant.launches, paged_attention.launches,
            kv_append_quant.launches) == before


def test_attention_pool_code_checks_scales():
    kq, ks, vq, vs = _quant_pools(np.random.default_rng(1), "float8_e5m2",
                                  4, 4, 2, 32)
    q = torch.zeros(1, 2, 2, 32)
    assert attention_pool_code("x", q, kq, vq, ks, vs) == 3
    f = torch.zeros(4, 4, 2, 32)
    assert attention_pool_code("x", q, f, f, None, None) == 0
    with pytest.raises(ValueError, match="k_scale"):
        attention_pool_code("x", q, kq, vq, None, None)
    with pytest.raises(ValueError, match="k_scale"):
        attention_pool_code("x", q, kq, vq, ks[:, :1], vs)
    with pytest.raises(ValueError, match="scales go with"):
        attention_pool_code("x", q, f, f, ks, vs)
    with pytest.raises(TypeError):
        attention_pool_code("x", q.bfloat16(), f, f, None, None)


# ---------------------------------------------------------------------------
# model level: int8 pools through the three paged entry points
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    J = _jax()
    from repro.configs import get_config as jax_config
    from repro.models import LM as JaxLM
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import from_jax_params
    jcfg = jax_config("llama3.2-1b", tiny=True)
    cfg = get_config("llama3.2-1b", tiny=True)
    jm = JaxLM(jcfg)
    jparams = jm.init(J.jax.random.PRNGKey(0), dtype=J.jnp.float32)
    params = from_jax_params(J.jax.tree.map(np.asarray, jparams), cfg)
    return cfg, jm, jparams, params


def _int8_pools(rng, cfg, n_pages, page):
    """Random int8 payload and positive scales in the port's layout, and
    the same as a JAX tree."""
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_map
    zeros = LM(cfg).init_cache(n_pages, page, dtype=torch.float32,
                               device="cpu", kv_dtype="int8")

    def fill(z):
        if z.dtype == torch.int8:
            return torch.from_numpy(rng.integers(-127, 128, z.shape)
                                    .astype(np.int8))
        return torch.from_numpy(rng.uniform(0.02, 0.1, z.shape)
                                .astype(np.float32))
    pools = tree_map(fill, zeros)
    jpools = tuple({b: {k: _to_jax(v) for k, v in p.items()}
                    for b, p in g.items()} for g in pools)
    return pools, jpools


def _check_quant_pools(j_pools, t_pools, before):
    from repro_torch.utils.tree import tree_leaves
    J = _jax()
    for jl, tl, b in zip(J.jax.tree.leaves(j_pools), tree_leaves(t_pools),
                         tree_leaves(before)):
        want = np.asarray(jl)
        got = tl.numpy()
        if tl.dtype == torch.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
        assert not np.array_equal(got, b.numpy())       # written


def _run_both(tiny, seed, fn_name, args, **kw):
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_map
    cfg, jm, jparams, params = tiny
    J = _jax()
    rng = np.random.default_rng(seed)
    pools, jpools = _int8_pools(rng, cfg, 48, 16)
    before = tree_map(torch.clone, pools)
    jout = getattr(jm, fn_name)(jparams, *map(J.jnp.asarray, args[0]),
                                jpools, J.jnp.asarray(args[1]),
                                **{k: J.jnp.asarray(v) for k, v in kw.items()})
    tout = getattr(LM(cfg), fn_name)(
        params, *map(torch.from_numpy, args[0]), pools,
        torch.from_numpy(args[1]),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    return jout, tout, pools, before


def test_forward_mixed_paged_int8_matches_jax(tiny):
    cfg = tiny[0]
    rng = np.random.default_rng(0)
    bt = rng.permutation(48)[:4 * 8].reshape(4, 8).astype(np.int32)
    tok_seq = np.array([0] * 6 + [1] * 5 + [2] + [0] * 4, np.int32)
    tok_pos = np.array(list(range(20, 26)) + list(range(5)) + [77]
                       + [-1] * 4, np.int32)
    tokens = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    q_last = np.array([5, 10, 11, 0], np.int32)
    jm_call = (tokens, tok_seq, tok_pos, q_last)
    jout, tout, pools, before = _run_both(tiny, 1, "forward_mixed_paged",
                                          (jm_call, bt))
    j_ids, j_logits, j_pools = jout
    t_ids, t_logits, _ = tout
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    _check_quant_pools(j_pools, pools, before)


def test_decode_step_paged_int8_matches_jax(tiny):
    cfg = tiny[0]
    rng = np.random.default_rng(2)
    bt = rng.permutation(48)[:4 * 8].reshape(4, 8).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    ctx_lens = np.array([77, 16, 1, 0], np.int32)
    jout, tout, pools, before = _run_both(tiny, 3, "decode_step_paged",
                                          ((tokens, ctx_lens), bt))
    np.testing.assert_allclose(tout[0][:3].numpy(), np.asarray(jout[0])[:3],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tout[0][:3].argmax(-1).numpy(),
                                  np.asarray(jout[0])[:3].argmax(-1))
    _check_quant_pools(jout[1], pools, before)


def test_extend_step_paged_int8_matches_jax(tiny):
    cfg = tiny[0]
    rng = np.random.default_rng(4)
    bt = rng.permutation(48)[:2 * 8].reshape(2, 8).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    start = np.array([29, 0], np.int32)
    n_new = np.array([5, 8], np.int32)
    jout, tout, pools, before = _run_both(
        tiny, 5, "extend_step_paged", ((tokens, start, n_new), bt),
        logits_index=np.array([4, 7], np.int32))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=5e-4, rtol=0)
    _check_quant_pools(jout[1], pools, before)


def test_init_cache_quantized_layout(tiny):
    """The JAX tree's leaves, in its (sorted-key) order, shapes and
    dtypes; kv_dtype=None grows no scale leaves."""
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_leaves
    cfg, jm, _, _ = tiny
    J = _jax()
    for name in ALL_KV_DTYPES:
        jp = jm.init_cache(10, 16, kv_dtype=name)
        tp = LM(cfg).init_cache(10, 16, dtype=torch.float32, device="cpu",
                                kv_dtype=name)
        assert list(tp[0]["b0"]) == ["k", "k_scale", "v", "v_scale"]
        for jl, tl in zip(J.jax.tree.leaves(jp), tree_leaves(tp)):
            assert tuple(jl.shape) == tuple(tl.shape)
            assert tl.element_size() == np.dtype(jl.dtype).itemsize
        assert tp[0]["b0"]["k"].dtype == kv_quant_dtype(name)
    plain = LM(cfg).init_cache(10, 16, dtype=torch.float32, device="cpu")
    assert list(plain[0]["b0"]) == ["k", "v"]


def test_teacher_forced_int8_logit_ratio_matches_reference(tiny):
    """The body of the reference's teacher-forced check on both sides:
    the same token fed at every step into float and int8 pools, worst
    max|logit error| / logit spread. The reference's own 0.12 bound does
    not hold on this tree (its test measures 0.1357 in the config's
    bf16), so the port is held to the reference's measured ratio, within
    1e-4 relative. Both run in float32: in bf16 the two frameworks'
    logits part by a bf16 unit in the last place (1.6e-2 at magnitude 4),
    as large as the errors measured, so only float32 isolates the int8
    pools' effect (the reference's body measures 0.1351 there)."""
    from repro_torch.models.model import LM
    cfg, jm, jparams, params = tiny
    J = _jax()
    jnp = J.jnp
    n_pages, page, B, T = 16, 4, 2, 10
    bt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (B, T)).astype(np.int32)
    lm = LM(cfg)
    j_f = jm.init_cache(n_pages, page, dtype=jnp.float32)
    j_q = jm.init_cache(n_pages, page, dtype=jnp.float32, kv_dtype="int8")
    t_f = lm.init_cache(n_pages, page, dtype=torch.float32, device="cpu")
    t_q = lm.init_cache(n_pages, page, dtype=torch.float32, device="cpu",
                        kv_dtype="int8")
    worst_j = worst_t = 0.0
    for t in range(T):
        ctx = np.full((B,), t + 1, np.int32)
        lf, j_f = jm.decode_step_paged(jparams, jnp.asarray(toks[:, t]),
                                       jnp.asarray(ctx), j_f, jnp.asarray(bt))
        lq, j_q = jm.decode_step_paged(jparams, jnp.asarray(toks[:, t]),
                                       jnp.asarray(ctx), j_q, jnp.asarray(bt))
        err = float(jnp.max(jnp.abs(lf - lq)))
        worst_j = max(worst_j, err / max(float(jnp.max(lf) - jnp.min(lf)),
                                         1e-6))
        args = (torch.from_numpy(toks[:, t]), torch.from_numpy(ctx))
        tf, _ = lm.decode_step_paged(params, *args, t_f,
                                     torch.from_numpy(bt))
        tq, _ = lm.decode_step_paged(params, *args, t_q,
                                     torch.from_numpy(bt))
        err = float((tf - tq).abs().max())
        worst_t = max(worst_t, err / max(float(tf.max() - tf.min()), 1e-6))
    assert worst_j > 0.1                   # the reference's measured ~0.136
    assert abs(worst_t - worst_j) <= 1e-4 * worst_j, (worst_t, worst_j)


# ---------------------------------------------------------------------------
# engine level: Engine(kv_dtype=...) against the JAX engine
# ---------------------------------------------------------------------------
ENGINE_KW = dict(page_size=16, n_pages=128, max_model_len=256,
                 prefix_cache=True)
# tests/test_quantized_kv.py's workload (_workload)
WORKLOAD_KW = dict(seed=5, n_sessions=2, rate_rps=2.0, n_templates=2,
                   system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
                   hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
                   final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2,
                   max_ctx=240)


@pytest.fixture(scope="module")
def engine_setup(tiny):
    from repro_torch.serving.workloads import make_agent_workload
    cfg, _, _, params = tiny
    return cfg, params, make_agent_workload(vocab=cfg.vocab_size,
                                            **WORKLOAD_KW)


@pytest.mark.parametrize("policy,fused,kv_dtype", [
    ("infercept", True, "int8"), ("swap", True, "int8"),
    ("infercept", False, "int8"), ("swap", False, "int8"),
    ("infercept", True, "float8_e4m3")])
def test_port_quant_engine_matches_jax_engine(engine_setup, policy, fused,
                                              kv_dtype):
    from repro.configs import get_config as jax_config
    from repro.core import POLICIES as JAX_POLICIES
    from repro.serving.engine import Engine as JaxEngine
    from repro.serving.workloads import make_agent_workload as jax_workload
    from repro_torch.core import POLICIES
    from repro_torch.obs.metrics import SCHED_COUNTER_SCHEMA
    from repro_torch.serving.engine import Engine
    from repro_torch.utils.hw import TPU_V5E
    cfg, params, reqs = engine_setup
    jcfg = jax_config("llama3.2-1b", tiny=True)
    jeng = JaxEngine(jcfg, JAX_POLICIES[policy], seed=0, fused=fused,
                     kv_dtype=kv_dtype, **ENGINE_KW)
    for r in jax_workload(vocab=jcfg.vocab_size, **WORKLOAD_KW):
        jeng.add_request(r)
    jfin = jeng.run(strict=True)
    eng = Engine(cfg, POLICIES[policy], params=params, chip=TPU_V5E,
                 device="cpu", fused=fused, kv_dtype=kv_dtype, **ENGINE_KW)
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    fin = eng.run(strict=True)
    assert len(fin) == len(reqs)
    assert {r.rid: eng.generated_text(r) for r in fin} == \
        {r.rid: jeng.generated_text(r) for r in jfin}
    assert dict(eng.counters) == dict(jeng.counters)
    assert {f: getattr(eng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA} \
        == {f: getattr(jeng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA}
    assert eng.ledger.causes == jeng.ledger.causes
    assert eng.now == jeng.now
    assert eng.kv_token_bytes == jeng.kv_token_bytes
    for key in ("kv_quant_scale_reset_pages", "kv_quant_scale_cow_pages",
                "swap_bytes"):
        assert eng.counters[key] > 0, key
    # lifecycle: no freed page keeps a scale, before and after the cache
    # lets go of its pages, and then every page but the scratch is free
    assert eng._stale_scale_pages() == []
    eng.cache.evict(eng.blocks.n_pages)
    assert eng._stale_scale_pages() == []
    assert eng.blocks.num_free == eng.blocks.n_pages - 1
    assert eng.stager.inflight == 0


def test_engine_kv_dtype_validation(engine_setup):
    from repro_torch.core import POLICIES
    from repro_torch.serving.engine import Engine
    cfg, params, _ = engine_setup
    kw = dict(params=params, device="cpu", page_size=16, n_pages=32,
              max_model_len=64)
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        Engine(cfg, POLICIES["infercept"], kv_dtype="int4", **kw)
    with pytest.raises(ValueError, match="requires the paged engine"):
        Engine(cfg, POLICIES["infercept"], kv_dtype="int8", paged=False,
               **kw)
    eng = Engine(cfg, POLICIES["infercept"], kv_dtype="int8", **kw)
    assert eng.cost.kv_dtype == "int8"
    base = Engine(cfg, POLICIES["infercept"], **kw)
    # Eq. 5 prices the quantized pool: M follows the 1-byte payload
    assert 2 * eng.cost.m_bytes == base.cost.m_bytes   # bf16 -> int8
    assert 2 * eng.kv_token_bytes <= base.kv_token_bytes


def test_swap_stager_carries_scale_leaves():
    """A quantized pool tree through pack, collect and unpack on the CPU:
    payload bytes and scales back exactly, one slab leaf per pool leaf."""
    from repro_torch.models.model import LM
    from repro_torch.configs import get_config
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = get_config("llama3.2-1b", tiny=True)
    gen = torch.Generator().manual_seed(0)
    pools = tree_map(
        lambda z: (torch.randn(z.shape, generator=gen) * 50).to(z.dtype),
        LM(cfg).init_cache(12, 4, dtype=torch.float32, device="cpu",
                           kv_dtype="float8_e4m3"))
    want = tree_map(torch.clone, pools)
    st = SwapStager()
    slab = st.collect(st.pack(pools, [3, 7, 1]))
    assert [tuple(x.shape) for x in tree_leaves(slab)] == [
        (x.shape[0], 3, *x.shape[2:]) for x in tree_leaves(pools)]
    for leaf in tree_leaves(pools):
        leaf[:, [3, 7, 1]] = 0
    st.unpack(pools, [3, 7, 1], slab_pages(slab, 3))
    for a, b in zip(tree_leaves(pools), tree_leaves(want)):
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b)


@pytest.mark.parametrize("phase", ["quant", "quant_unfused"])
def test_chip_smoke_quant_serve_rehearsal(phase):
    """chip_smoke.py's int8 serve phases, rehearsed at the tiny config on
    the CPU: every request finishes, pages come back with zero scales, the
    kv_token_bytes of int8 pools, and the recorder keeps the quantized
    calls under their own keys for the timing phase."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    policy, kw = chip_smoke.SERVE_PHASES[phase]
    rec = chip_smoke.Recorder()
    res = chip_smoke.serve(policy, rec, tiny=True, device="cpu", **kw)
    assert res["finished"] == res["requests"]
    assert res["stale_scale_pages"] == [] and res["kv_dtype"] == "int8"
    assert res["swapped_out_tokens"] == res["swapped_in_tokens"] > 0
    attention = "ragged_paged_attention" if kw.get("fused", True) \
        else "paged_attention"
    assert {"kv_append_quant", f"{attention}_int8"} <= set(rec.calls)
    assert "kv_append" not in rec.calls
    assert chip_smoke.row_key(attention, "int8") in chip_smoke.KERNELS
    assert all(v == 0 for v in res["launches"].values())


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_quant_state(cuda, name, n_pages=64, page=16, Hkv=8, hd=64, N=40):
    """Pools half written by a first append, then rows for a second one
    with duplicate pages, invalid rows and larger magnitudes."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qd = kv_quant_dtype(name)
    kp = torch.zeros((n_pages, page, Hkv, hd), dtype=qd, device=cuda)
    vp = torch.zeros_like(kp)
    ks = torch.zeros((n_pages, Hkv), device=cuda)
    vs = torch.zeros_like(ks)
    slots = torch.randperm(n_pages * page, generator=gen, device=cuda)
    i32 = torch.int32

    def batch(sl, mag):
        n = sl.numel()
        rows = [torch.randn((n, Hkv, hd), generator=gen, device=cuda) * mag
                for _ in range(2)]
        valid = (torch.rand(n, generator=gen, device=cuda) > 0.2).to(i32)
        return (*rows, (sl // page).to(i32), (sl % page).to(i32), valid)
    kv_append_quant_ref(kp, vp, ks, vs, *batch(slots[:N * 8], 2.0))
    return (kp, vp, ks, vs), batch(slots[N * 8:N * 9], 6.0)


def _same(a, b):
    return all(torch.equal(x.view(torch.uint8) if x.element_size() == 1
                           else x, y.view(torch.uint8)
                           if y.element_size() == 1 else y)
               for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_gpu_kv_append_quant_bit_exact(cuda, name):
    pools, rows = _card_quant_state(cuda, name)
    want = kv_append_quant_ref(*[t.clone() for t in pools], *rows)
    before = (kv_append_quant.launches, page_requant.launches)
    got = ops.kv_append_quant_op(*[t.clone() for t in pools], *rows)
    torch.cuda.synchronize()
    # one fused launch; the standalone page_requant is not launched
    assert (kv_append_quant.launches, page_requant.launches) == \
        (before[0] + 1, before[1])
    assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_gpu_page_requant_bit_exact(cuda, name):
    (kp, vp, ks, vs), _ = _card_quant_state(cuda, name)
    gen = torch.Generator(device=cuda).manual_seed(1)
    N = 300
    pids = torch.randint(0, kp.shape[0] + 4, (N,), generator=gen,
                         device=cuda, dtype=torch.int32)  # some invalid
    kr = torch.rand((N, kp.shape[2]), generator=gen, device=cuda)
    vr = torch.rand((N, kp.shape[2]), generator=gen, device=cuda)
    want = page_requant_ref(kp.clone(), vp.clone(), kr, vr, pids)
    got = page_requant(kp.clone(), vp.clone(), kr, vr, pids)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_gpu_scaled_attention_kernels_match_plain(cuda, name, qdtype):
    (kp, vp, ks, vs), _ = _card_quant_state(cuda, name)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[qdtype]
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, G = 4, 4
    q = torch.randn((B, 8, G, 64), generator=gen, device=cuda).to(td)
    bt = torch.randint(0, kp.shape[0], (B, 4), generator=gen, device=cuda,
                       dtype=torch.int32)
    ctx = torch.tensor([1, 16, 64, 0], dtype=torch.int32, device=cuda)
    tol = 1e-4 if qdtype == "float32" else 3e-2
    got = paged_attention(q, kp, vp, bt, ctx, k_scale=ks, v_scale=vs)
    want = paged_attention_quant_ref(q, kp, vp, ks, vs, bt, ctx)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    seq = torch.arange(B, dtype=torch.int32, device=cuda)
    got = ragged_paged_attention(q, kp, vp, bt, seq, ctx - 1, k_scale=ks,
                                 v_scale=vs)
    want = ragged_paged_attention_quant_ref(q, kp, vp, ks, vs, bt, seq,
                                            ctx - 1)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert torch.all(got[-1] == 0)
