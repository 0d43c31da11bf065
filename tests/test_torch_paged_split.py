"""The decomposition behind the bf16 paged-attention kernels
(``csrc/paged_tc.cuh``), held two ways.

* On the CPU: the plain form of the tiling (``plan_tiles``,
  ``block_tiles``, ``tile_grid``) under hypothesis over random routings,
  and the split-KV decomposition (``attention_partials`` over a split of
  the keys, then ``merge_partials``) against the plain version and the
  JAX reference through Pallas interpret: random splits, splits that see
  no key, padded rows, quantized pools with the scales applied as the
  kernel applies them.
* On a CUDA card (``-m gpu``): both kernels at the sweep's tile and split
  edges against their plain versions. The card's machine has no JAX:
  ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_paged_split.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.kv_quant import (KV_QUANT_DTYPES, kv_quant_dtype,
                                          kv_quant_qmax, quantize_rows)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_quant_ref,
                                                 paged_attention_ref)
from repro_torch.kernels.ragged_paged_attention import (
    MAX_SPLITS, STAGE_KEYS, attention_partials, block_tiles, merge_partials,
    plan_tiles, ragged_paged_attention, ragged_paged_attention_quant_ref,
    TILE_ROWS, _COUNTERS, ragged_paged_attention_ref,
    ragged_paged_attention_split_ref, split_count, split_key_bounds,
    tensor_cores, tile_grid, tile_tokens)

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
import hypothesis.strategies as st      # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per xdist worker, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The split decomposition against the plain version: the same float32
# scores, exponentials taken against each split's own max and rescaled by
# the merge, sums in another order: within a few float32 units.
SPLIT_TOL = 2e-6
# against the JAX reference through Pallas interpret, as
# tests/test_torch_kernels.py holds the plain version
JAX_TOL = 2e-5


def _jax():
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.ragged_paged_attention import ragged_paged_attention
    return SimpleNamespace(jnp=jnp, ragged=ragged_paged_attention, ref=ref)


def _inputs(seed, *, N, B, Hkv=2, G=4, hd=16, page=4, max_pages=24,
            n_pages=64, tok_seq=None, tok_pos=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    q, kp, vp = f(N, Hkv, G, hd), f(n_pages, page, Hkv, hd), \
        f(n_pages, page, Hkv, hd)
    bt = torch.from_numpy(rng.integers(0, n_pages, (B, max_pages))
                          .astype(np.int32))
    if tok_seq is None:
        tok_seq = rng.integers(0, B, N)
    if tok_pos is None:
        tok_pos = rng.integers(0, page * max_pages, N)
    return (q, kp, vp, bt, torch.tensor(tok_seq, dtype=torch.int32),
            torch.tensor(tok_pos, dtype=torch.int32))


def _layout(lens, starts, pad=0):
    """Each sequence's rows consecutive, then padded rows, as the engine
    lays out a mixed iteration."""
    seq = [b for b, n in enumerate(lens) for _ in range(n)] + [0] * pad
    pos = [s + i for n, s in zip(lens, starts) for i in range(n)] + \
        [-1] * pad
    return seq, pos


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the tiling
# ---------------------------------------------------------------------------
routings = st.integers(1, 6).flatmap(lambda B: st.tuples(
    st.just(B), st.lists(st.integers(0, B - 1), min_size=1, max_size=80)))


@settings(max_examples=200, deadline=None)
@given(routings, st.sampled_from([1, 2, 3, 4, 8, 16, 64]),
       st.integers(1, 200))
def test_plan_tiles_cover_each_row_once_within_one_sequence(routing, G,
                                                            grid):
    """Any tok_seq, unsorted included: the tiles partition the rows, none
    crosses a sequence or holds more than tile_tokens(G) rows, and the
    grid's blocks take every tile exactly once with no block past the
    grid."""
    _, seq = routing
    tq = tile_tokens(G)
    tiles = plan_tiles(seq, tq)
    rows = [n for a, b in tiles for n in range(a, b)]
    assert rows == list(range(len(seq)))
    for a, b in tiles:
        assert 1 <= b - a <= tq and len(set(seq[a:b])) == 1
    taken = block_tiles(len(tiles), grid)
    assert len(taken) <= grid
    assert sorted(t for ts in taken for t in ts) == list(range(len(tiles)))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(1, 300), min_size=1, max_size=16),
       st.sampled_from([1, 2, 4, 8, 16]), st.integers(0, 64))
def test_tile_grid_bounds_the_engine_layout(lens, G, pad):
    """The engine's layout (each sequence's rows consecutive, padding
    last, B block-table rows): the tiles never exceed tile_grid, so each
    block takes one tile; padded rows may share the last sequence's id."""
    seq, _ = _layout(lens, [0] * len(lens), pad)
    N, B = len(seq), len(lens)
    assert len(plan_tiles(seq, tile_tokens(G))) <= tile_grid(N, G, B) <= N


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 4096), st.integers(1, 4096), st.integers(1, 200))
def test_split_count_limits(blocks, keys, n_sm):
    """At least one split, at most one per stage and MAX_SPLITS, and none
    for a grid that fills the card."""
    s = split_count(blocks, keys, n_sm)
    assert 1 <= s <= min(MAX_SPLITS, -(-keys // STAGE_KEYS))
    if blocks >= 2 * n_sm:
        assert s == 1


def test_split_count_at_the_serve_shapes():
    """llama3.2-1b on 132 SMs (Hkv 8, a 64-page x 16-slot table): a B = 1
    decode splits 16 ways (one 64-key stage each), a decode-only bucket
    of 8 five ways, a 512-token mixed iteration not at all."""
    assert split_count(1 * 8, 1024, 132) == 16
    assert split_count(tile_grid(8, 4, 8) * 8, 1024, 132) == 5
    assert split_count(tile_grid(512, 4, 16) * 8, 1024, 132) == 1


# ---------------------------------------------------------------------------
# the split-KV decomposition
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_random_splits_merge_to_the_plain_version(seed):
    """Per-row random cuts of the keys (some splits empty, some past a
    row's context): the merged partials equal the plain version."""
    rng = np.random.default_rng(100 + seed)
    args = _inputs(seed, N=24, B=4)
    S = int(rng.integers(1, 9))
    keys = args[3].shape[1] * args[1].shape[1]
    cuts = np.sort(rng.integers(0, keys + 1, (24, S - 1)), axis=1)
    bounds = torch.from_numpy(np.concatenate(
        [np.zeros((24, 1)), cuts, np.full((24, 1), keys)], 1).astype(
            np.int64))
    window = [None, 7][seed % 2]
    got = merge_partials(*attention_partials(*args, bounds, window=window),
                         args[5], torch.float32)
    _close(got, ragged_paged_attention_ref(*args, window=window), SPLIT_TOL)


@pytest.mark.parametrize("splits", [1, 2, 5, 32])
@pytest.mark.parametrize("window,softcap", [(None, None), (9, None),
                                            (None, 20.0)])
def test_kernel_split_matches_pallas(splits, window, softcap):
    """The kernel's own cut (split_key_bounds) over a mixed batch of an
    engine layout with padded rows, against the Pallas kernel."""
    seq, pos = _layout([1, 1, 13, 7], [40, 3, 20, 80], pad=3)
    args = _inputs(7, N=len(seq), B=4, tok_seq=seq, tok_pos=pos)
    got = ragged_paged_attention_split_ref(*args, splits=splits,
                                           window=window, softcap=softcap)
    J = _jax()
    want = J.ragged(*(J.jnp.asarray(t.numpy()) for t in args),
                    softcap=softcap, window=window, interpret=True)
    _close(got, torch.from_numpy(np.array(want)), JAX_TOL)
    assert torch.all(got[-3:] == 0)


def test_splits_that_see_no_key_merge_as_nothing():
    """Short contexts under many splits and windowed rows: most splits of
    a tile see no key of some row (and a whole split none at all); the
    merge weighs them as nothing, not NaN; padded rows are zeros."""
    seq, pos = _layout([1, 1, 1, 5], [0, 2, 90, 60], pad=2)
    args = _inputs(3, N=len(seq), B=4, tok_seq=seq, tok_pos=pos)
    for window in (None, 3):
        bounds = split_key_bounds(args[4], args[5], G=4, page=4,
                                  max_pages=24, splits=8, window=window)
        m, l, acc = attention_partials(*args, bounds, window=window)
        assert bool(torch.isinf(m).any())          # a split saw no key
        got = merge_partials(m, l, acc, args[5], torch.float32)
        assert torch.isfinite(got).all()
        _close(got, ragged_paged_attention_ref(*args, window=window),
               SPLIT_TOL)
        assert torch.all(got[-2:] == 0)


def test_all_padded_bucket_is_zeros():
    args = _inputs(4, N=6, B=2, tok_pos=[-1] * 6)
    got = ragged_paged_attention_split_ref(*args, splits=4)
    assert torch.all(got == 0)


@pytest.mark.parametrize("name", sorted(KV_QUANT_DTYPES))
@pytest.mark.parametrize("splits", [1, 3])
def test_quantized_split_matches_quant_ref(name, splits):
    """Quantized pools, scales applied as the kernel applies them: the
    page's k_scale times the raw payload's scores, v_scale folded into P;
    against the dequantize-then-attend plain version and the JAX
    reference."""
    rng = np.random.default_rng(5)
    qd = kv_quant_dtype(name)
    seq, pos = _layout([1, 9, 6], [30, 0, 50], pad=2)
    q, kp, vp, bt, ts, tp = _inputs(8, N=len(seq), B=3, tok_seq=seq,
                                    tok_pos=pos)
    pools = []
    for f in (kp, vp):
        f = f * torch.from_numpy(rng.uniform(0.5, 4, (f.shape[0], 1, 2, 1))
                                 .astype(np.float32))
        scale = f.abs().amax(dim=(1, 3)) / kv_quant_qmax(qd)
        pools += [quantize_rows(f, scale[:, None], qd), scale]
    kq, ks, vq, vs = pools
    got = ragged_paged_attention_split_ref(q, kq, vq, bt, ts, tp,
                                           splits=splits, k_scale=ks,
                                           v_scale=vs, window=11)
    want = ragged_paged_attention_quant_ref(q, kq, vq, ks, vs, bt, ts, tp,
                                            window=11)
    _close(got, want, SPLIT_TOL * 4)   # |v_scale * v| reaches ~4x |v|
    J = _jax()

    def jx(t):
        if t.element_size() == 1 and t.dtype != torch.int8:
            jd = {torch.float8_e4m3fn: J.jnp.float8_e4m3fn,
                  torch.float8_e5m2: J.jnp.float8_e5m2}[t.dtype]
            return J.jnp.asarray(t.view(torch.uint8).numpy().view(jd).copy())
        return J.jnp.asarray(t.numpy().copy())
    jref = J.ref.ragged_paged_attention_quant_ref(
        jx(q), jx(kq), jx(vq), jx(ks), jx(vs), jx(bt), jx(ts), jx(tp),
        window=11)
    live = tp >= 0           # the JAX reference leaves padded rows as is
    _close(got[live], torch.from_numpy(np.array(jref))[live], JAX_TOL * 4)
    assert torch.all(got[~live] == 0)


def test_paged_is_ragged_with_one_row_per_sequence():
    """The paged kernel's problem through the same decomposition: row b
    at position ctx_lens[b] - 1 of sequence b, 16 splits (a B = 1
    decode's)."""
    ctx = torch.tensor([1, 4, 5, 96, 0], dtype=torch.int32)
    q, kp, vp, bt, _, _ = _inputs(9, N=5, B=5)
    got = ragged_paged_attention_split_ref(
        q, kp, vp, bt, torch.arange(5, dtype=torch.int32), ctx - 1,
        splits=16)
    _close(got, paged_attention_ref(q, kp, vp, bt, ctx), SPLIT_TOL)


@pytest.mark.parametrize("dtype,G,sweep", [
    (torch.bfloat16, 1, True), (torch.bfloat16, TILE_ROWS, True),
    (torch.bfloat16, TILE_ROWS + 8, False), (torch.float32, 4, False)])
def test_route_by_dtype_and_group(dtype, G, sweep):
    """bf16 q takes the tensor-core sweep while a tile holds all G heads of
    a row; a larger G, and float32 q, take the CUDA-core kernel."""
    assert tensor_cores(torch.zeros((2, 1, G, 32), dtype=dtype)) is sweep


# ---------------------------------------------------------------------------
# chip_smoke.py's timing records
# ---------------------------------------------------------------------------
def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_recorder_keeps_the_last_call_of_each_size():
    """The timing phase times each bucketed N at its last call, and row 1d
    at the last of the largest decode-only calls: the run's latest, so
    the longest contexts of that size."""
    import repro_torch.models.attention as attention
    rec = _chip_smoke().Recorder()
    calls = []
    with rec:
        for n, ctx in ((4, 10), (8, 20), (4, 30), (2, 40), (4, 50),
                       (2, 60)):
            args = _inputs(n * ctx, N=n, B=4, tok_pos=[ctx - 1] * n)
            attention.ragged_paged_attention_op(*args)
            calls.append((n, args))
    last = {n: args for n, args in calls}
    counts = rec.by_size["ragged_paged_attention"]
    assert counts == {4: 3, 8: 1, 2: 2}
    for n, args in last.items():
        got, _ = rec.call("ragged_paged_attention", device="cpu", size=n)
        assert all(torch.equal(a, b) for a, b in zip(got, args))
    # decode-only: no more rows than the block table's 4
    got, _ = rec.call("ragged_paged_attention_decode", device="cpu")
    assert rec.decode_launches == 5 and torch.equal(got[5], last[4][5])


def test_parent_kernels_import_another_tree_under_its_own_modules():
    """--parent loads another checkout's wrappers through its own modules
    (here this very tree's source, imported a second time) and leaves this
    tree's modules as they were."""
    import sys
    from pathlib import Path
    from repro_torch.kernels import _build, ragged_paged_attention as rpa
    cs = _chip_smoke()
    before = {k: m for k, m in sys.modules.items()
              if k.startswith("repro_torch")}
    ns = cs.parent_kernels(Path(cs.ROOT))
    after = {k: m for k, m in sys.modules.items()
             if k.startswith("repro_torch")}
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)
    assert ns.ragged is not rpa.ragged_paged_attention
    assert ns.ragged.__globals__["_build"] is not _build
    assert ns.mla.__globals__["_build"] is not _build
    assert ns.build.__module__ == "repro_torch.kernels._build"
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        ns.ragged(*_inputs(0, N=2, B=1))
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        q, kp, vp, bt, _, _ = _inputs(0, N=1, B=1)
        ns.paged(q, kp, vp, bt, torch.tensor([3], dtype=torch.int32))


# ---------------------------------------------------------------------------
# on the card: the kernels at the sweep's edges
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_inputs(cuda, seq, pos, *, G, hd, B, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(len(seq) * 131 + G + hd)
    q = torch.randn((len(seq), 8, G, hd), generator=g, device=cuda)
    kp = torch.randn((512, 16, 8, hd), generator=g, device=cuda)
    vp = torch.randn_like(kp)
    bt = torch.randint(0, 512, (B, 64), generator=g, device=cuda,
                       dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device=cuda)
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), bt,
            torch.tensor(seq, **i32), torch.tensor(pos, **i32))


EDGE_LAYOUTS = {
    "chunk tq-1": lambda tq: ([tq - 1], [100], 1),
    "chunk tq": lambda tq: ([tq], [100], 1),
    "chunk tq+1 to the table's end": lambda tq: ([tq + 1], [1023 - tq], 1),
    "two sequences in a tile": lambda tq: ([3, 5, 20], [30, 700, 0], 4),
    "decode at split edges": lambda tq: ([1] * 8, [63, 64, 255, 256, 767,
                                                   768, 1023, 0], 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(EDGE_LAYOUTS))
@pytest.mark.parametrize("G,hd", [(1, 64), (4, 64), (8, 64), (4, 32),
                                  (8, 128)])
def test_gpu_ragged_tile_edges(cuda, layout, G, hd):
    lens, starts, pad = EDGE_LAYOUTS[layout](tile_tokens(G))
    seq, pos = _layout(lens, starts, pad)
    args = _card_inputs(cuda, seq, pos, G=G, hd=hd, B=len(lens))
    got = ragged_paged_attention(*args)
    want = ragged_paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)
    assert torch.all(got[args[5] < 0] == 0)


@pytest.mark.gpu
def test_gpu_ragged_unsorted_tok_seq(cuda):
    seq, pos = _layout([1, 17, 9, 1, 12], [63, 0, 250, 1023, 500])
    order = torch.randperm(len(seq), generator=torch.Generator()
                           .manual_seed(0)).tolist()
    seq, pos = [seq[i] for i in order], [pos[i] for i in order]
    args = _card_inputs(cuda, seq, pos, G=4, hd=64, B=5)
    torch.testing.assert_close(ragged_paged_attention(*args).float(),
                               ragged_paged_attention_ref(*args).float(),
                               atol=3e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ctx", [1, 64, 65, 687, 1024])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_gpu_paged_split_edges(cuda, ctx, G):
    q, kp, vp, bt, _, _ = _card_inputs(cuda, [0, 1, 2], [0, 0, 0], G=G,
                                       hd=64, B=3)
    lens = torch.tensor([ctx, 65, 0], dtype=torch.int32, device=cuda)
    got = paged_attention(q, kp, vp, bt, lens)
    torch.testing.assert_close(
        got.float(), paged_attention_ref(q, kp, vp, bt, lens).float(),
        atol=3e-2, rtol=0)
    assert torch.all(got[-1] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(KV_QUANT_DTYPES))
def test_gpu_quantized_tile_edges(cuda, name):
    qd = kv_quant_dtype(name)
    seq, pos = _layout([17, 3, 1], [100, 700, 1023], 2)
    q, kp, vp, bt, ts, tp = _card_inputs(cuda, seq, pos, G=4, hd=64, B=3,
                                         dtype=torch.float32)
    pools = []
    for f in (kp, vp):
        scale = f.abs().amax(dim=(1, 3)) / kv_quant_qmax(qd)
        pools += [quantize_rows(f, scale[:, None], qd), scale]
    kq, ks, vq, vs = pools
    q = q.bfloat16()
    got = ragged_paged_attention(q, kq, vq, bt, ts, tp, k_scale=ks,
                                 v_scale=vs)
    want = ragged_paged_attention_quant_ref(q, kq, vq, ks, vs, bt, ts, tp)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)
    lens = tp[:3].clone() + 1
    got = paged_attention(q[:3], kq, vq, bt, lens, k_scale=ks, v_scale=vs)
    want = paged_attention_quant_ref(q[:3], kq, vq, ks, vs, bt, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [TILE_ROWS + 8])
def test_gpu_bf16_group_past_a_tile(cuda, G):
    """bf16 q with more heads a row than a tile holds runs the CUDA-core
    kernel in both entry points, at the same tolerance."""
    seq, pos = _layout([5, 1], [100, 687], 1)
    args = _card_inputs(cuda, seq, pos, G=G, hd=32, B=2)
    torch.testing.assert_close(ragged_paged_attention(*args).float(),
                               ragged_paged_attention_ref(*args).float(),
                               atol=3e-2, rtol=0)
    q, kp, vp, bt = args[:4]
    lens = torch.tensor([687, 0], dtype=torch.int32, device=cuda)
    got = paged_attention(q[:2], kp, vp, bt, lens)
    torch.testing.assert_close(
        got.float(), paged_attention_ref(q[:2], kp, vp, bt, lens).float(),
        atol=3e-2, rtol=0)


@pytest.mark.gpu
def test_gpu_split_counters_are_left_zero(cuda):
    """The arrival counters are zeroed once: every split launch leaves them
    zero, so launch after launch on one stream merges the same result."""
    seq, pos = _layout([1] * 8, [63, 64, 255, 256, 767, 768, 1023, 0])
    args = _card_inputs(cuda, seq, pos, G=4, hd=64, B=8)
    q, kp, vp, bt = args[:4]
    lens = torch.tensor([1000], dtype=torch.int32, device=cuda)

    def paged():
        return paged_attention(q[:1], kp, vp, bt[:1], lens)
    first, first_paged = ragged_paged_attention(*args), paged()
    for _ in range(3):
        assert torch.equal(ragged_paged_attention(*args), first)
        assert torch.equal(paged(), first_paged)
    torch.cuda.synchronize()
    assert _COUNTERS and all(int(c.abs().sum()) == 0
                             for c in _COUNTERS.values())
