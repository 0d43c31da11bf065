"""The swap path's tree pack and unpack (PERF.md rows 3-4): one launch for
every leaf of a pool tree, one byte slab per swap.

* On the CPU: the plain tree versions byte for byte against the per-leaf
  ``swap_pack_ref`` / ``swap_unpack_ref`` and against the JAX package's
  Pallas ``swap_pack`` / ``swap_unpack`` run leaf by leaf in interpret
  mode, under hypothesis over trees of 1-4 leaves of mixed dtypes and row
  sizes, 0-40 ids with repeats and ids out of range, 1-4 periods; the
  slab's layout; a ``SwapStager`` round trip whose collected views share
  one buffer. (The launchers' refusal of CPU tensors is in
  ``tests/test_torch_kernels.py``.)
* On a CUDA card (``-m gpu``): the tree kernel against its plain version
  over unaligned sections, rows larger than a stage and n == 0, an
  unpack with repeated and out-of-range ids, one launch per stager pack
  and unpack, the collected slab pinned. The
  card's machine has no JAX, so the reference is imported inside the CPU
  tests only:
  ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_swap.py``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import ops
from repro_torch.kernels.swap_pack import (
    SLAB_ALIGN, SwapStager, slab_layout, slab_pages, slab_views, swap_pack,
    swap_pack_ref, swap_pack_tree, swap_pack_tree_ref, swap_unpack,
    swap_unpack_ref, swap_unpack_tree, swap_unpack_tree_ref)
from repro_torch.utils.tree import tree_leaves

DTYPES = ("bfloat16", "float32", "int8", "float8_e4m3fn")
# trailing page shapes: with the dtypes above, rows of 1 to 256 bytes,
# 4, 8 and 32 among them, many not a multiple of 16
TRAILING = ((1,), (2,), (8,), (3,), (5, 3), (2, 2, 4), (4, 2, 8))
N_PAGES = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(rng, P, trailing, dtype, n_pages=N_PAGES, device="cpu"):
    shape = (P, n_pages, *trailing)
    if dtype == "int8":
        t = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))
    else:
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 8)
        t = t.to(getattr(torch, dtype))
    return t.to(device)


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bytes(a), _bytes(b))


def _to_jax(t):
    """A torch tensor as a jnp array of the same bits."""
    import jax.numpy as jnp
    import ml_dtypes
    np_dtype = {torch.bfloat16: ml_dtypes.bfloat16,
                torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
                torch.float32: np.float32, torch.int8: np.int8}[t.dtype]
    return jnp.asarray(t.view(torch.uint8).numpy().view(np_dtype))


def _from_jax(a, dtype):
    raw = np.ascontiguousarray(np.asarray(a)).view(np.uint8)
    return torch.from_numpy(raw.copy()).view(dtype)


tree_spec = st.lists(st.tuples(st.sampled_from(DTYPES),
                               st.sampled_from(TRAILING)),
                     min_size=1, max_size=4)
ids_spec = st.lists(st.integers(-3, N_PAGES + 2), min_size=0, max_size=40)


def _case(spec, P, seed):
    rng = np.random.default_rng(seed)
    leaves = [_leaf(rng, P, trailing, dtype) for dtype, trailing in spec]
    return rng, leaves


def _keep_last(ids):
    """In-range ids, the last of repeats kept: (positions, ids)."""
    last = {}
    for i, pid in enumerate(ids):
        if 0 <= pid < N_PAGES:
            last[pid] = i
    pos = sorted(last.values())
    return pos, [ids[i] for i in pos]


# ---------------------------------------------------------------------------
# the plain tree versions, on the CPU
# ---------------------------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(spec=tree_spec, P=st.integers(1, 4), ids=ids_spec,
       seed=st.integers(0, 2 ** 16))
def test_tree_plain_matches_per_leaf_refs(spec, P, ids, seed):
    """Pack: each leaf's section holds swap_pack_ref of the in-range ids,
    rows of ids out of range keep the slab's bytes. Unpack: every leaf as
    swap_unpack_ref leaves it over the in-range ids, the last of repeated
    ids written."""
    rng, leaves = _case(spec, P, seed)
    n = len(ids)
    tids = torch.tensor(ids, dtype=torch.int32)
    offs, size = slab_layout(leaves, n)
    before = torch.from_numpy(rng.integers(0, 256, size, dtype=np.uint8))
    slab = before.clone()
    swap_pack_tree_ref(leaves, tids, slab)
    views = slab_views(slab, leaves, n, offs)
    old = slab_views(before, leaves, n, offs)
    valid = [i for i, pid in enumerate(ids) if 0 <= pid < N_PAGES]
    invalid = [i for i in range(n) if i not in valid]
    for leaf, view, prior in zip(leaves, views, old):
        assert view.dtype == leaf.dtype and \
            view.shape == (P, n, *leaf.shape[2:])
        assert _same(view[:, valid], swap_pack_ref(
            leaf, torch.tensor([ids[i] for i in valid], dtype=torch.int32)))
        assert _same(view[:, invalid], prior[:, invalid])
    # unpack the random slab back into copies of the leaves
    pos, kept = _keep_last(ids)
    got = [leaf.clone() for leaf in leaves]
    swap_unpack_tree_ref(got, before, tids)
    for leaf, g, prior in zip(leaves, got, old):
        want = swap_unpack_ref(leaf.clone(), prior[:, pos],
                               torch.tensor(kept, dtype=torch.int32))
        assert _same(g, want)


@settings(max_examples=15, deadline=None)
@given(spec=tree_spec, P=st.integers(1, 4), ids=ids_spec,
       seed=st.integers(0, 2 ** 16))
def test_tree_plain_matches_pallas_leaf_by_leaf(spec, P, ids, seed):
    """The JAX package's Pallas kernels (interpret mode) on each leaf, its
    period axis moved behind the page axis: pack over the in-range ids
    (repeats included) equals the tree pack's rows, unpack over them (its
    grid writes in order, the last repeat wins) equals the tree unpack."""
    import jax.numpy as jnp
    from repro.kernels.swap_pack import swap_pack as j_pack
    from repro.kernels.swap_pack import swap_unpack as j_unpack
    rng, leaves = _case(spec, P, seed)
    n = len(ids)
    tids = torch.tensor(ids, dtype=torch.int32)
    _, size = slab_layout(leaves, n)
    # finite values in the slab: XLA may rewrite a NaN's payload bits
    slab = torch.zeros(size, dtype=torch.uint8)
    for (dtype, trailing), view in zip(spec, slab_views(slab, leaves, n)):
        view.copy_(_leaf(rng, P, trailing, dtype, n))
    packed = slab_views(swap_pack_tree_ref(leaves, tids, slab.clone()),
                        leaves, n)
    unpacked = swap_unpack_tree_ref([leaf.clone() for leaf in leaves], slab,
                                    tids)
    valid = [i for i, pid in enumerate(ids) if 0 <= pid < N_PAGES]
    jids = jnp.asarray(np.array([ids[i] for i in valid], np.int32))
    sections = slab_views(slab, leaves, n)
    for leaf, view, got, section in zip(leaves, packed, unpacked, sections):
        pool = jnp.moveaxis(_to_jax(leaf), 0, 1)           # (n_pages, P, ..)
        if valid:
            staged = jnp.moveaxis(j_pack(pool, jids, interpret=True), 0, 1)
            assert _same(view[:, valid], _from_jax(staged, leaf.dtype))
            rows = jnp.moveaxis(_to_jax(section[:, valid].contiguous()), 0,
                                1)
            pool = j_unpack(pool, rows, jids, interpret=True)
        assert _same(got, _from_jax(jnp.moveaxis(pool, 0, 1), leaf.dtype))


def test_slab_layout_aligns_every_section():
    leaves = [torch.zeros(2, 5, 3, dtype=torch.int8),
              torch.zeros(2, 5, 1, dtype=torch.float32),
              torch.zeros(3, 5, 4, 4, dtype=torch.bfloat16),
              torch.zeros(0, 5, 8, dtype=torch.float32)]
    offs, size = slab_layout(leaves, 7)
    assert offs == [0, 128, 256, 1024]       # 256 + 3 * 7 * 32 rounded up
    assert size == offs[3] and all(o % SLAB_ALIGN == 0 for o in offs)
    slab = torch.zeros(size, dtype=torch.uint8)
    views = slab_views(slab, leaves, 7)
    assert [tuple(v.shape) for v in views] == [(2, 7, 3), (2, 7, 1),
                                               (3, 7, 4, 4), (0, 7, 8)]
    assert all(v.untyped_storage().data_ptr() == slab.data_ptr()
               for v in views if v.numel())
    assert slab_layout(leaves, 0) == ([0, 0, 0, 0], 0)


def test_stager_cpu_roundtrip_one_buffer_per_swap():
    """A mixed pool tree (bf16 payload, int8 payload, 8-byte scale rows)
    through pack, collect and unpack on the CPU: the collected pytree's
    leaves are views of one buffer, each section 128-byte aligned in it,
    with the pools' dtypes and (P, n, ...) shapes; the pages' payloads
    unpack back exactly; no kernel launches."""
    rng = np.random.default_rng(7)
    pools = {"b0": {"k": _leaf(rng, 3, (4, 2, 8), "bfloat16"),
                    "k_scale": _leaf(rng, 3, (2,), "float32"),
                    "v": _leaf(rng, 3, (4, 2, 8), "int8")}}
    want = {k: v.clone() for k, v in pools["b0"].items()}
    launches = (swap_pack.launches, swap_unpack.launches)
    st_ = SwapStager()
    ids = [9, 0, 4, 11]
    host = st_.collect(st_.pack(pools, ids))
    leaves = tree_leaves(host)
    base = leaves[0].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in leaves)
    assert [(v.data_ptr() - base) % SLAB_ALIGN for v in leaves] == [0] * 3
    for k, v in host["b0"].items():
        assert v.dtype == pools["b0"][k].dtype
        assert v.shape == (3, 4, *pools["b0"][k].shape[2:])
    pages = slab_pages(host, len(ids))
    for leaf in pools["b0"].values():
        leaf[:, ids] = 0
    st_.unpack(pools, ids, pages)
    assert all(_same(pools["b0"][k], want[k]) for k in want)
    assert (st_.packs, st_.unpacks) == (1, 1)
    assert (st_.packed_pages, st_.unpacked_pages) == (4, 4)
    assert (swap_pack.launches, swap_unpack.launches) == launches


def test_tree_ops_dispatch_cpu_to_plain_versions():
    rng = np.random.default_rng(8)
    leaves = [_leaf(rng, 2, (3,), "float32"), _leaf(rng, 2, (5,), "int8")]
    ids = torch.tensor([3, 1], dtype=torch.int32)
    _, size = slab_layout(leaves, 2)
    slab = torch.zeros(size, dtype=torch.uint8)
    launches = (swap_pack.launches, swap_unpack.launches)
    views = slab_views(ops.swap_pack_tree_op(leaves, ids, slab), leaves, 2)
    assert all(_same(v, swap_pack_ref(leaf, ids))
               for v, leaf in zip(views, leaves))
    got = ops.swap_unpack_tree_op([torch.zeros_like(x) for x in leaves],
                                  slab, ids)
    assert all(_same(g[:, [3, 1]], v) for g, v in zip(got, views))
    assert (swap_pack.launches, swap_unpack.launches) == launches


# ---------------------------------------------------------------------------
# on the card: the tree kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (trailing shape, dtype): 16 KB rows (one stage), 8 KB, 20 KB and 24 KB
# (pieces of stages), 512 and 1040 bytes (many rows a chunk) on the bulk
# copies; 48 and 32 bytes (16-byte words), 4, 8, 18 and 5 bytes on the
# word path
GPU_LEAVES = (((16, 8, 64), "bfloat16"), ((16, 8, 64), "int8"),
              ((20, 8, 64), "bfloat16"), ((3, 16, 8, 16), "float32"),
              ((48,), "float8_e4m3fn"), ((8,), "float32"), ((1,), "float32"),
              ((2,), "float32"), ((9,), "bfloat16"), ((5,), "int8"),
              ((256,), "bfloat16"), ((260,), "float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("picks", [[0], [1, 5], [1, 5, 1, 5], [2, 3],
                                   [6, 7, 8, 9], [0, 6, 1, 9], [4, 5, 8, 2],
                                   [10, 11, 7]])
@pytest.mark.parametrize("n", [0, 1, 34, 100])
@pytest.mark.parametrize("shift", [0, 8])
def test_gpu_tree_kernel_matches_plain(cuda, picks, n, shift):
    """Byte for byte against the plain tree versions on the card: slabs
    with aligned sections and slabs that start 8 bytes into their buffer
    (every leaf then on the word path), ids repeated (pack) and out of
    range; one launch per call, none at n == 0."""
    rng = np.random.default_rng(n + 7 * shift + 100 * len(picks))
    leaves = [_leaf(rng, 3, GPU_LEAVES[i][0], GPU_LEAVES[i][1], 128, cuda)
              for i in picks]
    _, size = slab_layout(leaves, n)
    buf = torch.from_numpy(rng.integers(0, 256, size + shift,
                                        dtype=np.uint8)).to(cuda)
    ids = torch.from_numpy(rng.integers(-3, 132, n).astype(np.int32)).to(cuda)
    before = (swap_pack.launches, swap_unpack.launches)
    got, want = buf.clone(), buf.clone()
    swap_pack_tree(leaves, ids, got[shift:])
    swap_pack_tree_ref(leaves, ids, want[shift:])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    uids = torch.from_numpy(rng.permutation(136)[:n].astype(np.int32)).to(
        cuda)
    mine = [leaf.clone() for leaf in leaves]
    swap_unpack_tree(mine, buf[shift:], uids)
    swap_unpack_tree_ref(leaves, buf[shift:], uids)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(mine, leaves))
    assert (swap_pack.launches - before[0], swap_unpack.launches
            - before[1]) == ((0, 0) if n == 0 else (1, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("picks", [[0, 1], [4, 5, 8, 2], [2, 3]])
@pytest.mark.parametrize("n", [7, 34, 100])
def test_gpu_unpack_repeated_ids_write_the_last(cuda, picks, n):
    """An unpack whose ids repeat pages and run out of range, on the bulk
    copies, rows larger than a stage and the word path: byte for byte the
    plain version's result, where the last row naming a page wins
    (``_unpack_rows``, the reference's sequential grid)."""
    rng = np.random.default_rng(11 * n + len(picks))
    leaves = [_leaf(rng, 3, GPU_LEAVES[i][0], GPU_LEAVES[i][1], 128, cuda)
              for i in picks]
    _, size = slab_layout(leaves, n)
    buf = torch.from_numpy(rng.integers(0, 256, size,
                                        dtype=np.uint8)).to(cuda)
    ids = rng.integers(0, 10, n).astype(np.int32)   # every page repeated
    ids[::5] = rng.integers(-3, 0, len(ids[::5]))
    ids[1::7] = 128 + rng.integers(0, 4, len(ids[1::7]))
    ids = torch.from_numpy(ids).to(cuda)
    mine = [leaf.clone() for leaf in leaves]
    swap_unpack_tree(mine, buf, ids)
    swap_unpack_tree_ref(leaves, buf, ids)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(mine, leaves))


@pytest.mark.gpu
def test_gpu_one_leaf_wrappers_match_refs(cuda):
    """swap_pack / swap_unpack, the tree launcher's one-leaf case, against
    the per-leaf plain versions: a payload leaf and an 8-byte scale leaf."""
    rng = np.random.default_rng(3)
    ids = torch.tensor([7, 100, 3, 64], dtype=torch.int32, device=cuda)
    for trailing, dtype in (((16, 8, 64), "bfloat16"), ((2,), "float32")):
        pool = _leaf(rng, 4, trailing, dtype, 128, cuda)
        slab = swap_pack(pool, ids)
        assert _same(slab, swap_pack_ref(pool, ids))
        zero = torch.zeros_like(slab)
        got = swap_unpack(pool.clone(), zero, ids)
        assert _same(got, swap_unpack_ref(pool.clone(), zero, ids))


@pytest.mark.gpu
def test_gpu_stager_one_launch_per_swap_pinned_slab(cuda):
    """An int8 pool tree (payload and scale leaves): one pack and one
    unpack launch for the four leaves; the collected leaves are views of
    one pinned buffer; the round trip is exact."""
    rng = np.random.default_rng(4)
    pools = ({"b0": {"k": _leaf(rng, 4, (16, 8, 64), "int8", 128, cuda),
                     "k_scale": _leaf(rng, 4, (8,), "float32", 128, cuda),
                     "v": _leaf(rng, 4, (16, 8, 64), "int8", 128, cuda),
                     "v_scale": _leaf(rng, 4, (8,), "float32", 128, cuda)}},)
    want = {k: v.clone() for k, v in pools[0]["b0"].items()}
    before = (swap_pack.launches, swap_unpack.launches)
    st_ = SwapStager()
    ids = [5, 77, 3, 120, 9]
    host = st_.collect(st_.pack(pools, ids))
    leaves = tree_leaves(host)
    assert all(v.is_pinned() for v in leaves)
    base = leaves[0].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in leaves)
    for leaf in pools[0]["b0"].values():
        leaf[:, ids] = 0
    st_.unpack(pools, ids, slab_pages(host, len(ids)))
    torch.cuda.synchronize()
    assert all(_same(pools[0]["b0"][k], want[k]) for k in want)
    assert (swap_pack.launches - before[0],
            swap_unpack.launches - before[1]) == (1, 1)
