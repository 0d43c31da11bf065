"""The fused quantized append (``csrc/kv_append_quant.cu``) and the
redesigned ``kv_append`` kernel, held two ways.

* On the CPU, ``kv_append_quant_owner_ref`` (the kernel's decomposition:
  one owner per (page, kv head), in first-occurrence order) byte for
  byte against the port's ``kv_append_quant_ref`` and against the JAX
  ``kv_append_quant`` (Pallas, ``interpret=True``, as
  ``tests/test_torch_kv_quant.py`` runs it; every page but its
  write-discard page), under hypothesis over int8 / float8_e4m3 /
  float8_e5m2 pools x bfloat16 / float32 rows and routings with
  duplicate pages in any order, invalid rows sharing a valid row's page,
  out-of-range ids, zero-scale pages, all-zero rows, and rows that do and
  do not grow the scale. Offsets outside the page against the JAX
  reference's drop-mode scatter; negative ids against the port's plain
  version. The attention layer's append on the CPU launches nothing.
* On a CUDA card (``-m gpu``): the kernel bit for bit against the plain
  version, on the card and on the CPU, over Hkv {1, 8} x hd {32, 64,
  128} x N {1, 7, 16, 17, 512}, its
  refusals, one fused launch per append and none of ``kv_append`` or
  ``page_requant``; ``kv_append`` at its 8-row block edges N {1, 7, 8,
  9, 512}. The card's machine has no JAX, so the reference is imported
  inside the CPU tests only and the card runs this file alone:
  ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_kv_append_quant.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.kv_append import kv_append, kv_append_ref
from repro_torch.kernels.kv_quant import (KV_QUANT_DTYPES, kv_append_quant,
                                          kv_append_quant_owner_ref,
                                          kv_append_quant_ref,
                                          kv_quant_dtype, kv_quant_qmax,
                                          page_requant, quantize_rows)

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
import hypothesis.strategies as st      # noqa: E402

ALL_KV_DTYPES = sorted(KV_QUANT_DTYPES)
ROW_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them, so each worker's
    torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """The JAX reference, imported where a CPU test needs it."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jq
    from repro.kernels import ref
    return SimpleNamespace(jnp=jnp, q=jq, ref=ref)


def _u8(x) -> np.ndarray:
    """Payload bytes of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _to_jax(t: torch.Tensor):
    """torch -> JAX through a numpy copy (float8 and bfloat16 through
    their bytes)."""
    J = _jax()
    jd = {torch.float8_e4m3fn: J.jnp.float8_e4m3fn,
          torch.float8_e5m2: J.jnp.float8_e5m2,
          torch.bfloat16: J.jnp.bfloat16}.get(t.dtype)
    if jd is None:
        return J.jnp.asarray(t.numpy().copy())
    raw = t.view(torch.uint8 if t.element_size() == 1 else torch.int16)
    return J.jnp.asarray(raw.numpy().view(jd).copy())


def _same(a, b) -> bool:
    return all(torch.equal(x.view(torch.uint8) if x.element_size() == 1
                           else x, y.view(torch.uint8)
                           if y.element_size() == 1 else y)
               for x, y in zip(a, b))


def _state(rng, name, n_pages, page, Hkv, hd, zero_pages=()):
    """Pools quantized from random values at random per-(page, head)
    scales; ``zero_pages`` get scale 0 over a leftover payload (a freed
    page keeps its bytes)."""
    qd = kv_quant_dtype(name)
    out = []
    for _ in range(2):
        scale = rng.uniform(0.01, 0.1, (n_pages, Hkv)).astype(np.float32)
        f = rng.uniform(-1, 1, (n_pages, page, Hkv, hd)).astype(np.float32)
        f *= scale[:, None, :, None] * kv_quant_qmax(qd)
        s = torch.from_numpy(scale)
        q = quantize_rows(torch.from_numpy(f), s[:, None].expand(
            n_pages, page, Hkv), qd)
        s[list(zero_pages)] = 0.0
        out += [q, s]
    kq, ks, vq, vs = out
    return [kq, vq, ks, vs]


def _rows(rng, name, n, Hkv, hd, mag, rdtype, zero_rows=()):
    """Rows around mag x a mid-range page's span (0.05 * qmax), exact in
    ``rdtype``; ``zero_rows`` all zero."""
    base = 0.05 * kv_quant_qmax(kv_quant_dtype(name))
    out = []
    for _ in range(2):
        x = torch.from_numpy((rng.normal(size=(n, Hkv, hd)) * mag * base)
                             .astype(np.float32)).to(rdtype)
        x[list(zero_rows)] = 0
        out.append(x)
    return out


# ---------------------------------------------------------------------------
# CPU: the owner decomposition against the plain version and JAX
# ---------------------------------------------------------------------------
N_PAGES, PAGE, HKV, HD, N = 7, 4, 2, 16, 10
DISCARD = N_PAGES - 1          # the Pallas path's write-discard page, last


@st.composite
def _calls(draw):
    """One append: distinct slots over the live pages (so pages repeat in
    any order), validity, out-of-range ids (clamped onto the last page,
    the discard page, by the Pallas path), zero-scale pages, all-zero
    rows and a row magnitude that does or does not grow the scales."""
    slots = draw(st.lists(st.integers(0, DISCARD * PAGE - 1), min_size=N,
                          max_size=N, unique=True))
    ids = [s // PAGE for s in slots]
    far = draw(st.lists(st.sampled_from([None, None, None, N_PAGES,
                                         N_PAGES + 3]), min_size=N,
                        max_size=N))
    ids = [i if f is None else f for i, f in zip(ids, far)]
    valid = draw(st.lists(st.booleans(), min_size=N, max_size=N))
    return SimpleNamespace(
        ids=np.array(ids, np.int32),
        offs=np.array([s % PAGE for s in slots], np.int32),
        valid=np.array(valid, np.int32),
        zero_pages=draw(st.sets(st.integers(0, DISCARD - 1), max_size=3)),
        zero_rows=draw(st.sets(st.integers(0, N - 1), max_size=4)),
        mag=draw(st.sampled_from([0.0, 0.1, 1.0, 8.0])),
        seed=draw(st.integers(0, 2 ** 31 - 1)))


@pytest.mark.parametrize("rdtype", sorted(ROW_DTYPES))
@pytest.mark.parametrize("name", ALL_KV_DTYPES)
@settings(max_examples=80, deadline=None)
@given(call=_calls())
def test_owner_ref_matches_plain_and_jax(name, rdtype, call):
    J = _jax()
    rng = np.random.default_rng(call.seed)
    state = _state(rng, name, N_PAGES, PAGE, HKV, HD, call.zero_pages)
    rows = _rows(rng, name, N, HKV, HD, call.mag, ROW_DTYPES[rdtype],
                 call.zero_rows)
    routing = [torch.from_numpy(a) for a in (call.ids, call.offs,
                                             call.valid)]
    jax_in = [_to_jax(t) for t in state] + [_to_jax(r) for r in rows]
    want = kv_append_quant_ref(*[t.clone() for t in state], *rows, *routing)
    got = kv_append_quant_owner_ref(*state, *rows, *routing)
    assert all(a is b for a, b in zip(got, state))            # in place
    assert _same(got, want)
    pal = J.q.kv_append_quant(*jax_in, *map(J.jnp.asarray, (
        call.ids, call.offs, call.valid)), DISCARD, interpret=True)
    live = np.arange(DISCARD)
    for i in (0, 1):
        assert np.array_equal(_u8(got[i])[live], _u8(pal[i])[live])
    for i in (2, 3):
        assert np.array_equal(got[i].numpy(), np.asarray(pal[i]))


def test_owner_ref_drops_offsets_outside_the_page_as_jax_does():
    """A valid row whose offset lies past the page: its amax still grows
    the scale and its page is requantized, its write is dropped, as the
    reference's drop-mode scatter does."""
    J = _jax()
    rng = np.random.default_rng(5)
    state = _state(rng, "int8", N_PAGES, PAGE, HKV, HD)
    rows = _rows(rng, "int8", 3, HKV, HD, 8.0, torch.float32)
    ids = np.array([2, 2, 4], np.int32)
    offs = np.array([1, PAGE, PAGE + 2], np.int32)
    valid = np.ones(3, np.int32)
    jax_in = [_to_jax(t) for t in state] + [_to_jax(r) for r in rows]
    want = J.ref.kv_append_quant_ref(*jax_in, *map(J.jnp.asarray,
                                                   (ids, offs, valid)))
    got = kv_append_quant_owner_ref(*state, *rows, *map(torch.from_numpy,
                                                        (ids, offs, valid)))
    for i in (0, 1):
        assert np.array_equal(_u8(got[i]), _u8(want[i]))
    for i in (2, 3):
        assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
    assert float(got[2][4].min()) > 0.1     # page 4 grew from row 2 alone


@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_owner_ref_negative_ids_and_duplicates_match_plain(name):
    """Negative ids (valid or not), a page named by rows in reverse slot
    order, an invalid row on a valid row's page, an all-zero row on a
    zero-scale page (its scale stays 0 and its payload becomes signed
    zeros: -0.0 is the float8 byte 0x80)."""
    rng = np.random.default_rng(11)
    state = _state(rng, name, 8, 4, 2, 32, zero_pages=(5,))
    rows = _rows(rng, name, 8, 2, 32, 1.0, torch.bfloat16, zero_rows=(6,))
    ids = torch.tensor([3, -1, 3, 0, 3, -4, 5, 0], dtype=torch.int32)
    offs = torch.tensor([3, 0, 1, 2, 0, 1, 2, 1], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 0, 0, 1, 1], dtype=torch.int32)
    want = kv_append_quant_ref(*[t.clone() for t in state], *rows, ids,
                               offs, valid)
    got = kv_append_quant_owner_ref(*state, *rows, ids, offs, valid)
    assert _same(got, want)
    assert float(got[2][5].abs().max()) == 0.0
    assert float(got[0][5].float().abs().max()) == 0.0


def test_quant_append_on_the_cpu_launches_nothing():
    """The attention layer's append over a quantized pool dict on the CPU
    runs the plain version: no kernel launch of any kind."""
    from repro_torch.models.attention import _append
    rng = np.random.default_rng(3)
    kq, vq, ks, vs = _state(rng, "float8_e4m3", 6, 4, 2, 16)
    pool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    want = [t.clone() for t in (kq, vq, ks, vs)]
    k, v = _rows(rng, "float8_e4m3", 5, 2, 16, 1.0, torch.float32)
    pids = torch.tensor([1, 1, 4, 0, 1])
    offs = torch.tensor([0, 3, 2, 2, 1])
    valid = torch.tensor([True, True, True, False, True])
    kv_append_quant_ref(*want, k, v, pids.int(), offs.int(), valid.int())
    before = (kv_append_quant.launches, kv_append.launches,
              page_requant.launches)
    kw = _append(pool, k, v, pids, offs, valid)
    assert kw == {"k_scale": ks, "v_scale": vs}
    assert _same((kq, vq, ks, vs), want)
    assert (kv_append_quant.launches, kv_append.launches,
            page_requant.launches) == before


# ---------------------------------------------------------------------------
# chip_smoke.py's records and bound for the appends
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


def test_chip_smoke_append_quant_bound_counts_each_byte_once():
    """Row 2q's bound: the live rows read in their dtype; in both pools
    each touched page written once and read only where no new row lands,
    its scales read and written; the int32 routing read once."""
    cs = _chip_smoke()
    n_pages, page, Hkv, hd = 64, 16, 8, 64
    slot = Hkv * hd
    kp = torch.zeros((n_pages, page, Hkv, hd), dtype=torch.int8)
    ks = torch.zeros((n_pages, Hkv))
    # the serve's largest call: 464 live rows filling 29 pages whole, 48
    # padded rows invalid
    N = 512
    slots = torch.arange(N)
    ids, offs = (slots // page).int(), (slots % page).int()
    valid = (slots < 464).int()
    kn = torch.zeros((N, Hkv, hd), dtype=torch.bfloat16)
    nbytes, ops, touched = cs.append_quant_work(kp, ks, kn, ids, offs, valid)
    assert touched == 29
    assert nbytes == 2 * (464 * slot * 2 + 29 * page * slot
                          + 2 * 29 * Hkv * 4) + 12 * N == 1435264
    assert ops == 2 * (29 * page * slot + 2 * 464 * slot)
    # a page partly written, a live row whose offset lies past its page
    # (read for the amax, written nowhere), an id out of range and an
    # invalid row on a live page (neither read)
    ids = torch.tensor([3, 3, 5, 5, 70, 3], dtype=torch.int32)
    offs = torch.tensor([0, 1, 2, 20, 0, 4], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.int32)
    kn = torch.zeros((6, Hkv, hd))
    nbytes, _, touched = cs.append_quant_work(kp, ks, kn, ids, offs, valid)
    assert touched == 2
    assert nbytes == 2 * (4 * slot * 4 + (2 * page - 3) * slot
                          + 2 * page * slot + 2 * 2 * Hkv * 4) + 12 * 6


def test_chip_smoke_recorder_keeps_the_appends_by_size():
    """The timing phase sums rows 2 and 2q's launches x (time - bound)
    over every N the serve runs appended, each N at its last call."""
    import repro_torch.models.attention as attention
    rng = np.random.default_rng(4)
    rec = _chip_smoke().Recorder()
    kq, vq, ks, vs = _state(rng, "int8", 6, 4, 2, 16)
    kp, vp = (torch.zeros((6, 4, 2, 16)) for _ in range(2))
    last = {}
    with rec:
        for n in (3, 5, 3):
            k, v = _rows(rng, "int8", n, 2, 16, 1.0, torch.float32)
            routing = (torch.arange(n, dtype=torch.int32),
                       torch.zeros(n, dtype=torch.int32),
                       torch.ones(n, dtype=torch.int32))
            attention.kv_append_op(kp, vp, k, v, *routing)
            attention.kv_append_quant_op(kq, vq, ks, vs, k, v, *routing)
            last[n] = (k, routing)
    for key in ("kv_append", "kv_append_quant"):
        assert rec.by_size[key] == {3: 2, 5: 1}
        for n, (k, routing) in last.items():
            got, _ = rec.call(key, device="cpu", size=n)
            assert torch.equal(got[-5], k)
            assert all(torch.equal(a, b) for a, b in zip(got[-3:], routing))


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_call(cuda, gen, name, rdtype, **kw):
    """chip_smoke.py's quantized append case on the card: pages named by
    several rows in any order, invalid rows, ids out of range, zero-scale
    pages, an all-zero row, rows that grow the scales or mostly do not."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke.append_quant_case(gen, name, rdtype, device=cuda, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("rdtype", sorted(ROW_DTYPES))
@pytest.mark.parametrize("name", ALL_KV_DTYPES)
def test_gpu_kv_append_quant_bit_exact_over_the_grid(cuda, name, rdtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for Hkv in (1, 8):
        for hd in (32, 64, 128):
            for N in (1, 7, 16, 17, 512):
                state, args = _card_call(cuda, gen, name, ROW_DTYPES[rdtype],
                                         N=N, Hkv=Hkv, hd=hd)
                want = kv_append_quant_ref(*[t.clone() for t in state],
                                           *args)
                on_cpu = kv_append_quant_ref(*[t.cpu() for t in state],
                                             *[a.cpu() for a in args])
                got = kv_append_quant(*state, *args)
                torch.cuda.synchronize()
                assert _same(got, want), (Hkv, hd, N)
                assert _same([t.cpu() for t in got], on_cpu), (Hkv, hd, N)


@pytest.mark.gpu
def test_gpu_kv_append_quant_one_launch_per_append(cuda):
    """Through the op and through the attention layer's append: one fused
    launch each, and none of kv_append or page_requant."""
    from repro_torch.models.attention import _append
    gen = torch.Generator(device=cuda).manual_seed(1)
    state, args = _card_call(cuda, gen, "int8", torch.bfloat16, N=40,
                             Hkv=8, hd=64)
    counts = (lambda: (kv_append_quant.launches, kv_append.launches,
                       page_requant.launches))
    before = counts()
    ops.kv_append_quant_op(*[t.clone() for t in state], *args)
    assert counts() == (before[0] + 1, *before[1:])
    pool = dict(zip(("k", "v", "k_scale", "v_scale"), state))
    _append(pool, *args)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, *before[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pool dtype", "row dtype", "scale shape",
                                  "scale dtype", "row shape", "ids dtype",
                                  "rows not contiguous", "cpu scale"])
def test_gpu_kv_append_quant_refusals(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(2)
    (kq, vq, ks, vs), (kn, vn, ids, offs, valid) = _card_call(
        cuda, gen, "int8", torch.bfloat16, N=8, Hkv=2, hd=32)
    err = TypeError
    if case == "pool dtype":
        kq = vq = kq.float()
    elif case == "row dtype":
        kn = vn = kn.half()
    elif case == "scale shape":
        ks, err = ks[:, :1].contiguous(), ValueError
    elif case == "scale dtype":
        ks = vs = ks.double()
    elif case == "row shape":
        kn, err = kn[:, :, :16].contiguous(), ValueError
    elif case == "ids dtype":
        ids = ids.long()
    elif case == "rows not contiguous":
        kn = torch.cat([kn, kn], dim=2)[:, :, ::2]
        err = ValueError
    else:
        vs, err = vs.cpu(), ValueError
    before = kv_append_quant.launches
    with pytest.raises(err):
        kv_append_quant(kq, vq, ks, vs, kn, vn, ids, offs, valid)
    assert kv_append_quant.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(ROW_DTYPES))
@pytest.mark.parametrize("N", [1, 7, 8, 9, 512])
def test_gpu_kv_append_block_edges(cuda, dtype, N):
    """One warp a row, 8 rows a block: the rows at a block's edges, an
    invalid row, an id out of range; then a 12-byte row (bfloat16 Hkv 1 x
    hd 6), copied byte by byte."""
    td = ROW_DTYPES[dtype]
    g = torch.Generator(device=cuda).manual_seed(N)
    for Hkv, hd in ((8, 64), (1, 6)):
        kp = torch.randn((80, 16, Hkv, hd), generator=g, device=cuda).to(td)
        vp = torch.randn_like(kp)
        kn = torch.randn((N, Hkv, hd), generator=g, device=cuda).to(td)
        vn = torch.randn_like(kn)
        slots = torch.randperm(80 * 16, generator=g, device=cuda)[:N]
        ids, offs = (slots // 16).int(), (slots % 16).int()
        valid = torch.ones(N, dtype=torch.int32, device=cuda)
        valid[N // 2] = 0
        ids[-1] = 80 if N > 1 else ids[-1]
        want = kv_append_ref(kp.clone(), vp.clone(), kn, vn, ids, offs, valid)
        before = kv_append.launches
        got = ops.kv_append_op(kp, vp, kn, vn, ids, offs, valid)
        torch.cuda.synchronize()
        assert kv_append.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
