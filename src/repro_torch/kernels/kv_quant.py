"""Quantized KV pages with per-(page, kv head) float32 scales: the fused
quantized-append CUDA kernel's launcher (``kv_append_quant``), the
``page_requant`` kernel's launcher, and their plain PyTorch versions.

Counterpart of ``repro.kernels.kv_quant`` (DESIGN.md §17). A quantized
pool stores its payload in int8, float8_e4m3 or float8_e5m2 beside one
float32 scale per (page, kv head), ``k_scale``/``v_scale`` of shape
(n_pages, Hkv), in the same pool dict, so COW copies and swap slabs move
payload and scales together. The append is the reference's three phases:

  A. scale update: each row's amax over the head dim, scatter-maxed into
     its page's scales, ``new = max(old, amax / qmax)``;
  B. page requant: every touched page's payload is rescaled once by
     ``old / new``, so a page never mixes scales;
  C. row write: the rows, quantized at the new scales, go into their
     slots.

The plain version ``kv_append_quant_ref`` runs them op for op as the
reference does, with ``page_requant_ref`` and ``kv_append_ref`` for B and
C. On the card one kernel (``csrc/kv_append_quant.cu``) runs all three:
one block per (row, kv head), of which the first valid row naming each
page owns that (page, head); ``kv_append_quant_owner_ref`` is the same
decomposition in plain PyTorch. ``page_requant`` (``csrc/page_requant.cu``)
stays the reference's standalone phase-B op; the main path no longer
launches it.

Unlike the reference, pools and scales are updated in place. Every
quantize or requant clips to ±qmax before the cast (a float8 cast of an
out-of-range value is NaN); int8 rounds half to even first. A zero scale
means the page holds nothing; its ratio is 0. Gathers and scatters of the
payload go through a uint8 view, which every device indexes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_append import _raw_stream, kv_append_ref

# public name -> (storage dtype, largest representable magnitude)
KV_QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "float8_e4m3": (torch.float8_e4m3fn, 448.0),
    "float8_e5m2": (torch.float8_e5m2, 57344.0),
}
# the kernels' payload codes
PAYLOAD_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1,
                 torch.float8_e5m2: 2}
# the fused append's row codes
ROW_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kv_quant_dtype(name: str) -> torch.dtype:
    """Resolve a public kv_dtype name to its storage dtype."""
    try:
        return KV_QUANT_DTYPES[name][0]
    except KeyError:
        raise ValueError(
            f"unsupported kv_dtype {name!r}; "
            f"choose from {sorted(KV_QUANT_DTYPES)}") from None


def kv_quant_qmax(dtype: torch.dtype) -> float:
    """qmax of a quantized pool's storage dtype."""
    for qd, qmax in KV_QUANT_DTYPES.values():
        if qd == dtype:
            return qmax
    raise ValueError(f"not a quantized KV pool dtype: {dtype}")


def _cast(y, qdtype):
    """Round (int8), clip to ±qmax, cast: the reference's order."""
    qmax = kv_quant_qmax(qdtype)
    if qdtype == torch.int8:
        y = torch.round(y)                      # half to even, as jnp.rint
    return y.clamp(-qmax, qmax).to(qdtype)


def quantize_rows(x, scale, qdtype):
    """x: (..., Hkv, hd) -> qdtype, dividing by scale (..., Hkv). Zero
    scales (an empty page) quantize to 0."""
    s = scale[..., None]
    y = torch.where(s > 0, x.float() / torch.where(s > 0, s, 1.0), 0.0)
    return _cast(y, qdtype)


def requant_payload(q, ratio, qdtype):
    """Rescale quantized payload q (..., Hkv, hd) by ratio (..., Hkv) =
    old_scale / new_scale; ratio 1 is the identity for every dtype."""
    return _cast(q.float() * ratio[..., None], qdtype)


def gather_pages(pool, idx):
    """pool[idx] along the page axis; a 1-byte payload is gathered
    through a uint8 view."""
    if pool.element_size() == 1:
        return pool.view(torch.uint8)[idx].view(pool.dtype)
    return pool[idx]


def attention_pool_code(name, q, k_pool, v_pool, k_scale, v_scale) -> int:
    """Check the pool and scale operands of an attention kernel and
    return its pool code: 0 for pools in q's dtype (no scales), 1 + the
    payload code for quantized pools, which need both scales,
    (n_pages, Hkv) float32."""
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{name}: the pools must share a dtype")
    if k_pool.dtype not in PAYLOAD_CODES:
        if k_pool.dtype != q.dtype:
            raise TypeError(f"{name}: q and unquantized pools must share a "
                            "dtype")
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"{name}: scales go with quantized pools only")
        return 0
    want = (k_pool.shape[0], k_pool.shape[2])
    for s in (k_scale, v_scale):
        if s is None or s.dtype != torch.float32 or tuple(s.shape) != want \
                or s.device != k_pool.device or not s.is_contiguous():
            raise ValueError(f"{name}: {k_pool.dtype} pools need k_scale "
                             f"and v_scale, contiguous {want} float32 on "
                             "the pools' device")
    return 1 + PAYLOAD_CODES[k_pool.dtype]


def dequant_gathered(pages, scale_pages):
    """Dequantize a block-table gather of quantized pages.
    pages: (..., n_sel, page, Hkv, hd); scale_pages: (..., n_sel, Hkv)
    float32. Returns float32 with each (page, head) scale broadcast over
    the page's slots and the head dim."""
    return pages.float() * scale_pages[..., None, :, None]


def updated_page_scales(k_scale, v_scale, k_new, v_new, pids, qmax):
    """Phase A, in place: ``scale[p] = max(scale[p], amax / qmax)`` over
    the rows naming page p. k_scale/v_scale (n_pages, Hkv) float32;
    k_new/v_new (N, Hkv, hd); pids (N,) with an out-of-range id for a
    row whose update is dropped. Such a row adds 0 to the clipped page,
    which leaves it as it was, since scales are never negative."""
    n_pages = k_scale.shape[0]
    live = ((pids >= 0) & (pids < n_pages))[:, None]
    idx = pids.clamp(0, n_pages - 1).long()[:, None].expand(-1,
                                                            k_scale.shape[1])
    # qmax as a tensor on the rows' device: PyTorch on CUDA divides by a
    # Python number by multiplying with its reciprocal, which can miss the
    # reference's quotient by one bit; by a tensor it divides everywhere
    qmax = k_scale.new_full((), qmax)
    for scale, rows in ((k_scale, k_new), (v_scale, v_new)):
        amax = rows.float().abs().amax(dim=-1) / qmax          # (N, Hkv)
        scale.scatter_reduce_(0, idx, torch.where(live, amax, 0.0), "amax")
    return k_scale, v_scale


def first_occurrence(pids):
    """first[i] is True iff no earlier row names the same page: the one
    row per page that runs the phase-B requant."""
    eq = pids[:, None] == pids[None, :]
    return ~torch.tril(eq, diagonal=-1).any(dim=1)


def _ratio(old, new):
    return torch.where(new > 0, old / torch.where(new > 0, new, 1.0), 0.0)


def page_requant_ref(k_pool, v_pool, k_ratio, v_ratio, pids,
                     discard_pid=None):
    """The plain version of phase B, in place: page pids[i] gets payload
    *= ratio[i], re-rounded and cast, for the first row naming each page.
    Later rows naming it, and rows whose id is out of range, write
    nothing (the reference routes them to ``discard_pid``).
    Pools (n_pages, page, Hkv, hd) quantized; ratios (N, Hkv) float32;
    pids (N,) int32. Returns the pools."""
    del discard_pid
    n_pages = k_pool.shape[0]
    keep = first_occurrence(pids) & (pids >= 0) & (pids < n_pages)
    ids = pids[keep].long()
    for pool, ratio in ((k_pool, k_ratio), (v_pool, v_ratio)):
        pages = requant_payload(gather_pages(pool, ids),
                                ratio[keep][:, None, :], pool.dtype)
        pool.view(torch.uint8)[ids] = pages.view(torch.uint8)
    return k_pool, v_pool


def _check_requant(k_pool, v_pool, k_ratio, v_ratio, pids):
    if not k_pool.is_cuda:
        raise ValueError("page_requant launches a CUDA kernel; got a tensor "
                         f"on {k_pool.device}")
    if k_pool.dtype not in PAYLOAD_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"page_requant takes int8, float8_e4m3fn or "
                        f"float8_e5m2 pools of one dtype, got {k_pool.dtype} "
                        f"and {v_pool.dtype}")
    n_pages, page, Hkv, hd = k_pool.shape
    N = pids.shape[0]
    if v_pool.shape != k_pool.shape or k_ratio.shape != (N, Hkv) \
            or v_ratio.shape != (N, Hkv) or pids.shape != (N,):
        raise ValueError(f"pools {tuple(k_pool.shape)}, ratios "
                         f"{tuple(k_ratio.shape)} {tuple(v_ratio.shape)}, "
                         f"pids {tuple(pids.shape)} not taken: pools "
                         "(n_pages, page, Hkv, hd), ratios (N, Hkv), pids "
                         "(N,)")
    if k_ratio.dtype != torch.float32 or v_ratio.dtype != torch.float32 \
            or pids.dtype != torch.int32:
        raise TypeError("ratios must be float32 and pids int32")
    for t in (k_pool, v_pool, k_ratio, v_ratio, pids):
        if t.device != k_pool.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def page_requant(k_pool, v_pool, k_ratio, v_ratio, pids, discard_pid=None):
    """Launch the CUDA kernel on the current stream: the same function as
    ``page_requant_ref``, in place; returns the pools. ``discard_pid`` is
    kept for the reference's signature: on a parallel grid a write to one
    discard page from many rows would race, so those rows write
    nothing. Raises on any operand the kernel does not take, a CPU
    tensor included."""
    _check_requant(k_pool, v_pool, k_ratio, v_ratio, pids)
    del discard_pid
    n_pages, page, Hkv, hd = k_pool.shape
    err = _build.lib().page_requant_launch(
        k_pool.data_ptr(), v_pool.data_ptr(), k_ratio.data_ptr(),
        v_ratio.data_ptr(), pids.data_ptr(), pids.shape[0], n_pages, page,
        Hkv, hd, PAYLOAD_CODES[k_pool.dtype],
        torch.cuda.current_stream(k_pool.device).cuda_stream)
    _build.check(err, "page_requant")
    page_requant.launches += 1
    return k_pool, v_pool


page_requant.launches = 0


def kv_append_quant_ref(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                        page_ids, offsets, valid, discard_pid=None):
    """The plain version of the quantized append, following
    ``repro.kernels.ref.kv_append_quant_ref`` op for op, in place.
    Pools (n_pages, page, Hkv, hd) quantized; scales (n_pages, Hkv)
    float32; rows (N, Hkv, hd); page_ids/offsets/valid (N,) int32.
    Returns (k_pool, v_pool, k_scale, v_scale)."""
    n_pages = k_pool.shape[0]
    qdtype = k_pool.dtype
    live = valid != 0
    pids = torch.where(live, page_ids, n_pages).to(torch.int32)
    gidx = pids.clamp(max=n_pages - 1).long()
    k_old, v_old = k_scale[gidx], v_scale[gidx]
    updated_page_scales(k_scale, v_scale, k_new, v_new, pids,
                        kv_quant_qmax(qdtype))
    k_s, v_s = k_scale[gidx], v_scale[gidx]
    page_requant_ref(k_pool, v_pool, _ratio(k_old, k_s), _ratio(v_old, v_s),
                     pids, discard_pid)
    u8 = torch.uint8
    kv_append_ref(k_pool.view(u8), v_pool.view(u8),
                  quantize_rows(k_new, k_s, qdtype).view(u8),
                  quantize_rows(v_new, v_s, qdtype).view(u8), pids, offsets,
                  live.to(torch.int32))
    return k_pool, v_pool, k_scale, v_scale


def kv_append_quant_owner_ref(k_pool, v_pool, k_scale, v_scale, k_new,
                              v_new, page_ids, offsets, valid,
                              discard_pid=None):
    """The fused kernel's decomposition in plain PyTorch, in place: one
    owner per (page, kv head), taken in the order of the rows that first
    name each page, as ``csrc/kv_append_quant.cu``'s blocks divide the
    work. A valid row with an id in [0, n_pages) that no earlier valid row
    shares owns its page; its members are the valid rows at or after it
    naming the page. Per head and pool, the owner forms the members' amax
    in float32, ``new = max(old, amax / qmax)``, requantizes the head's
    slice of the page by ``old / new`` and writes the members' head
    slices quantized at ``new`` (a member whose offset lies outside the
    page writes nothing). Equal to ``kv_append_quant_ref`` byte for byte.
    Returns (k_pool, v_pool, k_scale, v_scale)."""
    del discard_pid
    n_pages, page, Hkv, _ = k_pool.shape
    qdtype = k_pool.dtype
    qmax = kv_quant_qmax(qdtype)
    ids, live = page_ids.tolist(), (valid != 0).tolist()
    offs = offsets.tolist()
    u8 = torch.uint8
    named = set()
    for i, (pid, ok) in enumerate(zip(ids, live)):
        if not ok or not 0 <= pid < n_pages or pid in named:
            continue
        named.add(pid)
        members = [j for j in range(i, len(ids)) if live[j] and ids[j] == pid]
        writes = [j for j in members if 0 <= offs[j] < page]
        slots = torch.tensor([offs[j] for j in writes], dtype=torch.long)
        for h in range(Hkv):
            for pool, scale, rows in ((k_pool, k_scale, k_new),
                                      (v_pool, v_scale, v_new)):
                old = scale[pid, h].clone()
                amax = rows[members, h].float().abs().amax()
                new = torch.maximum(old, amax / qmax)
                payload = pool.view(u8)[pid, :, h].view(qdtype)
                pool.view(u8)[pid, :, h] = _cast(
                    payload.float() * _ratio(old, new), qdtype).view(u8)
                if writes:
                    q = quantize_rows(rows[writes, h],
                                      new.expand(len(writes)), qdtype)
                    pool.view(u8)[pid, slots, h] = q.view(u8)
                scale[pid, h] = new
    return k_pool, v_pool, k_scale, v_scale


def _check_append_quant(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                        page_ids, offsets, valid):
    if not k_pool.is_cuda:
        raise ValueError("kv_append_quant launches a CUDA kernel; got a "
                         f"tensor on {k_pool.device}")
    if k_pool.dtype not in PAYLOAD_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"kv_append_quant takes int8, float8_e4m3fn or "
                        f"float8_e5m2 pools of one dtype, got {k_pool.dtype} "
                        f"and {v_pool.dtype}")
    if k_new.dtype not in ROW_CODES or v_new.dtype != k_new.dtype:
        raise TypeError(f"kv_append_quant takes float32 or bfloat16 rows of "
                        f"one dtype, got {k_new.dtype} and {v_new.dtype}")
    if not k_scale.dtype == v_scale.dtype == torch.float32:
        raise TypeError("scales must be float32")
    n_pages, page, Hkv, hd = k_pool.shape
    N = k_new.shape[0]
    if v_pool.shape != k_pool.shape or k_new.shape != (N, Hkv, hd) \
            or v_new.shape != k_new.shape \
            or not k_scale.shape == v_scale.shape == (n_pages, Hkv):
        raise ValueError(f"pools {tuple(k_pool.shape)}, scales "
                         f"{tuple(k_scale.shape)} {tuple(v_scale.shape)}, "
                         f"rows {tuple(k_new.shape)} {tuple(v_new.shape)} "
                         "not taken: pools (n_pages, page, Hkv, hd), scales "
                         "(n_pages, Hkv), rows (N, Hkv, hd)")
    if not (page_ids.dtype == offsets.dtype == valid.dtype == torch.int32
            and page_ids.shape == offsets.shape == valid.shape == (N,)):
        raise TypeError("page_ids, offsets and valid must be (N,) int32")
    ops = (k_pool, v_pool, k_scale, v_scale, k_new, v_new, page_ids,
           offsets, valid)
    if not all(t.is_contiguous() for t in ops) \
            or len({t.get_device() for t in ops}) != 1:
        raise ValueError("all operands must be contiguous on one device")


def kv_append_quant(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                    page_ids, offsets, valid, discard_pid=None):
    """Launch the fused CUDA kernel on the current stream: the same
    function as ``kv_append_quant_ref`` (phases A, B and C), in place, in
    one launch with no allocation; returns (k_pool, v_pool, k_scale,
    v_scale). ``discard_pid`` is kept for the reference's signature: no
    row writes to it. Raises on any operand the kernel does not take, a
    CPU tensor included."""
    _check_append_quant(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                        page_ids, offsets, valid)
    del discard_pid
    n_pages, page, Hkv, hd = k_pool.shape
    err = _build.lib().kv_append_quant_launch(
        k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        page_ids.data_ptr(), offsets.data_ptr(), valid.data_ptr(),
        k_new.shape[0], n_pages, page, Hkv, hd, ROW_CODES[k_new.dtype],
        PAYLOAD_CODES[k_pool.dtype], _raw_stream(k_pool))
    _build.check(err, "kv_append_quant")
    kv_append_quant.launches += 1
    return k_pool, v_pool, k_scale, v_scale


kv_append_quant.launches = 0
