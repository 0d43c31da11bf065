"""Quantized KV pages with per-(page, kv head) float32 scales: the
``page_requant`` CUDA kernel's launcher, its plain PyTorch version, and
the requantize-on-append composite ``kv_append_quant``.

Counterpart of ``repro.kernels.kv_quant`` (DESIGN.md §17). A quantized
pool stores its payload in int8, float8_e4m3 or float8_e5m2 beside one
float32 scale per (page, kv head), ``k_scale``/``v_scale`` of shape
(n_pages, Hkv), in the same pool dict, so COW copies and swap slabs move
payload and scales together. The append runs the reference's three
phases:

  A. scale update: each row's amax over the head dim, scatter-maxed into
     its page's scales, ``new = max(old, amax / qmax)`` (PyTorch ops);
  B. page requant: every touched page's payload is rescaled once by
     ``old / new`` (the ``page_requant`` kernel), so a page never mixes
     scales;
  C. row write: the rows, quantized at the new scales, go through the
     ordinary ``kv_append`` kernel, which copies bytes.

Unlike the reference, pools and scales are updated in place: the old
scales are gathered and the ratios formed before the new scales are
written back. Every quantize or requant clips to ±qmax before the cast
(a float8 cast of an out-of-range value is NaN); int8 rounds half to
even first. A zero scale means the page holds nothing; its ratio is 0.
Gathers and scatters of the payload go through a uint8 view, which every
device indexes. The kernel source is ``csrc/page_requant.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_append import kv_append, kv_append_ref

# public name -> (storage dtype, largest representable magnitude)
KV_QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "float8_e4m3": (torch.float8_e4m3fn, 448.0),
    "float8_e5m2": (torch.float8_e5m2, 57344.0),
}
# the kernels' payload codes
PAYLOAD_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1,
                 torch.float8_e5m2: 2}


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


def _kv_append_quant(requant, append, k_pool, v_pool, k_scale, v_scale,
                     k_new, v_new, page_ids, offsets, valid, discard_pid):
    """The three phases around the given phase-B and phase-C functions."""
    n_pages = k_pool.shape[0]
    qdtype = k_pool.dtype
    live = valid != 0
    pids = torch.where(live, page_ids, n_pages).to(torch.int32)
    gidx = pids.clamp(max=n_pages - 1).long()
    k_old, v_old = k_scale[gidx], v_scale[gidx]
    updated_page_scales(k_scale, v_scale, k_new, v_new, pids,
                        kv_quant_qmax(qdtype))
    k_s, v_s = k_scale[gidx], v_scale[gidx]
    requant(k_pool, v_pool, _ratio(k_old, k_s), _ratio(v_old, v_s), pids,
            discard_pid)
    u8 = torch.uint8
    append(k_pool.view(u8), v_pool.view(u8),
           quantize_rows(k_new, k_s, qdtype).view(u8),
           quantize_rows(v_new, v_s, qdtype).view(u8), pids, offsets,
           live.to(torch.int32))
    return k_pool, v_pool, k_scale, v_scale


def kv_append_quant_ref(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                        page_ids, offsets, valid, discard_pid=None):
    """The plain version of the quantized append, following
    ``repro.kernels.ref.kv_append_quant_ref`` op for op, in place.
    Pools (n_pages, page, Hkv, hd) quantized; scales (n_pages, Hkv)
    float32; rows (N, Hkv, hd); page_ids/offsets/valid (N,) int32.
    Returns (k_pool, v_pool, k_scale, v_scale)."""
    return _kv_append_quant(page_requant_ref, kv_append_ref, k_pool, v_pool,
                            k_scale, v_scale, k_new, v_new, page_ids,
                            offsets, valid, discard_pid)


def kv_append_quant(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                    page_ids, offsets, valid, discard_pid=None):
    """The card path, in place: phases A and C's quantize as PyTorch ops
    on the current stream, phase B on the ``page_requant`` kernel and
    phase C's write on the ``kv_append`` kernel (1-byte rows, copied as
    bytes). Returns (k_pool, v_pool, k_scale, v_scale)."""
    return _kv_append_quant(page_requant, kv_append, k_pool, v_pool,
                            k_scale, v_scale, k_new, v_new, page_ids,
                            offsets, valid, discard_pid)
