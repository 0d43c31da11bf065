"""Paged decode attention, the per-call decode path's attention core: the
CUDA kernel's launcher and its plain PyTorch version.

Counterpart of ``repro.kernels.paged_attention``. One new query token per
sequence: row b's G grouped query heads attend over the first
``ctx_lens[b]`` positions of its pages ``block_tables[b, i]`` (the last
``window`` of them when a window is set). Rows with ``ctx_lens == 0`` are
padding and get zeros.

Layout: q (B, Hkv, G, hd); pools (n_pages, page, Hkv, hd);
block_tables (B, max_pages) int32; ctx_lens (B,) int32. Pools are in
q's dtype, or quantized (int8, float8_e4m3fn, float8_e5m2) with
``k_scale``/``v_scale`` (n_pages, Hkv) float32, dequantized in-register.
The kernel source is ``csrc/paged_attention.cu``; its bf16 route is the
tensor-core sweep of ``csrc/paged_tc.cuh``, the ragged problem with one
row per sequence.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant import (attention_pool_code,
                                          dequant_gathered, gather_pages)
from repro_torch.kernels.ragged_paged_attention import (sm_count,
                                                        split_count,
                                                        split_scratch,
                                                        tensor_cores)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 48 * 1024      # the CUDA-core kernel's shared memory, no opt-in


def _attend(q, k_cache, v_cache, ctx_lens, softcap, window):
    """f32 einsum divided by sqrt(hd), softcap, mask, softmax, einsum over
    caches gathered per sequence, (B, S, Hkv, hd); rows with
    ``ctx_lens == 0`` are zeroed, the kernel's contract."""
    hd = q.shape[-1]
    S = k_cache.shape[1]
    s = torch.einsum("bhgk,bshk->bhgs", q.float(),
                     k_cache.float()) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    j = torch.arange(S, device=q.device)[None, :]
    live = j < ctx_lens[:, None]
    if window is not None:
        live &= j > ctx_lens[:, None] - 1 - window
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshk->bhgk", w, v_cache.float())
    out = out.masked_fill((ctx_lens <= 0)[:, None, None, None], 0.0)
    return out.to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_tables, ctx_lens, *,
                        softcap=None, window=None):
    """The plain version, in the op order of the reference's jnp mirror
    inside ``repro.models.attention.gqa_decode_paged``: gather the block
    table, f32 einsum divided by sqrt(hd), softcap, mask, softmax,
    einsum. Rows with ``ctx_lens == 0`` are zeroed, the kernel's
    contract."""
    B, Hkv, G, hd = q.shape
    S = block_tables.shape[1] * k_pool.shape[1]
    bt = block_tables.long()
    return _attend(q, k_pool[bt].reshape(B, S, Hkv, hd),
                   v_pool[bt].reshape(B, S, Hkv, hd), ctx_lens, softcap,
                   window)


def paged_attention_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                              block_tables, ctx_lens, *, softcap=None,
                              window=None):
    """The plain version over quantized pools, as the reference's
    ``paged_attention_quant_ref``: gather pages and their scales through
    the block table, dequantize in f32, then the same math."""
    B, Hkv, G, hd = q.shape
    S = block_tables.shape[1] * k_pool.shape[1]
    bt = block_tables.long()
    k = dequant_gathered(gather_pages(k_pool, bt), k_scale[bt])
    v = dequant_gathered(gather_pages(v_pool, bt), v_scale[bt])
    return _attend(q, k.reshape(B, S, Hkv, hd), v.reshape(B, S, Hkv, hd),
                   ctx_lens, softcap, window)


def _smem_bytes(G: int, page: int, hd: int) -> int:
    # the CUDA-core kernel's staged tiles are float32 whatever the payload: a
    # 16-byte load carries 16 / element size elements, dequantized as they
    # are stored
    return 4 * (2 * G * hd + page * (hd + 1) + page * hd + G * page + 3 * G)


def _check(q, k_pool, v_pool, k_scale, v_scale, block_tables,
           ctx_lens) -> int:
    """Raise on any operand the kernel does not take (the device is checked
    by the launcher); returns the pool code."""
    if q.dtype not in DTYPES:
        raise TypeError(f"paged_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    B, Hkv, G, hd = q.shape
    n_pages, page, pool_hkv, pool_hd = k_pool.shape
    if hd not in HEAD_DIMS or (pool_hkv, pool_hd) != (Hkv, hd) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} / pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)} not "
                         f"taken (head_dim in {HEAD_DIMS})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or ctx_lens.shape != (B,):
        raise ValueError("block_tables must be (B, max_pages) and ctx_lens "
                         "(B,)")
    pool_code = attention_pool_code("paged_attention", q, k_pool, v_pool,
                                    k_scale, v_scale)
    for t in (block_tables, ctx_lens):
        if t.dtype != torch.int32:
            raise TypeError("block_tables and ctx_lens must be int32")
    for t in (q, k_pool, v_pool, block_tables, ctx_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    # the K/V tiles are staged with 16-byte loads
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("the pools must start on a 16-byte boundary")
    if tensor_cores(q):
        # the tensor-core sweep's shared memory depends on hd and the
        # payload only (opted in by the launcher)
        return pool_code
    smem = _smem_bytes(G, page, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"G={G}, page={page}, hd={hd} needs {smem} bytes "
                         f"of shared memory, above {SMEM_LIMIT}")
    return pool_code


def paged_attention(q, k_pool, v_pool, block_tables, ctx_lens, *,
                    k_scale=None, v_scale=None, softcap=None, window=None):
    """Launch the CUDA kernel on the current stream; returns
    (B, Hkv, G, hd) in q's dtype. Quantized pools need ``k_scale`` and
    ``v_scale``. Raises on any operand the kernel does not take, a CPU
    tensor included."""
    _build.require_cuda("paged_attention", q)
    pool_code = _check(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                       ctx_lens)
    B, Hkv, G, hd = q.shape
    page = k_pool.shape[1]
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    splits, part, counters, _scratch = 1, None, None, None
    if tensor_cores(q):
        splits = split_count(B * Hkv, max_pages * page,
                             sm_count(q.device.index))
        part, counters, _scratch = split_scratch(splits, q, stream)
    err = _build.lib().paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        part, counters,
        B, Hkv, G, hd, page, max_pages,
        0 if window is None else int(window), splits,
        0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(hd),
        DTYPES[q.dtype], pool_code, stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
