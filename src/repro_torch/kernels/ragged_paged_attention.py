"""Ragged-query paged attention, the fused mixed-batch iteration's
attention core: the CUDA kernel's launcher and its plain PyTorch version.

Counterpart of ``repro.kernels.ragged_paged_attention``. One iteration's
whole query workload — every prefill chunk's tokens and every decode's
single token — arrives as one flat batch of N tokens; token n belongs to
sequence ``tok_seq[n]`` at absolute position ``tok_pos[n]`` and attends to
that sequence's pages through ``block_tables[tok_seq[n]]`` under the mask
``kv position <= tok_pos[n]``. Padded rows carry ``tok_pos == -1`` and get
zeros.

Layout: q (N, Hkv, G, hd); pools (n_pages, page, Hkv, hd);
block_tables (B, max_pages) int32; tok_seq/tok_pos (N,) int32. The kernel
source is ``csrc/ragged_paged_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 48 * 1024      # bytes of shared memory without an opt-in


def ragged_paged_attention_ref(q, k_pool, v_pool, block_tables, tok_seq,
                               tok_pos, *, softcap=None, window=None):
    """The plain version, in the op order of the reference's jnp mirror
    (``repro.models.attention.gqa_mixed_paged``): gather the block table,
    f32 einsum divided by sqrt(hd), softcap, mask, softmax, einsum. Rows
    with ``tok_pos < 0`` are zeroed, the kernel's contract."""
    N, Hkv, G, hd = q.shape
    page = k_pool.shape[1]
    S = block_tables.shape[1] * page
    bt_tok = block_tables[tok_seq.long()].long()          # (N, max_pages)
    k_cache = k_pool[bt_tok].reshape(N, S, Hkv, hd)
    v_cache = v_pool[bt_tok].reshape(N, S, Hkv, hd)
    s = torch.einsum("bhgk,bshk->bhgs", q.float(),
                     k_cache.float()) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    j = torch.arange(S, device=q.device)[None, :]
    live = j <= tok_pos[:, None]
    if window is not None:
        live &= j > tok_pos[:, None] - window
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshk->bhgk", w, v_cache.float())
    out = out.masked_fill((tok_pos < 0)[:, None, None, None], 0.0)
    return out.to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, tok_seq, tok_pos):
    if not q.is_cuda:
        raise ValueError("ragged_paged_attention launches a CUDA kernel; "
                         f"got a tensor on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"ragged_paged_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    N, Hkv, G, hd = q.shape
    n_pages, page, pool_hkv, pool_hd = k_pool.shape
    if hd not in HEAD_DIMS or (pool_hkv, pool_hd) != (Hkv, hd) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} / pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)} not "
                         f"taken (head_dim in {HEAD_DIMS})")
    if block_tables.dim() != 2 or tok_seq.shape != (N,) \
            or tok_pos.shape != (N,):
        raise ValueError("block_tables must be (B, max_pages), tok_seq and "
                         "tok_pos (N,)")
    for t in (k_pool, v_pool):
        if t.dtype != q.dtype:
            raise TypeError("q and the pools must share a dtype")
    for t in (block_tables, tok_seq, tok_pos):
        if t.dtype != torch.int32:
            raise TypeError("block_tables, tok_seq and tok_pos must be int32")
    for t in (q, k_pool, v_pool, block_tables, tok_seq, tok_pos):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    smem = 4 * (2 * G * hd + page * (hd + 1) + page * hd + G * page + 3 * G)
    if smem > SMEM_LIMIT:
        raise ValueError(f"G={G}, page={page}, hd={hd} needs {smem} bytes "
                         f"of shared memory, above {SMEM_LIMIT}")


def ragged_paged_attention(q, k_pool, v_pool, block_tables, tok_seq,
                           tok_pos, *, softcap=None, window=None):
    """Launch the CUDA kernel on the current stream; returns
    (N, Hkv, G, hd) in q's dtype. Raises on any operand the kernel does
    not take, a CPU tensor included."""
    _check(q, k_pool, v_pool, block_tables, tok_seq, tok_pos)
    N, Hkv, G, hd = q.shape
    page = k_pool.shape[1]
    out = torch.empty_like(q)
    err = _build.lib().ragged_paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), tok_seq.data_ptr(), tok_pos.data_ptr(),
        out.data_ptr(), N, Hkv, G, hd, page, block_tables.shape[1],
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(hd),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
