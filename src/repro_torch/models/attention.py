"""GQA attention over paged KV pools: the fused mixed-batch path and the
per-call decode and chunked-prefill paths.

Counterpart of the ``init_gqa`` / ``gqa_mixed_paged`` /
``gqa_decode_paged`` / ``gqa_extend_paged`` slice of
``repro.models.attention``. The per-layer pools are updated in place:
every new token's K/V is appended (``kv_append``) before attention reads
the pools, so one mask ``kv position <= token position`` gives both
decode tokens and chunk-internal causality.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttentionCfg
from repro_torch.kernels.ops import (kv_append_op, paged_attention_op,
                                     ragged_paged_attention_op)
from repro_torch.models.common import apply_rope, dense_init, softcap

NEG_INF = -1e30


def effective_window(a: AttentionCfg, override) -> Optional[int]:
    """Resolve a window override against the block's configured window:
    "cfg" -> the config's sliding window; None -> full attention; int w ->
    min(w, cfg window)."""
    if a.kind == "mla":
        return None
    if override == "cfg":
        return a.sliding_window
    if override is None:
        return None
    return min(override, a.sliding_window) if a.sliding_window else override


def init_gqa(generator: torch.Generator, d_model: int, a: AttentionCfg, *,
             dtype: torch.dtype, device):
    kw = dict(dtype=dtype, device=device)
    p = {"wq": dense_init(generator, (d_model, a.n_heads, a.head_dim), **kw),
         "wk": dense_init(generator, (d_model, a.n_kv_heads, a.head_dim),
                          **kw),
         "wv": dense_init(generator, (d_model, a.n_kv_heads, a.head_dim),
                          **kw),
         "wo": dense_init(generator, (a.n_heads, a.head_dim, d_model),
                          in_axis=0, **kw)}
    if a.qkv_bias:
        p["bq"] = torch.zeros((a.n_heads, a.head_dim), **kw)
        p["bk"] = torch.zeros((a.n_kv_heads, a.head_dim), **kw)
        p["bv"] = torch.zeros((a.n_kv_heads, a.head_dim), **kw)
    return p


def _project(x, w):
    """x (N, d) @ w (d, heads, hd) -> (N, heads, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[0], *w.shape[1:])


def gqa_mixed_paged(p, a: AttentionCfg, x, pool, block_tables, tok_seq,
                    tok_pos, *, window_override="cfg"):
    """x: (N, d) flat mixed-batch tokens; pool {"k","v"}: this layer's
    (n_pages, page, Hkv, hd) pools, written in place; block_tables:
    (B, max_pages) int32; tok_seq/tok_pos: (N,) int32 (tok_pos == -1
    marks a padded row: its K/V write is dropped and its output is
    zeros). Returns out (N, d)."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    window = effective_window(a, window_override)
    N, d = x.shape
    n_pages, page, Hkv, hd = pool["k"].shape
    valid = tok_pos >= 0
    pos = tok_pos.clamp(min=0)
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q[:, None], pos[:, None], a.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], a.rope_theta)[:, 0]

    pids = block_tables[tok_seq.long(), (pos // page).long()]
    i32 = torch.int32
    kv_append_op(pool["k"], pool["v"], k.contiguous(), v.contiguous(),
                 pids.to(i32), (pos % page).to(i32), valid.to(i32))
    G = a.n_heads // Hkv
    out = ragged_paged_attention_op(
        q.reshape(N, Hkv, G, hd), pool["k"], pool["v"], block_tables,
        tok_seq, tok_pos, softcap=a.logit_softcap, window=window)
    out = out.reshape(N, a.n_heads * hd).to(x.dtype)
    return out @ p["wo"].reshape(a.n_heads * hd, d)


def gqa_decode_paged(p, a: AttentionCfg, x, pool, block_tables, ctx_lens, *,
                     window_override="cfg"):
    """One new token per sequence, written and attended in place.

    x: (B, d); pool {"k","v"}: this layer's (n_pages, page, Hkv, hd)
    pools, written in place; block_tables: (B, max_pages) int32;
    ctx_lens: (B,) int32 context length including the new token
    (ctx_lens == 0 marks a padded row: its K/V write is dropped and its
    attention output is zeros). Returns out (B, d)."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    window = effective_window(a, window_override)
    B, d = x.shape
    n_pages, page, Hkv, hd = pool["k"].shape
    valid = ctx_lens > 0
    pos = (ctx_lens - 1).clamp(min=0)
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q[:, None], pos[:, None], a.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], a.rope_theta)[:, 0]

    bidx = torch.arange(B, device=x.device)
    pids = block_tables[bidx, (pos // page).long()]
    i32 = torch.int32
    kv_append_op(pool["k"], pool["v"], k.contiguous(), v.contiguous(),
                 pids.to(i32), (pos % page).to(i32), valid.to(i32))
    G = a.n_heads // Hkv
    out = paged_attention_op(
        q.reshape(B, Hkv, G, hd).contiguous(), pool["k"], pool["v"],
        block_tables, ctx_lens, softcap=a.logit_softcap, window=window)
    out = out.reshape(B, a.n_heads * hd).to(x.dtype)
    return out @ p["wo"].reshape(a.n_heads * hd, d)


def gqa_extend_paged(p, a: AttentionCfg, x, pool, block_tables, start,
                     n_new, *, window_override="cfg"):
    """Chunked prefill writing pool pages as they are computed.

    x: (B, T, d) at absolute positions start[b] + t; only the first
    n_new[b] tokens of each row are real, the rest are bucket padding
    whose K/V writes are dropped (their outputs are garbage and ignored
    by the caller). All written positions must fit the block table
    (start + T <= max_pages * page). The attention is plain PyTorch, a
    block-table gather then einsum and softmax in the reference's op
    order, as the reference leaves it to XLA. Returns out (B, T, d)."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    window = effective_window(a, window_override)
    B, T, d = x.shape
    n_pages, page, Hkv, hd = pool["k"].shape
    S = block_tables.shape[1] * page
    t_idx = torch.arange(T, device=x.device)
    positions = start[:, None] + t_idx[None, :]                   # (B, T)
    xf = x.reshape(B * T, d)
    q = _project(xf, p["wq"]).reshape(B, T, a.n_heads, hd)
    k = _project(xf, p["wk"]).reshape(B, T, Hkv, hd)
    v = _project(xf, p["wv"]).reshape(B, T, Hkv, hd)
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    t_valid = t_idx[None, :] < n_new[:, None]
    pids = torch.gather(block_tables, 1, (positions // page).long())
    i32 = torch.int32
    kv_append_op(pool["k"], pool["v"], k.reshape(B * T, Hkv, hd),
                 v.reshape(B * T, Hkv, hd), pids.reshape(-1).to(i32),
                 (positions % page).reshape(-1).to(i32),
                 t_valid.reshape(-1).to(i32))

    bt = block_tables.long()
    k_cache = pool["k"][bt].reshape(B, S, Hkv, hd)
    v_cache = pool["v"][bt].reshape(B, S, Hkv, hd)
    G = a.n_heads // Hkv
    qh = q.reshape(B, T, Hkv, G, hd).float()
    s = torch.einsum("bthgk,bshk->bhgts", qh,
                     k_cache.float()) / math.sqrt(hd)
    if a.logit_softcap is not None:
        s = softcap(s, a.logit_softcap)
    j = torch.arange(S, device=x.device)[None, None, :]
    qpos = positions[:, :, None]
    live = j <= qpos
    if window is not None:
        live &= j > qpos - window
    s = s.masked_fill(~live[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bshk->bthgk", w, v_cache.float())
    out = out.reshape(B * T, a.n_heads * hd).to(x.dtype)
    return (out @ p["wo"].reshape(a.n_heads * hd, d)).reshape(B, T, d)


def init_pool(a: AttentionCfg, n_pages: int, page: int, *,
              dtype: torch.dtype, device, periods: int):
    """Zeroed paged K/V pools of one attention block, stacked over the
    group's layer periods: {"k","v"}: (periods, n_pages, page, Hkv, hd)."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    shape = (periods, n_pages, page, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
