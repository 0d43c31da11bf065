"""GQA attention: the full-sequence forward (training, prefill) over the
flash kernels; single-token decode and chunked prefill over slotted
caches (the gather path); and paged KV pools' fused mixed-batch path and
per-call decode and chunked-prefill paths.

Counterpart of the ``init_gqa`` / ``gqa_qkv`` / ``gqa_forward`` /
``attention_forward`` / ``gqa_decode`` / ``gqa_extend`` /
``attention_decode`` / ``attention_extend`` / ``gqa_mixed_paged`` /
``gqa_decode_paged`` / ``gqa_extend_paged`` / ``init_cache_shapes`` slice
of ``repro.models.attention``. A slotted cache is {"k","v"}: (B, S, Hkv,
hd), one row of S slots per sequence; decode and extend return new
caches and leave theirs as they were, as the reference's ``.at[].set``
does, and their attention is plain PyTorch (float32 scores, the
reference's op order), which the reference leaves to XLA. The per-layer
pools are updated in place: every new token's K/V is appended
(``kv_append``) before attention reads the pools, so one mask ``kv
position <= token position`` gives both decode tokens and chunk-internal
causality. A quantized pool (DESIGN.md §17) carries
``k_scale``/``v_scale`` (n_pages, Hkv) float32 beside its 1-byte payload:
the append is ``kv_append_quant`` and attention dequantizes with the
scales.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttentionCfg
from repro_torch.kernels.kv_quant import (dequant_gathered, gather_pages,
                                          kv_quant_dtype)
from repro_torch.kernels.ops import (flash_attention_op, kv_append_op,
                                     kv_append_quant_op, paged_attention_op,
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


def gqa_qkv(p, a: AttentionCfg, x, positions):
    """x: (B, T, d); positions (T,) or (B, T). Returns roped q
    (B, T, Hq, hd), k and v (B, T, Hkv, hd)."""
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    q = _project(xf, p["wq"]).reshape(B, T, *p["wq"].shape[1:])
    k = _project(xf, p["wk"]).reshape(B, T, *p["wk"].shape[1:])
    v = _project(xf, p["wv"]).reshape(B, T, *p["wv"].shape[1:])
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if positions.dim() == 1:
        positions = positions[None, :]
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def gqa_forward(p, a: AttentionCfg, x, positions, *, window_override="cfg"):
    """Causal self-attention over the whole sequence, x (B, T, d) at
    positions 0..T-1: the flash kernels where the reference runs its XLA
    ``blocked_attention`` (the same function; the reference scales q
    before the product, the kernel scales the product, so the two agree
    within rounding). q, k and v are made contiguous once in the kernels'
    (B, Hkv, G, T, hd) layout. Returns (out (B, T, d), {"k", "v"})."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    window = effective_window(a, window_override)
    q, k, v = gqa_qkv(p, a, x, positions)
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    out = flash_attention_op(
        q.reshape(B, T, Hkv, Hq // Hkv, hd).permute(0, 2, 3, 1, 4)
        .contiguous(),
        k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous(),
        causal=True, window=window, softcap=a.logit_softcap)
    out = out.permute(0, 3, 1, 2, 4).reshape(B * T, Hq * hd).to(x.dtype)
    out = out @ p["wo"].reshape(Hq * hd, -1)
    return out.reshape(B, T, -1), {"k": k, "v": v}


def attention_forward(p, a, x, positions, *, window_override="cfg"):
    if a.kind == "mla":
        raise NotImplementedError("MLA attention is not ported yet")
    return gqa_forward(p, a, x, positions, window_override=window_override)


def _attend(q, k_cache, v_cache, live, a: AttentionCfg):
    """Attention of q (B, T, Hkv, G, hd) over slotted caches (B, S, Hkv,
    hd) where ``live`` (B, T, S) holds: float32 scores, the softcap, then
    the mask, in the reference's order. Returns (B, T, Hq * hd) float32."""
    B, T, Hkv, G, hd = q.shape
    s = torch.einsum("bthgk,bshk->bhgts", q.float(),
                     k_cache.float()) / math.sqrt(hd)
    if a.logit_softcap is not None:
        s = softcap(s, a.logit_softcap)
    s = s.masked_fill(~live[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bshk->bthgk", w, v_cache.float())
    return out.reshape(B, T, Hkv * G * hd)


def gqa_decode(p, a: AttentionCfg, x, cache, pos, *, window_override="cfg"):
    """One token per sequence over a slotted cache. x: (B, d); cache
    {"k","v"}: (B, S, Hkv, hd); pos: (B,) the new token's absolute
    position. Its K/V go to slot pos % S (a ring buffer when S is below
    the positions: a slot then holds the latest position that maps to
    it). Returns (out (B, d), the new cache)."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    window = effective_window(a, window_override)
    B, d = x.shape
    S = cache["k"].shape[1]
    pos = pos.long()
    q, k, v = (t[:, 0] for t in gqa_qkv(p, a, x[:, None], pos[:, None]))
    slot = pos % S
    bidx = torch.arange(B, device=x.device)
    k_cache = cache["k"].index_put((bidx, slot), k.to(cache["k"].dtype))
    v_cache = cache["v"].index_put((bidx, slot), v.to(cache["v"].dtype))
    # the position of the token each slot holds (ring-buffer aware)
    j = torch.arange(S, device=x.device)[None, :]
    stored = torch.where(j <= slot[:, None], j, j - S) \
        + (pos - slot)[:, None]
    live = (stored >= 0) & (stored <= pos[:, None])
    if window is not None:
        live &= stored > pos[:, None] - window
    Hkv = a.n_kv_heads
    out = _attend(q.reshape(B, 1, Hkv, a.n_heads // Hkv, a.head_dim),
                  k_cache, v_cache, live[:, None], a)[:, 0]
    out = out.to(x.dtype) @ p["wo"].reshape(a.n_heads * a.head_dim, d)
    return out, {"k": k_cache, "v": v_cache}


def gqa_extend(p, a: AttentionCfg, x, cache, start, *,
               window_override="cfg"):
    """Chunked prefill or recompute over a slotted cache: x (B, T, d) at
    absolute positions start[b] + t, attending to the cached prefix and
    the chunk causally. No ring wrap: S >= start + T. Returns (out
    (B, T, d), the new cache)."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    window = effective_window(a, window_override)
    B, T, d = x.shape
    S = cache["k"].shape[1]
    positions = start.long()[:, None] + torch.arange(T, device=x.device)
    q, k, v = gqa_qkv(p, a, x, positions)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, T)
    k_cache = cache["k"].index_put((bidx, positions),
                                   k.to(cache["k"].dtype))
    v_cache = cache["v"].index_put((bidx, positions),
                                   v.to(cache["v"].dtype))
    j = torch.arange(S, device=x.device)[None, None, :]
    qpos = positions[:, :, None]
    live = j <= qpos
    if window is not None:
        live &= j > qpos - window
    Hkv = a.n_kv_heads
    out = _attend(q.reshape(B, T, Hkv, a.n_heads // Hkv, a.head_dim),
                  k_cache, v_cache, live, a)
    out = out.to(x.dtype) @ p["wo"].reshape(a.n_heads * a.head_dim, d)
    return out, {"k": k_cache, "v": v_cache}


def attention_decode(p, a, x, cache, pos, *, window_override="cfg"):
    if a.kind == "mla":
        raise NotImplementedError("MLA attention is not ported yet")
    return gqa_decode(p, a, x, cache, pos, window_override=window_override)


def attention_extend(p, a, x, cache, start, *, window_override="cfg"):
    if a.kind == "mla":
        raise NotImplementedError("MLA attention is not ported yet")
    return gqa_extend(p, a, x, cache, start,
                      window_override=window_override)


def _append(pool, k, v, pids, offs, valid):
    """Write rows k/v (N, Hkv, hd) into ``pool`` in place, through the
    quantized append when the pool carries scales; returns the scale
    keywords for attention (none for a float pool)."""
    i32 = torch.int32
    args = (k.contiguous(), v.contiguous(), pids.to(i32), offs.to(i32),
            valid.to(i32))
    if "k_scale" not in pool:
        kv_append_op(pool["k"], pool["v"], *args)
        return {}
    kv_append_quant_op(pool["k"], pool["v"], pool["k_scale"],
                       pool["v_scale"], *args)
    return {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]}


def _gather_cache(pool, name, bt):
    """Block-table gather of pool ``name``, dequantized to float32 with
    its per-(page, head) scales when the pool is quantized."""
    if f"{name}_scale" not in pool:
        return pool[name][bt]
    return dequant_gathered(gather_pages(pool[name], bt),
                            pool[f"{name}_scale"][bt])


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
    scales = _append(pool, k, v, pids, pos % page, valid)
    G = a.n_heads // Hkv
    out = ragged_paged_attention_op(
        q.reshape(N, Hkv, G, hd), pool["k"], pool["v"], block_tables,
        tok_seq, tok_pos, softcap=a.logit_softcap, window=window, **scales)
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
    scales = _append(pool, k, v, pids, pos % page, valid)
    G = a.n_heads // Hkv
    out = paged_attention_op(
        q.reshape(B, Hkv, G, hd).contiguous(), pool["k"], pool["v"],
        block_tables, ctx_lens, softcap=a.logit_softcap, window=window,
        **scales)
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
    block-table gather (dequantized for a quantized pool) then einsum and
    softmax in the reference's op order, as the reference leaves it to
    XLA. Returns out (B, T, d)."""
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
    _append(pool, k.reshape(B * T, Hkv, hd), v.reshape(B * T, Hkv, hd),
            pids.reshape(-1), (positions % page).reshape(-1),
            t_valid.reshape(-1))

    bt = block_tables.long()
    k_cache = _gather_cache(pool, "k", bt).reshape(B, S, Hkv, hd)
    v_cache = _gather_cache(pool, "v", bt).reshape(B, S, Hkv, hd)
    j = torch.arange(S, device=x.device)[None, None, :]
    qpos = positions[:, :, None]
    live = j <= qpos
    if window is not None:
        live &= j > qpos - window
    out = _attend(q.reshape(B, T, Hkv, a.n_heads // Hkv, hd), k_cache,
                  v_cache, live, a)
    return out.to(x.dtype) @ p["wo"].reshape(a.n_heads * hd, d)


def init_cache_shapes(a: AttentionCfg, batch: int, max_len: int, *,
                      dtype: torch.dtype, device, kv_dtype=None):
    """Zeroed cache of one attention block: {"k","v"} (batch, max_len,
    Hkv, hd), a slotted cache of ``batch`` sequences, or the page pool of
    ``batch`` pages of ``max_len`` slots. ``kv_dtype`` (a name of
    ``kernels.kv_quant.KV_QUANT_DTYPES``, pools only) stores the payload
    low-bit, with {"k_scale","v_scale"}: (batch, Hkv) float32, one scale
    per (page, kv head); the keys are in the JAX tree's sorted order."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    shape = (batch, max_len, a.n_kv_heads, a.head_dim)
    if kv_dtype is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    qd = kv_quant_dtype(kv_dtype)
    scale = (batch, a.n_kv_heads)
    return {"k": torch.zeros(shape, dtype=qd, device=device),
            "k_scale": torch.zeros(scale, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=qd, device=device),
            "v_scale": torch.zeros(scale, dtype=torch.float32, device=device)}
