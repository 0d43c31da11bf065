"""GQA and MLA attention: the full-sequence forward (training, prefill)
over the flash kernels; single-token decode and chunked prefill over
slotted caches (the gather path); and paged KV pools' fused mixed-batch
path and per-call decode and chunked-prefill paths.

Counterpart of ``repro.models.attention`` but its sequence-parallel
decode: GQA (``init_gqa`` ... ``gqa_extend_paged``), MLA (``init_mla``,
``_mla_latent``, ``_mla_q``, ``mla_forward``, ``mla_decode``,
``mla_extend``, ``mla_mixed_paged``, ``mla_decode_paged``,
``mla_extend_paged``), their dispatchers and ``init_cache_shapes``. A
slotted cache is {"k","v"}: (B, S, Hkv, hd), or MLA's latent {"c","kr"}:
(B, S, kv_lora) and (B, S, rope), one row of S slots per sequence; decode
and extend return new caches and leave theirs as they were, as the
reference's ``.at[].set`` does, and their attention is plain PyTorch
(float32 scores, the reference's op order), which the reference leaves to
XLA. The per-layer pools are updated in place: every new token's K/V (or
latent c and rope key kr) is appended (``kv_append``) before attention
reads the pools, so one mask ``kv position <= token position`` gives both
decode tokens and chunk-internal causality. A quantized pool (DESIGN.md
§17) carries ``k_scale``/``v_scale`` (n_pages, Hkv) float32 beside its
1-byte payload: the append is ``kv_append_quant`` and attention
dequantizes with the scales; MLA's latent pools stay in the model dtype.
MLA attends in the latent space on every path but the full-sequence
forward (the reference's absorbed form): the queries' nope part times
``w_uk`` scores the latents, and the latents' weighted sum times ``w_uv``
is the head's value; on the paged paths that attention is the ragged
latent-attention kernel (``kernels/mla_attention.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttentionCfg
from repro_torch.kernels.kv_quant import (dequant_gathered, gather_pages,
                                          kv_quant_dtype)
from repro_torch.kernels.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.kernels.mla_attention import latent_attend
from repro_torch.kernels.ops import (flash_attention_op, kv_append_op,
                                     kv_append_quant_op, paged_attention_op,
                                     ragged_latent_attention_op,
                                     ragged_paged_attention_op)
from repro_torch.models.common import (apply_rope, dense_init, rms_norm,
                                       softcap)

NEG_INF = -1e30


def effective_window(a: AttentionCfg, override) -> Optional[int]:
    """Resolve a window override against the block's configured window:
    "cfg" -> the config's sliding window; None -> full attention; int w ->
    min(w, cfg window). MLA always attends the full latent (DESIGN.md
    §4)."""
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
    fn = mla_forward if a.kind == "mla" else gqa_forward
    return fn(p, a, x, positions, window_override=window_override)


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
    fn = mla_decode if a.kind == "mla" else gqa_decode
    return fn(p, a, x, cache, pos, window_override=window_override)


def attention_extend(p, a, x, cache, start, *, window_override="cfg"):
    fn = mla_extend if a.kind == "mla" else gqa_extend
    return fn(p, a, x, cache, start, window_override=window_override)


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


# ==========================================================================
# MLA (deepseek-v3)
# ==========================================================================

def init_mla(generator: torch.Generator, d_model: int, a: AttentionCfg, *,
             dtype: torch.dtype, device):
    """The reference's ``init_mla`` leaves and shapes: the query's low-rank
    projection (``w_dq``, ``q_norm``, ``w_uq`` to nope + rope per head),
    the joint latent and rope key (``w_dkv``, ``kv_norm``), the latent's
    up-projections to each head's nope key (``w_uk``) and value
    (``w_uv``), and ``wo``."""
    kw = dict(dtype=dtype, device=device)
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    return {
        "w_dq": dense_init(generator, (d_model, a.q_lora_rank), **kw),
        "q_norm": torch.zeros((a.q_lora_rank,), **kw),
        "w_uq": dense_init(generator, (a.q_lora_rank, a.n_heads, qk), **kw),
        "w_dkv": dense_init(generator, (d_model, a.kv_lora_rank
                                        + a.qk_rope_head_dim), **kw),
        "kv_norm": torch.zeros((a.kv_lora_rank,), **kw),
        "w_uk": dense_init(generator, (a.kv_lora_rank, a.n_heads,
                                       a.qk_nope_head_dim), **kw),
        "w_uv": dense_init(generator, (a.kv_lora_rank, a.n_heads,
                                       a.v_head_dim), **kw),
        "wo": dense_init(generator, (a.n_heads, a.v_head_dim, d_model),
                         in_axis=0, **kw)}


def init_attention(generator: torch.Generator, d_model: int,
                   a: AttentionCfg, *, dtype: torch.dtype, device):
    fn = init_mla if a.kind == "mla" else init_gqa
    return fn(generator, d_model, a, dtype=dtype, device=device)


def _as_rows(positions):
    return positions[None, :] if positions.dim() == 1 else positions


def _mla_latent(p, a: AttentionCfg, x, positions):
    """x (B, T, d) at positions (T,) or (B, T) -> the normed latent c
    (B, T, kv_lora) and the roped key kr (B, T, rope) that all heads
    share."""
    B, T, d = x.shape
    ckr = (x.reshape(B * T, d) @ p["w_dkv"]).reshape(B, T, -1)
    c = rms_norm(ckr[..., :a.kv_lora_rank], p["kv_norm"])
    kr = apply_rope(ckr[:, :, None, a.kv_lora_rank:], _as_rows(positions),
                    a.rope_theta)[:, :, 0]
    return c, kr


def _mla_q(p, a: AttentionCfg, x, positions):
    """x (B, T, d) -> each head's nope query (B, T, H, nope) and roped
    query (B, T, H, rope)."""
    B, T, d = x.shape
    cq = rms_norm((x.reshape(B * T, d) @ p["w_dq"]), p["q_norm"])
    q = (cq @ p["w_uq"].reshape(a.q_lora_rank, -1)).reshape(
        B, T, a.n_heads, -1)
    qr = apply_rope(q[..., a.qk_nope_head_dim:], _as_rows(positions),
                    a.rope_theta)
    return q[..., :a.qk_nope_head_dim], qr


def _mla_scale(a: AttentionCfg) -> float:
    return 1.0 / math.sqrt(a.qk_nope_head_dim + a.qk_rope_head_dim)


def _mla_out(p, a: AttentionCfg, ctx, dtype):
    """The latent context (..., H, kv_lora) float32 through ``w_uv``
    (float32, as the reference), then ``wo``: (..., d) in ``dtype``."""
    lead = ctx.shape[:-2]
    out = torch.einsum("nhl,lhv->nhv", ctx.reshape(-1, *ctx.shape[-2:]),
                       p["w_uv"].float()).to(dtype)
    out = out.reshape(out.shape[0], -1) @ p["wo"].reshape(
        a.n_heads * a.v_head_dim, -1)
    return out.reshape(*lead, -1)


def mla_forward(p, a: AttentionCfg, x, positions, *, window_override="cfg"):
    """The non-absorbed full-sequence path (training, prefill), x (B, T, d)
    at positions 0..T-1: each head's key is its nope key ``c . w_uk`` and
    the shared rope key, its value ``c . w_uv``; attention runs in the
    flash kernels at qk = nope + rope (192 at deepseek-v3's widths) with
    the value zero-padded to it and scale 1 / sqrt(qk), as the reference
    pads for its ``blocked_attention``. A qk the kernels do not take is
    zero-padded to the next head_dim they do (the tiny config's 48 to
    64: zero dims add nothing to a score). Returns (out (B, T, d),
    {"c", "kr"})."""
    B, T, _ = x.shape
    H, nope, rope = a.n_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
    qn, qr = _mla_q(p, a, x, positions)
    c, kr = _mla_latent(p, a, x, positions)
    cf = c.reshape(B * T, -1)
    kn = (cf @ p["w_uk"].reshape(a.kv_lora_rank, -1)).reshape(B, T, H, nope)
    v = (cf @ p["w_uv"].reshape(a.kv_lora_rank, -1)).reshape(
        B, T, H, a.v_head_dim)
    hd = min(h for h in FLASH_HEAD_DIMS if h >= nope + rope)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, kr[:, :, None].expand(B, T, H, rope)], dim=-1)

    def heads(t):   # (B, T, H, e) -> (B, H, T, hd), zero-padded
        return torch.nn.functional.pad(
            t, (0, hd - t.shape[-1])).permute(0, 2, 1, 3).contiguous()
    out = flash_attention_op(heads(q)[:, :, None], heads(k), heads(v),
                             causal=True, scale=_mla_scale(a))
    out = out[:, :, 0, :, :a.v_head_dim].permute(0, 2, 1, 3).to(x.dtype)
    out = out.reshape(B * T, -1) @ p["wo"].reshape(H * a.v_head_dim, -1)
    return out.reshape(B, T, -1), {"c": c, "kr": kr}


def _mla_q_lat(p, qn):
    """The absorbed query, qn (..., H, nope) . w_uk -> (..., H, kv_lora)
    float32, as the reference computes it."""
    lead = qn.shape[:-2]
    q = torch.einsum("nhk,lhk->nhl", qn.reshape(-1, *qn.shape[-2:]).float(),
                     p["w_uk"].float())
    return q.reshape(*lead, *q.shape[1:])


def mla_decode(p, a: AttentionCfg, x, cache, pos, *, window_override="cfg"):
    """Absorbed decode over a slotted latent cache. x: (B, d); cache
    {"c": (B, S, kv_lora), "kr": (B, S, rope)}; pos: (B,) the new
    token's absolute position, its latent written to slot pos % S (a
    ring buffer when S is below the positions). Returns (out (B, d), the
    new cache)."""
    B, d = x.shape
    S = cache["c"].shape[1]
    pos = pos.long()
    qn, qr = _mla_q(p, a, x[:, None], pos[:, None])
    c_new, kr_new = _mla_latent(p, a, x[:, None], pos[:, None])
    slot = pos % S
    bidx = torch.arange(B, device=x.device)
    c_cache = cache["c"].index_put((bidx, slot),
                                   c_new[:, 0].to(cache["c"].dtype))
    kr_cache = cache["kr"].index_put((bidx, slot),
                                     kr_new[:, 0].to(cache["kr"].dtype))
    j = torch.arange(S, device=x.device)[None, :]
    stored = torch.where(j <= slot[:, None], j, j - S) \
        + (pos - slot)[:, None]
    live = (stored >= 0) & (stored <= pos[:, None])
    ctx = latent_attend(_mla_q_lat(p, qn), qr.float(), c_cache, kr_cache,
                        live[:, None], _mla_scale(a))
    return _mla_out(p, a, ctx[:, 0], x.dtype), {"c": c_cache,
                                                "kr": kr_cache}


def mla_extend(p, a: AttentionCfg, x, cache, start, *,
               window_override="cfg"):
    """Absorbed chunked prefill over a slotted latent cache: x (B, T, d)
    at positions start[b] + t, attending to the cached prefix and the
    chunk causally (S >= start + T). Returns (out (B, T, d), the new
    cache)."""
    B, T, d = x.shape
    S = cache["c"].shape[1]
    positions = start.long()[:, None] + torch.arange(T, device=x.device)
    qn, qr = _mla_q(p, a, x, positions)
    c_new, kr_new = _mla_latent(p, a, x, positions)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, T)
    c_cache = cache["c"].index_put((bidx, positions),
                                   c_new.to(cache["c"].dtype))
    kr_cache = cache["kr"].index_put((bidx, positions),
                                     kr_new.to(cache["kr"].dtype))
    live = torch.arange(S, device=x.device)[None, None, :] \
        <= positions[:, :, None]
    ctx = latent_attend(_mla_q_lat(p, qn), qr.float(), c_cache, kr_cache,
                        live, _mla_scale(a))
    return _mla_out(p, a, ctx, x.dtype), {"c": c_cache, "kr": kr_cache}


def _mla_paged(p, a: AttentionCfg, x, pool, block_tables, tok_seq, tok_pos,
               positions):
    """The paged paths' shared body over N flat rows: x (N, d) at
    ``positions`` (N,) (0 for a padded row), row i of sequence tok_seq[i]
    at tok_pos[i] (-1: padded). (a) the rows' latent c and rope key kr
    are appended into the pools by ``kv_append`` (c viewed as (n_pages,
    page, 1, kv_lora), kr as (n_pages, page, 1, rope); a padded row's
    write is dropped); (b) the absorbed query attends over the latent
    pages in the ragged latent-attention kernel; (c) ``w_uv`` and ``wo``.
    Returns out (N, d)."""
    page = pool["c"].shape[1]
    qn, qr = _mla_q(p, a, x[:, None], positions[:, None])
    c_new, kr_new = _mla_latent(p, a, x[:, None], positions[:, None])
    pids = block_tables[tok_seq.long(), (positions // page).long()]
    i32 = torch.int32
    c, kr = pool["c"], pool["kr"]
    kv_append_op(c.view(*c.shape[:2], 1, -1), kr.view(*kr.shape[:2], 1, -1),
                 c_new.to(c.dtype).contiguous(),
                 kr_new.to(kr.dtype).contiguous(), pids.to(i32),
                 (positions % page).to(i32), (tok_pos >= 0).to(i32))
    ctx = ragged_latent_attention_op(
        _mla_q_lat(p, qn[:, 0]).contiguous(), qr[:, 0].float().contiguous(),
        c, kr, block_tables, tok_seq, tok_pos, _mla_scale(a))
    return _mla_out(p, a, ctx, x.dtype)


def mla_mixed_paged(p, a: AttentionCfg, x, pool, block_tables, tok_seq,
                    tok_pos, *, window_override="cfg"):
    """The fused mixed batch over this layer's latent pools {"c","kr"}
    (n_pages, page, kv_lora / rope), written in place: x (N, d),
    tok_seq/tok_pos (N,) int32 (-1: a padded row, its write dropped and
    its output zeros). Returns out (N, d)."""
    return _mla_paged(p, a, x, pool, block_tables, tok_seq, tok_pos,
                      tok_pos.clamp(min=0))


def mla_decode_paged(p, a: AttentionCfg, x, pool, block_tables, ctx_lens,
                     *, window_override="cfg"):
    """One new token per sequence over the latent pools: x (B, d);
    ctx_lens (B,) int32 context length including the new token (0: a
    padded row). The rows are the kernel's with tok_seq = 0..B-1 and
    tok_pos = ctx_lens - 1. Returns out (B, d)."""
    B = x.shape[0]
    tok_pos = ctx_lens - 1
    return _mla_paged(p, a, x, pool, block_tables,
                      torch.arange(B, dtype=torch.int32, device=x.device),
                      tok_pos, tok_pos.clamp(min=0))


def mla_extend_paged(p, a: AttentionCfg, x, pool, block_tables, start,
                     n_new, *, window_override="cfg"):
    """Chunked prefill over the latent pools: x (B, T, d) at positions
    start[b] + t, of which the first n_new[b] are real (the rest's writes
    dropped, their outputs zeros); the B * T tokens are the kernel's flat
    rows. All positions must fit the block table (start + T <= max_pages
    * page). Returns out (B, T, d)."""
    B, T, d = x.shape
    t_idx = torch.arange(T, device=x.device)
    positions = (start[:, None] + t_idx[None, :]).to(torch.int32)
    tok_pos = torch.where(t_idx[None, :] < n_new[:, None], positions, -1)
    tok_seq = torch.arange(B, dtype=torch.int32,
                           device=x.device).repeat_interleave(T)
    out = _mla_paged(p, a, x.reshape(B * T, d), pool, block_tables, tok_seq,
                     tok_pos.reshape(-1).to(torch.int32),
                     positions.reshape(-1))
    return out.reshape(B, T, -1)


def attention_mixed_paged(p, a, x, pool, block_tables, tok_seq, tok_pos, *,
                          window_override="cfg"):
    fn = mla_mixed_paged if a.kind == "mla" else gqa_mixed_paged
    return fn(p, a, x, pool, block_tables, tok_seq, tok_pos,
              window_override=window_override)


def attention_decode_paged(p, a, x, pool, block_tables, ctx_lens, *,
                           window_override="cfg"):
    fn = mla_decode_paged if a.kind == "mla" else gqa_decode_paged
    return fn(p, a, x, pool, block_tables, ctx_lens,
              window_override=window_override)


def attention_extend_paged(p, a, x, pool, block_tables, start, n_new, *,
                           window_override="cfg"):
    fn = mla_extend_paged if a.kind == "mla" else gqa_extend_paged
    return fn(p, a, x, pool, block_tables, start, n_new,
              window_override=window_override)


def init_cache_shapes(a: AttentionCfg, batch: int, max_len: int, *,
                      dtype: torch.dtype, device, kv_dtype=None):
    """Zeroed cache of one attention block: {"k","v"} (batch, max_len,
    Hkv, hd), a slotted cache of ``batch`` sequences, or the page pool of
    ``batch`` pages of ``max_len`` slots. ``kv_dtype`` (a name of
    ``kernels.kv_quant.KV_QUANT_DTYPES``, pools only) stores the payload
    low-bit, with {"k_scale","v_scale"}: (batch, Hkv) float32, one scale
    per (page, kv head); the keys are in the JAX tree's sorted order.
    MLA's cache is its latent {"c": (batch, max_len, kv_lora), "kr":
    (batch, max_len, rope)}, in ``dtype`` whatever ``kv_dtype`` says, as
    the reference keeps it (no quantized latent kernel)."""
    if a.kind == "mla":
        kw = dict(dtype=dtype, device=device)
        return {"c": torch.zeros((batch, max_len, a.kv_lora_rank), **kw),
                "kr": torch.zeros((batch, max_len, a.qk_rope_head_dim),
                                  **kw)}
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
