"""GQA attention over paged KV pools: the fused mixed-batch path.

Counterpart of the ``init_gqa`` / ``gqa_mixed_paged`` slice of
``repro.models.attention``. The per-layer pools are updated in place:
every new token's K/V is appended (``kv_append``) before the ragged
attention pass reads the pools, so one mask ``kv position <= tok_pos``
gives both decode tokens and chunk-internal causality.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttentionCfg
from repro_torch.kernels.ops import kv_append_op, ragged_paged_attention_op
from repro_torch.models.common import apply_rope, dense_init


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


def init_pool(a: AttentionCfg, n_pages: int, page: int, *,
              dtype: torch.dtype, device, periods: int):
    """Zeroed paged K/V pools of one attention block, stacked over the
    group's layer periods: {"k","v"}: (periods, n_pages, page, Hkv, hd)."""
    if a.kind != "gqa":
        raise NotImplementedError(f"{a.kind} attention is not ported yet")
    shape = (periods, n_pages, page, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
