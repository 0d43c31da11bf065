"""Residual blocks, counterpart of the ``init_block`` / ``block_forward``
/ ``block_mixed_paged`` / ``block_decode_paged`` / ``block_extend_paged``
slice of ``repro.models.blocks``: attention plus a dense FFN, over the
full sequence (training) and on the paged paths. MoE,
post-norms and SSM blocks are not ported yet and raise, so the extend's
auxiliary (MoE balance) loss is always 0 and is not returned."""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import attention, mlp
from repro_torch.models.common import rms_norm


def _check_ported(blk: BlockCfg):
    if blk.kind not in ("attn", "shared_attn"):
        raise NotImplementedError(f"{blk.kind} blocks are not ported yet")
    if blk.ffn.kind != "dense" or blk.post_norms:
        raise NotImplementedError("MoE FFNs and post-norms are not ported "
                                  "yet")


def init_block(generator: torch.Generator, cfg: ModelConfig, blk: BlockCfg,
               *, dtype: torch.dtype, device):
    _check_ported(blk)
    d = cfg.d_model
    return {"norm1": torch.zeros((d,), dtype=dtype, device=device),
            "attn": attention.init_gqa(generator, d, blk.attn, dtype=dtype,
                                       device=device),
            "norm2": torch.zeros((d,), dtype=dtype, device=device),
            "mlp": mlp.init_mlp(generator, d, blk.ffn, dtype=dtype,
                                device=device)}


def block_forward(p, cfg: ModelConfig, blk: BlockCfg, x, ctx):
    """Full-sequence pass over x (B, T, d) at ctx["positions"]. Returns
    (x, cache entry {"k", "v"}, aux loss 0: no MoE here)."""
    _check_ported(blk)
    eps = cfg.norm_eps
    h, kv = attention.attention_forward(
        p["attn"], blk.attn, rms_norm(x, p["norm1"], eps), ctx["positions"],
        window_override=ctx.get("window_override", "cfg"))
    x = x + h.to(x.dtype)
    h = mlp.mlp_forward(p["mlp"], blk.ffn, rms_norm(x, p["norm2"], eps))
    return x + h.to(x.dtype), kv, torch.zeros((), device=x.device)


def block_mixed_paged(p, cfg: ModelConfig, blk: BlockCfg, x, pool, ctx):
    """Fused mixed-batch pass over this block's paged pool, which it
    writes in place. x: (N, d), one row per flat token of the iteration,
    routed through ctx["block_tables"] by ctx["tok_seq"] / ctx["tok_pos"].
    Returns x (N, d)."""
    _check_ported(blk)
    eps = cfg.norm_eps
    h = attention.gqa_mixed_paged(
        p["attn"], blk.attn, rms_norm(x, p["norm1"], eps), pool,
        ctx["block_tables"], ctx["tok_seq"], ctx["tok_pos"],
        window_override=ctx.get("window_override", "cfg"))
    x = x + h.to(x.dtype)
    h = mlp.mlp_forward(p["mlp"], blk.ffn, rms_norm(x, p["norm2"], eps))
    return x + h.to(x.dtype)


def block_decode_paged(p, cfg: ModelConfig, blk: BlockCfg, x, pool, ctx):
    """Single-token pass over this block's paged pool, which it writes in
    place. x: (B, d), one row per sequence, routed through
    ctx["block_tables"] / ctx["ctx_lens"]. Returns x (B, d)."""
    _check_ported(blk)
    eps = cfg.norm_eps
    h = attention.gqa_decode_paged(
        p["attn"], blk.attn, rms_norm(x, p["norm1"], eps), pool,
        ctx["block_tables"], ctx["ctx_lens"],
        window_override=ctx.get("window_override", "cfg"))
    x = x + h.to(x.dtype)
    h = mlp.mlp_forward(p["mlp"], blk.ffn, rms_norm(x, p["norm2"], eps))
    return x + h.to(x.dtype)


def block_extend_paged(p, cfg: ModelConfig, blk: BlockCfg, x, pool, ctx):
    """Chunked-prefill pass writing this block's pool pages in place.
    x: (B, T, d) at positions ctx["start"][b] + t; only the first
    ctx["n_new"][b] tokens of each row are real. Returns x (B, T, d)."""
    _check_ported(blk)
    eps = cfg.norm_eps
    h = attention.gqa_extend_paged(
        p["attn"], blk.attn, rms_norm(x, p["norm1"], eps), pool,
        ctx["block_tables"], ctx["start"], ctx["n_new"],
        window_override=ctx.get("window_override", "cfg"))
    x = x + h.to(x.dtype)
    h = mlp.mlp_forward(p["mlp"], blk.ffn, rms_norm(x, p["norm2"], eps))
    return x + h.to(x.dtype)
