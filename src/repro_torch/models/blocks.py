"""Residual blocks on the fused paged path, counterpart of the
``init_block`` / ``block_mixed_paged`` slice of ``repro.models.blocks``:
attention plus a dense FFN. MoE, post-norms and SSM blocks are not
ported yet and raise."""
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
