"""Residual blocks, counterpart of the ``init_block`` / ``block_forward``
/ ``block_decode`` / ``init_block_cache`` / ``block_mixed_paged`` /
``block_decode_paged`` / ``block_extend_paged`` slice of
``repro.models.blocks``: attention plus a dense FFN, over the full
sequence (training) and on the paged paths; and the SSM blocks (mamba2,
mLSTM, sLSTM) over the full sequence and in single-token decode. MoE and
post-norms are not ported yet and raise, so the auxiliary (MoE balance)
loss is always 0. Attention blocks in single-token decode (the gather
path) raise too, and the paged paths refuse SSM blocks, as the reference
does."""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import attention, mlp, ssm
from repro_torch.models.common import rms_norm

SSM_KINDS = ("mamba2", "mlstm", "slstm")
_INIT = {"mamba2": ssm.init_mamba2, "mlstm": ssm.init_mlstm,
         "slstm": ssm.init_slstm}
_FORWARD = {"mamba2": ssm.mamba2_forward, "mlstm": ssm.mlstm_forward,
            "slstm": ssm.slstm_forward}
_DECODE = {"mamba2": ssm.mamba2_decode, "mlstm": ssm.mlstm_decode,
           "slstm": ssm.slstm_decode}
_STATE = {"mamba2": ssm.mamba2_state_shapes,
          "mlstm": ssm.mlstm_state_shapes, "slstm": ssm.slstm_state_shapes}
GATHER_SLICE = ("the gather path for attention blocks (decode_step, "
                "slotted caches; ROADMAP, 'Modules to port' item 2)")


def _check_ported(blk: BlockCfg):
    if blk.kind in SSM_KINDS:
        return
    if blk.kind not in ("attn", "shared_attn"):
        raise ValueError(f"unknown block kind {blk.kind}")
    if blk.ffn.kind != "dense" or blk.post_norms:
        raise NotImplementedError("MoE FFNs and post-norms are not ported "
                                  "yet")


def _check_paged(blk: BlockCfg):
    if blk.kind not in ("attn", "shared_attn"):
        raise ValueError(f"paged execution serves attention blocks, "
                         f"got {blk.kind}")
    _check_ported(blk)


def init_block(generator: torch.Generator, cfg: ModelConfig, blk: BlockCfg,
               *, dtype: torch.dtype, device):
    _check_ported(blk)
    d = cfg.d_model
    if blk.kind in SSM_KINDS:
        return {"norm": torch.zeros((d,), dtype=dtype, device=device),
                "cell": _INIT[blk.kind](generator, d, blk.ssm, dtype=dtype,
                                        device=device)}
    return {"norm1": torch.zeros((d,), dtype=dtype, device=device),
            "attn": attention.init_gqa(generator, d, blk.attn, dtype=dtype,
                                       device=device),
            "norm2": torch.zeros((d,), dtype=dtype, device=device),
            "mlp": mlp.init_mlp(generator, d, blk.ffn, dtype=dtype,
                                device=device)}


def block_forward(p, cfg: ModelConfig, blk: BlockCfg, x, ctx):
    """Full-sequence pass over x (B, T, d) at ctx["positions"]. Returns
    (x, cache entry — {"k", "v"} for attention, the final state for an
    SSM block —, aux loss 0: no MoE here)."""
    _check_ported(blk)
    eps = cfg.norm_eps
    if blk.kind in SSM_KINDS:
        h, state = _FORWARD[blk.kind](p["cell"], blk.ssm, cfg.d_model,
                                      rms_norm(x, p["norm"], eps))
        return x + h.to(x.dtype), state, torch.zeros((), device=x.device)
    h, kv = attention.attention_forward(
        p["attn"], blk.attn, rms_norm(x, p["norm1"], eps), ctx["positions"],
        window_override=ctx.get("window_override", "cfg"))
    x = x + h.to(x.dtype)
    h = mlp.mlp_forward(p["mlp"], blk.ffn, rms_norm(x, p["norm2"], eps))
    return x + h.to(x.dtype), kv, torch.zeros((), device=x.device)


def block_decode(p, cfg: ModelConfig, blk: BlockCfg, x, cache, ctx):
    """Single-token pass. x: (B, d); cache: the block's state. Returns
    (x, new state). SSM blocks only: attention blocks decode through the
    paged pools (``block_decode_paged``); their slotted caches come with
    the gather-path slice."""
    _check_ported(blk)
    if blk.kind not in SSM_KINDS:
        raise NotImplementedError(f"block_decode of an attention block: "
                                  f"{GATHER_SLICE}")
    h, state = _DECODE[blk.kind](p["cell"], blk.ssm, cfg.d_model,
                                 rms_norm(x, p["norm"], cfg.norm_eps), cache)
    return x + h.to(x.dtype), state


def init_block_cache(cfg: ModelConfig, blk: BlockCfg, batch: int, *,
                     dtype: torch.dtype, device):
    """Zeroed decode state of one SSM block for ``batch`` sequences (an
    attention block's pool is ``attention.init_pool``)."""
    _check_ported(blk)
    if blk.kind not in SSM_KINDS:
        raise NotImplementedError(f"slotted attention caches: "
                                  f"{GATHER_SLICE}")
    return _STATE[blk.kind](blk.ssm, cfg.d_model, batch, dtype,
                            device=device)


def block_mixed_paged(p, cfg: ModelConfig, blk: BlockCfg, x, pool, ctx):
    """Fused mixed-batch pass over this block's paged pool, which it
    writes in place. x: (N, d), one row per flat token of the iteration,
    routed through ctx["block_tables"] by ctx["tok_seq"] / ctx["tok_pos"].
    Returns x (N, d)."""
    _check_paged(blk)
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
    _check_paged(blk)
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
    _check_paged(blk)
    eps = cfg.norm_eps
    h = attention.gqa_extend_paged(
        p["attn"], blk.attn, rms_norm(x, p["norm1"], eps), pool,
        ctx["block_tables"], ctx["start"], ctx["n_new"],
        window_override=ctx.get("window_override", "cfg"))
    x = x + h.to(x.dtype)
    h = mlp.mlp_forward(p["mlp"], blk.ffn, rms_norm(x, p["norm2"], eps))
    return x + h.to(x.dtype)
