"""Residual blocks, counterpart of the ``init_block`` / ``block_forward``
/ ``block_decode`` / ``block_extend`` / ``init_block_cache`` /
``block_mixed_paged`` / ``block_decode_paged`` / ``block_extend_paged``
slice of ``repro.models.blocks``: attention plus a dense or MoE FFN, and
the SSM blocks (mamba2, mLSTM, sLSTM), over the full sequence, in
single-token decode and in chunked prefill (attention over slotted
caches: the gather path), and attention on the paged paths, with gemma2's
post-norms (``post_norm1`` / ``post_norm2`` on each sublayer's output
before its residual add). An MoE FFN takes each batch row as a dispatch
group on the full-sequence and extend paths, and each token as a group of
one on the decode and paged-decode paths and the fused mixed batch, as
the reference does; its balance loss is the aux loss that the
full-sequence and extend passes return. Attention is GQA or MLA
(deepseek-v3's latent attention, whose caches and pools are the latent
{"c","kr"}); the paged paths refuse SSM blocks, as the reference does."""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import attention, mlp, moe, ssm
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


def _check_ported(blk: BlockCfg):
    if blk.kind in SSM_KINDS:
        return
    if blk.kind not in ("attn", "shared_attn"):
        raise ValueError(f"unknown block kind {blk.kind}")
    if blk.attn.kind not in ("gqa", "mla"):
        raise ValueError(f"unknown attention kind {blk.attn.kind}")
    if blk.ffn.kind not in ("dense", "moe"):
        raise NotImplementedError(f"{blk.ffn.kind} FFNs are not ported")


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
    p = {"norm1": torch.zeros((d,), dtype=dtype, device=device),
         "attn": attention.init_attention(generator, d, blk.attn,
                                          dtype=dtype, device=device),
         "norm2": torch.zeros((d,), dtype=dtype, device=device)}
    if blk.ffn.kind == "moe":
        p["moe"] = moe.init_moe(generator, d, blk.ffn, dtype=dtype,
                                device=device)
    else:
        p["mlp"] = mlp.init_mlp(generator, d, blk.ffn, dtype=dtype,
                                device=device)
    if blk.post_norms:
        p["post_norm1"] = torch.zeros((d,), dtype=dtype, device=device)
        p["post_norm2"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def block_forward(p, cfg: ModelConfig, blk: BlockCfg, x, ctx):
    """Full-sequence pass over x (B, T, d) at ctx["positions"]. Returns
    (x, cache entry — {"k", "v"} for attention, the final state for an
    SSM block —, the MoE balance loss, 0 for other blocks)."""
    _check_ported(blk)
    eps = cfg.norm_eps
    if blk.kind in SSM_KINDS:
        h, state = _FORWARD[blk.kind](p["cell"], blk.ssm, cfg.d_model,
                                      rms_norm(x, p["norm"], eps))
        return x + h.to(x.dtype), state, _no_aux(x)
    return _attn_ffn(p, cfg, blk, x, lambda xn: attention.attention_forward(
        p["attn"], blk.attn, xn, ctx["positions"],
        window_override=ctx.get("window_override", "cfg")))


def _no_aux(x):
    return torch.zeros((), device=x.device)


def _attn_ffn(p, cfg: ModelConfig, blk: BlockCfg, x, attn,
              per_token: bool = False):
    """An attention block around ``attn`` (normed x -> (h, cache entry or
    None)): residual attention, then the residual FFN, each sublayer's
    output normed by its post-norm before the add where the block has
    them (gemma2), in the output's own dtype. An MoE FFN takes each row of
    x (B, T, d) as a dispatch group, or with ``per_token`` (x (N, d)) each
    token as a group of one. Returns (x, the cache entry, the MoE balance
    loss or 0)."""
    eps = cfg.norm_eps
    h, kv = attn(rms_norm(x, p["norm1"], eps))
    if blk.post_norms:
        h = rms_norm(h, p["post_norm1"], eps)
    x = x + h.to(x.dtype)
    xin = rms_norm(x, p["norm2"], eps)
    aux = _no_aux(x)
    if blk.ffn.kind == "moe" and per_token:
        h, aux = moe.moe_forward(p["moe"], blk.ffn, xin[:, None])
        h = h[:, 0]
    elif blk.ffn.kind == "moe":
        h, aux = moe.moe_forward(p["moe"], blk.ffn, xin)
    else:
        h = mlp.mlp_forward(p["mlp"], blk.ffn, xin)
    if blk.post_norms:
        h = rms_norm(h, p["post_norm2"], eps)
    return x + h.to(x.dtype), kv, aux


def block_decode(p, cfg: ModelConfig, blk: BlockCfg, x, cache, ctx):
    """Single-token pass at positions ctx["pos"] (B,). x: (B, d); cache:
    the block's slotted cache or state. Returns (x, new cache or
    state)."""
    _check_ported(blk)
    if blk.kind in SSM_KINDS:
        h, state = _DECODE[blk.kind](p["cell"], blk.ssm, cfg.d_model,
                                     rms_norm(x, p["norm"], cfg.norm_eps),
                                     cache)
        return x + h.to(x.dtype), state
    return _attn_ffn(p, cfg, blk, x, lambda xn: attention.attention_decode(
        p["attn"], blk.attn, xn, cache, ctx["pos"],
        window_override=ctx.get("window_override", "cfg")),
        per_token=True)[:2]


def block_extend(p, cfg: ModelConfig, blk: BlockCfg, x, cache, ctx):
    """Chunked-prefill pass: x (B, T, d) appended at positions
    ctx["start"][b] + t, attending to the cached prefix (an SSM block
    continues from its state). Returns (x, new cache or state, the MoE
    balance loss or 0)."""
    _check_ported(blk)
    if blk.kind in SSM_KINDS:
        h, state = _FORWARD[blk.kind](p["cell"], blk.ssm, cfg.d_model,
                                      rms_norm(x, p["norm"], cfg.norm_eps),
                                      initial_state=cache)
        return x + h.to(x.dtype), state, _no_aux(x)
    return _attn_ffn(p, cfg, blk, x, lambda xn: attention.attention_extend(
        p["attn"], blk.attn, xn, cache, ctx["start"],
        window_override=ctx.get("window_override", "cfg")))


def init_block_cache(cfg: ModelConfig, blk: BlockCfg, batch: int,
                     cache_len: int, *, dtype: torch.dtype, device,
                     window_override="cfg", kv_dtype=None):
    """Zeroed decode cache of one block: an attention block's slotted
    cache of ``batch`` rows of ``cache_len`` slots (no more than its
    window), or its page pool (``batch`` pages of ``cache_len`` slots,
    ``kv_dtype`` storing it low-bit; DESIGN.md §17); an SSM block's zero
    state for ``batch`` sequences (``cache_len`` does not apply)."""
    _check_ported(blk)
    if blk.kind in SSM_KINDS:
        return _STATE[blk.kind](blk.ssm, cfg.d_model, batch, dtype,
                                device=device)
    window = attention.effective_window(blk.attn, window_override)
    n = cache_len if window is None else min(cache_len, window)
    return attention.init_cache_shapes(blk.attn, batch, n, dtype=dtype,
                                       device=device, kv_dtype=kv_dtype)


def block_mixed_paged(p, cfg: ModelConfig, blk: BlockCfg, x, pool, ctx):
    """Fused mixed-batch pass over this block's paged pool, which it
    writes in place. x: (N, d), one row per flat token of the iteration,
    routed through ctx["block_tables"] by ctx["tok_seq"] / ctx["tok_pos"].
    Returns x (N, d)."""
    _check_paged(blk)
    return _attn_ffn(p, cfg, blk, x, lambda xn: (
        attention.attention_mixed_paged(
            p["attn"], blk.attn, xn, pool, ctx["block_tables"],
            ctx["tok_seq"], ctx["tok_pos"],
            window_override=ctx.get("window_override", "cfg")), None),
        per_token=True)[0]


def block_decode_paged(p, cfg: ModelConfig, blk: BlockCfg, x, pool, ctx):
    """Single-token pass over this block's paged pool, which it writes in
    place. x: (B, d), one row per sequence, routed through
    ctx["block_tables"] / ctx["ctx_lens"]. Returns x (B, d)."""
    _check_paged(blk)
    return _attn_ffn(p, cfg, blk, x, lambda xn: (
        attention.attention_decode_paged(
            p["attn"], blk.attn, xn, pool, ctx["block_tables"],
            ctx["ctx_lens"],
            window_override=ctx.get("window_override", "cfg")), None),
        per_token=True)[0]


def block_extend_paged(p, cfg: ModelConfig, blk: BlockCfg, x, pool, ctx):
    """Chunked-prefill pass writing this block's pool pages in place.
    x: (B, T, d) at positions ctx["start"][b] + t; only the first
    ctx["n_new"][b] tokens of each row are real. Returns x (B, T, d)."""
    _check_paged(blk)
    return _attn_ffn(p, cfg, blk, x, lambda xn: (
        attention.attention_extend_paged(
            p["attn"], blk.attn, xn, pool, ctx["block_tables"],
            ctx["start"], ctx["n_new"],
            window_override=ctx.get("window_override", "cfg")), None))[0]
