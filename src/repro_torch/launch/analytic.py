"""Analytic per-(arch x shape) FLOP/byte accounting for the roofline.

Why this exists: XLA's ``compiled.cost_analysis()`` counts ``lax.scan``/
``while`` bodies ONCE, not multiplied by trip count (verified empirically —
see EXPERIMENTS.md §Dry-run "calibration"). Our models scan over layer
periods (and attention/GLA/CE chunk loops), so raw cost_analysis
undercounts by the trip products. The roofline terms therefore use this
analytic model — validated against an UNROLLED tiny-config compile, where
cost_analysis is exact — while the raw per-iteration HLO numbers are kept
in the dry-run JSONs.

Conventions: matmul = 2mnk flops (XLA's convention, verified); attention
scores+values = 4 * heads * head_dim * ctx flops per query token; backward
pass = 2x forward; remat adds ~1x forward recompute.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AttentionCfg, BlockCfg, InputShape,
                                ModelConfig)
from repro_torch.utils.hw import dtype_bytes


@dataclasses.dataclass
class StepCost:
    flops_global: float         # whole-step, all chips
    weight_bytes: float         # parameter bytes read PER CHIP
    cache_bytes: float          # KV/state bytes read+written PER CHIP
    activation_bytes: float     # rough activation traffic PER CHIP

    @property
    def hbm_bytes_per_chip(self) -> float:
        return self.weight_bytes + self.cache_bytes + self.activation_bytes


def _attn_flops_per_token(a: AttentionCfg, ctx: float) -> float:
    """Forward attention flops for one query token at context ``ctx``."""
    if a.kind == "mla":
        lat = a.kv_lora_rank + a.qk_rope_head_dim
        # scores in latent space + context aggregation over the latent
        return 4.0 * a.n_heads * lat * ctx
    eff = min(ctx, a.sliding_window) if a.sliding_window else ctx
    return 4.0 * a.n_heads * a.head_dim * eff


def _block_extra_flops_per_token(cfg: ModelConfig, blk: BlockCfg,
                                 ctx: float) -> float:
    """Non-matmul-weight flops: attention context math / GLA state ops."""
    if blk.kind in ("attn", "shared_attn"):
        return _attn_flops_per_token(blk.attn, ctx)
    s = blk.ssm
    d_inner = s.expand * cfg.d_model
    hd = d_inner // s.n_heads
    if s.kind == "mamba2":
        return 8.0 * s.n_heads * s.d_state * hd
    if s.kind == "mlstm":
        return 8.0 * s.n_heads * hd * (hd + 1)
    # slstm: recurrent matmul R (hd x 4hd per head)
    return 2.0 * s.n_heads * hd * 4 * hd


def forward_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    base = 2.0 * cfg.active_params_per_token()
    extra = sum(_block_extra_flops_per_token(cfg, b, ctx)
                for b in cfg.blocks)
    return base + extra


def step_cost(cfg: ModelConfig, shape: InputShape, window_override="cfg",
              *, n_chips: int = 1, model_shards: int = 1,
              data_shards: int = 1, fsdp: bool = True,
              batch_shards: int = 1) -> StepCost:
    """Per-chip byte accounting is sharding-aware: weights divide by their
    actual sharding extent (model axis, x data axis when FSDP), caches by
    batch x seq sharding, activations by batch sharding."""
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_bytes(cfg.dtype)
    wbytes = cfg.approx_n_params() * dt
    kv_tok = cfg.kv_token_bytes(dt)
    state = cfg.state_bytes(4)  # f32 states
    w_shards = model_shards * (data_shards if fsdp else 1)

    if shape.mode == "train":
        tokens = B * S
        # causal: average context = S/2; fwd + bwd(2x) + remat(~1x) = 4x
        flops = 4.0 * tokens * forward_flops_per_token(cfg, S / 2)
        # params + grads + adam moments traffic, per chip (FSDP-sharded)
        weight_traffic = wbytes * (2 + 2 * 2) / w_shards
        act = 20.0 * tokens * cfg.d_model * dt * 2 / n_chips
        return StepCost(flops, weight_traffic, 0.0, act)

    if shape.mode == "prefill":
        tokens = B * S
        flops = tokens * forward_flops_per_token(cfg, S / 2)
        cache = (tokens * kv_tok + B * state) / n_chips
        act = 12.0 * tokens * cfg.d_model * dt / n_chips
        return StepCost(flops, wbytes / w_shards, cache, act)

    # decode: one token per sequence; context window-capped per block
    tokens = B
    flops = tokens * forward_flops_per_token_decode(cfg, S, window_override)
    cache_shards = batch_shards * (model_shards
                                   if S % model_shards == 0 else 1)
    cache_read = (B * _resident_cache_bytes(cfg, S, window_override, dt)
                  + B * state) / cache_shards
    act = 4.0 * tokens * cfg.d_model * dt / max(1, batch_shards)
    return StepCost(flops, wbytes / w_shards, cache_read, act)


def _resident_cache_bytes(cfg, S, window_override, dt):
    total = 0
    for b in cfg.blocks:
        if b.kind in ("attn", "shared_attn"):
            a = b.attn
            from repro_torch.models.attention import effective_window
            w = effective_window(a, window_override)
            n = min(S, w) if w else S
            total += n * a.kv_token_bytes(dt)
    return total


def forward_flops_per_token_decode(cfg, S, window_override) -> float:
    from repro_torch.models.attention import effective_window
    base = 2.0 * cfg.active_params_per_token()
    extra = 0.0
    for b in cfg.blocks:
        if b.kind in ("attn", "shared_attn"):
            w = effective_window(b.attn, window_override)
            ctx = min(S, w) if w else S
            extra += _attn_flops_per_token(b.attn, ctx)
        else:
            extra += _block_extra_flops_per_token(cfg, b, S)
    return base + extra


def scan_trip_multiplier(cfg: ModelConfig) -> int:
    """Dominant layer-scan trip count — used to correct HLO-text collective
    bytes (instructions inside while bodies execute trips times but appear
    once in the text). Multi-group models use the largest group (the error
    from smaller groups is proportionally small)."""
    return max(g.n_periods for g in cfg.groups)
