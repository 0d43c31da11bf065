"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone with a SHARED attention
block (single parameter set) invoked at interleave points.

38 layers: 6 periods of (5 mamba2 + shared attention) + a tail of 2 mamba2.
The shared block's parameters are stored once at model level and closed over
by every invocation (not scanned).
"""
from repro_torch.configs.base import (AttentionCfg, BlockCfg, FFNCfg, LayerGroup,
                                ModelConfig, SSMCfg)

SOURCE = "arXiv:2411.15242"


def _cfg(name, n_periods, n_m, n_tail, d_model, n_heads, n_kv, head_dim,
         d_ff, d_state, vocab) -> ModelConfig:
    mamba = BlockCfg(kind="mamba2",
                     ssm=SSMCfg(kind="mamba2", d_state=d_state,
                                n_heads=max(2, (2 * d_model) // 64 // 8),
                                expand=2, d_conv=4, chunk_size=256))
    shared = BlockCfg(kind="shared_attn",
                      attn=AttentionCfg(kind="gqa", n_heads=n_heads,
                                        n_kv_heads=n_kv, head_dim=head_dim),
                      ffn=FFNCfg(kind="dense", d_ff=d_ff))
    groups = [LayerGroup(period=(mamba,) * n_m + (shared,), n_periods=n_periods)]
    if n_tail:
        groups.append(LayerGroup(period=(mamba,), n_periods=n_tail))
    return ModelConfig(name=name, family="hybrid", source=SOURCE,
                       d_model=d_model, vocab_size=vocab,
                       groups=tuple(groups))


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return _cfg("zamba2-1.2b-tiny", 1, 1, 0, 256, 4, 4, 64, 512, 16, 512)
    # 38 layers = 6 x (5 mamba2 + shared attn) + 2 mamba2
    return _cfg("zamba2-1.2b", 6, 5, 2, 2048, 32, 32, 64, 8192, 64, 32000)
