"""Gemma2-9B [arXiv:2408.00118] — alternating local(4096)/global attention,
attention and final logit softcapping, GeGLU MLP."""
from repro_torch.configs.base import BlockCfg, AttentionCfg, FFNCfg, LayerGroup, ModelConfig

SOURCE = "arXiv:2408.00118"


def _cfg(n_periods, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab,
         window, name) -> ModelConfig:
    def attn(sw):
        return AttentionCfg(kind="gqa", n_heads=n_heads, n_kv_heads=n_kv_heads,
                            head_dim=head_dim, logit_softcap=50.0,
                            sliding_window=sw)
    ffn = FFNCfg(kind="dense", d_ff=d_ff, activation="gelu", gated=True)
    local = BlockCfg(kind="attn", attn=attn(window), ffn=ffn, post_norms=True)
    glob = BlockCfg(kind="attn", attn=attn(None), ffn=ffn, post_norms=True)
    return ModelConfig(
        name=name, family="dense", source=SOURCE, d_model=d_model,
        vocab_size=vocab, final_logit_softcap=30.0, norm_eps=1e-6,
        groups=(LayerGroup(period=(local, glob), n_periods=n_periods),))


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return _cfg(1, 256, 4, 2, 64, 512, 512, 128, "gemma2-9b-tiny")
    # 42 layers = 21 (local, global) periods
    return _cfg(21, 3584, 16, 8, 256, 14336, 256000, 4096, "gemma2-9b")
