"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained experts: 2 shared + 64
routed top-6, first layer dense FFN."""
from repro_torch.configs.base import (AttentionCfg, BlockCfg, FFNCfg, LayerGroup,
                                ModelConfig)

SOURCE = "arXiv:2401.06066"


def _cfg(name, n_moe_layers, d_model, n_heads, n_kv_heads, head_dim,
         d_ff_dense, d_ff_expert, n_experts, top_k, n_shared, vocab) -> ModelConfig:
    attn = AttentionCfg(kind="gqa", n_heads=n_heads, n_kv_heads=n_kv_heads,
                        head_dim=head_dim)
    dense = BlockCfg(kind="attn", attn=attn,
                     ffn=FFNCfg(kind="dense", d_ff=d_ff_dense))
    moe = BlockCfg(kind="attn", attn=attn,
                   ffn=FFNCfg(kind="moe", n_routed_experts=n_experts,
                              n_shared_experts=n_shared, top_k=top_k,
                              d_ff_expert=d_ff_expert))
    return ModelConfig(
        name=name, family="moe", source=SOURCE, d_model=d_model,
        vocab_size=vocab,
        groups=(LayerGroup(period=(dense,), n_periods=1),
                LayerGroup(period=(moe,), n_periods=n_moe_layers)))


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        cfg = _cfg("deepseek-moe-16b-tiny", 1, 256, 8, 8, 32, 512, 128,
                   n_experts=4, top_k=2, n_shared=1, vocab=512)
        # ample capacity so smoke tests are chunking-invariant (capacity
        # dropping legitimately differs across chunk boundaries otherwise)
        import dataclasses
        groups = tuple(
            dataclasses.replace(g, period=tuple(
                dataclasses.replace(b, ffn=dataclasses.replace(
                    b.ffn, capacity_factor=8.0))
                if b.ffn is not None and b.ffn.kind == "moe" else b
                for b in g.period))
            for g in cfg.groups)
        return dataclasses.replace(cfg, groups=groups)
    # 28 layers: 1 dense + 27 MoE; 64 routed top-6 + 2 shared, expert ff 1408
    return _cfg("deepseek-moe-16b", 27, 2048, 16, 16, 128, 10944, 1408,
                n_experts=64, top_k=6, n_shared=2, vocab=102400)
