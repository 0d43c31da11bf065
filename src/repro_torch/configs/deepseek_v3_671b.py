"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA attention (kv_lora 512, rope 64),
1 shared + 256 routed top-8 fine-grained MoE, first 3 layers dense.

MTP (multi-token prediction) head is out of scope (DESIGN.md §7): it is a
training-objective add-on orthogonal to interception-aware serving.
"""
from repro_torch.configs.base import (AttentionCfg, BlockCfg, FFNCfg, LayerGroup,
                                ModelConfig)

SOURCE = "arXiv:2412.19437"


def _mla(n_heads, q_lora, kv_lora, nope, rope, v_dim) -> AttentionCfg:
    return AttentionCfg(kind="mla", n_heads=n_heads, n_kv_heads=n_heads,
                        head_dim=nope + rope, q_lora_rank=q_lora,
                        kv_lora_rank=kv_lora, qk_nope_head_dim=nope,
                        qk_rope_head_dim=rope, v_head_dim=v_dim)


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        attn = _mla(4, 64, 32, 32, 16, 32)
        dense = BlockCfg(kind="attn", attn=attn,
                         ffn=FFNCfg(kind="dense", d_ff=512))
        moe = BlockCfg(kind="attn", attn=attn,
                       ffn=FFNCfg(kind="moe", n_routed_experts=4, top_k=2,
                                  n_shared_experts=1, d_ff_expert=128,
                                  capacity_factor=8.0))
        return ModelConfig(name="deepseek-v3-671b-tiny", family="moe",
                           source=SOURCE, d_model=256, vocab_size=512,
                           groups=(LayerGroup((dense,), 1),
                                   LayerGroup((moe,), 1)))
    attn = _mla(128, 1536, 512, 128, 64, 128)
    dense = BlockCfg(kind="attn", attn=attn,
                     ffn=FFNCfg(kind="dense", d_ff=18432))
    moe = BlockCfg(kind="attn", attn=attn,
                   ffn=FFNCfg(kind="moe", n_routed_experts=256, top_k=8,
                              n_shared_experts=1, d_ff_expert=2048))
    # 61 layers: 3 dense + 58 MoE
    return ModelConfig(name="deepseek-v3-671b", family="moe", source=SOURCE,
                       d_model=7168, vocab_size=129280,
                       groups=(LayerGroup((dense,), 3),
                               LayerGroup((moe,), 58)))
