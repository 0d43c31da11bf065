"""Qwen2-72B [arXiv:2407.10671] — GQA kv=8, QKV bias."""
from repro_torch.configs.base import ModelConfig, simple_dense

SOURCE = "arXiv:2407.10671"


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense(
            "qwen2-72b-tiny", SOURCE, n_layers=2, d_model=256, n_heads=8,
            n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512, qkv_bias=True)
    return simple_dense(
        "qwen2-72b", SOURCE, n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=29568, vocab_size=152064,
        qkv_bias=True, rope_theta=1000000.0)
