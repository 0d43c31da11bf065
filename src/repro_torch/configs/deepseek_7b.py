"""DeepSeek-7B [arXiv:2401.02954] — llama-architecture dense, MHA (kv=heads)."""
from repro_torch.configs.base import ModelConfig, simple_dense

SOURCE = "arXiv:2401.02954"


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense(
            "deepseek-7b-tiny", SOURCE, n_layers=2, d_model=256, n_heads=4,
            n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512)
    return simple_dense(
        "deepseek-7b", SOURCE, n_layers=30, d_model=4096, n_heads=32,
        n_kv_heads=32, head_dim=128, d_ff=11008, vocab_size=102400)
