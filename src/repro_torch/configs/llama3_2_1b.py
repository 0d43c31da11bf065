"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3, tied embeddings."""
from repro_torch.configs.base import ModelConfig, simple_dense

SOURCE = "hf:meta-llama/Llama-3.2-1B"


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense(
            "llama3.2-1b-tiny", SOURCE, n_layers=2, d_model=256, n_heads=8,
            n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
            rope_theta=500000.0, tie_embeddings=True)
    return simple_dense(
        "llama3.2-1b", SOURCE, n_layers=16, d_model=2048, n_heads=32,
        n_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=128256,
        rope_theta=500000.0, tie_embeddings=True)
