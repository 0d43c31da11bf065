"""MusicGen-large [arXiv:2306.05284] — decoder-only transformer over EnCodec
tokens, 4 codebooks with the delay interleaving pattern.

Backbone only per the task carve-out: the EnCodec conv codec is a stub;
``input_specs()`` feeds 4-stream codec token ids. The model sums the 4
codebook embeddings per position and emits 4 parallel logit heads.
"""
from repro_torch.configs.base import ModelConfig, simple_dense

SOURCE = "arXiv:2306.05284"


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense(
            "musicgen-large-tiny", SOURCE, family="audio", n_layers=2,
            d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
            vocab_size=256, n_codebooks=4, gated=False, activation="gelu")
    return simple_dense(
        "musicgen-large", SOURCE, family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
        n_codebooks=4, gated=False, activation="gelu")
