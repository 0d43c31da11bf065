"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — Pixtral-ViT vision encoder +
Mistral-NeMo-style multimodal decoder.

Backbone only per the task carve-out: the ViT encoder + projector are a stub;
``input_specs()`` provides pre-computed patch embeddings (B, vision_prefix_len,
d_model) which the decoder consumes as a prefix, followed by text tokens.
"""
from repro_torch.configs.base import ModelConfig, simple_dense

SOURCE = "hf:mistralai/Pixtral-12B-2409"


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense(
            "pixtral-12b-tiny", SOURCE, family="vlm", n_layers=2, d_model=256,
            n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
            vision_prefix_len=16)
    return simple_dense(
        "pixtral-12b", SOURCE, family="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=131072, rope_theta=1000000.0, vision_prefix_len=1024)
