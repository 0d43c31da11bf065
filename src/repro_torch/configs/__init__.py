"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

from repro_torch.configs import (deepseek_7b, deepseek_moe_16b, deepseek_v3_671b,
                           gemma2_9b, llama3_2_1b, musicgen_large,
                           paper_models, pixtral_12b, qwen2_72b, xlstm_350m,
                           zamba2_1_2b)
from repro_torch.configs.base import (INPUT_SHAPES, AttentionCfg, BlockCfg, FFNCfg,
                                InputShape, LayerGroup, ModelConfig, SSMCfg)

# The 10 assigned architectures.
ARCH_REGISTRY = {
    "deepseek-moe-16b": deepseek_moe_16b.make_config,
    "musicgen-large": musicgen_large.make_config,
    "gemma2-9b": gemma2_9b.make_config,
    "deepseek-7b": deepseek_7b.make_config,
    "pixtral-12b": pixtral_12b.make_config,
    "deepseek-v3-671b": deepseek_v3_671b.make_config,
    "xlstm-350m": xlstm_350m.make_config,
    "qwen2-72b": qwen2_72b.make_config,
    "llama3.2-1b": llama3_2_1b.make_config,
    "zamba2-1.2b": zamba2_1_2b.make_config,
}

# The paper's own evaluation models (simulator / Fig. 2-3 reproduction).
PAPER_MODELS = {
    "gpt-j-6b": paper_models.gptj_6b,
    "vicuna-13b": paper_models.vicuna_13b,
    "llama3-70b": paper_models.llama3_70b,
}


def list_archs():
    return sorted(ARCH_REGISTRY)


def get_config(name: str, tiny: bool = False) -> ModelConfig:
    reg = {**ARCH_REGISTRY, **PAPER_MODELS}
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(reg)}")
    return reg[name](tiny=tiny)


__all__ = [
    "ARCH_REGISTRY", "PAPER_MODELS", "INPUT_SHAPES", "ModelConfig",
    "InputShape", "AttentionCfg", "BlockCfg", "FFNCfg", "SSMCfg",
    "LayerGroup", "get_config", "list_archs",
]
