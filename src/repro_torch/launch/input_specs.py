"""Stand-ins for every (architecture x input shape) pair, counterpart of
``repro.launch.input_specs``: tensors on the ``meta`` device (a shape and
a dtype, no storage) in place of ``jax.ShapeDtypeStruct``, so nothing is
allocated however large the shape.

For the modality-stub architectures:
  * vlm (pixtral): precomputed patch embeddings (B, vision_prefix_len, d)
    plus text tokens for the remainder of the sequence.
  * audio (musicgen): 4-codebook EnCodec token ids (B, S, K).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape: InputShape):
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_codebooks:
        toks = _spec((B, S, cfg.n_codebooks), torch.int32)
        labels = _spec((B, S, cfg.n_codebooks), torch.int32)
        return {"tokens": toks, "labels": labels,
                "mask": _spec((B, S), torch.float32), "embeds": None}
    P = cfg.vision_prefix_len
    toks = _spec((B, S - P), torch.int32)
    embeds = _spec((B, P, cfg.d_model), torch.bfloat16) if P else None
    return {"tokens": toks, "labels": _spec((B, S - P), torch.int32),
            "mask": _spec((B, S - P), torch.float32), "embeds": embeds}


def prefill_inputs(cfg: ModelConfig, shape: InputShape):
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_codebooks:
        return {"tokens": _spec((B, S, cfg.n_codebooks), torch.int32),
                "embeds": None}
    P = cfg.vision_prefix_len
    embeds = _spec((B, P, cfg.d_model), torch.bfloat16) if P else None
    return {"tokens": _spec((B, S - P), torch.int32), "embeds": embeds}


def decode_inputs(cfg: ModelConfig, shape: InputShape):
    B = shape.global_batch
    if cfg.n_codebooks:
        toks = _spec((B, cfg.n_codebooks), torch.int32)
    else:
        toks = _spec((B,), torch.int32)
    return {"tokens": toks, "pos": _spec((B,), torch.int32)}


def cache_struct(cfg: ModelConfig, shape: InputShape, window_override):
    """The decode cache, ``LM.init_cache`` on the meta device (no
    allocation)."""
    from repro_torch.models.model import LM
    return LM(cfg).init_cache(shape.global_batch, shape.seq_len,
                              dtype=getattr(torch, cfg.dtype), device="meta",
                              window_override=window_override)


def params_struct(cfg: ModelConfig, dtype=None):
    """The parameter tree, ``LM.init`` on the meta device (no allocation;
    the generator draws nothing there), with the reference's float32
    leaves kept float32 as ``models.bridge.cast_params`` keeps them."""
    from repro_torch.models.bridge import cast_params
    from repro_torch.models.model import LM
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    params = LM(cfg).init(torch.Generator(), dtype=dtype, device="meta")
    return cast_params(params, cfg, dtype)


def window_override_for(cfg: ModelConfig, shape: InputShape):
    """long_500k decode must be sub-quadratic / memory-bounded: dense
    full-attention layers fall back to a sliding window
    (cfg.long_context_window); SSM/MLA are naturally O(1)/compressed and
    keep their configured behaviour ("cfg")."""
    if shape.name == "long_500k":
        return cfg.long_context_window
    return "cfg"


def input_specs(cfg: ModelConfig, shape_name: str):
    """The full stand-in bundle for one (arch, shape) pair."""
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train":
        return train_inputs(cfg, shape)
    if shape.mode == "prefill":
        return prefill_inputs(cfg, shape)
    return decode_inputs(cfg, shape)
