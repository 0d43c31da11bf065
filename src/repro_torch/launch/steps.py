"""The production step functions of an architecture, counterpart of
``repro.launch.steps``: train_step, prefill_step and serve_step
(single-token greedy decode). The serve steps run under
``torch.no_grad``. prefill_step runs the full-sequence forward (attention
through the flash kernels) and returns the decode cache: attention
blocks' slotted K/V caches of ``seq_len`` slots, SSM blocks' states;
serve_step decodes over it (attention in plain PyTorch, the gather
path)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import LM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import make_train_step


def build_train_step(cfg: ModelConfig, remat: bool = True):
    model = LM(cfg)
    step = make_train_step(model, AdamWConfig(), remat=remat)

    def train_step(params, opt_state, tokens, labels, mask, embeds=None):
        return step(params, opt_state, tokens, labels, mask, embeds=embeds)

    return model, train_step


def build_prefill_step(cfg: ModelConfig, seq_len: int, window_override="cfg"):
    model = LM(cfg)

    @torch.no_grad()
    def prefill_step(params, tokens, embeds=None):
        """tokens (B, T), or (B, T, K) with codebooks, after the prefix
        ``embeds`` (B, P, d) where given -> (logits (B, V) or (B, K, V)
        at the last position, the decode cache)."""
        out = model.forward(params, tokens, embeds, remat=False,
                            window_override=window_override,
                            return_cache_len=seq_len)
        logits = model.logits(params, out.hidden[:, -1])
        return logits, out.cache

    return model, prefill_step


def build_serve_step(cfg: ModelConfig, window_override="cfg"):
    model = LM(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        """tokens (B,), or (B, K) with codebooks, at positions pos (B,)
        -> (logits (B, V) or (B, K, V), the greedy next tokens (B,) or
        (B, K) int32, the new cache)."""
        logits, new_cache = model.decode_step(
            params, tokens, pos, cache, window_override=window_override)
        # greedy next token on-device (production decode loop shape)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, next_tok, new_cache

    return model, serve_step
