"""The production train step of an architecture, counterpart of
``repro.launch.steps.build_train_step``. (``prefill_step`` and
``serve_step`` feed the slotted gather-path caches and come with that
slice.)"""
from __future__ import annotations

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
