"""Training step and loop, counterpart of ``repro.training.train_loop``:
loss, gradients over the parameter leaves, then the AdamW update. PyTorch
runs eagerly, so the step is a plain function (no jit); its metrics are
0-dim tensors on the params' device, with no host sync inside the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import LM
from repro_torch.utils.device import resolve_device
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    model: LM

    @classmethod
    def create(cls, cfg: ModelConfig, generator: torch.Generator, *,
               dtype=torch.float32, device=None):
        model = LM(cfg)
        params = model.init(generator, dtype=dtype,
                            device=resolve_device(device))
        return cls(params=params, opt=adamw_init(params), model=model)


def loss_and_grads(model: LM, params, tokens, labels, mask, *,
                   remat: bool = True, embeds=None):
    """(loss, metrics, grads): ``model.loss`` and its gradient with
    respect to every parameter leaf, as a tree shaped like ``params``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        loss, metrics = model.loss(p, tokens, labels, embeds=embeds,
                                   label_mask=mask, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t)
              for g, t in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(model: LM, opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True):
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, tokens, labels, mask, embeds=None):
        loss, metrics, grads = loss_and_grads(model, params, tokens, labels,
                                              mask, remat=remat,
                                              embeds=embeds)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return new_params, new_opt, metrics

    return train_step


def train_loop(cfg: ModelConfig, *, steps: int, data_iter, generator=None,
               opt_cfg: Optional[AdamWConfig] = None, dtype=torch.float32,
               device=None, log_every: int = 10, callback=None):
    """Single-process training driver (examples / smoke tests), on the
    card unless ``device`` says otherwise. Weights are drawn from
    ``generator`` (seed 0 when None)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    state = TrainState.create(cfg, generator, dtype=dtype, device=device)
    step_fn = make_train_step(state.model, opt_cfg)
    history = []
    for step in range(steps):
        tokens, labels, mask = (torch.as_tensor(a, device=device)
                                for a in next(data_iter))
        state.params, state.opt, metrics = step_fn(
            state.params, state.opt, tokens, labels, mask)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            if callback:
                callback(step, m)
    return state, history
