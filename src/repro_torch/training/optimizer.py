"""AdamW with decoupled weight decay and global-norm clipping, counterpart
of ``repro.training.optimizer``: the same numbers, on trees of tensors.

The learning rate of an update is the schedule at the state's old step;
bias correction uses the new step; weight decay applies to leaves of two
or more dims only. The moments are float32 whatever the params' dtype.
The update is functional, as the reference's: it returns new trees.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # Global-norm clip. Default off: Adam's per-parameter normalization
    # already bounds update magnitude, and rms_norm's 1/rms Jacobian makes
    # raw embedding-gradient norms legitimately O(100) at init — a 1.0 clip
    # strangles the effective LR ~200x (verified empirically).
    grad_clip: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay; step a 0-dim integer tensor."""
    step = step.float()
    warm = cfg.lr * torch.clamp((step + 1) / max(1, cfg.warmup_steps),
                                max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}), all
    tensors on the params' device: no host sync."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip and cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = 1.0
    lr = lr_schedule(cfg, state["step"])
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        newp = p.float() - lr * (update + decay * p.float())
        return newp.to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    new_state = {"mu": pick(1), "nu": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}
