"""Dense FFN (SwiGLU / GeGLU / plain), counterpart of ``repro.models.mlp``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import FFNCfg
from repro_torch.models.common import activation_fn, dense_init


def init_mlp(generator: torch.Generator, d_model: int, f: FFNCfg, *,
             dtype: torch.dtype, device):
    p = {"w_up": dense_init(generator, (d_model, f.d_ff), dtype=dtype,
                            device=device),
         "w_down": dense_init(generator, (f.d_ff, d_model), dtype=dtype,
                              device=device)}
    if f.gated:
        p["w_gate"] = dense_init(generator, (d_model, f.d_ff), dtype=dtype,
                                 device=device)
    return p


def mlp_forward(p, f: FFNCfg, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> (..., d)."""
    act = activation_fn(f.activation)
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if f.gated else act(up)
    return h @ p["w_down"]
