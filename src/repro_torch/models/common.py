"""Shared low-level model components, plain PyTorch functions on tensors.

Counterpart of ``repro.models.common``: the same math in the same op
order, so the port's CPU path agrees with the JAX reference on the same
inputs. Every init helper takes an explicit ``torch.Generator``, dtype
and device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, in_axis=-2, *,
               dtype: torch.dtype, device) -> torch.Tensor:
    """Truncated-normal fan-in init (lecun-style), cut at two std."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return out.to(dtype)


def embed_init(generator: torch.Generator, shape, *, dtype: torch.dtype,
               device) -> torch.Tensor:
    """Embeddings at 1/sqrt(d), so the residual stream enters the first
    rms_norm at unit RMS."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return (out / math.sqrt(shape[-1])).to(dtype)


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def softcap(x: torch.Tensor, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation_fn(name: str):
    return {"silu": F.silu,
            # jax.nn.gelu defaults to the tanh approximation
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# --------------------------------------------------------------------------
# RoPE (gpt-neox rotate-half convention)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., T, n_heads, head_dim); positions: broadcastable to (..., T).
    Rotates in float32 and returns x's dtype."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)      # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
