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
import torch.utils.checkpoint


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


# --------------------------------------------------------------------------
# Memory-lean cross entropy: never materializes (B, T, V) logits.
# --------------------------------------------------------------------------

def _ce_chunk(xf, wc, labels, start, m, s, tgt):
    """One vocab chunk of the streaming logsumexp: columns
    [start, start + wc.shape[1]) of the logits."""
    logits = xf @ wc.float()
    new_m = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - new_m) + torch.exp(
        logits - new_m[..., None]).sum(dim=-1)
    local = labels - start
    in_chunk = (local >= 0) & (local < wc.shape[1])
    picked = torch.gather(
        logits, -1, local.clamp(0, wc.shape[1] - 1)[..., None].long())[..., 0]
    return new_m, s, torch.where(in_chunk, picked, tgt)


def chunked_cross_entropy(x, w_out, labels, *, vocab_chunk=16384,
                          label_mask=None):
    """Mean next-token CE of ``x @ w_out`` against ``labels``.

    x: (B, T, d) hidden states, w_out: (d, V), labels: (B, T) int.
    Loops over vocab chunks accumulating a streaming logsumexp plus the
    target-class logit, so peak memory is (B, T, vocab_chunk) instead of
    (B, T, V). The reference pads the last chunk with zero columns masked
    to -inf; here the last chunk is just narrower, which gives the same
    max, sum and target. Each chunk is checkpointed: under autograd its
    float32 logits are recomputed in the backward instead of being kept
    (1 GiB a chunk at B 4 x T 2048)."""
    B, T, d = x.shape
    V = w_out.shape[-1]
    xf = x.float()
    m = torch.full((B, T), -math.inf, device=x.device)
    s = torch.zeros((B, T), device=x.device)
    tgt = torch.zeros((B, T), device=x.device)
    for start in range(0, V, vocab_chunk):
        m, s, tgt = torch.utils.checkpoint.checkpoint(
            _ce_chunk, xf, w_out[:, start:start + vocab_chunk], labels,
            start, m, s, tgt, use_reentrant=False)
    nll = (m + torch.log(s)) - tgt                # logsumexp - target logit
    return _masked_mean(nll, label_mask)


def cross_entropy_logits(logits, labels, label_mask=None):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _masked_mean(lse - tgt, label_mask)


def _masked_mean(nll, label_mask):
    if label_mask is None:
        return torch.mean(nll)
    label_mask = label_mask.float()
    return torch.sum(nll * label_mask) / torch.clamp(torch.sum(label_mask),
                                                     min=1.0)
