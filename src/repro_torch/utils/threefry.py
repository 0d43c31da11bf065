"""JAX's threefry PRNG in torch integer ops, bit for bit.

Only what ``models.model.sample_tokens`` draws is here: a key made from a
32-bit seed (``jax.random.PRNGKey``), a key folded with a 32-bit datum
(``jax.random.fold_in``), and a row of ``n`` 32-bit words from each key
under ``jax_threefry_partitionable`` (element i is ``b1 ^ b2`` of
threefry2x32(key, (0, i))), turned into uniforms and Gumbel noise as
``jax.random.uniform`` and ``jax.random.gumbel`` (its "low" mode) do.

Every function works on a batch of keys at once, as a fixed sequence of
tensor ops whose count does not depend on the batch or on ``n``. A 32-bit
word is held in int64 and masked to 32 bits after each add and shift (the
uint32 tensor type has partial operator support), so the same code runs
on the CPU and on a CUDA device. A key is a pair ``(k1, k2)`` of int64
tensors of one shape.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal: the Gumbel draw's lower bound for u
TINY = torch.finfo(torch.float32).tiny

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(key: Key, x1: torch.Tensor, x2: torch.Tensor) -> Key:
    """Threefry-2x32 with 20 rounds of the counter words (x1, x2) under
    ``key``; all broadcastable int64 tensors of 32-bit values. Returns the
    two output words."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def prng_key(seeds: torch.Tensor) -> Key:
    """``jax.random.PRNGKey`` of each 32-bit seed (B,): (0, the seed's
    bits)."""
    k2 = seeds.to(torch.int64) & M32
    return torch.zeros_like(k2), k2


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in`` of each key with its 32-bit datum (B,)."""
    d = data.to(torch.int64) & M32
    return threefry2x32(key, torch.zeros_like(d), d)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """(B, n) 32-bit words (int64) of each of B keys, as
    ``jax.random.bits(key, (n,), uint32)``."""
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32((k1[:, None], k2[:, None]), torch.zeros_like(lo),
                          lo)
    return b1 ^ b2


def uniform(key: Key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """(B, n) float32 uniforms in [minval, maxval), as
    ``jax.random.uniform``: the top 23 bits of each word as the mantissa
    of a float in [1, 2), minus 1, scaled, and held at or above
    minval. The bounds are float32 values passed as Python numbers, so
    no tensor crosses from the host (a pageable copy would sync the
    stream)."""
    bits = random_bits(key, n)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * scale + lo, min=lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """(B, n) float32 standard Gumbel noise, as ``jax.random.gumbel`` in
    its low dynamic range mode: -log(-log(u)), u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, TINY, 1.0)))
