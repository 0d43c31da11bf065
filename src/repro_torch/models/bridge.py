"""The one way weights cross from the JAX reference into the port.

``from_jax_params`` takes the ``repro`` ``LM.init`` pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``: groups stacked over
``n_periods``) and returns the port's parameter tree with the same
layout, as torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.tree import tree_map


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # ml_dtypes bfloat16: move the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_params(np_tree, cfg: ModelConfig, *, dtype=None,
                    device="cpu") -> dict:
    """Numpy-leaved JAX params -> port params (same nesting: dicts, and
    the ``groups`` tuple). ``dtype`` casts every leaf; None keeps each
    leaf's own."""
    if tuple(np.shape(np_tree["embed"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {np.shape(np_tree['embed'])} does not fit "
                         f"{cfg.name}")
    if len(np_tree["groups"]) != len(cfg.groups):
        raise ValueError("param groups do not match the config's groups")
    out = tree_map(lambda a: _to_tensor(a).to(device=device, dtype=dtype),
                   dict(np_tree))
    out["groups"] = tuple(out["groups"])
    return out
