"""The one way weights cross from the JAX reference into the port.

``from_jax_params`` takes the ``repro`` ``LM.init`` pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``: groups stacked over
``n_periods``, zamba2's shared block once under "shared") and returns the
port's parameter tree with the same layout, as torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import FLOAT32_PARAMS
from repro_torch.utils.tree import tree_map


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # ml_dtypes bfloat16: move the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def cast_params(params: dict, cfg: ModelConfig, dtype, device=None) -> dict:
    """A new tree with every leaf cast to ``dtype`` (and moved to
    ``device`` where given) but those the reference keeps float32 at any
    model dtype — the SSM cells' gate and decay parameters
    (``models.ssm.FLOAT32_PARAMS``) and the MoE router — which come out
    float32. A leaf already in its dtype and on its device is not
    copied. A ``shared_attn`` block has no entry in its period: its tree,
    ``params["shared"]`` (attention and a dense FFN), is cast whole.
    Codebook tables and heads are leaves like any other and cast with
    the model's dtype."""
    out = tree_map(lambda t: t.to(device=device, dtype=dtype), params)
    for gi, g in enumerate(cfg.groups):
        for j, blk in enumerate(g.period):
            if blk.kind == "shared_attn":
                continue
            src = params["groups"][gi]["scan"][f"b{j}"]
            dst = out["groups"][gi]["scan"][f"b{j}"]
            kept = [(dst["cell"], src["cell"], name)
                    for name in FLOAT32_PARAMS.get(blk.kind, ())]
            if "moe" in src:
                kept.append((dst["moe"], src["moe"], "router"))
            for d, s, name in kept:
                d[name] = s[name].to(device=device, dtype=torch.float32)
    return out


def from_jax_params(np_tree, cfg: ModelConfig, *, dtype=None,
                    device="cpu") -> dict:
    """Numpy-leaved JAX params -> port params (same nesting: dicts, and
    the ``groups`` tuple). "embed" must be (V, d), or (K, V, d) for a
    config with ``n_codebooks`` K, and an untied "lm_head" (d, V) or (K,
    d, V). ``dtype`` casts the leaves as ``cast_params``
    does, keeping the reference's float32 leaves float32; None keeps each
    leaf's own."""
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    shapes = {"embed": (*books, cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (*books, cfg.d_model, cfg.vocab_size)
    for name, want in shapes.items():
        if tuple(np.shape(np_tree[name])) != want:
            raise ValueError(f"{name} {np.shape(np_tree[name])} does not "
                             f"fit {cfg.name}")
    if len(np_tree["groups"]) != len(cfg.groups):
        raise ValueError("param groups do not match the config's groups")
    out = tree_map(lambda a: _to_tensor(a).to(device=device), dict(np_tree))
    out["groups"] = tuple(out["groups"])
    return out if dtype is None else cast_params(out, cfg, dtype)
