"""Sharded npz checkpointing, counterpart of ``repro.training.checkpoint``
with the same on-disk layout: <dir>/step_<n>/shard_<i>.npz +
manifest.json. Leaves are flattened in the JAX tree order (dict keys
sorted, tuples by index) under archive keys spelled as
``jax.tree_util.keystr`` spells them (``"['groups'][0]['scan']['b0']
['attn']['wq']"``), so a float32 checkpoint loads from either package
into the other. numpy has no bfloat16: such a leaf is stored as float32
(exactly) and cast back on load.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def _paths(tree, prefix=""):
    """(keystr, leaf) pairs in the JAX flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Any,
                    shard_bytes: int = 512 << 20) -> str:
    out = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(out, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _paths(tree)}
    shards, cur, cur_bytes = [], {}, 0
    for k, v in flat.items():
        if cur and cur_bytes + v.nbytes > shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += v.nbytes
    if cur:
        shards.append(cur)
    manifest = {"step": step, "n_shards": len(shards),
                "keys": {k: i for i, s in enumerate(shards) for k in s}}
    for i, s in enumerate(shards):
        np.savez(os.path.join(out, f"shard_{i:04d}.npz"), **s)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return out


def _rebuild(like, prefix, data):
    if isinstance(like, dict):
        return {k: _rebuild(v, f"{prefix}[{k!r}]", data)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, f"{prefix}[{i}]", data)
                          for i, v in enumerate(like))
    if prefix not in data:
        raise KeyError(f"checkpoint missing {prefix}")
    arr = data[prefix]
    assert arr.shape == tuple(like.shape), (prefix, arr.shape, like.shape)
    return torch.from_numpy(arr).to(dtype=like.dtype, device=like.device)


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (tensors giving each leaf's
    shape, dtype and device)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    for i in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{i:04d}.npz")) as z:
            for k in z.files:
                data[k] = z[k]
    return _rebuild(like, "", data)


def latest_checkpoint(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return os.path.join(directory, steps[-1]) if steps else None
