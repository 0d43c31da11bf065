"""``launch/input_specs.py`` in the port against the reference's: for every
config (the assigned architectures and the paper's models) and every
input shape, the stand-ins have the reference's keys, shapes and dtypes —
the audio (B, S, K) and (B, K) ids and pixtral's prefix carved from the
sequence among them — as meta-device tensors, which hold no storage. The
decode caches and parameter trees at the tiny configs match the
reference's ``eval_shape`` leaf by leaf, and ``params_struct`` of
qwen2-72b counts its ~72e9 parameters without allocating them, as
tests/test_launch.py holds the reference's."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import input_specs as ref
from repro_torch.configs import (ARCH_REGISTRY, INPUT_SHAPES, PAPER_MODELS,
                                 get_config)
from repro_torch.launch import input_specs
from repro_torch.utils.tree import tree_leaves

CONFIGS = sorted({**ARCH_REGISTRY, **PAPER_MODELS})


def _desc(leaf):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.device.type == "meta"
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    return tuple(leaf.shape), np.dtype(leaf.dtype).name


def _paths(tree, prefix=()):
    """{path: (shape, dtype) or None} of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        return {p: x for k in tree
                for p, x in _paths(tree[k], prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _paths(v, prefix + (i,)).items()}
    return {prefix: None if tree is None else _desc(tree)}


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_input_specs_match_reference(name, shape):
    want = ref.input_specs(jax_config(name), shape)
    got = input_specs.input_specs(get_config(name), shape)
    assert _paths(got) == _paths(want)
    assert input_specs.window_override_for(
        get_config(name), INPUT_SHAPES[shape]) == ref.window_override_for(
        jax_config(name), INPUT_SHAPES[shape])


def test_audio_and_prefix_specs():
    au = input_specs.input_specs(get_config("musicgen-large"), "decode_32k")
    assert au["tokens"].shape == (128, 4) and au["pos"].shape == (128,)
    tr = input_specs.input_specs(get_config("musicgen-large"), "train_4k")
    assert tr["tokens"].shape == tr["labels"].shape == (256, 4096, 4)
    assert tr["mask"].shape == (256, 4096) and tr["embeds"] is None
    cfg = get_config("pixtral-12b")
    sp = input_specs.input_specs(cfg, "train_4k")
    assert sp["tokens"].shape == (256, 4096 - cfg.vision_prefix_len)
    assert sp["embeds"].shape == (256, cfg.vision_prefix_len, cfg.d_model)
    assert sp["embeds"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", CONFIGS)
def test_structs_match_reference_at_tiny_widths(name):
    """The parameter tree (the reference's float32 leaves kept float32)
    and the decode cache of every shape's mode, at the tiny config with a
    64-slot cache of 2 sequences."""
    jcfg, cfg = jax_config(name, tiny=True), get_config(name, tiny=True)
    assert _paths(input_specs.params_struct(cfg)) == \
        _paths(ref.params_struct(jcfg))
    for shape in INPUT_SHAPES.values():
        small = type(shape)(shape.name, 64, 2, shape.mode)
        got = input_specs.cache_struct(
            cfg, small, input_specs.window_override_for(cfg, shape))
        want = ref.cache_struct(jcfg, small,
                                ref.window_override_for(jcfg, shape))
        assert _paths(got) == _paths(want), shape.name


def test_params_struct_no_allocation():
    s = input_specs.params_struct(get_config("qwen2-72b"))
    leaves = tree_leaves(s)
    assert all(t.device.type == "meta" for t in leaves)
    total = sum(math.prod(t.shape) for t in leaves)
    assert 70e9 < total < 76e9  # 72B params, never materialized
    # the reference's count, leaf for leaf
    assert total == sum(math.prod(x.shape) for x in jax.tree.leaves(
        ref.params_struct(jax_config("qwen2-72b"))))
