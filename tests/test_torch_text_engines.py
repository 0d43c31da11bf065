"""The port's engine on two text models that no slice of their own holds
against the JAX engine: tiny pixtral-12b served on text alone (its
prefix is a ``prefill_step`` input, tests/test_torch_embeds.py) and tiny
deepseek-7b (llama-style, 30 layers cut to the tiny config's). Streams,
counters, scheduler stats, ledger causes and the virtual clock equal the
JAX engine's (``tests/wide_models.py: engine_matches_jax``) under
InferCept and swap, fused, per-call (``fused=False``) and over int8
pools."""
import pytest

from wide_models import engine_matches_jax, tiny_model
from wide_models import one_torch_thread  # noqa: F401 (autouse fixture)

PATHS = {"fused": {}, "unfused": {"fused": False},
         "int8": {"kv_dtype": "int8"}}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("policy", ["infercept", "swap"])
@pytest.mark.parametrize("name", ["pixtral-12b", "deepseek-7b"])
def test_engine_matches_jax(name, policy, path):
    jcfg, cfg, _, _, params = tiny_model(name)
    assert engine_matches_jax(jcfg, cfg, params, policy, **PATHS[path])
