"""GPT-J-6B, the paper's own evaluation model, in the port's engine,
against the JAX engine on the CPU; and qwen2's QKV biases on the paged
paths.

GPT-J is a plain dense model (a non-gated GELU MLP, 16 heads of 256 at
full width, G 1). Two tiny configurations on the reference's seed-0
float32 init, bridged: tiny GPT-J (head_dim 64) and the same at head_dim
256, the full model's head width.

* The engine: greedy streams, ``engine.counters``, scheduler stats,
  ledger causes and the virtual clock equal the JAX engine's under
  ``infercept`` and ``swap``; tiny qwen2-72b (``qkv_bias``) under
  ``infercept``, which the paged paths serve (they add the biases).
* DESIGN.md §6 inside the port at head_dim 256: gather, fused and
  unfused streams are identical under the 4 policies.
* chip_smoke.py's ``gptj_serve`` and ``wide_parity`` legs rehearsed at
  the tiny config.

Greedy ids and engine streams exactly equal; the rehearsed parity legs
within float32 rounding (logits 1e-4, pools and cache 1e-4 of their
largest entry).
"""
import pytest
import torch

from repro_torch.configs import get_config
from wide_models import (ALL_POLICIES, chip_smoke, engine_matches_jax,
                         paths_agree, port_run, rehearse_parity, tiny_model)
from wide_models import one_torch_thread  # noqa: F401 (autouse fixture)

MODELS = {"gptj": ("gpt-j-6b", None), "gptj_hd256": ("gpt-j-6b", 256),
          "qwen2": ("qwen2-72b", None)}


def model(key):
    return tiny_model(*MODELS[key])


def test_configs():
    blk = model("gptj")[1].blocks[0]
    assert not blk.ffn.gated and blk.ffn.activation == "gelu"
    assert blk.attn.n_heads == blk.attn.n_kv_heads          # G 1
    assert model("gptj_hd256")[1].blocks[0].attn.head_dim == 256
    assert get_config("gpt-j-6b").blocks[0].attn.head_dim == 256
    assert model("qwen2")[1].blocks[0].attn.qkv_bias


@pytest.mark.parametrize("key,policy", [
    ("gptj", "infercept"), ("gptj", "swap"), ("gptj_hd256", "infercept"),
    ("gptj_hd256", "swap"), ("qwen2", "infercept")])
def test_engine_matches_jax_engine(key, policy):
    jcfg, cfg, _, _, params = model(key)
    engine_matches_jax(jcfg, cfg, params, policy)


@pytest.fixture(scope="module")
def oracle():
    _, cfg, _, _, params = model("gptj_hd256")
    return port_run(cfg, params, "vllm", paged=False)[0]


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_streams_identical_across_paths_at_hd256(oracle, policy):
    """DESIGN.md §6 inside the port at head_dim 256: the gather, fused and
    unfused paths emit the gather oracle's streams under every policy."""
    _, cfg, _, _, params = model("gptj_hd256")
    paths_agree(oracle, cfg, params, policy)


# ---------------------------------------------------------------------------
# chip_smoke.py's GPT-J phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_gptj_rehearsals():
    """gptj_serve (no recorder: nothing times it) and wide_parity's GPT-J
    legs (``rehearse_parity``) at the tiny config on the CPU, through the
    checks and launch-count reads of the card."""
    cs = chip_smoke()
    model_name, policy, kw = cs.WIDE_SERVE_PHASES["gptj_serve"]
    assert model_name == "gpt-j-6b"
    res = cs.serve(policy, tiny=True, device="cpu", model=model_name, **kw)
    assert res["finished"] == res["requests"]
    assert res["model"] == "gpt-j-6b-tiny"
    rehearse_parity("gpt-j-6b")
