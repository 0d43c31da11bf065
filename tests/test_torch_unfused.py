"""The port's per-call paged path, ``Engine(fused=False)``, on the CPU.

Each prefill chunk is one ``LM.extend_step_paged`` call and the decodes
one bucketed ``LM.decode_step_paged`` call (the ``paged_attention``
kernel's path); their logits cross to the host and are sampled there at
commit. Held two ways:

* Against the JAX ``Engine(fused=False)``: the same tiny-llama weights
  (bridged through ``from_jax_params``), the same chip spec (the port's
  copy of TPU_V5E) and the same agent workload as
  ``tests/test_torch_engine.py`` — equal greedy streams,
  ``engine.counters`` (``logit_bytes`` included: float32 logits on both
  sides), scheduler stats, waste-ledger causes and virtual clock, under
  ``infercept`` and ``swap``.
* Inside the port, DESIGN.md §6: the unfused streams equal the fused
  streams under all 4 policies, with the prefix cache off and on.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import POLICIES as JAX_POLICIES
from repro.models import LM as JaxLM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.workloads import make_agent_workload as jax_workload
from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.models.bridge import from_jax_params
from repro_torch.obs.metrics import SCHED_COUNTER_SCHEMA
from repro_torch.serving.engine import Engine
from repro_torch.serving.workloads import make_agent_workload
from repro_torch.utils.hw import TPU_V5E


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them and slow these
    tests many times over, so each worker's torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALL_POLICIES = ["preserve", "vllm", "swap", "infercept"]
ENGINE_KW = dict(page_size=16, n_pages=128, max_model_len=256)
# tests/test_paged_engine.py's agent workload: mid-page prefix divergence
# (system prompt 50 vs page 16), so COW tails of cached pages are taken
WORKLOAD_KW = dict(seed=5, n_sessions=2, rate_rps=2.0, n_templates=2,
                   system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
                   hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
                   final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2,
                   max_ctx=240)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("llama3.2-1b", tiny=True)
    cfg = get_config("llama3.2-1b", tiny=True)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    reqs = make_agent_workload(vocab=cfg.vocab_size, **WORKLOAD_KW)
    return jcfg, cfg, params, reqs


def _port(cfg, params, reqs, policy, **kw):
    eng = Engine(cfg, POLICIES[policy], params=params, chip=TPU_V5E,
                 device="cpu", **ENGINE_KW, **kw)
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    fin = eng.run(strict=True)
    assert len(fin) == len(reqs)
    return {r.rid: eng.generated_text(r) for r in fin}, eng


@pytest.fixture(scope="module")
def fused_streams(setup):
    _, cfg, params, reqs = setup
    return _port(cfg, params, reqs, "infercept")[0]


@pytest.mark.parametrize("policy", ["infercept", "swap"])
def test_port_unfused_matches_jax_unfused(setup, policy):
    jcfg, cfg, params, reqs = setup
    jeng = JaxEngine(jcfg, JAX_POLICIES[policy], seed=0, fused=False,
                     **ENGINE_KW)
    for r in jax_workload(vocab=jcfg.vocab_size, **WORKLOAD_KW):
        jeng.add_request(r)
    jfin = jeng.run(strict=True)
    want = {r.rid: jeng.generated_text(r) for r in jfin}
    got, eng = _port(cfg, params, reqs, policy, fused=False)
    assert got == want
    assert dict(eng.counters) == dict(jeng.counters)
    assert {f: getattr(eng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA} \
        == {f: getattr(jeng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA}
    assert eng.now == jeng.now
    assert eng.ledger.causes == jeng.ledger.causes
    # the per-call path really ran: whole float32 logits rows crossed to
    # the host, not the fused path's int32 ids
    assert eng.counters["logit_bytes"] >= \
        eng.counters["decode_tokens"] * cfg.vocab_size * 4


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_port_fused_equals_unfused(setup, fused_streams, policy,
                                   prefix_cache):
    """DESIGN.md §6 inside the port: the per-call path emits what the
    fused path emits, under every policy, with and without the cache."""
    _, cfg, params, reqs = setup
    got, eng = _port(cfg, params, reqs, policy, fused=False,
                     prefix_cache=prefix_cache)
    assert got == fused_streams
    assert not eng._pending_oracle
    if not prefix_cache:   # every page back in the free list
        assert eng.blocks.num_free == eng.blocks.n_pages - 1


def test_unfused_engine_without_device_needs_cuda(setup, monkeypatch):
    """fused=False runs on the card unless the caller asks for the CPU,
    as the fused engine does."""
    _, cfg, params, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, POLICIES["infercept"], params=params, fused=False,
               **ENGINE_KW)


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_decode_parity_rehearsal():
    """chip_smoke.py's decode_parity phase at the tiny config on the CPU:
    the per-call prefill and decode against the fused path, in float32
    and bfloat16, from the same weights and pools; on the plain versions
    the two paths agree exactly."""
    chip_smoke = _chip_smoke()
    chip_smoke.check_decode_parity(tiny=True, device="cpu")
    r = chip_smoke.paths_parity(torch.float32, conditioned=False, tiny=True,
                                device="cpu")
    assert r["decode_err"] == 0.0 and r["prefill_err"] <= 1e-5
    assert r["prefill_ids"][0] == r["prefill_ids"][1]


def test_chip_smoke_unfused_rehearsal():
    """chip_smoke.py's unfused phase, rehearsed at the tiny config on the
    CPU: the same workload, policy, checks and launch-count reads as on
    the card (no kernel launches here). The per-call path calls the paged
    decode attention and never the ragged one."""
    chip_smoke = _chip_smoke()
    rec = chip_smoke.Recorder()
    res = chip_smoke.serve("infercept", rec, tiny=True, device="cpu",
                           fused=False)
    assert res["finished"] == res["requests"] and not res["fused"]
    assert {"paged_attention", "kv_append"} <= set(rec.calls)
    assert "ragged_paged_attention" not in rec.calls
    assert all(v == 0 for v in res["launches"].values())
