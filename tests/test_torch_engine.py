"""The port's serving engine on the CPU, held two ways.

* Against the JAX ``Engine``: the same tiny-llama weights (bridged
  through ``from_jax_params``), the same chip spec (the port's copy of
  TPU_V5E, so the virtual clock and the Eq. 5 choices match), the same
  agent workload as ``tests/test_paged_engine.py`` — equal greedy
  streams, ``engine.counters``, scheduler stats, waste-ledger causes and
  virtual clock, under ``infercept`` and ``swap``.
* Inside the port, DESIGN.md §6: token streams identical across the 4
  policies x prefix cache on/off x overlap on/off, and a ScriptedClient
  replay identical to the closed loop.
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
from repro_torch.serving.session import SamplingParams, ScriptedClient
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


def _stats(eng):
    return {f: getattr(eng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA}


@pytest.fixture(scope="module")
def baseline(setup):
    _, cfg, params, reqs = setup
    return _port(cfg, params, reqs, "infercept")


@pytest.mark.parametrize("policy", ["infercept", "swap"])
def test_port_engine_matches_jax_engine(setup, policy):
    jcfg, cfg, params, reqs = setup
    jeng = JaxEngine(jcfg, JAX_POLICIES[policy], seed=0, **ENGINE_KW)
    for r in jax_workload(vocab=jcfg.vocab_size, **WORKLOAD_KW):
        jeng.add_request(r)
    jfin = jeng.run(strict=True)
    want = {r.rid: jeng.generated_text(r) for r in jfin}
    got, eng = _port(cfg, params, reqs, policy)
    assert got == want
    assert dict(eng.counters) == dict(jeng.counters)
    assert _stats(eng) == {f: getattr(jeng.sched.stats, f)
                           for f in SCHED_COUNTER_SCHEMA}
    assert eng.now == jeng.now
    assert eng.ledger.causes == jeng.ledger.causes
    assert eng.kv_token_bytes == jeng.kv_token_bytes
    assert eng.counters["swap_bytes"] > 0      # the swap path really ran
    assert eng.stager.packed_pages == eng.stager.unpacked_pages > 0


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_port_streams_identical_across_policies(setup, baseline, policy,
                                                prefix_cache, overlap):
    """DESIGN.md §6 inside the port: scheduling policy, the prefix cache
    and the pipelined step change when work runs, never what it emits."""
    _, cfg, params, reqs = setup
    got, eng = _port(cfg, params, reqs, policy, prefix_cache=prefix_cache,
                     overlap=overlap)
    assert got == baseline[0]
    assert eng.counters["device_dispatches"] == \
        eng.counters["mixed_iterations"]
    if not prefix_cache:   # every page back in the free list
        assert eng.blocks.num_free == eng.blocks.n_pages - 1
    assert eng.stager.inflight == 0


def test_scripted_client_replay_matches_closed_loop(setup, baseline):
    _, cfg, params, reqs = setup
    eng = Engine(cfg, POLICIES["infercept"], params=params, chip=TPU_V5E,
                 device="cpu", **ENGINE_KW)
    streams = ScriptedClient(eng).replay(copy.deepcopy(reqs))
    assert streams == baseline[0]
    assert dict(eng.counters) == dict(baseline[1].counters)


def test_default_chip_is_h100(setup):
    _, cfg, params, _ = setup
    eng = Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
                 **ENGINE_KW)
    assert eng.cost.chip.name == "h100"
    assert eng.device == torch.device("cpu")
    assert eng.pools[0]["b0"]["k"].device.type == "cpu"


@pytest.mark.parametrize("mode", [dict(paged=False), dict(fused=False),
                                  dict(speculate=True),
                                  dict(kv_dtype="int8"),
                                  dict(sanitize=True)])
def test_unported_modes_raise(setup, mode):
    _, cfg, params, _ = setup
    with pytest.raises(NotImplementedError):
        Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
               **ENGINE_KW, **mode)


def test_stochastic_sampling_raises(setup):
    _, cfg, params, reqs = setup
    eng = Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
                 **ENGINE_KW)
    req = copy.deepcopy(reqs[0])
    req.sampling = SamplingParams(temperature=0.7, seed=1)
    with pytest.raises(NotImplementedError):
        eng.add_request(req)


def test_serve_cli_on_cpu(capsys):
    """python -m repro_torch.launch.serve --tiny --device cpu: a scripted
    replay plus one live caller-driven session finish."""
    from repro_torch.launch import serve
    serve.main(["--tiny", "--device", "cpu", "--requests", "3",
                "--tool-workers", "0"])
    out = capsys.readouterr().out
    assert "finished=4/4" in out and "live session: state=finished" in out


def test_chip_smoke_serve_rehearsal():
    """chip_smoke.py's serve phase, rehearsed at the tiny config on the
    CPU: the same workload, policy, checks and launch-count reads as on
    the card (no kernel launches here)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    rec = chip_smoke.Recorder()
    res = chip_smoke.serve("swap", rec, tiny=True, device="cpu")
    assert res["finished"] == res["requests"]
    assert res["swapped_out_tokens"] == res["swapped_in_tokens"] > 0
    assert set(rec.calls) == {"ragged_paged_attention", "kv_append",
                              "swap_pack", "swap_unpack"}
    assert all(v == 0 for v in res["launches"].values())
