"""Sampled serving on the port's engine, on the CPU.

* The JAX engine's sampled streams and counters (vllm, fused) equal the
  port's under all 4 policies x fused / unfused / gather, for top-k and
  for top-p 0.3, as ``tests/test_session.py``'s ``_sampled_run`` holds
  the reference against itself; another seed moves the stream, top-p 0.3
  binds, and ``SamplingParams(temperature=0)`` equals greedy.
* The launcher's live session samples with ``--temperature`` and
  ``--top-p``.
* chip_smoke.py's ``sample`` phase and the ``tiny`` phase's sampled
  sessions, rehearsed at the tiny config.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.core.request import InterceptDirective, SamplingParams
from repro_torch.serving.api_executor import VirtualTimeToolExecutor
from repro_torch.serving.engine import Engine
from repro_torch.serving.session import InferCeptClient
from repro_torch.utils.hw import TPU_V5E

ALL_POLICIES = ["preserve", "vllm", "swap", "infercept"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them, so each worker's
    torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sampled_run(E, cfg, policy, *, client, sampling, directive, tools,
                 seed=11, temp=0.8, top_k=6, top_p=1.0, **kw):
    """tests/test_session.py's ``_sampled_run`` for either engine."""
    eng = E(cfg, policy, page_size=16, n_pages=96, max_model_len=256, **kw)
    cl = client(eng)
    tool = tools(cfg.vocab_size, n_tokens=5, duration=0.3)

    def det(req, tid, now):
        if req.output_tokens == 5 and req.seg_idx == 0:
            return directive("qa", 0.3, reason="detector")
        return None

    hs = [cl.submit(list(range(r, r + 20)),
                    sampling(temperature=temp, top_k=top_k, top_p=top_p,
                             seed=seed + r),
                    detector=det, max_new_tokens=14, tools=tool)
          for r in range(2)]
    cl.poll()
    assert all(h.finished for h in hs)
    return {h.rid: cl.token_ids(h) for h in hs}, eng


CASES = {"top_k": dict(top_k=6, top_p=1.0), "top_p": dict(top_k=0, top_p=0.3)}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine once per case (vllm, fused), and its weights."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.core import POLICIES as JAX_POLICIES
    from repro.core.request import InterceptDirective as JaxDirective
    from repro.core.request import SamplingParams as JaxSampling
    from repro.serving.api_executor import VirtualTimeToolExecutor as JaxVT
    from repro.serving.engine import Engine as JaxEngine
    from repro.serving.session import InferCeptClient as JaxClient
    from repro_torch.models.bridge import from_jax_params
    jcfg = jax_config("llama3.2-1b", tiny=True)
    out = {}
    for name, case in CASES.items():
        streams, jeng = _sampled_run(
            JaxEngine, jcfg, JAX_POLICIES["vllm"], client=JaxClient,
            sampling=JaxSampling, directive=JaxDirective, tools=JaxVT,
            **case)
        out[name] = (streams, dict(jeng.counters))
    cfg = get_config("llama3.2-1b", tiny=True)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg)
    return out, params


def _port_run(params, policy, **kw):
    cfg = get_config("llama3.2-1b", tiny=True)
    return _sampled_run(Engine, cfg, POLICIES[policy], client=InferCeptClient,
                        sampling=SamplingParams,
                        directive=InterceptDirective,
                        tools=VirtualTimeToolExecutor, params=params,
                        device="cpu", chip=TPU_V5E, **kw)


PATHS = {"fused": {}, "unfused": {"fused": False},
         "gather": {"fused": False, "paged": False}}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_streams_match_jax_engine(jax_runs, case, policy, path):
    runs, params = jax_runs
    want, counters = runs[case]
    got, eng = _port_run(params, policy, **CASES[case], **PATHS[path])
    assert got == want
    if policy == "vllm" and path == "fused":
        assert dict(eng.counters) == counters
        # sampling stayed on the device: one dispatch an iteration and
        # only ids cross
        assert eng.counters["device_dispatches"] == \
            eng.counters["mixed_iterations"]
        assert eng.counters["logit_bytes"] < 4 * 64 * \
            eng.counters["mixed_iterations"]


def test_seed_moves_and_top_p_binds(jax_runs):
    runs, params = jax_runs
    other, _ = _port_run(params, "vllm", seed=999, **CASES["top_k"])
    assert other != runs["top_k"][0], "per-request seed had no effect"
    full, _ = _port_run(params, "vllm", top_k=0, top_p=1.0)
    assert full != runs["top_p"][0], "top_p=0.3 did not bind"


@pytest.mark.parametrize("fused", [True, False])
def test_zero_temperature_equals_greedy(jax_runs, fused):
    """SamplingParams(temperature=0) is the greedy oracle: the streams of
    a sampling=None session, on the argmax-only graph."""
    _, params = jax_runs
    cfg = get_config("llama3.2-1b", tiny=True)

    def run(sampling):
        eng = Engine(cfg, POLICIES["vllm"], params=params, device="cpu",
                     chip=TPU_V5E, page_size=16, n_pages=64,
                     max_model_len=256, fused=fused)
        cl = InferCeptClient(eng)
        hs = [cl.submit(list(range(r, r + 18)), sampling,
                        max_new_tokens=10) for r in range(2)]
        cl.poll()
        assert all(h.finished for h in hs)
        return {h.rid: cl.token_ids(h) for h in hs}

    assert run(SamplingParams(temperature=0.0, top_k=0, seed=42)) == \
        run(None)


def test_serve_cli_samples_the_live_session(capsys):
    """python -m repro_torch.launch.serve --temperature 0.7 --top-p 0.9:
    the live session samples (top-k 16, seed 1) and every session
    finishes."""
    from repro_torch.launch import serve
    serve.main(["--tiny", "--device", "cpu", "--requests", "3",
                "--tool-workers", "0", "--temperature", "0.7",
                "--top-p", "0.9"])
    out = capsys.readouterr().out
    assert "finished=4/4" in out and "live session: state=finished" in out


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_sample_rehearsal():
    """chip_smoke.py's sample phase and the tiny phase's sampled sessions,
    rehearsed at the tiny config on the CPU: the same workload, probe and
    checks as on the card (no kernel launches here)."""
    cs = _chip_smoke()
    greedy = cs.serve("infercept", cs.Recorder(), tiny=True, device="cpu")
    probe = cs.SamplerProbe(on_card=False)
    with probe:
        res = cs.serve("infercept", cs.Recorder(), tiny=True, device="cpu",
                       sampled=True)
    assert res["finished"] == res["requests"] == 13
    assert res["free_pages"] == res["n_pages"] - 1
    assert res["swapped_in_tokens"] == res["swapped_out_tokens"] > 0
    cs.check_sample_phase(res, probe, greedy, device="cpu")
    assert len(probe.host_ms) == res["steps"] and probe.device_ms == []
    assert 2 <= len(probe.kept) <= 3
    cs.check_tiny_sampled(device="cpu")


SPEC_WORKLOAD = dict(seed=5, n_sessions=2, rate_rps=2.0, n_templates=2,
                     system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
                     hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
                     final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2,
                     max_ctx=240)


def test_sampled_speculation_matches_jax_engine(jax_runs):
    """Sampled requests under speculative resume (the oracle predictor):
    a fork samples its tokens at the positions the resumed request would,
    so accepted forks keep the streams of the run without speculation,
    and the port's streams, counters and speculation log equal the JAX
    engine's."""
    from repro.configs import get_config as jax_config
    from repro.core import POLICIES as JAX_POLICIES
    from repro.core.request import SamplingParams as JaxSampling
    from repro.serving.api_executor import OracleToolResultPredictor as JaxOr
    from repro.serving.engine import Engine as JaxEngine
    from repro.serving.workloads import make_agent_workload as jax_workload
    from repro_torch.serving.api_executor import OracleToolResultPredictor
    from repro_torch.serving.workloads import make_agent_workload
    _, params = jax_runs
    cfg = get_config("llama3.2-1b", tiny=True)
    kw = dict(page_size=16, n_pages=128, max_model_len=256)

    def sampled(reqs, cls):
        for r in reqs:
            r.sampling = cls(temperature=0.8, top_k=20, top_p=0.9,
                             seed=7 + r.rid)
        return reqs

    def port(**spec):
        eng = Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
                     chip=TPU_V5E, **kw, **spec)
        for r in sampled(make_agent_workload(vocab=cfg.vocab_size,
                                             **SPEC_WORKLOAD),
                         SamplingParams):
            eng.add_request(r)
        fin = eng.run(strict=True)
        return {r.rid: eng.generated_text(r) for r in fin}, eng

    got, eng = port(speculate=True,
                    predictor=OracleToolResultPredictor(cfg.vocab_size))
    assert eng.counters["spec_accepted"] > 0
    assert eng.counters["spec_decode_tokens"] > 0
    assert got == port()[0]
    jcfg = jax_config("llama3.2-1b", tiny=True)
    jeng = JaxEngine(jcfg, JAX_POLICIES["infercept"], seed=0, speculate=True,
                     predictor=JaxOr(jcfg.vocab_size), **kw)
    for r in sampled(jax_workload(vocab=jcfg.vocab_size, **SPEC_WORKLOAD),
                     JaxSampling):
        jeng.add_request(r)
    want = {r.rid: jeng.generated_text(r) for r in jeng.run(strict=True)}
    assert got == want
    assert dict(eng.counters) == dict(jeng.counters)
    assert eng.spec_log == jeng.spec_log
