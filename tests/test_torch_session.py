"""The session API (DESIGN.md §11) on the port's engine, mirroring
``tests/test_session.py`` apart from its sampling cases (those are in
``tests/test_torch_sampling.py``).

* Scripted-over-session equivalence: the mixed workload (agent sessions
  with explicit prompts plus Table-1 scripted requests) replayed through
  ScriptedClient gives the closed loop's streams under all four policies
  x fused / unfused, and those streams are the JAX engine's.
* Caller-driven resume, stop-token and explicit interception, the async
  tool runtime, a failing off-thread tool, and the lifecycle guardrails,
  with the reference test's assertions; the deterministic ones also give
  the JAX engine's streams, counters and virtual clock on the same
  bridged weights.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.core.request import InterceptDirective, Request, Segment
from repro_torch.launch.serve import scale_to_budget
from repro_torch.models.bridge import from_jax_params
from repro_torch.serving.api_executor import WallClockToolExecutor
from repro_torch.serving.engine import Engine
from repro_torch.serving.session import (FinishEvent, InferCeptClient,
                                         InterceptEvent, ScriptedClient)
from repro_torch.serving.workloads import make_agent_workload, make_workload
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


@pytest.fixture(scope="module")
def params():
    from repro.configs import get_config as jax_config
    from repro.models import LM as JaxLM
    jparams = JaxLM(jax_config("llama3.2-1b", tiny=True)).init(
        jax.random.PRNGKey(0), dtype=jnp.float32)
    return from_jax_params(jax.tree.map(np.asarray, jparams),
                           get_config("llama3.2-1b", tiny=True))


CFG = get_config("llama3.2-1b", tiny=True)


def _engine(params, policy, **kw):
    for k, v in dict(page_size=16, n_pages=128, max_model_len=256).items():
        kw.setdefault(k, v)
    return Engine(CFG, POLICIES[policy], params=params, device="cpu",
                  chip=TPU_V5E, **kw)


def _jax_engine(policy, **kw):
    from repro.configs import get_config as jax_config
    from repro.core import POLICIES as JAX_POLICIES
    from repro.serving.engine import Engine as JaxEngine
    for k, v in dict(page_size=16, n_pages=128, max_model_len=256).items():
        kw.setdefault(k, v)
    return JaxEngine(jax_config("llama3.2-1b", tiny=True),
                     JAX_POLICIES[policy], seed=0, **kw)


def _mixed_workload(agent=make_agent_workload, table=make_workload,
                    scale=scale_to_budget):
    reqs = agent(
        seed=5, n_sessions=2, rate_rps=2.0, vocab=CFG.vocab_size,
        n_templates=2, system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
        hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
        final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2, max_ctx=240)
    extra = scale(table(seed=3, n_requests=2, rate_rps=1.0, max_ctx=200),
                  200, prompt_cap=32, gen_cap=8, ret_cap=6, max_segments=2)
    for i, r in enumerate(extra):
        r.rid = len(reqs) + i
    return reqs + extra


@pytest.fixture(scope="module")
def sess_diff(params):
    reqs = _mixed_workload()
    eng = _engine(params, "vllm")
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    fin = eng.run()
    assert fin.drained and len(fin) == len(reqs)
    oracle = {r.rid: eng.generated_text(r) for r in fin}
    session, engines = {}, {}
    for name in ALL_POLICIES:
        for fused in (True, False):
            e = _engine(params, name, fused=fused)
            session[(name, fused)] = ScriptedClient(e).replay(
                copy.deepcopy(reqs))
            engines[(name, fused)] = e
    return reqs, oracle, session, engines


def test_closed_loop_matches_jax_engine(sess_diff):
    from repro.launch.serve import scale_to_budget as jax_scale
    from repro.serving.workloads import make_agent_workload as jax_agent
    from repro.serving.workloads import make_workload as jax_table
    _, oracle, _, _ = sess_diff
    jeng = _jax_engine("vllm")
    for r in _mixed_workload(jax_agent, jax_table, jax_scale):
        jeng.add_request(r)
    fin = jeng.run()
    assert oracle == {r.rid: jeng.generated_text(r) for r in fin}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_scripted_sessions_match_legacy_streams(sess_diff, policy, fused):
    _, oracle, session, _ = sess_diff
    assert session[(policy, fused)] == oracle


def test_session_interceptions_really_happened(sess_diff):
    reqs, _, _, engines = sess_diff
    n_int = sum(1 for r in reqs for s in r.segments if s.interception)
    assert n_int > 0
    for (name, fused), eng in engines.items():
        assert eng.sched.stats.decode_tokens > 0
        done = {r.rid: r for r in eng.finished}
        assert sum(sum(1 for s in done[r.rid].segments if s.interception)
                   for r in reqs) == n_int, (name, fused)
        if fused:
            assert eng.counters["device_dispatches"] == \
                eng.counters["mixed_iterations"], (name, fused)
    for r in engines[("infercept", True)].finished:
        m = r.latency_metrics()
        assert m["output_tokens"] > 0 and m["ttft"] is not None


def caller_resume(eng, directive):
    cl = eng_client(eng)

    def det(req, tid, now):
        if req.output_tokens == 6 and req.seg_idx == 0:
            return directive("qa", 0.4, reason="detector")
        return None

    h = cl.submit(list(range(24)), detector=det, max_new_tokens=16)
    evs = cl.poll()
    state, n_before = h.state, len(cl.token_ids(h))
    iev = [e for e in evs if type(e).__name__ == "InterceptEvent"][0]
    cl.resume(h, [7, 8, 9], delay=0.4)
    evs = cl.poll()
    return cl, h, state, n_before, iev, evs


def eng_client(eng):
    """The session client of ``eng``'s own package."""
    import importlib
    pkg = type(eng).__module__.split(".")[0]
    return importlib.import_module(f"{pkg}.serving.session").InferCeptClient(
        eng)


def test_caller_driven_resume_out_of_band(params):
    from repro.core.request import InterceptDirective as JaxDirective
    eng = _engine(params, "infercept", n_pages=64)
    cl, h, state, n_before, iev, evs = caller_resume(eng, InterceptDirective)
    assert state == "intercepted"
    assert isinstance(iev, InterceptEvent)
    assert iev.reason == "detector" and iev.caller_owned
    assert iev.trigger_token_id is not None
    assert n_before == 24 + 6
    assert h.finished and any(isinstance(e, FinishEvent) for e in evs)
    stream = cl.token_ids(h)
    assert stream[n_before:n_before + 3] == [7, 8, 9]
    assert len(stream) > n_before + 3
    assert 0.4 <= h.request.paused_time < 0.45
    assert h.request.output_tokens == 16
    jeng = _jax_engine("infercept", n_pages=64)
    jcl, jh, *_ = caller_resume(jeng, JaxDirective)
    assert jcl.token_ids(jh) == stream
    assert jh.request.paused_time == h.request.paused_time
    assert dict(jeng.counters) == dict(eng.counters)
    assert jeng.now == eng.now


def stop_token(make_engine):
    prompt = list(range(20))
    cl = eng_client(make_engine())
    h = cl.submit(prompt, max_new_tokens=8)
    cl.poll()
    third = cl.token_ids(h)[len(prompt) + 2]
    eng2 = make_engine()
    cl2 = eng_client(eng2)
    h2 = cl2.submit(prompt, stop_tokens={third}, max_new_tokens=8,
                    kind="tool")
    evs = cl2.poll()
    state = h2.state
    iev = [e for e in evs if type(e).__name__ == "InterceptEvent"][0]
    cl2.resume(h2, [3, 1])
    cl2.finish(h2)
    cl2.poll()
    return third, state, iev, cl2, h2, eng2


def test_stop_token_detector_consumes_trigger(params):
    third, state, iev, cl2, h2, eng2 = stop_token(
        lambda: _engine(params, "vllm", n_pages=64))
    assert state == "intercepted"
    assert iev.reason == "stop_token" and iev.trigger_token_id == third
    assert cl2.token_ids(h2)[20:].count(third) == 0
    assert h2.finished
    jthird, _, _, jcl2, jh2, jeng2 = stop_token(
        lambda: _jax_engine("vllm", n_pages=64))
    assert jthird == third
    assert jcl2.token_ids(jh2) == cl2.token_ids(h2)
    assert dict(jeng2.counters) == dict(eng2.counters)


def test_explicit_intercept_at_first_boundary_and_tool_roundtrip(params):
    eng = _engine(params, "vllm", n_pages=64)
    cl = InferCeptClient(eng)
    seen = []

    def tool(call):
        seen.append(call)
        return [11, 12]

    h = cl.submit(list(range(16)), max_new_tokens=6,
                  tools=WallClockToolExecutor(tool))
    cl.intercept(h, duration_hint=0.2)
    cl.poll()
    assert h.finished
    assert len(seen) == 1 and seen[0].trigger_token_id is not None
    stream = cl.token_ids(h)
    assert stream[16:18] == [11, 12]
    assert h.request.segments[0].gen_tokens == 0
    assert h.request.output_tokens == 6


def test_async_tool_runtime_does_not_stall_unrelated_sessions(params):
    import time as _time
    eng = _engine(params, "vllm", n_pages=96)
    cl = InferCeptClient(eng, tool_workers=2)
    assert eng.async_tools is not None
    other = {}

    def slow_tool(call):
        deadline = _time.time() + 30.0
        while not other["handle"].finished:
            assert _time.time() < deadline, \
                "unrelated session stalled behind the in-flight tool"
            _time.sleep(0.005)
        return [5, 6, 7]

    def det(req, tid, now):
        if req.output_tokens == 3 and req.seg_idx == 0:
            return InterceptDirective("tool", 0.2, reason="detector")
        return None

    ha = cl.submit(list(range(20)), detector=det, max_new_tokens=10,
                   tools=WallClockToolExecutor(slow_tool))
    hb = cl.submit(list(range(30, 50)), max_new_tokens=12)
    other["handle"] = hb
    cl.poll()
    assert ha.finished and hb.finished
    assert hb.request.finish_time < ha.request.finish_time
    assert eng.counters["tool_seconds"] > 0
    assert eng.counters["overlapped_tool_seconds"] > 0
    assert [5, 6, 7] == cl.token_ids(ha)[20 + 3:20 + 6]
    assert ha.request.output_tokens == 10
    cl.close()


def test_async_tool_failure_fails_only_that_session(params):
    def run(with_poisoned: bool):
        eng = _engine(params, "vllm", n_pages=64)
        cl = InferCeptClient(eng, tool_workers=1)

        def bad_tool(call):
            raise ValueError("tool exploded")

        def det(req, tid, now):
            if req.output_tokens == 2 and req.seg_idx == 0:
                return InterceptDirective("tool", 0.1, reason="detector")
            return None

        h = None
        if with_poisoned:
            h = cl.submit(list(range(16)), detector=det, max_new_tokens=8,
                          tools=WallClockToolExecutor(bad_tool))
        hb = cl.submit(list(range(30, 46)), max_new_tokens=10)
        cl.poll()
        stream = cl.token_ids(hb)
        cl.close()
        return eng, h, hb, stream

    eng, h, hb, stream = run(with_poisoned=True)
    assert h.state == "failed" and h.done and not h.finished
    assert h.error is not None and h.error.kind == "exception"
    assert not h.error.retryable
    assert "tool exploded" in h.error.message
    assert eng.counters["sessions_failed"] == 1
    assert hb.finished and hb.request.output_tokens == 10
    _, _, _, clean = run(with_poisoned=False)
    assert stream == clean
    assert eng.ledger.causes["tool_failed"] > 0.0


def test_resume_and_rid_guardrails(params):
    eng = _engine(params, "vllm", n_pages=64)
    eng.add_request(Request(
        rid=0, arrival=5.0, prompt_len=8,
        segments=[Segment(gen_tokens=2, interception=None)]))
    cl = InferCeptClient(eng)
    h = cl.submit(list(range(16)), max_new_tokens=8)
    assert h.rid != 0
    cl.intercept(h, duration_hint=0.1)
    batch = cl.poll(max_steps=1)
    assert batch.drained is False
    assert cl.poll().drained is True
    assert h.state == "intercepted"
    with pytest.raises(ValueError):
        cl.resume(h, [])
    cl.resume(h, [1, 2])
    with pytest.raises(ValueError):
        cl.resume(h, [3, 4])
    cl.poll()
    assert h.finished
