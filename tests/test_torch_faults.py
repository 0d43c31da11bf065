"""Fault-tolerant interception (DESIGN.md §15) on the port's engine,
mirroring ``tests/test_faults.py``: a tool failure, timeout, cancel or
pool saturation ends at most the session that suffered it.

Each case runs the port's engine on the JAX init's weights (bridged
through ``from_jax_params``, the TPU_V5E chip spec, so the virtual clock
matches) and holds the reference test's own assertions. The terminal
failure, retry, timeout, backpressure, chaos, saturation cases and the
cancels from running, paused, swapped and speculating states also run
the JAX engine on the same workload and compare session states, errors,
streams, counters, ledger causes, the virtual clock and the free pages:
no terminal failure or timeout may part the two engines. The cancel from
the queue, the soak matrix, and the cases on wall-clock threads hold the
reference's assertions only.
"""
import copy
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.bridge import from_jax_params
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


def _namespace(pkg):
    """One package's engine, client, executors and request types."""
    import importlib
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    api = mod("serving.api_executor")
    req = mod("core.request")
    return types.SimpleNamespace(
        pkg=pkg, cfg=mod("configs").get_config("llama3.2-1b", tiny=True),
        POLICIES=mod("core").POLICIES, Engine=mod("serving.engine").Engine,
        Client=mod("serving.session").InferCeptClient,
        Chaos=api.ChaosToolExecutor, VirtualTime=api.VirtualTimeToolExecutor,
        WallClock=api.WallClockToolExecutor,
        Oracle=api.OracleToolResultPredictor,
        Directive=req.InterceptDirective, Sampling=req.SamplingParams,
        agent_workload=mod("serving.workloads").make_agent_workload)


@pytest.fixture(scope="module")
def port():
    cfg = get_config("llama3.2-1b", tiny=True)
    from repro.configs import get_config as jax_config
    from repro.models import LM as JaxLM
    jparams = JaxLM(jax_config("llama3.2-1b", tiny=True)).init(
        jax.random.PRNGKey(0), dtype=jnp.float32)
    ns = _namespace("repro_torch")
    ns.engine_kw = dict(params=from_jax_params(
        jax.tree.map(np.asarray, jparams), cfg), device="cpu", chip=TPU_V5E)
    return ns


@pytest.fixture(scope="module")
def ref():
    ns = _namespace("repro")
    ns.engine_kw = dict(seed=0)
    return ns


def _engine(ns, policy, **kw):
    for k, v in dict(page_size=16, n_pages=128, max_model_len=256).items():
        kw.setdefault(k, v)
    return ns.Engine(ns.cfg, ns.POLICIES[policy], **ns.engine_kw, **kw)


def _leak_free(eng):
    return eng.blocks.num_free == eng.blocks.n_pages - 1


def _ledger_balanced(eng):
    tot = sum(eng.ledger.causes.values())
    return abs(tot - eng.ledger.total_check) <= 1e-6 * max(1.0, tot)


def _summary(eng, cl, hs):
    """What the two engines must agree on after a run."""
    return {"states": [h.state for h in hs],
            "errors": [(h.error.kind, h.error.retryable) if h.error else None
                       for h in hs],
            "streams": [cl.token_ids(h) if h.state != "rejected" else None
                        for h in hs],
            "counters": dict(eng.counters),
            "causes": dict(eng.ledger.causes), "now": eng.now,
            "free": eng.blocks.num_free,
            "stats": (eng.sched.stats.tool_failures,
                      eng.sched.stats.cancellations,
                      eng.sched.stats.pool_preempts)}


def _ref_summary(scenario, ns, *args):
    """``_summary`` of the run ``scenario(ns, *args)`` makes."""
    eng, cl, hs = scenario(ns, *args)[:3]
    return _summary(eng, cl, hs)


def once_detector(ns, n_at, kind="math", duration=0.05):
    fired = set()

    def det(req, tid, now):
        if req.output_tokens == n_at and req.rid not in fired:
            fired.add(req.rid)
            return ns.Directive(kind=kind, duration_hint=duration)
        return None
    return det


def multi_detector(ns, at=(5, 10), kind="math", duration=0.05):
    fired = {}

    def det(req, tid, now):
        seen = fired.setdefault(req.rid, set())
        if req.output_tokens in at and req.output_tokens not in seen:
            seen.add(req.output_tokens)
            return ns.Directive(kind=kind, duration_hint=duration)
        return None
    return det


# ---------------------------------------------------------------------------
# fault policy: retries, backoff, timeouts
# ---------------------------------------------------------------------------
def terminal_failure(ns):
    eng = _engine(ns, "infercept")
    cl = ns.Client(eng)
    bad = ns.Chaos(ns.VirtualTime(ns.cfg.vocab_size, n_tokens=4,
                                  duration=0.05), seed=1, failure_rate=1.0)
    h = cl.submit([1, 2, 3, 4], detector=once_detector(ns, 5),
                  max_new_tokens=64, tools=bad,
                  sampling=ns.Sampling(tool_retries=2, tool_backoff_s=0.01))
    hb = cl.submit([9, 8, 7, 6], max_new_tokens=12)
    cl.poll()
    return eng, cl, [h, hb]


def retry_recovery(ns, failure_rate):
    eng = _engine(ns, "infercept")
    cl = ns.Client(eng)
    tools = ns.Chaos(ns.VirtualTime(ns.cfg.vocab_size, n_tokens=4,
                                    duration=0.05),
                     seed=0, failure_rate=failure_rate)
    h = cl.submit([1, 2, 3, 4], detector=once_detector(ns, 5),
                  max_new_tokens=24, tools=tools,
                  sampling=ns.Sampling(tool_retries=5, tool_backoff_s=0.01))
    cl.poll()
    return eng, cl, [h]


def timeout(ns):
    eng = _engine(ns, "infercept")
    cl = ns.Client(eng)
    hang = ns.Chaos(ns.VirtualTime(ns.cfg.vocab_size, n_tokens=4,
                                   duration=0.05), seed=2, timeout_rate=1.0)
    h = cl.submit([1, 2, 3, 4], detector=once_detector(ns, 5),
                  max_new_tokens=64, tools=hang,
                  sampling=ns.Sampling(tool_timeout_s=0.5, tool_retries=1,
                                       tool_backoff_s=0.01))
    cl.poll()
    return eng, cl, [h]


def backpressure(ns):
    eng = _engine(ns, "infercept", max_queued=2)
    cl = ns.Client(eng)
    hs = [cl.submit([1, 2, 3], max_new_tokens=4) for _ in range(4)]
    states = [h.state for h in hs]
    cl.poll()
    return eng, cl, hs, states


def test_terminal_failure_fails_only_that_session(port, ref):
    eng, cl, (h, hb) = terminal_failure(port)
    assert h.state == "failed" and h.done and not h.finished
    assert h.error is not None and h.error.kind == "unavailable"
    assert eng.counters["tool_retries"] == 2
    assert eng.counters["tool_faults"] == 3
    assert eng.counters["sessions_failed"] == 1
    assert eng.ledger.causes["tool_failed"] > 0.0
    assert eng.sched.stats.tool_failures == 1
    assert hb.finished and hb.request.output_tokens == 12
    assert _ledger_balanced(eng) and _leak_free(eng)
    assert _summary(eng, cl, [h, hb]) == _ref_summary(terminal_failure, ref)


def test_retry_recovery_stream_bit_identical(port, ref):
    e1, c1, (h1,) = retry_recovery(port, 0.5)
    e0, c0, (h0,) = retry_recovery(port, 0.0)
    assert h1.finished and h0.finished
    assert e1.counters["tool_retries"] == 1
    assert e0.counters["tool_retries"] == 0
    assert c1.token_ids(h1) == c0.token_ids(h0)
    assert e1.sched.estimator.failed_observations("math") == 1
    assert h1.request.paused_time > h0.request.paused_time
    assert _leak_free(e1) and _ledger_balanced(e1)
    assert _summary(e1, c1, [h1]) == _ref_summary(retry_recovery, ref, 0.5)


def test_timeout_fires_at_virtual_deadline(port, ref):
    eng, cl, (h,) = timeout(port)
    assert h.state == "failed"
    assert h.error is not None and h.error.kind == "timeout"
    assert eng.counters["tool_timeouts"] == 2
    assert eng.now < 100.0
    assert _leak_free(eng) and _ledger_balanced(eng)
    assert _summary(eng, cl, [h]) == _ref_summary(timeout, ref)


def test_admission_backpressure_rejects_not_raises(port, ref):
    eng, cl, hs, states = backpressure(port)
    assert states.count("rejected") == 2
    assert eng.counters["sessions_rejected"] == 2
    assert sum(1 for h in hs if h.finished) == 2
    assert _leak_free(eng)
    assert _summary(eng, cl, hs) == _ref_summary(backpressure, ref)


def chaos_run(ns):
    eng = _engine(ns, "infercept")
    cl = ns.Client(eng)
    tools = ns.Chaos(ns.VirtualTime(ns.cfg.vocab_size, n_tokens=4,
                                    duration=0.05),
                     seed=5, failure_rate=0.3, timeout_rate=0.1)
    hs = [cl.submit([10 + i, 11 + i, 12 + i], detector=multi_detector(ns),
                    max_new_tokens=16, tools=tools,
                    sampling=ns.Sampling(tool_timeout_s=1.0, tool_retries=1,
                                         tool_backoff_s=0.01))
          for i in range(5)]
    cl.poll()
    return eng, cl, hs


def test_chaos_draws_are_deterministic(port, ref):
    got = _ref_summary(chaos_run, port)
    assert got == _ref_summary(chaos_run, port)
    assert got == _ref_summary(chaos_run, ref)
    assert got["counters"]["tool_faults"] > 0


# ---------------------------------------------------------------------------
# chaos soak: blast radius under injected faults
# ---------------------------------------------------------------------------
def _soak(ns, policy, *, fused=True, overlap=True, failure_rate=0.0,
          timeout_rate=0.0, n=6, seed_chaos=7):
    eng = _engine(ns, policy, fused=fused, overlap=overlap)
    cl = ns.Client(eng)
    tools = ns.Chaos(ns.VirtualTime(ns.cfg.vocab_size, n_tokens=4,
                                    duration=0.05),
                     seed=seed_chaos, failure_rate=failure_rate,
                     timeout_rate=timeout_rate)
    hs = [cl.submit([10 + i, 11 + i, 12 + i, 13 + i],
                    detector=multi_detector(ns), max_new_tokens=20,
                    tools=tools,
                    sampling=ns.Sampling(tool_timeout_s=1.0, tool_retries=1,
                                         tool_backoff_s=0.01))
          for i in range(n)]
    cl.poll()
    return eng, cl, hs


def _assert_soak_invariants(eng, cl, hs, clean):
    assert all(h.done for h in hs)
    assert _leak_free(eng)
    assert _ledger_balanced(eng)
    for h in hs:
        if h.finished:
            assert cl.token_ids(h) == clean[h.rid], \
                f"surviving session {h.rid} diverged under injected faults"


def _clean(ns, policy, **kw):
    eng, cl, hs = _soak(ns, policy, **kw)
    return {h.rid: cl.token_ids(h) for h in hs}


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_chaos_soak_quick_matches_jax(port, ref, rate):
    clean = _clean(port, "infercept")
    eng, cl, hs = _soak(port, "infercept", failure_rate=rate,
                        timeout_rate=0.05)
    _assert_soak_invariants(eng, cl, hs, clean)
    assert eng.counters["tool_faults"] > 0
    want = _summary(*_soak(ref, "infercept", failure_rate=rate,
                           timeout_rate=0.05))
    assert _summary(eng, cl, hs) == want


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_chaos_soak_matrix(port, policy, fused, overlap):
    """The reference's soak matrix (4 policies x fused, and its serial
    engine) on the port, serial (overlap=False) under every policy."""
    clean = _clean(port, policy, fused=fused, overlap=overlap)
    eng, cl, hs = _soak(port, policy, fused=fused, overlap=overlap,
                        failure_rate=0.2, timeout_rate=0.1)
    _assert_soak_invariants(eng, cl, hs, clean)


@pytest.mark.parametrize("policy,fused", [("infercept", True),
                                          ("swap", False)])
def test_terminal_chaos_matches_jax(port, ref, policy, fused):
    """Chaos heavy enough that retries run out: sessions end on terminal
    failures and timeouts beside survivors, and both engines end the same
    sessions the same way (the reference's rates recover every fault)."""
    kw = dict(fused=fused, failure_rate=0.3, timeout_rate=0.15,
              seed_chaos=11)
    eng, cl, hs = _soak(port, policy, **kw)
    _assert_soak_invariants(eng, cl, hs, _clean(port, policy, fused=fused))
    got = _summary(eng, cl, hs)
    assert got["counters"]["sessions_failed"] > 0
    assert got["counters"]["tool_timeouts"] > 0
    assert "finished" in got["states"]
    assert ("timeout", False) in got["errors"] or \
        ("timeout", True) in got["errors"]
    assert got == _summary(*_soak(ref, policy, **kw))


# ---------------------------------------------------------------------------
# cancellation from every lifecycle state
# ---------------------------------------------------------------------------
def test_cancel_from_queued(port):
    eng = _engine(port, "infercept")
    cl = port.Client(eng)
    h = cl.submit([1, 2, 3, 4], max_new_tokens=64)
    h.cancel()
    cl.poll()
    assert h.state == "cancelled" and h.done and not h.finished
    assert eng.counters["sessions_cancelled"] == 1
    assert eng.ledger.causes["cancelled"] == 0.0
    assert _leak_free(eng)


def cancel_running(ns, with_cancel=True):
    eng = _engine(ns, "infercept")
    cl = ns.Client(eng)
    h = cl.submit([1, 2, 3, 4], max_new_tokens=64)
    hb = cl.submit([9, 8, 7, 6], max_new_tokens=16)
    if with_cancel:
        while h.request.output_tokens < 4:
            cl.poll(max_steps=1)
        h.cancel()
    cl.poll()
    return eng, cl, [h, hb]


def test_cancel_from_running_leaves_coresident_untouched(port, ref):
    eng, cl, (h, hb) = cancel_running(port)
    assert h.state == "cancelled" and h.request.output_tokens >= 4
    assert hb.finished
    assert eng.ledger.causes["cancelled"] > 0.0
    assert eng.sched.stats.cancellations == 1
    assert _leak_free(eng) and _ledger_balanced(eng)
    _, ccl, (_, chb) = cancel_running(port, with_cancel=False)
    assert cl.token_ids(hb) == ccl.token_ids(chb)
    assert _summary(eng, cl, [h, hb]) == _ref_summary(cancel_running, ref)


def cancel_paused(ns):
    eng = _engine(ns, "preserve")
    cl = ns.Client(eng)
    h = cl.submit(list(range(16)), max_new_tokens=32)
    hb = cl.submit(list(range(30, 46)), max_new_tokens=12)
    cl.intercept(h, duration_hint=5.0)
    while h.state != "intercepted":
        cl.poll(max_steps=1)
    pinned = h.request.device_tokens
    cl.poll(max_steps=2)
    h.cancel()
    cl.poll()
    return eng, cl, [h, hb], pinned


def test_cancel_from_paused_preserve(port, ref):
    eng, cl, (h, hb), pinned = cancel_paused(port)
    assert pinned > 0
    assert h.state == "cancelled"
    assert hb.finished
    assert eng.ledger.causes["cancelled"] > 0.0
    assert _leak_free(eng) and _ledger_balanced(eng)
    assert _summary(eng, cl, [h, hb]) == _ref_summary(cancel_paused, ref)


def cancel_swapped(ns):
    eng = _engine(ns, "swap")
    cl = ns.Client(eng)
    h = cl.submit(list(range(32)), max_new_tokens=32)
    hb = cl.submit(list(range(40, 56)), max_new_tokens=20)
    cl.intercept(h, duration_hint=50.0)
    for _ in range(200):
        cl.poll(max_steps=1)
        if h.request.host_tokens > 0:
            break
    swapped = h.request.host_tokens
    h.cancel()
    cl.poll()
    return eng, cl, [h, hb], swapped


def test_cancel_from_swapped(port, ref):
    eng, cl, (h, hb), swapped = cancel_swapped(port)
    assert swapped > 0, "never reached the swapped state"
    assert h.state == "cancelled"
    assert h.request.host_tokens == 0
    assert hb.finished
    assert _leak_free(eng) and _ledger_balanced(eng)
    assert _summary(eng, cl, [h, hb]) == _ref_summary(cancel_swapped, ref)


def test_cancel_with_inflight_async_tool(port):
    eng = _engine(port, "vllm")
    cl = port.Client(eng, tool_workers=1)
    gate = threading.Event()

    def slow_tool(call):
        assert gate.wait(30.0), "test gate never opened"
        return [5, 6, 7]

    def det(req, tid, now):
        if req.output_tokens == 3 and req.seg_idx == 0:
            return port.Directive("tool", 0.2, reason="detector")
        return None

    h = cl.submit(list(range(16)), detector=det, max_new_tokens=10,
                  tools=port.WallClock(slow_tool))
    hb = cl.submit(list(range(30, 46)), max_new_tokens=24)
    for _ in range(200):
        cl.poll(max_steps=1)
        if h.state == "resuming" or eng.async_tools.inflight > 0:
            break
    h.cancel()
    gate.set()
    cl.poll()
    assert h.state == "cancelled"
    assert hb.finished and hb.request.output_tokens == 24
    assert _leak_free(eng) and _ledger_balanced(eng)
    cl.close()


def cancel_speculating(ns, cancel=True):
    reqs = ns.agent_workload(
        seed=5, n_sessions=2, rate_rps=2.0, vocab=ns.cfg.vocab_size,
        n_templates=2, system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
        hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
        final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2, max_ctx=240)
    eng = _engine(ns, "infercept", speculate=True,
                  predictor=ns.Oracle(ns.cfg.vocab_size))
    assert eng.speculate
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    target = {}
    if cancel:
        def hook(e):
            if e._spec_forks and not target:
                target["rid"] = min(e._spec_forks)
                e.cancel_request(target["rid"])
        eng.on_plan = hook
    fin = eng.run()
    return eng, fin, target, len(reqs)


def test_cancel_while_speculating_frees_fork(port, ref):
    eng, fin, target, n = cancel_speculating(port)
    assert "rid" in target, "no fork was ever live"
    assert len(fin) == n - 1
    assert eng.counters["sessions_cancelled"] == 1
    assert eng.ledger.causes["cancelled"] > 0.0
    assert not eng._spec_forks
    assert _leak_free(eng) and _ledger_balanced(eng)
    base_eng, base_fin, _, _ = cancel_speculating(port, cancel=False)
    base = {r.rid: base_eng.generated_text(r) for r in base_fin}
    for r in fin:
        assert base[r.rid] == eng.generated_text(r)
    jeng, jfin, jtarget, _ = cancel_speculating(ref)
    assert jtarget == target
    assert {r.rid: jeng.generated_text(r) for r in jfin} == \
        {r.rid: eng.generated_text(r) for r in fin}
    assert dict(jeng.counters) == dict(eng.counters)
    assert jeng.ledger.causes == eng.ledger.causes


# ---------------------------------------------------------------------------
# graceful admission: pool saturation re-preempts instead of crashing
# ---------------------------------------------------------------------------
def saturated(ns, n_pages, max_steps=200):
    n, plen = 10, 17
    eng = _engine(ns, "vllm", n_pages=n_pages, max_model_len=64)
    cl = ns.Client(eng)
    hs = [cl.submit([(100 + 7 * i + j) % ns.cfg.vocab_size
                     for j in range(plen)], max_new_tokens=8)
          for i in range(n)]
    steps = 0
    while not all(h.done for h in hs) and steps < max_steps:
        cl.poll(max_steps=1)
        steps += 1
    assert all(h.state == "finished" for h in hs), \
        f"n_pages={n_pages} stalled: {[h.state for h in hs]}"
    return eng, cl, hs


def test_saturated_pool_repreempts_instead_of_crashing(port, ref):
    ample_eng, acl, ahs = saturated(port, 128)
    assert ample_eng.sched.stats.pool_preempts == 0
    tight_eng, tcl, ths = saturated(port, 20)
    assert tight_eng.sched.stats.pool_preempts > 0
    assert [acl.token_ids(h) for h in ahs] == [tcl.token_ids(h) for h in ths]
    assert _ledger_balanced(tight_eng) and _leak_free(tight_eng)
    assert _summary(tight_eng, tcl, ths) == _ref_summary(saturated, ref, 20)


# ---------------------------------------------------------------------------
# simulator mirror
# ---------------------------------------------------------------------------
def _sim(pkg):
    ns = _namespace(pkg)
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    sim = importlib.import_module(f"{pkg}.sim")
    hw = importlib.import_module(f"{pkg}.utils.hw")
    workloads = importlib.import_module(f"{pkg}.serving.workloads")
    cfgs = importlib.import_module(f"{pkg}.configs")
    cost = core.CostModel(cfg=cfgs.get_config("gpt-j-6b"), chip=hw.A100,
                          n_chips=1)
    reqs = workloads.make_workload(seed=3, n_requests=8, rate_rps=2.0,
                                   max_ctx=400)
    base = sim.simulate(copy.deepcopy(reqs), ns.POLICIES["infercept"], cost)
    r = sim.simulate(copy.deepcopy(reqs), ns.POLICIES["infercept"], cost,
                     cancel_at={0: 3}, fail_at={1: 1})
    return base, r


def test_sim_mirror_cancel_and_fail():
    base, r = _sim("repro_torch")
    assert len(base.finished) == 8
    assert base.ledger.causes["cancelled"] == 0.0
    assert base.ledger.causes["tool_failed"] == 0.0
    assert r.cancelled == 1 and r.failed == 1
    assert {q.rid for q in r.finished} == set(range(8)) - {0, 1}
    assert r.ledger.causes["cancelled"] > 0.0
    assert r.ledger.causes["tool_failed"] > 0.0
    assert r.stats.cancellations == 1 and r.stats.tool_failures == 1
    tot = sum(r.ledger.causes.values())
    assert abs(tot - r.ledger.total_check) <= 1e-6 * max(1.0, tot)
    _, want = _sim("repro")
    assert r.ledger.causes == want.ledger.causes
    assert r.ledger.total_check == want.ledger.total_check
