"""Tracing and the waste ledger (DESIGN.md §13) on the port's engine,
mirroring the tracing and ledger parts of ``tests/test_obs.py``.

* The copied tracers, Perfetto export and validator, and the ledger's
  cause charges, Eq. 5 records and breakdown check, as the reference
  holds them.
* The port's engine under four policies spread over its variants (fused,
  serial step, unfused, prefix cache), traced and not: tracing perturbs
  no stream, counter or ledger charge; its traces validate and carry the
  lifecycle and tool spans; the ledger's invariants hold; the
  simulator's ledger mirrors the engine's; the summary and stats lines
  and the one registry's Prometheus dump carry their fields.
* Against the JAX engine on the same bridged weights and chip spec: the
  same Perfetto events (count and content), ledger causes and totals,
  summary and stats lines, under each of the four variants.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import POLICIES, CostModel
from repro_torch.core.waste import waste_preserve, waste_swap
from repro_torch.models.bridge import from_jax_params
from repro_torch.obs.check import check_breakdown
from repro_torch.obs.check import main as check_main
from repro_torch.obs.export import (format_stats_line, format_summary,
                                    to_perfetto, validate_trace, write_trace)
from repro_torch.obs.ledger import WASTE_CAUSES, WasteLedger, waste_report
from repro_torch.obs.trace import NullTracer, SpanTracer
from repro_torch.serving.engine import Engine
from repro_torch.serving.session import ScriptedClient
from repro_torch.serving.workloads import make_workload
from repro_torch.sim import simulate
from repro_torch.utils.hw import A100, TPU_V5E


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them, so each worker's
    torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tracers and export
# ---------------------------------------------------------------------------
def test_null_tracer_is_inert():
    t = NullTracer()
    assert not t.enabled
    t.span(("req", 1), "decode", 0.0, 1.0)
    t.async_begin("tool", 1, "tool", 0.0)
    t.async_end("tool", 1, "tool", 1.0)
    t.instant(("req", 1), "finish", 1.0)
    assert len(t) == 0


def test_span_tracer_records_and_drops_empty():
    t = SpanTracer()
    assert t.enabled
    t.span(("engine", "step"), "iter", 1.0, 1.0)     # zero-length: dropped
    assert len(t) == 0
    t.span(("engine", "step"), "iter", 1.0, 2.0)
    t.async_begin("tool", 5, "tool", 1.2)
    t.async_end("tool", 5, "tool", 1.8)
    t.instant(("req", 0), "finish", 2.0)
    assert len(t) == 4


def test_perfetto_export_and_validator():
    t = SpanTracer()
    t.span(("engine", "step"), "iter", 0.0, 1.0)
    t.span(("engine", "step"), "iter", 1.0, 2.0)
    t.span(("req", 0), "prefill", 0.0, 0.5)
    t.async_begin("tool", 7, "tool", 0.2)
    t.async_end("tool", 7, "tool", 1.7)
    obj = to_perfetto(t)
    assert validate_trace(obj) == []
    names = {ev.get("name") for ev in obj["traceEvents"]}
    assert {"iter", "prefill", "tool"} <= names
    metas = [ev for ev in obj["traceEvents"] if ev["ph"] == "M"]
    assert any(ev["args"].get("name") == "engine" for ev in metas)
    bad = SpanTracer()
    bad.span(("req", 0), "a", 0.0, 2.0)
    bad.span(("req", 0), "b", 1.0, 3.0)
    assert validate_trace(to_perfetto(bad))
    dangling = SpanTracer()
    dangling.async_begin("tool", 1, "tool", 0.0)
    assert validate_trace(to_perfetto(dangling))


# ---------------------------------------------------------------------------
# the waste ledger
# ---------------------------------------------------------------------------
def _cost():
    return CostModel(cfg=get_config("gpt-j-6b"), chip=A100, n_chips=1)


def test_ledger_cause_charges_and_crosscheck():
    cost = _cost()
    led = WasteLedger(cost, 10_000)
    m = cost.m_bytes
    led.charge_iteration(0.1, 0.0, False, 0, 64, 100, 500)
    assert led.causes["preserve_pinned"] == pytest.approx(0.1 * 100 * m)
    led.charge_iteration(0.2, 0.05, False, 32, 64, 0, 500)
    assert led.causes["recompute"] == pytest.approx(0.2 * 0.5 * 500 * m)
    assert led.causes["swap_stall"] == pytest.approx(0.05 * 500 * m)
    led.charge_iteration(0.1, 0.02, True, 0, 8, 0, 300)
    assert led.causes["pipeline_bubble"] == pytest.approx(0.02 * 300 * m)
    led.charge_idle(1.0, 200, tool_wait=True)
    led.charge_idle(5.0, 200, tool_wait=False)
    assert led.causes["tool_unoverlapped"] == pytest.approx(1.0 * 200 * m)
    assert led.idle_time == 6.0 and led.iterations == 3
    assert set(led.causes) == set(WASTE_CAUSES)
    assert led.total_waste() == pytest.approx(led.total_check, rel=1e-9)
    assert 0.0 < led.waste_fraction()
    assert check_breakdown(waste_report(led)) == []


def test_ledger_intercept_records_eq5_branches():
    cost = _cost()
    led = WasteLedger(cost, 10_000)
    m = cost.m_bytes
    led.intercept_started(1, "math", t_call=10.0, predicted_s=2.0,
                          c_tokens=128, gpu_used_tokens=512)
    rec = led.intercept_finished(1, "preserve", t_done=12.0)
    assert rec.realized_s == 2.0
    assert rec.predicted_waste == pytest.approx(waste_preserve(2.0, 128, m))
    assert rec.realized_waste == rec.predicted_waste
    assert led.registry.histograms["estimator_abs_err_s"].mean() == 0.0
    assert led.registry.gauges["estimator_bias_s_math"] == 0.0
    led.intercept_started(2, "search", 20.0, 1.0, 64, 256)
    rec2 = led.intercept_finished(2, "swap", 29.0)
    assert rec2.predicted_waste == rec2.realized_waste
    assert rec2.realized_waste == pytest.approx(
        waste_swap(cost.t_swap(64), 256, m))
    st = led.estimator_stats()
    assert st["search"]["bias_s"] == pytest.approx(-8.0)
    assert st["search"]["abs_err_s"] == pytest.approx(8.0)
    assert led.intercept_finished(99, "preserve", 1.0) is None
    assert len(led.records) == 2


def test_check_breakdown_catches_tampering(tmp_path):
    led = WasteLedger(_cost(), 1000)
    led.charge_iteration(0.1, 0.0, False, 0, 4, 50, 100)
    rep = waste_report(led)
    assert check_breakdown(rep) == []
    assert check_breakdown([rep, rep]) == []
    bad = dict(rep)
    bad["causes"] = dict(rep["causes"])
    bad["causes"]["recompute"] += 0.01 * rep["total_waste_check"] + 1.0
    assert check_breakdown(bad)
    assert check_breakdown({"causes": "nope"})
    good = tmp_path / "breakdown.json"
    good.write_text(json.dumps({"vllm": rep, "preserve": rep}))
    assert check_main([str(good)]) == 0
    broken = tmp_path / "bad.json"
    broken.write_text(json.dumps(bad))
    assert check_main([str(broken)]) == 1
    assert check_main([]) == 2


# ---------------------------------------------------------------------------
# the engine: the identity contract, the sim mirror, the JAX engine
# ---------------------------------------------------------------------------
CONFIGS = [
    ("vllm", {}),                           # discard + full recompute
    ("preserve", {"overlap": False}),       # serial step (§12 oracle)
    ("swap", {"fused": False}),             # unfused mixed batches
    ("infercept", {"prefix_cache": True}),  # min-waste + prefix cache
]
ENGINE_KW = dict(page_size=16, n_pages=64, max_model_len=192)


def _small_workload(make=make_workload, n=3):
    reqs = make(seed=7, n_requests=n, rate_rps=2.0, max_ctx=200)
    for r in reqs:
        r.prompt_len = min(r.prompt_len, 32)
        r.target_ctx = r.prompt_len
        for s in r.segments:
            s.gen_tokens = min(s.gen_tokens, 8)
            if s.interception:
                s.interception.returned_tokens = min(
                    s.interception.returned_tokens, 6)
        r.segments = r.segments[:2]
        if r.segments[-1].interception is not None:
            r.segments[-1].interception = None
    return reqs


@pytest.fixture(scope="module")
def params():
    from repro.configs import get_config as jax_config
    from repro.models import LM as JaxLM
    jparams = JaxLM(jax_config("llama3.2-1b", tiny=True)).init(
        jax.random.PRNGKey(0), dtype=jnp.float32)
    return from_jax_params(jax.tree.map(np.asarray, jparams),
                           get_config("llama3.2-1b", tiny=True))


def _port_engine(params, name, **kw):
    return Engine(get_config("llama3.2-1b", tiny=True), POLICIES[name],
                  params=params, device="cpu", chip=TPU_V5E, **ENGINE_KW,
                  **kw)


@pytest.fixture(scope="module")
def traced_runs(params):
    reqs = _small_workload()
    out = {}
    for name, kw in CONFIGS:
        runs = {}
        for key, tracer in (("on", SpanTracer()), ("off", None)):
            eng = _port_engine(params, name, tracer=tracer, **kw)
            for r in copy.deepcopy(reqs):
                eng.add_request(r)
            fin = eng.run()
            assert len(fin) == len(reqs), (name, key)
            runs[key] = ({r.rid: eng.generated_text(r) for r in fin}, eng)
        out[name] = runs
    return out


def test_tracing_identity(traced_runs):
    for name, runs in traced_runs.items():
        (s_on, eng_on), (s_off, eng_off) = runs["on"], runs["off"]
        assert s_on == s_off, f"tracing perturbed streams under {name}"
        assert dict(eng_on.counters) == dict(eng_off.counters), name
        assert isinstance(eng_off.tracer, NullTracer)
        assert len(eng_off.tracer) == 0
        assert eng_on.ledger.causes == eng_off.ledger.causes, name
        assert eng_on.ledger.total_check == eng_off.ledger.total_check


def test_engine_traces_validate(traced_runs):
    for name, runs in traced_runs.items():
        _, eng = runs["on"]
        assert len(eng.tracer) > 0, name
        errs = validate_trace(to_perfetto(eng.tracer))
        assert errs == [], (name, errs[:5])


def test_trace_has_lifecycle_and_tool_spans(traced_runs):
    _, eng = traced_runs["infercept"]["on"]
    obj = to_perfetto(eng.tracer)
    spans = {ev["name"] for ev in obj["traceEvents"] if ev["ph"] == "X"}
    assert {"iter", "prefill", "decode"} <= spans
    begins = [ev for ev in obj["traceEvents"] if ev["ph"] == "b"]
    ends = [ev for ev in obj["traceEvents"] if ev["ph"] == "e"]
    assert len(begins) == len(ends) == len(eng.ledger.records) > 0
    for ev in ends:
        assert "branch" in ev["args"] and "realized_s" in ev["args"]
    for ev in begins:
        assert "predicted_s" in ev["args"]


def test_engine_ledger_invariants(traced_runs):
    for name, runs in traced_runs.items():
        _, eng = runs["off"]
        led = eng.ledger
        assert led.iterations > 0 and led.busy_time > 0, name
        assert led.total_waste() >= 0, name
        if name in ("preserve", "infercept"):
            assert led.causes["preserve_pinned"] > 0, name
        rep = waste_report(led)
        assert check_breakdown(rep) == [], (name, check_breakdown(rep))
        assert not led._open, name
        assert rep["intercepts"]["n"] == len(led.records)


def test_engine_sim_ledger_mirror(traced_runs):
    """Token-granular policies: the simulator's ledger equals the port
    engine's bit for bit at matched capacity, and its own waste fields."""
    cost = CostModel(cfg=get_config("llama3.2-1b", tiny=True), chip=TPU_V5E,
                     n_chips=1)
    for name in ("vllm", "preserve"):
        _, eng = traced_runs[name]["off"]
        res = simulate(copy.deepcopy(_small_workload()), POLICIES[name],
                       cost, gpu_capacity_tokens=eng.sched.gpu_capacity)
        sl = res.ledger
        assert sl.causes == eng.ledger.causes, name
        assert sl.gpu_byte_seconds == eng.ledger.gpu_byte_seconds, name
        assert sl.total_check == eng.ledger.total_check, name
        assert sl.causes["preserve_pinned"] == res.waste_preserved, name
        assert sl.causes["recompute"] == res.waste_recompute, name
        assert sl.causes["swap_stall"] == res.waste_swap_stall, name


def test_format_summary_and_stats_line(traced_runs):
    _, eng = traced_runs["infercept"]["on"]
    s = format_summary(eng)
    assert "waste attribution" in s
    assert "intercepts" in s and "branches:" in s
    line = format_stats_line(eng)
    assert "iters=" in line and "waste=" in line
    prom = eng.metrics.to_prometheus()
    assert "engine_decode_tokens" in prom
    assert "sched_recompute_tokens" in prom


def test_trace_file_roundtrip_check(tmp_path, traced_runs):
    _, eng = traced_runs["infercept"]["on"]
    path = tmp_path / "trace.json"
    n = write_trace(eng.tracer, str(path))
    assert n > 0
    obj = json.loads(path.read_text())
    assert n == len(obj["traceEvents"])
    assert check_main([str(path)]) == 0


def test_session_latency_histograms(params):
    eng = _port_engine(params, "infercept")
    scripted = ScriptedClient(eng)
    handles = scripted.submit(copy.deepcopy(_small_workload()))
    batch = scripted.client.poll()
    assert batch.drained
    ttft = eng.metrics.histograms["session_ttft_s"]
    assert ttft.n == len(handles)
    assert ttft.total >= 0.0
    assert eng.metrics.histograms["session_token_gap_s"].n > 0
    eng.close()


@pytest.mark.parametrize("name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_traces_and_ledger_match_jax_engine(traced_runs, name, kw):
    """The JAX engine, traced, on the same workload: the same Perfetto
    events, ledger, summary and stats line as the port's traced run."""
    from repro.configs import get_config as jax_config
    from repro.core import POLICIES as JAX_POLICIES
    from repro.obs.export import format_stats_line as jax_stats_line
    from repro.obs.export import format_summary as jax_summary
    from repro.obs.export import to_perfetto as jax_perfetto
    from repro.obs.trace import SpanTracer as JaxTracer
    from repro.serving.engine import Engine as JaxEngine
    from repro.serving.workloads import make_workload as jax_workload
    jeng = JaxEngine(jax_config("llama3.2-1b", tiny=True),
                     JAX_POLICIES[name], seed=0, tracer=JaxTracer(),
                     **ENGINE_KW, **kw)
    for r in _small_workload(jax_workload):
        jeng.add_request(r)
    jeng.run()
    streams, eng = traced_runs[name]["on"]
    assert streams == {r.rid: jeng.generated_text(r) for r in jeng.finished}
    want = jax_perfetto(jeng.tracer)["traceEvents"]
    got = to_perfetto(eng.tracer)["traceEvents"]
    assert len(got) == len(want) > 0
    assert got == want
    assert eng.ledger.causes == jeng.ledger.causes
    assert eng.ledger.total_check == jeng.ledger.total_check
    assert len(eng.ledger.records) == len(jeng.ledger.records)
    assert format_summary(eng) == jax_summary(jeng)
    assert format_stats_line(eng) == jax_stats_line(jeng)
