"""The invariant layer of DESIGN.md §16 on the port's engine
(``Engine(sanitize=True)``), mirroring the runtime cases of
``tests/test_analysis.py``: the KV-page ownership sanitizer and the
lifecycle checker (both copied from the reference) wired into the port's
plan and dispatch phases.

* The default engine carries no sanitizer and its counter view no
  schema; the sanitized view refuses an undeclared key.
* Injected faults are found: a leak, a double free, a stale block-table
  entry, an unforked COW write, a stale scale on int8 pools; a free
  zeroes the scales; an illegal phase transition raises; the transition
  table has its shape.
* ``sanitize=True`` only observes: chaos soaks (tool faults, retries,
  swap churn) on float32 and int8 pools, and on the gather engine, have
  no findings and the streams, session states and counters of
  ``sanitize=False``; ``simulate(sanitize=True)`` runs clean.
* Against the JAX engine with ``sanitize=True`` on bridged weights: no
  findings on either side, equal streams and counters.
* ``repro_torch.analysis.run_lint`` resolves and
  ``python -m repro_torch.analysis.lint src/repro_torch`` exits 0; and
  chip_smoke.py's sanitize phases rehearsed at the tiny config.
"""
import copy
import subprocess
import sys
from pathlib import Path

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
from repro_torch import analysis
from repro_torch.analysis.lifecycle import (TRANSITIONS, IllegalTransition,
                                            LifecycleChecker)
from repro_torch.configs import get_config
from repro_torch.core import POLICIES, CostModel
from repro_torch.core.request import (InterceptDirective, Phase, Request,
                                      SamplingParams, Segment)
from repro_torch.models.bridge import from_jax_params
from repro_torch.serving.api_executor import (ChaosToolExecutor,
                                              VirtualTimeToolExecutor)
from repro_torch.serving.engine import Engine
from repro_torch.serving.session import InferCeptClient
from repro_torch.serving.workloads import make_agent_workload, make_workload
from repro_torch.sim import simulate
from repro_torch.utils.hw import A100, TPU_V5E

ROOT = Path(__file__).resolve().parents[1]
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
    cfg = get_config("llama3.2-1b", tiny=True)
    jparams = JaxLM(jax_config("llama3.2-1b", tiny=True)).init(
        jax.random.PRNGKey(0), dtype=jnp.float32)
    return from_jax_params(jax.tree.map(np.asarray, jparams), cfg)


def _engine(params, policy="infercept", **kw):
    cfg = get_config("llama3.2-1b", tiny=True)
    for k, v in dict(page_size=16, n_pages=128, max_model_len=256).items():
        kw.setdefault(k, v)
    return Engine(cfg, POLICIES[policy], params=params, device="cpu",
                  chip=TPU_V5E, **kw)


def _run_some(eng, n_sessions=2, max_new=8, steps=None):
    """Submit a few sessions and step the engine until drained (or for
    ``steps`` iterations)."""
    cl = InferCeptClient(eng)
    for i in range(n_sessions):
        cl.submit([10 + i, 11 + i, 12 + i, 13 + i], max_new_tokens=max_new)
    if steps is None:
        cl.poll()
    else:
        for _ in range(steps):
            if not eng.step():
                break
    return cl


def _live_page(eng):
    rid, st = next((rid, st) for rid, st in eng.kv.items()
                   if any(e is not None and e[0] == "dev" for e in st.pages))
    return rid, next(e[1] for e in st.pages if e is not None and e[0] == "dev")


# ---------------------------------------------------------------------------
# sanitize=False carries nothing; the sanitized counter view has a schema
# ---------------------------------------------------------------------------
def test_default_engine_carries_no_sanitizer(params):
    eng = _engine(params)
    assert eng.sanitizer is None and eng._lifecycle_checker is None
    assert eng.counters._schema is None
    _run_some(eng)
    assert all("_lifecycle" not in r.__dict__ for r in eng.finished)


def test_sanitized_counter_view_fails_fast_on_undeclared_key(params):
    eng = _engine(params, sanitize=True)
    with pytest.raises(KeyError, match="undeclared counter key"):
        eng.counters["bogus_key"] = 1  # lint: allow(undeclared-counter): intentionally-bogus key under test


# ---------------------------------------------------------------------------
# injection: each corruption class fires its detector
# ---------------------------------------------------------------------------
def test_injected_leak_detected(params):
    eng = _engine(params, sanitize=True)
    _run_some(eng)
    assert eng.sanitizer.findings == []
    [pid] = eng.blocks.allocate(1)             # a page no table owns
    eng.sanitizer.audit("test-inject")
    leaks = [f for f in eng.sanitizer.findings if f.kind == "leak"]
    assert leaks and leaks[0].page == pid and leaks[0].site == "test-inject"


def test_injected_double_free_detected(params):
    eng = _engine(params, sanitize=True)
    [pid] = eng.blocks.allocate(1)
    eng.blocks.free([pid])
    eng.blocks.free([pid])                     # would assert un-sanitized
    dfs = [f for f in eng.sanitizer.findings if f.kind == "double_free"]
    assert dfs and dfs[0].page == pid
    assert "test_torch_analysis.py" in dfs[0].site


def test_injected_stale_block_table_entry_detected(params):
    eng = _engine(params, sanitize=True)
    _run_some(eng, steps=4)                    # mid-flight: live tables
    rid, pid = _live_page(eng)
    eng.blocks.free([pid])                     # yank a live page
    eng.sanitizer.audit("test-inject")
    uafs = [f for f in eng.sanitizer.findings if f.kind == "use_after_free"]
    assert uafs and any(f.page == pid for f in uafs)
    assert any(f.rid is not None and str(rid) in str(f.rid) for f in uafs)


@pytest.mark.parametrize("paged", [True, False])
def test_injected_unforked_cow_write_detected(params, paged):
    """A phantom co-owner on a decode target page survives to dispatch,
    where check_plan flags the unforked write, on the paged and on the
    gather engine."""
    eng = _engine(params, sanitize=True, paged=paged)
    _run_some(eng, steps=4)
    _, pid = _live_page(eng)
    eng.blocks.fork([pid])
    for _ in range(3):
        if any(f.kind == "cow_violation" for f in eng.sanitizer.findings):
            break
        if not eng.step():
            break
    cows = [f for f in eng.sanitizer.findings if f.kind == "cow_violation"]
    assert cows and cows[0].page == pid and cows[0].rid is not None


def test_injected_stale_scale_detected(params):
    eng = _engine(params, sanitize=True, kv_dtype="int8")
    _run_some(eng)
    eng.sanitizer.audit("pre-inject")
    assert eng.sanitizer.findings == []
    pid = next(p for p in range(eng.blocks.n_pages)
               if eng.blocks.ref_count(p) == 0)
    eng.pools[0]["b0"]["k_scale"][:, pid] = 0.25   # a resurrected scale
    eng.sanitizer.audit("test-inject")
    stale = [f for f in eng.sanitizer.findings if f.kind == "stale_scale"]
    assert stale and stale[0].page == pid and stale[0].site == "test-inject"
    assert "scale" in stale[0].detail


def test_free_zeroes_scales_eagerly(params):
    eng = _engine(params, sanitize=True, kv_dtype="int8")
    _run_some(eng)
    assert eng.counters["kv_quant_scale_reset_pages"] > 0
    assert eng._stale_scale_pages() == []


def test_injected_illegal_phase_transition_raises():
    req = Request(rid=7, arrival=0.0, prompt_len=2,
                  segments=[Segment(4, None)], prompt_tokens=[1, 2])
    req.__dict__["_lifecycle"] = LifecycleChecker()
    req.phase = Phase.RUNNING
    req.phase = Phase.FINISHED
    with pytest.raises(IllegalTransition) as ei:
        req.phase = Phase.RUNNING                # terminal states are final
    assert ei.value.rid == 7
    assert ei.value.old is Phase.FINISHED and ei.value.new is Phase.RUNNING
    assert "test_torch_analysis.py" in ei.value.site


def test_transition_table_shape():
    assert set(TRANSITIONS) == set(Phase)
    for terminal in (Phase.FINISHED, Phase.CANCELLED, Phase.FAILED):
        assert TRANSITIONS[terminal] == frozenset()
    for live in (Phase.WAITING, Phase.RUNNING, Phase.PAUSED, Phase.SWAPQ):
        assert {Phase.CANCELLED, Phase.FAILED} <= TRANSITIONS[live]


# ---------------------------------------------------------------------------
# sanitize=True only observes
# ---------------------------------------------------------------------------
def _soak(params, policy, *, sanitize, n=6, **engine_kw):
    cfg = get_config("llama3.2-1b", tiny=True)
    eng = _engine(params, policy, sanitize=sanitize, **engine_kw)
    cl = InferCeptClient(eng)
    tools = ChaosToolExecutor(
        VirtualTimeToolExecutor(cfg.vocab_size, n_tokens=4, duration=0.05),
        seed=7, failure_rate=0.2, timeout_rate=0.1)

    def detector(req, tid, now):
        if req.output_tokens == 5:
            return InterceptDirective(kind="math", duration_hint=0.05)
        return None

    hs = [cl.submit([10 + i, 11 + i, 12 + i, 13 + i], detector=detector,
                    max_new_tokens=16, tools=tools,
                    sampling=SamplingParams(tool_timeout_s=1.0,
                                            tool_retries=1,
                                            tool_backoff_s=0.01))
          for i in range(n)]
    cl.poll()
    return eng, hs, {h.rid: cl.token_ids(h) for h in hs if h.finished}


@pytest.mark.parametrize("policy,kw", [
    ("infercept", {}), ("infercept", {"kv_dtype": "int8"}),
    ("swap", {"fused": False}), ("infercept", {"overlap": False}),
    ("vllm", {"paged": False})],
    ids=["quick", "quantized", "unfused", "serial", "gather"])
def test_sanitized_soak_is_clean_and_identical(params, policy, kw):
    eng_off, hs_off, streams_off = _soak(params, policy, sanitize=False,
                                         **kw)
    eng_on, hs_on, streams_on = _soak(params, policy, sanitize=True, **kw)
    assert eng_on.sanitizer.findings == [], \
        [str(f) for f in eng_on.sanitizer.findings]
    assert [h.state for h in hs_on] == [h.state for h in hs_off]
    assert streams_on == streams_off
    assert dict(eng_on.counters) == dict(eng_off.counters)


def test_sanitized_simulator_runs_clean():
    cost = CostModel(cfg=get_config("gpt-j-6b"), chip=A100, n_chips=1)
    reqs = make_workload(seed=1, n_requests=24, rate_rps=3.0)
    base = simulate(copy.deepcopy(reqs), POLICIES["infercept"], cost)
    sane = simulate(copy.deepcopy(reqs), POLICIES["infercept"], cost,
                    sanitize=True)
    assert len(sane.finished) == len(base.finished) == 24
    assert sane.sim_time == base.sim_time


# ---------------------------------------------------------------------------
# against the JAX engine, both sanitized
# ---------------------------------------------------------------------------
WORKLOAD_KW = dict(seed=5, n_sessions=2, rate_rps=2.0, n_templates=2,
                   system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
                   hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
                   final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2,
                   max_ctx=240)


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"}],
                         ids=["float32", "int8"])
def test_sanitized_port_matches_sanitized_jax_engine(params, kw):
    jcfg = jax_config("llama3.2-1b", tiny=True)
    jeng = JaxEngine(jcfg, JAX_POLICIES["infercept"], seed=0, page_size=16,
                     n_pages=128, max_model_len=256, prefix_cache=True,
                     sanitize=True, **kw)
    for r in jax_workload(vocab=jcfg.vocab_size, **WORKLOAD_KW):
        jeng.add_request(r)
    jfin = jeng.run(strict=True)
    eng = _engine(params, prefix_cache=True, sanitize=True, **kw)
    for r in make_agent_workload(vocab=eng.cfg.vocab_size, **WORKLOAD_KW):
        eng.add_request(r)
    fin = eng.run(strict=True)
    assert jeng.sanitizer.findings == [] and eng.sanitizer.findings == []
    assert {r.rid: eng.generated_text(r) for r in fin} == \
        {r.rid: jeng.generated_text(r) for r in jfin}
    assert dict(eng.counters) == dict(jeng.counters)


# ---------------------------------------------------------------------------
# the copied lint
# ---------------------------------------------------------------------------
def test_port_lint_resolves_and_is_clean():
    from repro_torch.analysis import lint
    assert analysis.run_lint is lint.run
    assert lint.run([str(ROOT / "src" / "repro_torch")]) == []
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         "src/repro_torch"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and "lint: clean" in out.stdout, out


# ---------------------------------------------------------------------------
# chip_smoke.py's sanitize phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_sanitize_rehearsal():
    """The sanitize phase at the tiny config on the CPU: no findings, and
    the serve phase's streams and counters."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    plain = chip_smoke.serve("infercept", chip_smoke.Recorder(), tiny=True,
                             device="cpu")
    sane = chip_smoke.serve("infercept", chip_smoke.Recorder(), tiny=True,
                            device="cpu", sanitize=True)
    assert sane["findings"] == [] and plain["findings"] is None
    assert sane["streams"] == plain["streams"]
    assert sane["counters"] == plain["counters"]
