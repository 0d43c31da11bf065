"""The port's speculative resume past intercepts (DESIGN.md §14) on the
CPU, mirroring ``tests/test_speculation.py``.

* Against the JAX engine: with the oracle predictor (every fork grafts)
  and a template predictor (every fork is rejected), the port gives the
  JAX engine's streams, ``engine.counters`` (the ``spec_*`` counters
  included), scheduler stats, ledger causes (``speculation_wasted``
  included), virtual clock and per-intercept ``spec_log`` — the same
  tiny-llama weights, bridged through ``from_jax_params``.
* Inside the port, the reference's pins: speculation off, all-accept
  and all-reject emit identical streams under all 4 policies; accepted
  forks skip the returned-token re-prefill (token conservation against
  the baseline); rejected forks charge ``speculation_wasted``; the
  session API surfaces each outcome (``SessionHandle.speculation``); no
  predictor, or no paging (``paged=False``), means no speculation.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import POLICIES as JAX_POLICIES
from repro.core.request import InterceptDirective as JaxDirective
from repro.models import LM as JaxLM
from repro.serving.api_executor import \
    OracleToolResultPredictor as JaxOracle
from repro.serving.api_executor import \
    TemplateToolResultPredictor as JaxTemplate
from repro.serving.engine import Engine as JaxEngine
from repro.serving.session import InferCeptClient as JaxClient
from repro.serving.workloads import make_agent_workload as jax_workload
from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.core.request import InterceptDirective
from repro_torch.models.bridge import from_jax_params
from repro_torch.obs.metrics import SCHED_COUNTER_SCHEMA
from repro_torch.serving.api_executor import (OracleToolResultPredictor,
                                              TemplateToolResultPredictor)
from repro_torch.serving.engine import Engine
from repro_torch.serving.session import InferCeptClient
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
WORKLOAD_KW = dict(seed=5, n_sessions=2, rate_rps=2.0, n_templates=2,
                   system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
                   hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
                   final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2,
                   max_ctx=240)
TEMPLATES = {"search": [1, 2, 3], "math": [4, 5], "chatbot": [7],
             "qa": [9, 9]}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("llama3.2-1b", tiny=True)
    cfg = get_config("llama3.2-1b", tiny=True)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    reqs = make_agent_workload(vocab=cfg.vocab_size, **WORKLOAD_KW)
    return jcfg, cfg, params, reqs


def _predictor(mode, vocab, jax_side=False):
    if mode == "accept":
        return (JaxOracle if jax_side else OracleToolResultPredictor)(vocab)
    return (JaxTemplate if jax_side else TemplateToolResultPredictor)(
        TEMPLATES)


def _run(cfg, params, reqs, policy, **kw):
    eng = Engine(cfg, POLICIES[policy], params=params, chip=TPU_V5E,
                 device="cpu", **ENGINE_KW, **kw)
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    fin = eng.run(strict=True)
    assert len(fin) == len(reqs), (policy, kw)
    return {r.rid: eng.generated_text(r) for r in fin}, eng


@pytest.fixture(scope="module")
def spec_diff(setup):
    _, cfg, params, reqs = setup
    base, accept, reject = {}, {}, {}
    for name in ALL_POLICIES:
        base[name] = _run(cfg, params, reqs, name)
        for mode, out in (("accept", accept), ("reject", reject)):
            out[name] = _run(cfg, params, reqs, name, speculate=True,
                             predictor=_predictor(mode, cfg.vocab_size))
    return base, accept, reject


@pytest.mark.parametrize("mode", ["accept", "reject"])
def test_port_speculation_matches_jax(setup, spec_diff, mode):
    jcfg, cfg, _, _ = setup
    jeng = JaxEngine(jcfg, JAX_POLICIES["infercept"], seed=0,
                     speculate=True,
                     predictor=_predictor(mode, jcfg.vocab_size, True),
                     **ENGINE_KW)
    for r in jax_workload(vocab=jcfg.vocab_size, **WORKLOAD_KW):
        jeng.add_request(r)
    jfin = jeng.run(strict=True)
    want = {r.rid: jeng.generated_text(r) for r in jfin}
    got, eng = (spec_diff[1] if mode == "accept" else spec_diff[2])[
        "infercept"]
    assert got == want
    assert dict(eng.counters) == dict(jeng.counters)
    assert eng.counters["spec_forks"] > 0
    assert {f: getattr(eng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA} \
        == {f: getattr(jeng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA}
    assert eng.now == jeng.now
    assert eng.ledger.causes == jeng.ledger.causes
    assert eng.spec_log == jeng.spec_log


def test_speculation_disabled_without_predictor(setup):
    _, cfg, params, _ = setup
    kw = dict(params=params, device="cpu", page_size=16, n_pages=64,
              max_model_len=256)
    assert Engine(cfg, POLICIES["infercept"], **kw).speculate is False
    # opting in without a predictor stays off
    assert Engine(cfg, POLICIES["infercept"], speculate=True,
                  **kw).speculate is False
    assert Engine(cfg, POLICIES["infercept"], speculate=True,
                  predictor=OracleToolResultPredictor(cfg.vocab_size),
                  **kw).speculate is True
    # nor without paging: forks are page refcounts
    assert Engine(cfg, POLICIES["infercept"], paged=False, speculate=True,
                  predictor=OracleToolResultPredictor(cfg.vocab_size),
                  **kw).speculate is False


def test_streams_identical_across_speculation_modes(spec_diff):
    """Default-off, all-accept and all-reject runs emit identical token
    streams on every policy: speculation moves compute earlier in
    virtual time, it never changes the stream."""
    base, accept, reject = spec_diff
    ref = base["preserve"][0]
    for name in ALL_POLICIES:
        assert base[name][0] == ref, name
        assert accept[name][0] == ref, f"accept-path {name} diverged"
        assert reject[name][0] == ref, f"reject-path {name} diverged"
        for runs in (base, accept, reject):
            eng = runs[name][1]
            assert eng.blocks.num_free == eng.blocks.n_pages - 1, name
            assert not eng._spec_forks


def test_accepted_forks_skip_reprefill(spec_diff):
    """With a perfect predictor every fork grafts; the returned tokens the
    baseline re-prefills after resume were already computed on the fork,
    so baseline prefill >= spec prefill + fork prefill (equal under
    preserve), and decode tokens are conserved exactly."""
    base, accept, _ = spec_diff
    for name in ALL_POLICIES:
        eb, ea = base[name][1], accept[name][1]
        c = ea.counters
        assert c["spec_forks"] > 0 and c["spec_accepted"] > 0, name
        assert c["spec_rejected"] == 0 and c["spec_killed"] == 0, name
        assert c["spec_accepted"] == c["spec_forks"], name
        assert c["spec_prefill_tokens"] > 0 and c["spec_decode_tokens"] > 0
        assert c["prefill_tokens"] + c["spec_prefill_tokens"] <= \
            eb.counters["prefill_tokens"], name
        if name == "preserve":
            assert c["prefill_tokens"] + c["spec_prefill_tokens"] == \
                eb.counters["prefill_tokens"]
        assert c["decode_tokens"] + c["spec_decode_tokens"] == \
            eb.counters["decode_tokens"], name
        assert c["spec_grafted_tokens"] == \
            c["spec_accepted"] + c["spec_decode_tokens"], name
        assert ea.sched.stats.recompute_tokens <= \
            eb.sched.stats.recompute_tokens, name
        assert ea.ledger.causes["speculation_wasted"] == 0.0, name


def test_rejected_forks_charge_speculation_waste(spec_diff):
    base, _, reject = spec_diff
    charged = False
    for name in ALL_POLICIES:
        eb, er = base[name][1], reject[name][1]
        c = er.counters
        assert c["spec_accepted"] == 0, name
        assert c["prefill_tokens"] == eb.counters["prefill_tokens"], name
        assert c["decode_tokens"] == eb.counters["decode_tokens"], name
        if c["spec_rejected"]:
            assert er.ledger.causes["speculation_wasted"] > 0.0, name
            charged = True
    assert charged, "no policy ever rejected a fork — vacuous test"
    led = reject["infercept"][1].ledger
    assert led.causes["speculation_wasted"] <= led.total_check + 1e-6


def _session(client_cls, eng, directive, resume_ids):
    """One caller-driven session intercepted after 6 tokens and resumed
    with ``resume_ids`` 0.4 s later; returns (handle, stream)."""
    cl = client_cls(eng)

    def det(req, tid, now):
        if req.output_tokens == 6 and req.seg_idx == 0:
            return directive("qa", 0.4, reason="detector")
        return None

    h = cl.submit(list(range(24)), detector=det, max_new_tokens=16)
    cl.poll()
    assert h.state == "intercepted"
    cl.resume(h, resume_ids, delay=0.4)
    cl.poll()
    assert h.finished and h.request.output_tokens == 16
    return h, cl.token_ids(h)


@pytest.mark.parametrize("resume_ids,accepted", [([7, 8, 9], True),
                                                 ([1, 2, 3], False)])
def test_session_handle_surfaces_speculation(setup, resume_ids, accepted):
    """A caller-owned intercept speculates on the template [7, 8, 9]: a
    matching resume grafts, a mismatching one rejects — visible through
    SessionHandle.speculation — and the stream equals the JAX engine's
    and the port's own no-speculation run."""
    jcfg, cfg, params, _ = setup
    kw = dict(page_size=16, n_pages=64, max_model_len=256)
    eng = Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
                 chip=TPU_V5E, speculate=True,
                 predictor=TemplateToolResultPredictor({"qa": [7, 8, 9]}),
                 **kw)
    h, stream = _session(InferCeptClient, eng, InterceptDirective,
                         resume_ids)
    assert [e["accepted"] for e in h.speculation] == [accepted]
    assert h.speculation[0]["kind"] == "qa"
    assert h.spec_accept_rate == (1.0 if accepted else 0.0)
    if accepted:
        assert h.speculation[0]["grafted_tokens"] >= 1
    jeng = JaxEngine(jcfg, JAX_POLICIES["infercept"], seed=0, speculate=True,
                     predictor=JaxTemplate({"qa": [7, 8, 9]}), **kw)
    jh, jstream = _session(JaxClient, jeng, JaxDirective, resume_ids)
    assert stream == jstream
    assert h.speculation == jh.speculation
    eng0 = Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
                  chip=TPU_V5E, **kw)
    h0, stream0 = _session(InferCeptClient, eng0, InterceptDirective,
                           resume_ids)
    assert stream0 == stream
    assert h0.speculation == [] and h0.spec_accept_rate is None


def test_chip_smoke_spec_rehearsal():
    """chip_smoke.py's spec phase, rehearsed at the tiny config on the
    CPU: the closed loop with the oracle predictor grafts forks whose
    decode steps go through the paged decode attention, beside the fused
    path's ragged attention."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    rec = chip_smoke.Recorder()
    res = chip_smoke.serve("infercept", rec, tiny=True, device="cpu",
                           speculate=True, closed_loop=True)
    assert res["finished"] == res["requests"] and res["speculate"]
    assert res["spec"]["spec_accepted"] > 0
    assert res["spec"]["spec_grafted_tokens"] > res["spec"]["spec_accepted"]
    assert {"paged_attention", "ragged_paged_attention",
            "kv_append"} <= set(rec.calls)
    assert all(v == 0 for v in res["launches"].values())
