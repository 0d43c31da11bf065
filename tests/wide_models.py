"""Helpers shared by the tests of the wide-head models in the port
(``test_torch_gemma2.py``, ``test_torch_gptj.py``): tiny configurations
of either package, optionally at another head_dim, on the reference's
seed-0 float32 init bridged into the port; the port's engine on the agent
workload of ``tests/test_torch_gather.py`` and its comparison with the JAX
engine; and ``chip_smoke.py`` imported for its CPU rehearsals."""
import copy
import dataclasses
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
from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.models.bridge import from_jax_params
from repro_torch.obs.metrics import SCHED_COUNTER_SCHEMA
from repro_torch.serving.engine import Engine
from repro_torch.serving.workloads import make_agent_workload
from repro_torch.utils.hw import TPU_V5E

ROOT = Path(__file__).resolve().parents[1]
ALL_POLICIES = ["preserve", "vllm", "swap", "infercept"]
ENGINE_KW = dict(page_size=16, n_pages=128, max_model_len=256)
# tests/test_torch_gather.py's agent workload: contexts up to 240 tokens,
# past tiny gemma2's 128-token window
WORKLOAD_KW = dict(seed=5, n_sessions=2, rate_rps=2.0, n_templates=2,
                   system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
                   hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
                   final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2,
                   max_ctx=240)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_head_dim(cfg, head_dim):
    """``cfg`` (either package's) with every attention block at
    ``head_dim``; the name says so."""
    groups = tuple(dataclasses.replace(g, period=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(
            b.attn, head_dim=head_dim)) for b in g.period))
        for g in cfg.groups)
    return dataclasses.replace(cfg, groups=groups,
                               name=f"{cfg.name}-hd{head_dim}")


_BUILT = {}


def tiny_model(name, head_dim=None):
    """(jax cfg, port cfg, JAX LM, JAX params, bridged port params) of the
    tiny ``name`` (at ``head_dim`` where given), float32, made once per
    worker."""
    if (name, head_dim) not in _BUILT:
        jcfg, cfg = jax_config(name, tiny=True), get_config(name, tiny=True)
        if head_dim is not None:
            jcfg, cfg = with_head_dim(jcfg, head_dim), with_head_dim(
                cfg, head_dim)
        jm = JaxLM(jcfg)
        jparams = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
        _BUILT[name, head_dim] = (jcfg, cfg, jm, jparams, params)
    return _BUILT[name, head_dim]


def port_run(cfg, params, policy, **kw):
    """The port's engine on the CPU over the agent workload: (streams by
    rid, the engine, the finished requests)."""
    eng = Engine(cfg, POLICIES[policy], params=params, chip=TPU_V5E,
                 device="cpu", **ENGINE_KW, **kw)
    reqs = make_agent_workload(vocab=cfg.vocab_size, **WORKLOAD_KW)
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    fin = eng.run(strict=True)
    assert len(fin) == len(reqs)
    return {r.rid: eng.generated_text(r) for r in fin}, eng, fin


def engine_matches_jax(jcfg, cfg, params, policy, **kw):
    """The port's engine against the JAX engine (its own seed-0 init,
    which the port's params are bridged from) on one workload, both with
    the engine options ``kw``: streams, counters, scheduler stats, ledger
    causes and the virtual clock equal; returns the port's finished
    requests."""
    jeng = JaxEngine(jcfg, JAX_POLICIES[policy], seed=0, **ENGINE_KW, **kw)
    for r in jax_workload(vocab=jcfg.vocab_size, **WORKLOAD_KW):
        jeng.add_request(r)
    jfin = jeng.run(strict=True)
    got, eng, fin = port_run(cfg, params, policy, **kw)
    assert got == {r.rid: jeng.generated_text(r) for r in jfin}
    assert dict(eng.counters) == dict(jeng.counters)
    assert {f: getattr(eng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA} \
        == {f: getattr(jeng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA}
    assert eng.now == jeng.now
    assert eng.ledger.causes == jeng.ledger.causes
    # every page back, but those a prefix cache still holds
    assert eng.blocks.num_free == jeng.blocks.num_free
    if not kw.get("prefix_cache"):
        assert eng.blocks.num_free == eng.blocks.n_pages - 1
    return fin


def paths_agree(oracle, cfg, params, policy):
    """DESIGN.md §6 inside the port: the gather, fused and unfused paths
    emit ``oracle``'s streams under ``policy``, with nothing left in
    flight and every page back."""
    for kw in (dict(paged=False), dict(), dict(fused=False)):
        got, eng, _ = port_run(cfg, params, policy, **kw)
        assert got == oracle, (policy, kw)
        assert eng.stager.inflight == 0
        assert eng.blocks.num_free == eng.blocks.n_pages - 1


def chip_smoke():
    """The repository's chip_smoke.py as a module."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as module
    finally:
        sys.path.pop(0)
    return module


def rehearse_parity(model):
    """wide_parity's legs at ``model``'s tiny config on the CPU, with a
    sequence past tiny gemma2's 128-token window: the plain versions agree
    within float32 rounding (logits 1e-4, pools and cache 1e-4 of their
    largest entry, greedy ids equal), and layer 0's K/V lie within 1e-5
    of the float64 witness on both prefill legs."""
    r = chip_smoke().paths_parity(torch.float32, conditioned=True,
                                  tiny=True, device="cpu", model=model,
                                  lens=[37, 160, 150, 16])
    for leg in ("prefill", "decode", "gather"):
        assert r[f"{leg}_err"] <= 1e-4, leg
        assert r[f"{leg}_ids"][0] == r[f"{leg}_ids"][1], leg
    (pe, pt), (de, dt) = r["prefill_pools"], r["decode_pools"]
    assert pe <= 1e-4 * pt and de <= 1e-4 * dt
    assert r["gather_cache"][0] <= 1e-4 * r["gather_cache"][1]
    wf, wu, wt = r["layer0_witness"]
    assert max(wf, wu) <= 1e-5 * wt
    return r
