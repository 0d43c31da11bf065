"""The gather path of the port on the CPU: attention blocks over slotted
caches and the gather engine (``Engine(paged=False)``).

* Against the JAX package, tiny llama in float32 on bridged weights:
  ``gqa_decode`` (ring wrap, window, softcap), ``gqa_extend``,
  ``block_extend``, ``LM.extend_step`` then ``LM.decode_step``, and
  ``prefill_step`` (its slotted caches, ring slots included) followed by
  8 greedy ``serve_step`` calls; then ``Engine(paged=False)``: streams,
  ``engine.counters`` (the gather byte formulas included), scheduler
  stats, ledger causes and clock under ``vllm``, ``swap`` and
  ``infercept``.
* Inside the port, DESIGN.md §6: gather, fused and unfused streams are
  identical over the 4 policies x prefix cache on/off; padded scatter
  entries never touch a page; chip_smoke.py's gather, dense_serve and
  paths_parity rehearsals.

Tolerances: whole-model logits atol 2e-4, where ``tests/test_torch_model.py``
holds its paged calls to 1e-4: on these prompts the port's unchanged
full-sequence forward already differs from the reference's by 1.5e-4
(float32 products summed in another order by XLA and by PyTorch, through
2 layers whose K/V reach magnitude ~40 under the JAX init, into a
softmax), and the gather path's extend and decode differ from that
forward by 1e-5 within either package; caches atol 2e-5 of each leaf's
largest
magnitude (appended K/V reach magnitude ~40 under the JAX init), the
tolerances of ``tests/test_torch_model.py``, and one layer's output on
random inputs (magnitude ~60) the same 2e-5 of its largest magnitude;
greedy ids and engine streams exactly equal.
"""
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
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models import LM as JaxLM
from repro.models import attention as jax_attention
from repro.models import blocks as jax_blocks
from repro.serving.engine import Engine as JaxEngine
from repro.serving.workloads import make_agent_workload as jax_workload
from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import attention
from repro_torch.models import blocks as B
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import LM
from repro_torch.obs.metrics import SCHED_COUNTER_SCHEMA
from repro_torch.serving.engine import Engine
from repro_torch.serving.workloads import make_agent_workload
from repro_torch.utils.hw import TPU_V5E
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ALL_POLICIES = ["preserve", "vllm", "swap", "infercept"]
ENGINE_KW = dict(page_size=16, n_pages=128, max_model_len=256)
# tests/test_paged_engine.py's agent workload: mid-page prefix divergence
# (system prompt 50 vs page 16), so COW tails of cached pages are taken
WORKLOAD_KW = dict(seed=5, n_sessions=2, rate_rps=2.0, n_templates=2,
                   system_prompt_len=50, turns=(2, 2), turn_gap_s=3.0,
                   hist_per_turn=12, prefix_share=0.75, gen_tokens=(8, 3),
                   final_gen=(8, 3), ret_tokens=(6, 2), max_tool_calls=2,
                   max_ctx=240)


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
def tiny():
    jcfg = jax_config("llama3.2-1b", tiny=True)
    cfg = get_config("llama3.2-1b", tiny=True)
    jm = JaxLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jm, jparams, params


def _close(got, want, atol=2e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _close_rel(got, want):
    """One layer's output on random inputs (magnitude ~60): within 2e-5 of
    its largest magnitude, the caches' tolerance."""
    want = np.asarray(want)
    _close(got, want, atol=2e-5 * np.abs(want).max())


def _close_caches(got, want):
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=2e-5 * np.abs(j).max())


def _layer(tree, i=0):
    return tree_map(lambda t: t[i], tree)


def _attn_cfgs(jcfg, cfg, softcap):
    ja, a = jcfg.blocks[0].attn, cfg.blocks[0].attn
    if softcap:
        ja = dataclasses.replace(ja, logit_softcap=20.0)
        a = dataclasses.replace(a, logit_softcap=20.0)
    return ja, a


def _cache(rng, B, S, a):
    shape = (B, S, a.n_kv_heads, a.head_dim)
    return {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}


# (pos, window_override, softcap): in-range slots; a ring wrap (pos past
# S = 16); a window; a softcap
DECODE_CASES = {"plain": ([3, 9, 15], "cfg", False),
                "ring": ([3, 21, 40], "cfg", False),
                "window": ([12, 21, 40], 6, False),
                "softcap": ([3, 21, 40], "cfg", True)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_gqa_decode_matches_reference(tiny, case):
    jcfg, cfg, _, jparams, params = tiny
    pos, window, cap = DECODE_CASES[case]
    ja, a = _attn_cfgs(jcfg, cfg, cap)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    cache = _cache(rng, 3, 16, a)
    pos = np.asarray(pos, np.int32)
    jp = jax.tree.map(lambda t: t[0],
                      jparams["groups"][0]["scan"]["b0"]["attn"])
    jout, jcache = jax_attention.gqa_decode(
        jp, ja, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(pos), window_override=window)
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    out, new = attention.gqa_decode(
        _layer(params["groups"][0]["scan"]["b0"]["attn"]), a,
        torch.from_numpy(x), tcache, torch.from_numpy(pos),
        window_override=window)
    _close_rel(out, jout)
    _close_caches(new, jcache)
    # the input cache is left as it was (a new cache is returned)
    assert all(np.array_equal(tcache[k].numpy(), cache[k]) for k in "kv")


@pytest.mark.parametrize("window,softcap", [("cfg", False), (4, False),
                                            ("cfg", True)])
def test_gqa_extend_matches_reference(tiny, window, softcap):
    jcfg, cfg, _, jparams, params = tiny
    ja, a = _attn_cfgs(jcfg, cfg, softcap)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    cache = _cache(rng, 2, 24, a)
    start = np.asarray([0, 11], np.int32)
    jp = jax.tree.map(lambda t: t[0],
                      jparams["groups"][0]["scan"]["b0"]["attn"])
    jout, jcache = jax_attention.gqa_extend(
        jp, ja, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(start), window_override=window)
    out, new = attention.gqa_extend(
        _layer(params["groups"][0]["scan"]["b0"]["attn"]), a,
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                              cache.items()},
        torch.from_numpy(start), window_override=window)
    _close_rel(out, jout)
    _close_caches(new, jcache)


def test_block_extend_matches_reference(tiny):
    jcfg, cfg, _, jparams, params = tiny
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    cache = _cache(rng, 2, 32, cfg.blocks[0].attn)
    start = np.asarray([7, 20], np.int32)
    jx, jcache, _ = jax_blocks.block_extend(
        jax.tree.map(lambda t: t[1], jparams["groups"][0]["scan"]["b0"]),
        jcfg, jcfg.blocks[0], jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), {"start": jnp.asarray(start)})
    tx, tcache, aux = B.block_extend(
        _layer(params["groups"][0]["scan"]["b0"], 1), cfg, cfg.blocks[0],
        torch.from_numpy(x), {k: torch.from_numpy(v)
                              for k, v in cache.items()},
        {"start": torch.from_numpy(start)})
    _close_rel(tx, jx)
    _close_caches(tcache, jcache)
    assert float(aux) == 0.0


def test_extend_then_decode_matches_reference(tiny):
    """Per sequence, two extend_step chunks (the second read at
    logits_index) on a zeroed slotted cache, then one decode_step."""
    jcfg, cfg, jm, jparams, params = tiny
    lm = LM(cfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    jcache = jm.init_cache(2, 32, dtype=jnp.float32)
    cache = lm.init_cache(2, 32, dtype=torch.float32, device="cpu")
    _close_caches(cache, jcache)
    start = np.zeros(2, np.int32)
    for lo, hi, index in ((0, 8, None), (8, 12, [1, 3])):
        jidx = None if index is None else jnp.asarray(index)
        tidx = None if index is None else torch.tensor(index)
        jl, jcache = jm.extend_step(jparams, jnp.asarray(toks[:, lo:hi]),
                                    jnp.asarray(start + lo), jcache,
                                    logits_index=jidx)
        tl, cache = lm.extend_step(params, torch.from_numpy(toks[:, lo:hi]),
                                   torch.from_numpy(start + lo), cache,
                                   logits_index=tidx)
        _close(tl, jl)
        _close_caches(cache, jcache)
    pos = np.full(2, 12, np.int32)
    jl, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, 12]),
                                jnp.asarray(pos), jcache)
    tl, cache = lm.decode_step(params, torch.from_numpy(toks[:, 12]),
                               torch.from_numpy(pos), cache)
    _close(tl, jl)
    _close_caches(cache, jcache)
    assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()


@pytest.mark.parametrize("T,cache_len", [(12, 32), (12, 8)])
def test_prefill_and_serve_steps_match_reference(tiny, T, cache_len):
    """prefill_step (the forward through the flash kernel's plain version,
    then _materialize_cache; cache_len 8 < T keeps the last 8 positions
    in ring slots) and 8 greedy serve_step calls (past the ring's end at
    cache_len 8)."""
    jcfg, cfg, _, jparams, params = tiny
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    _, jprefill = jax_prefill_step(jcfg, cache_len)
    _, jserve = jax_serve_step(jcfg)
    _, prefill = build_prefill_step(cfg, cache_len)
    _, serve = build_serve_step(cfg)
    jl, jcache = jprefill(jparams, jnp.asarray(toks))
    tl, cache = prefill(params, torch.from_numpy(toks))
    _close(tl, jl)
    _close_caches(cache, jcache)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for i in range(8):
        pos = np.full(2, T + i, np.int32)
        before = [t.clone() for t in tree_leaves(cache)]
        jl, jtok, jcache = jserve(jparams, jcache, jtok, jnp.asarray(pos))
        tl, ttok, new = serve(params, cache, ttok, torch.from_numpy(pos))
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(cache)))
        cache = new
        _close(tl, jl)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    _close_caches(cache, jcache)


def test_materialized_cache_copies_the_forward(tiny):
    """_materialize_cache copies K/V into its slots: the prefill's cache
    owns its storage, so writing it leaves the forward's tensors as they
    were."""
    _, cfg, _, _, params = tiny
    lm = LM(cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 6),
                         generator=torch.Generator().manual_seed(0))
    out = lm.forward(params, toks, return_cache_len=6)
    again = lm.forward(params, toks, return_cache_len=6)
    for leaf in tree_leaves(out.cache):
        leaf.fill_(7.0)
    assert all(not torch.equal(a, b) for a, b in
               zip(tree_leaves(out.cache), tree_leaves(again.cache)))


# ---------------------------------------------------------------------------
# the gather engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def workload(tiny):
    _, cfg, _, _, params = tiny
    return cfg, params, make_agent_workload(vocab=cfg.vocab_size,
                                            **WORKLOAD_KW)


def _port(cfg, params, reqs, policy, **kw):
    eng = Engine(cfg, POLICIES[policy], params=params, chip=TPU_V5E,
                 device="cpu", **ENGINE_KW, **kw)
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    fin = eng.run(strict=True)
    assert len(fin) == len(reqs)
    return {r.rid: eng.generated_text(r) for r in fin}, eng


@pytest.mark.parametrize("policy", ["vllm", "swap", "infercept"])
def test_gather_engine_matches_jax_engine(tiny, workload, policy):
    jcfg = tiny[0]
    cfg, params, reqs = workload
    jeng = JaxEngine(jcfg, JAX_POLICIES[policy], seed=0, paged=False,
                     **ENGINE_KW)
    for r in jax_workload(vocab=jcfg.vocab_size, **WORKLOAD_KW):
        jeng.add_request(r)
    jfin = jeng.run(strict=True)
    got, eng = _port(cfg, params, reqs, policy, paged=False)
    assert not eng.paged and not eng.fused
    assert got == {r.rid: jeng.generated_text(r) for r in jfin}
    assert dict(eng.counters) == dict(jeng.counters)
    assert {f: getattr(eng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA} \
        == {f: getattr(jeng.sched.stats, f) for f in SCHED_COUNTER_SCHEMA}
    assert eng.now == jeng.now
    assert eng.ledger.causes == jeng.ledger.causes
    # O(context) round trips: more bytes per decode token than one slot
    assert eng.kv_bytes_per_decode_token() > eng.kv_token_bytes
    assert eng.blocks.num_free == eng.blocks.n_pages - 1


@pytest.fixture(scope="module")
def oracle(workload):
    cfg, params, reqs = workload
    return _port(cfg, params, reqs, "vllm", paged=False)[0]


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_streams_identical_across_paths(workload, oracle, policy,
                                        prefix_cache):
    """DESIGN.md §6 inside the port: the gather, fused and unfused paths
    emit the gather oracle's exact streams under every policy, prefix
    cache on and off."""
    cfg, params, reqs = workload
    for kw in (dict(paged=False), dict(), dict(fused=False)):
        got, eng = _port(cfg, params, reqs, policy,
                         prefix_cache=prefix_cache, **kw)
        assert got == oracle, (policy, prefix_cache, kw)
        assert eng.stager.inflight == 0
        if not prefix_cache:
            assert eng.blocks.num_free == eng.blocks.n_pages - 1


def test_gather_scatter_pad_rows_never_touch_pages(tiny):
    """A mirror of the reference's white-box test: only the real entries
    given to _scatter_tokens write the pools; padded rows and tokens are
    never built into the index tensors, so no page (the scratch page
    included) is touched by them."""
    _, cfg, _, _, params = tiny
    eng = Engine(cfg, POLICIES["vllm"], page_size=8, n_pages=16,
                 max_model_len=64, paged=False, params=params, device="cpu")
    for leaf in tree_leaves(eng.pools):
        leaf.fill_(3.25)
    bt = np.asarray([[1, 2] + [eng.scratch_page] * (eng.max_pages - 2)] * 4)
    cache = tree_map(lambda t: torch.full_like(t, 9.0),
                     eng._gather_cache(torch.from_numpy(bt)))
    eng._scatter_tokens(cache, bt, np.zeros(1, np.int64), np.asarray([5]))
    target = np.zeros((16, 8), bool)
    target[1, 5] = True                                  # pos 5 -> page 1
    for leaf in tree_leaves(eng.pools):
        arr = leaf.numpy()
        assert np.all(arr[:, ~target] == 3.25)
        assert np.all(arr[:, target] == 9.0)


def test_gather_engine_keeps_the_refusals(tiny):
    _, cfg, _, _, params = tiny
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
               paged=False, kv_dtype="int8", **ENGINE_KW)
    eng = Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
                 paged=False, fused=True, **ENGINE_KW)
    assert eng.fused is False


# ---------------------------------------------------------------------------
# chip_smoke.py's phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_gather_rehearsal():
    """The gather phase at the tiny config on the CPU: the same workload,
    policy, checks and launch-count reads as on the card; the gather
    engine calls no paged attention and no append, and swaps through the
    stager."""
    cs = _chip_smoke()
    rec = cs.Recorder()
    res = cs.serve("infercept", rec, tiny=True, device="cpu", paged=False)
    assert res["finished"] == res["requests"] and not res["paged"]
    assert set(rec.calls) <= {"swap_pack", "swap_unpack"}
    assert all(v == 0 for v in res["launches"].values())


def test_chip_smoke_dense_serve_and_parity_rehearsals():
    """The dense_serve phase (llama prefill_step and greedy serve_step)
    and paths_parity's gather leg at the tiny config on the CPU: on the
    plain versions the gather leg agrees with the fused path within
    float32 rounding (logits 1e-4, the cache 1e-4 of its largest entry,
    greedy ids equal)."""
    cs = _chip_smoke()
    res = cs.model_serve("dense_serve", tiny=True, device="cpu", batch=2,
                         seq=40, steps=4, profile=True)
    assert res["finite"] and res["max_memory_allocated"] is None
    assert all(v == 0 for v in res["launches"].values())
    r = cs.paths_parity(torch.float32, conditioned=False, tiny=True,
                        device="cpu")
    assert r["gather_err"] <= 1e-4 and r["gather_cache"][0] <= \
        1e-4 * r["gather_cache"][1]
    assert r["gather_ids"][0] == r["gather_ids"][1]
