"""The port's MoE FFN and deepseek-moe-16b, against the JAX package on the
CPU.

* ``models.moe.moe_forward`` and its balance loss against the reference's
  ``moe_forward`` on the same numpy weights and rows, over
  ``tests/test_moe.py``'s three (E, k, shared) cases at ample capacity and
  an overflow case (cf 0.25), whose expert ids and dropped pairs equal the
  reference's exactly; every token a group against every row a group.
* Tiny deepseek-moe-16b (a dense layer, then an MoE layer of 4 experts,
  top-2, one shared expert) on the reference's bridged seed-0 init: the
  init's tree, ``LM.forward`` (hidden, aux) and ``LM.loss``,
  ``extend_step`` then ``decode_step`` over slotted caches, the three
  paged entry points, ``prefill_step`` / ``serve_step`` and the launcher.
* The engine: greedy streams, counters, scheduler stats, ledger causes
  and the virtual clock equal the JAX engine's under ``infercept`` and
  ``swap``; DESIGN.md §6 inside the port: gather, fused and unfused
  streams identical under the 4 policies.
* The router stays float32 through the bridge and a bf16 engine; the
  in-place stacked init equals the stacking of each period's leaves, bit
  for bit.

chip_smoke.py's MoE phases are rehearsed in
``tests/test_torch_moe_smoke.py``.

Tolerances: ``moe_forward`` 1e-5 (float32, products summed in other
orders); hidden states and logits atol 2e-4, the paged calls' logits 1e-4,
caches and pools 2e-5 of each leaf's largest magnitude and the losses
1e-5 relative, as ``tests/test_torch_gemma2.py`` holds them; ids, streams
and dropped pairs exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FFNCfg as JaxFFNCfg
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.configs.base import FFNCfg
from repro_torch.core import POLICIES
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import blocks as B
from repro_torch.models import moe
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.common import embed_init
from repro_torch.models.model import LM
from repro_torch.serving.engine import Engine
from repro_torch.utils.tree import tree_leaves, tree_map
from wide_models import (ALL_POLICIES, engine_matches_jax, paths_agree,
                         port_run, tiny_model)
from wide_models import one_torch_thread  # noqa: F401 (autouse fixture)

MODEL = "deepseek-moe-16b"


def model():
    return tiny_model(MODEL)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _close_leaves(got, want):
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=2e-5 * np.abs(j).max())


# ---------------------------------------------------------------------------
# moe_forward against the reference's
# ---------------------------------------------------------------------------
def _ffn(E, k, shared, cf):
    kw = dict(kind="moe", n_routed_experts=E, top_k=k,
              n_shared_experts=shared, d_ff_expert=32, capacity_factor=cf)
    return JaxFFNCfg(**kw), FFNCfg(**kw)


def _moe_pair(jf, d=16, seed=0):
    """The reference's init_moe at seed ``seed``: (JAX params, the same
    as torch tensors)."""
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), d, jf, jnp.float32)
    return jp, tree_map(lambda a: torch.from_numpy(np.array(a)),
                        jax.tree.map(np.asarray, jp))


CASES = [(4, 2, 0, 8.0, (2, 12)), (8, 2, 1, 8.0, (2, 12)),
         (4, 1, 2, 8.0, (2, 12)), (4, 2, 0, 0.25, (1, 32))]


@pytest.mark.parametrize("E,k,shared,cf,bt", CASES,
                         ids=[f"E{c[0]}-k{c[1]}-s{c[2]}-cf{c[3]}"
                              for c in CASES])
def test_moe_forward_matches_reference(E, k, shared, cf, bt):
    jf, f = _ffn(E, k, shared, cf)
    jp, p = _moe_pair(jf)
    x = np.random.default_rng(0).normal(size=(*bt, 16)).astype(np.float32)
    jout, jaux = jax_moe.moe_forward(jp, jf, jnp.asarray(x))
    out, aux = moe.moe_forward(p, f, torch.from_numpy(x))
    _close(out, jout, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the same experts, and the same pairs dropped
    logits = jnp.einsum("btd,de->bte", jnp.asarray(x), jp["router"])
    jw, ji = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    C = jax_moe._capacity(bt[1], jf)
    assert moe._capacity(bt[1], f) == C
    _, _, jvalid = jax.vmap(
        lambda xg, gi, gw: jax_moe._dispatch_group(xg, gi, gw, E, C))(
        jnp.asarray(x), ji, jw)
    _, idx, _ = moe.router(p, f, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    valid = moe.route(idx, C, E)[1]
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(jvalid).reshape(-1))
    assert (not valid.all()) == (cf < 1)


def test_per_token_groups_match_per_row_groups():
    """At ample capacity a row of tokens as one group or as groups of one
    gives the same output; at cf 0.25 the row drops pairs and the groups of
    one (capacity k) do not, and give the dense mixture."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 24, 16)).astype(np.float32))
    for cf in (8.0, 0.25):
        jf, f = _ffn(4, 2, 1, cf)
        _, p = _moe_pair(jf, seed=1)
        rows, _ = moe.moe_forward(p, f, x)
        tokens, _ = moe.moe_forward(p, f, x.reshape(48, 1, 16))
        _, idx, _ = moe.router(p, f, x.reshape(48, 1, 16))
        assert moe.route(idx, moe._capacity(1, f), 4)[1].all()
        if cf > 1:
            torch.testing.assert_close(tokens.reshape(2, 24, 16), rows,
                                       rtol=0, atol=1e-6)
        else:
            _, ample = _ffn(4, 2, 1, 8.0)
            want, _ = moe.moe_forward(p, ample, x)
            torch.testing.assert_close(tokens.reshape(2, 24, 16), want,
                                       rtol=0, atol=1e-6)
            assert float((rows - want).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# tiny deepseek-moe-16b
# ---------------------------------------------------------------------------
def _shapes(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _shapes(tree[key], path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _shapes(t, path + (i,)).items()}
    return {path: tuple(np.shape(tree))}


def test_init_has_the_reference_tree_and_a_float32_router():
    _, cfg, _, jparams, params = model()
    own = LM(cfg).init(torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    assert _shapes(own) == _shapes(jparams)
    moe_blk = own["groups"][1]["scan"]["b0"]
    assert moe_blk["moe"]["router"].dtype == torch.float32
    assert moe_blk["moe"]["we_gate"].dtype == torch.bfloat16
    assert "mlp" in own["groups"][0]["scan"]["b0"]
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_forward_and_loss_match_reference():
    _, cfg, jm, jparams, params = model()
    lm = LM(cfg)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jout = jm.forward(jparams, jnp.asarray(toks))
    out = lm.forward(params, torch.from_numpy(toks))
    _close(out.hidden, jout.hidden, 2e-4)
    np.testing.assert_allclose(float(out.aux_loss), float(jout.aux_loss),
                               rtol=1e-5)
    assert float(out.aux_loss) > 0
    labels = np.roll(toks, -1, axis=1)
    jl, jparts = jm.loss(jparams, jnp.asarray(toks), jnp.asarray(labels))
    tl, parts = lm.loss(params, torch.from_numpy(toks),
                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=1e-5)


def test_extend_then_decode_match_reference():
    """Two extend_step chunks (per-row groups at the chunk's length) and
    8 decode_step calls (groups of one) over slotted caches."""
    _, cfg, jm, jparams, params = model()
    lm = LM(cfg)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)
    jcache = jm.init_cache(2, 64, dtype=jnp.float32)
    cache = lm.init_cache(2, 64, dtype=torch.float32, device="cpu")
    start = np.zeros(2, np.int32)
    for lo, hi in ((0, 24), (24, 40)):
        jl, jcache = jm.extend_step(jparams, jnp.asarray(toks[:, lo:hi]),
                                    jnp.asarray(start + lo), jcache)
        tl, cache = lm.extend_step(params, torch.from_numpy(toks[:, lo:hi]),
                                   torch.from_numpy(start + lo), cache)
        _close(tl, jl, 2e-4)
        _close_leaves(cache, jcache)
    for pos in range(40, 48):
        p = np.full(2, pos, np.int32)
        jl, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, pos]),
                                    jnp.asarray(p), jcache)
        tl, cache = lm.decode_step(params, torch.from_numpy(toks[:, pos]),
                                   torch.from_numpy(p), cache)
        _close(tl, jl, 2e-4)
        assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    _close_leaves(cache, jcache)


N_PAGES, PAGE, MAX_PAGES = 32, 16, 8


def _pools(rng, jm):
    shapes = jax.tree.map(lambda z: z.shape,
                          jm.init_cache(N_PAGES, PAGE, dtype=jnp.float32))
    return jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(i, int) for i in x))


@pytest.mark.parametrize("entry", ["forward_mixed_paged",
                                   "decode_step_paged", "extend_step_paged"])
def test_paged_entry_points_match_reference(entry):
    _, cfg, jm, jparams, params = model()
    lm = LM(cfg)
    rng = np.random.default_rng(4)
    bt = rng.permutation(N_PAGES)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32)
    pools = _pools(rng, jm)
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    j_pools = jax.tree.map(jnp.asarray, pools)
    if entry == "forward_mixed_paged":
        # a 6-token chunk at 50, a 5-token prefill, a decode at 90, padding
        tok_seq = np.array([0] * 6 + [1] * 5 + [2] + [0] * 4, np.int32)
        tok_pos = np.array(list(range(50, 56)) + list(range(5)) + [90]
                           + [-1] * 4, np.int32)
        tokens = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        args = (tokens, tok_seq, tok_pos, np.array([5, 10, 11, 0], np.int32))
        j_ids, jl, j_pools = jm.forward_mixed_paged(
            jparams, *map(jnp.asarray, args), j_pools, jnp.asarray(bt))
        t_ids, tl, _ = lm.forward_mixed_paged(
            params, *map(torch.from_numpy, args), t_pools,
            torch.from_numpy(bt))
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        rows = slice(0, 3)
    elif entry == "decode_step_paged":
        tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
        ctx_lens = np.array([100, 16, 1, 0], np.int32)
        jl, j_pools = jm.decode_step_paged(
            jparams, jnp.asarray(tokens), jnp.asarray(ctx_lens), j_pools,
            jnp.asarray(bt))
        tl, _ = lm.decode_step_paged(
            params, *map(torch.from_numpy, (tokens, ctx_lens)), t_pools,
            torch.from_numpy(bt))
        rows = slice(0, 3)
    else:
        tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        start, n_new = np.array([40, 0], np.int32), np.array([5, 8], np.int32)
        index = np.array([4, 7], np.int32)
        jl, j_pools = jm.extend_step_paged(
            jparams, *map(jnp.asarray, (tokens, start, n_new)), j_pools,
            jnp.asarray(bt[:2]), logits_index=jnp.asarray(index))
        tl, _ = lm.extend_step_paged(
            params, *map(torch.from_numpy, (tokens, start, n_new)), t_pools,
            torch.from_numpy(bt[:2]), logits_index=torch.from_numpy(index))
        rows = slice(0, 2)
    _close(tl[rows], np.asarray(jl)[rows], 1e-4)
    assert tl[rows].argmax(-1).tolist() == \
        np.asarray(jl)[rows].argmax(-1).tolist()
    _close_leaves(t_pools, j_pools)


def test_prefill_and_serve_steps_match_reference():
    """launch/steps.py: prefill_step of 2 x 20, then 4 greedy serve_step
    calls, against the reference's."""
    jcfg, cfg, _, jparams, params = model()
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    _, jprefill = jax_prefill_step(jcfg, 32)
    _, jserve = jax_serve_step(jcfg)
    _, prefill = build_prefill_step(cfg, 32)
    _, serve = build_serve_step(cfg)
    jl, jcache = jprefill(jparams, jnp.asarray(toks))
    tl, cache = prefill(params, torch.from_numpy(toks))
    _close(tl, jl, 2e-4)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    tok = tl.argmax(-1).to(torch.int32)
    for i in range(4):
        pos = np.full(2, 20 + i, np.int32)
        jl, jtok, jcache = jserve(jparams, jcache, jtok, jnp.asarray(pos))
        tl, tok, cache = serve(params, cache, tok, torch.from_numpy(pos))
        _close(tl, jl, 2e-4)
        assert tok.tolist() == np.asarray(jtok).tolist()


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", MODEL, "--tiny", "--device", "cpu", "--requests",
                "3", "--tool-workers", "0"])
    out = capsys.readouterr().out
    assert "finished=4/4" in out and "live session: state=finished" in out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["infercept", "swap"])
def test_engine_matches_jax_engine(policy):
    jcfg, cfg, _, _, params = model()
    engine_matches_jax(jcfg, cfg, params, policy)


@pytest.fixture(scope="module")
def oracle():
    _, cfg, _, _, params = model()
    return port_run(cfg, params, "vllm", paged=False)[0]


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_streams_identical_across_paths(oracle, policy):
    """DESIGN.md §6 inside the port on tiny deepseek-moe-16b (capacity
    factor 8.0: nothing drops on any path): the gather, fused and unfused
    paths emit the gather oracle's streams under every policy."""
    _, cfg, _, _, params = model()
    paths_agree(oracle, cfg, params, policy)


def test_router_stays_float32_through_bridge_and_bf16_engine():
    _, cfg, _, jparams, _ = model()
    bridged = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                              dtype=torch.bfloat16)
    eng = Engine(cfg, POLICIES["infercept"], page_size=16, n_pages=16,
                 max_model_len=64, params=bridged, device="cpu",
                 dtype=torch.bfloat16)
    for tree in (bridged, eng.params):
        blk = tree["groups"][1]["scan"]["b0"]
        assert blk["moe"]["router"].dtype == torch.float32
        assert blk["moe"]["we_down"].dtype == torch.bfloat16
        assert blk["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        eng.params["groups"][1]["scan"]["b0"]["moe"]["router"].numpy(),
        np.asarray(jparams["groups"][1]["scan"]["b0"]["moe"]["router"]))
    eng.close()


def _stacked_init(cfg, seed):
    """LM.init as the stacking of each period's separately made leaves
    (``torch.stack``), in the same generator order."""
    gen = torch.Generator().manual_seed(seed)
    kw = dict(dtype=torch.float32, device="cpu")
    params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), **kw),
              "final_norm": torch.zeros((cfg.d_model,), **kw)}
    groups = []
    for g in cfg.groups:
        periods = [{f"b{j}": B.init_block(gen, cfg, blk, **kw)
                    for j, blk in enumerate(g.period)}
                   for _ in range(g.n_periods)]
        groups.append({"scan": tree_map(lambda *xs: torch.stack(xs),
                                        *periods)})
    params["groups"] = tuple(groups)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                       **kw)
    return params


@pytest.mark.parametrize("name", ["llama3.2-1b", MODEL])
def test_init_in_place_equals_stacking(name):
    cfg = get_config(name, tiny=True)
    # three MoE periods, so that the stacking has something to stack
    cfg = dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, n_periods=max(g.n_periods, 3))
        for g in cfg.groups))
    got = LM(cfg).init(torch.Generator().manual_seed(7),
                       dtype=torch.float32, device="cpu")
    want = _stacked_init(cfg, 7)
    assert _shapes(got) == _shapes(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
