"""gemma2 in the port (post-norms, local/global windows, attention and
final softcaps, GeGLU), against the JAX package on the CPU.

Two configurations on bridged float32 weights: tiny gemma2-9b (2 layers,
a local layer of window 128 and a global one, head_dim 64) and the same
at head_dim 256, the full model's head width, which the card's kernels
take since this slice.

* ``LM.init`` makes ``post_norm1`` / ``post_norm2`` under the reference's
  keys; ``LM.forward`` (hidden, logits), ``LM.loss``, ``extend_step`` then
  ``decode_step`` over slotted caches whose local ring (128 slots) wraps,
  and the three paged entry points (``forward_mixed_paged``,
  ``decode_step_paged``, ``extend_step_paged``) over contexts past the
  window, against the reference's.
* The engine: greedy streams, ``engine.counters``, scheduler stats and
  the virtual clock equal the JAX engine's under ``infercept`` and
  ``swap``, at ``max_model_len`` 256, so the window bites.
* DESIGN.md §6 inside the port: gather, fused and unfused streams are
  identical under the 4 policies.
* chip_smoke.py's gemma2 phases rehearsed at the tiny config.

Tolerances: hidden states and logits atol 2e-4 and the paged calls'
logits 1e-4 (``tests/test_torch_gather.py`` and ``test_torch_model.py``:
float32 products summed in another order by XLA and by PyTorch); caches
and pools 2e-5 of each leaf's largest magnitude; the loss 1e-5 relative;
greedy ids and engine streams exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.model import LM
from repro_torch.utils.tree import tree_leaves, tree_map
from wide_models import (ALL_POLICIES, chip_smoke, engine_matches_jax,
                         paths_agree, port_run, rehearse_parity, tiny_model)
from wide_models import one_torch_thread  # noqa: F401 (autouse fixture)

WINDOW = 128                               # tiny gemma2's local window
MODELS = {"gemma2": ("gemma2-9b", None), "gemma2_hd256": ("gemma2-9b", 256)}


def model(key):
    return tiny_model(*MODELS[key])


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


def test_config_is_gemma2():
    cfg = model("gemma2")[1]
    windows = [b.attn.sliding_window for b in cfg.blocks]
    assert windows == [WINDOW, None]
    assert all(b.post_norms and b.attn.logit_softcap == 50.0
               for b in cfg.blocks)
    assert cfg.final_logit_softcap == 30.0
    assert model("gemma2_hd256")[1].blocks[0].attn.head_dim == 256


def _shapes(tree, path=()):
    """{key path: shape} of a nested dict / tuple of arrays or
    tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _shapes(tree[key], path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _shapes(t, path + (i,)).items()}
    return {path: tuple(np.shape(tree))}


@pytest.mark.parametrize("key", sorted(MODELS))
def test_init_carries_post_norms_as_the_reference(key):
    """The port's own init has the reference's tree (post-norms included,
    zeros); the bridge carries the reference's values."""
    _, cfg, _, jparams, params = model(key)
    own = LM(cfg).init(torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    for group, g in zip(own["groups"], cfg.groups):
        for blk in group["scan"].values():
            for name in ("post_norm1", "post_norm2"):
                assert blk[name].shape == (g.n_periods, cfg.d_model)
                assert not blk[name].any()
    assert _shapes(own) == _shapes(jparams)
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("key", sorted(MODELS))
def test_forward_and_loss_match_reference(key):
    """150 tokens, past the local layer's window: the flash forward's
    plain version with gemma2's window and softcap."""
    _, cfg, jm, jparams, params = model(key)
    lm = LM(cfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 150)).astype(np.int32)
    jout = jm.forward(jparams, jnp.asarray(toks))
    out = lm.forward(params, torch.from_numpy(toks))
    _close(out.hidden, jout.hidden, 2e-4)
    _close(lm.logits(params, out.hidden), jm.logits(jparams, jout.hidden),
           2e-4)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jm.loss(jparams, jnp.asarray(toks), jnp.asarray(labels))
    tl, parts = lm.loss(params, torch.from_numpy(toks),
                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(parts["aux"]) == 0.0


@pytest.mark.parametrize("key", sorted(MODELS))
def test_extend_then_decode_match_reference(key):
    """Two extend_step chunks (0-60, 60-120; the reference's extend takes
    no ring wrap) and 16 decode_step calls over slotted caches of 160
    slots: the local layer keeps 128, so its ring wraps at position 128
    and its window then hides the oldest positions."""
    _, cfg, jm, jparams, params = model(key)
    lm = LM(cfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 136)).astype(np.int32)
    jcache = jm.init_cache(2, 160, dtype=jnp.float32)
    cache = lm.init_cache(2, 160, dtype=torch.float32, device="cpu")
    assert sorted({tuple(t.shape)[2] for t in tree_leaves(cache)}) == \
        [WINDOW, 160]
    start = np.zeros(2, np.int32)
    for lo, hi in ((0, 60), (60, 120)):
        jl, jcache = jm.extend_step(jparams, jnp.asarray(toks[:, lo:hi]),
                                    jnp.asarray(start + lo), jcache)
        tl, cache = lm.extend_step(params, torch.from_numpy(toks[:, lo:hi]),
                                   torch.from_numpy(start + lo), cache)
        _close(tl, jl, 2e-4)
        _close_leaves(cache, jcache)
    for pos in range(120, 136):
        p = np.full(2, pos, np.int32)
        jl, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, pos]),
                                    jnp.asarray(p), jcache)
        tl, cache = lm.decode_step(params, torch.from_numpy(toks[:, pos]),
                                   torch.from_numpy(p), cache)
        _close(tl, jl, 2e-4)
        assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    _close_leaves(cache, jcache)


def _pools(rng, jm, n_pages, page):
    shapes = jax.tree.map(lambda z: z.shape,
                          jm.init_cache(n_pages, page, dtype=jnp.float32))
    return jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(i, int) for i in x))


N_PAGES, PAGE, MAX_PAGES = 64, 16, 16     # 256 slots a sequence


def _paged_call(entry, jm, lm, jparams, params, rng):
    """One call of ``entry`` through both packages on the same random pools
    and routing, contexts past the 128-token window: (JAX logits, JAX
    pools, port logits, port pools, rows to compare)."""
    cfg = lm.cfg
    bt = rng.permutation(N_PAGES)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32)
    pools = _pools(rng, jm, N_PAGES, PAGE)
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    j_pools = jax.tree.map(jnp.asarray, pools)
    if entry == "forward_mixed_paged":
        # a 6-token chunk at 150, a 5-token prefill, a decode at 230, padding
        tok_seq = np.array([0] * 6 + [1] * 5 + [2] + [0] * 4, np.int32)
        tok_pos = np.array(list(range(150, 156)) + list(range(5)) + [230]
                           + [-1] * 4, np.int32)
        tokens = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        q_last = np.array([5, 10, 11, 0], np.int32)
        args = (tokens, tok_seq, tok_pos, q_last)
        j_ids, jl, j_pools = jm.forward_mixed_paged(
            jparams, *map(jnp.asarray, args), j_pools, jnp.asarray(bt))
        t_ids, tl, _ = lm.forward_mixed_paged(
            params, *map(torch.from_numpy, args), t_pools,
            torch.from_numpy(bt))
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        return jl, j_pools, tl, t_pools, slice(0, 3)
    if entry == "decode_step_paged":
        tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
        ctx_lens = np.array([200, 16, 1, 0], np.int32)
        jl, j_pools = jm.decode_step_paged(
            jparams, jnp.asarray(tokens), jnp.asarray(ctx_lens), j_pools,
            jnp.asarray(bt))
        tl, _ = lm.decode_step_paged(
            params, *map(torch.from_numpy, (tokens, ctx_lens)), t_pools,
            torch.from_numpy(bt))
        return jl, j_pools, tl, t_pools, slice(0, 3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    start, n_new = np.array([140, 0], np.int32), np.array([5, 8], np.int32)
    index = np.array([4, 7], np.int32)
    jl, j_pools = jm.extend_step_paged(
        jparams, *map(jnp.asarray, (tokens, start, n_new)), j_pools,
        jnp.asarray(bt[:2]), logits_index=jnp.asarray(index))
    tl, _ = lm.extend_step_paged(
        params, *map(torch.from_numpy, (tokens, start, n_new)), t_pools,
        torch.from_numpy(bt[:2]), logits_index=torch.from_numpy(index))
    return jl, j_pools, tl, t_pools, slice(0, 2)


@pytest.mark.parametrize("entry", ["forward_mixed_paged",
                                   "decode_step_paged", "extend_step_paged"])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_paged_entry_points_match_reference(key, entry):
    _, cfg, jm, jparams, params = model(key)
    jl, j_pools, tl, t_pools, rows = _paged_call(
        entry, jm, LM(cfg), jparams, params, np.random.default_rng(3))
    _close(tl[rows], np.asarray(jl)[rows], 1e-4)
    assert tl[rows].argmax(-1).tolist() == \
        np.asarray(jl)[rows].argmax(-1).tolist()
    _close_leaves(t_pools, j_pools)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["infercept", "swap"])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_engine_matches_jax_engine(key, policy):
    jcfg, cfg, _, _, params = model(key)
    fin = engine_matches_jax(jcfg, cfg, params, policy)
    # contexts grow past the local window
    assert max(r.target_ctx for r in fin) > WINDOW


@pytest.fixture(scope="module")
def oracle():
    _, cfg, _, _, params = model("gemma2")
    return port_run(cfg, params, "vllm", paged=False)[0]


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_streams_identical_across_paths(oracle, policy):
    """DESIGN.md §6 inside the port on tiny gemma2: the gather, fused and
    unfused paths emit the gather oracle's streams under every policy."""
    _, cfg, _, _, params = model("gemma2")
    paths_agree(oracle, cfg, params, policy)


# ---------------------------------------------------------------------------
# chip_smoke.py's gemma2 phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("phase", ["gemma2_serve", "gemma2_unfused",
                                   "gemma2_quant"])
def test_chip_smoke_gemma2_serve_rehearsals(phase):
    """The gemma2 serve phases at the tiny config on the CPU: the agent
    workload served to the end, every page back, through the same checks
    and launch-count reads as on the card."""
    cs = chip_smoke()
    model_name, policy, kw = cs.WIDE_SERVE_PHASES[phase]
    assert model_name == "gemma2-9b"
    res = cs.serve(policy, cs.Recorder(), tiny=True, device="cpu",
                   model=model_name, **kw)
    assert res["finished"] == res["requests"]
    assert res["model"] == "gemma2-9b-tiny"
    assert all(v == 0 for v in res["launches"].values())


def test_chip_smoke_wide_parity_and_dense_rehearsals():
    """wide_parity's legs at the tiny gemma2 config with a sequence past
    its window (``rehearse_parity``), and wide_dense's prefill_step and
    serve_step."""
    r = rehearse_parity("gemma2-9b")
    assert max(r["lens"]) > WINDOW
    res = chip_smoke().model_serve("wide_dense", tiny=True, device="cpu",
                                   batch=2, seq=40, steps=4)
    assert res["finite"] and res["model"] == "gemma2-9b-tiny"
