"""Embedding prefixes (pixtral's patch embeddings) and ``positions`` in the
port, against the JAX reference on tiny pixtral-12b (bridged weights) and
a 16-row prefix (its ``vision_prefix_len``) at the embeddings' scale, in
float32 on the CPU.

* ``LM.forward(tokens, embeds)``: hidden states within 1e-4 of their
  largest magnitude, also at ``positions`` (an offset range).
* ``LM.loss`` drops the prefix's positions: within 1e-5, and equal to
  the cross entropy of the token positions' hidden states.
* Gradients of every leaf and the prefix itself within 1e-3 of each
  leaf's largest magnitude, the port no farther from the float64
  gradient than 2x the reference (after tests/test_torch_training.py's
  1.5x: the reference init's attention is close to a hard max; here the
  embedding table's gradient lands 1.77x as far, measured); one
  ``make_train_step`` as ``tests/test_models_smoke.py`` takes it: loss,
  grad_norm and lr.
* ``prefill_step(tokens, embeds)`` then 8 greedy ``serve_step`` calls at
  P + T on: logits within 1e-4 and 5e-4, tokens equal, caches within
  1e-4 of their largest magnitude; serve_step at P + T equals the last
  logits of a P + T + 1 prefill.
* ``embeds=`` in place of tokens in ``decode_step``, ``extend_step``,
  ``decode_step_paged``, ``extend_step_paged`` and
  ``forward_mixed_paged``: logits within 1e-4, pools and caches within
  2e-5 / 1e-4 of their largest magnitude.
* ``chip_smoke.py``'s pixtral phases rehearsed at the tiny config.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.common import cross_entropy_logits
from repro_torch.models.model import LM
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import loss_and_grads, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
B, T = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("pixtral-12b", tiny=True)
    cfg = get_config("pixtral-12b", tiny=True)
    jm = JaxLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jm, jparams, params


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _prefix(cfg, params, seed=0, rows=None, batch=B):
    """(batch, rows, d) float32 at the embeddings' standard deviation;
    rows default the config's vision_prefix_len."""
    rows = cfg.vision_prefix_len if rows is None else rows
    scale = float(params["embed"].std())
    return (np.random.default_rng(100 + seed).normal(
        size=(batch, rows, cfg.d_model)) * scale).astype(np.float32)


def _sorted_leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _close_rel(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_config_builds_with_its_prefix_len():
    cfg = get_config("pixtral-12b")
    assert cfg.vision_prefix_len == 1024 and cfg.d_model == 5120
    LM(cfg)


def test_embed_prepends_the_prefix(tiny):
    _, cfg, _, _, params = tiny
    toks = torch.from_numpy(_tokens(0, (B, T), cfg.vocab_size))
    pre = torch.from_numpy(_prefix(cfg, params)).double()
    x = LM(cfg).embed(params, toks, pre)
    assert x.shape == (B, cfg.vision_prefix_len + T, cfg.d_model)
    assert x.dtype == params["embed"].dtype        # cast to the table's
    assert torch.equal(x[:, :cfg.vision_prefix_len], pre.float())
    assert torch.equal(x[:, cfg.vision_prefix_len:],
                       LM(cfg).embed(params, toks))


@pytest.mark.parametrize("offset", [None, 5])
def test_forward_matches_jax(tiny, offset):
    """The prefixed sequence at positions 0..P+T-1, or at ``offset`` on
    (RoPE shifted; the flash kernel masks by index, the reference by
    position: the same mask on a range)."""
    jcfg, cfg, jm, jparams, params = tiny
    toks = _tokens(1, (B, T), cfg.vocab_size)
    pre = _prefix(cfg, params)
    n = cfg.vision_prefix_len + T
    pos = None if offset is None else np.arange(offset, offset + n,
                                                dtype=np.int32)
    want = jm.forward(jparams, jnp.asarray(toks), jnp.asarray(pre),
                      positions=None if pos is None else jnp.asarray(pos))
    got = LM(cfg).forward(params, torch.from_numpy(toks),
                          torch.from_numpy(pre),
                          positions=None if pos is None
                          else torch.from_numpy(pos))
    assert got.hidden.shape == (B, n, cfg.d_model)
    _close_rel(got.hidden, want.hidden, 1e-4)
    if offset is not None:
        plain = LM(cfg).forward(params, torch.from_numpy(toks),
                                torch.from_numpy(pre)).hidden
        assert not torch.allclose(plain, got.hidden)


def test_loss_drops_the_prefix(tiny):
    jcfg, cfg, jm, jparams, params = tiny
    toks = _tokens(2, (B, T), cfg.vocab_size)
    labels = _tokens(3, (B, T), cfg.vocab_size)
    pre = _prefix(cfg, params, 1)
    jloss, jaux = jm.loss(jparams, jnp.asarray(toks), jnp.asarray(labels),
                          jnp.asarray(pre))
    lm = LM(cfg)
    for remat in (False, True):
        loss, aux = lm.loss(params, torch.from_numpy(toks),
                            torch.from_numpy(labels), torch.from_numpy(pre),
                            remat=remat)
        assert abs(float(loss) - float(jloss)) <= 1e-5
    h = lm.forward(params, torch.from_numpy(toks),
                   torch.from_numpy(pre)).hidden[:, cfg.vision_prefix_len:]
    ce = cross_entropy_logits(lm.logits(params, h), torch.from_numpy(labels))
    assert abs(float(ce) - float(aux["ce"])) <= 1e-6


def test_gradients_match_jax(tiny):
    """Every parameter leaf's gradient, and the prefix's own, through the
    loss with the prefix."""
    jcfg, cfg, jm, jparams, params = tiny
    rng = np.random.default_rng(4)
    toks = _tokens(4, (B, T), cfg.vocab_size)
    labels = _tokens(5, (B, T), cfg.vocab_size)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    pre = _prefix(cfg, params, 2)
    want, want_pre = jax.grad(lambda p, e: jm.loss(
        p, jnp.asarray(toks), jnp.asarray(labels), e,
        label_mask=jnp.asarray(mask))[0], argnums=(0, 1))(
            jparams, jnp.asarray(pre))

    def port(p, dtype):
        e = torch.from_numpy(pre).to(dtype).requires_grad_(True)
        with torch.enable_grad():
            _, _, g = loss_and_grads(
                LM(cfg), p, torch.from_numpy(toks), torch.from_numpy(labels),
                torch.from_numpy(mask), embeds=e)
            loss, _ = LM(cfg).loss(p, torch.from_numpy(toks),
                                   torch.from_numpy(labels), e,
                                   label_mask=torch.from_numpy(mask))
            (g_pre,) = torch.autograd.grad(loss, (e,))
        return _sorted_leaves(g) + [g_pre]

    got = port(params, torch.float32)
    w64 = port(tree_map(lambda t: t.double(), params), torch.float64)
    for g, w, h in zip(got, jax.tree.leaves(want) + [want_pre], w64):
        w, h = np.asarray(w), h.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())
        ref_err = np.abs(w - h).max()
        assert np.abs(g.numpy() - h).max() <= \
            2 * ref_err + 1e-6 * np.abs(h).max()


def test_train_step_matches_jax(tiny):
    """One make_train_step with the prefix, as tests/test_models_smoke.py
    takes it on the reference (lr 1e-3, labels the tokens, mask ones):
    loss, grad_norm and lr. The new params are not compared element by
    element: Adam's first step is about lr * g / |g|, whose sign flips
    where g is near 0."""
    from repro.training import optimizer as jo
    from repro.training.train_loop import make_train_step as jax_step
    jcfg, cfg, jm, jparams, params = tiny
    toks = _tokens(6, (B, 16), cfg.vocab_size)
    mask = np.ones((B, 16), np.float32)
    pre = _prefix(cfg, params, 3, rows=4)
    _, _, jmet = jax_step(jm, jo.AdamWConfig(lr=1e-3))(
        jparams, jo.adamw_init(jparams), jnp.asarray(toks),
        jnp.asarray(toks), jnp.asarray(mask), embeds=jnp.asarray(pre))
    new_p, new_opt, met = make_train_step(LM(cfg), AdamWConfig(lr=1e-3))(
        params, adamw_init(params), torch.from_numpy(toks),
        torch.from_numpy(toks), torch.from_numpy(mask),
        embeds=torch.from_numpy(pre))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    assert float(met["loss"]) > 0 and int(new_opt["step"]) == 1
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new_p))


def test_prefill_then_serve_match_jax(tiny):
    """prefill_step over the prefix and T tokens (P + T + 8 slots), then 8
    greedy serve_step calls from position P + T, against the reference's
    steps; and the first step against a P + T + 1 prefill."""
    jcfg, cfg, _, jparams, params = tiny
    P = cfg.vision_prefix_len
    toks = _tokens(7, (3, T + 1), cfg.vocab_size)
    pre = _prefix(cfg, params, 4, batch=3)
    n = P + T + 8
    _, jpre = jax_prefill_step(jcfg, n)
    _, jserve = jax_serve_step(jcfg)
    jserve = jax.jit(jserve)
    jlogits, jcache = jax.jit(jpre)(jparams, jnp.asarray(toks[:, :T]),
                                    jnp.asarray(pre))
    _, pre_step = build_prefill_step(cfg, n)
    _, serve = build_serve_step(cfg)
    logits, cache = pre_step(params, torch.from_numpy(toks[:, :T]),
                             torch.from_numpy(pre))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    for a, b in zip(jax.tree.leaves(jcache), _sorted_leaves(cache)):
        assert tuple(b.shape) == a.shape and b.shape[2] == n
        _close_rel(b, a, 1e-4)
    # the decode continues the prefill: position P + T against a
    # P + T + 1 prefill with the same prefix
    step, _, _ = serve(params, cache, torch.from_numpy(toks[:, T]),
                       torch.full((3,), P + T, dtype=torch.int32))
    want, _ = build_prefill_step(cfg, n)[1](
        params, torch.from_numpy(toks), torch.from_numpy(pre))
    torch.testing.assert_close(step, want, atol=1e-4, rtol=0)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((3,), P + T + i, np.int32)
        jlogits, jtok, jcache = jserve(jparams, jcache, jtok,
                                       jnp.asarray(pos))
        logits, tok, cache = serve(params, cache, tok, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=5e-4, rtol=0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for a, b in zip(jax.tree.leaves(jcache), _sorted_leaves(cache)):
        _close_rel(b, a, 1e-4)


def test_gather_entry_points_take_embeds(tiny):
    """extend_step(tokens=None, embeds=(B, T, d)) over init_cache's zero
    caches, then decode_step(tokens=None, embeds=(B, d)): logits within
    1e-4, caches within 1e-4 of their largest magnitude."""
    jcfg, cfg, jm, jparams, params = tiny
    lm = LM(cfg)
    rows = _prefix(cfg, params, 5, rows=9)
    jcache = jm.init_cache(B, 32, dtype=jnp.float32)
    cache = lm.init_cache(B, 32, dtype=torch.float32, device="cpu")
    zero = np.zeros(B, np.int32)
    jl, jcache = jm.extend_step(jparams, None, jnp.asarray(zero), jcache,
                                embeds=jnp.asarray(rows[:, :8]))
    tl, cache = lm.extend_step(params, None, torch.from_numpy(zero), cache,
                               embeds=torch.from_numpy(rows[:, :8]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    pos = np.full(B, 8, np.int32)
    jl, jcache = jm.decode_step(jparams, None, jnp.asarray(pos), jcache,
                                embeds=jnp.asarray(rows[:, 8]))
    tl, cache = lm.decode_step(params, None, torch.from_numpy(pos), cache,
                               embeds=torch.from_numpy(rows[:, 8]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    for a, b in zip(jax.tree.leaves(jcache), _sorted_leaves(cache)):
        _close_rel(b, a, 1e-4)


def _pools(rng, jm, n_pages, page):
    shapes = jax.tree.map(lambda z: z.shape,
                          jm.init_cache(n_pages, page, dtype=jnp.float32))
    return jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(i, int) for i in x))


def _check_pools(j_pools, t_pools):
    for jl, tl in zip(jax.tree.leaves(j_pools), tree_leaves(t_pools)):
        _close_rel(tl, jl, 2e-5)


@pytest.mark.parametrize("entry", ["decode_step_paged", "extend_step_paged",
                                   "forward_mixed_paged"])
def test_paged_entry_points_take_embeds(tiny, entry):
    """The paged entry points with ``embeds=`` rows in place of token
    ids, over the same pools and block tables as the reference: logits
    within 1e-4 (ids equal), pools within 2e-5 of their largest
    magnitude."""
    jcfg, cfg, jm, jparams, params = tiny
    rng = np.random.default_rng(8)
    n_pages, page, max_pages = 48, 16, 8
    bt = rng.permutation(n_pages)[:4 * max_pages].reshape(
        4, max_pages).astype(np.int32)
    pools = _pools(rng, jm, n_pages, page)
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    jpools = jax.tree.map(jnp.asarray, pools)
    lm = LM(cfg)
    if entry == "decode_step_paged":
        rows = _prefix(cfg, params, 6, rows=1, batch=4)[:, 0]
        ctx = np.array([77, 16, 1, 0], np.int32)
        jl, jp = jm.decode_step_paged(jparams, None, jnp.asarray(ctx), jpools,
                                      jnp.asarray(bt), embeds=jnp.asarray(rows))
        tl, tp = lm.decode_step_paged(params, None, torch.from_numpy(ctx),
                                      t_pools, torch.from_numpy(bt),
                                      embeds=torch.from_numpy(rows))
        jl, tl = np.asarray(jl)[:3], tl[:3]
    elif entry == "extend_step_paged":
        rows = _prefix(cfg, params, 7, rows=8, batch=2)
        start, n_new = np.array([29, 0], np.int32), np.array([5, 8], np.int32)
        jl, jp = jm.extend_step_paged(
            jparams, None, jnp.asarray(start), jnp.asarray(n_new), jpools,
            jnp.asarray(bt[:2]), embeds=jnp.asarray(rows))
        tl, tp = lm.extend_step_paged(
            params, None, torch.from_numpy(start), torch.from_numpy(n_new),
            t_pools, torch.from_numpy(bt[:2]), embeds=torch.from_numpy(rows))
    else:
        tok_seq = np.array([0] * 6 + [1] * 5 + [2] + [0] * 4, np.int32)
        tok_pos = np.array(list(range(20, 26)) + list(range(5)) + [77]
                           + [-1] * 4, np.int32)
        q_last = np.array([5, 10, 11, 0], np.int32)
        rows = _prefix(cfg, params, 8, rows=len(tok_seq), batch=1)[0]
        args = (tok_seq, tok_pos, q_last)
        j_ids, jl, jp = jm.forward_mixed_paged(
            jparams, None, *map(jnp.asarray, args), jpools, jnp.asarray(bt),
            embeds=jnp.asarray(rows))
        t_ids, tl, tp = lm.forward_mixed_paged(
            params, None, *map(torch.from_numpy, args), t_pools,
            torch.from_numpy(bt), embeds=torch.from_numpy(rows))
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert tp is t_pools                           # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    _check_pools(jp, t_pools)


# ---------------------------------------------------------------------------
# chip_smoke.py's pixtral phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_pixtral_rehearsals():
    """pixtral_parity and pixtral_serve at the tiny config on the CPU (the
    prefix the config's 16 rows): the same control flow, checks and
    launch-count reads as on the card (no kernel launches here); the
    recorder keeps the first prefill call's q, k and v, P + T rows each;
    one prefill launches flash once a layer."""
    cs = _chip_smoke()
    assert cs.prefill_launches(get_config("pixtral-12b")) == {
        "flash_attention": 40}
    assert "flash_attention_pixtral" in cs.PREFIX_SHARED_KERNELS
    cs.check_prefill_parity("pixtral_parity", tiny=True, device="cpu",
                            seq=24)
    rec = cs.FlashRecorder()
    res = cs.model_serve("pixtral_serve", rec, tiny=True, device="cpu",
                         batch=2, seq=24, steps=4, profile=True)
    assert res["finite"] and res["prefix"] == 16
    assert res["expected_launches"] == {"flash_attention": 2}
    assert all(v == 0 for v in res["launches"].values())
    q, k, v, kw = rec.args
    assert q.shape == (2, 2, 4, 40, 32) and k.shape == (2, 2, 40, 32)
