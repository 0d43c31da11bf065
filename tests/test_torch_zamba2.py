"""The port's zamba2 path (mamba2 blocks and one shared attention block
that every occurrence reads) against the JAX reference, on bridged
weights and the same token ids, in float32 on the CPU: tiny zamba2-1.2b
(one period of a mamba2 and the shared block) and the same config
widened to three periods, so the shared block serves three times.

* The parameter tree: the shared block once under "shared", no period
  entry for it; the port's own init has the reference's leaves.
* ``LM.forward``'s hidden states within 1e-4 of their largest magnitude,
  ``LM.loss`` within 1e-5, with and without remat.
* The three-period model on the reference's init with its attention
  projections conditioned for soft attention (``_model``), the same
  weights in both packages; the one-period model on the raw init.
* Every gradient leaf, the shared block's (the sum over its occurrences)
  among them, within 1e-4 of its leaf's largest magnitude of
  ``jax.grad``'s at T 8; at T 40 the reference's own float32 gradient of
  the three-period model is NaN, and the port's finite.
* ``prefill_step``: logits within 1e-4 and every cache leaf (mamba2
  states, each occurrence's K/V) within 1e-4 of its largest magnitude;
  8 greedy ``serve_step`` calls: tokens equal, logits within 5e-4 (the
  tolerances of ``tests/test_torch_ssm_model.py``).
* ``extend_step`` then ``decode_step`` on ``init_cache``'s zero caches.
* ``cast_params``: bf16 everywhere but mamba2's float32 leaves.
* Refusals: the engine (the reference's assertion) and the paged paths
  (on the mamba2 blocks).
* ``chip_smoke.py``'s zamba2 phases rehearsed at the tiny config.
"""
import dataclasses
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
from repro_torch.core import POLICIES
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import blocks as B
from repro_torch.models.bridge import cast_params, from_jax_params
from repro_torch.models.model import LM
from repro_torch.models.ssm import FLOAT32_PARAMS
from repro_torch.serving.engine import Engine
from repro_torch.training.train_loop import loss_and_grads

ROOT = Path(__file__).resolve().parents[1]
PERIODS = [1, 3]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _widened(cfg, n_periods):
    """``cfg`` (either package's) with its one group at ``n_periods``."""
    if n_periods == cfg.groups[0].n_periods:
        return cfg
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-x{n_periods}",
        groups=(dataclasses.replace(cfg.groups[0], n_periods=n_periods),))


_BUILT = {}


def _model(n_periods, conditioned=None):
    """(jcfg, cfg, jm, jparams, params): the reference's seed-0 init in
    float32, bridged. ``conditioned`` (by default where the shared block
    serves more than once) rescales the attention projections, in both
    trees alike, to a fan-in over d_model (``chip_smoke.condition_attention``):
    on the raw init the three-period model's shared attention is a hard
    max over a residual stream of ~430, and float32 rounding in either
    package flips its near-ties, which parts the two packages by up to
    3.1x the tolerances below (and the reference from a float64 run of
    itself by up to 3.2x); conditioned, the port lands within 0.17x of
    them."""
    if conditioned is None:
        conditioned = n_periods > 1
    key = (n_periods, conditioned)
    if key not in _BUILT:
        jcfg = _widened(jax_config("zamba2-1.2b", tiny=True), n_periods)
        cfg = _widened(get_config("zamba2-1.2b", tiny=True), n_periods)
        jm = JaxLM(jcfg)
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0),
                                              dtype=jnp.float32))
        if conditioned:
            _chip_smoke().condition_attention(tree)
        params = from_jax_params(tree, cfg)
        _BUILT[key] = (jcfg, cfg, jm, jax.tree.map(jnp.asarray, tree),
                       params)
    return _BUILT[key]


@pytest.fixture(scope="module", params=PERIODS, ids=lambda n: f"periods{n}")
def model(request):
    return _model(request.param)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _sorted_leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def _close_rel(got, want, rel):
    """``got`` (the port) within ``rel`` of ``want``'s (the reference's)
    largest magnitude."""
    got, want = _np(got), _np(want).astype(np.float32).astype(np.float64)
    atol = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= atol, (err, atol)


def _assert_tree_close(tree, jtree, rel):
    jl, tl = jax.tree.leaves(jtree), _sorted_leaves(tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        _close_rel(b, a, rel)


def test_config_has_one_shared_block():
    cfg = get_config("zamba2-1.2b")
    kinds = [(b.kind, g.n_periods) for g in cfg.groups for b in g.period]
    assert sum(n for k, n in kinds if k == "shared_attn") == 6
    assert sum(n for k, n in kinds if k == "mamba2") == 32
    LM(cfg)                                       # builds


def test_param_tree_matches_jax(model):
    """The bridged tree keeps "shared" and has no period entry for the
    shared block; the port's own init has the same leaves, shapes and
    order as the reference's (JAX's sorted keys)."""
    jcfg, cfg, jm, jparams, params = model
    assert "shared" in params and sorted(params["shared"]) == \
        sorted(jparams["shared"])
    assert sorted(params["groups"][0]["scan"]) == ["b0"]
    own = LM(cfg).init(torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    assert list(own)[:3] == ["embed", "final_norm", "shared"]
    jl = jax.tree.leaves(jparams)
    tl = _sorted_leaves(own)
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]


def test_forward_hidden_and_loss_match_jax(model):
    jcfg, cfg, jm, jparams, params = model
    toks = _tokens(0, (2, 70), cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    want = jm.forward(jparams, jnp.asarray(toks)).hidden
    lm = LM(cfg)
    got = lm.forward(params, torch.from_numpy(toks)).hidden
    _close_rel(got, want, 1e-4)
    jloss, _ = jm.loss(jparams, jnp.asarray(toks), jnp.asarray(labels))
    for remat in (False, True):
        loss, aux = lm.loss(params, torch.from_numpy(toks),
                            torch.from_numpy(labels), remat=remat)
        assert abs(float(loss) - float(jloss)) <= 1e-5
        assert float(aux["aux"]) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax(model, remat):
    """Every leaf's gradient against ``jax.grad`` of the reference's loss
    within 1e-4 of the leaf's largest magnitude, the shared block's (which
    every occurrence reads, and which remat passes to each period's
    checkpoint as an input) summed over its occurrences as the reference's
    closure sums it. T 8: on the raw init the three-period model's
    gradients grow with T (the embedding's largest entry 3.6 at T 8, 26.6
    at T 32), float32 rounding in either package moves them apart by up to
    2.2e-3 of a leaf's magnitude at T 16, and at T 40 the reference's own
    is NaN (``test_reference_gradient_nan_at_t40``)."""
    jcfg, cfg, jm, jparams, params = model
    rng = np.random.default_rng(1)
    toks = _tokens(1, (2, 8), cfg.vocab_size)
    labels = _tokens(2, (2, 8), cfg.vocab_size)
    mask = (rng.random((2, 8)) > 0.2).astype(np.float32)
    jloss, want = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(toks), jnp.asarray(labels),
        label_mask=jnp.asarray(mask))[0])(jparams)
    loss, _, grads = loss_and_grads(
        LM(cfg), params, *(torch.from_numpy(a) for a in (toks, labels, mask)),
        remat=remat)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    _assert_tree_close(grads, want, 1e-4)
    g_shared = grads["shared"]["attn"]["wq"]
    assert g_shared.shape == params["shared"]["attn"]["wq"].shape
    assert float(g_shared.abs().max()) > 0


def test_reference_gradient_nan_at_t40():
    """The reference's float32 gradient of the three-period model at T 40
    is NaN: its chunked_gla takes exp(lb_i - lb_j) over the whole chunk
    and masks after the exp, so above the diagonal the exp overflows and
    the mask's gradient, 0 x inf, is NaN. The port forms the decay under
    the mask (``kernels.gla_scan.chunked_gla_ref``): its gradient is
    finite and the two losses agree."""
    jcfg, cfg, jm, jparams, params = _model(3, conditioned=False)
    toks = _tokens(1, (2, 40), cfg.vocab_size)
    labels = _tokens(2, (2, 40), cfg.vocab_size)
    jloss, want = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(toks), jnp.asarray(labels))[0])(jparams)
    assert not np.isfinite(np.asarray(want["shared"]["attn"]["wq"])).all()
    loss, _, grads = loss_and_grads(
        LM(cfg), params, torch.from_numpy(toks), torch.from_numpy(labels),
        torch.ones((2, 40)))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert all(bool(torch.isfinite(g).all()) for g in _sorted_leaves(grads))


@pytest.mark.parametrize("T", [100, 37])
def test_prefill_step_matches_jax(model, T):
    jcfg, cfg, _, jparams, params = model
    toks = _tokens(T, (2, T), cfg.vocab_size)
    _, jstep = jax_prefill_step(jcfg, T + 8)
    jlogits, jcache = jax.jit(jstep)(jparams, jnp.asarray(toks))
    _, step = build_prefill_step(cfg, T + 8)
    logits, cache = step(params, torch.from_numpy(toks))
    _close_rel(logits, jlogits, 1e-4 / np.abs(np.asarray(jlogits)).max())
    # the shared block's occurrences keep their own caches, stacked over
    # the periods
    k = cache[0]["b1"]["k"]
    assert k.shape[:3] == (cfg.groups[0].n_periods, 2, T + 8)
    _assert_tree_close(cache, jcache, 1e-4)


def test_serve_steps_match_jax(model):
    """8 greedy serve_step calls after a prefill, each fed the previous
    argmax: the tokens equal, the logits within 5e-4, and the final
    cache within 1e-4 of each leaf's magnitude."""
    jcfg, cfg, _, jparams, params = model
    T = 37
    toks = _tokens(2, (3, T), cfg.vocab_size)
    _, jpre = jax_prefill_step(jcfg, T + 8)
    _, jserve = jax_serve_step(jcfg)
    jserve = jax.jit(jserve)
    jlogits, jcache = jax.jit(jpre)(jparams, jnp.asarray(toks))
    _, pre = build_prefill_step(cfg, T + 8)
    _, serve = build_serve_step(cfg)
    logits, cache = pre(params, torch.from_numpy(toks))
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((3,), T + i, np.int32)
        jlogits, jtok, jcache = jserve(jparams, jcache, jtok,
                                       jnp.asarray(pos))
        logits, tok, cache = serve(params, cache, tok, torch.from_numpy(pos))
        _close_rel(logits, jlogits, 5e-4 / np.abs(np.asarray(jlogits)).max())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _assert_tree_close(cache, jcache, 1e-4)


def test_extend_then_decode_match_jax(model):
    """init_cache's zero caches, two chunks through extend_step (from 0,
    then from 11 with the logits at each row's own index), then a
    decode_step: logits within 1e-4 and every cache leaf within 1e-4 of
    its largest magnitude, at each call."""
    jcfg, cfg, jm, jparams, params = model
    lm = LM(cfg)
    jcache = jm.init_cache(2, 32, dtype=jnp.float32)
    cache = lm.init_cache(2, 32, dtype=torch.float32, device="cpu")
    _assert_tree_close(cache, jcache, 0)
    a, b = _tokens(5, (2, 11), cfg.vocab_size), _tokens(6, (2, 7),
                                                         cfg.vocab_size)
    zero, eleven = np.zeros(2, np.int32), np.full(2, 11, np.int32)
    li = np.array([6, 3], np.int32)
    jl, jcache = jm.extend_step(jparams, jnp.asarray(a), jnp.asarray(zero),
                                jcache)
    tl, cache = lm.extend_step(params, torch.from_numpy(a),
                               torch.from_numpy(zero), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    jl, jcache = jm.extend_step(jparams, jnp.asarray(b),
                                jnp.asarray(eleven), jcache,
                                logits_index=jnp.asarray(li))
    tl, cache = lm.extend_step(params, torch.from_numpy(b),
                               torch.from_numpy(eleven), cache,
                               logits_index=torch.from_numpy(li))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    _assert_tree_close(cache, jcache, 1e-4)
    tok = _tokens(7, (2,), cfg.vocab_size)
    pos = np.full(2, 18, np.int32)
    jl, jcache = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos),
                                jcache)
    tl, cache = lm.decode_step(params, torch.from_numpy(tok),
                               torch.from_numpy(pos), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    _assert_tree_close(cache, jcache, 1e-4)


def test_cast_params_keeps_mamba2_float32_leaves(model):
    """``dtype=bfloat16``: the shared block cast whole (it has no float32
    leaf), mamba2's float32 leaves kept float32 with their values; the
    dtypes equal the reference's bf16 init, leaf by leaf."""
    jcfg, cfg, jm, jparams, params = model
    p = cast_params(params, cfg, torch.bfloat16)
    assert {t.dtype for t in _sorted_leaves(p["shared"])} == \
        {torch.bfloat16}
    cell = p["groups"][0]["scan"]["b0"]["cell"]
    for name in FLOAT32_PARAMS["mamba2"]:
        assert cell[name].dtype == torch.float32
        assert torch.equal(cell[name],
                           params["groups"][0]["scan"]["b0"]["cell"][name])
    j16 = jm.init(jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    p16 = from_jax_params(jax.tree.map(np.asarray, j16), cfg,
                          dtype=torch.bfloat16)
    own = LM(cfg).init(torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    jl = jax.tree.leaves(j16)
    for tree in (p16, own):
        tl = _sorted_leaves(tree)
        assert [str(a.dtype) for a in jl] == [str(b.dtype)[6:] for b in tl]


def test_engine_and_paged_paths_refuse_zamba2(model):
    _, cfg, _, _, params = model
    with pytest.raises(AssertionError, match="attention-cache"):
        Engine(cfg, POLICIES["infercept"], params=params, device="cpu")
    blk = cfg.groups[0].period[0]
    assert blk.kind == "mamba2"
    x = torch.zeros((2, cfg.d_model))
    for fn in (B.block_mixed_paged, B.block_decode_paged,
               B.block_extend_paged):
        with pytest.raises(ValueError, match="attention blocks, got mamba2"):
            fn(params, cfg, blk, x, {}, {})


# ---------------------------------------------------------------------------
# chip_smoke.py's zamba2 phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_zamba2_rehearsals():
    """zamba2_parity and zamba2_serve at the tiny config on the CPU: the
    same control flow, checks and launch-count reads as on the card (no
    kernel launches here); one prefill launches gla_scan once per mamba2
    layer and flash once per occurrence of the shared block; the recorder
    keeps the first mamba2 call's q and k on the host as one slice over
    the heads and gives them back as views of stride 0 over the heads,
    and row 8z's bound reads them once."""
    cs = _chip_smoke()
    assert cs.prefill_launches(get_config("zamba2-1.2b")) == {
        "gla_scan": 32, "flash_attention": 6}
    assert "gla_scan_zamba2" in cs.PREFIX_SHARED_KERNELS
    cs.check_prefill_parity("zamba2_parity", tiny=True, device="cpu",
                            seq=70)
    rec = cs.GLARecorder()
    res = cs.model_serve("zamba2_serve", rec, tiny=True, device="cpu",
                         batch=2, seq=90, steps=4, profile=True)
    assert res["finite"] and res["max_memory_allocated"] is None
    assert res["expected_launches"] == {"gla_scan": 1, "flash_attention": 1}
    assert all(v == 0 for v in res["launches"].values())
    assert set(res["stamps"]) >= {"construction", "warm_up", "prefill",
                                  "steps", "profiled_prefill"}
    kept, shape, _ = rec.args[0]
    assert kept.shape == (2, 1, 90, 16) and shape == (2, 2, 90, 16)
    q, k, v, la, kw = rec.operands()
    assert q.shape == (2, 2, 90, 16) and q.stride(1) == 0
    assert cs.stored_bytes(q) * 2 == q.numel() * q.element_size()
    assert v.shape == (2, 2, 90, 256) and kw["chunk"] == 256
