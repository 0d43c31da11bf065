"""musicgen's codebooks in the port, against the JAX reference on tiny
musicgen-large (K 4 codebooks, an ungated GELU FFN) with the reference's
seed-0 float32 init bridged in, on the CPU.

* The parameter tree: "embed" (K, V, d) and "lm_head" (K, d, V), the
  port's own init with the reference's leaves and shapes; the bridge's
  checks; ``cast_params`` with no codebook case.
* ``LM.forward`` hidden states and ``LM.logits`` (B, T, K, V) of the
  whole sequence within 2e-4, as tests/test_torch_gemma2.py and
  test_torch_moe.py hold them (1.79e-4 and 1.88e-4 measured: under the
  reference's init the attention outputs reach ~189, and the port's
  attention sums its float32 products in another order than XLA's; the
  codebook embedding itself is exact); ``LM.loss`` with and without a
  mask within 1e-5. Gradients: the reference's own float32 gradient lies
  up to 3.4e-4 of a leaf's largest magnitude from the float64 one
  (measured: the embedding tables, wq, norm1), so, as
  tests/test_torch_training.py's hard-max case does, each leaf is held
  within 1e-3 of its magnitude of the reference's, and within 1e-4 of it
  of the float64 gradient or no farther from it than twice the
  reference.
* ``prefill_step`` over (B, T, K) tokens, then 8 greedy ``serve_step``
  calls on (B, K) ids: logits within 1e-4 and 5e-4, ids equal, caches
  within 1e-4 of their largest magnitude.
* ``extend_step`` then ``decode_step`` over slotted caches, and the three
  paged entry points over the same pools and block tables (greedy and
  sampled rows of ``forward_mixed_paged`` from the last codebook's
  logits): logits within 1e-4, pools within 2e-5 of their largest
  magnitude (tests/test_torch_model.py's tolerances).
* The engine against the JAX engine under InferCept and swap x fused,
  per-call and int8 pools (streams, counters with ``logit_bytes``,
  scheduler stats, ledger causes, clock, free pages); gather == fused ==
  unfused inside the port (DESIGN.md §6).
* ``chip_smoke.py``'s musicgen phases rehearsed at the tiny config.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models.bridge import cast_params, from_jax_params
from repro_torch.models.model import LM
from repro_torch.serving.engine import Engine
from repro_torch.training.train_loop import loss_and_grads
from repro_torch.utils.tree import tree_leaves, tree_map
from wide_models import (chip_smoke, engine_matches_jax, paths_agree,
                         port_run, tiny_model)
from wide_models import one_torch_thread  # noqa: F401 (autouse fixture)

NAME = "musicgen-large"
B, T = 2, 24


@pytest.fixture(scope="module")
def model():
    return tiny_model(NAME)


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _paths(tree, prefix=()):
    """{path: leaf} of a nested dict / tuple tree (either package's)."""
    if isinstance(tree, dict):
        return {p: x for k in tree for p, x in _paths(tree[k],
                                                      prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _paths(v, prefix + (i,)).items()}
    return {prefix: tree}


def _close_rel(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _close_trees(tree, jtree, rel):
    want, got = _paths(jtree), _paths(tree)
    assert want.keys() == got.keys()
    for p, w in want.items():
        assert tuple(got[p].shape) == tuple(np.shape(w)), p
        _close_rel(got[p], w, rel)


# ---------------------------------------------------------------------------
# the parameter tree and the bridge
# ---------------------------------------------------------------------------
def test_config_builds_with_codebook_tables():
    cfg = get_config(NAME)
    assert (cfg.n_codebooks, cfg.n_layers, cfg.d_model) == (4, 48, 2048)
    lm = LM(cfg)                                    # builds at full width
    assert lm.cfg is cfg


def test_param_tree_matches_jax(model):
    """The bridged tree keeps the reference's values; the port's own init
    has the same paths and shapes."""
    jcfg, cfg, _, jparams, params = model
    K, V, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    assert tuple(params["embed"].shape) == (K, V, d)
    assert tuple(params["lm_head"].shape) == (K, d, V)
    want = _paths(jax.tree.map(np.asarray, jparams))
    got = _paths(params)
    assert want.keys() == got.keys()
    for p, w in want.items():
        np.testing.assert_array_equal(got[p].numpy(), w)
    own = _paths(LM(cfg).init(torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu"))
    assert {p: tuple(t.shape) for p, t in own.items()} == \
        {p: tuple(np.shape(w)) for p, w in want.items()}


def test_bridge_checks_the_codebook_axes(model):
    jcfg, cfg, _, jparams, _ = model
    np_tree = jax.tree.map(np.asarray, jparams)
    flat = dict(np_tree, embed=np_tree["embed"][0])       # (V, d)
    with pytest.raises(ValueError, match="embed"):
        from_jax_params(flat, cfg)
    head = dict(np_tree, lm_head=np_tree["lm_head"][0])   # (d, V)
    with pytest.raises(ValueError, match="lm_head"):
        from_jax_params(head, cfg)
    with pytest.raises(ValueError, match="embed"):        # a text config
        from_jax_params(np_tree, get_config("llama3.2-1b", tiny=True))


def test_cast_params_needs_no_codebook_case(model):
    """The codebook tables and heads are leaves like any other: a bf16
    cast keeps their shapes and casts every leaf."""
    _, cfg, _, _, params = model
    out = cast_params(params, cfg, torch.bfloat16)
    assert {p: tuple(t.shape) for p, t in _paths(out).items()} == \
        {p: tuple(t.shape) for p, t in _paths(params).items()}
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(out))
    assert torch.equal(out["embed"], params["embed"].bfloat16())


def test_embed_sums_the_tables(model):
    _, cfg, _, _, params = model
    toks = torch.from_numpy(_ids(0, (B, T, cfg.n_codebooks),
                                 cfg.vocab_size))
    x = LM(cfg).embed(params, toks)
    want = sum(params["embed"][k][toks[..., k].long()]
               for k in range(cfg.n_codebooks))
    assert x.shape == (B, T, cfg.d_model)
    torch.testing.assert_close(x, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# forward, logits, loss, gradients
# ---------------------------------------------------------------------------
def test_forward_and_logits_match_jax(model):
    jcfg, cfg, jm, jparams, params = model
    toks = _ids(1, (B, T, cfg.n_codebooks), cfg.vocab_size)
    want = jm.forward(jparams, jnp.asarray(toks)).hidden
    lm = LM(cfg)
    np.testing.assert_array_equal(
        lm.embed(params, torch.from_numpy(toks)).numpy(),
        np.asarray(jm.embed(jparams, jnp.asarray(toks))))
    got = lm.forward(params, torch.from_numpy(toks)).hidden
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    jl = jm.logits(jparams, want)
    tl = lm.logits(params, got)
    assert tl.shape == (B, T, cfg.n_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_jax(model, masked):
    """The CE over the T x K (position, codebook) pairs, each mask entry
    repeated over its position's K."""
    jcfg, cfg, jm, jparams, params = model
    K = cfg.n_codebooks
    toks = _ids(2, (B, T, K), cfg.vocab_size)
    labels = _ids(3, (B, T, K), cfg.vocab_size)
    mask = (np.random.default_rng(4).random((B, T)) > 0.3).astype(
        np.float32) if masked else None
    jloss, jaux = jm.loss(jparams, jnp.asarray(toks), jnp.asarray(labels),
                          label_mask=None if mask is None
                          else jnp.asarray(mask))
    lm = LM(cfg)
    for remat in (False, True):
        loss, aux = lm.loss(params, torch.from_numpy(toks),
                            torch.from_numpy(labels),
                            label_mask=None if mask is None
                            else torch.from_numpy(mask), remat=remat)
        assert abs(float(loss) - float(jloss)) <= 1e-5
        assert abs(float(aux["ce"]) - float(jaux["ce"])) <= 1e-5
    if masked:
        # the masked mean by hand: positions whose mask is 0 drop all K
        lg = lm.logits(params, lm.forward(params,
                                          torch.from_numpy(toks)).hidden)
        nll = torch.logsumexp(lg, -1) - lg.gather(
            -1, torch.from_numpy(labels)[..., None].long())[..., 0]
        m = torch.from_numpy(mask)[..., None].expand(B, T, K)
        assert abs(float((nll * m).sum() / m.sum()) - float(loss)) <= 1e-5


@pytest.mark.parametrize("remat", [True, False])
def test_gradients_match_jax_grad(model, remat):
    jcfg, cfg, jm, jparams, params = model
    K = cfg.n_codebooks
    toks = _ids(5, (B, T, K), cfg.vocab_size)
    labels = _ids(6, (B, T, K), cfg.vocab_size)
    mask = (np.random.default_rng(7).random((B, T)) > 0.2).astype(
        np.float32)
    want = jax.grad(lambda p: jm.loss(
        p, jnp.asarray(toks), jnp.asarray(labels),
        label_mask=jnp.asarray(mask), remat=remat)[0])(jparams)
    args = (torch.from_numpy(toks), torch.from_numpy(labels),
            torch.from_numpy(mask))
    _, _, grads = loss_and_grads(LM(cfg), params, *args, remat=remat)
    _close_trees(grads, want, 1e-3)
    _, _, g64 = loss_and_grads(LM(cfg), tree_map(lambda t: t.double(),
                                                 params), *args, remat=remat)
    want, got, g64 = _paths(want), _paths(grads), _paths(g64)
    for p, w in want.items():
        h = g64[p].numpy()
        ref_err = np.abs(np.asarray(w) - h).max()
        assert np.abs(got[p].numpy() - h).max() <= max(
            1e-4 * np.abs(h).max(), 2 * ref_err), p


# ---------------------------------------------------------------------------
# launch/steps.py and the gather path
# ---------------------------------------------------------------------------
def test_prefill_then_serve_match_jax(model):
    """prefill_step over (3, T, K) tokens (T + 8 slots), then 8 greedy
    serve_step calls on the (3, K) ids each step's argmax gives."""
    jcfg, cfg, _, jparams, params = model
    K = cfg.n_codebooks
    toks = _ids(8, (3, T, K), cfg.vocab_size)
    n = T + 8
    _, jpre = jax_prefill_step(jcfg, n)
    _, jserve = jax_serve_step(jcfg)
    jserve = jax.jit(jserve)
    jlogits, jcache = jax.jit(jpre)(jparams, jnp.asarray(toks))
    _, pre_step = build_prefill_step(cfg, n)
    _, serve = build_serve_step(cfg)
    logits, cache = pre_step(params, torch.from_numpy(toks))
    assert logits.shape == (3, K, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    _close_trees(cache, jcache, 1e-4)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(8):
        assert tok.shape == (3, K) and tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((3,), T + i, np.int32)
        jlogits, jtok, jcache = jserve(jparams, jcache, jtok,
                                       jnp.asarray(pos))
        logits, tok, cache = serve(params, cache, tok, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=5e-4, rtol=0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _close_trees(cache, jcache, 1e-4)


def test_extend_then_decode_match_jax(model):
    """extend_step of (B, 9, K) tokens over init_cache's zero caches, then
    decode_step of (B, K) ids at position 9."""
    jcfg, cfg, jm, jparams, params = model
    K = cfg.n_codebooks
    lm = LM(cfg)
    toks = _ids(9, (B, 10, K), cfg.vocab_size)
    jcache = jm.init_cache(B, 32, dtype=jnp.float32)
    cache = lm.init_cache(B, 32, dtype=torch.float32, device="cpu")
    zero = np.zeros(B, np.int32)
    jl, jcache = jm.extend_step(jparams, jnp.asarray(toks[:, :9]),
                                jnp.asarray(zero), jcache)
    tl, cache = lm.extend_step(params, torch.from_numpy(toks[:, :9]),
                               torch.from_numpy(zero), cache)
    assert tl.shape == (B, K, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    pos = np.full(B, 9, np.int32)
    jl, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, 9]),
                                jnp.asarray(pos), jcache)
    tl, cache = lm.decode_step(params, torch.from_numpy(toks[:, 9]),
                               torch.from_numpy(pos), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    _close_trees(cache, jcache, 1e-4)


# ---------------------------------------------------------------------------
# the paged entry points
# ---------------------------------------------------------------------------
def _pools(rng, jm, n_pages, page):
    shapes = jax.tree.map(lambda z: z.shape,
                          jm.init_cache(n_pages, page, dtype=jnp.float32))
    return jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(i, int) for i in x))


SAMPLING = (np.array([0.0, 0.7, 1.3, 0.0], np.float32),
            np.array([0, 5, 0, 0], np.int32),
            np.array([1.0, 0.9, 0.3, 1.0], np.float32),
            np.array([3, -7, 2**31 - 1, 0], np.int32))


@pytest.mark.parametrize("entry", ["decode_step_paged", "extend_step_paged",
                                   "forward_mixed_paged",
                                   "forward_mixed_paged_sampled"])
def test_paged_entry_points_match_jax(model, entry):
    """Each paged entry point on K independent ids a token over the same
    pools and block tables as the reference: (.., K, V) logits within
    1e-4, pools within 2e-5 of their largest magnitude; the fused
    iteration's greedy and sampled ids (from the last codebook's row)
    equal."""
    jcfg, cfg, jm, jparams, params = model
    K, V = cfg.n_codebooks, cfg.vocab_size
    rng = np.random.default_rng(10)
    n_pages, page, max_pages = 48, 16, 8
    bt = rng.permutation(n_pages)[:4 * max_pages].reshape(
        4, max_pages).astype(np.int32)
    pools = _pools(rng, jm, n_pages, page)
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    jpools = jax.tree.map(jnp.asarray, pools)
    lm = LM(cfg)
    if entry == "decode_step_paged":
        toks = _ids(11, (4, K), V)
        ctx = np.array([77, 16, 1, 0], np.int32)
        jl, jp = jm.decode_step_paged(jparams, jnp.asarray(toks),
                                      jnp.asarray(ctx), jpools,
                                      jnp.asarray(bt))
        tl, tp = lm.decode_step_paged(params, torch.from_numpy(toks),
                                      torch.from_numpy(ctx), t_pools,
                                      torch.from_numpy(bt))
        jl, tl = np.asarray(jl)[:3], tl[:3]
    elif entry == "extend_step_paged":
        toks = _ids(12, (2, 8, K), V)
        start, n_new = np.array([29, 0], np.int32), np.array([5, 8], np.int32)
        jl, jp = jm.extend_step_paged(
            jparams, jnp.asarray(toks), jnp.asarray(start),
            jnp.asarray(n_new), jpools, jnp.asarray(bt[:2]))
        tl, tp = lm.extend_step_paged(
            params, torch.from_numpy(toks), torch.from_numpy(start),
            torch.from_numpy(n_new), t_pools, torch.from_numpy(bt[:2]))
    else:
        tok_seq = np.array([0] * 6 + [1] * 5 + [2] + [0] * 4, np.int32)
        tok_pos = np.array(list(range(20, 26)) + list(range(5)) + [77]
                           + [-1] * 4, np.int32)
        q_last = np.array([5, 10, 11, 0], np.int32)
        toks = _ids(13, (len(tok_seq), K), V)
        args = (toks, tok_seq, tok_pos, q_last)
        samp = SAMPLING if entry.endswith("sampled") else None
        j_ids, jl, jp = jm.forward_mixed_paged(
            jparams, *map(jnp.asarray, args), jpools, jnp.asarray(bt),
            None if samp is None else tuple(map(jnp.asarray, samp)))
        t_ids, tl, tp = lm.forward_mixed_paged(
            params, *map(torch.from_numpy, args), t_pools,
            torch.from_numpy(bt),
            None if samp is None else tuple(map(torch.from_numpy, samp)))
        assert t_ids.shape == (4,) and t_ids.dtype == torch.int32
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        # a greedy row is the argmax of its last codebook's logits
        last = tl[:, -1].argmax(-1)
        assert t_ids[0] == last[0] and t_ids[3] == last[3]
        if samp is None:
            assert torch.equal(t_ids.long(), last)
    assert tp is t_pools                           # written in place
    assert tuple(tl.shape[-2:]) == (K, V)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(t_pools)):
        _close_rel(b, a, 2e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
PATHS = {"fused": {}, "unfused": {"fused": False},
         "int8": {"kv_dtype": "int8"}}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("policy", ["infercept", "swap"])
def test_engine_matches_jax(model, policy, path):
    jcfg, cfg, _, _, params = model
    assert engine_matches_jax(jcfg, cfg, params, policy, **PATHS[path])


@pytest.mark.parametrize("policy", ["infercept", "swap"])
def test_paths_agree(model, policy):
    """DESIGN.md §6 inside the port on the codebook model: the gather,
    fused and unfused paths emit the same streams."""
    _, cfg, _, _, params = model
    oracle, _, _ = port_run(cfg, params, policy)
    paths_agree(oracle, cfg, params, policy)


def test_engine_feeds_codebooks_as_a_view(model):
    """The engine broadcasts each id over the K codebooks as a stride-0
    view of the ids it uploaded, and samples from the last codebook's
    row; a text model's ids pass as they are."""
    _, cfg, _, _, params = model
    eng = Engine(cfg, POLICIES["infercept"], params=params, device="cpu",
                 page_size=16, n_pages=16, max_model_len=64)
    ids = torch.arange(5, dtype=torch.int32)
    fed = eng._feed(ids)
    assert fed.shape == (5, cfg.n_codebooks) and fed.stride() == (1, 0)
    assert fed.data_ptr() == ids.data_ptr()
    row = np.arange(cfg.n_codebooks * cfg.vocab_size, dtype=np.float32)
    np.testing.assert_array_equal(
        eng._last_book(row.reshape(cfg.n_codebooks, -1)),
        row[-cfg.vocab_size:])
    text = get_config("llama3.2-1b", tiny=True)
    eng = Engine(text, POLICIES["infercept"], device="cpu", page_size=16,
                 n_pages=16, max_model_len=64)
    assert eng._feed(ids) is ids


# ---------------------------------------------------------------------------
# chip_smoke.py's musicgen phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_musicgen_rehearsals():
    """musicgen_parity at the tiny config on the CPU (its checks as on the
    card: the legs at decode_parity's conditioned float32 tolerances, and
    the plain versions against themselves where the card holds the
    kernels), and musicgen_serve and musicgen_unfused with their
    recorder: the same control flow, checks and launch-count reads as on
    the card (no kernel launches here); the recorder keeps the largest
    pack's pool leaves as meta shapes, and row 1g is a kernels-line
    row."""
    cs = chip_smoke()
    r = cs.check_musicgen_parity(tiny=True, device="cpu",
                                 lens=[37, 60, 50, 16])
    K, V = get_config(NAME, tiny=True).n_codebooks, 256
    assert tuple(r["outputs"]["fused"].shape) == (4, K, V)
    assert "ragged_paged_attention_musicgen" in cs.ROWS
    rec = cs.MusicgenRecorder()
    for phase in cs.MUSICGEN_SERVE_PHASES:
        res = cs.musicgen_serve(phase, rec if phase == "musicgen_serve"
                                else None, tiny=True, device="cpu")
        assert res["finished"] == res["requests"]
        assert res["swapped_in_tokens"] == res["swapped_out_tokens"]
        assert res["free_pages"] == res["n_pages"] - 1
        assert all(v == 0 for v in res["launches"].values())
        assert set(res["decisions"]) == {"preserves", "discards", "swaps",
                                         "recompute_tokens"}
        cs.log_scheduler(res, res)
    q = rec.call("ragged_paged_attention", device="cpu")[0][0]
    assert q.shape[1:] == (4, 1, 64)            # tiny: 4 kv heads x G 1
    if "swap_pack" in rec.calls:
        assert all(leaf.device.type == "meta"
                   for leaf in rec.calls["swap_pack"][1][0])
