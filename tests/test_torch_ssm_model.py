"""The port's SSM model path on tiny xlstm-350m (one period: an mLSTM and
an sLSTM block) against the JAX reference, on bridged weights and the
same token ids, in float32 on the CPU.

* ``LM.forward``'s hidden states within 1e-5 of their largest magnitude
  and ``LM.loss`` within 1e-5 (float32 sums in another order).
* ``build_prefill_step``: logits within 1e-4 and every cache leaf within
  1e-5 of its largest magnitude, at T off the chunk, on it and below it.
* ``build_serve_step``: 8 greedy tokens equal and logits within 5e-4
  (the tolerance of ``tests/test_consistency.py``); decode at position T
  after a T-prefill equals the last logits of a T+1 prefill within 1e-4.
* ``init_cache(batch, cache_len)`` equals the reference's zero states;
  ``from_jax_params(dtype=bfloat16)`` and the port's own bf16 init keep
  the reference's float32 leaves float32, and a bf16 prefill gives the
  reference's dtypes.
* Refusals: the port's ``Engine`` refuses xLSTM (the reference's
  assertion), and the paged paths refuse SSM blocks.
* ``chip_smoke.py``'s SSM phases rehearsed at the tiny config on the CPU.
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
from repro_torch.core import POLICIES
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import blocks as B
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import LM
from repro_torch.models.ssm import FLOAT32_PARAMS
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("xlstm-350m", tiny=True)
    cfg = get_config("xlstm-350m", tiny=True)
    jm = JaxLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jm, jparams, params


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


def _close_rel(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _assert_cache_close(cache, jcache, rel=1e-5):
    jl, tl = jax.tree.leaves(jcache), _sorted_leaves(cache)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype)[6:] == str(a.dtype)
        _close_rel(b, a, rel)


def test_forward_hidden_and_loss_match_jax(tiny):
    jcfg, cfg, jm, jparams, params = tiny
    toks = _tokens(0, (2, 100), cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    want = jm.forward(jparams, jnp.asarray(toks)).hidden
    lm = LM(cfg)
    got = lm.forward(params, torch.from_numpy(toks)).hidden
    _close_rel(got, want, 1e-5)
    jloss, _ = jm.loss(jparams, jnp.asarray(toks), jnp.asarray(labels))
    for remat in (False, True):
        loss, aux = lm.loss(params, torch.from_numpy(toks),
                            torch.from_numpy(labels), remat=remat)
        assert abs(float(loss) - float(jloss)) <= 1e-5
        assert float(aux["aux"]) == 0.0


def test_loss_is_differentiable_on_the_cpu(tiny):
    """On the CPU the GLA is the plain version, so autograd trains an SSM
    model there (the card's kernel has no backward yet)."""
    _, cfg, _, _, params = tiny
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in params["groups"][0]["scan"]["b0"]["cell"].items()}
    p = dict(params, groups=({"scan": {
        "b0": dict(params["groups"][0]["scan"]["b0"], cell=leaves),
        "b1": params["groups"][0]["scan"]["b1"]}},))
    toks = torch.from_numpy(_tokens(1, (2, 70), cfg.vocab_size))
    loss, _ = LM(cfg).loss(p, toks, torch.roll(toks, -1, 1))
    loss.backward()
    assert all(torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
               for t in leaves.values())


@pytest.mark.parametrize("T", [100, 64, 5])
def test_prefill_step_matches_jax(tiny, T):
    jcfg, cfg, _, jparams, params = tiny
    toks = _tokens(T, (2, T), cfg.vocab_size)
    _, jstep = jax_prefill_step(jcfg, T)
    jlogits, jcache = jax.jit(jstep)(jparams, jnp.asarray(toks))
    _, step = build_prefill_step(cfg, T)
    logits, cache = step(params, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert isinstance(cache, tuple) and sorted(cache[0]) == ["b0", "b1"]
    _assert_cache_close(cache, jcache)


def test_serve_steps_match_jax(tiny):
    """8 greedy serve_step calls after a prefill, each fed the previous
    argmax: the tokens equal, the logits within 5e-4, and the final
    cache within 1e-5 of each leaf's magnitude."""
    jcfg, cfg, _, jparams, params = tiny
    T = 37
    toks = _tokens(2, (3, T), cfg.vocab_size)
    _, jpre = jax_prefill_step(jcfg, T)
    _, jserve = jax_serve_step(jcfg)
    jserve = jax.jit(jserve)
    jlogits, jcache = jax.jit(jpre)(jparams, jnp.asarray(toks))
    _, pre = build_prefill_step(cfg, T)
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
        assert tok.dtype == torch.int32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=5e-4, rtol=0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _assert_cache_close(cache, jcache)


def test_decode_continues_the_prefill(tiny):
    """serve_step at position T after a T-prefill gives the last logits
    of a T+1 prefill (the step recurrence against the chunked form), and
    leaves its input cache as it was."""
    _, cfg, _, _, params = tiny
    T = 70
    toks = torch.from_numpy(_tokens(3, (2, T + 1), cfg.vocab_size))
    _, pre = build_prefill_step(cfg, T)
    _, pre1 = build_prefill_step(cfg, T + 1)
    _, serve = build_serve_step(cfg)
    _, cache = pre(params, toks[:, :T])
    before = [t.clone() for t in _sorted_leaves(cache)]
    logits, _, new_cache = serve(params, cache, toks[:, T],
                                 torch.full((2,), T, dtype=torch.int32))
    want, want_cache = pre1(params, toks)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=0)
    for a, b in zip(_sorted_leaves(new_cache), _sorted_leaves(want_cache)):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=0)
    for a, b in zip(_sorted_leaves(cache), before):
        assert torch.equal(a, b)


def test_init_cache_and_zero_state_decode_match_jax(tiny):
    jcfg, cfg, jm, jparams, params = tiny
    jcache = jm.init_cache(3, 16, dtype=jnp.float32)
    cache = LM(cfg).init_cache(3, 16, dtype=torch.float32, device="cpu")
    _assert_cache_close(cache, jcache, rel=0)
    toks = _tokens(4, (3,), cfg.vocab_size)
    pos = np.zeros((3,), np.int32)
    jlogits, jnew = jm.decode_step(jparams, jnp.asarray(toks),
                                   jnp.asarray(pos), jcache)
    logits, new = LM(cfg).decode_step(params, torch.from_numpy(toks),
                                      torch.from_numpy(pos), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    _assert_cache_close(new, jnew)


def _cells(tree, cfg):
    """(block kind, cell dict) of every SSM block of a parameter tree."""
    return [(blk.kind, tree["groups"][gi]["scan"][f"b{j}"]["cell"])
            for gi, g in enumerate(cfg.groups)
            for j, blk in enumerate(g.period)]


def test_bridge_keeps_the_float32_leaves(tiny):
    """``dtype=bfloat16`` casts every leaf but the reference's float32
    ones (mLSTM's w_if, b_i, b_f; sLSTM's b), from a float32 tree (their
    values kept exactly) and from the reference's bf16 init (the dtypes
    equal the reference's, leaf by leaf); the port's own bf16 init has
    the same dtypes and shapes."""
    jcfg, cfg, jm, jparams, _ = tiny
    np32 = jax.tree.map(np.asarray, jparams)
    p = from_jax_params(np32, cfg, dtype=torch.bfloat16)
    for (kind, cell), (_, src) in zip(_cells(p, cfg), _cells(np32, cfg)):
        for name, t in cell.items():
            if name in FLOAT32_PARAMS[kind]:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), src[name])
            elif isinstance(t, torch.Tensor):     # sLSTM's ff is a dict
                assert t.dtype == torch.bfloat16, name
    assert p["embed"].dtype == torch.bfloat16
    j16 = jm.init(jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    p16 = from_jax_params(jax.tree.map(np.asarray, j16), cfg,
                          dtype=torch.bfloat16)
    own = LM(cfg).init(torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    jl = jax.tree.leaves(j16)
    for tree in (p16, own):
        tl = _sorted_leaves(tree)
        assert len(tl) == len(jl)
        for a, b in zip(jl, tl):
            assert tuple(b.shape) == a.shape
            assert str(b.dtype)[6:] == str(a.dtype)


def test_bridge_casts_attention_models_whole():
    """A model without SSM blocks: ``dtype`` casts every leaf, as
    before."""
    jcfg = jax_config("llama3.2-1b", tiny=True)
    cfg = get_config("llama3.2-1b", tiny=True)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    p = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                        dtype=torch.bfloat16)
    assert {t.dtype for t in _sorted_leaves(p)} == {torch.bfloat16}


def test_bfloat16_prefill_dtypes_follow_jax(tiny):
    """The reference's bf16 weights, bridged: the prefill's logits and
    every cache leaf in the reference's dtypes, the logits within 2^-4 of
    their largest magnitude (bf16 rounding through two blocks)."""
    jcfg, cfg, jm, _, _ = tiny
    j16 = jm.init(jax.random.PRNGKey(2), dtype=jnp.bfloat16)
    p16 = from_jax_params(jax.tree.map(np.asarray, j16), cfg,
                          dtype=torch.bfloat16)
    toks = _tokens(5, (2, 40), cfg.vocab_size)
    _, jstep = jax_prefill_step(jcfg, 40)
    jlogits, jcache = jax.jit(jstep)(j16, jnp.asarray(toks))
    _, step = build_prefill_step(cfg, 40)
    logits, cache = step(p16, torch.from_numpy(toks))
    assert str(logits.dtype)[6:] == str(jlogits.dtype)
    for a, b in zip(jax.tree.leaves(jcache), _sorted_leaves(cache)):
        assert str(b.dtype)[6:] == str(a.dtype)
    _close_rel(logits, jlogits, 2.0 ** -4)


def test_engine_refuses_xlstm(tiny):
    _, cfg, _, _, params = tiny
    with pytest.raises(AssertionError, match="attention-cache"):
        Engine(cfg, POLICIES["infercept"], params=params, device="cpu")


def test_paged_paths_refuse_ssm_blocks(tiny):
    _, cfg, _, _, params = tiny
    blk = cfg.groups[0].period[0]
    x = torch.zeros((2, cfg.d_model))
    for fn in (B.block_mixed_paged, B.block_decode_paged,
               B.block_extend_paged):
        with pytest.raises(ValueError, match="attention blocks, got mlstm"):
            fn(params, cfg, blk, x, {}, {})


# ---------------------------------------------------------------------------
# chip_smoke.py's SSM phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_ssm_rehearsals():
    """The tiny_ssm, ssm_parity and ssm_serve phases at the tiny config on
    the CPU: the same control flow, checks and launch-count reads as on
    the card (no kernel launches here), and the recorder keeps the first
    mLSTM call's inputs, on the host."""
    cs = _chip_smoke()
    # 15 rows: the eight TPU kernels' wrappers, the flash backward, the
    # two attention and the two swap kernels over int8 pools, the ragged
    # kernel's decode-only call and the fused quantized append
    assert "gla_scan" in cs.KERNELS and len(cs.KERNELS) == 15
    cs.check_tiny_ssm(device="cpu")
    cs.check_prefill_parity("ssm_parity", tiny=True, device="cpu", seq=70)
    rec = cs.GLARecorder()
    res = cs.model_serve("ssm_serve", rec, tiny=True, device="cpu",
                         batch=2, seq=90, steps=4, profile=True)
    assert res["finite"] and res["max_memory_allocated"] is None
    assert all(v == 0 for v in res["launches"].values())
    q, k, v, la, kw = rec.operands()
    assert q.shape == (2, 2, 90, 256) and v.shape == (2, 2, 90, 257)
    assert k.dtype == torch.float32 and kw["chunk"] == 64
    # the bound's operation count: one chunk of 64 and one of 26, with no
    # q S term on the first (zero state)
    pairs = 64 * 65 // 2 + 26 * 27 // 2
    want = 2 * 4 * (pairs * (256 + 257) + 26 * 256 * 257
                    + 90 * 256 * 257)
    assert cs.gla_ops((2, 2, 90, 256), 257, 64, False) == want
