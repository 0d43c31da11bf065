"""The port's training path against the JAX reference, float32 on the CPU:
the cross entropies, ``gqa_forward`` / ``block_forward`` / ``LM.forward``
/ ``LM.loss`` and its gradients on bridged tiny-llama weights, the AdamW
update and one full train step. (The loop, checkpoints and the CLI are in
``test_torch_train_loop.py``.)

Tolerances: losses atol 1e-5 and normed hidden states atol 1e-4 (float32
products summed in another order by XLA and by PyTorch, through 2
layers; the flash path scales the product where ``blocked_attention``
scales q); a single layer's raw outputs 1e-5 of their largest magnitude;
gradients atol 1e-4 of each leaf's largest magnitude (one case needs
more, and says why); the AdamW update on identical gradients atol 1e-6
of the largest magnitude (the same elementwise float32 ops)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.models import attention, blocks
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.common import (chunked_cross_entropy,
                                       cross_entropy_logits)
from repro_torch.models.model import LM
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, lr_schedule)
from repro_torch.training.train_loop import loss_and_grads, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them."""
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


def _batch(cfg, B=2, T=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    return tokens, labels, mask


def _close_trees(got, want, rel):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max())


# ---------------------------------------------------------------------------
# cross entropies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_jax(masked):
    """V 1000 in chunks of 256: the last chunk is padded in the reference
    (24 columns) and narrower here."""
    from repro.models import common as jc
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = rng.normal(size=(16, 1000)).astype(np.float32)
    labels = rng.integers(0, 1000, (2, 7)).astype(np.int32)
    labels[0, :3] = [999, 768, 0]          # the padded chunk and its edges
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    want = jc.chunked_cross_entropy(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), vocab_chunk=256,
        label_mask=None if mask is None else jnp.asarray(mask))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = chunked_cross_entropy(
        xt, torch.from_numpy(w), torch.from_numpy(labels), vocab_chunk=256,
        label_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5)
    # its gradient (each chunk recomputed in the backward) against jax.grad
    want_g = jax.grad(lambda a: jc.chunked_cross_entropy(
        a, jnp.asarray(w), jnp.asarray(labels), vocab_chunk=256,
        label_mask=None if mask is None else jnp.asarray(mask)))(
            jnp.asarray(x))
    got.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=1e-5)
    # and the dense CE on the same logits
    lg = x @ w
    dense = cross_entropy_logits(
        torch.from_numpy(lg), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    want_dense = jc.cross_entropy_logits(
        jnp.asarray(lg), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(dense), float(want_dense), atol=1e-5)
    np.testing.assert_allclose(float(dense), float(got.detach()), atol=1e-5)


# ---------------------------------------------------------------------------
# the layers and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window_override", ["cfg", 8])
def test_gqa_and_block_forward_match_jax(tiny, window_override):
    from repro.models import attention as jattn
    from repro.models import blocks as jblocks
    jcfg, cfg, _, jparams, params = tiny
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    jp = jax.tree.map(lambda t: t[0], jparams["groups"][0]["scan"]["b0"])
    tp = tree_map(lambda t: t[0], params["groups"][0]["scan"]["b0"])
    blk, jblk = cfg.blocks[0], jcfg.blocks[0]
    want, want_kv = jattn.gqa_forward(jp["attn"], jblk.attn, jnp.asarray(x),
                                      jnp.asarray(pos),
                                      window_override=window_override)
    got, got_kv = attention.gqa_forward(
        tp["attn"], blk.attn, torch.from_numpy(x), torch.from_numpy(pos),
        window_override=window_override)
    # the layer's raw outputs reach ~75 under the reference init: held
    # at 1e-5 of their largest magnitude
    for g, w in ((got, want), (got_kv["k"], want_kv["k"]),
                 (got_kv["v"], want_kv["v"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    ctx = {"positions": jnp.asarray(pos), "window_override": window_override}
    want, _, _ = jblocks.block_forward(jp, jcfg, jblk, jnp.asarray(x), ctx)
    got, _, aux = blocks.block_forward(
        tp, cfg, blk, torch.from_numpy(x),
        {"positions": torch.from_numpy(pos),
         "window_override": window_override})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert float(aux) == 0.0


@pytest.mark.parametrize("window_override", ["cfg", 8])
def test_forward_and_loss_match_jax(tiny, window_override):
    jcfg, cfg, jm, jparams, params = tiny
    tokens, labels, mask = _batch(cfg)
    want = jm.forward(jparams, jnp.asarray(tokens),
                      window_override=window_override)
    lm = LM(cfg)
    got = lm.forward(params, torch.from_numpy(tokens),
                     window_override=window_override)
    assert got.cache is None and float(got.aux_loss) == 0.0
    np.testing.assert_allclose(got.hidden.numpy(), np.asarray(want.hidden),
                               atol=1e-4)
    jl, jmet = jm.loss(jparams, jnp.asarray(tokens), jnp.asarray(labels),
                       label_mask=jnp.asarray(mask),
                       window_override=window_override)
    tl, tmet = lm.loss(params, torch.from_numpy(tokens),
                       torch.from_numpy(labels),
                       label_mask=torch.from_numpy(mask),
                       window_override=window_override)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                               atol=1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_gradients_match_jax_grad(tiny, remat):
    jcfg, cfg, jm, jparams, params = tiny
    tokens, labels, mask = _batch(cfg, seed=4)
    want = jax.grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(labels),
        label_mask=jnp.asarray(mask), remat=remat)[0])(jparams)
    loss, _, grads = loss_and_grads(
        LM(cfg), params, torch.from_numpy(tokens), torch.from_numpy(labels),
        torch.from_numpy(mask), remat=remat)
    assert all(not t.requires_grad for t in tree_leaves(grads))
    _close_trees(grads, want, 1e-4)


def test_chunked_loss_path_matches_jax():
    """A vocabulary of 65536 takes LM.loss through the chunked CE (four
    chunks), with its gradient."""
    jcfg = dataclasses.replace(jax_config("llama3.2-1b", tiny=True),
                               vocab_size=65536)
    cfg = dataclasses.replace(get_config("llama3.2-1b", tiny=True),
                              vocab_size=65536)
    jm = JaxLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(3), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    tokens, labels, mask = _batch(cfg, T=8, seed=5)
    (jl, _), want = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(labels),
        label_mask=jnp.asarray(mask)), has_aux=True)(jparams)
    loss, _, grads = loss_and_grads(
        LM(cfg), params, torch.from_numpy(tokens), torch.from_numpy(labels),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-5)
    # The reference init's attention is close to a hard max, where float32
    # rounding alone moves a gradient by up to ~5e-4 of its leaf's largest
    # magnitude (these weights: the reference's float32 gradient against
    # the float64 one). So the two float32 gradients are held at 1e-3 of
    # it, and the port's no farther from the float64 gradient than 1.5x
    # the reference's distance (plus 1e-6 of the leaf's magnitude).
    _close_trees(grads, want, 1e-3)
    p64 = tree_map(lambda t: t.double(), params)
    _, _, g64 = loss_and_grads(
        LM(cfg), p64, torch.from_numpy(tokens), torch.from_numpy(labels),
        torch.from_numpy(mask))
    for g, w, h in zip(tree_leaves(grads), jax.tree.leaves(want),
                       tree_leaves(g64)):
        h = h.numpy()
        ref_err = np.abs(np.asarray(w) - h).max()
        assert np.abs(g.numpy() - h).max() <= \
            1.5 * ref_err + 1e-6 * np.abs(h).max()


def test_forward_refuses_unported(tiny):
    """The forward's ``embeds`` prefix and ``positions``, which the port
    refused before pixtral's slice, against the reference on tiny llama:
    hidden states within 1e-4 of their largest magnitude, as
    tests/test_torch_embeds.py holds the rest of the prefix path on tiny
    pixtral; positions that are not an offset range are still refused."""
    _, cfg, jm, jparams, params = tiny
    lm = LM(cfg)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    embeds = (0.05 * rng.normal(size=(2, 3, cfg.d_model))).astype(np.float32)
    positions = np.arange(4, 13, dtype=np.int32)
    for kw in ({"embeds": embeds}, {"positions": positions[3:]},
               {"embeds": embeds, "positions": positions}):
        want = jm.forward(jparams, jnp.asarray(tokens),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
        got = lm.forward(params, torch.from_numpy(tokens),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
        want = np.asarray(want.hidden)
        np.testing.assert_allclose(got.hidden.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    # the flash kernel masks by index: positions other than an offset
    # range (a gap, a reset, per-row positions) are refused
    for pos in (np.array([0, 1, 2, 4, 5, 6]), np.array([3, 4, 5, 0, 1, 2]),
                np.tile(np.arange(6), (2, 1))):
        with pytest.raises(NotImplementedError, match="offset range"):
            lm.forward(params, torch.from_numpy(tokens),
                       positions=torch.from_numpy(pos.astype(np.int32)))


# ---------------------------------------------------------------------------
# the optimizer and the step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_update_matches_jax(grad_clip):
    """Three updates on identical gradients, leaves of 1 dim (no decay)
    and 2-3 dims, through warmup and into the cosine."""
    from repro.training import optimizer as jo
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 3), "b": {"c": (4,), "d": (2, 3, 2)}}
    p_np = {"a": rng.normal(size=shapes["a"]).astype(np.float32),
            "b": {k: rng.normal(size=s).astype(np.float32)
                  for k, s in shapes["b"].items()}}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=grad_clip)
    jcfg, tcfg = jo.AdamWConfig(**kw), AdamWConfig(**kw)
    jp, tp = jax.tree.map(jnp.asarray, p_np), tree_map(torch.from_numpy,
                                                       p_np)
    js, ts = jo.adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape)
                         .astype(np.float32), p_np)
        jp, js, jm = jo.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                     js)
        tp, ts, tm = adamw_update(tcfg, tp, tree_map(torch.from_numpy, g),
                                  ts)
        _close_trees(tp, jp, 1e-6)
        _close_trees(ts["mu"], js["mu"], 1e-6)
        _close_trees(ts["nu"], js["nu"], 1e-6)
        assert int(ts["step"]) == int(js["step"])
        assert ts["mu"]["a"].dtype == torch.float32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)


def test_lr_schedule_matches_jax():
    from repro.training import optimizer as jo
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=50, min_lr_frac=0.2)
    for step in (0, 5, 9, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(
            float(lr_schedule(AdamWConfig(**kw), torch.tensor(step))),
            float(jo.lr_schedule(jo.AdamWConfig(**kw), jnp.asarray(step))),
            rtol=1e-6)


def test_train_step_matches_jax(tiny):
    """One make_train_step: loss, grad_norm and lr. The new params are
    not compared element by element: Adam's first step is about
    lr * g / |g|, whose sign flips where g is near 0."""
    from repro.training import optimizer as jo
    from repro.training.train_loop import make_train_step as jax_step
    jcfg, cfg, jm, jparams, params = tiny
    tokens, labels, mask = _batch(cfg, seed=7)
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=10)
    _, _, jmet = jax_step(jm, jo.AdamWConfig(**kw))(
        jparams, jo.adamw_init(jparams), jnp.asarray(tokens),
        jnp.asarray(labels), jnp.asarray(mask))
    new_p, new_opt, met = make_train_step(LM(cfg), AdamWConfig(**kw))(
        params, adamw_init(params), torch.from_numpy(tokens),
        torch.from_numpy(labels), torch.from_numpy(mask))
    assert all(v.dim() == 0 for v in met.values())
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    assert int(new_opt["step"]) == 1
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(tree_leaves(new_p), tree_leaves(params)))
