"""The flash backward at head_dim 256 (gemma2-9b, GPT-J-6B) and 192 (MLA's
qk width) on the port's training path, float32 on the CPU.

* The plain backward (``flash_attention_bwd_ref``, the oracle that the
  card's kernels are held against) against ``jax.grad`` of
  ``repro.kernels.ref.flash_attention_ref`` on one seeded cotangent: at
  head_dim 256 with G 2, softcap 50, a window and Tq < Tk, and at 192
  with v zero-padded past 128 columns and scale 1 / sqrt(192), as
  ``mla_forward`` calls it; atol 2e-5, as
  ``tests/test_torch_flash_attention.py`` holds head_dim 32 (float32
  products summed in another order).
* Tiny gemma2-9b and tiny GPT-J-6B widened to head_dim 256
  (``tests/wide_models.py: with_head_dim``) on the reference's seed-0
  init bridged into the port (GPT-J's attention conditioned for soft
  attention, see the test): the loss and every gradient of
  ``loss_and_grads`` against ``jax.value_and_grad`` of ``JaxLM.loss``,
  remat on and off (loss atol 1e-5, each gradient 1e-4 of its leaf's
  largest magnitude); then one ``make_train_step`` of each against the
  reference's (loss, grad_norm, lr), as ``tests/test_torch_training.py``
  holds llama.
* ``chip_smoke.py``'s gemma2_train, gptj_train and wide_train_parity
  phases rehearsed at the tiny configs on the CPU.

The kernels themselves run on the card only:
``tests/test_torch_flash_attention.py -m gpu`` holds them at 192 and 256.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_fwd_ref)
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import LM
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import loss_and_grads, make_train_step
from repro_torch.utils.tree import tree_map
from wide_models import chip_smoke, tiny_model

MODELS = ("gemma2-9b", "gpt-j-6b")
# past tiny gemma2's 128-token window
T = 160


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hd,G,Tq,Tk,kw,v_width", [
    (256, 2, 40, 64, dict(window=12, softcap=50.0), None),
    (256, 2, 48, 48, dict(softcap=50.0), None),
    (192, 1, 48, 48, dict(scale=1.0 / np.sqrt(192)), 128),
    (192, 1, 40, 64, dict(scale=1.0 / np.sqrt(192), window=9), 128)])
def test_plain_backward_matches_jax_grad(hd, G, Tq, Tk, kw, v_width):
    from repro.kernels import ref
    rng = np.random.default_rng(hd + Tq)
    q = rng.normal(size=(2, 2, G, Tq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, Tk, hd)).astype(np.float32)
            for _ in range(2))
    cot = rng.normal(size=q.shape).astype(np.float32)
    if v_width is not None:
        v[..., v_width:] = 0
        cot[..., v_width:] = 0

    def f(q, k, v):
        return jnp.sum(ref.flash_attention_ref(q, k, v, **kw) * cot)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_fwd_ref(tq, tk, tv, **kw)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse,
                                  torch.from_numpy(cot), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    if v_width is not None:
        assert bool((got[2][..., v_width:] == 0).all())


def _sorted_leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


_CONDITIONED = {}


def _conditioned(name):
    """(JAX params, port params) of ``tiny_model(name, 256)`` with the
    attention projections rescaled to a fan-in over d_model
    (``chip_smoke.condition_attention``'s rule, applied to the reference's
    tree before the bridge): attention off a hard max."""
    if name not in _CONDITIONED:
        jcfg, cfg, jm, jparams, _ = tiny_model(name, 256)
        tree = jax.tree.map(np.array, jparams)
        for g in tree["groups"]:
            for blk in g["scan"].values():
                attn = blk["attn"]
                d, H, hd = attn["wq"].shape[-3:]
                for w in ("wq", "wk", "wv"):
                    attn[w] *= np.sqrt(attn[w].shape[-2] / d)
                attn["wo"] *= 1.0 / np.sqrt(hd)
        _CONDITIONED[name] = (jax.tree.map(jnp.asarray, tree),
                              from_jax_params(tree, cfg))
    return _CONDITIONED[name]


def _grads(jm, jparams, cfg, params, batch, remat):
    """(JAX loss, JAX gradient leaves, port loss, port gradient leaves in
    JAX's order) of ``LM.loss`` on ``batch``."""
    tokens, labels, mask = batch
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(labels),
        label_mask=jnp.asarray(mask), remat=remat)[0])(jparams)
    loss, _, grads = loss_and_grads(
        LM(cfg), params, torch.from_numpy(tokens), torch.from_numpy(labels),
        torch.from_numpy(mask), remat=remat)
    return (float(jloss), [np.asarray(w) for w in jax.tree.leaves(jgrads)],
            float(loss), _sorted_leaves(grads))


def _batch(cfg, B=2, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    return tokens, labels, mask


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_loss_gradients_match_jax_grad_at_head_dim_256(name, remat):
    """gemma2 on the reference's init (its softcap keeps attention soft);
    GPT-J, which has no softcap, on weights conditioned for soft attention
    (``_conditioned``): on the reference's init its attention is close to
    a hard max, where float32 alone puts either package's gradient 2-6e-4
    of a leaf from float64 (at head_dim 64 as at 256), and there the
    port's float32 gradient is held against the port's float64 one within
    max(1e-4, twice the reference's float32 distance)."""
    jcfg, cfg, jm, jparams, params = tiny_model(name, 256)
    batch = _batch(cfg)
    held = (jparams, params) if name == "gemma2-9b" else _conditioned(name)
    jloss, jleaves, loss, leaves = _grads(jm, *held[:1], cfg, held[1],
                                          batch, remat)
    assert abs(loss - jloss) <= 1e-5
    assert len(jleaves) == len(leaves)
    for g, w in zip(leaves, jleaves):
        assert tuple(g.shape) == w.shape and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    if name == "gpt-j-6b":
        _, jleaves, _, leaves = _grads(jm, jparams, cfg, params, batch,
                                       remat)
        _, _, _, wit = _grads(jm, jparams, cfg,
                              tree_map(torch.Tensor.double, params), batch,
                              remat)
        for g, w, x in zip(leaves, jleaves, wit):
            x = x.numpy()
            scale = np.abs(x).max()
            allowed = max(1e-4, 2 * np.abs(w - x).max() / scale)
            assert np.abs(g.numpy() - x).max() / scale <= allowed


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax_at_head_dim_256(name):
    """One make_train_step: loss, grad_norm and lr (the new params are
    not compared element by element: Adam's first step is about
    lr * sign(g), which flips where g is near 0); GPT-J on conditioned
    weights, as above."""
    from repro.training import optimizer as jo
    from repro.training.train_loop import make_train_step as jax_step
    jcfg, cfg, jm, jparams, params = tiny_model(name, 256)
    if name == "gpt-j-6b":
        jparams, params = _conditioned(name)
    tokens, labels, mask = _batch(cfg, seed=7)
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=10)
    _, _, jmet = jax_step(jm, jo.AdamWConfig(**kw))(
        jparams, jo.adamw_init(jparams), jnp.asarray(tokens),
        jnp.asarray(labels), jnp.asarray(mask))
    _, opt, met = make_train_step(LM(cfg), AdamWConfig(**kw))(
        params, adamw_init(params), torch.from_numpy(tokens),
        torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    assert int(opt["step"]) == 1


def test_chip_smoke_wide_train_rehearsals():
    """gemma2_train and gptj_train at the tiny configs (one period, 4 x
    128) and wide_train_parity at T 160 on the CPU: the same control flow,
    checks and launch-count reads as on the card (no kernel launches
    here), the recorders keep each run's first attention call and the
    gradient that reached its output, and wide_train_parity's recorder
    deepseek-v3's call at the padded qk width with its scale."""
    cs = chip_smoke()
    for phase, (model, *_) in cs.WIDE_TRAIN.items():
        rec = cs.FlashRecorder()
        res = cs.train(rec, model=model, tiny=True, device="cpu", warm=2,
                       timed=6, batch=4, seq=128, periods=(1,))
        assert len(res["losses"]) == 8 and res["max_memory_allocated"] is None
        assert all(v == 0 for v in res["launches"].values())
        q, k, v, kw = rec.args
        assert rec.dout.shape == q.shape and q.shape[3] == 128
    rec = cs.FlashRecorder()
    assert cs.check_wide_train_parity(tiny=True, device="cpu", recorder=rec,
                                      seq=T) == 0
    q, k, v, kw = rec.args
    assert rec.dout.shape == q.shape and q.shape[3] == T
    assert kw["scale"] != 1.0 / np.sqrt(q.shape[-1])
    assert set(cs.WIDE_BWD_KERNELS) <= set(cs.ROWS)
    assert set(cs.WIDE_TRAIN_ROWS.values()) <= set(cs.WIDE_BWD_KERNELS)
    assert {"wide_train_parity", *cs.WIDE_TRAIN} <= set(cs.PHASES)
