"""The port's layer primitives against ``repro.models.common`` / ``mlp``:
the same numpy inputs through both, float32 on the CPU, atol 1e-5.

The paged attention layers (``gqa_decode_paged``, ``gqa_extend_paged``)
against ``repro.models.attention`` on the same weights and pools: outputs
atol 1e-4 (float32 products summed in another order by XLA and by
PyTorch, then the output projection), pools atol 2e-5 of their largest
magnitude; padded rows (ctx_lens 0, bucket padding past n_new) are
compared only where both sides define them: their pool slots must stay
untouched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionCfg, FFNCfg
from repro.models import attention as jattn
from repro.models import common as jc
from repro.models import mlp as jmlp
from repro_torch.configs.base import AttentionCfg as TAttentionCfg
from repro_torch.configs.base import FFNCfg as TFFNCfg
from repro_torch.models import attention as tattn
from repro_torch.models import common as tc
from repro_torch.models import mlp as tmlp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them and slow these
    tests many times over, so each worker's torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(4, 32), (2, 3, 64), (1, 256)])
def test_rms_norm(shape):
    rng = np.random.default_rng(len(shape))
    xj, xt = _both(rng.normal(size=shape).astype(np.float32) * 3)
    sj, st = _both(rng.normal(size=shape[-1:]).astype(np.float32) * 0.1)
    _close(jc.rms_norm(xj, sj), tc.rms_norm(xt, st))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("hd", [32, 64])
def test_apply_rope(theta, hd):
    """Neox rotate-half in f32 at the positions a mixed batch carries:
    x (N, 1, H, hd) at positions (N, 1), up to a long context."""
    rng = np.random.default_rng(hd)
    xj, xt = _both(rng.normal(size=(7, 1, 4, hd)).astype(np.float32))
    pos = np.array([0, 1, 15, 16, 255, 1023, 4095], np.int32)[:, None]
    pj, pt = _both(pos)
    _close(jc.apply_rope(xj, pj, theta), tc.apply_rope(xt, pt, theta))
    _close(jc.rope_freqs(hd, theta), tc.rope_freqs(hd, theta))


def test_apply_rope_batched_positions():
    """positions (B, T) against x (B, T, H, hd), the prefill layout."""
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.normal(size=(2, 5, 2, 32)).astype(np.float32))
    pj, pt = _both(np.arange(10, dtype=np.int32).reshape(2, 5) * 7)
    _close(jc.apply_rope(xj, pj, 10000.0), tc.apply_rope(xt, pt, 10000.0))


@pytest.mark.parametrize("cap", [None, 30.0, 5.0])
def test_softcap(cap):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.normal(size=(3, 17)).astype(np.float32) * 40)
    _close(jc.softcap(xj, cap), tc.softcap(xt, cap))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_fn(name):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.normal(size=(64,)).astype(np.float32) * 3)
    _close(jc.activation_fn(name)(xj), tc.activation_fn(name)(xt))


@pytest.mark.parametrize("gated,activation", [(True, "silu"),
                                              (True, "gelu"),
                                              (False, "relu")])
def test_mlp_forward(gated, activation):
    """Gated SwiGLU (and its variants) with the same weights."""
    rng = np.random.default_rng(3)
    d, f = 32, 64
    kw = dict(kind="dense", d_ff=f, activation=activation, gated=gated)
    names = ["w_up", "w_down"] + (["w_gate"] if gated else [])
    shapes = {"w_up": (d, f), "w_down": (f, d), "w_gate": (d, f)}
    w = {n: (rng.normal(size=shapes[n]) / np.sqrt(shapes[n][0])
             ).astype(np.float32) for n in names}
    xj, xt = _both(rng.normal(size=(5, d)).astype(np.float32))
    pj = {n: jnp.asarray(v) for n, v in w.items()}
    pt = {n: torch.from_numpy(v) for n, v in w.items()}
    _close(jmlp.mlp_forward(pj, FFNCfg(**kw), xj),
           tmlp.mlp_forward(pt, TFFNCfg(**kw), xt))


def test_init_helpers_distributions():
    """dense_init is truncated at two std of 1/sqrt(fan_in); embed_init
    is N(0, 1/d) — the JAX init's distributions, from a torch.Generator."""
    gen = torch.Generator().manual_seed(0)
    w = tc.dense_init(gen, (256, 8, 32), dtype=torch.float32, device="cpu")
    std = 1.0 / np.sqrt(8)          # fan_in = shape[-2], as in the JAX init
    assert w.shape == (256, 8, 32)
    assert float(w.abs().max()) <= 2 * std + 1e-6
    e = tc.embed_init(gen, (512, 256), dtype=torch.bfloat16, device="cpu")
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 1 / 16) < 5e-3


# ---------------------------------------------------------------------------
# paged attention layers: per-call decode and chunked prefill
# ---------------------------------------------------------------------------
ATTN_KW = dict(n_heads=8, n_kv_heads=2, head_dim=32, rope_theta=10000.0)


def _attn_setup(rng, d, n_pages, page, **cfg_kw):
    kw = dict(ATTN_KW, **cfg_kw)
    a = AttentionCfg(**kw)
    ta = TAttentionCfg(**kw)
    H, Hkv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    shapes = {"wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
              "wo": (H, hd, d)}
    w = {n: (rng.normal(size=sh) / np.sqrt(sh[0])).astype(np.float32)
         for n, sh in shapes.items()}
    pools = {k: rng.normal(size=(n_pages, page, Hkv, hd)).astype(np.float32)
             for k in ("k", "v")}
    return a, ta, w, pools


def _attn_both(fn, a, ta, w, pools, x, *args, **kw):
    want, jpool = getattr(jattn, fn)(
        {n: jnp.asarray(v) for n, v in w.items()}, a, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in pools.items()},
        *map(jnp.asarray, args), **kw)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    got = getattr(tattn, fn)(
        {n: torch.from_numpy(v) for n, v in w.items()}, ta,
        torch.from_numpy(x), tpool, *map(torch.from_numpy, args), **kw)
    return (np.asarray(want), got.numpy(),
            {k: np.asarray(v) for k, v in jpool.items()},
            {k: v.numpy() for k, v in tpool.items()})


def _pools_close(jpool, tpool, before, n_written):
    for k in ("k", "v"):
        want = jpool[k]
        np.testing.assert_allclose(tpool[k], want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
        changed = np.any(tpool[k] != before[k], axis=(2, 3))
        assert changed.sum() == n_written


@pytest.mark.parametrize("cfg_kw", [{}, dict(sliding_window=9),
                                    dict(logit_softcap=20.0)])
def test_gqa_decode_paged(cfg_kw):
    """Three sequences at ragged depths, one on a page boundary, and a
    padded row (ctx_lens 0): written and attended in place."""
    rng = np.random.default_rng(1)
    d, n_pages, page, max_pages = 64, 24, 8, 5
    a, ta, w, pools = _attn_setup(rng, d, n_pages, page, **cfg_kw)
    bt = rng.permutation(n_pages)[:4 * max_pages].reshape(4, max_pages)
    bt = bt.astype(np.int32)
    ctx_lens = np.array([37, 8, 1, 0], np.int32)
    x = rng.normal(size=(4, d)).astype(np.float32)
    want, got, jpool, tpool = _attn_both("gqa_decode_paged", a, ta, w, pools,
                                         x, bt, ctx_lens)
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-4, rtol=0)
    _pools_close(jpool, tpool, pools, n_written=3)


@pytest.mark.parametrize("cfg_kw", [{}, dict(sliding_window=9),
                                    dict(logit_softcap=20.0)])
def test_gqa_extend_paged(cfg_kw):
    """Two chunks padded to T = 8: one mid-context across a page edge (5
    real tokens from position 13), one prefill from 0 (all 8 real)."""
    rng = np.random.default_rng(2)
    d, n_pages, page, max_pages = 64, 24, 8, 4
    a, ta, w, pools = _attn_setup(rng, d, n_pages, page, **cfg_kw)
    bt = rng.permutation(n_pages)[:2 * max_pages].reshape(2, max_pages)
    bt = bt.astype(np.int32)
    start = np.array([13, 0], np.int32)
    n_new = np.array([5, 8], np.int32)
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    want, got, jpool, tpool = _attn_both("gqa_extend_paged", a, ta, w, pools,
                                         x, bt, start, n_new)
    np.testing.assert_allclose(got[0, :5], want[0, :5], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    _pools_close(jpool, tpool, pools, n_written=13)
