"""The port's layer primitives against ``repro.models.common`` / ``mlp``:
the same numpy inputs through both, float32 on the CPU, atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FFNCfg
from repro.models import common as jc
from repro.models import mlp as jmlp
from repro_torch.configs.base import FFNCfg as TFFNCfg
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
