"""The port's SSM cells (``repro_torch.models.ssm``) against the JAX
reference ``repro.models.ssm``, on the same numpy inputs and bridged
weights, in float32 on the CPU.

* Each cell (mamba2, mLSTM, sLSTM) at ``tests/test_ssm.py``'s sizes:
  the full-sequence forward with and without an initial state, and
  single-token decode, output and every state leaf within 1e-5 of the
  reference's largest magnitude (float32 sums in another order; the
  sLSTM's stabilizer ``m`` is compared relative to its own magnitude,
  which reaches ~1e30 at the zero state). A bfloat16 run keeps every
  output's and state leaf's dtype equal to the reference's.
* ``causal_conv`` and ``causal_conv_step`` within 1e-6, and
  ``_maxplus_scan``, which replays ``jax.lax.associative_scan``'s
  recursion, bit for bit.
* The port's own copies of ``tests/test_ssm.py``'s invariants: decode
  equals forward, chunked continuation equals one pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMCfg as JSSMCfg
from repro.models import ssm as jssm
from repro_torch.configs.base import SSMCfg
from repro_torch.models import ssm
from repro_torch.models.bridge import _to_tensor
from repro_torch.utils.tree import tree_map

KEY = jax.random.PRNGKey(0)

CASES = {
    "mamba2": dict(d_state=16, n_heads=2, expand=2, chunk_size=8),
    "mlstm": dict(n_heads=2, expand=2, chunk_size=8),
    "slstm": dict(n_heads=2, expand=1, ff_mult=4 / 3),
}
FNS = {name: (getattr(ssm, f"{name}_forward"), getattr(ssm, f"{name}_decode"),
              getattr(ssm, f"{name}_state_shapes"))
       for name in CASES}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(name, dtype=jnp.float32, d=64):
    """The JAX cell's config and weights, and the port's bridged copy."""
    js = JSSMCfg(kind=name, **CASES[name])
    jp = getattr(jssm, f"init_{name}")(KEY, d, js, dtype)
    tp = tree_map(_to_tensor, jax.tree.map(np.asarray, jp))
    return js, jp, SSMCfg(kind=name, **CASES[name]), tp


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return tree_map(lambda t: t.float().numpy(), tree)


def _sorted_leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _close(got, want, rel=1e-5):
    """got (torch) within ``rel`` of want's (JAX) largest magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _close_state(got, want, name):
    for key in sorted(want):
        if name == "slstm" and key == "m":
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=1e-6)
        else:
            _close(got[key], want[key])


def _x(seed, B, T, d):
    return (np.random.default_rng(seed).normal(size=(B, T, d)) * 0.5
            ).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("with_state", [False, True])
def test_cell_forward_matches_jax(name, with_state):
    js, jp, s, tp = _cell(name)
    d, B, T = 64, 2, 21
    x = _x(1, B, T, d)
    jinit = tinit = None
    if with_state:
        # a carried state: the one a first segment leaves
        x0 = _x(2, B, 11, d)
        _, jinit = getattr(jssm, f"{name}_forward")(jp, js, d,
                                                    jnp.asarray(x0))
        tinit = tree_map(torch.from_numpy, jax.tree.map(np.array, jinit))
    y_ref, st_ref = getattr(jssm, f"{name}_forward")(jp, js, d,
                                                     jnp.asarray(x),
                                                     initial_state=jinit)
    y, st = FNS[name][0](tp, s, d, torch.from_numpy(x), initial_state=tinit)
    _close(y, y_ref)
    assert sorted(st) == sorted(st_ref)
    _close_state(st, st_ref, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cell_decode_matches_jax(name):
    js, jp, s, tp = _cell(name)
    d, B = 64, 3
    x0 = _x(3, B, 9, d)
    _, jst = getattr(jssm, f"{name}_forward")(jp, js, d, jnp.asarray(x0))
    tst = tree_map(torch.from_numpy, jax.tree.map(np.array, jst))
    rng = np.random.default_rng(4)
    for _ in range(3):
        xt = (rng.normal(size=(B, d)) * 0.5).astype(np.float32)
        y_ref, jst = getattr(jssm, f"{name}_decode")(jp, js, d,
                                                     jnp.asarray(xt), jst)
        y, tst = FNS[name][1](tp, s, d, torch.from_numpy(xt), tst)
        _close(y, y_ref)
        _close_state(tst, jst, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cell_bfloat16_dtypes_follow_jax(name):
    """A bf16 model: the reference's promotion rules decide which outputs
    and state leaves are float32; the port's are the same dtypes, and
    agree within bf16 rounding (2^-5 of the largest magnitude: a few
    bf16 roundings along the cell)."""
    js, jp, s, tp = _cell(name, jnp.bfloat16)
    d, B, T = 64, 2, 17
    x = _x(5, B, T, d)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    y_ref, st_ref = getattr(jssm, f"{name}_forward")(jp, js, d, jx)
    y, st = FNS[name][0](tp, s, d, tx)
    assert str(y.dtype)[6:] == str(y_ref.dtype)
    for got, want in zip(_sorted_leaves(st), jax.tree.leaves(st_ref)):
        assert str(got.dtype)[6:] == str(want.dtype)
    _close(y, y_ref, rel=2.0 ** -5)
    y1, st1 = getattr(jssm, f"{name}_decode")(jp, js, d, jx[:, 0], st_ref)
    y2, st2 = FNS[name][1](tp, s, d, tx[:, 0], st)
    assert str(y2.dtype)[6:] == str(y1.dtype)
    for got, want in zip(_sorted_leaves(st2), jax.tree.leaves(st1)):
        assert str(got.dtype)[6:] == str(want.dtype)


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_jax(history):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 13, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    h = rng.normal(size=(2, 3, 10)).astype(np.float32) if history else None
    want = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            None if h is None else jnp.asarray(h))
    got = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b),
                          None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_causal_conv_step_matches_jax():
    rng = np.random.default_rng(7)
    st = rng.normal(size=(3, 3, 10)).astype(np.float32)
    xn = rng.normal(size=(3, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    want_y, want_st = jssm.causal_conv_step(*map(jnp.asarray, (st, xn, w, b)))
    got_y, got_st = ssm.causal_conv_step(*map(torch.from_numpy,
                                              (st, xn, w, b)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


@pytest.mark.parametrize("T", [1, 2, 17, 64, 257])
def test_maxplus_scan_matches_jax_bit_for_bit(T):
    rng = np.random.default_rng(T)
    lf = (-np.abs(rng.normal(size=(3, 2, T))) * 3).astype(np.float32)
    it = (rng.normal(size=(3, 2, T)) * 4).astype(np.float32)
    for m0 in (np.full((3, 2), -1e30, np.float32),
               rng.normal(size=(3, 2)).astype(np.float32)):
        want = jssm._maxplus_scan(*map(jnp.asarray, (lf, it, m0)))
        got = ssm._maxplus_scan(*map(torch.from_numpy, (lf, it, m0)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_maxplus_scan_matches_loop():
    rng = np.random.default_rng(8)
    lf = torch.from_numpy(-np.abs(rng.normal(size=(3, 17))).astype(
        np.float32))
    it = torch.from_numpy(rng.normal(size=(3, 17)).astype(np.float32))
    m = torch.full((3,), -1e30)
    got = ssm._maxplus_scan(lf, it, m)
    want = []
    for t in range(17):
        m = torch.maximum(m + lf[:, t], it[:, t])
        want.append(m)
    torch.testing.assert_close(got, torch.stack(want, -1), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_cell_decode_equals_forward(name):
    _, _, s, tp = _cell(name)
    fwd, dec, shapes = FNS[name]
    d, B, T = 64, 2, 12
    x = torch.from_numpy(_x(9, B, T, d))
    y_ref, _ = fwd(tp, s, d, x)
    st = shapes(s, d, B, torch.float32)
    ys = []
    for t in range(T):
        y, st = dec(tp, s, d, x[:, t], st)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_cell_chunked_continuation(name):
    _, _, s, tp = _cell(name)
    fwd, _, shapes = FNS[name]
    d, B, T = 64, 2, 24
    x = torch.from_numpy(_x(10, B, T, d))
    y_ref, _ = fwd(tp, s, d, x)
    st = shapes(s, d, B, torch.float32)
    ys = []
    for c0 in range(0, T, 8):
        y, st = fwd(tp, s, d, x[:, c0:c0 + 8], initial_state=st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_shapes_match_jax(name):
    js, _, s, _ = _cell(name)
    want = getattr(jssm, f"{name}_state_shapes")(js, 64, 3, jnp.bfloat16)
    got = FNS[name][2](s, 64, 3, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype)[6:] == str(want[key].dtype)
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32))
