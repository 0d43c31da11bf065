"""The port's MoE routing and expert kernels, without the JAX package.

* ``models.moe.route``: the ranks from one stable sort equal the
  reference's one-hot cumulative sum (``route_ref``) exactly, over groups
  of one token and of whole rows, with and without drops; the sorted pairs
  are expert-major with flat order kept inside an expert, and the offsets
  bound each expert's pairs.
* ``moe_experts_ref`` against a dense per-token mixture (every expert run
  on every token, the dropped pairs masked), float32 within 1e-5.
* The dispatch: ``ops.moe_experts_op`` is the plain version on the CPU and
  differentiable there; the launcher refuses a CPU tensor.
* On a CUDA card (``-m gpu``), the kernels against the plain version at
  the tiny and full widths (a decode, a fused prefill and an extend call
  with drops), within 3e-2 (bf16) or 1e-4 (float32) of the largest entry;
  one launch per call, and the backward raising. The card's machine runs
  this file with ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
  tests/test_torch_moe_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FFNCfg
from repro_torch.kernels import ops
from repro_torch.kernels.moe_experts import moe_experts, moe_experts_ref
from repro_torch.models import moe


def _weights(rng, E, d, fe, dtype=torch.float32, device="cpu"):
    """The experts' weights at fan-in scale, drawn on ``device`` from a
    generator seeded by ``rng``."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 31)))

    def w(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device)
                / np.sqrt(fan_in)).to(dtype)
    return w((E, d, fe), d), w((E, d, fe), d), w((E, fe, d), fe)


def _routed(rng, G, T, d, E, k, cf, dtype=torch.float32, device="cpu"):
    """x (G T, d), the router's gates and ids (G, T, k) and route's pairs
    at capacity ``cf``, for random rows and a random router."""
    f = FFNCfg(kind="moe", n_routed_experts=E, top_k=k, d_ff_expert=64,
               capacity_factor=cf)
    x = torch.from_numpy(rng.normal(size=(G, T, d)).astype(np.float32)).to(
        device, dtype)
    p = {"router": torch.from_numpy(rng.normal(size=(d, E)).astype(
        np.float32)).to(device)}
    gate_w, gate_idx, _ = moe.router(p, f, x)
    C = moe._capacity(T, f)
    return x.reshape(G * T, d), gate_w.reshape(G * T, k), gate_idx, C, \
        moe.route(gate_idx, C, E)


@pytest.mark.parametrize("G,T,E,k,cf", [
    (16, 1, 8, 3, 1.25), (3, 40, 8, 2, 1.25), (2, 64, 4, 2, 0.25),
    (1, 100, 16, 6, 8.0)])
def test_route_ranks_equal_the_cumulative_sum(G, T, E, k, cf):
    rng = np.random.default_rng(0)
    _, _, idx, C, (pair, valid, offsets) = _routed(rng, G, T, 32, E, k, cf)
    np.testing.assert_array_equal(valid.numpy(),
                                  moe.route_ref(idx, C, E).numpy())
    if T == 1:
        assert valid.all()                 # a group of one never drops
    if cf < 1:
        assert (~valid).sum() > 0
    flat_e = idx.reshape(-1)[pair.long()]
    bounds = offsets.tolist()
    assert bounds[0] == 0 and bounds[-1] == G * T * k
    for e in range(E):
        seg = pair[bounds[e]:bounds[e + 1]]
        assert (flat_e[bounds[e]:bounds[e + 1]] == e).all()
        assert (seg[1:] > seg[:-1]).all()   # flat order kept
    assert sorted(pair.tolist()) == list(range(G * T * k))


def test_plain_version_is_the_masked_dense_mixture():
    rng = np.random.default_rng(1)
    E, d, fe, k = 4, 32, 48, 2
    x, gw, idx, C, (pair, valid, offsets) = _routed(rng, 2, 30, d, E, k,
                                                    0.5)
    wg, wu, wd = _weights(rng, E, d, fe)
    got = moe_experts_ref(x, wg, wu, wd, gw, pair, valid, offsets)
    silu = torch.nn.functional.silu
    all_out = torch.stack([(silu(x @ wg[e]) * (x @ wu[e])) @ wd[e]
                           for e in range(E)], 1)             # (N, E, d)
    picked = all_out[torch.arange(x.shape[0])[:, None], idx.reshape(-1, k)]
    picked = picked * valid.reshape(-1, k, 1)
    want = (picked * gw[..., None]).sum(1)
    assert (~valid).sum() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_op_is_the_plain_version_on_the_cpu_and_differentiable():
    rng = np.random.default_rng(2)
    x, gw, idx, C, routed = _routed(rng, 4, 8, 64, 4, 2, 1.25)
    wg, wu, wd = (w.requires_grad_(True) for w in _weights(rng, 4, 64, 64))
    out = ops.moe_experts_op(x, wg, wu, wd, gw, *routed)
    torch.testing.assert_close(out, moe_experts_ref(x, wg, wu, wd, gw,
                                                    *routed))
    out.square().sum().backward()
    assert all(float(w.grad.abs().sum()) > 0 for w in (wg, wu, wd))


def test_launcher_refuses_what_the_kernels_do_not_take():
    rng = np.random.default_rng(3)
    x, gw, _, _, routed = _routed(rng, 2, 4, 64, 4, 2, 1.25)
    wg, wu, wd = _weights(rng, 4, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        moe_experts(x, wg, wu, wd, gw, *routed)


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (label, groups, tokens a group, d, fe, E, k, capacity factor)
GPU_CASES = [("tiny decode", 8, 1, 256, 128, 4, 2, 8.0),
             ("decode", 8, 1, 2048, 1408, 64, 6, 1.25),
             ("fused prefill", 512, 1, 2048, 1408, 64, 6, 1.25),
             ("extend", 4, 128, 2048, 1408, 64, 6, 1.25),
             ("tiny extend", 4, 128, 256, 128, 4, 2, 0.5)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,G,T,d,fe,E,k,cf", GPU_CASES,
                         ids=[c[0] for c in GPU_CASES])
def test_gpu_kernels_match_plain(cuda, dtype, label, G, T, d, fe, E, k, cf):
    rng = np.random.default_rng(4)
    x, gw, idx, C, routed = _routed(rng, G, T, d, E, k, cf, dtype, cuda)
    wg, wu, wd = _weights(rng, E, d, fe, dtype, cuda)
    np.testing.assert_array_equal(routed[1].cpu().numpy(),
                                  moe.route_ref(idx.cpu(), C, E).numpy())
    if label.endswith("extend"):
        assert int((~routed[1]).sum()) > 0
    before = moe_experts.launches
    got = moe_experts(x, wg, wu, wd, gw, *routed)
    torch.cuda.synchronize()
    assert moe_experts.launches == before + 1
    want = moe_experts_ref(x, wg, wu, wd, gw, *routed)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.gpu
def test_gpu_backward_raises(cuda):
    rng = np.random.default_rng(5)
    x, gw, _, _, routed = _routed(rng, 2, 4, 64, 4, 2, 8.0, device=cuda)
    wg, wu, wd = (w.requires_grad_(True)
                  for w in _weights(rng, 4, 64, 64, device=cuda))
    out = ops.moe_experts_op(x, wg, wu, wd, gw, *routed)
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()
