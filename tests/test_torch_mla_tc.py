"""The latent-attention kernel's tensor-core form, on the CPU: its
arithmetic emulated in plain PyTorch, and the wrapper's choice of form.

``csrc/mla_attention.cu``'s tensor-core form (bf16 pools at L 512, R 64)
runs every product as bf16 on ``mma.sync`` with float32 accumulators. The
float32 queries (times scale * log2 e) and the softmax weights P are split
into two bf16 terms, hi = bf16(x) and lo = bf16(x - hi); the bf16 latents
are exact in one. ``_emulate`` repeats that order on the CPU: 32-key
tiles, the scores as four depth quarters of 144 summed in order, an online
softmax in the log2 domain, O += P_hi C + P_lo C. At deepseek-v3's widths
(H 128, L 512, R 64, contexts up to 1024) it lands within 1e-4 of
``ragged_latent_attention_ref`` and of the reference's einsums (jnp, the
op order of ``repro.models.attention.mla_mixed_paged``); with one term
(bf16 queries and weights) it does not. On the card the kernel itself is
held against the plain version by ``tests/test_torch_mla.py -m gpu`` and
``chip_smoke.py``'s kernels phase. Here too: chip_smoke's float64
yardstick for row 10.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import mla_attention as ma

H, L, R, PAGE, MAX_PAGES = 128, 512, 64, 16, 64
KEYS, QUARTERS = 32, 4        # the kernel's key tile and depth quarters
LOG2E = 1.4426950408889634


def _terms(x, n):
    """x as n bf16 values (as float32) that sum to it, largest first."""
    out = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return out


def _emulate(q_lat, q_rope, c_pool, kr_pool, bt, tok_seq, tok_pos, scale,
             terms=2):
    """The tensor-core form's arithmetic, row by row, in float32."""
    N = q_lat.shape[0]
    out = torch.zeros_like(q_lat)
    mul = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    depth = (L + R) // QUARTERS
    for i in range(N):
        pos = int(tok_pos[i])
        if pos < 0:
            continue
        n_keys = min(pos + 1, bt.shape[1] * PAGE)
        keys = torch.arange(n_keys)
        pid = bt[int(tok_seq[i])].long()[keys // PAGE]
        c = c_pool[pid, keys % PAGE].float()
        k = torch.cat([c, kr_pool[pid, keys % PAGE].float()], -1)
        q = _terms(torch.cat([q_lat[i], q_rope[i]], -1) * mul, terms)
        m = torch.full((H,), -math.inf)
        l_sum = torch.zeros(H)
        o = torch.zeros(H, L)
        for k0 in range(0, n_keys, KEYS):
            kt, ct = k[k0:k0 + KEYS], c[k0:k0 + KEYS]
            s = None
            for d in range(0, L + R, depth):
                part = sum(qt[:, d:d + depth] @ kt[:, d:d + depth].T
                           for qt in q)
                s = part if s is None else s + part
            m_new = torch.maximum(m, s.max(-1).values)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            l_sum = l_sum * corr + p.sum(-1)
            m = m_new
            o = o * corr[:, None] + sum(pt @ ct for pt in _terms(p, terms))
        out[i] = o / l_sum[:, None]
    return out


def _case(seed):
    """deepseek-v3's widths over bf16 pools: decodes at 1023 (the table's
    last key), 700, 31 and 32 (either side of a key tile's edge), a first
    token, and a padded row; numpy-seeded."""
    rng = np.random.default_rng(seed)
    B = 6
    n_pages = B * MAX_PAGES + 1
    bt = (rng.permutation(n_pages - 1)[:B * MAX_PAGES] + 1).reshape(
        B, MAX_PAGES).astype(np.int32)
    c = torch.from_numpy(rng.standard_normal((n_pages, PAGE, L),
                                             np.float32)).bfloat16()
    kr = torch.from_numpy(rng.standard_normal((n_pages, PAGE, R),
                                              np.float32)).bfloat16()
    pos = np.array([1023, 700, 31, 32, 0, -1], np.int32)
    seq = np.arange(B, dtype=np.int32)
    q_lat = rng.standard_normal((B, H, L), np.float32)
    q_rope = rng.standard_normal((B, H, R), np.float32)
    return (torch.from_numpy(q_lat), torch.from_numpy(q_rope), c, kr,
            torch.from_numpy(bt), torch.from_numpy(seq),
            torch.from_numpy(pos), 1 / math.sqrt(192))


def _reference_einsums(q_lat, q_rope, c_pool, kr_pool, bt, tok_seq, tok_pos,
                       scale):
    """The attention inside the reference's mla_mixed_paged, in jnp."""
    import jax
    import jax.numpy as jnp
    N = q_lat.shape[0]
    S = bt.shape[1] * PAGE
    bt_tok = jnp.asarray(bt.numpy())[jnp.asarray(tok_seq.numpy())]
    c = jnp.asarray(c_pool.float().numpy())[bt_tok].reshape(N, S, L)
    kr = jnp.asarray(kr_pool.float().numpy())[bt_tok].reshape(N, S, R)
    s = (jnp.einsum("bhl,bsl->bhs", q_lat.numpy(), c)
         + jnp.einsum("bhr,bsr->bhs", q_rope.numpy(), kr)) * scale
    live = jnp.arange(S)[None, :] <= jnp.asarray(tok_pos.numpy())[:, None]
    s = jnp.where(live[:, None, :], s, -1e30)
    return np.asarray(jnp.einsum("bhs,bsl->bhl", jax.nn.softmax(s, axis=-1),
                                 c))


@pytest.fixture(scope="module")
def case():
    args = _case(0)
    return args, ma.ragged_latent_attention_ref(*args)


def test_two_terms_match_the_plain_version_and_the_reference(case):
    args, plain = case
    got = _emulate(*args)
    live = args[6] >= 0
    assert torch.all(got[~live] == 0) and torch.all(plain[~live] == 0)
    assert float((got - plain).abs().max()) <= 1e-4
    want = _reference_einsums(*args)
    assert np.abs(got[live].numpy() - want[live.numpy()]).max() <= 1e-4


def test_one_term_misses_the_tolerance(case):
    """bf16 queries and weights alone: the split is what buys 1e-4."""
    args, plain = case
    got = _emulate(*args, terms=1)
    assert float((got - plain).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype,L_,R_,tc", [
    (torch.bfloat16, 512, 64, True),     # deepseek-v3's widths
    (torch.float32, 512, 64, False),     # float32 pools
    (torch.bfloat16, 32, 16, False),     # the tiny config's widths
    (torch.bfloat16, 512, 32, False),
    (torch.bfloat16, 256, 64, False),
])
def test_form_follows_the_pools_dtype_and_widths(dtype, L_, R_, tc):
    """The wrapper's choice, made from the operands before the device is
    looked at: _check returns it, tensor_cores says the same, and a CPU
    tensor is refused either way."""
    z, i32 = torch.zeros, torch.int32
    args = (z(2, 24, L_), z(2, 24, R_), z(8, 16, L_, dtype=dtype),
            z(8, 16, R_, dtype=dtype), z(1, 4, dtype=i32), z(2, dtype=i32),
            z(2, dtype=i32))
    assert ma.tensor_cores(args[2], L_, R_) is tc
    assert ma._check(*args) is tc
    with pytest.raises(ValueError, match="CUDA"):
        ma.ragged_latent_attention(*args, 0.1)


def test_refusals_name_both_forms():
    """Widths neither form takes are refused with both forms' terms; a
    pool dtype neither takes, or pools of two dtypes, raise TypeError."""
    z, i32 = torch.zeros, torch.int32
    routing = (z(1, 4, dtype=i32), z(2, dtype=i32), z(2, dtype=i32))
    for L_, R_ in ((520, 64), (512, 72), (24, 16)):
        with pytest.raises(ValueError, match="tensor-core form.*CUDA-core"):
            ma._check(z(2, 4, L_), z(2, 4, R_),
                      z(8, 16, L_, dtype=torch.bfloat16),
                      z(8, 16, R_, dtype=torch.bfloat16), *routing)
    with pytest.raises(TypeError):
        ma._check(z(2, 4, 512), z(2, 4, 64), z(8, 16, 512,
                                                dtype=torch.float16),
                  z(8, 16, 64, dtype=torch.float16), *routing)
    with pytest.raises(TypeError):
        ma._check(z(2, 4, 512), z(2, 4, 64), z(8, 16, 512,
                                                dtype=torch.bfloat16),
                  z(8, 16, 64), *routing)


def test_chip_smoke_float64_yardstick_matches_the_plain_version(case):
    """chip_smoke's float64 evaluation (row 10's timing logs each form's
    error against it) agrees with the plain version, padded rows zero."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    args, plain = case
    exact = chip_smoke.latent_f64(args)
    assert exact.dtype == torch.float64
    assert torch.all(exact[args[6] < 0] == 0)
    assert float((exact - plain.double()).abs().max()) <= 1e-5

