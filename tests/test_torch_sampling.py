"""The port's sampler against the JAX reference, on the CPU.

* ``utils/threefry.py``: threefry2x32, ``PRNGKey``, ``fold_in``, the
  32-bit words and the uniforms equal ``jax.random``'s bit for bit over
  seeds {0, 1, -1, 2**31 - 1, 12345} x positions {0, 1, 511, 2**20};
  the Gumbel noise within 1e-6 absolute + 1e-6 relative (the two
  libraries' ``log`` round apart).
* ``models.sample_tokens`` gives ``repro.models.sample_tokens``'s ids
  over a hypothesis grid of batch, vocabulary, temperature, top-k and
  top-p with tied logits. An id may differ only at a near-tie of the
  perturbed scores (margin below 1e-5) or of the nucleus's cumulative
  mass against top_p (below 1e-6); every such row is reported in a
  warning with its margins, and any other difference fails.
* The nucleus's membership and its disabled identity
  (``tests/test_session.py``'s unit case), and a chi-square of 20000
  draws over V 16 against the softmax. The engine's sampled streams are
  held in ``tests/test_torch_sampling_engine.py``.
* On a card (``-m gpu``): the threefry words and the Gumbel noise of a
  CUDA call equal the CPU's.
"""
import warnings

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.models import sample_tokens
from repro_torch.models.model import perturbed_scores
from repro_torch.utils import threefry

SEEDS = [0, 1, -1, 2**31 - 1, 12345]
POSITIONS = [0, 1, 511, 2**20]
SCORE_TIE = 1e-5        # a top-two margin of the perturbed scores
MASS_TIE = 1e-6         # a cumulative mass this close to top_p


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them, so each worker's
    torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed, pos):
    return threefry.fold_in(
        threefry.prng_key(torch.tensor([seed], dtype=torch.int32)),
        torch.tensor([pos], dtype=torch.int32))


# ---------------------------------------------------------------------------
# threefry against jax.random
# ---------------------------------------------------------------------------
def test_threefry2x32_matches_jax():
    import jax.numpy as jnp
    from jax.extend.random import threefry_2x32
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, (6, 2), dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    for k in keys:
        want = np.asarray(threefry_2x32(jnp.asarray(k), jnp.asarray(count)))
        # JAX hashes the count's halves as the two words of each pair
        x = torch.from_numpy(count.astype(np.int64))
        o1, o2 = threefry.threefry2x32(
            (torch.tensor(int(k[0])), torch.tensor(int(k[1]))),
            x[:32], x[32:])
        np.testing.assert_array_equal(torch.cat([o1, o2]).numpy(),
                                      want.astype(np.int64))


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_draws_match_jax_random(seed, pos):
    import jax
    import jax.numpy as jnp
    V = 1000
    k0 = jax.random.PRNGKey(seed)
    t0 = threefry.prng_key(torch.tensor([seed], dtype=torch.int32))
    assert [int(t0[0][0]), int(t0[1][0])] == \
        np.asarray(k0).astype(np.int64).tolist()
    key = jax.random.fold_in(k0, pos)
    tk = _key(seed, pos)
    assert [int(tk[0][0]), int(tk[1][0])] == \
        np.asarray(key).astype(np.int64).tolist()
    np.testing.assert_array_equal(
        threefry.random_bits(tk, V)[0].numpy(),
        np.asarray(jax.random.bits(key, (V,), jnp.uint32)).astype(np.int64))
    u = threefry.uniform(tk, V)[0].numpy()
    np.testing.assert_array_equal(
        u.view(np.int32),
        np.asarray(jax.random.uniform(key, (V,), jnp.float32)).view(
            np.int32))
    np.testing.assert_allclose(
        threefry.gumbel(tk, V)[0].numpy(),
        np.asarray(jax.random.gumbel(key, (V,), jnp.float32)),
        atol=1e-6, rtol=1e-6)


def test_threefry_batches_rows_in_one_call():
    """B keys in one call give each row's own draw."""
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    pos = torch.tensor([0, 1, 511, 2**20, 7], dtype=torch.int32)
    key = threefry.fold_in(threefry.prng_key(seeds), pos)
    bits = threefry.random_bits(key, 300)
    for b in range(len(SEEDS)):
        np.testing.assert_array_equal(
            bits[b].numpy(),
            threefry.random_bits(_key(int(seeds[b]), int(pos[b])),
                                 300)[0].numpy())


# ---------------------------------------------------------------------------
# sample_tokens against repro.models.sample_tokens
# ---------------------------------------------------------------------------
def _ref_sample(*arrays, rows=16):
    """The reference's ids, its batch padded to ``rows`` rows (rows are
    sampled independently), so each vocabulary compiles once."""
    import jax.numpy as jnp
    from repro.models import sample_tokens as ref
    B = len(arrays[0])
    padded = [np.concatenate([a, np.zeros((rows - B,) + a.shape[1:],
                                          a.dtype)]) for a in arrays]
    return np.asarray(ref(*map(jnp.asarray, padded)))[:B]


def _tie_margins(logits, temps, top_ks, top_ps, seeds, pos, got, want, b):
    """Row b's margins: the gap of the port's perturbed scores between the
    two ids, and the nucleus's cumulative mass nearest top_p."""
    row = [torch.from_numpy(a[b:b + 1]) for a in
           (logits, temps, top_ks, top_ps, seeds, pos)]
    score = perturbed_scores(*row)[0][0]
    pair = score[[got, want]]
    gap = float((pair[0] - pair[1]).abs()) if bool(
        torch.isfinite(pair).all()) else float("inf")
    srt = torch.sort(row[0], dim=-1, descending=True).values
    probs = torch.softmax(srt / max(float(temps[b]), 1e-6), dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    mass = float((excl - float(top_ps[b])).abs().min()) \
        if 0 < top_ps[b] < 1 else float("inf")
    return gap, mass


def _assert_ids(logits, temps, top_ks, top_ps, seeds, pos,
                got, want):
    ties = []
    for b in np.flatnonzero(got != want):
        gap, mass = _tie_margins(logits, temps, top_ks, top_ps, seeds, pos,
                                 int(got[b]), int(want[b]), b)
        assert gap < SCORE_TIE or mass < MASS_TIE, (
            f"row {b}: port {got[b]} vs reference {want[b]}, score gap "
            f"{gap:.3g}, nucleus mass margin {mass:.3g}")
        ties.append({"row": int(b), "score_gap": gap, "mass_margin": mass})
    if ties:
        warnings.warn(f"ids parted at near-ties: {ties}")


@st.composite
def _batch(draw, V):
    B = draw(st.integers(1, 16))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * draw(st.sampled_from([0.5, 3.0]))
              ).astype(np.float32)
    # ties: a share of each row rounded to a coarse grid, and a row of one
    # value repeated
    n_tied = draw(st.integers(0, V))
    logits[:, :n_tied] = np.round(logits[:, :n_tied] * 2) / 2
    if draw(st.booleans()):
        logits[0, :] = logits[0, 0]
    temps = rng.choice(np.float32([0, 0.3, 1, 2]), B)
    top_ks = rng.choice(np.int32([0, 1, 5, V]), B)
    top_ps = rng.choice(np.float32([0, 0.3, 0.9, 1, -1]), B)
    seeds = rng.integers(-2**31, 2**31, B).astype(np.int32)
    pos = rng.integers(0, 2**21, B).astype(np.int32)
    return logits, temps, top_ks, top_ps, seeds, pos


@pytest.mark.parametrize("V,n", [(7, 100), (64, 100), (1000, 60),
                                 (128256, 12)])
def test_sample_tokens_matches_reference(V, n):
    @settings(max_examples=n, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(_batch(V))
    def check(arrays):
        got = sample_tokens(*map(torch.from_numpy, arrays)).numpy()
        assert got.dtype == np.int32
        _assert_ids(*arrays, got, _ref_sample(*arrays))
    check()


def test_nucleus_membership_and_disabled_identity():
    """Every sampled id lies in the numpy-computed smallest prefix of the
    temperature-scaled distribution reaching top_p, and top_p 1 equals top_p
    0 and -1 (the filter off), as tests/test_session.py holds for the
    reference."""
    rng = np.random.default_rng(0)
    B, V, p = 8, 64, 0.3
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3.0
    temps = np.full(B, 0.7, np.float32)

    def sample(top_p):
        return sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(temps),
            torch.zeros(B, dtype=torch.int32),
            torch.full((B,), top_p, dtype=torch.float32),
            torch.arange(B, dtype=torch.int32),
            torch.arange(10, 10 + B, dtype=torch.int32)).numpy()

    out = sample(p)
    for b in range(B):
        scaled = logits[b] / temps[b]
        probs = np.exp(scaled - scaled.max())
        probs /= probs.sum()
        order = np.argsort(-probs)
        cut = int(np.searchsorted(np.cumsum(probs[order]), p)) + 1
        assert int(out[b]) in set(order[:cut].tolist()), b
    assert np.array_equal(sample(1.0), sample(0.0))
    assert np.array_equal(sample(1.0), sample(-1.0))


def chi_square_p(counts: torch.Tensor, probs: torch.Tensor) -> float:
    """The chi-square test's p-value of ``counts`` against ``probs``."""
    want = probs.double() * counts.sum()
    stat = ((counts.double() - want) ** 2 / want).sum()
    df = torch.tensor(float(len(counts) - 1), dtype=torch.float64)
    return float(torch.special.gammaincc(df / 2, stat / 2))


def test_gumbel_max_draws_follow_the_softmax():
    """20000 positions of one seed over one V 16 row at temperature 1, no
    filter: the draws' counts pass a chi-square against softmax."""
    n, V = 20000, 16
    row = torch.from_numpy(np.random.default_rng(3).normal(
        size=V).astype(np.float32))
    ids = sample_tokens(row.expand(n, V), torch.ones(n),
                        torch.zeros(n, dtype=torch.int32), torch.ones(n),
                        torch.full((n,), 7, dtype=torch.int32),
                        torch.arange(n, dtype=torch.int32))
    counts = torch.bincount(ids.long(), minlength=V)
    assert chi_square_p(counts, torch.softmax(row, 0)) > 1e-3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_threefry_on_the_card_equals_the_cpu(cuda):
    V = 128256
    seeds = torch.tensor([0, 1, -1, 2**31 - 1, 12345, 7, 8, 9],
                         dtype=torch.int32)
    pos = torch.tensor([0, 1, 511, 2**20, 3, 4, 5, 6], dtype=torch.int32)
    key = threefry.fold_in(threefry.prng_key(seeds), pos)
    key_d = threefry.fold_in(threefry.prng_key(seeds.to(cuda)), pos.to(cuda))
    assert torch.equal(threefry.random_bits(key_d, V).cpu(),
                       threefry.random_bits(key, V))
    assert torch.equal(threefry.uniform(key_d, V).cpu(),
                       threefry.uniform(key, V))
    torch.testing.assert_close(threefry.gumbel(key_d, V).cpu(),
                               threefry.gumbel(key, V), atol=1e-6,
                               rtol=1e-6)
