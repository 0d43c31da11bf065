"""The port's model slice against the JAX reference: ``from_jax_params``
bridges the ``repro`` ``LM.init`` weights, and ``forward_mixed_paged``,
``decode_step_paged`` and ``extend_step_paged`` run the same pools,
block tables and routing — padded token and sequence rows included —
through both, float32 on the CPU.

Tolerances: logits atol 1e-4 (float32 products summed in another order
by XLA and by PyTorch, through 2 layers); pools atol 2e-5 of each
leaf's largest magnitude — the appended K/V rows reach magnitude ~10
under the JAX init (its fan-in over the kv heads), and every element of
a row carries the rounding of the row's 256-term products; sampled ids
exactly equal. Logits of padded rows (ctx_lens 0 in a decode) are
garbage on both sides and are not compared."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import LM
from repro_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them and slow these
    tests many times over, so each worker's torch runs one thread."""
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
    return jcfg, cfg, jm, jparams


def _routing(rng, cfg, n_pages, page, max_pages):
    """Three sequences — a 6-token chunk mid-context, a 5-token prefill
    from 0, one decode deep in its table — then padded token rows
    (tok_pos -1) and a padded sequence row (q_last 0)."""
    B = 3
    bt = rng.permutation(n_pages)[:(B + 1) * max_pages].reshape(
        B + 1, max_pages).astype(np.int32)
    tok_seq = np.array([0] * 6 + [1] * 5 + [2] + [0] * 4, np.int32)
    tok_pos = np.array(list(range(20, 26)) + list(range(5)) + [77]
                       + [-1] * 4, np.int32)
    tokens = rng.integers(0, cfg.vocab_size, len(tok_seq)).astype(np.int32)
    q_last = np.array([5, 10, 11, 0], np.int32)
    return tokens, tok_seq, tok_pos, q_last, bt


def _pools(rng, jm, n_pages, page):
    shapes = jax.tree.map(lambda z: z.shape,
                          jm.init_cache(n_pages, page, dtype=jnp.float32))
    return jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(i, int) for i in x))


def test_bridge_keeps_layout_and_values(tiny):
    jcfg, cfg, _, jparams = tiny
    np_tree = jax.tree.map(np.asarray, jparams)
    params = from_jax_params(np_tree, cfg)
    jl, tl = jax.tree.leaves(np_tree), tree_leaves(params)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    assert isinstance(params["groups"], tuple)
    with pytest.raises(ValueError):
        from_jax_params(np_tree, get_config("llama3.2-1b"))


def test_bridge_bfloat16_leaves(tiny):
    jcfg, cfg, jm, _ = tiny
    np_tree = jax.tree.map(np.asarray,
                           jm.init(jax.random.PRNGKey(1),
                                   dtype=jnp.bfloat16))
    params = from_jax_params(np_tree, cfg)
    emb = params["embed"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(np_tree["embed"].astype(np.float32),
                                  emb.float().numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_mixed_paged_matches_jax(tiny, seed):
    jcfg, cfg, jm, jparams = tiny
    rng = np.random.default_rng(seed)
    n_pages, page, max_pages = 48, 16, 8
    tokens, tok_seq, tok_pos, q_last, bt = _routing(rng, cfg, n_pages, page,
                                                    max_pages)
    pools = _pools(rng, jm, n_pages, page)
    j_ids, j_logits, j_pools = jm.forward_mixed_paged(
        jparams, *map(jnp.asarray, (tokens, tok_seq, tok_pos, q_last)),
        jax.tree.map(jnp.asarray, pools), jnp.asarray(bt))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    t_ids, t_logits, t_out = LM(cfg).forward_mixed_paged(
        params, *map(torch.from_numpy, (tokens, tok_seq, tok_pos, q_last)),
        t_pools, torch.from_numpy(bt))
    assert t_out is t_pools                      # updated in place
    assert t_ids.dtype == torch.int32
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    for jl, tl, before in zip(jax.tree.leaves(j_pools), tree_leaves(t_pools),
                              jax.tree.leaves(pools)):
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
        # slots the padded rows would have hit are untouched: only the 12
        # real tokens' slots changed, in every layer
        changed = np.any(tl.numpy() != before, axis=(3, 4))
        assert changed.sum() == 12 * tl.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_mixed_paged_samples_as_jax(tiny, seed):
    """``sampling=(temps, top_ks, top_ps, seeds)``: each row is sampled on
    the device at tok_pos[q_last] + 1; a greedy row, top-k, nucleus and
    both; the padded sequence row greedy. Ids equal the reference's."""
    jcfg, cfg, jm, jparams = tiny
    rng = np.random.default_rng(seed)
    tokens, tok_seq, tok_pos, q_last, bt = _routing(rng, cfg, 48, 16, 8)
    pools = _pools(rng, jm, 48, 16)
    samp = (np.array([0.0, 0.7, 1.3, 0.0], np.float32),
            np.array([0, 5, 0, 0], np.int32),
            np.array([1.0, 0.9, 0.3, 1.0], np.float32),
            np.array([3, -7, 2**31 - 1, 0], np.int32))
    j_ids, j_logits, _ = jm.forward_mixed_paged(
        jparams, *map(jnp.asarray, (tokens, tok_seq, tok_pos, q_last)),
        jax.tree.map(jnp.asarray, pools), jnp.asarray(bt),
        tuple(map(jnp.asarray, samp)))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    t_ids, t_logits, _ = LM(cfg).forward_mixed_paged(
        params, *map(torch.from_numpy, (tokens, tok_seq, tok_pos, q_last)),
        tree_map(lambda a: torch.from_numpy(a.copy()), pools),
        torch.from_numpy(bt), tuple(map(torch.from_numpy, samp)))
    assert t_ids.dtype == torch.int32
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    # the greedy rows are the argmax of the logits
    greedy = np.argmax(t_logits.numpy(), axis=-1)
    assert t_ids[0] == greedy[0] and t_ids[3] == greedy[3]


def test_forward_mixed_paged_refuses_unported(tiny):
    with pytest.raises(NotImplementedError):
        LM(get_config("deepseek-v3-671b", tiny=True)).init(
            torch.Generator(), dtype=torch.float32, device="cpu")


def test_init_cache_layout(tiny):
    jcfg, cfg, jm, _ = tiny
    jp = jm.init_cache(10, 16, dtype=jnp.float32)
    tp = LM(cfg).init_cache(10, 16, dtype=torch.float32, device="cpu")
    assert [tuple(x.shape) for x in jax.tree.leaves(jp)] == \
        [tuple(x.shape) for x in tree_leaves(tp)]


def _check_pools(j_pools, t_pools, before, n_written):
    for jl, tl, b in zip(jax.tree.leaves(j_pools), tree_leaves(t_pools),
                         jax.tree.leaves(before)):
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
        changed = np.any(tl.numpy() != b, axis=(3, 4))
        assert changed.sum() == n_written * tl.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_step_paged_matches_jax(tiny, seed):
    """A bucket of 4 decodes: deep, on a page boundary, the first token,
    and a padded row (ctx_lens 0, nothing written)."""
    jcfg, cfg, jm, jparams = tiny
    rng = np.random.default_rng(seed)
    n_pages, page, max_pages = 48, 16, 8
    bt = rng.permutation(n_pages)[:4 * max_pages].reshape(
        4, max_pages).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    ctx_lens = np.array([77, 16, 1, 0], np.int32)
    pools = _pools(rng, jm, n_pages, page)
    j_logits, j_pools = jm.decode_step_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(ctx_lens),
        jax.tree.map(jnp.asarray, pools), jnp.asarray(bt))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    t_logits, t_out = LM(cfg).decode_step_paged(
        params, *map(torch.from_numpy, (tokens, ctx_lens)), t_pools,
        torch.from_numpy(bt))
    assert t_out is t_pools                      # updated in place
    assert t_logits.shape == (4, cfg.vocab_size)
    np.testing.assert_allclose(t_logits[:3].numpy(),
                               np.asarray(j_logits)[:3], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t_logits[:3].argmax(-1).numpy(),
                                  np.asarray(j_logits)[:3].argmax(-1))
    _check_pools(j_pools, t_pools, pools, n_written=3)


@pytest.mark.parametrize("logits_index", [None, [4, 7]])
def test_extend_step_paged_matches_jax(tiny, logits_index):
    """Two chunks bucketed to T = 8 — one of 5 real tokens from position
    29 (across a page edge), one prefill of 8 from 0 — with the logits
    taken at the last position or at each row's last real token."""
    jcfg, cfg, jm, jparams = tiny
    rng = np.random.default_rng(3)
    n_pages, page, max_pages = 48, 16, 8
    bt = rng.permutation(n_pages)[:2 * max_pages].reshape(
        2, max_pages).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    start = np.array([29, 0], np.int32)
    n_new = np.array([5, 8], np.int32)
    pools = _pools(rng, jm, n_pages, page)
    li = None if logits_index is None else np.array(logits_index, np.int32)
    j_logits, j_pools = jm.extend_step_paged(
        jparams, *map(jnp.asarray, (tokens, start, n_new)),
        jax.tree.map(jnp.asarray, pools), jnp.asarray(bt),
        logits_index=None if li is None else jnp.asarray(li))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    t_logits, t_out = LM(cfg).extend_step_paged(
        params, *map(torch.from_numpy, (tokens, start, n_new)), t_pools,
        torch.from_numpy(bt),
        logits_index=None if li is None else torch.from_numpy(li))
    assert t_out is t_pools
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    _check_pools(j_pools, t_pools, pools, n_written=13)
