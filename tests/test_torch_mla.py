"""MLA (deepseek-v3's latent attention) in the port, against the JAX
package on the CPU, and the latent-attention kernel on the card.

On tiny deepseek-v3 (a dense layer, then an MoE layer; 4 heads, q_lora 64,
kv_lora 32, nope 32, rope 16, v 32) with weights bridged from the
reference's seed-0 ``LM.init``, float32:

* layer 0's ``_mla_q`` / ``_mla_latent``, ``mla_forward`` (the flash
  path, qk 48 padded to 64 with scale 1 / sqrt(48)), ``mla_decode`` /
  ``mla_extend`` over slotted latent caches and the three paged functions
  against the reference's; ``ragged_latent_attention_ref`` against the
  attention inside ``mla_mixed_paged`` (the reference's einsums);
* the init's tree, the bridge's MLA leaves, ``LM.forward`` / ``loss``,
  ``extend_step`` then ``decode_step``, the three paged entry points,
  ``prefill_step`` / ``serve_step`` and the launcher;
* the engine under ``infercept`` and ``swap``, fused and unfused, with the
  prefix cache and with ``kv_dtype="int8"`` (MLA's latent pools stay
  float32 and carry no scales): streams, counters (the MLA gather bytes
  among them), scheduler stats, ledger causes and clock equal to the JAX
  engine's; DESIGN.md §6 inside the port: gather, fused and unfused
  streams identical under the 4 policies (capacity factor 8.0: nothing
  drops on any path);
* chip_smoke.py's MLA phases rehearsed at the tiny config.

On a CUDA card (``-m gpu``): the ragged latent-attention kernel against
its plain version at the tiny and full widths and at H 24 over float32
and bfloat16 pools (a ragged call of chunk, decode, padded and
page-boundary rows; bf16 pools at the full widths take the tensor-core
form, the rest the CUDA-core form) and decodes up to 8192 keys, a row's
bits equal in calls of N 1, N 31 and N 93 in each form, the flash
forward at head_dim 192 against its plain version, and
``mla_mixed_paged`` (kv_append at the latent widths, then the kernel)
against the same call on the CPU. The
card's machine has no JAX: the reference is imported inside the CPU tests
only, and the card runs ``PYTHONPATH=src python -m pytest -q --noconftest
-m gpu tests/test_torch_mla.py``.

Tolerances: the latent and queries 1e-6 of their largest magnitude
(float32, products summed in other orders); layer outputs 1e-4 and pools within 2e-6 of their largest
magnitude (what the reference's XLA and PyTorch round apart), the slots
no row writes exactly equal; hidden states and logits 2e-4, the paged
entry points' logits 1e-4, caches and pools 2e-5 of each leaf's largest
magnitude and losses 1e-5 relative, as ``tests/test_torch_moe.py`` holds
them; ids and streams exactly equal. On the card: the kernel 1e-4 over
float32 pools and 2e-3 over bfloat16 (the plain version reads the same
bf16 latents; only the sums' order differs), flash at 192 1e-4 / 3e-2
as ``tests/test_torch_flash_attention.py`` holds it.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.mla_attention import (ragged_latent_attention,
                                               ragged_latent_attention_ref)
from repro_torch.models import attention
from repro_torch.models.model import LM
from repro_torch.utils.tree import tree_leaves, tree_map

MODEL = "deepseek-v3-671b"
ROOT = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wide():
    """tests/wide_models.py, which imports JAX: for the CPU tests only."""
    sys.path.insert(0, str(ROOT))
    try:
        import wide_models
    finally:
        sys.path.pop(0)
    return wide_models


def model():
    return wide().tiny_model(MODEL)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _close_leaves(got, want, rel=2e-5):
    import jax
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=rel * np.abs(j).max())


# ---------------------------------------------------------------------------
# layer 0's MLA functions against the reference's
# ---------------------------------------------------------------------------
def _layer():
    """(reference attention module, AttentionCfg of either package, layer
    0's JAX attention params, the same as torch tensors, d_model)."""
    import jax
    from repro.models import attention as jax_attention
    jcfg, cfg, _, jparams, params = model()
    jp = jax.tree.map(lambda a: a[0],
                      jparams["groups"][0]["scan"]["b0"]["attn"])
    tp = tree_map(lambda t: t[0], params["groups"][0]["scan"]["b0"]["attn"])
    return (jax_attention, jcfg.groups[0].period[0].attn,
            cfg.groups[0].period[0].attn, jp, tp, cfg.d_model)


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_config_is_mla():
    cfg = get_config(MODEL, tiny=True)
    a = cfg.blocks[0].attn
    assert a.kind == "mla" and (a.kv_lora_rank, a.qk_rope_head_dim) == (
        32, 16)
    full = get_config(MODEL).blocks[0].attn
    assert (full.n_heads, full.kv_lora_rank, full.qk_rope_head_dim,
            full.qk_nope_head_dim + full.qk_rope_head_dim) == (128, 512, 64,
                                                               192)


def test_latent_and_queries_match_reference():
    import jax.numpy as jnp
    J, ja, a, jp, tp, d = _layer()
    x = _x(np.random.default_rng(0), 2, 9, d)
    pos = np.arange(3, 12, dtype=np.int32)
    jc, jkr = J._mla_latent(jp, ja, jnp.asarray(x), jnp.asarray(pos))
    c, kr = attention._mla_latent(tp, a, torch.from_numpy(x),
                                  torch.from_numpy(pos))
    jqn, jqr = J._mla_q(jp, ja, jnp.asarray(x), jnp.asarray(pos))
    qn, qr = attention._mla_q(tp, a, torch.from_numpy(x),
                              torch.from_numpy(pos))
    for got, want in ((c, jc), (kr, jkr), (qn, jqn), (qr, jqr)):
        assert tuple(got.shape) == np.shape(want)
        _close(got, want, 1e-6 * np.abs(np.asarray(want)).max())


def test_mla_forward_matches_reference():
    import jax.numpy as jnp
    J, ja, a, jp, tp, d = _layer()
    x = _x(np.random.default_rng(1), 2, 40, d)
    pos = np.arange(40, dtype=np.int32)
    jout, jcache = J.mla_forward(jp, ja, jnp.asarray(x), jnp.asarray(pos))
    out, cache = attention.attention_forward(tp, a, torch.from_numpy(x),
                                             torch.from_numpy(pos))
    _close(out, jout, 1e-4)
    assert set(cache) == {"c", "kr"}
    for k in cache:
        _close(cache[k], jcache[k], 1e-6 * np.abs(np.asarray(jcache[k])).max())


def _slotted(rng, a, B, S):
    return {"c": _x(rng, B, S, a.kv_lora_rank),
            "kr": _x(rng, B, S, a.qk_rope_head_dim)}


def test_mla_decode_and_extend_match_reference():
    """Over slotted latent caches: a chunk at 20 (extend), then a decode
    whose position wraps the ring (decode at 70 over 64 slots)."""
    import jax.numpy as jnp
    J, ja, a, jp, tp, d = _layer()
    rng = np.random.default_rng(2)
    cache = _slotted(rng, a, 2, 64)
    x = _x(rng, 2, 12, d)
    start = np.array([20, 3], np.int32)
    jout, jc = J.mla_extend(jp, ja, jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(start))
    out, c = attention.attention_extend(
        tp, a, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in cache.items()},
        torch.from_numpy(start))
    _close(out, jout, 1e-4)
    _close_leaves(c, jc, 2e-6)
    xd = _x(rng, 2, d)
    pos = np.array([70, 31], np.int32)
    jout, jc = J.mla_decode(jp, ja, jnp.asarray(xd),
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(pos))
    out, c = attention.attention_decode(
        tp, a, torch.from_numpy(xd),
        {k: torch.from_numpy(v) for k, v in cache.items()},
        torch.from_numpy(pos))
    _close(out, jout, 1e-4)
    _close_leaves(c, jc, 2e-6)


N_PAGES, PAGE, MAX_PAGES = 40, 16, 8


def _paged_case(rng, a):
    pools = {"c": _x(rng, N_PAGES, PAGE, a.kv_lora_rank),
             "kr": _x(rng, N_PAGES, PAGE, a.qk_rope_head_dim)}
    bt = rng.permutation(N_PAGES)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32)
    return pools, bt


@pytest.mark.parametrize("entry", ["mixed", "decode", "extend"])
def test_paged_functions_match_reference(entry):
    """mla_mixed_paged (a chunk at 50, a prefill, a decode at 90, a row
    ending on a page boundary, padding), mla_decode_paged (deep, page
    boundary, first token, padded row) and mla_extend_paged (n_new short
    of T): outputs of the real rows within 1e-4, the pools' written slots
    within 2e-6 of their largest magnitude and every other slot
    untouched."""
    import jax.numpy as jnp
    J, ja, a, jp, tp, d = _layer()
    rng = np.random.default_rng(3)
    pools, bt = _paged_case(rng, a)
    t_pools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    j_pools = {k: jnp.asarray(v) for k, v in pools.items()}
    if entry == "mixed":
        tok_seq = np.array([0] * 6 + [1] * 5 + [2, 3] + [0] * 3, np.int32)
        tok_pos = np.array(list(range(50, 56)) + list(range(5)) + [90, 31]
                           + [-1] * 3, np.int32)
        x = _x(rng, 16, d)
        jout, jnew = J.mla_mixed_paged(
            jp, ja, jnp.asarray(x), j_pools, jnp.asarray(bt),
            jnp.asarray(tok_seq), jnp.asarray(tok_pos))
        out = attention.attention_mixed_paged(
            tp, a, torch.from_numpy(x), t_pools, torch.from_numpy(bt),
            torch.from_numpy(tok_seq), torch.from_numpy(tok_pos))
        real = tok_pos >= 0
        assert torch.all(out[torch.from_numpy(~real)] == 0)
        _close(out[torch.from_numpy(real)], np.asarray(jout)[real], 1e-4)
        n_written = int(real.sum())
    elif entry == "decode":
        ctx = np.array([100, 16, 1, 0], np.int32)
        x = _x(rng, 4, d)
        jout, jnew = J.mla_decode_paged(jp, ja, jnp.asarray(x), j_pools,
                                        jnp.asarray(bt), jnp.asarray(ctx))
        out = attention.attention_decode_paged(
            tp, a, torch.from_numpy(x), t_pools, torch.from_numpy(bt),
            torch.from_numpy(ctx))
        _close(out[:3], np.asarray(jout)[:3], 1e-4)
        n_written = 3
    else:
        x = _x(rng, 2, 8, d)
        start, n_new = np.array([40, 0], np.int32), np.array([5, 8],
                                                             np.int32)
        jout, jnew = J.mla_extend_paged(
            jp, ja, jnp.asarray(x), j_pools, jnp.asarray(bt[:2]),
            jnp.asarray(start), jnp.asarray(n_new))
        out = attention.attention_extend_paged(
            tp, a, torch.from_numpy(x), t_pools, torch.from_numpy(bt[:2]),
            torch.from_numpy(start), torch.from_numpy(n_new))
        _close(out[0, :5], np.asarray(jout)[0, :5], 1e-4)
        _close(out[1], np.asarray(jout)[1], 1e-4)
        n_written = 13
    _close_leaves(t_pools, jnew, 2e-6)
    for k, before in pools.items():
        changed = np.any(t_pools[k].numpy() != before, axis=-1)
        assert changed.sum() == n_written, k


def test_ragged_latent_ref_matches_reference_einsums():
    """The plain version against the attention inside the reference's
    mla_mixed_paged, its einsums in jnp on the same q_lat / q_rope and
    pools; padded rows are zeros here (garbage there)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    H, L, R = 4, 32, 16
    pools = {"c": _x(rng, N_PAGES, PAGE, L), "kr": _x(rng, N_PAGES, PAGE, R)}
    bt = rng.permutation(N_PAGES)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32)
    tok_seq = np.array([0, 0, 1, 2, 3, 3, 0], np.int32)
    tok_pos = np.array([0, 17, 63, 127, 15, 16, -1], np.int32)
    q_lat, q_rope = _x(rng, 7, H, L), _x(rng, 7, H, R)
    scale = 1 / math.sqrt(48)
    S = MAX_PAGES * PAGE
    bt_tok = jnp.asarray(bt)[jnp.asarray(tok_seq)]
    c_cache = jnp.asarray(pools["c"])[bt_tok].reshape(7, S, -1)
    kr_cache = jnp.asarray(pools["kr"])[bt_tok].reshape(7, S, -1)
    s = (jnp.einsum("bhl,bsl->bhs", q_lat, c_cache)
         + jnp.einsum("bhr,bsr->bhs", q_rope, kr_cache)) / math.sqrt(48)
    live = jnp.arange(S)[None, :] <= jnp.asarray(tok_pos)[:, None]
    s = jnp.where(live[:, None, :], s, -1e30)
    want = jnp.einsum("bhs,bsl->bhl", jax.nn.softmax(s, axis=-1), c_cache)
    got = ragged_latent_attention_ref(
        torch.from_numpy(q_lat), torch.from_numpy(q_rope),
        torch.from_numpy(pools["c"]), torch.from_numpy(pools["kr"]),
        torch.from_numpy(bt), torch.from_numpy(tok_seq),
        torch.from_numpy(tok_pos), scale)
    _close(got[:6], np.asarray(want)[:6], 1e-5)
    assert torch.all(got[6] == 0)


def test_latent_kernel_refuses_cpu_and_bad_widths():
    """The wrapper launches its kernel or raises; it takes L a multiple of
    16 up to 512 and R a multiple of 8 up to 64."""
    from repro_torch.kernels import mla_attention as ma
    z, i32 = torch.zeros, torch.int32
    args = (z(2, 4, 32), z(2, 4, 16), z(8, 16, 32), z(8, 16, 16),
            z(1, 4, dtype=i32), z(2, dtype=i32), z(2, dtype=i32))
    with pytest.raises(ValueError, match="CUDA"):
        ragged_latent_attention(*args, 0.1)
    ma._check(*args)
    for L, R in ((24, 16), (544, 16), (32, 4), (32, 72)):
        with pytest.raises(ValueError, match="not taken"):
            ma._check(z(2, 4, L), z(2, 4, R), z(8, 16, L), z(8, 16, R),
                      *args[4:])
    with pytest.raises(TypeError):
        ma._check(args[0].double(), *args[1:])


# ---------------------------------------------------------------------------
# tiny deepseek-v3
# ---------------------------------------------------------------------------
def _shapes(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _shapes(tree[key], path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _shapes(t, path + (i,)).items()}
    return {path: tuple(np.shape(tree))}


def test_init_and_bridge_carry_the_mla_leaves():
    """LM.init makes the reference's tree; the bridge carries every MLA
    leaf across unchanged (float32) and casts it with the model (bf16),
    the router staying float32."""
    import jax
    from repro_torch.models.bridge import from_jax_params
    _, cfg, _, jparams, params = model()
    own = LM(cfg).init(torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    assert _shapes(own) == _shapes(jparams)
    leaves = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv",
              "wo")
    for gi in (0, 1):
        assert set(params["groups"][gi]["scan"]["b0"]["attn"]) == set(leaves)
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    bf = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                         dtype=torch.bfloat16)
    attn = bf["groups"][1]["scan"]["b0"]["attn"]
    assert all(attn[k].dtype == torch.bfloat16 for k in leaves)
    assert bf["groups"][1]["scan"]["b0"]["moe"]["router"].dtype == \
        torch.float32


def test_forward_and_loss_match_reference():
    import jax.numpy as jnp
    _, cfg, jm, jparams, params = model()
    lm = LM(cfg)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jout = jm.forward(jparams, jnp.asarray(toks))
    out = lm.forward(params, torch.from_numpy(toks))
    _close(out.hidden, jout.hidden, 2e-4)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jm.loss(jparams, jnp.asarray(toks), jnp.asarray(labels))
    tl, _ = lm.loss(params, torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_extend_then_decode_match_reference():
    """Two extend_step chunks and 8 decode_step calls over slotted latent
    caches; the forward's return_cache_len gives the same caches."""
    import jax.numpy as jnp
    _, cfg, jm, jparams, params = model()
    lm = LM(cfg)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)
    jcache = jm.init_cache(2, 64, dtype=jnp.float32)
    cache = lm.init_cache(2, 64, dtype=torch.float32, device="cpu")
    start = np.zeros(2, np.int32)
    for lo, hi in ((0, 24), (24, 40)):
        jl, jcache = jm.extend_step(jparams, jnp.asarray(toks[:, lo:hi]),
                                    jnp.asarray(start + lo), jcache)
        tl, cache = lm.extend_step(params, torch.from_numpy(toks[:, lo:hi]),
                                   torch.from_numpy(start + lo), cache)
        _close(tl, jl, 2e-4)
        _close_leaves(cache, jcache)
    fwd = lm.forward(params, torch.from_numpy(toks[:, :40]),
                     return_cache_len=64).cache
    _close_leaves(fwd, jcache)
    for pos in range(40, 48):
        p = np.full(2, pos, np.int32)
        jl, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, pos]),
                                    jnp.asarray(p), jcache)
        tl, cache = lm.decode_step(params, torch.from_numpy(toks[:, pos]),
                                   torch.from_numpy(p), cache)
        _close(tl, jl, 2e-4)
        assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    _close_leaves(cache, jcache)


@pytest.mark.parametrize("entry", ["forward_mixed_paged",
                                   "decode_step_paged", "extend_step_paged"])
def test_paged_entry_points_match_reference(entry):
    import jax
    import jax.numpy as jnp
    _, cfg, jm, jparams, params = model()
    lm = LM(cfg)
    rng = np.random.default_rng(7)
    bt = rng.permutation(N_PAGES)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32)
    shapes = jax.tree.map(lambda z: z.shape,
                          jm.init_cache(N_PAGES, PAGE, dtype=jnp.float32))
    pools = jax.tree.map(lambda s: _x(rng, *s), shapes,
                         is_leaf=lambda s: isinstance(s, tuple) and all(
                             isinstance(i, int) for i in s))
    t_pools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    j_pools = jax.tree.map(jnp.asarray, pools)
    if entry == "forward_mixed_paged":
        tok_seq = np.array([0] * 6 + [1] * 5 + [2] + [0] * 4, np.int32)
        tok_pos = np.array(list(range(50, 56)) + list(range(5)) + [90]
                           + [-1] * 4, np.int32)
        tokens = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        args = (tokens, tok_seq, tok_pos, np.array([5, 10, 11, 0], np.int32))
        j_ids, jl, j_pools = jm.forward_mixed_paged(
            jparams, *map(jnp.asarray, args), j_pools, jnp.asarray(bt))
        t_ids, tl, _ = lm.forward_mixed_paged(
            params, *map(torch.from_numpy, args), t_pools,
            torch.from_numpy(bt))
        np.testing.assert_array_equal(t_ids.numpy()[:3],
                                      np.asarray(j_ids)[:3])
        rows = slice(0, 3)
    elif entry == "decode_step_paged":
        tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
        ctx_lens = np.array([100, 16, 1, 0], np.int32)
        jl, j_pools = jm.decode_step_paged(
            jparams, jnp.asarray(tokens), jnp.asarray(ctx_lens), j_pools,
            jnp.asarray(bt))
        tl, _ = lm.decode_step_paged(
            params, *map(torch.from_numpy, (tokens, ctx_lens)), t_pools,
            torch.from_numpy(bt))
        rows = slice(0, 3)
    else:
        tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        start, n_new = np.array([40, 0], np.int32), np.array([5, 8], np.int32)
        index = np.array([4, 7], np.int32)
        jl, j_pools = jm.extend_step_paged(
            jparams, *map(jnp.asarray, (tokens, start, n_new)), j_pools,
            jnp.asarray(bt[:2]), logits_index=jnp.asarray(index))
        tl, _ = lm.extend_step_paged(
            params, *map(torch.from_numpy, (tokens, start, n_new)), t_pools,
            torch.from_numpy(bt[:2]), logits_index=torch.from_numpy(index))
        rows = slice(0, 2)
    _close(tl[rows], np.asarray(jl)[rows], 1e-4)
    assert tl[rows].argmax(-1).tolist() == \
        np.asarray(jl)[rows].argmax(-1).tolist()
    _close_leaves(t_pools, j_pools)


def test_prefill_and_serve_steps_match_reference():
    """launch/steps.py: prefill_step of 2 x 20 (the flash path), then 4
    greedy serve_step calls over the slotted latent caches."""
    import jax.numpy as jnp
    from repro.launch.steps import build_prefill_step as jax_prefill_step
    from repro.launch.steps import build_serve_step as jax_serve_step
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    jcfg, cfg, _, jparams, params = model()
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    _, jprefill = jax_prefill_step(jcfg, 32)
    _, jserve = jax_serve_step(jcfg)
    _, prefill = build_prefill_step(cfg, 32)
    _, serve = build_serve_step(cfg)
    jl, jcache = jprefill(jparams, jnp.asarray(toks))
    tl, cache = prefill(params, torch.from_numpy(toks))
    _close(tl, jl, 2e-4)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    tok = tl.argmax(-1).to(torch.int32)
    for i in range(4):
        pos = np.full(2, 20 + i, np.int32)
        jl, jtok, jcache = jserve(jparams, jcache, jtok, jnp.asarray(pos))
        tl, tok, cache = serve(params, cache, tok, torch.from_numpy(pos))
        _close(tl, jl, 2e-4)
        assert tok.tolist() == np.asarray(jtok).tolist()


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", MODEL, "--tiny", "--device", "cpu", "--requests",
                "3", "--tool-workers", "0"])
    out = capsys.readouterr().out
    assert "finished=4/4" in out and "live session: state=finished" in out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
ENGINE_CASES = {"infercept": ("infercept", {}), "swap": ("swap", {}),
                "infercept-unfused": ("infercept", {"fused": False}),
                "swap-unfused": ("swap", {"fused": False}),
                "infercept-prefix": ("infercept", {"prefix_cache": True}),
                "swap-prefix-unfused": ("swap", {"prefix_cache": True,
                                                 "fused": False}),
                "infercept-int8": ("infercept", {"kv_dtype": "int8"}),
                "swap-int8-unfused": ("swap", {"kv_dtype": "int8",
                                               "fused": False})}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine(case):
    """Streams, counters (prefill_bytes and decode_bytes price the
    reference's per-row latent gathers: kv_mla_token_bytes), stats,
    ledger causes and clock equal to the JAX engine's."""
    policy, kw = ENGINE_CASES[case]
    jcfg, cfg, _, _, params = model()
    fin = wide().engine_matches_jax(jcfg, cfg, params, policy, **kw)
    assert fin


def test_engine_prices_the_latent_gather():
    """kv_mla_token_bytes is every MLA layer's latent bytes a token (all
    layers here): (kv_lora + rope) x 4 B x 2 layers; int8 leaves the
    latent pools float32, with no scale leaves."""
    _, cfg, _, _, params = model()
    _, eng, _ = wide().port_run(cfg, params, "infercept")
    assert eng.kv_mla_token_bytes == eng.kv_token_bytes == (32 + 16) * 4 * 2
    _, eng8, _ = wide().port_run(cfg, params, "infercept", kv_dtype="int8")
    assert all(t.dtype == torch.float32 for t in tree_leaves(eng8.pools))
    assert all(set(e) == {"c", "kr"} for entry in eng8.pools
               for e in entry.values())
    assert eng8.kv_mla_token_bytes == eng.kv_mla_token_bytes


def test_sanitized_engine_is_clean(oracle):
    """Engine(sanitize=True) audits the latent pool tree's pages at every
    plan (fused and int8 unfused): no findings, and the gather oracle's
    streams."""
    _, cfg, _, _, params = model()
    for kw in (dict(), dict(kv_dtype="int8", fused=False)):
        got, eng, _ = wide().port_run(cfg, params, "infercept",
                                      sanitize=True, **kw)
        assert eng.sanitizer.findings == []
        assert got == oracle, kw


@pytest.fixture(scope="module")
def oracle():
    _, cfg, _, _, params = model()
    return wide().port_run(cfg, params, "vllm", paged=False)[0]


@pytest.mark.parametrize("policy", ["preserve", "vllm", "swap", "infercept"])
def test_streams_identical_across_paths(oracle, policy):
    """DESIGN.md §6 inside the port: the gather, fused and unfused paths
    emit the gather oracle's streams under every policy."""
    _, cfg, _, _, params = model()
    wide().paths_agree(oracle, cfg, params, policy)


# ---------------------------------------------------------------------------
# chip_smoke.py's MLA phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_mla_serve_rehearsal():
    cs = wide().chip_smoke()
    rec = cs.MLARecorder()
    policy, kw = cs.MLA_SERVE_PHASES["mla_serve"]
    with rec:
        res = cs.serve(policy, tiny=True, device="cpu", model=cs.MLA_MODEL,
                       periods=cs.MLA_SERVE_PERIODS, **kw)
    assert res["finished"] == res["requests"]
    assert res["model"] == "deepseek-v3-671b-tiny-periods3x1"
    assert all(v == 0 for v in res["launches"].values())
    assert rec.decode_launches > 0
    args, _ = rec.call("mla_attention", device="cpu")
    nbytes, ops = cs.latent_work(args)
    assert nbytes > 0 and ops > 0


def test_chip_smoke_latent_work_counts_live_rows():
    """Row 10's bound: the latent pages the live rows reach, the live rows'
    queries (a padded row's block reads none) and every row's output."""
    cs = wide().chip_smoke()
    N, H, L, R, page = 3, 2, 16, 8, 4
    c = torch.zeros(4, page, L, dtype=torch.bfloat16)
    kr = torch.zeros(4, page, R, dtype=torch.bfloat16)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    seq = torch.tensor([0, 0, 1], dtype=torch.int32)
    q_lat, q_rope = torch.zeros(N, H, L), torch.zeros(N, H, R)

    def work(pos):
        return cs.latent_work((q_lat, q_rope, c, kr, bt, seq,
                               torch.tensor(pos, dtype=torch.int32), 0.1))
    full, padded = work([5, 2, 3]), work([5, -1, 3])
    # pages 0, 1 (row 0, whose pages hold row 1's) and 2 (row 2)
    assert full[0] == (3 * page * (L + R) * 2 + N * H * (L + R) * 4
                       + N * H * L * 4 + (N + N + bt.numel()) * 4)
    assert full[0] - padded[0] == H * (L + R) * 4
    assert full[1] - padded[1] == 3 * H * 2 * (2 * L + R)


def test_chip_smoke_mla_parity_rehearsal():
    """mla_parity's legs at the tiny config with 3 dense layers and no
    MoE layer, the LM.forward leg among them."""
    cs = wide().chip_smoke()
    r = cs.paths_parity(torch.float32, conditioned=True, tiny=True,
                        device="cpu", model=cs.MLA_MODEL,
                        periods=cs.MLA_PARITY_PERIODS, lens=[37, 90, 16],
                        forward_leg=True)
    assert r["model"] == "deepseek-v3-671b-tiny-periods3x0"
    for leg in ("prefill", "decode", "gather", "forward"):
        assert r[f"{leg}_err"] <= 1e-4, leg
        assert r[f"{leg}_ids"][0] == r[f"{leg}_ids"][1], leg
    (pe, pt), (de, dt) = r["prefill_pools"], r["decode_pools"]
    assert pe <= 1e-4 * pt and de <= 1e-4 * dt
    assert r["gather_cache"][0] <= 1e-4 * r["gather_cache"][1]
    wf, wu, wt = r["layer0_witness"]
    assert max(wf, wu) <= 1e-5 * wt


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _latent_call(gen, *, H, L, R, dtype, device, page=16, max_pages=16):
    """A ragged call over random pools: a 20-token chunk at 30, a prefill
    of 5, decodes at 255 (the table's last key) and at 15 (a page's last
    slot), a first token, and 3 padded rows."""
    n_pages = 4 * max_pages + 1
    kw = dict(device=device, dtype=torch.float32)
    c = torch.randn((n_pages, page, L), generator=gen, **kw).to(dtype)
    kr = torch.randn((n_pages, page, R), generator=gen, **kw).to(dtype)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=device)[
        :4 * max_pages] + 1).reshape(4, max_pages).to(torch.int32)
    seq = [0] * 20 + [1] * 5 + [2, 3, 1] + [0] * 3
    pos = list(range(30, 50)) + list(range(5)) + [255, 15, 0] + [-1] * 3
    i32 = dict(device=device, dtype=torch.int32)
    N = len(seq)
    q_lat = torch.randn((N, H, L), generator=gen, **kw)
    q_rope = torch.randn((N, H, R), generator=gen, **kw)
    return (q_lat, q_rope, c, kr, bt, torch.tensor(seq, **i32),
            torch.tensor(pos, **i32), 1 / math.sqrt(192))


WIDTHS = {"tiny": (4, 32, 16), "full": (128, 512, 64),
          "full_h24": (24, 512, 64)}


def _launch_forms(args):
    """Launch the kernel once; returns (out, the form it took: True for
    the tensor-core form), checked against the wrapper's counts."""
    before = (ragged_latent_attention.launches,
              ragged_latent_attention.tc_launches)
    got = ragged_latent_attention(*args)
    tc = ragged_latent_attention.tc_launches - before[1]
    assert ragged_latent_attention.launches == before[0] + 1
    assert tc in (0, 1)
    return got, bool(tc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_gpu_latent_kernel_matches_plain(cuda, dtype, width):
    """Each form against the plain version: bf16 pools at L 512, R 64 take
    the tensor-core form (H 24: a head tile padded), the rest the
    CUDA-core form."""
    H, L, R = WIDTHS[width]
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _latent_call(gen, H=H, L=L, R=R, dtype=dtype, device=cuda)
    got, tc = _launch_forms(args)
    want = ragged_latent_attention_ref(*args)
    assert tc == (dtype == torch.bfloat16 and width != "tiny")
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 if dtype == torch.float32 else 2e-3)
    assert torch.all(got[-3:] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_latent_kernel_long_context(cuda, dtype):
    """Decodes over tables of 512 pages, up to 8192 keys, at the full
    widths, in each form."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    args = list(_latent_call(gen, H=128, L=512, R=64, dtype=dtype,
                             device=cuda, max_pages=512))
    i32 = dict(device=cuda, dtype=torch.int32)
    args[5] = torch.tensor([0, 1, 2, 3, 0], **i32)
    args[6] = torch.tensor([8191, 5000, 4096, 31, -1], **i32)
    args[0], args[1] = args[0][:5].contiguous(), args[1][:5].contiguous()
    got, tc = _launch_forms(args)
    assert tc == (dtype == torch.bfloat16)
    torch.testing.assert_close(got, ragged_latent_attention_ref(*args),
                               rtol=0, atol=1e-4)
    assert torch.all(got[-1] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [128, 24])
def test_gpu_latent_kernel_rows_do_not_depend_on_the_call(cuda, dtype, H):
    """Rows alone (N 1), and all rows in a call of three copies of them:
    the same bits as in the call of N 31, in each form."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = list(_latent_call(gen, H=H, L=512, R=64, dtype=dtype,
                             device=cuda))
    full = ragged_latent_attention(*args)
    for i in (0, 19, 25, 26):
        one = ragged_latent_attention(
            args[0][i:i + 1], args[1][i:i + 1], *args[2:5],
            args[5][i:i + 1], args[6][i:i + 1], args[7])
        assert torch.equal(one[0], full[i])
    big = ragged_latent_attention(
        args[0].repeat(3, 1, 1), args[1].repeat(3, 1, 1), *args[2:5],
        args[5].repeat(3), args[6].repeat(3), args[7])
    assert torch.equal(big[:args[0].shape[0]], full)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_flash_forward_at_head_dim_192(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((1, 8, 1, 300, 192), generator=gen, device=cuda).to(dtype)
    k = torch.randn((1, 8, 300, 192), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, 8, 300, 192), generator=gen, device=cuda).to(dtype)
    got, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-4 if dtype == torch.float32 else 3e-2)


@pytest.mark.gpu
def test_gpu_mla_mixed_paged_matches_cpu(cuda):
    """Tiny deepseek-v3's layer 0 on its own init (float32): the card's
    append (kv_append at the latent widths) and latent kernel against the
    CPU's plain versions, outputs and pools."""
    cfg = get_config(MODEL, tiny=True)
    a = cfg.blocks[0].attn
    p = attention.init_mla(torch.Generator().manual_seed(0), cfg.d_model, a,
                           dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(9)
    pools = {"c": torch.from_numpy(_x(rng, N_PAGES, PAGE, a.kv_lora_rank)),
             "kr": torch.from_numpy(_x(rng, N_PAGES, PAGE,
                                       a.qk_rope_head_dim))}
    bt = torch.from_numpy(rng.permutation(N_PAGES)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32))
    tok_seq = torch.tensor([0] * 6 + [1] * 5 + [2, 3] + [0] * 3,
                           dtype=torch.int32)
    tok_pos = torch.tensor(list(range(50, 56)) + list(range(5)) + [90, 31]
                           + [-1] * 3, dtype=torch.int32)
    x = torch.from_numpy(_x(rng, 16, cfg.d_model))
    cpu_pools = tree_map(torch.clone, pools)
    want = attention.mla_mixed_paged(p, a, x, cpu_pools, bt, tok_seq,
                                     tok_pos)
    dev = tree_map(lambda t: t.to(cuda), (p, pools, x, bt, tok_seq,
                                          tok_pos))
    got = attention.mla_mixed_paged(dev[0], a, dev[2], dev[1], *dev[3:])
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    for k in pools:
        torch.testing.assert_close(dev[1][k].cpu(), cpu_pools[k], rtol=0,
                                   atol=1e-5)
