"""The SSM models' training path against the JAX reference, float32 on the
CPU: one ``make_train_step`` of tiny xlstm-350m (an mLSTM and an sLSTM
block) and tiny zamba2-1.2b (a mamba2 block and the shared attention
block) on bridged weights and the same batch, and ``chip_smoke.py``'s
SSM train phases rehearsed at the tiny configs.

On the CPU the port's GLA is ``chunked_gla_ref`` under autograd, the
oracle that the card's ``gla_scan`` and ``gla_scan_bwd`` are held
against (``tests/test_torch_gla_scan.py``). Tolerances, as
``tests/test_torch_training.py`` holds llama: the loss within 1e-5,
every gradient within 1e-4 of its leaf's largest magnitude (float32
products summed in another order by XLA and by PyTorch), except
mamba2's ``A_log``, held at 1e-3: its gradient is the sum over B x T of
d log_a x log_a, which cancels ~8x (its summands' absolute sum over the
sum, 8.3 and 6.7 for the two heads in a float64 run), so the summands'
float32 rounding reaches it ~8x magnified (the port lands 1.4e-4 from a
float64 run of itself, within that). grad_norm within 1e-4 relative, lr
equal. The updated params: Adam's first step
is lr * g / (|g| + eps) in both, about lr * sign(g), so where the
reference's gradient is above 1e-2 of its leaf's largest magnitude (the
gradients' 1e-4 cannot flip its sign) the two new params agree within
1e-6 + 1e-3 lr, and everywhere within 2 lr + 1e-6 (a sign that flips
where g is near 0).
"""
import sys
from pathlib import Path

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
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import loss_and_grads, make_train_step

ROOT = Path(__file__).resolve().parents[1]
# the batches' lengths: xlstm's runs the tiny mLSTM's chunks of 64 with
# the last one padded; zamba2's is 40, below the length where the
# reference's own float32 gradient turns NaN on this init (its
# chunked_gla forms exp(lb_i - lb_j) above the diagonal too and masks
# after the exp, 0 x inf: tests/test_torch_zamba2.py, ROADMAP queue 3)
MODELS = {"xlstm-350m": 100, "zamba2-1.2b": 40}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def _model(name):
    """(cfg, jm, jparams, params): the reference's seed-0 float32 init of
    the tiny config, bridged."""
    jm = JaxLM(jax_config(name, tiny=True))
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0),
                                          dtype=jnp.float32))
    cfg = get_config(name, tiny=True)
    return cfg, jm, jax.tree.map(jnp.asarray, tree), from_jax_params(tree,
                                                                     cfg)


def _sorted_leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _batch(cfg, T, B=2, seed=7):
    """Token ids, labels and a mask, from a seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    return tokens, labels, mask


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(name):
    """Loss and every gradient (``loss_and_grads`` against
    ``jax.value_and_grad`` of the reference's loss, remat on in both),
    then one ``make_train_step`` against the reference's: loss,
    grad_norm, lr and the updated params, at the module's tolerances."""
    from repro.training import optimizer as jo
    from repro.training.train_loop import make_train_step as jax_step
    cfg, jm, jparams, params = _model(name)
    tokens, labels, mask = _batch(cfg, MODELS[name])
    jt, jl, jmask = (jnp.asarray(a) for a in (tokens, labels, mask))
    tt, tl, tmask = (torch.from_numpy(a) for a in (tokens, labels, mask))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jt, jl, label_mask=jmask)[0])(jparams)
    loss, _, grads = loss_and_grads(LM(cfg), params, tt, tl, tmask)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    jleaves, leaves = [w for _, w in paths], _sorted_leaves(grads)
    assert len(jleaves) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and np.isfinite(w).all()
        rel = 1e-3 if "A_log" in jax.tree_util.keystr(path) else 1e-4
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max())
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=10)
    jnew, _, jmet = jax_step(jm, jo.AdamWConfig(**kw))(
        jparams, jo.adamw_init(jparams), jt, jl, jmask)
    new, opt, met = make_train_step(LM(cfg), AdamWConfig(**kw))(
        params, adamw_init(params), tt, tl, tmask)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    assert int(opt["step"]) == 1
    lr = float(jmet["lr"])
    for p, w, g in zip(_sorted_leaves(new), jax.tree.leaves(jnew),
                       jleaves):
        p, w, g = p.numpy(), np.asarray(w), np.abs(np.asarray(g))
        np.testing.assert_allclose(p, w, rtol=0, atol=2 * lr + 1e-6)
        firm = g > 1e-2 * g.max()
        np.testing.assert_allclose(p[firm], w[firm], rtol=0,
                                   atol=1e-6 + 1e-3 * lr)


def test_chip_smoke_ssm_train_rehearsals():
    """The tiny_train (llama, xlstm and zamba2), ssm_train_parity,
    xlstm_train and zamba2_train phases at the tiny configs on the CPU:
    the same control flow, checks and launch-count reads as on the card
    (no kernel launches here), and the recorder keeps the first GLA
    call's inputs (zamba2's q and k as stride-0 views over the heads) and
    the gradient that reached its y (none reached the final state)."""
    cs = _chip_smoke()
    cs.check_tiny_train(device="cpu")
    cs.check_ssm_train_parity(tiny=True, device="cpu")
    for phase, (model, *_) in cs.SSM_TRAIN.items():
        rec = cs.GLARecorder(grad=True)
        res = cs.train(rec, model=model, tiny=True, device="cpu", warm=2,
                       timed=6, batch=4, seq=128)
        assert len(res["losses"]) == 8 and res["max_memory_allocated"] is None
        assert all(v == 0 for v in res["launches"].values())
        q, k, v, la, kw = rec.operands()
        dy, ds = rec.grads()
        assert dy.shape == v.shape and ds is None
        assert q.shape[:3] == v.shape[:3] == la.shape and kw["chunk"] > 0
        assert (q.stride(1) == 0) == (phase == "zamba2_train")
    assert set(cs.GLA_BWD_KERNELS) <= set(cs.ROWS)
    assert {"ssm_train_parity", *cs.SSM_TRAIN} <= set(cs.PHASES)
