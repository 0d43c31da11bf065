"""The port's training loop, checkpoints and CLI: the loop's loss falls
as the reference's does, checkpoints round-trip and load from either
package into the other (float32), and ``repro_torch.launch.train`` runs
on the CPU when asked and needs a card otherwise."""
import json
import os
import subprocess
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
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import train_loop
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist beside JAX workers on a few cores;
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("llama3.2-1b", tiny=True)
    cfg = get_config("llama3.2-1b", tiny=True)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    return cfg, jparams, params


def test_loss_decreases():
    """As tests/test_training.py::test_loss_decreases, on the port."""
    cfg = get_config("llama3.2-1b", tiny=True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=16, seed=0))
    state, history = train_loop(
        cfg, steps=60, data_iter=data.batches(),
        opt_cfg=AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60),
        device="cpu", log_every=10)
    first, last = history[0]["loss"], history[-1]["loss"]
    assert last < first - 0.5, f"loss did not decrease: {first} -> {last}"


def test_train_loop_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b", tiny=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(cfg, steps=1, data_iter=iter(()))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path, tiny):
    cfg, _, params = tiny
    state = {"params": params, "opt": adamw_init(params)}
    path = save_checkpoint(str(tmp_path), 42, state, shard_bytes=1 << 20)
    assert latest_checkpoint(str(tmp_path)) == path
    assert len(list(Path(path).glob("shard_*.npz"))) > 1
    restored = load_checkpoint(path, state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    bf = tree_map(lambda t: t.bfloat16(), params)
    back = load_checkpoint(save_checkpoint(str(tmp_path), 43, bf), bf)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(bf),
                                                  tree_leaves(back)))


def _keyed(tree, prefix=""):
    """{jax keystr: leaf} of a port tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _keyed(sub, f"{prefix}[{key!r}]").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _keyed(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def test_checkpoints_cross_load_between_packages(tmp_path, tiny):
    from repro.training import checkpoint as jck
    from repro.training.optimizer import adamw_init as jax_adamw_init
    cfg, jparams, params = tiny
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    jkeyed = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
              in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    tstate = {"params": params, "opt": adamw_init(params)}
    assert sorted(_keyed(tstate)) == sorted(jkeyed)
    # JAX -> port
    jpath = jck.save_checkpoint(str(tmp_path / "j"), 1, jstate,
                                shard_bytes=1 << 20)
    for k, leaf in _keyed(load_checkpoint(jpath, tstate)).items():
        assert leaf.dtype == _keyed(tstate)[k].dtype
        np.testing.assert_array_equal(leaf.numpy(), jkeyed[k])
    # port -> JAX, with the same archive keys in the same shards
    tpath = save_checkpoint(str(tmp_path / "t"), 1, tstate,
                            shard_bytes=1 << 20)
    back = jck.load_checkpoint(tpath, jax.eval_shape(lambda: jstate))
    tkeyed = _keyed(tstate)
    for p, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      tkeyed[jax.tree_util.keystr(p)].numpy())
    manifests = [json.loads((Path(p) / "manifest.json").read_text())
                 for p in (jpath, tpath)]
    assert manifests[0] == manifests[1]
    assert "['params']['groups'][0]['scan']['b0']['attn']['wq']" in \
        manifests[0]["keys"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_train_cli_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
         "--ckpt", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and all("loss" in ln for ln in lines)
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000003")


def test_train_cli_needs_a_card_by_default(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--tiny", "--steps", "1"])


# ---------------------------------------------------------------------------
# chip_smoke.py's training phases, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_train_rehearsals():
    """The tiny_train, train_parity and train phases at the tiny config
    on the CPU: the same control flow, checks and launch-count reads as
    on the card (no kernel launches here), and the recorder keeps the
    first attention call's inputs and the gradient at its output."""
    cs = _chip_smoke()
    cs.check_tiny_train(device="cpu")
    cs.check_train_parity(tiny=True, device="cpu")
    rec = cs.FlashRecorder()
    res = cs.train(rec, tiny=True, device="cpu", warm=1, timed=4, batch=4,
                   seq=64)
    assert len(res["losses"]) == 5 and res["max_memory_allocated"] is None
    assert all(v == 0 for v in res["launches"].values())
    q, k, v, kw = rec.args
    assert q.shape == (4, 2, 4, 64, 32) and k.shape == (4, 2, 64, 32)
    assert rec.dout.shape == q.shape and rec.dout.is_contiguous()
    assert set(cs.FLASH_REPLACES) <= set(cs.KERNELS)


def test_chip_smoke_ptxas_report():
    """The build log's ptxas -v report, one line per kernel with its
    registers and spills, errors kept."""
    cs = _chip_smoke()
    text = """== nvcc a.cu (exit 0)
ptxas info    : Compiling entry function '_Z3fwdv' for 'sm_90a'
ptxas info    : Function properties for _Z3fwdv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 137 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3bwdv' for 'sm_90a'
ptxas info    : Function properties for _Z3bwdv
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
b.cu(3): error: identifier "x" is undefined"""
    assert cs.ptxas_report(text) == [
        "_Z3fwdv: Used 137 registers, used 1 barriers; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads",
        "_Z3bwdv: Used 255 registers, used 1 barriers; 8 bytes stack "
        "frame, 8 bytes spill stores, 4 bytes spill loads",
        'b.cu(3): error: identifier "x" is undefined']
