"""The port stands alone beside the JAX reference.

* No module under ``src/repro_torch/``, and not ``chip_smoke.py``,
  imports ``jax`` or anything of ``repro``.
* The host-side modules the port copies verbatim stay equal to their
  originals after ``repro.`` -> ``repro_torch.``; the only allowed
  differences are the H100 chip spec added to ``utils/hw.py`` and, in
  ``analysis/ownership.py`` and ``analysis/lifecycle.py``, the one
  relative import spelled absolutely.
* Entry points run on the card unless the caller asks for the CPU: with
  no CUDA device, ``Engine()`` without ``device="cpu"`` raises.
"""
import ast
import difflib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

COPIED = [
    "configs/__init__.py", "configs/base.py", "configs/deepseek_7b.py",
    "configs/deepseek_moe_16b.py", "configs/deepseek_v3_671b.py",
    "configs/gemma2_9b.py", "configs/llama3_2_1b.py",
    "configs/musicgen_large.py", "configs/paper_models.py",
    "configs/pixtral_12b.py", "configs/qwen2_72b.py",
    "configs/xlstm_350m.py", "configs/zamba2_1_2b.py",
    "core/__init__.py", "core/costmodel.py", "core/estimator.py",
    "core/policy.py", "core/request.py", "core/scheduler.py",
    "core/waste.py", "memory/__init__.py", "memory/block_manager.py",
    "cache/__init__.py", "cache/prefix_tree.py", "obs/__init__.py",
    "obs/metrics.py", "obs/ledger.py", "obs/trace.py", "obs/export.py",
    "serving/api_executor.py", "serving/session.py",
    "serving/workloads.py", "training/data.py",
    "analysis/__init__.py", "analysis/lint.py", "sim/__init__.py",
    "sim/simulator.py", "obs/check.py", "launch/analytic.py",
    "launch/roofline.py", "launch/report.py",
]
# the one allowed difference: lines inserted into utils/hw.py that
# define the H100 spec
ALLOWED_INSERTS = {"utils/hw.py": "H100"}
# copies whose one relative import is spelled absolutely (the port allows
# no relative import): (the reference's line, the port's line), and no
# other difference
ALLOWED_REWRITES = {
    "analysis/ownership.py": ("from . import Finding, call_site",
                              "from repro_torch.analysis import Finding, "
                              "call_site"),
    "analysis/lifecycle.py": ("from . import call_site",
                              "from repro_torch.analysis import call_site"),
}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module == "jax" or module.startswith("jax.") or \
        module == "repro" or module.startswith("repro.")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level or _forbidden(node.module or ""):
                bad.append(node.module or ".")
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "import_module":
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and _forbidden(a.value)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("rel", COPIED + sorted(ALLOWED_INSERTS)
                         + sorted(ALLOWED_REWRITES))
def test_copied_host_modules_do_not_drift(rel):
    want = (REF / rel).read_text().replace("repro.", "repro_torch.")
    got = (PORT / rel).read_text()
    if rel in ALLOWED_REWRITES:
        ref_line, port_line = ALLOWED_REWRITES[rel]
        assert want.count(f"\n{ref_line}\n") == 1, rel
        want = want.replace(f"\n{ref_line}\n", f"\n{port_line}\n")
    if rel not in ALLOWED_INSERTS:
        assert got == want, f"{rel} drifted from src/repro/{rel}"
        return
    ops = difflib.SequenceMatcher(a=want.splitlines(), b=got.splitlines(),
                                  autojunk=False).get_opcodes()
    changes = [op for op in ops if op[0] != "equal"]
    assert len(changes) == 1 and changes[0][0] == "insert", changes
    _, _, _, j1, j2 = changes[0]
    inserted = "\n".join(got.splitlines()[j1:j2])
    assert ALLOWED_INSERTS[rel] in inserted


def test_port_sources_have_no_host_syncs():
    """No ``.item()``, ``device_get`` or ``block_until_ready`` anywhere in
    the port: the repo lint's call graph is name-based across packages,
    so one in a port function would taint the reference's dispatch too."""
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                name = getattr(node.func, "attr",
                               getattr(node.func, "id", None))
                assert name not in ("item", "device_get",
                                    "block_until_ready"), f"{path}:{node}"


def test_engine_without_device_needs_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import POLICIES
    from repro_torch.serving.engine import Engine, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(get_config("llama3.2-1b", tiny=True), POLICIES["infercept"])
    with pytest.raises(RuntimeError):
        resolve_device(None)
    # an explicit CUDA device, as launch/serve.py's and launch/train.py's
    # default --device cuda passes it, raises the same way
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(get_config("llama3.2-1b", tiny=True), POLICIES["infercept"],
               device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_kernel_modules_import_without_a_toolchain():
    """Importing the kernel modules builds nothing and needs no nvcc: the
    library is built at the first launch only."""
    from repro_torch.kernels import _build
    assert _build.lib.cache_info().currsize == 0
    assert sorted(p.name for p in _build.sources()) == [
        "flash_attention.cu", "gla_scan.cu", "kv_append.cu",
        "kv_append_quant.cu", "mla_attention.cu", "moe_experts.cu",
        "page_requant.cu", "paged_attention.cu", "ragged_paged_attention.cu",
        "swap_pack.cu"]
    assert _build.library_path().parent == ROOT / "build" / "kernels"
