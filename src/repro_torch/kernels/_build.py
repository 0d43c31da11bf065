"""Build the CUDA sources in ``csrc/`` and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface under ``build/kernels/`` at the repository root.
The library's name carries a digest of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edit rebuilds and an
unchanged tree loads what it built before. Nothing is built when this
module is imported: the first kernel launch calls ``lib()``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C signatures of csrc/*.cu, in declaration order
SIGNATURES = {
    "ragged_paged_attention_launch":
        [_P] * 11 + [_I] * 10 + [_F, _F, _I, _I, _P],
    "ragged_paged_attention_tc_occupancy": [_I, _I, _P],
    "paged_attention_launch":
        [_P] * 10 + [_I] * 8 + [_F, _F, _I, _I, _P],
    "page_requant_launch": [_P] * 5 + [_I] * 6 + [_P],
    "flash_attention_fwd_launch": [_P] * 5 + [_I] * 8 + [_F, _F, _I, _P],
    "flash_attention_bwd_launch": [_P] * 10 + [_I] * 8 + [_F, _F, _I, _P],
    "flash_attention_bwd_occupancy": [_I, _I, _I, _P, _P],
    "flash_attention_fwd_occupancy": [_I, _I, _P, _P],
    "flash_attention_f32_terms": [],
    "gla_scan_launch": [_P] * 10 + [_LL] * 9 + [_I] * 11 + [_P],
    "gla_scan_bwd_launch": [_P] * 19 + [_LL] * 12 + [_I] * 12 + [_P],
    "kv_append_launch": [_P] * 7 + [_I] * 3 + [_LL, _LL, _P],
    "kv_append_quant_launch": [_P] * 9 + [_I] * 7 + [_P],
    "mla_attention_launch": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    "mla_attention_occupancy": [_I, _I, _I, _P],
    "moe_experts_launch": [_P] * 11 + [_I] * 7 + [_P],
    "swap_pack_launch": [_P, _I, _P, _P, _I, _P],
    "swap_unpack_launch": [_P, _I, _P, _P, _I, _P],
}


def nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = home / "bin" / "nvcc"
    if found.exists():
        return str(found)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libinfercept_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it is already built. The
    compiler's output (with ``ptxas -v`` register and shared-memory
    reports) goes to ``build/kernels/build.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    procs = [subprocess.Popen([cc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    log = []
    failed = []
    for src, proc in zip(sources(), procs):
        text, _ = proc.communicate()
        log.append(f"== nvcc {src.name} (exit {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = out.with_name(f"{tag}.so.tmp")
    if not failed:
        link = subprocess.Popen([cc, *NVCC_FLAGS[:2], "-shared", "-o",
                                 str(tmp), *map(str, objs)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        text, _ = link.communicate()
        log.append(f"== link (exit {link.returncode})\n{text}")
        if link.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log))
    os.replace(tmp, out)
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def require_cuda(kernel: str, t) -> None:
    """Raise unless ``t`` lies on the card: a launcher runs its kernel or
    raises, and never falls back to the plain version."""
    if not t.is_cuda:
        raise ValueError(f"{kernel} launches a CUDA kernel; got a tensor on "
                         f"{t.device}")


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")
