"""In-place KV append, the paged write path: the CUDA kernel's launcher
and its plain PyTorch version.

Counterpart of ``repro.kernels.kv_append``. Row i's K/V ``(Hkv, hd)``
lands in pool slot ``(page_ids[i], offsets[i])`` iff ``valid[i] != 0``;
one page-slot write per token, O(1) HBM traffic per generated token. Both
versions update the pools in place and return them, keeping the JAX
signature. Invalid rows write nothing: on a parallel grid the TPU
kernel's discard-page write-back would race, so it is dropped. The two
pools may differ in their last width (MLA's latent pools: c as (n_pages,
page, 1, kv_lora), kr as (n_pages, page, 1, rope)). The kernel source is
``csrc/kv_append.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def kv_append_ref(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
    """The plain version: a masked index write. Invalid rows and page ids
    out of range are dropped, like the reference's drop-mode scatter."""
    keep = (valid != 0) & (page_ids >= 0) & (page_ids < k_pool.shape[0])
    pids, offs = page_ids[keep].long(), offsets[keep].long()
    k_pool[pids, offs] = k_new[keep].to(k_pool.dtype)
    v_pool[pids, offs] = v_new[keep].to(v_pool.dtype)
    return k_pool, v_pool


def _raw_stream(t) -> int:
    """The current CUDA stream of ``t``'s device as an integer, read
    without building a Stream object (the launchers' host time is most of
    what a ~10 us kernel costs a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
    """Raise on any operand the kernel does not take (the device is checked
    by the launcher)."""
    n_pages, page, Hkv, hd = k_pool.shape
    N = k_new.shape[0]
    if v_pool.dim() != 4 or v_pool.shape[:3] != k_pool.shape[:3] \
            or k_new.shape != (N, Hkv, hd) \
            or v_new.shape != (N, *v_pool.shape[2:]):
        raise ValueError(f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)}"
                         f" / rows {tuple(k_new.shape)} "
                         f"{tuple(v_new.shape)} not taken: pools (n_pages, "
                         "page, Hkv, hd_k) and (n_pages, page, Hkv, hd_v), "
                         "rows (N, Hkv, hd_k) and (N, Hkv, hd_v)")
    if not k_pool.dtype == v_pool.dtype == k_new.dtype == v_new.dtype:
        raise TypeError("pools and rows must share a dtype")
    if not (page_ids.dtype == offsets.dtype == valid.dtype == torch.int32
            and page_ids.shape == offsets.shape == valid.shape == (N,)):
        raise TypeError("page_ids, offsets and valid must be (N,) int32")
    ops = (k_pool, v_pool, k_new, v_new, page_ids, offsets, valid)
    if not all(t.is_contiguous() for t in ops) \
            or len({t.get_device() for t in ops}) != 1:
        raise ValueError("all operands must be contiguous on one device")


def kv_append(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
    """Launch the CUDA kernel on the current stream, writing the pools in
    place; returns (k_pool, v_pool). Raises on any operand the kernel
    does not take, a CPU tensor included."""
    _build.require_cuda("kv_append", k_pool)
    _check(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid)
    n_pages, page = k_pool.shape[:2]
    err = _build.lib().kv_append_launch(
        k_pool.data_ptr(), v_pool.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), page_ids.data_ptr(), offsets.data_ptr(),
        valid.data_ptr(), k_new.shape[0], n_pages, page,
        k_pool.shape[2] * k_pool.shape[3] * k_pool.element_size(),
        v_pool.shape[2] * v_pool.shape[3] * v_pool.element_size(),
        _raw_stream(k_pool))
    _build.check(err, "kv_append")
    kv_append.launches += 1
    return k_pool, v_pool


kv_append.launches = 0
