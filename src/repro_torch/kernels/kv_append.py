"""In-place KV append, the paged write path: the CUDA kernel's launcher
and its plain PyTorch version.

Counterpart of ``repro.kernels.kv_append``. Row i's K/V ``(Hkv, hd)``
lands in pool slot ``(page_ids[i], offsets[i])`` iff ``valid[i] != 0``;
one page-slot write per token, O(1) HBM traffic per generated token. Both
versions update the pools in place and return them, keeping the JAX
signature. Invalid rows write nothing: on a parallel grid the TPU
kernel's discard-page write-back would race, so it is dropped. The kernel
source is ``csrc/kv_append.cu``.
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


def _check(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
    if not k_pool.is_cuda:
        raise ValueError("kv_append launches a CUDA kernel; got a tensor on "
                         f"{k_pool.device}")
    n_pages, page, Hkv, hd = k_pool.shape
    N = k_new.shape[0]
    if v_pool.shape != k_pool.shape or k_new.shape != (N, Hkv, hd) \
            or v_new.shape != k_new.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} / rows "
                         f"{tuple(k_new.shape)} {tuple(v_new.shape)} not "
                         "taken: pools (n_pages, page, Hkv, hd), rows "
                         "(N, Hkv, hd)")
    for t in (v_pool, k_new, v_new):
        if t.dtype != k_pool.dtype:
            raise TypeError("pools and rows must share a dtype")
    for t in (page_ids, offsets, valid):
        if t.dtype != torch.int32 or t.shape != (N,):
            raise TypeError("page_ids, offsets and valid must be (N,) int32")
    for t in (k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
        if t.device != k_pool.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def kv_append(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid):
    """Launch the CUDA kernel on the current stream, writing the pools in
    place; returns (k_pool, v_pool). Raises on any operand the kernel
    does not take, a CPU tensor included."""
    _check(k_pool, v_pool, k_new, v_new, page_ids, offsets, valid)
    n_pages, page, Hkv, hd = k_pool.shape
    err = _build.lib().kv_append_launch(
        k_pool.data_ptr(), v_pool.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), page_ids.data_ptr(), offsets.data_ptr(),
        valid.data_ptr(), k_new.shape[0], n_pages, page,
        Hkv * hd * k_pool.element_size(),
        torch.cuda.current_stream(k_pool.device).cuda_stream)
    _build.check(err, "kv_append")
    kv_append.launches += 1
    return k_pool, v_pool


kv_append.launches = 0
