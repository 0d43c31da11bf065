"""Swap pack / unpack: the CUDA kernels' launchers, their plain PyTorch
versions, and the stream-ordered ``SwapStager`` the engine swaps through.

Counterpart of ``repro.kernels.swap_pack``. The paper's Swap analysis
(§3.2) found that a paged context scatters over many non-contiguous
pages, so swapping it page by page costs one transfer per region. The
port coalesces on the device first: ``swap_pack`` gathers a request's
pages into one contiguous slab, the slab crosses to pinned host memory in
one copy, and ``swap_unpack`` scatters a slab back into pool pages.

Both work on pools stacked over layer periods, ``(P, n_pages, ...)`` with
any trailing rank, so one launch moves a page of every layer. The kernel
source is ``csrc/swap_pack.cu``.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, List, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.utils.tree import tree_leaves, tree_map


def swap_pack_ref(pool, page_ids):
    """Plain version: pool (P, n_pages, ...) -> slab (P, n, ...)."""
    return pool[:, page_ids.long()]


def swap_unpack_ref(pool, staging, page_ids):
    """Plain version: write slab (P, n, ...) into pool pages in place."""
    pool[:, page_ids.long()] = staging.to(pool.dtype)
    return pool


def _check(name, pool, slab, page_ids):
    if not pool.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel; got a tensor on "
                         f"{pool.device}")
    if pool.dim() < 2 or slab.dtype != pool.dtype or \
            slab.shape != (pool.shape[0], page_ids.shape[0],
                           *pool.shape[2:]):
        raise ValueError(f"{name}: pool {tuple(pool.shape)} and slab "
                         f"{tuple(slab.shape)} must be (P, n_pages, ...) "
                         "and (P, n, ...) of one dtype")
    if page_ids.dtype != torch.int32 or page_ids.dim() != 1:
        raise TypeError(f"{name}: page_ids must be (n,) int32")
    for t in (pool, slab, page_ids):
        if t.device != pool.device or not t.is_contiguous():
            raise ValueError(f"{name}: all operands must be contiguous on "
                             "one device")


def _row_bytes(pool) -> int:
    return pool[0, 0].numel() * pool.element_size()


def swap_pack(pool, page_ids):
    """Launch the gather kernel on the current stream:
    pool (P, n_pages, ...) -> new slab (P, n, ...)."""
    slab = torch.empty((pool.shape[0], page_ids.shape[0], *pool.shape[2:]),
                       dtype=pool.dtype, device=pool.device)
    _check("swap_pack", pool, slab, page_ids)
    err = _build.lib().swap_pack_launch(
        pool.data_ptr(), slab.data_ptr(), page_ids.data_ptr(),
        page_ids.shape[0], pool.shape[0], pool.shape[1], _row_bytes(pool),
        torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(err, "swap_pack")
    swap_pack.launches += 1
    return slab


def swap_unpack(pool, staging, page_ids):
    """Launch the scatter kernel on the current stream, writing the pool's
    pages in place; returns the pool."""
    _check("swap_unpack", pool, staging, page_ids)
    err = _build.lib().swap_unpack_launch(
        pool.data_ptr(), staging.data_ptr(), page_ids.data_ptr(),
        page_ids.shape[0], pool.shape[0], pool.shape[1], _row_bytes(pool),
        torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(err, "swap_unpack")
    swap_unpack.launches += 1
    return pool


swap_pack.launches = 0
swap_unpack.launches = 0


# ---------------------------------------------------------------------------
# Stream-ordered staging for the pipelined engine step (DESIGN.md §12)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StagedSlab:
    """One swap-out slab whose host copy has been issued but not
    collected: ``host`` is its host pytree, complete once ``done`` (the
    copy stream's event; None on the CPU) has fired."""
    ticket: int
    host: Any
    n_pages: int
    done: Optional[Any] = None


class SwapStager:
    """Issue/collect split of the coalesced swap transfer.

    ``pack()`` launches ``swap_pack`` on the compute stream, so the gather
    is ordered before anything this iteration later writes into the pages
    the engine frees right after packing (the pools are updated in place;
    JAX's immutable arrays made that order free). Only the copy of the
    slab into pinned host memory goes on a side copy stream, after it
    waits for the gather; the device slab is handed to that stream with
    ``record_stream`` and dropped, so device staging is held only while
    its copy drains. ``collect(ticket)`` waits on that copy alone.
    ``unpack()`` copies a host slab to the device and launches
    ``swap_unpack`` on the compute stream, issue-only.

    On the CPU the same calls run the plain versions synchronously. Pools
    are pytrees of ``(P, n_pages, ...)`` leaves; the engine reasons only
    in tickets and page ids.
    """

    def __init__(self):
        self._inflight = deque()            # StagedSlab, FIFO
        self._tickets = itertools.count()
        self._copy_stream = None            # made at the first CUDA pack
        self.packed_pages = 0
        self.collected_pages = 0
        self.unpacked_pages = 0

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @staticmethod
    def _ids(page_ids: List[int], leaf) -> torch.Tensor:
        if min(page_ids) < 0 or max(page_ids) >= leaf.shape[1]:
            raise ValueError(f"page ids {page_ids} outside the pool's "
                             f"{leaf.shape[1]} pages")
        ids = torch.tensor(page_ids, dtype=torch.int32)
        if leaf.is_cuda:
            ids = ids.pin_memory().to(leaf.device, non_blocking=True)
        return ids

    def pack(self, pools, page_ids: List[int]) -> int:
        """Launch the gather of ``page_ids`` from every pool leaf and issue
        its host copy; returns a ticket for collect(). Never waits."""
        from repro_torch.kernels.ops import swap_pack_op
        leaf0 = tree_leaves(pools)[0]
        ids = self._ids(page_ids, leaf0)
        slabs = tree_map(lambda leaf: swap_pack_op(leaf, ids), pools)
        done = None
        host = slabs
        if leaf0.is_cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(leaf0.device)
            cs = self._copy_stream
            cs.wait_stream(torch.cuda.current_stream(leaf0.device))
            with torch.cuda.stream(cs):
                host = tree_map(_to_pinned_host, slabs)
            for s in tree_leaves(slabs):
                s.record_stream(cs)
            done = torch.cuda.Event()
            done.record(cs)
        slab = StagedSlab(next(self._tickets), host, len(page_ids), done)
        self._inflight.append(slab)
        self.packed_pages += slab.n_pages
        return slab.ticket

    def collect(self, ticket: int):
        """Resolve a ticket to its host pytree (page axis 1), waiting only
        on that slab's copy."""
        for i, slab in enumerate(self._inflight):
            if slab.ticket == ticket:
                del self._inflight[i]
                self.collected_pages += slab.n_pages
                if slab.done is not None:
                    slab.done.synchronize()
                return slab.host
        raise KeyError(f"unknown or already-collected ticket {ticket}")

    def unpack(self, pools, page_ids: List[int], host_slab):
        """Copy a host slab to the device and scatter it into ``pools`` at
        ``page_ids`` in place, issue-only; returns the pools."""
        from repro_torch.kernels.ops import swap_unpack_op
        leaf0 = tree_leaves(pools)[0]
        ids = self._ids(page_ids, leaf0)

        def put(leaf, val):
            if leaf.is_cuda:
                val = val.pin_memory().to(leaf.device, non_blocking=True)
            return swap_unpack_op(leaf, val, ids)

        tree_map(put, pools, host_slab)
        self.unpacked_pages += len(page_ids)
        return pools


def _to_pinned_host(slab):
    host = torch.empty(slab.shape, dtype=slab.dtype, pin_memory=True)
    host.copy_(slab, non_blocking=True)
    return host
