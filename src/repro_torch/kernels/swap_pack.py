"""Swap pack / unpack: the CUDA kernel's launchers, their plain PyTorch
versions, and the stream-ordered ``SwapStager`` the engine swaps through.

Counterpart of ``repro.kernels.swap_pack``. The paper's Swap analysis
(§3.2) found that a paged context scatters over many non-contiguous
pages, so swapping it page by page costs one transfer per region. The
port coalesces on the device first: the pack gathers a request's pages
of every pool leaf into one contiguous byte slab in one launch, the slab
crosses to pinned host memory in one copy, and the unpack scatters a
slab back into pool pages in one launch.

Leaves are pools stacked over layer periods, ``(P, n_pages, ...)`` with
any trailing rank, so one launch moves a page of every layer. A slab
holds each leaf's ``(P, n, ...)`` section at a byte offset that is a
multiple of ``SLAB_ALIGN`` (``slab_layout``). ``swap_pack`` and
``swap_unpack`` are the one-leaf case, the reference's counterparts. The
kernel source is ``csrc/swap_pack.cu``.
"""
from __future__ import annotations

import array
import dataclasses
import itertools
import math
from collections import deque
from typing import Any, List, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_append import _raw_stream
from repro_torch.utils.tree import tree_leaves, tree_map

SLAB_ALIGN = 128      # bytes; each leaf's section of a slab starts on one
MAX_LEAVES = 16       # leaves a launch takes (csrc/swap_pack.cu kMaxLeaves)


def swap_pack_ref(pool, page_ids):
    """Plain version: pool (P, n_pages, ...) -> slab (P, n, ...)."""
    return pool[:, page_ids.long()]


def swap_unpack_ref(pool, staging, page_ids):
    """Plain version: write slab (P, n, ...) into pool pages in place."""
    pool[:, page_ids.long()] = staging.to(pool.dtype)
    return pool


def _row_bytes(leaf) -> int:
    """Bytes of one (period, page) row of a (P, n_pages, ...) leaf."""
    return math.prod(leaf.shape[2:]) * leaf.element_size()


def _layout(leaves, n: int):
    """(offsets, row bytes, size) of a slab of ``n`` pages."""
    offs, rows, end = [], [], 0
    for leaf in leaves:
        row = _row_bytes(leaf)
        end = -(-end // SLAB_ALIGN) * SLAB_ALIGN
        offs.append(end)
        rows.append(row)
        end += leaf.shape[0] * n * row
    return offs, rows, end


def slab_layout(leaves, n: int):
    """(offsets, size): the byte offset of each leaf's (P, n, ...) section
    in a slab of ``n`` pages, each a multiple of SLAB_ALIGN, and the
    slab's size in bytes."""
    offs, _, size = _layout(leaves, n)
    return offs, size


def slab_views(slab, leaves, n: int, offs=None) -> list:
    """The (P, n, ...) view, in the leaf's dtype, of each leaf's section of
    the uint8 ``slab``."""
    if offs is None:
        offs, _ = slab_layout(leaves, n)
    views = []
    for o, leaf in zip(offs, leaves):
        shape = (leaf.shape[0], n, *leaf.shape[2:])
        nbytes = math.prod(shape) * leaf.element_size()
        views.append(slab[o:o + nbytes].view(leaf.dtype).view(shape)
                     if nbytes else slab.new_empty(shape, dtype=leaf.dtype))
    return views


def slab_pages(slab, n: int) -> list:
    """A slab pytree (page axis 1) split into its ``n`` page payloads,
    views with the page axis dropped."""
    return [tree_map(lambda leaf: leaf[:, i], slab) for i in range(n)]


def _unpack_rows(ids, n_pages):
    """The slab rows an unpack writes: id in range and not repeated later
    (the last of repeated ids wins, as the reference's sequential grid
    writes them)."""
    valid = (ids >= 0) & (ids < n_pages)
    pos = torch.arange(ids.shape[0], device=ids.device)
    slot = torch.where(valid, ids, n_pages)
    last = torch.full((n_pages + 1,), -1, dtype=torch.long,
                      device=ids.device).scatter_reduce_(0, slot, pos, "amax")
    return valid & (last[slot] == pos)


def _byte_rows(t, rows: int):
    """(P, rows, row bytes) uint8 view of a contiguous (P, rows, ...)
    tensor or slab section."""
    return t.view(torch.uint8).view(t.shape[0], rows, -1)


def swap_pack_tree_ref(leaves, page_ids, slab):
    """Plain version of the tree pack: each leaf's pages ``page_ids`` into
    its section of the uint8 ``slab``; a row whose id is out of range is
    left as it was. Works on bytes, so any dtype moves. Returns the slab."""
    n = page_ids.shape[0]
    ids = page_ids.long()
    for leaf, view in zip(leaves, slab_views(slab, leaves, n)):
        if view.numel() and leaf.numel():
            keep = ((ids >= 0) & (ids < leaf.shape[1])).nonzero()[:, 0]
            section = _byte_rows(view, n)
            section[:, keep] = _byte_rows(leaf, leaf.shape[1])[:, ids[keep]]
    return slab


def swap_unpack_tree_ref(leaves, slab, page_ids):
    """Plain version of the tree unpack: each leaf's section of ``slab``
    into its pages ``page_ids`` in place, skipping ids out of range.
    Returns the leaves."""
    n = page_ids.shape[0]
    ids = page_ids.long()
    for leaf, view in zip(leaves, slab_views(slab, leaves, n)):
        if view.numel() and leaf.numel():
            keep = _unpack_rows(ids, leaf.shape[1]).nonzero()[:, 0]
            pool = _byte_rows(leaf, leaf.shape[1])
            pool[:, ids[keep]] = _byte_rows(view, n)[:, keep]
    return leaves


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
    dev = pool.get_device()
    for t in (pool, slab, page_ids):
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"{name}: all operands must be contiguous on "
                             "one device")


def _check_tree(name, leaves, slab, page_ids):
    """The tree launch's checks, once per launch; returns the layout's
    offsets and row bytes."""
    if not leaves or not leaves[0].is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel; got leaves on "
                         f"{[str(leaf.device) for leaf in leaves]}")
    if page_ids.dtype != torch.int32 or page_ids.dim() != 1:
        raise TypeError(f"{name}: page_ids must be (n,) int32")
    if len(leaves) > MAX_LEAVES or any(leaf.dim() < 2 for leaf in leaves):
        raise ValueError(f"{name}: at most {MAX_LEAVES} leaves, each "
                         "(P, n_pages, ...)")
    offs, rows, size = _layout(leaves, page_ids.shape[0])
    if slab.dtype != torch.uint8 or slab.dim() != 1 or slab.numel() < size:
        raise ValueError(f"{name}: slab must be a uint8 buffer of at least "
                         f"{size} bytes; got {slab.dtype} "
                         f"{tuple(slab.shape)}")
    dev = leaves[0].get_device()
    for t in (*leaves, slab, page_ids):
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"{name}: all operands must be contiguous on "
                             "one device")
    return offs, rows


def _launch(counter, leaves, offs, rows, slab_ptr, page_ids):
    """One launch of the pack (``counter`` is swap_pack) or unpack kernel,
    none when nothing moves. The leaves go to the kernel as an int64
    table of (pointer, row bytes, section offset, P, n_pages)."""
    n = page_ids.shape[0]
    if n == 0 or not any(leaf.shape[0] * row
                         for leaf, row in zip(leaves, rows)):
        return
    table = array.array("q")
    for leaf, off, row in zip(leaves, offs, rows):
        table.extend((leaf.data_ptr(), row, off, *leaf.shape[:2]))
    fn = (_build.lib().swap_pack_launch if counter is swap_pack
          else _build.lib().swap_unpack_launch)
    err = fn(table.buffer_info()[0], len(leaves), slab_ptr,
             page_ids.data_ptr(), n, _raw_stream(leaves[0]))
    _build.check(err, counter.__name__)
    counter.launches += 1


def swap_pack_tree(leaves, page_ids, slab):
    """Launch one gather of pages ``page_ids`` from every leaf into its
    section of the uint8 ``slab`` (``slab_layout``), on the current
    stream; returns the slab (``slab_views`` gives the sections)."""
    offs, rows = _check_tree("swap_pack", leaves, slab, page_ids)
    _launch(swap_pack, leaves, offs, rows, slab.data_ptr(), page_ids)
    return slab


def swap_unpack_tree(leaves, slab, page_ids):
    """Launch one scatter of every leaf's section of the uint8 ``slab``
    into its pages ``page_ids``, in place, on the current stream; ids out
    of range write nothing, and a page named more than once takes the
    last such row (``_unpack_rows``). Returns the leaves."""
    offs, rows = _check_tree("swap_unpack", leaves, slab, page_ids)
    _launch(swap_unpack, leaves, offs, rows, slab.data_ptr(), page_ids)
    return leaves


def swap_pack(pool, page_ids):
    """The one-leaf gather on the current stream:
    pool (P, n_pages, ...) -> new slab (P, n, ...)."""
    slab = torch.empty((pool.shape[0], page_ids.shape[0], *pool.shape[2:]),
                       dtype=pool.dtype, device=pool.device)
    _check("swap_pack", pool, slab, page_ids)
    _launch(swap_pack, [pool], [0], [_row_bytes(pool)], slab.data_ptr(),
            page_ids)
    return slab


def swap_unpack(pool, staging, page_ids):
    """The one-leaf scatter on the current stream, writing the pool's
    pages in place; returns the pool."""
    _check("swap_unpack", pool, staging, page_ids)
    _launch(swap_unpack, [pool], [0], [_row_bytes(pool)],
            staging.data_ptr(), page_ids)
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
    """Issue/collect split of the coalesced swap transfer, one launch and
    one pinned slab per swap.

    ``pack()`` launches the tree gather of every pool leaf into one device
    byte slab on the compute stream, so the gather is ordered before
    anything this iteration later writes into the pages the engine frees
    right after packing (the pools are updated in place; JAX's immutable
    arrays made that order free). Only the copy of the slab into one
    pinned host buffer goes on a side copy stream, after it waits for the
    gather; the device slab is handed to that stream with
    ``record_stream`` and dropped, so device staging is held only while
    its copy drains. ``collect(ticket)`` waits on that copy alone and
    returns the pool tree's structure of dtype views of the host buffer
    (page axis 1). ``unpack()`` stacks the page payloads it is handed
    straight into one pinned buffer, copies it to the device in one copy
    and launches the tree scatter on the compute stream, issue-only.

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
        self.packs = 0
        self.unpacks = 0

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @staticmethod
    def _ids(page_ids: List[int], leaf) -> torch.Tensor:
        if min(page_ids) < 0 or max(page_ids) >= leaf.shape[1]:
            raise ValueError(f"page ids {page_ids} outside the pool's "
                             f"{leaf.shape[1]} pages")
        ids = torch.tensor(page_ids, dtype=torch.int32,
                           pin_memory=leaf.is_cuda)
        if leaf.is_cuda:
            ids = ids.to(leaf.device, non_blocking=True)
        return ids

    def pack(self, pools, page_ids: List[int]) -> int:
        """Launch the gather of ``page_ids`` from every pool leaf and issue
        its host copy; returns a ticket for collect(). Never waits."""
        from repro_torch.kernels.ops import swap_pack_tree_op
        leaves = tree_leaves(pools)
        ids = self._ids(page_ids, leaves[0])
        n = len(page_ids)
        offs, size = slab_layout(leaves, n)
        slab = torch.empty(size, dtype=torch.uint8, device=leaves[0].device)
        swap_pack_tree_op(leaves, ids, slab)
        host, done = slab, None
        if slab.is_cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(slab.device)
            cs = self._copy_stream
            cs.wait_stream(torch.cuda.current_stream(slab.device))
            host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            with torch.cuda.stream(cs):
                host.copy_(slab, non_blocking=True)
            slab.record_stream(cs)
            done = torch.cuda.Event()
            done.record(cs)
        it = iter(slab_views(host, leaves, n, offs))
        staged = StagedSlab(next(self._tickets),
                            tree_map(lambda _: next(it), pools), n, done)
        self._inflight.append(staged)
        self.packed_pages += n
        self.packs += 1
        return staged.ticket

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

    def unpack(self, pools, page_ids: List[int], pages: list):
        """Scatter ``pages``, one payload pytree per id (the pool tree's
        structure, leaves (P, ...)), into ``pools`` at ``page_ids`` in
        place, issue-only; returns the pools."""
        from repro_torch.kernels.ops import swap_unpack_tree_op
        leaves = tree_leaves(pools)
        ids = self._ids(page_ids, leaves[0])
        n = len(page_ids)
        offs, size = slab_layout(leaves, n)
        on_card = leaves[0].is_cuda
        slab = torch.empty(size, dtype=torch.uint8, pin_memory=on_card)
        payloads = [tree_leaves(page) for page in pages]
        for j, view in enumerate(slab_views(slab, leaves, n, offs)):
            torch.stack([p[j] for p in payloads], dim=1, out=view)
        if on_card:
            slab = slab.to(leaves[0].device, non_blocking=True)
        swap_unpack_tree_op(leaves, slab, ids)
        self.unpacked_pages += n
        self.unpacks += 1
        return pools
