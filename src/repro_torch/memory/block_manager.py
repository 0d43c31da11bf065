"""Paged KV block (page) allocator — the vLLM-style memory manager.

Pages are fixed-size token slots in the global KV pools; the allocator is
pure host-side bookkeeping (free list + refcounts). With the prefix cache
(repro_torch.cache) the refcounts carry real sharing: one physical page can back
many requests plus the cache index, copy-on-write style. The invariants
(DESIGN.md §8):

  * a page leaves the free list with refcount 1 and returns to it only
    when the count drops back to 0 — never while any owner remains;
  * ``fork`` adds an owner (a borrowing request, or the cache adopting a
    page on insert); ``free`` removes one; double-free asserts;
  * a shared page (refcount > 1) is read-only — writers must take a
    private copy first (``cow_target`` names the page to write instead;
    the engine copies the payload, since the allocator never touches
    device memory).

The scheduler reasons in tokens; the engine converts to pages.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


class BlockManager:
    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs = [0] * n_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def free_tokens(self) -> int:
        return self.num_free * self.page_size

    def allocate(self, n: int = 1) -> Optional[List[int]]:
        """Allocate n pages or None if they don't all fit (no partial)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def free(self, pages) -> None:
        for p in pages:
            assert self._refs[p] > 0, f"double free of page {p}"
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def fork(self, pages) -> None:
        """Refcount bump: a new owner borrows already-computed pages."""
        for p in pages:
            assert self._refs[p] > 0, f"fork of unallocated page {p}"
            self._refs[p] += 1

    # ------------------------------------------------------------------
    # sharing / copy-on-write
    # ------------------------------------------------------------------
    def ref_count(self, page: int) -> int:
        return self._refs[page]

    def is_shared(self, page: int) -> bool:
        return self._refs[page] > 1

    def cow_target(self, page: int) -> Tuple[Optional[int], bool]:
        """Prepare ``page`` for writing. Exclusive pages (refcount 1) are
        written in place: returns (page, False). Shared pages trigger the
        copy: a fresh page is allocated, this owner's reference to the
        original is dropped, and (new_page, True) is returned — the caller
        must copy the payload before writing. Returns (None, False) when a
        copy is needed but no page is free (caller evicts and retries)."""
        assert self._refs[page] > 0, f"cow of unallocated page {page}"
        if self._refs[page] == 1:
            return page, False
        got = self.allocate(1)
        if got is None:
            return None, False
        self.free([page])
        return got[0], True

    def pages_for_tokens(self, tokens: int) -> int:
        return -(-tokens // self.page_size)
