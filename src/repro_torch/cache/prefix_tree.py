"""Token-block radix tree: cross-request prefix sharing of computed KV pages.

InferCept's preserve/swap/discard machinery (§4) only avoids recompute
*within* one request's lifetime. Agent traffic shares system prompts,
few-shot templates, and tool-call histories across requests — and a
discarded request's own context is, by definition, an exact prefix of the
context it must rebuild on resume. This tree indexes computed KV pages by
their token-id prefix so both kinds of reuse become a lookup instead of a
prefill (DESIGN.md §8).

Structure: one node per full page (``page_size`` token ids). An edge is the
exact token tuple of the child's page, so a match is a block-by-block walk
from the root and two contexts share a node iff they share that token
prefix bit-for-bit. Fixed-length edges mean node splitting never happens;
this is the hash-chained radix used by vLLM's prefix caching, kept as an
explicit tree so LRU eviction can peel leaves (deepest, least-recently-used
suffixes) first.

Ownership protocol (the COW contract with ``BlockManager``):
  * ``insert`` ADOPTS each newly indexed page via the ``adopt`` callback
    (a refcount bump) — the cache is a first-class owner, so pages survive
    the inserting request's discard/finish.
  * ``match`` only reports page ids; the CALLER takes its own reference
    before using them (engine: ``BlockManager.fork``).
  * ``evict`` releases the cache's reference via ``release``; a page is
    only truly freed when every borrowing request has also released it.
    ``can_evict`` gates victims — the engine passes "refcount == 1", i.e.
    only pages no live request is reading may leave the index.
  * Cached pages are IMMUTABLE. A request that appends into a partially
    filled matched page must copy-on-write its private copy first
    (``Engine._ensure_writable``); the node keeps the original page id and
    content.

The tree is pure host-side bookkeeping and deliberately engine-agnostic:
the simulator indexes synthetic token streams with counter page ids to
reproduce the engine's hit/miss accounting analytically.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0                 # lookups that matched at least one token
    hit_tokens: int = 0           # full-page matched tokens
    tail_hit_tokens: int = 0      # partial-page (COW-tail) matched tokens
    inserted_pages: int = 0
    deduped_pages: int = 0        # insert found the block already indexed
    evicted_pages: int = 0

    @property
    def total_hit_tokens(self) -> int:
        return self.hit_tokens + self.tail_hit_tokens


@dataclasses.dataclass
class Match:
    """Longest cached prefix of a token sequence."""
    tokens: int                   # full-page matched token count
    pages: List[int]              # page ids backing tokens[0:tokens]
    tail_pid: Optional[int] = None   # page whose first tail_tokens ids match
    tail_tokens: int = 0

    @property
    def total(self) -> int:
        return self.tokens + self.tail_tokens


class _Node:
    __slots__ = ("key", "pid", "parent", "children", "last_access")

    def __init__(self, key: Tuple[int, ...], pid: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.pid = pid
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.last_access = 0


class PrefixCache:
    def __init__(self, page_size: int, *,
                 max_pages: Optional[int] = None,
                 adopt: Optional[Callable[[List[int]], None]] = None,
                 release: Optional[Callable[[List[int]], None]] = None,
                 can_evict: Optional[Callable[[int], bool]] = None):
        assert page_size > 0
        self.page = page_size
        self.max_pages = max_pages
        self._adopt = adopt or (lambda pids: None)
        self._release = release or (lambda pids: None)
        self._can_evict = can_evict or (lambda pid: True)
        self._root = _Node((), -1, None)
        self._tick = 0
        self.n_pages = 0
        # bumped on every structural change (insert/evict/clear) — lets
        # callers memoize failed match probes until the index can answer
        # differently
        self.generation = 0
        self.stats = CacheStats()

    # ------------------------------------------------------------------
    def _touch(self, node: _Node):
        self._tick += 1
        node.last_access = self._tick

    def match(self, tokens: Sequence[int]) -> Match:
        """Longest cached prefix of ``tokens``, full pages first plus at
        most one partial tail page. Bumps LRU stamps along the path. The
        caller caps ``tokens`` (e.g. at target_ctx - 1 so at least one
        token is always left to compute for the first logits)."""
        self.stats.lookups += 1
        node = self._root
        pages: List[int] = []
        i = 0
        while len(tokens) - i >= self.page:
            child = node.children.get(tuple(tokens[i:i + self.page]))
            if child is None:
                break
            self._touch(child)
            pages.append(child.pid)
            node = child
            i += self.page
        m = Match(tokens=i, pages=pages)
        rest = tuple(tokens[i:])
        if rest:
            # partial tail: the child sharing the longest common prefix of
            # its page with the remaining tokens (COW reuse of a full page)
            best, best_n = None, 0
            for key, child in node.children.items():
                n = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    n += 1
                if n > best_n:
                    best, best_n = child, n
            if best is not None:
                self._touch(best)
                m.tail_pid, m.tail_tokens = best.pid, best_n
        if m.total:
            self.stats.hits += 1
        self.stats.hit_tokens += m.tokens
        self.stats.tail_hit_tokens += m.tail_tokens
        return m

    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pids: Sequence[int]) -> int:
        """Index the full pages backing ``tokens`` (page j holds
        tokens[j*page:(j+1)*page]; partial trailing tokens are the caller's
        problem and must not be passed). Newly indexed pages are adopted
        (refcount bump); blocks already present are deduped — the existing
        page id wins and the caller keeps sole ownership of its duplicate.
        Returns the number of pages adopted."""
        node = self._root
        added = 0
        n_full = min(len(tokens) // self.page, len(pids))
        for j in range(n_full):
            key = tuple(tokens[j * self.page:(j + 1) * self.page])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(pids[j]), node)
                self._adopt([int(pids[j])])
                node.children[key] = child
                self.n_pages += 1
                added += 1
                self.stats.inserted_pages += 1
            else:
                self.stats.deduped_pages += 1
            self._touch(child)
            node = child
        if added:
            self.generation += 1
        if self.max_pages is not None and self.n_pages > self.max_pages:
            self.evict(self.n_pages - self.max_pages)
        return added

    # ------------------------------------------------------------------
    def pages(self):
        """Yield every page id the cache currently holds a reference to
        (one per indexed node). Consumed by the KV sanitizer's ownership
        audit; walk order is unspecified."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n.pid
            stack.extend(n.children.values())

    # ------------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            if not n.children and n is not self._root:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def evict(self, n_pages: int) -> int:
        """Peel least-recently-used evictable leaves until ``n_pages`` cache
        references were released (or no victim remains). Leaf-first order
        keeps the tree a valid prefix index: a node's ancestors are always
        at least as recently used as the node itself on the match path, so
        LRU leaves are exactly the coldest suffixes. Pages a live request
        still references are skipped via ``can_evict`` — releasing the
        cache's reference is safe memory-wise but would silently break
        sharing, so in-use pages stay indexed.

        One leaf scan seeds a min-heap; a parent whose last child was
        peeled is pushed as it becomes a leaf, so eviction is O(log n) per
        page after the scan (refcounts cannot change mid-call, so skipped
        victims stay skipped)."""
        freed = 0
        heap = [(lf.last_access, lf.pid, lf) for lf in self._leaves()
                if self._can_evict(lf.pid)]
        heapq.heapify(heap)
        while heap and freed < n_pages:
            _, _, v = heapq.heappop(heap)
            del v.parent.children[v.key]
            self._release([v.pid])
            self.n_pages -= 1
            freed += 1
            self.stats.evicted_pages += 1
            p = v.parent
            if (p is not self._root and not p.children
                    and self._can_evict(p.pid)):
                heapq.heappush(heap, (p.last_access, p.pid, p))
        if freed:
            self.generation += 1
        return freed

    def clear(self) -> int:
        """Release every cache reference (shutdown / tests)."""
        released = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            self._release([n.pid])
            released += 1
            stack.extend(n.children.values())
        self._root.children.clear()
        self.n_pages = 0
        self.generation += 1
        return released
