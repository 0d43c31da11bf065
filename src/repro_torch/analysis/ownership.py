"""KV-page ownership sanitizer — shadows `BlockManager` under sanitize=True.

The allocator itself only knows refcounts; the sanitizer reconstructs the
*owner multiset* from the engine's own tables — request block tables
(``kv[rid].pages`` "dev" entries), speculative forks, prefix-cache nodes,
and the scratch page — and cross-checks it against ``BlockManager._refs``
at every plan-phase safe point:

* refs > owners            -> leak (nobody will ever free the surplus ref)
* refs < owners            -> use-after-free (a table still points at a
                              page it no longer holds a reference to)
* allocated but unowned    -> leak (off the free list, in no table)
* owned with refs == 0     -> use-after-free
* generation-tag mismatch  -> use-after-free (page was freed-to-zero and
                              recycled while some (owner, page) pair kept
                              pointing at it across audits)

``check_plan`` additionally validates the pages a dispatch is *about to
write*: every planned chunk/decode write must land on a live, exclusive
("dev", refcount == 1) page — a shared target means `_back_plan` skipped
a COW fork (cow_violation).

The wrapped ``blocks.free`` converts the allocator's double-free assert
into a reported `Finding` (so audits keep running and the soak can
report every corruption, not just the first) and bumps the generation
tag whenever a page's refcount drops to 0. Wrapping happens in
`Engine.__init__` *before* the prefix cache captures ``blocks.free`` as
its release callback, so cache-driven frees are tagged too.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis import Finding, call_site


class KVSanitizer:
    def __init__(self, engine):
        self.engine = engine
        self.findings: List[Finding] = []
        self.generation = [0] * engine.blocks.n_pages
        # (owner_key, page) -> generation observed when the pair appeared
        self._seen: Dict[Tuple[str, int], int] = {}
        self._wrap_free(engine.blocks)

    # ------------------------------------------------------------------
    # allocator shadowing
    # ------------------------------------------------------------------
    def _wrap_free(self, blocks) -> None:
        inner = blocks.free

        def free(pages) -> None:
            live = []
            for p in pages:
                if blocks._refs[p] <= 0:
                    self.findings.append(Finding(
                        kind="double_free", rid=None, page=int(p),
                        site=call_site(),
                        detail=f"free of page {p} with refcount {blocks._refs[p]}",
                    ))
                    continue
                if blocks._refs[p] == 1:
                    self.generation[p] += 1   # page is being recycled
                live.append(p)
            inner(live)

        blocks.free = free

    # ------------------------------------------------------------------
    # ownership reconstruction
    # ------------------------------------------------------------------
    def owners(self) -> Dict[int, List[str]]:
        """page id -> list of owner labels, from the engine's own tables."""
        eng = self.engine
        out: Dict[int, List[str]] = {}

        def own(pid: int, label: str) -> None:
            out.setdefault(int(pid), []).append(label)

        if getattr(eng, "scratch_page", None) is not None:
            own(eng.scratch_page, "scratch")
        for rid, st in eng.kv.items():
            for e in st.pages:
                if e is not None and e[0] == "dev":
                    own(e[1], f"req:{rid}")
        for rid, fork in getattr(eng, "_spec_forks", {}).items():
            for e in fork.st.pages:
                if e is not None and e[0] == "dev":
                    own(e[1], f"spec:{rid}")
        if eng.cache is not None:
            for pid in eng.cache.pages():
                own(pid, "cache")
        return out

    @staticmethod
    def _rid_of(labels: List[str]):
        for lab in labels:
            if ":" in lab:
                return lab.split(":", 1)[1]
        return None

    # ------------------------------------------------------------------
    # safe-point audit
    # ------------------------------------------------------------------
    def audit(self, site: str) -> None:
        blocks = self.engine.blocks
        owners = self.owners()
        seen_now: Dict[Tuple[str, int], int] = {}
        for page in range(blocks.n_pages):
            refs = blocks._refs[page]
            labels = owners.get(page, [])
            if refs == 0 and labels:
                self.findings.append(Finding(
                    kind="use_after_free", rid=self._rid_of(labels), page=page,
                    site=site,
                    detail=f"freed page still referenced by {labels}",
                ))
            elif refs > len(labels):
                self.findings.append(Finding(
                    kind="leak", rid=self._rid_of(labels), page=page, site=site,
                    detail=f"refcount {refs} but only {len(labels)} owners {labels}",
                ))
            elif refs and refs < len(labels):
                self.findings.append(Finding(
                    kind="use_after_free", rid=self._rid_of(labels), page=page,
                    site=site,
                    detail=f"{len(labels)} owners {labels} share refcount {refs}",
                ))
            for lab in labels:
                key = (lab, page)
                seen_now[key] = self.generation[page]
                before = self._seen.get(key)
                if before is not None and before != self.generation[page]:
                    self.findings.append(Finding(
                        kind="use_after_free", rid=self._rid_of([lab]), page=page,
                        site=site,
                        detail=(f"page recycled (gen {before} -> "
                                f"{self.generation[page]}) under owner {lab}"),
                    ))
        self._seen = seen_now
        self._audit_scales(site)

    def _audit_scales(self, site: str) -> None:
        """Quantized pools only: the freed => zero-scales invariant
        (DESIGN.md §17). A freed-and-recyclable page whose k/v scale rows
        are still nonzero would silently re-quantize the next owner's
        tokens against the previous owner's dynamic range."""
        eng = self.engine
        if getattr(eng, "kv_dtype", None) is None:
            return
        for page in eng._stale_scale_pages():
            self.findings.append(Finding(
                kind="stale_scale", rid=None, page=int(page), site=site,
                detail=(f"freed page {page} retains nonzero quantization "
                        "scales — scale lifetime must equal page lifetime"),
            ))

    # ------------------------------------------------------------------
    # dispatch-time write validation
    # ------------------------------------------------------------------
    def check_plan(self, plan, site: str = "dispatch") -> None:
        """Every page a planned write touches must be live + exclusive."""
        eng = self.engine
        page = eng.page

        def check_write(req, st, positions) -> None:
            for pos in positions:
                pidx = pos // page
                if pidx >= len(st.pages) or st.pages[pidx] is None:
                    self.findings.append(Finding(
                        kind="use_after_free", rid=req.rid, page=None, site=site,
                        detail=f"write to position {pos} has no block-table entry",
                    ))
                    continue
                kind, pid = st.pages[pidx]
                if kind != "dev":
                    self.findings.append(Finding(
                        kind="use_after_free", rid=req.rid, page=None, site=site,
                        detail=f"write to position {pos} lands on {kind!r} entry",
                    ))
                elif eng.blocks._refs[pid] <= 0:
                    self.findings.append(Finding(
                        kind="use_after_free", rid=req.rid, page=int(pid),
                        site=site,
                        detail=f"planned write to freed page {pid} (pos {pos})",
                    ))
                elif eng.blocks._refs[pid] > 1:
                    self.findings.append(Finding(
                        kind="cow_violation", rid=req.rid, page=int(pid),
                        site=site,
                        detail=(f"planned write to shared page {pid} "
                                f"(refcount {eng.blocks._refs[pid]}, pos {pos}) "
                                "— _back_plan did not fork"),
                    ))

        for req, n in plan.chunks:
            st = eng.kv.get(req.rid)
            if st is None:
                continue
            check_write(req, st, range(st.computed, st.computed + n))
        for req in plan.decode:
            st = eng.kv.get(req.rid)
            if st is None:
                continue
            check_write(req, st, [req.target_ctx])
        # stale-entry sweep: any dev entry pointing at a freed page, even
        # outside this plan's write set, is corruption worth flagging now.
        # Exempt this plan's staged swap-outs: the dispatch half frees the
        # source pages while the gather's DMA drains, and commit rewrites
        # those entries to ("host", ...) — an intentional in-flight window
        # (DESIGN.md §12), not a use-after-free.
        staged = getattr(eng, "_swap_out_pages", {})
        for rid, st in eng.kv.items():
            staged_idxs = set(staged.get(rid, ()))
            for i, e in enumerate(st.pages):
                if i in staged_idxs:
                    continue
                if e is not None and e[0] == "dev" and eng.blocks._refs[e[1]] <= 0:
                    self.findings.append(Finding(
                        kind="use_after_free", rid=rid, page=int(e[1]), site=site,
                        detail=f"block table references freed page {e[1]}",
                    ))
