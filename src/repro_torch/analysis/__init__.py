"""Invariant enforcement: runtime sanitizers + a static lint pass.

Two sides of the same contract (DESIGN.md §16):

* **Runtime** — `KVSanitizer` shadows the engine's `BlockManager` with
  per-page ownership records and audits them at every plan-phase safe
  point; `LifecycleChecker` asserts every `Request.phase` transition
  against the declarative table in `lifecycle.TRANSITIONS`. Both are
  attached only under ``Engine(sanitize=True)`` — the default path
  carries a ``None`` attribute and allocates nothing per step (the same
  discipline as ``NullTracer``).

* **Static** — ``python -m repro_torch.analysis.lint src tests`` walks the
  package ASTs and enforces the project rules that runtime checks can't
  see: no host-sync reachable from ``_dispatch*``, no wall-clock or
  unseeded randomness in virtual-time code, every counter/cause key
  declared in the `obs` schema, and donation paired with every aliased
  `pallas_call`'s jit site.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Finding:
    """One detected invariant violation, with enough context to act on."""

    kind: str   # leak | double_free | use_after_free | cow_violation | stale_scale
    rid: Optional[str]         # owning request id, when attributable
    page: Optional[int]        # page id, when attributable
    site: str                  # safe point or call site that detected it
    detail: str

    def __str__(self) -> str:  # pragma: no cover - formatting only
        who = f" rid={self.rid}" if self.rid is not None else ""
        pg = f" page={self.page}" if self.page is not None else ""
        return f"[{self.kind}]{who}{pg} at {self.site}: {self.detail}"


def call_site(skip=("request.py", "lifecycle.py", "ownership.py")) -> str:
    """Best-effort ``file:line`` of the first frame outside the checkers.

    Only used on failure paths, so the frame walk's cost never touches
    the sanitize-off (or even the sanitize-on happy) path.
    """
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.rsplit("/", 1)[-1]
        if name not in skip:
            return f"{name}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


_EXPORTS = {
    "KVSanitizer": "repro_torch.analysis.ownership",
    "LifecycleChecker": "repro_torch.analysis.lifecycle",
    "IllegalTransition": "repro_torch.analysis.lifecycle",
    "TRANSITIONS": "repro_torch.analysis.lifecycle",
    "run_lint": "repro_torch.analysis.lint",
}


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name if name != "run_lint" else "run")
    globals()[name] = value
    return value


__all__ = ["Finding", "call_site", *_EXPORTS.keys()]
