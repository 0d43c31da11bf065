"""Declarative request-lifecycle state machine.

`TRANSITIONS` is the single source of truth for which `Phase` moves are
legal anywhere in the stack — engine, scheduler, and simulator all
mutate ``Request.phase`` through the property seam installed in
`repro_torch.core.request`, so attaching a `LifecycleChecker` to a request
(``req.__dict__["_lifecycle"] = checker``) is enough to assert every
transition at its faulting call site. No engine/scheduler code needs to
know the checker exists; requests without one pay a single dict lookup
per phase write.

The table mirrors DESIGN.md §11/§14/§15:

* WAITING -> RUNNING when scheduled (or straight to CANCELLED/FAILED
  if the session dies in queue).
* RUNNING -> PAUSED at an intercept, FINISHED at EOS/target, WAITING
  when preempted-with-discard (recompute), or a terminal fault state.
* PAUSED -> SWAPQ (preserve chose swap), WAITING (discard during the
  pause), RUNNING (tool returned while still resident), or terminal.
* SWAPQ -> WAITING (swap-in failed -> recompute), RUNNING (resumed),
  or terminal (cancel/fault while swapped out).
* FINISHED / CANCELLED / FAILED are terminal; self-transitions are
  no-ops filtered by the property seam (``new is old``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core.request import Phase

from repro_torch.analysis import call_site

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.request import Request

TRANSITIONS = {
    Phase.WAITING: frozenset({Phase.RUNNING, Phase.CANCELLED, Phase.FAILED}),
    Phase.RUNNING: frozenset(
        {Phase.PAUSED, Phase.FINISHED, Phase.WAITING, Phase.CANCELLED, Phase.FAILED}
    ),
    Phase.PAUSED: frozenset(
        {Phase.SWAPQ, Phase.WAITING, Phase.RUNNING, Phase.CANCELLED, Phase.FAILED}
    ),
    Phase.SWAPQ: frozenset(
        {Phase.WAITING, Phase.RUNNING, Phase.CANCELLED, Phase.FAILED}
    ),
    Phase.FINISHED: frozenset(),
    Phase.CANCELLED: frozenset(),
    Phase.FAILED: frozenset(),
}


class IllegalTransition(AssertionError):
    """A phase move not present in `TRANSITIONS`."""

    def __init__(self, rid: str, old: Phase, new: Phase, site: str):
        self.rid, self.old, self.new, self.site = rid, old, new, site
        super().__init__(
            f"illegal lifecycle transition {old.name} -> {new.name} "
            f"for request {rid!r} at {site}"
        )


class LifecycleChecker:
    """Raises `IllegalTransition` on any move outside the table.

    Raise-only (no findings list): an illegal phase move means host
    bookkeeping is already inconsistent, so continuing the step would
    only bury the faulting site under downstream corruption.
    """

    __slots__ = ("transitions",)

    def __init__(self, transitions=None):
        self.transitions = TRANSITIONS if transitions is None else transitions

    def on_transition(self, req: "Request", old: Phase, new: Phase) -> None:
        if new not in self.transitions.get(old, frozenset()):
            raise IllegalTransition(req.rid, old, new, call_site())
