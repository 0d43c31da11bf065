"""The waste ledger: every wasted GPU byte-second charged to a cause.

InferCept's headline measurement (§3.2, Fig. 3) is an attribution: how
much GPU memory was held *without producing tokens*, and why. The ledger
integrates that over the virtual clock with one charge call per executed
iteration plus one per idle clock-jump, splitting the total across:

  * ``recompute``       — Eq. 1/4: the recompute-attributable share of an
                          iteration holds the whole batch's memory while
                          producing no new tokens
                          (``iter_time * rec_share * gpu_used * M``).
  * ``swap_stall``      — Eq. 3's stall term under the serial engine:
                          synchronous swap DMA stalls the batch
                          (``stall * gpu_used * M``).
  * ``preserve_pinned`` — Eq. 2: paused requests' device-resident context
                          pinned during busy iterations
                          (``iter_time * paused_tokens * M``).
  * ``pipeline_bubble`` — the overlap engine's residual stall: transfer
                          time that exceeded the model window.
  * ``tool_unoverlapped`` — idle clock-jumps spent waiting on a tool
                          completion while context stayed pinned: pause
                          time that overlapped NOTHING (the complement of
                          the engine's ``overlapped_tool_seconds``).
  * ``speculation_wasted`` — speculative-resume forks (DESIGN.md §14)
                          whose prediction was REJECTED at resume: the
                          byte-seconds their extra KV pages were held,
                          integrated per iteration while the fork was
                          alive and charged in one lump at rejection
                          (accepted forks charge nothing — their pages
                          became the resumed context).
  * ``cancelled`` / ``tool_failed`` — sessions torn down mid-flight
                          (caller cancellation / terminal tool failure,
                          DESIGN.md §15): the byte-seconds their context
                          occupied while resident, charged in one lump at
                          teardown — nothing they held produced consumable
                          output.

The per-iteration formulas are exactly the simulator's legacy
``waste_preserved`` / ``waste_recompute`` / ``waste_swap_stall`` lines,
so for token-granular policies the engine's ledger and the simulator's
are bit-identical (the mirror test); the legacy SimResult fields remain
and must equal the matching causes bit-for-bit on non-overlap runs.

``total_check`` is an independent accumulator summed in per-iteration
order (different float addition order than summing the per-cause
totals), so the exporter/CI invariant — causes sum to total waste within
float tolerance — is a real crosscheck, not an identity.

Per intercept, the ledger also records the chosen Eq. 5 branch with its
predicted and realized waste (§4.4 estimator accuracy): ``waste_preserve``
at the predicted vs realized pause duration for preserves, Eq. 4's
chunked-discard waste for discards, Eq. 3 for swaps (both
duration-independent — the error still lands in the estimator metrics).
Absolute estimation error feeds a histogram and a per-tool-kind signed
bias gauge in the registry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.waste import (waste_chunked_discard, waste_preserve,
                              waste_swap)
from repro_torch.obs.metrics import WASTE_CAUSE_SCHEMA, MetricsRegistry

# the declared cause schema IS the ledger's cause list — one source of
# truth shared with the static lint and the sanitize-mode fail-fast view
WASTE_CAUSES = WASTE_CAUSE_SCHEMA


@dataclasses.dataclass
class InterceptRecord:
    """One interception's accounting: what the estimator predicted at
    t_call, what actually happened, and the Eq. 5 waste either way."""
    rid: int
    kind: str
    t_call: float
    predicted_s: float
    c_tokens: int            # paused context at the intercept
    gpu_used_tokens: int     # whole-batch context at the intercept
    branch: str = ""         # preserve | discard | swap | pending | none
    t_done: float = 0.0
    realized_s: float = 0.0
    predicted_waste: float = 0.0
    realized_waste: float = 0.0


class WasteLedger:
    def __init__(self, cost, gpu_capacity_tokens: int,
                 registry: Optional[MetricsRegistry] = None):
        self.cost = cost
        self.capacity = int(gpu_capacity_tokens)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.causes: Dict[str, float] = {c: 0.0 for c in WASTE_CAUSES}
        self.gpu_byte_seconds = 0.0    # capacity * busy time (denominator)
        self.forward_time = 0.0
        self.recompute_time = 0.0
        self.stall_time = 0.0
        self.busy_time = 0.0
        self.idle_time = 0.0
        self.iterations = 0
        self.total_check = 0.0         # independent sum, iteration order
        self._open: Dict[int, InterceptRecord] = {}
        self.records: List[InterceptRecord] = []
        self._kind_err: Dict[str, List[float]] = {}  # kind -> [sum, n]

    # ------------------------------------------------------------------
    # per-iteration charges (mirrored bit-for-bit by sim/simulator.py)
    # ------------------------------------------------------------------
    def charge_iteration(self, iter_time: float, stall: float,
                         overlap: bool, rec_tokens: int, query_tokens: int,
                         paused_tokens: int, gpu_used_tokens: int):
        """Charge one executed iteration. Must be called with the
        scheduler state BEFORE apply_plan (rec_tokens from the current
        recompute debt, paused/used tokens from the pre-commit batch) —
        the same observation point as the simulator's accounting."""
        m = self.cost.m_bytes
        self.iterations += 1
        self.busy_time += iter_time
        self.gpu_byte_seconds += iter_time * self.capacity * m
        charged = iter_time * paused_tokens * m
        self.causes["preserve_pinned"] += charged
        if query_tokens:
            rec_share = rec_tokens / query_tokens
            self.recompute_time += iter_time * rec_share
            w_rec = iter_time * rec_share * gpu_used_tokens * m
            self.causes["recompute"] += w_rec
            charged += w_rec
        self.forward_time += iter_time - stall
        self.stall_time += stall
        if stall:
            w_stall = stall * gpu_used_tokens * m
            self.causes["pipeline_bubble" if overlap
                        else "swap_stall"] += w_stall
            charged += w_stall
        self.total_check += charged

    def charge_idle(self, gap: float, gpu_used_tokens: int,
                    tool_wait: bool):
        """Charge an idle clock-jump of ``gap`` virtual seconds. When the
        jump target is a pending tool completion (``tool_wait``: the
        engine had nothing schedulable and the next event is a tool
        resume, not an arrival), any pinned context was held for a pause
        that overlapped no serving work — the paper's worst case for
        Preserve."""
        self.idle_time += gap
        if tool_wait and gpu_used_tokens:
            w = gap * gpu_used_tokens * self.cost.m_bytes
            self.causes["tool_unoverlapped"] += w
            self.total_check += w

    def charge_speculation(self, byte_seconds: float):
        """Charge a REJECTED speculative fork's accumulated occupancy
        (extra fork tokens * M integrated over the fork's lifetime) to
        ``speculation_wasted``. Called once per rejected fork, at resume
        validation; accepted forks never reach here."""
        if byte_seconds <= 0.0:
            return
        self.causes["speculation_wasted"] += byte_seconds
        self.total_check += byte_seconds

    def charge_abandoned(self, cause: str, byte_seconds: float):
        """Charge a torn-down session's accumulated device occupancy (its
        context tokens * M integrated over its resident lifetime, plus any
        live speculative fork's) to ``cancelled`` or ``tool_failed``
        (DESIGN.md §15): every byte-second the session held produced
        output the caller will never consume, so at teardown the whole
        accrual becomes waste in one lump — same shape as
        ``charge_speculation``."""
        assert cause in ("cancelled", "tool_failed"), cause
        if byte_seconds <= 0.0:
            return
        self.causes[cause] += byte_seconds
        self.total_check += byte_seconds

    # ------------------------------------------------------------------
    # per-intercept records (§4.4 estimator accuracy)
    # ------------------------------------------------------------------
    def intercept_started(self, rid: int, kind: str, t_call: float,
                          predicted_s: float, c_tokens: int,
                          gpu_used_tokens: int):
        self._open[rid] = InterceptRecord(
            rid=rid, kind=kind, t_call=t_call, predicted_s=predicted_s,
            c_tokens=c_tokens, gpu_used_tokens=gpu_used_tokens)

    def intercept_finished(self, rid: int, branch: str,
                           t_done: float) -> Optional[InterceptRecord]:
        rec = self._open.pop(rid, None)
        if rec is None:
            return None
        rec.branch = branch or "none"
        rec.t_done = t_done
        rec.realized_s = max(0.0, t_done - rec.t_call)
        rec.predicted_waste = self._branch_waste(rec, rec.predicted_s)
        rec.realized_waste = self._branch_waste(rec, rec.realized_s)
        self.records.append(rec)
        err = rec.predicted_s - rec.realized_s
        reg = self.registry
        reg.observe("estimator_abs_err_s", abs(err))
        acc = self._kind_err.setdefault(rec.kind, [0.0, 0.0])
        acc[0] += err
        acc[1] += 1.0
        reg.gauge(f"estimator_bias_s_{rec.kind}", acc[0] / acc[1])
        return rec

    def _branch_waste(self, rec: InterceptRecord, t_int: float) -> float:
        """Eq. 5 branch waste for this interception evaluated at pause
        duration ``t_int`` (only the preserve branch depends on it)."""
        m = self.cost.m_bytes
        c = rec.c_tokens
        if rec.branch == "discard":
            c_r, t_fwd_c, n_chunks, t_fwd_chunk = \
                self.cost.recompute_terms(c)
            return waste_chunked_discard(
                t_fwd_c, c_r, m, n_chunks, t_fwd_chunk,
                max(0, rec.gpu_used_tokens - c))
        if rec.branch == "swap":
            # Eq. 3 at the batch context observed when the swap decision
            # was taken (the stall holds everyone's memory)
            return waste_swap(self.cost.t_swap(c), rec.gpu_used_tokens, m)
        # preserve / pending / none: context pinned for the pause
        return waste_preserve(t_int, c, m)

    # ------------------------------------------------------------------
    def total_waste(self) -> float:
        return sum(self.causes.values())

    def waste_fraction(self) -> float:
        return (self.total_waste() / self.gpu_byte_seconds
                if self.gpu_byte_seconds else 0.0)

    def estimator_stats(self) -> Dict[str, dict]:
        out = {}
        for kind, (s, n) in sorted(self._kind_err.items()):
            recs = [r for r in self.records if r.kind == kind]
            out[kind] = {
                "n": int(n),
                "bias_s": s / n if n else 0.0,
                "abs_err_s": (sum(abs(r.predicted_s - r.realized_s)
                                  for r in recs) / n if n else 0.0),
            }
        return out


def waste_report(ledger: WasteLedger) -> dict:
    """JSON-ready breakdown: per-cause byte-seconds, the independent
    total crosscheck, time split, and the per-intercept estimator view.
    ``repro_torch.obs.check`` re-asserts sum(causes) == total_waste_check."""
    branches: Dict[str, int] = {}
    for r in ledger.records:
        branches[r.branch] = branches.get(r.branch, 0) + 1
    return {
        "causes": dict(ledger.causes),
        "total_waste": ledger.total_waste(),
        "total_waste_check": ledger.total_check,
        "gpu_byte_seconds": ledger.gpu_byte_seconds,
        "waste_fraction": ledger.waste_fraction(),
        "busy_time_s": ledger.busy_time,
        "idle_time_s": ledger.idle_time,
        "forward_time_s": ledger.forward_time,
        "recompute_time_s": ledger.recompute_time,
        "stall_time_s": ledger.stall_time,
        "iterations": ledger.iterations,
        "intercepts": {
            "n": len(ledger.records),
            "branches": branches,
            "predicted_waste": sum(r.predicted_waste
                                   for r in ledger.records),
            "realized_waste": sum(r.realized_waste
                                  for r in ledger.records),
            "estimator": ledger.estimator_stats(),
        },
    }
