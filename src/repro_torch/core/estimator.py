"""Interception duration estimation (§4.4).

Four modes:
  * oracle  — exact durations (upper bound; the paper reports InferCept with
              dynamic estimation reaches 93% of oracle).
  * profile — offline per-augmentation-type means (Table 1), usable when the
              type is known and stable.
  * dynamic — T̂_INT = t_now − t_call: the longer a request has been paused,
              the longer we expect it to remain paused. No profiling needed.
  * learned — an online per-tool-kind predictor: an exponential moving
              average over REALIZED pause durations, fed by ``observe()``
              from the same resume boundary the WasteLedger records
              (Scheduler.notify_resumed). The estimate is the predicted
              REMAINING duration, ``ema − elapsed``; once a pause overruns
              its prediction the estimator degrades to the dynamic rule
              (elapsed time), the same "longer paused → longer remaining"
              heuristic. A kind with no observations yet also falls back to
              dynamic, so cold starts behave exactly like the paper's
              no-profiling baseline and then converge toward profile-mode
              accuracy as resumes stream in.

``estimate()`` is a pure function of (request, now, learned state): it never
mutates predictor state, so the ledger's prediction recording cannot perturb
the stream. All mutation happens in ``observe()``. Profile-mode misses
(unprofiled kind) are the one exception — they bump ``profile_misses`` (and
the ``estimator_profile_miss`` registry counter when attached) so the silent
degradation to dynamic is visible in the Eq. 5 branch stats; the returned
value is unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.request import Request


@dataclasses.dataclass
class DurationEstimator:
    mode: str = "dynamic"              # oracle | profile | dynamic | learned
    profiles: Optional[Dict[str, float]] = None
    min_estimate: float = 1e-4
    # learned mode: EMA weight of the newest observation. 0.25 tracks
    # drifting tool latencies within a few resumes while still smoothing
    # per-call noise.
    decay: float = 0.25
    # metrics registry (optional): profile misses surface as the
    # ``estimator_profile_miss`` counter; the scheduler attaches its own
    # registry when the estimator carries none.
    registry: Optional[object] = None

    def __post_init__(self):
        self.profile_misses = 0
        self._ema: Dict[str, float] = {}
        self._obs: Dict[str, int] = {}
        self._fail_obs: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # online learning (learned mode): one realized pause per resume
    # ------------------------------------------------------------------
    def observe(self, kind: str, realized_s: float, *,
                failed: bool = False):
        """Feed one realized pause duration — called by the scheduler at
        notify_resumed, the same observation point the WasteLedger's
        intercept_finished records. Cheap for every mode (a dict update),
        consulted only by ``learned``.

        Each retry ATTEMPT is observed separately (DESIGN.md §15):
        ``failed=True`` marks a fault/timeout observation whose duration
        is the attempt's realized pause (censored at the deadline for
        timeouts). Failed attempts still update the EMA — a flaky tool's
        retries are real pause time the next Eq. 5 decision should expect
        — and are counted apart for telemetry."""
        realized_s = max(0.0, float(realized_s))
        prev = self._ema.get(kind)
        if prev is None:
            self._ema[kind] = realized_s
        else:
            self._ema[kind] = (1.0 - self.decay) * prev \
                + self.decay * realized_s
        self._obs[kind] = self._obs.get(kind, 0) + 1
        if failed:
            self._fail_obs[kind] = self._fail_obs.get(kind, 0) + 1

    def observations(self, kind: str) -> int:
        return self._obs.get(kind, 0)

    def failed_observations(self, kind: str) -> int:
        return self._fail_obs.get(kind, 0)

    def learned_mean(self, kind: str) -> Optional[float]:
        return self._ema.get(kind)

    def _count_profile_miss(self):
        self.profile_misses += 1
        if self.registry is not None:
            self.registry.counters["estimator_profile_miss"] = \
                self.registry.counters.get("estimator_profile_miss", 0) + 1

    # ------------------------------------------------------------------
    def estimate(self, req: Request, now: float) -> float:
        if req.current_int is None:
            return self.min_estimate
        if self.mode == "oracle":
            # Remaining (not total) duration: the oracle knows when it ends.
            remaining = (req.t_call + req.current_int.duration) - now
            return max(self.min_estimate, remaining)
        if self.mode == "profile":
            prof = (self.profiles or {}).get(req.current_int.kind)
            if prof is not None:
                return max(self.min_estimate, prof)
            # unprofiled kind: degrade to dynamic, but COUNT it — a silent
            # fallback skews the Eq. 5 branch stats the ledger exports
            self._count_profile_miss()
        elif self.mode == "learned":
            ema = self._ema.get(req.current_int.kind)
            if ema is not None:
                elapsed = max(0.0, now - req.t_call)
                remaining = ema - elapsed
                if remaining > 0.0:
                    return max(self.min_estimate, remaining)
                # the pause overran its prediction: dynamic regime
                return max(self.min_estimate, elapsed)
            # no observations for this kind yet: dynamic cold start
        # dynamic (also the fallback for unprofiled/unlearned types)
        return max(self.min_estimate, now - req.t_call)
