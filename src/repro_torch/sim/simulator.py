"""Discrete-event simulator for intercept-aware serving.

Drives the shared ``repro_torch.core.Scheduler`` with virtual time from the
analytic cost model — the same T_fwd/T_swap mappings the scheduler itself
uses (in the paper both come from offline profiling). This is how we
reproduce the paper's end-to-end experiments (Fig. 2, Fig. 3, the waste
fractions, and the estimator-vs-oracle comparison) on a CPU-only box.

With ``prefix_cache=True`` the simulator mirrors the engine's prefix-KV
cache hit/miss accounting (DESIGN.md §8): the same radix tree indexes
token streams — explicit ``prompt_tokens`` where the workload provides
them, synthetic unique-per-request ids elsewhere — so cross-request
prompt sharing and a discarded request's self-rehit resolve exactly as
they do in the real engine, with counter page ids standing in for
physical pages.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cache import PrefixCache
from repro_torch.core.costmodel import CostModel
from repro_torch.core.estimator import DurationEstimator
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.request import Request
from repro_torch.core.scheduler import Scheduler
from repro_torch.obs.ledger import WasteLedger
# the deterministic scripted tool return — the engine's completions and
# the speculation mirror's acceptance check share the same function
from repro_torch.serving.api_executor import returned_token_ids


@dataclasses.dataclass
class SimResult:
    policy: str
    finished: List[Request]
    sim_time: float
    iterations: int
    # GPU-memory waste accounting, byte-seconds by category
    waste_preserved: float = 0.0
    waste_recompute: float = 0.0
    waste_swap_stall: float = 0.0
    gpu_byte_seconds: float = 0.0        # total capacity * time (denominator)
    forward_time: float = 0.0
    recompute_time: float = 0.0
    stall_time: float = 0.0
    stats: Optional[object] = None
    cache_stats: Optional[object] = None   # CacheStats when prefix_cache
    # overlap accounting (DESIGN.md §12), mirroring the engine's counters
    # through the shared CostModel.overlap_terms — bit-consistent formulas
    overlap: bool = False
    swap_overlap_bytes: float = 0.0
    pipeline_bubbles: int = 0
    pipeline_bubble_s: float = 0.0
    tool_seconds: float = 0.0
    overlapped_tool_seconds: float = 0.0
    # speculative resume (DESIGN.md §14), mirroring the engine's spec_*
    # counters: forks taken at intercepts, resume-time validation
    # outcomes, and tokens grafted (returned-prefill + decoded) on accept
    spec_forks: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    spec_grafted_tokens: int = 0
    # fault-tolerance mirror (DESIGN.md §15): sessions torn down before
    # finishing, by cause — their accrued occupancy lands in
    # ledger.causes["cancelled"] / ["tool_failed"]
    cancelled: int = 0
    failed: int = 0
    # the cause-attributed WasteLedger (DESIGN.md §13), charged with the
    # exact expressions behind waste_preserved/waste_recompute/
    # waste_swap_stall above — ledger.causes mirrors those fields
    # bit-for-bit, plus idle tool_unoverlapped time and per-intercept
    # Eq. 5 branch records the legacy fields never carried
    ledger: Optional[object] = None

    # ---- headline metrics -------------------------------------------------
    def normalized_latency(self, pct: float = 50.0) -> float:
        vals = [r.latency_metrics()["normalized"] for r in self.finished]
        return float(np.percentile(vals, pct)) if vals else float("nan")

    def throughput_rps(self) -> float:
        return len(self.finished) / self.sim_time if self.sim_time else 0.0

    def ttft(self, pct: float = 50.0) -> float:
        vals = [r.latency_metrics()["ttft"] for r in self.finished
                if r.latency_metrics()["ttft"] is not None]
        return float(np.percentile(vals, pct)) if vals else float("nan")

    def waste_fraction(self) -> float:
        w = self.waste_preserved + self.waste_recompute + self.waste_swap_stall
        return w / self.gpu_byte_seconds if self.gpu_byte_seconds else 0.0

    def recompute_time_fraction(self) -> float:
        return (self.recompute_time / self.forward_time
                if self.forward_time else 0.0)

    def cache_hit_rate(self) -> float:
        """Prefix-cache hit tokens over all context-establishing tokens
        (hits + chunk-prefilled fresh + recomputed)."""
        if self.stats is None:
            return 0.0
        hit = getattr(self.stats, "cache_hit_tokens", 0)
        denom = hit + self.stats.fresh_tokens + self.stats.recompute_tokens
        return hit / denom if denom else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "finished": len(self.finished),
            "sim_time_s": round(self.sim_time, 2),
            "throughput_rps": round(self.throughput_rps(), 4),
            "norm_latency_p50_s_per_tok": round(self.normalized_latency(), 5),
            "norm_latency_p90_s_per_tok": round(self.normalized_latency(90),
                                                5),
            "ttft_p50_s": round(self.ttft(), 4),
            "waste_fraction": round(self.waste_fraction(), 4),
            "recompute_time_fraction": round(self.recompute_time_fraction(),
                                             4),
        }


def simulate(requests: Sequence[Request], policy: PolicyConfig,
             cost: CostModel, *, estimator: Optional[DurationEstimator] = None,
             profiles: Optional[dict] = None, max_time: float = 36000.0,
             max_iters: int = 2_000_000, prefix_cache: bool = False,
             cache_page_size: int = 16,
             cache_max_pages: Optional[int] = None,
             overlap: bool = False,
             gpu_capacity_tokens: Optional[int] = None,
             speculate: bool = False, predictor=None,
             spec_tokens: int = 32, spec_vocab: int = 50_000,
             registry=None,
             cancel_at: Optional[Dict[int, int]] = None,
             fail_at: Optional[Dict[int, int]] = None,
             sanitize: bool = False) -> SimResult:
    """``cancel_at`` maps rid -> output-token threshold: once the request
    has emitted that many tokens it is torn down as a caller cancellation.
    ``fail_at`` maps rid -> seg_idx AT DISPATCH TIME (segment completion
    already advanced it, so segment 0's interception is seg_idx=1 — the
    same keying as ToolCall.seg_idx): that interception resolves as a
    TERMINAL tool failure at its completion time instead of resuming.
    Both mirror the engine's teardown accounting (DESIGN.md §15): accrued
    device occupancy (context tokens * M integrated over residency, plus
    any live speculative fork's) is charged to the matching ledger cause
    in one lump. Retry/backoff timelines are engine-side fault POLICY,
    not mirrored here — the simulator models outcomes, so engine<->sim
    ledger comparisons stay meaningful at the terminal boundary."""
    if estimator is None:
        estimator = DurationEstimator(mode=policy.estimator,
                                      profiles=profiles)
    # gpu_capacity_tokens mirrors the engine's page-pool-derived capacity
    # so engine<->sim ledger comparisons run at identical occupancy
    sched = Scheduler(policy, cost, estimator=estimator,
                      gpu_capacity_tokens=gpu_capacity_tokens,
                      registry=registry)
    ledger = WasteLedger(cost, sched.gpu_capacity,
                         registry=sched.registry)
    arrivals = deque(sorted(requests, key=lambda r: r.arrival))
    resume_heap: list = []       # (resume_time, rid, request)
    now = 0.0
    iters = 0
    res = SimResult(policy=policy.name, finished=[], sim_time=0.0,
                    iterations=0, overlap=overlap, ledger=ledger)
    m = cost.m_bytes
    # tool-overlap integral, mirroring the engine (DESIGN.md §12): per
    # in-flight interception [t_call, due, accum]; each iteration adds its
    # exact intersection with the pause window
    tool_windows: Dict[int, List[float]] = {}

    # ---- teardown mirror (DESIGN.md §15) ----------------------------------
    # per-request occupancy integral: device_tokens * M accumulated over
    # every busy iteration and idle gap the context sat resident — the
    # engine's _accrued_bs, charged in one lump only if the session is
    # torn down (finish pops it; fault-free runs add nothing new)
    cancel_at = dict(cancel_at or {})
    fail_at = dict(fail_at or {})
    accrued: Dict[int, float] = {}

    def teardown(req: Request, t: float, cause: str):
        win = tool_windows.pop(req.rid, None)
        if win is not None:
            # mid-pause: clamp the overlap credit at the pause actually
            # realized and count the truncated pause as tool time
            res.overlapped_tool_seconds += min(
                win[2], max(0.0, t - win[0]))
            res.tool_seconds += max(0.0, t - win[0])
        ledger.intercept_finished(req.rid, req.decision or "none", t)
        fork_bs = 0.0
        fork = spec_forks.pop(req.rid, None)
        if fork is not None:
            fork_bs = fork["bs"]
        sched.notify_cancelled(req, t, cause=cause)
        ledger.charge_abandoned(cause, accrued.pop(req.rid, 0.0) + fork_bs)
        if cause == "cancelled":
            res.cancelled += 1
        else:
            res.failed += 1

    # ---- prefix-cache mirror (same accounting as Engine) ------------------
    cache = None
    if prefix_cache:
        page = cache_page_size
        cache = PrefixCache(page, max_pages=(
            cache_max_pages if cache_max_pages is not None
            else max(1, sched.gpu_capacity // page)))
        res.cache_stats = cache.stats
        pid_source = itertools.count()
        streams: Dict[int, List[int]] = {}
        # Gen/returned token ids are unknown to the simulator, so each
        # request extends its stream with ids unique to (rid, position):
        # self-rehit after a discard matches exactly (same ids), while
        # cross-request sharing happens only through real prompt_tokens —
        # the same two reuse channels the engine sees.
        GEN_BASE = 1 << 42

        def stream(req: Request, n: int) -> List[int]:
            s = streams.get(req.rid)
            if s is None:
                s = (list(req.prompt_tokens) if req.prompt_tokens is not None
                     else [-(req.rid * 1_000_003 + i + 1)
                           for i in range(req.prompt_len)])
                streams[req.rid] = s
            while len(s) < n:
                s.append(GEN_BASE + req.rid * 1_000_000 + len(s))
            return s[:n]

        def cache_probe(req: Request) -> int:
            if req.host_tokens:
                return 0
            return (req.device_tokens // page) * page

        sched.cache_probe = cache_probe

        match_seen: Dict[int, int] = {}      # rid -> gen of a known miss

        def register(req: Request, computed: int):
            full = (computed // page) * page
            if full > 0 and not req.host_tokens:
                cache.insert(stream(req, full),
                             [next(pid_source) for _ in range(full // page)])

        def on_discard(req: Request, n_tokens: int):
            register(req, req.device_tokens)
            match_seen.pop(req.rid, None)

        sched.on_discard = on_discard

        def try_match(req: Request):
            # mirror Engine._try_cache_match: cap at target-1 AND at free
            # capacity (credits count against it); misses are memoized on
            # the cache generation (zero-hit is first-block-determined)
            if req.device_tokens or req.host_tokens:
                return
            if match_seen.get(req.rid) == cache.generation:
                return
            limit = min(req.target_ctx - 1, sched.gpu_free())
            if limit <= 0:
                return
            hit = cache.match(stream(req, limit)).total
            if hit > 0:
                sched.notify_cache_hit(req, hit)
            else:
                match_seen[req.rid] = cache.generation

    # ---- speculative-resume mirror (DESIGN.md §14) ------------------------
    # The engine's fork machinery without the tensors: fork/step cadence,
    # occupancy accrual, acceptance (predictor output vs the deterministic
    # scripted return), and the graft's scheduler bookkeeping all use the
    # same formulas, so engine<->sim speculation accounting stays
    # comparable. The simulator has no physical page pool, so the engine's
    # page-pressure fork kills have no mirror here.
    speculate = bool(speculate and predictor is not None)
    spec_forks: Dict[int, dict] = {}

    def spec_maybe_fork(req: Request, intc):
        seg_next = req.seg_idx + 1
        if (not speculate or req.rid in spec_forks
                or seg_next >= len(req.segments)):
            return
        if req.host_tokens or req.device_tokens != req.target_ctx:
            return
        nxt = req.segments[seg_next]
        if nxt.open or (nxt.gen_tokens or 0) < 1:
            return
        pred = predictor.predict(req.rid, intc.kind, seg_next,
                                 intc.returned_tokens)
        if not pred:
            return
        spec_forks[req.rid] = {
            "base": req.target_ctx, "predicted": [int(p) for p in pred],
            "max_emit": min(spec_tokens, nxt.gen_tokens),
            "emitted": 0, "computed": req.target_ctx, "bs": 0.0}
        res.spec_forks += 1

    def spec_advance(fork: dict) -> bool:
        # engine cadence: first step prefills the predicted return and
        # emits the seed token; each later step decodes one token
        if fork["emitted"] >= fork["max_emit"]:
            return False
        if fork["emitted"] == 0:
            fork["computed"] += len(fork["predicted"])
            fork["emitted"] = 1
        else:
            fork["computed"] += 1
            fork["emitted"] += 1
        return True

    def spec_step_forks(iter_time: float):
        for fork in spec_forks.values():
            spec_advance(fork)
            # post-step accrual (engine mirror): the iteration that
            # materialized the prefill already pays for its residency
            fork["bs"] += (fork["computed"] - fork["base"]) * m * iter_time

    def spec_idle(gap: float):
        for fork in spec_forks.values():
            budget = gap
            while fork["emitted"] < fork["max_emit"]:
                q = len(fork["predicted"]) if fork["emitted"] == 0 else 1
                t = cost.t_fwd(q, fork["computed"] + q)
                if t > budget or not spec_advance(fork):
                    break
                budget -= t
            fork["bs"] += (fork["computed"] - fork["base"]) * m * gap

    def spec_validate(req: Request) -> bool:
        fork = spec_forks.pop(req.rid, None)
        if fork is None:
            return False
        actual = [int(x) for x in returned_token_ids(
            req.rid, req.seg_idx, req.current_int.returned_tokens,
            spec_vocab)]
        if fork["emitted"] < 1 or actual != fork["predicted"]:
            ledger.charge_speculation(fork["bs"])
            res.spec_rejected += 1
            return False
        k = fork["emitted"]
        sched.notify_spec_graft(req,
                                fork["base"] + len(fork["predicted"]))
        sched.notify_resumed(req, now)
        for _ in range(k - 1):   # graft the fork's decoded tokens
            req.target_ctx += 1
            req.device_tokens += 1
            req.gen_in_seg += 1
            req.output_tokens += 1
        if k > 1 and req.first_token_time is None:
            req.first_token_time = now
        res.spec_accepted += 1
        res.spec_grafted_tokens += k
        return True

    # lifecycle enforcement (DESIGN.md §16): the simulator drives the
    # same Request.phase seam as the engine, so sanitize=True asserts
    # every scheduler-side transition here too; off by default, free
    if sanitize:
        from repro_torch.analysis.lifecycle import LifecycleChecker
        lifecycle_checker = LifecycleChecker()
    else:
        lifecycle_checker = None

    def admit(upto: float):
        while arrivals and arrivals[0].arrival <= upto:
            req = arrivals.popleft()
            if lifecycle_checker is not None:
                req.__dict__["_lifecycle"] = lifecycle_checker
            sched.submit(req)

    while (arrivals or sched.has_work()) and now < max_time \
            and iters < max_iters:
        admit(now)
        while resume_heap and resume_heap[0][0] <= now:
            t, _, req = heapq.heappop(resume_heap)
            if req.rid not in sched.live:
                continue          # torn down while paused; entry is stale
            if fail_at.get(req.rid) == req.seg_idx:
                # the tool's terminal failure surfaces at its completion
                # time — same virtual instant the engine's fault fires
                estimator.observe(req.current_int.kind,
                                  max(0.0, t - req.t_call), failed=True)
                teardown(req, t, "tool_failed")
                continue
            res.tool_seconds += max(0.0, t - req.t_call)
            win = tool_windows.pop(req.rid, None)
            if win is not None:
                res.overlapped_tool_seconds += win[2]
            ledger.intercept_finished(req.rid, req.decision or "none", t)
            if spec_validate(req):
                continue   # accepted fork grafted; re-prefill skipped
            sched.notify_resumed(req, now)
        if cache is not None:
            for req in list(sched.waiting):
                try_match(req)

        plan = sched.next_iteration(now)
        if plan.empty:
            # idle: jump to the next event (engine _advance_idle mirror)
            INF = float("inf")
            t_arr = arrivals[0].arrival if arrivals else INF
            t_res = resume_heap[0][0] if resume_heap else INF
            if t_arr == INF and t_res == INF:
                break
            target = max(now, min(t_arr, t_res))
            gap = target - now
            if gap > 0.0:
                # a jump to a pending tool completion is pause time that
                # overlapped no serving work — pinned context there is
                # pure tool_unoverlapped waste
                ledger.charge_idle(gap, sched.gpu_used(), t_res <= t_arr)
                for req in sched.live.values():
                    if req.device_tokens:
                        accrued[req.rid] = accrued.get(req.rid, 0.0) \
                            + req.device_tokens * m * gap
                if spec_forks:
                    spec_idle(gap)
            now = target
            continue

        iters += 1
        t_model = cost.t_fwd(max(1, plan.query_tokens),
                             plan.context_tokens)
        if overlap:
            # pipelined-step charging (DESIGN.md §12): swap DMA hides
            # under the model window, only the remainder stalls — the
            # same CostModel.overlap_terms the engine's commit phase uses
            swap_tokens = (sum(n for _, n in plan.swap_out)
                           + sum(n for _, n in plan.swap_in))
            hidden, stall = cost.overlap_terms(t_model, swap_tokens,
                                               plan.stall_s)
            if swap_tokens:
                res.swap_overlap_bytes += hidden * m
            if stall > 0.0:
                res.pipeline_bubbles += 1
                res.pipeline_bubble_s += stall
        else:
            stall = plan.stall_s
        iter_time = t_model + stall
        end = now + iter_time
        for win in tool_windows.values():
            win[2] += max(0.0, min(end, win[1]) - max(now, win[0]))

        # ---- waste accounting over [now, end) -----------------------------
        res.gpu_byte_seconds += iter_time * sched.gpu_capacity * m
        res.waste_preserved += iter_time * sched.paused_device_tokens() * m
        rec_tokens = sum(min(n, sched._recompute_debt.get(r.rid, 0))
                         for r, n in plan.chunks)
        if plan.query_tokens:
            rec_share = rec_tokens / plan.query_tokens
            res.recompute_time += iter_time * rec_share
            # Eq.1-style: recompute's own occupancy + everyone else's memory
            # held during the recompute-attributable part of the iteration.
            res.waste_recompute += (iter_time * rec_share
                                    * sched.gpu_used() * m)
        res.forward_time += iter_time - stall
        res.stall_time += stall
        if stall:
            res.waste_swap_stall += stall * sched.gpu_used() * m
        # the cause-attributed ledger runs the SAME expressions on the
        # same pre-commit state, so its causes equal the legacy fields
        # above bit-for-bit (and the engine's ledger, token-granularity
        # permitting)
        ledger.charge_iteration(iter_time, stall, overlap, rec_tokens,
                                plan.query_tokens,
                                sched.paused_device_tokens(),
                                sched.gpu_used())
        # per-request occupancy accrual (engine _accrued_bs mirror):
        # pre-commit device context, same observation point as the charges
        for req in sched.live.values():
            if req.device_tokens:
                accrued[req.rid] = accrued.get(req.rid, 0.0) \
                    + req.device_tokens * m * iter_time

        events = sched.apply_plan(plan, end)
        if cache is not None:
            # mirror the engine's registration points: prefill/recompute
            # completion and request finish publish the computed context
            for req, _ in plan.chunks:
                if req.context_ready:
                    register(req, req.device_tokens)
            for req in events["finished"]:
                register(req, req.target_ctx)
        for req, intc in events["intercepted"]:
            c_before, gpu_before = req.device_tokens, sched.gpu_used()
            spec_maybe_fork(req, intc)   # mirror: before the pause decision
            sched.notify_intercepted(req, intc, end)
            ledger.intercept_started(
                req.rid, intc.kind, end,
                sched.estimator.estimate(req, end), c_before, gpu_before)
            tool_windows[req.rid] = [end, end + intc.duration, 0.0]
            heapq.heappush(resume_heap,
                           (end + intc.duration, req.rid, req))
        res.finished.extend(events["finished"])
        for req in events["finished"]:
            accrued.pop(req.rid, None)
        # caller cancellations: threshold crossings observed post-commit,
        # the same boundary the engine's queued cancels resolve at
        for rid in [r for r, thr in cancel_at.items()
                    if r in sched.live
                    and sched.live[r].output_tokens >= thr]:
            teardown(sched.live[rid], end, "cancelled")
            del cancel_at[rid]
        # step forks LAST (engine mirror): a fork created by this
        # iteration's intercepts still piggybacks on this iteration
        if spec_forks:
            spec_step_forks(iter_time)
        now = end

    res.sim_time = now
    res.iterations = iters
    res.stats = sched.stats
    return res
