"""InferCept's iteration-level min-waste scheduler (§4), plus the baseline
policies (Discard/vLLM, ImprovedDiscard, Preserve, Swap) expressed as
configurations of the same machinery.

The scheduler is engine-agnostic: it plans token movement per iteration
(IterationPlan) and does the bookkeeping in apply_plan(); the discrete-event
simulator and the real JAX serving engine both drive it, the latter
additionally executing the plan on device (model step, page swaps,
recompute chunks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.estimator import DurationEstimator
from repro_torch.core.policy import SHORT_RUNNING_KINDS, PolicyConfig
from repro_torch.core.request import Interception, Phase, Request
from repro_torch.core.waste import min_waste_decision
from repro_torch.obs.metrics import SCHED_COUNTER_SCHEMA, MetricsRegistry


@dataclasses.dataclass
class IterationPlan:
    decode: List[Request] = dataclasses.field(default_factory=list)
    chunks: List[Tuple[Request, int]] = dataclasses.field(default_factory=list)
    swap_out: List[Tuple[Request, int]] = dataclasses.field(default_factory=list)
    swap_in: List[Tuple[Request, int]] = dataclasses.field(default_factory=list)
    stall_s: float = 0.0        # synchronous-swap stall (Swap baseline)

    @property
    def query_tokens(self) -> int:
        return len(self.decode) + sum(n for _, n in self.chunks)

    @property
    def context_tokens(self) -> int:
        return (sum(r.device_tokens for r in self.decode)
                + sum(r.device_tokens for r, _ in self.chunks))

    @property
    def empty(self) -> bool:
        return (not self.decode and not self.chunks and not self.swap_out
                and not self.swap_in)


class SchedulerStats:
    """Scheduler counters, stored in a MetricsRegistry under a ``sched_``
    prefix. Attribute reads/writes route straight to the registry cells
    (same int objects, no copies), so legacy ``sched.stats.discards += 1``
    call sites and tests keep their exact semantics while the counters
    show up in the shared telemetry dump.

    Fields:
      recompute_tokens / fresh_tokens / decode_tokens — query-token mix
      swapped_out_tokens / swapped_in_tokens — swap traffic
      discards / preserves / swaps / evictions — pause decisions
      cache_hit_tokens — tokens restored from the prefix cache instead of
        being recomputed (credited via notify_cache_hit; they reduce
        recompute debt)
      swap_in_failures — planned swap-ins the engine could not back with
        physical pages; the request was re-preempted to recompute
        instead of crashing the engine
      pool_preempts — planned chunk/decode work the engine could not back
        (COW / pool exhaustion); re-preempted to recompute, same seam
      cancellations / tool_failures — sessions torn down mid-flight
        (caller cancel / terminal tool failure, DESIGN.md §15)
    """

    # the declared schema in repro_torch.obs.metrics is the single source of
    # truth for these field names (shared with the static lint pass)
    _FIELDS = SCHED_COUNTER_SCHEMA

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "sched_"):
        object.__setattr__(self, "_reg",
                           registry if registry is not None
                           else MetricsRegistry())
        object.__setattr__(self, "_prefix", prefix)
        for f in self._FIELDS:
            self._reg.counters.setdefault(prefix + f, 0)

    def __getattr__(self, name):
        if name in SchedulerStats._FIELDS:
            return self._reg.counters[self._prefix + name]
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}")

    def __setattr__(self, name, value):
        if name in SchedulerStats._FIELDS:
            self._reg.counters[self._prefix + name] = value
        else:
            object.__setattr__(self, name, value)

    def __repr__(self):
        body = ", ".join(f"{f}={getattr(self, f)}" for f in self._FIELDS)
        return f"SchedulerStats({body})"


class Scheduler:
    def __init__(self, policy: PolicyConfig, cost: CostModel, *,
                 estimator: Optional[DurationEstimator] = None,
                 gpu_capacity_tokens: Optional[int] = None,
                 cpu_capacity_tokens: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.policy = policy
        self.cost = cost
        self.estimator = estimator or DurationEstimator(mode=policy.estimator)
        self.gpu_capacity = (gpu_capacity_tokens if gpu_capacity_tokens
                             is not None else cost.kv_capacity_tokens())
        # Paper setup: ample host memory (A100 boxes have >1TB); default to
        # 4x device KV capacity.
        self.cpu_capacity = (cpu_capacity_tokens if cpu_capacity_tokens
                             is not None else 4 * self.gpu_capacity)

        self.running: List[Request] = []
        self.paused: List[Request] = []
        self.swap_queue: List[Request] = []
        self.waiting: List[Request] = []
        self.swap_out_order: List[Request] = []   # waste-priority order
        self.live: Dict[int, Request] = {}
        self.registry = registry if registry is not None else MetricsRegistry()
        self.stats = SchedulerStats(self.registry)
        if self.estimator.registry is None:
            # profile-miss / learned-mode telemetry lands in the shared dump
            self.estimator.registry = self.registry
        self._recompute_debt: Dict[int, int] = {}
        # rid -> device tokens that are PURE cache credit (no real compute
        # invested since the last match); only these may be reclaimed when
        # admission is head-of-line blocked
        self._cache_credit: Dict[int, int] = {}
        # Engine hook: called as on_discard(req, n_device_tokens_dropped)
        # right before a request's device-resident context is released.
        self.on_discard = None
        # Prefix-cache hook: cache_probe(req) -> tokens of the request's
        # current context that would survive a discard (cached prefix).
        # Feeds the cache-aware Eq. 5: recompute waste counts only the
        # uncached suffix, shifting decisions toward discard when the
        # prefix is shared. None = no cache.
        self.cache_probe = None

    # ------------------------------------------------------------------
    # memory accounting
    # ------------------------------------------------------------------
    def gpu_used(self) -> int:
        return sum(r.device_tokens for r in self.live.values())

    def gpu_free(self) -> int:
        return self.gpu_capacity - self.gpu_used()

    def cpu_used(self) -> int:
        return sum(r.host_tokens for r in self.live.values())

    def cpu_free(self) -> int:
        return self.cpu_capacity - self.cpu_used()

    # ------------------------------------------------------------------
    # request lifecycle notifications
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.phase = Phase.WAITING
        req.arrival_key = req.arrival
        self.live[req.rid] = req
        self._insert_waiting(req)

    def _insert_waiting(self, req: Request):
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival_key, r.rid))

    def notify_intercepted(self, req: Request, intc: Interception, now: float):
        """Called when a decoded token triggers an augmentation call."""
        req.segment_done(now)
        if req.phase == Phase.FINISHED:
            return
        req.phase = Phase.PAUSED
        req.t_call = now
        req.current_int = intc
        self.running.remove(req)
        self.paused.append(req)

        pol = self.policy
        if pol.decision == "discard":
            self._discard(req, now)
        elif pol.decision == "preserve":
            req.decision = "preserve"
            self.stats.preserves += 1
        elif pol.decision == "swap_first":
            self._enqueue_swap_out(req, now)
        elif pol.decision == "heuristic":
            if intc.kind in SHORT_RUNNING_KINDS:
                req.decision = "preserve"
                self.stats.preserves += 1
            else:
                self._enqueue_swap_out(req, now)
        elif pol.decision == "min_waste":
            # decided (and re-decided) at each iteration boundary in
            # _min_waste_pass(); until then the context stays put.
            req.decision = "pending"
        else:
            raise ValueError(pol.decision)

    def _discard(self, req: Request, now: float):
        # The WHOLE context becomes recompute debt — including any prefix a
        # prior partial swap-out already moved to host. Retaining the host
        # payload would double-hold CPU bytes and send the request through
        # swap_queue on resume to restore a prefix whose suffix is debt
        # (restore-vs-recompute mis-ordering); drop it exactly as
        # notify_swap_in_failed does, zeroed BEFORE the on_discard hook so
        # the engine keeps no host-prefix page entries.
        dropped = req.device_tokens + req.host_tokens
        req.host_tokens = 0
        if dropped:
            if self.on_discard is not None:
                self.on_discard(req, dropped)
            self._recompute_debt[req.rid] = (
                self._recompute_debt.get(req.rid, 0) + dropped)
            req.device_tokens = 0
        self._cache_credit.pop(req.rid, None)
        if req in self.swap_out_order:
            self.swap_out_order.remove(req)
        req.pending_swap_out = 0
        req.decision = "discard"
        self.stats.discards += 1

    def _enqueue_swap_out(self, req: Request, now: float):
        amount = min(req.device_tokens, self.cpu_free())
        if amount <= 0:
            self._discard(req, now)
            return
        req.pending_swap_out = amount
        req.decision = "swap"
        if req not in self.swap_out_order:
            self.swap_out_order.append(req)
        self.stats.swaps += 1

    def _preempt_to_waiting(self, req: Request, now: float):
        """Shared graceful-preempt body: the whole context — the host
        payload and any device pages — becomes recompute debt and the
        request requeues FCFS; admission control then waits for real
        memory before recomputing it."""
        dropped = req.device_tokens + req.host_tokens
        # the host payload is dropped, not retained: zero it BEFORE the
        # engine's on_discard hook so no host-prefix pages survive
        req.host_tokens = 0
        if self.on_discard is not None:
            self.on_discard(req, dropped)
        req.device_tokens = 0
        if dropped:
            self._recompute_debt[req.rid] = (
                self._recompute_debt.get(req.rid, 0) + dropped)
        self._cache_credit.pop(req.rid, None)
        if req in self.swap_out_order:
            self.swap_out_order.remove(req)
        req.pending_swap_out = 0
        req.decision = "discard"
        self.stats.discards += 1
        req.phase = Phase.WAITING
        self._insert_waiting(req)

    def notify_swap_in_failed(self, req: Request, now: float):
        """The engine could not allocate device pages for a planned
        swap-in: the physical pool is exhausted in a way the token-capacity
        accounting cannot see (COW copies, cache-held pages,
        fragmentation). Gracefully re-preempt instead of aborting the
        engine mid-commit."""
        self.swap_queue.remove(req)
        self._preempt_to_waiting(req, now)
        self.stats.swap_in_failures += 1

    def notify_pool_exhausted(self, req: Request, now: float):
        """The engine could not back this request's planned chunk/decode
        writes with physical pages (COW copies under a saturated pool, a
        cache holding every free page, fragmentation). Same graceful
        re-preempt as a failed swap-in, but reachable from RUNNING and
        WAITING too — the request drops out of this iteration's plan,
        its context becomes recompute debt, and it requeues FCFS."""
        for q in (self.running, self.waiting, self.swap_queue):
            if req in q:
                q.remove(req)
        self._preempt_to_waiting(req, now)
        self.stats.pool_preempts += 1

    def notify_cancelled(self, req: Request, now: float, *,
                         cause: str = "cancelled"):
        """Tear a request out of EVERY scheduler structure, from any
        phase — queued, running, paused, swapped, mid-swap — releasing
        its memory accounting entirely (DESIGN.md §15). The engine's
        on_discard hook frees/registers its device pages; the host
        payload is dropped. ``cause`` is "cancelled" (caller teardown)
        or "tool_failed" (terminal tool failure); either way the request
        leaves ``live`` and never reschedules."""
        for q in (self.running, self.paused, self.waiting, self.swap_queue,
                  self.swap_out_order):
            if req in q:
                q.remove(req)
        dropped = req.device_tokens + req.host_tokens
        req.host_tokens = 0
        if self.on_discard is not None:
            self.on_discard(req, dropped)
        req.device_tokens = 0
        req.pending_swap_out = 0
        req.current_int = None
        self.live.pop(req.rid, None)
        self._recompute_debt.pop(req.rid, None)
        self._cache_credit.pop(req.rid, None)
        if cause == "cancelled":
            req.phase = Phase.CANCELLED
            self.stats.cancellations += 1
        else:
            req.phase = Phase.FAILED
            self.stats.tool_failures += 1

    def notify_cache_hit(self, req: Request, n_tokens: int):
        """The engine/simulator restored ``n_tokens`` of context from the
        prefix cache (shared pages forked, no compute). The tokens count as
        device-resident immediately — the request is typically WAITING, so
        admission sees the reduced to_compute — and pay down recompute debt:
        they were discarded but never recomputed."""
        if n_tokens <= 0:
            return
        req.device_tokens += n_tokens
        self._cache_credit[req.rid] = req.device_tokens
        debt = self._recompute_debt.get(req.rid, 0)
        if debt:
            self._recompute_debt[req.rid] = max(0, debt - n_tokens)
        self.stats.cache_hit_tokens += n_tokens

    def notify_resumed(self, req: Request, now: float,
                       n_returned: Optional[int] = None):
        """Interception finished: returned tokens arrive, request resumes.
        ``n_returned`` is the actual delivered token count (session API);
        None uses the scripted interception's declared count."""
        if req.current_int is not None:
            # feed the learned estimator the realized pause duration — the
            # same observation point the WasteLedger's intercept_finished
            # records (engine and simulator both route resumes here)
            self.estimator.observe(req.current_int.kind,
                                   max(0.0, now - req.t_call))
        req.resume(now, n_returned)
        self.paused.remove(req)
        if req in self.swap_out_order:
            self.swap_out_order.remove(req)
        req.pending_swap_out = 0
        if not self.policy.requeue_original_arrival:
            req.arrival_key = now
        if req.host_tokens > 0:
            req.phase = Phase.SWAPQ
            self.swap_queue.append(req)
            self.swap_queue.sort(key=lambda r: (r.arrival_key, r.rid))
        elif req.to_compute > 0:
            req.phase = Phase.WAITING
            self._insert_waiting(req)
        else:
            req.phase = Phase.RUNNING
            self.running.append(req)

    def notify_spec_graft(self, req: Request, device_tokens: int):
        """A speculative fork was accepted at resume (engine/simulator
        speculation, DESIGN.md §14): the fork's pages become the request's
        device context, covering the pre-pause prefix AND the returned
        tokens. Any recompute debt from a mid-pause discard is void —
        nothing will be recomputed — and any host payload from a mid-pause
        swap-out is dropped (the fork's device copy supersedes it). Must
        be called BEFORE notify_resumed so resume routing sees the grafted
        state."""
        self._recompute_debt.pop(req.rid, None)
        self._cache_credit.pop(req.rid, None)
        if req in self.swap_out_order:
            self.swap_out_order.remove(req)
        req.pending_swap_out = 0
        req.host_tokens = 0
        req.device_tokens = device_tokens

    # ------------------------------------------------------------------
    # the per-iteration decision (§4.3)
    # ------------------------------------------------------------------
    def next_iteration(self, now: float) -> IterationPlan:
        plan = IterationPlan()
        pol = self.policy

        # 1. decode batch: every running request generates one token.
        plan.decode = list(self.running)
        decode_need = len(plan.decode)

        # 2. eviction under memory pressure (vLLM-style recompute preempt:
        #    latest-arrival running requests are discarded to the wait queue).
        while decode_need > self.gpu_free() + 0 and self.running:
            victim = max(self.running, key=lambda r: (r.arrival_key, r.rid))
            self.running.remove(victim)
            plan.decode.remove(victim)
            self._discard(victim, now)
            victim.decision = ""
            victim.phase = Phase.WAITING
            self._insert_waiting(victim)
            self.stats.evictions += 1
            decode_need = len(plan.decode)

        free = self.gpu_free() - decode_need

        # 3. admission from the waiting queue, FCFS by arrival key.
        sat = self.cost.saturation_tokens
        chunk_budget = max(0, sat - decode_need) if pol.chunked_recompute \
            else None
        for req in list(self.waiting):
            n = req.to_compute
            if n <= 0:
                # preserved-resumed request with nothing to compute
                self.waiting.remove(req)
                req.phase = Phase.RUNNING
                self.running.append(req)
                continue
            if pol.chunked_recompute:
                if chunk_budget <= 0:
                    break
                n = min(n, chunk_budget)
            if n > free and self.cache_probe is not None:
                free += self._reclaim_waiting_credit(req, n - free, now)
            if n > free:
                if pol.chunked_recompute and free > 0:
                    n = free
                else:
                    break  # FCFS head-of-line: wait for memory
            plan.chunks.append((req, n))
            free -= n
            if pol.chunked_recompute:
                chunk_budget -= n

        # 3b (prefix cache only) helper defined below: when the FCFS head
        #    can't fit, cache-credited context held by LATER waiting
        #    requests is released first — their pages stay indexed in the
        #    cache, so the release is nearly free, and matched-but-
        #    unadmitted requests can never deadlock admission.

        # 4. swap budget N_i: what the link can hide behind this iteration's
        #    forwarding (§4.1). Unbudgeted Swap moves everything and stalls.
        if pol.swap_enabled:
            if pol.swap_budgeted:
                t_iter = self.cost.t_fwd(max(1, plan.query_tokens),
                                         plan.context_tokens)
                budget = self.cost.swap_tokens_within(t_iter)
            else:
                budget = None  # unbounded, but stalls
            if pol.decision == "min_waste":
                # _min_waste_pass consumes from ``budget`` and appends its
                # swap-outs to the plan; _plan_swap_out below re-derives
                # what is already used from the plan itself, so BOTH see
                # the same total-budget semantics. The remaining swap-in
                # budget is then total minus everything swapped out —
                # counted ONCE. (Subtracting the plan total from the
                # min-waste REMAINDER double-counted the min-waste swaps
                # and silently starved every queued swap-in whenever they
                # exceeded half the budget.)
                self._min_waste_pass(plan, budget, now)
            self._plan_swap_out(plan, budget)
            budget = (None if budget is None
                      else max(0, budget
                               - sum(n for _, n in plan.swap_out)))
            self._plan_swap_in(plan, budget, free)

        return plan

    def _reclaim_waiting_credit(self, head: Request, needed: int,
                                now: float) -> int:
        """Release device context held by waiting requests BEHIND the FCFS
        head (latest arrival first) until ``needed`` tokens are freed. Only
        runs with the prefix cache on: on_discard registers the released
        pages in the cache first, so the victims typically re-match their
        context the moment memory allows — this trades a cheap tree lookup
        for admission progress and bounds cache credits by what admission
        can actually use."""
        reclaimed = 0
        try:
            idx = self.waiting.index(head)
        except ValueError:
            return 0
        for victim in reversed(self.waiting[idx + 1:]):
            if reclaimed >= needed:
                break
            # only PURE cache credit is reclaimable: context with real
            # chunk-prefill invested is never thrown away for the head —
            # that would make the cache a regression under pressure
            if (victim.device_tokens <= 0 or victim.host_tokens
                    or victim.device_tokens
                    != self._cache_credit.get(victim.rid, -1)):
                continue
            reclaimed += victim.device_tokens
            if self.on_discard is not None:
                self.on_discard(victim, victim.device_tokens)
            self._recompute_debt[victim.rid] = (
                self._recompute_debt.get(victim.rid, 0)
                + victim.device_tokens)
            victim.device_tokens = 0
            self._cache_credit.pop(victim.rid, None)
        return reclaimed

    def _plan_swap_out(self, plan: IterationPlan, budget: Optional[int]):
        used = sum(n for _, n in plan.swap_out)
        cpu_free = self.cpu_free()
        for req in list(self.swap_out_order):
            if budget is not None and used >= budget:
                break
            if any(r is req for r, _ in plan.swap_out):
                continue
            n = min(req.pending_swap_out, cpu_free)
            if budget is not None:
                n = min(n, budget - used)
            if n <= 0:
                continue
            plan.swap_out.append((req, n))
            used += n
            cpu_free -= n
            if budget is None:
                plan.stall_s += self.cost.t_swap(n)

    def _plan_swap_in(self, plan: IterationPlan, budget: Optional[int],
                      free: int):
        """Restore swapped-out contexts, FCFS by original arrival (no
        skipping ahead). Two distinct exhaustion exits: the per-iteration
        link budget running out (budget_exhausted — more swap-in resumes
        next iteration's budget) vs the device token pool running out
        (pool_exhausted — memory, not bandwidth, is the binding
        constraint). Conflating them behind one ``n <= 0`` break hid
        budget starvation as pool pressure; the split is observable via
        the returned reason (tests) and keeps each branch independently
        coverable."""
        used = 0
        for req in list(self.swap_queue):
            if budget is not None and budget - used <= 0:
                return "budget_exhausted"
            if free <= 0:
                return "pool_exhausted"
            n = req.host_tokens
            if budget is not None:
                n = min(n, budget - used)
            n = min(n, free)
            assert n > 0, "swap_queue members always carry host tokens"
            plan.swap_in.append((req, n))
            used += n
            free -= n
            if budget is None:
                plan.stall_s += self.cost.t_swap(n)
        return "drained"

    def _min_waste_pass(self, plan: IterationPlan, budget: int,
                        now: float) -> int:
        """§4.3: sort intercepted requests by potential waste (Eq. 5
        min-waste); give this iteration's swap-out budget to the top of the
        order; the remainder preserve or discard by the Eq. 5 argmin. Runs
        every iteration so the dynamic duration estimate (§4.4) can flip
        earlier preserve decisions. Returns the remaining budget."""
        candidates = [r for r in self.paused if r.device_tokens > 0]
        if not candidates:
            return budget
        c_other = self.gpu_used()
        scored = []
        for r in candidates:
            t_int = self.estimator.estimate(r, now)
            c = r.device_tokens
            cached = 0
            if self.cache_probe is not None:
                cached = max(0, min(int(self.cache_probe(r)), c))
            c_r, t_fwd_c, n_chunks, t_fwd_chunk = \
                self.cost.recompute_terms(c, cached)
            decision, w = min_waste_decision(
                t_int_est=t_int, c_tokens=c, m_bytes=self.cost.m_bytes,
                t_fwd_c=t_fwd_c, n_chunks=n_chunks,
                t_fwd_chunk=t_fwd_chunk,
                c_other_tokens=max(0, c_other - c), recompute_tokens=c_r)
            scored.append((w, decision, r))
        scored.sort(key=lambda t: (-t[0], t[2].rid))

        remaining = budget
        cpu_free = self.cpu_free()
        for w, decision, r in scored:
            n = min(r.device_tokens, remaining, cpu_free)
            if n > 0:
                plan.swap_out.append((r, n))
                remaining -= n
                cpu_free -= n
                if r.decision != "swap":
                    r.decision = "swap"
                    self.stats.swaps += 1
                # leftover context of a partially-swapped request stays for
                # the next iteration's re-evaluation (pipelined swap, §4.1)
            elif decision == "discard":
                self._discard(r, now)
            else:
                if r.decision != "preserve":
                    r.decision = "preserve"
                    self.stats.preserves += 1
        return remaining

    # ------------------------------------------------------------------
    # bookkeeping after the engine/simulator executes a plan
    # ------------------------------------------------------------------
    def apply_plan(self, plan: IterationPlan, end_time: float):
        """Account token movement; returns events:
        {"intercepted": [(req, interception)], "finished": [req]}."""
        for req, n in plan.swap_out:
            req.device_tokens -= n
            req.host_tokens += n
            req.pending_swap_out = max(0, req.pending_swap_out - n)
            self.stats.swapped_out_tokens += n
            if req.pending_swap_out <= 0 and req in self.swap_out_order:
                self.swap_out_order.remove(req)

        for req, n in plan.swap_in:
            req.host_tokens -= n
            req.device_tokens += n
            self.stats.swapped_in_tokens += n
            if req.host_tokens == 0:
                self.swap_queue.remove(req)
                if req.to_compute > 0:
                    req.phase = Phase.WAITING
                    self._insert_waiting(req)
                else:
                    req.phase = Phase.RUNNING
                    self.running.append(req)

        for req, n in plan.chunks:
            req.device_tokens += n
            self._cache_credit.pop(req.rid, None)  # real compute invested
            debt = self._recompute_debt.get(req.rid, 0)
            rec = min(n, debt)
            if rec:
                self._recompute_debt[req.rid] = debt - rec
            self.stats.recompute_tokens += rec
            self.stats.fresh_tokens += n - rec
            if req.context_ready:
                self.waiting.remove(req)
                req.phase = Phase.RUNNING
                self.running.append(req)

        events = {"intercepted": [], "finished": []}
        for req in plan.decode:
            self.stats.decode_tokens += 1
            intc = req.advance_decode(end_time)
            seg = req.current_segment()
            # open (session) segments never fire here: the engine consults
            # the request's controller at the token boundary instead and
            # routes through notify_intercepted / notify_finished
            if not seg.open and req.gen_in_seg >= seg.gen_tokens:
                if intc is not None:
                    events["intercepted"].append((req, intc))
                else:
                    self.notify_finished(req, end_time)
                    events["finished"].append(req)
        return events

    def notify_finished(self, req: Request, now: float):
        """Finish bookkeeping, shared by apply_plan's scripted path and
        the engine's session boundaries (the caller's controller ended the
        request). The request's current segment must be closed with no
        interception (scripted, or via Request.close_segment(None))."""
        req.segment_done(now)
        assert req.phase == Phase.FINISHED
        self.running.remove(req)
        del self.live[req.rid]
        self._recompute_debt.pop(req.rid, None)
        self._cache_credit.pop(req.rid, None)

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.running or self.waiting or self.swap_queue
                    or self.paused)

    def paused_device_tokens(self) -> int:
        return sum(r.device_tokens for r in self.paused)
