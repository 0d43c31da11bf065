"""The continuous-batching serving engine on PyTorch: the port of
``repro.serving.engine``.

Executes the InferCept scheduler's per-iteration plans on the model with
paged KV storage:

  * KV lives in global paged pools (one pytree mirroring the model's cache
    structure, page-indexed, updated in place); a BlockManager allocates
    pages; per-request block tables map logical positions to pages.
  * fused         — each scheduler iteration's chunks AND decodes are
                    flattened into ONE ragged token batch and executed by a
                    single LM.forward_mixed_paged call — one kv_append per
                    layer covering every new token, one ragged
                    paged-attention pass, sampling ON DEVICE so only B
                    int32 ids cross to the host (DESIGN.md §10).
                    fused=False keeps the per-call paths as the
                    differential oracle: one LM.extend_step_paged call per
                    prefill chunk and one bucketed LM.decode_step_paged
                    call for the decodes (the paged_attention kernel),
                    their logits fetched and sampled on the host at commit.
  * gather        — paged=False (the differential oracle; implies
                    fused=False): each call gathers the requests' block
                    tables into a slotted (periods, B, max_pages * page,
                    ...) cache, runs LM.extend_step / LM.decode_step on it
                    and scatters only the new tokens' K/V back into the
                    pools, so it moves O(context) bytes per call where the
                    paged paths move O(new tokens).
  * swap_out/in   — page-granular device<->host movement staged through ONE
                    contiguous slab per request (the §4.1 coalesced
                    transfer): one swap_pack launch gathers every pool
                    leaf on the compute stream, the slab crosses to one
                    pinned host buffer on a copy stream, and one
                    swap_unpack launch scatters it back; with overlap=True
                    (default) the host copy is reconciled at commit, so it
                    hides under the model call (DESIGN.md §12)
  * discard/evict — pages freed via the scheduler's on_discard hook
  * prefix cache  — optional (prefix_cache=True): a token-block radix tree
                    indexes computed pages; admitted/resumed requests fork
                    matching prefix pages instead of recomputing them,
                    shared pages are copy-on-write, and LRU eviction
                    reclaims cache-only pages under page pressure
                    (DESIGN.md §8).
  * speculation   — optional (speculate=True with a predictor): at an
                    interception the request's pages are COW-forked and
                    the fork prefills the predictor's guess at the tool
                    return and decodes ahead; an exact match at resume
                    grafts the fork, any mismatch frees it (DESIGN.md §14).

Two lifecycles drive the same iteration machinery (DESIGN.md §11): the
closed loop (scripted requests, ``run``) and caller-driven sessions
(``serving.session``: controllers consulted at every sampled-token
boundary, events drained by ``poll``, out-of-band ``resume_request``).

Each ``step()`` is a three-phase pipeline (DESIGN.md §12): **plan** (host
bookkeeping only), **dispatch** (swap-out gathers, swap-in scatters and
the model call, all issued with no host sync between them), **commit**
(fetch the sampled ids, collect the staged swap slabs, reconcile, advance
the virtual clock, consult session boundaries). ``overlap=False`` keeps
the serial execute-then-sync order as the differential oracle.

Time is virtual (the same cost model as the simulator, on the chip spec
given as ``chip``); tensor math is real. On a CUDA device the paged path
launches the port's hand-written kernels (``repro_torch.kernels``); on
the CPU it runs their plain PyTorch versions, which follow the JAX
reference's CPU math op for op. Sampling is greedy argmax by default, or
per-request SamplingParams (temperature, top-k, top-p, seed) through
``models.model.sample_tokens`` on the engine's device, its noise keyed by
(seed, position) alone, so the §6 identity holds for sampled streams too.

Quantized pools (``kv_dtype="int8" | "float8_e4m3" | "float8_e5m2"``,
DESIGN.md §17) keep one float32 scale per (page, kv head) in the same
pool tree, so COW copies and swap slabs carry scales with the payload;
a page's scales are zeroed when its refcount reaches 0.

``sanitize=True`` attaches the invariant checks of DESIGN.md §16: the
KV-page ownership sanitizer (audited at every plan phase, every planned
write checked at dispatch) and the request lifecycle checker, and makes
the counter view refuse undeclared keys. They only observe: streams and
counters are those of ``sanitize=False``.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache import PrefixCache
from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import CostModel
from repro_torch.core.estimator import DurationEstimator
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.request import Interception, Phase, Request
from repro_torch.core.scheduler import Scheduler
from repro_torch.kernels.kv_quant import KV_QUANT_DTYPES
from repro_torch.kernels.swap_pack import SwapStager, slab_pages
from repro_torch.memory.block_manager import BlockManager
from repro_torch.models.bridge import cast_params
from repro_torch.models.model import LM, sample_tokens
from repro_torch.obs.ledger import WasteLedger
from repro_torch.obs.metrics import ENGINE_COUNTER_SCHEMA, MetricsRegistry
from repro_torch.obs.trace import NullTracer, SpanTracer
from repro_torch.serving.api_executor import (AsyncToolRuntime,
                                              ScriptedToolRuntime, ToolError,
                                              ToolResultPredictor,
                                              prompt_token_ids)
from repro_torch.serving.session import (CancelledEvent, FailedEvent,
                                         FinishEvent, InterceptEvent,
                                         RejectedEvent, TokenEvent)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.hw import H100, ChipSpec
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class ReqKV:
    tokens: List[int]                       # all known token ids
    pages: List[object]                     # ("dev", pid) | ("host", tree)
    computed: int = 0                       # KV tokens materialized (prefix)


@dataclasses.dataclass
class SpecFork:
    """A speculative continuation past an intercept (DESIGN.md §14): a
    refcounted COW fork of the paused request's pages taken at the
    intercept boundary, seeded with the predictor's guess at the tool's
    returned ids and decoded ahead while the real tool runs. Validated at
    resume: exact match grafts ``st`` onto the request (re-prefill
    skipped); any mismatch frees the pages and the baseline resume path
    runs untouched."""
    req: Request
    st: ReqKV                  # fork-private tokens / pages / computed
    kind: str                  # interception kind (telemetry key)
    base: int                  # parent context size at the fork (tokens)
    predicted: List[int]       # predicted returned ids (validation key)
    max_emit: int              # sampled-token budget past the prefill
    emitted: int = 0           # sampled tokens produced so far
    byte_seconds: float = 0.0  # extra occupancy, charged on reject/kill
    dead: bool = False         # killed by page pressure; rejects at resume


@dataclasses.dataclass
class FaultState:
    """Per-pause fault policy and progress (DESIGN.md §15), created at the
    intercept boundary from the directive/SamplingParams chain and popped
    at the pause's resolution (resume, terminal failure, teardown).

    ``deadline`` is the current attempt's virtual-time timeout (None =
    wait forever); ``attempt`` counts launches, so retry N carries
    attempt=N and stale completions from attempt N-1 are dropped by the
    injection guards."""
    kind: str
    caller_owned: bool
    timeout_s: Optional[float] = None
    max_retries: int = 0
    backoff_s: float = 0.05
    attempt: int = 0
    deadline: Optional[float] = None


@dataclasses.dataclass
class StepInflight:
    """Work issued by the dispatch phase, reconciled at commit (DESIGN.md
    §12): swap-out slabs whose host copy is draining behind the model
    call, and the fused dispatch's on-device sampled ids not yet
    fetched."""
    swap_out: List[Tuple[Request, int]] = \
        dataclasses.field(default_factory=list)   # (req, stager ticket)
    mixed: Optional[tuple] = None                 # (entries, sampled_dev)


class EngineStepsExhausted(RuntimeError):
    """Engine.run hit max_steps with work still pending."""


class RunResult(list):
    """The finished requests, plus ``drained``: False when run() stopped
    on step exhaustion (max_steps) with work still pending — the results
    are partial and the caller must not treat them as a completed
    workload."""

    def __init__(self, finished: Sequence[Request], drained: bool = True):
        super().__init__(finished)
        self.drained = drained


class EventBatch(list):
    """Events drained by poll(), plus ``drained``: False when the
    underlying run stopped on step exhaustion — the stream is truncated
    and the caller should poll again (step exhaustion is never silent,
    the same contract as RunResult)."""

    def __init__(self, events: Sequence[object], drained: bool = True):
        super().__init__(events)
        self.drained = drained


class Engine:
    def __init__(self, cfg: ModelConfig, policy: PolicyConfig, *,
                 page_size: int = 16, n_pages: int = 256,
                 max_model_len: int = 512, seed: int = 0,
                 estimator: Optional[DurationEstimator] = None,
                 prefix_cache: bool = False,
                 cache_pages: Optional[int] = None,
                 paged: bool = True,
                 fused: bool = True,
                 overlap: bool = True,
                 speculate: bool = False,
                 predictor: Optional[ToolResultPredictor] = None,
                 spec_tokens: int = 32,
                 max_queued: Optional[int] = None,
                 tracer: Optional[SpanTracer] = None,
                 sanitize: bool = False,
                 kv_dtype: Optional[str] = None,
                 params: Optional[dict] = None,
                 chip: ChipSpec = H100,
                 device=None,
                 dtype: torch.dtype = torch.float32):
        for blk in cfg.blocks:
            assert blk.kind in ("attn", "shared_attn"), \
                "paged engine serves attention-cache architectures"
        # quantized KV pools (DESIGN.md §17): low-bit payload + per-page
        # fp32 scales owned by the same BlockManager pages. Only the
        # paged path can host them — the gather/scatter oracle
        # round-trips pools through a slotted (periods, B, S, ...) view
        # that has no slot axis for a scale leaf.
        if kv_dtype is not None:
            if kv_dtype not in KV_QUANT_DTYPES:
                raise ValueError(
                    f"unsupported kv_dtype {kv_dtype!r}; "
                    f"choose from {sorted(KV_QUANT_DTYPES)}")
            if not paged:
                raise ValueError("kv_dtype requires the paged engine "
                                 "(paged=True)")
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = LM(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, dtype=dtype, device=self.device)
        self.params = cast_params(params, cfg, dtype, device=self.device)
        self.page = page_size
        # fixed per-request page-table width
        self.max_pages = -(-max_model_len // page_size)
        self.pools = self.model.init_cache(n_pages, page_size, dtype=dtype,
                                           device=self.device,
                                           kv_dtype=kv_dtype)
        self.blocks = BlockManager(n_pages, page_size)
        self.scratch_page = self.blocks.allocate(1)[0]  # block-table padding
        # scale lifetime == page lifetime: zero a page's scales the moment
        # its refcount drops to 0, so a recycled page never inherits its
        # prior occupant's (coarser) scale and the sanitizer can audit
        # "freed => zero scales". Installed INNERMOST: the sanitizer's own
        # free wrap (below) filters double frees before they reach it, and
        # the prefix cache captures the fully wrapped chain as its release
        # callback.
        if kv_dtype is not None:
            self._wrap_free_for_quant()
        # invariant enforcement (DESIGN.md §16): attached only under
        # sanitize=True, so the default path allocates nothing for it.
        # Created BEFORE the prefix cache below, which captures
        # ``blocks.free`` as its release callback: the sanitizer must
        # already have wrapped it to tag cache frees.
        self.sanitize = bool(sanitize)
        self.sanitizer = None
        self._lifecycle_checker = None
        if self.sanitize:
            from repro_torch.analysis.lifecycle import LifecycleChecker
            from repro_torch.analysis.ownership import KVSanitizer
            self.sanitizer = KVSanitizer(self)
            self._lifecycle_checker = LifecycleChecker()
        self.cost = CostModel(cfg=cfg, chip=chip, n_chips=1,
                              kv_dtype=kv_dtype)
        cap = max(page_size, (n_pages - 8) * page_size)
        # telemetry (DESIGN.md §13): one registry spans engine + scheduler
        # + ledger; the tracer defaults to the allocation-free NullTracer
        # and every emission site below is guarded on tracer.enabled so
        # tracing cannot perturb the virtual clock or the streams
        self.metrics = MetricsRegistry()
        self.tracer: SpanTracer = tracer if tracer is not None \
            else NullTracer()
        self.ledger = WasteLedger(self.cost, cap, registry=self.metrics)
        self.sched = Scheduler(policy, self.cost, estimator=estimator,
                               gpu_capacity_tokens=cap,
                               registry=self.metrics)
        self.sched.on_discard = self._on_discard
        self.cache: Optional[PrefixCache] = None
        self._match_seen: Dict[int, int] = {}   # rid -> gen of a known miss
        if prefix_cache:
            self.cache = PrefixCache(
                page_size, max_pages=cache_pages,
                adopt=self.blocks.fork, release=self.blocks.free,
                can_evict=lambda pid: self.blocks.ref_count(pid) == 1)
            self.sched.cache_probe = self._cache_probe
        self.api = ScriptedToolRuntime(cfg.vocab_size)
        self.kv: Dict[int, ReqKV] = {}
        self.now = 0.0
        self.finished: List[Request] = []
        # session lifecycle (DESIGN.md §11): out-of-band resumes posted by
        # the caller (Engine.resume_request), ordered by virtual due time;
        # events emitted at token/intercept/finish boundaries, drained by
        # poll() when emit_events is on (InferCeptClient sets it)
        self._resume_queue: List[Tuple[float, int, int, List[int]]] = []
        self._resume_pending: set = set()
        self._resume_seq = itertools.count()
        self.emit_events = False
        # buffer_events=False keeps the sink-only fast path: events still
        # route inline to event_sink, but nothing is retained for poll()
        # (batch replays that never read the drained batch)
        self.buffer_events = True
        self.events: List[object] = []
        # called synchronously at emission so the client can round-trip a
        # ToolExecutor the moment an intercept fires (virtual-time-prompt
        # resume) instead of after the engine drains
        self.event_sink = None
        self._prefill_emits: List[Tuple[Request, int]] = []
        self._decode_ids: List[int] = []
        # unfused oracle paths: logits fetches + host-side sampling issued
        # at dispatch are parked here and resolved at the commit phase's
        # single sync point (entries: ("chunk", req, st, logits) /
        # ("decode", reqs, logits, pos))
        self._pending_oracle: List[tuple] = []
        # kept sorted by DESCENDING arrival: the next request to admit is
        # at the tail, so intake is one bisect + shift and admission is an
        # O(1) pop(); _pending_rids mirrors the queue for O(1) rid-collision
        # checks
        self._pending_arrivals: List[Request] = []
        self._pending_rids: set = set()
        # graceful admission (DESIGN.md §15): bounded intake. None keeps
        # the unbounded queue; with a bound, add_request rejects (returns
        # False + RejectedEvent) instead of growing without limit.
        self.max_queued = max_queued
        # fault tolerance (DESIGN.md §15). All four queues are drained at
        # the plan phase — the step's safe point — so cancels/faults posted
        # from an event_sink callback mid-commit can never race the
        # in-flight dispatch:
        #   _fault_state  — rid -> FaultState for every in-flight pause
        #   _fault_queue  — (due, seq, rid, ToolError): failures awaiting
        #                   the retry/terminal decision at their virtual
        #                   arrival time
        #   _retry_queue  — (t0, seq, rid): backed-off re-launches
        #   _cancel_queue — (rid, reason) teardown orders
        self._fault_state: Dict[int, FaultState] = {}
        self._fault_queue: List[Tuple[float, int, int, ToolError]] = []
        self._retry_queue: List[Tuple[float, int, int]] = []
        self._cancel_queue: List[Tuple[int, str]] = []
        self._fault_seq = itertools.count()
        # rid -> device byte-seconds accrued while resident; popped at
        # finish, charged to the ledger in one lump at cancel/failure
        self._accrued_bs: Dict[int, float] = {}
        # chaos hook: called at every plan phase (the safe point) with the
        # engine; the chaos harness uses it to inject cancellations
        # deterministically mid-run
        self.on_plan = None
        # pipelined step (DESIGN.md §12): dispatch-phase swap-outs staged
        # through the SwapStager and collected at commit; overlap=False is
        # the serial execute-then-sync oracle
        self.paged = paged
        self.fused = bool(fused and paged)   # the fused path runs on pools
        self.overlap = overlap
        self.stager = SwapStager()
        # speculative resume past intercepts (DESIGN.md §14): at an
        # interception, COW-fork the sequence pages and keep decoding
        # against the predictor's guess at the tool return; validate at
        # resume. speculate=False (the default) never forks — streams,
        # counters and the ledger are identical to the baseline. Requires
        # the paged path (forks ARE page refcounts) and a predictor.
        self.speculate = bool(speculate and paged and predictor is not None)
        self.predictor = predictor
        self.spec_tokens = int(spec_tokens)
        self._spec_forks: Dict[int, SpecFork] = {}
        # rid -> per-intercept speculation outcomes, surfaced by the
        # session API (SessionHandle.speculation)
        self.spec_log: Dict[int, List[dict]] = {}
        # off-thread caller-side tool execution; completions are injected
        # at the plan phase through resume_request (attach one directly or
        # via InferCeptClient(tool_workers=...))
        self.async_tools: Optional[AsyncToolRuntime] = None
        # tool-overlap integral (DESIGN.md §12): per in-flight
        # interception, [t_call, due, accum] — each executed iteration
        # adds its exact intersection with the pause window to accum, so
        # overlapped_tool_seconds counts ONLY busy time inside
        # [t_call, due] (due is +inf for caller-owned resumes until
        # resume_request fixes it)
        self._tool_windows: Dict[int, List[float]] = {}
        # counters (DESIGN.md §9/§10/§12), the same keys and arithmetic
        # as the reference engine so the two can be compared: KV bytes
        # copied between buffers per phase, dispatch density, the bytes
        # that crossed the sampling boundary, and overlap accounting.
        # Stored as a CounterView over the registry ("engine_" prefix);
        # under sanitize=True the view fails fast on any undeclared write.
        self.counters = self.metrics.view(
            "engine_", schema=ENGINE_COUNTER_SCHEMA if self.sanitize
            else None)
        self.counters.update(ENGINE_COUNTER_SCHEMA)
        # rid -> (t_start, phase) while a request sits in a wait state
        # (queued after admission / swapped_wait after a swap-out resume);
        # closed into a span + wait histogram at its next compute
        self._wait_marks: Dict[int, Tuple[float, str]] = {}
        # bytes one token position occupies across every layer's pool —
        # the pools' total physical bytes amortized per page slot
        page_slots = n_pages * page_size
        self.kv_token_bytes = -(-sum(
            t.numel() * t.element_size() for t in tree_leaves(self.pools))
            // page_slots)
        # the same for MLA blocks alone, whose latent pools the reference
        # gathers O(context) per row on every paged path: the counters
        # price that gather as the reference's do (0 for other models)
        self.kv_mla_token_bytes = sum(
            -(-sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.pools[gi][f"b{j}"]))
              // page_slots)
            for gi, g in enumerate(cfg.groups)
            for j, blk in enumerate(g.period)
            if blk.attn is not None and blk.attn.kind == "mla")

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> bool:
        """Submit a request. Returns False (emitting a RejectedEvent,
        state untouched) when ``max_queued`` is set and the intake —
        pending arrivals plus the scheduler's waiting queue — is already
        at the bound: bounded backpressure instead of unbounded queue
        growth (DESIGN.md §15). max_queued=None keeps the legacy
        always-accept behavior."""
        if self.max_queued is not None and \
                (len(self._pending_arrivals) + len(self.sched.waiting)
                 >= self.max_queued):
            self.counters["sessions_rejected"] += 1
            self._emit(RejectedEvent(rid=req.rid, reason="queue_full",
                                     time=self.now))
            return False
        # O(log n) search + O(n) shift instead of re-sorting the whole
        # queue on every insert; the list is descending by arrival, so
        # insort_left on the negated key keeps FIFO order among equal
        # arrival times once _admit pops from the tail
        bisect.insort_left(self._pending_arrivals, req,
                           key=lambda r: -r.arrival)
        self._pending_rids.add(req.rid)
        return True

    def _admit(self):
        while self._pending_arrivals and \
                self._pending_arrivals[-1].arrival <= self.now:
            req = self._pending_arrivals.pop()
            self._pending_rids.discard(req.rid)
            if req.prompt_tokens is not None:
                toks = [int(t) % self.cfg.vocab_size
                        for t in req.prompt_tokens]
            else:
                toks = list(map(int, prompt_token_ids(
                    req.rid, req.prompt_len, self.cfg.vocab_size)))
            self.kv[req.rid] = ReqKV(tokens=toks, pages=[])
            if self._lifecycle_checker is not None:
                req.__dict__["_lifecycle"] = self._lifecycle_checker
            self.sched.submit(req)
            self._wait_marks[req.rid] = (req.arrival, "queued")

    # ------------------------------------------------------------------
    # session lifecycle: out-of-band resume, events, sampling
    # ------------------------------------------------------------------
    def resume_request(self, rid: int, token_ids: Sequence[int], *,
                       delay: float = 0.0):
        """The caller's side of the intercept/resume boundary (DESIGN.md
        §11): complete an interception by appending ``token_ids`` to the
        paused request's context at virtual time now + delay. The scripted
        virtual-time stub never touches these requests — the resume is
        wholly caller-owned. At least one token is required: the intercept
        consumed its trigger, so a zero-token resume would leave the
        request with no feed token to decode from (an empty tool result
        should re-prompt the model with an error/sentinel token
        instead)."""
        if not len(token_ids):
            raise ValueError("resume_request needs at least one returned "
                             "token id")
        req = self.sched.live.get(rid)
        if req is None or req.phase != Phase.PAUSED:
            raise ValueError(f"request {rid} is not paused "
                             f"(phase={None if req is None else req.phase})")
        if rid in self.api.inflight:
            raise ValueError(f"request {rid} is owned by the scripted "
                             "tool runtime; it resumes itself")
        if rid in self._resume_pending:
            raise ValueError(f"request {rid} already has a resume queued")
        self._resume_pending.add(rid)
        due = self.now + max(0.0, delay)
        win = self._tool_windows.get(rid)
        if win is not None and win[1] == float("inf"):
            win[1] = due               # caller-owned pause: due now known
        heapq.heappush(self._resume_queue,
                       (due, next(self._resume_seq), rid,
                        [int(t) for t in token_ids]))

    def _due_resumes(self):
        """All completions due by now — scripted stub launches plus
        caller-posted resumes — as [(req, token_ids, completion_time)]."""
        out = list(self.api.completions(self.now))
        while self._resume_queue and self._resume_queue[0][0] <= self.now:
            due, _, rid, toks = heapq.heappop(self._resume_queue)
            self._resume_pending.discard(rid)
            req = self.sched.live.get(rid)
            if req is None or req.phase != Phase.PAUSED:
                continue   # torn down (cancel/failure) while queued
            out.append((req, toks, due))
        return out

    def _inject_async_tools(self):
        """Inject off-thread ToolExecutor completions (AsyncToolRuntime)
        through the resume queue, anchored at the intercept's virtual time
        plus the tool's reported duration — the same anchor the inline
        dispatch uses (the anchor is clamped to ``now`` when the engine
        already advanced past it: virtual time never runs backwards).

        Failures never take down the engine (DESIGN.md §15): typed
        ToolError outcomes AND raised exceptions both become per-session
        fault postings (retry/terminal decision at _process_faults) —
        co-resident sessions are untouched. Stale completions — a session
        torn down or retried past the attempt that produced them — are
        dropped."""
        if self.async_tools is None:
            return
        done, failed = self.async_tools.drain()
        for call, res in done:
            req = self.sched.live.get(call.rid)
            fs = self._fault_state.get(call.rid)
            stale = (req is None or req.phase != Phase.PAUSED
                     or call.rid in self._resume_pending
                     or (fs is not None and fs.attempt != call.attempt))
            if stale:
                continue
            if isinstance(res, ToolError):
                self._post_fault(call.rid, res, at=call.time)
                continue
            due = call.time + max(0.0, res.duration)
            self.resume_request(call.rid, res.token_ids,
                                delay=max(0.0, due - self.now))
        for call, exc in failed:
            req = self.sched.live.get(call.rid)
            fs = self._fault_state.get(call.rid)
            if (req is None or req.phase != Phase.PAUSED
                    or call.rid in self._resume_pending
                    or (fs is not None and fs.attempt != call.attempt)):
                continue
            self._post_fault(call.rid,
                             ToolError(kind="exception", retryable=False,
                                       message=repr(exc)),
                             at=call.time)

    # ------------------------------------------------------------------
    # fault tolerance: tool faults, retries, timeouts, cancellation (§15)
    # ------------------------------------------------------------------
    def cancel_request(self, rid: int, *, reason: str = "client"):
        """Tear a session down from ANY lifecycle state — queued, running,
        paused, swapped, mid-swap, or intercepted with an in-flight tool
        (the result is discarded on drain). Queued here and applied at
        the next plan phase (the
        step's safe point), so cancelling from an event_sink callback
        mid-commit can never race the in-flight dispatch. Unknown or
        already-terminal rids are a no-op at apply time."""
        self._cancel_queue.append((rid, reason))

    def post_tool_fault(self, rid: int, err: ToolError):
        """The caller's failure half of the intercept boundary (DESIGN.md
        §15): report a typed ToolError outcome for a caller-owned
        interception. Applied at the next plan phase; the engine then
        retries with backoff (fresh pause interval, per-attempt estimator
        observation) or terminally fails the SESSION — never itself."""
        self._post_fault(rid, err, at=self.now)

    def _post_fault(self, rid: int, err: ToolError, *, at: float):
        due = max(self.now, at + max(0.0, err.duration))
        heapq.heappush(self._fault_queue,
                       (due, next(self._fault_seq), rid, err))

    def _process_cancels(self):
        while self._cancel_queue:
            rid, reason = self._cancel_queue.pop(0)
            if rid in self._pending_rids:
                # not yet admitted: nothing allocated, drop the arrival
                self._pending_arrivals = [
                    r for r in self._pending_arrivals if r.rid != rid]
                self._pending_rids.discard(rid)
                self.counters["sessions_cancelled"] += 1
                self._emit(CancelledEvent(rid=rid, reason=reason,
                                          n_tokens=0, time=self.now))
                continue
            req = self.sched.live.get(rid)
            if req is None:
                continue               # finished/failed already: no-op
            self._teardown_session(req, self.now, "cancelled")
            self.counters["sessions_cancelled"] += 1
            self._emit(CancelledEvent(rid=rid, reason=reason,
                                      n_tokens=req.output_tokens,
                                      time=self.now))

    def _process_faults(self):
        while self._fault_queue and self._fault_queue[0][0] <= self.now:
            due, _, rid, err = heapq.heappop(self._fault_queue)
            req = self.sched.live.get(rid)
            if req is None or req.phase != Phase.PAUSED \
                    or rid in self._resume_pending:
                continue               # torn down or already resuming
            self._tool_fault(req, err, due)

    def _tool_fault(self, req: Request, err: ToolError, t: float):
        """Decide a failed attempt's fate: bounded retry with exponential
        backoff, or terminal session failure. Each attempt is a separate
        observation — the estimator sees its realized pause (censored at
        the deadline for timeouts), the ledger closes its intercept
        record, and the retry re-enters as a fresh pause interval."""
        fs = self._fault_state.get(req.rid)
        kind = fs.kind if fs is not None else \
            (req.current_int.kind if req.current_int is not None else "tool")
        self.counters["tool_faults"] += 1
        realized = max(0.0, t - req.t_call)
        self.sched.estimator.observe(kind, realized, failed=True)
        if not err.retryable or fs is None or fs.attempt >= fs.max_retries:
            self._fail_session(req, err, max(self.now, t))
            return
        # close THIS attempt's accounting: tool window, ledger record,
        # tracer span — the retry re-opens fresh ones
        win = self._tool_windows.pop(req.rid, None)
        if win is not None:
            self.counters["tool_seconds"] += realized
            self.counters["overlapped_tool_seconds"] += \
                min(win[2], realized)
        rec = self.ledger.intercept_finished(
            req.rid, req.decision or "none", t)
        if self.tracer.enabled and rec is not None:
            self.tracer.async_end("tool", req.rid, rec.kind, t,
                                  {"branch": rec.branch,
                                   "outcome": "fault_retry",
                                   "attempt": fs.attempt,
                                   "error": err.kind})
        fs.attempt += 1
        fs.deadline = None             # re-armed when the retry launches
        t0 = max(self.now, t) + fs.backoff_s * (2 ** (fs.attempt - 1))
        # the backoff is pause time too: re-anchor t_call at the retry's
        # launch so the next attempt is a fresh interval for Eq. 5 / the
        # estimator, with the elapsed span folded into paused_time
        req.paused_time += t0 - req.t_call
        req.t_call = t0
        heapq.heappush(self._retry_queue,
                       (t0, next(self._fault_seq), req.rid))
        self.counters["tool_retries"] += 1

    def _launch_retries(self):
        """Fire due retries: re-open the attempt's accounting (ledger
        record, tracer span, tool window) and re-dispatch — the scripted
        stub relaunches engine-side; caller-owned interceptions emit an
        InterceptEvent(reason="retry") so the client re-invokes its
        ToolExecutor with the bumped attempt index."""
        while self._retry_queue and self._retry_queue[0][0] <= self.now:
            t0, _, rid = heapq.heappop(self._retry_queue)
            req = self.sched.live.get(rid)
            fs = self._fault_state.get(rid)
            if req is None or req.phase != Phase.PAUSED or fs is None:
                continue               # torn down while backing off
            intc = req.current_int
            assert intc is not None, "paused request without interception"
            self._note_intercept(req, intc, t0, req.device_tokens,
                                 self.sched.gpu_used())
            if fs.timeout_s is not None:
                fs.deadline = t0 + fs.timeout_s
            if fs.caller_owned:
                self._tool_windows[rid] = [t0, float("inf"), 0.0]
            else:
                self._tool_windows[rid] = [t0, t0 + intc.duration, 0.0]
                self.api.launch(req, intc, t0)
            self._emit(InterceptEvent(
                rid=rid, kind=intc.kind, reason="retry",
                trigger_token_id=None, duration_hint=intc.duration,
                caller_owned=fs.caller_owned, time=t0,
                attempt=fs.attempt))

    def _fire_timeouts(self):
        """Fire virtual-time deadlines. A resolution due on-or-before the
        deadline wins (it will be processed normally); anything later
        loses — the late result is purged so a post-deadline completion
        can never resurrect the attempt — and the timeout enters the
        fault path as a retryable ToolError("timeout")."""
        for rid, fs in list(self._fault_state.items()):
            if fs.deadline is None or fs.deadline > self.now:
                continue
            req = self.sched.live.get(rid)
            if req is None or req.phase != Phase.PAUSED:
                self._fault_state.pop(rid, None)
                continue
            ent = self.api.inflight.get(rid)
            if ent is not None and ent[0] <= fs.deadline:
                continue               # scripted completion beats it
            if any(e[2] == rid and e[0] <= fs.deadline
                   for e in self._resume_queue):
                continue               # caller resume beats it
            if any(e[2] == rid and e[0] <= fs.deadline
                   for e in self._fault_queue):
                continue               # an earlier failure beats it
            self.api.inflight.pop(rid, None)
            if rid in self._resume_pending:
                self._resume_queue = [e for e in self._resume_queue
                                      if e[2] != rid]
                heapq.heapify(self._resume_queue)
                self._resume_pending.discard(rid)
            if any(e[2] == rid for e in self._fault_queue):
                self._fault_queue = [e for e in self._fault_queue
                                     if e[2] != rid]
                heapq.heapify(self._fault_queue)
            if self.async_tools is not None:
                self.async_tools.discard(rid)
            self.counters["tool_timeouts"] += 1
            deadline, fs.deadline = fs.deadline, None
            self._tool_fault(req, ToolError(
                kind="timeout", retryable=True,
                message=f"attempt {fs.attempt} exceeded "
                        f"{fs.timeout_s}s (virtual)"), deadline)

    def _fault_policy(self, req: Request, act):
        """Resolve the pause's fault policy: directive field ->
        SamplingParams default -> legacy (wait forever, no retries)."""
        sp = req.sampling
        timeout = act.timeout_s if act.timeout_s is not None \
            else (sp.tool_timeout_s if sp is not None else None)
        retries = act.max_retries if act.max_retries is not None \
            else (sp.tool_retries if sp is not None else 0)
        backoff = act.backoff_s if act.backoff_s is not None \
            else (sp.tool_backoff_s if sp is not None else 0.05)
        return timeout, int(retries), float(backoff)

    def _fail_session(self, req: Request, err: ToolError, t: float):
        fs = self._fault_state.get(req.rid)
        kind = fs.kind if fs is not None else \
            (req.current_int.kind if req.current_int is not None else "tool")
        self._teardown_session(req, t, "tool_failed")
        self.counters["sessions_failed"] += 1
        self._emit(FailedEvent(rid=req.rid, kind=kind, error=err,
                               n_tokens=req.output_tokens, time=t))

    def _teardown_session(self, req: Request, t: float, cause: str):
        """Shared teardown for cancellation and terminal tool failure:
        abandon every in-flight completion path, close the open pause
        accounting, free the speculative fork, release pages and
        scheduler structures, and charge the accrued byte-seconds to the
        ledger's ``cancelled``/``tool_failed`` cause — the session ends;
        the engine and every co-resident session are untouched."""
        rid = req.rid
        self._fault_state.pop(rid, None)
        # in-flight completion paths: scripted stub entry, off-thread tool
        # (result discarded on drain), queued resumes/retries/faults
        self.api.inflight.pop(rid, None)
        if self.async_tools is not None:
            self.async_tools.discard(rid)
        self._resume_pending.discard(rid)
        for qname in ("_resume_queue", "_retry_queue", "_fault_queue"):
            q = getattr(self, qname)
            if any(e[2] == rid for e in q):
                q = [e for e in q if e[2] != rid]
                heapq.heapify(q)
                setattr(self, qname, q)
        # close the open pause accounting (ledger record + tracer span
        # stay balanced: every async_begin gets its async_end)
        win = self._tool_windows.pop(rid, None)
        if win is not None:
            realized = max(0.0, t - req.t_call)
            self.counters["tool_seconds"] += realized
            self.counters["overlapped_tool_seconds"] += \
                min(win[2], realized)
        rec = self.ledger.intercept_finished(
            rid, req.decision or "none", t)
        if self.tracer.enabled and rec is not None:
            self.tracer.async_end("tool", rid, rec.kind, t,
                                  {"branch": rec.branch, "outcome": cause})
        self._close_wait_mark(req, t)
        # a live speculative fork dies with the session; its accrued
        # occupancy joins the teardown charge (not speculation_wasted —
        # the fork didn't mispredict, its session went away)
        fork = self._spec_forks.pop(rid, None)
        fork_bs = 0.0
        if fork is not None:
            fork.dead = True
            fork_bs = fork.byte_seconds
            self._spec_free(fork)
            self.counters["spec_killed"] += 1
            self._spec_note(req, fork, cause, 0, t)
        # release scheduler structures + pages (notify_cancelled zeroes
        # host retention BEFORE on_discard, so _on_discard frees every
        # device page and drops host payloads: kv ends empty, no leaks)
        self.sched.notify_cancelled(
            req, t, cause="cancelled" if cause == "cancelled"
            else "tool_failed")
        bs = self._accrued_bs.pop(rid, 0.0) + fork_bs
        self.ledger.charge_abandoned(cause, bs)
        if self.tracer.enabled:
            self.tracer.instant(("req", rid), cause, t,
                                {"byte_seconds": bs})

    def _emit(self, ev):
        if not self.emit_events:
            return
        if self.buffer_events:
            self.events.append(ev)
        if self.event_sink is not None:
            self.event_sink(ev)

    def _emit_token(self, req: Request, tid: int, idx: int, t: float):
        self._emit(TokenEvent(rid=req.rid, token_id=tid, index=idx, time=t))

    def _boundary_action(self, req: Request, tid: int, end: float, events,
                         intercepted: set, finished: set, *,
                         pop_on_fire: bool = False) -> bool:
        """Consult a session request's controller with the sampled token
        ``tid`` at a token boundary. Returns True when the controller fired
        an intercept or finish — the trigger token is consumed (popped if
        it was already appended by a prefill), exactly as the scripted path
        drops the sampled id of the intercepting step."""
        ctrl = req.controller
        if ctrl is None:
            return False
        act = ctrl.on_token(req, tid, end)
        if act is None:
            return False
        if pop_on_fire:
            self.kv[req.rid].tokens.pop()
        if act == "finish":
            req.close_segment(None)
            self.sched.notify_finished(req, end)
            finished.add(req.rid)
            events["finished"].append(req)
            return True
        intc = Interception(kind=act.kind, duration=act.duration_hint,
                            returned_tokens=act.returned_tokens or 0)
        req.close_segment(intc)
        c_before, gpu_before = req.device_tokens, self.sched.gpu_used()
        self._maybe_fork(req, intc, end)   # before pages are freed/swapped
        self.sched.notify_intercepted(req, intc, end)
        self._note_intercept(req, intc, end, c_before, gpu_before)
        timeout_s, retries, backoff = self._fault_policy(req, act)
        self._fault_state[req.rid] = FaultState(
            kind=intc.kind, caller_owned=act.returned_tokens is None,
            timeout_s=timeout_s, max_retries=retries, backoff_s=backoff,
            deadline=None if timeout_s is None else end + timeout_s)
        if act.returned_tokens is not None:
            # scripted stub owns the resume: the due time is known now
            self._tool_windows[req.rid] = [end, end + intc.duration, 0.0]
            self.api.launch(req, intc, end)
        else:
            # caller-owned: due fixed when resume_request posts it
            self._tool_windows[req.rid] = [end, float("inf"), 0.0]
        intercepted.add(req.rid)
        self._emit(InterceptEvent(
            rid=req.rid, kind=act.kind, reason=act.reason,
            trigger_token_id=tid, duration_hint=act.duration_hint,
            caller_owned=act.returned_tokens is None, time=end))
        return True

    # ------------------------------------------------------------------
    # telemetry hooks (DESIGN.md §13)
    # ------------------------------------------------------------------
    def _note_intercept(self, req: Request, intc: Interception, t: float,
                        c_before: int, gpu_before: int):
        """Open the intercept's ledger record. ``c_before``/``gpu_before``
        are the context sizes captured BEFORE notify_intercepted (discard
        zeroes device_tokens immediately); the estimator call is pure, so
        recording its prediction cannot perturb the stream."""
        pred = self.sched.estimator.estimate(req, t)
        self.ledger.intercept_started(req.rid, intc.kind, t, pred,
                                      c_before, gpu_before)
        if self.tracer.enabled:
            self.tracer.async_begin(
                "tool", req.rid, intc.kind, t,
                {"kind": intc.kind, "predicted_s": pred,
                 "c_tokens": c_before,
                 "decision": req.decision or "pending"})

    def _close_wait_mark(self, req: Request, t1: float):
        """Close an open queued/swapped_wait window: observe it into the
        wait histograms and emit its span ending at ``t1`` (the start of
        the iteration that finally computes for the request), so wait
        spans never overlap the compute spans that follow them."""
        mark = self._wait_marks.pop(req.rid, None)
        if mark is None:
            return
        t0, kind = mark
        self.metrics.observe(
            "engine_queue_wait_s" if kind == "queued"
            else "engine_swapped_wait_s", max(0.0, t1 - t0))
        if self.tracer.enabled and t1 > t0:
            self.tracer.span(("req", req.rid), kind, t0, t1)

    def _trace_iteration(self, plan, start: float, end: float,
                         t_model: float, stall: float):
        """Emit this iteration's spans (tracer-enabled runs only). Called
        before apply_plan so per-chunk recompute shares read the same
        pre-commit debt the ledger charged."""
        tr = self.tracer
        tr.span(("engine", "step"), "iter", start, end,
                {"query_tokens": plan.query_tokens,
                 "context_tokens": plan.context_tokens,
                 "decode": len(plan.decode), "chunks": len(plan.chunks),
                 "stall_s": stall})
        swap_tokens = sum(n for _, n in plan.swap_out) \
            + sum(n for _, n in plan.swap_in)
        if swap_tokens:
            t_dma = min(t_model, self.cost.t_swap(swap_tokens))
            tr.span(("engine", "dma"), "swap_dma", start, start + t_dma,
                    {"tokens": swap_tokens})
        if stall > 0.0:
            tr.span(("engine", "dma"),
                    "bubble" if self.overlap else "stall",
                    start + t_model, end)
        for req, n in plan.chunks:
            rec = min(n, self.sched._recompute_debt.get(req.rid, 0))
            tr.span(("req", req.rid), "prefill", start, end,
                    {"tokens": n, "recompute_tokens": rec})
        for req in plan.decode:
            tr.span(("req", req.rid), "decode", start, end)
        for req, n in plan.swap_out:
            tr.span(("req", req.rid), "swap_out", start, end,
                    {"tokens": n})
        for req, n in plan.swap_in:
            tr.span(("req", req.rid), "swap_in", start, end,
                    {"tokens": n})

    def _sample_row(self, req: Request, flat_row: np.ndarray,
                    position: int) -> int:
        """Sample one token from a host-fetched logits row on the per-call
        paths, bit for bit as the fused path samples it: greedy requests
        keep the host np.argmax; a stochastic row runs sample_tokens on
        the engine's device with the same (seed, position) noise key."""
        sp = req.sampling
        if sp is None or sp.greedy:
            return int(np.argmax(flat_row))
        dev = self.device
        out = sample_tokens(
            torch.from_numpy(np.ascontiguousarray(flat_row))[None].to(dev),
            torch.tensor([sp.temperature], dtype=torch.float32, device=dev),
            torch.tensor([sp.top_k], dtype=torch.int32, device=dev),
            torch.tensor([sp.top_p], dtype=torch.float32, device=dev),
            torch.tensor([sp.seed], dtype=torch.int32, device=dev),
            torch.tensor([position], dtype=torch.int32, device=dev))
        return int(out[0])

    def _sampling_rows(self, reqs: Sequence[Request], B_pad: int):
        """Per-row (temps, top_ks, top_ps, seeds) host arrays for the
        fused dispatch; None when every row is greedy, which keeps the
        argmax-only graph."""
        if all(r.sampling is None or r.sampling.greedy for r in reqs):
            return None
        temps = np.zeros(B_pad, np.float32)
        ks = np.zeros(B_pad, np.int32)
        ps = np.ones(B_pad, np.float32)
        seeds = np.zeros(B_pad, np.int32)
        for b, r in enumerate(reqs):
            sp = r.sampling
            if sp is None:
                continue
            temps[b] = sp.temperature
            ks[b] = sp.top_k
            ps[b] = sp.top_p
            seeds[b] = sp.seed
        return temps, ks, ps, seeds

    # ------------------------------------------------------------------
    # page plumbing
    # ------------------------------------------------------------------
    def _allocate_pages(self, n: int) -> Optional[List[int]]:
        """Allocate n pages, evicting cold cache-only pages on pressure."""
        got = self.blocks.allocate(n)
        if got is None and self.cache is not None:
            self.cache.evict(n - self.blocks.num_free)
            got = self.blocks.allocate(n)
        return got

    def _sacrifice_fork(self) -> bool:
        """Page pressure last resort: kill one live speculative fork
        (lowest rid — deterministic) so real work can allocate. Pure
        speculation must never block or crash the real workload."""
        if not self._spec_forks:
            return False
        self._spec_kill(self._spec_forks[min(self._spec_forks)], "pool")
        return True

    def _try_ensure_pages(self, st: ReqKV, upto_tokens: int) -> bool:
        # request the whole shortfall in one _allocate_pages call: a single
        # cache-eviction pass covers the lot, instead of one page (and
        # potentially one eviction scan) per loop trip
        short = -(-upto_tokens // self.page) - len(st.pages)
        if short <= 0:
            return True
        got = self._allocate_pages(short)
        while got is None and self._sacrifice_fork():
            got = self._allocate_pages(short)
        if got is None:
            return False
        st.pages.extend(("dev", pid) for pid in got)
        return True

    def _ensure_pages(self, st: ReqKV, upto_tokens: int):
        # backstop over the graceful path: _back_plan pre-flights every
        # planned chunk/decode write, so dispatch-time failure here means
        # a bookkeeping bug, not ordinary pool pressure
        if not self._try_ensure_pages(st, upto_tokens):
            raise RuntimeError("out of KV pages — size the engine up")

    def _try_ensure_writable(self, st: ReqKV, pos: int) -> bool:
        """Copy-on-write: the page holding token position ``pos`` is about
        to be written. Shared pages (prefix-cache hits, pages the cache
        adopted from this request, or pages a speculative fork holds) are
        immutable — take a private copy of the payload first, an index
        copy on the pools in place, on the compute stream before the
        model call that writes it. Exclusive pages are written in place.
        Without a cache or speculation no page is ever shared, so the
        early-out skips the lookup. Under exhaustion the copy target is
        reclaimed by evicting cold cache pages one at a time, then
        sacrificing speculative forks; False only when the pool genuinely
        cannot back the copy."""
        if self.cache is None and not self.speculate:
            return True
        pidx = pos // self.page
        if pidx >= len(st.pages):
            return True
        kind, pid = st.pages[pidx]
        if kind != "dev" or not self.blocks.is_shared(pid):
            return True
        new, copied = self.blocks.cow_target(pid)
        while new is None:
            if self.cache is not None and self.cache.evict(1) > 0:
                new, copied = self.blocks.cow_target(pid)
                continue
            if self._sacrifice_fork():
                new, copied = self.blocks.cow_target(pid)
                continue
            return False
        if copied:
            self._copy_page(pid, new)
        st.pages[pidx] = ("dev", new)
        return True

    def _copy_page(self, src: int, dst: int):
        """The COW payload copy: page ``src`` of every layer's pools into
        page ``dst``, in place on the compute stream, so the model call
        issued after it reads and writes the private copy in order. A
        quantized pool's scale leaves are among the leaves: scales travel
        with the payload on every fork."""
        for leaf in tree_leaves(self.pools):
            leaf[:, dst] = leaf[:, src]
        self.counters["cow_bytes"] += self.page * self.kv_token_bytes
        if self.kv_dtype is not None:
            self.counters["kv_quant_scale_cow_pages"] += 1

    # ------------------------------------------------------------------
    # quantized pools: scale lifetime == page lifetime (DESIGN.md §17)
    # ------------------------------------------------------------------
    def _wrap_free_for_quant(self) -> None:
        """Chain onto ``blocks.free``: zero the scales of every page whose
        refcount drops to 0. Eager, at free time: swap-out packs its slab
        before freeing, and COW / swap-in allocate an already-zeroed page
        and then overwrite payload and scales together."""
        inner = self.blocks.free

        def free(pages) -> None:
            recycled = [int(p) for p in pages
                        if self.blocks.ref_count(p) == 1]
            inner(pages)
            if recycled:
                self._zero_page_scales(recycled)

        self.blocks.free = free

    def _scale_leaves(self) -> List[torch.Tensor]:
        return [pool[key] for entry in self.pools for pool in entry.values()
                for key in ("k_scale", "v_scale") if key in pool]

    def _zero_page_scales(self, pages: List[int]) -> None:
        """An in-place zero of the pages' scales on the compute stream, so
        it is ordered after the in-flight model call and after the
        swap-out pack that preceded the free; the ids cross in one pinned,
        non-blocking copy."""
        ids = self._to_device(np.asarray(pages, np.int32))[0].long()
        for leaf in self._scale_leaves():
            leaf.index_fill_(1, ids, 0.0)
        self.counters["kv_quant_scale_reset_pages"] += len(pages)

    def _stale_scale_pages(self) -> List[int]:
        """Pages violating the freed => zero-scales invariant (the
        sanitizer's per-page scale audit reads it at every plan phase).
        Reads the scales to the host: a sync, so only for the sanitizer
        and checks at the end of a run."""
        if self.kv_dtype is None:
            return []
        mx = torch.zeros(self.blocks.n_pages)
        for leaf in self._scale_leaves():
            mx = torch.maximum(mx, leaf.abs().amax(dim=(0, 2)).cpu())
        return [p for p in range(self.blocks.n_pages)
                if self.blocks.ref_count(p) == 0 and mx[p] > 0.0]

    def _ensure_writable(self, st: ReqKV, pos: int):
        # backstop, same contract as _ensure_pages: unreachable for
        # planned work once _back_plan has pre-flighted the plan
        if not self._try_ensure_writable(st, pos):
            raise RuntimeError("out of KV pages during copy-on-write")

    def _device_page_ids(self, st: ReqKV, n_pages: int) -> List[int]:
        ids = []
        for e in st.pages[:n_pages]:
            assert e is not None and e[0] == "dev", \
                "request not fully device-resident"
            ids.append(e[1])
        return ids

    # ------------------------------------------------------------------
    # prefix cache
    # ------------------------------------------------------------------
    def _cache_probe(self, req: Request) -> int:
        """Scheduler hook: tokens of this request's context that a discard
        would get back from the cache (the full pages _on_discard is about
        to register). An estimate — eviction may drop them before resume —
        but LRU keeps recently discarded contexts hot (DESIGN.md §8)."""
        st = self.kv.get(req.rid)
        if st is None or req.host_tokens:
            return 0
        return (st.computed // self.page) * self.page

    def _register_in_cache(self, st: ReqKV):
        """Index this context's computed full pages in the radix tree. The
        cache adopts (refcount-bumps) pages it hasn't seen; duplicates of
        already-indexed blocks stay solely owned by the request."""
        if self.cache is None:
            return
        full = st.computed // self.page
        head = st.pages[:full]
        if full <= 0 or any(e is None or e[0] != "dev" for e in head):
            return                     # host-resident prefix: not shareable
        self.cache.insert(st.tokens[:full * self.page],
                          [e[1] for e in head])

    def _try_cache_match(self, req: Request):
        """Fork the longest cached prefix of a fresh/discarded context in
        place of recomputing it. Capped at target_ctx - 1 so at least one
        token remains to compute (its logits seed the next decode), and at
        the scheduler's free token capacity — credited tokens count against
        it immediately, so a burst of fully-matched requests must not
        overcommit the GPU. The matched pages are shared read-only; a
        partial tail page is taken COW so the request can append into it.
        A zero-hit probe is decided by the first token block, so misses are
        memoized on the cache generation alone — waiting queues don't
        re-walk the tree every iteration until the index actually changes
        (discard invalidates via _match_seen.pop)."""
        st = self.kv.get(req.rid)
        if (self.cache is None or st is None or st.pages
                or req.device_tokens or req.host_tokens):
            return
        if self._match_seen.get(req.rid) == self.cache.generation:
            return                     # known miss on an unchanged index
        limit = min(req.target_ctx - 1, self.sched.gpu_free())
        if limit <= 0:
            return
        m = self.cache.match(st.tokens[:limit])
        if m.total <= 0:
            self._match_seen[req.rid] = self.cache.generation
            return
        self.blocks.fork(m.pages)
        st.pages = [("dev", pid) for pid in m.pages]
        if m.tail_pid is not None:
            self.blocks.fork([m.tail_pid])
            st.pages.append(("dev", m.tail_pid))
        st.computed = m.total
        self.sched.notify_cache_hit(req, m.total)

    # ------------------------------------------------------------------
    # plan execution
    # ------------------------------------------------------------------
    def _on_discard(self, req: Request, n_tokens: int):
        if self.tracer.enabled:
            self.tracer.instant(("req", req.rid), "discard", self.now,
                                {"tokens_dropped": n_tokens})
        st = self.kv.get(req.rid)
        if st is None:
            return
        self._register_in_cache(st)    # context survives under cache refs
        self._match_seen.pop(req.rid, None)   # context gone: probe afresh
        freed = [e[1] for e in st.pages if e is not None and e[0] == "dev"]
        self.blocks.free(freed)
        # host prefix survives; discarded device pages are dropped entirely
        st.pages = st.pages[:-(-req.host_tokens // self.page)] \
            if req.host_tokens else []
        st.computed = req.host_tokens

    def _page_align_swaps(self, plan):
        """Round token-granular swap amounts to page-granular moves."""
        def aligned_out(req, n):
            st = self.kv[req.rid]
            dev_start = req.host_tokens        # host prefix is pages [0, h)
            first_dev_page = dev_start // self.page
            moved = 0
            pages = []
            p = first_dev_page
            while moved < n and p * self.page < st.computed:
                count = min(self.page, st.computed - p * self.page)
                if moved + count > n and count == self.page:
                    break                      # don't split full pages
                pages.append(p)
                moved += count
                p += 1
            return pages, moved

        new_out = []
        for req, n in plan.swap_out:
            pages, moved = aligned_out(req, n)
            if moved:
                new_out.append((req, moved, pages))
        plan.swap_out = [(r, n) for r, n, _ in new_out]
        self._swap_out_pages = {r.rid: p for r, _, p in new_out}

        new_in = []
        for req, n in plan.swap_in:
            st = self.kv[req.rid]
            first_host = next((i for i, e in enumerate(st.pages)
                               if e is not None and e[0] == "host"), None)
            if first_host is None:
                continue
            moved = 0
            pages = []
            p = first_host
            while moved < n and p < len(st.pages) and \
                    st.pages[p] is not None and st.pages[p][0] == "host":
                count = min(self.page,
                            req.host_tokens + req.device_tokens
                            - p * self.page)
                if moved + count > n and count == self.page:
                    break
                pages.append(p)
                moved += count
                p += 1
            if moved:
                new_in.append((req, moved, pages))
        plan.swap_in = [(r, n) for r, n, _ in new_in]
        self._swap_in_pages = {r.rid: p for r, _, p in new_in}

    def _stage_swap_out(self, req: Request) -> Optional[int]:
        """Dispatch half of the outbound swap (DESIGN.md §12): launch the
        one swap_pack gather of ALL the request's outbound pages, every
        pool leaf, into one contiguous device slab and issue its copy to
        one pinned host buffer WITHOUT synchronizing, then free the source
        pages. The pools are updated in place, so
        freeing is safe only because the gather runs on the compute
        stream: this iteration's swap-ins and appends into the recycled
        pages are stream-ordered after it, while the host copy drains on
        the stager's copy stream behind the model call. Returns a stager
        ticket for _complete_swap_out, or None when page alignment left
        nothing to move."""
        st = self.kv[req.rid]
        idxs = self._swap_out_pages.get(req.rid, [])
        if not idxs:
            return None
        pids = []
        for p in idxs:
            kind, pid = st.pages[p]
            assert kind == "dev"
            pids.append(pid)
        ticket = self.stager.pack(self.pools, pids)
        self.blocks.free(pids)
        return ticket

    def _complete_swap_out(self, req: Request, ticket: Optional[int]):
        """Commit half: collect the staged slab host-side (blocking only
        on that transfer) and reconcile the page table — the outbound
        pages become ("host", payload) entries, payload a pytree of host
        tensors (views of the slab)."""
        if ticket is None:
            return
        st = self.kv[req.rid]
        idxs = self._swap_out_pages.get(req.rid, [])
        pages = slab_pages(self.stager.collect(ticket), len(idxs))
        for p, payload in zip(idxs, pages):
            st.pages[p] = ("host", payload)
        self.counters["swap_bytes"] += \
            len(idxs) * self.page * self.kv_token_bytes

    def _exec_swap_in(self, req: Request) -> bool:
        """Hand the request's inbound page payloads to the stager, which
        stacks them into one pinned slab and scatters it back into freshly
        allocated pool pages with one host to device copy and one
        swap_unpack launch for every pool leaf, issue-only on the compute
        stream — the model dispatch that follows reads the
        updated pools in stream order, without a host sync. Returns
        False (nothing moved, no partial allocation held) when the
        physical pool cannot back the planned pages — the caller
        re-preempts the request instead of aborting the engine."""
        st = self.kv[req.rid]
        idxs = self._swap_in_pages.get(req.rid, [])
        if not idxs:
            return True
        got = self._allocate_pages(len(idxs))
        if got is None:
            return False
        payloads = []
        for p in idxs:
            kind, payload = st.pages[p]
            assert kind == "host"
            payloads.append(payload)
        self.stager.unpack(self.pools, got, payloads)
        for i, p in enumerate(idxs):
            st.pages[p] = ("dev", got[i])
        self.counters["swap_bytes"] += \
            len(idxs) * self.page * self.kv_token_bytes
        return True

    def _pool_preempt(self, req: Request):
        """The device pool cannot physically back this request's planned
        write (COW copies and cache-held pages the scheduler's token
        accounting cannot see): re-preempt gracefully — the context
        becomes recompute debt and the request requeues FCFS — instead of
        the old hard RuntimeError mid-dispatch. Same shape as the PR 5
        swap-in seam (_swap_in_failed), extended to every planned
        chunk/decode write."""
        self._close_wait_mark(req, self.now)
        self._wait_marks[req.rid] = (self.now, "queued")
        if self.tracer.enabled:
            self.tracer.instant(("req", req.rid), "pool_preempt", self.now)
        self.sched.notify_pool_exhausted(req, self.now)
        # notify's on_discard hook freed the device pages (host retention
        # was zeroed first); drop any leftover host payload entries
        st = self.kv[req.rid]
        st.pages = []
        st.computed = 0

    def _back_plan(self, plan):
        """Graceful admission (DESIGN.md §15): pre-flight the physical
        backing for every planned chunk/decode write — pages allocated
        and COW targets resolved in the exact order the dispatch paths
        would — BEFORE anything reaches the device. Entries the pool
        cannot back are dropped from the plan and their requests
        re-preempted via _pool_preempt; the dropped entries' planned
        compute still charges the iteration (pool thrash is not free),
        and the raising _ensure_* backstops downstream become
        unreachable for planned work."""
        if not (plan.chunks or plan.decode):
            return
        kept = []
        for req, n in plan.chunks:
            st = self.kv[req.rid]
            if self._try_ensure_pages(st, st.computed + n) and \
                    self._try_ensure_writable(st, st.computed):
                kept.append((req, n))
            else:
                self._pool_preempt(req)
        plan.chunks = kept
        kept = []
        for req in plan.decode:
            st = self.kv[req.rid]
            if self._try_ensure_pages(st, req.target_ctx + 1) and \
                    self._try_ensure_writable(st, req.target_ctx):
                kept.append(req)
            else:
                self._pool_preempt(req)
        plan.decode = kept

    def _swap_in_failed(self, req: Request):
        """A planned swap-in could not be backed by physical pages
        (exhaustion the scheduler's token accounting cannot see — COW
        copies, cache-held pages): gracefully re-preempt via the
        scheduler — the context becomes recompute debt, the request
        requeues FCFS — instead of the old hard
        ``RuntimeError("out of KV pages during swap-in")`` mid-commit."""
        st = self.kv[req.rid]
        # close any open wait span and restart the clock as queue time:
        # the request goes back to FCFS with its context as recompute debt
        self._close_wait_mark(req, self.now)
        self._wait_marks[req.rid] = (self.now, "queued")
        if self.tracer.enabled:
            self.tracer.instant(("req", req.rid), "swap_in_failed",
                                self.now)
        self.sched.notify_swap_in_failed(req, self.now)
        # notify's on_discard hook freed the device-resident pages and
        # dropped the host-prefix retention (host_tokens was zeroed
        # first); any remaining entries are host payloads to drop
        st.pages = []
        st.computed = 0

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """A call's int32 routing arrays as one host buffer that crosses
        to the device in one pinned, non-blocking copy; returns device
        views shaped like ``arrays``."""
        dev = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
        if dev.device != self.device:
            dev = dev.pin_memory().to(self.device, non_blocking=True)
        parts = torch.split(dev, [a.size for a in arrays])
        return [t.view(a.shape) for t, a in zip(parts, arrays)]

    def _block_table(self, sts: Sequence[ReqKV], rows: int) -> np.ndarray:
        """(rows, max_pages) int32 block tables of ``sts``, padded with
        the scratch page."""
        bt = np.full((rows, self.max_pages), self.scratch_page, np.int32)
        for b, st in enumerate(sts):
            ids = self._device_page_ids(st, len(st.pages))
            bt[b, :len(ids)] = ids
        return bt

    def _gather_cache(self, bt_d: torch.Tensor):
        """The gather oracle's view: block tables bt_d (B, P) on the device
        -> a slotted cache (periods, B, P * page, ...) copied out of the
        pools."""
        Bsz, P = bt_d.shape
        ids = bt_d.reshape(-1).long()

        def g(leaf):
            out = leaf.index_select(1, ids)
            return out.reshape(leaf.shape[0], Bsz, P * self.page,
                               *leaf.shape[3:])
        return tree_map(g, self.pools)

    def _scatter_tokens(self, cache, bt: np.ndarray, batch_idx: np.ndarray,
                        positions: np.ndarray):
        """Write the cache entries at (batch_idx[i], positions[i]) back into
        the pools, at the pages of each row's block table ``bt`` (host).
        Only the real entries are given: a padded row or token is never
        built into the index tensors, so it never touches a physical page
        (where the reference pads to a jit shape and drops the padding
        with an out-of-range page id)."""
        pids = bt[batch_idx, positions // self.page]
        pids_d, offs_d, bidx_d, pos_d = (
            t.long() for t in self._to_device(
                pids.astype(np.int32),
                (positions % self.page).astype(np.int32),
                batch_idx.astype(np.int32), positions.astype(np.int32)))

        def s(pool_leaf, cache_leaf):
            pool_leaf[:, pids_d, offs_d] = \
                cache_leaf[:, bidx_d, pos_d].to(pool_leaf.dtype)
        tree_map(s, self.pools, cache)

    def _extend_call(self, st: ReqKV, start: int, n: int) -> torch.Tensor:
        """Issue one chunk call over positions [start, start + n) of
        ``st``'s context: LM.extend_step_paged on the pools, or, on the
        gather oracle, LM.extend_step over the gathered block table, then
        the n real tokens' K/V scattered back. The chunk is padded to a
        bucketed length as in the reference; padding tokens sit past the
        real range, causally invisible, and their writes are dropped (or
        land only in the throwaway view). Returns the last real token's
        logits (1, V) ((1, K, V) with codebooks), still on the device."""
        n_pad = max(n, min(self._bucket(n),
                           self.max_pages * self.page - start))
        toks = np.zeros((1, n_pad), np.int32)
        toks[0, :n] = st.tokens[start:start + n]
        bt = self._block_table([st], 1)
        toks_d, meta_d, bt_d = self._to_device(
            toks, np.array([start, n, n - 1], np.int32), bt)
        toks_d = self._feed(toks_d)
        if self.paged:
            logits, _ = self.model.extend_step_paged(
                self.params, toks_d, meta_d[0:1], meta_d[1:2], self.pools,
                bt_d, logits_index=meta_d[2:3])
            return logits
        logits, cache = self.model.extend_step(
            self.params, toks_d, meta_d[0:1], self._gather_cache(bt_d),
            logits_index=meta_d[2:3])
        self._scatter_tokens(cache, bt, np.zeros(n, np.int64),
                             np.arange(start, start + n))
        return logits

    def _decode_call(self, sts: Sequence[ReqKV],
                     pos: Sequence[int]) -> torch.Tensor:
        """Issue one decode call over a bucketed batch: row b feeds
        ``sts[b].tokens[pos[b]]`` at position pos[b]. LM.decode_step_paged
        on the pools, where padded rows carry ctx_lens 0 and write
        nothing; or, on the gather oracle, LM.decode_step over the
        gathered block tables (padded rows: the scratch page's view at
        position 0) and the real rows' new K/V scattered back. Returns
        logits (B_pad, V) ((B_pad, K, V) with codebooks), still on the
        device."""
        B_pad = self._bucket(len(sts))
        feed = np.zeros(B_pad, np.int32)
        ctx_lens = np.zeros(B_pad, np.int32)   # counts the new token
        for b, (st, p) in enumerate(zip(sts, pos)):
            feed[b] = st.tokens[p]
            ctx_lens[b] = p + 1
        bt = self._block_table(sts, B_pad)
        feed_d, cl_d, bt_d = self._to_device(feed, ctx_lens, bt)
        feed_d = self._feed(feed_d)
        if self.paged:
            logits, _ = self.model.decode_step_paged(self.params, feed_d,
                                                     cl_d, self.pools, bt_d)
            return logits
        logits, cache = self.model.decode_step(
            self.params, feed_d, (cl_d - 1).clamp(min=0),
            self._gather_cache(bt_d))
        self._scatter_tokens(cache, bt, np.arange(len(sts)),
                             np.asarray(pos, np.int64))
        return logits

    def _exec_chunk(self, req: Request, n: int):
        """Unfused prefill chunk: one extend call, issue-only. The final
        chunk of a fresh prefill emits the first generated token, but its
        logits fetch and host-side sampling are deferred to the commit
        phase (DESIGN.md §12): nothing reads st.tokens / _prefill_emits
        before commit."""
        st = self.kv[req.rid]
        assert req.host_tokens == 0, "chunks require device-resident prefix"
        start = st.computed
        self._ensure_pages(st, start + n)
        # only the first page of the chunk range can be shared (a matched
        # COW tail); pages past it were freshly allocated above
        self._ensure_writable(st, start)
        logits = self._extend_call(st, start, n)
        # the gather oracle round-trips the whole block-table view; the
        # paged call's MLA blocks gather their latent table once
        self.counters["prefill_bytes"] += (
            n * self.kv_token_bytes
            + self.max_pages * self.page * self.kv_mla_token_bytes
            if self.paged else
            (self.max_pages * self.page + n) * self.kv_token_bytes)
        self.counters["prefill_tokens"] += n
        self.counters["device_dispatches"] += 1
        st.computed = start + n
        if st.computed == req.target_ctx and len(st.tokens) == req.target_ctx:
            self._pending_oracle.append(("chunk", req, st, logits))
        if st.computed == req.target_ctx:
            # prefill/recompute complete: publish the context so concurrent
            # same-prefix requests can hit before this one even finishes
            self._register_in_cache(st)

    def _exec_decode(self, reqs: List[Request]):
        """Unfused decode: one bucketed paged (or gather) decode call for
        every decoding request, issue-only. The full B_pad x vocab logits cross
        to the host at commit (the per-step cost the fused path's
        on-device sampling removes)."""
        if not reqs:
            return
        sts = [self.kv[r.rid] for r in reqs]
        for r, st in zip(reqs, sts):
            self._ensure_pages(st, r.target_ctx + 1)
            self._ensure_writable(st, r.target_ctx)
        pos = [r.target_ctx for r in reqs]
        logits = self._decode_call(sts, pos)
        # O(1) appends per generated token, plus the O(context) latent
        # gather of MLA blocks per padded row; the gather oracle
        # round-trips the whole block-table view, O(context)
        B_pad = self._bucket(len(reqs))
        self.counters["decode_bytes"] += (
            len(reqs) * self.kv_token_bytes
            + B_pad * self.max_pages * self.page * self.kv_mla_token_bytes
            if self.paged else
            (B_pad * self.max_pages * self.page + len(reqs))
            * self.kv_token_bytes)
        self.counters["decode_tokens"] += len(reqs)
        self.counters["device_dispatches"] += 1
        self._pending_oracle.append(("decode", list(reqs), logits, pos))
        for st, p in zip(sts, pos):
            st.computed = p + 1

    def _dispatch_mixed(self, plan):
        """Fused mixed-batch iteration (DESIGN.md §10): flatten every chunk
        and every decode of this plan into one ragged token batch —
        flattened ids + per-token (sequence, position) routing + a stacked
        block-table matrix, bucketed to powers of two as in the reference —
        and execute it with a single LM.forward_mixed_paged call. The
        routing, and the sampling rows of a batch with a stochastic
        request, cross to the device as one pinned int32 buffer. Sampling
        runs on device, so the only device->host transfer is B int32 ids;
        full logits stay resident (never fetched here).
        Issue-only (DESIGN.md §12): returns (entries, sampled_dev) with the
        sampled ids still on device — _commit_mixed fetches them, so staged
        swap copies drain behind the model call in between."""
        entries = []                       # (req, st, start, n, is_chunk)
        for req, n in plan.chunks:
            st = self.kv[req.rid]
            assert req.host_tokens == 0, \
                "chunks require device-resident prefix"
            start = st.computed
            self._ensure_pages(st, start + n)
            # only the first page of the chunk range can be shared (a
            # matched COW tail); pages past it were freshly allocated
            self._ensure_writable(st, start)
            entries.append((req, st, start, n, True))
        for req in plan.decode:
            st = self.kv[req.rid]
            self._ensure_pages(st, req.target_ctx + 1)
            self._ensure_writable(st, req.target_ctx)
            entries.append((req, st, req.target_ctx, 1, False))
        if not entries:
            return None

        B = len(entries)
        B_pad = self._bucket(B)
        total = sum(n for _, _, _, n, _ in entries)
        N_pad = self._bucket(total)
        toks = np.zeros(N_pad, np.int32)
        tseq = np.zeros(N_pad, np.int32)      # pad rows: masked via tok_pos
        tpos = np.full(N_pad, -1, np.int32)   # -1 marks a padded token row
        qlast = np.zeros(B_pad, np.int32)
        off = 0
        for b, (req, st, start, n, _) in enumerate(entries):
            toks[off:off + n] = st.tokens[start:start + n]
            tseq[off:off + n] = b
            tpos[off:off + n] = np.arange(start, start + n)
            qlast[b] = off + n - 1
            off += n
        samp = self._sampling_rows([e[0] for e in entries], B_pad)
        routing = [toks, tseq, tpos, qlast,
                   self._block_table([e[1] for e in entries], B_pad)]
        if samp is not None:
            # the float rows cross as their int32 bits in the same copy
            routing += [a.view(np.int32) for a in samp]
        dev = self._to_device(*routing)
        toks_d, tseq_d, tpos_d, qlast_d, bt_d = dev[:5]
        if samp is not None:
            temps_d, ks_d, ps_d, seeds_d = dev[5:]
            samp = (temps_d.view(torch.float32), ks_d,
                    ps_d.view(torch.float32), seeds_d)
        sampled, _logits, _ = self.model.forward_mixed_paged(
            self.params, self._feed(toks_d), tseq_d, tpos_d, qlast_d,
            self.pools, bt_d, samp)

        n_chunk = sum(n for _, _, _, n, c in entries if c)
        n_dec = B - len(plan.chunks)
        # the reference gathers MLA blocks' latent table once per flat row:
        # chunk rows charge prefill, decode rows decode, and padding rows
        # the decode side when the batch has decodes, else prefill (0 for
        # models without MLA)
        mla_gather = self.max_pages * self.page * self.kv_mla_token_bytes
        pad_rows = N_pad - total
        self.counters["prefill_bytes"] += n_chunk * self.kv_token_bytes \
            + (n_chunk + (0 if n_dec else pad_rows)) * mla_gather
        self.counters["prefill_tokens"] += n_chunk
        # O(1) appends per generated token
        self.counters["decode_bytes"] += n_dec * self.kv_token_bytes \
            + (n_dec + (pad_rows if n_dec else 0)) * mla_gather
        self.counters["decode_tokens"] += n_dec
        self.counters["device_dispatches"] += 1
        # B_pad int32 ids, O(B) — size known without fetching
        self.counters["logit_bytes"] += \
            sampled.numel() * sampled.element_size()
        return entries, sampled

    def _commit_mixed(self, entries, sampled):
        """Commit half of the fused iteration: fetch the sampled ids (the
        one device->host sync of the step) and reconcile bookkeeping —
        computed counts, prefill first-token emits, decode ids."""
        ids = sampled.tolist()
        self._decode_ids = []
        for b, (req, st, start, n, is_chunk) in enumerate(entries):
            if is_chunk:
                st.computed = start + n
                # final chunk of a fresh prefill seeds generation with the
                # on-device sampled id
                if st.computed == req.target_ctx \
                        and len(st.tokens) == req.target_ctx:
                    st.tokens.append(ids[b])
                    self._prefill_emits.append((req, ids[b]))
                if st.computed == req.target_ctx:
                    # prefill/recompute complete: publish the context so
                    # concurrent same-prefix requests can hit early
                    self._register_in_cache(st)
            else:
                st.computed = start + 1
                self._decode_ids.append(ids[b])

    def _feed(self, toks: torch.Tensor) -> torch.Tensor:
        """Token ids on the device as the model takes them: with codebooks
        each id broadcast over the K codebooks as a view made on the
        device (no K copies cross from the host), as the reference engine
        feeds musicgen."""
        K = self.cfg.n_codebooks
        return toks[..., None].expand(*toks.shape, K) if K else toks

    def _last_book(self, row: np.ndarray) -> np.ndarray:
        """A fetched logits row (V,) or (K, V) -> the last codebook's (V,),
        the row every path samples from."""
        return row.reshape(-1, self.cfg.vocab_size)[-1]

    def _fetch_logits(self, logits: torch.Tensor) -> np.ndarray:
        """Fetch an unfused call's logits to the host (a sync), counted in
        ``logit_bytes`` at the fetched array's size (every codebook's row
        with codebooks, as the reference counts them); float32 numpy for
        host-side sampling."""
        host = logits.cpu()
        self.counters["logit_bytes"] += host.numel() * host.element_size()
        return host.float().numpy()

    def _commit_oracle(self):
        """Resolve the unfused paths' deferred logits fetches at the
        commit sync point, in dispatch order (chunks before decode — a
        request never has both in one plan), each token sampled from the
        last codebook's row at the position it will take: a chunk's
        st.computed, a decode's pos + 1."""
        pending, self._pending_oracle = self._pending_oracle, []
        for entry in pending:
            if entry[0] == "chunk":
                _, req, st, logits = entry
                tid = self._sample_row(
                    req, self._last_book(self._fetch_logits(logits[0])),
                    st.computed)
                st.tokens.append(tid)
                self._prefill_emits.append((req, tid))
            else:
                _, reqs, logits, pos = entry
                rows = self._fetch_logits(logits)
                self._decode_ids = [
                    self._sample_row(r, self._last_book(rows[b]), pos[b] + 1)
                    for b, r in enumerate(reqs)]

    # ------------------------------------------------------------------
    # speculative resume (DESIGN.md §14)
    # ------------------------------------------------------------------
    def _maybe_fork(self, req: Request, intc: Interception, t: float):
        """Fork the sequence at an intercept boundary, BEFORE the
        scheduler's pause decision frees or swaps its pages. The fork
        bumps page refcounts, so whatever Eq. 5 does to the parent —
        preserve, swap, discard — the forked KV survives under the fork's
        own references, and the parent's state is never touched: a
        rejected fork falls back bit-identically."""
        if not self.speculate:
            return
        st = self.kv.get(req.rid)
        seg_next = req.seg_idx + 1   # segment_done has not run yet; this
        if (st is None                # is the index completions() will use
                or req.rid in self._spec_forks
                or seg_next >= len(req.segments)):
            return
        # fork only a clean, fully device-resident context: the pages ARE
        # the state being forked (at an intercept boundary the trigger
        # token is consumed, so tokens == computed == target_ctx)
        if (req.host_tokens or st.computed != req.device_tokens
                or req.device_tokens != req.target_ctx
                or len(st.tokens) != req.target_ctx
                or any(e is None or e[0] != "dev" for e in st.pages)):
            return
        nxt = req.segments[seg_next]
        if not nxt.open and (nxt.gen_tokens or 0) < 1:
            return
        pred = self.predictor.predict(req.rid, intc.kind, seg_next,
                                      intc.returned_tokens)
        if not pred:
            return
        predicted = [int(p) % self.cfg.vocab_size for p in pred]
        # emit budget: stop short of the next segment's boundary so the
        # segment-completing token (interception/finish consult) always
        # goes through the normal decode path; open (session) segments
        # get exactly the seed emit — their controller is consulted at
        # graft time before the token is ever fed onward
        max_emit = 1 if nxt.open else min(self.spec_tokens, nxt.gen_tokens)
        pids = [e[1] for e in st.pages]
        self.blocks.fork(pids)
        fork = SpecFork(
            req=req, kind=intc.kind,
            st=ReqKV(tokens=list(st.tokens) + predicted,
                     pages=[("dev", pid) for pid in pids],
                     computed=st.computed),
            base=req.target_ctx, predicted=predicted, max_emit=max_emit)
        self._spec_forks[req.rid] = fork
        self.counters["spec_forks"] += 1
        if self.tracer.enabled:
            self.tracer.async_begin(
                "spec", req.rid, intc.kind, t,
                {"predicted_tokens": len(predicted),
                 "max_emit": max_emit})

    def _spec_free(self, fork: SpecFork):
        """Release the fork's page references. Every model call that read
        or wrote them was issued before on the one compute stream, so a
        later write into a recycled page is stream-ordered after them."""
        self.blocks.free([e[1] for e in fork.st.pages
                          if e is not None and e[0] == "dev"])
        fork.st.pages = []

    def _spec_kill(self, fork: SpecFork, why: str):
        """Page pressure killed the fork mid-flight: release its pages
        and charge the occupancy it wasted. The parent never knew the
        fork existed, so the baseline path is untouched — the resume
        simply finds no fork and runs normally."""
        fork.dead = True
        self._spec_forks.pop(fork.req.rid, None)
        self._spec_free(fork)
        self.ledger.charge_speculation(fork.byte_seconds)
        self.counters["spec_killed"] += 1
        self._spec_note(fork.req, fork, "killed", 0, self.now)

    def _spec_note(self, req: Request, fork: SpecFork, outcome: str,
                   grafted: int, t: float):
        self.spec_log.setdefault(req.rid, []).append(
            {"kind": fork.kind, "accepted": outcome == "accepted",
             "outcome": outcome, "predicted_tokens": len(fork.predicted),
             "emitted_tokens": fork.emitted, "grafted_tokens": grafted,
             "time": t})
        if self.tracer.enabled:
            self.tracer.async_end(
                "spec", req.rid, fork.kind, t,
                {"outcome": outcome, "grafted_tokens": grafted,
                 "wasted_byte_seconds": fork.byte_seconds
                 if outcome != "accepted" else 0.0})

    def _spec_pages(self, fork: SpecFork, upto_tokens: int) -> bool:
        short = -(-upto_tokens // self.page) - len(fork.st.pages)
        if short <= 0:
            return True
        got = self._allocate_pages(short)
        if got is None:
            return False
        fork.st.pages.extend(("dev", pid) for pid in got)
        return True

    def _spec_cow(self, fork: SpecFork, pos: int) -> bool:
        """COW for fork writes: the fork's tail page is shared with the
        parent (and possibly the prefix cache) — take a private copy
        before the fork appends into it. Same mechanics as
        _try_ensure_writable, but failure kills the fork instead of
        raising: speculation must never crash the real workload."""
        st = fork.st
        pidx = pos // self.page
        if pidx >= len(st.pages):
            return True
        kind, pid = st.pages[pidx]
        if kind != "dev" or not self.blocks.is_shared(pid):
            return True
        new, copied = self.blocks.cow_target(pid)
        if new is None and self.cache is not None:
            self.cache.evict(1)
            new, copied = self.blocks.cow_target(pid)
        if new is None:
            return False
        if copied:
            self._copy_page(pid, new)
        st.pages[pidx] = ("dev", new)
        return True

    def _spec_advance(self, fork: SpecFork) -> bool:
        """One speculative step, issued and fetched in the commit phase.
        The first call prefills the predicted returned tokens and emits
        the fork's first sampled token — exactly the chunk-end emit the
        real resume path would produce; later calls decode one token each
        through the paged decode. Sampling depends only on the context,
        the seed and the position, so an ACCEPTED fork's tokens are the
        ones the baseline would decode after the real resume: speculation
        moves them earlier in virtual time, it cannot change them."""
        if fork.dead or fork.emitted >= fork.max_emit:
            return False
        req, st = fork.req, fork.st
        if fork.emitted == 0:
            # predicted-return prefill: positions [base, base + P)
            start, n = st.computed, len(fork.predicted)
            if not self._spec_pages(fork, start + n) \
                    or not self._spec_cow(fork, start):
                self._spec_kill(fork, "pages")
                return False
            logits = self._extend_call(st, start, n)
            st.computed = start + n
            st.tokens.append(self._sample_row(
                req, self._last_book(logits[0].cpu().float().numpy()),
                st.computed))
            fork.emitted = 1
            self.counters["spec_prefill_tokens"] += n
            return True
        pos = st.computed
        if not self._spec_pages(fork, pos + 1) \
                or not self._spec_cow(fork, pos):
            self._spec_kill(fork, "pages")
            return False
        logits = self._decode_call([st], [pos])
        st.computed = pos + 1
        st.tokens.append(self._sample_row(
            req, self._last_book(logits[0].cpu().float().numpy()), pos + 1))
        fork.emitted += 1
        self.counters["spec_decode_tokens"] += 1
        return True

    def _spec_step_forks(self, iter_time: float):
        """Commit-phase fork stepping: every live fork accrues the extra
        occupancy it pinned over this iteration and advances one step —
        bounded piggyback on the batch's memory-bound window; the virtual
        clock is untouched, so baseline requests are unperturbed."""
        for fork in list(self._spec_forks.values()):
            self._spec_advance(fork)
            # accrue AFTER the step so the iteration that materialized the
            # predicted prefill already pays for its residency — a fork
            # rejected at the very next resume still shows up in the ledger
            fork.byte_seconds += (fork.st.computed - fork.base) \
                * self.cost.m_bytes * iter_time

    def _spec_idle(self, gap: float):
        """Idle-gap fork stepping: the device is otherwise parked, so fork
        steps are budgeted against the gap's cost-model-priced virtual
        time instead of piggybacking on a batch window."""
        for fork in list(self._spec_forks.values()):
            budget = gap
            while not fork.dead and fork.emitted < fork.max_emit:
                q = len(fork.predicted) if fork.emitted == 0 else 1
                t = self.cost.t_fwd(q, fork.st.computed + q)
                if t > budget:
                    break
                if not self._spec_advance(fork):
                    break
                budget -= t
            # post-step accrual, same reasoning as _spec_step_forks
            fork.byte_seconds += (fork.st.computed - fork.base) \
                * self.cost.m_bytes * gap

    def _spec_validate(self, req: Request, toks, t_done: float) -> bool:
        """Resume-time validation. Exact-match accept: the fork's pages
        and tokens replace the parent's context and the request decodes
        immediately — the returned-token re-prefill is skipped entirely
        (the recompute debt / host payload a mid-pause discard or swap
        left behind is voided by notify_spec_graft). Any mismatch frees
        the fork, charges ``speculation_wasted``, and returns False: the
        baseline resume path runs bit-identically."""
        fork = self._spec_forks.pop(req.rid, None)
        if fork is None:
            return False
        actual = [int(t) % self.cfg.vocab_size for t in toks]
        if fork.dead or fork.emitted < 1 or actual != fork.predicted:
            self._spec_free(fork)
            self.ledger.charge_speculation(fork.byte_seconds)
            self.counters["spec_rejected"] += 1
            self._spec_note(req, fork, "rejected", 0, t_done)
            return False
        st = self.kv[req.rid]
        # the fork's context supersedes the parent's: release the
        # parent's device refs; host-payload entries just disappear
        self.blocks.free([e[1] for e in st.pages
                          if e is not None and e[0] == "dev"])
        st.tokens = fork.st.tokens
        st.pages = fork.st.pages
        st.computed = fork.st.computed
        self._match_seen.pop(req.rid, None)
        k = fork.emitted
        self.sched.notify_spec_graft(req, fork.base + len(fork.predicted))
        self.sched.notify_resumed(req, self.now, n_returned=len(actual))
        assert req.phase == Phase.RUNNING, "grafted resume must be ready"
        # graft the fork's decoded tokens past the first (seed) emit:
        # advance_decode's accounting, k - 1 tokens at once. max_emit
        # stops short of the segment boundary, so no interception or
        # finish can fall inside the graft.
        for _ in range(k - 1):
            req.target_ctx += 1
            req.device_tokens += 1
            req.gen_in_seg += 1
            req.output_tokens += 1
        if k > 1 and req.first_token_time is None:
            req.first_token_time = self.now
        self.counters["spec_accepted"] += 1
        self.counters["spec_grafted_tokens"] += k
        self._spec_note(req, fork, "accepted", k, t_done)
        self._close_wait_mark(req, self.now)
        if req.controller is not None:
            # session seed token: consult the controller NOW, before the
            # scheduler can feed the token to a decode — the same
            # consult-before-use order the prefill-emit path guarantees
            tid = st.tokens[-1]
            local = {"intercepted": [], "finished": []}
            if self._boundary_action(req, tid, self.now, local, set(),
                                     set(), pop_on_fire=True):
                for fin in local["finished"]:
                    self._finish_request(fin, self.now)
            else:
                self._emit_token(req, tid, len(st.tokens) - 1, self.now)
        else:
            base_idx = len(st.tokens) - k
            for i in range(k):
                self._emit_token(req, st.tokens[base_idx + i],
                                 base_idx + i, self.now)
        return True

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration as an explicit three-phase pipeline
        (DESIGN.md §12): plan -> dispatch -> commit. Returns False when no
        further progress is possible without external input (fully
        drained, or every remaining session is blocked on a caller-side
        resume)."""
        plan = self._plan_phase()
        if plan.empty:
            return self._advance_idle()
        inflight = self._dispatch_phase(plan)
        self._commit_phase(plan, inflight)
        return True

    def _plan_phase(self):
        """PLAN: admission, async-tool / resume injection, prefix-cache
        matching, the scheduler's iteration plan, and page-aligning its
        token-granular swap amounts. Pure host bookkeeping — nothing is
        dispatched to the device yet."""
        if self.sanitizer is not None:
            # safe point: post-commit state is stable, audit ownership
            self.sanitizer.audit("plan")
        self._admit()
        self._prefill_emits = []
        # fault machinery (§15) runs at this safe point, in dependency
        # order: cancels first (a cancelled session must not retry), then
        # the chaos hook (its cancels apply immediately), async-tool
        # completions/faults, due retries (which may inline-dispatch and
        # fail again -> same-phase fault processing), fault decisions,
        # deadlines (a queued resolution due on-or-before its deadline
        # wins), and finally the due resumes themselves.
        self._process_cancels()
        if self.on_plan is not None:
            self.on_plan(self)
            self._process_cancels()
        self._inject_async_tools()
        self._launch_retries()
        self._process_faults()
        self._fire_timeouts()
        for req, toks, t_done in self._due_resumes():
            self._fault_state.pop(req.rid, None)   # pause resolved
            # tool-overlap accounting (§12): the pause's virtual duration,
            # and the part of it that coincided with engine-busy time —
            # tool latency hidden behind serving rather than extending it
            # (the window's accumulated iteration intersections, exact)
            self.counters["tool_seconds"] += max(0.0, t_done - req.t_call)
            win = self._tool_windows.pop(req.rid, None)
            if win is not None:
                self.counters["overlapped_tool_seconds"] += win[2]
            # close the intercept's ledger record at the branch the pause
            # actually resolved to (min-waste may have flipped it mid-
            # pause) — the same call site the simulator mirrors
            rec = self.ledger.intercept_finished(
                req.rid, req.decision or "none", t_done)
            if self.tracer.enabled and rec is not None:
                self.tracer.async_end(
                    "tool", req.rid, rec.kind, t_done,
                    {"branch": rec.branch,
                     "predicted_s": rec.predicted_s,
                     "realized_s": rec.realized_s,
                     "predicted_waste": rec.predicted_waste,
                     "realized_waste": rec.realized_waste})
                self.tracer.instant(("req", req.rid), "resume", t_done)
            if self._spec_validate(req, toks, t_done):
                continue   # accepted fork grafted; re-prefill skipped
            self.kv[req.rid].tokens.extend(
                int(t) % self.cfg.vocab_size for t in toks)
            self.sched.notify_resumed(req, self.now, n_returned=len(toks))
            if req.phase != Phase.RUNNING:
                # returned tokens need compute (or a swap-in) before the
                # request decodes again: wait-state clock restarts at the
                # boundary (self.now >= t_done; the due time itself can
                # fall inside an already-committed iteration's spans)
                self._wait_marks[req.rid] = (
                    self.now,
                    "swapped_wait" if req.host_tokens > 0 else "queued")
        if self.cache is not None:
            # single match point: covers fresh admissions, discarded
            # contexts re-entering after an interception, and eviction
            # victims — anything waiting with no context yet
            for req in list(self.sched.waiting):
                self._try_cache_match(req)
        plan = self.sched.next_iteration(self.now)
        if not plan.empty:
            self._page_align_swaps(plan)
        return plan

    def _advance_idle(self) -> bool:
        """Nothing schedulable: jump the virtual clock to the next known
        event, or block on an off-thread tool when that is the only thing
        the engine is waiting for."""
        INF = float("inf")
        t_arr = self._pending_arrivals[-1].arrival \
            if self._pending_arrivals else INF
        t = self.api.next_completion_time()
        t_api = t if t is not None else INF
        t_res = self._resume_queue[0][0] if self._resume_queue else INF
        # fault machinery wake-ups (§15): backed-off retries, queued
        # failures, and the earliest armed timeout deadline
        t_rty = self._retry_queue[0][0] if self._retry_queue else INF
        t_flt = self._fault_queue[0][0] if self._fault_queue else INF
        t_ddl = min((fs.deadline for fs in self._fault_state.values()
                     if fs.deadline is not None), default=INF)
        t_tool = min(t_api, t_res, t_rty, t_flt, t_ddl)
        nxt = min(t_arr, t_tool)
        if nxt != INF:
            target = max(self.now, nxt)
            gap = target - self.now
            if gap > 0.0:
                # idle attribution: a jump whose target is a pending tool
                # completion (not an arrival) is pause time that
                # overlapped NO serving work — pinned context there is
                # pure tool_unoverlapped waste
                self.ledger.charge_idle(gap, self.sched.gpu_used(),
                                        t_tool <= t_arr)
                # idle occupancy accrues too (§15): pinned context over
                # the jump is held memory a teardown must charge
                m_bytes = self.cost.m_bytes
                for r in self.sched.live.values():
                    if r.device_tokens:
                        self._accrued_bs[r.rid] = \
                            self._accrued_bs.get(r.rid, 0.0) \
                            + r.device_tokens * m_bytes * gap
                if self._spec_forks:
                    self._spec_idle(gap)
                if self.tracer.enabled:
                    self.tracer.span(
                        ("engine", "step"), "idle", self.now, target,
                        {"pinned_tokens": self.sched.gpu_used()})
            self.now = target
            return True
        if self.async_tools is not None and self.async_tools.inflight:
            # every remaining session is gated on an off-thread tool:
            # wall-block until one completes, then inject and continue
            self.async_tools.wait_any()
            self._inject_async_tools()
            return True
        return False

    def _dispatch_phase(self, plan) -> StepInflight:
        """DISPATCH: issue this iteration's device work back-to-back with
        no host sync in between — swap-out slab gathers and their host
        copies, swap-in slab scatters, then the model call — so the
        host<->device copies overlap the model dispatch (§4.1's budget
        premise made real). With overlap=False each transfer completes
        synchronously in the legacy serial order, the differential
        oracle. Swap-ins that cannot be backed by physical pages
        re-preempt their request gracefully and drop out of the plan."""
        inflight = StepInflight()
        for req, _ in plan.swap_out:
            ticket = self._stage_swap_out(req)
            if self.overlap:
                inflight.swap_out.append((req, ticket))
            else:
                self._complete_swap_out(req, ticket)  # lint: allow(dispatch-host-sync): serial oracle (overlap=False) completes DMA inline
        ok_in = []
        for req, n in plan.swap_in:
            if self._exec_swap_in(req):
                ok_in.append((req, n))
            else:
                # the transfer never happened: refund its synchronous
                # stall (unbudgeted plans charged t_swap(n) into stall_s;
                # budgeted plans carry none, max() keeps 0) so the clock
                # is not stalled for phantom DMA
                plan.stall_s = max(0.0, plan.stall_s - self.cost.t_swap(n))
                self._swap_in_failed(req)
        plan.swap_in = ok_in
        self._back_plan(plan)
        if self.sanitizer is not None:
            # every page this plan writes must now be live + exclusive
            self.sanitizer.check_plan(plan)
        if plan.chunks or plan.decode:
            self.counters["mixed_iterations"] += 1
        if self.fused:
            inflight.mixed = self._dispatch_mixed(plan)
            if not self.overlap and inflight.mixed is not None:
                self._commit_mixed(*inflight.mixed)  # lint: allow(dispatch-host-sync): serial oracle (overlap=False) syncs inline
                inflight.mixed = None
        else:
            # per-call oracle paths sample host-side: their logits fetch
            # is inherent, but it is deferred to commit, so staged
            # swap-out copies still drain behind the model calls
            for req, n in plan.chunks:
                self._exec_chunk(req, n)
            self._exec_decode(plan.decode)
        return inflight

    def _commit_phase(self, plan, inflight: StepInflight):
        """COMMIT: the single host-sync point of the step. Fetch the fused
        dispatch's sampled ids, collect the staged swap-out slabs
        (reconciling page tables), charge the iteration's virtual time
        with overlap semantics, then run the scheduler bookkeeping and
        session boundary consults exactly as the serial engine did —
        commit-phase reconciliation keeps every host-visible state
        transition in the same order as overlap=False, which is why the
        two paths are bit-identical."""
        if inflight.mixed is not None:
            self._commit_mixed(*inflight.mixed)
        if self._pending_oracle:
            self._commit_oracle()
        for req, ticket in inflight.swap_out:
            self._complete_swap_out(req, ticket)

        t_model = self.cost.t_fwd(max(1, plan.query_tokens),
                                  plan.context_tokens)
        if self.overlap:
            swap_tokens = sum(n for _, n in plan.swap_out) \
                + sum(n for _, n in plan.swap_in)
            hidden, stall = self.cost.overlap_terms(
                t_model, swap_tokens, plan.stall_s)
            if swap_tokens:
                self.counters["swap_overlap_bytes"] += \
                    hidden * self.cost.m_bytes
            if stall > 0.0:
                self.counters["pipeline_bubbles"] += 1
                self.counters["pipeline_bubble_s"] += stall
        else:
            stall = plan.stall_s
        iter_time = t_model + stall
        start = self.now
        end = start + iter_time
        # tool-overlap integral: this iteration's exact intersection with
        # every in-flight pause window [t_call, due]
        for win in self._tool_windows.values():
            win[2] += max(0.0, min(end, win[1]) - max(start, win[0]))
        # waste attribution (§13): charge the iteration with the
        # pre-commit scheduler state — recompute debt, paused context and
        # batch occupancy exactly as the simulator observes them
        rec_tokens = sum(min(n, self.sched._recompute_debt.get(r.rid, 0))
                         for r, n in plan.chunks)
        self.ledger.charge_iteration(
            iter_time, stall, self.overlap, rec_tokens,
            plan.query_tokens, self.sched.paused_device_tokens(),
            self.sched.gpu_used())
        # per-session occupancy accrual (§15): integrate each live
        # request's device-resident bytes over the iteration, so a later
        # cancel/terminal failure charges exactly what the session held
        # (popped unchargeable at normal finish)
        m_bytes = self.cost.m_bytes
        for r in self.sched.live.values():
            if r.device_tokens:
                self._accrued_bs[r.rid] = self._accrued_bs.get(r.rid, 0.0) \
                    + r.device_tokens * m_bytes * iter_time
        if self.tracer.enabled:
            self._trace_iteration(plan, start, end, t_model, stall)
        for req, _ in plan.chunks:
            self._close_wait_mark(req, start)
        for req, _ in plan.swap_in:
            self._close_wait_mark(req, start)
        for req in plan.decode:
            self._close_wait_mark(req, start)
        decode_reqs = list(plan.decode)
        events = self.sched.apply_plan(plan, end)
        # the iteration's virtual time is spent: advance the clock BEFORE
        # the boundary consults, so an inline ToolExecutor dispatch
        # (event_sink -> resume_request) anchors its due time at the
        # intercept's virtual time, not one iteration early
        self.now = end
        intercepted = {r.rid for r, _ in events["intercepted"]}
        finished = {r.rid for r in events["finished"]}
        # session boundaries for prefills that just emitted their first
        # generated token: the controller may consume it (pop) and fire
        for req, tid in self._prefill_emits:
            if self._boundary_action(req, tid, end, events, intercepted,
                                     finished, pop_on_fire=True):
                continue
            self._emit_token(req, tid, len(self.kv[req.rid].tokens) - 1, end)
        for b, req in enumerate(decode_reqs):
            if req.rid in intercepted or req.rid in finished:
                continue
            tid = self._decode_ids[b]
            # session-driven requests decide intercept/finish from the
            # sampled token itself, not from a script; a fired boundary
            # consumes the trigger (exactly the scripted path's dropped
            # sampled id)
            if self._boundary_action(req, tid, end, events, intercepted,
                                     finished):
                continue
            st = self.kv[req.rid]
            st.tokens.append(tid)
            self._emit_token(req, tid, len(st.tokens) - 1, end)
        for req, intc in events["intercepted"]:
            c_before, gpu_before = req.device_tokens, self.sched.gpu_used()
            self._maybe_fork(req, intc, end)   # before pages are freed
            self.sched.notify_intercepted(req, intc, end)
            self._note_intercept(req, intc, end, c_before, gpu_before)
            sp = req.sampling
            self._fault_state[req.rid] = FaultState(
                kind=intc.kind, caller_owned=False,
                timeout_s=None if sp is None else sp.tool_timeout_s,
                max_retries=0 if sp is None else sp.tool_retries,
                backoff_s=0.05 if sp is None else sp.tool_backoff_s,
                deadline=None if sp is None or sp.tool_timeout_s is None
                else end + sp.tool_timeout_s)
            self._tool_windows[req.rid] = [end, end + intc.duration, 0.0]
            self.api.launch(req, intc, end)
            self._emit(InterceptEvent(
                rid=req.rid, kind=intc.kind, reason="scripted",
                trigger_token_id=None, duration_hint=intc.duration,
                caller_owned=False, time=end))
        for req in events["finished"]:
            self._finish_request(req, end)
        # step forks LAST so one created by this iteration's intercepts
        # still piggybacks on this iteration (a tool returning within a
        # single iteration would otherwise always reject at emitted==0)
        if self._spec_forks:
            self._spec_step_forks(iter_time)

    def _finish_request(self, req: Request, end: float):
        """Engine-side finish bookkeeping, shared by the commit loop and
        the speculative graft's inline seed-token consult."""
        self.finished.append(req)
        self._wait_marks.pop(req.rid, None)
        self._accrued_bs.pop(req.rid, None)   # produced output: not waste
        self._fault_state.pop(req.rid, None)
        if self.tracer.enabled:
            self.tracer.instant(("req", req.rid), "finish", end,
                                {"output_tokens": req.output_tokens})
        st = self.kv[req.rid]
        self._register_in_cache(st)   # prompt+gen prefix reusable by
        self.blocks.free([e[1] for e in st.pages   # follow-up turns
                          if e is not None and e[0] == "dev"])
        st.pages = []
        self._match_seen.pop(req.rid, None)
        self._emit(FinishEvent(rid=req.rid, n_tokens=req.output_tokens,
                               time=end))

    def run(self, max_steps: int = 100000, *,
            strict: bool = False) -> RunResult:
        """Drive iterations until the engine drains or blocks on a
        caller-side resume. Returns the finished requests; ``.drained`` is
        False when the loop stopped on ``max_steps`` with work still
        pending (raised as EngineStepsExhausted under ``strict``) — step
        exhaustion is never silent."""
        steps = 0
        drained = True
        while True:
            more = (self._pending_arrivals or self.sched.has_work()
                    or self.api.inflight or self._resume_queue
                    or self._cancel_queue or self._retry_queue
                    or self._fault_queue
                    or (self.async_tools is not None
                        and self.async_tools.inflight))
            if not more:
                break
            if steps >= max_steps:
                drained = False
                if strict:
                    raise EngineStepsExhausted(
                        f"run() exhausted {max_steps} steps with work "
                        f"pending ({len(self.finished)} finished, "
                        f"{len(self.sched.live)} live)")
                break
            if not self.step():
                break
            steps += 1
        return RunResult(self.finished, drained)

    def poll(self, max_steps: int = 100000, *,
             strict: bool = False) -> EventBatch:
        """The event-drain loop (DESIGN.md §11): advance until drained or
        until every remaining session is blocked on an out-of-band
        resume_request, then return the events emitted since the last
        drain. The batch's ``drained`` flag is False when the run stopped
        on step exhaustion instead (strict raises, as in run) — a
        truncated event stream is never silent. Requires ``emit_events``
        (InferCeptClient sets it)."""
        res = self.run(max_steps, strict=strict)
        out, self.events = self.events, []
        return EventBatch(out, res.drained)

    def close(self):
        """Release engine-held external resources: shuts down the
        attached AsyncToolRuntime's worker threads (idempotent; a closed
        engine can still be inspected, but not driven through off-thread
        tools)."""
        if self.async_tools is not None:
            self.async_tools.shutdown()

    # ------------------------------------------------------------------
    def generated_text(self, req: Request) -> List[int]:
        """All token ids of a finished request (prompt + gen + returned)."""
        return list(self.kv[req.rid].tokens)

    def kv_bytes_per_decode_token(self) -> float:
        """KV bytes copied between buffers per generated token — O(1) page
        writes on the paged path, O(context) round-trips on the gather
        oracle (the measurable form of the §3.2 scatter-cost claim)."""
        return (self.counters["decode_bytes"]
                / max(1, self.counters["decode_tokens"]))

    def kv_bytes_per_prefill_token(self) -> float:
        return (self.counters["prefill_bytes"]
                / max(1, self.counters["prefill_tokens"]))
