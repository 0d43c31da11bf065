"""First-class session API: caller-driven intercept/resume over the engine.

InferCept's core claim is that interception is a serving primitive — the
caller pauses a request at a tool call and resumes it with appended tokens,
instead of ending generation and resubmitting (the paper's Fig. 6
API/executor boundary). This module is that boundary (DESIGN.md §11):

  * ``InferCeptClient.submit(prompt_ids, SamplingParams) -> SessionHandle``
    opens a session; the engine streams ``TokenEvent`` / ``InterceptEvent``
    / ``FinishEvent`` into the handle as ``poll()`` drives iterations.
  * Interception is requested by the CALLER — an explicit
    ``client.intercept(handle, duration_hint)``, a stop-token set, or a
    pluggable detector callable — never read from a script. The engine
    consults the session's controller at every sampled-token boundary; the
    triggering token is consumed (reported as the event's
    ``trigger_token_id``), exactly as the scripted closed loop drops the
    sampled id of the intercepting step.
  * ``client.resume(handle, returned_token_ids)`` appends the tool's
    tokens and requeues the session — or attach a ``ToolExecutor``
    (``tools=``) and the client round-trips the call for you when it
    drains the intercept event.

``ScriptedClient`` replays the legacy Table-1 workloads through this API:
each scripted request becomes a session whose controller fires the
script's interceptions by generated-token count and whose returned tokens
come from the engine's virtual-time stub. Its streams are bit-identical to
feeding the scripted requests straight into ``Engine.run()`` — the legacy
closed loop is now just one client of the session API (pinned by
tests/test_session.py across all four policies).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Union)

from repro_torch.core.request import (InterceptDirective, Request, SamplingParams,
                                Segment)
from repro_torch.serving.api_executor import (ToolCall, ToolError, ToolExecutor,
                                        ToolResult, prompt_token_ids)

__all__ = [
    "SamplingParams", "TokenEvent", "InterceptEvent", "FinishEvent",
    "FailedEvent", "CancelledEvent", "RejectedEvent",
    "SessionHandle", "SessionController", "ScriptedController",
    "InferCeptClient", "ScriptedClient",
]


# ---------------------------------------------------------------------------
# the event contract
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One generated token committed to the session's context."""
    rid: int
    token_id: int
    index: int            # absolute position in the token stream
    time: float           # engine virtual time


@dataclasses.dataclass(frozen=True)
class InterceptEvent:
    """The session paused at a tool call. ``caller_owned`` means the caller
    must resume it (``trigger_token_id`` was consumed, not appended);
    scripted interceptions are completed by the engine's virtual-time
    stub."""
    rid: int
    kind: str
    reason: str           # explicit | stop_token | detector | scripted | retry
    trigger_token_id: Optional[int]
    duration_hint: float
    caller_owned: bool
    time: float
    attempt: int = 0      # retry attempt index (0 = first dispatch)


@dataclasses.dataclass(frozen=True)
class FinishEvent:
    rid: int
    n_tokens: int         # generated tokens over the session's lifetime
    time: float


@dataclasses.dataclass(frozen=True)
class FailedEvent:
    """Terminal tool failure (retries exhausted or non-retryable error,
    DESIGN.md §15): the SESSION ends here — its pages are freed and its
    accrued byte-seconds charged to the ledger's ``tool_failed`` cause —
    but the engine and every co-resident session are untouched."""
    rid: int
    kind: str             # tool kind that failed
    error: ToolError
    n_tokens: int         # tokens generated before the failure
    time: float


@dataclasses.dataclass(frozen=True)
class CancelledEvent:
    """The caller tore the session down (``SessionHandle.cancel()`` /
    ``Engine.cancel_request``); pages freed, byte-seconds charged to
    ``cancelled``."""
    rid: int
    reason: str
    n_tokens: int
    time: float


@dataclasses.dataclass(frozen=True)
class RejectedEvent:
    """Admission control refused the session at submit: bounded intake is
    full (backpressure). Nothing was allocated; resubmit later."""
    rid: int
    reason: str           # e.g. "queue_full"
    time: float


Event = Union[TokenEvent, InterceptEvent, FinishEvent,
              FailedEvent, CancelledEvent, RejectedEvent]


# ---------------------------------------------------------------------------
# controllers: the per-token intercept/finish decision
# ---------------------------------------------------------------------------
class SessionController:
    """Decides, at each sampled-token boundary, whether the session
    continues (None), intercepts (InterceptDirective), or finishes
    ("finish"). Priority: explicit caller request > detector > stop-token
    set > max_new_tokens."""

    def __init__(self, *, stop_tokens: Sequence[int] = (),
                 detector: Optional[Callable] = None,
                 max_new_tokens: Optional[int] = None,
                 kind: str = "tool", duration_hint: float = 0.0,
                 timeout_s: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 backoff_s: Optional[float] = None):
        self.stop_tokens = frozenset(int(t) for t in stop_tokens)
        self.detector = detector       # detector(req, token_id, now)
        self.max_new_tokens = max_new_tokens
        self.kind = kind
        self.duration_hint = duration_hint
        # per-session tool fault policy defaults (DESIGN.md §15); None
        # defers to the request's SamplingParams, resolved by the engine
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._pending = None           # explicit intercept()/finish()

    def request_intercept(self, duration_hint: Optional[float] = None,
                          kind: Optional[str] = None):
        self._pending = InterceptDirective(
            kind=kind or self.kind,
            duration_hint=self.duration_hint if duration_hint is None
            else duration_hint,
            reason="explicit",
            timeout_s=self.timeout_s, max_retries=self.max_retries,
            backoff_s=self.backoff_s)

    def request_finish(self):
        self._pending = "finish"

    def on_token(self, req: Request, token_id: int, now: float):
        if self._pending is not None:
            act, self._pending = self._pending, None
            return act
        if self.detector is not None:
            act = self.detector(req, token_id, now)
            if act is not None:
                return act
        if token_id in self.stop_tokens:
            return InterceptDirective(kind=self.kind,
                                      duration_hint=self.duration_hint,
                                      reason="stop_token",
                                      timeout_s=self.timeout_s,
                                      max_retries=self.max_retries,
                                      backoff_s=self.backoff_s)
        if self.max_new_tokens is not None \
                and req.output_tokens >= self.max_new_tokens:
            return "finish"
        return None


class ScriptedController:
    """Replays a legacy segment script through the session lifecycle:
    fires each interception when the segment's generated-token count is
    reached — the same ``gen_in_seg >= gen_tokens`` boundary apply_plan
    checks for scripted requests — with ``returned_tokens`` declared so the
    engine's virtual-time stub owns the resume."""

    def __init__(self, segments: Sequence[Segment]):
        self.script = list(segments)
        self._k = 0

    def on_token(self, req: Request, token_id: int, now: float):
        if self._k >= len(self.script):
            return None
        seg = self.script[self._k]
        if req.gen_in_seg >= seg.gen_tokens:
            self._k += 1
            if seg.interception is None:
                return "finish"
            i = seg.interception
            return InterceptDirective(kind=i.kind, duration_hint=i.duration,
                                      returned_tokens=i.returned_tokens,
                                      reason="scripted")
        return None


# ---------------------------------------------------------------------------
# handles and clients
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SessionHandle:
    rid: int
    request: Request
    controller: object
    tools: Optional[ToolExecutor]
    events: Deque[Event] = dataclasses.field(default_factory=deque)
    # queued | active | intercepted | resuming | finished
    #   | failed | cancelled | rejected        (terminal, DESIGN.md §15)
    state: str = "queued"
    # terminal tool failure detail (set with state == "failed")
    error: Optional[ToolError] = None
    # backref set by InferCeptClient.submit — enables handle.cancel()
    client: Optional[object] = None
    # False = state/tool dispatch only, no per-handle event retention
    # (batch replay paths that never read handle.events)
    buffer_events: bool = True
    # virtual time of the last TokenEvent — feeds the session-level
    # TTFT / inter-token-gap histograms in the engine's registry
    _last_token_t: Optional[float] = None
    # speculative-resume outcomes (DESIGN.md §14): one dict per validated
    # intercept ({"kind", "accepted", "outcome", "predicted_tokens",
    # "emitted_tokens", "grafted_tokens", "time"}), appended live by the
    # engine — the client aliases this list to the engine's spec_log[rid],
    # so the handle sees acceptances the moment they are grafted
    speculation: List[dict] = dataclasses.field(default_factory=list)

    def next_event(self) -> Optional[Event]:
        return self.events.popleft() if self.events else None

    @property
    def finished(self) -> bool:
        return self.state == "finished"

    @property
    def done(self) -> bool:
        """Terminal in ANY way: finished normally, terminally failed,
        cancelled, or rejected at admission."""
        return self.state in ("finished", "failed", "cancelled", "rejected")

    def cancel(self, reason: str = "client"):
        """Tear this session down from whatever state it is in — queued,
        running, swapped, intercepted with an in-flight tool, or
        speculating. Takes effect at the engine's next plan phase (safe
        point); the CancelledEvent lands on this handle's stream."""
        assert self.client is not None, "handle not attached to a client"
        self.client.cancel(self, reason=reason)

    @property
    def spec_accept_rate(self) -> Optional[float]:
        """Accepted fraction of this session's validated speculative
        forks; None when the session was never speculated on."""
        if not self.speculation:
            return None
        acc = sum(1 for s in self.speculation if s["accepted"])
        return acc / len(self.speculation)


class InferCeptClient:
    """The session facade over one Engine. Typical loop:

        client = InferCeptClient(engine)
        h = client.submit(prompt_ids, SamplingParams(temperature=0.7),
                          stop_tokens={TOOL_ID}, tools=my_executor)
        while not h.finished:
            events = client.poll()
            ...  # inspect TokenEvents; resume() manually if tools is None

    ``poll()`` advances the engine until it is drained or every remaining
    session is blocked on a caller-side ``resume()``; sessions with an
    attached ToolExecutor are round-tripped automatically as their
    intercept events drain.

    ``tool_workers > 0`` attaches an ``AsyncToolRuntime`` to the engine:
    attached ToolExecutors then run OFF-THREAD (DESIGN.md §12) and their
    completions are injected at the engine's next plan phase, anchored at
    the same intercept-time + duration virtual instant the inline
    dispatch uses — a slow tool no longer wall-clock-blocks unrelated
    sessions' progress."""

    def __init__(self, engine, *, tool_workers: int = 0):
        if engine.event_sink is not None:
            raise ValueError(
                "engine already has a client attached (event_sink is set); "
                "one InferCeptClient per engine — a second would silently "
                "detach the first client's sessions")
        self.engine = engine
        engine.emit_events = True
        engine.event_sink = self._on_event   # inline routing + tool dispatch
        if tool_workers > 0:
            from repro_torch.serving.api_executor import AsyncToolRuntime
            engine.async_tools = AsyncToolRuntime(max_workers=tool_workers)
        self.handles: Dict[int, SessionHandle] = {}
        self._rid_counter = itertools.count()

    # -- session intake -------------------------------------------------
    def _rid_taken(self, rid: int) -> bool:
        """O(1): the rid belongs to a session, an admitted request (kv),
        or a legacy request still in the pending-arrivals queue (added
        directly via engine.add_request, admitted at its arrival time)."""
        return (rid in self.handles or rid in self.engine.kv
                or rid in self.engine._pending_rids)

    def _alloc_rid(self) -> int:
        rid = next(self._rid_counter)
        while self._rid_taken(rid):
            rid = next(self._rid_counter)
        return rid

    def submit(self, prompt_ids: Sequence[int],
               sampling: Optional[SamplingParams] = None, *,
               arrival: Optional[float] = None, rid: Optional[int] = None,
               stop_tokens: Sequence[int] = (),
               detector: Optional[Callable] = None,
               max_new_tokens: Optional[int] = None,
               tools: Optional[ToolExecutor] = None,
               kind: str = "tool", duration_hint: float = 0.0,
               controller: Optional[object] = None,
               buffer_events: bool = True) -> SessionHandle:
        """Open a session. ``controller`` overrides the default
        SessionController (advanced: ScriptedClient uses this)."""
        if rid is None:
            rid = self._alloc_rid()
        assert not self._rid_taken(rid), f"rid {rid} already in use"
        if controller is None:
            controller = SessionController(
                stop_tokens=stop_tokens, detector=detector,
                max_new_tokens=max_new_tokens, kind=kind,
                duration_hint=duration_hint)
        req = Request.dynamic(rid, self.engine.now if arrival is None
                              else arrival, list(map(int, prompt_ids)),
                              sampling=sampling, controller=controller)
        handle = SessionHandle(rid=rid, request=req, controller=controller,
                               tools=tools, buffer_events=buffer_events,
                               client=self)
        # alias the engine's speculation log for this rid: _spec_note
        # appends to the same list object, so the handle surfaces
        # accept/reject outcomes live (empty forever when the engine
        # does not speculate)
        handle.speculation = self.engine.spec_log.setdefault(rid, [])
        self.handles[rid] = handle
        if not self.engine.add_request(req):
            # admission backpressure: the RejectedEvent already routed
            # through the sink (handle.state == "rejected"); nothing was
            # allocated engine-side, so drop the dead handle mapping
            self.engine.spec_log.pop(rid, None)
            del self.handles[rid]
        return handle

    # -- the event-drain loop -------------------------------------------
    def _on_event(self, ev: Event):
        """Engine sink, called synchronously at emission: route the event
        to its session and round-trip an attached ToolExecutor the moment
        the intercept fires — the resume lands at the intercept's virtual
        time + tool duration, not after the engine drains."""
        h = self.handles.get(ev.rid)
        if h is None:
            return                     # legacy scripted request, no session
        if h.buffer_events:
            h.events.append(ev)
        if isinstance(ev, TokenEvent):
            h.state = "active"
            # session latency metrics (DESIGN.md §13), on the virtual
            # clock: first token = TTFT from submission arrival, then
            # inter-token gaps (pauses included — the user-visible gap)
            reg = self.engine.metrics
            if h._last_token_t is None:
                reg.observe("session_ttft_s",
                            max(0.0, ev.time - h.request.arrival))
            else:
                reg.observe("session_token_gap_s",
                            max(0.0, ev.time - h._last_token_t))
            h._last_token_t = ev.time
        elif isinstance(ev, FinishEvent):
            h.state = "finished"
        elif isinstance(ev, FailedEvent):
            h.state = "failed"
            h.error = ev.error
        elif isinstance(ev, CancelledEvent):
            h.state = "cancelled"
        elif isinstance(ev, RejectedEvent):
            h.state = "rejected"
        elif isinstance(ev, InterceptEvent):
            h.state = "intercepted"
            if ev.caller_owned and h.tools is not None:
                self._dispatch_tool(h, ev)

    def poll(self, max_steps: int = 100_000, *, strict: bool = False):
        """Advance the engine until it drains or every remaining session
        is blocked on a manual resume(); attached ToolExecutors are
        round-tripped inline as their intercepts fire. Returns the events
        emitted since the last poll as an EventBatch whose ``drained``
        flag is False when the run stopped on step exhaustion instead
        (strict raises) — a truncated stream is never silent."""
        return self.engine.poll(max_steps, strict=strict)

    def _dispatch_tool(self, handle: SessionHandle, ev: InterceptEvent):
        call = ToolCall(rid=handle.rid, kind=ev.kind,
                        seg_idx=handle.request.seg_idx,
                        trigger_token_id=ev.trigger_token_id,
                        context_ids=self.token_ids(handle), time=ev.time,
                        attempt=ev.attempt)
        if self.engine.async_tools is not None:
            # off-thread: the engine injects the completion (or routes the
            # failure through the fault path) at its next plan phase
            self.engine.async_tools.submit(handle.tools, call)
            handle.state = "resuming"
            return
        try:
            res = handle.tools(call)
        except Exception as exc:       # noqa: BLE001 — per-session fault,
            res = ToolError(kind="exception", retryable=False,  # not fatal
                            message=repr(exc))
        if isinstance(res, ToolError):
            # typed failure: the engine retries with backoff or fails the
            # SESSION at its next plan phase — never the engine
            self.engine.post_tool_fault(handle.rid, res)
            handle.state = "resuming"
            return
        # anchor the resume at the intercept's virtual time, not the
        # engine's current clock (identical for inline dispatch at the
        # commit boundary; differs only for retries fired at plan phase)
        self.resume(handle, res.token_ids,
                    delay=max(0.0, (call.time + res.duration)
                              - self.engine.now))

    # -- the caller's side of the intercept/resume boundary -------------
    def intercept(self, handle: SessionHandle,
                  duration_hint: Optional[float] = None,
                  kind: Optional[str] = None):
        """Request an interception; takes effect at the session's next
        sampled-token boundary."""
        handle.controller.request_intercept(duration_hint, kind)

    def finish(self, handle: SessionHandle):
        """End the session at its next sampled-token boundary."""
        handle.controller.request_finish()

    def cancel(self, handle: SessionHandle, *, reason: str = "client"):
        """Tear the session down from any lifecycle state (DESIGN.md §15):
        queued, running, swapped, mid-swap, intercepted with an in-flight
        tool (the result is discarded on drain), or speculating (the fork
        is freed). Queued engine-side and applied at the next plan phase —
        cancelling from inside an event callback is safe. The handle gets
        a CancelledEvent; accrued byte-seconds land in the ledger's
        ``cancelled`` cause."""
        if handle.done:
            return
        self.engine.cancel_request(handle.rid, reason=reason)

    def resume(self, handle: SessionHandle, returned_token_ids:
               Sequence[int], *, delay: float = 0.0):
        """Complete an interception: the returned ids join the context
        after ``delay`` virtual seconds and decoding requeues."""
        self.engine.resume_request(handle.rid, returned_token_ids,
                                   delay=delay)
        # still paused until the queued resume falls due; the first
        # post-resume TokenEvent flips the state to "active"
        handle.state = "resuming"

    def close(self):
        """Shut down the off-thread tool workers (no-op without
        ``tool_workers``); call when done with a tool_workers client so
        pool threads don't outlive it."""
        self.engine.close()

    # -- stream access ---------------------------------------------------
    def token_ids(self, handle: SessionHandle) -> List[int]:
        """The session's full visible stream (prompt + generated +
        returned tokens)."""
        return list(self.engine.kv[handle.rid].tokens)

    def streams(self) -> Dict[int, List[int]]:
        return {rid: self.token_ids(h) for rid, h in self.handles.items()}


class ScriptedClient:
    """Replays scripted (Table-1) workloads through the session API — the
    legacy closed loop expressed as just another client. Prompt ids and
    returned ids are the same deterministic functions of (rid, seg) the
    legacy engine uses, so streams are bit-identical to Engine.run() on
    the scripted requests (the §11 equivalence pin)."""

    def __init__(self, engine, *, retain_events: bool = False):
        self.client = InferCeptClient(engine)
        # replay is a batch path: events route inline through the sink for
        # state/bookkeeping, but nothing reads the drained batch — don't
        # retain O(total tokens) of event objects unless asked
        engine.buffer_events = retain_events

    def submit(self, requests: Sequence[Request]) -> List[SessionHandle]:
        vocab = self.client.engine.cfg.vocab_size
        handles = []
        for r in requests:
            prompt = (list(map(int, r.prompt_tokens))
                      if r.prompt_tokens is not None
                      else [int(t) for t in
                            prompt_token_ids(r.rid, r.prompt_len, vocab)])
            handles.append(self.client.submit(
                prompt, r.sampling, arrival=r.arrival, rid=r.rid,
                controller=ScriptedController(r.segments),
                buffer_events=False))   # replay never reads handle.events
        return handles

    def replay(self, requests: Sequence[Request],
               max_steps: int = 1_000_000) -> Dict[int, List[int]]:
        """Submit the whole workload, drain it, and return the per-request
        token streams (prompt + generated + returned)."""
        handles = self.submit(requests)
        # strict: step exhaustion raises EngineStepsExhausted rather than
        # falling through to a misleading did-not-drain assertion
        self.client.poll(max_steps, strict=True)
        unfinished = [h.rid for h in handles if not h.finished]
        assert not unfinished, f"sessions did not drain: {unfinished}"
        return {h.rid: self.client.token_ids(h) for h in handles}
