"""Request state machine for augmented-LLM serving.

A request's lifetime is a sequence of segments: generate n tokens, then hit
an interception (tool call / human turn / model call), whose completion
appends returned tokens to the context, then generate again, ... until done.
This mirrors the paper's workload model (§2.2): per-request number of
interceptions, interception durations, and context lengths.

Two construction paths feed the same machinery (DESIGN.md §11):

  * scripted — the legacy closed loop: every segment's length and
    interception are fixed up front (``Request(segments=[...])``), and the
    scheduler fires interceptions by generated-token count.
  * dynamic  — the session API: the request starts with ONE open-ended
    segment (``gen_tokens=None``) and a ``controller`` that is consulted at
    every sampled-token boundary; interceptions are requested by the caller
    (explicit, stop-token, or detector) and ``close_segment`` fixes the
    segment's length at the tokens actually generated. Scripted segments
    are thereby just a pre-materialized special case.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional


class Phase(enum.Enum):
    WAITING = "waiting"        # in the waiting queue (new / discarded / evicted)
    RUNNING = "running"        # decoding, full context on device
    PAUSED = "paused"          # interception in flight
    SWAPQ = "swapq"            # resumed but context (partially) in host memory
    FINISHED = "finished"
    CANCELLED = "cancelled"    # torn down by the caller (terminal)
    FAILED = "failed"          # terminal tool failure (retries exhausted)


@dataclasses.dataclass
class Interception:
    kind: str                  # math | qa | ve | chatbot | image | tts | tool
    duration: float            # oracle duration (sim ground truth / hint)
    returned_tokens: int       # tokens appended to the context on completion


@dataclasses.dataclass
class Segment:
    # None = open-ended (dynamic session segment, length fixed at the
    # caller's intercept/finish via close_segment)
    gen_tokens: Optional[int]
    interception: Optional[Interception]   # None for the final segment

    @property
    def open(self) -> bool:
        return self.gen_tokens is None


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration, applied ON DEVICE by the fused
    path (models.model.sample_tokens). temperature <= 0 means greedy argmax
    (the legacy behavior and the differential oracle); top_k <= 0 means the
    full vocabulary; top_p outside (0, 1) disables nucleus filtering.
    top_k and top_p compose (both masks apply, vLLM-style: the nucleus is
    taken over the temperature-scaled distribution). Sampling noise is
    keyed only by (seed, position), so a request's stream is independent
    of batch composition and scheduling policy — the §6 equivalence
    property survives stochastic sampling."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # --- per-request tool fault policy (DESIGN.md §15) -------------------
    # Defaults for every interception of this request; an
    # InterceptDirective overrides them per call. tool_timeout_s is a
    # virtual-time deadline per attempt (None = wait forever, the legacy
    # behavior); tool_retries bounds retry-with-exponential-backoff
    # (attempt i waits tool_backoff_s * 2**i after a retryable failure).
    tool_timeout_s: Optional[float] = None
    tool_retries: int = 0
    tool_backoff_s: float = 0.05

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclasses.dataclass
class InterceptDirective:
    """A controller's request to intercept at the current token boundary.

    ``returned_tokens`` is set only by scripted controllers (the engine's
    virtual-time stub then completes the call with that many deterministic
    ids); None means the caller owns the resume and will provide the actual
    returned ids out of band (Engine.resume_request)."""
    kind: str = "tool"
    duration_hint: float = 0.0
    returned_tokens: Optional[int] = None
    reason: str = "explicit"   # explicit | stop_token | detector | scripted
    # Per-call fault policy; None = inherit the request's SamplingParams
    # defaults (tool_timeout_s / tool_retries / tool_backoff_s).
    timeout_s: Optional[float] = None
    max_retries: Optional[int] = None
    backoff_s: Optional[float] = None


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    segments: List[Segment]
    # Explicit prompt token ids (shared-prefix / agent workloads, sessions).
    # None = synthesize unique-per-rid ids (engine) or an anonymous stream
    # (sim), which makes cross-request prefix sharing impossible by
    # construction.
    prompt_tokens: Optional[List[int]] = None
    # Per-request sampling parameters; None = greedy (legacy oracle).
    sampling: Optional[SamplingParams] = None
    # Session controller (duck-typed: on_token(req, token_id, now) ->
    # None | "finish" | InterceptDirective), consulted by the engine at
    # every sampled-token boundary. None = scripted closed-loop request.
    controller: Optional[Any] = None

    # --- dynamic token accounting -----------------------------------------
    seg_idx: int = 0
    gen_in_seg: int = 0
    target_ctx: int = 0        # tokens the context must hold to keep decoding
    device_tokens: int = 0     # KV resident in device HBM
    host_tokens: int = 0       # KV swapped out to host memory

    # --- scheduling state ---------------------------------------------------
    phase: Phase = Phase.WAITING
    arrival_key: float = 0.0   # FCFS key (policy-dependent on re-queue)
    t_call: float = 0.0        # when the current interception started
    current_int: Optional[Interception] = None
    pending_swap_out: int = 0  # tokens still assigned to budgeted swap-out
    decision: str = ""         # last interception decision (metrics)

    # --- metrics -------------------------------------------------------------
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    paused_time: float = 0.0
    output_tokens: int = 0

    def __post_init__(self):
        self.target_ctx = self.prompt_len
        self.arrival_key = self.arrival
        if self.prompt_tokens is not None:
            assert len(self.prompt_tokens) == self.prompt_len, \
                "prompt_tokens length must equal prompt_len"

    @classmethod
    def dynamic(cls, rid: int, arrival: float, prompt_tokens: List[int], *,
                sampling: Optional[SamplingParams] = None,
                controller: Optional[Any] = None) -> "Request":
        """A session-driven request: one open segment, grown as the caller
        drives the intercept/resume lifecycle."""
        return cls(rid=rid, arrival=arrival, prompt_len=len(prompt_tokens),
                   segments=[Segment(gen_tokens=None, interception=None)],
                   prompt_tokens=list(prompt_tokens), sampling=sampling,
                   controller=controller)

    # ------------------------------------------------------------------
    @property
    def to_compute(self) -> int:
        """Tokens whose KV must be (re)computed before decoding resumes."""
        return self.target_ctx - self.device_tokens - self.host_tokens

    @property
    def context_ready(self) -> bool:
        return self.device_tokens == self.target_ctx

    @property
    def total_output(self) -> int:
        return sum(s.gen_tokens or 0 for s in self.segments)

    def current_segment(self) -> Segment:
        return self.segments[self.seg_idx]

    # ------------------------------------------------------------------
    def advance_decode(self, now: float) -> Optional[Interception]:
        """Account one decoded token; returns the interception hit, if any.
        Open (session) segments never fire here — their boundaries come
        from the controller via close_segment."""
        assert self.phase == Phase.RUNNING and self.context_ready
        self.target_ctx += 1
        self.device_tokens += 1
        self.gen_in_seg += 1
        self.output_tokens += 1
        if self.first_token_time is None:
            self.first_token_time = now
        seg = self.current_segment()
        if not seg.open and self.gen_in_seg >= seg.gen_tokens:
            return seg.interception     # may be None (request finished)
        return None

    def close_segment(self, interception: Optional[Interception]):
        """Dynamic sessions only: fix the open segment's length at the
        tokens actually generated and attach the interception that ended it
        (None = the session is finishing). Behind an interception a fresh
        open segment is appended so decoding can continue after resume."""
        seg = self.current_segment()
        assert seg.open, "close_segment on a scripted segment"
        seg.gen_tokens = self.gen_in_seg
        seg.interception = interception
        if interception is not None:
            self.segments.append(Segment(gen_tokens=None, interception=None))

    def segment_done(self, now: float):
        """Advance past the completed segment (interception or finish)."""
        seg = self.current_segment()
        if seg.interception is None:
            self.phase = Phase.FINISHED
            self.finish_time = now
            return
        self.seg_idx += 1
        self.gen_in_seg = 0

    def resume(self, now: float, n_returned: Optional[int] = None):
        """Interception completed: append returned tokens to the context.
        ``n_returned`` is the actual count delivered (session resumes);
        None falls back to the scripted interception's declared count."""
        assert self.current_int is not None
        if n_returned is None:
            n_returned = self.current_int.returned_tokens
        self.target_ctx += n_returned
        self.paused_time += now - self.t_call
        self.current_int = None

    # ------------------------------------------------------------------
    def latency_metrics(self):
        assert self.finish_time is not None
        e2e = self.finish_time - self.arrival - self.paused_time
        return {"e2e": e2e,
                "normalized": e2e / max(1, self.output_tokens),
                "ttft": None if self.first_token_time is None
                else self.first_token_time - self.arrival,
                "output_tokens": self.output_tokens}


# ----------------------------------------------------------------------
# lifecycle enforcement seam (DESIGN.md §16)
# ----------------------------------------------------------------------
def _phase_get(self) -> Phase:
    return self.__dict__["_phase"]


def _phase_set(self, new: Phase) -> None:
    old = self.__dict__.get("_phase")
    if old is not None and new is not old:
        checker = self.__dict__.get("_lifecycle")
        if checker is not None:
            checker.on_transition(self, old, new)
    self.__dict__["_phase"] = new


# Installed AFTER the dataclass is created, so the generated __init__'s
# ``self.phase = phase`` routes through the setter (old=None -> the
# initial assignment is always legal). A checker is attached per-request
# (``req.__dict__["_lifecycle"] = LifecycleChecker()``) only under
# sanitize=True; the default path costs one dict lookup per phase write
# and allocates nothing. Storage lives in ``__dict__["_phase"]`` so
# copy/pickle/asdict keep working through the normal attribute protocol.
Request.phase = property(_phase_get, _phase_set)
