"""Tool ("API") execution at the serving boundary (the paper's Fig. 6).

Two halves, matching the session redesign (DESIGN.md §11):

  * ``ToolExecutor`` — the CALLER-side protocol: a callable that receives a
    ``ToolCall`` (what the model asked for, with its visible context) and
    returns a ``ToolResult`` (the tokens to append and how long the call
    took in virtual seconds). ``InferCeptClient`` invokes a session's
    executor when it drains an ``InterceptEvent`` and feeds the result back
    through ``Engine.resume_request`` — interception and resume are driven
    from outside the engine, exactly the API/executor split the paper
    draws. Implementations here:
      - ``VirtualTimeToolExecutor`` — deterministic stub: returned ids are
        a pure function of (rid, seg_idx), duration is fixed. Reproducible
        runs, the basis of the policy-equivalence tests.
      - ``WallClockToolExecutor`` — wraps a real Python callable; its
        measured wall-clock latency becomes the interception's virtual
        duration, so a live tool loop experiences the same scheduling the
        paper models.

  * ``ScriptedToolRuntime`` — the ENGINE-side virtual-time completion
    tracker for scripted interceptions (legacy closed loop and the
    ScriptedClient replay path): completion times come from the request
    script (Table-1-calibrated) and returned tokens are a deterministic
    function of (rid, segment), so serving runs are exactly reproducible
    across scheduling policies.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.request import Interception, Request


def returned_token_ids(rid: int, seg_idx: int, n: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng((rid * 1_000_003 + seg_idx * 7919) % 2**31)
    return rng.integers(0, vocab, size=n, dtype=np.int64)


def prompt_token_ids(rid: int, n: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng((rid * 2_654_435_761 + 17) % 2**31)
    return rng.integers(0, vocab, size=n, dtype=np.int64)


# ---------------------------------------------------------------------------
# caller-side protocol
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ToolCall:
    """What the session hands the caller's executor at an interception."""
    rid: int
    kind: str
    seg_idx: int                       # interception index within the session
    trigger_token_id: Optional[int]    # the sampled id that fired (consumed)
    context_ids: List[int]             # the session's visible token stream
    time: float                        # engine virtual time of the intercept
    attempt: int = 0                   # retry attempt (0 = first dispatch)


@dataclasses.dataclass(frozen=True)
class ToolResult:
    token_ids: List[int]               # appended to the context on resume
    duration: float = 0.0              # virtual seconds the call took


@dataclasses.dataclass(frozen=True)
class ToolError:
    """Typed tool failure: the other half of the executor outcome union
    ``ToolResult | ToolError``. ``retryable`` gates the engine's bounded
    retry-with-backoff policy (a non-retryable error, or one that exhausts
    ``max_retries``, terminally fails the SESSION — never the engine).
    ``duration`` is how long the failing attempt took in virtual seconds
    before it failed (charged to the session's pause like a success)."""
    kind: str                          # e.g. "unavailable", "exception", "timeout"
    retryable: bool = True
    message: str = ""
    duration: float = 0.0


ToolOutcome = Union[ToolResult, ToolError]

# A ToolExecutor is any callable ToolCall -> ToolResult (or ToolError for
# executors that participate in the typed fault protocol; raising is also
# tolerated and mapped to a non-retryable ToolError by the runtime).
ToolExecutor = Callable[[ToolCall], ToolResult]


class VirtualTimeToolExecutor:
    """Deterministic caller-side stub: returned ids are the same pure
    function of (rid, seg_idx) the engine's scripted runtime uses, and the
    call takes a fixed virtual ``duration`` — runs are bit-reproducible."""

    def __init__(self, vocab: int, *, n_tokens: int = 8,
                 duration: float = 0.05):
        self.vocab = vocab
        self.n_tokens = n_tokens
        self.duration = duration

    def __call__(self, call: ToolCall) -> ToolResult:
        ids = returned_token_ids(call.rid, call.seg_idx, self.n_tokens,
                                 self.vocab)
        return ToolResult(token_ids=[int(t) for t in ids],
                          duration=self.duration)


class WallClockToolExecutor:
    """Runs a real tool: ``fn(ToolCall) -> token id sequence``. The
    measured wall-clock latency of ``fn`` becomes the interception's
    virtual duration (floored at ``min_duration`` so the scheduler always
    sees a positive pause), coupling the engine's virtual clock to real
    tool latency."""

    def __init__(self, fn: Callable[[ToolCall], Sequence[int]], *,
                 min_duration: float = 1e-6):
        self.fn = fn
        self.min_duration = min_duration

    def __call__(self, call: ToolCall) -> ToolResult:
        t0 = time.perf_counter()  # lint: allow(wall-clock-rng): measured tool latency becomes the virtual pause
        ids = self.fn(call)
        dt = time.perf_counter() - t0  # lint: allow(wall-clock-rng): measured tool latency becomes the virtual pause
        return ToolResult(token_ids=[int(t) for t in ids],
                          duration=max(self.min_duration, dt))


class ChaosToolExecutor:
    """Deterministic fault injection around a real executor (the chaos
    harness of DESIGN.md §15). Every decision is a pure function of
    ``(seed, rid, seg_idx, attempt)`` — NOT of wall clock, drain order, or
    batch composition — so a chaos run is exactly reproducible and the
    blast-radius tests can diff unaffected sessions' streams against a
    fault-free run bit-for-bit.

    Per call, one uniform draw u selects the outcome band:
      u < failure_rate                      -> ToolError("unavailable",
                                               retryable=True) after
                                               ``failure_latency`` virtual s
      u < failure_rate + timeout_rate       -> the call "hangs": the inner
                                               result is returned but with
                                               its virtual duration inflated
                                               past any plausible deadline
                                               (``hang_s``), so the engine's
                                               virtual-time timeout fires and
                                               the late result is discarded
      otherwise                             -> inner result, with duration
                                               scaled by ``latency_mult``

    Retries see a fresh draw (attempt is in the key), so a failed call can
    succeed on retry — the recovery path the soak exercises."""

    def __init__(self, inner: ToolExecutor, *, seed: int,
                 failure_rate: float = 0.0, timeout_rate: float = 0.0,
                 latency_mult: float = 1.0, failure_latency: float = 0.01,
                 hang_s: float = 1e6, retryable: bool = True):
        self.inner = inner
        self.seed = int(seed)
        self.failure_rate = float(failure_rate)
        self.timeout_rate = float(timeout_rate)
        self.latency_mult = float(latency_mult)
        self.failure_latency = float(failure_latency)
        self.hang_s = float(hang_s)
        self.retryable = bool(retryable)

    def _draw(self, call: ToolCall) -> float:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, call.rid, call.seg_idx,
                                    call.attempt]))
        return float(rng.random())

    def __call__(self, call: ToolCall) -> ToolOutcome:
        u = self._draw(call)
        if u < self.failure_rate:
            return ToolError(kind="unavailable", retryable=self.retryable,
                             message=f"injected failure (u={u:.3f})",
                             duration=self.failure_latency)
        res = self.inner(call)
        if isinstance(res, ToolError):
            return res
        if u < self.failure_rate + self.timeout_rate:
            return ToolResult(token_ids=res.token_ids,
                              duration=res.duration + self.hang_s)
        if self.latency_mult != 1.0:
            return ToolResult(token_ids=res.token_ids,
                              duration=res.duration * self.latency_mult)
        return res


class AsyncToolRuntime:
    """Off-thread tool execution for the pipelined engine step (DESIGN.md
    §12): ToolExecutor calls run on a thread pool, so a slow tool no
    longer blocks the engine's wall-clock step loop — unrelated sessions
    keep decoding while the tool is in flight.

    The client submits here instead of calling the executor inline; the
    engine drains completed calls at every plan phase and injects them
    through ``Engine.resume_request``, anchored at the intercept's virtual
    time plus the tool's reported duration — the same anchor the inline
    dispatch uses, so virtual-time accounting is unchanged and only the
    wall-clock serialization disappears. Completions are injected in
    deterministic (intercept time, rid) order. Worker threads never touch
    engine state; injection happens on the engine's thread."""

    def __init__(self, max_workers: int = 4):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="tool")
        self._futures = {}                 # Future -> ToolCall
        self._discarded = set()            # rids whose results must be dropped

    @property
    def inflight(self) -> int:
        return len(self._futures)

    def submit(self, executor: ToolExecutor, call: ToolCall):
        self._futures[self._pool.submit(executor, call)] = call

    def discard(self, rid: int):
        """Mark a session's in-flight calls as abandoned (cancellation /
        terminal failure): their results are silently dropped at the next
        ``drain`` instead of resuming a torn-down session. The worker
        thread is not interrupted — it finishes into the void."""
        if any(c.rid == rid for c in self._futures.values()):
            self._discarded.add(rid)

    def drain(self):
        """Non-blocking: returns (completed, failed) — completed
        (call, ToolResult | ToolError) pairs in deterministic
        (intercept time, rid) order, failed (call, exception) pairs for
        executors that raised. Separating the two keeps the pop
        transactional: one raising executor cannot discard other sessions'
        completed results (the engine injects every completion first, THEN
        routes the failure through the per-session fault path). Results
        for ``discard``-ed rids are dropped here."""
        done = [f for f in list(self._futures) if f.done()]
        out, failed = [], []
        for f in done:
            call = self._futures.pop(f)
            if call.rid in self._discarded:
                if not any(c.rid == call.rid for c in self._futures.values()):
                    self._discarded.discard(call.rid)
                continue
            try:
                out.append((call, f.result()))
            except BaseException as exc:        # noqa: BLE001 — routed to
                failed.append((call, exc))      # the fault path, not lost
        out.sort(key=lambda cr: (cr[0].time, cr[0].rid))
        failed.sort(key=lambda ce: (ce[0].time, ce[0].rid))
        return out, failed

    def wait_any(self, timeout: Optional[float] = None):
        """Block until at least one in-flight call completes (the engine's
        idle path: nothing schedulable, everything gated on a tool)."""
        if self._futures:
            concurrent.futures.wait(
                list(self._futures), timeout=timeout,
                return_when=concurrent.futures.FIRST_COMPLETED)

    def shutdown(self):
        self._pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# speculative resume: tool-result prediction (DESIGN.md §14)
# ---------------------------------------------------------------------------
class ToolResultPredictor:
    """Protocol for speculative resume past intercepts: at an interception
    the engine asks the predictor what token ids the tool is EXPECTED to
    return; a non-None prediction COW-forks the sequence and keeps decoding
    against it while the real tool runs. On resume the actual returned ids
    are validated against the prediction — exact match grafts the fork
    (re-prefill skipped), any mismatch frees it and falls back to the
    baseline path bit-identically.

    ``predict(rid, kind, seg_idx, n_hint)`` returns the predicted token id
    list, or None to skip speculation for this interception. ``n_hint`` is
    the scripted interception's declared returned-token count when known
    (session intercepts pass the directive's hint), 0 otherwise.
    Subclasses below cover the spectrum: templated per-kind returns (the
    common "tool echoes a fixed acknowledgement" case) and a deterministic
    oracle (upper bound / tests)."""

    def predict(self, rid: int, kind: str, seg_idx: int,
                n_hint: int) -> Optional[List[int]]:
        raise NotImplementedError


class TemplateToolResultPredictor(ToolResultPredictor):
    """Predicts a fixed per-kind token template (e.g. an empty/templated
    tool acknowledgement). Kinds absent from ``templates`` are not
    speculated. Acceptance then measures how often the tool actually
    returned its template."""

    def __init__(self, templates: dict):
        self.templates = {k: [int(t) for t in v]
                          for k, v in templates.items()}

    def predict(self, rid, kind, seg_idx, n_hint):
        tpl = self.templates.get(kind)
        return list(tpl) if tpl else None


class OracleToolResultPredictor(ToolResultPredictor):
    """Predicts exactly what the deterministic scripted runtime will
    return (``returned_token_ids``) — 100% acceptance by construction.
    The speculative-resume upper bound for benchmarks, and the fixture
    that pins the graft path in tests."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def predict(self, rid, kind, seg_idx, n_hint):
        if n_hint <= 0:
            return None
        return [int(t) for t in
                returned_token_ids(rid, seg_idx, n_hint, self.vocab)]


# ---------------------------------------------------------------------------
# engine-side scripted completions
# ---------------------------------------------------------------------------
class ScriptedToolRuntime:
    """Tracks in-flight scripted interceptions and their virtual-time
    completions (durations and returned-token counts known up front)."""

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.inflight = {}   # rid -> (completion_time, req, interception)

    def launch(self, req: Request, intc: Interception, now: float):
        self.inflight[req.rid] = (now + intc.duration, req, intc)

    def completions(self, now: float):
        """Pop all interceptions completed by ``now``; returns
        [(req, returned_token_ids, completion_time)] in completion
        order."""
        done = sorted((t, rid) for rid, (t, _, _) in self.inflight.items()
                      if t <= now)
        out = []
        for t, rid in done:
            _, req, intc = self.inflight.pop(rid)
            toks = returned_token_ids(req.rid, req.seg_idx,
                                      intc.returned_tokens, self.vocab)
            out.append((req, toks, t))
        return out

    def next_completion_time(self):
        if not self.inflight:
            return None
        return min(t for t, _, _ in self.inflight.values())


# Backwards-compatible name: the runtime was the whole "API executor"
# before the caller-side protocol existed.
APIExecutor = ScriptedToolRuntime
