"""Per-request span tracing on the virtual clock.

A span tracer records three event shapes, all timestamped in virtual
seconds (the engine's cost-model clock, so traces are bit-reproducible):

  * complete spans — ``span(track, name, t0, t1, args)``: one lifecycle
    phase of one track. Request tracks (``("req", rid)``) carry queued /
    swapped_wait / prefill / decode / swap_out / swap_in spans; the
    engine tracks carry per-iteration ``iter`` and ``idle`` spans
    (``("engine", "step")``) and staged-DMA windows
    (``("engine", "dma")``). Spans on one track never overlap — the
    export validator enforces it.
  * async spans — ``async_begin``/``async_end``: tool-call windows
    ``[t_call, resume]``, which DO overlap request-track swap spans (a
    paused context can be swapping while its tool runs), so they live in
    Chrome's async-event namespace keyed by (cat, id). The end event
    carries the intercept's Eq. 5 branch and its predicted vs realized
    waste charge.
  * instants — point markers (discard, resume, swap_in_failed).

``NullTracer`` is the engine default: ``enabled`` is False and every
method is a no-op, so tracing-off runs allocate nothing — emission sites
guard arg-dict construction on ``tracer.enabled``.
"""
from __future__ import annotations

from typing import Hashable, Optional, Tuple

Track = Tuple[str, Hashable]          # (group, key): ("req", rid), ...


class SpanTracer:
    enabled = True

    def __init__(self):
        # (track, name, t0, t1, args)
        self.spans: list = []
        # (phase "b"|"e", cat, id, name, t, args)
        self.asyncs: list = []
        # (track, name, t, args)
        self.instants: list = []

    def span(self, track: Track, name: str, t0: float, t1: float,
             args: Optional[dict] = None):
        if t1 > t0:
            self.spans.append((track, name, t0, t1, args))

    def async_begin(self, cat: str, aid: Hashable, name: str, t: float,
                    args: Optional[dict] = None):
        self.asyncs.append(("b", cat, aid, name, t, args))

    def async_end(self, cat: str, aid: Hashable, name: str, t: float,
                  args: Optional[dict] = None):
        self.asyncs.append(("e", cat, aid, name, t, args))

    def instant(self, track: Track, name: str, t: float,
                args: Optional[dict] = None):
        self.instants.append((track, name, t, args))

    def __len__(self):
        return len(self.spans) + len(self.asyncs) + len(self.instants)


class NullTracer(SpanTracer):
    """The allocation-free default: records nothing."""
    enabled = False

    def __init__(self):          # no lists
        pass

    def span(self, track, name, t0, t1, args=None):
        pass

    def async_begin(self, cat, aid, name, t, args=None):
        pass

    def async_end(self, cat, aid, name, t, args=None):
        pass

    def instant(self, track, name, t, args=None):
        pass

    def __len__(self):
        return 0
