"""The metrics registry: counters, gauges, fixed-bucket histograms.

One registry instance spans the whole serving stack (engine, scheduler,
ledger, session client). The pre-existing surfaces stay intact as thin
views over it:

  * ``Engine.counters`` is a ``CounterView`` (a MutableMapping whose
    items live in ``registry.counters`` under an ``engine_`` prefix), so
    ``eng.counters["decode_bytes"] += n`` keeps its exact int arithmetic
    and dict semantics — nothing is copied, nothing is rounded.
  * ``SchedulerStats`` (core/scheduler.py) routes its attributes to
    ``sched_``-prefixed registry counters the same way.

Histograms use FIXED bucket edges declared up front (Prometheus-style
cumulative ``le`` semantics) so merging/diffing dumps across runs is
well-defined; all time-valued observations share ``DEFAULT_TIME_EDGES``
(virtual seconds, log-spaced sub-ms .. minutes).
"""
from __future__ import annotations

import bisect
from collections.abc import MutableMapping
from typing import Dict, Iterable, Optional, Tuple

# virtual-second buckets: sub-millisecond decode iterations up to
# minute-long tool pauses / queue waits
DEFAULT_TIME_EDGES: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# ----------------------------------------------------------------------
# declared key schemas (DESIGN.md §16)
#
# The single source of truth for every counter / waste-cause key the
# stack may write. Consumed by three parties: Engine seeds its counters
# from ENGINE_COUNTER_SCHEMA, the static lint (repro_torch.analysis.lint)
# rejects literal writes of undeclared keys, and CounterView fails fast
# on undeclared runtime writes when the engine runs with sanitize=True.
# ----------------------------------------------------------------------
ENGINE_COUNTER_SCHEMA: Dict[str, float] = {
    "decode_bytes": 0, "decode_tokens": 0,
    "prefill_bytes": 0, "prefill_tokens": 0,
    "swap_bytes": 0, "cow_bytes": 0,
    "device_dispatches": 0, "mixed_iterations": 0,
    "logit_bytes": 0,
    "swap_overlap_bytes": 0,
    "pipeline_bubbles": 0, "pipeline_bubble_s": 0.0,
    "tool_seconds": 0.0, "overlapped_tool_seconds": 0.0,
    "spec_forks": 0, "spec_accepted": 0, "spec_rejected": 0,
    "spec_killed": 0, "spec_prefill_tokens": 0, "spec_decode_tokens": 0,
    "spec_grafted_tokens": 0,
    "tool_faults": 0, "tool_retries": 0, "tool_timeouts": 0,
    "sessions_cancelled": 0, "sessions_failed": 0, "sessions_rejected": 0,
    # quantized KV pools (DESIGN.md §17): pages whose scales were zeroed
    # at free time (scale lifetime == page lifetime) and shared pages
    # whose scales were copied by a COW fork alongside the payload
    "kv_quant_scale_reset_pages": 0, "kv_quant_scale_cow_pages": 0,
}

SCHED_COUNTER_SCHEMA: Tuple[str, ...] = (
    "recompute_tokens", "fresh_tokens", "decode_tokens",
    "swapped_out_tokens", "swapped_in_tokens",
    "discards", "preserves", "swaps", "evictions",
    "cache_hit_tokens", "swap_in_failures", "pool_preempts",
    "cancellations", "tool_failures",
)

# counters written outside the two prefixed views (estimator profiles)
EXTRA_COUNTER_SCHEMA: Tuple[str, ...] = ("estimator_profile_miss",)

WASTE_CAUSE_SCHEMA: Tuple[str, ...] = (
    "recompute", "swap_stall", "preserve_pinned", "pipeline_bubble",
    "tool_unoverlapped", "speculation_wasted", "cancelled", "tool_failed",
)


class Histogram:
    """Fixed-bucket histogram. ``counts[i]`` holds observations with
    ``v <= edges[i]`` (first matching bucket, non-cumulative storage;
    the Prometheus dump re-cumulates); ``counts[-1]`` is the overflow."""

    __slots__ = ("name", "edges", "counts", "total", "n")

    def __init__(self, name: str,
                 edges: Iterable[float] = DEFAULT_TIME_EDGES):
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        assert list(self.edges) == sorted(self.edges), \
            "histogram bucket edges must be sorted"
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, value: float):
        self.counts[bisect.bisect_left(self.edges, value)] += 1
        self.total += value
        self.n += 1

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def __repr__(self):
        return (f"Histogram({self.name}, n={self.n}, "
                f"mean={self.mean():.6g})")


class MetricsRegistry:
    """Counters (monotonic-ish numeric cells), gauges (last-write-wins),
    and histograms, each keyed by a flat string name."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    # -- counters --------------------------------------------------------
    def counter(self, name: str, initial=0):
        """Declare a counter (idempotent); returns its current value."""
        return self.counters.setdefault(name, initial)

    def inc(self, name: str, delta=1):
        self.counters[name] = self.counters.get(name, 0) + delta

    def get(self, name: str, default=0):
        return self.counters.get(name, default)

    def view(self, prefix: str = "", schema=None) -> "CounterView":
        return CounterView(self, prefix, schema)

    # -- gauges ----------------------------------------------------------
    def gauge(self, name: str, value: float):
        self.gauges[name] = value

    # -- histograms ------------------------------------------------------
    def histogram(self, name: str,
                  edges: Iterable[float] = DEFAULT_TIME_EDGES) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, edges)
        return h

    def observe(self, name: str, value: float):
        self.histogram(name).observe(value)

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                n: {"edges": list(h.edges), "counts": list(h.counts),
                    "sum": h.total, "count": h.n}
                for n, h in self.histograms.items()},
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one flat dump; virtual-time
        quantities are plain seconds)."""
        lines = []
        for name in sorted(self.counters):
            lines.append(f"# TYPE {_prom_name(name)} counter")
            lines.append(f"{_prom_name(name)} {_prom_val(self.counters[name])}")
        for name in sorted(self.gauges):
            lines.append(f"# TYPE {_prom_name(name)} gauge")
            lines.append(f"{_prom_name(name)} {_prom_val(self.gauges[name])}")
        for name in sorted(self.histograms):
            h = self.histograms[name]
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} histogram")
            cum = 0
            for edge, c in zip(h.edges, h.counts):
                cum += c
                lines.append(f'{pn}_bucket{{le="{edge:g}"}} {cum}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {h.n}')
            lines.append(f"{pn}_sum {_prom_val(h.total)}")
            lines.append(f"{pn}_count {h.n}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_val(v) -> str:
    return repr(int(v)) if isinstance(v, bool) else repr(v)


class CounterView(MutableMapping):
    """Dict-compatible view over a registry's counters under a fixed key
    prefix. ``view[k]`` is exactly ``registry.counters[prefix + k]`` —
    same Python number objects, so ``view["x"] += 1`` preserves int
    arithmetic bit-for-bit and legacy code/tests that treat
    ``engine.counters`` as a plain dict keep working unchanged.

    With ``schema`` set (sanitize=True), writes of undeclared keys raise
    immediately — the runtime twin of the lint rule. ``schema=None``
    (the default) adds zero per-write overhead beyond one ``is None``."""

    __slots__ = ("_reg", "_prefix", "_schema")

    def __init__(self, registry: MetricsRegistry, prefix: str = "",
                 schema=None):
        self._reg = registry
        self._prefix = prefix
        self._schema = None if schema is None else frozenset(schema)

    @property
    def registry(self) -> MetricsRegistry:
        return self._reg

    def __getitem__(self, key):
        return self._reg.counters[self._prefix + key]

    def __setitem__(self, key, value):
        if self._schema is not None and key not in self._schema:
            raise KeyError(
                f"undeclared counter key {key!r} (prefix {self._prefix!r}) — "
                "declare it in the repro_torch.obs.metrics schema")
        self._reg.counters[self._prefix + key] = value

    def __delitem__(self, key):
        del self._reg.counters[self._prefix + key]

    def __iter__(self):
        p = self._prefix
        return (k[len(p):] for k in list(self._reg.counters)
                if k.startswith(p))

    def __len__(self):
        return sum(1 for _ in self)

    def __repr__(self):
        return f"CounterView({self._prefix!r}, {dict(self)!r})"
