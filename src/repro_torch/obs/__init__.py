"""Waste-attribution telemetry (DESIGN.md §13).

Four pieces, threaded through the serving stack:

  * ``MetricsRegistry`` (metrics.py) — counters / gauges / fixed-bucket
    virtual-time histograms. The engine's ad-hoc ``counters`` dict and the
    scheduler's ``SchedulerStats`` are thin compatibility views over one
    shared registry, so every legacy read keeps working while a single
    ``to_prometheus()`` dump exposes the whole stack.
  * ``SpanTracer`` / ``NullTracer`` (trace.py) — per-request virtual-clock
    lifecycle spans (queued, prefill chunk, decode, swap, swapped-wait)
    plus engine-track pipeline/DMA/idle spans and tool-call async spans.
    ``NullTracer`` is the default: every emission site is guarded on
    ``tracer.enabled`` so the hot path stays allocation-free, and an
    identity test pins streams + counters bit-identical tracing on/off.
  * ``WasteLedger`` (ledger.py) — charges every wasted GPU byte-second to
    a cause (recompute / swap_stall / preserve_pinned / pipeline_bubble /
    tool_unoverlapped) and records per-intercept Eq. 5 branch waste,
    predicted vs realized (the §4.4 estimator-accuracy substrate).
    ``sim/simulator.py`` mirrors the same ledger bit-consistently.
  * exporters (export.py) — Chrome/Perfetto ``trace_event`` JSON, a
    Prometheus text dump, and the human-readable summary table; check.py
    is the CI smoke that loads a trace + breakdown back and re-asserts
    the cause-total invariant.

The package __init__ is lazy (PEP 562): ``repro_torch.core.scheduler`` imports
``repro_torch.obs.metrics`` while ``repro_torch.obs.ledger`` imports
``repro_torch.core.waste``, and deferring the submodule imports keeps either
entry order cycle-free.
"""
from __future__ import annotations

_EXPORTS = {
    "MetricsRegistry": "repro_torch.obs.metrics",
    "CounterView": "repro_torch.obs.metrics",
    "Histogram": "repro_torch.obs.metrics",
    "DEFAULT_TIME_EDGES": "repro_torch.obs.metrics",
    "ENGINE_COUNTER_SCHEMA": "repro_torch.obs.metrics",
    "SCHED_COUNTER_SCHEMA": "repro_torch.obs.metrics",
    "EXTRA_COUNTER_SCHEMA": "repro_torch.obs.metrics",
    "WASTE_CAUSE_SCHEMA": "repro_torch.obs.metrics",
    "SpanTracer": "repro_torch.obs.trace",
    "NullTracer": "repro_torch.obs.trace",
    "WasteLedger": "repro_torch.obs.ledger",
    "InterceptRecord": "repro_torch.obs.ledger",
    "WASTE_CAUSES": "repro_torch.obs.ledger",
    "waste_report": "repro_torch.obs.ledger",
    "to_perfetto": "repro_torch.obs.export",
    "write_trace": "repro_torch.obs.export",
    "validate_trace": "repro_torch.obs.export",
    "format_summary": "repro_torch.obs.export",
    "format_stats_line": "repro_torch.obs.export",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
