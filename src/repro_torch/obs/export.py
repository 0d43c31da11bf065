"""Exporters: Perfetto trace JSON, summary table, periodic stats line.

``to_perfetto`` emits Chrome ``trace_event`` JSON (the legacy array
format Perfetto's UI loads directly): one process per group with one
thread ("track") per request / pipeline stage, tool calls as async
("b"/"e") events overlaying the request tracks, instants as "i" events.
Virtual seconds map to microseconds (``ts = t * 1e6``) so the timeline
reads in familiar units. ``validate_trace`` re-checks the schema and the
per-track span discipline (sorted, non-overlapping, balanced asyncs) —
both the test suite and the CI smoke run it on real engine output.
"""
from __future__ import annotations

import json
from typing import Dict, Hashable, List, Tuple

from repro_torch.obs.trace import SpanTracer

_US = 1e6                     # virtual seconds -> trace microseconds

# fixed pids: one "process" per track group so Perfetto groups the
# engine pipeline lanes away from the per-request lanes
_ENGINE_PID = 1
_REQ_PID = 2
_ENGINE_TIDS = {"step": 1, "dma": 2, "tools": 3}


def _locate(track: Tuple[str, Hashable]) -> Tuple[int, int]:
    group, key = track
    if group == "engine":
        return _ENGINE_PID, _ENGINE_TIDS.get(key, 9)
    # request tracks: tid = rid + 1 (tid 0 is reserved by trace viewers)
    return _REQ_PID, int(key) + 1


def to_perfetto(tracer: SpanTracer) -> dict:
    """Convert a SpanTracer's records to a Chrome trace_event object."""
    events: List[dict] = []
    seen: Dict[Tuple[int, int], str] = {}

    def _name_track(pid: int, tid: int, label: str):
        if (pid, tid) not in seen:
            seen[(pid, tid)] = label

    for track, name, t0, t1, args in tracer.spans:
        pid, tid = _locate(track)
        _name_track(pid, tid, f"{track[0]}:{track[1]}")
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "cat": track[0], "ts": t0 * _US, "dur": (t1 - t0) * _US}
        if args:
            ev["args"] = args
        events.append(ev)

    for phase, cat, aid, name, t, args in tracer.asyncs:
        pid, tid = _locate(("req", aid)) if cat == "tool" \
            else (_ENGINE_PID, _ENGINE_TIDS["tools"])
        _name_track(pid, tid, f"req:{aid}" if cat == "tool" else "tools")
        ev = {"ph": phase, "pid": pid, "tid": tid, "name": name,
              "cat": cat, "id": str(aid), "ts": t * _US}
        if args:
            ev["args"] = args
        events.append(ev)

    for track, name, t, args in tracer.instants:
        pid, tid = _locate(track)
        _name_track(pid, tid, f"{track[0]}:{track[1]}")
        ev = {"ph": "i", "pid": pid, "tid": tid, "name": name,
              "cat": track[0], "ts": t * _US, "s": "t"}
        if args:
            ev["args"] = args
        events.append(ev)

    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))

    meta: List[dict] = [
        {"ph": "M", "pid": _ENGINE_PID, "tid": 0, "name": "process_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": _REQ_PID, "tid": 0, "name": "process_name",
         "args": {"name": "requests"}},
    ]
    for (pid, tid), label in sorted(seen.items()):
        meta.append({"ph": "M", "pid": pid, "tid": tid,
                     "name": "thread_name", "args": {"name": label}})

    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def validate_trace(obj: dict) -> List[str]:
    """Schema + span-discipline check on a trace_event object. Returns a
    list of human-readable errors (empty = valid)."""
    errors: List[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]

    tracks: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    async_depth: Dict[Tuple[str, str], int] = {}
    last_ts: Dict[Tuple[int, int], float] = {}

    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "b", "e", "i", "M"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        for key in ("pid", "tid", "name"):
            if key not in ev:
                errors.append(f"event {i} (ph={ph}): missing {key!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"event {i} (ph={ph}): missing/invalid ts")
            continue
        loc = (ev.get("pid"), ev.get("tid"))
        # the stream must be globally ts-sorted per track
        if ts < last_ts.get(loc, float("-inf")) - 1e-6:
            errors.append(
                f"event {i}: ts not monotone on track {loc}")
        last_ts[loc] = max(last_ts.get(loc, float("-inf")), ts)
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: X event missing/negative dur")
                continue
            tracks.setdefault(loc, []).append((ts, ts + dur))
        elif ph in ("b", "e"):
            if "id" not in ev:
                errors.append(f"event {i}: async event missing id")
                continue
            key = (ev.get("cat", ""), ev["id"])
            d = async_depth.get(key, 0) + (1 if ph == "b" else -1)
            if d < 0:
                errors.append(f"event {i}: async end before begin {key}")
            async_depth[key] = d

    for loc, spans in tracks.items():
        spans.sort()
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            # µs-scale epsilon: adjacent spans may share an endpoint
            if b0 < a1 - 1e-6:
                errors.append(
                    f"track {loc}: overlapping spans "
                    f"[{a0:.3f},{a1:.3f}] and [{b0:.3f},{b1:.3f}]")

    for key, d in async_depth.items():
        if d != 0:
            errors.append(f"async {key}: {d} unbalanced begin events")
    return errors


def write_trace(tracer: SpanTracer, path: str) -> int:
    """Export + write a trace file; returns the event count."""
    obj = to_perfetto(tracer)
    with open(path, "w") as f:
        json.dump(obj, f)
    return len(obj["traceEvents"])


# ----------------------------------------------------------------------
# human-readable reporting
# ----------------------------------------------------------------------
def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} TiB"


def _fmt_byteseconds(n: float) -> str:
    return _fmt_bytes(n) + "·s"


def format_stats_line(engine) -> str:
    """One-line periodic stats for the serve loop."""
    led = engine.ledger
    sched = engine.sched
    c = engine.counters
    toks = c.get("decode_tokens", 0) + c.get("prefill_tokens", 0)
    return (f"[t={engine.now:9.3f}s] iters={led.iterations} "
            f"tokens={toks} running={len(sched.running)} "
            f"waiting={len(sched.waiting)} "
            f"paused={sched.paused_device_tokens()}tok "
            f"waste={led.waste_fraction() * 100:5.2f}% "
            f"idle={led.idle_time:.3f}s")


def format_summary(engine) -> str:
    """End-of-run report: throughput, memory traffic, tool overlap, the
    waste-attribution breakdown, and estimator accuracy."""
    led = engine.ledger
    c = engine.counters
    reg = engine.metrics
    lines = []
    add = lines.append

    add("=== engine summary " + "=" * 41)
    add(f"virtual time        {engine.now:.3f} s  "
        f"(busy {led.busy_time:.3f}, idle {led.idle_time:.3f})")
    add(f"forward / stall     {led.forward_time:.3f} s / "
        f"{led.stall_time:.3f} s over {led.iterations} iterations")
    dec, pre = c.get("decode_tokens", 0), c.get("prefill_tokens", 0)
    add(f"tokens              {dec} decode + {pre} prefill")
    if engine.now > 0:
        add(f"throughput          {(dec + pre) / engine.now:.1f} tok/s "
            f"virtual")
    kv = c.get("decode_bytes", 0) + c.get("prefill_bytes", 0)
    add(f"KV traffic          {_fmt_bytes(kv)}"
        + (f"  ({_fmt_bytes(kv / max(1, dec + pre))}/token)"))
    add(f"swap traffic        {_fmt_bytes(c.get('swap_bytes', 0))} "
        f"({_fmt_bytes(c.get('swap_overlap_bytes', 0))} overlapped)")
    tool_s = c.get("tool_seconds", 0.0)
    ov_s = c.get("overlapped_tool_seconds", 0.0)
    pct = 100.0 * ov_s / tool_s if tool_s else 0.0
    add(f"tool time           {tool_s:.3f} s total, {ov_s:.3f} s "
        f"overlapped with serving ({pct:.1f}%)")

    add("--- waste attribution (Eq. 1-5, byte-seconds) " + "-" * 14)
    total = led.total_waste()
    for cause, v in sorted(led.causes.items(), key=lambda kv: -kv[1]):
        share = 100.0 * v / total if total else 0.0
        add(f"  {cause:<18} {_fmt_byteseconds(v):>14}  {share:5.1f}%")
    add(f"  {'total':<18} {_fmt_byteseconds(total):>14}  "
        f"{led.waste_fraction() * 100:5.2f}% of GPU capacity")

    if led.records:
        add("--- intercepts " + "-" * 45)
        branches: dict = {}
        for r in led.records:
            branches[r.branch] = branches.get(r.branch, 0) + 1
        add(f"  n={len(led.records)}  branches: " + ", ".join(
            f"{b}={n}" for b, n in sorted(branches.items())))
        add(f"  predicted waste {_fmt_byteseconds(sum(r.predicted_waste for r in led.records))}"
            f" vs realized {_fmt_byteseconds(sum(r.realized_waste for r in led.records))}")
        h = reg.histograms.get("estimator_abs_err_s")
        if h is not None and h.n:
            add(f"  estimator |err|   mean {h.mean():.4f} s over {h.n}")
        for kind, st in led.estimator_stats().items():
            add(f"    {kind:<14} n={st['n']:<4} "
                f"bias {st['bias_s']:+.4f} s  "
                f"|err| {st['abs_err_s']:.4f} s")

    for name, label in (("session_ttft_s", "TTFT"),
                        ("engine_queue_wait_s", "queue wait"),
                        ("session_token_gap_s", "token gap"),
                        ("engine_swapped_wait_s", "swapped wait")):
        h = reg.histograms.get(name)
        if h is not None and h.n:
            add(f"{label:<19} mean {h.mean():.4f} s  (n={h.n})")
    add("=" * 60)
    return "\n".join(lines)
