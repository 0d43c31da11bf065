"""Serving launcher for the port: drive the intercept-aware engine through
the session API (DESIGN.md §11), on the CUDA card unless told otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --tiny --policy infercept --requests 8 --rate 2.0 [--device cpu]

Mirrors ``repro.launch.serve``. Two clients share one engine:

  * a ``ScriptedClient`` replays the Table-1 workload — interceptions fire
    by generated-token count and resume from the engine's virtual-time
    stub;
  * one live session with caller-driven interception: a detector pauses it
    mid-generation and a ``WallClockToolExecutor`` round-trips a real
    Python "tool", its measured wall-clock latency becoming the
    interception's virtual duration.

Sampling is greedy: stochastic sampling is not ported yet.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core import POLICIES
from repro_torch.core.request import InterceptDirective, Segment
from repro_torch.obs.export import (format_stats_line, format_summary,
                                    write_trace)
from repro_torch.obs.trace import SpanTracer
from repro_torch.serving.api_executor import (AsyncToolRuntime,
                                              WallClockToolExecutor)
from repro_torch.serving.engine import Engine
from repro_torch.serving.session import InterceptEvent, ScriptedClient
from repro_torch.serving.workloads import make_workload


def scale_to_budget(reqs, max_len: int, *, prompt_cap: int = 0,
                    gen_cap: int = 16, ret_cap: int = 8,
                    max_segments: int = 4):
    """Clamp scripted requests to a demo engine's context budget.
    ``prompt_cap`` defaults to max_len // 4."""
    prompt_cap = prompt_cap or max_len // 4
    for r in reqs:
        r.prompt_len = min(r.prompt_len, prompt_cap)
        if r.prompt_tokens is not None:
            r.prompt_tokens = r.prompt_tokens[:r.prompt_len]
        r.target_ctx = r.prompt_len
        for s in r.segments:
            s.gen_tokens = min(s.gen_tokens, gen_cap)
            if s.interception:
                s.interception.returned_tokens = min(
                    s.interception.returned_tokens, ret_cap)
        r.segments = r.segments[:max_segments]
        if not r.segments:
            r.segments = [Segment(gen_tokens=8, interception=None)]
        elif r.segments[-1].interception is not None:
            r.segments[-1].interception = None
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--policy", default="infercept",
                    choices=sorted(POLICIES))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    ap.add_argument("--no-overlap", action="store_true",
                    help="serial engine step (the pipelined-step oracle, "
                         "DESIGN.md §12)")
    ap.add_argument("--tool-workers", type=int, default=2,
                    help="thread-pool size for off-thread tool execution "
                         "(0 = inline, the live tool blocks the loop)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record per-request spans and write a "
                         "Chrome/Perfetto trace_event JSON")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="print a one-line stats update every N engine "
                         "steps while serving (0 = off)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, tiny=args.tiny)
    reqs = scale_to_budget(
        make_workload(seed=0, n_requests=args.requests, rate_rps=args.rate,
                      max_ctx=args.max_len), args.max_len)

    eng = Engine(cfg, POLICIES[args.policy], page_size=args.page_size,
                 n_pages=args.pages, max_model_len=args.max_len,
                 overlap=not args.no_overlap, device=args.device,
                 tracer=SpanTracer() if args.trace else None)
    if args.tool_workers > 0:
        eng.async_tools = AsyncToolRuntime(max_workers=args.tool_workers)
    scripted = ScriptedClient(eng, retain_events=True)
    handles = scripted.submit(reqs)
    client = scripted.client

    # one live session: the caller intercepts at the 8th generated token
    # and a real Python tool supplies the returned ids
    def detector(req, tid, now):
        if req.output_tokens == 8 and req.seg_idx == 0:
            return InterceptDirective(kind="tool", duration_hint=0.1,
                                      reason="detector")
        return None

    def calculator(call):
        return [(call.trigger_token_id or 0) % cfg.vocab_size, 7, 42]

    live = client.submit(list(range(32)), detector=detector,
                         max_new_tokens=24,
                         tools=WallClockToolExecutor(calculator))

    t0 = time.perf_counter()
    if args.stats_every > 0:
        events = []
        while True:
            batch = client.poll(args.stats_every)
            events.extend(batch)
            print(format_stats_line(eng))
            if batch.drained:
                break
    else:
        events = client.poll()
    wall = time.perf_counter() - t0
    finished = [h for h in handles + [live] if h.finished]
    intercepts = sum(isinstance(e, InterceptEvent) for e in events)
    print(f"policy={args.policy} device={eng.device} "
          f"finished={len(finished)}/{len(handles) + 1} "
          f"events={len(events)} intercepts={intercepts} "
          f"virtual_time={eng.now:.2f}s wall={wall:.1f}s")
    st = eng.sched.stats
    print(f"decode_tokens={st.decode_tokens} recompute={st.recompute_tokens} "
          f"fresh={st.fresh_tokens} swapped_out={st.swapped_out_tokens} "
          f"preserves={st.preserves} discards={st.discards}")
    print(format_summary(eng))
    print(f"live session: state={live.state} "
          f"stream_len={len(client.token_ids(live))} "
          f"out={live.request.output_tokens}tok "
          f"paused={live.request.paused_time * 1e3:.2f}ms")
    if args.trace:
        n = write_trace(eng.tracer, args.trace)
        print(f"wrote {n} trace events to {args.trace}")
    eng.close()


if __name__ == "__main__":
    main()
