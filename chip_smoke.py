#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, agrees with its plain
versions, and serves.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases kernels

Phases; any failure ends the run with a non-zero exit and no result line:
  1. card     — name and power limit from nvidia-smi; no CUDA card: exit 2
  2. build    — nvcc every csrc/*.cu for sm_90a, load the library
  3. kernels  — each kernel against its plain version on the card, at
                llama3.2-1b's widths (Hkv 8, G 4, hd 64, page 16) in bf16
                and f32, plus edge cases
  4. tiny     — tiny-config f32 forward_mixed_paged, kernels on the card
                against plain versions on the CPU, same weights and pools
  5. serve    — full-width llama3.2-1b in bf16, random weights from a seed,
                agent sessions through ScriptedClient under InferCept
  6. swap     — the same under the swap policy, so pages cross to the host
  7. timing   — each kernel, its plain version and the one-call PyTorch
                yardstick, timed with CUDA events on the inputs the serve
                runs gave it; bound from those inputs
  8. profile  — torch.profiler over a window of serve steps: device busy
                share and device time by kernel

Launch counts are read from the kernel wrappers: set to 0 just before
each serve run and read just after it. The second-to-last line is the
kernels JSON; the last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("kernels", "tiny", "serve", "swap", "timing", "profile")

# NVIDIA H100 SXM data sheet peaks (dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    import torch
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        line = smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        line = "nvidia-smi unavailable"
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one card",
              file=sys.stderr)
        sys.exit(2)
    return line


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, iters: int):
    """plain, kernel, kernel, plain; the faster of each pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return min(k1, k2), min(p1, p2)


def ragged_inputs(gen, *, N, B, Hkv, G, hd, page, max_pages, n_pages,
                  dtype, device, tok_seq=None, tok_pos=None):
    import torch
    q = torch.randn((N, Hkv, G, hd), generator=gen, device=device).to(dtype)
    kp = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                     device=device).to(dtype)
    vp = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                     device=device).to(dtype)
    bt = torch.randint(0, n_pages, (B, max_pages), generator=gen,
                       device=device, dtype=torch.int32)
    if tok_seq is None:
        tok_seq = torch.randint(0, B, (N,), generator=gen, device=device,
                                dtype=torch.int32)
    if tok_pos is None:
        tok_pos = torch.randint(0, page * max_pages, (N,), generator=gen,
                                device=device, dtype=torch.int32)
    return q, kp, vp, bt, tok_seq.to(device), tok_pos.to(device)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels() -> dict:
    import torch
    from repro_torch.kernels.kv_append import kv_append, kv_append_ref
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)
    from repro_torch.kernels.swap_pack import (swap_pack, swap_pack_ref,
                                               swap_unpack, swap_unpack_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    worst = {"ragged_paged_attention": 0.0, "kv_append": 0.0,
             "swap_pack": 0.0, "swap_unpack": 0.0}

    def ragged_case(label, dtype, **kw):
        window, softcap = kw.pop("window", None), kw.pop("softcap", None)
        args = ragged_inputs(gen, dtype=dtype, device=dev, **kw)
        got = ragged_paged_attention(*args, window=window, softcap=softcap)
        want = ragged_paged_attention_ref(*args, window=window,
                                          softcap=softcap)
        torch.cuda.synchronize()
        err = max_err(got, want)
        zero_ok = bool((got[args[5] < 0] == 0).all())
        log(f"  ragged_paged_attention {label} {str(dtype)[6:]}: "
            f"max_abs_err {err:.3g} (tol {tol[dtype]:g})"
            f"{'' if zero_ok else ' PADDED ROWS NOT ZERO'}")
        assert err <= tol[dtype] and zero_ok, label
        worst["ragged_paged_attention"] = max(
            worst["ragged_paged_attention"], err)

    full = dict(Hkv=8, G=4, hd=64, page=16, max_pages=64, n_pages=2048)
    for dtype in (torch.bfloat16, torch.float32):
        # a mixed iteration at llama3.2-1b widths: 8 decodes and a chunk
        ragged_case("mixed N=264", dtype, N=264, B=9, **full)
        for ctx in (1, 16, 17, 64 * 16):           # page edges, full table
            for G in (1, 4):
                kw = dict(full, G=G)
                pos = torch.tensor([ctx - 1, max(0, ctx - 2), -1],
                                   dtype=torch.int32)
                ragged_case(f"ctx={ctx} G={G}", dtype, N=3, B=1,
                            tok_seq=torch.zeros(3, dtype=torch.int32),
                            tok_pos=pos, **kw)
        ragged_case("all padded", dtype, N=8, B=2,
                    tok_pos=torch.full((8,), -1, dtype=torch.int32), **full)
        for window, softcap in ((7, None), (40, None), (None, 30.0),
                                (9, 25.0)):
            ragged_case(f"window={window} softcap={softcap}", dtype, N=32,
                        B=3, window=window, softcap=softcap, **full)
        for hd, G in ((32, 4), (128, 8)):
            ragged_case(f"hd={hd} G={G}", dtype, N=16, B=2,
                        **dict(full, hd=hd, G=G))

        # kv_append: distinct slots, random validity, then all invalid
        n_pages, page, Hkv, hd = 64, 16, 8, 64
        for label, n, all_invalid in (("N=37", 37, False),
                                      ("all invalid", 16, True)):
            kp = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                             device=dev).to(dtype)
            vp = torch.randn_like(kp)
            kn = torch.randn((n, Hkv, hd), generator=gen,
                             device=dev).to(dtype)
            vn = torch.randn_like(kn)
            slots = torch.randperm(n_pages * page, generator=gen,
                                   device=dev)[:n]
            ids = (slots // page).to(torch.int32)
            offs = (slots % page).to(torch.int32)
            valid = torch.zeros(n, dtype=torch.int32, device=dev) \
                if all_invalid else torch.randint(
                    0, 2, (n,), generator=gen, device=dev,
                    dtype=torch.int32)
            want_k, want_v = kv_append_ref(kp.clone(), vp.clone(), kn, vn,
                                           ids, offs, valid)
            got_k, got_v = kv_append(kp, vp, kn, vn, ids, offs, valid)
            torch.cuda.synchronize()
            err = max(max_err(got_k, want_k), max_err(got_v, want_v))
            log(f"  kv_append {label} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3g} (tol 0, a copy)")
            assert err == 0.0, label
            worst["kv_append"] = max(worst["kv_append"], err)

        # swap pack/unpack over a stacked (16 periods) payload and a
        # scale-shaped leaf, round trip exact
        for shape in ((16, 128, 16, 8, 64), (16, 128, 8)):
            pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
            ids = torch.randperm(shape[1], generator=gen,
                                 device=dev)[:23].to(torch.int32)
            slab = swap_pack(pool, ids)
            err_p = max_err(slab, swap_pack_ref(pool, ids))
            clobbered = swap_unpack(pool.clone(), torch.zeros_like(slab), ids)
            err_u = max_err(clobbered,
                            swap_unpack_ref(pool.clone(),
                                            torch.zeros_like(slab), ids))
            restored = swap_unpack(clobbered, slab, ids)
            torch.cuda.synchronize()
            err_r = max_err(restored, pool)
            log(f"  swap_pack/unpack {shape} {str(dtype)[6:]}: pack "
                f"{err_p:.3g}, unpack {err_u:.3g}, round trip {err_r:.3g} "
                "(tol 0, copies)")
            assert err_p == err_u == err_r == 0.0, shape
            worst["swap_pack"] = max(worst["swap_pack"], err_p)
            worst["swap_unpack"] = max(worst["swap_unpack"], err_u, err_r)
    return worst


# ---------------------------------------------------------------------------
# phase 4: tiny config, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------
def check_tiny() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.utils.tree import tree_map
    cfg = get_config("llama3.2-1b", tiny=True)
    lm = LM(cfg)
    gen = torch.Generator().manual_seed(0)
    params = lm.init(gen, dtype=torch.float32, device="cpu")
    n_pages, page, max_pages = 32, 16, 8
    pools = tree_map(lambda z: torch.randn(z.shape, generator=gen),
                     lm.init_cache(n_pages, page, dtype=torch.float32,
                                   device="cpu"))
    bt = torch.randperm(n_pages, generator=gen)[:4 * max_pages].reshape(
        4, max_pages).to(torch.int32)
    tok_seq = torch.tensor([0] * 6 + [1] * 5 + [2] + [0] * 4,
                           dtype=torch.int32)
    tok_pos = torch.tensor(list(range(20, 26)) + list(range(5)) + [77]
                           + [-1] * 4, dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (16,), generator=gen,
                           dtype=torch.int32)
    q_last = torch.tensor([5, 10, 11, 0], dtype=torch.int32)
    cuda = lambda t: t.cuda()                                   # noqa: E731
    ids_c, logits_c, pools_c = lm.forward_mixed_paged(
        params, tokens, tok_seq, tok_pos, q_last, tree_map(torch.clone,
                                                           pools), bt)
    ids_g, logits_g, pools_g = lm.forward_mixed_paged(
        tree_map(cuda, params), cuda(tokens), cuda(tok_seq), cuda(tok_pos),
        cuda(q_last), tree_map(cuda, pools), cuda(bt))
    torch.cuda.synchronize()
    err = max_err(logits_g.cpu(), logits_c)
    pool_err = max(max_err(pools_g[0]["b0"][k].cpu(), pools_c[0]["b0"][k])
                   for k in ("k", "v"))
    # the appended K/V come from float32 products summed in another order
    # on the card: held to 1e-4 of the pools' largest magnitude
    pool_tol = 1e-4 * max(float(pools_c[0]["b0"][k].abs().max())
                          for k in ("k", "v"))
    log(f"  tiny logits max_abs_err {err:.3g} (tol 1e-3), pools "
        f"{pool_err:.3g} (tol {pool_tol:.3g}); sampled card "
        f"{ids_g.tolist()} cpu {ids_c.tolist()}")
    assert err <= 1e-3 and pool_err <= pool_tol
    assert logits_g.shape == (4, cfg.vocab_size)
    assert bool(torch.isfinite(logits_g).all())


# ---------------------------------------------------------------------------
# phases 5-6: full-width serve through the session API
# ---------------------------------------------------------------------------
class Recorder:
    """Keeps a copy of the inputs of each kernel's largest call on the
    main path, for the timing phase: wraps the ops that the model and the
    stager call, and adds nothing to the launch counts."""

    def __init__(self):
        import repro_torch.kernels.ops as ops
        import repro_torch.models.attention as attention
        self.calls = {}
        # (module, op name, kernel, index of the argument whose leading
        # size ranks the calls)
        self._ops = [
            (attention, "ragged_paged_attention_op",
             "ragged_paged_attention", 0),
            (attention, "kv_append_op", "kv_append", 2),
            (ops, "swap_pack_op", "swap_pack", 1),
            (ops, "swap_unpack_op", "swap_unpack", 2)]
        self._orig = {}

    def __enter__(self):
        for mod, name, key, size_arg in self._ops:
            orig = self._orig[(mod, name)] = getattr(mod, name)

            def wrapped(*args, _orig=orig, _key=key, _size=size_arg, **kw):
                size = args[_size].shape[0]
                if size > self.calls.get(_key, (-1,))[0]:
                    self.calls[_key] = (size, [a.clone() for a in args], kw)
                return _orig(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self._orig.items():
            setattr(mod, name, orig)


def launch_counts() -> dict:
    from repro_torch.kernels import kv_append, ragged_paged_attention
    from repro_torch.kernels import swap_pack as sp
    return {"ragged_paged_attention":
            ragged_paged_attention.ragged_paged_attention.launches,
            "kv_append": kv_append.kv_append.launches,
            "swap_pack": sp.swap_pack.launches,
            "swap_unpack": sp.swap_unpack.launches}


def reset_counts() -> None:
    from repro_torch.kernels import kv_append, ragged_paged_attention
    from repro_torch.kernels import swap_pack as sp
    ragged_paged_attention.ragged_paged_attention.launches = 0
    kv_append.kv_append.launches = 0
    sp.swap_pack.launches = 0
    sp.swap_unpack.launches = 0


def agent_engine(policy: str, *, tiny: bool, device: str):
    """A fresh engine (llama3.2-1b, random weights from seed 0) with the
    agent workload submitted through a ScriptedClient."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import POLICIES
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.session import ScriptedClient
    from repro_torch.serving.workloads import make_agent_workload
    cfg = get_config("llama3.2-1b", tiny=tiny)
    on_card = device == "cuda"
    reqs = make_agent_workload(
        seed=0, n_sessions=8, rate_rps=4.0, vocab=cfg.vocab_size,
        n_templates=2, system_prompt_len=160, turns=(1, 2), turn_gap_s=5.0,
        hist_per_turn=96, gen_tokens=(24, 8), final_gen=(32, 8),
        max_tool_calls=2, max_ctx=1024)
    gc.collect()                  # the previous run's engine, if any
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, POLICIES[policy], page_size=16, n_pages=2048,
                 max_model_len=1024, seed=0, device=device,
                 dtype=torch.bfloat16 if on_card else torch.float32)
    client = ScriptedClient(eng)
    handles = client.submit(reqs)
    return eng, client.client, handles


def serve(policy: str, recorder: Recorder, *, tiny: bool = False,
          device: str = "cuda") -> dict:
    """Serve agent sessions through ScriptedClient and check the run. The
    smoke run uses the defaults; ``tiny`` and ``device="cpu"`` rehearse
    the same control flow without a card."""
    import torch
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    eng, client, handles = agent_engine(policy, tiny=tiny, device=device)
    cfg = eng.cfg
    sync()
    reset_counts()
    t0 = time.perf_counter()
    with recorder:
        batch = client.poll(strict=True)
        sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = eng.sched.stats
    out_tokens = sum(h.request.output_tokens for h in handles)
    streams = [client.token_ids(h) for h in handles]
    res = {"policy": policy, "finished": sum(h.finished for h in handles),
           "requests": len(handles), "steps": eng.counters[
               "mixed_iterations"], "output_tokens": out_tokens,
           "wall_s": wall, "tokens_per_s": out_tokens / wall,
           "max_memory_allocated":
               torch.cuda.max_memory_allocated() if on_card else None,
           "swapped_out_tokens": st.swapped_out_tokens,
           "swapped_in_tokens": st.swapped_in_tokens,
           "free_pages": eng.blocks.num_free, "n_pages": eng.blocks.n_pages,
           "launches": counts}
    log(f"  {json.dumps(res)}")
    assert batch.drained and res["finished"] == res["requests"], res
    assert all(0 <= t < cfg.vocab_size for s in streams for t in s)
    if on_card:
        assert counts["ragged_paged_attention"] > 0 \
            and counts["kv_append"] > 0
    assert eng.blocks.num_free == eng.blocks.n_pages - 1, "leaked pages"
    eng.close()
    return res


# ---------------------------------------------------------------------------
# phase 7: timing on the main path's inputs
# ---------------------------------------------------------------------------
def time_kernels(recorder: Recorder, worst: dict, launches: dict) -> list:
    import torch
    from repro_torch.kernels.kv_append import kv_append, kv_append_ref
    from repro_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)
    from repro_torch.kernels.swap_pack import (swap_pack, swap_pack_ref,
                                               swap_unpack, swap_unpack_ref)
    rows = []
    meta = {
        "ragged_paged_attention": (
            "src/repro_torch/kernels/csrc/ragged_paged_attention.cu",
            "src/repro/kernels/ragged_paged_attention.py:105"),
        "kv_append": ("src/repro_torch/kernels/csrc/kv_append.cu",
                      "src/repro/kernels/kv_append.py:60"),
        "swap_pack": ("src/repro_torch/kernels/csrc/swap_pack.cu",
                      "src/repro/kernels/swap_pack.py:35"),
        "swap_unpack": ("src/repro_torch/kernels/csrc/swap_pack.cu",
                        "src/repro/kernels/swap_pack.py:74"),
    }

    def row(name, ms, plain_ms, lib_ms, nbytes, ops, dtype, err, shape):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_OPS[dtype] * 1e3
        src, rep = meta[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops
                     else "operations",
                     "library_ms": lib_ms, "shape": shape})
        log(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {lib_ms} ms, bound {max(by_bytes, by_ops):.4f} "
            f"ms, main-path max_abs_err {err:.3g}")

    # ragged paged attention: no single PyTorch call computes it
    _, args, kw = recorder.calls["ragged_paged_attention"]
    q, kp, vp, bt, tok_seq, tok_pos = args
    got = ragged_paged_attention(*args, **kw)
    want = ragged_paged_attention_ref(*args, **kw)
    main_err = max_err(got, want)
    # both round one float32 result to the working type once: within one
    # bf16 unit in the last place at the output's largest magnitude (in
    # float32, 2^-16 of it for the different order of the sums)
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -16}[q.dtype]
    tol = ulp * float(want.float().abs().max())
    log(f"  ragged_paged_attention main-path call: max_abs_err "
        f"{main_err:.3g} (tol {tol:.3g})")
    assert main_err <= tol
    err = max(worst["ragged_paged_attention"], main_err)
    ms, plain_ms = in_turns(lambda: ragged_paged_attention_ref(*args, **kw),
                            lambda: ragged_paged_attention(*args, **kw), 5)
    N, Hkv, G, hd = q.shape
    page = kp.shape[1]
    pos, seqs, table = tok_pos.tolist(), tok_seq.tolist(), bt.tolist()
    window = kw.get("window")
    pages, visible = set(), 0
    for p, s in zip(pos, seqs):
        if p < 0:
            continue
        lo = 0 if window is None else max(0, p + 1 - window)
        visible += p + 1 - lo
        pages.update(table[s][i] for i in range(lo // page, p // page + 1))
    elem = q.element_size()
    nbytes = (2 * len(pages) * page * Hkv * hd * elem + 2 * q.numel() * elem
              + 4 * (bt.numel() + 2 * N))
    ops = 4 * visible * Hkv * G * hd
    row("ragged_paged_attention", ms, plain_ms, None, nbytes, ops,
        str(q.dtype)[6:], err, list(q.shape))

    # kv_append: two pools and a validity mask, no single PyTorch call
    _, args, _ = recorder.calls["kv_append"]
    kp, vp, kn, vn, ids, offs, valid = args
    want_k, want_v = kv_append_ref(kp.clone(), vp.clone(), kn, vn, ids, offs,
                                   valid)
    got_k, got_v = kv_append(kp, vp, kn, vn, ids, offs, valid)
    err = max(worst["kv_append"], max_err(got_k, want_k),
              max_err(got_v, want_v))
    assert err == 0.0, "kv_append disagrees on the main path's inputs"
    ms, plain_ms = in_turns(
        lambda: kv_append_ref(kp, vp, kn, vn, ids, offs, valid),
        lambda: kv_append(kp, vp, kn, vn, ids, offs, valid), 20)
    n_valid = int((valid != 0).sum())
    row_bytes = kn[0].numel() * kn.element_size()
    nbytes = 4 * n_valid * row_bytes + 3 * 4 * kn.shape[0]
    row("kv_append", ms, plain_ms, None, nbytes, 0, str(kn.dtype)[6:], err,
        list(kn.shape))

    # swap pack: the yardstick is index_select over the page axis
    _, args, _ = recorder.calls["swap_pack"]
    pool, ids = args
    err = max(worst["swap_pack"],
              max_err(swap_pack(pool, ids), swap_pack_ref(pool, ids)))
    assert err == 0.0, "swap_pack disagrees on the main path's inputs"
    ms, plain_ms = in_turns(lambda: swap_pack_ref(pool, ids),
                            lambda: swap_pack(pool, ids), 20)
    lib_ms = cuda_ms(lambda: torch.index_select(pool, 1, ids.long()), 20)
    moved = pool.shape[0] * ids.numel() * pool[0, 0].numel() \
        * pool.element_size()
    row("swap_pack", ms, plain_ms, lib_ms, 2 * moved + 4 * ids.numel(), 0,
        str(pool.dtype)[6:], err, list(pool.shape[:1]) + [ids.numel()]
        + list(pool.shape[2:]))

    # swap unpack: the yardstick is index_copy_ over the page axis
    _, args, _ = recorder.calls["swap_unpack"]
    pool, staging, ids = args
    want = swap_unpack_ref(pool.clone(), staging, ids)
    err = max(worst["swap_unpack"],
              max_err(swap_unpack(pool, staging, ids), want))
    assert err == 0.0, "swap_unpack disagrees on the main path's inputs"
    ms, plain_ms = in_turns(lambda: swap_unpack_ref(pool, staging, ids),
                            lambda: swap_unpack(pool, staging, ids), 20)
    lib_ms = cuda_ms(lambda: pool.index_copy_(1, ids.long(), staging), 20)
    moved = staging.numel() * staging.element_size()
    row("swap_unpack", ms, plain_ms, lib_ms, 2 * moved + 4 * ids.numel(), 0,
        str(pool.dtype)[6:], err, list(staging.shape))
    torch.cuda.synchronize()
    return rows


def profile_serve(warm_steps: int = 100, steps: int = 100) -> None:
    """torch.profiler over ``steps`` engine steps of the InferCept serve
    run, after ``warm_steps``: the device's busy share of the window and
    device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng, client, _ = agent_engine("infercept", tiny=False, device="cuda")
    client.poll(warm_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.poll(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: (e.self_device_time_total, e.count) for e in rows}
    total = sum(us for us, _ in dev_us.values())
    log(f"  window: {steps} steps, wall {wall * 1e3:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms = {total / 1e6 / wall:.3f} of the window "
        f"(sum of kernel times; streams may overlap)")
    for name, (us, n) in sorted(dev_us.items(), key=lambda kv: -kv[1][0]
                                )[:12]:
        log(f"  {us / 1e3:9.2f} ms {n:7d}x  {us / max(total, 1e-9):.3f}  "
            f"{name[:90]}")
    if total == 0:
        log("  the profiler saw no device time: not measured")
    eng.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES} (card and build always "
                         "run; timing needs serve and swap)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    smi = card()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    name = torch.cuda.get_device_name(0)
    log(f"[card] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines() \
            if (_build.BUILD_DIR / "build.log").exists() else []:
        if "registers" in line or "error" in line or "spill" in line:
            log(f"  {line.strip()}")

    worst = {k: 0.0 for k in ("ragged_paged_attention", "kv_append",
                              "swap_pack", "swap_unpack")}
    if "kernels" in phases:
        log("[kernels] each kernel against its plain version on the card")
        worst = check_kernels()
    if "tiny" in phases:
        log("[tiny] forward_mixed_paged, card kernels vs CPU plain versions")
        check_tiny()
    recorder = Recorder()
    total = {k: 0 for k in worst}
    results = []
    for phase, policy in (("serve", "infercept"), ("swap", "swap")):
        if phase not in phases:
            continue
        log(f"[{phase}] llama3.2-1b full width, bf16, policy {policy}")
        res = serve(policy, recorder)
        results.append(res)
        for k, v in res["launches"].items():
            total[k] += v
        if phase == "swap":
            assert res["swapped_out_tokens"] > 0, "nothing was swapped"
            assert res["swapped_in_tokens"] == res["swapped_out_tokens"]
            assert res["launches"]["swap_pack"] > 0 and \
                res["launches"]["swap_unpack"] > 0
    rows = []
    if "timing" in phases and {"serve", "swap"} <= phases:
        log("[timing] CUDA events on the inputs of each kernel's largest "
            "main-path call")
        rows = time_kernels(recorder, worst, total)
    if "profile" in phases:
        log("[profile] torch.profiler over serve steps, InferCept policy")
        profile_serve()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
