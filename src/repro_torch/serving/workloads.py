"""The six augmentation workloads from the paper (§2.2, Table 1, Appendix).

Each augmentation type is characterized by (mean, std) of: interception
duration, number of interceptions per request, and context length at
interception. Durations are lognormal (positive, heavy-tailed — matches the
CDFs in the paper's appendix Figs. 4-5); counts/lengths are clipped normals.
Returned-token lengths follow the appendix's qualitative description (short
constant-ish returns for math/image/TTS, longer retrieved passages for QA).

The paper's mixed workload uniformly samples the six types.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Interception, Request, Segment


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    kind: str
    int_time: tuple          # (mean s, std s)   — Table 1
    n_int: tuple             # (mean, std)       — Table 1
    ctx_len: tuple           # (mean, std)       — Table 1
    ret_tokens: tuple        # (mean, std)       — appendix-calibrated


AUGMENT_SPECS: Dict[str, AugmentSpec] = {
    "math":    AugmentSpec("math",    (9e-5, 6e-5),   (3.75, 1.3),
                           (1422, 738), (10, 4)),
    "qa":      AugmentSpec("qa",      (0.69, 0.17),   (2.52, 1.73),
                           (1846, 428), (96, 32)),
    "ve":      AugmentSpec("ve",      (0.09, 0.014),  (28.18, 15.2),
                           (2185, 115), (24, 8)),
    "chatbot": AugmentSpec("chatbot", (28.6, 15.6),   (4.45, 1.96),
                           (753, 703), (48, 24)),
    "image":   AugmentSpec("image",   (20.03, 7.8),   (6.91, 3.93),
                           (1247, 792), (16, 4)),
    "tts":     AugmentSpec("tts",     (17.24, 7.6),   (6.91, 3.93),
                           (1251, 792), (16, 4)),
}

MIXED = tuple(AUGMENT_SPECS)


def _lognormal(rng: np.random.Generator, mean: float, std: float) -> float:
    """Lognormal sample with the given linear-space mean/std."""
    if mean <= 0:
        return 0.0
    var = std * std
    sigma2 = math.log(1.0 + var / (mean * mean))
    mu = math.log(mean) - sigma2 / 2.0
    return float(rng.lognormal(mu, math.sqrt(sigma2)))


def _clipped_normal(rng, mean, std, lo, hi=None) -> int:
    x = rng.normal(mean, std)
    if hi is not None:
        x = min(x, hi)
    return int(max(lo, round(x)))


def sample_request(rng: np.random.Generator, kind: str, rid: int,
                   arrival: float, max_ctx: int = 8192) -> Request:
    """Generate one scripted request of the given augmentation type."""
    spec = AUGMENT_SPECS[kind]
    n_int = _clipped_normal(rng, *spec.n_int, lo=1)
    ctx0 = _clipped_normal(rng, *spec.ctx_len, lo=32, hi=max_ctx // 2)
    # first-interception context = prompt + first generation stretch
    gen0 = max(8, int(ctx0 * 0.3))
    prompt = max(16, ctx0 - gen0)
    segments: List[Segment] = []
    for j in range(n_int):
        gen = gen0 if j == 0 else _clipped_normal(rng, 60, 30, lo=8)
        dur = _lognormal(rng, *spec.int_time)
        ret = _clipped_normal(rng, *spec.ret_tokens, lo=1)
        segments.append(Segment(gen_tokens=gen,
                                interception=Interception(kind, dur, ret)))
    segments.append(Segment(gen_tokens=_clipped_normal(rng, 80, 40, lo=8),
                            interception=None))
    # keep the scripted request within the serving context budget
    total = prompt + sum(s.gen_tokens for s in segments) + \
        sum(s.interception.returned_tokens for s in segments
            if s.interception)
    if total > max_ctx:
        scale = max_ctx / total
        prompt = max(16, int(prompt * scale))
        for s in segments:
            s.gen_tokens = max(4, int(s.gen_tokens * scale))
            if s.interception:
                s.interception.returned_tokens = max(
                    1, int(s.interception.returned_tokens * scale))
    return Request(rid=rid, arrival=arrival, prompt_len=prompt,
                   segments=segments)


def make_workload(seed: int, n_requests: int, rate_rps: float,
                  kinds: Sequence[str] = MIXED,
                  max_ctx: int = 8192) -> List[Request]:
    """Poisson arrivals at ``rate_rps``; types sampled uniformly (the
    paper's mixed workload) or from a single-kind list."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(1.0 / rate_rps)
        kind = kinds[int(rng.integers(len(kinds)))]
        out.append(sample_request(rng, kind, rid, t, max_ctx))
    return out


def make_agent_workload(seed: int, n_sessions: int, rate_rps: float, *,
                        vocab: int = 32000, n_templates: int = 4,
                        system_prompt_len: int = 160,
                        turns: tuple = (1, 4), turn_gap_s: float = 30.0,
                        hist_per_turn: int = 96, prefix_share: float = 0.7,
                        kinds: Sequence[str] = ("math", "qa", "ve"),
                        gen_tokens: tuple = (24, 10),
                        final_gen: tuple = (32, 12),
                        ret_tokens: Optional[tuple] = None,
                        max_tool_calls: int = 4,
                        max_ctx: int = 4096) -> List[Request]:
    """Agent traffic with real shared-prefix structure (explicit token ids).

    Sessions arrive Poisson at ``rate_rps``; each samples one of
    ``n_templates`` system prompts and runs 1..n multi-turn requests. Turn
    k's shared part is always an exact prefix-extension of turn k-1's
    prompt (template + accumulated history, clamped to the ``max_ctx//2``
    budget while holding the share ratio), so a prefix cache sees: (a)
    cross-session sharing of the system prompt, (b) cross-turn sharing of
    the previous prompt's prefix — registered as soon as turn k-1
    prefills — and (c) each request's own context again after a discard.

    ``prefix_share`` sets the shared fraction of each prompt: the unique
    tail is sized so unique/(shared+unique) = 1 - prefix_share. Tool-call
    interceptions are sampled from AUGMENT_SPECS (``ret_tokens`` overrides
    the returned-length distribution, handy for tiny-context tests).
    """
    assert 0.0 < prefix_share <= 1.0
    rng = np.random.default_rng(seed)
    templates = [rng.integers(0, vocab, size=system_prompt_len).tolist()
                 for _ in range(n_templates)]
    reqs: List[Request] = []
    t = 0.0
    cap = max_ctx // 2
    for _ in range(n_sessions):
        t += rng.exponential(1.0 / rate_rps)
        tmpl = templates[int(rng.integers(n_templates))]
        # session context: a prefix-extension chain seeded by the template
        # and re-rooted at each emitted prompt, so turn k+1's shared part
        # is by construction a prefix-extension of turn k's prompt
        ctx: List[int] = list(tmpl)
        arr = t
        for _turn in range(int(rng.integers(turns[0], turns[1] + 1))):
            n_unique = max(4, int(round(
                len(ctx) * (1.0 - prefix_share) / prefix_share)))
            if len(ctx) + n_unique > cap:
                # context outgrew the budget: hold the share ratio INSIDE
                # the cap — take a prefix of the session context and size
                # the unique tail to fill the remainder, so prompts stay
                # bounded and prefix_share keeps meaning what it says
                take = min(len(ctx), max(1, int(round(prefix_share * cap))))
                n_unique = max(4, cap - take)
            else:
                take = len(ctx)
            unique = rng.integers(0, vocab, size=n_unique).tolist()
            prompt = ctx[:take] + unique
            segments: List[Segment] = []
            for _ in range(_clipped_normal(rng, 1.5, 1.0, lo=0,
                                           hi=max_tool_calls)):
                kind = kinds[int(rng.integers(len(kinds)))]
                spec = AUGMENT_SPECS[kind]
                ret = ret_tokens if ret_tokens is not None \
                    else spec.ret_tokens
                segments.append(Segment(
                    gen_tokens=_clipped_normal(rng, *gen_tokens, lo=4),
                    interception=Interception(
                        kind, _lognormal(rng, *spec.int_time),
                        _clipped_normal(rng, *ret, lo=1))))
            segments.append(Segment(
                gen_tokens=_clipped_normal(rng, *final_gen, lo=4),
                interception=None))
            reqs.append(Request(rid=0, arrival=arr, prompt_len=len(prompt),
                                segments=segments, prompt_tokens=prompt))
            # re-root on the emitted prompt + fresh history filler (the
            # assistant/tool turns a real agent framework would append)
            ctx = prompt + rng.integers(0, vocab,
                                        size=hist_per_turn).tolist()
            arr += rng.exponential(turn_gap_s)
    reqs.sort(key=lambda r: (r.arrival, id(r)))
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def profile_means(kinds: Sequence[str] = MIXED) -> Dict[str, float]:
    """Offline per-type duration means (the 'profile' estimator mode)."""
    return {k: AUGMENT_SPECS[k].int_time[0] for k in kinds}


def workload_table(requests: Sequence[Request]) -> Dict[str, dict]:
    """Empirical Table-1 statistics of a generated workload (benchmark)."""
    by_kind: Dict[str, dict] = {}
    for r in requests:
        ctx = r.prompt_len
        for s in r.segments:
            ctx += s.gen_tokens
            if s.interception is None:
                continue
            d = by_kind.setdefault(s.interception.kind,
                                   {"durations": [], "n_int": [], "ctx": []})
            d["durations"].append(s.interception.duration)
            d["ctx"].append(ctx)
            ctx += s.interception.returned_tokens
        k = next((s.interception.kind for s in r.segments if s.interception),
                 None)
        if k:
            by_kind[k]["n_int"].append(
                sum(1 for s in r.segments if s.interception))
    out = {}
    for k, d in by_kind.items():
        out[k] = {
            "int_time_mean": float(np.mean(d["durations"])),
            "int_time_std": float(np.std(d["durations"])),
            "n_int_mean": float(np.mean(d["n_int"])) if d["n_int"] else 0.0,
            "ctx_mean": float(np.mean(d["ctx"])),
        }
    return out
