"""The paper's GPU-memory-waste accounting (§3.2, Equations 1-4).

All quantities are in byte-seconds (GB*s up to scaling): "how much GPU
memory is held without producing tokens, for how long". ``M`` is the
per-token KV-cache footprint in bytes (ModelConfig.kv_token_bytes());
``t_fwd`` / ``t_swap`` come from the cost model (offline profiling in the
paper).
"""
from __future__ import annotations


def waste_discard(t_fwd_c: float, c_tokens: int, m_bytes: float,
                  c_other_tokens: int) -> float:
    """Eq. 1: recomputation occupies memory producing no new tokens, and the
    lengthened iteration wastes every other running request's memory."""
    return t_fwd_c * c_tokens * m_bytes + t_fwd_c * c_other_tokens * m_bytes


def waste_preserve(t_int: float, c_tokens: int, m_bytes: float) -> float:
    """Eq. 2: the paused request's whole context is held for the
    interception's duration."""
    return t_int * c_tokens * m_bytes


def waste_swap(t_swap_c: float, c_batch_tokens: int, m_bytes: float) -> float:
    """Eq. 3: synchronous swap stalls the whole batch for the transfer, out
    and back in (hence the factor 2)."""
    return 2.0 * t_swap_c * c_batch_tokens * m_bytes


def overlap_stall(t_window: float, t_cost: float) -> float:
    """Overlap semantics (DESIGN.md §12): a transfer (or any off-critical-
    path work) of duration ``t_cost`` issued alongside a compute window of
    ``t_window`` stalls the pipeline only for the remainder —
    ``max(t_window, t_cost)`` total instead of ``t_window + t_cost``. The
    §4.1 swap budget is the special case where the remainder is forced to
    zero by sizing the transfer to the window. Under overlap, Eq. 3's
    stall term is evaluated at this remainder (CostModel.overlap_terms;
    the simulator then charges ``remainder * batch_tokens * M`` per
    iteration exactly as it charges the serial stall)."""
    return max(0.0, t_cost - t_window)


def waste_chunked_discard(t_fwd_c: float, c_tokens: int, m_bytes: float,
                          n_chunks: int, t_fwd_chunk: float,
                          c_other_tokens: int) -> float:
    """Eq. 4: chunked recomputation halves the self-occupancy term (memory
    ramps linearly instead of being held for the full recompute) and the
    other-requests term shrinks because chunks piggyback on decode
    iterations (n * t_fwd(C/n) <= t_fwd(C))."""
    return (t_fwd_c * c_tokens * m_bytes / 2.0
            + n_chunks * t_fwd_chunk * c_other_tokens * m_bytes)


def min_waste_decision(*, t_int_est: float, c_tokens: int, m_bytes: float,
                       t_fwd_c: float, n_chunks: int, t_fwd_chunk: float,
                       c_other_tokens: int, recompute_tokens: int = None):
    """Eq. 5: min(WastePreserve, WasteChunkDiscard) for one intercepted
    request. Returns (decision, waste) with decision in
    {"preserve", "discard"}; swap is allocated separately by budget order.

    ``recompute_tokens`` is the cache-aware refinement: with the prefix
    cache (repro_torch.cache) a discard only has to recompute the UNCACHED
    suffix — the shared-prefix pages are restored by a tree lookup — so
    the discard side of Eq. 5 is evaluated at the suffix length while the
    preserve side still holds the full context. The callers' t_fwd_c /
    n_chunks / t_fwd_chunk must already be sized for the suffix
    (CostModel.recompute_terms). Defaults to c_tokens (no cache).
    """
    c_r = c_tokens if recompute_tokens is None else recompute_tokens
    wp = waste_preserve(t_int_est, c_tokens, m_bytes)
    if c_r <= 0:
        # fully cached context: discarding is free, holding memory is not
        return ("discard", 0.0)
    wd = waste_chunked_discard(t_fwd_c, c_r, m_bytes, n_chunks,
                               t_fwd_chunk, c_other_tokens)
    return ("preserve", wp) if wp <= wd else ("discard", wd)
