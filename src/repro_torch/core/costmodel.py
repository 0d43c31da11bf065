"""Analytic hardware cost model: T_fwd, T_swap, and the saturation point S.

The paper obtains T_fwd (batch scheduled tokens -> iteration time) and the
GPU saturation point S by offline profiling on A100s. We derive the same
mappings analytically from chip specs and the model config via a two-term
roofline (compute vs HBM), so the identical object serves:
  * the InferCept scheduler itself (swap budgets, waste equations),
  * the discrete-event simulator (iteration timing), and
  * the §Roofline analysis (validated against compiled.cost_analysis()).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.waste import overlap_stall
from repro_torch.utils.hw import ChipSpec, dtype_bytes


@dataclasses.dataclass(frozen=True)
class CostModel:
    cfg: ModelConfig
    chip: ChipSpec
    n_chips: int = 1
    eff_flops: float = 0.45       # achievable fraction of peak matmul
    eff_hbm: float = 0.75         # achievable fraction of peak bandwidth
    fixed_overhead_s: float = 2e-4  # dispatch/launch floor per iteration
    weight_dtype: str = "bfloat16"
    # KV pool storage dtype when it differs from the weights (quantized
    # pools, DESIGN.md §17). None = KV stored at weight_dtype, the
    # historical assumption. Halving M shifts every Eq. 4/5 pivot: swap
    # budgets (swap_tokens_within), T_swap, kv_capacity_tokens, and the
    # byte-seconds the WasteLedger prices all follow m_bytes.
    kv_dtype: Optional[str] = None
    # Profiled floor for the saturation point: the pure weights-read/compute
    # crossover underestimates S because weight streaming overlaps compute;
    # measured chunked-prefill sweet spots sit around 512 query tokens
    # (Sarathi; vLLM's max_num_batched_tokens default).
    saturation_floor: int = 512

    # ---- derived ---------------------------------------------------------
    @property
    def m_bytes(self) -> int:
        """Per-token KV bytes, the paper's M (kv-dtype-aware: quantized
        pools store K/V at 1 byte/elem; the per-page scale overhead is
        amortized below 1% per token at page_size >= 8 and is carried by
        the engine's physical ``kv_token_bytes``, not the analytic M)."""
        return self.cfg.kv_token_bytes(
            dtype_bytes(self.kv_dtype or self.weight_dtype))

    @property
    def weight_bytes(self) -> float:
        return self.cfg.approx_n_params() * dtype_bytes(self.weight_dtype)

    @property
    def active_param_flops_per_token(self) -> float:
        return 2.0 * self.cfg.active_params_per_token()

    @property
    def flops_rate(self) -> float:
        return self.n_chips * self.chip.peak_flops_bf16 * self.eff_flops

    @property
    def hbm_rate(self) -> float:
        return self.n_chips * self.chip.hbm_bandwidth * self.eff_hbm

    @property
    def swap_rate_bytes(self) -> float:
        return self.n_chips * self.chip.host_link_bandwidth

    def kv_capacity_tokens(self, reserve_frac: float = 0.15) -> int:
        """KV tokens that fit in HBM after weights + activation reserve."""
        free = (self.n_chips * self.chip.hbm_bytes * (1 - reserve_frac)
                - self.weight_bytes)
        return max(0, int(free / max(1, self.m_bytes)))

    # ---- the paper's profiled mappings -----------------------------------
    def t_fwd(self, query_tokens: int, ctx_tokens: int = 0) -> float:
        """Iteration time for a batch with ``query_tokens`` scheduled query
        tokens whose attention reads ``ctx_tokens`` total context KV."""
        if query_tokens <= 0:
            return 0.0
        flops = (self.active_param_flops_per_token * query_tokens
                 + 2.0 * self.m_bytes * ctx_tokens)  # attn MACs ~ KV elems
        mem = (self.weight_bytes + self.m_bytes * (ctx_tokens + query_tokens))
        return (max(flops / self.flops_rate, mem / self.hbm_rate)
                + self.fixed_overhead_s)

    def recompute_terms(self, c_tokens: int, cached_tokens: int = 0):
        """Chunked-recompute cost inputs for Eq. 4/5 when a prefix of the
        discarded context is already held by the prefix cache: recompute
        covers only the uncached suffix. Returns
        (recompute_tokens, t_fwd_c, n_chunks, t_fwd_chunk); with
        cached_tokens=0 these are exactly the paper's full-context terms."""
        c_r = max(0, c_tokens - max(0, cached_tokens))
        sat = max(1, self.saturation_tokens)
        n_chunks = max(1, -(-c_r // sat))
        return c_r, self.t_fwd(c_r), n_chunks, self.t_fwd(min(c_r, sat))

    def t_swap(self, tokens: int) -> float:
        return tokens * self.m_bytes / self.swap_rate_bytes

    def swap_tokens_within(self, seconds: float) -> int:
        """The swap limit N_i: tokens movable for free under T_fwd (§4.1)."""
        return int(seconds * self.swap_rate_bytes / max(1, self.m_bytes))

    def overlap_terms(self, t_model: float, swap_tokens: int,
                      stall_s: float):
        """Pipelined-step accounting (DESIGN.md §12), shared by the engine
        and the simulator so their counters stay bit-consistent: swap DMA
        issued alongside a forwarding window of ``t_model`` seconds hides
        up to the link's capacity for that window; an unbudgeted transfer
        (``stall_s`` = its total link time, the Swap baseline) stalls only
        for the remainder — ``max(t_model, t_swap)`` instead of
        ``t_model + t_swap``. Returns (hidden_tokens, stall_remainder_s)."""
        hidden = min(swap_tokens, self.swap_tokens_within(t_model))
        return hidden, (overlap_stall(t_model, stall_s) if stall_s else 0.0)

    @property
    def saturation_tokens(self) -> int:
        """S: query-token count at which the batch matmul becomes
        compute-bound (beyond it, iteration time grows without improving
        throughput — §4.2)."""
        s = (self.weight_bytes / self.hbm_rate
             * self.flops_rate / self.active_param_flops_per_token)
        return max(self.saturation_floor, int(s))
