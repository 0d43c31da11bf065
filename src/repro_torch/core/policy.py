"""Interception-handling policy configurations.

Presets cover the paper's five end-to-end systems (Figure 2) and the
incremental breakdown variants (Figure 3).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    name: str
    # On re-queueing a discarded request, keep the ORIGINAL arrival time as
    # the FCFS key (ImprovedDiscard+) instead of the resume time (vLLM).
    requeue_original_arrival: bool = False
    # Recompute discarded contexts in saturation-point-sized chunks (§4.2)
    # instead of a single monolithic prefill iteration.
    chunked_recompute: bool = False
    # Swap machinery enabled at all.
    swap_enabled: bool = False
    # Budgeted + pipelined swap (§4.1): per-iteration swap limit N_i hidden
    # behind forwarding. If False, swap is synchronous and stalls the batch.
    swap_budgeted: bool = False
    # Decision for intercepted requests' remaining (non-swapped) context:
    #   discard | preserve | swap_first | heuristic | min_waste
    # "heuristic": preserve short-running automated augmentations, discard
    # interactive ones (the Fig. 3 step before full min-waste).
    decision: str = "discard"
    # Re-evaluate preserved requests every iteration with the (growing)
    # dynamic duration estimate (§4.4) and flip them if waste says so.
    reevaluate_preserved: bool = False
    # Duration estimator mode.
    estimator: str = "dynamic"


# ---- Figure 2 systems ------------------------------------------------------

VLLM = PolicyConfig(name="vllm")  # Discard, requeue-at-tail

IMPROVED_DISCARD = PolicyConfig(name="improved_discard",
                                requeue_original_arrival=True)

PRESERVE = PolicyConfig(name="preserve", requeue_original_arrival=True,
                        decision="preserve")

SWAP = PolicyConfig(name="swap", requeue_original_arrival=True,
                    swap_enabled=True, swap_budgeted=False,
                    decision="swap_first")

INFERCEPT = PolicyConfig(name="infercept", requeue_original_arrival=True,
                         chunked_recompute=True, swap_enabled=True,
                         swap_budgeted=True, decision="min_waste",
                         reevaluate_preserved=True, estimator="dynamic")

INFERCEPT_ORACLE = dataclasses.replace(INFERCEPT, name="infercept_oracle",
                                       estimator="oracle")

# ---- Figure 3 incremental breakdown ---------------------------------------

BREAKDOWN = [
    VLLM,
    IMPROVED_DISCARD,
    dataclasses.replace(IMPROVED_DISCARD, name="+chunked_recompute",
                        chunked_recompute=True),
    dataclasses.replace(IMPROVED_DISCARD, name="+budgeted_swap",
                        chunked_recompute=True, swap_enabled=True,
                        swap_budgeted=True, decision="swap_first"),
    dataclasses.replace(IMPROVED_DISCARD, name="+preserve_heuristic",
                        chunked_recompute=True, swap_enabled=True,
                        swap_budgeted=True, decision="heuristic"),
    INFERCEPT,
]

POLICIES = {p.name: p for p in
            [VLLM, IMPROVED_DISCARD, PRESERVE, SWAP, INFERCEPT,
             INFERCEPT_ORACLE] + BREAKDOWN[2:5]}

# Augmentation types considered "automated / short-running" by the Fig. 3
# heuristic (math, QA, VE); the rest are interactive / long-running.
SHORT_RUNNING_KINDS = frozenset({"math", "qa", "ve"})
