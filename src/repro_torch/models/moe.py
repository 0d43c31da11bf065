"""Fine-grained MoE (DeepSeek style): shared experts plus routed top-k
experts with capacity-bounded dispatch, counterpart of
``repro.models.moe``.

Each batch row of x is a dispatch group, as in the reference: the fused,
paged-decode and slotted-decode paths pass (N, 1, d), every token a group
of one (capacity k: nothing drops), the forward and extend paths (B, T, d)
at the padded chunk length. The router runs in float32. ``route`` gives
each (group, token, k-rank) pair its rank within its (group, expert) in
the reference's token-major then k-rank order, from one stable sort, and
drops the pairs ranked past the capacity; it never syncs with the host.
The experts run in ``kernels.ops.moe_experts_op`` over the pairs each
expert received (the kernels on the card, their plain version on the
CPU), where the reference scatters into a dense (E, C, d) buffer per
group and runs dense einsums.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FFNCfg
from repro_torch.kernels.ops import moe_experts_op
from repro_torch.models.common import activation_fn, dense_init


def init_moe(generator: torch.Generator, d_model: int, f: FFNCfg, *,
             dtype: torch.dtype, device):
    """The reference's leaves: ``router`` (d, E) float32 at any dtype,
    ``we_gate`` / ``we_up`` (E, d, fe) and ``we_down`` (E, fe, d) with
    their fan-in over axis 1, and the shared experts' MLP of width
    ``n_shared * fe``."""
    E, fe = f.n_routed_experts, f.d_ff_expert
    kw = dict(dtype=dtype, device=device)
    p = {"router": dense_init(generator, (d_model, E), dtype=torch.float32,
                              device=device),
         "we_gate": dense_init(generator, (E, d_model, fe), in_axis=1, **kw),
         "we_up": dense_init(generator, (E, d_model, fe), in_axis=1, **kw),
         "we_down": dense_init(generator, (E, fe, d_model), in_axis=1, **kw)}
    if f.n_shared_experts:
        fs = f.n_shared_experts * fe
        p["shared"] = {
            "w_gate": dense_init(generator, (d_model, fs), **kw),
            "w_up": dense_init(generator, (d_model, fs), **kw),
            "w_down": dense_init(generator, (fs, d_model), **kw)}
    return p


def _capacity(tokens_per_group: int, f: FFNCfg) -> int:
    c = int(tokens_per_group * f.top_k * f.capacity_factor
            / f.n_routed_experts) + 1
    return max(c, f.top_k)  # never below top_k slots


def route(gate_idx, capacity: int, n_experts: int):
    """gate_idx (G, T, k) int64 -> (pair (P,) int32: the flat pair ids
    (g T + t) k + r in expert-major order, groups and then flat order
    within an expert; valid (P,) bool in flat order, a pair's rank within
    its (group, expert) below ``capacity``; offsets (E + 1,) int32, each
    expert's first sorted pair). One stable sort on expert * G + group
    orders the pairs, and a segment's start comes from ``searchsorted``;
    no op here syncs with the host."""
    G, T, k = gate_idx.shape
    P = G * T * k
    dev = gate_idx.device
    flat = torch.arange(P, device=dev)
    key = gate_idx.reshape(P) * G + flat // (T * k)
    skey, order = torch.sort(key, stable=True)
    rank = flat - torch.searchsorted(skey, skey)
    valid = torch.zeros(P, dtype=torch.bool, device=dev).scatter_(
        0, order, rank < capacity)
    offsets = torch.searchsorted(
        skey, torch.arange(n_experts + 1, device=dev) * G)
    return order.to(torch.int32), valid, offsets.to(torch.int32)


def route_ref(gate_idx, capacity: int, n_experts: int):
    """The plain capacity step, the reference's ``_dispatch_group`` per
    group: each pair's rank within its expert is a cumulative sum of
    one-hot rows over the group's flat pairs. Returns valid (P,) bool in
    flat order, ``route``'s second output."""
    G, T, k = gate_idx.shape
    flat_e = gate_idx.reshape(G, T * k, 1)
    onehot = (flat_e == torch.arange(n_experts, device=gate_idx.device)
              ).to(torch.int32)
    rank = torch.gather(onehot.cumsum(1) - onehot, 2, flat_e)
    return (rank < capacity).reshape(-1)


def router(p, f: FFNCfg, x):
    """x (B, T, d) -> (gates (B, T, k) in x's dtype, expert ids (B, T, k)
    int64, the Switch-style balance loss): float32 logits, softmax, top-k,
    the gates renormalized."""
    E = f.n_routed_experts
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gate_w, gate_idx = torch.topk(probs, f.top_k, dim=-1)
    gate_w = (gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
              ).to(x.dtype)
    # per group, then averaged; top-1 usage without one_hot, which checks
    # its input's range with a host sync on the card
    me = probs.mean(dim=1)                                      # (B, E)
    ce = (gate_idx[..., :1] == torch.arange(E, device=x.device)
          ).float().mean(dim=1)
    aux = E * torch.mean(torch.sum(me * ce, dim=-1)) * f.router_aux_loss_coef
    return gate_w, gate_idx, aux


def moe_forward(p, f: FFNCfg, x):
    """x: (B, T, d) -> (out (B, T, d), aux loss scalar). Each batch row is
    a dispatch group of capacity ``_capacity(T)``."""
    B, T, d = x.shape
    act = activation_fn(f.activation)
    gate_w, gate_idx, aux = router(p, f, x)
    pair, valid, offsets = route(gate_idx, _capacity(T, f),
                                 f.n_routed_experts)
    out = moe_experts_op(x.reshape(B * T, d).contiguous(), p["we_gate"],
                         p["we_up"], p["we_down"],
                         gate_w.reshape(B * T, f.top_k).contiguous(), pair,
                         valid, offsets, activation=f.activation)
    out = out.reshape(B, T, d)
    if f.n_shared_experts:
        s = p["shared"]
        up = x @ s["w_up"]
        h = act(x @ s["w_gate"]) * up
        out = out + h @ s["w_down"]
    return out, aux
