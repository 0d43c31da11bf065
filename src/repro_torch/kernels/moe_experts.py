"""The routed experts of a fine-grained MoE FFN: the CUDA kernels'
launcher, its plain PyTorch version and the autograd Function around the
launch.

There is no Pallas kernel to replace: the reference runs its experts as
XLA's dense dispatch einsums over an (E, C, d) buffer per group
(``repro.models.moe.moe_forward``, ``per_group``). Here each expert runs
only the pairs routed to it. Inputs, as ``models.moe.route`` makes them
on the device:

  x (N, d) token rows; we_gate, we_up (E, d, fe); we_down (E, fe, d);
  gate_w (N, k) the gates in x's dtype; pair (P = N k,) int32, the flat
  pair ids t * k + r in expert-major order; valid (P,) bool in flat
  order, False for a pair past its expert's capacity (dropped: it adds
  nothing); offsets (E + 1,) int32, each expert's first sorted pair.

The function: ``out[t] = sum_r gate_w[t, r] * y[t k + r]``, where a kept
pair's ``y = (act(x_t @ we_gate[e]) * (x_t @ we_up[e])) @ we_down[e]`` in
x's dtype (each product rounded to it, as the reference's einsums round)
and a dropped pair's is zero; the sum is float32, rounded once. The
kernels (``csrc/moe_experts.cu``) are three launches, counted as one call
in ``moe_experts.launches``: gate/up, down, and the combine.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE = 64            # the kernels' output tile: d and fe are multiples
MAX_EXPERTS = 256
ACTIVATIONS = {"silu": 0, "gelu": 1, "relu": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_experts_ref(x, we_gate, we_up, we_down, gate_w, pair, valid,
                    offsets, *, activation: str = "silu"):
    """The plain version: a Python loop over the experts, each one's
    sorted pairs through its three products (the offsets come to the host
    once). Differentiable by autograd; the CPU path and the card's
    oracle."""
    # imported here: the models import the kernels
    from repro_torch.models.common import activation_fn
    N, d = x.shape
    k = gate_w.shape[1]
    act = activation_fn(activation)
    bounds = offsets.tolist()
    keep = valid[pair.long()][:, None]                 # sorted order
    ids, rows = [], []
    for e in range(we_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        pid = pair[lo:hi].long()
        xe = x[pid // k]
        h = act(xe @ we_gate[e]) * (xe @ we_up[e])
        ids.append(pid)
        rows.append(torch.where(keep[lo:hi], h @ we_down[e], 0))
    y = x.new_zeros((N * k, d))
    if ids:
        y = y.index_copy(0, torch.cat(ids), torch.cat(rows))
    out = (y.view(N, k, d).float() * gate_w.float()[..., None]).sum(1)
    return out.to(x.dtype)


def _check(x, we_gate, we_up, we_down, gate_w, pair, valid, offsets,
           activation):
    """Raise on any operand the kernels do not take."""
    if not x.is_cuda:
        raise ValueError(f"moe_experts launches CUDA kernels; got a tensor "
                         f"on {x.device}")
    if x.dim() != 2 or we_gate.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} and we_gate "
                         f"{tuple(we_gate.shape)}: x (N, d), experts "
                         "(E, d, fe)")
    N, d = x.shape
    E, _, fe = we_gate.shape
    k = gate_w.shape[-1]
    if we_gate.shape != (E, d, fe) or we_up.shape != (E, d, fe) \
            or we_down.shape != (E, fe, d) or gate_w.shape != (N, k):
        raise ValueError(f"shapes x {tuple(x.shape)}, we_gate / we_up "
                         f"{tuple(we_gate.shape)} {tuple(we_up.shape)}, "
                         f"we_down {tuple(we_down.shape)}, gate_w "
                         f"{tuple(gate_w.shape)} not taken")
    if d % TILE or fe % TILE:
        raise ValueError(f"d {d} and fe {fe} must be multiples of {TILE}, "
                         "the kernels' tile")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{E} experts: the kernels take 1-{MAX_EXPERTS}")
    if x.dtype not in DTYPES or not (
            x.dtype == we_gate.dtype == we_up.dtype == we_down.dtype
            == gate_w.dtype):
        raise TypeError("x, the experts and the gates must share one dtype, "
                        f"float32 or bfloat16; got {x.dtype}, "
                        f"{we_gate.dtype}, {we_down.dtype}, {gate_w.dtype}")
    if pair.dtype != torch.int32 or offsets.dtype != torch.int32 \
            or valid.dtype != torch.bool or pair.shape != (N * k,) \
            or valid.shape != (N * k,) or offsets.shape != (E + 1,):
        raise TypeError("pair (N k,) int32, valid (N k,) bool and offsets "
                        "(E + 1,) int32 expected")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not taken")
    ops = (x, we_gate, we_up, we_down, gate_w, pair, valid, offsets)
    if not all(t.is_contiguous() for t in ops) \
            or len({t.get_device() for t in ops}) != 1:
        raise ValueError("all operands must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in ops[:4]):
        raise ValueError("x and the experts must start on 16 bytes")


def moe_experts(x, we_gate, we_up, we_down, gate_w, pair, valid, offsets,
                *, activation: str = "silu"):
    """Launch the three kernels on the current stream; returns out (N, d)
    in x's dtype. Raises on any operand the kernels do not take, a CPU
    tensor included."""
    _check(x, we_gate, we_up, we_down, gate_w, pair, valid, offsets,
           activation)
    N, d = x.shape
    E, _, fe = we_gate.shape
    k = gate_w.shape[1]
    h = torch.empty((N * k, fe), dtype=x.dtype, device=x.device)
    y = torch.empty((N * k, d), dtype=x.dtype, device=x.device)
    out = torch.empty((N, d), dtype=x.dtype, device=x.device)
    err = _build.lib().moe_experts_launch(
        x.data_ptr(), we_gate.data_ptr(), we_up.data_ptr(),
        we_down.data_ptr(), gate_w.data_ptr(), pair.data_ptr(),
        valid.data_ptr(), offsets.data_ptr(), h.data_ptr(), y.data_ptr(),
        out.data_ptr(), N, d, fe, E, k, ACTIVATIONS[activation],
        DTYPES[x.dtype], torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "moe_experts")
    moe_experts.launches += 1
    return out


moe_experts.launches = 0


class MoEExperts(torch.autograd.Function):
    """The kernels as an autograd Function. Their backward is later work:
    it raises rather than differentiate the plain version on the card."""

    @staticmethod
    def forward(ctx, x, we_gate, we_up, we_down, gate_w, pair, valid,
                offsets, activation):
        return moe_experts(x, we_gate, we_up, we_down, gate_w, pair, valid,
                           offsets, activation=activation)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "moe_experts has no backward kernel yet: training an MoE model "
            "on the card waits for it (ROADMAP, 'The kernel work that "
            "remains': '10. The MoE experts' backward')")
