"""Chunked gated linear attention, the core of the SSM blocks (xLSTM's
mLSTM and Mamba2's SSD): the CUDA kernel's launcher, its plain PyTorch
versions, and the autograd Function around the launch.

Counterpart of ``repro.kernels.gla_scan`` (the Pallas kernel) and of its
oracle ``repro.models.ssm.chunked_gla``, the function the reference model
calls. Per (batch, head): ``S_t = exp(log_a_t) S_{t-1} + k_t v_t^T`` and
``y_t = q_t S_t``, with ``log_a <= 0``, taken in chunks of ``c =
min(chunk, T)`` steps. Any T: the last chunk is padded with ``log_a = 0``
and ``k = v = 0`` (steps that change nothing) and the padded rows of y
are dropped, as ``chunked_gla`` does (the Pallas kernel asserts chunk
multiples). All arithmetic is float32, as ``chunked_gla`` casts.

Layout: q, k (B, H, T, dk); v (B, H, T, dv); log_a (B, H, T); an
optional initial state (B, H, dk, dv). Returns y (B, H, T, dv) in v's
dtype and the final state (B, H, dk, dv) float32. The kernel source is
``csrc/gla_scan.cu``; it has no backward yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_CHUNK = 256      # rows of a chunk: one thread of the scan block each
MAX_DK = 512         # key dims: two state rows per thread of the scan block
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunked_gla_ref(q, k, v, log_a, chunk: int, initial_state=None):
    """The plain version, ``repro.models.ssm.chunked_gla`` op for op, with
    a Python loop over the chunks in place of ``lax.scan``. The decay
    ``exp(lb_i - lb_j)`` is formed under the causal mask (``-inf`` above
    the diagonal), so it never overflows there and stays differentiable;
    the reference forms it everywhere and masks after the ``exp``, which
    gives the same values. Returns (y in v's dtype, state float32)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, T)
    n = -(-T // c)
    pad = n * c - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_a = F.pad(log_a, (0, pad))        # a = 1, kv = 0: a no-op
    f32 = torch.float32
    qc = q.reshape(B, H, n, c, dk).to(f32)
    kc = k.reshape(B, H, n, c, dk).to(f32)
    vc = v.reshape(B, H, n, c, dv).to(f32)
    lac = log_a.reshape(B, H, n, c).to(f32)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=q.device))
    if initial_state is None:
        S = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
    else:
        S = initial_state.to(f32)
    ys = []
    for i in range(n):
        qb, kb, vb = qc[:, :, i], kc[:, :, i], vc[:, :, i]
        lb = torch.cumsum(lac[:, :, i], dim=-1)           # inclusive
        # intra-chunk: D_ij = exp(lb_i - lb_j), j <= i
        D = torch.exp(torch.where(causal, lb[..., :, None] - lb[..., None, :],
                                  -torch.inf))
        att = torch.einsum("bhid,bhjd->bhij", qb, kb) * D
        y = torch.einsum("bhij,bhjv->bhiv", att, vb)
        # inter-chunk contribution from the carried state
        y = y + torch.exp(lb)[..., None] * torch.einsum("bhid,bhdv->bhiv",
                                                         qb, S)
        # state update to the end of the chunk
        decay_to_end = torch.exp(lb[..., -1:] - lb)
        U = torch.einsum("bhjd,bhjv->bhdv", kb * decay_to_end[..., None], vb)
        S = torch.exp(lb[..., -1])[..., None, None] * S + U
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :T]
    return y.to(v.dtype), S


def gla_step_ref(S, q, k, v, log_a):
    """One decode step, ``repro.models.ssm.gla_step``: S (B, H, dk, dv);
    q, k (B, H, dk); v (B, H, dv); log_a (B, H). Returns (y (B, H, dv) in
    v's dtype, the new state float32)."""
    f32 = torch.float32
    S = S.to(f32)
    a = torch.exp(log_a.to(f32))[..., None, None]
    S_new = a * S + torch.einsum("bhk,bhv->bhkv", k.to(f32), v.to(f32))
    y = torch.einsum("bhk,bhkv->bhv", q.to(f32), S_new)
    return y.to(v.dtype), S_new


def _check(q, k, v, log_a, chunk, initial_state):
    """Raise on any operand the kernel does not take."""
    if not q.is_cuda:
        raise ValueError(f"gla_scan launches a CUDA kernel; got a tensor on "
                         f"{q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3] or log_a.shape != q.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, log_a {tuple(log_a.shape)}: "
                         "q, k (B, H, T, dk), v (B, H, T, dv), log_a "
                         "(B, H, T)")
    B, H, T, dk = q.shape
    if initial_state is not None and \
            initial_state.shape != (B, H, dk, v.shape[-1]):
        raise ValueError(f"initial state {tuple(initial_state.shape)} is "
                         "not (B, H, dk, dv)")
    if v.dtype not in DTYPES:
        raise TypeError(f"gla_scan writes y in v's dtype, float32 or "
                        f"bfloat16; got {v.dtype}")
    for t in (k, v, log_a) + (() if initial_state is None
                              else (initial_state,)):
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
        if not t.is_floating_point():
            raise TypeError(f"gla_scan takes floating operands, got "
                            f"{t.dtype}")
    if (T > 0 and not 1 <= min(chunk, T) <= MAX_CHUNK) or dk > MAX_DK:
        raise ValueError(f"chunk {chunk} / dk {dk} not taken: the kernel "
                         f"takes chunks of 1-{MAX_CHUNK} steps and dk up "
                         f"to {MAX_DK}")


def gla_scan_fwd(q, k, v, log_a, *, chunk: int, initial_state=None):
    """Launch the kernel on the current stream. The operands are cast to
    float32 and made contiguous first (a stride-0 broadcast, as Mamba2's
    shared q and k, is materialized). Returns (y like v, the final state
    (B, H, dk, dv) float32). Raises on any operand the kernel does not
    take, a CPU tensor included."""
    _check(q, k, v, log_a, chunk, initial_state)
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    y = torch.empty((B, H, T, dv), dtype=v.dtype, device=dev)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    if B * H == 0 or dv == 0:
        return y, state
    if T == 0:
        return y, (torch.zeros_like(state) if initial_state is None
                   else initial_state.to(torch.float32).clone())
    c = min(chunk, T)
    n = -(-T // c)
    cpad = -(-c // 64) * 64
    f32 = [t.to(torch.float32).contiguous() for t in (q, k, v, log_a)]
    s0 = None if initial_state is None \
        else initial_state.to(torch.float32).contiguous()
    # scratch: the masked, decayed intra-chunk scores (transposed) and the
    # chunks' cumulative log decays
    scores = torch.empty((B * H, n, cpad, cpad), dtype=torch.float32,
                         device=dev)
    lb = torch.empty((B * H, n, cpad), dtype=torch.float32, device=dev)
    err = _build.lib().gla_scan_launch(
        *(t.data_ptr() for t in f32), 0 if s0 is None else s0.data_ptr(),
        y.data_ptr(), state.data_ptr(), scores.data_ptr(), lb.data_ptr(),
        B * H, T, dk, dv, c, DTYPES[v.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gla_scan")
    gla_scan_fwd.launches += 1
    return y, state


gla_scan_fwd.launches = 0


class GLAScan(torch.autograd.Function):
    """The kernel as an autograd Function. It has no backward: the TPU
    kernel had none either (the reference differentiates ``chunked_gla``
    through XLA), and a gradient kernel is later work. The backward
    raises rather than differentiate the plain version on the card."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, chunk, initial_state):
        return gla_scan_fwd(q, k, v, log_a, chunk=chunk,
                            initial_state=initial_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        raise NotImplementedError(
            "gla_scan has no backward kernel yet: training an SSM model on "
            "the card waits for the gla backward (ROADMAP, 'What remains' "
            "item 1)")


def gla_scan(q, k, v, log_a, *, chunk: int = 128, initial_state=None):
    """The reference's signature (plus ``initial_state``, which
    ``chunked_gla`` takes): the kernel on CUDA tensors. Returns (y, final
    state)."""
    return GLAScan.apply(q, k, v, log_a, chunk, initial_state)
