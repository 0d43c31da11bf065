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

The kernel reads q, k and v in place, float32 or bfloat16, through their
(B, H, T) strides, where every row starts on 16 bytes (``aligned``); it
multiplies on the tensor cores, a float32 operand split into bf16 terms
(``TERMS``, by y's dtype). y comes back as the first dv columns of a
buffer whose rows are padded to a multiple of 8 elements
(``aligned_empty``), as the mLSTM builds its v.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_CHUNK = 256      # steps of a chunk: the decays of one block
# bf16 terms of a float32 operand, by y's (v's) dtype (csrc kTermsOf):
# two leave ~1e-5 of the float32 result, below a bf16 y's rounding; three
# ~2e-7, as float32 sums, for a float32 y
TERMS = {torch.bfloat16: 2, torch.float32: 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def padded_width(n: int) -> int:
    """n rounded up to a multiple of 8 elements: rows of that pitch start
    on 16 bytes in either dtype."""
    return -(-n // 8) * 8


def aligned_empty(shape, dtype, device):
    """An uninitialized tensor of ``shape`` whose rows (the last dimension)
    start on 16 bytes: the first ``shape[-1]`` columns of a buffer padded
    to ``padded_width``."""
    *lead, n = shape
    buf = torch.empty((*lead, padded_width(n)), dtype=dtype, device=device)
    return buf[..., :n]


def aligned(t) -> bool:
    """Whether the kernel reads ``t`` in place: float32 or bfloat16, unit
    stride along the last dimension, and every row of it starting on 16
    bytes (the data pointer and each stride of a dimension longer than 1,
    in bytes, multiples of 16; a stride-0 broadcast passes)."""
    if t.dtype not in DTYPES:
        return False
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return False
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def in_place(t):
    """``t`` itself where the kernel reads it in place; else a copy in an
    ``aligned_empty`` buffer, in float32 unless ``t`` is float32 or
    bfloat16 already (so a bf16 operand is never widened)."""
    if aligned(t):
        return t
    dtype = t.dtype if t.dtype in DTYPES else torch.float32
    out = aligned_empty(tuple(t.shape), dtype, t.device)
    out.copy_(t)
    return out


def chunked_gla_ref(q, k, v, log_a, chunk: int, initial_state=None):
    """The plain version, ``repro.models.ssm.chunked_gla`` op for op, with
    a Python loop over the chunks in place of ``lax.scan``. The decay
    ``exp(lb_i - lb_j)`` is formed under the causal mask (``-inf`` above
    the diagonal), so it never overflows there and stays differentiable;
    the reference forms it everywhere and masks after the ``exp``, which
    gives the same values. It works in float32, as the reference does, or
    in float64 where ``log_a`` is float64 (a model on float64 params: a
    witness for the float32 chunked form's own rounding). Returns (y in
    v's dtype, state in the working type)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, T)
    n = -(-T // c)
    pad = n * c - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_a = F.pad(log_a, (0, pad))        # a = 1, kv = 0: a no-op
    ct = torch.float64 if log_a.dtype == torch.float64 else torch.float32
    qc = q.reshape(B, H, n, c, dk).to(ct)
    kc = k.reshape(B, H, n, c, dk).to(ct)
    vc = v.reshape(B, H, n, c, dv).to(ct)
    lac = log_a.reshape(B, H, n, c).to(ct)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=q.device))
    if initial_state is None:
        S = torch.zeros((B, H, dk, dv), dtype=ct, device=q.device)
    else:
        S = initial_state.to(ct)
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
    if T > 0 and not 1 <= min(chunk, T) <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not taken: the kernel takes chunks "
                         f"of 1-{MAX_CHUNK} steps")


def gla_scan_fwd(q, k, v, log_a, *, chunk: int, initial_state=None):
    """Launch the kernel on the current stream. q, k and v are read in
    place (``in_place``: a stride-0 broadcast, as Mamba2's shared q and k,
    and the mLSTM's transposed views included); log_a and the initial
    state are read as contiguous float32. Returns (y like v, as the first
    dv columns of an ``aligned_empty`` buffer; the final state (B, H, dk,
    dv) float32). Raises on any operand the kernel does not take, a CPU
    tensor included."""
    _check(q, k, v, log_a, chunk, initial_state)
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    y = aligned_empty((B, H, T, dv), v.dtype, dev)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    if B * H == 0 or dv == 0:
        return y, state
    if T == 0:
        return y, (torch.zeros_like(state) if initial_state is None
                   else initial_state.to(torch.float32).clone())
    c = min(chunk, T)
    n = -(-T // c)
    cpad = -(-c // 64) * 64
    dvp = padded_width(dv)
    q, k, v = (in_place(t) for t in (q, k, v))
    la = log_a.to(torch.float32).contiguous()
    s0 = None if initial_state is None \
        else initial_state.to(torch.float32).contiguous()
    # scratch: the chunks' cumulative log decays, the masked decayed scores
    # and the chunk-entry states, each of the last two as its bf16 terms
    terms = TERMS[v.dtype]
    lb = torch.empty((B * H, n, cpad), dtype=torch.float32, device=dev)
    scores = torch.empty((terms, B * H, n, cpad, cpad), dtype=torch.bfloat16,
                         device=dev)
    states = torch.empty((terms, B * H, n, dk, dvp), dtype=torch.bfloat16,
                         device=dev)
    err = _build.lib().gla_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(),
        0 if s0 is None else s0.data_ptr(), y.data_ptr(), state.data_ptr(),
        lb.data_ptr(), scores.data_ptr(), states.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        B, H, T, dk, dv, c, dvp,
        DTYPES[q.dtype], DTYPES[k.dtype], DTYPES[v.dtype], terms,
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
            "the card waits for the gla backward (ROADMAP, 'The kernel "
            "work that remains': '8b. The gla backward')")


def gla_scan(q, k, v, log_a, *, chunk: int = 128, initial_state=None):
    """The reference's signature (plus ``initial_state``, which
    ``chunked_gla`` takes): the kernel on CUDA tensors. Returns (y, final
    state)."""
    return GLAScan.apply(q, k, v, log_a, chunk, initial_state)
