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
``csrc/gla_scan.cu``, the forward's kernels and the backward's
(``gla_scan_bwd``, held against ``chunked_gla_bwd_ref``, the plain
backward written out op for op).

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
# the (q, k, v) dtypes the backward takes, as the models hand them: all
# float32, all bf16, the mLSTM's (k float32 beside bf16 q and v) and
# mamba2's (v float32 beside bf16 q and k)
BWD_DTYPES = {(torch.float32,) * 3, (torch.bfloat16,) * 3,
              (torch.bfloat16, torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.bfloat16, torch.float32)}


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


def chunked_gla_bwd_ref(q, k, v, log_a, chunk: int, initial_state, dy,
                        dstate=None):
    """The plain backward of ``chunked_gla_ref``, the chunk form written
    out op for op (the gradient ``jax.vjp`` of the reference's
    ``chunked_gla`` gives), and the kernel's oracle on the card. dy
    (B, H, T, dv) is the gradient of y, ``dstate`` (B, H, dk, dv) that of
    the final state or None (zero). The states entering each chunk, S_n,
    are formed left to right as the forward forms them; then a sweep right
    to left carries dS, the gradient of the state leaving the chunk. Per
    chunk, with lb the inclusive cumsum of log_a, c the chunk's last step
    and D_ij = exp(lb_i - lb_j) under the causal mask:

        dA = D * (dy v^T),  P = D * (q k^T)
        dq = dA k + exp(lb_i) dy S_n^T
        dk = dA^T q + exp(lb_c - lb_j) v dS^T
        dv = P^T dy + exp(lb_c - lb_j) k dS
        dS <- exp(lb_c) dS + (q exp(lb_i))^T dy

    d log_a needs no gradient of the decay matrix: with b_t the running
    sum of log_a over the whole sequence, dL/db_t = q_t . dq_t - k_t .
    dk_t, plus <dstate, S_T> at the last step, and d log_a is its reverse
    cumulative sum. The dS left at the end is the initial state's
    gradient (None without an initial state). Padded steps (log_a 0, k =
    v = dy = 0) are dropped. Returns (dq, dk, dv, dlog_a,
    dinitial_state) in float32, or in float64 where log_a is float64 (the
    forward's witness mode)."""
    B, H, T, dk_ = q.shape
    dv_ = v.shape[-1]
    ct = torch.float64 if log_a.dtype == torch.float64 else torch.float32
    c = min(chunk, T)
    n = -(-T // c)
    pad = n * c - T
    q0, k0 = q.to(ct), k.to(ct)
    if pad:
        q, k, v, dy = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, dy))
        log_a = F.pad(log_a, (0, pad))
    qc = q.reshape(B, H, n, c, dk_).to(ct)
    kc = k.reshape(B, H, n, c, dk_).to(ct)
    vc = v.reshape(B, H, n, c, dv_).to(ct)
    dyc = dy.reshape(B, H, n, c, dv_).to(ct)
    lb = torch.cumsum(log_a.reshape(B, H, n, c).to(ct), dim=-1)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=q.device))
    S = torch.zeros((B, H, dk_, dv_), dtype=ct, device=q.device) \
        if initial_state is None else initial_state.to(ct)
    states = []
    for i in range(n):
        states.append(S)
        last = lb[:, :, i, -1:]
        decayed = kc[:, :, i] * torch.exp(last - lb[:, :, i])[..., None]
        S = torch.exp(last)[..., None] * S + torch.einsum(
            "bhjd,bhjv->bhdv", decayed, vc[:, :, i])
    dS = torch.zeros_like(S) if dstate is None else dstate.to(ct)
    dq, dk, dv = (torch.empty_like(t) for t in (qc, kc, vc))
    for i in reversed(range(n)):
        qb, kb, vb, dyb, li = (qc[:, :, i], kc[:, :, i], vc[:, :, i],
                               dyc[:, :, i], lb[:, :, i])
        D = torch.exp(torch.where(causal, li[..., :, None] - li[..., None, :],
                                  -torch.inf))
        dA = D * torch.einsum("bhiv,bhjv->bhij", dyb, vb)
        P = D * torch.einsum("bhid,bhjd->bhij", qb, kb)
        dec = torch.exp(li[..., -1:] - li)[..., None]
        dq[:, :, i] = torch.einsum("bhij,bhjd->bhid", dA, kb) \
            + torch.exp(li)[..., None] * torch.einsum("bhiv,bhdv->bhid", dyb,
                                                      states[i])
        dk[:, :, i] = torch.einsum("bhij,bhid->bhjd", dA, qb) \
            + dec * torch.einsum("bhjv,bhdv->bhjd", vb, dS)
        dv[:, :, i] = torch.einsum("bhij,bhiv->bhjv", P, dyb) \
            + dec * torch.einsum("bhjd,bhdv->bhjv", kb, dS)
        dS = torch.exp(li[..., -1])[..., None, None] * dS + torch.einsum(
            "bhid,bhiv->bhdv", qb * torch.exp(li)[..., None], dyb)
    dq, dk, dv = (t.reshape(B, H, n * c, -1)[:, :, :T] for t in (dq, dk, dv))
    delta = (q0 * dq).sum(-1) - (k0 * dk).sum(-1)
    if dstate is not None and T > 0:
        delta[..., -1] += (dstate.to(ct) * S).sum((-2, -1))
    dlog_a = torch.flip(torch.cumsum(torch.flip(delta, (-1,)), -1), (-1,))
    return dq, dk, dv, dlog_a, None if initial_state is None else dS


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


def gla_scan_bwd(q, k, v, log_a, dy, *, chunk: int, initial_state=None,
                 dstate=None):
    """Launch the backward kernels on the current stream: the gradients
    of ``gla_scan_fwd``'s (y, final state) with respect to (q, k, v,
    log_a, initial_state), given dy (the gradient of y) and ``dstate``
    (of the final state; None for zero). The operands are read in place
    as the forward reads them, dy in v's dtype. Returns (dq, dk, dv,
    dlog_a, dinitial_state): dq, dk and dv in the dtypes the kernel read
    their operands in (``in_place``), dense per head (a stride-0 q or k
    gets one gradient per head), each the first columns of an
    ``aligned_empty`` buffer; dlog_a and dinitial_state float32, the
    latter None without an initial state (``GLAScan`` casts each to its
    operand's dtype). Raises on any operand the kernel does not take
    (dtypes outside ``BWD_DTYPES`` among them, as ``in_place`` leaves
    them), a CPU tensor included."""
    kinds = tuple(t.dtype if t.dtype in DTYPES else torch.float32
                  for t in (q, k, v))
    if kinds not in BWD_DTYPES:
        raise TypeError("gla_scan_bwd takes q, k and v all float32, all "
                        "bfloat16, or bfloat16 beside a float32 k or v "
                        "(the mLSTM's and mamba2's); got "
                        f"{tuple(str(d)[6:] for d in kinds)}")
    _check(q, k, v, log_a, chunk, initial_state)
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    if tuple(dy.shape) != (B, H, T, dv) or dy.device != dev:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} is not y's "
                         f"{(B, H, T, dv)} on {dev}")
    if dstate is not None and (tuple(dstate.shape) != (B, H, dk, dv)
                               or dstate.device != dev):
        raise ValueError(f"dstate {tuple(dstate.shape)} on {dstate.device} "
                         f"is not the state's {(B, H, dk, dv)} on {dev}")
    q, k, v = (in_place(t) for t in (q, k, v))
    f32 = torch.float32
    dq = aligned_empty((B, H, T, dk), q.dtype, dev)
    dk_ = aligned_empty((B, H, T, dk), k.dtype, dev)
    dv_ = aligned_empty((B, H, T, dv), v.dtype, dev)
    dla = torch.empty((B, H, T), dtype=f32, device=dev)
    ds0 = None if initial_state is None \
        else torch.empty((B, H, dk, dv), dtype=f32, device=dev)
    if B * H == 0 or dv == 0 or T == 0:
        for t in (dq, dk_, dv_, dla):
            t.zero_()
        if ds0 is not None and dstate is not None:
            ds0.copy_(dstate)     # T 0: the final state is the initial one
        elif ds0 is not None:
            ds0.zero_()
        return dq, dk_, dv_, dla, ds0
    c = min(chunk, T)
    n = -(-T // c)
    cpad = -(-c // 64) * 64
    dvp, dkp = padded_width(dv), padded_width(dk)
    dy = in_place(dy.to(v.dtype))
    la = log_a.to(f32).contiguous()
    s0 = None if initial_state is None \
        else initial_state.to(f32).contiguous()
    ds = None if dstate is None else dstate.to(f32).contiguous()
    terms = TERMS[v.dtype]
    R = B * H
    # scratch: the forward's lb and state terms again, the final state, the
    # dS leaving each chunk as its terms, P's and dA's terms, and q . dq and
    # k . dk by 64-column slice of dk
    lb = torch.empty((R, n, cpad), dtype=f32, device=dev)
    state = torch.empty((R, dk, dv), dtype=f32, device=dev)
    states = torch.empty((2, terms, R, n, dk, dvp), dtype=torch.bfloat16,
                         device=dev)
    scores = torch.empty((2, terms, R, n, cpad, cpad), dtype=torch.bfloat16,
                         device=dev)
    part = torch.empty((2, -(-dk // 64), R, T), dtype=f32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    err = _build.lib().gla_scan_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(),
        la.data_ptr(), ptr(s0), ptr(ds), state.data_ptr(), lb.data_ptr(),
        states[0].data_ptr(), states[1].data_ptr(), scores[0].data_ptr(),
        scores[1].data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
        ptr(ds0), part.data_ptr(), dla.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dy.stride()[:3], B, H, T, dk, dv, c, dvp, dkp,
        DTYPES[q.dtype], DTYPES[k.dtype], DTYPES[v.dtype], terms,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gla_scan_bwd")
    gla_scan_bwd.launches += 1
    return dq, dk_, dv_, dla, ds0


gla_scan_bwd.launches = 0


class GLAScan(torch.autograd.Function):
    """The kernel as an autograd Function. The forward saves its inputs
    alone; the backward launches ``gla_scan_bwd``, which forms the
    chunk-entry states again (the TPU kernel had no backward: the
    reference differentiates ``chunked_gla`` through XLA, and
    ``chunked_gla_bwd_ref`` is that gradient written out). Gradients come
    back in their operands' dtypes, None for an input that needs none."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, chunk, initial_state):
        ctx.chunk = chunk
        ctx.save_for_backward(q, k, v, log_a, initial_state)
        ctx.set_materialize_grads(False)
        return gla_scan_fwd(q, k, v, log_a, chunk=chunk,
                            initial_state=initial_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        q, k, v, log_a, s0 = ctx.saved_tensors
        if dy is None and dstate is None:
            return (None,) * 6
        grads = gla_scan_bwd(q, k, v, log_a,
                             torch.zeros_like(v) if dy is None else dy,
                             chunk=ctx.chunk, initial_state=s0, dstate=dstate)
        need = ctx.needs_input_grad[:4] + ctx.needs_input_grad[5:]
        out = [g.to(t.dtype) if g is not None and n else None
               for g, t, n in zip(grads, (q, k, v, log_a, s0), need)]
        return (*out[:4], None, out[4])


def gla_scan(q, k, v, log_a, *, chunk: int = 128, initial_state=None):
    """The reference's signature (plus ``initial_state``, which
    ``chunked_gla`` takes): the kernel on CUDA tensors. Returns (y, final
    state)."""
    return GLAScan.apply(q, k, v, log_a, chunk, initial_state)
