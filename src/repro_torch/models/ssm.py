"""The SSM family, counterpart of ``repro.models.ssm``: a shared
chunkwise-parallel gated-linear-attention (GLA) core used by both Mamba2
(SSD form) and xLSTM's mLSTM (matrix memory), plus the truly recurrent
sLSTM cell.

Recurrence (per batch, head):   S_t = a_t * S_{t-1} + k_t v_t^T
                                y_t = q_t @ S_t
with a_t in (0, 1] a scalar decay. The full-sequence forward takes it in
chunks (``chunked_gla``, the ``gla_scan`` kernel on the card); decode
takes one step (``gla_step``). mLSTM folds its exponential input gate into
k (stabilized by the max-plus scan m_t = max(log_f_t + m_{t-1}, i_t)) and
its normalizer into an extra all-ones value channel.

The functions follow the reference op for op, and JAX's dtype promotion:
a product of a bfloat16 and a float32 operand is taken in float32
(``_mm``), so a bf16 model's states, gates and normalized outputs are
float32 where the reference's are. The sLSTM recurrence, a ``lax.scan``
with no kernel in the reference, is a Python loop over the steps.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.kernels import ops
from repro_torch.kernels.gla_scan import aligned_empty, gla_step_ref
from repro_torch.models.common import dense_init, rms_norm

F32 = torch.float32
# the leaves the reference's init keeps float32 at any model dtype
FLOAT32_PARAMS = {"mamba2": ("A_log", "D", "dt_bias"),
                  "mlstm": ("w_if", "b_i", "b_f"), "slstm": ("b",)}


def _mm(a, b):
    """``a @ b`` with JAX's promotion: mixed operands go to the wider
    type (torch's matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ==========================================================================
# Core: chunkwise gated linear attention
# ==========================================================================

def chunked_gla(q, k, v, log_a, chunk: int, initial_state=None):
    """q, k: (B, H, T, dk); v: (B, H, T, dv); log_a: (B, H, T) with
    log_a <= 0. Returns (y (B, H, T, dv), final_state (B, H, dk, dv)):
    the kernel for CUDA tensors, its plain version for CPU tensors."""
    return ops.gla_scan_op(q, k, v, log_a, chunk=chunk,
                           initial_state=initial_state)


# single decode step: S (B, H, dk, dv); q, k (B, H, dk); v (B, H, dv);
# log_a (B, H) -> (y (B, H, dv), S_new); plain PyTorch on every device (the
# reference has no kernel for it)
gla_step = gla_step_ref


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along the last axis (len(a) is len(b)
    or len(b) + 1)."""
    out = a.new_empty(a.shape[:-1] + (a.shape[-1] + b.shape[-1],))
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def _associative_scan(fn, elems):
    """``jax.lax.associative_scan`` along the last axis: the same
    odd/even recursion, so the same operations in the same order."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = fn([e[..., 0:-1:2] for e in elems],
                 [e[..., 1::2] for e in elems])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[..., :-1] for e in odd], [e[..., 2::2] for e in elems])
    else:
        even = fn(odd, [e[..., 2::2] for e in elems])
    even = [torch.cat([e[..., :1], r], dim=-1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _maxplus_scan(log_f, i_tilde, m0):
    """m_t = max(m_{t-1} + log_f_t, i_tilde_t) via associative scan.

    Composition of (alpha, beta) |-> m = max(m_prev + alpha, beta):
      (a1,b1) then (a2,b2) == (a1+a2, max(b1+a2, b2)).
    log_f, i_tilde: (..., T); m0: (...,). Returns m (..., T).
    """
    def combine(x, y):
        a1, b1 = x
        a2, b2 = y
        return [a1 + a2, torch.maximum(b1 + a2, b2)]

    alpha, beta = _associative_scan(combine, [log_f, i_tilde])
    return torch.maximum(m0[..., None] + alpha, beta)


# ==========================================================================
# Causal depthwise conv (mamba2 / mLSTM front conv)
# ==========================================================================

def causal_conv(x, w, b, history=None):
    """x: (B, T, C); w: (width, C) depthwise; causal (left) padding, or the
    previous chunk's tail (B, width-1, C) when continuing a sequence. The
    cross-correlation in float32 as width shifted products summed in
    order: no convolution library (whose float32 may be TF32)."""
    width, T = w.shape[0], x.shape[1]
    if history is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([history.to(x.dtype), x], dim=1)
    xp, wf = xp.to(F32), w.to(F32)
    out = xp[:, 0:T] * wf[0]
    for j in range(1, width):
        out = out + xp[:, j:j + T] * wf[j]
    return (out + b).to(x.dtype)


def causal_conv_step(conv_state, x_new, w, b):
    """conv_state: (B, width-1, C) past inputs; x_new: (B, C)."""
    window = torch.cat([conv_state, x_new[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", window.to(F32), w.to(F32)) + b
    return out.to(x_new.dtype), window[:, 1:]


# ==========================================================================
# Mamba2 block (SSD)
# ==========================================================================

def init_mamba2(generator: torch.Generator, d_model: int, s: SSMCfg, *,
                dtype: torch.dtype, device):
    d_inner = s.expand * d_model
    conv_dim = d_inner + 2 * s.d_state
    H = s.n_heads
    kw, f32 = dict(dtype=dtype, device=device), dict(dtype=F32, device=device)
    return {
        "w_in": dense_init(generator,
                           (d_model, 2 * d_inner + 2 * s.d_state + H), **kw),
        "conv_w": dense_init(generator, (s.d_conv, conv_dim), in_axis=0,
                             **kw),
        "conv_b": torch.zeros((conv_dim,), **kw),
        "A_log": torch.log(torch.arange(1, H + 1, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), math.log(math.e - 1), **f32),
        "gate_norm": torch.zeros((d_inner,), **kw),
        "w_out": dense_init(generator, (d_inner, d_model), **kw),
    }


def _mamba2_split(s: SSMCfg, d_model, zxbcdt):
    d_inner = s.expand * d_model
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * s.d_state,
                                s.n_heads], dim=-1)


def _mamba2_ssm_inputs(p, s: SSMCfg, xBC, dt, d_inner):
    """xBC: (..., conv_dim) post-conv; dt: (..., H)."""
    H = s.n_heads
    hd = d_inner // H
    x_in, Bmat, Cmat = torch.split(xBC, [d_inner, s.d_state, s.d_state],
                                   dim=-1)
    dt = _softplus(dt.to(F32) + p["dt_bias"])
    log_a = -torch.exp(p["A_log"]) * dt                   # (..., H)
    xh = x_in.reshape(*x_in.shape[:-1], H, hd)
    v = xh * dt[..., None]
    return x_in, xh, Bmat, Cmat, v, log_a


def _conv_state(conv_tail, s: SSMCfg):
    pad_t = max(0, s.d_conv - 1 - conv_tail.shape[1])
    return F.pad(conv_tail, (0, 0, pad_t, 0))


def mamba2_forward(p, s: SSMCfg, d_model: int, x, initial_state=None):
    """x: (B, T, d). Returns (out, state {"conv", "ssm"})."""
    B, T, _ = x.shape
    d_inner = s.expand * d_model
    H = s.n_heads
    z, xBC, dt = _mamba2_split(s, d_model, _mm(x, p["w_in"]))
    conv_hist = None if initial_state is None else initial_state["conv"]
    ssm_init = None if initial_state is None else initial_state["ssm"]
    pre_conv = xBC if conv_hist is None else \
        torch.cat([conv_hist.to(xBC.dtype), xBC], dim=1)
    conv_tail = pre_conv[:, max(0, pre_conv.shape[1] - (s.d_conv - 1)):]
    xBC = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"], conv_hist))
    x_in, xh, Bmat, Cmat, v, log_a = _mamba2_ssm_inputs(p, s, xBC, dt,
                                                        d_inner)
    q = Cmat[:, None].expand(B, H, T, s.d_state)
    k = Bmat[:, None].expand(B, H, T, s.d_state)
    y, S = chunked_gla(q, k, v.transpose(1, 2), log_a.transpose(1, 2),
                       s.chunk_size, ssm_init)
    y = y.transpose(1, 2) + p["D"][:, None] * xh            # (B, T, H, hd)
    y = y.reshape(B, T, d_inner)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["gate_norm"])
    out = _mm(y, p["w_out"])
    return out, {"conv": _conv_state(conv_tail, s), "ssm": S}


def mamba2_decode(p, s: SSMCfg, d_model: int, x, state):
    """x: (B, d); state {"conv": (B, w-1, conv_dim), "ssm": (B,H,dk,hd)}."""
    B, _ = x.shape
    d_inner = s.expand * d_model
    H = s.n_heads
    z, xBC, dt = _mamba2_split(s, d_model, _mm(x, p["w_in"]))
    xBC, conv_state = causal_conv_step(state["conv"], xBC, p["conv_w"],
                                       p["conv_b"])
    xBC = F.silu(xBC)
    x_in, xh, Bmat, Cmat, v, log_a = _mamba2_ssm_inputs(p, s, xBC, dt,
                                                        d_inner)
    q = Cmat[:, None].expand(B, H, s.d_state)
    k = Bmat[:, None].expand(B, H, s.d_state)
    y, S = gla_step(state["ssm"], q, k, v, log_a)          # (B, H, hd)
    y = y + p["D"][:, None] * xh
    y = y.reshape(B, d_inner)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["gate_norm"])
    return _mm(y, p["w_out"]), {"conv": conv_state, "ssm": S}


def mamba2_state_shapes(s: SSMCfg, d_model: int, batch: int, dtype, *,
                        device="cpu"):
    d_inner = s.expand * d_model
    H, hd = s.n_heads, d_inner // s.n_heads
    return {"conv": torch.zeros((batch, s.d_conv - 1,
                                 d_inner + 2 * s.d_state), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, H, s.d_state, hd), dtype=F32,
                               device=device)}


# ==========================================================================
# mLSTM block (xLSTM matrix memory)
# ==========================================================================

def init_mlstm(generator: torch.Generator, d_model: int, s: SSMCfg, *,
               dtype: torch.dtype, device):
    d_inner = s.expand * d_model
    H = s.n_heads
    kw, f32 = dict(dtype=dtype, device=device), dict(dtype=F32, device=device)
    return {
        "w_up": dense_init(generator, (d_model, 2 * d_inner), **kw),
        "conv_w": dense_init(generator, (s.d_conv, d_inner), in_axis=0,
                             **kw),
        "conv_b": torch.zeros((d_inner,), **kw),
        "w_q": dense_init(generator, (d_inner, d_inner), **kw),
        "w_k": dense_init(generator, (d_inner, d_inner), **kw),
        "w_v": dense_init(generator, (d_inner, d_inner), **kw),
        "w_if": dense_init(generator, (d_inner, 2 * H), **f32),
        "b_i": torch.zeros((H,), **f32),
        "b_f": torch.full((H,), 3.0, **f32),   # bias toward remembering
        "head_norm": torch.zeros((d_inner,), **kw),
        "w_down": dense_init(generator, (d_inner, d_model), **kw),
    }


def _mlstm_gates(p, x_branch):
    gf = x_branch.to(F32) @ p["w_if"]
    H = p["b_i"].shape[0]
    i_tilde = gf[..., :H] + p["b_i"]
    log_f = F.logsigmoid(gf[..., H:] + p["b_f"])
    return i_tilde, log_f


def _mlstm_out(p, y_aug, m, hd):
    """h = num / max(|den|, exp(-m)) from the augmented GLA output."""
    num, den = y_aug[..., :hd], y_aug[..., hd]
    return num / torch.maximum(den.abs(), torch.exp(-m))[..., None]


def mlstm_forward(p, s: SSMCfg, d_model: int, x, initial_state=None):
    """x: (B, T, d). State: {"conv", "S" (B,H,dk,hd+1), "m" (B,H)}."""
    B, T, _ = x.shape
    d_inner = s.expand * d_model
    H, hd = s.n_heads, d_inner // s.n_heads
    x_branch, z = torch.chunk(_mm(x, p["w_up"]), 2, dim=-1)
    conv_hist = None if initial_state is None else initial_state["conv"]
    pre_conv = x_branch if conv_hist is None else \
        torch.cat([conv_hist.to(x_branch.dtype), x_branch], dim=1)
    conv_tail = pre_conv[:, max(0, pre_conv.shape[1] - (s.d_conv - 1)):]
    xc = F.silu(causal_conv(x_branch, p["conv_w"], p["conv_b"], conv_hist))
    q = _mm(xc, p["w_q"]).reshape(B, T, H, hd)
    k = _mm(xc, p["w_k"]).reshape(B, T, H, hd)
    v = _mm(x_branch, p["w_v"]).reshape(B, T, H, hd)
    k = k / math.sqrt(hd)
    i_tilde, log_f = _mlstm_gates(p, x_branch)             # (B, T, H)
    i_tilde = i_tilde.transpose(1, 2)
    log_f = log_f.transpose(1, 2)                          # (B, H, T)

    if initial_state is None:
        m0 = torch.full((B, H), -1e30, dtype=F32, device=x.device)
        S0 = None
    else:
        m0 = initial_state["m"]
        S0 = initial_state["S"]
    m = _maxplus_scan(log_f, i_tilde, m0)                  # (B, H, T)
    m_prev = torch.cat([m0[..., None], m[..., :-1]], dim=-1)
    # Clamp: exp(-30) ~ 1e-13 is already a hard zero for f32 accumulators,
    # and an unclamped -1e30 (the "no history" stabilizer) would absorb the
    # following small decays inside chunked_gla's cumsum (float addition).
    log_a = torch.clamp(log_f + m_prev - m, min=-30.0)    # <= 0
    i_eff = torch.exp(i_tilde - m)                         # stabilized gate

    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2) * i_eff[..., None]
    vh = v.transpose(1, 2)
    # [v, 1] with rows padded to 16 bytes, so the kernel reads it in place
    # (a contiguous bf16 row of hd + 1 = 513 is only 2-byte aligned)
    v_aug = aligned_empty((B, H, T, hd + 1), vh.dtype, vh.device)
    v_aug[..., :hd] = vh
    v_aug[..., hd] = 1
    y_aug, S = chunked_gla(qh, kh, v_aug, log_a, s.chunk_size, S0)
    h = _mlstm_out(p, y_aug, m, hd)
    h = h.transpose(1, 2).reshape(B, T, d_inner)
    h = rms_norm(h, p["head_norm"])
    h = h * F.silu(z.to(F32)).to(h.dtype)
    out = _mm(h, p["w_down"])
    return out, {"conv": _conv_state(conv_tail, s), "S": S, "m": m[..., -1]}


def mlstm_decode(p, s: SSMCfg, d_model: int, x, state):
    B, _ = x.shape
    d_inner = s.expand * d_model
    H, hd = s.n_heads, d_inner // s.n_heads
    x_branch, z = torch.chunk(_mm(x, p["w_up"]), 2, dim=-1)
    xc, conv_state = causal_conv_step(state["conv"], x_branch, p["conv_w"],
                                      p["conv_b"])
    xc = F.silu(xc)
    q = _mm(xc, p["w_q"]).reshape(B, H, hd)
    k = _mm(xc, p["w_k"]).reshape(B, H, hd) / math.sqrt(hd)
    v = _mm(x_branch, p["w_v"]).reshape(B, H, hd)
    i_tilde, log_f = _mlstm_gates(p, x_branch)             # (B, H)
    m_prev = state["m"]
    m = torch.maximum(log_f + m_prev, i_tilde)
    log_a = torch.clamp(log_f + m_prev - m, min=-30.0)    # forward's clamp
    i_eff = torch.exp(i_tilde - m)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    y_aug, S = gla_step(state["S"], q, k * i_eff[..., None], v_aug, log_a)
    h = _mlstm_out(p, y_aug, m, hd).reshape(B, d_inner)
    h = rms_norm(h, p["head_norm"])
    h = h * F.silu(z.to(F32)).to(h.dtype)
    return _mm(h, p["w_down"]), {"conv": conv_state, "S": S, "m": m}


def mlstm_state_shapes(s: SSMCfg, d_model: int, batch: int, dtype, *,
                       device="cpu"):
    d_inner = s.expand * d_model
    H, hd = s.n_heads, d_inner // s.n_heads
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype,
                                device=device),
            "S": torch.zeros((batch, H, hd, hd + 1), dtype=F32,
                             device=device),
            "m": torch.full((batch, H), -1e30, dtype=F32, device=device)}


# ==========================================================================
# sLSTM block (scalar memory, true recurrence)
# ==========================================================================

def init_slstm(generator: torch.Generator, d_model: int, s: SSMCfg, *,
               dtype: torch.dtype, device):
    d_inner = s.expand * d_model
    H, hd = s.n_heads, d_inner // s.n_heads
    kw = dict(dtype=dtype, device=device)
    p = {
        "w_x": dense_init(generator, (d_model, 4 * d_inner), **kw),
        "r": dense_init(generator, (H, hd, 4 * hd), in_axis=1, **kw),
        "b": torch.cat([torch.zeros((d_inner,)), torch.full((d_inner,), 3.0),
                        torch.zeros((2 * d_inner,))]).to(device=device,
                                                         dtype=F32),
        "w_out": dense_init(generator, (d_inner, d_model), **kw),
    }
    if s.ff_mult:
        d_ff = int(s.ff_mult * d_inner)
        p["ff"] = {"w_up": dense_init(generator, (d_inner, d_ff), **kw),
                   "w_down": dense_init(generator, (d_ff, d_inner), **kw)}
    return p


def _slstm_step(p, s: SSMCfg, d_inner, gx, state, r32):
    """gx: (B, 4*d_inner) input-side gate preactivations (no bias yet);
    r32: the recurrent weights p["r"] in float32."""
    H, hd = s.n_heads, d_inner // s.n_heads
    c, n, h, m = state
    B = gx.shape[0]
    hr = h.reshape(B, H, hd)
    gr = torch.einsum("bhk,hkg->bhg", hr.to(F32), r32).reshape(B, 4 * d_inner)
    g = gx.to(F32) + gr + p["b"]
    i_t, f_t, z_t, o_t = torch.chunk(g, 4, dim=-1)
    m_new = torch.maximum(f_t + m, i_t)                    # exp forget gate
    i_e = torch.exp(i_t - m_new)
    f_e = torch.exp(f_t + m - m_new)
    c_new = f_e * c + i_e * torch.tanh(z_t)
    n_new = f_e * n + i_e
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_ff(p, h):
    """The post-cell FFN (jax.nn.gelu's default tanh approximation)."""
    if "ff" not in p:
        return h
    up = _mm(h, p["ff"]["w_up"])
    return h + _mm(F.gelu(up, approximate="tanh"), p["ff"]["w_down"])


def slstm_forward(p, s: SSMCfg, d_model: int, x, initial_state=None):
    """x: (B, T, d). Returns (out, state {"c", "n", "h", "m"})."""
    B, T, _ = x.shape
    d_inner = s.expand * d_model
    gx = _mm(x, p["w_x"])                                  # (B, T, 4*di)
    if initial_state is None:
        initial_state = slstm_state_shapes(s, d_model, B, F32,
                                           device=x.device)
    state = tuple(initial_state[k] for k in ("c", "n", "h", "m"))
    r32 = p["r"].to(F32)
    hs = []
    for t in range(T):
        state = _slstm_step(p, s, d_inner, gx[:, t], state, r32)
        hs.append(state[2])
    h = torch.stack(hs, dim=1).to(x.dtype)                 # (B, T, d_inner)
    out = _mm(_slstm_ff(p, h), p["w_out"])
    c, n, hh, m = state
    return out, {"c": c, "n": n, "h": hh, "m": m}


def slstm_decode(p, s: SSMCfg, d_model: int, x, state):
    d_inner = s.expand * d_model
    st = tuple(state[k] for k in ("c", "n", "h", "m"))
    c, n, h, m = _slstm_step(p, s, d_inner, _mm(x, p["w_x"]), st,
                             p["r"].to(F32))
    out = _mm(_slstm_ff(p, h.to(x.dtype)), p["w_out"])
    return out, {"c": c, "n": n, "h": h, "m": m}


def slstm_state_shapes(s: SSMCfg, d_model: int, batch: int, dtype, *,
                       device="cpu"):
    d_inner = s.expand * d_model

    def z():
        return torch.zeros((batch, d_inner), dtype=F32, device=device)
    return {"c": z(), "n": z() + 1e-6, "h": z(), "m": z() - 1e30}
