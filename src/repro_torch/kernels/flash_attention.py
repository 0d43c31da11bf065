"""Dense GQA flash attention, the full-sequence forward's attention core,
and its gradient: the CUDA kernels' launchers, their plain PyTorch
versions, and the autograd Function that joins them.

Counterpart of ``repro.kernels.flash_attention`` (forward only there: the
reference differentiates its XLA attention, so the backward kernels are
the counterpart of that autodiff). Query row i sits at position
``i + Tk - Tq`` (right-aligned) and sees key j iff ``j <= position``
(``causal``) and ``j > position - window`` (``window``); scores are
``q . k * scale``, then ``softcap * tanh(s / softcap)``. Tq > Tk is
refused: its first rows would see no key, where the reference's two
versions disagree.

Layout: q (B, Hkv, G, Tq, hd); k, v (B, Hkv, Tk, hd); out like q; the
forward also gives lse (B, Hkv, G, Tq), the per-row log-sum-exp the
backward recomputes the probabilities from. The kernel source is
``csrc/flash_attention.cu``, and every product runs on the tensor cores
(float32 accumulators). bfloat16 operands, with P and dS rounded to bf16
before their products: ``mma.sync`` for the forward and for the backward
up to head_dim 128; at head_dim 192 and 256 the backward runs on Hopper's
``wgmma`` (the building blocks in ``csrc/hopper.cuh``), each block a
producer warpgroup that feeds 64-row tiles by TMA into a ring of
shared-memory stages and two consumer warpgroups that hold dK and dV, or
parts of dQ's columns, one each. float32 operands: the split kernels on
``mma.sync`` at every head_dim, each float32 operand (Q, K, V, dO, and P
and dS in registers) split into ``F32_TERMS`` (three) bf16 terms, and each
product summed over the six term products whose indexes sum below three
(those dropped are below 2^-24 of it): as near float32 as plain float32
arithmetic gets, also on the large scores where two terms (2^-16) are
not. Each shape takes one route, with no fallback between them.
The TMA tensor maps need every operand on a 16-byte boundary and rows of
a multiple of 16 bytes, which ``_check`` and ``HEAD_DIMS`` guarantee.
Each launcher counts its launches in ``.launches`` and, apart, its
float32 launches in ``.f32_launches``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# 192: MLA's qk width (128 + 64), deepseek-v3's full-sequence forward;
# the forward and the backward take the same head dims
HEAD_DIMS = (32, 64, 128, 192, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 terms a float32 operand is split into by the float32 kernels
# (kTerms in csrc/flash_attention.cu, which the library reports and
# ``_lib`` checks); a product keeps the term pairs whose indexes sum below
# it
F32_TERMS = 3


def max_heads(hd: int) -> int:
    """The most query heads G a kv head may have: 128 / (hd / 32), 16 at
    hd 192. The kernels take the heads through their grid, not through a
    block's threads; this is the range the checks on the card cover, and
    every model of the port lies well inside it."""
    return 128 // (8 if hd == 192 else hd // 32)


def _check_lengths(q, k):
    if q.shape[3] > k.shape[2]:
        raise ValueError(f"Tq {q.shape[3]} > Tk {k.shape[2]}: the first "
                         "query rows would see no key")


def _mask(Tq, Tk, causal, window, device):
    """(Tq, Tk) visibility, right-aligned positions."""
    qpos = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, causal, window, softcap, scale):
    """Capped scores (before masking) and the mask, in the working type:
    float32, or float64 for float64 inputs."""
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.to(ct), k.to(ct)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s, _mask(q.shape[3], k.shape[2], causal, window, q.device), scale


def flash_attention_fwd_ref(q, k, v, *, causal=True, window=None,
                            softcap=None, scale=None):
    """The plain forward, as ``repro.kernels.ref.flash_attention_ref``:
    float32 einsum times scale, softcap, mask to -1e30, softmax, einsum.
    Returns (out in q's dtype, lse in the working type)."""
    _check_lengths(q, k)
    s, mask, _ = _scores(q, k, causal, window, softcap, scale)
    s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(s.dtype))
    return out.to(q.dtype), lse


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    """The plain forward's output alone."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)[0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                            window=None, softcap=None, scale=None):
    """The plain backward from the saved output ``o`` and per-row ``lse``:
    P = exp(s - lse) on the visible keys, dV = P^T dO, dP = dO V^T,
    dS = P * (dP - rowsum(dO * O)), times 1 - (s / softcap)^2 under a
    softcap and times scale; dQ = dS K, dK = dS^T Q. Returns (dq, dk, dv)
    in q's, k's and v's dtypes."""
    _check_lengths(q, k)
    s, mask, scale = _scores(q, k, causal, window, softcap, scale)
    ct = s.dtype
    p = torch.exp(s - lse.to(ct)[..., None]).masked_fill(~mask, 0.0)
    dof = do.to(ct)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.to(ct))
    delta = (dof * o.to(ct)).sum(-1)
    ds = p * (dp - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - torch.square(s / softcap))
    ds = ds * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(ct))
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, q.to(ct))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def split_terms(x, terms):
    """x as ``terms`` bf16 values (as float32) that sum to it, largest
    first: hi = bf16(x), then bf16 of what is left (``split`` in
    csrc/mma.cuh)."""
    out = []
    for _ in range(terms):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return out


def split_einsum(eq, a, b, terms=F32_TERMS):
    """einsum of float32 a and b as the float32 kernels run it on the bf16
    tensor cores: each operand as ``terms`` bf16 terms, the term pairs
    whose indexes sum below ``terms`` kept, summed in float32."""
    ta, tb = split_terms(a.float(), terms), split_terms(b.float(), terms)
    return sum(torch.einsum(eq, ta[i], tb[j]) for i in range(terms)
               for j in range(terms) if i + j < terms)


def _split_scores(q, k, terms, causal, window, softcap, scale):
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    d = split_einsum("bhgqd,bhkd->bhgqk", q, k, terms) * scale
    s = softcap * torch.tanh(d / softcap) if softcap is not None else d
    return s, _mask(q.shape[3], k.shape[2], causal, window, q.device), scale


def flash_attention_split_fwd_ref(q, k, v, *, terms=F32_TERMS, causal=True,
                                  window=None, softcap=None, scale=None):
    """The float32 kernels' forward arithmetic in plain PyTorch: S and
    P V through ``split_einsum``, P (against the row's maximum: its split
    is relative, as the kernel's against its running maximum) split too.
    Returns (out, lse) in float32; ``terms=1`` is plain bf16 operands."""
    _check_lengths(q, k)
    s, mask, _ = _split_scores(q, k, terms, causal, window, softcap, scale)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    ell = p.sum(-1)
    out = split_einsum("bhgqk,bhkd->bhgqd", p, v, terms) / ell[..., None]
    return out, m[..., 0] + torch.log(ell)


def flash_attention_split_bwd_ref(q, k, v, o, lse, do, *, terms=F32_TERMS,
                                  causal=True, window=None, softcap=None,
                                  scale=None):
    """The float32 kernels' backward arithmetic in plain PyTorch, as
    ``flash_attention_bwd_ref`` with every product through
    ``split_einsum`` (P and dS split too). Returns (dq, dk, dv) in
    float32."""
    _check_lengths(q, k)
    s, mask, scale = _split_scores(q, k, terms, causal, window, softcap,
                                   scale)
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~mask, 0.0)
    dof = do.float()
    dp = split_einsum("bhgqd,bhkd->bhgqk", dof, v, terms)
    grad = (1 - (s / softcap) ** 2) * scale if softcap is not None \
        else scale
    ds = p * grad * (dp - (dof * o.float()).sum(-1)[..., None])
    return (split_einsum("bhgqk,bhkd->bhgqd", ds, k, terms),
            split_einsum("bhgqk,bhgqd->bhkd", ds, q, terms),
            split_einsum("bhgqk,bhgqd->bhkd", p, dof, terms))


def _check(kernel, *tensors):
    """Raise on any operand the kernels do not take (the device is checked
    by the launchers)."""
    q, k = tensors[0], tensors[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError("q must be (B, Hkv, G, Tq, hd) and k, v "
                         "(B, Hkv, Tk, hd)")
    B, Hkv, G, Tq, hd = q.shape
    if hd not in HEAD_DIMS or G > max_heads(hd) \
            or tuple(k.shape[:2]) != (B, Hkv) or k.shape[3] != hd \
            or tensors[2].shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} / k {tuple(k.shape)} "
                         f"/ v {tuple(tensors[2].shape)} not taken (head_dim "
                         f"in {HEAD_DIMS}, G <= max_heads(head_dim))")
    _check_lengths(q, k)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
        if t.dtype not in (q.dtype, torch.float32):
            raise TypeError(f"{kernel}: operand of type {t.dtype} with q "
                            f"{q.dtype}")
        # rows are read with 8- and 16-byte loads, and by TMA
        if t.data_ptr() % 16:
            raise ValueError("operands must start on a 16-byte boundary")


def _lib():
    """The kernel library, once checked to split float32 operands into
    ``F32_TERMS`` terms, as the split references here do."""
    lib = _build.lib()
    if not _lib.checked:
        terms = lib.flash_attention_f32_terms()
        if terms != F32_TERMS:
            raise RuntimeError(f"the flash kernels split float32 into {terms}"
                               f" terms, F32_TERMS is {F32_TERMS}")
        _lib.checked = True
    return lib


_lib.checked = False


def _opts(q, causal, window, softcap, scale):
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    return (int(bool(causal)), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale))


def flash_attention_fwd(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    """Launch the forward kernel on the current stream; returns (out like
    q, lse (B, Hkv, G, Tq) float32). Raises on any operand the kernel does
    not take, a CPU tensor included."""
    _build.require_cuda("flash_attention", q)
    _check("flash_attention", q, k, v)
    opts = _opts(q, causal, window, softcap, scale)
    B, Hkv, G, Tq, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, Tq), dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Hkv, G, Tq, k.shape[2], hd, *opts,
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.f32_launches += int(q.dtype == torch.float32)
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.f32_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        softcap=None, scale=None):
    """Launch the backward kernels (dQ, which also forms delta, then
    dK/dV) on the current stream; returns (dq, dk, dv) like q, k and v.
    Raises on any operand the kernels do not take, a CPU tensor
    included."""
    _build.require_cuda("flash_attention_bwd", q)
    _check("flash_attention_bwd", q, k, v, o, do, lse)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:4] or lse.dtype != torch.float32 \
            or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("o and do must be like q, lse (B, Hkv, G, Tq) "
                         "float32")
    opts = _opts(q, causal, window, softcap, scale)
    B, Hkv, G, Tq, hd = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(lse)
    err = _lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Hkv, G, Tq, k.shape[2], hd,
        *opts, DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.f32_launches += int(q.dtype == torch.float32)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.f32_launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: on CUDA tensors the forward and the
    backward launch the kernels; on CPU tensors they run the plain
    versions. Saves q, k, v, out and lse; the backward recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        fwd = flash_attention_fwd_ref if q.device.type == "cpu" \
            else flash_attention_fwd
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_ref if q.device.type == "cpu" \
            else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None):
    """The reference's signature: q (B, Hkv, G, Tq, hd); k, v
    (B, Hkv, Tk, hd); returns out like q, differentiable. The kernels for
    CUDA tensors, the plain versions for CPU tensors."""
    _check_lengths(q, k)
    return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
