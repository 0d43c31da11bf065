"""Ragged latent attention, MLA's absorbed attention over paged latent
pools (deepseek-v3): the CUDA kernel's launcher and its plain PyTorch
version.

No Pallas kernel is its counterpart: the reference computes this
attention as XLA ops inside ``repro.models.attention.mla_mixed_paged``
(and ``mla_decode_paged`` / ``mla_extend_paged``), gathering each row's
whole latent table. Row i belongs to sequence ``tok_seq[i]`` at position
``tok_pos[i]``; for each head h it attends over the keys j <= tok_pos[i]
of its block table with scores ``(q_lat[i, h] . c_j + q_rope[i, h] .
kr_j) * scale`` and returns the softmax-weighted sum of the latents c_j.
A row with ``tok_pos == -1`` gives zeros.

Layout: q_lat (N, H, L) and q_rope (N, H, R) float32; pools c (n_pages,
page, L) and kr (n_pages, page, R), float32 or bfloat16; block_tables
(B, max_pages) int32; tok_seq, tok_pos (N,) int32; out (N, H, L)
float32. The kernel source is ``csrc/mla_attention.cu``, in two forms,
which its launcher picks from the pools' dtype and the widths
(``tensor_cores`` says which, for the counts):

* the tensor-core form takes bf16 pools at L 512 and R 64 (deepseek-v3's
  widths), any H: a block per (row, 32 heads) on ``mma.sync``, the
  float32 queries and the softmax weights split into two bf16 terms, so
  it computes the float32 function to ~2e-5 of the output's magnitude;
* the CUDA-core form takes every other call the wrapper accepts: float32
  pools, and L a multiple of 16 up to 512 with R a multiple of 8 up to
  64 (e.g. the tiny config's 32 and 16), float32 on the CUDA cores.

Neither falls back to the other, or to the plain version, on a failure.
Both are bound by bytes at mla_serve's calls on the H100 (the float32
queries in and output out; the latents are shared by all heads of a row).
``ragged_latent_attention.launches`` counts both forms' launches and
``.tc_launches`` the tensor-core form's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_L, MAX_R = 512, 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core form's widths
TC_L, TC_R = 512, 64


def latent_attend(q_lat, q_rope, c_cache, kr_cache, live, scale):
    """Absorbed attention over gathered latents, the reference's op order:
    q_lat (B, T, H, L) and q_rope (B, T, H, R) float32 over c_cache
    (B, S, L) and kr_cache (B, S, R) where ``live`` (B, T, S) holds:
    float32 scores (q_lat . c + q_rope . kr) * scale, masked to -1e30,
    softmax, then the weighted sum of the latents. Returns (B, T, H, L)
    float32. The gather path's slotted caches and the plain version's
    per-row gathers both go through it."""
    c = c_cache.float()
    s = (torch.einsum("bthl,bsl->bths", q_lat, c)
         + torch.einsum("bthr,bsr->bths", q_rope, kr_cache.float())) * scale
    s = s.masked_fill(~live[:, :, None, :], NEG_INF)
    return torch.einsum("bths,bsl->bthl", torch.softmax(s, dim=-1), c)


def ragged_latent_attention_ref(q_lat, q_rope, c_pool, kr_pool,
                                block_tables, tok_seq, tok_pos, scale):
    """The plain version, as the reference's ``mla_mixed_paged`` computes
    the attention: gather each row's block table of latents, float32
    scores, mask ``key <= tok_pos``, softmax, weighted sum. Rows with
    ``tok_pos < 0`` are zeroed, the kernel's contract."""
    N, H, L = q_lat.shape
    S = block_tables.shape[1] * c_pool.shape[1]
    bt_tok = block_tables[tok_seq.long()].long()           # (N, max_pages)
    live = torch.arange(S, device=q_lat.device)[None, :] \
        <= tok_pos.long()[:, None]
    out = latent_attend(q_lat[:, None], q_rope[:, None],
                        c_pool[bt_tok].reshape(N, S, L),
                        kr_pool[bt_tok].reshape(N, S, -1), live[:, None],
                        scale)[:, 0]
    return out.masked_fill((tok_pos < 0)[:, None, None], 0.0)


def tensor_cores(c_pool, L: int, R: int) -> bool:
    """Whether the launcher takes a call over ``c_pool`` at widths L, R on
    the tensor-core form (bf16 pools at L 512, R 64); every other call the
    wrapper accepts takes the CUDA-core form."""
    return c_pool.dtype == torch.bfloat16 and (L, R) == (TC_L, TC_R)


def _check(q_lat, q_rope, c_pool, kr_pool, block_tables, tok_seq, tok_pos):
    """Raise on any operand the kernel does not take (the device is checked
    by the launcher); returns whether the tensor-core form takes it."""
    N, H, L = q_lat.shape
    R = q_rope.shape[2]
    if q_lat.dtype != torch.float32 or q_rope.dtype != torch.float32:
        raise TypeError("q_lat and q_rope must be float32")
    if c_pool.dtype not in DTYPES or kr_pool.dtype != c_pool.dtype:
        raise TypeError(f"pools must be float32 or bfloat16 and share a "
                        f"dtype, got {c_pool.dtype} / {kr_pool.dtype}")
    if q_rope.shape[:2] != (N, H) or c_pool.dim() != 3 \
            or kr_pool.shape[:2] != c_pool.shape[:2] \
            or (c_pool.shape[2], kr_pool.shape[2]) != (L, R) \
            or L % 16 or L > MAX_L or R % 8 or R == 0 or R > MAX_R:
        raise ValueError(
            f"shapes q_lat {tuple(q_lat.shape)} / q_rope "
            f"{tuple(q_rope.shape)} / pools {tuple(c_pool.shape)} "
            f"{tuple(kr_pool.shape)} not taken (the tensor-core form: bf16 "
            f"pools at L {TC_L} and R {TC_R}, any H; the CUDA-core form: "
            f"float32 or bf16 pools, L a multiple of 16 up to {MAX_L}, R a "
            f"multiple of 8 up to {MAX_R})")
    if block_tables.dim() != 2 or tok_seq.shape != (N,) \
            or tok_pos.shape != (N,):
        raise ValueError("block_tables must be (B, max_pages), tok_seq and "
                         "tok_pos (N,)")
    for t in (block_tables, tok_seq, tok_pos):
        if t.dtype != torch.int32:
            raise TypeError("block_tables, tok_seq and tok_pos must be int32")
    ops = (q_lat, q_rope, c_pool, kr_pool, block_tables, tok_seq, tok_pos)
    if not all(t.is_contiguous() for t in ops) \
            or len({t.device for t in ops}) != 1:
        raise ValueError("all operands must be contiguous on one device")
    # rows are read with 16-byte loads and copies
    if any(t.data_ptr() % 16 for t in ops[:4]):
        raise ValueError("q_lat, q_rope and the pools must start on a "
                         "16-byte boundary")
    return tensor_cores(c_pool, L, R)


def ragged_latent_attention(q_lat, q_rope, c_pool, kr_pool, block_tables,
                            tok_seq, tok_pos, scale):
    """Launch the CUDA kernel on the current stream, in the form its
    launcher picks (``tensor_cores``); returns (N, H, L) float32. Raises on any
    operand the kernel does not take, a CPU tensor included."""
    _build.require_cuda("ragged_latent_attention", q_lat)
    tc = _check(q_lat, q_rope, c_pool, kr_pool, block_tables, tok_seq,
                tok_pos)
    N, H, L = q_lat.shape
    n_pages, page, R = kr_pool.shape
    out = torch.empty_like(q_lat)
    err = _build.lib().mla_attention_launch(
        q_lat.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
        kr_pool.data_ptr(), block_tables.data_ptr(), tok_seq.data_ptr(),
        tok_pos.data_ptr(), out.data_ptr(), N, H, L, R, page,
        block_tables.shape[1], n_pages, float(scale), DTYPES[c_pool.dtype],
        torch.cuda.current_stream(q_lat.device).cuda_stream)
    _build.check(err, "ragged_latent_attention")
    ragged_latent_attention.launches += 1
    ragged_latent_attention.tc_launches += tc
    return out


ragged_latent_attention.launches = 0
ragged_latent_attention.tc_launches = 0
