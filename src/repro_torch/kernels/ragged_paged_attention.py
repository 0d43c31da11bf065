"""Ragged-query paged attention, the fused mixed-batch iteration's
attention core: the CUDA kernel's launcher and its plain PyTorch version.

Counterpart of ``repro.kernels.ragged_paged_attention``. One iteration's
whole query workload — every prefill chunk's tokens and every decode's
single token — arrives as one flat batch of N tokens; token n belongs to
sequence ``tok_seq[n]`` at absolute position ``tok_pos[n]`` and attends to
that sequence's pages through ``block_tables[tok_seq[n]]`` under the mask
``kv position <= tok_pos[n]``. Padded rows carry ``tok_pos == -1`` and get
zeros.

Layout: q (N, Hkv, G, hd); pools (n_pages, page, Hkv, hd);
block_tables (B, max_pages) int32; tok_seq/tok_pos (N,) int32. Pools are
in q's dtype, or quantized (int8, float8_e4m3fn, float8_e5m2) with
``k_scale``/``v_scale`` (n_pages, Hkv) float32, dequantized in-register.
The kernel source is ``csrc/ragged_paged_attention.cu``; its bf16 route
is the tensor-core sweep of ``csrc/paged_tc.cuh``.

Beside the plain version, this module keeps the plain form of that
sweep's decomposition, for the CPU tests: the tiling of the flat rows
(``plan_tiles``, ``block_tiles``), the key split (``split_key_bounds``),
the partial softmax states over one split (``attention_partials``) and
their log-sum-exp merge (``merge_partials``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant import (attention_pool_code,
                                          dequant_gathered, gather_pages)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 48 * 1024      # the CUDA-core kernel's shared memory, no opt-in
# the bf16 (tensor-core) sweep: a tile is at most TILE_ROWS query rows
# (tokens x G heads), the keys are staged STAGE_KEYS positions at a time,
# and a call splits its keys at most MAX_SPLITS ways
TILE_ROWS = 64
STAGE_KEYS = 64
MAX_SPLITS = 32
# the split aims at this many blocks per SM
BLOCKS_PER_SM = 2


def tile_tokens(G: int) -> int:
    """Tokens of one sequence a tile takes: its rows fill TILE_ROWS."""
    return max(1, TILE_ROWS // G)


def tile_grid(N: int, G: int, B: int) -> int:
    """The grid's tile count: each window of ``tile_tokens`` rows holds at
    least one tile, and each of the B sequences (and the padding after
    them) starts at most one more, when every sequence's rows are
    consecutive. The last block takes any tiles past it."""
    return max(1, min(N, -(-N // tile_tokens(G)) + B))


def split_count(blocks: int, keys: int, n_sm: int) -> int:
    """Key splits for a call of ``blocks`` (tile, kv head) blocks whose
    sequences hold at most ``keys`` positions: enough to give the card
    BLOCKS_PER_SM blocks per SM, at most one per stage and MAX_SPLITS.
    From shapes alone: no host sync. (Splitting a grid that already
    fills the card, to shorten its longest tile, made the 512-row call
    slower; PERF.md has the numbers.)"""
    want = -(-BLOCKS_PER_SM * n_sm // max(1, blocks))
    return max(1, min(want, -(-keys // STAGE_KEYS), MAX_SPLITS))


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_tiles(tok_seq, tq: int) -> list:
    """The kernel's tiling, plainly: rows [start, end) cut at every
    multiple of ``tq`` and wherever tok_seq changes."""
    seq = [int(x) for x in tok_seq]
    starts = [n for n in range(len(seq))
              if n % tq == 0 or seq[n] != seq[n - 1]]
    return list(zip(starts, starts[1:] + [len(seq)]))


def block_tiles(n_tiles: int, grid: int) -> list:
    """The tiles each block of the grid takes: block x tile x, and the
    last block every tile from its own on."""
    return [[x] if x < grid - 1 else list(range(x, n_tiles))
            for x in range(min(grid, n_tiles))]


def split_key_bounds(tok_seq, tok_pos, *, G, page, max_pages, splits,
                     window=None):
    """(N, splits + 1) key positions: split s of row n's tile covers keys
    [b[n, s], b[n, s + 1]), as the kernel cuts the tile's STAGE_KEYS
    stages from its first visible key to its last; empty splits repeat
    the end. Rows of a tile with no visible key get all zeros."""
    pos = [int(x) for x in tok_pos]
    bounds = torch.zeros((len(pos), splits + 1), dtype=torch.long)
    k_table = max_pages * page
    for start, end in plan_tiles(tok_seq, tile_tokens(G)):
        live = [p for p in pos[start:end] if p >= 0]
        if not live:
            continue
        los = [max(0, p + 1 - window) if window else 0 for p in live]
        k_end = min(max(live) + 1, k_table)
        if min(los) >= k_end:
            continue
        first = min(los) // STAGE_KEYS
        n_stages = (k_end - 1) // STAGE_KEYS - first + 1
        per = -(-n_stages // splits)
        for s in range(splits + 1):
            bounds[start:end, s] = (first + min(s * per, n_stages)) \
                * STAGE_KEYS
    return bounds


def _attend(q, k_cache, v_cache, tok_pos, softcap, window):
    """f32 einsum divided by sqrt(hd), softcap, mask, softmax, einsum over
    caches gathered per token, (N, S, Hkv, hd); rows with ``tok_pos < 0``
    are zeroed, the kernel's contract."""
    hd = q.shape[-1]
    S = k_cache.shape[1]
    s = torch.einsum("bhgk,bshk->bhgs", q.float(),
                     k_cache.float()) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    j = torch.arange(S, device=q.device)[None, :]
    live = j <= tok_pos[:, None]
    if window is not None:
        live &= j > tok_pos[:, None] - window
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshk->bhgk", w, v_cache.float())
    out = out.masked_fill((tok_pos < 0)[:, None, None, None], 0.0)
    return out.to(q.dtype)


def ragged_paged_attention_ref(q, k_pool, v_pool, block_tables, tok_seq,
                               tok_pos, *, softcap=None, window=None):
    """The plain version, in the op order of the reference's jnp mirror
    (``repro.models.attention.gqa_mixed_paged``): gather the block table,
    f32 einsum divided by sqrt(hd), softcap, mask, softmax, einsum. Rows
    with ``tok_pos < 0`` are zeroed, the kernel's contract."""
    N, Hkv, G, hd = q.shape
    S = block_tables.shape[1] * k_pool.shape[1]
    bt_tok = block_tables[tok_seq.long()].long()          # (N, max_pages)
    return _attend(q, k_pool[bt_tok].reshape(N, S, Hkv, hd),
                   v_pool[bt_tok].reshape(N, S, Hkv, hd), tok_pos, softcap,
                   window)


def _gather_keys(k_pool, v_pool, k_scale, v_scale, block_tables, tok_seq):
    """Each row's keys and values in table order, (N, S, Hkv, hd) float32,
    and the per-key scales (N, S, Hkv): ones for a float pool, else the
    page's scale beside the raw payload, as the kernel applies them."""
    N = tok_seq.shape[0]
    _, page, Hkv, hd = k_pool.shape
    bt_tok = block_tables[tok_seq.long()].long()
    S = bt_tok.shape[1] * page

    def keys(pool, scale):
        x = gather_pages(pool, bt_tok).float().reshape(N, S, Hkv, hd)
        if scale is None:
            return x, torch.ones((N, S, Hkv), device=x.device)
        return x, scale[bt_tok].float().repeat_interleave(page, dim=1)
    return (*keys(k_pool, k_scale), *keys(v_pool, v_scale))


def attention_partials(q, k_pool, v_pool, block_tables, tok_seq, tok_pos,
                       bounds, *, k_scale=None, v_scale=None, softcap=None,
                       window=None):
    """The softmax state of each split, as the kernel's split-KV blocks
    leave it: for split s, row n's visible keys inside [bounds[n, s],
    bounds[n, s + 1]), scores (q . k) * k_scale / sqrt(hd) (softcapped),
    m = their max (-inf where the split sees none), l = sum exp(score - m)
    and acc = sum exp(score - m) * v_scale * v. Returns m, l (S, N, Hkv,
    G) and acc (S, N, Hkv, G, hd), float32."""
    N, Hkv, G, hd = q.shape
    k, ks, v, vs = _gather_keys(k_pool, v_pool, k_scale, v_scale,
                                block_tables, tok_seq)
    S = k.shape[1]
    s = torch.einsum("nhgk,nshk->nhgs", q.float(), k) \
        * ks.permute(0, 2, 1)[:, :, None] / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    j = torch.arange(S, device=q.device)[None, :]
    pos = tok_pos.long()[:, None]
    vis = j <= pos
    if window is not None:
        vis &= j > pos - window
    ms, ls, accs = [], [], []
    for b in range(bounds.shape[1] - 1):
        inside = vis & (j >= bounds[:, b:b + 1]) & (j < bounds[:, b + 1:b + 2])
        x = s.masked_fill(~inside[:, None, None], -math.inf)
        m = x.amax(dim=-1)
        p = torch.exp(x - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("nhgs,nshk->nhgk", p,
                                 v * vs[..., None]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials(m, l, acc, tok_pos, dtype):
    """The log-sum-exp merge of the splits' states: a split that saw no
    key weighs nothing; a padded row (tok_pos < 0) or one that saw no key
    at all is zeros. Returns (N, Hkv, G, hd) in ``dtype``."""
    top = m.amax(dim=0)
    w = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(top), 0.0, top)))
    L = (w * l).sum(0)
    out = (w[..., None] * acc).sum(0) / torch.where(L > 0, L, 1.0)[..., None]
    dead = (L <= 0) | (tok_pos < 0)[:, None, None]
    return out.masked_fill(dead[..., None], 0.0).to(dtype)


def ragged_paged_attention_split_ref(q, k_pool, v_pool, block_tables,
                                     tok_seq, tok_pos, *, splits,
                                     k_scale=None, v_scale=None,
                                     softcap=None, window=None):
    """The kernel's decomposition, plainly: the keys cut as
    ``split_key_bounds`` cuts them, each split's partial state, then the
    merge."""
    bounds = split_key_bounds(tok_seq, tok_pos, G=q.shape[2],
                              page=k_pool.shape[1],
                              max_pages=block_tables.shape[1],
                              splits=splits, window=window)
    parts = attention_partials(q, k_pool, v_pool, block_tables, tok_seq,
                               tok_pos, bounds, k_scale=k_scale,
                               v_scale=v_scale, softcap=softcap,
                               window=window)
    return merge_partials(*parts, tok_pos, q.dtype)


def ragged_paged_attention_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, tok_seq, tok_pos, *,
                                     softcap=None, window=None):
    """The plain version over quantized pools, as the reference's
    ``ragged_paged_attention_quant_ref``: gather pages and their scales
    through the block table, dequantize in f32, then the same math."""
    N, Hkv, G, hd = q.shape
    S = block_tables.shape[1] * k_pool.shape[1]
    bt_tok = block_tables[tok_seq.long()].long()
    k = dequant_gathered(gather_pages(k_pool, bt_tok), k_scale[bt_tok])
    v = dequant_gathered(gather_pages(v_pool, bt_tok), v_scale[bt_tok])
    return _attend(q, k.reshape(N, S, Hkv, hd), v.reshape(N, S, Hkv, hd),
                   tok_pos, softcap, window)


def _check(q, k_pool, v_pool, k_scale, v_scale, block_tables, tok_seq,
           tok_pos) -> int:
    """Raise on any operand the kernel does not take (the device is checked
    by the launcher); returns the pool code."""
    if q.dtype not in DTYPES:
        raise TypeError(f"ragged_paged_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    N, Hkv, G, hd = q.shape
    n_pages, page, pool_hkv, pool_hd = k_pool.shape
    if hd not in HEAD_DIMS or (pool_hkv, pool_hd) != (Hkv, hd) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} / pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)} not "
                         f"taken (head_dim in {HEAD_DIMS})")
    if block_tables.dim() != 2 or tok_seq.shape != (N,) \
            or tok_pos.shape != (N,):
        raise ValueError("block_tables must be (B, max_pages), tok_seq and "
                         "tok_pos (N,)")
    pool_code = attention_pool_code("ragged_paged_attention", q, k_pool,
                                    v_pool, k_scale, v_scale)
    for t in (block_tables, tok_seq, tok_pos):
        if t.dtype != torch.int32:
            raise TypeError("block_tables, tok_seq and tok_pos must be int32")
    for t in (q, k_pool, v_pool, block_tables, tok_seq, tok_pos):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    # the K/V tiles are staged with 16-byte loads
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("the pools must start on a 16-byte boundary")
    if tensor_cores(q):
        # the tensor-core sweep's shared memory depends on hd and the
        # payload only (at most ~197 KB, at hd 256, opted in by the
        # launcher)
        return pool_code
    # the CUDA-core kernel's staged tiles: a 16-byte load carries 16 /
    # element size elements, dequantized to float32 as they are stored
    smem = 4 * (2 * G * hd + page * (hd + 1) + page * hd + G * page + 3 * G)
    if smem > SMEM_LIMIT:
        raise ValueError(f"G={G}, page={page}, hd={hd} needs {smem} bytes "
                         f"of shared memory, above {SMEM_LIMIT}")
    return pool_code


def tensor_cores(q) -> bool:
    """Whether q takes the tensor-core sweep: bf16, with all G heads of a
    row inside one tile. The rest take the CUDA-core kernel."""
    return q.dtype == torch.bfloat16 and q.shape[2] <= TILE_ROWS


_COUNTERS = {}   # (device index, stream) -> int32 arrival counters


def split_counters(n: int, device, stream: int) -> int:
    """A pointer to at least ``n`` int32 arrival counters for ``stream``
    (a handle) on ``device``. They are zeroed once, when made or grown,
    and every launch leaves them zero (the merging block resets its own),
    so no call pays for a memset; one buffer per stream keeps two streams'
    launches apart."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 0)
        buf = _COUNTERS[key] = torch.zeros(size, dtype=torch.int32,
                                           device=device)
    return buf.data_ptr()


def split_scratch(splits: int, q, stream: int):
    """The split-KV scratch of a call on ``stream``: (splits, N, Hkv, G,
    hd + 4) float32 partials (the accumulator, the row max and sum,
    16-byte rows), and N * Hkv arrival counters (``split_counters``). None
    for one split. Returns (partials pointer, counters pointer, the
    partials' tensor)."""
    if splits == 1:
        return None, None, None
    N, Hkv, G, hd = q.shape
    part = torch.empty(splits * N * Hkv * G * (hd + 4), dtype=torch.float32,
                       device=q.device)
    return part.data_ptr(), split_counters(N * Hkv, q.device, stream), part


def ragged_paged_attention(q, k_pool, v_pool, block_tables, tok_seq,
                           tok_pos, *, k_scale=None, v_scale=None,
                           softcap=None, window=None):
    """Launch the CUDA kernel on the current stream; returns
    (N, Hkv, G, hd) in q's dtype. Quantized pools need ``k_scale`` and
    ``v_scale``. Raises on any operand the kernel does not take, a CPU
    tensor included."""
    _build.require_cuda("ragged_paged_attention", q)
    pool_code = _check(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                       tok_seq, tok_pos)
    N, Hkv, G, hd = q.shape
    page = k_pool.shape[1]
    B, max_pages = block_tables.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tq, tiles, splits, part, counters = tile_tokens(G), 1, 1, None, None
    _scratch = None   # owns part until the launch is queued
    if tensor_cores(q):
        tiles = tile_grid(N, G, B)
        splits = split_count(tiles * Hkv, max_pages * page,
                             sm_count(q.device.index))
        part, counters, _scratch = split_scratch(splits, q, stream)
    err = _build.lib().ragged_paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        block_tables.data_ptr(), tok_seq.data_ptr(), tok_pos.data_ptr(),
        out.data_ptr(), part, counters,
        N, Hkv, G, hd, page, max_pages,
        0 if window is None else int(window), tq, tiles, splits,
        0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(hd),
        DTYPES[q.dtype], pool_code, stream)
    _build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
