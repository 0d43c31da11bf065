// The tensor-core sweep shared by the ragged and the paged decode attention
// kernels, for bf16 queries over bf16 or 1-byte (int8, float8 e4m3, e5m2)
// pools.
//
// Bound on the H100: bytes. Every visible K/V page is read once; the work
// is G * 4 flops per K/V element pair, far below the bf16 ridge. What held
// the CUDA-core kernels back was latency and re-reads: one block per
// (token, kv head), each walking its pages one by one with synchronous
// loads. This sweep:
//
// - Tiles queries. A block takes one tile: up to tq = 64 / G consecutive
//   rows of one sequence, so the tile's tq x G query rows fill the M side of
//   m16n8k16 products, and each K/V page of the tile's visible range is
//   staged once for all of them. The tiling cuts the flat rows at every
//   multiple of tq and wherever tok_seq changes (`is_tile_start`); each
//   block finds its own tile by a block-wide count over tok_seq, so no host
//   sync and no plan pass. The grid's x size is a bound on the tile count
//   for the engine's layout (each sequence's rows consecutive); whatever
//   tiles lie past the grid, the last block takes in turn, so any order of
//   tok_seq is right. The paged entry has one row per sequence: tile b is
//   row b.
// - Splits the keys (split-KV) when tiles x kv heads cannot fill the card:
//   blockIdx.z takes an even share of the tile's 64-key stages and writes
//   a float32 partial (row max, row sum, accumulator); the last block of a
//   (tile, head) to arrive (an atomic counter) merges the partials by their
//   log-sum-exp. A split or a row that sees no key merges as nothing.
// - Pipelines the staging: 64 key positions a stage, K and V rows copied
//   global -> shared by 16-byte cp.async, NS stages in flight, the page ids
//   of the next stage fetched into registers a stage ahead. Inside a stage
//   the four warps split the tile's rows and, for small tiles (decode), the
//   keys; their states merge through shared memory at the end.
// - Converts a 1-byte payload to bf16 as it stages it (exact for int8,
//   e4m3 and e5m2), multiplies the page's k_scale into the scores and folds
//   v_scale into P before the P.V product. P is rounded once to bf16 over
//   a bf16 pool; P * v_scale goes in as a bf16 hi/lo pair (two products).
// - At head_dim 256 (gemma2, GPT-J) a warp's 16 x 256 float32 accumulator
//   alone is 128 registers a thread, so the sweep holds nothing else across
//   stages: the query fragments are read from shared memory at each stage
//   (ldmatrix, not kept in registers), the page ids are loaded as each
//   stage is issued (not a stage ahead), and a warp that takes a whole
//   stage scores its 64 keys in two halves. Shared memory: 169,536 B (bf16,
//   two stages) and 201,792 B (1-byte payloads, three), one block an SM.
#pragma once

#include <climits>
#include <math_constants.h>

#include "mma.cuh"
#include "payload.cuh"

namespace {
namespace ptc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;        // query rows of a tile: tokens x G heads
constexpr int kBK = 64;          // key positions a stage
constexpr int kMaxSplits = 32;   // the wrapper's cap on blockIdx.z
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const bf16* q;                // (N, Hkv, G, HD)
  const void* k_pool;           // (n_pages, page, Hkv, HD), P
  const void* v_pool;
  const float* k_scale;         // (n_pages, Hkv); 1-byte pools only
  const float* v_scale;
  const int* block_tables;      // (B, max_pages)
  const int* tok_seq;           // (N,) ragged rows
  const int* tok_pos;           // (N,)
  const int* ctx_lens;          // (N,) paged rows, row b = sequence b; or null
  bf16* out;                    // (N, Hkv, G, HD)
  float* part;                  // (splits, N, Hkv, G, HD + 4), splits > 1
  int* counters;                // (N, Hkv), splits > 1: zero, left zero
  int N, Hkv, G, page, max_pages, window, tq, splits;
  float softcap, scale;
};

// Shared-memory layout of a block, in bytes: the tile's queries, the ring
// of NS staged K/V stages (and, for a 1-byte payload, the converted bf16
// K/V of the current stage), the payload's per-key scales, and int
// metadata. After the sweep the warps' states and the merge weights reuse
// the ring.
template <typename P, int HD>
struct Cfg {
  static constexpr bool kQuant = sizeof(P) == 1;
  static constexpr int kPitch = HD + 8;            // bf16 row, 16-byte pad
  static constexpr int NS = (kQuant || HD <= 64) ? 3 : 2;
  // registers: no query fragments or page ids held across stages
  static constexpr bool kLean = HD > 128;
  static constexpr int CH = HD * (int)sizeof(P) / 16;  // 16-byte pieces a row
  static constexpr int U = kBK * CH / kThreads;    // pieces a thread a tile
  static constexpr int kRowBytes = kQuant ? HD : kPitch * 2;
  static constexpr int kTile = kBK * kRowBytes;    // one K or V stage
  static constexpr int kQBytes = kRows * kPitch * 2;
  static constexpr int kRing = NS * 2 * kTile + (kQuant ? 2 * kBK * kPitch * 2
                                                        : 0);
  static constexpr int kRed = kWarps * 16 * (HD + 2) * 4;
  static constexpr int kMerge = 2 * kRows * kMaxSplits * 4 + kRows * 4;
  static constexpr int kArea = kRing > kRed + kMerge ? kRing : kRed + kMerge;
  static constexpr int kScales = kQuant ? NS * 2 * kBK * 4 : 0;
  static constexpr int kMeta = (2 * kRows + 16) * 4;
  static constexpr int kSmem = kQBytes + kArea + kScales + kMeta;
  static_assert(U >= 1 && kBK * CH % kThreads == 0, "whole copy rounds");
};

// metadata ints: pos_s[kRows], lo_s[kRows] (per token of the tile), then
// reductions and flags
constexpr int kPosS = 0, kLoS = kRows, kRed4 = 2 * kRows, kFlag = 2 * kRows + 8;

// The tile's rows and the keys they see.
struct Tile {
  int start, len, seq;
  bool live;                    // some row sees a key
  int pos_min, lo_max;          // over live rows: where masks begin
  int k_end;                    // keys at or past k_end are not visible
  int st_first, n_stages;       // the 64-key stages of [lo_min, k_end)
};

__device__ __forceinline__ bool is_tile_start(const Params& p, int n) {
  return n % p.tq == 0 || p.tok_seq[n] != p.tok_seq[n - 1];
}

// rows [start, end) of tile x of the ragged tiling; start = -1 if there
// are fewer tiles
__device__ void find_tile(const Params& p, int x, int* meta, int& start,
                          int& end) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int* sh = meta + kFlag;
  if (tid == 0) {
    sh[4] = -1;
    sh[5] = p.N;
  }
  int base = 0;  // tile starts before the chunk, the same in every thread
  for (int c0 = 0; c0 < p.N && base <= x + 1; c0 += kThreads) {
    const int n = c0 + tid;
    const bool f = n < p.N && is_tile_start(p, n);
    const unsigned bal = __ballot_sync(kAll, f);
    __syncthreads();  // the previous chunk's counts are read
    if (lane == 0) sh[warp] = __popc(bal);
    __syncthreads();
    int before = base, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += sh[w];
      total += sh[w];
    }
    const int idx = before + __popc(bal & ((1u << lane) - 1u));
    if (f && idx == x) sh[4] = n;
    if (f && idx == x + 1) sh[5] = n;
    base += total;
  }
  __syncthreads();
  start = sh[4];
  end = sh[5];
  __syncthreads();
}

// the end of the ragged tile that starts at row `start`
__device__ int tile_end(const Params& p, int start) {
  int e = start + 1;
  while (e < p.N && !is_tile_start(p, e)) ++e;
  return e;
}

__device__ Tile tile_meta(const Params& p, int* meta, int start, int end) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  Tile t;
  t.start = start;
  t.len = end - start;
  t.seq = p.ctx_lens ? start : p.tok_seq[start];
  if (tid < kRows) {
    int pos = -1, lo = 0;
    if (tid < t.len) {
      const int n = start + tid;
      pos = p.ctx_lens ? p.ctx_lens[n] - 1 : p.tok_pos[n];
      pos = max(pos, -1);
      lo = p.window > 0 ? max(0, pos + 1 - p.window) : 0;
    }
    const bool live = pos >= 0;
    meta[kPosS + tid] = pos;
    meta[kLoS + tid] = lo;
    const int a = __reduce_min_sync(kAll, live ? pos : INT_MAX);
    const int b = __reduce_max_sync(kAll, live ? pos : -1);
    const int c = __reduce_min_sync(kAll, live ? lo : INT_MAX);
    const int d = __reduce_max_sync(kAll, live ? lo : -1);
    if (lane == 0) {
      meta[kRed4 + warp * 4 + 0] = a;
      meta[kRed4 + warp * 4 + 1] = b;
      meta[kRed4 + warp * 4 + 2] = c;
      meta[kRed4 + warp * 4 + 3] = d;
    }
  }
  __syncthreads();
  const int* r = meta + kRed4;
  t.pos_min = min(r[0], r[4]);
  const int pos_max = max(r[1], r[5]);
  const int lo_min = min(r[2], r[6]);
  t.lo_max = max(r[3], r[7]);
  t.k_end = min(pos_max + 1, p.max_pages * p.page);
  // a row whose window lies past the table sees nothing, as before
  t.live = pos_max >= 0 && lo_min < t.k_end;
  t.st_first = t.live ? lo_min / kBK : 0;
  t.n_stages = t.live ? (t.k_end - 1) / kBK - t.st_first + 1 : 0;
  return t;
}

// out rows of the tile, as zeros
__device__ void zero_rows(const Params& p, const Tile& t, int h, int HD) {
  const int gh = p.G * HD;
  for (int i = threadIdx.x; i < t.len * gh; i += kThreads) {
    const int n = t.start + i / gh;
    p.out[((long long)n * p.Hkv + h) * gh + i % gh] = __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kAll, x, 1));
  return fmaxf(x, __shfl_xor_sync(kAll, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kAll, x, 1);
  return x + __shfl_xor_sync(kAll, x, 2);
}

// 16 payload values to 16 bf16 (exact for every payload type), as two
// 16-byte words
template <typename P>
__device__ __forceinline__ void widen16(uint4* dst, uint4 raw) {
  const P* e = reinterpret_cast<const P*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = pack_bf16(to_float(e[2 * j]),
                                               to_float(e[2 * j + 1]));
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// The sweep of stages [j0, j1) of tile t for kv head h by KW warps per row
// group (KW = 4: one group of 16 rows, the warps split each stage's keys).
// Leaves each warp's (row max in log2 units, row sum, accumulator) in the
// reduction area at the start of the ring.
template <typename P, int HD, int KW>
__device__ void sweep(const Params& p, const Tile& t, unsigned char* smem,
                      const int* meta, int h, int j0, int j1) {
  using C = Cfg<P, HD>;
  constexpr int PIT = C::kPitch, KS = HD / 16, DT = HD / 8;
  constexpr int NTW = kBK / 8 / KW, NS = C::NS, CH = C::CH, U = C::U;
  constexpr int EL = 16 / (int)sizeof(P);  // payload elements a piece
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp / KW, kg = warp % KW;
  const int key_w = kg * (kBK / KW);         // the warp's keys in a stage
  const int M = t.len * p.G;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + C::kQBytes;
  bf16* buf = reinterpret_cast<bf16*>(ring + NS * 2 * C::kTile);
  float* sc_s = reinterpret_cast<float*>(ring + C::kArea);
  const P* kpool = static_cast<const P*>(p.k_pool);
  const P* vpool = static_cast<const P*>(p.v_pool);
  const int* bt = p.block_tables + (long long)t.seq * p.max_pages;

  // this thread's two accumulator rows and what they see
  int r_pos[2], r_lo[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = rg * 16 + lane / 4 + e * 8;
    r_pos[e] = r < M ? meta[kPosS + r / p.G] : -1;
    r_lo[e] = r < M ? meta[kLoS + r / p.G] : 0;
  }

  // the tile's queries: row r is token r / G, head r % G
  for (int c = tid; c < kRows * (HD / 8); c += kThreads) {
    const int r = c / (HD / 8), col = c % (HD / 8) * 8;
    const bool in = r < M;
    const long long row = in ? ((long long)(t.start + r / p.G) * p.Hkv + h) *
                                   p.G + r % p.G
                             : 0;
    cp_async16(q_s + r * PIT + col, p.q + row * HD + col, in);
  }

  // page id and slot of this thread's key rows of stage j (page 0 where
  // not visible), resolved a stage ahead; a row's quotient and remainder
  // by the page size are fixed, so a stage costs one division. The lean
  // configuration resolves them in issue() instead
  int pid[U], sl[U], rq[U], rm[U];
  if constexpr (!C::kLean) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = (tid + u * kThreads) / CH;
      rq[u] = r / p.page;
      rm[u] = r % p.page;
    }
  }
  auto fetch = [&](int j) {
    if constexpr (C::kLean) return;
    const int k0 = j * kBK, kq = k0 / p.page, km = k0 - kq * p.page;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kp = k0 + (tid + u * kThreads) / CH;
      const int over = km + rm[u] >= p.page;
      sl[u] = km + rm[u] - (over ? p.page : 0);
      pid[u] = kp < t.k_end ? bt[kq + rq[u] + over] : 0;
    }
  };
  auto issue = [&](int j, int slot) {
    unsigned char* kd = ring + slot * 2 * C::kTile;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = tid + u * kThreads, r = c / CH, ch = c % CH;
      const bool in = j * kBK + r < t.k_end;
      int id, at_slot;
      if constexpr (C::kLean) {
        const int kp = j * kBK + r;
        id = in ? bt[kp / p.page] : 0;
        at_slot = kp % p.page;
      } else {
        id = pid[u];
        at_slot = sl[u];
      }
      const long long el =
          (((long long)id * p.page + at_slot) * p.Hkv + h) * HD + ch * EL;
      cp_async16(kd + r * C::kRowBytes + ch * 16, kpool + el, in);
      cp_async16(kd + C::kTile + r * C::kRowBytes + ch * 16, vpool + el, in);
      if constexpr (C::kQuant) {
        if (ch == 0) {  // the page's scales, one a key row
          float* s = sc_s + slot * 2 * kBK;
          const long long at = (long long)id * p.Hkv + h;
          cp_async4(s + r, p.k_scale + at, in);
          cp_async4(s + kBK + r, p.v_scale + at, in);
        }
      }
    }
  };

  fetch(j0);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (j0 + i < j1) {
      issue(j0 + i, i);
      fetch(j0 + i + 1);
    }
    cp_async_commit();
  }

  const float mul = p.scale * kLog2e;
  const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
  const float cap_log2e = p.softcap * kLog2e;
  uint32_t qf[KS][4];
  float acc[DT][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int j = j0; j < j1; ++j) {
    const int slot = (j - j0) % NS;
    cp_async_wait<NS - 2>();  // stage j (and the queries) have landed
    __syncthreads();          // and stage j - 1 is consumed by every warp
    if (j + NS - 1 < j1) {
      issue(j + NS - 1, (j - j0 + NS - 1) % NS);
      fetch(j + NS);
    }
    cp_async_commit();
    if (!C::kLean && j == j0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_a<PIT>(qf[kk], q_s, rg * 16, kk * 16);
    }
    const bf16* k_s;
    if constexpr (C::kQuant) {
      const unsigned char* raw = ring + slot * 2 * C::kTile;
      for (int c = tid; c < 2 * kBK * CH; c += kThreads) {
        const int kv = c / (kBK * CH), r = c / CH % kBK, ch = c % CH;
        const uint4 w = *reinterpret_cast<const uint4*>(
            raw + kv * C::kTile + r * HD + ch * 16);
        widen16<P>(reinterpret_cast<uint4*>(buf + (kv * kBK + r) * PIT +
                                            ch * 16), w);
      }
      __syncthreads();
      k_s = buf;
    } else {
      k_s = reinterpret_cast<const bf16*>(ring + slot * 2 * C::kTile);
    }
    const bf16* v_s = k_s + kBK * PIT;
    const float* ks_s = sc_s + slot * 2 * kBK;
    const float* vs_s = ks_s + kBK;

    const int k0 = j * kBK;
    const bool edge = k0 + kBK > t.k_end || k0 + kBK - 1 > t.pos_min ||
                      k0 < t.lo_max;
    // at head_dim 256 a warp that takes all 64 keys of a stage scores them
    // in two halves, so that its score tile fits in registers beside the
    // accumulator
    constexpr int PARTS = (C::kLean && NTW > 4) ? 2 : 1, NP = NTW / PARTS;
#pragma unroll 1
    for (int part = 0; part < PARTS; ++part) {
      const int kb = key_w + part * NP * 8;  // the part's first key
      float s[NP][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4];
        if constexpr (C::kLean) {
          ldsm_a<PIT>(qa, q_s, rg * 16, kk * 16);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        }
#pragma unroll
        for (int n = 0; n < NP; n += 2) {
          uint32_t f[4];
          ldsm_b<PIT>(f, k_s, kb + n * 8, kk * 16);
          mma16816(s[n], qa, f[0], f[1]);
          mma16816(s[n + 1], qa, f[2], f[3]);
        }
      }
      // scores in the log2 domain; the softcap's branch is uniform
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (C::kQuant)
            s[n][e] *= ks_s[kb + n * 8 + lane % 4 * 2 + (e & 1)];
        }
      }
      if (p.softcap > 0.f) {
#pragma unroll
        for (int n = 0; n < NP; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = cap_log2e * tanhf(s[n][e] * cap_in);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NP; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= mul;
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + n * 8 + lane % 4 * 2 + (e & 1);
          float x = s[n][e];
          const int kp = k0 + key, hh = e >> 1;
          if (edge && !(kp >= r_lo[hh] && kp <= r_pos[hh] && kp < t.k_end))
            x = -CUDART_INF_F;
          s[n][e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
      float base[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        base[hh] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no key seen yet
        const float corr = exp2f(m[hh] - base[hh]);
        m[hh] = m_new;
        l[hh] *= corr;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          acc[d][2 * hh] *= corr;
          acc[d][2 * hh + 1] *= corr;
        }
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[n][e] - base[e >> 1]);
          l[e >> 1] += pr;
          if constexpr (C::kQuant)
            pr *= vs_s[kb + n * 8 + lane % 4 * 2 + (e & 1)];
          s[n][e] = pr;
        }
      }
      // O += P V, P from registers, 16 keys a step. P * v_scale is not in
      // [0, 1] and one rounding of it would carry to the output (a single
      // visible key gives v_scale * v, off by bf16's 2^-9), so a 1-byte
      // payload's P goes in as bf16 hi + lo parts, two products
#pragma unroll
      for (int kk = 0; kk < NP / 2; ++kk) {
        uint32_t a[4], lo[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        if constexpr (C::kQuant) {
          float r0[4], r1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            r0[e] = s[2 * kk][e] -
                    __bfloat162float(__float2bfloat16(s[2 * kk][e]));
            r1[e] = s[2 * kk + 1][e] -
                    __bfloat162float(__float2bfloat16(s[2 * kk + 1][e]));
          }
          c_to_a(lo, r0, r1);
        }
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t f[4];
          ldsm_bt<PIT>(f, v_s, kb + kk * 16, d * 8);
          mma16816(acc[d], a, f[0], f[1]);
          mma16816(acc[d + 1], a, f[2], f[3]);
          if constexpr (C::kQuant) {
            mma16816(acc[d], lo, f[0], f[1]);
            mma16816(acc[d + 1], lo, f[2], f[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states go there
  float* red = reinterpret_cast<float*>(ring);
  float* ml = red + kWarps * 16 * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp * 16 + lane / 4 + hh * 8;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(red + row * HD + d * 8 + lane % 4 * 2) =
          make_float2(acc[d][2 * hh], acc[d][2 * hh + 1]);
    const float sum = quad_sum(l[hh]);
    if (lane % 4 == 0) {
      ml[row * 2] = m[hh];
      ml[row * 2 + 1] = sum;
    }
  }
  __syncthreads();
}

// a partial state's row: the accumulator, then (row max, row sum), padded
// to 16 bytes
template <int HD>
constexpr int kPart = HD + 4;

// 8 floats of a row: two 16-byte loads, from shared or (past L1) global
__device__ __forceinline__ void load8(float (&x)[8], const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8_cg(float (&x)[8], const float* src) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(src + 4));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// 8 floats times mul as 8 bf16, one 16-byte store
__device__ __forceinline__ void store8_bf16(bf16* dst, const float (&x)[8],
                                            float mul) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      pack_bf16(x[0] * mul, x[1] * mul), pack_bf16(x[2] * mul, x[3] * mul),
      pack_bf16(x[4] * mul, x[5] * mul), pack_bf16(x[6] * mul, x[7] * mul));
}

// Merge the kw warps' states of each row: the tile's output when it has
// one split, else this split's partial; the last split of the (tile, head)
// to finish merges all partials into the output. A thread takes 8
// columns of a row at a time, so the row's weights and addresses are
// worked out once for 8 values (a block alone on an SM runs one warp per
// scheduler, with nothing to hide a dependent chain behind).
template <int HD>
__device__ void finish(const Params& p, const Tile& t, unsigned char* area,
                       int* meta, int h, int split, int n_splits, int kw) {
  constexpr int PS = kPart<HD>, CW = HD / 8;
  const int tid = threadIdx.x;
  const int M = t.len * p.G;
  const float* red = reinterpret_cast<const float*>(area);
  const float* ml = red + kWarps * 16 * HD;
  const bool multi = n_splits > 1;
  auto out_at = [&](int r) {
    return ((long long)(t.start + r / p.G) * p.Hkv + h) * p.G + r % p.G;
  };
  const long long split_stride = (long long)p.N * p.Hkv * p.G * PS;
  for (int i = tid; i < M * CW; i += kThreads) {
    const int r = i / CW, d0 = i % CW * 8, rg = r / 16, rr = r % 16;
    float mx = -CUDART_INF_F;
    for (int g = 0; g < kw; ++g)
      mx = fmaxf(mx, ml[((rg * kw + g) * 16 + rr) * 2]);
    float L = 0.f, a[8] = {};
    for (int g = 0; g < kw; ++g) {
      const int w = (rg * kw + g) * 16 + rr;
      const float mw = ml[w * 2];
      if (mw == -CUDART_INF_F) continue;  // this warp saw no key
      const float f = exp2f(mw - mx);
      L += f * ml[w * 2 + 1];
      float x[8];
      load8(x, red + w * HD + d0);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] += f * x[e];
    }
    const long long row = out_at(r);
    if (!multi) {
      const bool zero = meta[kPosS + r / p.G] < 0 || L == 0.f;
      store8_bf16(p.out + row * HD + d0, a, zero ? 0.f : 1.f / L);
    } else {
      float* pr = p.part + split * split_stride + row * PS;
      *reinterpret_cast<float4*>(pr + d0) = make_float4(a[0], a[1], a[2],
                                                        a[3]);
      *reinterpret_cast<float4*>(pr + d0 + 4) = make_float4(a[4], a[5],
                                                            a[6], a[7]);
      if (d0 == 0) *reinterpret_cast<float2*>(pr + HD) = make_float2(mx, L);
    }
  }
  if (!multi) return;
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (long long)t.start * p.Hkv + h;
  if (tid == 0) {
    const int prev = atomicAdd(counter, 1);
    meta[kFlag + 6] = prev == n_splits - 1;
    // every split has arrived: the counter is free for the next launch
    if (prev == n_splits - 1) *counter = 0;
  }
  __syncthreads();
  if (!meta[kFlag + 6]) return;
  __threadfence();  // the other splits' partials are visible
  // every (row, split) state in one round of loads, then the weights
  float* w_s = reinterpret_cast<float*>(area) + kWarps * 16 * (HD + 2);
  float* l_s = w_s + kRows * kMaxSplits;
  float* inv_s = l_s + kRows * kMaxSplits;
  for (int i = tid; i < M * n_splits; i += kThreads) {
    const int r = i / n_splits, s = i % n_splits;
    const float2 st = __ldcg(reinterpret_cast<const float2*>(
        p.part + s * split_stride + out_at(r) * PS + HD));
    w_s[r * kMaxSplits + s] = st.x;
    l_s[r * kMaxSplits + s] = st.y;
  }
  __syncthreads();
  for (int r = tid; r < M; r += kThreads) {
    float* w = w_s + r * kMaxSplits;
    float mx = -CUDART_INF_F;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, w[s]);
    float L = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      w[s] = w[s] == -CUDART_INF_F ? 0.f : exp2f(w[s] - mx);
      L += w[s] * l_s[r * kMaxSplits + s];
    }
    inv_s[r] = meta[kPosS + r / p.G] < 0 || L == 0.f ? 0.f : 1.f / L;
  }
  __syncthreads();
  for (int i = tid; i < M * CW; i += kThreads) {
    const int r = i / CW, d0 = i % CW * 8;
    const long long row = out_at(r);
    const float* pr = p.part + row * PS + d0;
    const float* w = w_s + r * kMaxSplits;
    float a[8] = {};
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) {  // independent loads in flight
      float x[8];
      load8_cg(x, pr + s * split_stride);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] += w[s] * x[e];
    }
    store8_bf16(p.out + row * HD + d0, a, inv_s[r]);
  }
}

// One tile for kv head h and split blockIdx.z.
template <typename P, int HD>
__device__ void attend_tile(const Params& p, unsigned char* smem, int start,
                            int end, int h, int split) {
  using C = Cfg<P, HD>;
  int* meta = reinterpret_cast<int*>(smem + C::kQBytes + C::kArea +
                                     C::kScales);
  const Tile t = tile_meta(p, meta, start, end);
  if (!t.live) {
    if (split == 0) zero_rows(p, t, h, HD);
    return;
  }
  const int per = (t.n_stages + p.splits - 1) / p.splits;
  const int n_splits = (t.n_stages + per - 1) / per;  // the non-empty ones
  const int s0 = split * per;
  if (s0 >= t.n_stages) return;
  const int j0 = t.st_first + s0;
  const int j1 = t.st_first + min(s0 + per, t.n_stages);
  const int M = t.len * p.G;
  const int kw = M <= 16 ? 4 : M <= 32 ? 2 : 1;
  if (kw == 4) sweep<P, HD, 4>(p, t, smem, meta, h, j0, j1);
  else if (kw == 2) sweep<P, HD, 2>(p, t, smem, meta, h, j0, j1);
  else sweep<P, HD, 1>(p, t, smem, meta, h, j0, j1);
  finish<HD>(p, t, smem + C::kQBytes, meta, h, split, n_splits, kw);
}

template <typename P, int HD>
__global__ void __launch_bounds__(kThreads) paged_tc_kernel(const Params p) {
  using C = Cfg<P, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* meta = reinterpret_cast<int*>(smem + C::kQBytes + C::kArea +
                                     C::kScales);
  const int h = blockIdx.y, split = blockIdx.z;
  int start = blockIdx.x, end = start + 1;  // the paged entry: tile b = row b
  if (!p.ctx_lens) find_tile(p, blockIdx.x, meta, start, end);
  // the last block also takes every tile past the grid, in turn
  while (start >= 0 && start < p.N) {
    attend_tile<P, HD>(p, smem, start, end, h, split);
    if (blockIdx.x != gridDim.x - 1 || p.ctx_lens) break;
    start = end;
    if (start >= p.N) break;
    end = tile_end(p, start);
    __syncthreads();
  }
}

// the kernel's opt-in to its dynamic shared memory, once per device (the
// serve is host-bound: a CUDA API call per launch is not free)
template <typename P, int HD>
cudaError_t opt_in() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(paged_tc_kernel<P, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<P, HD>::kSmem);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// With splits > 1 the counters must be zero at the launch; the merging
// block of each (tile, head) leaves its counter zero again, so a buffer
// zeroed once serves every launch on its stream.
template <typename P, int HD>
int launch(const Params& p, int tiles, cudaStream_t s) {
  const cudaError_t e = opt_in<P, HD>();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_tc_kernel<P, HD><<<dim3(tiles, p.Hkv, p.splits), kThreads,
                           Cfg<P, HD>::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// blocks of paged_tc_kernel<P, HD> resident on one SM, and its shared memory
template <typename P, int HD>
int occupancy(int* smem) {
  *smem = Cfg<P, HD>::kSmem;
  opt_in<P, HD>();
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_tc_kernel<P, HD>,
                                                kThreads, *smem);
  return n;
}

template <typename P>
int by_hd(int hd, const Params& p, int tiles, cudaStream_t s, int* smem) {
  switch (hd) {
    case 32: return smem ? occupancy<P, 32>(smem) : launch<P, 32>(p, tiles, s);
    case 64: return smem ? occupancy<P, 64>(smem) : launch<P, 64>(p, tiles, s);
    case 128:
      return smem ? occupancy<P, 128>(smem) : launch<P, 128>(p, tiles, s);
    case 256:
      return smem ? occupancy<P, 256>(smem) : launch<P, 256>(p, tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pool_dtype: 0 = bf16, 1 = int8, 2 = float8 e4m3, 3 = float8 e5m2. With
// smem set, returns the kernel's blocks per SM (and its shared memory in
// *smem) instead of launching.
inline int dispatch(int pool_dtype, int hd, const Params& p, int tiles,
                    cudaStream_t s, int* smem = nullptr) {
  if (p.splits < 1 || p.splits > kMaxSplits || p.G < 1 || p.G > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pool_dtype) {
    case 0: return by_hd<bf16>(hd, p, tiles, s, smem);
    case 1: return by_hd<int8_t>(hd, p, tiles, s, smem);
    case 2: return by_hd<fp8e4m3>(hd, p, tiles, s, smem);
    case 3: return by_hd<fp8e5m2>(hd, p, tiles, s, smem);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ptc
}  // namespace
