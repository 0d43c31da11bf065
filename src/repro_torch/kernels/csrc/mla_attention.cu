// Ragged latent attention for Hopper (sm_90a): MLA's absorbed attention
// (deepseek-v3) over the paged latent pools, for every row of a fused
// mixed batch, and for the per-call decode and chunked prefill flattened to
// rows.
//
// Replaces: no Pallas kernel. The reference runs this attention as XLA ops
// in src/repro/models/attention.py: mla_mixed_paged (:742-784),
// mla_decode_paged (:562-605) and mla_extend_paged (:608-647), each a
// gather of the whole latent table per row (c_pool[bt_tok]) and float32
// einsums. At deepseek-v3's widths a 512-row call with contexts near 1000
// would materialize ~1 GB of float32 latents per layer, so the port
// computes it here instead. Row i (sequence tok_seq[i], position
// tok_pos[i]) and head h:
//   out[i, h] = sum_j softmax_j((q_lat[i, h] . c_j + q_rope[i, h] . kr_j)
//                               * scale) c_j,
// over the keys j = 0 .. tok_pos[i], key j at pool slot
// (block_tables[tok_seq[i], j / page], j % page); float32 out (N, H, L).
// A row with tok_pos -1 gives zeros.
//
// Bound on the H100: at deepseek-v3's widths (H 128, L 512, R 64) a
// (row, head, key) triple costs 2 (2 L + R) = 2176 operations against the
// key's 1152 bytes of latent, which all 128 heads of the row share, and
// each row reads its float32 queries (H (L + R) 4 B) and writes its float32
// output (H L 4 B) once. mla_serve's largest call (464 live rows, contexts
// 1-464) is bound by those bytes (~0.081 ms at 3.35 TB/s; its ~30 GFLOP
// take ~0.031 ms at the bf16 tensor-core peak, 0.45 ms at the float32
// CUDA-core rate).
//
// Two forms, picked by the launcher from the pools' dtype and the widths,
// as row 1's launcher does (nothing falls back from one to the other):
//
// The tensor-core form (namespace mla::tc; bf16 pools at L 512 and R 64,
// any H): this is MQA with a 576-wide qk and a 512-wide v, every head of a
// row on one latent per key, so heads go on the M dimension of mma.sync
// (m16n8k16, bf16 in, float32 accumulators). A block of 8 warps takes one
// row and a tile of 32 heads (heads past H compute on zeros and write
// nothing) and walks the row's keys 32 at a time: each key's c and kr rows
// (1152 B) are staged into a 4-stage shared-memory ring by cp.async (the
// slots of a tile's keys read from the block table one tile ahead) and
// read by every warp with ldmatrix. The float32 queries (times scale *
// log2 e) are split once into two bf16 terms (split<2>, mma.cuh: within
// 2^-16 of each value) and held as A fragments in registers: warp w takes
// head tile w / 4 and a quarter (w % 4) of the 576-wide depth, 9 k-steps
// of two terms, 72 registers. A key tile's scores S = Q [c|kr]^T are then
// four depth partials a (head, key), summed in shared memory in quarter
// order; the online softmax (log2 domain) runs 8 lanes a head, 4 keys a
// lane, and writes P's two bf16 terms; then O += P C, each warp owning 64
// of O's 512 columns for all 32 heads (64 float32 accumulators a thread).
// The tiles are software-pipelined, two barriers a tile: the softmax of
// tile t, then P C of tile t beside the scores of tile t + 1. c and kr are
// bf16, so they are exact in one term: a product is hi * b + lo * b. The
// bf16 products are twice the call's operations (~0.062 ms at peak at
// mla_serve's largest call), under its bytes bound. 217 registers, no
// spill; 175,360 B of shared memory, one block an SM.
//
// The CUDA-core form (float32 pools, and any width the tensor-core form
// does not take: L a multiple of 16 up to 512, R a multiple of 8 up to
// 64, e.g. the tiny config's L 32 and R 16): one block of 8 warps per
// (row, tile of 16 heads), 2 heads a warp. Each lane holds its heads'
// queries as registers, float4 slices 4 (lane + 32 m) of q_lat (times
// scale * log2 e) and a float2 of q_rope. Keys come 16 at a time: their c
// and kr rows are staged once in shared memory by 16-byte cp.async, in the
// pool's dtype, two stages deep, and every warp reads them. A lane's 32
// partial dot products (2 heads x 16 keys) are summed over the warp by a
// transposing butterfly (31 shuffles), after which lane l holds the score
// of head l / 16 and key l % 16; the online softmax runs in the log2
// domain, and each lane's float32 accumulator slices (both heads) take
// p * c of every key; float32 on the CUDA cores.
//
// In both forms a row's result depends on the row alone: no split of its
// keys is chosen from the grid, so a row computes the same bits in a call
// of N 1 as in one of N 512 (the fused path gives each token the
// arithmetic of the per-call paths).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma.cuh"

namespace mla {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 2 * kWarps;  // heads of a block
constexpr int kKeys = 16;           // keys a stage holds
constexpr int kMaxL = 512;
constexpr int kMaxR = 64;
constexpr int kSlices = kMaxL / 128;  // float4 slices of q_lat a lane holds
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const float* q_lat;   // (N, H, L)
  const float* q_rope;  // (N, H, R)
  const void* c_pool;   // (n_pages, page, L), T
  const void* kr_pool;  // (n_pages, page, R), T
  const int* block_tables;  // (B, max_pages)
  const int* tok_seq;       // (N,)
  const int* tok_pos;       // (N,)
  float* out;               // (N, H, L)
  int H, L, R, page, max_pages, n_pages;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& a, float s, float4 y) {
  a.x = fmaf(s, y.x, a.x);
  a.y = fmaf(s, y.y, a.y);
  a.z = fmaf(s, y.z, a.z);
  a.w = fmaf(s, y.w, a.w);
}

// keys [k0, k0 + kKeys) of the row into a stage: c rows then kr rows, in
// 16-byte pieces; keys at or past n_keys (or on a page id outside the pool)
// are zero-filled and never read from the pool
template <typename T>
__device__ __forceinline__ void stage_keys(T* c_s, T* kr_s, const Params& p,
                                           const int* table, int k0,
                                           int n_keys) {
  const int c_pieces = p.L * static_cast<int>(sizeof(T)) / 16;
  const int r_pieces = p.R * static_cast<int>(sizeof(T)) / 16;
  const int per_key = c_pieces + r_pieces;
  const char* c_pool = static_cast<const char*>(p.c_pool);
  const char* kr_pool = static_cast<const char*>(p.kr_pool);
  for (int e = threadIdx.x; e < kKeys * per_key; e += kThreads) {
    const int k = e / per_key, piece = e - k * per_key;
    const int key = k0 + k;
    int pid = 0;
    bool in = key < n_keys;
    if (in) {
      pid = table[key / p.page];
      in = pid >= 0 && pid < p.n_pages;
    }
    const long long slot = in ? (long long)pid * p.page + key % p.page : 0;
    if (piece < c_pieces) {
      cp_async16(reinterpret_cast<char*>(c_s + k * p.L) + 16 * piece,
                 c_pool + slot * p.L * sizeof(T) + 16 * piece, in);
    } else {
      const int rp = piece - c_pieces;
      cp_async16(reinterpret_cast<char*>(kr_s + k * p.R) + 16 * rp,
                 kr_pool + slot * p.R * sizeof(T) + 16 * rp, in);
    }
  }
}

// one round of the transposing butterfly over a warp's 2 O partial sums a
// lane: the lane keeps the half whose index bit O matches its own lane bit,
// summed with its partner's (lane ^ O) copy of that half, in v[0, O)
template <int O>
__device__ __forceinline__ void fold(float (&v)[2 * kKeys], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int u = 0; u < O; ++u) {
    const float send = up ? v[u] : v[u + O];
    const float keep = up ? v[u + O] : v[u];
    v[u] = keep + __shfl_xor_sync(kAll, send, O);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mla_attention_kernel(
    const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.y * kHeads;
  const int L4 = p.L / 4, R2 = p.R / 2;
  const int pos = p.tok_pos[i];
  if (pos < 0) {  // a padded row: zeros (the whole block returns here)
    const int heads = min(kHeads, p.H - h0);
    float4* o = reinterpret_cast<float4*>(p.out + ((long long)i * p.H + h0)
                                          * p.L);
    for (int e = threadIdx.x; e < heads * L4; e += kThreads)
      o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int n_keys = min(pos + 1, p.max_pages * p.page);
  const int* table = p.block_tables + (long long)p.tok_seq[i] * p.max_pages;
  const int stage_elems = kKeys * (p.L + p.R);
  T* base = reinterpret_cast<T*>(smem);

  // this warp's two heads; a head past H computes on zeros, writes nothing
  const int ha = h0 + 2 * warp, hb = ha + 1;
  const float mul = p.scale * kLog2e;
  float4 qa[kSlices], qb[kSlices], acc_a[kSlices], acc_b[kSlices];
  float2 ra = make_float2(0.f, 0.f), rb = make_float2(0.f, 0.f);
  const float* qla = p.q_lat + ((long long)i * p.H + ha) * p.L;
  const float* qra = p.q_rope + ((long long)i * p.H + ha) * p.R;
#pragma unroll
  for (int m = 0; m < kSlices; ++m) {
    const int e = lane + 32 * m;
    qa[m] = qb[m] = acc_a[m] = acc_b[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < L4) {
      if (ha < p.H) qa[m] = load4(qla + 4 * e);
      if (hb < p.H) qb[m] = load4(qla + p.L + 4 * e);
    }
    qa[m] = make_float4(qa[m].x * mul, qa[m].y * mul, qa[m].z * mul,
                        qa[m].w * mul);
    qb[m] = make_float4(qb[m].x * mul, qb[m].y * mul, qb[m].z * mul,
                        qb[m].w * mul);
  }
  if (lane < R2) {
    if (ha < p.H) ra = load2(qra + 2 * lane);
    if (hb < p.H) rb = load2(qra + p.R + 2 * lane);
    ra = make_float2(ra.x * mul, ra.y * mul);
    rb = make_float2(rb.x * mul, rb.y * mul);
  }
  // the softmax state of this lane's head (lane / 16: a, then b)
  float m_run = -CUDART_INF_F, l_run = 0.f;

  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  stage_keys(base, base + kKeys * p.L, p, table, 0, n_keys);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      T* nxt = base + ((t + 1) & 1) * stage_elems;
      stage_keys(nxt, nxt + kKeys * p.L, p, table, (t + 1) * kKeys, n_keys);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const T* c_s = base + (t & 1) * stage_elems;
    const T* kr_s = c_s + kKeys * p.L;
    // partial scores: v[k] head a, v[16 + k] head b
    float v[2 * kKeys];
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int m = 0; m < kSlices; ++m) {
        const int e = lane + 32 * m;
        if (e < L4) {
          const float4 c = load4(c_s + k * p.L + 4 * e);
          sa = dot4(qa[m], c, sa);
          sb = dot4(qb[m], c, sb);
        }
      }
      if (lane < R2) {
        const float2 r = load2(kr_s + k * p.R + 2 * lane);
        sa = fmaf(ra.x, r.x, fmaf(ra.y, r.y, sa));
        sb = fmaf(rb.x, r.x, fmaf(rb.y, r.y, sb));
      }
      v[k] = sa;
      v[kKeys + k] = sb;
    }
    // the transposing butterfly: lane l ends with the score of index l
    fold<16>(v, lane);
    fold<8>(v, lane);
    fold<4>(v, lane);
    fold<2>(v, lane);
    fold<1>(v, lane);
    const int key = t * kKeys + lane % kKeys;
    const float s = key < n_keys ? v[0] : -CUDART_INF_F;
    float mx = s;
#pragma unroll
    for (int o = kKeys / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));
    const float m_new = fmaxf(m_run, mx);  // finite: the tile's first key
    const float corr = exp2f(m_run - m_new);
    const float pr = exp2f(s - m_new);
    float sum = pr;
#pragma unroll
    for (int o = kKeys / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(kAll, sum, o);
    m_run = m_new;
    l_run = l_run * corr + sum;
    const float corr_a = __shfl_sync(kAll, corr, 0);
    const float corr_b = __shfl_sync(kAll, corr, kKeys);
#pragma unroll
    for (int m = 0; m < kSlices; ++m) {
      acc_a[m] = make_float4(acc_a[m].x * corr_a, acc_a[m].y * corr_a,
                             acc_a[m].z * corr_a, acc_a[m].w * corr_a);
      acc_b[m] = make_float4(acc_b[m].x * corr_b, acc_b[m].y * corr_b,
                             acc_b[m].z * corr_b, acc_b[m].w * corr_b);
    }
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const float pa = __shfl_sync(kAll, pr, k);
      const float pb = __shfl_sync(kAll, pr, kKeys + k);
#pragma unroll
      for (int m = 0; m < kSlices; ++m) {
        const int e = lane + 32 * m;
        if (e < L4) {
          const float4 c = load4(c_s + k * p.L + 4 * e);
          axpy4(acc_a[m], pa, c);
          axpy4(acc_b[m], pb, c);
        }
      }
    }
    __syncthreads();  // the stage is consumed before tile t + 2 refills it
  }
  const float inv_a = 1.f / __shfl_sync(kAll, l_run, 0);
  const float inv_b = 1.f / __shfl_sync(kAll, l_run, kKeys);
  float* oa = p.out + ((long long)i * p.H + ha) * p.L;
#pragma unroll
  for (int m = 0; m < kSlices; ++m) {
    const int e = lane + 32 * m;
    if (e >= L4) continue;
    if (ha < p.H)
      *reinterpret_cast<float4*>(oa + 4 * e) =
          make_float4(acc_a[m].x * inv_a, acc_a[m].y * inv_a,
                      acc_a[m].z * inv_a, acc_a[m].w * inv_a);
    if (hb < p.H)
      *reinterpret_cast<float4*>(oa + p.L + 4 * e) =
          make_float4(acc_b[m].x * inv_b, acc_b[m].y * inv_b,
                      acc_b[m].z * inv_b, acc_b[m].w * inv_b);
  }
}

template <typename T>
int smem_bytes(const Params& p) {
  return 2 * kKeys * (p.L + p.R) * static_cast<int>(sizeof(T));
}

template <typename T>
int launch(const Params& p, int N, cudaStream_t s) {
  const int smem = smem_bytes<T>(p);
  const cudaError_t e = cudaFuncSetAttribute(
      mla_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N, (p.H + kHeads - 1) / kHeads);
  mla_attention_kernel<T><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core form: bf16 pools at L 512, R 64
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kL = 512, kR = 64, kD = kL + kR;  // latent, rope, qk depth
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 32;    // heads of a block: two m16 tiles
constexpr int kKeys = 32;     // keys a stage holds
constexpr int kStages = 4;    // a tile scored, one multiplied, two in flight
constexpr int kQuarters = 4;  // depth quarters of the scores, a warp each
constexpr int kSteps = kD / 16 / kQuarters;  // k16 steps of a quarter: 9
constexpr int kPitch = kD + 8;  // a staged key: c, kr, 16 B of padding
constexpr int kStageElems = kKeys * kPitch;
constexpr int kSP = kKeys + 8;  // pitch of the score partials (float32)
constexpr int kPP = kKeys + 8;  // pitch of P's terms (bf16)
constexpr int kCols = kL / kWarps;  // O's columns a warp owns: 64
constexpr int kPieces = kD * 2 / 16;  // 16-byte pieces of a key: 72
constexpr int kCPieces = kL * 2 / 16;  // of them c's: 64
constexpr int kSmem = kStages * kStageElems * 2 + kQuarters * kHeads * kSP * 4
                      + 2 * kHeads * kPP * 2 + 2 * kHeads * 4;
static_assert(kD % (16 * kQuarters) == 0, "whole k-steps a quarter");
static_assert(kL % 16 == 0, "a k-step lies in q_lat or in q_rope");
static_assert(kKeys * kPieces % kThreads == 0, "whole pieces a thread");
static_assert(kWarps == 2 * kQuarters && kHeads == 4 * kWarps &&
                  kKeys == 32,
              "a warp per (head tile, quarter); a lane per key's slot; "
              "4 heads a warp, 8 lanes a head, in the softmax");

// the pool slot of key `key`, or -1 for a key at or past n_keys or on a
// page id outside the pool (zero-filled, never read from the pool)
__device__ __forceinline__ long long key_slot(const Params& p,
                                              const int* table, int key,
                                              int n_keys) {
  if (key >= n_keys) return -1;
  const int pid = table[key / p.page];
  return pid >= 0 && pid < p.n_pages ? (long long)pid * p.page + key % p.page
                                     : -1;
}

// a key tile into a stage, key rows of c then kr; lane k of every warp
// holds the slot of the tile's key k (key_slot)
__device__ __forceinline__ void stage_keys(bf16* st, const Params& p,
                                           long long slot_of_lane) {
  const char* c_pool = static_cast<const char*>(p.c_pool);
  const char* kr_pool = static_cast<const char*>(p.kr_pool);
#pragma unroll
  for (int j = 0; j < kKeys * kPieces / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int k = e / kPieces, piece = e - k * kPieces;
    const long long slot = __shfl_sync(kAll, slot_of_lane, k);
    const bool in = slot >= 0;
    const long long at = in ? slot : 0;
    const char* src =
        piece < kCPieces
            ? c_pool + at * (kL * 2) + 16 * piece
            : kr_pool + at * (kR * 2) + 16 * (piece - kCPieces);
    cp_async16(reinterpret_cast<char*>(st + k * kPitch) + 16 * piece, src,
               in);
  }
}

// q[i, h, d..d+1] of the 576-wide query (q_lat, then q_rope); zeros for a
// head past H
__device__ __forceinline__ float2 q_pair(const Params& p, int i, int h,
                                         int d) {
  if (h >= p.H) return make_float2(0.f, 0.f);
  const long long row = (long long)i * p.H + h;
  return d < kL
             ? *reinterpret_cast<const float2*>(p.q_lat + row * kL + d)
             : *reinterpret_cast<const float2*>(p.q_rope + row * kR + d - kL);
}

// 1. this warp's quarter dq of S for head tile mt: 16 heads x 32 keys over
// 144 of the depth, the hi and lo terms' products in accumulators of their
// own, summed into the partials
__device__ __forceinline__ void score_quarter(
    float* s_part, const bf16* st, const uint32_t (&qh)[kSteps][4],
    const uint32_t (&ql)[kSteps][4], int mt, int dq, int g, int c2) {
  float sh[4][4], sl[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) sh[n][r] = sl[n][r] = 0.f;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int k0 = 16 * (kSteps * dq + s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t b[4];
      ldsm_b<kPitch>(b, st, 16 * j, k0);
      mma16816(sh[2 * j], qh[s], b[0], b[1]);
      mma16816(sl[2 * j], ql[s], b[0], b[1]);
      mma16816(sh[2 * j + 1], qh[s], b[2], b[3]);
      mma16816(sl[2 * j + 1], ql[s], b[2], b[3]);
    }
  }
  float* sp = s_part + (dq * kHeads + 16 * mt) * kSP;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(sp + g * kSP + 8 * n + c2) =
        make_float2(sh[n][0] + sl[n][0], sh[n][1] + sl[n][1]);
    *reinterpret_cast<float2*>(sp + (g + 8) * kSP + 8 * n + c2) =
        make_float2(sh[n][2] + sl[n][2], sh[n][3] + sl[n][3]);
  }
}

// 2. the online softmax of local head hl over keys k4 .. k4 + 3 of the tile
// at key0 (8 lanes a head): the quarters summed in order, P written as two
// bf16 terms, the head's correction to corr_s
__device__ __forceinline__ void softmax_tile(const float* s_part,
                                             bf16* p_terms, float* corr_s,
                                             float& m_run, float& l_run,
                                             int hl, int k4, int key0,
                                             int n_keys) {
  const float* sp0 = s_part + hl * kSP + k4;
  float4 x = *reinterpret_cast<const float4*>(sp0);
#pragma unroll
  for (int q = 1; q < kQuarters; ++q) {
    const float4 y = *reinterpret_cast<const float4*>(sp0 + q * kHeads * kSP);
    x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
  float v[4] = {x.x, x.y, x.z, x.w};
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    v[u] = key0 + k4 + u < n_keys ? v[u] : -CUDART_INF_F;
    mx = fmaxf(mx, v[u]);
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, w));
  const float m_new = fmaxf(m_run, mx);  // finite: the tile's key 0
  const float corr = exp2f(m_run - m_new);
  float sum = 0.f;
  uint32_t hi[2], lo[2];
#pragma unroll
  for (int u = 0; u < 4; u += 2) {
    const float p0 = exp2f(v[u] - m_new), p1 = exp2f(v[u + 1] - m_new);
    sum += p0 + p1;
    float a[2], b[2];
    split<2>(p0, a);
    split<2>(p1, b);
    hi[u / 2] = pack_bf16(a[0], b[0]);
    lo[u / 2] = pack_bf16(a[1], b[1]);
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) sum += __shfl_xor_sync(kAll, sum, w);
  l_run = l_run * corr + sum;
  m_run = m_new;
  *reinterpret_cast<uint2*>(p_terms + hl * kPP + k4) =
      make_uint2(hi[0], hi[1]);
  *reinterpret_cast<uint2*>(p_terms + (kHeads + hl) * kPP + k4) =
      make_uint2(lo[0], lo[1]);
  if (k4 == 0) corr_s[hl] = corr;
}

// 3. O = O * corr + P C over this warp's 64 columns, both head tiles
__device__ __forceinline__ void pv_tile(float (&o)[2][kCols / 8][4],
                                        const bf16* st, const bf16* p_terms,
                                        const float* corr_s, int warp,
                                        int g) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float ca = corr_s[16 * a + g], cb = corr_s[16 * a + g + 8];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      o[a][n][0] *= ca;
      o[a][n][1] *= ca;
      o[a][n][2] *= cb;
      o[a][n][3] *= cb;
    }
  }
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks) {
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      ldsm_a<kPP>(ph[a], p_terms, 16 * a, 16 * ks);
      ldsm_a<kPP>(pl[a], p_terms + kHeads * kPP, 16 * a, 16 * ks);
    }
#pragma unroll
    for (int j = 0; j < kCols / 16; ++j) {
      uint32_t b[4];
      ldsm_bt<kPitch>(b, st, 16 * ks, kCols * warp + 16 * j);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        mma16816(o[a][2 * j], ph[a], b[0], b[1]);
        mma16816(o[a][2 * j], pl[a], b[0], b[1]);
        mma16816(o[a][2 * j + 1], ph[a], b[2], b[3]);
        mma16816(o[a][2 * j + 1], pl[a], b[2], b[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_attention_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* s_part = reinterpret_cast<float*>(stages + kStages * kStageElems);
  bf16* p_terms = reinterpret_cast<bf16*>(s_part + kQuarters * kHeads * kSP);
  float* corr_s = reinterpret_cast<float*>(p_terms + 2 * kHeads * kPP);
  float* inv_s = corr_s + kHeads;

  const int head_tiles = (p.H + kHeads - 1) / kHeads;
  const int i = blockIdx.x / head_tiles;
  const int h0 = blockIdx.x % head_tiles * kHeads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  float* out = p.out + (long long)i * p.H * kL;
  const int pos = p.tok_pos[i];
  if (pos < 0) {  // a padded row: zeros (the whole block returns here)
    const int heads = min(kHeads, p.H - h0);
    float4* o = reinterpret_cast<float4*>(out + (long long)h0 * kL);
    for (int e = threadIdx.x; e < heads * kL / 4; e += kThreads)
      o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int n_keys = min(pos + 1, p.max_pages * p.page);
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int* table = p.block_tables + (long long)p.tok_seq[i] * p.max_pages;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      stage_keys(stages + t * kStageElems, p,
                 key_slot(p, table, t * kKeys + lane, n_keys));
    cp_async_commit();
  }
  // the slots of the next tile to stage, read one tile ahead of its use
  long long next_slot =
      key_slot(p, table, (kStages - 1) * kKeys + lane, n_keys);

  // this warp's scores: head tile mt (16 heads), depth quarter dq; its
  // queries' A fragments, times scale * log2 e, as two bf16 terms
  const int mt = warp / kQuarters, dq = warp % kQuarters;
  const int ha = h0 + 16 * mt + g, hb = ha + 8;
  const float mul = p.scale * kLog2e;
  uint32_t qh[kSteps][4], ql[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int d = 16 * (kSteps * dq + s) + c2;
    const float2 x[4] = {q_pair(p, i, ha, d), q_pair(p, i, hb, d),
                         q_pair(p, i, ha, d + 8), q_pair(p, i, hb, d + 8)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float a[2], b[2];
      split<2>(x[r].x * mul, a);
      split<2>(x[r].y * mul, b);
      qh[s][r] = pack_bf16(a[0], b[0]);
      ql[s][r] = pack_bf16(a[1], b[1]);
    }
  }
  // the softmax state of local head hl over keys k4 .. k4 + 3 of a tile,
  // held by the 8 lanes of the head alike, and O's columns kCols warp ..
  // + 63 for all 32 heads
  const int hl = 4 * warp + lane / 8, k4 = 4 * (lane % 8);
  float m_run = -CUDART_INF_F, l_run = 0.f;
  float o[2][kCols / 8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[a][n][r] = 0.f;

  // software-pipelined over the key tiles, two barriers a tile: the
  // softmax of tile t, then P C of tile t beside the scores of tile t + 1
  cp_async_wait<kStages - 2>();  // tile 0
  __syncthreads();
  score_quarter(s_part, stages, qh, ql, mt, dq, g, c2);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    softmax_tile(s_part, p_terms, corr_s, m_run, l_run, hl, k4, t * kKeys,
                 n_keys);
    cp_async_wait<kStages - 3>();  // this thread's copies of tile t + 1
    // P and its corrections written, the partials read, tile t + 1
    // landed, and tile t - 1's stage consumed
    __syncthreads();
    if (t + kStages - 1 < n_tiles) {
      stage_keys(stages + (t + kStages - 1) % kStages * kStageElems, p,
                 next_slot);
      next_slot = key_slot(p, table, (t + kStages) * kKeys + lane, n_keys);
    }
    cp_async_commit();
    pv_tile(o, stages + t % kStages * kStageElems, p_terms, corr_s, warp, g);
    if (t + 1 < n_tiles)
      score_quarter(s_part, stages + (t + 1) % kStages * kStageElems, qh,
                    ql, mt, dq, g, c2);
    __syncthreads();  // the partials written, P consumed
  }
  cp_async_wait<0>();
  if (k4 == 0) inv_s[hl] = 1.f / l_run;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int ra = 16 * a + g, rb = ra + 8;
    const float ia = inv_s[ra], ib = inv_s[rb];
    float* oa = out + (long long)(h0 + ra) * kL + kCols * warp + c2;
    float* ob = out + (long long)(h0 + rb) * kL + kCols * warp + c2;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      if (h0 + ra < p.H)
        *reinterpret_cast<float2*>(oa + 8 * n) =
            make_float2(o[a][n][0] * ia, o[a][n][1] * ia);
      if (h0 + rb < p.H)
        *reinterpret_cast<float2*>(ob + 8 * n) =
            make_float2(o[a][n][2] * ib, o[a][n][3] * ib);
    }
  }
}

int launch(const Params& p, int N, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      mla_attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (long long)N * ((p.H + kHeads - 1) / kHeads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mla_attention_tc_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                            s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace mla

// dtype of the pools: 0 = float32, 1 = bfloat16; q_lat, q_rope and out
// are float32. bf16 pools at L 512 and R 64 take the tensor-core form;
// every other call takes the CUDA-core form, which takes L a multiple of
// 16 up to 512 and R a multiple of 8 up to 64. The pools start on a
// 16-byte boundary. Returns the launch's cudaError_t.
extern "C" int mla_attention_launch(
    const float* q_lat, const float* q_rope, const void* c_pool,
    const void* kr_pool, const int* block_tables, const int* tok_seq,
    const int* tok_pos, float* out, int N, int H, int L, int R, int page,
    int max_pages, int n_pages, float scale, int dtype, void* stream) {
  if (N == 0 || H == 0) return 0;
  if (L <= 0 || L % 16 || L > mla::kMaxL || R <= 0 || R % 8 ||
      R > mla::kMaxR || page <= 0 || max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const mla::Params p{q_lat, q_rope, c_pool, kr_pool, block_tables, tok_seq,
                      tok_pos, out, H, L, R, page, max_pages, n_pages,
                      scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && L == mla::tc::kL && R == mla::tc::kR)
    return mla::tc::launch(p, N, s);
  if (dtype == 0) return mla::launch<float>(p, N, s);
  if (dtype == 1) return mla::launch<__nv_bfloat16>(p, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

// resident blocks per SM of a kernel at its dynamic shared memory; -1 on
// an error
template <typename K>
int blocks_per_sm(K kernel, int threads, int smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// The dynamic shared memory of the form that takes widths L, R over pools
// of dtype (the codes of mla_attention_launch) into *smem, and its
// resident blocks per SM (the return value; -1 for a dtype neither takes).
extern "C" int mla_attention_occupancy(int dtype, int L, int R, int* smem) {
  mla::Params p{};
  p.L = L;
  p.R = R;
  if (dtype == 1 && L == mla::tc::kL && R == mla::tc::kR) {
    *smem = mla::tc::kSmem;
    return blocks_per_sm(mla::tc::mla_attention_tc_kernel,
                         mla::tc::kThreads, *smem);
  }
  if (dtype == 0) {
    *smem = mla::smem_bytes<float>(p);
    return blocks_per_sm(mla::mla_attention_kernel<float>, mla::kThreads,
                         *smem);
  }
  if (dtype == 1) {
    *smem = mla::smem_bytes<__nv_bfloat16>(p);
    return blocks_per_sm(mla::mla_attention_kernel<__nv_bfloat16>,
                         mla::kThreads, *smem);
  }
  return -1;
}
