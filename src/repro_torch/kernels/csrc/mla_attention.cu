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
// key's 1152 bytes of latent, which all 128 heads of the row share: a call
// is bound by operations (bf16 tensor cores: 989 TFLOP/s; this kernel runs
// them in float32 on the CUDA cores, 67 TFLOP/s).
//
// Design (simple first; the tensor-core form is later work): one block of
// 8 warps per (row, tile of 16 heads), 2 heads a warp. Each lane holds its
// heads' queries as registers, float4 slices 4 (lane + 32 m) of q_lat
// (times scale * log2 e) and a float2 of q_rope. Keys come 16 at a time:
// their c and kr rows are staged once in shared memory by 16-byte
// cp.async, in the pool's dtype, two stages deep, and every warp reads
// them. A lane's 32 partial dot products (2 heads x 16 keys) are summed
// over the warp by a transposing butterfly (31 shuffles), after which lane
// l holds the score of head l / 16 and key l % 16; the online softmax runs
// in the log2 domain, and each lane's float32 accumulator slices (both
// heads) take p * c of every key. A row's result depends on the row alone:
// no split of its keys is chosen from the grid, so a row computes the same
// bits in a call of N 1 as in one of N 512 (the fused path gives each
// token the arithmetic of the per-call paths).
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
int launch(const Params& p, int N, cudaStream_t s) {
  const int smem = 2 * kKeys * (p.L + p.R) * static_cast<int>(sizeof(T));
  const cudaError_t e = cudaFuncSetAttribute(
      mla_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N, (p.H + kHeads - 1) / kHeads);
  mla_attention_kernel<T><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mla

// dtype of the pools: 0 = float32, 1 = bfloat16; q_lat, q_rope and out are
// float32. L a multiple of 16 up to 512, R a multiple of 8 up to 64; the
// pools start on a 16-byte boundary. Returns the launch's cudaError_t.
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
  if (dtype == 0) return mla::launch<float>(p, N, s);
  if (dtype == 1) return mla::launch<__nv_bfloat16>(p, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
