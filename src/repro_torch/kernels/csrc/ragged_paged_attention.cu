// Ragged-query paged attention for Hopper (sm_90a), the fused mixed-batch
// iteration's attention core.
//
// Replaces: src/repro/kernels/ragged_paged_attention.py, function
// ragged_paged_attention (Pallas body _ragged_kernel). Flat token n's G
// grouped query heads attend over the pages block_tables[tok_seq[n], i] of
// its own sequence, masked to kv position <= tok_pos[n] (and to the last
// `window` positions when window > 0), with an online softmax and float32
// accumulators. tok_pos[n] == -1 marks a padded row, whose output is zeros.
//
// Bound on the H100: bytes. Each live KV page of a sequence is read from HBM
// (3.35 TB/s); the arithmetic per byte is G * 2 flops per element, far below
// the ~295 flop/byte ridge of the bf16 tensor cores.
//
// Design: one block per (token n, kv head h). The block loads its own
// tok_seq[n] / tok_pos[n] and block-table row from global memory, which
// takes the place of the TPU's scalar prefetch. Instead of the TPU grid's
// full max_pages sweep with pl.when, it loops only over the live pages,
// from the window's first page to (ctx - 1) / page. Each page's K and V tile
// for head h is staged through shared memory (K rows padded by one float so
// the score loop is free of bank conflicts); each of the G query rows keeps
// its running max, sum and head_dim-wide accumulator in float32 shared
// memory. Simple and right first: no tensor cores, no TMA, no split-KV.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) ragged_kernel(
    const T* __restrict__ q,              // (N, Hkv, G, HD)
    const T* __restrict__ k_pool,         // (n_pages, page, Hkv, HD)
    const T* __restrict__ v_pool,         // (n_pages, page, Hkv, HD)
    const int* __restrict__ block_tables, // (B, max_pages)
    const int* __restrict__ tok_seq,      // (N,)
    const int* __restrict__ tok_pos,      // (N,)
    T* __restrict__ out,                  // (N, Hkv, G, HD)
    int Hkv, int G, int page, int max_pages, int window, float softcap,
    float scale) {
  constexpr int KS = HD + 1;  // padded K row stride in shared memory
  extern __shared__ float smem[];
  float* q_s = smem;                 // G * HD
  float* acc = q_s + G * HD;         // G * HD
  float* k_s = acc + G * HD;         // page * KS
  float* v_s = k_s + page * KS;      // page * HD
  float* p_s = v_s + page * HD;      // G * page: scores, then probabilities
  float* m_s = p_s + G * page;       // G running max
  float* l_s = m_s + G;              // G running sum
  float* c_s = l_s + G;              // G rescale factor of this page

  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int gh = G * HD;
  const long long qo = ((long long)n * Hkv + h) * gh;
  const int ctx = tok_pos[n] + 1;  // this token sees positions < ctx
  if (ctx <= 0) {
    for (int i = tid; i < gh; i += kThreads) out[qo + i] = from_float<T>(0.f);
    return;
  }
  for (int i = tid; i < gh; i += kThreads) {
    q_s[i] = to_float(q[qo + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int lo = window > 0 ? max(0, ctx - window) : 0;  // first visible pos
  const int first = lo / page;
  const int last = min((ctx - 1) / page, max_pages - 1);
  const int* bt = block_tables + (long long)tok_seq[n] * max_pages;
  const long long slot_stride = (long long)Hkv * HD;  // elements per slot
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int pi = first; pi <= last; ++pi) {
    const long long base =
        (long long)bt[pi] * page * slot_stride + (long long)h * HD;
    __syncthreads();  // the previous page's tiles are fully consumed
    for (int i = tid; i < page * HD; i += kThreads) {
      const int t = i / HD;
      const int d = i - t * HD;
      const long long o = base + t * slot_stride + d;
      k_s[t * KS + d] = to_float(k_pool[o]);
      v_s[i] = to_float(v_pool[o]);
    }
    __syncthreads();
    for (int i = tid; i < G * page; i += kThreads) {
      const int g = i / page;
      const int t = i - g * page;
      const float* qr = q_s + g * HD;
      const float* kr = k_s + t * KS;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      float s = dot * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int pos = pi * page + t;
      if (pos >= ctx || pos < lo) s = kNegInf;
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query row; every live page holds at
    // least one visible position, so m_new is finite
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[g * page + t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(p_s[g * page + t] - m_new);
        p_s[g * page + t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < gh; i += kThreads) {
      const int g = i / HD;
      const int d = i - g * HD;
      const float* pr = p_s + g * page;
      float a = acc[i] * c_s[g];
      for (int t = 0; t < page; ++t) a += pr[t] * v_s[t * HD + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < gh; i += kThreads) {
    const int g = i / HD;
    out[qo + i] = from_float<T>(acc[i] / fmaxf(l_s[g], 1e-37f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* block_tables, const int* tok_seq, const int* tok_pos,
           void* out, int N, int Hkv, int G, int page, int max_pages,
           int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * G * HD + page * (HD + 1) + page * HD + G * page + 3 * G);
  dim3 grid(N, Hkv);
  ragged_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, tok_seq, tok_pos,
      static_cast<T*>(out), Hkv, G, page, max_pages, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k_pool, const void* v_pool,
              const int* block_tables, const int* tok_seq, const int* tok_pos,
              void* out, int N, int Hkv, int G, int page, int max_pages,
              int window, float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, block_tables, tok_seq, tok_pos,
                           out, N, Hkv, G, page, max_pages, window, softcap,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, block_tables, tok_seq, tok_pos,
                           out, N, Hkv, G, page, max_pages, window, softcap,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, block_tables, tok_seq, tok_pos,
                            out, N, Hkv, G, page, max_pages, window, softcap,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean none.
// Returns the cudaError_t of the launch.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const int* block_tables, const int* tok_seq, const int* tok_pos,
    void* out, int N, int Hkv, int G, int hd, int page, int max_pages,
    int window, float softcap, float scale, int dtype, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k_pool, v_pool, block_tables, tok_seq,
                            tok_pos, out, N, Hkv, G, page, max_pages, window,
                            softcap, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, block_tables,
                                    tok_seq, tok_pos, out, N, Hkv, G, page,
                                    max_pages, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
