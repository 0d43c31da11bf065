// Paged decode attention for Hopper (sm_90a), the per-call decode path's
// attention core (unfused decode and the speculative fork's decode).
//
// Replaces: src/repro/kernels/paged_attention.py, function paged_attention
// (Pallas body _paged_kernel). Sequence b's single new query token, as its
// G grouped query heads of kv head h, attends over positions [lo, ctx) of
// its pages block_tables[b, i], where ctx = ctx_lens[b] and lo = ctx - window
// when window > 0 (else 0), with an online softmax and float32 accumulators.
// ctx_lens[b] == 0 marks a padded row, whose output is zeros (the TPU
// kernel's max(l, 1e-37) flush of an untouched accumulator). The pools hold
// q's type, or a quantized 1-byte payload (int8, float8 e4m3 or e5m2) with
// one float32 scale per (page, kv head) in k_scale / v_scale.
//
// Bound on the H100: bytes. Each live KV page of a sequence is read once
// from HBM (3.35 TB/s) per kv head; the arithmetic is G * 4 flops per K/V
// element pair, far below the ~295 flop/byte ridge of the bf16 tensor cores.
// A 1-byte payload halves the bytes of a bf16 pool.
//
// Two routes:
// - bf16 q with G <= 64 (every serve path): the tensor-core sweep of
//   paged_tc.cuh, the ragged problem with one row per sequence (tile b =
//   row b at position ctx_lens[b] - 1). A B = 1 decode alone gives Hkv
//   blocks, so the keys are split over blockIdx.z (the wrapper sizes the
//   split from B and the table, without a host sync) and merged by
//   log-sum-exp; each split's pages are staged by pipelined cp.async, the
//   four warps share out its keys, and the scores and P.V run on mma.sync.
// - float32 q (the parity checks), and bf16 q with G > 64 (more rows than a
//   tile holds): the CUDA-core kernel below, one block per (sequence b, kv
//   head h), the TPU grid's (B, Hkv) axes; a loop inside the block visits
//   only the live pages, i * page < ctx and, for a window, (i + 1) * page >
//   ctx - window, as the TPU kernel's pl.when does. Each page's K and V
//   tile for head h is staged through shared memory with 16-byte loads
//   (converted to float32 and multiplied by the page's scale as they are
//   stored; K rows padded by one float against bank conflicts); the G query
//   rows and their running max, sum and accumulator stay in float32 shared
//   memory.
#include "paged_tc.cuh"
#include "payload.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;                  // (B, Hkv, G, HD), T
  const void* k_pool;             // (n_pages, page, Hkv, HD), P
  const void* v_pool;             // (n_pages, page, Hkv, HD), P
  const float* k_scale;           // (n_pages, Hkv), or null: not quantized
  const float* v_scale;
  const int* block_tables;        // (B, max_pages)
  const int* ctx_lens;            // (B,)
  void* out;                      // (B, Hkv, G, HD), T
  int Hkv, G, page, max_pages, window;
  float softcap, scale;
};

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads) paged_kernel(const Params prm) {
  constexpr int KS = HD + 1;                  // padded K row stride
  constexpr int VEC = 16 / sizeof(P);         // elements per 16-byte load
  constexpr int ROW_VECS = HD / VEC;          // 16-byte loads per row
  const T* __restrict__ q = static_cast<const T*>(prm.q);
  const P* __restrict__ k_pool = static_cast<const P*>(prm.k_pool);
  const P* __restrict__ v_pool = static_cast<const P*>(prm.v_pool);
  T* __restrict__ out = static_cast<T*>(prm.out);
  const int Hkv = prm.Hkv, G = prm.G, page = prm.page;
  const int window = prm.window;
  const float softcap = prm.softcap;
  extern __shared__ float smem[];
  float* q_s = smem;                 // G * HD
  float* acc = q_s + G * HD;         // G * HD
  float* k_s = acc + G * HD;         // page * KS
  float* v_s = k_s + page * KS;      // page * HD
  float* p_s = v_s + page * HD;      // G * page: scores, then probabilities
  float* m_s = p_s + G * page;       // G running max
  float* l_s = m_s + G;              // G running sum
  float* c_s = l_s + G;              // G rescale factor of this page

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int gh = G * HD;
  const long long qo = ((long long)b * Hkv + h) * gh;
  const int ctx = prm.ctx_lens[b];  // the query sees positions < ctx
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
  const int last = min((ctx - 1) / page, prm.max_pages - 1);
  const int* bt = prm.block_tables + (long long)b * prm.max_pages;
  const long long slot_stride = (long long)Hkv * HD;  // elements per slot
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int pi = first; pi <= last; ++pi) {
    const int pid = bt[pi];
    const long long base = (long long)pid * page * slot_stride +
                           (long long)h * HD;
    // a quantized page's per-head scales; 1 (exact) for a float pool
    const float ks = prm.k_scale ? prm.k_scale[(long long)pid * Hkv + h] : 1.f;
    const float vs = prm.v_scale ? prm.v_scale[(long long)pid * Hkv + h] : 1.f;
    __syncthreads();  // the previous page's tiles are fully consumed
    for (int i = tid; i < page * ROW_VECS; i += kThreads) {
      const int t = i / ROW_VECS;
      const int d0 = (i - t * ROW_VECS) * VEC;
      const long long o = base + t * slot_stride + d0;
      const uint4 kw = *reinterpret_cast<const uint4*>(k_pool + o);
      const uint4 vw = *reinterpret_cast<const uint4*>(v_pool + o);
      const P* ke = reinterpret_cast<const P*>(&kw);
      const P* ve = reinterpret_cast<const P*>(&vw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        k_s[t * KS + d0 + j] = to_float(ke[j]) * ks;
        v_s[t * HD + d0 + j] = to_float(ve[j]) * vs;
      }
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
      float s = dot * prm.scale;
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

template <typename T, typename P, int HD>
int launch(const Params& prm, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * prm.G * HD + prm.page * (HD + 1) + prm.page * HD +
       prm.G * prm.page + 3 * prm.G);
  paged_kernel<T, P, HD><<<dim3(B, prm.Hkv), kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_hd(int hd, const Params& prm, int B, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, P, 32>(prm, B, stream);
    case 64: return launch<T, P, 64>(prm, B, stream);
    case 128: return launch<T, P, 128>(prm, B, stream);
    case 256: return launch<T, P, 256>(prm, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pool_dtype: 0 = q's type, 1 = int8, 2 = float8 e4m3, 3 = float8 e5m2
template <typename T>
int launch_pool(int pool_dtype, int hd, const Params& prm, int B,
                cudaStream_t stream) {
  switch (pool_dtype) {
    case 0: return launch_hd<T, T>(hd, prm, B, stream);
    case 1: return launch_hd<T, int8_t>(hd, prm, B, stream);
    case 2: return launch_hd<T, fp8e4m3>(hd, prm, B, stream);
    case 3: return launch_hd<T, fp8e5m2>(hd, prm, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (q and out): 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores
// for G <= 64, the CUDA-core kernel above for a larger G). pool_dtype: 0 =
// q's type (k_scale and v_scale null), 1 = int8, 2 = float8 e4m3, 3 =
// float8 e5m2 (both scales set). window <= 0 and softcap <= 0 mean none.
// Tensor cores only: `splits` key splits; with splits > 1, part is (splits,
// B, Hkv, G, hd + 4) float32 scratch and counters (B, Hkv) int32, zero at
// the launch and left zero by it. Returns the
// cudaError_t of the launch.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* block_tables,
    const int* ctx_lens, void* out, float* part, int* counters, int B,
    int Hkv, int G, int hd, int page, int max_pages, int window, int splits,
    float softcap, float scale, int dtype, int pool_dtype, void* stream) {
  if (B == 0) return 0;
  if ((pool_dtype == 0) != (k_scale == nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && G <= ptc::kRows) {
    if (splits > 1 && (!part || !counters))
      return static_cast<int>(cudaErrorInvalidValue);
    const ptc::Params p{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                        k_scale, v_scale, block_tables, nullptr, nullptr,
                        ctx_lens, static_cast<__nv_bfloat16*>(out), part,
                        counters, B, Hkv, G, page, max_pages, window, 1,
                        splits, softcap, scale};
    return ptc::dispatch(pool_dtype, hd, p, B, s);
  }
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{q, k_pool, v_pool, k_scale, v_scale, block_tables,
                   ctx_lens, out, Hkv, G, page, max_pages, window, softcap,
                   scale};
  return dtype == 0 ? launch_pool<float>(pool_dtype, hd, prm, B, s)
                   : launch_pool<__nv_bfloat16>(pool_dtype, hd, prm, B, s);
}
