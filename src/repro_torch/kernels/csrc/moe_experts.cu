// Routed experts of a fine-grained MoE FFN for Hopper (sm_90a): a grouped
// matrix product over the (token, expert) pairs that each expert received.
//
// Replaces no Pallas kernel: the reference computes its experts with XLA's
// dense dispatch einsums (src/repro/models/moe.py:85-94, moe_forward's
// per_group), over an (E, C, d) buffer per dispatch group. With a group per
// token, as the fused, paged-decode and decode paths call it, that buffer is
// E x k rows per token, about E / k times the useful work, and a 0.8 GB
// buffer at 512 tokens for deepseek-moe-16b. Here every expert runs only the
// rows routed to it.
//
// Inputs: the token rows x (N, d); the experts' weights w_gate, w_up
// (E, d, fe) and w_down (E, fe, d); the gates (N, k) in x's dtype; the pairs
// in expert-major order (pair: flat pair ids t * k + r, sorted by expert,
// stable), their validity in flat order (a pair past its expert's capacity
// is dropped) and the expert offsets (E + 1) into the sorted pairs. The
// routing that makes them runs on the device and never syncs with the host,
// so nothing here may either: each block finds its own tile.
//
// Three launches:
//  (a) gate/up: a grid of ceil(P / 64) + min(E, P) tile slots x fe / 64.
//      Each block walks the offsets to its (expert, 64-row tile); slots
//      past the last tile exit. It gathers its pairs' x rows and runs both
//      products, then writes h = act(g) * u per sorted pair, rounded where
//      the plain version rounds (g and u to bf16, act(g) to bf16, then the
//      product). A dropped pair writes a zero row.
//  (b) down: the same tiling over h (contiguous in sorted order) with
//      K = fe, writing each pair's output row at its flat pair id; a
//      dropped pair's row is zero.
//  (c) combine: out[t] = sum_r w[t, r] * y[t * k + r], summed in float32 in
//      r order and rounded once. No atomics: the result is the same from
//      run to run.
//
// Types: bf16 runs (a) and (b) on the tensor cores (mma.sync m16n8k16 with
// float32 accumulators, operands staged through shared memory by cp.async
// in a 3-stage ring; this is the first design, wgmma and TMA are later
// work); float32, the parity runs' type, runs them on the CUDA cores.
//
// Bound on the H100: bytes. A decode step's 48 pairs touch about 34 of 64
// experts, 17 MB of bf16 weights each at deepseek-moe-16b's widths; a
// 512-token prefill call reads all 64 (1.1 GB) for 53 GFLOP, still below
// the card's 295 operations per byte. What (a) and (b) must do is stream
// each touched expert's weights once at the memory's rate: every block
// reads its own 64-column slice of one expert, so the slices are read once
// per row tile, and a decode step's tiles are one per expert.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 64;            // sorted pairs of a tile
constexpr int BN = 64;            // output columns of a tile
constexpr int BK = 32;            // depth of a bf16 stage
constexpr int kStages = 3;
constexpr int kThreads = 128;     // bf16: 4 warps, 2 x 2 over the tile
constexpr int APITCH = BK + 8;    // 80-byte rows: ldmatrix without conflicts
constexpr int BPITCH = BN + 8;
constexpr int FBK = 16;           // depth of a float32 stage
constexpr int kFThreads = 256;    // float32: 16 x 16 threads, 4 x 4 each
constexpr int kMaxExperts = 256;
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the reference's activations: silu, gelu (tanh approximation), relu
__device__ __forceinline__ float activation(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));
  if (act == 1)
    return 0.5f * g *
           (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.f);
}

// Block s's expert and tile: the sorted rows [row0, row0 + rows) of expert
// e. False for a slot past the last tile. The offsets are in shared memory.
__device__ __forceinline__ bool find_tile(const int* off, int E, int s,
                                          int& e, int& row0, int& rows) {
  int acc = 0;
  for (int i = 0; i < E; ++i) {
    const int n = off[i + 1] - off[i];
    const int tiles = (n + BM - 1) / BM;
    if (s < acc + tiles) {
      e = i;
      row0 = off[i] + (s - acc) * BM;
      rows = min(BM, off[i + 1] - row0);
      return true;
    }
    acc += tiles;
  }
  return false;
}

// One stage of the bf16 ring: this thread's two 16-byte chunks of the A
// tile (rows tid / 4 and tid / 4 + 32, chunk tid % 4; a row past the tile
// zero-filled) and of each B tile (32 rows of 8 chunks: rows tid / 8 and
// tid / 8 + 16, chunk tid % 8), depth k0.
template <int kMats>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* const* a_src,
    const bool* a_ok, const __nv_bfloat16* const* ws, int k0, int n_cols,
    int n0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    cp_async16(as + (tid / 4 + 32 * i) * APITCH + (tid % 4) * 8,
               a_src[i] + k0, a_ok[i]);
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tid / 8 + 16 * i, c = (tid % 8) * 8;
      cp_async16(bs + m * BK * BPITCH + r * BPITCH + c,
                 ws[m] + static_cast<size_t>(k0 + r) * n_cols + n0 + c,
                 true);
    }
}

// (a) with kGateUp: A = x (rows gathered by pair / k), K = d, W0 / W1 =
// w_gate / w_up, out = h (P, fe) in sorted order. (b) without: A = h (its
// sorted rows), K = fe, W0 = w_down, out = y (P, d) at the flat pair ids.
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads) moe_tc_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W0,
    const __nv_bfloat16* __restrict__ W1, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ pair, const uint8_t* __restrict__ valid,
    const int* __restrict__ offsets, int E, int K, int n_cols, int k,
    int act) {
  constexpr int kMats = kGateUp ? 2 : 1;
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ __align__(16) __nv_bfloat16 As[kStages][BM * APITCH];
  __shared__ __align__(16) __nv_bfloat16 Bs[kStages][kMats * BK * BPITCH];
  const int tid = threadIdx.x;
  for (int i = tid; i <= E; i += kThreads) s_off[i] = offsets[i];
  __syncthreads();
  int e, row0, rows;
  if (!find_tile(s_off, E, blockIdx.x, e, row0, rows)) return;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* a_src[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid / 4 + 32 * i;
    a_ok[i] = r < rows;
    const int j = row0 + (a_ok[i] ? r : 0);
    const long long src_row = kGateUp ? pair[j] / k : j;
    a_src[i] = A + src_row * K + (tid % 4) * 8;
  }
  const size_t w_off = static_cast<size_t>(e) * K * n_cols;
  const __nv_bfloat16* ws[2] = {W0 + w_off, kGateUp ? W1 + w_off : nullptr};
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  float acc[kMats][2][4][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][mi][nt][q] = 0.f;
  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT)
      load_stage<kMats>(As[s], Bs[s], a_src, a_ok, ws, s * BK, n_cols, n0,
                        tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT)
      load_stage<kMats>(As[next % kStages], Bs[next % kStages], a_src, a_ok,
                        ws, next * BK, n_cols, n0, tid);
    cp_async_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_a<APITCH>(a[mi], As[st], wm * 32 + mi * 16, ks * 16);
#pragma unroll
      for (int m = 0; m < kMats; ++m)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t b[4];
          ldsm_bt<BPITCH>(b, Bs[st] + m * BK * BPITCH, ks * 16,
                          wn * 32 + nj * 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816(acc[m][mi][2 * nj], a[mi], b[0], b[1]);
            mma16816(acc[m][mi][2 * nj + 1], a[mi], b[2], b[3]);
          }
        }
    }
  }
  cp_async_wait<0>();
  const int lane = tid % 32, g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + g + half * 8;
      if (r >= rows) continue;
      const int j = row0 + r, p = pair[j];
      const bool keep = valid[p] != 0;
      __nv_bfloat16* dst =
          out + static_cast<size_t>(kGateUp ? j : p) * n_cols;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float x0 = acc[0][mi][nt][half * 2 + q];
          v[q] = kGateUp ? round_bf16(activation(round_bf16(x0), act)) *
                               round_bf16(acc[kMats - 1][mi][nt][half * 2 + q])
                         : x0;
          if (!keep) v[q] = 0.f;
        }
        *reinterpret_cast<uint32_t*>(dst + n0 + wn * 32 + nt * 8 + c2) =
            pack_bf16(v[0], v[1]);
      }
    }
}

// The same two products in float32 on the CUDA cores (the parity runs'
// type): 64 x 64 tiles, 16 deep, each thread 4 x 4 outputs per product.
template <bool kGateUp>
__global__ void __launch_bounds__(kFThreads) moe_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ W0,
    const float* __restrict__ W1, float* __restrict__ out,
    const int* __restrict__ pair, const uint8_t* __restrict__ valid,
    const int* __restrict__ offsets, int E, int K, int n_cols, int k,
    int act) {
  constexpr int kMats = kGateUp ? 2 : 1;
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ float As[FBK][BM + 4];                 // depth-major
  __shared__ __align__(16) float Bs[kMats][FBK][BN];
  const int tid = threadIdx.x;
  for (int i = tid; i <= E; i += kFThreads) s_off[i] = offsets[i];
  __syncthreads();
  int e, row0, rows;
  if (!find_tile(s_off, E, blockIdx.x, e, row0, rows)) return;
  const int n0 = blockIdx.y * BN;
  const int ar = tid / 4, ac = (tid % 4) * 4;       // A: row, float4 column
  const bool a_ok = ar < rows;
  const int aj = row0 + (a_ok ? ar : 0);
  const float* a_src =
      A + static_cast<long long>(kGateUp ? pair[aj] / k : aj) * K + ac;
  const int br = tid / 16, bc = (tid % 16) * 4;     // B: row, float4 column
  const size_t w_off = static_cast<size_t>(e) * K * n_cols;
  const float* Ws[2] = {W0 + w_off, kGateUp ? W1 + w_off : nullptr};
  const int ty = tid / 16, tx = tid % 16;
  float acc[kMats][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    const float4 av = a_ok ? *reinterpret_cast<const float4*>(a_src + k0)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    As[ac + 0][ar] = av.x;
    As[ac + 1][ar] = av.y;
    As[ac + 2][ar] = av.z;
    As[ac + 3][ar] = av.w;
#pragma unroll
    for (int m = 0; m < kMats; ++m)
      *reinterpret_cast<float4*>(&Bs[m][br][bc]) =
          *reinterpret_cast<const float4*>(
              Ws[m] + static_cast<size_t>(k0 + br) * n_cols + n0 + bc);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[m][kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[m][i][0] = fmaf(a[i], b.x, acc[m][i][0]);
          acc[m][i][1] = fmaf(a[i], b.y, acc[m][i][1]);
          acc[m][i][2] = fmaf(a[i], b.z, acc[m][i][2]);
          acc[m][i][3] = fmaf(a[i], b.w, acc[m][i][3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const int j = row0 + r, p = pair[j];
    const bool keep = valid[p] != 0;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x0 = acc[0][i][q];
      v[q] = keep ? (kGateUp ? activation(x0, act) * acc[kMats - 1][i][q]
                             : x0)
                  : 0.f;
    }
    *reinterpret_cast<float4*>(
        out + static_cast<size_t>(kGateUp ? j : p) * n_cols + n0 + tx * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// (c): one block per token, out[t] = sum_r w[t, r] * y[t * k + r] in
// float32, r in order, rounded once
template <typename T>
__global__ void __launch_bounds__(kCombineThreads) moe_combine_kernel(
    const T* __restrict__ y, const T* __restrict__ w, T* __restrict__ out,
    int d, int k) {
  const int t = blockIdx.x;
  const T* yt = y + static_cast<size_t>(t) * k * d;
  for (int c = threadIdx.x; c < d; c += kCombineThreads) {
    float s = 0.f;
    for (int r = 0; r < k; ++r)
      s += to_float(w[t * k + r]) *
           to_float(yt[static_cast<size_t>(r) * d + c]);
    out[static_cast<size_t>(t) * d + c] = from_float<T>(s);
  }
}

template <typename T, typename Launch>
int launch_all(Launch gemm, const void* gate_w, void* y, void* out,
               int n_tokens, int d, int k, cudaStream_t s) {
  int err = gemm();
  if (err != 0) return err;
  moe_combine_kernel<T><<<n_tokens, kCombineThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(gate_w),
      static_cast<T*>(out), d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, d), w_gate / w_up (E, d, fe), w_down (E, fe, d), gate_w (N, k), all
// of one dtype (0 float32, 1 bf16); pair (P = N k,) int32 sorted; valid (P,)
// uint8 in flat order; offsets (E + 1,) int32; scratch h (P, fe) and y
// (P, d), out (N, d) in that dtype. act: 0 silu, 1 gelu (tanh), 2 relu.
// d and fe are multiples of 64, E <= 256. Returns the first launch's
// cudaError_t that is not 0, checked after each of the three launches.
extern "C" int moe_experts_launch(const void* x, const void* w_gate,
                                  const void* w_up, const void* w_down,
                                  const void* gate_w, const int* pair,
                                  const uint8_t* valid, const int* offsets,
                                  void* h, void* y, void* out, int n_tokens,
                                  int d, int fe, int E, int k, int act,
                                  int dtype, void* stream) {
  const int P = n_tokens * k;
  if (P == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = (P + BM - 1) / BM + (E < P ? E : P);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch_all<bf>([&]() {
      moe_tc_kernel<true><<<dim3(slots, fe / BN), kThreads, 0, s>>>(
          static_cast<const bf*>(x), static_cast<const bf*>(w_gate),
          static_cast<const bf*>(w_up), static_cast<bf*>(h), pair, valid,
          offsets, E, d, fe, k, act);
      int err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
      moe_tc_kernel<false><<<dim3(slots, d / BN), kThreads, 0, s>>>(
          static_cast<const bf*>(h), static_cast<const bf*>(w_down), nullptr,
          static_cast<bf*>(y), pair, valid, offsets, E, fe, d, k, act);
      return static_cast<int>(cudaGetLastError());
    }, gate_w, y, out, n_tokens, d, k, s);
  }
  return launch_all<float>([&]() {
    moe_f32_kernel<true><<<dim3(slots, fe / BN), kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_gate),
        static_cast<const float*>(w_up), static_cast<float*>(h), pair, valid,
        offsets, E, d, fe, k, act);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    moe_f32_kernel<false><<<dim3(slots, d / BN), kFThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w_down),
        nullptr, static_cast<float*>(y), pair, valid, offsets, E, fe, d, k,
        act);
    return static_cast<int>(cudaGetLastError());
  }, gate_w, y, out, n_tokens, d, k, s);
}
