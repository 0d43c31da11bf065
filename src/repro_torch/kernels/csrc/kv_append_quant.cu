// The quantized KV append for Hopper (sm_90a): the scale update, the page
// requant and the quantized row write in one launch.
//
// Replaces: src/repro/kernels/kv_quant.py, function kv_append_quant, which
// runs phase A (the scale update) and phase C's quantize in XLA around two
// Pallas kernels, page_requant (_requant_kernel, phase B) and kv_append
// (phase C's write). It computes what the plain version kv_append_quant_ref
// (kernels/kv_quant.py) computes, bit for bit in the pools' bytes and the
// scales: for every page p named by a valid row,
//   new[p, h] = max(old[p, h], max |x| over those rows' head h / qmax);
//   page p's head-h payload *= old / new (0 when new is 0), re-rounded;
//   each such row's head h written to its slot as x / new (0 when new is 0),
//   rounded (rint for int8), clipped to +-qmax and cast.
//
// Bound on the H100: bytes, and per launch latency: each valid row's K and V
// read once and written once at one byte, each touched page's payload read
// and written once in both pools (8 KiB a pool for llama3.2-1b's 16-slot
// pages), the touched scales read and written once.
//
// Design: the grid is (rows, kv heads). Block (i, h) owns (page, head) when
// row i is valid, its page id lies in [0, n_pages), and no earlier valid row
// names the same page; every other block exits. The block finds that out
// itself: its threads scan the rows before i, newest first, and
// __syncthreads_or folds the answer, as page_requant.cu does. Exactly one
// block then writes each (page, head)'s payload and scale, so there are no
// atomics, no second launch, no host sync and no allocation, and any row
// order is right. An owner lists its member rows (the valid rows j >= i that
// name the page) with a block-wide prefix count, forms the head's K and V
// amax in float32, the new scales and the ratios, requantizes the head's
// strided slice of the page in both pools (requant.cuh, shared with
// page_requant.cu), and after a barrier writes its members' head slices.
// Rows are bf16 or float32; payload and rows move as 16-byte words when
// head_dim is a multiple of 16 and the pointers allow it. Divisions stay
// divisions and there are no fast-math flags, so every value equals the
// plain version's float32 arithmetic.
#include "requant.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                  // rows a thread scans a pass
constexpr int kScan = kThreads * kPerThread;   // rows a block scans a pass

// Lists the rows j in [lo, min(lo + kScan, N)) that are valid and name page
// pid in list[] (in no particular order) and returns how many. Every thread
// of the block calls it; it starts and ends with a barrier, so the caller
// may read list[] until its next call.
__device__ __forceinline__ int collect_members(
    const int* __restrict__ page_ids, const int* __restrict__ valid, int lo,
    int N, int pid, int* list, int* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool is[kPerThread];
  int mine = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = lo + r * kThreads + threadIdx.x;
    int ok = 0, p = -1;
    if (j < N) {
      ok = valid[j];
      p = page_ids[j];
    }
    is[r] = ok != 0 && p == pid;
    mine += is[r];
  }
  int incl = mine;  // inclusive prefix count over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int at = incl - mine, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_total[w];
    at += w < warp ? t : 0;
    total += t;
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (is[r]) list[at++] = lo + r * kThreads + threadIdx.x;
  __syncthreads();
  return total;
}

// 16 consecutive row values (a 16-byte aligned group) as float.
template <typename R>
__device__ __forceinline__ void load16(const R* __restrict__ src,
                                       float (&out)[16]) {
  constexpr int kWords = sizeof(R);  // 16 values of sizeof(R) bytes
  uint4 w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = reinterpret_cast<const uint4*>(src)[k];
  const R* e = reinterpret_cast<const R*>(w);
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j] = to_float(e[j]);
}

// Folds the listed rows' head slices into the running K and V amax. A unit
// is 16 values with `vec`, else one.
template <typename R>
__device__ __forceinline__ void fold_amax(const R* __restrict__ k_new,
                                          const R* __restrict__ v_new,
                                          const int* list, int count,
                                          int row_elems, int head_at, int hd,
                                          bool vec, float& k_amax,
                                          float& v_amax) {
  const int per_row = vec ? hd / 16 : hd;
  const int units = count * per_row;
  for (int u = threadIdx.x; u < 2 * units; u += kThreads) {
    const bool is_v = u >= units;
    const int c = is_v ? u - units : u;
    const int e = (c % per_row) * (vec ? 16 : 1);
    const R* src = (is_v ? v_new : k_new) +
                   (long long)list[c / per_row] * row_elems + head_at + e;
    float m = 0.f;
    if (vec) {
      float x[16];
      load16(src, x);
#pragma unroll
      for (int j = 0; j < 16; ++j) m = fmaxf(m, fabsf(x[j]));
    } else {
      m = fabsf(to_float(*src));
    }
    if (is_v) {
      v_amax = fmaxf(v_amax, m);
    } else {
      k_amax = fmaxf(k_amax, m);
    }
  }
}

// Writes the listed rows' head slices, quantized at the new scales, into
// their slots of page pid; a row whose offset lies outside the page writes
// nothing.
template <typename R, typename P>
__device__ __forceinline__ void write_rows(
    P* __restrict__ k_pool, P* __restrict__ v_pool,
    const R* __restrict__ k_new, const R* __restrict__ v_new,
    const int* __restrict__ offsets, const int* list, int count, int pid,
    int page, int row_elems, int head_at, int hd, float k_s, float v_s,
    float qmax, bool vec) {
  const int per_row = vec ? hd / 16 : hd;
  const int units = count * per_row;
  for (int u = threadIdx.x; u < 2 * units; u += kThreads) {
    const bool is_v = u >= units;
    const int c = is_v ? u - units : u;
    const int e = (c % per_row) * (vec ? 16 : 1);
    const int j = list[c / per_row];
    const int off = offsets[j];
    if (off < 0 || off >= page) continue;
    const float s = is_v ? v_s : k_s;
    const R* src =
        (is_v ? v_new : k_new) + (long long)j * row_elems + head_at + e;
    P* dst = (is_v ? v_pool : k_pool) +
             ((long long)pid * page + off) * row_elems + head_at + e;
    if (vec) {
      float x[16];
      load16(src, x);
      uint4 word;
      P* q = reinterpret_cast<P*>(&word);
#pragma unroll
      for (int t = 0; t < 16; ++t)
        q[t] = quantize<P>(s > 0.f ? x[t] / s : 0.f, qmax);
      *reinterpret_cast<uint4*>(dst) = word;
    } else {
      const float x = to_float(*src);
      *dst = quantize<P>(s > 0.f ? x / s : 0.f, qmax);
    }
  }
}

template <typename R, typename P>
__global__ void __launch_bounds__(kThreads) append_quant_kernel(
    P* __restrict__ k_pool, P* __restrict__ v_pool,  // (n_pages, page, Hkv, hd)
    float* __restrict__ k_scale, float* __restrict__ v_scale,  // (n_pages, Hkv)
    const R* __restrict__ k_new, const R* __restrict__ v_new,  // (N, Hkv, hd)
    const int* __restrict__ page_ids, const int* __restrict__ offsets,
    const int* __restrict__ valid,                             // (N,)
    int N, int n_pages, int page, int Hkv, int hd, float qmax, bool vec) {
  __shared__ int members[kScan];
  __shared__ int warp_total[kWarps];
  __shared__ float red[2][kWarps];
  const int i = blockIdx.x, h = blockIdx.y;
  const int pid = page_ids[i];
  if (valid[i] == 0 || pid < 0 || pid >= n_pages) return;  // whole block
  const long long sidx = (long long)pid * Hkv + h;
  const float k_old = k_scale[sidx], v_old = v_scale[sidx];

  // an owner only: no earlier valid row names the page. Newest first, so
  // the block of a page's later row usually stops after one pass
  for (int hi = i; hi > 0; hi -= kScan) {
    int found = 0;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int j = hi - 1 - (r * kThreads + (int)threadIdx.x);
      if (j >= 0) {
        const int ok = valid[j], p = page_ids[j];
        found |= ok != 0 && p == pid;
      }
    }
    if (__syncthreads_or(found)) return;
  }

  // the members' amax of head h, K and V apart
  const int row_elems = Hkv * hd, head_at = h * hd;
  const bool one_pass = N - i <= kScan;
  float k_amax = 0.f, v_amax = 0.f;
  int count = 0;
  for (int lo = i; lo < N; lo += kScan) {
    count = collect_members(page_ids, valid, lo, N, pid, members, warp_total);
    fold_amax(k_new, v_new, members, count, row_elems, head_at, hd, vec,
              k_amax, v_amax);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    k_amax = fmaxf(k_amax, __shfl_xor_sync(0xffffffffu, k_amax, d));
    v_amax = fmaxf(v_amax, __shfl_xor_sync(0xffffffffu, v_amax, d));
  }
  if (lane == 0) {
    red[0][warp] = k_amax;
    red[1][warp] = v_amax;
  }
  __syncthreads();
  k_amax = red[0][0];
  v_amax = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    k_amax = fmaxf(k_amax, red[0][w]);
    v_amax = fmaxf(v_amax, red[1][w]);
  }

  // new = max(old, amax / qmax); ratio = old / new, 0 for an empty page
  const float k_s = fmaxf(k_old, k_amax / qmax);
  const float v_s = fmaxf(v_old, v_amax / qmax);
  const float k_ratio = k_s > 0.f ? k_old / k_s : 0.f;
  const float v_ratio = v_s > 0.f ? v_old / v_s : 0.f;

  // the head's slice of the page in both pools: page runs of hd elements,
  // Hkv * hd apart
  const long long slice = (long long)pid * page * row_elems + head_at;
  requant_runs<P>(k_pool + slice, v_pool + slice, OneRatio{k_ratio},
                  OneRatio{v_ratio}, page, hd, row_elems, qmax, vec,
                  threadIdx.x, kThreads);
  __syncthreads();  // the slots' requant before the rows land on them

  if (one_pass) {
    write_rows(k_pool, v_pool, k_new, v_new, offsets, members, count, pid,
               page, row_elems, head_at, hd, k_s, v_s, qmax, vec);
  } else {
    for (int lo = i; lo < N; lo += kScan) {
      count =
          collect_members(page_ids, valid, lo, N, pid, members, warp_total);
      write_rows(k_pool, v_pool, k_new, v_new, offsets, members, count, pid,
                 page, row_elems, head_at, hd, k_s, v_s, qmax, vec);
    }
  }
  if (threadIdx.x == 0) {
    k_scale[sidx] = k_s;
    v_scale[sidx] = v_s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename R, typename P>
int launch(void* k_pool, void* v_pool, float* k_scale, float* v_scale,
           const void* k_new, const void* v_new, const int* page_ids,
           const int* offsets, const int* valid, int N, int n_pages, int page,
           int Hkv, int hd, float qmax, cudaStream_t stream) {
  const bool vec = hd % 16 == 0 && aligned16(k_pool) && aligned16(v_pool) &&
                   aligned16(k_new) && aligned16(v_new);
  append_quant_kernel<R, P><<<dim3(N, Hkv), kThreads, 0, stream>>>(
      static_cast<P*>(k_pool), static_cast<P*>(v_pool), k_scale, v_scale,
      static_cast<const R*>(k_new), static_cast<const R*>(v_new), page_ids,
      offsets, valid, N, n_pages, page, Hkv, hd, qmax, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_rows(int dtype, void* k_pool, void* v_pool, float* k_scale,
                float* v_scale, const void* k_new, const void* v_new,
                const int* page_ids, const int* offsets, const int* valid,
                int N, int n_pages, int page, int Hkv, int hd,
                cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch<R, int8_t>(k_pool, v_pool, k_scale, v_scale, k_new,
                               v_new, page_ids, offsets, valid, N, n_pages,
                               page, Hkv, hd, 127.f, s);
    case 1:
      return launch<R, fp8e4m3>(k_pool, v_pool, k_scale, v_scale, k_new,
                                v_new, page_ids, offsets, valid, N, n_pages,
                                page, Hkv, hd, 448.f, s);
    case 2:
      return launch<R, fp8e5m2>(k_pool, v_pool, k_scale, v_scale, k_new,
                                v_new, page_ids, offsets, valid, N, n_pages,
                                page, Hkv, hd, 57344.f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// rows: 0 = float32, 1 = bfloat16; dtype: 0 = int8 (qmax 127), 1 = float8
// e4m3 (448), 2 = float8 e5m2 (57344). Returns the launch's cudaError_t.
extern "C" int kv_append_quant_launch(void* k_pool, void* v_pool,
                                      float* k_scale, float* v_scale,
                                      const void* k_new, const void* v_new,
                                      const int* page_ids, const int* offsets,
                                      const int* valid, int N, int n_pages,
                                      int page, int Hkv, int hd, int rows,
                                      int dtype, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 0:
      return launch_rows<float>(dtype, k_pool, v_pool, k_scale, v_scale,
                                k_new, v_new, page_ids, offsets, valid, N,
                                n_pages, page, Hkv, hd, s);
    case 1:
      return launch_rows<__nv_bfloat16>(dtype, k_pool, v_pool, k_scale,
                                        v_scale, k_new, v_new, page_ids,
                                        offsets, valid, N, n_pages, page, Hkv,
                                        hd, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
