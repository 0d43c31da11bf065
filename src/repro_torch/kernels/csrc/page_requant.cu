// Whole-page requant of quantized KV pools for Hopper (sm_90a), phase B of
// the quantized append.
//
// Replaces: src/repro/kernels/kv_quant.py, function page_requant (Pallas body
// _requant_kernel). Page pids[i] of both pools is rescaled by row i's
// per-head ratio old_scale / new_scale: every element becomes
// cast(clip(rint?(float(q) * ratio[head]), -qmax, qmax)), rint for int8 only,
// so a page never mixes two scales after its scale grew.
//
// Bound on the H100: bytes, and per launch mostly latency: each distinct
// touched page is read and written once in each pool, page * Hkv * head_dim
// bytes (8 KiB for llama3.2-1b with 16-slot pages), against the 3.35 TB/s of
// HBM; the arithmetic is one multiply, round and convert per byte.
//
// Design: one block per row, which rewrites its whole page. The TPU kernel
// sent rows that are not the first to name their page, and invalid rows, to
// a write-discard page, because its grid is sequential; on a parallel grid
// those writes would race, so such rows write nothing. Each block decides
// "first occurrence" itself: its threads scan the rows before it and
// __syncthreads_or folds the answer, so no N x N mask is built. A page id out
// of [0, n_pages) marks an invalid row. The page is streamed with 16-byte
// loads and stores (16 elements, all of one head when head_dim is a multiple
// of 16), else element by element, by requant.cuh's requant_runs, which the
// fused quantized append (kv_append_quant.cu) shares. The main path runs
// that fused kernel; this one is the reference's standalone phase-B op.
#include "requant.cuh"

namespace {

constexpr int kThreads = 128;

template <typename P>
__global__ void __launch_bounds__(kThreads) requant_kernel(
    P* __restrict__ k_pool, P* __restrict__ v_pool,  // (n_pages, page, Hkv, hd)
    const float* __restrict__ k_ratio,               // (N, Hkv)
    const float* __restrict__ v_ratio,               // (N, Hkv)
    const int* __restrict__ pids,                    // (N,)
    int n_pages, int page, int Hkv, int hd, float qmax, bool vec) {
  const int i = blockIdx.x;
  const int pid = pids[i];
  if (pid < 0 || pid >= n_pages) return;  // the same for the whole block
  int earlier = 0;
  for (int j = threadIdx.x; j < i; j += kThreads) earlier |= pids[j] == pid;
  if (__syncthreads_or(earlier)) return;
  const int elems = page * Hkv * hd;
  const long long at = (long long)pid * elems;
  requant_runs<P>(k_pool + at, v_pool + at,
                  HeadRatios{k_ratio + (long long)i * Hkv, hd, Hkv},
                  HeadRatios{v_ratio + (long long)i * Hkv, hd, Hkv}, 1, elems,
                  elems, qmax, vec, threadIdx.x, kThreads);
}

template <typename P>
int launch(void* k_pool, void* v_pool, const float* k_ratio,
           const float* v_ratio, const int* pids, int N, int n_pages, int page,
           int Hkv, int hd, float qmax, cudaStream_t stream) {
  const bool vec =
      hd % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(k_pool) |
        reinterpret_cast<uintptr_t>(v_pool)) & 15u) == 0;
  requant_kernel<P><<<N, kThreads, 0, stream>>>(
      static_cast<P*>(k_pool), static_cast<P*>(v_pool), k_ratio, v_ratio,
      pids, n_pages, page, Hkv, hd, qmax, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = int8 (qmax 127), 1 = float8 e4m3 (448), 2 = float8 e5m2
// (57344). Returns the launch's cudaError_t.
extern "C" int page_requant_launch(void* k_pool, void* v_pool,
                                   const float* k_ratio, const float* v_ratio,
                                   const int* pids, int N, int n_pages,
                                   int page, int Hkv, int hd, int dtype,
                                   void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<int8_t>(k_pool, v_pool, k_ratio, v_ratio, pids, N,
                            n_pages, page, Hkv, hd, 127.f, s);
    case 1:
      return launch<fp8e4m3>(k_pool, v_pool, k_ratio, v_ratio, pids, N,
                             n_pages, page, Hkv, hd, 448.f, s);
    case 2:
      return launch<fp8e5m2>(k_pool, v_pool, k_ratio, v_ratio, pids, N,
                             n_pages, page, Hkv, hd, 57344.f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
