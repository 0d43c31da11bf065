// Swap pack / unpack for Hopper (sm_90a): the coalescing gather and scatter
// of InferCept's swap path.
//
// Replaces: src/repro/kernels/swap_pack.py, functions swap_pack (Pallas body
// _pack_kernel) and swap_unpack (_unpack_kernel). Pack gathers pool pages
// into one contiguous slab, so the device-to-host transfer moves one block;
// unpack scatters a slab back into pool pages in place.
//
// Bound on the H100: bytes. Each moved page is read once and written once
// (2 * row_bytes per (period, page)), against the 3.35 TB/s of HBM.
//
// Design: both work on a (P, n_pages, R) byte view of a pool stacked over P
// layer periods, R the page's flattened trailing size in bytes, so one
// launch covers every layer of the stacked pool instead of one launch per
// layer. One block copies one (period, page) row with 16-byte vector loads
// and stores when the row size and the pointers allow it. A page id out of
// range is skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         long long bytes, bool vec) {
  if (vec) {
    const long long n16 = bytes / 16;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (long long j = threadIdx.x; j < n16; j += kThreads) d[j] = s[j];
  } else {
    for (long long j = threadIdx.x; j < bytes; j += kThreads) dst[j] = src[j];
  }
}

// grid (n, P): block (i, p) moves page ids[i] of period p
__global__ void __launch_bounds__(kThreads) pack_kernel(
    const char* __restrict__ pool, char* __restrict__ slab,
    const int* __restrict__ ids, int n, int n_pages, long long row_bytes,
    bool vec) {
  const int i = blockIdx.x;
  const int p = blockIdx.y;
  const int pid = ids[i];
  if (pid < 0 || pid >= n_pages) return;
  copy_row(slab + ((long long)p * n + i) * row_bytes,
           pool + ((long long)p * n_pages + pid) * row_bytes, row_bytes, vec);
}

__global__ void __launch_bounds__(kThreads) unpack_kernel(
    char* __restrict__ pool, const char* __restrict__ slab,
    const int* __restrict__ ids, int n, int n_pages, long long row_bytes,
    bool vec) {
  const int i = blockIdx.x;
  const int p = blockIdx.y;
  const int pid = ids[i];
  if (pid < 0 || pid >= n_pages) return;
  copy_row(pool + ((long long)p * n_pages + pid) * row_bytes,
           slab + ((long long)p * n + i) * row_bytes, row_bytes, vec);
}

bool vectorizable(const void* a, const void* b, long long row_bytes) {
  return row_bytes % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

}  // namespace

// pool: (P, n_pages, row_bytes) bytes; slab: (P, n, row_bytes) bytes.
// Both return the launch's cudaError_t.
extern "C" int swap_pack_launch(const void* pool, void* slab, const int* ids,
                                int n, int P, int n_pages, long long row_bytes,
                                void* stream) {
  if (n == 0 || P == 0) return 0;
  dim3 grid(n, P);
  pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(pool), static_cast<char*>(slab), ids, n,
      n_pages, row_bytes, vectorizable(pool, slab, row_bytes));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int swap_unpack_launch(void* pool, const void* slab, const int* ids,
                                  int n, int P, int n_pages,
                                  long long row_bytes, void* stream) {
  if (n == 0 || P == 0) return 0;
  dim3 grid(n, P);
  unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), static_cast<const char*>(slab), ids, n,
      n_pages, row_bytes, vectorizable(pool, slab, row_bytes));
  return static_cast<int>(cudaGetLastError());
}
