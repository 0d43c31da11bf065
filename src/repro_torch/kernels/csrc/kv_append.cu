// In-place KV append for Hopper (sm_90a), the paged write path.
//
// Replaces: src/repro/kernels/kv_append.py, function kv_append (Pallas body
// _append_kernel). Row i's K and V, (Hkv, head_dim) each, go into pool slot
// (page_ids[i], offsets[i]) iff valid[i] != 0, in place.
//
// Bound on the H100: bytes, and per launch mostly latency: each valid row
// reads and writes 2 * Hkv * head_dim elements (2 KiB per row for
// llama3.2-1b in bf16), against the 3.35 TB/s of HBM.
//
// Design: one block per row; the copy is dtype-agnostic bytes, with 16-byte
// vector loads and stores whenever the row size and the pointers allow it.
// An invalid row writes nothing. The TPU kernel instead copied the slot of a
// caller-chosen discard page back onto itself, because its grid is
// sequential; on a parallel grid several invalid rows aliasing one slot
// would race, so that write-back is dropped. A page id or offset out of
// range is dropped too, like the reference's drop-mode scatter.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads) kv_append_kernel(
    char* __restrict__ k_pool, char* __restrict__ v_pool,
    const char* __restrict__ k_new, const char* __restrict__ v_new,
    const int* __restrict__ page_ids, const int* __restrict__ offsets,
    const int* __restrict__ valid, int n_pages, int page, long long row_bytes,
    bool vec) {
  const int i = blockIdx.x;
  if (valid[i] == 0) return;
  const int pid = page_ids[i];
  const int off = offsets[i];
  if (pid < 0 || pid >= n_pages || off < 0 || off >= page) return;
  const long long slot = ((long long)pid * page + off) * row_bytes;
  const long long row = (long long)i * row_bytes;
  copy_row(k_pool + slot, k_new + row, row_bytes, vec);
  copy_row(v_pool + slot, v_new + row, row_bytes, vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// row_bytes = Hkv * head_dim * element size. Returns the launch's
// cudaError_t.
extern "C" int kv_append_launch(void* k_pool, void* v_pool, const void* k_new,
                                const void* v_new, const int* page_ids,
                                const int* offsets, const int* valid,
                                int n_rows, int n_pages, int page,
                                long long row_bytes, void* stream) {
  if (n_rows == 0) return 0;
  const bool vec = row_bytes % 16 == 0 && aligned16(k_pool) &&
                   aligned16(v_pool) && aligned16(k_new) && aligned16(v_new);
  kv_append_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      page_ids, offsets, valid, n_pages, page, row_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}
