// In-place KV append for Hopper (sm_90a), the paged write path.
//
// Replaces: src/repro/kernels/kv_append.py, function kv_append (Pallas body
// _append_kernel). Row i's K and V, (Hkv, head_dim) each, go into pool slot
// (page_ids[i], offsets[i]) iff valid[i] != 0, in place. The two pools may
// differ in their rows' width: MLA appends its latent c (512 wide at
// deepseek-v3's widths) and its shared rope key kr (64) as the "K" and "V"
// of one call.
//
// Bound on the H100: bytes, and per launch latency: each valid row reads and
// writes 2 * Hkv * head_dim elements (2 KiB per row for llama3.2-1b in bf16),
// against the 3.35 TB/s of HBM. A 512-row call moves 2 MiB, 0.6 us at that
// rate, so what a call costs is its chain of dependent memory trips.
//
// Design: one warp per row, 8 rows per block of 256 threads. Each lane loads
// its row's valid flag, page id and offset, and all of its 16-byte K and V
// words (2 + 2 at llama3.2-1b's 1 KiB rows), before it tests the row or
// stores anything, so a row costs one trip to memory and back. The copy is
// dtype-agnostic bytes, in 16-byte words whenever the row size and the
// pointers allow it. Stores are ordinary: attention reads the new rows next,
// so they should stay in L2. An invalid row writes nothing. The TPU kernel
// instead copied the slot of a caller-chosen discard page back onto itself,
// because its grid is sequential; on a parallel grid several invalid rows
// aliasing one slot would race, so that write-back is dropped. A page id or
// offset out of range is dropped too, like the reference's drop-mode
// scatter.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kWords = 4;  // 16-byte words a lane loads per pool before storing

// A 16-byte load through the read-only path, kept as written so that every
// load of a batch is issued before the row is tested.
__device__ __forceinline__ uint4 load16(const uint4* p) {
  uint4 w;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
               : "l"(p));
  return w;
}

__global__ void __launch_bounds__(kThreads) kv_append_kernel(
    char* __restrict__ k_pool, char* __restrict__ v_pool,
    const char* __restrict__ k_new, const char* __restrict__ v_new,
    const int* __restrict__ page_ids, const int* __restrict__ offsets,
    const int* __restrict__ valid, int n_rows, int n_pages, int page,
    long long k_bytes, long long v_bytes, bool vec) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= n_rows) return;
  const int ok = valid[i], pid = page_ids[i], off = offsets[i];
  const long long slot = (long long)pid * page + off;
  const char* ks = k_new + i * k_bytes;
  const char* vs = v_new + i * v_bytes;
  char* kd = k_pool + slot * k_bytes;
  char* vd = v_pool + slot * v_bytes;
  if (vec) {
    const int nk = static_cast<int>(k_bytes / 16);
    const int nv = static_cast<int>(v_bytes / 16);
    for (int base = lane; base < max(nk, nv); base += 32 * kWords) {
      uint4 kw[kWords], vw[kWords];
#pragma unroll
      for (int b = 0; b < kWords; ++b) {
        const int w = base + 32 * b;
        if (w < nk) kw[b] = load16(reinterpret_cast<const uint4*>(ks) + w);
        if (w < nv) vw[b] = load16(reinterpret_cast<const uint4*>(vs) + w);
      }
      if (ok == 0 || pid < 0 || pid >= n_pages || off < 0 || off >= page)
        return;
#pragma unroll
      for (int b = 0; b < kWords; ++b) {
        const int w = base + 32 * b;
        if (w < nk) reinterpret_cast<uint4*>(kd)[w] = kw[b];
        if (w < nv) reinterpret_cast<uint4*>(vd)[w] = vw[b];
      }
    }
  } else {
    if (ok == 0 || pid < 0 || pid >= n_pages || off < 0 || off >= page)
      return;
    for (long long j = lane; j < max(k_bytes, v_bytes); j += 32) {
      if (j < k_bytes) kd[j] = ks[j];
      if (j < v_bytes) vd[j] = vs[j];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// k_bytes, v_bytes = a K and a V row's bytes (Hkv * head_dim * element
// size for GQA pools). Returns the launch's cudaError_t.
extern "C" int kv_append_launch(void* k_pool, void* v_pool, const void* k_new,
                                const void* v_new, const int* page_ids,
                                const int* offsets, const int* valid,
                                int n_rows, int n_pages, int page,
                                long long k_bytes, long long v_bytes,
                                void* stream) {
  if (n_rows == 0) return 0;
  const bool vec = k_bytes % 16 == 0 && v_bytes % 16 == 0 &&
                   aligned16(k_pool) && aligned16(v_pool) &&
                   aligned16(k_new) && aligned16(v_new);
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  kv_append_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      page_ids, offsets, valid, n_rows, n_pages, page, k_bytes, v_bytes,
      vec);
  return static_cast<int>(cudaGetLastError());
}
