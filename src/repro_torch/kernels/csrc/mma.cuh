// PTX wrappers for the tensor-core kernels (sm_80 and later): asynchronous
// global -> shared copies (cp.async), fragment loads from shared memory
// (ldmatrix), the bf16 m16n8k16 product with float32 accumulators
// (mma.sync) and the split of a float32 operand into bf16 terms.
//
// Fragments of m16n8k16, for lane l, g = l / 4, c = 2 (l % 4):
//  A (16 x 16, row-major), four bf16x2 registers: (g, c..c+1),
//    (g + 8, c..c+1), (g, c+8..c+9), (g + 8, c+8..c+9);
//  B (16 x 8, k x n), two registers: (k c..c+1, n g), (k c+8..c+9, n g);
//  C (16 x 8, float32), four values: (g, c), (g, c+1), (g + 8, c),
//    (g + 8, c+1).
// So two neighbouring C tiles of one row band, packed to bf16x2, are the
// A fragment of the next product over their 16 columns, in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, past L1; zeros when !valid (the
// source is then not read, but must still be an address inside the tensor)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (the .cg form takes 16-byte copies only), zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 b16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8; register m of lane l receives (row l / 4, columns 2 (l % 4), +1)
// of matrix m, or with .trans (rows 2 (l % 4), +1, column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x as NT bf16 values (as floats) that sum to it, largest first: hi =
// bf16(x), then bf16 of what is left, so a float32 operand reaches the
// bf16 products as NT terms (two: within 2^-16 of x; three: 2^-24)
template <int NT>
__device__ __forceinline__ void split(float x, float (&t)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    t[i] = __bfloat162float(__float2bfloat16_rn(x));
    x -= t[i];
  }
}

// the A fragment of 16 columns held as two C tiles of one row band
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Fragment loads from a row-major bf16 tile of PITCH elements a row:
//  ldsm_a: the A fragment of rows r0..r0+15, columns c0..c0+15;
//  ldsm_b: B fragments of a tile stored n x k (rows are n): columns
//    n0..n0+7 in r[0..1] and n0+8..n0+15 in r[2..3], depth k0..k0+15;
//  ldsm_bt: the same of a tile stored k x n (rows are k), by .trans.
// (ldsm_at, below, is ldsm_a of a tile stored k x m.)
template <int PITCH>
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4],
                                       const __nv_bfloat16* t, int r0,
                                       int c0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(r, t + (r0 + l % 8 + (l / 8 % 2) * 8) * PITCH + c0 + l / 16 * 8);
}

template <int PITCH>
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4],
                                       const __nv_bfloat16* t, int n0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(r, t + (n0 + l % 8 + l / 16 * 8) * PITCH + k0 + (l / 8 % 2) * 8);
}

template <int PITCH>
__device__ __forceinline__ void ldsm_bt(uint32_t (&r)[4],
                                        const __nv_bfloat16* t, int k0,
                                        int n0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(r, t + (k0 + l % 8 + (l / 8 % 2) * 8) * PITCH + n0 + l / 16 * 8);
}

// ldsm_at: the A fragment of rows m0..m0+15, depth k0..k0+15 of a tile
// stored k x m (rows are k), by .trans
template <int PITCH>
__device__ __forceinline__ void ldsm_at(uint32_t (&r)[4],
                                        const __nv_bfloat16* t, int k0,
                                        int m0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(r, t + (k0 + l % 8 + l / 16 * 8) * PITCH + m0 + (l / 8 % 2) * 8);
}

}  // namespace
