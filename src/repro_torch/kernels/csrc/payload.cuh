// Element types of the KV pools and their conversions to and from float,
// shared by the attention and page_requant kernels.
//
// A pool holds float32 or bfloat16 (the query's type), or a quantized
// 1-byte payload: int8, float8 e4m3 or float8 e5m2, with one float32 scale
// per (page, kv head) beside it. The two float8 kinds share a storage type,
// so each gets a tag struct of one byte that the templates can tell apart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct fp8e4m3 { __nv_fp8_storage_t x; };
struct fp8e5m2 { __nv_fp8_storage_t x; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
// float8 -> half is exact, and so is half -> float
__device__ __forceinline__ float to_float(fp8e4m3 v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.x, __NV_E4M3)));
}
__device__ __forceinline__ float to_float(fp8e5m2 v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.x, __NV_E5M2)));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

// The quantized payloads: the reference's cast, clip to +-qmax first (a
// float8 cast of an out-of-range value is NaN there), rint for int8 (round
// half to even, as jnp.rint and torch.round), round to nearest even for
// float8 (as torch's and ml_dtypes' casts).
template <typename P>
__device__ __forceinline__ P quantize(float y, float qmax);
template <>
__device__ __forceinline__ int8_t quantize<int8_t>(float y, float qmax) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -qmax), qmax));
}
template <>
__device__ __forceinline__ fp8e4m3 quantize<fp8e4m3>(float y, float qmax) {
  return {__nv_cvt_float_to_fp8(fminf(fmaxf(y, -qmax), qmax), __NV_SATFINITE,
                                __NV_E4M3)};
}
template <>
__device__ __forceinline__ fp8e5m2 quantize<fp8e5m2>(float y, float qmax) {
  return {__nv_cvt_float_to_fp8(fminf(fmaxf(y, -qmax), qmax), __NV_SATFINITE,
                                __NV_E5M2)};
}

}  // namespace
