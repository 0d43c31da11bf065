// Requantization of a quantized KV payload in place, shared by the
// page_requant kernel (whole pages, one ratio per kv head) and the fused
// quantized append (one kv head's strided slice of a page, one ratio).
//
// Every element becomes cast(clip(rint?(float(q) * ratio), -qmax, qmax)),
// rint for int8 only: the plain versions' float32 multiply, with no
// fast-math flags, so the result equals them bit for bit.
#pragma once

#include "payload.cuh"

namespace {

// The ratio of element e of a whole-page run: one ratio per kv head.
struct HeadRatios {
  const float* ratio;  // (Hkv,)
  int hd, Hkv;
  __device__ __forceinline__ float operator()(int e) const {
    return ratio[(e / hd) % Hkv];
  }
};

// One ratio for every element of a run: one kv head's slice.
struct OneRatio {
  float ratio;
  __device__ __forceinline__ float operator()(int) const { return ratio; }
};

// Rescales the K and V payloads in place over one geometry: `runs` runs of
// `run` elements each, run r starting r * `stride` elements after `k` (and
// `v`). Element e of a run (0 <= e < run) is scaled by k_ratio(e) in K and
// v_ratio(e) in V. Threads tid, tid + nthreads, ... of the block share the
// units of both pools. With `vec` (run and stride multiples of 16, both
// pools 16-byte aligned, a ratio constant over each aligned group of 16
// elements of a run) a unit is 16 elements moved as one 16-byte word; else
// it is one element.
template <typename P, typename KRatio, typename VRatio>
__device__ __forceinline__ void requant_runs(P* __restrict__ k,
                                             P* __restrict__ v,
                                             KRatio k_ratio, VRatio v_ratio,
                                             int runs, int run, int stride,
                                             float qmax, bool vec, int tid,
                                             int nthreads) {
  const int per_run = vec ? run / 16 : run;
  const int units = runs * per_run;
  for (int u = tid; u < 2 * units; u += nthreads) {
    const bool is_v = u >= units;
    const int c = is_v ? u - units : u;
    const int e = (c % per_run) * (vec ? 16 : 1);
    P* at = (is_v ? v : k) + (long long)(c / per_run) * stride + e;
    const float r = is_v ? v_ratio(e) : k_ratio(e);
    if (vec) {
      uint4 word = *reinterpret_cast<const uint4*>(at);
      P* q = reinterpret_cast<P*>(&word);
#pragma unroll
      for (int j = 0; j < 16; ++j) q[j] = quantize<P>(to_float(q[j]) * r, qmax);
      *reinterpret_cast<uint4*>(at) = word;
    } else {
      *at = quantize<P>(to_float(*at) * r, qmax);
    }
  }
}

}  // namespace
