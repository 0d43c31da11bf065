// Dense GQA flash attention for Hopper (sm_90a): the forward of every
// attention layer of the full-sequence forward (training), and its gradient.
//
// Replaces: src/repro/kernels/flash_attention.py, function flash_attention
// (Pallas body _flash_kernel). q (B, Hkv, G, Tq, hd); k, v (B, Hkv, Tk, hd);
// out like q. Query row i sits at position i + Tk - Tq (right-aligned) and
// sees key j iff j <= its position (causal) and j > its position - window
// (window > 0); scores are dot * scale, then softcap * tanh(s / softcap)
// when softcap > 0; the softmax is online, in float32. The forward also
// writes lse = max + log(sum), float32 (B, Hkv, G, Tq), which the backward
// recomputes the probabilities from. The TPU kernel has no backward: the
// reference differentiates its XLA attention; the two backward kernels here
// are the counterpart of that autodiff (dS = P * (dP - delta), with
// delta = rowsum(dO * O), and the softcap chain rule
// dS *= 1 - (s_capped / softcap)^2).
//
// Bound on the H100: operations. A causal layer of the training shape
// (B 4, 32 query heads, T 2048, hd 64) does ~69 GFLOP forward and ~2.5x that
// backward, against ~0.1 GB of operands: far above the ~295 flop/byte ridge.
//
// Design, simple and right first. Every product runs on the float32 CUDA
// cores: no tensor cores, no TMA (later work). A row of q (or of k, in the
// dK/dV kernel) is owned by TPR = hd / 32 neighbouring threads, 32 of its
// dims each, held in registers as float4s interleaved across the TPR
// threads, so that the threads of a row read neighbouring 16-byte words of
// a shared-memory row (conflict-free) and a dot product is one shuffle
// reduction over the TPR threads.
//  * forward and dQ: one block of 128 threads per (b, kv head, q tile); the
//    tile holds the G query heads that share one K/V stream (the TPU
//    block's G * bq rows): R = 128 / TPR rows, R / G positions. K/V tiles
//    of 4096 / hd keys are staged in shared memory as float32 with
//    16-byte (float32) or 8-byte (bf16) loads, and only the tiles up to the
//    causal limit and from the window's start are visited (block skip).
//    Keys are scored 8 at a time; the forward rescales its accumulator once
//    per 8 keys. Any Tq and Tk: rows and keys past the ends are masked.
//    The dQ kernel first forms delta for its rows and writes it for the
//    dK/dV kernel, which runs after it on the same stream.
//  * dK/dV: one block per (b, kv head, k tile) of R keys, which loops over
//    the q positions that see its keys, all G heads, staged 4096 / hd rows
//    of q and dO at a time, recomputes P from lse and accumulates dK and dV
//    in float32 registers. No atomics: every output element has one owner.
#include "payload.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kDS = 32;       // dims of a row held by one thread
constexpr int kNM = kDS / 4;  // float4s of a row held by one thread
constexpr int kChunk = 8;     // keys scored together in forward and dQ
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;       // (B, Hkv, G, Tq, HD), T
  const void* k;       // (B, Hkv, Tk, HD), T
  const void* v;
  const void* o;       // forward output, backward only
  const void* dout;    // backward only
  void* out;           // forward: (B, Hkv, G, Tq, HD), T
  void* dq;            // backward outputs, T
  void* dk;
  void* dv;
  float* lse;          // (B, Hkv, G, Tq)
  float* delta;        // (B, Hkv, G, Tq), backward scratch
  int Hkv, G, Tq, Tk, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  // round to nearest even, as torch's cast
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned int*>(&a);
  w.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ void fma4(float4& a, float4 x, float4 y) {
  a.x = fmaf(x.x, y.x, a.x);
  a.y = fmaf(x.y, y.y, a.y);
  a.z = fmaf(x.z, y.z, a.z);
  a.w = fmaf(x.w, y.w, a.w);
}

__device__ __forceinline__ void axpy4(float4& a, float s, float4 y) {
  a.x = fmaf(s, y.x, a.x);
  a.y = fmaf(s, y.y, a.y);
  a.z = fmaf(s, y.z, a.z);
  a.w = fmaf(s, y.w, a.w);
}

__device__ __forceinline__ float sum4(float4 a) {
  return (a.x + a.y) + (a.z + a.w);
}

// the sum of x over the TPR neighbouring threads that own one row; every
// thread of the warp takes part, so callers keep their loops uniform
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the float4 of a row's shared-memory copy that thread `part` holds as its
// m-th (dims 4 * (part + TPR * m) ...)
template <int TPR>
__device__ __forceinline__ float4 slice4(const float* row, int part, int m) {
  return *reinterpret_cast<const float4*>(row + 4 * (part + TPR * m));
}

template <int TPR, typename T>
__device__ __forceinline__ const T* gslice(const T* row, int part, int m) {
  return row + 4 * (part + TPR * m);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, const Params& p) {
  return kpos < p.Tk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

__device__ __forceinline__ float capped(float dot, const Params& p) {
  const float s = dot * p.scale;
  return p.softcap > 0.f ? p.softcap * tanhf(s / p.softcap) : s;
}

// d(capped score) / d(dot)
__device__ __forceinline__ float capped_grad(float sc, const Params& p) {
  if (p.softcap <= 0.f) return p.scale;
  const float t = sc / p.softcap;
  return (1.f - t * t) * p.scale;
}

// rows [0, n_rows) of a (rows, HD) tile into float32 shared memory, zeros
// past the end of the tensor
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, int n_rows) {
  for (int i = threadIdx.x; i < ROWS * HD / 4; i += kThreads) {
    const int r = i / (HD / 4);
    reinterpret_cast<float4*>(dst)[i] =
        r < n_rows ? load4(src + 4LL * i) : zero4();
  }
}

// The q tile of a forward or dQ block and one thread's place in it.
template <int HD>
struct QTile {
  static constexpr int TPR = HD / kDS;
  static constexpr int R = kThreads / TPR;  // rows (heads x positions)
  static constexpr int BK = 4096 / HD;      // keys per staged K/V tile
  int BQ, part, g, i, qpos, k_lo, k_hi;
  bool active;
  long long bh, row;

  __device__ QTile(const Params& p) {
    BQ = R / p.G;
    // the tiles near the end of q see the most keys: start them first
    const int qt = gridDim.x - 1 - blockIdx.x;
    bh = (long long)blockIdx.z * p.Hkv + blockIdx.y;
    part = threadIdx.x % TPR;
    const int r = threadIdx.x / TPR;
    g = r / BQ;
    i = qt * BQ + (r - g * BQ);
    active = r < p.G * BQ && i < p.Tq;
    const int off = p.Tk - p.Tq;
    qpos = i + off;
    row = (bh * p.G + g) * p.Tq + i;
    const int q_first = qt * BQ + off;
    const int q_last = min(qt * BQ + BQ, p.Tq) - 1 + off;
    k_hi = p.causal ? min(p.Tk - 1, q_last) : p.Tk - 1;
    k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using Tile = QTile<HD>;
  constexpr int TPR = Tile::TPR, BK = Tile::BK;
  __shared__ __align__(16) float k_s[BK * HD];
  __shared__ __align__(16) float v_s[BK * HD];
  const Tile tl(p);
  const int part = tl.part;
  const T* qrow = static_cast<const T*>(p.q) + tl.row * HD;
  float4 q[kNM], acc[kNM];
#pragma unroll
  for (int m = 0; m < kNM; ++m) {
    q[m] = tl.active ? load4(gslice<TPR>(qrow, part, m)) : zero4();
    acc[m] = zero4();
  }
  float m_i = kNegInf, l_i = 0.f;
  const T* kb = static_cast<const T*>(p.k) + tl.bh * p.Tk * HD;
  const T* vb = static_cast<const T*>(p.v) + tl.bh * p.Tk * HD;
  for (int kt = tl.k_lo / BK; kt <= tl.k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    stage<T, HD, BK>(k_s, kb + (long long)k0 * HD, p.Tk - k0);
    stage<T, HD, BK>(v_s, vb + (long long)k0 * HD, p.Tk - k0);
    __syncthreads();
    const int jb = max(0, tl.k_lo - k0) & ~(kChunk - 1);
    const int je = min(BK, tl.k_hi - k0 + 1);
    for (int j0 = jb; j0 < je; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float* kr = k_s + (j0 + u) * HD;
        float4 a = zero4();
#pragma unroll
        for (int m = 0; m < kNM; ++m) fma4(a, q[m], slice4<TPR>(kr, part, m));
        s[u] = row_sum<TPR>(sum4(a));
      }
      unsigned vis = 0;
      float cmax = kNegInf;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (visible(k0 + j0 + u, tl.qpos, p)) {
          vis |= 1u << u;
          s[u] = capped(s[u], p);
          cmax = fmaxf(cmax, s[u]);
        }
      }
      const float m_new = fmaxf(m_i, cmax);
      const float corr = expf(m_i - m_new);
      l_i *= corr;
#pragma unroll
      for (int m = 0; m < kNM; ++m) {
        acc[m].x *= corr;
        acc[m].y *= corr;
        acc[m].z *= corr;
        acc[m].w *= corr;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        s[u] = (vis >> u) & 1u ? expf(s[u] - m_new) : 0.f;
        l_i += s[u];
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float* vr = v_s + (j0 + u) * HD;
#pragma unroll
        for (int m = 0; m < kNM; ++m) axpy4(acc[m], s[u], slice4<TPR>(vr, part, m));
      }
      m_i = m_new;
    }
  }
  if (!tl.active) return;
  const float l = fmaxf(l_i, 1e-37f);
  T* orow = static_cast<T*>(p.out) + tl.row * HD;
#pragma unroll
  for (int m = 0; m < kNM; ++m) {
    const float4 a = acc[m];
    store4(orow + 4 * (part + TPR * m),
           make_float4(a.x / l, a.y / l, a.z / l, a.w / l));
  }
  if (part == 0) p.lse[tl.row] = m_i + logf(l);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const Params p) {
  using Tile = QTile<HD>;
  constexpr int TPR = Tile::TPR, BK = Tile::BK;
  __shared__ __align__(16) float k_s[BK * HD];
  __shared__ __align__(16) float v_s[BK * HD];
  const Tile tl(p);
  const int part = tl.part;
  const long long ro = tl.row * HD;
  float4 q[kNM], d_o[kNM], dq[kNM];
  float dl = 0.f;
#pragma unroll
  for (int m = 0; m < kNM; ++m) {
    float4 o4 = zero4();
    q[m] = d_o[m] = zero4();
    if (tl.active) {
      q[m] = load4(gslice<TPR>(static_cast<const T*>(p.q) + ro, part, m));
      d_o[m] = load4(gslice<TPR>(static_cast<const T*>(p.dout) + ro, part,
                                 m));
      o4 = load4(gslice<TPR>(static_cast<const T*>(p.o) + ro, part, m));
    }
    dl += sum4(make_float4(d_o[m].x * o4.x, d_o[m].y * o4.y,
                           d_o[m].z * o4.z, d_o[m].w * o4.w));
    dq[m] = zero4();
  }
  dl = row_sum<TPR>(dl);  // delta = rowsum(dO * O)
  const float lse = tl.active ? p.lse[tl.row] : 0.f;
  if (tl.active && part == 0) p.delta[tl.row] = dl;
  const T* kb = static_cast<const T*>(p.k) + tl.bh * p.Tk * HD;
  const T* vb = static_cast<const T*>(p.v) + tl.bh * p.Tk * HD;
  for (int kt = tl.k_lo / BK; kt <= tl.k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<T, HD, BK>(k_s, kb + (long long)k0 * HD, p.Tk - k0);
    stage<T, HD, BK>(v_s, vb + (long long)k0 * HD, p.Tk - k0);
    __syncthreads();
    const int jb = max(0, tl.k_lo - k0) & ~(kChunk - 1);
    const int je = min(BK, tl.k_hi - k0 + 1);
    for (int j0 = jb; j0 < je; j0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float* kr = k_s + (j0 + u) * HD;
        const float* vr = v_s + (j0 + u) * HD;
        float4 a = zero4(), c = zero4();
#pragma unroll
        for (int m = 0; m < kNM; ++m) {
          fma4(a, q[m], slice4<TPR>(kr, part, m));
          fma4(c, d_o[m], slice4<TPR>(vr, part, m));
        }
        s[u] = row_sum<TPR>(sum4(a));
        dp[u] = row_sum<TPR>(sum4(c));
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        float ds = 0.f;
        if (visible(k0 + j0 + u, tl.qpos, p)) {
          const float sc = capped(s[u], p);
          ds = expf(sc - lse) * (dp[u] - dl) * capped_grad(sc, p);
        }
        s[u] = ds;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float* kr = k_s + (j0 + u) * HD;
#pragma unroll
        for (int m = 0; m < kNM; ++m) axpy4(dq[m], s[u], slice4<TPR>(kr, part, m));
      }
    }
  }
  if (!tl.active) return;
  T* dqrow = static_cast<T*>(p.dq) + ro;
#pragma unroll
  for (int m = 0; m < kNM; ++m) store4(dqrow + 4 * (part + TPR * m), dq[m]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const Params p) {
  constexpr int TPR = HD / kDS;
  constexpr int R = kThreads / TPR;  // keys per block
  constexpr int RS = 4096 / HD;      // q rows (heads x positions) per stage
  __shared__ __align__(16) float q_s[RS * HD];
  __shared__ __align__(16) float do_s[RS * HD];
  __shared__ float lse_s[RS];
  __shared__ float dl_s[RS];
  const int G = p.G, Tq = p.Tq, Tk = p.Tk;
  const int BQS = RS / G;     // positions per stage
  const int NR = G * BQS;     // staged rows
  const int off = Tk - Tq;
  const long long bh = (long long)blockIdx.z * p.Hkv + blockIdx.y;
  const int part = threadIdx.x % TPR;
  const int j0 = blockIdx.x * R;
  const int kpos = j0 + threadIdx.x / TPR;
  const bool active = kpos < Tk;
  const long long ko = (bh * Tk + kpos) * HD;
  float4 k[kNM], v[kNM], dk[kNM], dv[kNM];
#pragma unroll
  for (int m = 0; m < kNM; ++m) {
    k[m] = active ? load4(gslice<TPR>(static_cast<const T*>(p.k) + ko, part,
                                      m)) : zero4();
    v[m] = active ? load4(gslice<TPR>(static_cast<const T*>(p.v) + ko, part,
                                      m)) : zero4();
    dk[m] = dv[m] = zero4();
  }
  // the q positions that see a key of this tile
  const int j1 = min(j0 + R, Tk);
  const int i_lo = p.causal ? max(0, j0 - off) : 0;
  const int i_hi = p.window > 0 ? min(Tq - 1, j1 - 2 + p.window - off)
                                : Tq - 1;
  const T* qb = static_cast<const T*>(p.q) + bh * G * Tq * HD;
  const T* dob = static_cast<const T*>(p.dout) + bh * G * Tq * HD;
  for (int i0 = i_lo; i0 <= i_hi; i0 += BQS) {
    __syncthreads();  // the previous stage is consumed
    for (int e = threadIdx.x; e < NR * HD / 4; e += kThreads) {
      const int rr = e / (HD / 4);
      const int c = e - rr * (HD / 4);
      const int g = rr / BQS;
      const int i = i0 + rr - g * BQS;
      float4 a = zero4(), b = zero4();
      if (i < Tq) {
        const long long src = ((long long)g * Tq + i) * HD + 4 * c;
        a = load4(qb + src);
        b = load4(dob + src);
      }
      reinterpret_cast<float4*>(q_s)[e] = a;
      reinterpret_cast<float4*>(do_s)[e] = b;
    }
    for (int rr = threadIdx.x; rr < NR; rr += kThreads) {
      const int g = rr / BQS;
      const int i = i0 + rr - g * BQS;
      const long long row = (bh * G + g) * Tq + i;
      lse_s[rr] = i < Tq ? p.lse[row] : 0.f;
      dl_s[rr] = i < Tq ? p.delta[row] : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < NR; rr += 2) {
      // two rows at a time, for independent work between the shuffles
      float s[2], dp[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r2 = min(rr + u, NR - 1);
        float4 a = zero4(), c = zero4();
#pragma unroll
        for (int m = 0; m < kNM; ++m) {
          fma4(a, k[m], slice4<TPR>(q_s + r2 * HD, part, m));
          fma4(c, v[m], slice4<TPR>(do_s + r2 * HD, part, m));
        }
        s[u] = row_sum<TPR>(sum4(a));
        dp[u] = row_sum<TPR>(sum4(c));
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r2 = rr + u;
        if (r2 >= NR) break;
        const int i = i0 + r2 - (r2 / BQS) * BQS;
        float pr = 0.f, ds = 0.f;
        if (active && i < Tq && visible(kpos, i + off, p)) {
          const float sc = capped(s[u], p);
          pr = expf(sc - lse_s[r2]);
          ds = pr * (dp[u] - dl_s[r2]) * capped_grad(sc, p);
        }
#pragma unroll
        for (int m = 0; m < kNM; ++m) {
          axpy4(dv[m], pr, slice4<TPR>(do_s + r2 * HD, part, m));
          axpy4(dk[m], ds, slice4<TPR>(q_s + r2 * HD, part, m));
        }
      }
    }
  }
  if (!active) return;
  T* dkrow = static_cast<T*>(p.dk) + ko;
  T* dvrow = static_cast<T*>(p.dv) + ko;
#pragma unroll
  for (int m = 0; m < kNM; ++m) {
    store4(dkrow + 4 * (part + TPR * m), dk[m]);
    store4(dvrow + 4 * (part + TPR * m), dv[m]);
  }
}

template <int HD>
constexpr int q_rows() { return kThreads / (HD / kDS); }

template <typename T, int HD>
int launch_fwd(const Params& p, int B, cudaStream_t s) {
  const int bq = q_rows<HD>() / p.G;
  const dim3 grid((p.Tq + bq - 1) / bq, p.Hkv, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bwd(const Params& p, int B, cudaStream_t s) {
  const int bq = q_rows<HD>() / p.G;
  const dim3 qgrid((p.Tq + bq - 1) / bq, p.Hkv, B);
  flash_bwd_dq_kernel<T, HD><<<qgrid, kThreads, 0, s>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // after the dQ kernel on the same stream: delta is written
  const int bk = q_rows<HD>();
  const dim3 kgrid((p.Tk + bk - 1) / bk, p.Hkv, B);
  flash_bwd_dkv_kernel<T, HD><<<kgrid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool bwd, int hd, const Params& p, int B, cudaStream_t s) {
  switch (hd) {
    case 32: return bwd ? launch_bwd<T, 32>(p, B, s) : launch_fwd<T, 32>(p, B, s);
    case 64: return bwd ? launch_bwd<T, 64>(p, B, s) : launch_fwd<T, 64>(p, B, s);
    case 128: return bwd ? launch_bwd<T, 128>(p, B, s) : launch_fwd<T, 128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(bool bwd, const Params& p, int B, int hd, int dtype, void* stream) {
  if (B == 0 || p.Hkv == 0 || p.G == 0 || p.Tq == 0) return 0;
  // every row must see a key; a tile must hold all G heads of a position
  if (p.Tq > p.Tk || hd < kDS || p.G > kThreads / (hd / kDS))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(bwd, hd, p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bwd, hd, p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype (q, k, v, out): 0 = float32, 1 = bfloat16; hd in {32, 64, 128};
// G at most 128 / (hd / 32); Tq <= Tk. causal 0 or 1; window <= 0 and
// softcap <= 0 mean none. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int Hkv, int G, int Tq, int Tk, int hd, int causal, int window,
    float softcap, float scale, int dtype, void* stream) {
  const Params p{q, k, v, nullptr, nullptr, out, nullptr, nullptr, nullptr,
                 lse, nullptr, Hkv, G, Tq, Tk, causal, window, softcap,
                 scale};
  return run(false, p, B, hd, dtype, stream);
}

// The gradient: dq like q, dk and dv like k, all in dtype; delta is float32
// (B, Hkv, G, Tq) scratch. Two kernels on the stream, dQ (which writes
// delta) then dK/dV.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int Hkv, int G, int Tq, int Tk, int hd, int causal,
    int window, float softcap, float scale, int dtype, void* stream) {
  const Params p{q, k, v, o, dout, nullptr, dq, dk, dv,
                 const_cast<float*>(lse), delta, Hkv, G, Tq, Tk, causal,
                 window, softcap, scale};
  return run(true, p, B, hd, dtype, stream);
}
