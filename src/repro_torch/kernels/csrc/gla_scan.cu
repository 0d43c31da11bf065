// Chunked gated linear attention for Hopper (sm_90a): the core of every
// mLSTM layer (and of Mamba2's SSD) in the full-sequence forward, which is
// the prefill of an SSM model.
//
// Replaces: src/repro/kernels/gla_scan.py, function gla_scan (Pallas body
// _gla_kernel). Its oracle, and the function the reference model calls, is
// src/repro/models/ssm.py chunked_gla. For each row r of B * H:
//   S_t = exp(la_t) S_{t-1} + k_t v_t^T,   y_t = q_t S_t,
// taken in chunks of c steps. Within a chunk, with lb the inclusive cumsum
// of la over the chunk (float32, left to right, as jnp.cumsum):
//   y_i = sum_{j<=i} (q_i . k_j) exp(lb_i - lb_j) v_j + exp(lb_i) q_i S
//   S  <- exp(lb_last) S + sum_j (k_j exp(lb_last - lb_j)) v_j^T
// Any T: steps past T are no-ops (la = 0, k = v = 0) and their rows of y are
// not written. The state starts from the given float32 state or from zero.
// q, k and v are each float32 or bfloat16 and are read in place, through
// their (B, H, T) strides (unit stride along the last dimension, every row
// 16-byte aligned); y is written in v's type through a row pitch that is a
// multiple of 8, the final state in float32.
//
// Exponents: la <= 0, so exp(lb_i - lb_j) is formed only for j <= i, after
// the product, where it is at most 1; exp(lb_i) and exp(lb_last - lb_j) may
// underflow to 0, harmlessly. Nothing is factored as exp(lb_i) * exp(-lb_j),
// which would overflow: mLSTM clamps la at -30, so lb reaches ~ -7680 over
// 256 steps.
//
// Bound on the H100: operations. One mLSTM layer of xlstm-350m's prefill
// (B 8, H 4, T 2000, dk 512, dv 513, c 256) does ~79.5 GFLOP of float32 work
// against ~0.36 GB of operands, far above the ridge, so every product runs
// on the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulators).
//
// Float32 accuracy from bf16 products: a float32 operand (k at the mLSTM
// call, the scores P, the state S, a float32 q or v) is split into NT bf16
// terms, hi = bf16(x), mid = bf16(x - hi), ..., and a product takes every
// pair of terms whose indexes sum below NT; a bf16 operand is exact in one
// term and is staged as it is. NT follows y's type (kTermsOf): 2 for a
// bf16 y (hi*hi + hi*mid + mid*hi of two float32 operands, hi*b + mid*b
// beside a bf16 one: ~1e-5 of the float32 result, far below y's rounding),
// 3 for a float32 y (~2e-7, as float32 sums; with 2, the float32
// xlstm-350m drifts past 1e-3 over its 24 layers). One term is ~3e-3 off
// (the CPU emulation in tests/test_torch_gla_scan.py).
//
// Design, the chunk-parallel form (flash-linear-attention's chunk_gla): only
// the small state recurrence is sequential. Four kernels on the stream, each
// block four warps over a 64 x 64 tile (16 rows a warp), its operands staged
// by 32 along the reduced dimension into two shared-memory stages (the next
// one loads while the current one is multiplied): bf16 through cp.async as
// it is, float32 through registers, split into its bf16 terms on the way in.
//  1. gla_lb_kernel: lb of every (row, chunk), left to right in float32,
//     once, into scratch.
//  2. gla_scores_kernel: a block per (64 x 64 tile on or below the
//     diagonal, chunk, row) forms Q K^T over dk, then the decay and the
//     causal mask on the float32 accumulators, and writes P as its bf16
//     terms (row-major, as the output kernel's A operand) to scratch.
//  3. gla_states_kernel: a block per (dv tile, dk tile, row) sweeps the
//     chunks in order with its 64 x 64 slice of S in registers (the
//     accumulator fragments): it writes the state entering each chunk as
//     its bf16 terms to scratch, then S = exp(lb_last) S +
//     (K * exp(lb_last - lb))^T V, the decayed K split as it is staged.
//  4. gla_outputs_kernel: a block per (64-row tile of the chunk, dv tile,
//     chunk, row) forms Q S_n over dk (skipped while the state is the zero
//     state), scales its rows by exp(lb_i), adds P V over the j <= i tiles
//     (a warp stops at its last row) and writes y. The i tiles of one dv
//     tile are neighbouring blocks, so S_n, V and P are read from L2.
#include <type_traits>

#include "mma.cuh"
#include "payload.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;            // four warps, 16 rows each
constexpr int kTile = 64;                // rows and columns of a block tile
constexpr int kDepth = 32;               // reduced dimension of one stage
constexpr int kMaxChunk = 256;
constexpr int kPM = kDepth + 8;          // pitch of a 64 x 32 stage
constexpr int kPN = kTile + 8;           // pitch of a 32 x 64 stage
constexpr int kWide = kTile * kPM;       // elements of a 64 x 32 plane
constexpr int kDeep = kDepth * kPN;      // elements of a 32 x 64 plane
static_assert(kWide % 8 == 0 && kDeep % 8 == 0, "16-byte planes");

// bf16 terms of a float32 operand, by the type of y: two for a bf16 y
// (~1e-5, far below its rounding), three for a float32 one (~2e-7, as
// float32 sums: a float32 model compounds it over its layers)
template <typename TY>
constexpr int kTermsOf = std::is_same<TY, bf16>::value ? 2 : 3;

extern __shared__ __align__(16) unsigned char gla_smem[];

struct Params {
  const void* q;     // (B, H, T, dk), strides qs
  const void* k;     // (B, H, T, dk), strides ks
  const void* v;     // (B, H, T, dv), strides vs
  const float* la;   // (R, T)
  const float* s0;   // (R, dk, dv), or null for a zero state
  void* y;           // (R, T, dvp) in v's type, the first dv columns
  float* s;          // (R, dk, dv)
  float* lb;         // (R, n, cpad) scratch
  bf16* p;           // (NT, R, n, cpad, cpad) scratch: P's terms
  bf16* st;          // (NT, R, n, dk, dvp) scratch: chunk-entry states
  long long qs[3], ks[3], vs[3];   // (B, H, T) strides, in elements
  int R, H, T, dk, dv, c, n, cpad, dvp;
};

template <typename T>
__device__ __forceinline__ const T* row_base(const void* base,
                                             const long long (&s)[3], int r,
                                             int H) {
  return static_cast<const T*>(base) + (r / H) * s[0] + (r % H) * s[1];
}

template <typename T>
__device__ __forceinline__ T zero() { return T(0.f); }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// ---------------------------------------------------------------------------
// Stage loaders. A stage is R x C elements (C a multiple of 8) of a
// row-major source from its origin, rows past `rows` and columns past
// `cols` zero; it lands in shared memory as bf16 planes of pitch P, one per
// term. issue() starts the loads, commit() finishes them (the caller then
// waits for cp.async and synchronizes).
// ---------------------------------------------------------------------------

// bf16 planes copied as they are: a bf16 operand (one plane) or a scratch
// already split (NT planes, `plane` elements apart in the source).
// 16-byte cp.async where a group of 8 columns is whole; a group cut by
// `cols` is read element by element (only where a width is not a multiple
// of 8).
template <int NP, int R, int C, int P>
struct Copy {
  static constexpr int kPlanes = NP;
  const bf16* safe;     // an address inside the source, for zero fills
  long long plane;
  __device__ void issue(bf16* dst, const bf16* src, long long ld, int rows,
                        int cols) {
    constexpr int kGroups = R * C / 8;
    static_assert(kGroups % kThreads == 0, "whole groups per thread");
#pragma unroll
    for (int g = 0; g < kGroups / kThreads; ++g) {
      const int e = threadIdx.x + g * kThreads;
      const int r = e / (C / 8), c = e % (C / 8) * 8;
      const bool live = r < rows && c < cols;
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) {
        bf16* d = dst + pl * R * P + r * P + c;
        const bf16* s = src + pl * plane + r * ld + c;
        if (!live || c + 8 <= cols) {
          cp_async16(d, live ? s : safe, live);
        } else {
          for (int x = 0; x < 8; ++x)
            d[x] = c + x < cols ? s[x] : zero<bf16>();
        }
      }
    }
  }
  __device__ void commit(bf16*, const float*) {}
};

// a float32 operand, or any operand scaled by a factor per source row (the
// decayed K): read into registers 16 bytes at a time, then scaled, split
// into NT bf16 planes and stored
template <typename T, bool SCALED, int NT, int R, int C, int P>
struct Split {
  static constexpr int kPlanes = NT;
  static constexpr int kG = 16 / sizeof(T);
  static constexpr int kPer = R * C / kG / kThreads;
  static_assert(R * C / kG % kThreads == 0, "whole groups per thread");
  const bf16* safe;     // unused: the interface of Copy
  long long plane;
  uint4 reg[kPer];
  __device__ void issue(bf16*, const T* src, long long ld, int rows,
                        int cols) {
#pragma unroll
    for (int g = 0; g < kPer; ++g) {
      const int e = threadIdx.x + g * kThreads;
      const int r = e / (C / kG), c = e % (C / kG) * kG;
      const T* s = src + r * ld + c;
      if (r >= rows || c >= cols) {
        reg[g] = make_uint4(0, 0, 0, 0);
      } else if (c + kG <= cols) {
        reg[g] = __ldg(reinterpret_cast<const uint4*>(s));
      } else {
        T tmp[kG];
        for (int x = 0; x < kG; ++x) tmp[x] = c + x < cols ? s[x] : zero<T>();
        memcpy(&reg[g], tmp, sizeof(tmp));
      }
    }
  }
  // scale: the factor of each of the stage's rows (SCALED only)
  __device__ void commit(bf16* dst, const float* scale) {
#pragma unroll
    for (int g = 0; g < kPer; ++g) {
      const int e = threadIdx.x + g * kThreads;
      const int r = e / (C / kG), c = e % (C / kG) * kG;
      const T* x = reinterpret_cast<const T*>(&reg[g]);
      const float f = SCALED ? scale[r] : 1.f;
      uint32_t out[NT][kG / 2];
#pragma unroll
      for (int i = 0; i < kG; i += 2) {
        float a[NT], b[NT];
        split(to_float(x[i]) * f, a);
        split(to_float(x[i + 1]) * f, b);
#pragma unroll
        for (int t = 0; t < NT; ++t) out[t][i / 2] = pack_bf16(a[t], b[t]);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        bf16* d = dst + t * R * P + r * P + c;
        if constexpr (kG == 4)
          *reinterpret_cast<uint2*>(d) = make_uint2(out[t][0], out[t][1]);
        else
          *reinterpret_cast<uint4*>(d) =
              make_uint4(out[t][0], out[t][1], out[t][2], out[t][3]);
      }
    }
  }
};

// an operand as it is: bf16 copied, float32 split in NT
template <typename T, int NT, int R, int C, int P>
using Plain =
    typename std::conditional<std::is_same<T, bf16>::value, Copy<1, R, C, P>,
                              Split<float, false, NT, R, C, P>>::type;

// ---------------------------------------------------------------------------
// The warp's products over one stage: acc (16 rows from m0, n16 groups of 16
// columns) += A B, A 16 x 32 and B 32 x 64, over the planes' term pairs
// whose indexes sum below NT.
// A is stored m x k (pitch kPM) or, AT, k x m (pitch kPN); B is stored k x n
// (pitch kPN) or, BN, n x k (pitch kPM). Only the first `kleft` of the
// stage's 32 depth indexes are taken (in steps of 16).
// ---------------------------------------------------------------------------
template <int NT, int PA, int PB, bool AT, bool BN>
__device__ __forceinline__ void stage_mma(float (&acc)[8][4], const bf16* A,
                                          const bf16* B, int m0, int n16,
                                          int kleft) {
  constexpr int kPlaneA = AT ? kDeep : kWide;
  constexpr int kPlaneB = BN ? kWide : kDeep;
#pragma unroll
  for (int k0 = 0; k0 < kDepth; k0 += 16) {
    if (k0 >= kleft) break;
    uint32_t a[PA][4];
#pragma unroll
    for (int t = 0; t < PA; ++t) {
      if constexpr (AT)
        ldsm_at<kPN>(a[t], A + t * kPlaneA, k0, m0);
      else
        ldsm_a<kPM>(a[t], A + t * kPlaneA, m0, k0);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n >= n16) break;
      uint32_t b[PB][4];
#pragma unroll
      for (int t = 0; t < PB; ++t) {
        if constexpr (BN)
          ldsm_b<kPM>(b[t], B + t * kPlaneB, n * 16, k0);
        else
          ldsm_bt<kPN>(b[t], B + t * kPlaneB, k0, n * 16);
      }
#pragma unroll
      for (int ta = 0; ta < PA; ++ta)
#pragma unroll
        for (int tb = 0; tb < PB; ++tb) {
          if (ta + tb >= NT) continue;
          mma16816(acc[2 * n], a[ta], b[tb][0], b[tb][1]);
          mma16816(acc[2 * n + 1], a[ta], b[tb][2], b[tb][3]);
        }
    }
  }
}

// The block's sweep over `steps` stages of the reduced dimension, two
// shared-memory stages deep: issue(s, a, b) starts stage s's loads into
// buffers a and b, commit(s, a, b) finishes them. The warp takes depth
// indexes up to kmax (of the whole sweep) and none if kmax < 0.
template <int NT, class LA, class LB, bool AT, bool BN, class Issue,
          class Commit>
__device__ __forceinline__ void sweep(float (&acc)[8][4], bf16* sa,
                                      bf16* sb, int steps, int m0, int n16,
                                      int kmax, Issue issue, Commit commit) {
  constexpr int kA = LA::kPlanes * (AT ? kDeep : kWide);
  constexpr int kB = LB::kPlanes * (BN ? kWide : kDeep);
  if (steps <= 0) return;
  issue(0, sa, sb);
  cp_async_commit();
  commit(0, sa, sb);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    bf16* na = sa + (cur ^ 1) * kA;
    bf16* nb = sb + (cur ^ 1) * kB;
    if (s + 1 < steps) {
      issue(s + 1, na, nb);
      cp_async_commit();
    }
    stage_mma<NT, LA::kPlanes, LB::kPlanes, AT, BN>(
        acc, sa + cur * kA, sb + cur * kB, m0, n16, kmax - s * kDepth + 1);
    if (s + 1 < steps) {
      commit(s + 1, na, nb);
      cp_async_wait<0>();
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
}

// ---------------------------------------------------------------------------
// 1. lb: a block of 32 threads per (chunk, row): la staged, summed left to
//    right by one thread, written back by all
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32) gla_lb_kernel(Params p) {
  __shared__ float buf[kMaxChunk];
  const int chunk = blockIdx.x, r = blockIdx.y;
  const int t0 = chunk * p.c;
  const int live = min(p.c, p.T - t0);
  const float* src = p.la + (long long)r * p.T + t0;
  for (int j = threadIdx.x; j < p.c; j += 32)
    buf[j] = j < live ? src[j] : 0.f;
  __syncwarp();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int j = 0; j < p.c; ++j) {
      acc += buf[j];
      buf[j] = acc;
    }
  }
  __syncwarp();
  float* dst = p.lb + ((long long)r * p.n + chunk) * p.cpad;
  for (int j = threadIdx.x; j < p.c; j += 32) dst[j] = buf[j];
}

// ---------------------------------------------------------------------------
// 2. scores: block per (64 x 64 tile, chunk, row); tiles above the diagonal
//    and tiles of rows past T return
// ---------------------------------------------------------------------------
template <typename TQ, typename TK, int NT>
struct Scores {
  using LQ = Plain<TQ, NT, kTile, kDepth, kPM>;
  using LK = Plain<TK, NT, kTile, kDepth, kPM>;
  static constexpr int kA = 2 * LQ::kPlanes * kWide;   // stages, bf16
  static constexpr int kB = 2 * LK::kPlanes * kWide;
  static constexpr size_t kSmem = 2 * (kA + kB) + 2 * kTile * sizeof(float);
};

template <typename TQ, typename TK, int NT>
__global__ void __launch_bounds__(kThreads) gla_scores_kernel(Params p) {
  using K = Scores<TQ, TK, NT>;
  using LQ = typename K::LQ;
  using LK = typename K::LK;
  bf16* sa = reinterpret_cast<bf16*>(gla_smem);
  bf16* sb = sa + K::kA;
  float* lbi = reinterpret_cast<float*>(sb + K::kB);
  float* lbj = lbi + kTile;
  const int nt = p.cpad / kTile;
  const int ti = blockIdx.x / nt, tj = blockIdx.x % nt;
  if (tj > ti) return;
  const int chunk = blockIdx.y, r = blockIdx.z;
  const int t0 = chunk * p.c;
  const int live = min(p.c, p.T - t0);
  const int i0 = ti * kTile, j0 = tj * kTile;
  if (i0 >= live) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = warp * 16;

  const float* lbr = p.lb + ((long long)r * p.n + chunk) * p.cpad;
  for (int x = threadIdx.x; x < kTile; x += kThreads) {
    lbi[x] = i0 + x < live ? lbr[i0 + x] : 0.f;
    lbj[x] = j0 + x < live ? lbr[j0 + x] : 0.f;
  }
  const TQ* qr = row_base<TQ>(p.q, p.qs, r, p.H);
  const TK* kr = row_base<TK>(p.k, p.ks, r, p.H);
  const TQ* q0 = qr + (t0 + i0) * p.qs[2];
  const TK* k0 = kr + (t0 + j0) * p.ks[2];
  const int rows_q = min(kTile, live - i0);
  const int rows_k = max(0, min(kTile, live - j0));
  LQ lq{reinterpret_cast<const bf16*>(qr), 0};
  LK lk{reinterpret_cast<const bf16*>(kr), 0};
  float acc[8][4];
  zero_acc(acc);
  sweep<NT, LQ, LK, false, true>(
      acc, sa, sb, (p.dk + kDepth - 1) / kDepth, m0, (rows_k + 15) / 16,
      m0 < rows_q ? 1 << 30 : -1,
      [&](int s, bf16* a, bf16* b) {
        const int d = s * kDepth;
        lq.issue(a, q0 + d, p.qs[2], rows_q, p.dk - d);
        lk.issue(b, k0 + d, p.ks[2], rows_k, p.dk - d);
      },
      [&](int, bf16* a, bf16* b) {
        lq.commit(a, nullptr);
        lk.commit(b, nullptr);
      });

  // P_ij = (q_i . k_j) exp(lb_i - lb_j) for j <= i < live, else 0, as its
  // bf16 terms, two neighbouring columns a store
  const long long plane = (long long)p.R * p.n * p.cpad * p.cpad;
  bf16* out = p.p + ((long long)r * p.n + chunk) * p.cpad * p.cpad;
  const int g = lane / 4, cc = 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int il = m0 + g + 8 * h, i = i0 + il;
      const int jl = n * 8 + cc, j = j0 + jl;
      float w[2][NT];
#pragma unroll
      for (int x = 0; x < 2; ++x)
        split(j + x <= i && i < live
                  ? acc[n][2 * h + x] * expf(lbi[il] - lbj[jl + x])
                  : 0.f,
              w[x]);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        *reinterpret_cast<uint32_t*>(out + t * plane +
                                     (long long)i * p.cpad + j) =
            pack_bf16(w[0][t], w[1][t]);
    }
}

// ---------------------------------------------------------------------------
// 3. chunk states: block per (dv tile, dk tile, row), the chunks in order
// ---------------------------------------------------------------------------
template <typename TK, typename TV>
struct States {
  static constexpr int NT = kTermsOf<TV>;
  using LK = Split<TK, true, NT, kDepth, kTile, kPN>;   // decayed K, j x d
  using LV = Plain<TV, NT, kDepth, kTile, kPN>;         // V, j x v
  static constexpr int kA = 2 * LK::kPlanes * kDeep;
  static constexpr int kB = 2 * LV::kPlanes * kDeep;
  static constexpr size_t kSmem = 2 * (kA + kB) + kMaxChunk * sizeof(float);
};

template <typename TK, typename TV>
__global__ void __launch_bounds__(kThreads) gla_states_kernel(Params p) {
  using K = States<TK, TV>;
  constexpr int NT = K::NT;
  using LK = typename K::LK;
  using LV = typename K::LV;
  bf16* sa = reinterpret_cast<bf16*>(gla_smem);
  bf16* sb = sa + K::kA;
  float* dec = reinterpret_cast<float*>(sb + K::kB);  // exp(lb_last - lb_j)
  const int v0 = blockIdx.x * kTile, d0 = blockIdx.y * kTile, r = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = warp * 16, g = lane / 4, cc = 2 * (lane % 4);
  const int rows_d = min(kTile, p.dk - d0);
  const int n16 = (min(kTile, p.dv - v0) + 15) / 16;
  const TK* kr = row_base<TK>(p.k, p.ks, r, p.H);
  const TV* vr = row_base<TV>(p.v, p.vs, r, p.H);

  // the warp's 16 x 64 slice of S, as accumulator fragments: row d0 + m0 +
  // g (+ 8), columns v0 + 8 n + cc (+ 1); zero past dk and dv
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + m0 + g + 8 * (x / 2), v = v0 + 8 * n + cc + x % 2;
      s[n][x] = p.s0 != nullptr && d < p.dk && v < p.dv
                    ? p.s0[((long long)r * p.dk + d) * p.dv + v]
                    : 0.f;
    }
  const long long plane = (long long)p.R * p.n * p.dk * p.dvp;
  LK lk{reinterpret_cast<const bf16*>(kr), 0};
  LV lv{reinterpret_cast<const bf16*>(vr), 0};
  for (int chunk = 0; chunk < p.n; ++chunk) {
    const int t0 = chunk * p.c;
    const int live = min(p.c, p.T - t0);
    const long long rc = (long long)r * p.n + chunk;
    // the state entering the chunk, as its bf16 terms (columns up to dvp)
    bf16* out = p.st + rc * p.dk * p.dvp;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + m0 + g + 8 * h, v = v0 + 8 * n + cc;
        if (d >= p.dk || v >= p.dvp) continue;
        float a[NT], b[NT];
        split(s[n][2 * h], a);
        split(s[n][2 * h + 1], b);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          *reinterpret_cast<uint32_t*>(out + t * plane +
                                       (long long)d * p.dvp + v) =
              pack_bf16(a[t], b[t]);
      }
    const float* lbr = p.lb + rc * p.cpad;
    const float last = lbr[p.c - 1];
    for (int j = threadIdx.x; j < kMaxChunk; j += kThreads)
      dec[j] = j < p.c ? expf(last - lbr[j]) : 0.f;
    const float decay = expf(last);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] *= decay;
    __syncthreads();  // dec is written
    // S += (K * dec)^T V over the chunk's live steps
    const TK* kc = kr + t0 * p.ks[2] + d0;
    const TV* vc = vr + t0 * p.vs[2] + v0;
    sweep<NT, LK, LV, true, false>(
        s, sa, sb, (live + kDepth - 1) / kDepth, m0, n16,
        m0 < rows_d ? 1 << 30 : -1,
        [&](int st, bf16* a, bf16* b) {
          const int j = st * kDepth;
          lk.issue(a, kc + j * p.ks[2], p.ks[2], live - j, p.dk - d0);
          lv.issue(b, vc + j * p.vs[2], p.vs[2], live - j, p.dv - v0);
        },
        [&](int st, bf16* a, bf16* b) {
          lk.commit(a, dec + st * kDepth);
          lv.commit(b, nullptr);
        });
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + m0 + g + 8 * (x / 2), v = v0 + 8 * n + cc + x % 2;
      if (d < p.dk && v < p.dv)
        p.s[((long long)r * p.dk + d) * p.dv + v] = s[n][x];
    }
}

// ---------------------------------------------------------------------------
// 4. outputs: block per (64-row tile of the chunk, dv tile, chunk, row),
//    the row tiles of one dv tile neighbours
// ---------------------------------------------------------------------------
template <typename TQ, typename TV>
struct Outputs {
  static constexpr int NT = kTermsOf<TV>;
  using LQ = Plain<TQ, NT, kTile, kDepth, kPM>;    // Q, i x d
  using LS = Copy<NT, kDepth, kTile, kPN>;         // S_n's terms, d x v
  using LP = Copy<NT, kTile, kDepth, kPM>;         // P's terms, i x j
  using LV = Plain<TV, NT, kDepth, kTile, kPN>;    // V, j x v
  static constexpr int kA = 2 * NT * kWide;        // the larger of Q and P
  static constexpr int kB = 2 * NT * kDeep;        // the larger of S and V
  static constexpr size_t kSmem = 2 * (kA + kB) + kTile * sizeof(float);
};

template <typename TQ, typename TV>
__global__ void __launch_bounds__(kThreads) gla_outputs_kernel(Params p) {
  using K = Outputs<TQ, TV>;
  constexpr int NT = K::NT;
  using LQ = typename K::LQ;
  using LS = typename K::LS;
  using LP = typename K::LP;
  using LV = typename K::LV;
  bf16* sa = reinterpret_cast<bf16*>(gla_smem);
  bf16* sb = sa + K::kA;
  float* eb = reinterpret_cast<float*>(sb + K::kB);   // exp(lb_i)
  const int nt = p.cpad / kTile;
  const int ti = blockIdx.x % nt, vt = blockIdx.x / nt;
  const int chunk = blockIdx.y, r = blockIdx.z;
  const int t0 = chunk * p.c;
  const int live = min(p.c, p.T - t0);
  const int i0 = ti * kTile, v0 = vt * kTile;
  if (i0 >= live) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = warp * 16, g = lane / 4, cc = 2 * (lane % 4);
  const int rows_i = min(kTile, live - i0);
  const int n16 = (min(kTile, p.dv - v0) + 15) / 16;
  const long long rc = (long long)r * p.n + chunk;
  const float* lbr = p.lb + rc * p.cpad;
  for (int x = threadIdx.x; x < kTile; x += kThreads)
    eb[x] = i0 + x < live ? expf(lbr[i0 + x]) : 0.f;
  const TQ* qr = row_base<TQ>(p.q, p.qs, r, p.H) + (t0 + i0) * p.qs[2];
  const TV* vr = row_base<TV>(p.v, p.vs, r, p.H) + t0 * p.vs[2] + v0;
  float acc[8][4];
  zero_acc(acc);

  if (chunk > 0 || p.s0 != nullptr) {
    // exp(lb_i) q_i S_n
    LQ lq{reinterpret_cast<const bf16*>(qr), 0};
    LS ls{p.st, (long long)p.R * p.n * p.dk * p.dvp};
    const bf16* sn = p.st + rc * p.dk * p.dvp + v0;
    sweep<NT, LQ, LS, false, false>(
        acc, sa, sb, (p.dk + kDepth - 1) / kDepth, m0, n16,
        m0 < rows_i ? 1 << 30 : -1,
        [&](int s, bf16* a, bf16* b) {
          const int d = s * kDepth;
          lq.issue(a, qr + d, p.qs[2], rows_i, p.dk - d);
          ls.issue(b, sn + (long long)d * p.dvp, p.dvp, p.dk - d,
                   p.dvp - v0);
        },
        [&](int, bf16* a, bf16* b) {
          lq.commit(a, nullptr);
          ls.commit(b, nullptr);
        });
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[n][x] *= eb[m0 + g + 8 * (x / 2)];
  }

  // + P V over j < min(i0 + 64, live); a warp takes j up to its last row
  const int jend = min(i0 + kTile, live);
  LP lp{p.p, (long long)p.R * p.n * p.cpad * p.cpad};
  LV lv{reinterpret_cast<const bf16*>(vr), 0};
  const bf16* pr = p.p + (rc * p.cpad + i0) * p.cpad;
  sweep<NT, LP, LV, false, false>(
      acc, sa, sb, (jend + kDepth - 1) / kDepth, m0, n16,
      m0 < rows_i ? min(i0 + m0 + 15, live - 1) : -1,
      [&](int s, bf16* a, bf16* b) {
        const int j = s * kDepth;
        lp.issue(a, pr + j, p.cpad, kTile, p.cpad - j);
        lv.issue(b, vr + j * p.vs[2], p.vs[2], live - j, p.dv - v0);
      },
      [&](int, bf16* a, bf16* b) {
        lp.commit(a, nullptr);
        lv.commit(b, nullptr);
      });

  // y in v's type, two neighbouring columns a store where both are live
  TV* yr = static_cast<TV*>(p.y) + ((long long)r * p.T + t0 + i0) * p.dvp;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int il = m0 + g + 8 * h, v = v0 + 8 * n + cc;
      if (il >= rows_i || v >= p.dv) continue;
      TV* dst = yr + (long long)il * p.dvp + v;
      const float a = acc[n][2 * h], b = acc[n][2 * h + 1];
      if (v + 1 >= p.dv) {
        *dst = from_float<TV>(a);
      } else if constexpr (std::is_same<TV, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(a, b);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
      }
    }
}

// the dynamic shared memory of a kernel, allowed past 48 KB where needed
template <typename F>
int allow(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename TQ, typename TK, typename TV>
int launch(const Params& p, cudaStream_t s) {
  constexpr int NT = kTermsOf<TV>;
  using KS = Scores<TQ, TK, NT>;
  using KU = States<TK, TV>;
  using KO = Outputs<TQ, TV>;
  const int nt = p.cpad / kTile;
  const int ndk = (p.dk + kTile - 1) / kTile, ndv = (p.dv + kTile - 1) / kTile;
  int err = allow(gla_scores_kernel<TQ, TK, NT>, KS::kSmem);
  if (!err) err = allow(gla_states_kernel<TK, TV>, KU::kSmem);
  if (!err) err = allow(gla_outputs_kernel<TQ, TV>, KO::kSmem);
  if (err) return err;
  gla_lb_kernel<<<dim3(p.n, p.R), 32, 0, s>>>(p);
  gla_scores_kernel<TQ, TK, NT>
      <<<dim3(nt * nt, p.n, p.R), kThreads, KS::kSmem, s>>>(p);
  gla_states_kernel<TK, TV>
      <<<dim3(ndv, ndk, p.R), kThreads, KU::kSmem, s>>>(p);
  gla_outputs_kernel<TQ, TV>
      <<<dim3(nt * ndv, p.n, p.R), kThreads, KO::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the launch for the operands' types (0 float32, 1 bfloat16)
template <typename TQ, typename TK>
int launch_v(const Params& p, int tv, cudaStream_t s) {
  return tv ? launch<TQ, TK, bf16>(p, s) : launch<TQ, TK, float>(p, s);
}

template <typename TQ>
int launch_kv(const Params& p, int tk, int tv, cudaStream_t s) {
  return tk ? launch_v<TQ, bf16>(p, tv, s) : launch_v<TQ, float>(p, tv, s);
}

}  // namespace

// q, k (B, H, T, dk) and v (B, H, T, dv), each float32 or bfloat16 (codes
// q_t, k_t, v_t: 0, 1) with (B, H, T) strides in elements, unit stride
// along the last dimension, every row 16-byte aligned. la (B * H, T) and s0
// (B * H, dk, dv) or null: float32, contiguous. y (B * H, T, dvp) in v's
// type, dvp a multiple of 8 not below dv (its first dv columns written);
// s (B * H, dk, dv) float32. Scratch: lb (B * H, n, cpad) float32, p
// (terms, B * H, n, cpad, cpad) and st (terms, B * H, n, dk, dvp)
// bfloat16, with n = ceil(T / c), cpad = c rounded up to 64 and terms the
// bf16 terms of a float32 operand: 2 for a bf16 v, 3 for a float32 one.
// 1 <= c <= 256. Four kernels on the stream. Returns the cudaError_t of
// the launches.
extern "C" int gla_scan_launch(
    const void* q, const void* k, const void* v, const float* la,
    const float* s0, void* y, float* s, float* lb, void* pscr, void* sscr,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, int B, int H, int T, int dk, int dv, int c, int dvp,
    int q_t, int k_t, int v_t, int terms, void* stream) {
  const int R = B * H;
  if (R == 0 || T == 0 || dv == 0) return 0;
  const int n = (T + c - 1) / c;
  if (c < 1 || c > kMaxChunk || dk < 1 || dvp < dv || dvp % 8 != 0 ||
      R > 65535 || n > 65535 || (q_t | k_t | v_t) & ~1 ||
      terms != (v_t ? kTermsOf<bf16> : kTermsOf<float>))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, la, s0, y, s, lb, static_cast<bf16*>(pscr),
           static_cast<bf16*>(sscr), {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
           {v_sb, v_sh, v_st}, R, H, T, dk, dv, c, n,
           (c + kTile - 1) / kTile * kTile, dvp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_t ? launch_kv<bf16>(p, k_t, v_t, st)
             : launch_kv<float>(p, k_t, v_t, st);
}
