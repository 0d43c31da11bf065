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
//
// The backward (gla_scan_bwd_launch) replaces no Pallas kernel: the TPU
// kernel is forward only, and the reference's gradient is XLA's autodiff of
// src/repro/models/ssm.py:32 chunked_gla. It is the same chunk form run
// right to left (the formulas above the backward's kernels), on the same
// tiles, loaders, products and operand split (NT by v's type), the float32
// gradients dY and dS split as P and S are. Nothing is saved from the
// forward but its inputs (a model under remat runs every forward twice);
// nine kernels on the stream:
//  a. gla_lb_kernel and gla_states_kernel again: lb and the chunk-entry
//     states S_n (and the final state, for d la) into scratch;
//  b. gla_dstates_kernel: a block per (dv tile, dk tile, row) carries dS in
//     registers from the final state's gradient, chunks right to left,
//     writing the dS that leaves each chunk as its terms, then dS =
//     exp(lb_last) dS + (Q exp(lb))^T dY; what is left is the initial
//     state's gradient;
//  c. gla_scores_kernel twice: P = D * (Q K^T), and dA = D * (dY V^T) (the
//     same kernel over dy and v, reduced over dv);
//  d. gla_grad_kernel, the output kernel's shape three times: dQ = exp(lb_i)
//     dY S_n^T + dA K over j <= i; dK = exp(lb_last - lb_j) V dS^T + dA^T Q
//     and dV = exp(lb_last - lb_j) K dS + P^T dY over i >= j (the scores
//     read transposed). Each is written in its operand's type, densely per
//     head (a stride-0 q or k gets one gradient per head; autograd sums
//     them). dQ and dK also leave q . dq and k . dk by 64-column slice;
//  e. gla_dla_kernel: d la is the reverse cumulative sum over T of
//     q . dq - k . dk, plus <dS_T, S_T> at the last step (the decay's
//     gradient without a c x c matrix of its own), in float32.
// Bound: operations, as the forward's: ten products a chunk against its
// four (the states and P among them again); chip_smoke.py's gla_bwd_tc_ops
// counts the split's bf16 products. A simple form first: every product is
// its own pass over its operands, and P, dA, S_n and dS go through device
// memory as their terms.
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

// ===========================================================================
// The backward (no Pallas kernel: the reference differentiates chunked_gla
// through XLA). Per chunk, with S_n the state entering it, dS the gradient
// of the state leaving it and D_ij = exp(lb_i - lb_j) for j <= i:
//   dA = D * (dY V^T),  P = D * (Q K^T)
//   dQ = dA K + exp(lb_i) dY S_n^T
//   dK = dA^T Q + exp(lb_last - lb_j) V dS^T
//   dV = P^T dY + exp(lb_last - lb_j) K dS
//   dS <- exp(lb_last) dS + (Q exp(lb_i))^T dY
// and d la is the reverse cumulative sum over T of q_t . dq_t - k_t . dk_t
// (plus <dS_T, S_T> at the last step): the decay's gradient needs no c x c
// matrix of its own.
// ===========================================================================

// an operand read in place: its base and (B, H, T) strides in elements
struct Operand {
  const void* p;
  long long s[3];
};

template <typename T>
__device__ __forceinline__ const T* rows_of(const Operand& o, int r, int H) {
  return static_cast<const T*>(o.p) + (r / H) * o.s[0] + (r % H) * o.s[1];
}

struct Grad {
  Operand q, k, v, dy;   // dy in v's type
  const float* ds;       // (R, dk, dv): the final state's gradient, or null
  const float* s;        // (R, dk, dv): the final state, recomputed
  const float* lb;       // (R, n, cpad)
  const bf16* st;        // (NT, R, n, dk, dvp): the chunk-entry states' terms
  bf16* dst;             // (NT, R, n, dk, dvp): dS leaving each chunk, terms
  const bf16* pp;        // (NT, R, n, cpad, cpad): P's terms
  const bf16* pa;        // (NT, R, n, cpad, cpad): dA's terms
  void* gq;              // (R, T, dkp) in q's type: dQ
  void* gk;              // (R, T, dkp) in k's type: dK
  void* gv;              // (R, T, dvp) in v's type: dV
  float* ds0;            // (R, dk, dv): the initial state's gradient, or null
  float* part;           // (2, ndk, R, T): q . dq and k . dk by 64-wide slice
  float* dla;            // (R, T)
  int R, H, T, dk, dv, c, n, cpad, dvp, dkp;
  int s0;                // whether the forward started from a given state
};

// ---------------------------------------------------------------------------
// b. dS, right to left: block per (dv tile, dk tile, row), its 64 x 64 slice
//    of dS in registers, as gla_states_kernel carries S
// ---------------------------------------------------------------------------
template <typename TQ, typename TV>
struct DStates {
  static constexpr int NT = kTermsOf<TV>;
  using LQ = Split<TQ, true, NT, kDepth, kTile, kPN>;   // Q exp(lb), i x d
  using LY = Plain<TV, NT, kDepth, kTile, kPN>;         // dY, i x v
  static constexpr int kA = 2 * LQ::kPlanes * kDeep;
  static constexpr int kB = 2 * LY::kPlanes * kDeep;
  static constexpr size_t kSmem = 2 * (kA + kB) + kMaxChunk * sizeof(float);
};

template <typename TQ, typename TV>
__global__ void __launch_bounds__(kThreads) gla_dstates_kernel(Grad g) {
  using K = DStates<TQ, TV>;
  constexpr int NT = K::NT;
  using LQ = typename K::LQ;
  using LY = typename K::LY;
  bf16* sa = reinterpret_cast<bf16*>(gla_smem);
  bf16* sb = sa + K::kA;
  float* eb = reinterpret_cast<float*>(sb + K::kB);   // exp(lb_i)
  const int v0 = blockIdx.x * kTile, d0 = blockIdx.y * kTile, r = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = warp * 16, gr = lane / 4, cc = 2 * (lane % 4);
  const int rows_d = min(kTile, g.dk - d0);
  const int n16 = (min(kTile, g.dv - v0) + 15) / 16;
  const TQ* qr = rows_of<TQ>(g.q, r, g.H);
  const TV* yr = rows_of<TV>(g.dy, r, g.H);
  const long long sq = g.q.s[2], sy = g.dy.s[2];

  // the warp's 16 x 64 slice of dS, from the final state's gradient or 0
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + m0 + gr + 8 * (x / 2), v = v0 + 8 * n + cc + x % 2;
      s[n][x] = g.ds != nullptr && d < g.dk && v < g.dv
                    ? g.ds[((long long)r * g.dk + d) * g.dv + v]
                    : 0.f;
    }
  const long long plane = (long long)g.R * g.n * g.dk * g.dvp;
  LQ lq{reinterpret_cast<const bf16*>(qr), 0};
  LY ly{reinterpret_cast<const bf16*>(yr), 0};
  for (int chunk = g.n - 1; chunk >= 0; --chunk) {
    const int t0 = chunk * g.c;
    const int live = min(g.c, g.T - t0);
    const long long rc = (long long)r * g.n + chunk;
    // the dS leaving the chunk, as its bf16 terms (columns up to dvp)
    bf16* out = g.dst + rc * g.dk * g.dvp;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + m0 + gr + 8 * h, v = v0 + 8 * n + cc;
        if (d >= g.dk || v >= g.dvp) continue;
        float a[NT], b[NT];
        split(s[n][2 * h], a);
        split(s[n][2 * h + 1], b);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          *reinterpret_cast<uint32_t*>(out + t * plane +
                                       (long long)d * g.dvp + v) =
              pack_bf16(a[t], b[t]);
      }
    const float* lbr = g.lb + rc * g.cpad;
    for (int j = threadIdx.x; j < kMaxChunk; j += kThreads)
      eb[j] = j < g.c ? expf(lbr[j]) : 0.f;
    const float decay = expf(lbr[g.c - 1]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] *= decay;
    __syncthreads();  // eb is written
    // dS += (Q * exp(lb))^T dY over the chunk's live steps
    const TQ* qc = qr + t0 * sq + d0;
    const TV* yc = yr + t0 * sy + v0;
    sweep<NT, LQ, LY, true, false>(
        s, sa, sb, (live + kDepth - 1) / kDepth, m0, n16,
        m0 < rows_d ? 1 << 30 : -1,
        [&](int st, bf16* a, bf16* b) {
          const int j = st * kDepth;
          lq.issue(a, qc + j * sq, sq, live - j, g.dk - d0);
          ly.issue(b, yc + j * sy, sy, live - j, g.dv - v0);
        },
        [&](int st, bf16* a, bf16* b) {
          lq.commit(a, eb + st * kDepth);
          ly.commit(b, nullptr);
        });
  }
  if (g.ds0 == nullptr) return;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + m0 + gr + 8 * (x / 2), v = v0 + 8 * n + cc + x % 2;
      if (d < g.dk && v < g.dv)
        g.ds0[((long long)r * g.dk + d) * g.dv + v] = s[n][x];
    }
}

// ---------------------------------------------------------------------------
// d. the gradients: block per (64-row tile of the chunk, 64-column tile of
//    the output, chunk, row), in the shape of gla_outputs_kernel:
//      MODE 0, dQ (i x d) = exp(lb_i) (dY S_n^T) + dA K,        j <= i
//      MODE 1, dK (j x d) = exp(lb_last - lb_j) (V dS^T) + dA^T Q, i >= j
//      MODE 2, dV (j x v) = exp(lb_last - lb_j) (K dS) + P^T dY,   i >= j
//    the state's product first (skipped while that state is zero), its rows
//    scaled, then the scores' product. dQ and dK also write q . dq and
//    k . dk over their 64 columns, for d la.
// ---------------------------------------------------------------------------
template <int MODE, typename TQ, typename TK, typename TV>
struct GradOut {
  static constexpr int NT = kTermsOf<TV>;
  // X: the state product's A operand; Y: the scores product's B operand;
  // TO: the output's (and its operand's) type
  using TX = typename std::conditional<MODE == 2, TK, TV>::type;
  using TY = typename std::conditional<
      MODE == 0, TK, typename std::conditional<MODE == 1, TQ, TV>::type>::type;
  using TO = typename std::conditional<
      MODE == 0, TQ, typename std::conditional<MODE == 1, TK, TV>::type>::type;
  static constexpr bool kStateT = MODE != 2;   // the state's terms as S^T
  static constexpr bool kScoresT = MODE != 0;  // the scores as M^T
  using LX = Plain<TX, NT, kTile, kDepth, kPM>;
  using LS = typename std::conditional<kStateT, Copy<NT, kTile, kDepth, kPM>,
                                       Copy<NT, kDepth, kTile, kPN>>::type;
  using LM = typename std::conditional<kScoresT, Copy<NT, kDepth, kTile, kPN>,
                                       Copy<NT, kTile, kDepth, kPM>>::type;
  using LY = Plain<TY, NT, kDepth, kTile, kPN>;
  static_assert(kWide >= kDeep, "a 64 x 32 plane holds a 32 x 64 one");
  static constexpr int kA = 2 * NT * kWide;   // the larger of X and M
  static constexpr int kB = 2 * NT * kWide;   // the larger of S and Y
  static constexpr size_t kSmem = 2 * (kA + kB) + kTile * sizeof(float);
};

template <int MODE, typename TQ, typename TK, typename TV>
__global__ void __launch_bounds__(kThreads) gla_grad_kernel(Grad g) {
  using K = GradOut<MODE, TQ, TK, TV>;
  constexpr int NT = K::NT;
  using TX = typename K::TX;
  using TY = typename K::TY;
  using TO = typename K::TO;
  using LX = typename K::LX;
  using LS = typename K::LS;
  using LM = typename K::LM;
  using LY = typename K::LY;
  bf16* sa = reinterpret_cast<bf16*>(gla_smem);
  bf16* sb = sa + K::kA;
  float* eb = reinterpret_cast<float*>(sb + K::kB);   // the rows' scales
  const int W = MODE == 2 ? g.dv : g.dk;              // output columns
  const int KS = MODE == 2 ? g.dk : g.dv;             // the state's depth
  const int nt = g.cpad / kTile;
  const int ti = blockIdx.x % nt, wt = blockIdx.x / nt;
  const int chunk = blockIdx.y, r = blockIdx.z;
  const int t0 = chunk * g.c;
  const int live = min(g.c, g.T - t0);
  const int i0 = ti * kTile, w0 = wt * kTile;
  if (i0 >= live) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = warp * 16, gr = lane / 4, cc = 2 * (lane % 4);
  const int rows = min(kTile, live - i0);
  const int n16 = (min(kTile, W - w0) + 15) / 16;
  const long long rc = (long long)r * g.n + chunk;
  const float* lbr = g.lb + rc * g.cpad;
  const float last = lbr[g.c - 1];
  for (int x = threadIdx.x; x < kTile; x += kThreads)
    eb[x] = i0 + x < live
                ? expf(MODE == 0 ? lbr[i0 + x] : last - lbr[i0 + x])
                : 0.f;
  const Operand& xo = MODE == 0 ? g.dy : MODE == 1 ? g.v : g.k;
  const Operand& yo = MODE == 0 ? g.k : MODE == 1 ? g.q : g.dy;
  const TX* xr = rows_of<TX>(xo, r, g.H) + (t0 + i0) * xo.s[2];
  const TY* yr = rows_of<TY>(yo, r, g.H) + t0 * yo.s[2] + w0;
  float acc[8][4];
  zero_acc(acc);

  const bool zero_state = MODE == 0 ? chunk == 0 && !g.s0
                                    : chunk == g.n - 1 && g.ds == nullptr;
  if (!zero_state) {
    const long long plane = (long long)g.R * g.n * g.dk * g.dvp;
    const bf16* sn = (MODE == 0 ? g.st : g.dst) + rc * g.dk * g.dvp;
    LX lx{reinterpret_cast<const bf16*>(xr), 0};
    LS ls{sn, plane};
    sweep<NT, LX, LS, false, K::kStateT>(
        acc, sa, sb, (KS + kDepth - 1) / kDepth, m0, n16,
        m0 < rows ? 1 << 30 : -1,
        [&](int s, bf16* a, bf16* b) {
          const int kk = s * kDepth;
          lx.issue(a, xr + kk, xo.s[2], rows, KS - kk);
          if constexpr (K::kStateT)   // S^T: rows d (the output's), cols v
            ls.issue(b, sn + (long long)w0 * g.dvp + kk, g.dvp, g.dk - w0,
                     g.dvp - kk);
          else                        // S: rows d (the depth), cols v
            ls.issue(b, sn + (long long)kk * g.dvp + w0, g.dvp, g.dk - kk,
                     g.dvp - w0);
        },
        [&](int, bf16* a, bf16* b) {
          lx.commit(a, nullptr);
          ls.commit(b, nullptr);
        });
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[n][x] *= eb[m0 + gr + 8 * (x / 2)];
  }

  const long long mplane = (long long)g.R * g.n * g.cpad * g.cpad;
  const bf16* mr = (MODE == 2 ? g.pp : g.pa) + rc * g.cpad * g.cpad;
  LM lm{mr, mplane};
  LY ly{reinterpret_cast<const bf16*>(yr), 0};
  const long long sy = yo.s[2];
  if constexpr (!K::kScoresT) {
    // + dA K over j < min(i0 + 64, live); a warp takes j up to its last row
    const int jend = min(i0 + kTile, live);
    sweep<NT, LM, LY, false, false>(
        acc, sa, sb, (jend + kDepth - 1) / kDepth, m0, n16,
        m0 < rows ? min(i0 + m0 + 15, live - 1) : -1,
        [&](int s, bf16* a, bf16* b) {
          const int j = s * kDepth;
          lm.issue(a, mr + (long long)i0 * g.cpad + j, g.cpad, kTile,
                   g.cpad - j);
          ly.issue(b, yr + j * sy, sy, live - j, W - w0);
        },
        [&](int, bf16* a, bf16* b) {
          lm.commit(a, nullptr);
          ly.commit(b, nullptr);
        });
  } else {
    // + M^T Y over i from i0 (tiles on or below the diagonal) to live
    sweep<NT, LM, LY, true, false>(
        acc, sa, sb, (live - i0 + kDepth - 1) / kDepth, m0, n16,
        m0 < rows ? 1 << 30 : -1,
        [&](int s, bf16* a, bf16* b) {
          const int i = i0 + s * kDepth;
          lm.issue(a, mr + (long long)i * g.cpad + i0, g.cpad, live - i,
                   kTile);
          ly.issue(b, yr + i * sy, sy, live - i, W - w0);
        },
        [&](int, bf16* a, bf16* b) {
          lm.commit(a, nullptr);
          ly.commit(b, nullptr);
        });
  }

  // the output in its operand's type, two neighbouring columns a store
  // where both are live
  const int pitch = MODE == 2 ? g.dvp : g.dkp;
  TO* out = static_cast<TO*>(MODE == 0 ? g.gq : MODE == 1 ? g.gk : g.gv) +
            ((long long)r * g.T + t0 + i0) * pitch;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int il = m0 + gr + 8 * h, w = w0 + 8 * n + cc;
      if (il >= rows || w >= W) continue;
      TO* dst = out + (long long)il * pitch + w;
      const float a = acc[n][2 * h], b = acc[n][2 * h + 1];
      if (w + 1 >= W) {
        *dst = from_float<TO>(a);
      } else if constexpr (std::is_same<TO, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(a, b);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
      }
    }
  if constexpr (MODE != 2) {
    // q . dq (k . dk) over the tile's columns, a quad of lanes a row; the
    // float32 products, before the output's rounding
    const TO* src = rows_of<TO>(MODE == 0 ? g.q : g.k, r, g.H);
    const long long ss = (MODE == 0 ? g.q : g.k).s[2];
    float* part = g.part + ((long long)MODE * ((g.dk + kTile - 1) / kTile) +
                            wt) * g.R * g.T + (long long)r * g.T + t0 + i0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int il = m0 + gr + 8 * h;
      float sum = 0.f;
      if (il < rows) {
        const TO* row = src + (t0 + i0 + il) * ss;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int w = w0 + 8 * n + cc + x;
            if (w < W) sum += acc[n][2 * h + x] * to_float(row[w]);
          }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (lane % 4 == 0 && il < rows) part[il] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// e. d la: a block per row. delta_t = q_t . dq_t - k_t . dk_t (the slices'
//    sums in order), plus <dS_T, S_T> at the last step; d la_t is the sum of
//    delta over steps t and later, in float32: each thread sums a segment
//    of steps, the segments' sums are scanned right to left, then each
//    thread walks its segment back
// ---------------------------------------------------------------------------
constexpr int kScan = 256;

__global__ void __launch_bounds__(kScan) gla_dla_kernel(Grad g) {
  __shared__ float red[kScan];
  const int r = blockIdx.x, tid = threadIdx.x;
  float dot = 0.f;
  if (g.ds != nullptr) {
    const long long base = (long long)r * g.dk * g.dv;
    for (int e = tid; e < g.dk * g.dv; e += kScan)
      dot += g.ds[base + e] * g.s[base + e];
  }
  red[tid] = dot;
  __syncthreads();
  for (int w = kScan / 2; w > 0; w /= 2) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  dot = red[0];
  __syncthreads();
  const int ndk = (g.dk + kTile - 1) / kTile;
  const long long plane = (long long)g.R * g.T;
  const float* p = g.part + (long long)r * g.T;
  auto delta = [&](int t) {
    float x = 0.f;
    for (int s = 0; s < ndk; ++s)
      x += p[s * plane + t] - p[(ndk + s) * plane + t];
    return t == g.T - 1 ? x + dot : x;
  };
  const int seg = (g.T + kScan - 1) / kScan;
  const int lo = min(g.T, tid * seg), hi = min(g.T, lo + seg);
  float sum = 0.f;
  for (int t = lo; t < hi; ++t) sum += delta(t);
  red[tid] = sum;
  __syncthreads();
  if (tid == 0) {   // each segment's sum becomes the sum of those after it
    float acc = 0.f;
    for (int s = kScan - 1; s >= 0; --s) {
      const float x = red[s];
      red[s] = acc;
      acc += x;
    }
  }
  __syncthreads();
  float acc = red[tid];
  float* out = g.dla + (long long)r * g.T;
  for (int t = hi - 1; t >= lo; --t) {
    acc += delta(t);
    out[t] = acc;
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

// the backward's kernels on the stream, each launch checked: a: lb and the
// chunk-entry states again (nothing but the forward's inputs is saved); b:
// dS right to left; c: P and dA; d: dQ, dK, dV; e: d la
template <typename TQ, typename TK, typename TV>
int launch_bwd(const Params& p, const Params& pa, const Grad& g,
               cudaStream_t s) {
  constexpr int NT = kTermsOf<TV>;
  using KS = Scores<TQ, TK, NT>;
  using KA = Scores<TV, TV, NT>;
  using KU = States<TK, TV>;
  using KD = DStates<TQ, TV>;
  using G0 = GradOut<0, TQ, TK, TV>;
  using G1 = GradOut<1, TQ, TK, TV>;
  using G2 = GradOut<2, TQ, TK, TV>;
  const int nt = p.cpad / kTile;
  const int ndk = (p.dk + kTile - 1) / kTile, ndv = (p.dv + kTile - 1) / kTile;
  int err = allow(gla_scores_kernel<TQ, TK, NT>, KS::kSmem);
  if (!err) err = allow(gla_scores_kernel<TV, TV, NT>, KA::kSmem);
  if (!err) err = allow(gla_states_kernel<TK, TV>, KU::kSmem);
  if (!err) err = allow(gla_dstates_kernel<TQ, TV>, KD::kSmem);
  if (!err) err = allow(gla_grad_kernel<0, TQ, TK, TV>, G0::kSmem);
  if (!err) err = allow(gla_grad_kernel<1, TQ, TK, TV>, G1::kSmem);
  if (!err) err = allow(gla_grad_kernel<2, TQ, TK, TV>, G2::kSmem);
  if (err) return err;
#define GLA_CHECK_LAUNCH()                                   \
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err
  gla_lb_kernel<<<dim3(p.n, p.R), 32, 0, s>>>(p);
  GLA_CHECK_LAUNCH();
  gla_states_kernel<TK, TV>
      <<<dim3(ndv, ndk, p.R), kThreads, KU::kSmem, s>>>(p);
  GLA_CHECK_LAUNCH();
  gla_dstates_kernel<TQ, TV>
      <<<dim3(ndv, ndk, p.R), kThreads, KD::kSmem, s>>>(g);
  GLA_CHECK_LAUNCH();
  gla_scores_kernel<TQ, TK, NT>
      <<<dim3(nt * nt, p.n, p.R), kThreads, KS::kSmem, s>>>(p);
  GLA_CHECK_LAUNCH();
  gla_scores_kernel<TV, TV, NT>
      <<<dim3(nt * nt, p.n, p.R), kThreads, KA::kSmem, s>>>(pa);
  GLA_CHECK_LAUNCH();
  gla_grad_kernel<0, TQ, TK, TV>
      <<<dim3(nt * ndk, p.n, p.R), kThreads, G0::kSmem, s>>>(g);
  GLA_CHECK_LAUNCH();
  gla_grad_kernel<1, TQ, TK, TV>
      <<<dim3(nt * ndk, p.n, p.R), kThreads, G1::kSmem, s>>>(g);
  GLA_CHECK_LAUNCH();
  gla_grad_kernel<2, TQ, TK, TV>
      <<<dim3(nt * ndv, p.n, p.R), kThreads, G2::kSmem, s>>>(g);
  GLA_CHECK_LAUNCH();
  gla_dla_kernel<<<p.R, kScan, 0, s>>>(g);
  GLA_CHECK_LAUNCH();
#undef GLA_CHECK_LAUNCH
  return 0;
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

// The backward. q, k, v as gla_scan_launch takes them; dy (B, H, T, dv) in
// v's type, read in place through its (B, H, T) strides; ds (B * H, dk, dv)
// float32, the final state's gradient, or null (zero). Writes gq, gk
// (B * H, T, dkp) in q's and k's types and gv (B * H, T, dvp) in v's (their
// first dk, dv columns), dla (B * H, T) float32 and, where not null, ds0
// (B * H, dk, dv) float32, the initial state's gradient. Scratch: s
// (B * H, dk, dv) float32, lb as the forward's, st and dst (terms, B * H,
// n, dk, dvp) and pp and pa (terms, B * H, n, cpad, cpad) bfloat16, part
// (2, ceil(dk / 64), B * H, T) float32. The operand types the models hand
// it: all float32, all bfloat16, the mLSTM's (bf16 q and v, float32 k) and
// mamba2's (bf16 q and k, float32 v); others are refused (the builds of
// the other four of the forward's eight would only lengthen the compile).
// Nine kernels on the stream. Returns the cudaError_t of the first launch
// that fails, else 0.
extern "C" int gla_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* dy,
    const float* la, const float* s0, const float* ds, float* s, float* lb,
    void* st, void* dst, void* pp, void* pa, void* gq, void* gk, void* gv,
    float* ds0, float* part, float* dla, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long y_sb,
    long long y_sh, long long y_st, int B, int H, int T, int dk, int dv,
    int c, int dvp, int dkp, int q_t, int k_t, int v_t, int terms,
    void* stream) {
  const int R = B * H;
  if (R == 0 || T == 0 || dv == 0) return 0;
  const int n = (T + c - 1) / c;
  if (c < 1 || c > kMaxChunk || dk < 1 || dvp < dv || dvp % 8 != 0 ||
      dkp < dk || dkp % 8 != 0 || R > 65535 || n > 65535 ||
      (q_t | k_t | v_t) & ~1 ||
      terms != (v_t ? kTermsOf<bf16> : kTermsOf<float>))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpad = (c + kTile - 1) / kTile * kTile;
  Params p{q, k, v, la, s0, nullptr, s, lb, static_cast<bf16*>(pp),
           static_cast<bf16*>(st), {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
           {v_sb, v_sh, v_st}, R, H, T, dk, dv, c, n, cpad, dvp};
  // dA's scores: P's kernel over (dy, v), reduced over dv
  Params pA{dy, v, v, la, s0, nullptr, s, lb, static_cast<bf16*>(pa),
            static_cast<bf16*>(st), {y_sb, y_sh, y_st}, {v_sb, v_sh, v_st},
            {v_sb, v_sh, v_st}, R, H, T, dv, dv, c, n, cpad, dvp};
  Grad g{{q, {q_sb, q_sh, q_st}}, {k, {k_sb, k_sh, k_st}},
         {v, {v_sb, v_sh, v_st}}, {dy, {y_sb, y_sh, y_st}}, ds, s, lb,
         static_cast<const bf16*>(st), static_cast<bf16*>(dst),
         static_cast<const bf16*>(pp), static_cast<const bf16*>(pa), gq, gk,
         gv, ds0, part, dla, R, H, T, dk, dv, c, n, cpad, dvp, dkp,
         s0 != nullptr};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (q_t << 2 | k_t << 1 | v_t) {
    case 0: return launch_bwd<float, float, float>(p, pA, g, sm);
    case 7: return launch_bwd<bf16, bf16, bf16>(p, pA, g, sm);
    case 5: return launch_bwd<bf16, float, bf16>(p, pA, g, sm);
    case 6: return launch_bwd<bf16, bf16, float>(p, pA, g, sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
