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
// (B 4, 32 query heads, T 2048, hd 64) does ~69 GFLOP forward (two products
// of the visible (query, key) pairs) and ~172 backward (five), against
// ~0.1 GB of operands: far above the ~295 flop/byte ridge, so the products
// must run on the tensor cores (989 TFLOP/s bf16) and not on the float32
// CUDA cores (67), in float32 too: there each product becomes six bf16
// products (below), six times the bf16 work and still 2.5x under the CUDA
// cores' time for the same products.
//
// bfloat16 operands run the tensor-core kernels: at head_dim 32-128 the
// forward and the backward on mma.sync m16n8k16 (FlashAttention-2: bf16
// in, float32 accumulators), and the forward at 192 and 256 too; the
// backward at 192 and 256 on Hopper's wgmma, fed by TMA (below). An
// mma.sync block is 4 warps and owns 64 rows, 16 a warp:
//  * forward and dQ: one block per (b, query head, 64-query tile), the last
//    tiles first (they see the most keys). 64-key tiles of K and V come in
//    by 16-byte cp.async into two shared-memory stages, so that tile j + 1
//    lands while tile j is computed (zero-fill past Tk); only the tiles from
//    the window's start to the causal limit are visited, and only edge
//    tiles are masked. Shared-memory rows are bf16, padded by 8 elements,
//    so that every ldmatrix is free of bank conflicts. S = Q K^T and
//    dP = dO V^T come from ldmatrix fragments; the online softmax (forward)
//    or P = exp(s - lse) and dS (dQ) run in float32 on the accumulator
//    fragments, and P or dS is packed to bf16 in registers as the A operand
//    of P V or dS K: it never goes through shared memory. The forward keeps
//    its Q fragments in registers for the whole sweep, but at hd 192 (MLA's
//    qk width) and 256, where a warp's 16 x 256 float32 accumulator alone
//    takes 128 registers a thread, it reads them from shared memory at
//    every key tile and scores each tile in two halves of 32 keys. The dQ
//    kernel first forms delta for its rows and writes it for the dK/dV
//    kernel, which runs after it on the same stream.
//  * dK/dV: one block per (b, kv head, 64-key tile), which loops over the G
//    heads and the 64-query tiles (32 at hd 128, for registers) that see
//    its keys, staged by cp.async with their lse and delta, and forms the
//    transposed products directly, rows being keys: S^T = K Q^T,
//    dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q. No atomics: every
//    output element has one owner, and the result is deterministic.
//  * at hd 192 and 256 the backward's blocks are a TMA producer and two
//    wgmma consumer warpgroups over the same 64 rows, each consumer holding
//    one accumulator: dV or dK (dK/dV), a part of dQ's columns (dQ); see
//    "The backward at head_dim 192 and 256, for Hopper" below.
// P and dS are rounded to bf16 once before their products (relative 2^-9),
// as the inputs of S and dP already are; nothing else is rounded before
// the outputs.
//
// float32 operands run the same products on the same tensor cores, each
// operand split into three bf16 terms, hi = bf16(x), mid = bf16(x - hi)
// and lo = bf16(x - hi - mid) (split<3>, mma.cuh; together within 2^-24
// of x): Q, K, V and dO when they reach shared memory, P and dS in
// registers. Of the nine term products a product keeps the six whose term
// indexes sum below three (hi hi, hi mid, mid hi, hi lo, mid mid, lo hi)
// and drops those below 2^-24 of it, all summed in float32 accumulators.
// Three terms, not two, measured against a float64 evaluation: with two
// (2^-16) the split's arithmetic in plain PyTorch
// (flash_attention_split_fwd_ref / _bwd_ref in kernels/flash_attention.py)
// holds the card's float32 tolerances (1e-4) on unit-scale scores, but on
// scores in the hundreds, as on the reference init's hard-max attention,
// it parts from float64 by more than twice plain float32's distance, and
// three terms stay within it (tests/test_torch_flash_f32_split.py). On the
// H100, at the reference init's first float32 train call (llama3.2-1b,
// |out| up to 67), the kernels lie 0.0008 from float64 (plain float32
// 0.0027) and their gradients 2.3e-5 of their largest (plain float32
// 4.8e-5), by chip_smoke.py's f64_witness. Three terms cost twice two's
// products and 1.5x their term tiles. The term products of each 16-deep
// step are summed in zeroed accumulators and then added to the running
// sums in float32 (mma_split): the tensor cores truncate every sum they
// form, and a running sum kept in their accumulators put the kernels ~20x
// farther from the plain versions (train_parity's 3.2e-5 of a gradient's
// largest, against 1.2e-6 summed apart; PERF.md). The float32 kernels ("The float32
// split kernels" below) are mma.sync blocks like the bf16 ones up to hd
// 128, at every head dim: float32 tiles take twice the bf16 bytes, so a
// block stages its streamed tiles as float32 by cp.async and splits each
// landed tile once into its bf16 term tiles, from which ldmatrix reads as
// in the bf16 kernels; the key (forward, dQ) or query (dK/dV) tiles are
// 16-32 rows, so that terms and staging fit, dK/dV puts dV and dK in
// separate warps, and at head_dim 256, where the backward's own rows do
// not fit as three terms, it keeps them float32 and splits their
// fragments in registers.
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;

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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;  // a block's own rows: queries, or keys in dK/dV
constexpr int kBK = 64;    // keys per staged K/V tile (forward, dQ)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kAll = 0xffffffffu;

// a shared-memory row of HD bf16 and 8 more (16 bytes), so that the 8 rows
// one ldmatrix matrix reads fall in 8 distinct bank quads
template <int HD>
constexpr int kPitch = HD + 8;

// rows [r0, r0 + ROWS) of a row-major (n, HD) bf16 matrix into a padded
// shared-memory tile by 16-byte cp.async; zeros for rows at or past n
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int n) {
  constexpr int kPieces = HD / 8;  // 16-byte pieces of a row
  static_assert(ROWS * kPieces % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int u = 0; u < ROWS * kPieces / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / kPieces, col = c % kPieces * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * kPitch<HD> + col,
               src + (long long)(in ? r0 + r : 0) * HD + col, in);
  }
}

// the max (or sum) over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kAll, x, 1));
  return fmaxf(x, __shfl_xor_sync(kAll, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kAll, x, 1);
  return x + __shfl_xor_sync(kAll, x, 2);
}

// K and V rows of key tile t into stage st of a two-stage K/V buffer
// (stage st: K at 2 st kBK rows, V after it)
template <int HD>
__device__ __forceinline__ void load_kv(bf16* kv_s, const bf16* kg,
                                        const bf16* vg, int st, int t,
                                        int Tk) {
  bf16* k_s = kv_s + st * 2 * kBK * kPitch<HD>;
  load_rows<HD, kBK>(k_s, kg, t * kBK, Tk);
  load_rows<HD, kBK>(k_s + kBK * kPitch<HD>, vg, t * kBK, Tk);
}

// row band h (the thread's row +0 or +8) of a warp's 16 x HD accumulator,
// times mul, as bf16 into the row-major row at dst
template <int DT>
__device__ __forceinline__ void store_band(bf16* dst,
                                           const float (&c)[DT][4], int h,
                                           float mul) {
  const int col = threadIdx.x % 4 * 2;
#pragma unroll
  for (int d = 0; d < DT; ++d)
    *reinterpret_cast<uint32_t*>(dst + d * 8 + col) =
        pack_bf16(c[d][2 * h] * mul, c[d][2 * h + 1] * mul);
}

// the same as float32
template <int DT>
__device__ __forceinline__ void store_band(float* dst,
                                           const float (&c)[DT][4], int h,
                                           float mul) {
  const int col = threadIdx.x % 4 * 2;
#pragma unroll
  for (int d = 0; d < DT; ++d)
    *reinterpret_cast<float2*>(dst + d * 8 + col) =
        make_float2(c[d][2 * h] * mul, c[d][2 * h + 1] * mul);
}

// The 64-query tile of a forward or dQ block and the keys it sees.
// (BK: keys a staged tile, kBK in the bf16 kernels)
template <int BK = kBK>
struct QBlockOf {
  long long row0;  // (B, Hkv, G, Tq) row of the block's (b, h, g, 0)
  long long kv;    // (B, Hkv) stream of its K and V
  int i0, off, q_first, q_last, t_lo, t_hi;

  __device__ QBlockOf(const Params& p) {
    const int qt = gridDim.x - 1 - blockIdx.x;  // the last tiles first
    row0 = ((long long)blockIdx.z * p.Hkv * p.G + blockIdx.y) * p.Tq;
    kv = (long long)blockIdx.z * p.Hkv + blockIdx.y / p.G;
    i0 = qt * kRows;
    off = p.Tk - p.Tq;
    q_first = i0 + off;
    q_last = min(i0 + kRows, p.Tq) - 1 + off;
    const int k_hi = p.causal ? min(p.Tk - 1, q_last) : p.Tk - 1;
    const int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
    t_lo = k_lo / BK;
    t_hi = k_hi / BK;
  }

  // whether some (row, key) pair of key tile t is masked
  __device__ bool edge(int t, const Params& p) const {
    const int k0 = t * BK;
    return k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > q_first) ||
           (p.window > 0 && k0 <= q_last - p.window);
  }
};
using QBlock = QBlockOf<>;

// The forward's online softmax, shared by its bf16 and float32 kernels.
// A score tile s of NP 8-key tiles (keys key0 + 8 n + ..., the thread's
// rows at positions q0 and q0 + 8) into the log2 domain, capped under a
// softcap and masked to -inf on an edge tile; mx gets each row's maximum.
template <int NP>
__device__ __forceinline__ void log2_scores(float (&s)[NP][4],
                                            float (&mx)[2], int key0, int q0,
                                            bool edge, const Params& p) {
  const int lane = threadIdx.x % 32;
  const float mul = p.scale * kLog2e;  // without a softcap
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < NP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = p.softcap > 0.f ? capped(s[n][e], p) * kLog2e
                                : s[n][e] * mul;
      const int key = key0 + n * 8 + lane % 4 * 2 + (e & 1);
      if (edge && !visible(key, q0 + (e >> 1) * 8, p)) x = -CUDART_INF_F;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

// the running maximum m and sum l of each row and the accumulator acc
// moved to the new maximum, and s to P = exp2(s - maximum), added to l
template <int NP, int DT>
__device__ __forceinline__ void online_softmax(float (&s)[NP][4],
                                               const float (&mx)[2],
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[DT][4]) {
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    base[h] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no key seen yet
    const float corr = exp2f(m[h] - base[h]);
    m[h] = m_new;
    l[h] *= corr;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][2 * h] *= corr;
      acc[d][2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int n = 0; n < NP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2f(s[n][e] - base[e >> 1]);
      l[e >> 1] += s[n][e];
    }
  }
}

// the forward's end: the thread's rows i and i + 8 of the (b, h, g)
// stream at lse row row0, those below Tq, get acc over their sum, in T,
// and their lse
template <typename T, int DT>
__device__ __forceinline__ void finish_fwd(const Params& p, long long row0,
                                           int i, const float (&acc)[DT][4],
                                           const float (&m)[2],
                                           const float (&l)[2]) {
  constexpr int HD = DT * 8;
  T* og = static_cast<T*>(p.out) + row0 * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    if (i + h * 8 >= p.Tq) continue;
    store_band(og + (long long)(i + h * 8) * HD, acc, h, 1.f / sum);
    if (threadIdx.x % 4 == 0)
      p.lse[row0 + i + h * 8] = m[h] * kLn2 + logf(sum);
  }
}

template <int HD>
constexpr int fwd_smem() { return 5 * kRows * kPitch<HD> * 2; }

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_tc_kernel(
    const Params p) {
  constexpr int P = kPitch<HD>, KS = HD / 16, DT = HD / 8, NT = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + kRows * P;
  const QBlock b(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = warp * 16 + lane / 4;  // this thread's rows: r_lo, +8
  const bf16* kg = static_cast<const bf16*>(p.k) + b.kv * p.Tk * HD;
  const bf16* vg = static_cast<const bf16*>(p.v) + b.kv * p.Tk * HD;
  load_rows<HD, kRows>(q_s, static_cast<const bf16*>(p.q) + b.row0 * HD,
                       b.i0, p.Tq);
  load_kv<HD>(kv_s, kg, vg, 0, b.t_lo, p.Tk);
  cp_async_commit();
  constexpr bool kLean = HD > 128;     // Q fragments read at every tile
  uint32_t qf[KS][4];
  float acc[DT][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int t = b.t_lo; t <= b.t_hi; ++t) {
    const int st = (t - b.t_lo) & 1;
    if (t < b.t_hi) load_kv<HD>(kv_s, kg, vg, st ^ 1, t + 1, p.Tk);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) have landed
    __syncthreads();
    if (!kLean && t == b.t_lo) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_a<P>(qf[kk], q_s, warp * 16, kk * 16);
    }
    const bf16* k_s = kv_s + st * 2 * kBK * P;
    const bf16* v_s = k_s + kBK * P;
    const bool edge = b.edge(t, p);
    // at head_dim 256 the tile's 64 keys are scored in two halves, so that
    // the score tile fits in registers beside the accumulator
    constexpr int PARTS = kLean ? 2 : 1, NP = NT / PARTS;
#pragma unroll 1
    for (int part = 0; part < PARTS; ++part) {
      const int kb = part * NP * 8;  // the part's first key in the tile
      float s[NP][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4];
        if constexpr (kLean) {
          ldsm_a<P>(qa, q_s, warp * 16, kk * 16);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        }
#pragma unroll
        for (int n = 0; n < NP; n += 2) {
          uint32_t f[4];
          ldsm_b<P>(f, k_s, kb + n * 8, kk * 16);
          mma16816(s[n], qa, f[0], f[1]);
          mma16816(s[n + 1], qa, f[2], f[3]);
        }
      }
      float mx[2];
      log2_scores(s, mx, t * kBK + kb, b.q_first + r_lo, edge, p);
      online_softmax(s, mx, m, l, acc);
      // O += P V, P from registers, 16 keys a step
#pragma unroll
      for (int kk = 0; kk < NP / 2; ++kk) {
        uint32_t a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t f[4];
          ldsm_bt<P>(f, v_s, kb + kk * 16, d * 8);
          mma16816(acc[d], a, f[0], f[1]);
          mma16816(acc[d + 1], a, f[2], f[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed before tile t + 2 refills it
  }
  finish_fwd<bf16>(p, b.row0, b.i0 + r_lo, acc, m, l);
}

template <int HD>
constexpr int dq_smem() {
  return 6 * kRows * kPitch<HD> * 2 + 2 * kRows * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(
    const Params p) {
  constexpr int P = kPitch<HD>, KS = HD / 16, DT = HD / 8, NT = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kRows * P;
  bf16* kv_s = do_s + kRows * P;
  float* lse_s = reinterpret_cast<float*>(kv_s + 4 * kBK * P);  // log2 e
  float* dl_s = lse_s + kRows;
  const QBlock b(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = warp * 16 + lane / 4;
  const bf16* kg = static_cast<const bf16*>(p.k) + b.kv * p.Tk * HD;
  const bf16* vg = static_cast<const bf16*>(p.v) + b.kv * p.Tk * HD;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b.row0 * HD;
  load_rows<HD, kRows>(q_s, static_cast<const bf16*>(p.q) + b.row0 * HD,
                       b.i0, p.Tq);
  load_rows<HD, kRows>(do_s, dog, b.i0, p.Tq);
  load_kv<HD>(kv_s, kg, vg, 0, b.t_lo, p.Tk);
  cp_async_commit();
  {
    // delta = rowsum(dO * O), two threads a row, while the tiles land
    const int r = threadIdx.x / 2, i = b.i0 + r;
    const long long at = (long long)i * HD + threadIdx.x % 2 * (HD / 2);
    float dl = 0.f;
    if (i < p.Tq) {
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const uint4 o4 = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(p.o) + b.row0 * HD + at + c * 8);
        const uint4 d4 = *reinterpret_cast<const uint4*>(dog + at + c * 8);
        const bf16* oe = reinterpret_cast<const bf16*>(&o4);
        const bf16* de = reinterpret_cast<const bf16*>(&d4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dl = fmaf(__bfloat162float(de[j]), __bfloat162float(oe[j]), dl);
      }
    }
    dl += __shfl_xor_sync(kAll, dl, 1);
    if (threadIdx.x % 2 == 0) {
      dl_s[r] = dl;
      lse_s[r] = i < p.Tq ? p.lse[b.row0 + i] * kLog2e : 0.f;
      if (i < p.Tq) p.delta[b.row0 + i] = dl;
    }
  }
  float dq[DT][4] = {};
  for (int t = b.t_lo; t <= b.t_hi; ++t) {
    const int st = (t - b.t_lo) & 1;
    if (t < b.t_hi) load_kv<HD>(kv_s, kg, vg, st ^ 1, t + 1, p.Tk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + st * 2 * kBK * P;
    const bf16* v_s = k_s + kBK * P;
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_a<P>(qa, q_s, warp * 16, kk * 16);
      ldsm_a<P>(da, do_s, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t f[4];
        ldsm_b<P>(f, k_s, n * 8, kk * 16);
        mma16816(s[n], qa, f[0], f[1]);
        mma16816(s[n + 1], qa, f[2], f[3]);
        ldsm_b<P>(f, v_s, n * 8, kk * 16);
        mma16816(dp[n], da, f[0], f[1]);
        mma16816(dp[n + 1], da, f[2], f[3]);
      }
    }
    // dS = P * (dP - delta) * d(capped)/d(dot), P = exp(capped - lse)
    const bool edge = b.edge(t, p);
    const float lse2[2] = {lse_s[r_lo], lse_s[r_lo + 8]};
    const float dl[2] = {dl_s[r_lo], dl_s[r_lo + 8]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float sc = capped(s[n][e], p);
        float ds = 0.f;
        if (!edge || visible(t * kBK + n * 8 + lane % 4 * 2 + (e & 1),
                             b.q_first + r_lo + h * 8, p))
          ds = exp2f(sc * kLog2e - lse2[h]) * (dp[n][e] - dl[h]) *
               capped_grad(sc, p);
        s[n][e] = ds;
      }
    }
    // dQ += dS K, dS from registers, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t f[4];
        ldsm_bt<P>(f, k_s, kk * 16, d * 8);
        mma16816(dq[d], a, f[0], f[1]);
        mma16816(dq[d + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();
  }
  bf16* dqg = static_cast<bf16*>(p.dq) + b.row0 * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = b.i0 + r_lo + h * 8;
    if (i < p.Tq) store_band(dqg + (long long)i * HD, dq, h, 1.f);
  }
}

// query rows per staged tile of the dK/dV kernel: its dK and dV
// accumulators grow with hd, so the scores' shrink at hd 128
template <int HD>
constexpr int kDkvRows = HD > 64 ? 32 : 64;

template <int HD>
constexpr int dkv_smem() {
  constexpr int BQ = kDkvRows<HD>;
  return (2 * kRows + 4 * BQ) * kPitch<HD> * 2 + 4 * BQ * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(
    const Params p) {
  constexpr int P = kPitch<HD>, KS = HD / 16, DT = HD / 8;
  constexpr int BQ = kDkvRows<HD>, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kRows * P;
  bf16* qd_s = v_s + kRows * P;  // stage s: q at 2 s BQ P, dO after it
  float* lse_s = reinterpret_cast<float*>(qd_s + 4 * BQ * P);  // 2 stages
  float* dl_s = lse_s + 2 * BQ;
  const int G = p.G, Tq = p.Tq, Tk = p.Tk, off = Tk - Tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = (long long)blockIdx.z * p.Hkv + blockIdx.y;
  const int j0 = blockIdx.x * kRows, j1 = min(j0 + kRows, Tk);
  const int key = j0 + warp * 16 + lane / 4;  // this thread's keys: +0, +8
  // the query rows that see a key of this tile, in tiles of BQ, per head
  const int i_lo = p.causal ? max(0, j0 - off) : 0;
  const int i_hi = p.window > 0 ? min(Tq - 1, j1 - 2 + p.window - off)
                                : Tq - 1;
  const int n_qt = i_hi >= i_lo ? (i_hi - i_lo) / BQ + 1 : 0;
  const long long row0 = bh * G * Tq;  // lse row of (b, h, 0, 0)
  const bf16* qg = static_cast<const bf16*>(p.q) + row0 * HD;
  const bf16* dog = static_cast<const bf16*>(p.dout) + row0 * HD;
  auto load_q = [&](int st, int it) {
    const int g = it / n_qt, i0 = i_lo + (it - g * n_qt) * BQ;
    bf16* qs = qd_s + st * 2 * BQ * P;
    load_rows<HD, BQ>(qs, qg + (long long)g * Tq * HD, i0, Tq);
    load_rows<HD, BQ>(qs + BQ * P, dog + (long long)g * Tq * HD, i0, Tq);
    if (threadIdx.x < BQ) {
      const int i = i0 + threadIdx.x;
      const long long r = row0 + (long long)g * Tq + min(i, Tq - 1);
      cp_async4(lse_s + st * BQ + threadIdx.x, p.lse + r, i < Tq);
      cp_async4(dl_s + st * BQ + threadIdx.x, p.delta + r, i < Tq);
    }
  };
  load_rows<HD, kRows>(k_s, static_cast<const bf16*>(p.k) + bh * Tk * HD,
                       j0, Tk);
  load_rows<HD, kRows>(v_s, static_cast<const bf16*>(p.v) + bh * Tk * HD,
                       j0, Tk);
  if (n_qt > 0) load_q(0, 0);
  cp_async_commit();
  float dk[DT][4] = {}, dv[DT][4] = {};
  for (int it = 0; it < G * n_qt; ++it) {
    const int st = it & 1;
    if (it + 1 < G * n_qt) load_q(st ^ 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i0 = i_lo + it % n_qt * BQ;
    const bf16* q_s = qd_s + st * 2 * BQ * P;
    const bf16* do_s = q_s + BQ * P;
    const float* ls = lse_s + st * BQ;
    const float* dls = dl_s + st * BQ;
    // S^T = K Q^T and dP^T = V dO^T, rows are this warp's 16 keys
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_a<P>(ka, k_s, warp * 16, kk * 16);
      ldsm_a<P>(va, v_s, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t f[4];
        ldsm_b<P>(f, q_s, n * 8, kk * 16);
        mma16816(s[n], ka, f[0], f[1]);
        mma16816(s[n + 1], ka, f[2], f[3]);
        ldsm_b<P>(f, do_s, n * 8, kk * 16);
        mma16816(dp[n], va, f[0], f[1]);
        mma16816(dp[n + 1], va, f[2], f[3]);
      }
    }
    const bool edge = i0 + BQ > Tq || j0 + kRows > Tk ||
                      (p.causal && j0 + kRows - 1 > i0 + off) ||
                      (p.window > 0 &&
                       j0 <= min(i0 + BQ, Tq) - 1 + off - p.window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + lane % 4 * 2 + (e & 1);  // query row in tile
        const float sc = capped(s[n][e], p);
        float pr = 0.f, ds = 0.f;
        if (!edge || (i0 + c < Tq &&
                      visible(key + (e >> 1) * 8, i0 + c + off, p))) {
          pr = exp2f((sc - ls[c]) * kLog2e);
          ds = pr * (dp[n][e] - dls[c]) * capped_grad(sc, p);
        }
        s[n][e] = pr;
        dp[n][e] = ds;
      }
    }
    // dV += P^T dO and dK += dS^T Q, from registers, 16 query rows a step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t f[4];
        ldsm_bt<P>(f, do_s, kk * 16, d * 8);
        mma16816(dv[d], pa, f[0], f[1]);
        mma16816(dv[d + 1], pa, f[2], f[3]);
        ldsm_bt<P>(f, q_s, kk * 16, d * 8);
        mma16816(dk[d], da, f[0], f[1]);
        mma16816(dk[d + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy outlives the block (n_qt may be 0)
  bf16* dkg = static_cast<bf16*>(p.dk) + bh * Tk * HD;
  bf16* dvg = static_cast<bf16*>(p.dv) + bh * Tk * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key + h * 8;
    if (j >= Tk) continue;
    store_band(dkg + (long long)j * HD, dk, h, 1.f);
    store_band(dvg + (long long)j * HD, dv, h, 1.f);
  }
}

// ---------------------------------------------------------------------------
// The backward at head_dim 192 and 256, for Hopper (hopper.cuh). A warp's
// 16 x HD float32 accumulator is HD / 2 registers a thread, so a block
// splits its two accumulators (dK and dV; or dQ's columns) over two
// consumer warpgroups of 4 warps, each holding one, and a third
// warpgroup, the producer, feeds both: 384 threads, one block an SM.
//  * The producer drops to 24 registers a thread (setmaxnreg) and one of
//    its threads issues the TMA loads of whole 64-row tiles (HD / 64 boxes
//    of 64 x 64, 128-byte swizzle; rows past T read as zeros) into a ring
//    of stages, each completing on an mbarrier (`full`); the consumers
//    rise to 240 registers and give a stage back on another (`empty`), so
//    the next tiles land while the present one is computed.
//  * The products are wgmma over those tiles: a 64-row product reads each
//    B tile from shared memory once (mma.sync's 16-row bands read it four
//    times). P and dS go from the accumulators of S and dP, packed to
//    bf16 in registers, into the next product as its A operand; dQ's dS
//    through a bf16 tile in shared memory, which both consumers read.
//  * dK/dV: one block per (b, kv head, 64-key tile), a kv head's tiles
//    together (its Q and dO stay in L2), the first key tiles (which see the
//    most queries) first. Its K and V tiles load once; each stage holds a
//    64-row tile of Q and of dO, for each of the G heads in turn, with
//    their lse and delta (stored by the producer warp's lanes, read before
//    the stage is free, as rows of lse are not 16-byte aligned for TMA).
//    Consumer 0: S^T = K Q^T, P = exp(s - lse) on the visible pairs,
//    P d(capped)/d(dot) handed to consumer 1 in float32 through shared
//    memory laid out [warp][n][e][lane] (no bank conflict on either side),
//    dV += P^T dO. Consumer 1: dP^T = V dO^T, dS^T = P d(capped)/d(dot)
//    (dP^T - delta), dK += dS^T Q. Named barriers (bar.arrive on one side,
//    bar.sync on the other) order the hand-over.
//  * dQ: one block per (b, query head, 64-query tile), a kv head's G query
//    heads' tiles together, the last tiles first; its Q and dO tiles load
//    once, and its consumers first form delta = rowsum(dO * O) for the
//    dK/dV kernel, which runs after it on the stream. Each stage holds a 64-key tile of K and V. Consumer 0:
//    S = Q K^T and P d(capped)/d(dot), handed over as above; consumer 1:
//    dP = dO V^T, then dS, rounded to bf16 into one of two swizzled 64 x 64
//    tiles; then each adds dS K into its columns of dQ (0-127, and the
//    rest: 128-255 at 256, 128-191 at 192, whole 64-column chunks).
// The two kernels do seven products a visible pair (S twice, dP twice,
// dV, dK, dQ) where the bound counts five: the split keeps every output
// element with one owner (no atomics, deterministic) at the cost of
// recomputing S and dP. Bound: operations (the header's ~295 flop/byte);
// what a stage is held by besides: consumer 0's elementwise pass between
// its two products (branch-free, no division, its loads before the
// hand-over's stores), and the 64 KB each stage loads (48 KB at 192), in
// a ring two stages deep at 256 and three at 192.
// ---------------------------------------------------------------------------
constexpr int kHopThreads = 384;  // a producer warpgroup and two consumers
constexpr int kConsumers = 256;   // threads of the two consumer warpgroups
constexpr int kHand = 4 * (kBK / 8) * 4 * 32;  // handed-over floats, 16 KB
// named barriers of the consumers (0 is __syncthreads)
constexpr int kBarHandFull = 1, kBarHandFree = 2, kBarDs = 3, kBarDelta = 4,
              kBarEnd = 5;

// the 4 operand and 3 gradient tensors as (hd, T, heads) maps of 64 x 64
// boxes, and the call; passed by value into the kernel's parameter space
// (TMA reads the maps there)
struct HopArgs {
  CUtensorMap q, k, v, dout, dq, dk, dv;
  Params p;
};

template <int HD>
struct HopTiles {
  static constexpr int kTile = HD / kBox * kChunkBytes;  // 64 x HD bf16
  static constexpr int kStages = HD == 256 ? 2 : 3;      // ring depth
};

// dK/dV shared memory, byte offsets from a 1024-aligned base: K, V, the
// ring's stages (Q then dO), the hand-over, lse (times log2 e) and delta
// of each stage, then the barriers (K/V, full[S], empty[S])
template <int HD>
struct DkvSmem : HopTiles<HD> {
  using H = HopTiles<HD>;
  static constexpr int kK = 0, kV = H::kTile, kRing = 2 * H::kTile;
  static constexpr int kHandAt = kRing + 2 * H::kStages * H::kTile;
  static constexpr int kLse = kHandAt + kHand * 4;
  static constexpr int kDl = kLse + H::kStages * kRows * 4;
  static constexpr int kBars = kDl + H::kStages * kRows * 4;
  static constexpr int kBytes = kBars + (1 + 2 * H::kStages) * 8 + 1024;
};

// dQ shared memory: Q, dO, the ring's stages (K then V), two dS tiles,
// the hand-over, lse (times log2 e) and delta, then the barriers (Q/dO,
// full[S], empty[S])
template <int HD>
struct DqSmem : HopTiles<HD> {
  using H = HopTiles<HD>;
  static constexpr int kQ = 0, kDo = H::kTile, kRing = 2 * H::kTile;
  static constexpr int kDs = kRing + 2 * H::kStages * H::kTile;
  static constexpr int kHandAt = kDs + 2 * kChunkBytes;
  static constexpr int kLse = kHandAt + kHand * 4;
  static constexpr int kDl = kLse + kRows * 4;
  static constexpr int kBars = kDl + kRows * 4;
  static constexpr int kBytes = kBars + (1 + 2 * H::kStages) * 8 + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + (1024 - smem_addr(p) % 1024) % 1024;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A dot product's capped score and d(capped)/d(dot), with no division or
// library call an element: the softcap's presence is a template argument,
// chosen once a tile, and tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1), which is
// exact at both ends and within ~1e-7 of tanhf in between.
struct Capper {
  float scale, cap, t2;  // t2 = 2 log2(e) scale / cap
  __device__ explicit Capper(const Params& p)
      : scale(p.scale), cap(p.softcap),
        t2(p.softcap > 0.f ? 2.f * kLog2e * p.scale / p.softcap : 0.f) {}

  template <bool CAP>
  __device__ __forceinline__ void apply(float dot, float& sc,
                                        float& cg) const {
    if constexpr (CAP) {
      const float u = 1.f - 2.f * rcp_approx(ex2_approx(t2 * dot) + 1.f);
      sc = cap * u;
      cg = (1.f - u * u) * scale;
    } else {
      sc = dot * scale;
      cg = scale;
    }
  }
};

// dK/dV's consumer 0 on its S^T tile (rows keys from `key`, columns the
// queries from i0): P = exp(capped - lse) into s, P d(capped)/d(dot) into
// the hand-over; MASK on a tile with a hidden pair
template <bool CAP, bool MASK>
__device__ __forceinline__ void dkv_probs(float (&s)[32], float* hand,
                                          const float* ls, const Capper& cp,
                                          const Params& p, int key, int i0,
                                          int lane) {
  const int off = p.Tk - p.Tq;
  // the columns' lse first: read between the hand-over's stores, which
  // the compiler cannot tell apart from them, each load would wait
  float lsv[kBK / 8][2];
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) lsv[n][j] = ls[n * 8 + lane % 4 * 2 + j];
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + lane % 4 * 2 + (e & 1);  // query in tile
      float sc, cg;
      cp.apply<CAP>(s[4 * n + e], sc, cg);
      float pr = ex2_approx(sc * kLog2e - lsv[n][e & 1]);
      if (MASK && !(i0 + c < p.Tq &&
                    visible(key + (e >> 1) * 8, i0 + c + off, p)))
        pr = 0.f;
      s[4 * n + e] = pr;
      hand[(4 * n + e) * 32] = pr * cg;
    }
  }
}

// dQ's consumer 0 on its S tile (rows the queries at positions q0, q0 + 8,
// columns the keys from k0): P d(capped)/d(dot) into the hand-over
template <bool CAP, bool MASK>
__device__ __forceinline__ void dq_probs(const float (&s)[32], float* hand,
                                         const float (&lse2)[2],
                                         const Capper& cp, const Params& p,
                                         int k0, int q0, int lane) {
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sc, cg;
      cp.apply<CAP>(s[4 * n + e], sc, cg);
      float pg = ex2_approx(sc * kLog2e - lse2[e >> 1]) * cg;
      if (MASK && !visible(k0 + n * 8 + lane % 4 * 2 + (e & 1),
                           q0 + (e >> 1) * 8, p))
        pg = 0.f;
      hand[(4 * n + e) * 32] = pg;
    }
  }
}

// the 64 x 64 S or dP tile of 64 rows of a_tile against 64 of b_tile
template <int HD>
__device__ __forceinline__ void tile_scores(float (&s)[32],
                                            const unsigned char* a_tile,
                                            const unsigned char* b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<0>(s, desc_k(a_tile, kk), desc_k(b_tile, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// ROLE 0: S^T, P and dV; ROLE 1: dP^T, dS^T and dK; over n_it stages (G
// heads x n_qt query tiles from i_lo)
template <int HD, int ROLE>
__device__ __forceinline__ void dkv_consumer(const Params p,
                                             const CUtensorMap* out,
                                             unsigned char* sm, int j0,
                                             long long bh, int i_lo,
                                             int n_qt, int n_it) {
  using L = DkvSmem<HD>;
  constexpr int S = L::kStages, T = L::kTile;
  const int tid = threadIdx.x - 128 * (1 + ROLE);
  const int warp = tid / 32, lane = tid % 32;
  const int Tq = p.Tq, Tk = p.Tk, off = Tk - Tq;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + S;
  float* hand = reinterpret_cast<float*>(sm + L::kHandAt) +
                warp * (kBK / 8) * 4 * 32 + lane;
  const unsigned char* a_tile = sm + (ROLE == 0 ? L::kK : L::kV);
  const int key = j0 + warp * 16 + lane / 4;  // this thread's keys: +0, +8
  float acc[HD / 2];                          // dV or dK
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  if (n_it > 0) mbar_wait(bars, 0);           // K and V
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S;
    mbar_wait(full + st, it / S & 1);
    const unsigned char* q_s = sm + L::kRing + 2 * st * T;
    const unsigned char* do_s = q_s + T;
    const int i0 = i_lo + it % n_qt * kRows;
    float s[32];  // S^T or dP^T: rows the warp's keys, columns queries
    tile_scores<HD>(s, a_tile, ROLE == 0 ? q_s : do_s);
    if constexpr (ROLE == 0) {
      const Capper cp(p);
      const float* ls = reinterpret_cast<const float*>(sm + L::kLse) +
                        st * kRows;
      const bool edge = i0 + kRows > Tq || j0 + kRows > Tk ||
                        (p.causal && j0 + kRows - 1 > i0 + off) ||
                        (p.window > 0 &&
                         j0 <= min(i0 + kRows, Tq) - 1 + off - p.window);
      if (it > 0) named_sync(kBarHandFree, kConsumers);  // hand was read
      if (edge) {
        if (cp.cap > 0.f)
          dkv_probs<true, true>(s, hand, ls, cp, p, key, i0, lane);
        else
          dkv_probs<false, true>(s, hand, ls, cp, p, key, i0, lane);
      } else {
        if (cp.cap > 0.f)
          dkv_probs<true, false>(s, hand, ls, cp, p, key, i0, lane);
        else
          dkv_probs<false, false>(s, hand, ls, cp, p, key, i0, lane);
      }
      named_arrive(kBarHandFull, kConsumers);
    } else {
      const float* dls = reinterpret_cast<const float*>(sm + L::kDl) +
                         st * kRows;
      named_sync(kBarHandFull, kConsumers);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * n + e] = hand[(4 * n + e) * 32] *
                         (s[4 * n + e] - dls[n * 8 + lane % 4 * 2 + (e & 1)]);
      if (it + 1 < n_it) named_arrive(kBarHandFree, kConsumers);
    }
    // dV += P^T dO or dK += dS^T Q, 16 query rows a step, A from registers
    uint32_t fa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        fa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    const unsigned char* o_tile = ROLE == 0 ? do_s : q_s;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<1>(acc, fa[kk], desc_mn(o_tile, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  // the accumulator out through shared memory and TMA (rows past Tk are
  // not written): once both consumers are done with every stage, stage
  // 0's Q tile holds dV and its dO tile dK
  named_sync(kBarEnd, kConsumers);
  unsigned char* tile = sm + L::kRing + ROLE * T;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair_sw128(tile, warp * 16 + lane / 4 + h * 8,
                       n * 8 + lane % 4 * 2,
                       pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]));
  fence_async_smem();
  named_sync(kBarEnd, kConsumers);
  if (tid == 0) {
    for (int c = 0; c < HD / kBox; ++c)
      tma_store_3d(out, tile + c * kChunkBytes, c * kBox, j0,
                   static_cast<int>(bh));
    bulk_commit_and_wait();
  }
}

template <int HD>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_bwd_dkv_hopper_kernel(const __grid_constant__ HopArgs a) {
  using L = DkvSmem<HD>;
  constexpr int S = L::kStages, T = L::kTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  // a copy in registers: read through a reference, the parameter space
  // would be reloaded after every shared-memory store
  const Params p = a.p;
  const int G = p.G, Tq = p.Tq, Tk = p.Tk, off = Tk - Tq;
  // a kv head's key tiles together (its Q and dO stay in L2), the first
  // (the most queries under a causal mask) first
  const int n_kt = (Tk + kRows - 1) / kRows;
  const int j0 = blockIdx.x % n_kt * kRows, j1 = min(j0 + kRows, Tk);
  const long long bh = blockIdx.x / n_kt;
  // the query rows that see a key of this tile, in tiles of 64, per head
  const int i_lo = p.causal ? max(0, j0 - off) : 0;
  const int i_hi = p.window > 0 ? min(Tq - 1, j1 - 2 + p.window - off)
                                : Tq - 1;
  const int n_qt = i_hi >= i_lo ? (i_hi - i_lo) / kRows + 1 : 0;
  const int n_it = G * n_qt;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 1 + s, 32);     // the producer warp's lanes
      mbar_init(bars + 1 + S + s, 8);  // the consumers' warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32 || n_it == 0) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(bars, 2 * T);
      for (int c = 0; c < HD / kBox; ++c) {
        tma_load_3d(sm + L::kK + c * kChunkBytes, &a.k, bars, c * kBox, j0,
                    static_cast<int>(bh));
        tma_load_3d(sm + L::kV + c * kChunkBytes, &a.v, bars, c * kBox, j0,
                    static_cast<int>(bh));
      }
    }
    float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
    float* dl_s = reinterpret_cast<float*>(sm + L::kDl);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % S;
      const int head = static_cast<int>(bh) * G + it / n_qt;
      const int i0 = i_lo + it % n_qt * kRows;
      // the stage's lse and delta, read while the stage is still in use
      float lv[kRows / 32], dv[kRows / 32];
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) {
        const int i = i0 + lane + 32 * u;
        const long long row = (long long)head * Tq + i;
        lv[u] = i < Tq ? p.lse[row] * kLog2e : 0.f;
        dv[u] = i < Tq ? p.delta[row] : 0.f;
      }
      mbar_wait(bars + 1 + S + st, (it / S & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bars + 1 + st, 2 * T);
        unsigned char* q_s = sm + L::kRing + 2 * st * T;
        for (int c = 0; c < HD / kBox; ++c) {
          tma_load_3d(q_s + c * kChunkBytes, &a.q, bars + 1 + st, c * kBox,
                      i0, head);
          tma_load_3d(q_s + T + c * kChunkBytes, &a.dout, bars + 1 + st,
                      c * kBox, i0, head);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) {
        lse_s[st * kRows + lane + 32 * u] = lv[u];
        dl_s[st * kRows + lane + 32 * u] = dv[u];
      }
      mbar_arrive(bars + 1 + st);
    }
  } else {
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      dkv_consumer<HD, 0>(p, &a.dv, sm, j0, bh, i_lo, n_qt, n_it);
    else
      dkv_consumer<HD, 1>(p, &a.dk, sm, j0, bh, i_lo, n_qt, n_it);
  }
}

// The 64-query tile of a dQ block and the key tiles it sees: a query
// head's tiles together (the G heads of a kv head next to each other, so
// its K and V stay in L2), the last (the most keys) first.
struct HopQTile {
  long long head;  // (B, Hkv, G) query head
  int i0, q_first, q_last, t_lo, t_hi;

  __device__ HopQTile(const Params& p) {
    const int n_tiles = (p.Tq + kRows - 1) / kRows;
    head = blockIdx.x / n_tiles;
    i0 = (n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles)) * kRows;
    const int off = p.Tk - p.Tq;
    q_first = i0 + off;
    q_last = min(i0 + kRows, p.Tq) - 1 + off;
    const int k_hi = p.causal ? min(p.Tk - 1, q_last) : p.Tk - 1;
    const int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
    t_lo = k_lo / kBK;
    t_hi = k_hi / kBK;
  }

  // whether some (row, key) pair of key tile t is masked
  __device__ bool edge(int t, const Params& p) const {
    const int k0 = t * kBK;
    return k0 + kBK > p.Tk || (p.causal && k0 + kBK - 1 > q_first) ||
           (p.window > 0 && k0 <= q_last - p.window);
  }
};

// ROLE 0: S and P d(capped)/d(dot), then dQ's columns 0-127; ROLE 1: dP
// and dS, then dQ's columns 128 .. HD - 1
template <int HD, int ROLE>
__device__ __forceinline__ void dq_consumer(const Params p,
                                            const CUtensorMap* out,
                                            unsigned char* sm,
                                            const HopQTile& b) {
  using L = DqSmem<HD>;
  constexpr int S = L::kStages, T = L::kTile;
  constexpr int C0 = ROLE == 0 ? 0 : 128, N = ROLE == 0 ? 128 : HD - 128;
  const int tid = threadIdx.x - 128 * (1 + ROLE);
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4;  // this thread's rows: +0, +8
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + S;
  float* hand = reinterpret_cast<float*>(sm + L::kHandAt) +
                warp * (kBK / 8) * 4 * 32 + lane;
  const float* lse_s = reinterpret_cast<const float*>(sm + L::kLse);
  const float* dl_s = reinterpret_cast<const float*>(sm + L::kDl);
  const float lse2[2] = {lse_s[r_lo], lse_s[r_lo + 8]};
  const float dl[2] = {dl_s[r_lo], dl_s[r_lo + 8]};
  float dq[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dq[i] = 0.f;
  mbar_wait(bars, 0);  // Q and dO
  for (int t = b.t_lo; t <= b.t_hi; ++t) {
    const int it = t - b.t_lo, st = it % S;
    mbar_wait(full + st, it / S & 1);
    const unsigned char* k_s = sm + L::kRing + 2 * st * T;
    unsigned char* ds_s = sm + L::kDs + (it & 1) * kChunkBytes;
    float s[32];  // S or dP: rows the warp's queries, columns keys
    tile_scores<HD>(s, sm + (ROLE == 0 ? L::kQ : L::kDo),
                    ROLE == 0 ? k_s : k_s + T);
    if constexpr (ROLE == 0) {
      const Capper cp(p);
      const int k0 = t * kBK, q0 = b.q_first + r_lo;
      if (b.edge(t, p)) {
        if (cp.cap > 0.f)
          dq_probs<true, true>(s, hand, lse2, cp, p, k0, q0, lane);
        else
          dq_probs<false, true>(s, hand, lse2, cp, p, k0, q0, lane);
      } else {
        if (cp.cap > 0.f)
          dq_probs<true, false>(s, hand, lse2, cp, p, k0, q0, lane);
        else
          dq_probs<false, false>(s, hand, lse2, cp, p, k0, q0, lane);
      }
      named_arrive(kBarHandFull, kConsumers);
    } else {
      // dS = P d(capped)/d(dot) (dP - delta), as bf16 into the swizzled
      // K-major dS tile: (r, c) at r * 128 + ((c / 8) ^ (r % 8)) * 16 + ...
      named_sync(kBarHandFull, kConsumers);
      float pg[32];  // all loads before the first store (see dkv_probs)
#pragma unroll
      for (int i = 0; i < 32; ++i) pg[i] = hand[i * 32];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = pg[4 * n + e] * (s[4 * n + e] - dl[e >> 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + h * 8;
          *reinterpret_cast<uint32_t*>(ds_s + r * 128 +
                                       ((n ^ (r % 8)) << 4) + lane % 4 * 4) =
              pack_bf16(ds[2 * h], ds[2 * h + 1]);
        }
      }
      fence_async_smem();  // the stores, before wgmma reads the tile
    }
    named_sync(kBarDs, kConsumers);  // dS is whole; the hand-over was read
    // dQ[:, C0 : C0 + N] += dS K, 16 keys a step, K as the MN-major B
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss<1>(dq, desc_k(ds_s, kk),
                  desc_mn(k_s + C0 / kBox * kChunkBytes, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  // dQ out through shared memory and TMA (rows past Tq are not written):
  // once both consumers are done with every stage, the Q tile holds it
  named_sync(kBarEnd, kConsumers);
  unsigned char* tile = sm + L::kQ;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      store_pair_sw128(tile, r_lo + h * 8, C0 + n * 8 + lane % 4 * 2,
                       pack_bf16(dq[4 * n + 2 * h], dq[4 * n + 2 * h + 1]));
  fence_async_smem();
  named_sync(kBarEnd, kConsumers);
  if (tid == 0) {
    for (int c = C0 / kBox; c < (C0 + N) / kBox; ++c)
      tma_store_3d(out, tile + c * kChunkBytes, c * kBox, b.i0,
                   static_cast<int>(b.head));
    bulk_commit_and_wait();
  }
}

template <int HD>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_bwd_dq_hopper_kernel(const __grid_constant__ HopArgs a) {
  using L = DqSmem<HD>;
  constexpr int S = L::kStages, T = L::kTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  // a copy in registers: read through a reference, the parameter space
  // would be reloaded after every shared-memory store
  const Params p = a.p;
  const HopQTile b(p);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 1 + s, 1);      // the producer's TMA thread
      mbar_init(bars + 1 + S + s, 8);  // the consumers' warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    const int head = static_cast<int>(b.head);
    const int kv = head / p.G;
    mbar_arrive_expect_tx(bars, 2 * T);
    for (int c = 0; c < HD / kBox; ++c) {
      tma_load_3d(sm + L::kQ + c * kChunkBytes, &a.q, bars, c * kBox, b.i0,
                  head);
      tma_load_3d(sm + L::kDo + c * kChunkBytes, &a.dout, bars, c * kBox,
                  b.i0, head);
    }
    for (int t = b.t_lo; t <= b.t_hi; ++t) {
      const int it = t - b.t_lo, st = it % S;
      mbar_wait(bars + 1 + S + st, (it / S & 1) ^ 1);
      mbar_arrive_expect_tx(bars + 1 + st, 2 * T);
      unsigned char* k_s = sm + L::kRing + 2 * st * T;
      for (int c = 0; c < HD / kBox; ++c) {
        tma_load_3d(k_s + c * kChunkBytes, &a.k, bars + 1 + st, c * kBox,
                    t * kBK, kv);
        tma_load_3d(k_s + T + c * kChunkBytes, &a.v, bars + 1 + st,
                    c * kBox, t * kBK, kv);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    {
      // delta = rowsum(dO * O), four threads a row, while the tiles land
      constexpr int W = HD / 4;
      const int tid = threadIdx.x - 128, r = tid / 4, i = b.i0 + r;
      const long long row = b.head * p.Tq + i;
      float d = 0.f;
      if (i < p.Tq) {
        const bf16* o = static_cast<const bf16*>(p.o) + row * HD + tid % 4 * W;
        const bf16* g = static_cast<const bf16*>(p.dout) + row * HD +
                        tid % 4 * W;
#pragma unroll
        for (int c = 0; c < W / 8; ++c) {
          const uint4 o4 = *reinterpret_cast<const uint4*>(o + c * 8);
          const uint4 d4 = *reinterpret_cast<const uint4*>(g + c * 8);
          const bf16* oe = reinterpret_cast<const bf16*>(&o4);
          const bf16* de = reinterpret_cast<const bf16*>(&d4);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            d = fmaf(__bfloat162float(de[j]), __bfloat162float(oe[j]), d);
        }
      }
      d += __shfl_xor_sync(kAll, d, 1);
      d += __shfl_xor_sync(kAll, d, 2);
      if (tid % 4 == 0) {
        reinterpret_cast<float*>(sm + L::kDl)[r] = d;
        reinterpret_cast<float*>(sm + L::kLse)[r] =
            i < p.Tq ? p.lse[row] * kLog2e : 0.f;
        if (i < p.Tq) p.delta[row] = d;
      }
      named_sync(kBarDelta, kConsumers);
    }
    if (threadIdx.x < 256)
      dq_consumer<HD, 0>(p, &a.dq, sm, b);
    else
      dq_consumer<HD, 1>(p, &a.dq, sm, b);
  }
}

// ---------------------------------------------------------------------------
// The float32 split kernels, on mma.sync as the bf16 kernels up to
// head_dim 128 (see the header for the split and why three terms). Each
// block stages its streamed tiles as float32 by 16-byte cp.async (one
// stage: the next tile lands while the present one is computed) and,
// after a barrier, splits the landed tile into kTerms bf16 term tiles in
// shared memory, padded as kPitch, so that every fragment comes from
// ldmatrix as in the bf16 kernels, each term once a block and not once a
// warp. Its own rows (Q, and dO; K and V in dK/dV), which are only ever A
// operands, it splits once, straight from device memory, into term tiles
// (OwnRows); where three terms of them do not fit beside the streamed
// tiles (the backward at head_dim 256), it keeps them as float32 and
// splits each A fragment in registers as it forms it.
//  * forward and dQ: 4 warps, one block per (b, query head, 64-query
//    tile), as the bf16 kernels; key tiles of BK keys (SplitFwd,
//    SplitDq). The kernels are latency-bound (their time is several
//    times their bound), so BK and dK/dV's BQ, 16 or 32 rows, are those
//    that timed best on the H100 at each head dim (SplitTiles): small
//    tiles keep blocks resident, which hides more than longer sweeps
//    between barriers do.
//  * dK/dV: 8 warps over one 64-key tile. A warp's dK or dV accumulator
//    is 16 x HD float32 (HD / 2 registers a thread), so warps 0-3 hold dV
//    and warps 4-7 dK, 16 keys each: the first form S^T = K Q^T, P and
//    P d(capped)/d(dot), hand the last to their partner through shared
//    memory laid out [warp][n][e][lane] (one named barrier), and add
//    P^T dO; the others form dP^T = V dO^T, then dS^T, and add dS^T Q. So
//    the two groups do two products each a tile, as the bf16 kernel's
//    warps do four, and at every head dim the accumulators fit.
// P and dS are split in registers into the A fragments of the next
// product (c_to_a_split). No atomics: every output element has one owner.
// ---------------------------------------------------------------------------
constexpr int kTerms = 3;              // bf16 terms a float32 operand takes
constexpr int kSplitDkvThreads = 256;  // dV's 4 warps, then dK's
constexpr int kBarSplitHand = 1;       // dK/dV's hand-over (0: syncthreads)
constexpr int kSmemMax = 227 * 1024;   // a block's shared memory on the H100

// The split kernels' tiles at each head dim: keys a forward and a dQ
// tile, queries a dK/dV tile, and whether the backward keeps its own rows
// as float32 (OwnRows). Timed on the H100 by chip_smoke.py --split-tiles,
// which rewrites these four lines (PERF.md); a layout past kSmemMax does
// not compile.
template <int HD>
struct SplitTiles {
  static constexpr int kFwdBK = HD <= 64 || HD == 192 ? 32 : 16;
  static constexpr int kDqBK = HD <= 64 ? 32 : 16;
  static constexpr int kDkvBQ = HD == 32 || HD == 128 ? 32 : 16;
  static constexpr bool kOwnF32 = HD == 256;
};

// four float32 values as kTerms bf16 terms, term i at dst + i * TS
template <int TS>
__device__ __forceinline__ void split_store(bf16* dst, float4 x) {
  float a[kTerms], b[kTerms], c[kTerms], d[kTerms];
  split<kTerms>(x.x, a);
  split<kTerms>(x.y, b);
  split<kTerms>(x.z, c);
  split<kTerms>(x.w, d);
#pragma unroll
  for (int i = 0; i < kTerms; ++i)
    *reinterpret_cast<uint2*>(dst + i * TS) =
        make_uint2(pack_bf16(a[i], b[i]), pack_bf16(c[i], d[i]));
}

// rows [r0, r0 + ROWS) of a row-major (n, HD) float32 matrix into the
// term tiles at dst (ROWS x kPitch apart), read straight from device
// memory; zeros for rows at or past n
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void split_rows(bf16* dst, const float* src,
                                           int r0, int n) {
  constexpr int kPieces = HD / 4;  // float4s a row
  static_assert(ROWS * kPieces % THREADS == 0, "whole rounds of loads");
#pragma unroll 8
  for (int u = 0; u < ROWS * kPieces / THREADS; ++u) {
    const int c = threadIdx.x + u * THREADS;
    const int r = c / kPieces, col = c % kPieces * 4;
    const float4 x = r0 + r < n
        ? __ldg(reinterpret_cast<const float4*>(
              src + (long long)(r0 + r) * HD + col))
        : make_float4(0.f, 0.f, 0.f, 0.f);
    split_store<ROWS * kPitch<HD>>(dst + r * kPitch<HD> + col, x);
  }
}

// rows [r0, r0 + ROWS) of a row-major (n, HD) float32 matrix into a
// float32 tile of PITCH floats a row by 16-byte cp.async; zeros past n
template <int HD, int ROWS, int THREADS, int PITCH = HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int n) {
  constexpr int kPieces = HD / 4;
  static_assert(ROWS * kPieces % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int u = 0; u < ROWS * kPieces / THREADS; ++u) {
    const int c = threadIdx.x + u * THREADS;
    const int r = c / kPieces, col = c % kPieces * 4;
    const bool in = r0 + r < n;
    cp_async16(dst + r * PITCH + col,
               src + (long long)(in ? r0 + r : 0) * HD + col, in);
  }
}

// a landed float32 staging tile of ROWS rows into its term tiles
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void split_tile(bf16* dst, const float* src) {
  constexpr int kPieces = HD / 4;
  static_assert(ROWS * kPieces % THREADS == 0, "whole rounds");
#pragma unroll 4
  for (int u = 0; u < ROWS * kPieces / THREADS; ++u) {
    const int c = threadIdx.x + u * THREADS;
    split_store<ROWS * kPitch<HD>>(
        dst + c / kPieces * kPitch<HD> + c % kPieces * 4,
        reinterpret_cast<const float4*>(src)[c]);
  }
}

// c0 += a b0 and c1 += a b1 over the kept term products (those whose term
// indexes sum below kTerms), the smallest first; b holds, per term, the B
// fragments of two neighbouring 8-column tiles as ldsm_b gives them. The
// products of one call (16 deep) are summed in zeroed accumulators and
// then added to c0 and c1 in float32, rounded to nearest: the tensor cores
// truncate each sum they form, so a running sum kept in their accumulator
// over a long sweep drifts by up to 2^-23 of itself a product; this way
// the truncation is of a 16-deep partial sum only.
__device__ __forceinline__ void mma_split(float (&c0)[4], float (&c1)[4],
                                          const uint32_t (&a)[kTerms][4],
                                          const uint32_t (&b)[kTerms][4]) {
  float t0[4] = {}, t1[4] = {};
#pragma unroll
  for (int i = kTerms - 1; i >= 0; --i) {
#pragma unroll
    for (int j = kTerms - 1 - i; j >= 0; --j) {
      mma16816(t0, a[i], b[j][0], b[j][1]);
      mma16816(t1, a[i], b[j][2], b[j][3]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c0[e] += t0[e];
    c1[e] += t1[e];
  }
}

// an A fragment's eight float32 values, in c_to_a's order, as kTerms A
// fragments, one a term
__device__ __forceinline__ void split_a(uint32_t (&a)[kTerms][4],
                                        const float (&x)[8]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float lo[kTerms], hi[kTerms];
    split<kTerms>(x[2 * e], lo);
    split<kTerms>(x[2 * e + 1], hi);
#pragma unroll
    for (int i = 0; i < kTerms; ++i) a[i][e] = pack_bf16(lo[i], hi[i]);
  }
}

// c_to_a of float32 values as kTerms A fragments
__device__ __forceinline__ void c_to_a_split(uint32_t (&a)[kTerms][4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
  split_a(a, x);
}

// A block's own rows of one operand: kRows rows, only ever read as A
// fragments. As kTerms bf16 term tiles (split once, read by ldmatrix), or
// with F32 as one float32 tile of kPitch floats a row, 8 words past a
// multiple of 32, so that each half warp's 8-byte loads of a fragment are
// free of bank conflicts, split at every fragment.
template <int HD, bool F32>
struct OwnRows {
  static constexpr int P = kPitch<HD>;
  static constexpr int kBytes = F32 ? kRows * P * 4 : kTerms * kRows * P * 2;

  // rows [r0, r0 + kRows) of a row-major (n, HD) float32 matrix (zeros
  // past n); with F32 by cp.async, into the caller's next commit group
  template <int THREADS>
  __device__ __forceinline__ static void load(unsigned char* at,
                                              const float* src, int r0,
                                              int n) {
    if constexpr (F32)
      load_rows_f32<HD, kRows, THREADS, P>(reinterpret_cast<float*>(at), src,
                                           r0, n);
    else
      split_rows<HD, kRows, THREADS>(reinterpret_cast<bf16*>(at), src, r0,
                                     n);
  }

  // the kTerms A fragments of rows r0..r0+15, columns c0..c0+15
  __device__ __forceinline__ static void frag(uint32_t (&a)[kTerms][4],
                                              const unsigned char* at,
                                              int r0, int c0) {
    if constexpr (F32) {
      const float* t = reinterpret_cast<const float*>(at) +
                       (r0 + threadIdx.x % 32 / 4) * P + c0 +
                       threadIdx.x % 4 * 2;
      const float2 x0 = *reinterpret_cast<const float2*>(t);
      const float2 x1 = *reinterpret_cast<const float2*>(t + 8 * P);
      const float2 x2 = *reinterpret_cast<const float2*>(t + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(t + 8 * P + 8);
      const float x[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
      split_a(a, x);
    } else {
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
        ldsm_a<P>(a[i], reinterpret_cast<const bf16*>(at) + i * kRows * P,
                  r0, c0);
    }
  }
};

// bytes of the term tiles of ROWS streamed rows
template <int HD, int ROWS>
constexpr int kTermBytes = kTerms * ROWS * kPitch<HD> * 2;

// the float32 forward's shared memory, in bytes from the base: Q's own
// rows, K's then V's terms (BK rows each), then the next K and V tiles as
// float32 (BK rows each)
template <int HD>
struct SplitFwd {
  static constexpr int BK = SplitTiles<HD>::kFwdBK;  // keys a tile
  using Own = OwnRows<HD, false>;
  static constexpr int kK = Own::kBytes;
  static constexpr int kV = kK + kTermBytes<HD, BK>;
  static constexpr int kKf = kV + kTermBytes<HD, BK>;
  static constexpr int kBytes = kKf + 2 * BK * HD * 4;
  static_assert(kBytes <= kSmemMax, "the forward's tiles do not fit");
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_split_kernel(
    const Params p) {
  using L = SplitFwd<HD>;
  constexpr int P = kPitch<HD>, BK = L::BK, KS = HD / 16, DT = HD / 8;
  constexpr int NT = BK / 8, KT = BK * P;  // KT: a term tile's stride
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::kV);
  float* kf = reinterpret_cast<float*>(smem + L::kKf);
  float* vf = kf + BK * HD;
  const QBlockOf<BK> b(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = warp * 16 + lane / 4;  // this thread's rows: r_lo, +8
  const float* kg = static_cast<const float*>(p.k) + b.kv * p.Tk * HD;
  const float* vg = static_cast<const float*>(p.v) + b.kv * p.Tk * HD;
  load_rows_f32<HD, BK, kThreads>(kf, kg, b.t_lo * BK, p.Tk);
  load_rows_f32<HD, BK, kThreads>(vf, vg, b.t_lo * BK, p.Tk);
  cp_async_commit();
  L::Own::template load<kThreads>(
      smem, static_cast<const float*>(p.q) + b.row0 * HD, b.i0, p.Tq);
  float acc[DT][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int t = b.t_lo; t <= b.t_hi; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; the last tile's terms are read
    split_tile<HD, BK, kThreads>(k_s, kf);
    split_tile<HD, BK, kThreads>(v_s, vf);
    __syncthreads();  // its terms are ready and the staging is free
    if (t < b.t_hi) {
      load_rows_f32<HD, BK, kThreads>(kf, kg, (t + 1) * BK, p.Tk);
      load_rows_f32<HD, BK, kThreads>(vf, vg, (t + 1) * BK, p.Tk);
    }
    cp_async_commit();
    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[kTerms][4];
      L::Own::frag(qa, smem, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t f[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          ldsm_b<P>(f[i], k_s + i * KT, n * 8, kk * 16);
        mma_split(s[n], s[n + 1], qa, f);
      }
    }
    float mx[2];
    log2_scores(s, mx, t * BK, b.q_first + r_lo, b.edge(t, p), p);
    online_softmax(s, mx, m, l, acc);
    // O += P V, P split in registers, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[kTerms][4];
      c_to_a_split(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t f[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          ldsm_bt<P>(f[i], v_s + i * KT, kk * 16, d * 8);
        mma_split(acc[d], acc[d + 1], a, f);
      }
    }
  }
  finish_fwd<float>(p, b.row0, b.i0 + r_lo, acc, m, l);
}

// dQ's shared memory, in bytes from the base: Q's own rows, dO's, K's and
// V's terms (BK rows each), the next K and V tiles as float32, then lse
// (times log2 e) and delta of the block's rows
template <int HD>
struct SplitDq {
  static constexpr int BK = SplitTiles<HD>::kDqBK;
  using Own = OwnRows<HD, SplitTiles<HD>::kOwnF32>;
  static constexpr int kDo = Own::kBytes;
  static constexpr int kK = 2 * Own::kBytes;
  static constexpr int kV = kK + kTermBytes<HD, BK>;
  static constexpr int kKf = kV + kTermBytes<HD, BK>;
  static constexpr int kLse = kKf + 2 * BK * HD * 4;
  static constexpr int kBytes = kLse + 2 * kRows * 4;
  static_assert(kBytes <= kSmemMax, "dQ's tiles do not fit");
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_split_kernel(
    const Params p) {
  using L = SplitDq<HD>;
  constexpr int P = kPitch<HD>, BK = L::BK, KS = HD / 16, DT = HD / 8;
  constexpr int NT = BK / 8, KT = BK * P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::kV);
  float* kf = reinterpret_cast<float*>(smem + L::kKf);
  float* vf = kf + BK * HD;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* dl_s = lse_s + kRows;
  const QBlockOf<BK> b(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = warp * 16 + lane / 4;
  const float* kg = static_cast<const float*>(p.k) + b.kv * p.Tk * HD;
  const float* vg = static_cast<const float*>(p.v) + b.kv * p.Tk * HD;
  const float* dog = static_cast<const float*>(p.dout) + b.row0 * HD;
  load_rows_f32<HD, BK, kThreads>(kf, kg, b.t_lo * BK, p.Tk);
  load_rows_f32<HD, BK, kThreads>(vf, vg, b.t_lo * BK, p.Tk);
  L::Own::template load<kThreads>(
      smem, static_cast<const float*>(p.q) + b.row0 * HD, b.i0, p.Tq);
  L::Own::template load<kThreads>(smem + L::kDo, dog, b.i0, p.Tq);
  cp_async_commit();
  {
    // delta = rowsum(dO * O), two threads a row
    const int r = threadIdx.x / 2, i = b.i0 + r;
    const long long at = (long long)i * HD + threadIdx.x % 2 * (HD / 2);
    const float* og = static_cast<const float*>(p.o) + b.row0 * HD;
    float dl = 0.f;
    if (i < p.Tq) {
#pragma unroll 8
      for (int c = 0; c < HD / 8; ++c) {
        const float4 o4 = __ldg(reinterpret_cast<const float4*>(
            og + at + c * 4));
        const float4 d4 = __ldg(reinterpret_cast<const float4*>(
            dog + at + c * 4));
        dl = fmaf(d4.x, o4.x, dl);
        dl = fmaf(d4.y, o4.y, dl);
        dl = fmaf(d4.z, o4.z, dl);
        dl = fmaf(d4.w, o4.w, dl);
      }
    }
    dl += __shfl_xor_sync(kAll, dl, 1);
    if (threadIdx.x % 2 == 0) {
      dl_s[r] = dl;
      lse_s[r] = i < p.Tq ? p.lse[b.row0 + i] * kLog2e : 0.f;
      if (i < p.Tq) p.delta[b.row0 + i] = dl;
    }
  }
  float dq[DT][4] = {};
  for (int t = b.t_lo; t <= b.t_hi; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    split_tile<HD, BK, kThreads>(k_s, kf);
    split_tile<HD, BK, kThreads>(v_s, vf);
    __syncthreads();
    if (t < b.t_hi) {
      load_rows_f32<HD, BK, kThreads>(kf, kg, (t + 1) * BK, p.Tk);
      load_rows_f32<HD, BK, kThreads>(vf, vg, (t + 1) * BK, p.Tk);
    }
    cp_async_commit();
    // S = Q K^T, then dP = dO V^T (one operand's fragments live at once)
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[kTerms][4];
      L::Own::frag(qa, smem, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t f[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          ldsm_b<P>(f[i], k_s + i * KT, n * 8, kk * 16);
        mma_split(s[n], s[n + 1], qa, f);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t da[kTerms][4];
      L::Own::frag(da, smem + L::kDo, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t f[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          ldsm_b<P>(f[i], v_s + i * KT, n * 8, kk * 16);
        mma_split(dp[n], dp[n + 1], da, f);
      }
    }
    // dS = P * (dP - delta) * d(capped)/d(dot), P = exp(capped - lse)
    const bool edge = b.edge(t, p);
    const float lse2[2] = {lse_s[r_lo], lse_s[r_lo + 8]};
    const float dl[2] = {dl_s[r_lo], dl_s[r_lo + 8]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float sc = capped(s[n][e], p);
        float ds = 0.f;
        if (!edge || visible(t * BK + n * 8 + lane % 4 * 2 + (e & 1),
                             b.q_first + r_lo + h * 8, p))
          ds = exp2f(sc * kLog2e - lse2[h]) * (dp[n][e] - dl[h]) *
               capped_grad(sc, p);
        s[n][e] = ds;
      }
    }
    // dQ += dS K, dS split in registers, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[kTerms][4];
      c_to_a_split(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t f[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          ldsm_bt<P>(f[i], k_s + i * KT, kk * 16, d * 8);
        mma_split(dq[d], dq[d + 1], a, f);
      }
    }
  }
  float* dqg = static_cast<float*>(p.dq) + b.row0 * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = b.i0 + r_lo + h * 8;
    if (i < p.Tq) store_band(dqg + (long long)i * HD, dq, h, 1.f);
  }
}

// dK/dV's shared memory, in bytes from the base: K's own rows, V's, the
// query tile's Q terms and dO terms (BQ rows each), then the next tile's
// Q, dO (float32), lse and delta; the present tile's lse and delta, and
// the hand-over (64 x BQ floats)
template <int HD>
struct SplitDkv {
  static constexpr int BQ = SplitTiles<HD>::kDkvBQ;
  using Own = OwnRows<HD, SplitTiles<HD>::kOwnF32>;
  static constexpr int kV = Own::kBytes;
  static constexpr int kQ = 2 * Own::kBytes;
  static constexpr int kDo = kQ + kTermBytes<HD, BQ>;
  static constexpr int kQf = kDo + kTermBytes<HD, BQ>;
  static constexpr int kLse = kQf + 2 * BQ * HD * 4 + 2 * BQ * 4;
  static constexpr int kHand = kLse + 2 * BQ * 4;
  static constexpr int kBytes = kHand + kRows * BQ * 4;
  static_assert(kBytes <= kSmemMax, "dK/dV's tiles do not fit");
};

template <int HD>
__global__ void __launch_bounds__(kSplitDkvThreads)
    flash_bwd_dkv_split_kernel(const Params p) {
  using L = SplitDkv<HD>;
  constexpr int P = kPitch<HD>, BQ = L::BQ, KS = HD / 16, DT = HD / 8;
  constexpr int NT = BQ / 8, QT = BQ * P;
  constexpr int kN = kSplitDkvThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::kDo);
  float* qf = reinterpret_cast<float*>(smem + L::kQf);
  float* dof = qf + BQ * HD;
  float* lsef = dof + BQ * HD;
  float* dlf = lsef + BQ;
  float* ls = reinterpret_cast<float*>(smem + L::kLse);
  float* dls = ls + BQ;
  const int G = p.G, Tq = p.Tq, Tk = p.Tk, off = Tk - Tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / 4, w = warp % 4;  // 0: P and dV; 1: dS and dK
  const long long bh = (long long)blockIdx.z * p.Hkv + blockIdx.y;
  const int j0 = blockIdx.x * kRows, j1 = min(j0 + kRows, Tk);
  const int key = j0 + w * 16 + lane / 4;  // this thread's keys: +0, +8
  // the query rows that see a key of this tile, in tiles of BQ, per head
  const int i_lo = p.causal ? max(0, j0 - off) : 0;
  const int i_hi = p.window > 0 ? min(Tq - 1, j1 - 2 + p.window - off)
                                : Tq - 1;
  const int n_qt = i_hi >= i_lo ? (i_hi - i_lo) / BQ + 1 : 0;
  const long long row0 = bh * G * Tq;  // lse row of (b, h, 0, 0)
  const float* qg = static_cast<const float*>(p.q) + row0 * HD;
  const float* dog = static_cast<const float*>(p.dout) + row0 * HD;
  // query tile it (Q, dO, lse, delta) into the staging, a commit group
  auto load_q = [&](int it) {
    if (it < G * n_qt) {
      const int g = it / n_qt, i0 = i_lo + (it - g * n_qt) * BQ;
      load_rows_f32<HD, BQ, kN>(qf, qg + (long long)g * Tq * HD, i0, Tq);
      load_rows_f32<HD, BQ, kN>(dof, dog + (long long)g * Tq * HD, i0, Tq);
      if (threadIdx.x < BQ) {
        const int i = i0 + threadIdx.x;
        const long long r = row0 + (long long)g * Tq + min(i, Tq - 1);
        cp_async4(lsef + threadIdx.x, p.lse + r, i < Tq);
        cp_async4(dlf + threadIdx.x, p.delta + r, i < Tq);
      }
    }
    cp_async_commit();
  };
  // the own rows first, in load_q(0)'s commit group
  L::Own::template load<kN>(
      smem, static_cast<const float*>(p.k) + bh * Tk * HD, j0, Tk);
  L::Own::template load<kN>(
      smem + L::kV, static_cast<const float*>(p.v) + bh * Tk * HD, j0, Tk);
  load_q(0);
  // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1), rows this warp's
  // keys; then dV += P^T dO or dK += dS^T Q
  const unsigned char* a_own = smem + (grp ? L::kV : 0);
  const bf16* b_s = grp ? do_s : q_s;
  const bf16* o_s = grp ? q_s : do_s;
  float* hand = reinterpret_cast<float*>(smem + L::kHand) + w * NT * 128;
  float acc[DT][4] = {};
  for (int it = 0; it < G * n_qt; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; the last one's terms are read
    split_tile<HD, BQ, kN>(q_s, qf);
    split_tile<HD, BQ, kN>(do_s, dof);
    if (threadIdx.x < BQ) {
      ls[threadIdx.x] = lsef[threadIdx.x];
      dls[threadIdx.x] = dlf[threadIdx.x];
    }
    __syncthreads();
    load_q(it + 1);  // into the staging, now free
    const int i0 = i_lo + it % n_qt * BQ;
    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[kTerms][4];
      L::Own::frag(ka, a_own, w * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t f[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          ldsm_b<P>(f[i], b_s + i * QT, n * 8, kk * 16);
        mma_split(s[n], s[n + 1], ka, f);
      }
    }
    if (grp == 0) {
      // P = exp(capped - lse) on the visible pairs; P d(capped)/d(dot)
      // to the partner warp
      const bool edge = i0 + BQ > Tq || j0 + kRows > Tk ||
                        (p.causal && j0 + kRows - 1 > i0 + off) ||
                        (p.window > 0 &&
                         j0 <= min(i0 + BQ, Tq) - 1 + off - p.window);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + lane % 4 * 2 + (e & 1);  // query row in tile
          const float sc = capped(s[n][e], p);
          float pr = 0.f, pg = 0.f;
          if (!edge || (i0 + c < Tq &&
                        visible(key + (e >> 1) * 8, i0 + c + off, p))) {
            pr = exp2f((sc - ls[c]) * kLog2e);
            pg = pr * capped_grad(sc, p);
          }
          s[n][e] = pr;
          hand[(n * 4 + e) * 32 + lane] = pg;
        }
      }
      named_arrive(kBarSplitHand, kN);
    } else {
      // dS^T = P d(capped)/d(dot) (dP^T - delta)
      named_sync(kBarSplitHand, kN);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + lane % 4 * 2 + (e & 1);
          s[n][e] = hand[(n * 4 + e) * 32 + lane] * (s[n][e] - dls[c]);
        }
      }
    }
    // 16 query rows a step, P or dS split in registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[kTerms][4];
      c_to_a_split(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t f[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          ldsm_bt<P>(f[i], o_s + i * QT, kk * 16, d * 8);
        mma_split(acc[d], acc[d + 1], a, f);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (n_qt may be 0)
  float* dst = static_cast<float*>(grp ? p.dk : p.dv) + bh * Tk * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key + h * 8;
    if (j < Tk) store_band(dst + (long long)j * HD, acc, h, 1.f);
  }
}

// above 48 KB a kernel must opt in to its dynamic shared memory
template <typename K>
int opt_in(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename K, typename A>
int launch(K kernel, dim3 grid, int smem, const A& args, cudaStream_t s,
           int threads = kThreads) {
  const int e = opt_in(kernel, smem);
  if (e) return e;
  kernel<<<grid, threads, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// the backward at head_dim 192 and 256: the tensor maps, then dQ (which
// writes delta), then dK/dV, on the stream
template <int HD>
int run_hopper_bwd(const Params& p, int B, cudaStream_t s) {
  HopArgs a;
  a.p = p;
  const long long n_q = (long long)B * p.Hkv * p.G, n_kv = (long long)B * p.Hkv;
  int e = make_tile_map(&a.q, p.q, HD, p.Tq, n_q);
  if (!e) e = make_tile_map(&a.dout, p.dout, HD, p.Tq, n_q);
  if (!e) e = make_tile_map(&a.k, p.k, HD, p.Tk, n_kv);
  if (!e) e = make_tile_map(&a.v, p.v, HD, p.Tk, n_kv);
  if (!e) e = make_tile_map(&a.dq, p.dq, HD, p.Tq, n_q);
  if (!e) e = make_tile_map(&a.dk, p.dk, HD, p.Tk, n_kv);
  if (!e) e = make_tile_map(&a.dv, p.dv, HD, p.Tk, n_kv);
  if (e) return e;
  const long long q_blocks = (p.Tq + kRows - 1) / kRows * n_q;
  const long long k_blocks = (p.Tk + kRows - 1) / kRows * n_kv;
  if (q_blocks > 0x7fffffff || k_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  e = launch(flash_bwd_dq_hopper_kernel<HD>, dim3(q_blocks),
             DqSmem<HD>::kBytes, a, s, kHopThreads);
  if (e) return e;
  return launch(flash_bwd_dkv_hopper_kernel<HD>, dim3(k_blocks),
                DkvSmem<HD>::kBytes, a, s, kHopThreads);
}

// the bf16 backward kernels of a head_dim: (dQ, dK/dV), their shared
// memory and block size
template <int HD>
struct Bwd {
  static constexpr bool kHopper = HD > 128;
  static constexpr int kThreadsBwd = kHopper ? kHopThreads : kThreads;
  static int dq_bytes() {
    if constexpr (kHopper) return DqSmem<HD>::kBytes;
    else return dq_smem<HD>();
  }
  static int dkv_bytes() {
    if constexpr (kHopper) return DkvSmem<HD>::kBytes;
    else return dkv_smem<HD>();
  }
  static auto dq() {
    if constexpr (kHopper) return flash_bwd_dq_hopper_kernel<HD>;
    else return flash_bwd_dq_tc_kernel<HD>;
  }
  static auto dkv() {
    if constexpr (kHopper) return flash_bwd_dkv_hopper_kernel<HD>;
    else return flash_bwd_dkv_tc_kernel<HD>;
  }
};

// dtype 0: float32 (the split kernels), 1: bf16
template <int HD>
int run(bool bwd, int dtype, const Params& p, int B, cudaStream_t s) {
  const dim3 qgrid((p.Tq + kRows - 1) / kRows, p.Hkv * p.G, B);
  const dim3 kgrid((p.Tk + kRows - 1) / kRows, p.Hkv, B);
  if (dtype == 0) {
    if (!bwd)
      return launch(flash_fwd_split_kernel<HD>, qgrid, SplitFwd<HD>::kBytes,
                    p, s);
    const int err = launch(flash_bwd_dq_split_kernel<HD>, qgrid,
                           SplitDq<HD>::kBytes, p, s);
    if (err) return err;
    // after the dQ kernel on the same stream: delta is written
    return launch(flash_bwd_dkv_split_kernel<HD>, kgrid,
                  SplitDkv<HD>::kBytes, p, s, kSplitDkvThreads);
  }
  if (!bwd)
    return launch(flash_fwd_tc_kernel<HD>, qgrid, fwd_smem<HD>(), p, s);
  if constexpr (HD > 128) {
    return run_hopper_bwd<HD>(p, B, s);
  } else {
    const int err = launch(flash_bwd_dq_tc_kernel<HD>, qgrid, dq_smem<HD>(),
                           p, s);
    if (err) return err;
    return launch(flash_bwd_dkv_tc_kernel<HD>, kgrid, dkv_smem<HD>(), p, s);
  }
}

// blocks of `kernel` resident on one SM with smem bytes of dynamic shared
// memory and `threads` a block (0 if it cannot opt in to that much)
template <typename K>
int resident(K kernel, int smem, int threads) {
  int n = 0;
  if (opt_in(kernel, smem)) return 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n;
}

// blocks of a kernel (0: dQ, 1: dK/dV, 2: the forward) of dtype resident
// on one SM, its shared memory in *smem and its threads in *threads
template <int HD>
int occupancy(int dtype, int kernel, int* smem, int* threads) {
  *threads = kThreads;
  if (dtype == 0) {
    switch (kernel) {
      case 0:
        *smem = SplitDq<HD>::kBytes;
        return resident(flash_bwd_dq_split_kernel<HD>, *smem, *threads);
      case 1:
        *smem = SplitDkv<HD>::kBytes;
        *threads = kSplitDkvThreads;
        return resident(flash_bwd_dkv_split_kernel<HD>, *smem, *threads);
      default:
        *smem = SplitFwd<HD>::kBytes;
        return resident(flash_fwd_split_kernel<HD>, *smem, *threads);
    }
  }
  using K = Bwd<HD>;
  switch (kernel) {
    case 0:
      *smem = K::dq_bytes();
      *threads = K::kThreadsBwd;
      return resident(K::dq(), *smem, *threads);
    case 1:
      *smem = K::dkv_bytes();
      *threads = K::kThreadsBwd;
      return resident(K::dkv(), *smem, *threads);
    default:
      *smem = fwd_smem<HD>();
      return resident(flash_fwd_tc_kernel<HD>, *smem, *threads);
  }
}

}  // namespace tc

// the most query heads a kv head may have, as kernels/flash_attention.py
// max_heads: the range the checks on the card cover
constexpr int max_heads(int hd) { return 128 / (hd == 192 ? 8 : hd / 32); }

int run(bool bwd, const Params& p, int B, int hd, int dtype, void* stream) {
  if (B == 0 || p.Hkv == 0 || p.G == 0 || p.Tq == 0) return 0;
  // every row must see a key
  if (p.Tq > p.Tk || (dtype != 0 && dtype != 1) || hd < 32 ||
      p.G > max_heads(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return tc::run<32>(bwd, dtype, p, B, s);
    case 64: return tc::run<64>(bwd, dtype, p, B, s);
    case 128: return tc::run<128>(bwd, dtype, p, B, s);
    case 192: return tc::run<192>(bwd, dtype, p, B, s);  // MLA's qk width
    case 256: return tc::run<256>(bwd, dtype, p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int occupancy(int hd, int dtype, int kernel, int* smem, int* threads) {
  if (dtype != 0 && dtype != 1) return 0;
  switch (hd) {
    case 32: return tc::occupancy<32>(dtype, kernel, smem, threads);
    case 64: return tc::occupancy<64>(dtype, kernel, smem, threads);
    case 128: return tc::occupancy<128>(dtype, kernel, smem, threads);
    case 192: return tc::occupancy<192>(dtype, kernel, smem, threads);
    case 256: return tc::occupancy<256>(dtype, kernel, smem, threads);
    default: return 0;
  }
}

}  // namespace

// dtype (q, k, v, out): 0 = float32 (split into bf16 terms), 1 = bfloat16;
// both on the tensor cores. hd in {32, 64, 128, 192, 256}; G at most
// 128 / (hd / 32), 16 at hd 192; Tq <= Tk. causal 0 or 1; window <= 0 and
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

// The backward kernels' residency at head_dim hd and dtype (as the
// launchers'): kernel 0 is dQ, 1 dK/dV; returns its blocks per SM (0 for a
// head_dim or dtype it does not take) and writes its dynamic shared memory
// to *smem and its block size to *threads.
extern "C" int flash_attention_bwd_occupancy(int hd, int dtype, int kernel,
                                             int* smem, int* threads) {
  return occupancy(hd, dtype, kernel != 0, smem, threads);
}

// The forward kernel's residency, as flash_attention_bwd_occupancy's.
extern "C" int flash_attention_fwd_occupancy(int hd, int dtype, int* smem,
                                             int* threads) {
  return occupancy(hd, dtype, 2, smem, threads);
}

// The bf16 terms a float32 operand takes in the float32 kernels, as
// kernels/flash_attention.py's F32_TERMS, which the wrapper checks.
extern "C" int flash_attention_f32_terms() { return tc::kTerms; }
