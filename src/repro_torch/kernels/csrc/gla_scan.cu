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
// Every operand is float32 (the wrapper casts: chunked_gla computes in
// float32); y is written in float32 or bfloat16, the final state in float32.
//
// Exponents: la <= 0, so exp(lb_i - lb_j) is formed only for j <= i, where
// it is at most 1; exp(lb_i) and exp(lb_last - lb_j) may underflow to 0,
// harmlessly. Nothing is factored as exp(lb_i) * exp(-lb_j), which would
// overflow: mLSTM clamps la at -30, so lb reaches ~ -7680 over 256 steps.
//
// Bound on the H100: operations, on the float32 CUDA cores. One mLSTM layer
// of xlstm-350m's prefill (B 8, H 4, T 2000, dk 512, dv 513, c 256) does
// ~2 * 32 * 2000 * (128.5 * (512 + 513) + 2 * 512 * 513) ~ 76 GFLOP against
// ~0.3 GB of operands, far above the ridge.
//
// Design, simple and right first (tensor cores, TMA and wgmma are later):
//  * gla_scores_kernel: the intra-chunk scores do not depend on v and carry
//    nothing from one chunk to the next, so they are formed for every
//    (row, chunk) at once: a block per (64 x 64 tile on or below the
//    diagonal, chunk, row) takes the float32 product q k^T over dk in slices
//    of 32 staged in shared memory, then the decay and the causal mask. It
//    writes P^T (j-major, so the scan reads it coalesced) to float32 scratch,
//    zeros above the diagonal, and each chunk's lb to scratch.
//  * gla_scan_kernel: a block per (row, slice of 32 columns of v) sweeps the
//    chunks in order. The (dk x 32) float32 slice of S lives in shared memory
//    for the whole sweep, so the state never goes to device memory between
//    chunks. The whole state does not fit one block (512 x 513 x 4 B = 1 MB
//    against 227 KB), so dv is split across blocks, which also fills the card
//    (B * H * 17 blocks at full width). Per chunk: thread i owns row i of y,
//    32 float32 accumulators each for the intra part (P^T staged 32 rows at a
//    time, times the staged v slice) and the inter part (q staged 32 dims at a
//    time, transposed, times S); y is staged in shared memory and written row
//    by row, coalesced; then thread t owns rows t and t + 256 of the state
//    slice and adds the chunk's decayed k v^T (k staged 16 steps at a time).
#include "payload.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;          // one y row per thread
constexpr int kMaxDk = 2 * kThreads;    // two state rows per thread
constexpr int kTile = 64;               // scores tile
constexpr int kDK = 32;                 // dims of q and k staged at a time
constexpr int kTV = 32;                 // columns of v per scan block
constexpr int kV4 = kTV / 4;
constexpr int kJ = 32;                  // rows of P^T staged at a time
constexpr int kK = 16;                  // steps of k staged at a time
constexpr int kQT = kMaxChunk + 1;      // padded row of staged q^T
constexpr int kYS = kTV + 1;            // padded row of staged y
constexpr int kBuf = kMaxChunk * kYS;   // staging floats, the largest use

struct Params {
  const float* q;    // (R, T, dk)
  const float* k;    // (R, T, dk)
  const float* v;    // (R, T, dv)
  const float* la;   // (R, T)
  const float* s0;   // (R, dk, dv), or null for a zero state
  void* y;           // (R, T, dv), float or bfloat16
  float* s;          // (R, dk, dv)
  float* pt;         // (R, n, cpad, cpad) scratch: P^T of each chunk
  float* lb;         // (R, n, cpad) scratch: lb of each chunk
  int T, dk, dv, c, n, cpad;
};

__device__ __forceinline__ void axpy4(float4& a, float s, float4 y) {
  a.x = fmaf(s, y.x, a.x);
  a.y = fmaf(s, y.y, a.y);
  a.z = fmaf(s, y.z, a.z);
  a.w = fmaf(s, y.w, a.w);
}

// Block per (scores tile, chunk, row); tiles above the diagonal return.
__global__ void __launch_bounds__(kThreads) gla_scores_kernel(Params p) {
  const int nt = p.cpad / kTile;
  const int ti = blockIdx.x / nt, tj = blockIdx.x % nt;
  if (tj > ti) return;
  const int chunk = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = chunk * p.c;
  const int live = min(p.c, p.T - t0);
  __shared__ float lb_s[kMaxChunk];
  __shared__ float qs[kDK][kTile + 1];
  __shared__ float ks[kDK][kTile + 1];

  // lb: la loaded in parallel, then summed left to right by one thread
  const float* lar = p.la + (long long)r * p.T + t0;
  for (int j = tid; j < p.c; j += kThreads) lb_s[j] = j < live ? lar[j] : 0.f;
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int j = 0; j < p.c; ++j) {
      acc += lb_s[j];
      lb_s[j] = acc;
    }
  }
  __syncthreads();
  const long long rc = (long long)r * p.n + chunk;
  if (blockIdx.x == 0)
    for (int j = tid; j < p.c; j += kThreads) p.lb[rc * p.cpad + j] = lb_s[j];

  const int tx = tid % 16, ty = tid / 16;  // rows tx*4.., columns ty*4..
  const int i0 = ti * kTile, j0 = tj * kTile;
  const float* qr = p.q + ((long long)r * p.T + t0) * p.dk;
  const float* kr = p.k + ((long long)r * p.T + t0) * p.dk;
  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  for (int d0 = 0; d0 < p.dk; d0 += kDK) {
    for (int e = tid; e < kTile * kDK; e += kThreads) {
      const int row = e / kDK, dd = e % kDK, d = d0 + dd;
      const int i = i0 + row, j = j0 + row;
      qs[dd][row] = i < live && d < p.dk ? qr[(long long)i * p.dk + d] : 0.f;
      ks[dd][row] = j < live && d < p.dk ? kr[(long long)j * p.dk + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < kDK; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = qs[dd][tx * 4 + x];
        b[x] = ks[dd][ty * 4 + x];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
    __syncthreads();
  }
  // P_ij = (q_i . k_j) * exp(lb_i - lb_j) for j <= i < c, else 0; stored
  // transposed, four consecutive i per 16-byte store
  float* out = p.pt + rc * p.cpad * p.cpad;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int j = j0 + ty * 4 + y;
    float w[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + tx * 4 + x;
      w[x] = i < p.c && j <= i ? acc[x][y] * expf(lb_s[i] - lb_s[j]) : 0.f;
    }
    *reinterpret_cast<float4*>(out + (long long)j * p.cpad + i0 + tx * 4) =
        make_float4(w[0], w[1], w[2], w[3]);
  }
}

// Block per (slice of kTV columns of v, row): the sweep over the chunks.
template <typename TY>
__global__ void __launch_bounds__(kThreads) gla_scan_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* S_s = reinterpret_cast<float*>(smem4);  // (dk, kTV) state slice
  float* v_s = S_s + p.dk * kTV;                 // (c, kTV) chunk's v slice
  float* buf = v_s + kMaxChunk * kTV;            // staging, kBuf floats
  float* lb_s = buf + kBuf;                      // (c,) lb
  float* dec_s = lb_s + kMaxChunk;               // (c,) exp(lb_last - lb)
  const int tid = threadIdx.x;
  const int r = blockIdx.y;
  const int v0 = blockIdx.x * kTV;
  const int ncols = min(kTV, p.dv - v0);
  const long long rT = (long long)r * p.T;
  const float* qr = p.q + rT * p.dk;
  const float* kr = p.k + rT * p.dk;
  const float* vr = p.v + rT * p.dv;
  TY* yr = static_cast<TY*>(p.y) + rT * p.dv;

  for (int e = tid; e < p.dk * kTV; e += kThreads) {
    const int d = e / kTV, col = e % kTV;
    S_s[e] = p.s0 != nullptr && col < ncols
                 ? p.s0[((long long)r * p.dk + d) * p.dv + v0 + col]
                 : 0.f;
  }
  const int i = tid;                   // the row of y this thread owns
  const int d1 = tid, d2 = tid + kThreads;  // the state rows it owns
  for (int chunk = 0; chunk < p.n; ++chunk) {
    const int t0 = chunk * p.c;
    const int live = min(p.c, p.T - t0);   // the chunk's steps before T
    const long long rc = (long long)r * p.n + chunk;
    __syncthreads();   // the previous chunk is done with every buffer
    for (int e = tid; e < live * kTV; e += kThreads) {
      const int j = e / kTV, col = e % kTV;
      v_s[e] = col < ncols ? vr[(long long)(t0 + j) * p.dv + v0 + col] : 0.f;
    }
    const float* lbr = p.lb + rc * p.cpad;
    const float lb_last = lbr[p.c - 1];
    for (int j = tid; j < p.c; j += kThreads) {
      lb_s[j] = lbr[j];
      dec_s[j] = expf(lb_last - lbr[j]);
    }

    float4 a[kV4], b[kV4];
#pragma unroll
    for (int m = 0; m < kV4; ++m) {
      a[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      b[m] = a[m];
    }
    // intra-chunk: a_i = sum_{j<=i} P_ij v_j
    const float* ptr = p.pt + rc * p.cpad * p.cpad;
    for (int j0 = 0; j0 < live; j0 += kJ) {
      __syncthreads();
      for (int e = tid; e < kJ * p.c; e += kThreads) {
        const int jj = e / p.c, ii = e % p.c;
        buf[e] = j0 + jj < live ? ptr[(long long)(j0 + jj) * p.cpad + ii]
                                : 0.f;
      }
      __syncthreads();
      if (i < live && i >= j0) {
        const int jn = min(kJ, i - j0 + 1);
        for (int jj = 0; jj < jn; ++jj) {
          const float pij = buf[jj * p.c + i];
          const float4* vv =
              reinterpret_cast<const float4*>(v_s + (j0 + jj) * kTV);
#pragma unroll
          for (int m = 0; m < kV4; ++m) axpy4(a[m], pij, vv[m]);
        }
      }
    }
    // inter-chunk: b_i = q_i S, unless S is still the zero state
    if (chunk > 0 || p.s0 != nullptr) {
      for (int d0 = 0; d0 < p.dk; d0 += kDK) {
        __syncthreads();
        for (int e = tid; e < live * kDK; e += kThreads) {
          const int j = e / kDK, dd = e % kDK;
          buf[dd * kQT + j] =
              d0 + dd < p.dk ? qr[(long long)(t0 + j) * p.dk + d0 + dd] : 0.f;
        }
        __syncthreads();
        if (i < live) {
          const int dn = min(kDK, p.dk - d0);
          for (int dd = 0; dd < dn; ++dd) {
            const float qv = buf[dd * kQT + i];
            const float4* ss =
                reinterpret_cast<const float4*>(S_s + (d0 + dd) * kTV);
#pragma unroll
            for (int m = 0; m < kV4; ++m) axpy4(b[m], qv, ss[m]);
          }
        }
      }
    }
    // y_i = a_i + exp(lb_i) b_i, staged, then written a row at a time
    __syncthreads();
    if (i < live) {
      const float e = expf(lb_s[i]);
      float* yrow = buf + i * kYS;
#pragma unroll
      for (int m = 0; m < kV4; ++m) {
        yrow[4 * m + 0] = a[m].x + e * b[m].x;
        yrow[4 * m + 1] = a[m].y + e * b[m].y;
        yrow[4 * m + 2] = a[m].z + e * b[m].z;
        yrow[4 * m + 3] = a[m].w + e * b[m].w;
      }
    }
    __syncthreads();
    for (int e = tid; e < live * kTV; e += kThreads) {
      const int j = e / kTV, col = e % kTV;
      if (col < ncols)
        yr[(long long)(t0 + j) * p.dv + v0 + col] =
            from_float<TY>(buf[j * kYS + col]);
    }
    // the state: S = exp(lb_last) S + sum_j (k_j exp(lb_last - lb_j)) v_j^T
    float4 u1[kV4], u2[kV4];
#pragma unroll
    for (int m = 0; m < kV4; ++m) {
      u1[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      u2[m] = u1[m];
    }
    for (int j0 = 0; j0 < live; j0 += kK) {
      const int jn = min(kK, live - j0);
      __syncthreads();
      for (int e = tid; e < jn * p.dk; e += kThreads) {
        const int jj = e / p.dk, d = e % p.dk;
        buf[e] = kr[(long long)(t0 + j0 + jj) * p.dk + d] * dec_s[j0 + jj];
      }
      __syncthreads();
      for (int jj = 0; jj < jn; ++jj) {
        const float4* vv =
            reinterpret_cast<const float4*>(v_s + (j0 + jj) * kTV);
        if (d1 < p.dk) {
          const float kd = buf[jj * p.dk + d1];
#pragma unroll
          for (int m = 0; m < kV4; ++m) axpy4(u1[m], kd, vv[m]);
        }
        if (d2 < p.dk) {
          const float kd = buf[jj * p.dk + d2];
#pragma unroll
          for (int m = 0; m < kV4; ++m) axpy4(u2[m], kd, vv[m]);
        }
      }
    }
    const float g = expf(lb_last);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = h ? d2 : d1;
      if (d >= p.dk) continue;
      float4* srow = reinterpret_cast<float4*>(S_s + d * kTV);
#pragma unroll
      for (int m = 0; m < kV4; ++m) {
        const float4 u = h ? u2[m] : u1[m];
        const float4 s = srow[m];
        srow[m] = make_float4(g * s.x + u.x, g * s.y + u.y, g * s.z + u.z,
                              g * s.w + u.w);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < p.dk * kTV; e += kThreads) {
    const int d = e / kTV, col = e % kTV;
    if (col < ncols) p.s[((long long)r * p.dk + d) * p.dv + v0 + col] = S_s[e];
  }
}

size_t scan_smem_bytes(int dk) {
  return sizeof(float) *
         (static_cast<size_t>(dk) * kTV + kMaxChunk * kTV + kBuf +
          2 * kMaxChunk);
}

template <typename TY>
int launch(const Params& p, int R, cudaStream_t s) {
  const int nt = p.cpad / kTile;
  gla_scores_kernel<<<dim3(nt * nt, p.n, R), kThreads, 0, s>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t smem = scan_smem_bytes(p.dk);
  err = static_cast<int>(cudaFuncSetAttribute(
      gla_scan_kernel<TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  // after the scores kernel on the same stream: P^T and lb are written
  gla_scan_kernel<TY><<<dim3((p.dv + kTV - 1) / kTV, R), kThreads, smem, s>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k (R, T, dk), v (R, T, dv), la (R, T), s0 (R, dk, dv) or null: float32,
// contiguous. y (R, T, dv) in y_dtype (0 = float32, 1 = bfloat16); s
// (R, dk, dv) float32. pt (R, n, cpad, cpad) and lb (R, n, cpad) are float32
// scratch, with n = ceil(T / c) and cpad = c rounded up to 64. 1 <= c <= 256,
// dk <= 512. Two kernels on the stream, scores then scan. Returns the
// cudaError_t of the launches.
extern "C" int gla_scan_launch(const float* q, const float* k, const float* v,
                               const float* la, const float* s0, void* y,
                               float* s, float* pt, float* lb, int R, int T,
                               int dk, int dv, int c, int y_dtype,
                               void* stream) {
  if (R == 0 || T == 0 || dv == 0) return 0;
  if (c < 1 || c > kMaxChunk || dk < 1 || dk > kMaxDk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = (T + c - 1) / c;
  const int cpad = (c + kTile - 1) / kTile * kTile;
  const Params p{q, k, v, la, s0, y, s, pt, lb, T, dk, dv, c, n, cpad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_dtype == 0) return launch<float>(p, R, st);
  if (y_dtype == 1) return launch<__nv_bfloat16>(p, R, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
