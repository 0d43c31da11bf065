// Swap pack / unpack for Hopper (sm_90a): the coalescing gather and scatter
// of InferCept's swap path, one launch for every leaf of a pool tree.
//
// Replaces: src/repro/kernels/swap_pack.py, functions swap_pack (Pallas body
// _pack_kernel) and swap_unpack (_unpack_kernel). Pack gathers pool pages
// into one contiguous slab, so the device-to-host transfer moves one block;
// unpack scatters a slab back into pool pages in place.
//
// Bound on the H100: bytes. Each moved (period, page) row is read once and
// written once, 2 * row bytes, against the 3.35 TB/s of HBM; there is no
// arithmetic. What the design does about it:
//
// * One launch moves every leaf of the tree. Each leaf is a (P, n_pages, R)
//   byte view of a pool stacked over P layer periods (R its page's trailing
//   size in bytes); the slab holds its (P, n, R) section at a byte offset.
//   The leaves travel by value in the kernel's parameters (a table of base
//   pointer, R, section offset, P, n_pages), so a swap's host side makes one
//   launch whatever the leaf count.
// * Persistent blocks, kBlocksPerSM per SM, walk a strided list of chunks
//   over all leaves at once. A chunk is at most one stage (16 KB): a piece
//   of a row larger than a stage, or up to kMaxRows consecutive slab rows
//   of one period when rows are smaller.
// * The bytes never pass through registers. One elected thread keeps a ring
//   of kStages stages in flight: a bulk asynchronous copy (the TMA's
//   cp.async.bulk) global -> shared completing on the stage's mbarrier, then
//   a bulk copy shared -> global in a bulk group, and
//   cp.async.bulk.wait_group.read before the stage is loaded again.
// * A leaf whose rows are small (under kMinBulkRow: a scale leaf, a tiny
//   config's pages) or whose rows or addresses are not 16-byte multiples
//   (a scale leaf at Hkv 1 or 2, an unaligned slab) takes the word path of
//   the same kernel: the other warps copy its rows one word a thread, flat
//   over all such leaves' (period, row, word) elements, each word the
//   widest access that R and both addresses allow (16, 8, 4, 2 or 1
//   bytes). A one-thread TMA op per 32-byte row would cost more than the
//   row.
// * A page id out of range is skipped: pack leaves its slab row as it was,
//   unpack writes nothing. An unpack writes a page once whatever its ids: a
//   slab row whose id appears again later in ids writes nothing, so the
//   last of repeated ids wins, as the reference's sequential grid writes
//   them. Whoever issues a row's store decides it with a scan of the ids
//   after it (n is at most a few hundred; the ids stay in L1): on the bulk
//   copies the ring's thread before each store, on the word path each lane
//   for its row. The engine never repeats an id (it scatters into freshly
//   allocated pages).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;
constexpr int kMaxRows = 32;       // slab rows of one chunk
constexpr int kMinBulkRow = 512;   // bytes; smaller rows take the word path
constexpr int kThreads = 128;      // thread 0: the ring; warps 1-3: words
constexpr int kWordLanes = kThreads - 32;
constexpr int kBlocksPerSM = 2;
constexpr int kTableInts = 5;      // per leaf: pool, R, offset, P, n_pages

struct Leaf {
  char* pool;            // (P, n_pages, row) bytes
  long long row;         // bytes of one (period, page) row
  long long slab_off;    // byte offset of the leaf's (P, n, row) section
  long long first;       // its first chunk (bulk) or word (word path)
  long long per_period;  // bulk: chunks per period
  long long words;       // word path: words per row
  int P, n_pages;
  int bulk;              // 1: the ring's bulk copies; 0: the word path
  int unit;              // word path: bytes per word (16, 8, 4, 2, 1)
  int rows;              // bulk: slab rows per chunk (row <= a stage)
  int pieces;            // bulk: chunks per row (row > a stage), else 1
};

struct Table {
  Leaf leaf[kMaxLeaves];
  char* slab;
  const int* ids;
  long long bulk_chunks, word_elems;
  int n, n_leaves;
};

struct Chunk {
  const Leaf* leaf;
  long long p;         // period
  int i0, rows;        // first slab row and rows (1 for a piece of a row)
  long long off;       // byte offset inside the row (pieces)
  int len;             // bytes per row moved (the piece, or the row)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the leaf whose chunks (bulk) or words (word path) hold global index c
__device__ __forceinline__ const Leaf& leaf_of(const Table& t, long long c,
                                               int bulk) {
  int found = 0;
  for (int l = 0; l < t.n_leaves; ++l)
    if (t.leaf[l].bulk == bulk && c >= t.leaf[l].first) found = l;
  return t.leaf[found];
}

__device__ __forceinline__ Chunk chunk_of(const Table& t, long long c) {
  const Leaf& L = leaf_of(t, c, 1);
  const long long q = c - L.first;
  const long long r = q % L.per_period;
  Chunk k;
  k.leaf = &L;
  k.p = q / L.per_period;
  if (L.pieces > 1) {
    k.i0 = static_cast<int>(r / L.pieces);
    k.rows = 1;
    k.off = (r % L.pieces) * static_cast<long long>(kStageBytes);
    k.len = static_cast<int>(min(static_cast<long long>(kStageBytes),
                                 L.row - k.off));
  } else {
    k.i0 = static_cast<int>(r) * L.rows;
    k.rows = min(L.rows, t.n - k.i0);
    k.off = 0;
    k.len = static_cast<int>(L.row);
  }
  return k;
}

__device__ __forceinline__ bool in_range(int pid, const Leaf& L) {
  return pid >= 0 && pid < L.n_pages;
}

// unpack: slab row i (id pid) is the last row naming its page. A fold with
// no early exit, so the loads are independent and unrolled ones overlap (an
// early return per id waited out each load in turn)
__device__ __forceinline__ bool last_of(const Table& t, int i, int pid) {
  bool last = true;
#pragma unroll 8
  for (int j = i + 1; j < t.n; ++j) last &= __ldg(t.ids + j) != pid;
  return last;
}

__device__ __forceinline__ char* pool_row(const Leaf& L, long long p,
                                          int pid) {
  return L.pool + (p * L.n_pages + pid) * L.row;
}

__device__ __forceinline__ char* slab_row(const Table& t, const Leaf& L,
                                          long long p, int i) {
  return t.slab + L.slab_off + (p * t.n + i) * L.row;
}

// issue chunk k's loads into stage s, completing on bar
template <bool kUnpack>
__device__ __forceinline__ void load_chunk(const Table& t, const Chunk& k,
                                           unsigned char* s, uint64_t* bar) {
  const Leaf& L = *k.leaf;
  if (kUnpack) {  // the slab rows are contiguous: one copy
    const uint32_t bytes = static_cast<uint32_t>(k.rows) * k.len;
    bar_expect(bar, bytes);
    bulk_load(s, slab_row(t, L, k.p, k.i0) + k.off, bytes, bar);
    return;
  }
  int pid[kMaxRows];
  uint32_t bytes = 0;
  for (int r = 0; r < k.rows; ++r) {
    pid[r] = __ldg(t.ids + k.i0 + r);
    if (in_range(pid[r], L)) bytes += k.len;
  }
  bar_expect(bar, bytes);
  for (int r = 0; r < k.rows; ++r)
    if (in_range(pid[r], L))
      bulk_load(s + r * L.row, pool_row(L, k.p, pid[r]) + k.off, k.len, bar);
}

// issue chunk k's stores from stage s as one bulk group
template <bool kUnpack>
__device__ __forceinline__ void store_chunk(const Table& t, const Chunk& k,
                                            unsigned char* s) {
  const Leaf& L = *k.leaf;
  if (kUnpack) {
    for (int r = 0; r < k.rows; ++r) {
      const int pid = __ldg(t.ids + k.i0 + r);
      if (in_range(pid, L) && last_of(t, k.i0 + r, pid))
        bulk_store(pool_row(L, k.p, pid) + k.off, s + r * L.row, k.len);
    }
  } else {  // each run of in-range rows is one contiguous slab range
    int r0 = 0;
    for (int r = 0; r <= k.rows; ++r) {
      if (r < k.rows && in_range(__ldg(t.ids + k.i0 + r), L)) continue;
      if (r > r0)
        bulk_store(slab_row(t, L, k.p, k.i0 + r0) + k.off, s + r0 * L.row,
                   static_cast<uint32_t>(r - r0) * k.len);
      r0 = r + 1;
    }
  }
  bulk_commit();
}

// thread 0: this block's chunks k = 0, 1, ... (global blockIdx.x + k * grid)
// through the ring; the load into a stage is issued once the store that
// last read it has finished reading (one iteration later, so kStages - 1
// loads stay ahead of the stores)
template <bool kUnpack>
__device__ void bulk_loop(const Table& t, unsigned char* stage,
                          uint64_t* full) {
  const long long G = gridDim.x;
  const long long cnt =
      t.bulk_chunks > blockIdx.x ? (t.bulk_chunks - 1 - blockIdx.x) / G + 1
                                 : 0;
  if (cnt == 0) return;
  for (int s = 0; s < kStages; ++s) bar_init(&full[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (long long k = 0; k < cnt && k < kStages; ++k)
    load_chunk<kUnpack>(t, chunk_of(t, blockIdx.x + k * G),
                        stage + k * kStageBytes, &full[k]);
  for (long long k = 0; k < cnt; ++k) {
    const int s = static_cast<int>(k % kStages);
    bar_wait(&full[s], static_cast<uint32_t>((k / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    store_chunk<kUnpack>(t, chunk_of(t, blockIdx.x + k * G),
                         stage + s * kStageBytes);
    const long long j = k - 1 + kStages;
    if (k >= 1 && j < cnt) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int sj = static_cast<int>(j % kStages);
      load_chunk<kUnpack>(t, chunk_of(t, blockIdx.x + j * G),
                          stage + sj * kStageBytes, &full[sj]);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename W>
__device__ __forceinline__ void copy_word(char* dst, const char* src) {
  *reinterpret_cast<W*>(dst) = *reinterpret_cast<const W*>(src);
}

// warps 1-3: one word a thread, flat over the word-path leaves'
// (period, slab row, word) elements
template <bool kUnpack>
__device__ void word_loop(const Table& t) {
  const long long step = static_cast<long long>(gridDim.x) * kWordLanes;
  for (long long e = static_cast<long long>(blockIdx.x) * kWordLanes +
                     threadIdx.x - 32;
       e < t.word_elems; e += step) {
    const Leaf& L = leaf_of(t, e, 0);
    const long long q = e - L.first;
    const long long r = q / L.words;
    const long long p = r / t.n;
    const int i = static_cast<int>(r % t.n);
    const int pid = __ldg(t.ids + i);
    if (!in_range(pid, L) || (kUnpack && !last_of(t, i, pid))) continue;
    const long long off = (q % L.words) * L.unit;
    char* a = pool_row(L, p, pid) + off;
    char* b = slab_row(t, L, p, i) + off;
    char* dst = kUnpack ? a : b;
    const char* src = kUnpack ? b : a;
    switch (L.unit) {
      case 16: copy_word<uint4>(dst, src); break;
      case 8: copy_word<unsigned long long>(dst, src); break;
      case 4: copy_word<unsigned int>(dst, src); break;
      case 2: copy_word<unsigned short>(dst, src); break;
      default: copy_word<unsigned char>(dst, src);
    }
  }
}

template <bool kUnpack>
__global__ void __launch_bounds__(kThreads)
    swap_kernel(const __grid_constant__ Table t) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x == 0)
    bulk_loop<kUnpack>(t, stage, full);
  else if (threadIdx.x >= 32)
    word_loop<kUnpack>(t);
}

int alignment(uintptr_t a) {
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : a % 2 == 0 ? 2
                                                                          : 1;
}

template <bool kUnpack>
int launch(const long long* table, int n_leaves, void* slab, const int* ids,
           int n, void* stream) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  Table t{};
  t.slab = static_cast<char*>(slab);
  t.ids = ids;
  t.n = n;
  t.n_leaves = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* e = table + l * kTableInts;
    Leaf& L = t.leaf[l];
    L.pool = reinterpret_cast<char*>(static_cast<uintptr_t>(e[0]));
    L.row = e[1];
    L.slab_off = e[2];
    L.P = static_cast<int>(e[3]);
    L.n_pages = static_cast<int>(e[4]);
    L.unit = alignment(reinterpret_cast<uintptr_t>(L.pool) |
                       reinterpret_cast<uintptr_t>(t.slab + L.slab_off) |
                       static_cast<uintptr_t>(L.row));
    L.bulk = L.unit == 16 && L.row >= kMinBulkRow;
    L.rows = 1;
    L.pieces = 1;
    L.per_period = 0;
    L.words = 0;
    if (L.row == 0 || L.P == 0) {        // nothing to move
      L.bulk = 1;
      L.first = t.bulk_chunks;
    } else if (L.bulk) {
      if (L.row > kStageBytes) {
        L.pieces = static_cast<int>((L.row + kStageBytes - 1) / kStageBytes);
        L.per_period = static_cast<long long>(n) * L.pieces;
      } else {
        L.rows = static_cast<int>(std::min<long long>(
            {kStageBytes / L.row, kMaxRows, n}));
        L.per_period = (n + L.rows - 1) / L.rows;
      }
      L.first = t.bulk_chunks;
      t.bulk_chunks += L.P * L.per_period;
    } else {
      L.words = L.row / L.unit;
      L.first = t.word_elems;
      t.word_elems += static_cast<long long>(L.P) * n * L.words;
    }
  }
  const long long work = std::max(
      t.bulk_chunks, (t.word_elems + kWordLanes - 1) / kWordLanes);
  if (work == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static bool ready[64] = {};
  if (err == cudaSuccess && !ready[dev % 64]) {
    err = cudaFuncSetAttribute(swap_kernel<kUnpack>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStages * kStageBytes);
    ready[dev % 64] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(kBlocksPerSM) * sms;
  const unsigned grid = static_cast<unsigned>(std::min(work, cap));
  swap_kernel<kUnpack><<<grid, kThreads, kStages * kStageBytes,
                         static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: n_leaves rows of (pool pointer, row bytes, slab offset, P, n_pages)
// as int64; slab: the byte buffer holding each leaf's (P, n, row) section
// at its offset; ids: (n,) int32 page ids. Both return the launch's
// cudaError_t and launch nothing for n == 0 or an empty tree.
extern "C" int swap_pack_launch(const long long* table, int n_leaves,
                                void* slab, const int* ids, int n,
                                void* stream) {
  return launch<false>(table, n_leaves, slab, ids, n, stream);
}

extern "C" int swap_unpack_launch(const long long* table, int n_leaves,
                                  void* slab, const int* ids, int n,
                                  void* stream) {
  return launch<true>(table, n_leaves, slab, ids, n, stream);
}
