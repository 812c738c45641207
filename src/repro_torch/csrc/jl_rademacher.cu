// Matrix-free Johnson-Lindenstrauss projection for Hopper (sm_90a).
//
// jl_rademacher_kernel replaces the Pallas kernel
//   src/repro/kernels/jl_rademacher/jl_rademacher.py::jl_pallas
// One (n,) float32 vector and m 32-bit row seeds -> the (m,) projection
//   out[r] = sum_j sign(r, j) * v_j
//   sign(r, j) = +1 if the low bit of mix32(j * GOLDEN + row_seed[r]) is 0,
//                else -1
// with mix32 and GOLDEN from sketch_common.cuh.  The +-1 matrix is never
// stored: each sign is hashed where it is used.  The row seeds are an
// input, so one body serves both of the reference's rules:
// kernels.jl_project passes mix32(seed + r * GOLDEN) (the TPU kernel's
// rule) and core.baselines.jl_sketch passes fold_seed(seed, 0) + r.  The
// division by sqrt(m) is the caller's.
//
// The TPU kernel makes each (rows x columns) tile of signs once and feeds
// it to the matrix unit: the hash is its work.  Here the hash and the add
// both run on the CUDA cores (no tensor core applies: the signs are exact
// and TF32 would round v), so the bound on the card is operations: each
// of the m * n terms costs its hash and one float add.  The bytes are
// n * 4 read and m * 4 written.
//
// What held a block-a-row design back was the stream, not the hash:
// every block read the whole vector, so one launch pulled m * n * 4 bytes
// through L2 (48 MB at (30000, 400) for a 120 KB vector), spent a load
// instruction a term, and m = 400 blocks on 132 SMs left a tail.
//
// Design, one launch:
// - A block of THREADS threads takes ROWS rows and one chunk of the
//   columns.  A thread loads its columns UNROLL at a time, each round's
//   loads issued a round ahead, and adds each v_j, signed, into ROWS
//   accumulators, the row seeds in registers: a load serves ROWS terms and
//   the L2 stream shrinks by ROWS.
// - The columns are cut into up to MAX_CHUNKS chunks of at least MIN_COLS
//   columns (a multiple of 32); the chunks of a row tile form one
//   thread-block cluster of a portable size.  At (30000, 400): 100 x 8 =
//   800 blocks of 4 warps in one wave.  Clusters of 16 blocks reached
//   fewer SMs and needed a second wave.
// - A term: j * GOLDEN once a column; then the seed add, mix32's first
//   four steps and one multiply that puts the sign in bit 31
//   (sketch::mix32_sign_bit), an xor on the float's sign bit and the add:
//   9 instructions, 5 of them on the half-rate integer pipe, so a warp's
//   term takes ~10 issue cycles.  That is the floor of this kernel at the
//   SM level, and the balance of the blocks over the SMs sets the rest.
// - Sums in a fixed order: each thread adds its columns in ascending j;
//   the warp reduces its ROWS sums with one butterfly (lanes paired by
//   lane bits 16, 8, 4, 2, 1 in that order, halving the rows at each of
//   the first log2(ROWS) steps), so every row sees the same tree; the
//   warps are added in warp order; the chunks' sums go to rank 0 of the
//   cluster through distributed shared memory, after one cluster barrier,
//   and are added in rank order.  No float atomics.  The chunks depend
//   on n alone, so a row's bits depend only on its seed and v: not on m,
//   not on its place in a tile, not on the launch.
#include <cooperative_groups.h>

#include "sketch_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;             // rows a block (a power of two, <= 32)
constexpr int UNROLL = 8;           // columns a thread loads at once
constexpr int MAX_CHUNKS = 8;       // blocks a cluster (a portable size)
constexpr int64_t MIN_COLS = 1024;  // columns a chunk, at least
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SIGN = 0x80000000u;

// acc[r] += sign(r, j) * x for the ROWS rows, x's bits in xb.
__device__ __forceinline__ void add_column(float (&acc)[ROWS],
                                           const unsigned (&seed)[ROWS],
                                           unsigned jg, unsigned xb) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const unsigned s = sketch::mix32_sign_bit(jg + seed[r]) & SIGN;
    acc[r] = __fadd_rn(acc[r], __uint_as_float(xb ^ s));
  }
}

// The bits of v[j + u * THREADS], u < UNROLL; FULL: all before j1, else
// 0 from j1 on.
template <bool FULL>
__device__ __forceinline__ void load_round(unsigned (&xb)[UNROLL],
                                           const float* __restrict__ v,
                                           int64_t j, int64_t j1) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    xb[u] = FULL || j + u * THREADS < j1
                ? __float_as_uint(__ldg(v + j + u * THREADS))
                : 0u;
}

// The terms of one round of columns j + u * THREADS (those before j1
// unless FULL), in ascending j.
template <bool FULL>
__device__ __forceinline__ void add_round(float (&acc)[ROWS],
                                          const unsigned (&seed)[ROWS],
                                          const unsigned (&xb)[UNROLL],
                                          int64_t j, int64_t j1) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (FULL || j + u * THREADS < j1)
      add_column(acc, seed, (unsigned)(j + u * THREADS) * sketch::GOLDEN,
                 xb[u]);
}

// grid (row tiles, chunks); a cluster is the chunks of one row tile.
__global__ void __launch_bounds__(THREADS)
jl_rademacher_kernel(const float* __restrict__ v,
                     const unsigned* __restrict__ row_seeds, int64_t n,
                     int64_t m, int64_t chunk, float* __restrict__ out) {
  __shared__ float s_warp[WARPS][ROWS];
  __shared__ float s_recv[MAX_CHUNKS][ROWS];   // rank 0's: the chunks' sums
  const int nc = gridDim.y;
  if (nc > 1) sketch::cluster_arrive_relaxed();   // this block has started
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  unsigned seed[ROWS];
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    seed[r] = row0 + r < m ? __ldg(row_seeds + row0 + r) : 0u;
    acc[r] = 0.0f;
  }
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  // this thread's columns j0 + t + k * THREADS in rounds of UNROLL, each
  // round's loads issued a round ahead, the terms in ascending j: full
  // rounds while the next one is full too (no test in the loop), then at
  // most one full round and one partial round
  constexpr int64_t STEP = (int64_t)UNROLL * THREADS;
  constexpr int64_t LAST = (UNROLL - 1) * THREADS;
  int64_t j = j0 + threadIdx.x;
  unsigned xb[UNROLL];
  if (j + LAST < j1) load_round<true>(xb, v, j, j1);
  else load_round<false>(xb, v, j, j1);
  for (; j + STEP + LAST < j1; j += STEP) {
    unsigned next[UNROLL];
    load_round<true>(next, v, j + STEP, j1);
    add_round<true>(acc, seed, xb, j, j1);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) xb[u] = next[u];
  }
  if (j + LAST < j1) {
    unsigned next[UNROLL];
    load_round<false>(next, v, j + STEP, j1);
    add_round<true>(acc, seed, xb, j, j1);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) xb[u] = next[u];
    j += STEP;
  }
  add_round<false>(acc, seed, xb, j, j1);

  // the warp's sums: lanes paired by bit 16, 8, 4, 2, 1 in turn; at each
  // of the first log2(ROWS) steps a lane keeps half of its rows (the upper
  // half where its bit is set) and takes its partner's sums of them
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int off = 16 >> step;
    const int half = ROWS >> (step + 1);       // 0 once one row is left
    if (half > 0) {
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? acc[i] : acc[i + half];
        const float keep = upper ? acc[i + half] : acc[i];
        acc[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, off));
      }
    } else {
      acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(FULL, acc[0], off));
    }
  }
  // lane l now holds the warp's sum of row l / (32 / ROWS)
  constexpr int LANES_A_ROW = 32 / ROWS;
  if (lane % LANES_A_ROW == 0) s_warp[warp][lane / LANES_A_ROW] = acc[0];
  __syncthreads();
  float sum = 0.0f;
  if (threadIdx.x < ROWS) {
    sum = s_warp[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      sum = __fadd_rn(sum, s_warp[w][threadIdx.x]);
  }
  const int64_t row = row0 + threadIdx.x;
  if (nc == 1) {
    if (threadIdx.x < ROWS && row < m) out[row] = sum;
    return;
  }
  // the chunks' sums into rank 0's shared memory (every block of the
  // cluster has started, so it is there), one barrier, then rank 0 adds
  // them in rank order
  const cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  sketch::cluster_wait();
  if (threadIdx.x < ROWS)
    cl.map_shared_rank(&s_recv[0][0], 0)[rank * ROWS + threadIdx.x] = sum;
  cl.sync();
  if (rank == 0 && threadIdx.x < ROWS && row < m) {
    float total = s_recv[0][threadIdx.x];
    for (int c = 1; c < nc; ++c)
      total = __fadd_rn(total, s_recv[c][threadIdx.x]);
    out[row] = total;
  }
}

// The chunk length for n columns: a function of n alone.
int64_t chunk_len(int64_t n) {
  int64_t c = (n + MIN_COLS - 1) / MIN_COLS;
  c = c < 1 ? 1 : c > MAX_CHUNKS ? MAX_CHUNKS : c;
  return ((n + c - 1) / c + 31) / 32 * 32;
}

}  // namespace

extern "C" {

// v (n,) f32; row_seeds (m,) uint32; out (m,) f32.
int repro_jl_rademacher(const float* v, const unsigned* row_seeds, int64_t n,
                        int64_t m, float* out, void* stream) {
  if (m <= 0) return 0;
  if (n < 0 || n > 0xFFFFFFFFLL || m > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int64_t chunk = chunk_len(n);
  const int nc = n > 0 ? (int)((n + chunk - 1) / chunk) : 1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)nc;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((m + ROWS - 1) / ROWS), (unsigned)nc);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = nc > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, jl_rademacher_kernel, v,
                                           row_seeds, n, m, chunk, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
