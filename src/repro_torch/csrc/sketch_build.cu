// Linear-time sketch build kernels for Hopper (sm_90a).
//
// The hash/rank pass, with the histogram (entry repro_hash_rank_hist),
// replaces the Pallas kernel
//   src/repro/kernels/sketch_build/sketch_build.py::hash_rank_hist_pallas,
// and without it replaces
//   src/repro/kernels/hash_rank/hash_rank.py::hash_rank_batched_pallas
// (entry repro_hash_rank_batched) and, on one vector,
//   src/repro/kernels/hash_rank/hash_rank.py::hash_rank_pallas
// (entry repro_hash_rank).  The refinement levels of rank_hist_pallas
// run in radix_select.cu.
//
// One pass over a (D, n) float32 block.  For coordinate j it computes the
// unit hash hu (the shared hash row, (n,)) and the rank hu / w of every
// row ((D, n)) with the device functions of sketch_common.cuh -- the one
// source of the formula, as the reference's _block_hash_rank is for its
// three kernels, so all three stay bit-coordinated.  With the histogram it
// also counts a per-row 256-bin histogram of bits(rank) >> 24 (sign +
// exponent: the log-domain level 0 of the k-th smallest rank); without, it
// is the threshold build's front end.
//
// Bound on the card: memory.  The pass reads D*n*4 bytes and writes
// D*n*4 + n*4 bytes (the histogram is 1 KiB a row).  Every thread rebuilds
// its coordinate from its position, so no index array is read; the hash
// row is written once, by the blocks of row 0.  The ragged tail is masked,
// not padded, so the histogram is the one of the unpadded block.  The
// caller picks one of two routes (the wrappers' spread_route):
//
// The batched route (hash_rank_kernel), when the grid of one block per
// CHUNK coordinates of a row holds at least two blocks an SM, as on a
// (512, 65536) block: each thread walks 16 coordinates; with the histogram
// each block counts into a 256-bin shared histogram with warp-aggregated
// atomics (__match_any_sync: the lanes that share a bin add once, which
// matters because sparse rows put most ranks in the +inf bin), then adds
// each nonzero bin to the zeroed (D, 256) output with one global atomic.
//
// The spread route, when that grid would leave the card mostly idle, as
// on every single vector the paths sketch (n <= 1e5: 8 blocks at
// n = 30000, each walking its 16 coordinates in series).  There the time
// is the launch and the chain of dependent steps, not bytes (one vector of
// 30000 is 0.36 MB, 0.0001 ms at 3.35 TB/s), so the design cuts the chain:
//  - Without the histogram (spread_kernel), a coordinate a thread in
//    256-thread blocks: each thread has one load round trip and nothing
//    in series, and the row covers the SMs (118 blocks at n = 30000).
//  - With it (cluster_hist_kernel), each row is one thread-block cluster
//    of up to 16 blocks of 1024 threads (16 is a non-portable size, so the
//    device is asked once what it can hold), a coordinate a thread in
//    strides of the cluster.  A block counts into its shared histogram as
//    the batched route does; then every block adds its nonzero bins into
//    rank 0's histogram with atomics on distributed shared memory, one
//    cluster barrier, and rank 0 stores all 256 bins, zeros included.  The
//    output is written, not added to, so the caller need not zero it and a
//    call is one launch.  Integer sums: the order does not matter.  The
//    cluster's barrier and exchange cost about as much as its hashing at
//    n = 30000, and a cluster is at most 16 SMs, so past 2^17 coordinates
//    a row the batched grid and its fill are faster (the wrappers'
//    HIST_SPREAD_MAX_N).
#include <cooperative_groups.h>

#include "sketch_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;            // elements per thread per block
constexpr int CHUNK = THREADS * PER_THREAD;

// Add one to sh[bin] for every active lane; lanes sharing a bin add once.
__device__ __forceinline__ void hist_add(int* sh, unsigned active, int bin) {
  const unsigned peers = __match_any_sync(active, bin);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&sh[bin], __popc(peers));
}

__device__ __forceinline__ void flush_hist(const int* sh, int* out_row) {
  __syncthreads();
  for (int i = threadIdx.x; i < NBINS; i += blockDim.x)
    if (sh[i]) atomicAdd(&out_row[i], sh[i]);
}

template <int VARIANT, bool HIST>
__global__ void __launch_bounds__(THREADS)
hash_rank_kernel(const float* __restrict__ vals, float* __restrict__ h_out,
                 float* __restrict__ rank, int* __restrict__ hist, int64_t n,
                 uint32_t seed) {
  __shared__ int sh[HIST ? NBINS : 1];
  if constexpr (HIST) {
    for (int i = threadIdx.x; i < NBINS; i += blockDim.x) sh[i] = 0;
    __syncthreads();
  }
  const int64_t d = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * CHUNK;
  const int64_t end = min(start + (int64_t)CHUNK, n);
  const float* row = vals + d * n;
  float* rrow = rank + d * n;
  // the trip count is the same for every thread of the block, so the
  // whole warp reaches each ballot
  for (int64_t base = start; base < end; base += THREADS) {
    const int64_t j = base + threadIdx.x;
    const bool valid = j < end;
    const unsigned act = HIST ? __ballot_sync(0xffffffffu, valid) : 0u;
    if (valid) {
      const float hu = sketch::unit_hash((uint32_t)j, seed);
      const float r = sketch::rank_of(hu, sketch::weight(row[j], VARIANT));
      rrow[j] = r;
      if (d == 0) h_out[j] = hu;
      if constexpr (HIST) hist_add(sh, act, (int)(__float_as_uint(r) >> 24));
    }
  }
  if constexpr (HIST) flush_hist(sh, hist + d * NBINS);
}

template <bool HIST>
int launch_hash_rank(const float* vals, float* h_out, float* rank, int* hist,
                     int64_t D, int64_t n, uint32_t seed, int variant,
                     void* stream) {
  if (D <= 0 || n <= 0) return 0;
  const dim3 grid((unsigned)((n + CHUNK - 1) / CHUNK), (unsigned)D);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    hash_rank_kernel<0, HIST><<<grid, THREADS, 0, s>>>(vals, h_out, rank, hist, n, seed);
  else if (variant == 1)
    hash_rank_kernel<1, HIST><<<grid, THREADS, 0, s>>>(vals, h_out, rank, hist, n, seed);
  else if (variant == 2)
    hash_rank_kernel<2, HIST><<<grid, THREADS, 0, s>>>(vals, h_out, rank, hist, n, seed);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the spread route

constexpr int SPREAD_THREADS = 256;       // a block without the histogram
constexpr int CLUSTER_THREADS = 1024;     // a block of a histogram cluster
constexpr int MAX_CLUSTER = 16;           // a non-portable size on Hopper
constexpr unsigned FULL = 0xffffffffu;

// Without the histogram: grid (ceil(n / SPREAD_THREADS), D), a
// coordinate a thread.
template <int VARIANT>
__global__ void __launch_bounds__(SPREAD_THREADS)
spread_kernel(const float* __restrict__ vals, float* __restrict__ h_out,
              float* __restrict__ rank, int64_t n, uint32_t seed) {
  const int64_t d = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * SPREAD_THREADS + threadIdx.x;
  if (j >= n) return;
  const float hu = sketch::unit_hash((uint32_t)j, seed);
  rank[d * n + j] = sketch::rank_of(hu, sketch::weight(vals[d * n + j],
                                                       VARIANT));
  if (d == 0) h_out[j] = hu;
}

// With the histogram: grid (nb, D), one cluster of nb blocks a row (no
// cluster when nb == 1), a coordinate a thread in strides of the cluster.
// Each block counts into its shared histogram with hist_add; then every
// block but rank 0 adds its nonzero bins into rank 0's histogram
// (distributed shared memory atomics), one cluster barrier, and rank 0
// stores all 256 bins.
template <int VARIANT>
__global__ void __launch_bounds__(CLUSTER_THREADS)
cluster_hist_kernel(const float* __restrict__ vals, float* __restrict__ h_out,
                    float* __restrict__ rank, int* __restrict__ hist,
                    int64_t n, uint32_t seed, int nb) {
  __shared__ int sh[NBINS];
  for (int i = threadIdx.x; i < NBINS; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  // rank 0's zeros are released before any block adds into them
  if (nb > 1) sketch::cluster_arrive();
  const int64_t d = blockIdx.y;
  const float* row = vals + d * n;
  float* rrow = rank + d * n;
  const int64_t stride = (int64_t)nb * blockDim.x;
  // the trip count is the same for every thread of the block, so the
  // whole warp reaches each ballot
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const int64_t j = base + threadIdx.x;
    const bool valid = j < n;
    const unsigned act = __ballot_sync(FULL, valid);
    if (valid) {
      const float hu = sketch::unit_hash((uint32_t)j, seed);
      const float r = sketch::rank_of(hu, sketch::weight(row[j], VARIANT));
      rrow[j] = r;
      if (d == 0) h_out[j] = hu;
      hist_add(sh, act, (int)(__float_as_uint(r) >> 24));
    }
  }
  __syncthreads();
  int* out = hist + d * NBINS;
  if (nb == 1) {
    for (int i = threadIdx.x; i < NBINS; i += blockDim.x) out[i] = sh[i];
    return;
  }
  const cg::cluster_group cl = cg::this_cluster();
  const bool root = cl.block_rank() == 0;
  sketch::cluster_wait();
  if (!root) {
    int* dst = cl.map_shared_rank(sh, 0);
    for (int i = threadIdx.x; i < NBINS; i += blockDim.x)
      if (sh[i]) atomicAdd(dst + i, sh[i]);
  }
  cl.sync();
  if (root)
    for (int i = threadIdx.x; i < NBINS; i += blockDim.x) out[i] = sh[i];
}

// Blocks a histogram cluster may hold on this device (1 to MAX_CLUSTER),
// asked once a device; the kernel's non-portable cluster size allowed
// with it.
template <int VARIANT>
int cluster_cap(int* cap) {
  return sketch::once_per_device(cap, [](int, int* size) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_hist_kernel<VARIANT>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(MAX_CLUSTER);
    cfg.blockDim = dim3(CLUSTER_THREADS);
    e = cudaOccupancyMaxPotentialClusterSize(
        size, cluster_hist_kernel<VARIANT>, &cfg);
    if (e != cudaSuccess) return e;
    *size = *size > MAX_CLUSTER ? MAX_CLUSTER : *size < 1 ? 1 : *size;
    return cudaSuccess;
  });
}

template <int VARIANT>
int launch_cluster_hist(const float* vals, float* h_out, float* rank,
                        int* hist, int64_t D, int64_t n, uint32_t seed,
                        cudaStream_t s) {
  int cap = 1;
  const int err = cluster_cap<VARIANT>(&cap);
  if (err) return err;
  // a row shorter than a block takes one block of just enough warps
  const int threads = n >= CLUSTER_THREADS ? CLUSTER_THREADS
                                           : (int)((n + 31) / 32 * 32);
  int64_t nb = (n + threads - 1) / threads;
  nb = nb > cap ? cap : nb;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nb, (unsigned)D);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = nb > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, cluster_hist_kernel<VARIANT>, vals, h_out, rank, hist, n, seed,
      (int)nb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int VARIANT>
int launch_spread(const float* vals, float* h_out, float* rank, int64_t D,
                  int64_t n, uint32_t seed, cudaStream_t s) {
  const dim3 grid((unsigned)((n + SPREAD_THREADS - 1) / SPREAD_THREADS),
                  (unsigned)D);
  spread_kernel<VARIANT><<<grid, SPREAD_THREADS, 0, s>>>(vals, h_out, rank,
                                                         n, seed);
  return (int)cudaGetLastError();
}

// Either route of the pass.  spread = 0: the batched grid (hist, with
// HIST, zeroed by the caller and added to); 1: the spread route (hist
// written whole).
template <bool HIST>
int hash_rank_route(const float* vals, float* h_out, float* rank, int* hist,
                    int64_t D, int64_t n, uint32_t seed, int variant,
                    int spread, void* stream) {
  if (!spread)
    return launch_hash_rank<HIST>(vals, h_out, rank, hist, D, n, seed,
                                  variant, stream);
  if (D <= 0 || n <= 0) return 0;
  if (D > 65535 || n > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if constexpr (HIST) {
    if (variant == 0)
      return launch_cluster_hist<0>(vals, h_out, rank, hist, D, n, seed, s);
    if (variant == 1)
      return launch_cluster_hist<1>(vals, h_out, rank, hist, D, n, seed, s);
    return launch_cluster_hist<2>(vals, h_out, rank, hist, D, n, seed, s);
  } else {
    if (variant == 0)
      return launch_spread<0>(vals, h_out, rank, D, n, seed, s);
    if (variant == 1)
      return launch_spread<1>(vals, h_out, rank, D, n, seed, s);
    return launch_spread<2>(vals, h_out, rank, D, n, seed, s);
  }
}

}  // namespace

extern "C" {

// vals (D, n) f32, h_out (n,) f32, rank (D, n) f32, hist (D, 256) int32:
// zeroed by the caller when spread = 0, written whole when spread = 1.
// variant: 0 l2, 1 l1, 2 uniform.
int repro_hash_rank_hist(const float* vals, float* h_out, float* rank,
                         int* hist, int64_t D, int64_t n, uint32_t seed,
                         int variant, int spread, void* stream) {
  return hash_rank_route<true>(vals, h_out, rank, hist, D, n, seed, variant,
                               spread, stream);
}

// vals (D, n) f32 -> h_out (n,) f32, rank (D, n) f32.
int repro_hash_rank_batched(const float* vals, float* h_out, float* rank,
                            int64_t D, int64_t n, uint32_t seed, int variant,
                            int spread, void* stream) {
  return hash_rank_route<false>(vals, h_out, rank, nullptr, D, n, seed,
                                variant, spread, stream);
}

// vals (n,) f32 -> h_out (n,) f32, rank (n,) f32: one vector (D = 1).
int repro_hash_rank(const float* vals, float* h_out, float* rank, int64_t n,
                    uint32_t seed, int variant, int spread, void* stream) {
  return hash_rank_route<false>(vals, h_out, rank, nullptr, 1, n, seed,
                                variant, spread, stream);
}

}  // extern "C"
