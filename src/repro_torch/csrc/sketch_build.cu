// Linear-time sketch build kernels for Hopper (sm_90a).
//
// hash_rank_kernel<VARIANT, HIST=true> (entry repro_hash_rank_hist)
// replaces the Pallas kernel
//   src/repro/kernels/sketch_build/sketch_build.py::hash_rank_hist_pallas,
// hash_rank_kernel<VARIANT, HIST=false> replaces
//   src/repro/kernels/hash_rank/hash_rank.py::hash_rank_batched_pallas
// (entry repro_hash_rank_batched) and, launched with D = 1,
//   src/repro/kernels/hash_rank/hash_rank.py::hash_rank_pallas
// (entry repro_hash_rank).  The refinement levels of rank_hist_pallas
// run in radix_select.cu.
//
// hash_rank_kernel: one pass over a (D, n) float32 block.  For coordinate
// j it computes the unit hash hu (the shared hash row, (n,)) and the rank
// hu / w of every row ((D, n)) with the device functions of
// sketch_common.cuh — the one source of the formula, as the reference's
// _block_hash_rank is for its three kernels, so all three stay
// bit-coordinated.  With HIST it also counts a per-row 256-bin histogram
// of bits(rank) >> 24 (sign + exponent: the log-domain level 0 of the k-th
// smallest rank); without, it is the threshold build's front end.
//
// Bound on the card: memory.  hash_rank_kernel reads D*n*4 bytes and
// writes D*n*4 + n*4 bytes (the histogram is 1 KiB a row).  Design: every thread rebuilds its coordinate from its
// position, so no index array is read; the hash row is written once, by
// the blocks of row 0; with HIST each block counts into a 256-bin shared
// histogram with warp-aggregated atomics (__match_any_sync: the lanes that
// share a bin add once, which matters because sparse rows put most ranks
// in the +inf bin), then adds each nonzero bin to the zeroed (D, 256)
// output with one global atomic.  The ragged tail is masked, not padded,
// so the histogram is the one of the unpadded block.
#include "sketch_common.cuh"

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

}  // namespace

extern "C" {

// vals (D, n) f32, h_out (n,) f32, rank (D, n) f32, hist (D, 256) int32
// zeroed by the caller.  variant: 0 l2, 1 l1, 2 uniform.
int repro_hash_rank_hist(const float* vals, float* h_out, float* rank,
                         int* hist, int64_t D, int64_t n, uint32_t seed,
                         int variant, void* stream) {
  return launch_hash_rank<true>(vals, h_out, rank, hist, D, n, seed, variant,
                                stream);
}

// vals (D, n) f32 -> h_out (n,) f32, rank (D, n) f32.
int repro_hash_rank_batched(const float* vals, float* h_out, float* rank,
                            int64_t D, int64_t n, uint32_t seed, int variant,
                            void* stream) {
  return launch_hash_rank<false>(vals, h_out, rank, nullptr, D, n, seed,
                                 variant, stream);
}

// vals (n,) f32 -> h_out (n,) f32, rank (n,) f32: the D = 1 launch.
int repro_hash_rank(const float* vals, float* h_out, float* rank, int64_t n,
                    uint32_t seed, int variant, void* stream) {
  return launch_hash_rank<false>(vals, h_out, rank, nullptr, 1, n, seed,
                                 variant, stream);
}

}  // extern "C"
