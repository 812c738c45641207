// Linear-time sketch build kernels for Hopper (sm_90a).
//
// hash_rank_hist replaces the Pallas kernel
//   src/repro/kernels/sketch_build/sketch_build.py::hash_rank_hist_pallas
// and rank_hist replaces
//   src/repro/kernels/sketch_build/sketch_build.py::rank_hist_pallas.
//
// hash_rank_hist: one pass over a (D, n) float32 block.  For coordinate j
//   h    = mix32(j * 0x9E3779B9 + seed)
//   hu   = ((h >> 8) + 0.5) * 2^-24              (the shared hash row, (n,))
//   w    = v^2 | |v| | 1[v != 0]                 (l2 | l1 | uniform)
//   rank = hu / w, +inf where w == 0             ((D, n))
// plus a per-row 256-bin histogram of bits(rank) >> 24 (sign + exponent:
// the log-domain level 0 of the k-th smallest rank).
// rank_hist: one refinement level, counting (bits >> shift) & 0xFF over the
// keys whose bits above shift + 8 equal a per-row prefix.
//
// Bound on the card: memory.  hash_rank_hist reads D*n*4 bytes and writes
// D*n*4 + n*4 bytes (the histogram is 1 KiB a row); rank_hist reads D*n*4
// bytes.  Design: every thread rebuilds its coordinate from its position,
// so no index array is read; the hash row is written once, by the blocks
// of row 0; each block counts into a 256-bin shared histogram with
// warp-aggregated atomics (__match_any_sync: the lanes that share a bin add
// once, which matters because sparse rows put most ranks in the +inf bin),
// then adds each nonzero bin to the zeroed (D, 256) output with one global
// atomic.  The ragged tail is masked, not padded, so the histogram is the
// one of the unpadded block.
//
// Bit parity with the reference (which runs under XLA with float32
// subnormals flushed to zero): a subnormal weight is flushed to 0 and a
// subnormal rank to 0 explicitly; the division is the correctly rounded
// __fdiv_rn; nothing here is built with fast-math or -ftz.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;            // elements per thread per block
constexpr int CHUNK = THREADS * PER_THREAD;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t M1 = 0x21F0AAADu;
constexpr uint32_t M2 = 0x735A2D97u;
constexpr float UNIT = 1.0f / 16777216.0f;  // 2^-24

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 15;
  x *= M2;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}

// VARIANT: 0 = l2, 1 = l1, 2 = uniform
template <int VARIANT>
__device__ __forceinline__ float weight(float v) {
  if (VARIANT == 0) return flush(__fmul_rn(v, v));
  if (VARIANT == 1) return flush(fabsf(v));
  return flush(v) != 0.0f ? 1.0f : 0.0f;
}

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

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
hash_rank_hist_kernel(const float* __restrict__ vals, float* __restrict__ h_out,
                      float* __restrict__ rank, int* __restrict__ hist,
                      int64_t n, uint32_t seed) {
  __shared__ int sh[NBINS];
  for (int i = threadIdx.x; i < NBINS; i += blockDim.x) sh[i] = 0;
  __syncthreads();
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
    const unsigned act = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      const uint32_t h = mix32((uint32_t)j * GOLDEN + seed);
      const float hu = __fmul_rn(__fadd_rn((float)(h >> 8), 0.5f), UNIT);
      const float w = weight<VARIANT>(row[j]);
      float r = w > 0.0f ? __fdiv_rn(hu, w) : INFINITY;
      r = r < FLT_MIN ? 0.0f : r;
      rrow[j] = r;
      if (d == 0) h_out[j] = hu;
      hist_add(sh, act, (int)(__float_as_uint(r) >> 24));
    }
  }
  flush_hist(sh, hist + d * NBINS);
}

__global__ void __launch_bounds__(THREADS)
rank_hist_kernel(const float* __restrict__ keys, const int* __restrict__ prefix,
                 int* __restrict__ hist, int64_t n, int shift) {
  __shared__ int sh[NBINS];
  for (int i = threadIdx.x; i < NBINS; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int64_t d = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * CHUNK;
  const int64_t end = min(start + (int64_t)CHUNK, n);
  const float* row = keys + d * n;
  const uint32_t pre = (uint32_t)prefix[d];
  for (int64_t base = start; base < end; base += THREADS) {
    const int64_t j = base + threadIdx.x;
    bool on = j < end;
    uint32_t u = 0;
    if (on) {
      u = __float_as_uint(row[j]);
      // shift 24 is the top level: every key is active (and u >> 32 is
      // undefined in C++, so it is never evaluated)
      on = shift >= 24 || (u >> (shift + 8)) == pre;
    }
    const unsigned act = __ballot_sync(0xffffffffu, on);
    if (on) hist_add(sh, act, (int)((u >> shift) & 0xFFu));
  }
  flush_hist(sh, hist + d * NBINS);
}

}  // namespace

extern "C" {

// vals (D, n) f32, h_out (n,) f32, rank (D, n) f32, hist (D, 256) int32
// zeroed by the caller.  variant: 0 l2, 1 l1, 2 uniform.
int repro_hash_rank_hist(const float* vals, float* h_out, float* rank,
                         int* hist, int64_t D, int64_t n, uint32_t seed,
                         int variant, void* stream) {
  if (D <= 0 || n <= 0) return 0;
  const dim3 grid((unsigned)((n + CHUNK - 1) / CHUNK), (unsigned)D);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    hash_rank_hist_kernel<0><<<grid, THREADS, 0, s>>>(vals, h_out, rank, hist, n, seed);
  else if (variant == 1)
    hash_rank_hist_kernel<1><<<grid, THREADS, 0, s>>>(vals, h_out, rank, hist, n, seed);
  else if (variant == 2)
    hash_rank_hist_kernel<2><<<grid, THREADS, 0, s>>>(vals, h_out, rank, hist, n, seed);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// keys (D, n) f32 (nonnegative), prefix (D,) int32, hist (D, 256) int32
// zeroed by the caller.  shift in {0, 8, 16, 24}.
int repro_rank_hist(const float* keys, const int* prefix, int* hist, int64_t D,
                    int64_t n, int shift, void* stream) {
  if (D <= 0 || n <= 0) return 0;
  if (shift != 0 && shift != 8 && shift != 16 && shift != 24)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + CHUNK - 1) / CHUNK), (unsigned)D);
  rank_hist_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(keys, prefix, hist,
                                                               n, shift);
  return (int)cudaGetLastError();
}

}  // extern "C"
