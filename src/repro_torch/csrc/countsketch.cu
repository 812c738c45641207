// CountSketch construction for Hopper (sm_90a).
//
// countsketch kernels replace the Pallas kernel
//   src/repro/kernels/countsketch/countsketch.py::countsketch_pallas
// One (n,) float32 vector -> the (m,) table
//   out[bucket(j)] += sign(j) * v_j
//   bucket(j) = mix32(j * GOLDEN + seed_b) & (m - 1)   (m a power of two)
//             = mix32(j * GOLDEN + seed_b) % m         (otherwise)
//   sign(j)   = +1 if the low bit of mix32(j * GOLDEN + seed_s) is 0, else -1
// with mix32 and GOLDEN from sketch_common.cuh (the reference's hash streams,
// so a table built here matches one built by repro.core.hashing).
//
// The TPU kernel multiplies each input tile by a one-hot (L, m) matrix made
// from the hash, because the TPU has no fast scatter.  Here it is a
// scatter-add that must give the same bits on every launch: a float atomic
// add into memory sums in whatever order the threads arrive, so none is
// used.  Design:
//   pass 1 (one block per CHUNK inputs): each thread hashes ITEMS inputs;
//     the block sorts its (bucket, signed value) pairs by bucket with a
//     block radix sort (stable: within a bucket the inputs stay in
//     ascending j); each bucket's sum over the chunk is then taken in that
//     order by one thread, found by binary search in the sorted keys, and
//     written to the chunk's row of the (chunks, m) partial table — every
//     entry written once, 0 where the chunk has no input of that bucket;
//   pass 2 (one thread per bucket): out[b] = sum of partial[c][b] over the
//     chunks c in ascending order.
// Each sum is taken in a fixed order, so the table is the same bits from
// launch to launch.
//
// Bound on the card: memory — the vector is read once (n * 4 bytes) and
// the table written once (m * 4).  At the sizes of its callers (n up to
// 1e5, m up to 600: under 0.5 MB) the bound is well under a microsecond
// and the time is that of two launches.
#include <cub/block/block_radix_sort.cuh>

#include "sketch_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int CHUNK = THREADS * ITEMS;  // inputs per block of pass 1

using BlockSort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, float>;

union Pass1Smem {
  typename BlockSort::TempStorage sort;
  struct {
    unsigned keys[CHUNK];
    float vals[CHUNK];
  } sorted;
};

// first position in keys[0, CHUNK) whose key is >= b (keys ascending)
__device__ __forceinline__ int lower_bound(const unsigned* keys, unsigned b) {
  int lo = 0, hi = CHUNK;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < b) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
countsketch_partial_kernel(const float* __restrict__ v, int64_t n, unsigned m,
                           unsigned seed_b, unsigned seed_s, int end_bit,
                           float* __restrict__ partial) {
  __shared__ Pass1Smem smem;
  const int64_t base = (int64_t)blockIdx.x * CHUNK;
  const bool pow2 = (m & (m - 1)) == 0;
  unsigned keys[ITEMS];
  float vals[ITEMS];
  // blocked arrangement: thread t holds inputs base + t*ITEMS + [0, ITEMS),
  // so after the stable sort equal buckets keep ascending j
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t j = base + (int64_t)threadIdx.x * ITEMS + i;
    if (j < n) {
      const unsigned x = (unsigned)j * sketch::GOLDEN;
      const unsigned hb = sketch::mix32(x + seed_b);
      const unsigned hs = sketch::mix32(x + seed_s);
      keys[i] = pow2 ? (hb & (m - 1)) : (hb % m);
      vals[i] = (hs & 1u) ? -v[j] : v[j];
    } else {
      keys[i] = m;  // padding sorts after every bucket and is never summed
      vals[i] = 0.0f;
    }
  }
  BlockSort(smem.sort).Sort(keys, vals, 0, end_bit);
  __syncthreads();  // the sort's storage is reused below
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    smem.sorted.keys[threadIdx.x * ITEMS + i] = keys[i];
    smem.sorted.vals[threadIdx.x * ITEMS + i] = vals[i];
  }
  __syncthreads();
  float* row = partial + (int64_t)blockIdx.x * m;
  for (unsigned b = threadIdx.x; b < m; b += THREADS) {
    const int hi = lower_bound(smem.sorted.keys, b + 1);
    float acc = 0.0f;
    for (int i = lower_bound(smem.sorted.keys, b); i < hi; ++i)
      acc = __fadd_rn(acc, smem.sorted.vals[i]);
    row[b] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
countsketch_reduce_kernel(const float* __restrict__ partial, int chunks,
                          unsigned m, float* __restrict__ out) {
  const unsigned b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= m) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c)
    acc = __fadd_rn(acc, partial[(int64_t)c * m + b]);
  out[b] = acc;
}

}  // namespace

extern "C" {

// v (n,) f32; partial (ceil(n / CHUNK), m) f32 scratch (CHUNK = 4096,
// the Python wrapper's CHUNK); out (m,) f32.
// seed_b and seed_s are the two hash streams' 32-bit seeds.
int repro_countsketch(const float* v, int64_t n, int64_t m, unsigned seed_b,
                      unsigned seed_s, float* partial, float* out,
                      void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (m >= 0x7FFFFFFF || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int64_t chunks = (n + CHUNK - 1) / CHUNK;
  if (chunks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int end_bit = 0;  // bits of the largest key, m (the padding key)
  while (end_bit < 32 && (((int64_t)1) << end_bit) <= m) ++end_bit;
  const cudaStream_t s = (cudaStream_t)stream;
  countsketch_partial_kernel<<<(unsigned)chunks, THREADS, 0, s>>>(
      v, n, (unsigned)m, seed_b, seed_s, end_bit, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + THREADS - 1) / THREADS);
  countsketch_reduce_kernel<<<blocks, THREADS, 0, s>>>(
      partial, (int)chunks, (unsigned)m, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
