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
// used.  Bound on the card: memory -- the vector is read once (n * 4 bytes)
// and the table written once (m * 4).  At its callers' sizes (n up to 1e5,
// m up to 600: under 0.5 MB) that is well under a microsecond, so the time
// is the launch and the chain of dependent steps.  Two paths, chosen by m:
//
// One launch (m <= one_pass_max_m(): 16 warps' tables and a receive
// buffer fit in 227 KiB of shared memory, m <= 3417).  One thread-block
// cluster of up to 16 blocks (a block per 1024 inputs, at least one; 16 is
// a non-portable cluster size, so the device is asked once what it can
// hold), 16 warps a block; the inputs are cut into contiguous, ascending
// ranges, one a warp, in (block, warp) order, each a multiple of 32 long.
// A warp hashes four 32-input steps at once, then takes them in order: in
// a step one ballot a bit of the bucket groups the lanes whose inputs
// share a bucket (cheaper here than __match_any_sync), and the group's
// first lane adds the members' signed values, fetched by shuffles, in lane
// order (= j order) to the warp's own (m,) table in shared memory.  The
// groups of a step hold distinct buckets, so each entry has one writer.
// The block adds its 16 tables in warp order.  Bucket b belongs to block
// b % nb: every block writes its entries into their owners' shared memory
// (distributed shared memory), and after one cluster barrier each owner
// adds the blocks' entries in rank order and writes out once; no block
// reads another's memory, so none waits at a second barrier.  No scratch
// in device memory, no second launch.  The time at the callers' sizes is
// the cluster's launch and barrier and the per-step chain, not bytes.
// Past 1e5 inputs one cluster (16 SMs) gets slow in n; no caller goes
// there.
//
// Two passes (larger m, whose tables do not fit):
//   pass 1 (one block per CHUNK inputs): each thread hashes ITEMS inputs;
//     the block sorts its (bucket, signed value) pairs by bucket with a
//     block radix sort (stable: within a bucket the inputs stay in
//     ascending j); each bucket's sum over the chunk is then taken in that
//     order by one thread, found by binary search in the sorted keys, and
//     written to the chunk's row of the (chunks, m) partial table (a
//     scratch the caller allocates) -- every entry written once, 0 where
//     the chunk has no input of that bucket;
//   pass 2 (one thread per bucket): out[b] = sum of partial[c][b] over the
//     chunks c in ascending order.
// Each sum on either path is taken in a fixed order that depends on n, m
// and the device's largest cluster alone, so the table is the same bits
// from launch to launch.
#include <cooperative_groups.h>
#include <cub/block/block_radix_sort.cuh>

#include "sketch_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------ one launch
constexpr int CS_WARPS = 16;
constexpr int CS_THREADS = 32 * CS_WARPS;
constexpr int CS_STEPS = 4;               // 32-input steps loaded at once
constexpr int CS_MAX_CLUSTER = 16;        // a non-portable size on Hopper
constexpr int CS_BLOCK_INPUTS = 1024;     // inputs a block, at least
constexpr size_t SMEM_MAX = 232448;       // 227 KiB
constexpr unsigned FULL = 0xffffffffu;

// the warps' tables (warp 0's becomes the block's) and the cluster's
// receive buffer, ceil(m / nb) entries from each of up to 16 blocks
__host__ __device__ constexpr size_t one_pass_smem(int64_t m) {
  return ((size_t)(CS_WARPS + 1) * m + CS_MAX_CLUSTER) * 4;
}

// grid = one cluster of nb blocks (or one block); per = inputs a warp.
__global__ void __launch_bounds__(CS_THREADS)
countsketch_one_pass_kernel(const float* __restrict__ v, int64_t n,
                            unsigned m, unsigned seed_b, unsigned seed_s,
                            int64_t per, int nb, float* __restrict__ out) {
  extern __shared__ __align__(16) float cs_smem[];
  if (nb > 1) sketch::cluster_arrive_relaxed();    // this block has started
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* tbl = cs_smem + (size_t)warp * m;         // this warp's table
  float* recv = cs_smem + (size_t)CS_WARPS * m;    // [rank][m / nb]
  float4* tables = reinterpret_cast<float4*>(cs_smem);  // 16 m floats
  for (size_t i = threadIdx.x; i < (size_t)CS_WARPS * m / 4; i += CS_THREADS)
    tables[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const bool pow2 = (m & (m - 1)) == 0;
  const int key_bits = 32 - __clz(m);              // keys 0..m (m: none)
  const int64_t gw = (int64_t)blockIdx.x * CS_WARPS + warp;
  const int64_t lo = gw * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  for (int64_t j0 = lo; j0 < hi; j0 += 32 * CS_STEPS) {
    unsigned key[CS_STEPS];
    float sv[CS_STEPS];
#pragma unroll
    for (int t = 0; t < CS_STEPS; ++t) {
      const int64_t j = j0 + t * 32 + lane;
      const float x = j < hi ? __ldcs(v + j) : 0.0f;
      const unsigned h = (unsigned)j * sketch::GOLDEN;
      const unsigned hb = sketch::mix32(h + seed_b);
      key[t] = j < hi ? (pow2 ? (hb & (m - 1)) : (hb % m)) : m;
      sv[t] = (sketch::mix32(h + seed_s) & 1u) ? -x : x;
    }
#pragma unroll
    for (int t = 0; t < CS_STEPS; ++t) {
      if (j0 + t * 32 >= hi) break;                // the whole warp
      // the lanes whose key equals this lane's: one vote a bit of the key
      unsigned grp = FULL;
      for (int k = 0; k < key_bits; ++k) {
        const unsigned bit = (key[t] >> k) & 1u;
        const unsigned vote = __ballot_sync(FULL, bit);
        grp &= bit ? vote : ~vote;
      }
      // the group's first lane adds the others' values in lane order
      const bool lead = key[t] < m && (grp & ((1u << lane) - 1u)) == 0;
      unsigned rest = lead ? grp & (grp - 1) : 0u;
      float sum = sv[t];
      while (__any_sync(FULL, rest != 0)) {
        const float o = __shfl_sync(FULL, sv[t], rest ? __ffs(rest) - 1 : lane);
        if (rest) {
          sum = __fadd_rn(sum, o);
          rest &= rest - 1;
        }
      }
      if (lead) tbl[key[t]] = __fadd_rn(tbl[key[t]], sum);
      __syncwarp();
    }
  }
  __syncthreads();
  // the block's table: the warps' tables in warp order, into warp 0's
  for (unsigned b = threadIdx.x; b < m; b += CS_THREADS) {
    float sum = cs_smem[b];
#pragma unroll
    for (int w = 1; w < CS_WARPS; ++w)
      sum = __fadd_rn(sum, cs_smem[(size_t)w * m + b]);
    if (nb == 1) out[b] = sum;
    else cs_smem[b] = sum;
  }
  if (nb == 1) return;
  // bucket b belongs to block b % nb: each block sends its entries to
  // their owners' receive buffers (every block has started, so its shared
  // memory is there), one barrier, then each owner adds the blocks' entries
  // in rank order, from its own shared memory only
  const cg::cluster_group cl = cg::this_cluster();
  const unsigned r = cl.block_rank();
  const unsigned len = (m + nb - 1) / nb;
  sketch::cluster_wait();
  for (unsigned b = threadIdx.x; b < m; b += CS_THREADS)
    cl.map_shared_rank(recv, b % nb)[r * len + b / nb] = cs_smem[b];
  cl.sync();
  for (unsigned i = threadIdx.x; r + i * nb < m; i += CS_THREADS) {
    float t[CS_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < CS_MAX_CLUSTER; ++q)
      t[q] = q < nb ? recv[q * len + i] : 0.0f;
    float sum = t[0];
#pragma unroll
    for (int q = 1; q < CS_MAX_CLUSTER; ++q)
      if (q < nb) sum = __fadd_rn(sum, t[q]);
    out[r + i * nb] = sum;
  }
}

// Blocks a cluster may hold on this device at the largest table (up to
// CS_MAX_CLUSTER), once a device; the kernel's attributes set with it.
int max_cluster(int* nb) {
  return sketch::once_per_device(nb, [](int, int* size) {
    cudaError_t e = cudaFuncSetAttribute(
        countsketch_one_pass_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(countsketch_one_pass_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CS_MAX_CLUSTER);
    cfg.blockDim = dim3(CS_THREADS);
    cfg.dynamicSmemBytes = SMEM_MAX;
    e = cudaOccupancyMaxPotentialClusterSize(size, countsketch_one_pass_kernel,
                                             &cfg);
    if (e != cudaSuccess) return e;
    *size = *size > CS_MAX_CLUSTER ? CS_MAX_CLUSTER : *size < 1 ? 1 : *size;
    return cudaSuccess;
  });
}

int launch_one_pass(const float* v, int64_t n, int64_t m, unsigned seed_b,
                    unsigned seed_s, float* out, cudaStream_t s) {
  int cap = 1;
  const int err = max_cluster(&cap);
  if (err) return err;
  int nb = (int)((n + CS_BLOCK_INPUTS - 1) / CS_BLOCK_INPUTS);
  nb = nb < 1 ? 1 : nb > cap ? cap : nb;
  const int64_t warps = (int64_t)nb * CS_WARPS;
  const int64_t per = ((n + warps - 1) / warps + 31) / 32 * 32;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nb);
  cfg.blockDim = dim3(CS_THREADS);
  cfg.dynamicSmemBytes = one_pass_smem(m);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = nb > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, countsketch_one_pass_kernel, v, n, (unsigned)m, seed_b, seed_s,
      per, nb, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ two passes

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

// The largest m the one-launch path takes (3417).
int repro_countsketch_one_pass_max_m(void) {
  return (int)((SMEM_MAX / 4 - CS_MAX_CLUSTER) / (CS_WARPS + 1));
}

// v (n,) f32 -> out (m,) f32; seed_b and seed_s are the two hash streams'
// 32-bit seeds.  partial: for m > repro_countsketch_one_pass_max_m() a
// (ceil(n / CHUNK), m) f32 scratch (CHUNK = 4096, the Python wrapper's
// CHUNK); otherwise unused (may be null).
int repro_countsketch(const float* v, int64_t n, int64_t m, unsigned seed_b,
                      unsigned seed_s, float* out, float* partial,
                      void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (m >= 0x7FFFFFFF || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (m <= repro_countsketch_one_pass_max_m())
    return launch_one_pass(v, n, m, seed_b, seed_s, out, s);
  if (partial == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t chunks = (n + CHUNK - 1) / CHUNK;
  if (chunks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int end_bit = 0;  // bits of the largest key, m (the padding key)
  while (end_bit < 32 && (((int64_t)1) << end_bit) <= m) ++end_bit;
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
