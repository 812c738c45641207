// Exact per-row k-th smallest key in one launch, for Hopper (sm_90a).
//
// radix_select replaces the four-level histogram descent over
//   src/repro/kernels/sketch_build/sketch_build.py::rank_hist_pallas
// (driven by src/repro/kernels/sketch_build/ops.py::_kth_smallest_bits_pallas):
// the k-th smallest of each row of (D, n) nonnegative float32 keys (+inf
// allowed, no NaN).  Nonnegative floats order like their bit patterns, so
// the k-th smallest is found one byte at a time from the top: count the
// 256 values of the next byte among the keys that share the bytes found so
// far, take the first bin whose running count reaches k, rebase k and go
// down.  The result is the exact k-th key, bit-equal to torch.kthvalue and
// to the plain descent (ref.py).
//
// Bound on the card: memory, one read of the (D, n) block (D*n*4 bytes;
// the level-0 histogram, when the caller has it from the hash/rank pass,
// is 1 KiB a row).  Design: a thread-block cluster owns a row and runs
// every level on chip, so a selection is one launch with no host round
// trip.  At large D the cluster is one block; when the rows are too few to
// fill the card (one vector: the store's add, the join path's sketches) it
// is up to eight blocks, each streaming its own slice of the row and
// counting it into its own histogram, the cluster's histograms summed
// through distributed shared memory before every choice:
// - level 0 comes from hist0 when given; otherwise one streaming pass
//   counts it;
// - the bin holding the k-th key is found by one warp: each lane sums 8
//   bins, a shuffle scan over the lanes, a ballot for the first lane that
//   reaches k;
// - when that bin's keys fit in shared memory (CAP keys), one pass over the
//   row compacts them there (warp-aggregated slot claims; each block keeps
//   its slice's) and the lower levels count the candidates in shared
//   memory only;
// - when they do not (a row whose keys share a top byte), the next level
//   re-reads the row under the prefix, inside this kernel, and tries again;
//   each such pass also takes the min and max of the keys under the prefix,
//   so a bin of equal keys (an all-+inf row) ends the search at once.
// Streaming passes read 16 bytes a thread, four loads in flight, with the
// row's unaligned head and tail read one key a thread.  Histograms use
// warp-aggregated shared atomics (integer only; the lanes that share a bin
// add once).  Nothing is built with fast-math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int NBINS = 256;
constexpr int CAP = 8192;                 // candidate keys held on chip
constexpr int UNROLL = 4;                 // 16-byte loads in flight a thread
constexpr int MAX_CLUSTER = 8;            // blocks a row (portable size)
constexpr int MIN_SLICE = 4096;           // keys a block streams, at least
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NAN_BITS = 0x7FC00000u;

struct Shared {
  int hist[NBINS];                        // the row's counts
  int part[2][NBINS];                     // this block's counts, two levels
  uint32_t cand[CAP];                     // this block's candidates
  int n_cand;
  uint32_t prefix;                        // bits at and above `shift` found
  int remaining;                          // rank of the target in its bin
  int count;                              // keys in the chosen bin
  uint32_t kmin, kmax;                    // the row's keys under the prefix
  uint32_t pmin[2], pmax[2];              // this block's
  int bad;                                // k beyond the keys
};

__device__ __forceinline__ void hist_add(int* sh, unsigned active, int bin) {
  const unsigned peers = __match_any_sync(active, bin);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&sh[bin], __popc(peers));
}

// Call f(u, valid) for every key of the row, each warp-wide (every lane of
// every warp takes part in each call, so f may use warp votes).
template <class F>
__device__ __forceinline__ void for_each_key(const uint32_t* __restrict__ r,
                                             int n, F&& f) {
  const int mis = (int)(((uintptr_t)r >> 2) & 3);
  const int head = min(n, mis ? 4 - mis : 0);
  {
    const bool v = (int)threadIdx.x < head;
    f(v ? r[threadIdx.x] : 0u, v);
  }
  const uint4* body = reinterpret_cast<const uint4*>(r + head);
  const int nv = (n - head) >> 2;
  for (int base = 0; base < nv; base += THREADS * UNROLL) {
    uint4 x[UNROLL];
    bool v[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      const int i = base + q * THREADS + (int)threadIdx.x;
      v[q] = i < nv;
      x[q] = v[q] ? __ldg(body + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      f(x[q].x, v[q]);
      f(x[q].y, v[q]);
      f(x[q].z, v[q]);
      f(x[q].w, v[q]);
    }
  }
  const int tail0 = head + nv * 4;
  {
    const int j = tail0 + (int)threadIdx.x;
    const bool v = j < n && (int)threadIdx.x < 4;
    f(v ? r[j] : 0u, v);
  }
}

// Warp 0: the first bin whose running count reaches s.remaining; extends
// the prefix by it and rebases the rank.  Ends with the block synchronised.
__device__ __forceinline__ void choose_bin(Shared& s) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int c[8], sum = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      c[q] = s.hist[lane * 8 + q];
      sum += c[q];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    const int rem = s.remaining;
    const unsigned reach = __ballot_sync(FULL, incl >= rem);
    if (reach == 0) {
      if (lane == 0) s.bad = 1;
    } else if (lane == __ffs(reach) - 1) {
      int cum = incl - sum, q = 0;
      while (cum + c[q] < rem) cum += c[q++];
      s.prefix = (s.prefix << 8) | (uint32_t)(lane * 8 + q);
      s.remaining = rem - cum;
      s.count = c[q];
    }
  }
  __syncthreads();
}

// Zero this block's counts and min/max in buffer b before a counting pass.
__device__ __forceinline__ void clear_part(Shared& s, int b) {
  for (int i = threadIdx.x; i < NBINS; i += THREADS) s.part[b][i] = 0;
  if (threadIdx.x == 0) {
    s.pmin[b] = 0xFFFFFFFFu;
    s.pmax[b] = 0u;
  }
  __syncthreads();
}

// Fold each thread's min and max of the keys it counted into the block's.
__device__ __forceinline__ void fold_minmax(Shared& s, int b, uint32_t lo,
                                            uint32_t hi) {
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s.pmin[b], lo);
    atomicMax(&s.pmax[b], hi);
  }
}

// The row's counts, min and max from buffer b of every block of the
// cluster (nb blocks), read through distributed shared memory (integer
// sums: the order does not matter).  Every block calls it at the same
// point.  Levels alternate buffers, so one cluster barrier a level is
// enough: a block clears buffer b again only two levels on, after a barrier
// that every block reaches once its reads of buffer b are done.
__device__ __forceinline__ void reduce_cluster(Shared& s, int b, int nb,
                                               const cg::cluster_group& cl) {
  if (nb == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < NBINS; i += THREADS) s.hist[i] = s.part[b][i];
    if (threadIdx.x == 0) {
      s.kmin = s.pmin[b];
      s.kmax = s.pmax[b];
    }
    __syncthreads();
    return;
  }
  cl.sync();
  for (int i = threadIdx.x; i < NBINS; i += THREADS) {
    int t = 0;
    for (int q = 0; q < nb; ++q) t += cl.map_shared_rank(s.part[b], q)[i];
    s.hist[i] = t;
  }
  if (threadIdx.x == 0) {
    uint32_t lo = 0xFFFFFFFFu, hi = 0u;
    for (int q = 0; q < nb; ++q) {
      const Shared* o = cl.map_shared_rank(&s, q);
      lo = min(lo, o->pmin[b]);
      hi = max(hi, o->pmax[b]);
    }
    s.kmin = lo;
    s.kmax = hi;
  }
  __syncthreads();
}

// nb blocks a row, launched as clusters of nb when nb > 1.  Every block of
// a row's cluster takes the same branches (they depend only on the row's
// counts, which each block holds whole), so the cluster barriers match.
__global__ void __launch_bounds__(THREADS)
radix_select_kernel(const float* __restrict__ keys, const int* __restrict__ hist0,
                    const int64_t* __restrict__ kvec, int64_t kscalar,
                    float* __restrict__ out, int n, int nb) {
  __shared__ Shared s;
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = nb > 1 ? (int)cl.block_rank() : 0;
  const int64_t row = blockIdx.x / nb;
  int buf = 0;                            // this level's count buffer
  // this block's slice of the row, a multiple of four keys long
  const int chunk = ((n + nb - 1) / nb + 3) & ~3;
  const int lo0 = min(n, rank * chunk);
  const int len = min(n - lo0, chunk);
  const uint32_t* r =
      reinterpret_cast<const uint32_t*>(keys) + row * (int64_t)n + lo0;
  const int64_t k = kvec ? kvec[row] : kscalar;
  if (k < 1 || k > n) {                   // no k-th key: NaN, as no key is
    if (rank == 0 && threadIdx.x == 0) out[row] = __uint_as_float(NAN_BITS);
    return;
  }
  if (threadIdx.x == 0) {
    s.prefix = 0;
    s.remaining = (int)k;
    s.n_cand = 0;
    s.bad = 0;
  }
  // ---- level 0: bits 31..24
  bool done = false;
  if (hist0) {
    for (int i = threadIdx.x; i < NBINS; i += THREADS)
      s.hist[i] = hist0[row * NBINS + i];
  } else {
    clear_part(s, buf);
    uint32_t lo = 0xFFFFFFFFu, hi = 0u;
    for_each_key(r, len, [&](uint32_t u, bool v) {
      const unsigned act = __ballot_sync(FULL, v);
      if (v) {
        hist_add(s.part[buf], act, (int)(u >> 24));
        lo = min(lo, u);
        hi = max(hi, u);
      }
    });
    fold_minmax(s, buf, lo, hi);
    reduce_cluster(s, buf, nb, cl);
    buf ^= 1;
  }
  choose_bin(s);
  if (!hist0 && s.kmin == s.kmax) {       // every key equal
    if (threadIdx.x == 0) s.prefix = s.kmin;
    done = true;
  }
  int shift = 24;                         // s.prefix holds bits >= shift
  // ---- lower levels on the row in global memory, while the bin is large
  while (!done && shift > 0 && s.count > CAP) {
    const uint32_t pre = s.prefix;
    const int sh = shift;
    __syncthreads();
    clear_part(s, buf);
    uint32_t lo = 0xFFFFFFFFu, hi = 0u;
    for_each_key(r, len, [&](uint32_t u, bool v) {
      const bool on = v && (u >> sh) == pre;
      const unsigned act = __ballot_sync(FULL, on);
      if (on) {
        hist_add(s.part[buf], act, (int)((u >> (sh - 8)) & 0xFFu));
        lo = min(lo, u);
        hi = max(hi, u);
      }
    });
    fold_minmax(s, buf, lo, hi);
    reduce_cluster(s, buf, nb, cl);
    buf ^= 1;
    if (s.kmin == s.kmax) {               // the bin holds one value
      __syncthreads();
      if (threadIdx.x == 0) s.prefix = s.kmin;
      done = true;
      break;
    }
    choose_bin(s);
    shift -= 8;
  }
  if (!done && shift > 0) {
    // ---- the bin fits on chip: compact its keys, then finish there
    {
      const uint32_t pre = s.prefix;
      const int sh = shift;
      const int lane = threadIdx.x & 31;
      for_each_key(r, len, [&](uint32_t u, bool v) {
        const bool on = v && (u >> sh) == pre;
        const unsigned b = __ballot_sync(FULL, on);
        if (b) {
          const int leader = __ffs(b) - 1;
          int base = 0;
          if (lane == leader) base = atomicAdd(&s.n_cand, __popc(b));
          base = __shfl_sync(FULL, base, leader);
          const int slot = base + __popc(b & ((1u << lane) - 1u));
          if (on && slot < CAP) s.cand[slot] = u;   // the row's bin <= CAP
        }
      });
    }
    __syncthreads();
    const int nc = min(s.n_cand, CAP);
    while (shift > 0) {
      const uint32_t pre = s.prefix;
      const int sh = shift;
      __syncthreads();
      clear_part(s, buf);
      for (int base = 0; base < nc; base += THREADS) {
        const int i = base + (int)threadIdx.x;
        const uint32_t u = i < nc ? s.cand[i] : 0u;
        const bool on = i < nc && (u >> sh) == pre;
        const unsigned act = __ballot_sync(FULL, on);
        if (on) hist_add(s.part[buf], act, (int)((u >> (sh - 8)) & 0xFFu));
      }
      reduce_cluster(s, buf, nb, cl);
      buf ^= 1;
      choose_bin(s);
      shift -= 8;
    }
  }
  __syncthreads();
  if (rank == 0 && threadIdx.x == 0)
    out[row] = __uint_as_float(s.bad ? NAN_BITS : s.prefix);
  if (nb > 1) cl.sync();                  // no block leaves while read
}

}  // namespace

extern "C" {

// keys (D, n) f32 nonnegative; hist0 (D, 256) int32 level-0 counts or null;
// k: kvec (D,) int64 or, when null, kscalar; out (D,) f32.  1 <= k <= n
// (a row whose k is outside gets NaN).
int repro_radix_select(const float* keys, const int* hist0, const int64_t* kvec,
                       int64_t kscalar, float* out, int64_t D, int64_t n,
                       void* stream) {
  if (D <= 0) return 0;
  if (n <= 0 || n > 0x7FFFFFFF || D > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // blocks a row: doubled while the grid still fits the card once and each
  // block keeps at least MIN_SLICE keys
  int nb = 1;
  while (nb < MAX_CLUSTER && D * nb * 2 <= sms && n / (nb * 2) >= MIN_SLICE)
    nb *= 2;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(D * nb));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = nb > 1 ? 1 : 0;          // one block a row: no cluster
  e = cudaLaunchKernelEx(&cfg, radix_select_kernel, keys, hist0, kvec, kscalar,
                         out, (int)n, nb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
