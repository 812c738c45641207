// Bucketized intersection estimators for Hopper (sm_90a).
//
// A bucketized sketch lays entry i into bucket hash(i) mod B with at most
// S slots a bucket; coordinated sketches share the bucket hash, so a shared
// coordinate sits in the same bucket on both sides and the join is, per
// bucket, an S x S id compare.
//
// intersect_estimate replaces the Pallas kernel
//   src/repro/kernels/intersect_estimate/intersect_estimate.py::intersect_estimate_pallas
// One (B, S) query against a (C, B, S) corpus -> (C,) estimates, each the
// sum over matched slots of q*c / min(min(1, tau_q q^2), min(1, tau_c c^2))
// (the divide form, l2 weights).  Bound on the card: memory.  Read whole,
// the corpus is C*B*S*8 bytes (the full stream); but only the buckets
// where the query holds an id can match (~40% of them at m = 256 in 512
// buckets), and only matched slots need their value, so the bytes the
// work needs are the id sectors of the query's buckets and the value
// sectors of the matches.  Design:
// - Each block stages the query once, as a compact list of its occupied
//   buckets (bucket number and the S ids, values and inclusion
//   probabilities), in ascending bucket order: a ballot and a scan of the
//   warps' counts, no extra launch, no host sync.  A block has 16 warps,
//   so the staging is paid once for 16 rows (or once for a row's 16
//   warps, below).
// - A warp takes a corpus row; lane l takes list entries l, l + 32, ...
//   (entry chunks of 32), four chunks at a time, so a lane has four
//   independent streaming loads (ld.global.cs) in flight.  At S = 4 a
//   bucket's ids are one 16-byte load and its values, loaded only where
//   an id matches, another; any other S loads slot by slot.
// - When the rows are too few to fill the card (C <= the SM count: the
//   join-size panel's 2-3 rows), a block takes one row and its 16 warps
//   split the row's chunks (warp w: chunks w, w + 16, ...).
// Order of summation, the same in both layouts: lane l folds the terms of
// its entries chunk by chunk in ascending chunk order (each entry's
// matched terms summed first), then the 32 lanes are added in a fixed
// shuffle tree.  A row's bits thus depend only on the row and the query,
// not on C, the layout or the other rows; no float atomics.
//
// allpairs_compact and allpairs_join replace
//   src/repro/kernels/intersect_estimate/intersect_estimate.py::allpairs_estimate_pallas
// (D1, B, S) x (D2, B, S) with per-slot inclusion probabilities ->
// (D1, D2) estimates sum eq * va * vb * max(1/pa, 1/pb), or with MOMENTS
// the six Eq. (9) channels (n, sum_x, sum_y, xy, sum_x2, sum_y2) ->
// (D1, D2, 6).  Bound on the card: the bytes (both corpora read once, the
// output written once) or the compares the data needs — per bucket, the
// occupied A slots times the occupied B slots — on the CUDA cores (an
// equality join: no product for the tensor cores), whichever is larger.
// A row keeps m of its B*S slots (an eighth at the serving widths), so the
// work has to follow the occupied slots.  Design, in two launches:
// - allpairs_compact: for each tile of 64 rows and each bucket, the
//   occupied slots of those rows (idx != INVALID) as 16-byte entries (id,
//   row in tile | entries with this id << 8, v, 1/p), sorted by id (ties in row, slot order), and
//   their count; 1/p is taken once a slot (__fdiv_rn), and padding never
//   reaches the join.  A warp takes a bucket: its lanes gather the rows'
//   slots into shared memory (a shuffle scan for the positions), then
//   place each entry at its rank.  One corpus compacted once serves both
//   sides of all_pairs.
// - allpairs_join, plain mode: one block a 64 x 64 output tile; its warps
//   take the buckets in turn (warp w: w, w + W, ...), each into sums of
//   its own in shared memory, so no warp waits for another.  Per bucket a
//   warp holds the A list's first 64 entries in registers (two a lane) and
//   stages the B list with cp.async into a ring of two, one bucket ahead
//   of the compares (the counts two ahead).  It is a sort-merge join: each
//   lane finds its A id in the id-sorted B list by binary search, which
//   gives the run of equal ids it matches, and the matched pairs are then
//   dealt out one a lane, in list order, so the work is the matches (~3%
//   of the slot pairs a bucket shares at the serving widths) and a log of
//   the list, not every pair.  Pairs that fall on one cell in one batch of
//   32 add one at a time, in pair order.  No float atomics: each warp sums
//   a cell in ascending bucket order and within a bucket in ascending id
//   order, the warps' sums are added in warp order, so a cell's bits
//   depend on its two rows alone (the same on every launch, and whatever
//   other rows the corpora hold).
// - allpairs_join_tiles, the discovery scans' batches: the same join on
//   a list of (A tile, B tile) pairs, one launch a batch.  The scan
//   compacts each corpus once, with a row list that lays its scan tiles
//   (rows in descending-norm order) into the compacted tiles, and then
//   joins the visited tile pairs in batches.  A tile alone is one block
//   on one of 132 SMs, and a tile of the heaviest columns, whose samples
//   share most ids, deals out thousands of matches a bucket; so each
//   pair runs as `groups` blocks, block g joining only the A entries of
//   its 64 / groups rows into sums of its own.  A cell's adds stay the
//   plain join's, in its order (its row's group sees all of its pairs):
//   a tile's bits are the plain join's whatever the list, the batch and
//   the groups are.  B lists are staged up to 128 entries (the plain
//   join: 64), so a heavy tile's lists at S = 2 stay in shared memory.
// - allpairs_join, moments mode (six sums a cell): one block of 16 warps a
//   64 x 64 tile, and each cell owned by one warp.  Warp w owns the A rows
//   w, w + 16, w + 32, w + 48 of the tile and keeps their cells' sums in
//   a region of shared memory of its own, so no two warps write one cell
//   and nothing is summed across warps.
//   - Batches: the buckets go 16 at a time, one barrier a batch.  Warp v
//     stages bucket v's A and B lists with cp.async into one of two
//     buffers (each side's lists of the batch end to end, 1024 entries at
//     most; a list that does not fit is read from global memory) a batch
//     ahead of the join, and the counts two batches ahead.  After the
//     batch's join, warp v bins bucket v's A entries of the next batch by
//     owner warp (row % 16), each owner's in list order (a match-any vote
//     a 32 entries), so each entry is looked at once.
//   - The join of a batch, per warp: its entries in (bucket, id) order, 32
//     at a time.  Each lane finds its entry's run of equal ids in the
//     bucket's B list by binary search; the matched pairs, in (entry,
//     run) order, are dealt out 32 at a time, one a lane, and added to
//     their cells.  The pairs of one entry fall on distinct cells and add
//     at once; pairs of several entries that share a cell (a vote on the
//     cell's bits) add in rounds, in lane order.
//   - Order: a row holds an id once, so a cell takes at most one pair an
//     id and adds its pairs in ascending (bucket, id) order, one at a
//     time: its bits depend on its two rows alone, whatever D1, D2 and
//     the other rows are.
//   - Mirror: when both sides are the same compacted corpus (the
//     correlation matrix), one block a tile pair ta <= tb (the diagonal
//     first) also writes tile (tb, ta).  Its cell (b, a) holds the same
//     pairs in the same order with x and y swapped, and the products and
//     fmaxf commute, so the mirrored channels (n, sum_y, sum_x, xy,
//     sum_y2, sum_x2) are the bits a direct launch would give.
//   The sums (96 KiB) and the lists hold an SM to one block of 16 warps;
//   the join waits on the SM's shuffles and shared-memory accesses (the
//   staging, the binning, the search, the deal), not on bytes.
// Sums run in another order than the reference's, so estimates agree
// within float32 summation tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sketch_common.cuh"

namespace {

constexpr int INVALID = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- query
constexpr int Q_WARPS = 16;               // warps a block
constexpr int Q_THREADS = 32 * Q_WARPS;
constexpr int Q_UNROLL = 4;               // chunks (loads) in flight a lane

// Dynamic shared memory of the query kernels: the list (ids, values and
// probabilities, S a bucket, then the bucket numbers) and, for the split
// layout, one term a lane a chunk.
__host__ __device__ constexpr size_t query_smem(int B, int S) {
  return (size_t)B * S * 12 + (size_t)B * 4 + (size_t)((B + 31) / 32) * 128;
}

struct QueryList {
  const int* id;     // (L, S)
  const float* v;    // (L, S)
  const float* p;    // (L, S)
  const int* b;      // (L,)
  int n;             // L
};

// The query's occupied buckets, in ascending bucket order, into shared
// memory; every thread of the block calls it.
template <bool VEC>
__device__ QueryList stage_query(const int* __restrict__ q_idx,
                                 const float* __restrict__ q_val,
                                 const float* __restrict__ q_tau, int B,
                                 int S, unsigned char* smem) {
  __shared__ int wcount[Q_WARPS];
  int* lid = reinterpret_cast<int*>(smem);
  float* lv = reinterpret_cast<float*>(lid + (size_t)B * S);
  float* lp = lv + (size_t)B * S;
  int* lb = reinterpret_cast<int*>(lp + (size_t)B * S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float qt = q_tau[0];
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += Q_THREADS) {
    const int b = b0 + threadIdx.x;
    bool occ = false;
    int4 id4 = make_int4(INVALID, INVALID, INVALID, INVALID);
    if (b < B) {
      if (VEC) {
        id4 = __ldg(reinterpret_cast<const int4*>(q_idx) + b);
        occ = id4.x != INVALID || id4.y != INVALID || id4.z != INVALID ||
              id4.w != INVALID;
      } else {
        for (int s = 0; s < S; ++s)
          occ |= __ldg(q_idx + (size_t)b * S + s) != INVALID;
      }
    }
    const unsigned bal = __ballot_sync(FULL, occ);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int pos = base + __popc(bal & ((1u << lane) - 1u)), total = base;
#pragma unroll
    for (int w = 0; w < Q_WARPS; ++w) {
      const int c = wcount[w];
      pos += w < warp ? c : 0;
      total += c;
    }
    if (occ) {
      lb[pos] = b;
      if (VEC) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(q_val) + b);
        reinterpret_cast<int4*>(lid)[pos] = id4;
        reinterpret_cast<float4*>(lv)[pos] = v;
        reinterpret_cast<float4*>(lp)[pos] = make_float4(
            fminf(1.0f, __fmul_rn(qt, __fmul_rn(v.x, v.x))),
            fminf(1.0f, __fmul_rn(qt, __fmul_rn(v.y, v.y))),
            fminf(1.0f, __fmul_rn(qt, __fmul_rn(v.z, v.z))),
            fminf(1.0f, __fmul_rn(qt, __fmul_rn(v.w, v.w))));
      } else {
        for (int s = 0; s < S; ++s) {
          const size_t o = (size_t)b * S + s, d = (size_t)pos * S + s;
          const float v = __ldg(q_val + o);
          lid[d] = __ldg(q_idx + o);
          lv[d] = v;
          lp[d] = fminf(1.0f, __fmul_rn(qt, __fmul_rn(v, v)));
        }
      }
    }
    base = total;
    __syncthreads();                        // wcount is reused; list ready
  }
  return QueryList{lid, lv, lp, lb, base};
}

__device__ __forceinline__ int comp(const int4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}
__device__ __forceinline__ float comp(const float4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}

// The terms of Q_UNROLL chunks of one corpus row: chunks k0 + u*step,
// u < Q_UNROLL (none from K on).  x[u] is the sum of the matched terms of
// this lane's entry in that chunk (0 where it has none), corpus slot by
// corpus slot, query slot by query slot.  All the id loads are issued
// before any is used, then the value loads of the matched buckets.
template <bool VEC>
__device__ __forceinline__ void chunk_terms(float (&x)[Q_UNROLL], int k0,
                                            int step, int K,
                                            const QueryList& q,
                                            const int* __restrict__ ci,
                                            const float* __restrict__ cv,
                                            float ct, int S) {
  const int lane = threadIdx.x & 31;
  int e[Q_UNROLL];                          // list entry, -1 for none
#pragma unroll
  for (int u = 0; u < Q_UNROLL; ++u) {
    const int i = (k0 + u * step) * 32 + lane;
    e[u] = k0 + u * step < K && i < q.n ? i : -1;
    x[u] = 0.0f;
  }
  if (VEC) {
    const int4* ci4 = reinterpret_cast<const int4*>(ci);
    const float4* cv4 = reinterpret_cast<const float4*>(cv);
    const int4 none = make_int4(INVALID, INVALID, INVALID, INVALID);
    int4 c[Q_UNROLL];
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u)
      c[u] = e[u] >= 0 ? __ldcs(ci4 + q.b[e[u]]) : none;
    int4 qi[Q_UNROLL];
    bool hit[Q_UNROLL];
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      qi[u] = e[u] >= 0 ? reinterpret_cast<const int4*>(q.id)[e[u]] : none;
      bool h = false;
#pragma unroll
      for (int sc = 0; sc < 4; ++sc) {
        const int id = comp(c[u], sc);
        h |= id != INVALID && (id == qi[u].x || id == qi[u].y ||
                               id == qi[u].z || id == qi[u].w);
      }
      hit[u] = h;
    }
    float4 val[Q_UNROLL];
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u)
      val[u] = hit[u] ? __ldcs(cv4 + q.b[e[u]]) : make_float4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      if (!hit[u]) continue;
      const float4 qv = reinterpret_cast<const float4*>(q.v)[e[u]];
      const float4 qp = reinterpret_cast<const float4*>(q.p)[e[u]];
#pragma unroll
      for (int sc = 0; sc < 4; ++sc) {
        const int id = comp(c[u], sc);
        if (id == INVALID) continue;
        const float v = comp(val[u], sc);
        const float pc = fminf(1.0f, __fmul_rn(ct, __fmul_rn(v, v)));
#pragma unroll
        for (int sq = 0; sq < 4; ++sq)
          if (comp(qi[u], sq) == id)
            x[u] = __fadd_rn(x[u], __fdiv_rn(__fmul_rn(comp(qv, sq), v),
                                             fminf(comp(qp, sq), pc)));
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      if (e[u] < 0) continue;
      const size_t o = (size_t)q.b[e[u]] * S, qo = (size_t)e[u] * S;
      for (int sc = 0; sc < S; ++sc) {
        const int id = __ldcs(ci + o + sc);
        if (id == INVALID) continue;
        float v = 0.0f, pc = 0.0f;
        bool loaded = false;
        for (int sq = 0; sq < S; ++sq) {
          if (q.id[qo + sq] != id) continue;
          if (!loaded) {
            v = __ldcs(cv + o + sc);
            pc = fminf(1.0f, __fmul_rn(ct, __fmul_rn(v, v)));
            loaded = true;
          }
          x[u] = __fadd_rn(x[u], __fdiv_rn(__fmul_rn(q.v[qo + sq], v),
                                           fminf(q.p[qo + sq], pc)));
        }
      }
    }
  }
}

__device__ __forceinline__ float lane_tree_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(FULL, acc, off));
  return acc;                               // lane 0 holds the row's sum
}

// Many rows: a warp a row (rows warp, warp + all warps, ...); its lanes
// fold their chunks in ascending order.  Grid: at most the blocks the
// card holds at once.
template <bool VEC>
__global__ void __launch_bounds__(Q_THREADS)
intersect_rows_kernel(const int* __restrict__ q_idx,
                      const float* __restrict__ q_val,
                      const float* __restrict__ q_tau,
                      const int* __restrict__ c_idx,
                      const float* __restrict__ c_val,
                      const float* __restrict__ c_tau,
                      float* __restrict__ out, int64_t C, int B, int S) {
  extern __shared__ __align__(16) unsigned char q_smem[];
  const QueryList q = stage_query<VEC>(q_idx, q_val, q_tau, B, S, q_smem);
  const int K = (q.n + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t BS = (int64_t)B * S;
  for (int64_t row = (int64_t)blockIdx.x * Q_WARPS + (threadIdx.x >> 5);
       row < C; row += (int64_t)gridDim.x * Q_WARPS) {
    const float ct = c_tau[row];
    float acc = 0.0f;
    for (int k0 = 0; k0 < K; k0 += Q_UNROLL) {
      float x[Q_UNROLL];
      chunk_terms<VEC>(x, k0, 1, K, q, c_idx + row * BS, c_val + row * BS,
                       ct, S);
#pragma unroll
      for (int u = 0; u < Q_UNROLL; ++u)
        if (k0 + u < K) acc = __fadd_rn(acc, x[u]);
    }
    acc = lane_tree_sum(acc);
    if (lane == 0) out[row] = acc;
  }
}

// Few rows: a block a row; warp w takes chunks w, w + 16, ... and leaves
// each lane's term of each chunk in shared memory; warp 0 folds them in
// ascending chunk order, as a lane of intersect_rows_kernel does.
template <bool VEC>
__global__ void __launch_bounds__(Q_THREADS)
intersect_split_kernel(const int* __restrict__ q_idx,
                       const float* __restrict__ q_val,
                       const float* __restrict__ q_tau,
                       const int* __restrict__ c_idx,
                       const float* __restrict__ c_val,
                       const float* __restrict__ c_tau,
                       float* __restrict__ out, int B, int S) {
  extern __shared__ __align__(16) unsigned char q_smem[];
  const QueryList q = stage_query<VEC>(q_idx, q_val, q_tau, B, S, q_smem);
  float* xs = reinterpret_cast<float*>(q_smem + (size_t)B * S * 12 +
                                       (size_t)B * 4);
  const int K = (q.n + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  const int64_t BS = (int64_t)B * S;
  const float ct = c_tau[row];
  for (int k0 = warp; k0 < K; k0 += Q_UNROLL * Q_WARPS) {
    float x[Q_UNROLL];
    chunk_terms<VEC>(x, k0, Q_WARPS, K, q, c_idx + row * BS,
                     c_val + row * BS, ct, S);
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u)
      if (k0 + u * Q_WARPS < K) xs[(k0 + u * Q_WARPS) * 32 + lane] = x[u];
  }
  __syncthreads();
  if (warp != 0) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, xs[k * 32 + lane]);
  acc = lane_tree_sum(acc);
  if (lane == 0) out[row] = acc;
}

constexpr int SMEM_MAX = 232448;          // 227 KiB a block
constexpr int Q_STATIC_SMEM = Q_WARPS * 4;  // stage_query's warp counts

// Per device, once: the SM count, and both kernels allowed the largest
// shared memory.  Then the blocks an SM holds at this shared memory (kept
// for the last size asked, the shape a caller repeats).
template <bool VEC>
int query_launch_shape(size_t smem, int* sms, int* per_sm) {
  static int last_dev = -1, last_per_sm = 0;
  static size_t last_smem = 0;
  const int err = sketch::once_per_device(sms, [](int dev, int* n) {
    cudaError_t e =
        cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(intersect_rows_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX - Q_STATIC_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(intersect_split_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX - Q_STATIC_SMEM);
    return e;
  });
  if (err) return err;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev || smem != last_smem) {
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, intersect_rows_kernel<VEC>, Q_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    last_dev = dev;
    last_smem = smem;
    last_per_sm = n > 0 ? n : 1;
  }
  *per_sm = last_per_sm;
  return 0;
}

template <bool VEC>
int launch_query(const int* q_idx, const float* q_val, const float* q_tau,
                 const int* c_idx, const float* c_val, const float* c_tau,
                 float* out, int64_t C, int B, int S, cudaStream_t s) {
  const size_t smem = query_smem(B, S);
  int sms = 0, per_sm = 0;
  const int err = query_launch_shape<VEC>(smem, &sms, &per_sm);
  if (err) return err;
  if (C <= sms) {
    intersect_split_kernel<VEC><<<(unsigned)C, Q_THREADS, smem, s>>>(
        q_idx, q_val, q_tau, c_idx, c_val, c_tau, out, B, S);
    return (int)cudaGetLastError();
  }
  const int64_t need = (C + Q_WARPS - 1) / Q_WARPS;
  const int64_t fit = (int64_t)per_sm * sms;
  intersect_rows_kernel<VEC><<<(unsigned)(need < fit ? need : fit),
                               Q_THREADS, smem, s>>>(
      q_idx, q_val, q_tau, c_idx, c_val, c_tau, out, C, B, S);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ all pairs
constexpr int TILE = 64;                  // output tile and compaction tile
constexpr int AP_WARPS = 8;               // compaction: a warp a bucket
constexpr int AP_THREADS = 32 * AP_WARPS;
constexpr int SB = 64;                    // B entries staged a bucket
constexpr int SB_TILES = 128;             // ... by the tile-list join
constexpr int MAX_S = 16;
constexpr int MAX_GROUPS = 16;            // A-row groups of a listed pair

// entries (T, B, TILE*S) int4, counts (T, B): grid (ceil(B / 8), T);
// dynamic shared memory TILE*S entries a warp.  Row rl of tile t is the
// corpus row t * TILE + rl, or rows[t * TILE + rl] when a row list is
// given (the discovery scan's tiles in scan order; -1, or any id outside
// [0, D), is an empty row).  A warp gathers one bucket's occupied slots
// of the tile's rows in (row, slot) order, then writes each to its place
// in (id, row, slot) order: its rank among the bucket's entries.
__global__ void __launch_bounds__(AP_THREADS)
allpairs_compact_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                        const float* __restrict__ p,
                        const int* __restrict__ rows, int4* __restrict__ entries,
                        int* __restrict__ counts, int64_t D, int B, int S) {
  extern __shared__ int4 cp_smem[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * AP_WARPS + (threadIdx.x >> 5);
  const int64_t t = blockIdx.y;
  if (b >= B) return;                       // the whole warp
  int4* list = cp_smem + (threadIdx.x >> 5) * (TILE * S);
  int n = 0;
  for (int r0 = 0; r0 < TILE; r0 += 32) {
    const int rl = r0 + lane;
    const int64_t row = rows ? (int64_t)rows[t * TILE + rl] : t * TILE + rl;
    const int64_t o = (row * B + b) * S;
    int cnt = 0;
    if (row >= 0 && row < D)
      for (int s = 0; s < S; ++s) cnt += idx[o + s] != INVALID;
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    int pos = n + incl - cnt;
    if (cnt)
      for (int s = 0; s < S; ++s) {
        const int id = idx[o + s];
        if (id == INVALID) continue;
        const float rc = __fdiv_rn(1.0f, p[o + s]);
        list[pos++] = make_int4(id, rl, __float_as_int(val[o + s]),
                                __float_as_int(rc));
      }
    n += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  int4* out = entries + ((int64_t)t * B + b) * (TILE * S);
  const int* ids = reinterpret_cast<const int*>(list);
  for (int i = lane; i - lane < n; i += 32) {
    int4 e = i < n ? list[i] : make_int4(0, 0, 0, 0);
    int rank = 0, same = 0;
    for (int j = 0; j < n; ++j) {
      const int f = ids[4 * j];
      rank += f < e.x || (f == e.x && j < i);
      same += f == e.x;
    }
    e.y |= same << 8;                       // the length of the id's run
    if (i < n) out[rank] = e;
  }
  if (lane == 0) counts[t * B + b] = n;
}

__device__ __forceinline__ void add_pair(float* a, int4 e, int4 f) {
  const float av = __int_as_float(e.z), bv = __int_as_float(f.z);
  const float inv = fmaxf(__int_as_float(e.w), __int_as_float(f.w));
  a[0] = __fadd_rn(a[0], __fmul_rn(__fmul_rn(av, bv), inv));
}

// Up to 64 A entries, two a lane (x0 and x1, valid v0 and v1; x1 the later
// 32 of the id-sorted list), against an id-sorted B list of nb entries
// (staged in shared memory, or in global memory).  Each lane finds its ids
// by binary search (the two searches interleaved); a found id's run of
// equal ids in the B list is the entry's run length (entry.y >> 8).  The
// matched pairs, in list order (x0's lanes' runs end to end, then x1's),
// are dealt out 32 at a time, one a lane (scans of the run lengths, and a
// binary search over them for each pair's lane), so the adds keep every
// lane busy however the runs are spread.  Pairs of one batch that fall on
// one cell add one at a time, in pair order.  A cell's pairs in a bucket
// are thus added in ascending id order whatever else the tiles hold.  The
// cells are acc[(A row - row0) * TILE + B row]: the valid entries' rows
// are row0 and after.
__device__ __forceinline__ void join_windows(float* acc, int row0, int4 x0,
                                             bool v0, int4 x1, bool v1,
                                             const int4* bl, int nb) {
  const int lane = threadIdx.x & 31;
  const int* ids = reinterpret_cast<const int*>(bl);
  const int pw = 1 << (31 - __clz(nb));     // largest power of two <= nb
  const bool two = __any_sync(FULL, v1);
  int j0 = 0, j1 = 0;                       // first ids not below x0.x, x1.x
  if (two) {
    for (int st = pw; st > 0; st >>= 1) {
      if (j0 + st <= nb && ids[4 * (j0 + st - 1)] < x0.x) j0 += st;
      if (j1 + st <= nb && ids[4 * (j1 + st - 1)] < x1.x) j1 += st;
    }
  } else {                                  // one window (at most 32 entries)
    for (int st = pw; st > 0; st >>= 1)
      if (j0 + st <= nb && ids[4 * (j0 + st - 1)] < x0.x) j0 += st;
  }
  const int c0 = v0 && j0 < nb && ids[4 * j0] == x0.x ? ids[4 * j0 + 1] >> 8 : 0;
  const int c1 = v1 && j1 < nb && ids[4 * j1] == x1.x ? ids[4 * j1 + 1] >> 8 : 0;
  int in0 = c0, in1 = c1;                   // pairs of lanes <= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t0 = __shfl_up_sync(FULL, in0, off);
    const int t1 = __shfl_up_sync(FULL, in1, off);
    if (lane >= off) {
      in0 += t0;
      in1 += t1;
    }
  }
  const int total0 = __shfl_sync(FULL, in0, 31);
  const int total = total0 + __shfl_sync(FULL, in1, 31);
  for (int base = 0; base < total; base += 32) {
    const int t = base + lane;              // this lane's pair
    const bool second = t >= total0;        // from x1's window
    const int u = second ? t - total0 : t;  // its place in that window
    int src = 0;                            // the lane it comes from
#pragma unroll
    for (int st = 16; st > 0; st >>= 1) {
      const int e0 = __shfl_sync(FULL, in0, src + st - 1);
      const int e1 = __shfl_sync(FULL, in1, src + st - 1);
      if ((second ? e1 : e0) <= u) src += st;
    }
    src = min(src, 31);
    const int b0 = __shfl_sync(FULL, j0 - (in0 - c0), src);
    const int b1 = __shfl_sync(FULL, j1 - (in1 - c1), src);
    const int ay0 = __shfl_sync(FULL, x0.y, src), ay1 = __shfl_sync(FULL, x1.y, src);
    const int az0 = __shfl_sync(FULL, x0.z, src), az1 = __shfl_sync(FULL, x1.z, src);
    const int aw0 = __shfl_sync(FULL, x0.w, src), aw1 = __shfl_sync(FULL, x1.w, src);
    const int4 a = second ? make_int4(0, ay1, az1, aw1) : make_int4(0, ay0, az0, aw0);
    const bool act = t < total;
    const int4 f = act ? bl[(second ? b1 : b0) + u] : make_int4(0, 0, 0, 0);
    // the active lanes whose cell equals this lane's: one vote a bit of
    // the 12-bit cell (cheaper than a match instruction)
    const int cell = ((a.y & 0xFF) - row0) * TILE + (f.y & 0xFF);
    unsigned peers = __ballot_sync(FULL, act);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const unsigned m = __ballot_sync(FULL, (cell >> k) & 1);
      peers &= (cell >> k) & 1 ? m : ~m;
    }
    const bool solo = peers == (1u << lane);
    if (act && solo) add_pair(acc + cell, a, f);
    for (unsigned r = __ballot_sync(FULL, act && !solo); r; r &= r - 1) {
      __syncwarp();
      if (lane == __ffs(r) - 1) add_pair(acc + cell, a, f);
    }
    __syncwarp();
  }
}

// One bucket's lists as a warp holds them: the counts, the counts of the
// bucket it takes two turns later, the A list's first 64 entries.
struct Lists {
  int na, nb, na2, nb2;
  int4 e0, e1;
};

constexpr int J_WARPS = 4;                // plain join: buckets in parallel
constexpr size_t J_SMEM = (size_t)J_WARPS * 2 * SB * sizeof(int4) +
                          (size_t)J_WARPS * TILE * TILE * sizeof(float);

// Dynamic shared memory of the tile-list join at `groups` A-row groups:
// the warps' rings of two SB_TILES-entry B lists, then each warp's sums
// for TILE / groups A rows.
__host__ __device__ constexpr size_t tiles_smem(int groups) {
  return (size_t)J_WARPS * 2 * SB_TILES * sizeof(int4) +
         (size_t)J_WARPS * (TILE / groups) * TILE * sizeof(float);
}

// One output tile of the plain join, a warp's part: the buckets warp,
// warp + J_WARPS, ... of the A lists at ga (bucket b's at ga + b * cap,
// na_of[b] entries) against the B lists at gb, into the warp's sums
// acc[(A row - row0) * TILE + B row], joining, when ROW_GROUP, only the
// A entries of rows row0 .. row0 + rows - 1 (otherwise all of them, row0
// 0: the plain join's body as it was, with no filter).  ring: the warp's
// two staged B lists of SBN entries.  A cell's adds are those of the
// whole tile's join, in the same order, whatever row0 and rows are.
template <int SBN, bool ROW_GROUP>
__device__ __forceinline__ void join_buckets(float* acc, int4* ring,
                                             const int4* ga, const int* na_of,
                                             const int4* gb, const int* nb_of,
                                             int B, int cap, int row0,
                                             int rows) {
  constexpr int W = J_WARPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4 none = make_int4(0, 0, 0, 0);

  // the B list's first SBN entries into ring slot `slot`, one commit group
  auto stage = [&](int b, int slot, int nb) {
    if (b < B) {
      const int4* src = gb + (int64_t)b * cap;
      for (int i = lane; i < min(nb, SBN); i += 32)
        sketch::cp_async16(ring + slot * SBN + i, src + i);
    }
    sketch::cp_async_commit();
  };
  // A list's first 64 entries of bucket b, two a lane (cap >= 64, so the
  // loads stay inside the bucket; entries past the count are not used)
  auto load_a = [&](int b, Lists& l) {
    l.e0 = b < B ? ga[(int64_t)b * cap + lane] : none;
    l.e1 = b < B ? ga[(int64_t)b * cap + 32 + lane] : none;
  };
  auto load_counts = [&](int b, Lists& l) {
    l.na2 = b < B ? na_of[b] : 0;
    l.nb2 = b < B ? nb_of[b] : 0;
  };
  // an A entry this call joins: its row in row0 .. row0 + rows - 1
  auto mine = [&](int4 x) {
    return (unsigned)((x.y & 0xFF) - row0) < (unsigned)rows;
  };
  // One bucket b of this warp (buckets warp, warp + W, ...), its lists in
  // `cur`.  Meanwhile the next bucket's A entries load into `nxt` and its
  // B list into the other ring slot, and the counts of the bucket after
  // it into `cur`: the two register sets take turns, so nothing loaded
  // for a later bucket is waited for in this one.
  auto bucket = [&](int b, int it, Lists& cur, Lists& nxt) {
    cur.na = cur.na2;
    cur.nb = cur.nb2;
    stage(b + W, (it & 1) ^ 1, nxt.nb2);
    load_a(b + W, nxt);
    load_counts(b + 2 * W, cur);
    sketch::cp_async_wait_one();            // this bucket's B list landed
    __syncwarp();
    const int na = cur.na, nb = cur.nb;
    const int4* sbk = ring + (it & 1) * SBN;
    const int4* gbk = gb + (int64_t)b * cap;
    const int4* gak = ga + (int64_t)b * cap;
    for (int ia = 0; nb && ia < na; ia += 64) {
      const bool in0 = ia + lane < na, in1 = ia + 32 + lane < na;
      const int4 x0 = ia == 0 ? cur.e0 : (in0 ? gak[ia + lane] : none);
      const int4 x1 = ia == 0 ? cur.e1 : (in1 ? gak[ia + 32 + lane] : none);
      bool v0 = in0, v1 = in1;
      if constexpr (ROW_GROUP) {
        v0 = v0 && mine(x0);
        v1 = v1 && mine(x1);
        if (!__any_sync(FULL, v0 || v1)) continue;   // none of these rows
      }
      const int r0 = ROW_GROUP ? row0 : 0;
      if (nb <= SBN)  // the common case: the whole B list is staged
        join_windows(acc, r0, x0, v0, x1, v1, sbk, nb);
      else
        join_windows(acc, r0, x0, v0, x1, v1, gbk, nb);
    }
    __syncwarp();                           // the slot is refilled next
  };
  Lists X, Y;
  int b = warp;
  load_counts(b, X);
  load_counts(b + W, Y);
  load_a(b, X);
  stage(b, 0, X.nb2);
  for (int it = 0; b < B;) {
    bucket(b, it++, X, Y);
    if ((b += W) >= B) break;
    bucket(b, it++, Y, X);
    b += W;
  }
}

// The plain join.  grid (ceil(D2 / TILE), ceil(D1 / TILE)), one block of
// J_WARPS warps a TILE x TILE output tile; dynamic shared memory: each
// warp's ring of two staged B lists (SB entries each), then each warp's
// sums [A row][B row].
__global__ void __launch_bounds__(32 * J_WARPS)
allpairs_join_kernel(const int4* __restrict__ ea, const int* __restrict__ ca,
                     const int4* __restrict__ eb, const int* __restrict__ cb,
                     float* __restrict__ out, int64_t D1, int64_t D2, int B,
                     int S) {
  constexpr int W = J_WARPS;
  constexpr int SUMS = TILE * TILE;         // floats of one warp's sums
  extern __shared__ int4 ap_smem[];
  float* sums = reinterpret_cast<float*>(ap_smem + W * 2 * SB);
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < W * SUMS; i += 32 * W) sums[i] = 0.0f;
  __syncthreads();
  const int64_t ta = blockIdx.y, tb = blockIdx.x;
  const int cap = TILE * S;
  join_buckets<SB, false>(sums + warp * SUMS, ap_smem + warp * 2 * SB,
                          ea + ta * B * (int64_t)cap, ca + ta * B,
                          eb + tb * B * (int64_t)cap, cb + tb * B, B, cap, 0,
                          TILE);
  __syncthreads();
  // each cell: the warps' sums added in warp order
  const int64_t a0 = ta * TILE, b0 = tb * TILE;
  for (int x = threadIdx.x; x < SUMS; x += 32 * W) {
    const int col = x % TILE, r = x / TILE;
    const int64_t a = a0 + r, bcol = b0 + col;
    if (a >= D1 || bcol >= D2) continue;
    float v = sums[x];
#pragma unroll
    for (int w = 1; w < W; ++w) v = __fadd_rn(v, sums[w * SUMS + x]);
    out[a * D2 + bcol] = v;
  }
}

int launch_join(const int4* ea, const int* ca, const int4* eb, const int* cb,
                float* out, int64_t D1, int64_t D2, int B, int S,
                cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      allpairs_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)J_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((D2 + TILE - 1) / TILE),
                  (unsigned)((D1 + TILE - 1) / TILE));
  allpairs_join_kernel<<<grid, 32 * J_WARPS, J_SMEM, s>>>(ea, ca, eb, cb,
                                                          out, D1, D2, B, S);
  return (int)cudaGetLastError();
}

// The tile-list join (the discovery scans' batches).  Block x = n *
// groups + g joins listed pair n (pairs[2n]: a tile of the A lists,
// pairs[2n + 1]: a tile of the B lists) on the A rows g R .. g R + R - 1,
// R = TILE / groups, into those rows of out[n] (TILE x TILE); a pair
// outside [0, Ta) x [0, Tb) gives zeros.  A cell's adds are the plain
// join's, in its order, so each out[n] is bit-equal to the plain join's
// tile whatever the list and the groups are: a heavy tile spreads over
// `groups` SMs, and a batch of tiles fills the card in one launch.
__global__ void __launch_bounds__(32 * J_WARPS)
allpairs_join_tiles_kernel(const int4* __restrict__ ea,
                           const int* __restrict__ ca,
                           const int4* __restrict__ eb,
                           const int* __restrict__ cb,
                           const int* __restrict__ pairs,
                           float* __restrict__ out, int64_t Ta, int64_t Tb,
                           int B, int S, int groups) {
  constexpr int W = J_WARPS;
  extern __shared__ int4 ap_smem[];
  const int R = TILE / groups, n_sums = R * TILE;
  float* sums = reinterpret_cast<float*>(ap_smem + W * 2 * SB_TILES);
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < W * n_sums; i += 32 * W) sums[i] = 0.0f;
  __syncthreads();
  const int64_t n = blockIdx.x / groups;
  const int g = (int)(blockIdx.x - n * groups);
  const int64_t ta = pairs[2 * n], tb = pairs[2 * n + 1];
  const int cap = TILE * S;
  if (ta >= 0 && ta < Ta && tb >= 0 && tb < Tb)
    join_buckets<SB_TILES, true>(sums + warp * n_sums,
                                 ap_smem + warp * 2 * SB_TILES,
                                 ea + ta * B * (int64_t)cap, ca + ta * B,
                                 eb + tb * B * (int64_t)cap, cb + tb * B, B,
                                 cap, g * R, R);
  __syncthreads();
  // each cell: the warps' sums added in warp order
  float* o = out + (n * TILE + (int64_t)g * R) * TILE;
  for (int x = threadIdx.x; x < n_sums; x += 32 * W) {
    float v = sums[x];
#pragma unroll
    for (int w = 1; w < W; ++w) v = __fadd_rn(v, sums[w * n_sums + x]);
    o[x] = v;
  }
}

int launch_join_tiles(const int4* ea, const int* ca, const int4* eb,
                      const int* cb, const int* pairs, float* out,
                      int64_t N, int64_t Ta, int64_t Tb, int B, int S,
                      int groups, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      allpairs_join_tiles_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tiles_smem(1));
  if (e != cudaSuccess) return (int)e;
  allpairs_join_tiles_kernel<<<(unsigned)(N * groups), 32 * J_WARPS,
                               tiles_smem(groups), s>>>(
      ea, ca, eb, cb, pairs, out, Ta, Tb, B, S, groups);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- moments join
constexpr int M_WARPS = 16;               // warps a block = buckets a batch
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int M_ROWS = TILE / M_WARPS;    // A rows a warp owns
constexpr int M_CAP = M_WARPS * 64;       // entries staged a side and batch
constexpr int NCH = 6;                    // MOMENT_CHANNELS
// floats of a warp's sums: [row q][B row][channel], and 6 more, so that
// the warps' regions start 6 banks apart
constexpr int M_WSUMS = M_ROWS * TILE * NCH + NCH;
constexpr int M_CELLS = M_WARPS * M_WARPS;     // (owner warp, bucket) bins
// a run's place, as one word: its index (in the staged list, or in the
// tile's global lists), the entry's row q at bits 28-29, the staged flag
constexpr int M_INDEX = (1 << 28) - 1;
constexpr int M_STAGED = 1 << 30;

// Dynamic shared memory of the moments join at S slots: the warps' sums,
// and for two batches each: the lists (A then B) and their layout, the
// counts, and the bins: for each owner warp and bucket, the places of the
// owner's rows' entries in the bucket's A list (at most M_ROWS * S), and
// their count.
__host__ __device__ constexpr size_t moments_smem(int S) {
  return (size_t)(M_WARPS * M_WSUMS + 3) / 4 * sizeof(int4) +
         (size_t)2 * (2 * M_CAP + M_WARPS) * sizeof(int4) +
         2 * 2 * M_WARPS * sizeof(int) +
         (size_t)2 * M_CELLS * (1 + M_ROWS * S) * sizeof(unsigned short);
}

// Where warp w keeps its row q's cell with B row rb: six channels side by
// side.  A lane of a deal reads and writes them as three 8-byte words (its
// address once); 16 lanes on consecutive B rows meet no bank twice, nor do
// the epilogue's reads along a row or, as the warps' regions start 6
// banks apart, along a column.
__device__ __forceinline__ float2* cell_at(float* sums, int w, int q,
                                           int rb) {
  return reinterpret_cast<float2*>(sums + w * M_WSUMS +
                                   (q * TILE + rb) * NCH);
}

// One pair's six Eq. (9) terms (MOMENT_CHANNELS order, x the A side) into
// its cell's sums; each product and sum correctly rounded.
__device__ __forceinline__ void add_moments(float2* cell, float av, float ai,
                                            float bv, float bi) {
  const float inv = fmaxf(ai, bi);
  float2 s0 = cell[0], s1 = cell[1], s2 = cell[2];
  s0.x = __fadd_rn(s0.x, inv);
  s0.y = __fadd_rn(s0.y, __fmul_rn(av, inv));
  s1.x = __fadd_rn(s1.x, __fmul_rn(bv, inv));
  s1.y = __fadd_rn(s1.y, __fmul_rn(__fmul_rn(av, bv), inv));
  s2.x = __fadd_rn(s2.x, __fmul_rn(__fmul_rn(av, av), inv));
  s2.y = __fadd_rn(s2.y, __fmul_rn(__fmul_rn(bv, bv), inv));
  cell[0] = s0;
  cell[1] = s1;
  cell[2] = s2;
}

// The first entry of an id-sorted list of n entries whose id is not below
// `id` (*at), and the length of the run of `id` there (0 if absent).
__device__ __forceinline__ int find_run(const int4* list, int n, int id,
                                        int* at) {
  const int* ids = reinterpret_cast<const int*>(list);
  int pos = 0;
  for (int st = n ? 1 << (31 - __clz(n)) : 0; st > 0; st >>= 1)
    if (pos + st <= n && ids[4 * (pos + st - 1)] < id) pos += st;
  *at = pos;
  return pos < n && ids[4 * pos] == id ? ids[4 * pos + 1] >> 8 : 0;
}

// A batch's lists as lane j < 16 holds them for bucket j: the counts, and
// the places of the staged lists in the batch buffer (each side's lists
// end to end; a list that would end past M_CAP is not staged).
struct BatchLists {
  int na, nb, oa, ob;
};
__device__ __forceinline__ BatchLists batch_lists(const int* c) {
  const int lane = threadIdx.x & 31;
  BatchLists l;
  l.na = lane < M_WARPS ? c[lane] : 0;
  l.nb = lane < M_WARPS ? c[M_WARPS + lane] : 0;
  int ia = l.na, ib = l.nb;
#pragma unroll
  for (int off = 1; off < M_WARPS; off <<= 1) {
    const int ta = __shfl_up_sync(FULL, ia, off);
    const int tb = __shfl_up_sync(FULL, ib, off);
    if (lane >= off) {
      ia += ta;
      ib += tb;
    }
  }
  l.oa = ia - l.na;
  l.ob = ib - l.nb;
  return l;
}

// Block L of the self-join's T (T + 1) / 2 tiles ta <= tb: the T diagonal
// tiles first, then the others, row ta by row.
__device__ __forceinline__ void tile_pair(int64_t L, int64_t T, int64_t* ta,
                                          int64_t* tb) {
  if (L < T) {
    *ta = *tb = L;
    return;
  }
  const int64_t R = T * (T - 1) / 2 - 1 - (L - T);   // counted from the end
  int64_t k = (int64_t)((sqrt(8.0 * (double)R + 1.0) - 1.0) * 0.5);
  while (k * (k + 1) / 2 > R) --k;
  while ((k + 1) * (k + 2) / 2 <= R) ++k;
  *ta = T - 2 - k;
  *tb = T - 1 - (R - k * (k + 1) / 2);
}

// The moments join.  Without MIRROR, grid (ceil(D2 / TILE), ceil(D1 /
// TILE)), a block a TILE x TILE output tile; with MIRROR (both sides the
// same compacted corpus), one block a tile pair ta <= tb, which also
// writes tile (tb, ta).  M_WARPS warps a block; warp w owns the A rows
// w, w + M_WARPS, ... of the tile and sums their cells.
template <bool MIRROR>
__global__ void __launch_bounds__(M_THREADS, 1)
moments_join_kernel(const int4* __restrict__ ea, const int* __restrict__ ca,
                    const int4* __restrict__ eb, const int* __restrict__ cb,
                    float* __restrict__ out, int64_t D1, int64_t D2, int B,
                    int S) {
  extern __shared__ int4 mj_smem[];
  float* sums = reinterpret_cast<float*>(mj_smem);
  int4* lists = mj_smem + (M_WARPS * M_WSUMS + 3) / 4;   // [2][A, B][M_CAP]
  int4* lay = lists + 2 * 2 * M_CAP;        // [2][bucket]: (na, nb, oa, ob)
  int* cnt = reinterpret_cast<int*>(lay + 2 * M_WARPS);
  unsigned short* bin_n =                    // [2][owner][bucket]
      reinterpret_cast<unsigned short*>(cnt + 2 * 2 * M_WARPS);
  unsigned short* bin = bin_n + 2 * M_CELLS;
  const int per_bin = M_ROWS * S;           // [2][owner][bucket][per_bin]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int64_t ta, tb;
  if (MIRROR) {
    tile_pair(blockIdx.x, (D1 + TILE - 1) / TILE, &ta, &tb);
  } else {
    ta = blockIdx.y;
    tb = blockIdx.x;
  }
  const int cap = TILE * S;
  const int4* ga = ea + ta * B * (int64_t)cap;
  const int4* gb = eb + tb * B * (int64_t)cap;
  const int* na_of = ca + ta * B;
  const int* nb_of = cb + tb * B;
  const int nbatch = (B + M_WARPS - 1) / M_WARPS;

  for (int i = threadIdx.x; i < M_WARPS * M_WSUMS; i += M_THREADS)
    sums[i] = 0.0f;

  // batch k's counts (lanes 0..15 the A lists', 16..31 the B lists') into
  // slot k & 1, two batches ahead of the join; warp 0
  auto load_counts = [&](int k) {
    if (warp != 0) return;
    const int b = k * M_WARPS + (lane & (M_WARPS - 1));
    int* dst = cnt + (k & 1) * 2 * M_WARPS + lane;
    if (b < B)
      sketch::cp_async4(dst, (lane < M_WARPS ? na_of : nb_of) + b);
    else
      *dst = 0;
  };
  // warp v stages bucket v's lists of batch k into buffer k & 1; its A
  // list's count and place there stay for bin_batch(k), and warp 0 writes
  // the batch's layout for join_batch(k)
  int my_na = 0, my_oa = 0;
  auto stage = [&](int k) {
    const BatchLists l = batch_lists(cnt + (k & 1) * 2 * M_WARPS);
    if (warp == 0 && lane < M_WARPS)
      lay[(k & 1) * M_WARPS + lane] = make_int4(l.na, l.nb, l.oa, l.ob);
    my_na = __shfl_sync(FULL, l.na, warp);
    my_oa = __shfl_sync(FULL, l.oa, warp);
    const int nb = __shfl_sync(FULL, l.nb, warp);
    const int ob = __shfl_sync(FULL, l.ob, warp);
    const int64_t src = ((int64_t)k * M_WARPS + warp) * cap;
    int4* buf = lists + (k & 1) * 2 * M_CAP;
    if (my_oa + my_na <= M_CAP)
      for (int i = lane; i < my_na; i += 32)
        sketch::cp_async16(buf + my_oa + i, ga + src + i);
    if (ob + nb <= M_CAP)
      for (int i = lane; i < nb; i += 32)
        sketch::cp_async16(buf + M_CAP + ob + i, gb + src + i);
  };
  // warp v bins bucket v's A entries of batch k by owner warp (row %
  // M_WARPS), each owner's in list order, into bins k & 1.  It reads the
  // rows from the list it staged itself (its own copies waited for).
  auto bin_batch = [&](int k) {
    const int na = my_na;
    const bool staged = my_oa + na <= M_CAP;
    const int* rows = staged
        ? &lists[(k & 1) * 2 * M_CAP + my_oa].y
        : &ga[((int64_t)k * M_WARPS + warp) * cap].y;
    unsigned short* n_of = bin_n + (k & 1) * M_CELLS + warp;  // [owner * 16]
    unsigned short* to = bin + ((size_t)(k & 1) * M_CELLS + warp) * per_bin;
    sketch::cp_async_wait_all();
    if (lane < M_WARPS) n_of[lane * M_WARPS] = 0;
    __syncwarp();
    for (int i0 = 0; i0 < na; i0 += 32) {
      const int i = i0 + lane;
      const int o = i < na ? rows[4 * i] & (M_WARPS - 1) : M_WARPS + lane;
      const unsigned peers = __match_any_sync(FULL, o);
      const int base = i < na ? n_of[o * M_WARPS] : 0;
      if (i < na)
        to[(size_t)o * M_WARPS * per_bin + base + __popc(peers & below)] =
            (unsigned short)i;
      __syncwarp();
      if (i < na && (peers & below) == 0)
        n_of[o * M_WARPS] = (unsigned short)(base + __popc(peers));
      __syncwarp();
    }
  };

  // The buckets of batch k against this warp's rows.
  auto join_batch = [&](int k) {
    const int4* sa = lists + (k & 1) * 2 * M_CAP;
    const int4* sb = sa + M_CAP;
    const int4* lk = lay + (k & 1) * M_WARPS;
    const int64_t b0 = (int64_t)k * M_WARPS;
    const unsigned short* n_of = bin_n + (k & 1) * M_CELLS + warp * M_WARPS;
    const unsigned short* mine =
        bin + ((size_t)(k & 1) * M_CELLS + warp * M_WARPS) * per_bin;
    // this warp's entries, bucket by bucket: lane v < 16 holds bucket v's
    // count; scanned, the buckets' first places in the warp's sequence
    const int own = lane < M_WARPS ? n_of[lane] : 0;
    int incl = own;
#pragma unroll
    for (int off = 1; off < M_WARPS; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    const int n = __shfl_sync(FULL, incl, M_WARPS - 1);
    const int excl = incl - own;
    for (int c0 = 0; c0 < n; c0 += 32) {
      // lane: the (c0 + lane)-th entry; its bucket j is the number of
      // buckets whose entries end at or before it
      const int g = c0 + lane;
      int j = 0;
#pragma unroll
      for (int st = M_WARPS / 2; st > 0; st >>= 1)
        if (__shfl_sync(FULL, incl, j + st - 1) <= g) j += st;
      const int first = __shfl_sync(FULL, excl, j);
      int4 e = make_int4(0, 0, 0, 0);
      int at = 0, len = 0, where = 0;
      if (g < n) {
        const int4 L = lk[j];                 // (na, nb, oa, ob)
        const int i = mine[j * per_bin + g - first];
        e = L.z + L.x <= M_CAP ? sa[L.z + i] : ga[(b0 + j) * cap + i];
        if (L.w + L.y <= M_CAP) {
          len = find_run(sb + L.w, L.y, e.x, &at);
          where = (L.w + at) | M_STAGED;
        } else {
          len = find_run(gb + (b0 + j) * cap, L.y, e.x, &at);
          where = (int)((b0 + j) * cap + at);
        }
        where |= (e.y & 0xFF) / M_WARPS << 28;   // which of the warp's rows
      }
      if (!__any_sync(FULL, len > 0)) continue;
      // the matched pairs, in (entry, run) order, dealt out 32 at a time,
      // one a lane
      int in = len;                           // pairs of lanes <= this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, in, off);
        if (lane >= off) in += t;
      }
      const int total = __shfl_sync(FULL, in, 31);
      const int start = in - len;
      for (int base = 0; base < total; base += 32) {
        const int t = base + lane;            // this lane's pair
        const bool act = t < total;
        // the entries whose pairs fall in this window of 32
        const unsigned win =
            __ballot_sync(FULL, len > 0 && start < base + 32 && in > base);
        const bool one = (win & (win - 1)) == 0;
        int src = __ffs(win) - 1;             // the lane it comes from
        if (!one) {
          src = 0;
#pragma unroll
          for (int st = 16; st > 0; st >>= 1)
            if (__shfl_sync(FULL, in, src + st - 1) <= t) src += st;
          src = min(src, 31);
        }
        const int u = t - __shfl_sync(FULL, start, src);
        const int w = __shfl_sync(FULL, where, src);
        const int qs = (w >> 28) & (M_ROWS - 1);
        const float av = __int_as_float(__shfl_sync(FULL, e.z, src));
        const float ai = __int_as_float(__shfl_sync(FULL, e.w, src));
        int4 f = make_int4(0, 0, 0, 0);
        if (act)
          f = w & M_STAGED ? sb[(w & M_INDEX) + u] : gb[(w & M_INDEX) + u];
        const int rb = f.y & 0xFF;
        const float bv = __int_as_float(f.z), bi = __int_as_float(f.w);
        // the pairs of one entry fall on distinct cells; those of several
        // may share one: a cell's pairs add in rounds, in lane order
        int rank = 0;
        if (!one) {
          const int key = qs << 6 | rb;
          unsigned peers = __ballot_sync(FULL, act);
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const unsigned m = __ballot_sync(FULL, (key >> b) & 1);
            peers &= (key >> b) & 1 ? m : ~m;
          }
          rank = act ? __popc(peers & below) : 0;
        }
        float2* cell = cell_at(sums, warp, qs, rb);
        for (int rd = 0;; ++rd) {
          if (act && rank == rd) add_moments(cell, av, ai, bv, bi);
          __syncwarp();
          if (!__any_sync(FULL, rank > rd)) break;
        }
      }
    }
  };

  load_counts(0);
  load_counts(1);
  sketch::cp_async_commit();
  sketch::cp_async_wait_all();
  __syncthreads();
  stage(0);
  sketch::cp_async_commit();
  bin_batch(0);
  for (int k = 0; k < nbatch; ++k) {
    // batch k staged and binned, batch k + 1's counts landed; every warp
    // is done with batch k - 1, whose buffers are refilled, and with the
    // counts of batch k, whose slot batch k + 2's take
    sketch::cp_async_wait_all();
    __syncthreads();
    const bool next = k + 1 < nbatch;
    if (next) stage(k + 1);
    if (k + 2 < nbatch) load_counts(k + 2);
    sketch::cp_async_commit();
    join_batch(k);
    if (next) bin_batch(k + 1);
  }
  __syncthreads();                          // every warp's sums are final

  // the tile, a row of 64 cells x 6 channels at a time
  const int64_t a0 = ta * TILE, b0 = tb * TILE;
  constexpr int ROW = TILE * NCH;
  for (int x = threadIdx.x; x < TILE * ROW; x += M_THREADS) {
    const int ra = x / ROW, rem = x - ra * ROW;
    if (a0 + ra < D1 && b0 + rem / NCH < D2)
      out[((a0 + ra) * D2 + b0) * NCH + rem] =
          sums[(ra % M_WARPS) * M_WSUMS + (ra / M_WARPS) * ROW + rem];
  }
  if (MIRROR && ta != tb) {
    // the mirror tile (tb, ta): cell (b, a) holds the pairs of cell (a,
    // b) in the same order with x and y swapped, so its channels are (n,
    // sum_y, sum_x, xy, sum_y2, sum_x2) of (a, b)
    for (int x = threadIdx.x; x < TILE * ROW; x += M_THREADS) {
      const int col = x / ROW, rem = x - col * ROW;
      const int ra = rem / NCH, ch = rem - ra * NCH;
      const int sch = ch == 1 ? 2 : ch == 2 ? 1 : ch == 4 ? 5 : ch == 5 ? 4
                                                                        : ch;
      if (b0 + col < D1 && a0 + ra < D2)
        out[((b0 + col) * D2 + a0) * NCH + rem] =
            sums[(ra % M_WARPS) * M_WSUMS + (ra / M_WARPS) * ROW +
                 col * NCH + sch];
    }
  }
}

template <bool MIRROR>
int launch_moments(const int4* ea, const int* ca, const int4* eb,
                   const int* cb, float* out, int64_t D1, int64_t D2, int B,
                   int S, cudaStream_t s) {
  const size_t smem = moments_smem(S);
  const cudaError_t e = cudaFuncSetAttribute(
      moments_join_kernel<MIRROR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t T1 = (D1 + TILE - 1) / TILE, T2 = (D2 + TILE - 1) / TILE;
  const dim3 grid = MIRROR ? dim3((unsigned)(T1 * (T1 + 1) / 2))
                           : dim3((unsigned)T2, (unsigned)T1);
  moments_join_kernel<MIRROR><<<grid, M_THREADS, smem, s>>>(
      ea, ca, eb, cb, out, D1, D2, B, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S) int32/f32 + q_tau (1,) f32; corpus (C, B, S) int32/f32 + (C,)
// f32 tau -> out (C,) f32.  vec != 0 (only at S = 4, with the four id and
// value arrays 16-byte aligned) takes 16-byte loads.  The query's list
// needs query_smem(B, S) bytes of shared memory, which with the kernels'
// 64 static bytes must fit in 227 KiB.
int repro_intersect_estimate(const int* q_idx, const float* q_val,
                             const float* q_tau, const int* c_idx,
                             const float* c_val, const float* c_tau,
                             float* out, int64_t C, int B, int S, int vec,
                             void* stream) {
  if (C <= 0) return 0;
  if (B <= 0 || S <= 0 || (vec && S != 4) ||
      query_smem(B, S) > (size_t)(SMEM_MAX - Q_STATIC_SMEM))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return launch_query<true>(q_idx, q_val, q_tau, c_idx, c_val, c_tau, out,
                              C, B, S, s);
  return launch_query<false>(q_idx, q_val, q_tau, c_idx, c_val, c_tau, out,
                             C, B, S, s);
}

// Compact one corpus (D, B, S) idx/val/p for the join: entries (T, B,
// 64*S, 4) int32 and counts (T, B) int32.  Without a row list (rows
// null) tile t holds rows 64 t .. 64 t + 63, T = ceil(D / 64); with one
// (rows: T * 64 int32 row ids, -1 an empty row) tile t holds rows[64 t ..
// 64 t + 63].
int repro_allpairs_compact(const int* idx, const float* val, const float* p,
                           const int* rows, void* entries, int* counts,
                           int64_t T, int64_t D, int B, int S, void* stream) {
  if (T <= 0) return 0;
  if (B <= 0 || S <= 0 || S > MAX_S || T > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)AP_WARPS * TILE * S * sizeof(int4);
  const cudaError_t e = cudaFuncSetAttribute(
      allpairs_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + AP_WARPS - 1) / AP_WARPS), (unsigned)T);
  allpairs_compact_kernel<<<grid, AP_THREADS, smem, (cudaStream_t)stream>>>(
      idx, val, p, rows, static_cast<int4*>(entries), counts,
      D < 0 ? 0 : D, B, S);
  return (int)cudaGetLastError();
}

// Join two compacted corpora -> out (D1, D2) f32, or (D1, D2, 6) when
// moments != 0.  The moments join of a corpus with itself (the same
// entries and counts on both sides, D1 == D2) computes the tiles ta <= tb
// and mirrors them.
int repro_allpairs_join(const void* a_entries, const int* a_counts,
                        const void* b_entries, const int* b_counts, float* out,
                        int64_t D1, int64_t D2, int B, int S, int moments,
                        void* stream) {
  if (D1 <= 0 || D2 <= 0) return 0;
  if (B <= 0 || S <= 0 || S > MAX_S) return (int)cudaErrorInvalidValue;
  const int4* ea = static_cast<const int4*>(a_entries);
  const int4* eb = static_cast<const int4*>(b_entries);
  cudaStream_t s = (cudaStream_t)stream;
  if (!moments)
    return launch_join(ea, a_counts, eb, b_counts, out, D1, D2, B, S, s);
  if ((int64_t)B * TILE * S > M_INDEX) return (int)cudaErrorInvalidValue;
  if (ea == eb && a_counts == b_counts && D1 == D2)
    return launch_moments<true>(ea, a_counts, eb, b_counts, out, D1, D2, B,
                                S, s);
  return launch_moments<false>(ea, a_counts, eb, b_counts, out, D1, D2, B, S,
                               s);
}

// Join listed tile pairs of two compacted corpora (Ta and Tb tiles):
// pairs (N, 2) int32 (a tile of the A side, a tile of the B side) -> out
// (N, 64, 64) f32, each the plain join's tile of the two, bit for bit; a
// pair outside the tiles gives zeros.  groups (1, 2, 4, 8 or 16): blocks
// a pair, each joining 64 / groups of the A rows.
int repro_allpairs_join_tiles(const void* a_entries, const int* a_counts,
                              const void* b_entries, const int* b_counts,
                              const int* pairs, float* out, int64_t N,
                              int64_t Ta, int64_t Tb, int B, int S,
                              int groups, void* stream) {
  if (N <= 0) return 0;
  if (B <= 0 || S <= 0 || S > MAX_S || groups < 1 || groups > MAX_GROUPS ||
      (groups & (groups - 1)) || N * groups > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  return launch_join_tiles(static_cast<const int4*>(a_entries), a_counts,
                           static_cast<const int4*>(b_entries), b_counts,
                           pairs, out, N, Ta, Tb, B, S, groups,
                           (cudaStream_t)stream);
}

// The moments join's launch shape at S slots on the current device: its
// blocks an SM (the occupancy calculator's), warps a block, dynamic shared
// memory a block and registers a thread.
int repro_allpairs_moments_shape(int S, int* blocks_per_sm, int* warps,
                                 int* smem_bytes, int* regs) {
  if (S <= 0 || S > MAX_S) return (int)cudaErrorInvalidValue;
  const size_t smem = moments_smem(S);
  cudaError_t e = cudaFuncSetAttribute(
      moments_join_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, moments_join_kernel<true>, M_THREADS, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, moments_join_kernel<true>);
  if (e != cudaSuccess) return (int)e;
  *warps = M_WARPS;
  *smem_bytes = (int)smem;
  *regs = attr.numRegs;
  return 0;
}

}  // extern "C"
