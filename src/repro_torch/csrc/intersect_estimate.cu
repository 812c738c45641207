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
// - allpairs_join: one block a 64 x 64 output tile; its warps take the
//   buckets in turn (warp w: w, w + W, ...), each into sums of its own in
//   shared memory, so no warp waits for another.  Per bucket a warp holds
//   the A list's first 64 entries in registers (two a lane) and stages the
//   B list with cp.async into a ring of two, one bucket ahead of the
//   compares (the counts two ahead).  It is a sort-merge join: each lane
//   finds its A id in the id-sorted B list by binary search, which gives
//   the run of equal ids it matches, and the matched pairs are then dealt
//   out one a lane, in list order, so the work is the matches (~3% of the
//   slot pairs a bucket shares at the serving widths) and a log of the
//   list, not every pair.  Pairs that fall on one cell in one batch of 32
//   add one at a time, in pair order.  No float atomics: each warp sums a
//   cell in ascending bucket order and within a bucket in ascending id
//   order, the warps' sums are added in warp order, so a cell's bits
//   depend on its two rows alone (the same on every launch, and whatever
//   other rows the corpora hold).
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
constexpr int UNR = 4;                    // B entries compared per vote
constexpr int MAX_S = 16;

// entries (T, B, TILE*S) int4, counts (T, B): grid (ceil(B / 8), T);
// dynamic shared memory TILE*S entries a warp.  A warp gathers one
// bucket's occupied slots of the tile's rows in (row, slot) order, then
// writes each to its place in (id, row, slot) order: its rank among the
// bucket's entries.
__global__ void __launch_bounds__(AP_THREADS)
allpairs_compact_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                        const float* __restrict__ p, int4* __restrict__ entries,
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
    const int64_t row = t * TILE + rl;
    const int64_t o = (row * B + b) * S;
    int cnt = 0;
    if (row < D)
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

template <bool MOMENTS>
__device__ __forceinline__ void add_pair(float* a, int4 e, int4 f) {
  constexpr int CS = TILE * TILE;           // channel stride of the sums
  const float av = __int_as_float(e.z), bv = __int_as_float(f.z);
  const float inv = fmaxf(__int_as_float(e.w), __int_as_float(f.w));
  if (MOMENTS) {
    a[0] = __fadd_rn(a[0], inv);
    a[CS] = __fadd_rn(a[CS], __fmul_rn(av, inv));
    a[2 * CS] = __fadd_rn(a[2 * CS], __fmul_rn(bv, inv));
    a[3 * CS] = __fadd_rn(a[3 * CS], __fmul_rn(__fmul_rn(av, bv), inv));
    a[4 * CS] = __fadd_rn(a[4 * CS], __fmul_rn(__fmul_rn(av, av), inv));
    a[5 * CS] = __fadd_rn(a[5 * CS], __fmul_rn(__fmul_rn(bv, bv), inv));
  } else {
    a[0] = __fadd_rn(a[0], __fmul_rn(__fmul_rn(av, bv), inv));
  }
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
// are thus added in ascending id order whatever else the tiles hold.
template <bool MOMENTS>
__device__ __forceinline__ void join_windows(float* acc, int4 x0, bool v0,
                                             int4 x1, bool v1, const int4* bl,
                                             int nb) {
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
    const int cell = (a.y & 0xFF) * TILE + (f.y & 0xFF);
    unsigned peers = __ballot_sync(FULL, act);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const unsigned m = __ballot_sync(FULL, (cell >> k) & 1);
      peers &= (cell >> k) & 1 ? m : ~m;
    }
    const bool solo = peers == (1u << lane);
    if (act && solo) add_pair<MOMENTS>(acc + cell, a, f);
    for (unsigned r = __ballot_sync(FULL, act && !solo); r; r &= r - 1) {
      __syncwarp();
      if (lane == __ffs(r) - 1) add_pair<MOMENTS>(acc + cell, a, f);
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

template <bool MOMENTS>
struct JoinShape {
  static constexpr int WARPS = MOMENTS ? 2 : 4;   // buckets in parallel
  static constexpr int NCH = MOMENTS ? 6 : 1;
  static constexpr size_t smem() {
    return (size_t)WARPS * 2 * SB * sizeof(int4) +
           (size_t)WARPS * NCH * TILE * TILE * sizeof(float);
  }
};

// grid (ceil(D2 / TILE), ceil(D1 / TILE)), one block of WARPS warps a
// TILE x TILE output tile; dynamic shared memory: each warp's ring of two
// staged B lists (SB entries each), then each warp's sums
// [channel][A row][B row].
template <bool MOMENTS>
__global__ void __launch_bounds__(32 * JoinShape<MOMENTS>::WARPS)
allpairs_join_kernel(const int4* __restrict__ ea, const int* __restrict__ ca,
                     const int4* __restrict__ eb, const int* __restrict__ cb,
                     float* __restrict__ out, int64_t D1, int64_t D2, int B,
                     int S) {
  constexpr int W = JoinShape<MOMENTS>::WARPS;
  constexpr int NCH = JoinShape<MOMENTS>::NCH;
  constexpr int SUMS = NCH * TILE * TILE;   // floats of one warp's sums
  extern __shared__ int4 ap_smem[];
  float* sums = reinterpret_cast<float*>(ap_smem + W * 2 * SB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < W * SUMS; i += 32 * W) sums[i] = 0.0f;
  __syncthreads();
  float* acc = sums + warp * SUMS;
  int4* ring = ap_smem + warp * 2 * SB;
  const int64_t ta = blockIdx.y, tb = blockIdx.x;
  const int cap = TILE * S;
  const int4* ga = ea + ta * B * (int64_t)cap;
  const int4* gb = eb + tb * B * (int64_t)cap;
  const int* na_of = ca + ta * B;
  const int* nb_of = cb + tb * B;
  const int4 none = make_int4(0, 0, 0, 0);

  // the B list's first SB entries into ring slot `slot`, one commit group
  auto stage = [&](int b, int slot, int nb) {
    if (b < B) {
      const int4* src = gb + (int64_t)b * cap;
      for (int i = lane; i < min(nb, SB); i += 32)
        sketch::cp_async16(ring + slot * SB + i, src + i);
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
    const int4* sbk = ring + (it & 1) * SB;
    const int4* gbk = gb + (int64_t)b * cap;
    const int4* gak = ga + (int64_t)b * cap;
    for (int ia = 0; nb && ia < na; ia += 64) {
      const bool v0 = ia + lane < na, v1 = ia + 32 + lane < na;
      const int4 x0 = ia == 0 ? cur.e0 : (v0 ? gak[ia + lane] : none);
      const int4 x1 = ia == 0 ? cur.e1 : (v1 ? gak[ia + 32 + lane] : none);
      if (nb <= SB)   // the common case: the whole B list is staged
        join_windows<MOMENTS>(acc, x0, v0, x1, v1, sbk, nb);
      else
        join_windows<MOMENTS>(acc, x0, v0, x1, v1, gbk, nb);
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
  __syncthreads();
  // each cell: the warps' sums added in warp order
  const int64_t a0 = ta * TILE, b0 = tb * TILE;
  for (int x = threadIdx.x; x < SUMS; x += 32 * W) {
    const int c = x % NCH, rest = x / NCH;
    const int col = rest % TILE, r = rest / TILE;
    const int64_t a = a0 + r, bcol = b0 + col;
    if (a >= D1 || bcol >= D2) continue;
    const int k = (c * TILE + r) * TILE + col;
    float v = sums[k];
#pragma unroll
    for (int w = 1; w < W; ++w) v = __fadd_rn(v, sums[w * SUMS + k]);
    out[(a * D2 + bcol) * NCH + c] = v;
  }
}

template <bool MOMENTS>
int launch_join(const int4* ea, const int* ca, const int4* eb, const int* cb,
                float* out, int64_t D1, int64_t D2, int B, int S,
                cudaStream_t s) {
  constexpr size_t smem = JoinShape<MOMENTS>::smem();
  const cudaError_t e = cudaFuncSetAttribute(
      allpairs_join_kernel<MOMENTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((D2 + TILE - 1) / TILE),
                  (unsigned)((D1 + TILE - 1) / TILE));
  allpairs_join_kernel<MOMENTS><<<grid, 32 * JoinShape<MOMENTS>::WARPS, smem,
                                  s>>>(ea, ca, eb, cb, out, D1, D2, B, S);
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
// 64*S, 4) int32, each tile's bucket in (id, row, slot) order, and counts
// (T, B) int32, T = ceil(D / 64).  S <= 16.
int repro_allpairs_compact(const int* idx, const float* val, const float* p,
                           void* entries, int* counts, int64_t D, int B, int S,
                           void* stream) {
  if (D <= 0) return 0;
  if (B <= 0 || S <= 0 || S > MAX_S) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)AP_WARPS * TILE * S * sizeof(int4);
  const cudaError_t e = cudaFuncSetAttribute(
      allpairs_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + AP_WARPS - 1) / AP_WARPS),
                  (unsigned)((D + TILE - 1) / TILE));
  allpairs_compact_kernel<<<grid, AP_THREADS, smem, (cudaStream_t)stream>>>(
      idx, val, p, static_cast<int4*>(entries), counts, D, B, S);
  return (int)cudaGetLastError();
}

// Join two compacted corpora -> out (D1, D2) f32, or (D1, D2, 6) when
// moments != 0.
int repro_allpairs_join(const void* a_entries, const int* a_counts,
                        const void* b_entries, const int* b_counts, float* out,
                        int64_t D1, int64_t D2, int B, int S, int moments,
                        void* stream) {
  if (D1 <= 0 || D2 <= 0) return 0;
  if (B <= 0 || S <= 0 || S > MAX_S) return (int)cudaErrorInvalidValue;
  const int4* ea = static_cast<const int4*>(a_entries);
  const int4* eb = static_cast<const int4*>(b_entries);
  cudaStream_t s = (cudaStream_t)stream;
  if (moments)
    return launch_join<true>(ea, a_counts, eb, b_counts, out, D1, D2, B, S, s);
  return launch_join<false>(ea, a_counts, eb, b_counts, out, D1, D2, B, S, s);
}

}  // extern "C"
