// Batched matrix-product estimation for Hopper (sm_90a).
//
// matrix_products_kernel replaces the Pallas kernel
//   src/repro/kernels/matrix_sketch/matrix_sketch.py::matrix_products_pallas
// P pairs of bucketized matrix sketches -> the (P, d_a, d_b) estimates
//   out[p] = sum_b sum_{sa,sb} [ia == ib] * max(1/p_a, 1/p_b) *
//            a_row (x) b_row
// Per side: ids (P, B, S) int32 with INVALID padding, rows (P, B, S, d)
// float32, inclusion probabilities p (P, B, S) float32 (1.0 at padding).
// A coordinate shared by both sketches lands in the same bucket on both
// sides, so the join is a per-bucket S x S id compare; INVALID never
// matches.  The A side may be one sketch read for every pair (batch
// stride 0): one query against a corpus, with no copies.
//
// Bound on the card: memory.  A pair must read both sides' ids (B*S*4
// bytes each) and, for its matched slots only, the probabilities and the
// rows; the output is d_a*d_b floats.  A pair of sketches of m rows
// shares at most m rows, so the arithmetic (2*d_a*d_b flops a match) is
// far below the fp32 rate.
//
// Design: one block per pair (grid.y tiles the d_a*d_b outputs by
// THREADS when they are more).  (1) Both sides' ids go to shared memory
// with coalesced loads.  (2) Each thread counts the matches of a
// contiguous range of buckets; (3) a block exclusive scan of the counts
// gives each thread its offset, so (4) the matched (a slot, b slot,
// coefficient) triples land in a shared list in ascending (bucket, sa,
// sb) order without atomics: the result is the same bits run to run.
// (5) Each thread owns one output entry (k, l) and accumulates
// (c * a[k]) * b[l] over the list with fp32 FMAs; the matched rows are
// staged through shared memory STAGE at a time (coalesced row reads, the
// coefficient applied once per row).  (6) The entry is written once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// matched rows staged per round: STAGE_ROWS of the Python wrapper
constexpr int STAGE = 32;
constexpr int INVALID = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
matrix_products_kernel(const int* __restrict__ a_idx,
                       const float* __restrict__ a_rows,
                       const float* __restrict__ a_p,
                       const int* __restrict__ b_idx,
                       const float* __restrict__ b_rows,
                       const float* __restrict__ b_p, float* __restrict__ out,
                       int a_batched, int B, int S, int da, int db) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[WARPS];
  __shared__ int s_total;
  const int nslot = B * S;
  int* s_aid = reinterpret_cast<int*>(smem);
  int* s_bid = s_aid + nslot;
  int* s_ma = s_bid + nslot;      // matched a slot (bucket * S + sa)
  int* s_mb = s_ma + nslot;       // matched b slot
  float* s_mc = reinterpret_cast<float*>(s_mb + nslot);  // coefficient
  float* s_ra = s_mc + nslot;     // STAGE x da staged (c * a) rows
  float* s_rb = s_ra + STAGE * da;  // STAGE x db staged b rows

  const int64_t pair = blockIdx.x;
  const int64_t a_off = a_batched ? pair * nslot : 0;
  const int64_t b_off = pair * nslot;

  // (1) both sides' ids
  for (int i = threadIdx.x; i < nslot; i += THREADS) {
    s_aid[i] = a_idx[a_off + i];
    s_bid[i] = b_idx[b_off + i];
  }
  __syncthreads();

  // (2) matches in this thread's buckets [b0, b1)
  const int per = (B + THREADS - 1) / THREADS;
  const int b0 = min(B, (int)threadIdx.x * per);
  const int b1 = min(B, b0 + per);
  int cnt = 0;
  for (int b = b0; b < b1; ++b) {
    for (int sa = 0; sa < S; ++sa) {
      const int ia = s_aid[b * S + sa];
      if (ia == INVALID) continue;
      for (int sb = 0; sb < S; ++sb) cnt += s_bid[b * S + sb] == ia;
    }
  }

  // (3) block exclusive scan of the counts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int t = s_warp[w];
      s_warp[w] = run;
      run += t;
    }
    s_total = run;
  }
  __syncthreads();

  // (4) the triples, in (bucket, sa, sb) order
  int pos = s_warp[warp] + incl - cnt;
  for (int b = b0; b < b1; ++b) {
    for (int sa = 0; sa < S; ++sa) {
      const int ia = s_aid[b * S + sa];
      if (ia == INVALID) continue;
      for (int sb = 0; sb < S; ++sb) {
        if (s_bid[b * S + sb] != ia) continue;
        const float ra = 1.0f / a_p[a_off + b * S + sa];
        const float rb = 1.0f / b_p[b_off + b * S + sb];
        s_ma[pos] = b * S + sa;
        s_mb[pos] = b * S + sb;
        s_mc[pos] = fmaxf(ra, rb);
        ++pos;
      }
    }
  }
  __syncthreads();
  const int K = s_total;

  // (5) this thread's output entry, accumulated over staged rows
  const int e = blockIdx.y * THREADS + threadIdx.x;
  const bool owner = e < da * db;
  const int k = owner ? e / db : 0;
  const int l = owner ? e - k * db : 0;
  const float* a_base = a_rows + a_off * da;
  const float* b_base = b_rows + b_off * db;
  float acc = 0.0f;
  for (int j0 = 0; j0 < K; j0 += STAGE) {
    const int nj = min(STAGE, K - j0);
    __syncthreads();  // the previous stage has been read
    for (int i = threadIdx.x; i < nj * da; i += THREADS) {
      const int j = i / da;
      s_ra[i] = a_base[(int64_t)s_ma[j0 + j] * da + (i - j * da)] *
                s_mc[j0 + j];
    }
    for (int i = threadIdx.x; i < nj * db; i += THREADS) {
      const int j = i / db;
      s_rb[i] = b_base[(int64_t)s_mb[j0 + j] * db + (i - j * db)];
    }
    __syncthreads();
    if (owner) {
      for (int j = 0; j < nj; ++j)
        acc = fmaf(s_ra[j * da + k], s_rb[j * db + l], acc);
    }
  }
  // (6)
  if (owner) out[pair * da * db + e] = acc;
}

}  // namespace

extern "C" {

// a_idx (Pa, B, S) int32, a_rows (Pa, B, S, da) f32, a_p (Pa, B, S) f32
// with Pa = P when a_batched else 1; b_* the same with P and db;
// out (P, da, db) f32.  Dynamic shared memory: B*S*20 + STAGE*(da+db)*4
// bytes, at most 227 KiB less 64 bytes of static shared memory.
int repro_matrix_products(const int* a_idx, const float* a_rows,
                          const float* a_p, const int* b_idx,
                          const float* b_rows, const float* b_p, float* out,
                          int64_t P, int a_batched, int64_t B, int S, int da,
                          int db, void* stream) {
  if (P <= 0 || da <= 0 || db <= 0) return 0;
  if (B <= 0 || S <= 0 || B * S > (1 << 20) || P > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)B * S * 20 + (size_t)STAGE * ((size_t)da + db) * 4;
  if (smem > 232448 - 64) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        matrix_products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (int)(((int64_t)da * db + THREADS - 1) / THREADS);
  const dim3 grid((unsigned)P, (unsigned)tiles);
  matrix_products_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      a_idx, a_rows, a_p, b_idx, b_rows, b_p, out, a_batched, (int)B, S, da,
      db);
  return (int)cudaGetLastError();
}

}  // extern "C"
