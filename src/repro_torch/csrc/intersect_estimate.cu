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
// (the divide form, l2 weights).  Bound on the card: memory — the corpus
// is read once, C*B*S*8 bytes plus C*8 for tau and the output; the compare
// work is C*B*S^2, small beside it.  Design: each block holds the query's
// ids, values and inclusion probabilities in shared memory and gives one
// corpus row to each warp; a lane takes buckets, loads the row's S slots
// once and compares each with the S query slots, and the warp sums its
// lanes with shuffles.
//
// allpairs_estimate replaces
//   src/repro/kernels/intersect_estimate/intersect_estimate.py::allpairs_estimate_pallas
// (D1, B, S) x (D2, B, S) with per-slot inclusion probabilities ->
// (D1, D2) estimates sum eq * va * vb * max(1/pa, 1/pb), or with MOMENTS
// the six Eq. (9) channels (n, sum_x, sum_y, xy, sum_x2, sum_y2) ->
// (D1, D2, 6).  Bound on the card: operations — an equality join, about
// (valid A slots) x (valid B slots) compares per bucket summed over the
// buckets and the row pairs, on the CUDA cores (there is no product for
// the tensor cores).  Design: one block of 16 x 16 threads per 64 x 64
// output tile, each thread a 4 x 4 register tile of (a, b) pairs (rows
// ty + 16i of A, tx + 16j of B), so a staged slot is reused four times per
// thread from shared memory and each block restages 128 rows, not 32 for
// 256 pairs; the block stages a chunk of whole buckets of its 64 A rows
// and 64 B rows in shared memory (slot-major, row-minor, padded to 65 to
// spread banks), padding is remapped to -1 (A) / -2 (B) so it never
// matches, the reciprocal 1/p is taken only for occupied slots, and a
// thread skips a slot whose four A rows are all empty — most are, since a
// row keeps m of B*S slots — so the work follows the valid entries.
//
// Sums run in another order than the reference's, so estimates agree
// within float32 summation tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int INVALID = 0x7FFFFFFF;

// ---------------------------------------------------------------- query
constexpr int Q_ROWS = 4;                 // corpus rows (warps) per block
constexpr int Q_THREADS = 32 * Q_ROWS;

__global__ void __launch_bounds__(Q_THREADS)
intersect_estimate_kernel(const int* __restrict__ q_idx,
                          const float* __restrict__ q_val,
                          const float* __restrict__ q_tau,
                          const int* __restrict__ c_idx,
                          const float* __restrict__ c_val,
                          const float* __restrict__ c_tau,
                          float* __restrict__ out, int64_t C, int B, int S) {
  extern __shared__ unsigned char smem[];
  const int BS = B * S;
  int* sq_idx = reinterpret_cast<int*>(smem);
  float* sq_val = reinterpret_cast<float*>(sq_idx + BS);
  float* sq_p = sq_val + BS;
  const float qt = q_tau[0];
  for (int i = threadIdx.x; i < BS; i += blockDim.x) {
    const float v = q_val[i];
    sq_idx[i] = q_idx[i];
    sq_val[i] = v;
    sq_p[i] = fminf(1.0f, __fmul_rn(qt, __fmul_rn(v, v)));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * Q_ROWS + (threadIdx.x >> 5);
  if (row >= C) return;
  const int* ci_row = c_idx + row * BS;
  const float* cv_row = c_val + row * BS;
  const float ct = c_tau[row];
  float acc = 0.0f;
  for (int b = lane; b < B; b += 32) {
    for (int sc = 0; sc < S; ++sc) {
      const int ci = ci_row[b * S + sc];
      if (ci == INVALID) continue;
      const float cv = cv_row[b * S + sc];
      const float pc = fminf(1.0f, __fmul_rn(ct, __fmul_rn(cv, cv)));
      for (int sq = 0; sq < S; ++sq) {
        if (sq_idx[b * S + sq] == ci) {
          const float p = fminf(sq_p[b * S + sq], pc);
          acc = __fadd_rn(acc, __fdiv_rn(__fmul_rn(sq_val[b * S + sq], cv), p));
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) out[row] = acc;
}

// ------------------------------------------------------------ all pairs
constexpr int SUB = 16;                   // threads along each tile side
constexpr int REG = 4;                    // rows per thread along each side
constexpr int TILE = SUB * REG;           // output tile is TILE x TILE
constexpr int KS = 16;                    // staged slots per row per step
constexpr int LD = TILE + 1;              // padded slot stride in smem

struct Stage {
  int idx[KS * LD];
  float val[KS * LD];
  float rcp[KS * LD];
};

// Stage slots [g0, g0 + ks) of rows [row0, row0 + TILE) as [slot][row];
// empty slots get the side's padding id, value 0 and reciprocal 1.
__device__ __forceinline__ void stage(Stage& st, const int* __restrict__ idx,
                                      const float* __restrict__ val,
                                      const float* __restrict__ p,
                                      int64_t row0, int64_t D, int64_t BS,
                                      int64_t g0, int ks, int pad_id) {
  for (int e = threadIdx.x; e < TILE * KS; e += blockDim.x) {
    const int r = e / KS, k = e - r * KS;
    const int64_t row = row0 + r;
    int id = pad_id;
    float v = 0.0f, rc = 1.0f;
    if (k < ks && row < D) {
      const int64_t o = row * BS + g0 + k;
      const int raw = idx[o];
      if (raw != INVALID) {
        id = raw;
        v = val[o];
        rc = __fdiv_rn(1.0f, p[o]);
      }
    }
    st.idx[k * LD + r] = id;
    st.val[k * LD + r] = v;
    st.rcp[k * LD + r] = rc;
  }
}

template <bool MOMENTS>
__global__ void __launch_bounds__(SUB * SUB)
allpairs_estimate_kernel(const int* __restrict__ a_idx,
                         const float* __restrict__ a_val,
                         const float* __restrict__ a_p,
                         const int* __restrict__ b_idx,
                         const float* __restrict__ b_val,
                         const float* __restrict__ b_p, float* __restrict__ out,
                         int64_t D1, int64_t D2, int B, int S) {
  constexpr int NCH = MOMENTS ? 6 : 1;
  __shared__ Stage sa, sb;
  const int tx = threadIdx.x % SUB;        // B rows tx + SUB*j
  const int ty = threadIdx.x / SUB;        // A rows ty + SUB*i
  const int64_t a0 = (int64_t)blockIdx.y * TILE, b0 = (int64_t)blockIdx.x * TILE;
  const int64_t BS = (int64_t)B * S;
  const int step = (KS / S) * S;           // whole buckets per step
  float acc[REG][REG][NCH];
#pragma unroll
  for (int i = 0; i < REG; ++i)
#pragma unroll
    for (int j = 0; j < REG; ++j)
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[i][j][c] = 0.0f;
  for (int64_t g0 = 0; g0 < BS; g0 += step) {
    const int ks = (int)min((int64_t)step, BS - g0);
    __syncthreads();
    stage(sa, a_idx, a_val, a_p, a0, D1, BS, g0, ks, -1);
    stage(sb, b_idx, b_val, b_p, b0, D2, BS, g0, ks, -2);
    __syncthreads();
    for (int kb = 0; kb < ks; kb += S) {          // one bucket
      for (int sq = 0; sq < S; ++sq) {
        const int ka = (kb + sq) * LD + ty;
        int ai[REG];
        bool any = false;
#pragma unroll
        for (int i = 0; i < REG; ++i) {
          ai[i] = sa.idx[ka + SUB * i];
          any |= ai[i] >= 0;
        }
        if (!any) continue;                       // four empty A slots
        for (int sc = 0; sc < S; ++sc) {
          const int kc = (kb + sc) * LD + tx;
#pragma unroll
          for (int j = 0; j < REG; ++j) {
            const int bi = sb.idx[kc + SUB * j];
#pragma unroll
            for (int i = 0; i < REG; ++i) {
              if (ai[i] != bi) continue;
              const float av = sa.val[ka + SUB * i], bv = sb.val[kc + SUB * j];
              const float inv = fmaxf(sa.rcp[ka + SUB * i], sb.rcp[kc + SUB * j]);
              float* a = acc[i][j];
              if (MOMENTS) {
                a[0] = __fadd_rn(a[0], inv);
                a[1] = __fadd_rn(a[1], __fmul_rn(av, inv));
                a[2] = __fadd_rn(a[2], __fmul_rn(bv, inv));
                a[3] = __fadd_rn(a[3], __fmul_rn(__fmul_rn(av, bv), inv));
                a[4] = __fadd_rn(a[4], __fmul_rn(__fmul_rn(av, av), inv));
                a[5] = __fadd_rn(a[5], __fmul_rn(__fmul_rn(bv, bv), inv));
              } else {
                a[0] = __fadd_rn(a[0], __fmul_rn(__fmul_rn(av, bv), inv));
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < REG; ++i) {
    const int64_t a = a0 + ty + SUB * i;
    if (a >= D1) continue;
#pragma unroll
    for (int j = 0; j < REG; ++j) {
      const int64_t b = b0 + tx + SUB * j;
      if (b >= D2) continue;
#pragma unroll
      for (int c = 0; c < NCH; ++c) out[(a * D2 + b) * NCH + c] = acc[i][j][c];
    }
  }
}

}  // namespace

extern "C" {

// q (B, S) int32/f32 + q_tau (1,) f32; corpus (C, B, S) int32/f32 + (C,)
// f32 tau -> out (C,) f32.
int repro_intersect_estimate(const int* q_idx, const float* q_val,
                             const float* q_tau, const int* c_idx,
                             const float* c_val, const float* c_tau,
                             float* out, int64_t C, int B, int S, void* stream) {
  if (C <= 0) return 0;
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)B * S * 12;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        intersect_estimate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((C + Q_ROWS - 1) / Q_ROWS);
  intersect_estimate_kernel<<<grid, Q_THREADS, smem, (cudaStream_t)stream>>>(
      q_idx, q_val, q_tau, c_idx, c_val, c_tau, out, C, B, S);
  return (int)cudaGetLastError();
}

// a (D1, B, S) idx/val/p, b (D2, B, S) idx/val/p -> out (D1, D2) f32, or
// (D1, D2, 6) when moments != 0.  S <= 16.
int repro_allpairs_estimate(const int* a_idx, const float* a_val,
                            const float* a_p, const int* b_idx,
                            const float* b_val, const float* b_p, float* out,
                            int64_t D1, int64_t D2, int B, int S, int moments,
                            void* stream) {
  if (D1 <= 0 || D2 <= 0) return 0;
  if (B <= 0 || S <= 0 || S > KS) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D2 + TILE - 1) / TILE),
                  (unsigned)((D1 + TILE - 1) / TILE));
  cudaStream_t s = (cudaStream_t)stream;
  if (moments)
    allpairs_estimate_kernel<true><<<grid, SUB * SUB, 0, s>>>(
        a_idx, a_val, a_p, b_idx, b_val, b_p, out, D1, D2, B, S);
  else
    allpairs_estimate_kernel<false><<<grid, SUB * SUB, 0, s>>>(
        a_idx, a_val, a_p, b_idx, b_val, b_p, out, D1, D2, B, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
