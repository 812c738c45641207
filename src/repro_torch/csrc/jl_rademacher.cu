// Matrix-free Johnson-Lindenstrauss projection for Hopper (sm_90a).
//
// jl_rademacher_kernel replaces the Pallas kernel
//   src/repro/kernels/jl_rademacher/jl_rademacher.py::jl_pallas
// One (n,) float32 vector and m 32-bit row seeds -> the (m,) projection
//   out[r] = sum_j sign(r, j) * v_j
//   sign(r, j) = +1 if the low bit of mix32(j * GOLDEN + row_seed[r]) is 0,
//                else -1
// with mix32 and GOLDEN from sketch_common.cuh.  The +-1 matrix is never
// stored: each sign is hashed where it is used.  The row seeds are an
// input, so one body serves both of the reference's rules:
// kernels.jl_project passes mix32(seed + r * GOLDEN) (the TPU kernel's
// rule) and core.baselines.jl_sketch passes fold_seed(seed, 0) + r.  The
// division by sqrt(m) is the caller's.
//
// Bound on the card: operations.  Each of the m * n terms needs one hash
// (mix32: three xor-shifts of two integer operations each and two
// multiplies, plus the index multiply-add and the low-bit test: 10
// integer operations) and one float add; the bytes are n * 4 read and
// m * 4 written, the vector staying in L2.
//
// Design: one block per output row.  Its threads stride over j (coalesced
// reads of v, UNROLL of them issued before they are used, so a thread
// does not wait on each load in turn), hash, and add +-v_j into a
// register in ascending j; the block then sums the per-thread values in a
// fixed tree (warp shuffles, then the warps in order), so the result is
// the same bits on every launch.  A sign flip is exact and the adds are
// not fused with anything.
#include "sketch_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
jl_rademacher_kernel(const float* __restrict__ v,
                     const unsigned* __restrict__ row_seeds, int64_t n,
                     float* __restrict__ out) {
  __shared__ float s_warp[WARPS];
  const unsigned seed = row_seeds[blockIdx.x];
  float acc = 0.0f;
  // UNROLL loads in flight before their terms are added, in ascending j
  // (the same order as one term at a time)
  int64_t j = threadIdx.x;
  for (; j + (UNROLL - 1) * THREADS < n; j += UNROLL * THREADS) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) x[u] = v[j + u * THREADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned h = sketch::mix32(
          (unsigned)(j + u * THREADS) * sketch::GOLDEN + seed);
      acc = __fadd_rn(acc, (h & 1u) ? -x[u] : x[u]);
    }
  }
  for (; j < n; j += THREADS) {
    const unsigned h = sketch::mix32((unsigned)j * sketch::GOLDEN + seed);
    const float x = v[j];
    acc = __fadd_rn(acc, (h & 1u) ? -x : x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(FULL, acc, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = s_warp[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total = __fadd_rn(total, s_warp[w]);
    out[blockIdx.x] = total;
  }
}

}  // namespace

extern "C" {

// v (n,) f32; row_seeds (m,) uint32; out (m,) f32.
int repro_jl_rademacher(const float* v, const unsigned* row_seeds, int64_t n,
                        int64_t m, float* out, void* stream) {
  if (m <= 0) return 0;
  if (n < 0 || n > 0xFFFFFFFFLL || m > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  jl_rademacher_kernel<<<(unsigned)m, THREADS, 0, (cudaStream_t)stream>>>(
      v, row_seeds, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
