// Bucketized corpus merge for Hopper (sm_90a).
//
// merge_bucketized_kernel replaces the Pallas kernel
//   src/repro/kernels/sketch_merge/sketch_merge.py::merge_bucketized_pallas
// Two coordinated (D, B, S) bucketized corpora (int32 ids, float32 values)
// and a per-row merged tau (D,) -> the merged (D, B, S) corpus and the
// entries each row lost to a full bucket during the merge (D,) int32.
//
// Per row d and bucket b: the 2S candidates are a's S slots then b's.  A
// candidate's rank is recomputed from its id and value with the device
// functions of sketch_common.cuh (the same bits as at build time; padding
// has value 0, so weight 0 and rank +inf).  a's slot is kept when its id
// is valid and rank < tau; b's slot also needs its id absent from a's
// bucket (the S x S compare: a coordinate shared by both sides lands in
// the same bucket, and a's copy stands for it).  A kept candidate's output
// slot is the number of kept candidates with a smaller id (the 2S x 2S
// count: canonical coordinate order, ids unique after the dedupe); slots
// >= S are dropped and counted.  Unused output slots get INVALID / 0.
//
// Bound on the card: memory — both corpora are read once (D*B*S*16 bytes
// plus tau) and the merged one written once (D*B*S*8); the rank recompute
// is ~20 integer and float operations a slot.  Design: one thread per
// (row, bucket), so each thread reads its 2S ids and values as S-wide
// vector loads when S = 4 (16-byte aligned rows) and keeps the candidates
// in registers; the compaction is unrolled over compile-time S.  The drop
// counts are reduced across the warp with shuffles, then one integer
// atomic per warp adds to dropped[d]; integer sums do not depend on the
// order, so the output is deterministic.
#include "sketch_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int INVALID = 0x7FFFFFFF;

template <int S>
__device__ __forceinline__ void load_slots(const int* idx, const float* val,
                                           int64_t off, bool vec, int* ci,
                                           float* cv) {
  if constexpr (S == 4) {
    if (vec) {
      const int4 i4 = *reinterpret_cast<const int4*>(idx + off);
      const float4 v4 = *reinterpret_cast<const float4*>(val + off);
      ci[0] = i4.x; ci[1] = i4.y; ci[2] = i4.z; ci[3] = i4.w;
      cv[0] = v4.x; cv[1] = v4.y; cv[2] = v4.z; cv[3] = v4.w;
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ci[s] = idx[off + s];
    cv[s] = val[off + s];
  }
}

template <int S>
__device__ __forceinline__ void store_slots(int* idx, float* val, int64_t off,
                                            bool vec, const int* oi,
                                            const float* ov) {
  if constexpr (S == 4) {
    if (vec) {
      *reinterpret_cast<int4*>(idx + off) = make_int4(oi[0], oi[1], oi[2], oi[3]);
      *reinterpret_cast<float4*>(val + off) = make_float4(ov[0], ov[1], ov[2], ov[3]);
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    idx[off + s] = oi[s];
    val[off + s] = ov[s];
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS)
merge_bucketized_kernel(const int* __restrict__ a_idx,
                        const float* __restrict__ a_val,
                        const int* __restrict__ b_idx,
                        const float* __restrict__ b_val,
                        const float* __restrict__ tau, int* __restrict__ o_idx,
                        float* __restrict__ o_val, int* __restrict__ dropped,
                        int64_t B, uint32_t seed, int variant, bool vec) {
  const int64_t d = blockIdx.y;
  const int64_t bucket = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int drop = 0;
  if (bucket < B) {
    const int64_t off = (d * B + bucket) * S;
    int ci[2 * S];
    float cv[2 * S];
    load_slots<S>(a_idx, a_val, off, vec, ci, cv);
    load_slots<S>(b_idx, b_val, off, vec, ci + S, cv + S);
    const float t = tau[d];
    int key[2 * S];
#pragma unroll
    for (int j = 0; j < 2 * S; ++j) {
      bool keep = ci[j] != INVALID;
      if (j >= S) {
#pragma unroll
        for (int u = 0; u < S; ++u)
          keep = keep && !(ci[u] != INVALID && ci[u] == ci[j]);
      }
      if (keep) {
        const float hu = sketch::unit_hash((uint32_t)ci[j], seed);
        keep = sketch::rank_of(hu, sketch::weight(cv[j], variant)) < t;
      }
      key[j] = keep ? ci[j] : INVALID;
    }
    int oi[S];
    float ov[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      oi[s] = INVALID;
      ov[s] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 2 * S; ++j) {
      if (key[j] == INVALID) continue;  // not kept (a kept id is never INVALID)
      int pos = 0;
#pragma unroll
      for (int k = 0; k < 2 * S; ++k) pos += key[k] < key[j];
      if (pos >= S) {
        ++drop;
        continue;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (pos == s) {
          oi[s] = ci[j];
          ov[s] = cv[j];
        }
      }
    }
    store_slots<S>(o_idx, o_val, off, vec, oi, ov);
  }
  // every thread of the block reaches the shuffles (out-of-range buckets
  // carry drop = 0)
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) drop += __shfl_down_sync(0xffffffffu, drop, w);
  if ((threadIdx.x & 31) == 0 && drop) atomicAdd(&dropped[d], drop);
}

template <int S>
int launch(const int* a_idx, const float* a_val, const int* b_idx,
           const float* b_val, const float* tau, int* o_idx, float* o_val,
           int* dropped, int64_t D, int64_t B, uint32_t seed, int variant,
           bool vec, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + THREADS - 1) / THREADS), (unsigned)D);
  merge_bucketized_kernel<S><<<grid, THREADS, 0, stream>>>(
      a_idx, a_val, b_idx, b_val, tau, o_idx, o_val, dropped, B, seed,
      variant, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a_idx/b_idx (D, B, S) int32, a_val/b_val (D, B, S) f32, tau (D,) f32;
// o_idx (D, B, S) int32, o_val (D, B, S) f32, dropped (D,) int32 zeroed by
// the caller.  variant: 0 l2, 1 l1, 2 uniform.  1 <= S <= 8.
int repro_merge_bucketized(const int* a_idx, const float* a_val,
                           const int* b_idx, const float* b_val,
                           const float* tau, int* o_idx, float* o_val,
                           int* dropped, int64_t D, int64_t B, int S,
                           uint32_t seed, int variant, void* stream) {
  if (D <= 0 || B <= 0) return 0;
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  const uintptr_t all = (uintptr_t)a_idx | (uintptr_t)a_val |
                        (uintptr_t)b_idx | (uintptr_t)b_val |
                        (uintptr_t)o_idx | (uintptr_t)o_val;
  const bool vec = (all & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (S) {
#define CASE(K)                                                             \
  case K:                                                                   \
    return launch<K>(a_idx, a_val, b_idx, b_val, tau, o_idx, o_val, dropped, \
                     D, B, seed, variant, vec, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
