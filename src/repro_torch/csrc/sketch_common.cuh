// Hash, weight and sampling rank shared by every kernel that must stay
// bit-coordinated with the reference (src/repro/core/hashing.py and
// src/repro/kernels/hash_rank/hash_rank.py::_block_hash_rank): the build
// kernels (sketch_build.cu) and the bucketized merge (sketch_merge.cu).
//
//   h    = mix32(j * 0x9E3779B9 + seed)
//   hu   = ((h >> 8) + 0.5) * 2^-24
//   w    = v^2 | |v| | 1[v != 0]                 (l2 | l1 | uniform)
//   rank = hu / w, +inf where w == 0
//
// The reference runs under XLA, which flushes float32 subnormals to zero;
// here a subnormal weight is flushed to 0 (rank +inf) and a subnormal rank
// to 0 explicitly.  The products and the division are the correctly
// rounded __fmul_rn / __fadd_rn / __fdiv_rn; nothing is built with
// fast-math or -ftz.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace sketch {

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

// The 24-bit unit hash of coordinate j.
__device__ __forceinline__ float unit_hash(uint32_t j, uint32_t seed) {
  const uint32_t h = mix32(j * GOLDEN + seed);
  return __fmul_rn(__fadd_rn((float)(h >> 8), 0.5f), UNIT);
}

// variant: 0 = l2, 1 = l1, 2 = uniform
__device__ __forceinline__ float weight(float v, int variant) {
  if (variant == 0) return flush(__fmul_rn(v, v));
  if (variant == 1) return flush(fabsf(v));
  return flush(v) != 0.0f ? 1.0f : 0.0f;
}

// Sampling rank hu / w (+inf where w == 0, a subnormal rank flushed to 0).
__device__ __forceinline__ float rank_of(float hu, float w) {
  const float r = w > 0.0f ? __fdiv_rn(hu, w) : INFINITY;
  return r < FLT_MIN ? 0.0f : r;
}

}  // namespace sketch
