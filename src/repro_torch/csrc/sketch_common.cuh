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
//
// Below them, the device and host helpers that several kernels share:
// the cluster barrier's halves, cp.async copies into shared memory, and a
// device attribute asked once a device.
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

// The low bit of mix32(x), in bit 31 (the other bits are not defined).
// mix32 ends with y = x * M2; y ^= y >> 15, so its low bit is bit 0 xor
// bit 15 of y.  y * (2^31 + 2^16) holds exactly that xor in bit 31 (the
// low 31 bits of y << 31 are zero, so no carry reaches it), and y * (2^31
// + 2^16) = x * (M2 * (2^31 + 2^16)): one multiply in place of mix32's
// last multiply, shift and xor.  For the JL sign (jl_rademacher.cu).
__device__ __forceinline__ uint32_t mix32_sign_bit(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 15;
  return x * (M2 * 0x80010000u);
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

// ------------------------------------------------- shared helpers

// The two halves of a thread-block cluster's barrier.  arrive (release)
// makes this block's earlier writes visible to the blocks that wait;
// arrive_relaxed only says that this block has started (so its shared
// memory may be written by the others after their wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {        // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// cp.async of 4 (through L1) or 16 bytes (L2 only) into shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// *value = what ask(dev, value) sets for the current device, asked once a
// device and kept.  Each call site (each lambda type) has its own cache.
template <typename Ask>
int once_per_device(int* value, Ask&& ask) {
  constexpr int MAX_DEVICES = 64;
  static int known[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && known[dev]) {
    *value = known[dev];
    return 0;
  }
  e = ask(dev, value);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) known[dev] = *value;
  return 0;
}

}  // namespace sketch
