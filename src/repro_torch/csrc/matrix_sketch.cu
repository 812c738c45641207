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
// Each output entry is, exactly as in the block-a-pair design this one
// replaced,
//   acc = fmaf(rn(a_k * c), b_l, acc),  c = fmaxf(1 / p_a, 1 / p_b),
// over the matches in ascending (bucket, sa, sb) order from 0, so a
// pair's bits depend on its two sketches alone: not on P, the route or
// the layout of the launch.
//
// Bound on the card: bytes and latency, not arithmetic.  A pair must read
// both sides' ids (B*S*4 bytes a side; the library's 8 MB for a 1024-pair
// store query) and, for its matched slots only (~18 a pair there), the
// probabilities and the rows.  The arithmetic is 2*d_a*d_b flops a match,
// 9.4 MFLOP for that query: 0.14 us at the fp32 rate.  Tensor cores would
// not move it (and TF32 would change the bits).  What costs is the ids'
// bytes and the chain of dependent steps a pair takes: the block-a-pair
// design ran six phases with five block barriers on 8 warps a pair, 45 KB
// of shared memory a block, two waves at P = 1024.
//
// Design, one launch, a block of 4 warps a (pair, output tile) (8 warps
// when the blocks are few enough to be in flight at once, four an SM: the
// products call's 256 pairs, where 8 warps took ~16% less time on an
// H100):
// - Thread t takes buckets [t * bpt, (t + 1) * bpt), four at a time: the
//   eight loads of a round (at S = 4 with aligned ids, one 16-byte load a
//   bucket and side) are issued together, then the S x S compares give its
//   matches.  One block scan of the threads' counts places every match in
//   (bucket, sa, sb) order.
// - The matches are listed (a slot, b slot) in shared memory, up to 64 at
//   a time; the block copies their rows in with cp.async (16-byte copies
//   where the rows allow), thread j loads match j's probabilities and
//   makes c, and each staged a row is scaled once, rn(a_k * c), as the
//   contract rounds it.
// - A thread of the tile then takes one k and 8 consecutive l (16-byte
//   shared loads of b) and adds the matches in list order.
// - A pair with more than 64 matches takes several windows, and each
//   window walks a thread's buckets from its first again (ids past its
//   first four buckets are re-read).  The design assumes few matches a
//   pair: ~18 at the store query, ~41 at the products call, one window
//   each.  A cursor kept across windows made those one-window calls
//   slower and was dropped.
// - The block size and the list's length change no bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_common.cuh"

namespace {

constexpr int LANE_COLS = 8;        // output entries a thread: one k, 8 l
constexpr int MATCHES_MAX = 64;     // matches staged a round: STAGE_ROWS
constexpr int INVALID = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448 - 64;   // 227 KiB less the static bytes

__device__ __forceinline__ int comp(const int4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}

// The matches of one bucket at S == 4: bit sa * 4 + sb.
__device__ __forceinline__ unsigned mask4(const int4& a, const int4& x) {
  unsigned mk = 0;
#pragma unroll
  for (int sa = 0; sa < 4; ++sa) {
    const int ia = comp(a, sa);
    if (ia == INVALID) continue;
#pragma unroll
    for (int sb = 0; sb < 4; ++sb)
      if (comp(x, sb) == ia) mk |= 1u << (sa * 4 + sb);
  }
  return mk;
}

// The match masks of buckets r .. r + 3 at S == 4 (0 from b1 on), their
// eight 16-byte loads issued together.
__device__ __forceinline__ void masks4(const int* __restrict__ ai,
                                       const int* __restrict__ bi, int r,
                                       int b1, unsigned (&m)[4]) {
  const int4 none = make_int4(INVALID, INVALID, INVALID, INVALID);
  int4 a[4], x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool in = r + u < b1;
    a[u] = in ? __ldg(reinterpret_cast<const int4*>(ai) + r + u) : none;
    x[u] = in ? __ldg(reinterpret_cast<const int4*>(bi) + r + u) : none;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) m[u] = mask4(a[u], x[u]);
}

// Calls put(sa, sb) for each match of bucket b, any S, in (sa, sb) order.
template <typename F>
__device__ __forceinline__ void scalar_matches(const int* __restrict__ ai,
                                               const int* __restrict__ bi,
                                               int b, int S, F&& put) {
  for (int sa = 0; sa < S; ++sa) {
    const int ia = __ldg(ai + (size_t)b * S + sa);
    if (ia == INVALID) continue;
    for (int sb = 0; sb < S; ++sb)
      if (__ldg(bi + (size_t)b * S + sb) == ia) put(sa, sb);
  }
}

// One block a (pair, tile of THREADS x LANE_COLS output entries).
// Dynamic shared memory:
// mb listed matches, their a rows (mb, da), b rows (mb, db), coefficients
// and slots.  rows16: 16-byte copies of the rows.  bpt: buckets a thread.
template <bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
matrix_products_kernel(const int* __restrict__ a_idx,
                       const float* __restrict__ a_rows,
                       const float* __restrict__ a_p,
                       const int* __restrict__ b_idx,
                       const float* __restrict__ b_rows,
                       const float* __restrict__ b_p, float* __restrict__ out,
                       int a_batched, int B, int S, int da, int db, int tiles,
                       int mb, int rows16, int bpt) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WARPS = THREADS / 32;
  __shared__ int s_warp[WARPS];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + (size_t)mb * da;
  float* s_c = s_b + (size_t)mb * db;
  int* s_sa = reinterpret_cast<int*>(s_c + mb);
  int* s_sb = s_sa + mb;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t pair = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - pair * tiles);
  const int64_t nslot = (int64_t)B * S;
  const int64_t a_off = a_batched ? pair * nslot : 0;
  const int64_t b_off = pair * nslot;
  const int* ai = a_idx + a_off;
  const int* bi = b_idx + b_off;

  // this thread's buckets [b0, b1), four at a time, and their matches
  // (VEC: the first four buckets' masks kept); a block scan places them in
  // (bucket, sa, sb) order
  const int b0 = min(B, t * bpt), b1 = min(B, b0 + bpt);
  unsigned kept[4] = {0u, 0u, 0u, 0u};
  int cnt = 0;
  for (int r = b0; r < b1; r += 4) {
    if (VEC) {
      unsigned m[4];
      masks4(ai, bi, r, b1, m);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cnt += __popc(m[u]);
        if (r == b0) kept[u] = m[u];
      }
    } else {
      for (int b = r; b < r + 4 && b < b1; ++b)
        scalar_matches(ai, bi, b, S, [&](int, int) { ++cnt; });
    }
  }
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  const int first = before + incl - cnt;     // this thread's first place

  // this thread's output entries: row k, columns l0 .. l0 + 7 of the tile's
  // (k, 8-column group) slots
  const int nlb = (db + LANE_COLS - 1) / LANE_COLS;
  const int slot = tile * THREADS + t;
  const bool active = slot < da * nlb;
  const int k = active ? slot / nlb : 0;
  const int l0 = active ? (slot - k * nlb) * LANE_COLS : 0;
  const bool vec_b = db % LANE_COLS == 0 && mb % 4 == 0;
  float acc[LANE_COLS];
#pragma unroll
  for (int i = 0; i < LANE_COLS; ++i) acc[i] = 0.0f;
  const int width = rows16 ? 4 : 1;
  const int qa = da / width, per = qa + db / width;
  // the matches mb at a time: list them (each window walks this thread's
  // buckets from b0 again, see the header), copy their rows in, scale the
  // a rows by their coefficients (rn(a_k * c)), add them
  for (int w0 = 0; w0 < total; w0 += mb) {
    const int take = total - w0 < mb ? total - w0 : mb;
    int pos = first - w0;
    auto put = [&](int b, int sa, int sb) {
      if (pos >= 0 && pos < take) {
        s_sa[pos] = b * S + sa;
        s_sb[pos] = b * S + sb;
      }
      ++pos;
    };
    for (int r = b0; r < b1 && pos < take; r += 4) {
      if (VEC) {
        unsigned m[4] = {kept[0], kept[1], kept[2], kept[3]};
        if (r != b0) masks4(ai, bi, r, b1, m);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          for (unsigned mk = m[u]; mk; mk &= mk - 1) {
            const int bit = __ffs(mk) - 1;
            put(r + u, bit >> 2, bit & 3);
          }
      } else {
        for (int b = r; b < r + 4 && b < b1; ++b)
          scalar_matches(ai, bi, b, S,
                         [&](int sa, int sb) { put(b, sa, sb); });
      }
    }
    __syncthreads();
    for (int i = t; i < take * per; i += THREADS) {
      const int j = i / per, q = i - j * per;
      const bool in_a = q < qa;
      const int e = (in_a ? q : q - qa) * width;
      float* dst = in_a ? s_a + j * da + e : s_b + j * db + e;
      const float* src = in_a ? a_rows + (a_off + s_sa[j]) * da + e
                              : b_rows + (b_off + s_sb[j]) * db + e;
      if (rows16) sketch::cp_async16(dst, src);
      else sketch::cp_async4(dst, src);
    }
    for (int j = t; j < take; j += THREADS)
      s_c[j] = fmaxf(1.0f / __ldg(a_p + a_off + s_sa[j]),
                     1.0f / __ldg(b_p + b_off + s_sb[j]));
    sketch::cp_async_wait_all();
    __syncthreads();
    for (int i = t; i < take * da; i += THREADS)
      s_a[i] = __fmul_rn(s_a[i], s_c[i / da]);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int j = 0; j < take; ++j) {
        const float ca = s_a[j * da + k];
        const float* br = s_b + j * db + l0;
        if (vec_b) {
          const float4 x = reinterpret_cast<const float4*>(br)[0];
          const float4 y = reinterpret_cast<const float4*>(br)[1];
          acc[0] = fmaf(ca, x.x, acc[0]);
          acc[1] = fmaf(ca, x.y, acc[1]);
          acc[2] = fmaf(ca, x.z, acc[2]);
          acc[3] = fmaf(ca, x.w, acc[3]);
          acc[4] = fmaf(ca, y.x, acc[4]);
          acc[5] = fmaf(ca, y.y, acc[5]);
          acc[6] = fmaf(ca, y.z, acc[6]);
          acc[7] = fmaf(ca, y.w, acc[7]);
        } else {
#pragma unroll
          for (int c = 0; c < LANE_COLS; ++c)
            if (l0 + c < db) acc[c] = fmaf(ca, br[c], acc[c]);
        }
      }
    }
    __syncthreads();                         // the lists are reused
  }
  if (active) {
    float* o = out + pair * da * db + (int64_t)k * db + l0;
#pragma unroll
    for (int i = 0; i < LANE_COLS; ++i)
      if (l0 + i < db) o[i] = acc[i];
  }
}

}  // namespace

extern "C" {

// a_idx (Pa, B, S) int32, a_rows (Pa, B, S, da) f32, a_p (Pa, B, S) f32
// with Pa = P when a_batched else 1; b_* the same with P and db;
// out (P, da, db) f32.  Dynamic shared memory: up to 64 listed matches of
// 12 + 4*(da+db) bytes; one must fit in 227 KiB less 64 bytes.
int repro_matrix_products(const int* a_idx, const float* a_rows,
                          const float* a_p, const int* b_idx,
                          const float* b_rows, const float* b_p, float* out,
                          int64_t P, int a_batched, int64_t B, int S, int da,
                          int db, void* stream) {
  if (P <= 0 || da <= 0 || db <= 0) return 0;
  if (B <= 0 || S <= 0 || B * S > (1 << 20) || P > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  // 8 warps a block when the blocks are few enough to be in flight at once
  // (four an SM), else 4
  int sms = 1;
  const int err = sketch::once_per_device(&sms, [](int dev, int* n) {
    return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  });
  if (err) return err;
  const int64_t groups = (int64_t)da * ((db + LANE_COLS - 1) / LANE_COLS);
  const int threads = P * ((groups + 255) / 256) <= 4 * (int64_t)sms ? 256
                                                                      : 128;
  const int64_t tiles = (groups + threads - 1) / threads;
  if (P * tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t per_match = 12 + 4 * ((size_t)da + db);
  size_t mb = SMEM_MAX / per_match;
  if (mb < 1) return (int)cudaErrorInvalidValue;
  mb = mb > MATCHES_MAX ? MATCHES_MAX : mb >= 4 ? mb / 4 * 4 : mb;
  const size_t smem = mb * per_match;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = S == 4 && aligned(a_idx) && aligned(b_idx);
  const int rows16 = da % 4 == 0 && db % 4 == 0 && mb % 4 == 0 &&
                     aligned(a_rows) && aligned(b_rows);
  const int bpt = (int)((B + threads - 1) / threads);
  auto* kernel = threads == 256 ? (vec ? matrix_products_kernel<true, 256>
                                       : matrix_products_kernel<false, 256>)
                                : (vec ? matrix_products_kernel<true, 128>
                                       : matrix_products_kernel<false, 128>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)(P * tiles), threads, smem, (cudaStream_t)stream>>>(
      a_idx, a_rows, a_p, b_idx, b_rows, b_p, out, a_batched, (int)B, S, da,
      db, (int)tiles, (int)mb, rows16, bpt);
  return (int)cudaGetLastError();
}

}  // extern "C"
