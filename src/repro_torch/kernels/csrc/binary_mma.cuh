// Layer 1 of the binary networks on Hopper's binary tensor cores, shared by
// fused_forward.cu, xnor_matmul.cu and banked_xnor_layer1.cu:
//   mism[r][j] = sum_k popc(x[r][k] ^ w[j][k])
// for the rows of one CTA (one or two m16 tiles) against up to 32 weight rows
// (four n8 tiles), over all W words.
//
// The MMA is mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc:
// native on sm_90a at about 39x the POPC pipe's bit rate, where .xor.popc is
// emulated by two AND MMAs and logic.  So the product is popc(x & w) and
//   mism = popc(x) + popc(w) - 2 popc(x & w),
// with popc(x) and popc(w) counted from the same registers.  The packed rows
// and the (H, W) weight rows already are the fragments: A is 16 rows x 256
// bits, B is 8 weight rows x 256 bits, and A and B share one word-to-k-slot
// map, so the products pair up.  Nothing is staged in shared memory: each
// thread loads 16 bytes of a row or a weight row per 512-bit span straight
// from global memory, and the spans are split over the CTA's warps, whose
// integer sums then meet in shared memory once.
//
// Fragment map.  Thread (warp, lane) with g = lane / 4, t = lane % 4 holds
// rows g + 8 i (i < 2 M) of the CTA's 16 M (A fragments) and weight row
// 8 n + g of tile n (B fragments), and accumulates rows g + 16 m and
// g + 8 + 16 m by weight rows 8 n + 2 t, 8 n + 2 t + 1 (C fragments).  In a
// span it loads words 4 t .. 4 t + 3: k-step 0 takes words 4 t, 4 t + 1
// (k-slots t and t + 4), k-step 1 words 4 t + 2, 4 t + 3.
//
// Padding: words past W, rows given as NULL and weight rows past n_tiles
// load as zero and add nothing; the caller does not store them.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bmma {

constexpr int kLanes = 32;
constexpr int kSpanWords = 16;  // 512 bits: two k-steps of the MMA
constexpr int kMaxTiles = 4;    // four n8 tiles: 32 weight rows

// Ints each thread hands to the reduction for M m16 tiles: the accumulators,
// the row popcounts and the weight-row popcounts.
template <int M>
constexpr int kRed = M * kMaxTiles * 4 + 2 * M + kMaxTiles;

// Words [w0, w0 + 4) of the row at p, zero past W or where p is NULL.
// kVec: p and w0 are 16-byte aligned and W is a multiple of 4.
template <bool kVec>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ p, int w0, int W) {
  if (p == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kVec) {
    return w0 < W ? __ldg(reinterpret_cast<const uint4*>(p + w0)) : make_uint4(0u, 0u, 0u, 0u);
  } else {
    return make_uint4(w0 < W ? __ldg(p + w0) : 0u, w0 + 1 < W ? __ldg(p + w0 + 1) : 0u,
                      w0 + 2 < W ? __ldg(p + w0 + 2) : 0u, w0 + 3 < W ? __ldg(p + w0 + 3) : 0u);
  }
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// c += popc(A & B) over one 16 x 8 x 256-bit tile.
__device__ __forceinline__ void bmma_and(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Whether 16-byte loads may be taken: W a multiple of 4 words and every
// (base, row stride in words) pair 16-byte aligned.
inline bool vec_loads(int W, const void* x, long x_stride, const void* w, long w_stride) {
  return W % 4 == 0 && x_stride % 4 == 0 && w_stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// Layer 1 of a CTA of kWarps warps over M m16 tiles.  rows[i] is the thread's
// row g + 8 i (NULL past the end), wrow[n] its weight row 8 n + g (NULL past
// the end); n_tiles of the four n8 tiles hold a weight row.  Called by the
// whole CTA (it has a barrier).  Returns true on warp m < M, with
// mism[n][2 h + e] the mismatches of row g + 8 h + 16 m against weight row
// 8 n + 2 t + e; the other warps are done and return false.
template <int kWarps, int M, bool kVec>
__device__ __forceinline__ bool layer1_mismatches(
    int (&red)[kWarps][kRed<M>][kLanes], const uint32_t* const (&rows)[2 * M],
    const uint32_t* const (&wrow)[kMaxTiles], int n_tiles, int W,
    int (&mism)[kMaxTiles][4]) {
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int t = lane % 4;

  int acc[M][kMaxTiles][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0;
  int px[2 * M], pw[kMaxTiles] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 2 * M; ++i) px[i] = 0;

  const int spans = (W + kSpanWords - 1) / kSpanWords;
  for (int sp = warp; sp < spans; sp += kWarps) {
    const int w0 = sp * kSpanWords + 4 * t;
    uint4 a[2 * M], bw[kMaxTiles];
#pragma unroll
    for (int i = 0; i < 2 * M; ++i) a[i] = load4<kVec>(rows[i], w0, W);
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n)
      bw[n] = n < n_tiles ? load4<kVec>(wrow[n], w0, W) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < 2 * M; ++i) px[i] += popc4(a[i]);
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) {
      if (n >= n_tiles) continue;
      pw[n] += popc4(bw[n]);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint4 lo = a[2 * m], hi = a[2 * m + 1];  // rows g + 16 m, g + 8 + 16 m
        bmma_and(acc[m][n], lo.x, hi.x, lo.y, hi.y, bw[n].x, bw[n].y);
        bmma_and(acc[m][n], lo.z, hi.z, lo.w, hi.w, bw[n].z, bw[n].w);
      }
    }
  }

  // Hand the partial sums to warps 0 .. M - 1 (m tile m to warp m).
  {
    int i = 0;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][i++][lane] = acc[m][n][e];
#pragma unroll
    for (int r = 0; r < 2 * M; ++r) red[warp][i++][lane] = px[r];
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) red[warp][i++][lane] = pw[n];
  }
  __syncthreads();
  if (warp >= M) return false;
  const int m = warp;
  int sum[kMaxTiles][4], pxm[2] = {0, 0}, pwn[kMaxTiles];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    pwn[n] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] = 0;
  }
  for (int v = 0; v < kWarps; ++v) {
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[n][e] += red[v][(m * kMaxTiles + n) * 4 + e][lane];
#pragma unroll
    for (int h = 0; h < 2; ++h) pxm[h] += red[v][M * kMaxTiles * 4 + 2 * m + h][lane];
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) pwn[n] += red[v][M * kMaxTiles * 4 + 2 * M + n][lane];
  }
  // popc over the whole row / weight row: sum the four threads of a group.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) pxm[h] += __shfl_xor_sync(0xffffffffu, pxm[h], off);
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) pwn[n] += __shfl_xor_sync(0xffffffffu, pwn[n], off);
  }
  // Group q holds popc(w[8 n + q]); this thread needs weight rows 8 n + 2 t + e.
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pwc = __shfl_sync(0xffffffffu, pwn[n], (2 * t + e) * 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) mism[n][2 * h + e] = pxm[h] + pwc - 2 * sum[n][2 * h + e];
    }
  return true;
}

}  // namespace bmma
