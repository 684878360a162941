// Fused packet-forwarding kernel for Hopper (sm_90a).
//
// Replaces the TPU megakernel src/repro/kernels/fused_forward.py
// (_fused_gather_kernel in gather mode, _fused_contig_kernel in contiguous
// mode, both reached through fused_forward's pl.pallas_call): per block of
// block_b output rows that share one slot s = block_slots[block],
//   layer 1   mism[j] = sum_k popc(x[k] ^ w1[s][j][k])
//   sign      h[j] = ((float)(d - 2 mism[j]) + b1[s][j]) >= 0 ? 1 : -1
//   layer 2   y[c] = sum_j h[j] w2[s][c][j] + b2[s][c]
//   Pi        action = y[0] > 0 ? (ctrl & 1 ? FLAG : DROP) : FORWARD
// with the rows gathered by row_ids (NULL: rows are contiguous).
//
// Bound.  Per packet H d binary MACs (d = 32 W bits) and about W * 4 + 32
// bytes read.  At B = 8192, H = 32, d = 8192 the bound is 2.6-2.8 us, set
// by the bytes at 3.35 TB/s: the MACs at the b1 MMA rate that chip_smoke.py
// measures on the card (about 5.0e15 bit-MACs/s) take 0.4-0.7 us.
//
// Design.  Layer 1 runs on the binary tensor cores:
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// (native on sm_90a at about 39x the POPC pipe's bit rate; .xor.popc is
// emulated there by two AND MMAs and logic, so the kernel uses AND and
// mism = popc(x) + popc(w) - 2 popc(x & w)).  The packed layouts already
// are the fragments: A is 16 gathered rows x 256 bits, read straight from
// the packet rows (row_ids applied per row), B is 8 hidden units x 256 bits
// of w1[s] in its (H, W) order.  Each thread loads 16 bytes of a row (or of
// a weight row) per 512-bit span and feeds two k-steps from them; A and B
// use the same word-to-k-slot map, so the products pair up.  No weight is
// staged: w1[s] (32 KB at H32) is read from L2 through L1 by every warp, so
// no barrier waits on it.  A CTA takes 32 rows of one block (two m16 tiles,
// sharing the B fragments) and splits the d bits over its 4 warps (four
// 512-bit spans each at d = 8192), so no warp walks whole rows one after
// another; the warps' integer sums meet in shared memory.  At 4 warps and
// about 120 registers four CTAs fit on an SM, so B = 8192 (256-384 CTAs)
// runs in one wave, and the data plane's B = 2048 (at most 192 CTAs) still
// covers the SMs.  Layer 2 runs on the
// accumulator fragments: sign, times w2, summed across the four threads of
// a group, plus b2.  The sign input is the reference's float expression, so
// h is exact; only layer 2's summation order differs.  Padding: words past
// W and hidden units past H load as zero (popc 0), and are not stored.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;            // split the d bits; measured faster than 8
constexpr int kLanes = 32;
constexpr int kRowsPerCta = 32;      // two m16 tiles
constexpr int kSpanWords = 16;       // 512 bits: two k-steps of the MMA
constexpr int kMaxTiles = 4;         // H <= 32: four n8 tiles
constexpr int kRed = 2 * kMaxTiles * 4 + 4 + kMaxTiles;  // ints each thread hands on
constexpr int kCtrlWord = 2;
constexpr int kActionForward = 0;
constexpr int kActionDrop = 1;
constexpr int kActionFlag = 2;

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

// Thread (warp, lane) with g = lane / 4, t = lane % 4 holds rows g, g + 8,
// g + 16, g + 24 of the CTA's 32 (A fragments) and hidden unit 8 n + g of
// tile n (B fragments), and accumulates rows g (+16 m), g + 8 (+16 m) by
// hidden units 8 n + 2 t, 8 n + 2 t + 1 (C fragments).  Within a span it
// loads words 4 t .. 4 t + 3: k-step 0 takes words 4 t, 4 t + 1 (k-slots t
// and t + 4), k-step 1 words 4 t + 2, 4 t + 3.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * kLanes)
fused_forward_kernel(const uint32_t* __restrict__ x,
                     const int32_t* __restrict__ row_ids,
                     const int32_t* __restrict__ block_slots,
                     const uint32_t* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     float* __restrict__ scores,
                     int32_t* __restrict__ actions,
                     int block_b, int n_x_rows, long row_stride, int meta_words,
                     int W, int H, int C, int num_slots) {
  __shared__ int red[kWarps][kRed][kLanes];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int g = lane / 4, t = lane % 4;
  const int blk = blockIdx.x;
  const int s = min(max(block_slots[blk], 0), num_slots - 1);
  const int r_base = blockIdx.y * kRowsPerCta;  // first row of the CTA within the block
  const int n_tiles = (H + 7) / 8;

  // The four rows this thread loads (NULL past the block's end).
  const uint32_t* rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r_base + g + 8 * i;
    rows[i] = nullptr;
    if (r < block_b) {
      const long out_row = (long)blk * block_b + r;
      long src = row_ids ? row_ids[out_row] : out_row;
      src = src < 0 ? 0 : (src >= n_x_rows ? n_x_rows - 1 : src);
      rows[i] = x + src * row_stride + meta_words;
    }
  }
  const uint32_t* wrow[kMaxTiles];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    const int j = 8 * n + g;
    wrow[n] = j < H ? w1 + ((size_t)s * H + j) * W : nullptr;
  }

  int acc[2][kMaxTiles][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0;
  int px[4] = {0, 0, 0, 0}, pw[kMaxTiles] = {0, 0, 0, 0};

  const int spans = (W + kSpanWords - 1) / kSpanWords;
  for (int sp = warp; sp < spans; sp += kWarps) {
    const int w0 = sp * kSpanWords + 4 * t;
    uint4 a[4], bw[kMaxTiles];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4<kVec>(rows[i], w0, W);
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n)
      bw[n] = n < n_tiles ? load4<kVec>(wrow[n], w0, W) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) px[i] += popc4(a[i]);
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) {
      if (n >= n_tiles) continue;
      pw[n] += popc4(bw[n]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint4 lo = a[2 * m], hi = a[2 * m + 1];  // rows g + 16 m, g + 8 + 16 m
        bmma_and(acc[m][n], lo.x, hi.x, lo.y, hi.y, bw[n].x, bw[n].y);
        bmma_and(acc[m][n], lo.z, hi.z, lo.w, hi.w, bw[n].z, bw[n].w);
      }
    }
  }

  // Hand the partial sums to warps 0 and 1 (m tile 0 and 1).
  {
    int i = 0;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][i++][lane] = acc[m][n][e];
#pragma unroll
    for (int r = 0; r < 4; ++r) red[warp][i++][lane] = px[r];
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) red[warp][i++][lane] = pw[n];
  }
  __syncthreads();
  if (warp >= 2) return;
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
    for (int h = 0; h < 2; ++h) pxm[h] += red[v][2 * kMaxTiles * 4 + 2 * m + h][lane];
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) pwn[n] += red[v][2 * kMaxTiles * 4 + 4 + n][lane];
  }
  // popc over the whole row / weight row: sum the four threads of a group.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) pxm[h] += __shfl_xor_sync(0xffffffffu, pxm[h], off);
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) pwn[n] += __shfl_xor_sync(0xffffffffu, pwn[n], off);
  }
  // Group q holds popc(w1[s][8 n + q]); this thread needs units 8 n + 2 t + e.
  int pwc[kMaxTiles][2];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) pwc[n][e] = __shfl_sync(0xffffffffu, pwn[n], (2 * t + e) * 4);

  // Sign of layer 1 for rows g + 16 m (h = 0) and g + 8 + 16 m (h = 1).
  const int d_bits = W * 32;
  float hs[2][kMaxTiles][2];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + 2 * t + e;
      const float bj = j < H ? b1[(size_t)s * H + j] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mism = pxm[h] + pwc[n][e] - 2 * sum[n][2 * h + e];
        const float pre = (float)(d_bits - 2 * mism) + bj;
        hs[h][n][e] = j < H ? (pre >= 0.f ? 1.f : -1.f) : 0.f;
      }
    }

  // Layer 2 and Pi.
  long out_row[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_base + g + 8 * h + 16 * m;
    valid[h] = r < block_b;
    out_row[h] = (long)blk * block_b + r;
  }
  float y0[2] = {0.f, 0.f};
  for (int c = 0; c < C; ++c) {
    const float* __restrict__ w2c = w2 + ((size_t)s * C + c) * H;
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * n + 2 * t + e;
        if (j < H) {
          const float wj = w2c[j];
          v[0] += hs[0][n][e] * wj;
          v[1] += hs[1][n][e] * wj;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
      v[h] += b2[(size_t)s * C + c];
      if (c == 0) y0[h] = v[h];
      if (t == 0 && valid[h]) scores[out_row[h] * C + c] = v[h];
    }
  }
  if (actions != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      const uint32_t* row = m == 0 ? rows[h] : rows[2 + h];  // no local-memory index
      const uint32_t ctrl = row[kCtrlWord - meta_words];
      actions[out_row[h]] = y0[h] > 0.f ? ((ctrl & 1u) ? kActionFlag : kActionDrop)
                                        : kActionForward;
    }
  }
}

}  // namespace

extern "C" int fused_forward_launch(
    const void* x, const void* row_ids, const void* block_slots,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* scores, void* actions,
    int n_blocks, int block_b, int n_x_rows, int row_stride,
    int meta_words, int W, int H, int C, int num_slots, void* stream) {
  if (H > kMaxTiles * 8) return cudaErrorInvalidValue;
  const auto* xw = static_cast<const uint32_t*>(x);
  const bool vec = W % 4 == 0 && row_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(xw + meta_words) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  auto kernel = vec ? fused_forward_kernel<true> : fused_forward_kernel<false>;
  const dim3 grid(n_blocks, (block_b + kRowsPerCta - 1) / kRowsPerCta);
  kernel<<<grid, kWarps * kLanes, 0, (cudaStream_t)stream>>>(
      xw, static_cast<const int32_t*>(row_ids),
      static_cast<const int32_t*>(block_slots),
      static_cast<const uint32_t*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(scores), static_cast<int32_t*>(actions),
      block_b, n_x_rows, row_stride, meta_words, W, H, C, num_slots);
  return cudaGetLastError();
}

extern "C" const char* fused_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
