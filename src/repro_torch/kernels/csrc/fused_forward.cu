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
// Design.  Layer 1 runs on the binary tensor cores (mma.sync m16n8k256
// b1.and.popc with the popcount correction; binary_mma.cuh), its fragments
// loaded straight from the packet rows (row_ids applied per row) and from
// w1[s] in its (H, W) order.  No weight is staged: w1[s] (32 KB at H32) is
// read from L2 through L1 by every warp, so no barrier waits on it.  A CTA
// takes 32 rows of one block (two m16 tiles, sharing the B fragments) and
// splits the d bits over its 4 warps (four 512-bit spans each at d = 8192),
// so no warp walks whole rows one after another; the warps' integer sums
// meet in shared memory.  At 4 warps and about 120 registers four CTAs fit
// on an SM, so B = 8192 (256-384 CTAs) runs in one wave, and the data
// plane's B = 2048 (at most 192 CTAs) still covers the SMs.  Layer 2 runs
// on the accumulator fragments: sign, times w2, summed across the four
// threads of a group, plus b2.  The sign input is the reference's float
// expression, so h is exact; only layer 2's summation order differs.
// Padding: words past W and hidden units past H load as zero (popc 0), and
// are not stored.

#include "binary_mma.cuh"

namespace {

using bmma::kLanes;
using bmma::kMaxTiles;

constexpr int kWarps = 4;            // split the d bits; measured faster than 8
constexpr int kRowsPerCta = 32;      // two m16 tiles
constexpr int kCtrlWord = 2;
constexpr int kActionForward = 0;
constexpr int kActionDrop = 1;
constexpr int kActionFlag = 2;

// Layer 1 is bmma::layer1_mismatches (binary_mma.cuh) over the CTA's 32 rows;
// warp m < 2 then holds rows g + 16 m and g + 8 + 16 m by hidden units
// 8 n + 2 t + e and runs the epilogue on them.
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
  __shared__ int red[kWarps][bmma::kRed<2>][kLanes];
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

  int mism[kMaxTiles][4];
  if (!bmma::layer1_mismatches<kWarps, 2, kVec>(red, rows, wrow, n_tiles, W, mism)) return;
  const int m = warp;

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
        const float pre = (float)(d_bits - 2 * mism[n][2 * h + e]) + bj;
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
  const bool vec = bmma::vec_loads(W, xw + meta_words, row_stride, w1, W);
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
