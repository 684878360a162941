// Slot-selected BNN layer 1 for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/banked_matmul.py
// (_banked_xnor_kernel, reached through banked_xnor_layer1's pl.pallas_call):
// for every block of block_b rows that share one slot s = block_slots[block],
//   out[r][j] = (float)(d - 2 * sum_k popc(x[r][k] ^ w1[s][j][k])) + b1[s][j]
// with d = 32 W.  The float expression is the reference's (one int-to-float
// conversion, exact for |d| <= 2^24, then one rounded add), so the output is
// bit-equal to the plain version.
//
// Bound.  Per row W * 4 bytes read and H * 4 written, the used slots' w1 and
// b1 read once, and H d binary MACs.  At B = 8192, H = 32, d = 8192 over the
// 16 slots of one half of the double bank that is about 9.9 MB: 2.95 us at
// 3.35 TB/s, while the MACs at the b1.and.popc MMA rate that chip_smoke.py
// measures on the card (about 4.9e15 bit-MACs/s) take 0.43 us.  So the
// bytes bound it, and the design's aim is to keep the loads in flight.
//
// Design.  The fused kernel's layer 1 (binary_mma.cuh) with b1 added and no
// layer 2.  One CTA of 4 warps takes 32 rows of one block (two m16 tiles,
// ceil(block_b / 32) CTAs per block), reads its slot id and clamps it; the
// warps split the 512-bit spans of d and load their A fragments straight
// from the rows (stride x_stride) and their B fragments from w1[s] in its
// (H, W) order, 16 bytes a thread where the rows and w1 are 16-byte aligned
// (kVec) and 4 bytes otherwise.  No row and no weight is staged in shared
// memory, so any W is taken; only the warps' integer sums meet there, once.
// At 4 warps four CTAs fit on an SM, so B = 8192 (256 CTAs) runs in one
// wave.  The reference's word-axis tiling (chunk) is a TPU tiling knob and
// plays no part here.  Rows past the block and hidden units past H
// (H <= 32) load as zero and are not stored.

#include "binary_mma.cuh"

namespace {

using bmma::kLanes;
using bmma::kMaxTiles;

constexpr int kWarps = 4;
constexpr int kMTiles = 2;
constexpr int kRowsPerCta = 16 * kMTiles;

template <bool kVec>
__global__ void __launch_bounds__(kWarps * kLanes)
banked_xnor_layer1_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w1,
                          const float* __restrict__ b1,
                          const int32_t* __restrict__ block_slots,
                          float* __restrict__ out,
                          int block_b, long x_stride, int W, int H, int num_slots) {
  __shared__ int red[kWarps][bmma::kRed<kMTiles>][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int g = lane / 4, t = lane % 4;
  const int blk = blockIdx.x;
  const int s = min(max(block_slots[blk], 0), num_slots - 1);
  const int r_base = blockIdx.y * kRowsPerCta;  // first row of the CTA within the block

  const uint32_t* rows[2 * kMTiles];
#pragma unroll
  for (int i = 0; i < 2 * kMTiles; ++i) {
    const int r = r_base + g + 8 * i;
    rows[i] = r < block_b ? x + ((long)blk * block_b + r) * x_stride : nullptr;
  }
  const uint32_t* wrow[kMaxTiles];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    const int j = 8 * n + g;
    wrow[n] = j < H ? w1 + ((size_t)s * H + j) * W : nullptr;
  }

  int mism[kMaxTiles][4];
  if (!bmma::layer1_mismatches<kWarps, kMTiles, kVec>(red, rows, wrow, (H + 7) / 8, W, mism))
    return;
  const int m = threadIdx.x / kLanes;

  const int d_bits = W * 32;
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + 2 * t + e;
      if (j >= H) continue;
      const float bj = b1[(size_t)s * H + j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + g + 8 * h + 16 * m;
        if (r < block_b)
          out[((long)blk * block_b + r) * H + j] = (float)(d_bits - 2 * mism[n][2 * h + e]) + bj;
      }
    }
}

}  // namespace

extern "C" int banked_xnor_layer1_launch(
    const void* x, const void* w1, const void* b1, const void* block_slots,
    void* out, int n_blocks, int block_b, int x_stride, int W, int H,
    int num_slots, void* stream) {
  if (H > kMaxTiles * 8) return cudaErrorInvalidValue;
  auto kernel = bmma::vec_loads(W, x, x_stride, w1, W) ? banked_xnor_layer1_kernel<true>
                                                       : banked_xnor_layer1_kernel<false>;
  const dim3 grid(n_blocks, (block_b + kRowsPerCta - 1) / kRowsPerCta);
  kernel<<<grid, kWarps * kLanes, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w1),
      static_cast<const float*>(b1), static_cast<const int32_t*>(block_slots),
      static_cast<float*>(out), block_b, x_stride, W, H, num_slots);
  return cudaGetLastError();
}

extern "C" const char* banked_xnor_layer1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
