// Binary (XNOR-popcount) matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bnn_xnor.py (_xnor_kernel,
// reached through xnor_matmul's pl.pallas_call):
//   out[b][h] = d - 2 * sum_k popc(x[b][k] ^ w[h][k]),   d = 32 W.
//
// Bound.  B W * 4 bytes of rows and H W * 4 of weights read, B H * 4
// written, and B H d binary MACs.  At B = 8192, H = 32, d = 8192 that is
// about 9.5 MB: 2.83 us at 3.35 TB/s, against 0.43 us for the MACs at the
// b1.and.popc MMA rate that chip_smoke.py measures on the card (about
// 4.9e15 bit-MACs/s).  At B = 1 (the Table V control-plane replay, one
// packet per call) the 33 KB of the call take about 10 ns at either rate:
// the time is the launch and the latency of one chain of loads, MMAs and
// one reduction, and the design keeps that chain short.
//
// Design.  Layer 1 of the fused kernel (binary_mma.cuh) over a tile of
// rows by four n8 tiles (32) of weight rows: grid ceil(B / rows) x
// ceil(H / 32), ragged B and H masked (rows past B and weight rows past H
// load as zero and are not stored).  The warps of a CTA split the 512-bit
// spans of d; their integer sums meet in shared memory once.  The wrapper
// picks the CTA's shape before launch from the number of row tiles
// (bnn_xnor.xnor_warps):
//   * 16 warps over 16 rows (one m16 tile) for up to 32 tiles of 32 x 32:
//     at B = 1 the grid is one CTA, and its 16 warps take one 512-bit span
//     each at W = 256, so no warp walks the spans in turn.  One m tile
//     keeps the 16 warps' sums within the 48 KB of static shared memory,
//     and one such CTA fits on an SM;
//   * 4 warps over 32 rows (two m16 tiles sharing the B fragments) past
//     that, as in the fused kernel: four CTAs share an SM, so B = 8192
//     (256 CTAs) runs in one wave.
// Loads are 16 bytes a thread where x and w are 16-byte aligned with row
// strides of a multiple of 4 words and W is a multiple of 4 (kVec), 4 bytes
// otherwise.  No row and no weight is staged in shared memory, so any W is
// taken.

#include "binary_mma.cuh"

namespace {

using bmma::kLanes;
using bmma::kMaxTiles;

template <int kWarps, int M, bool kVec>
__global__ void __launch_bounds__(kWarps * kLanes)
xnor_matmul_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
                   int32_t* __restrict__ out, int B, int H, int W,
                   long x_stride, long w_stride) {
  __shared__ int red[kWarps][bmma::kRed<M>][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int g = lane / 4, t = lane % 4;
  const int r_base = blockIdx.x * 16 * M;
  const int h0 = blockIdx.y * 8 * kMaxTiles;

  const uint32_t* rows[2 * M];
#pragma unroll
  for (int i = 0; i < 2 * M; ++i) {
    const int r = r_base + g + 8 * i;
    rows[i] = r < B ? x + (size_t)r * x_stride : nullptr;
  }
  const uint32_t* wrow[kMaxTiles];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    const int j = h0 + 8 * n + g;
    wrow[n] = j < H ? w + (size_t)j * w_stride : nullptr;
  }
  const int n_tiles = min(kMaxTiles, (H - h0 + 7) / 8);

  int mism[kMaxTiles][4];
  if (!bmma::layer1_mismatches<kWarps, M, kVec>(red, rows, wrow, n_tiles, W, mism)) return;
  const int m = threadIdx.x / kLanes;

  const int d_bits = W * 32;
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = h0 + 8 * n + 2 * t + e;
      if (j >= H) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + g + 8 * h + 16 * m;
        if (r < B) out[(size_t)r * H + j] = d_bits - 2 * mism[n][2 * h + e];
      }
    }
}

template <int kWarps, int M>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int x_stride,
           int w_stride, cudaStream_t stream) {
  auto kernel = bmma::vec_loads(W, x, x_stride, w, w_stride) ? xnor_matmul_kernel<kWarps, M, true>
                                                             : xnor_matmul_kernel<kWarps, M, false>;
  const dim3 grid((B + 16 * M - 1) / (16 * M), (H + 8 * kMaxTiles - 1) / (8 * kMaxTiles));
  kernel<<<grid, kWarps * kLanes, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<int32_t*>(out), B, H, W, x_stride, w_stride);
  return cudaGetLastError();
}

}  // namespace

// warps: 4 (32 rows per CTA) or 16 (16 rows per CTA), as xnor_warps picks.
extern "C" int xnor_matmul_launch(const void* x, const void* w, void* out,
                                  int B, int H, int W, int x_stride,
                                  int w_stride, int warps, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (warps == 4) return launch<4, 2>(x, w, out, B, H, W, x_stride, w_stride, st);
  if (warps == 16) return launch<16, 1>(x, w, out, B, H, W, x_stride, w_stride, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* xnor_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
