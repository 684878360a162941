// Binary (XNOR-popcount) matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bnn_xnor.py (_xnor_kernel,
// reached through xnor_matmul's pl.pallas_call):
//   out[b][h] = d - 2 * sum_k popc(x[b][k] ^ w[h][k]),   d = 32 W.
//
// Design.  The same warp-per-row, lane-per-hidden-unit scheme as the fused
// kernel (xnor_common.cuh): a CTA of 8 warps covers a tile of 32 rows by 32
// hidden units, stages its 32 weight rows transposed in shared memory, and
// each warp computes one row at a time.  Ragged B and H are masked, so
// B = 1 (the single-packet Table V replay) works.
//
// Bound.  H * W XOR+POPC word operations per row; the POPC pipe (16 per
// clock per SM on compute capability 9.0) caps this design, as for the
// fused kernel, though neither kernel runs near that cap yet.

#include "xnor_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerCta = 32;

__global__ void __launch_bounds__(kWarps * kLanes)
xnor_matmul_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
                   int32_t* __restrict__ out, int B, int H, int W, int W4,
                   long x_stride, long w_stride) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  uint32_t* sw = smem;
  uint32_t* sx = smem + W4 * kPitch + warp * W4;

  const int h0 = blockIdx.y * kLanes;
  const int nh = min(kLanes, H - h0);
  stage_weights(sw, w + (size_t)h0 * w_stride, nh, W, W4, w_stride);
  __syncthreads();

  const int d_bits = W * 32;
  const int r_hi = min((int)(blockIdx.x + 1) * kRowsPerCta, B);
  for (int r = blockIdx.x * kRowsPerCta + warp; r < r_hi; r += kWarps) {
    stage_row(sx, x + (size_t)r * x_stride, W, W4, lane);
    const int mism = row_mismatches(sx, sw, W4, lane);
    __syncwarp();  // the next row overwrites sx
    if (lane < nh) out[(size_t)r * H + h0 + lane] = d_bits - 2 * mism;
  }
}

}  // namespace

extern "C" int xnor_matmul_launch(const void* x, const void* w, void* out,
                                  int B, int H, int W, int x_stride,
                                  int w_stride, void* stream) {
  const int W4 = (W + 3) / 4 * 4;
  const size_t smem = xnor_smem_bytes(W4, kWarps);
  const int err = reserve_smem(xnor_matmul_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRowsPerCta - 1) / kRowsPerCta, (H + kLanes - 1) / kLanes);
  xnor_matmul_kernel<<<grid, kWarps * kLanes, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<int32_t*>(out), B, H, W, W4, x_stride, w_stride);
  return cudaGetLastError();
}

extern "C" const char* xnor_matmul_error_string(int err) {
  return xnor_error_string(err);
}
