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
// Design.  The layer-1 half of fused_forward.cu, with the same split: the
// TPU ran one grid step per block of block_b rows in sequence; here each
// block is spread over ceil(block_b / 32) CTAs of 8 warps.  Each CTA reads
// its slot id, stages that slot's w1 (H x W words, H <= 32) transposed in
// shared memory (xnor_common.cuh), and each warp takes one row at a time,
// lane j counting hidden unit j.  The reference's word-axis tiling (chunk)
// is a TPU tiling knob and plays no part here.
//
// Bound.  Per row it reads W words and writes H floats, and does H * W
// XOR+POPC word operations.  As for the fused kernel, the POPC pipe (16 per
// clock per SM on compute capability 9.0) caps this design well above the
// card's own bound; the kernel is simple and right first.

#include "xnor_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerCta = 32;

__global__ void __launch_bounds__(kWarps * kLanes)
banked_xnor_layer1_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w1,
                          const float* __restrict__ b1,
                          const int32_t* __restrict__ block_slots,
                          float* __restrict__ out,
                          int block_b, long x_stride, int W, int W4, int H,
                          int num_slots) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  uint32_t* sw = smem;
  uint32_t* sx = smem + W4 * kPitch + warp * W4;

  const int blk = blockIdx.x;
  const int s = min(max(block_slots[blk], 0), num_slots - 1);
  stage_weights(sw, w1 + (size_t)s * H * W, H, W, W4, W);
  __syncthreads();

  const int d_bits = W * 32;
  const float b1j = lane < H ? b1[s * H + lane] : 0.f;
  const int r_hi = min((int)(blockIdx.y + 1) * kRowsPerCta, block_b);
  for (int r = blockIdx.y * kRowsPerCta + warp; r < r_hi; r += kWarps) {
    const long row = (long)blk * block_b + r;
    stage_row(sx, x + row * x_stride, W, W4, lane);
    const int mism = row_mismatches(sx, sw, W4, lane);
    __syncwarp();  // the next row overwrites sx
    if (lane < H) out[row * H + lane] = (float)(d_bits - 2 * mism) + b1j;
  }
}

}  // namespace

extern "C" int banked_xnor_layer1_launch(
    const void* x, const void* w1, const void* b1, const void* block_slots,
    void* out, int n_blocks, int block_b, int x_stride, int W, int H,
    int num_slots, void* stream) {
  const int W4 = (W + 3) / 4 * 4;
  const size_t smem = xnor_smem_bytes(W4, kWarps);
  const int err = reserve_smem(banked_xnor_layer1_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (block_b + kRowsPerCta - 1) / kRowsPerCta);
  banked_xnor_layer1_kernel<<<grid, kWarps * kLanes, smem,
                              (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w1),
      static_cast<const float*>(b1), static_cast<const int32_t*>(block_slots),
      static_cast<float*>(out), block_b, x_stride, W, W4, H, num_slots);
  return cudaGetLastError();
}

extern "C" const char* banked_xnor_layer1_error_string(int err) {
  return xnor_error_string(err);
}
