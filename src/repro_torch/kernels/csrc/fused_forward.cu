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
// Design.  The TPU grid ran block_b = 256 rows per grid step in sequence;
// at B = 8192 and K = 2 that is 34 blocks, too few for 132 SMs, so each
// block is split over ceil(block_b / 32) CTAs of 8 warps.  Each CTA reads
// its slot id, stages that slot's w1 (32 x 256 words = 32 KB at H32) into
// shared memory transposed (see xnor_common.cuh), and each warp takes one
// gathered row at a time, lane j accumulating hidden unit j.  Layer 2 is a
// warp shuffle reduction.  The float expression of the sign input is the
// reference's, so h is bit-exact; only layer 2's summation order differs.
//
// Bound.  Per packet the kernel does H * W = 8192 XOR+POPC word operations
// and reads ~1088 B.  POPC issues at 16 per clock per SM on compute
// capability 9.0, so at 132 SMs and a ~1.98 GHz clock this design tops out
// near 0.5 Gpps, against ~3 Gpps for the 3.35 TB/s memory: that is the
// design's ceiling.  The kernel runs well below it, bound by latency (per-CTA
// weight staging, rows walked one after another per warp).  The card's own
// least time for the same work is lower still (int8 tensor cores on unpacked
// bits); both are later work.

#include "xnor_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerCta = 32;
constexpr int kCtrlWord = 2;
constexpr int kActionForward = 0;
constexpr int kActionDrop = 1;
constexpr int kActionFlag = 2;

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
                     int W, int W4, int H, int C, int num_slots) {
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
    const long out_row = (long)blk * block_b + r;
    long src = row_ids ? row_ids[out_row] : out_row;
    src = src < 0 ? 0 : (src >= n_x_rows ? n_x_rows - 1 : src);
    const uint32_t* row = x + src * row_stride;
    stage_row(sx, row + meta_words, W, W4, lane);
    const int mism = row_mismatches(sx, sw, W4, lane);
    __syncwarp();  // the next row overwrites sx

    const float pre = (float)(d_bits - 2 * mism) + b1j;
    const float h = pre >= 0.f ? 1.f : -1.f;
    float y0 = 0.f;
    for (int c = 0; c < C; ++c) {
      float v = lane < H ? h * w2[((size_t)s * C + c) * H + lane] : 0.f;
      for (int off = kLanes / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      v += b2[s * C + c];
      if (c == 0) y0 = v;
      if (lane == 0) scores[out_row * C + c] = v;
    }
    if (actions != nullptr && lane == 0) {
      const uint32_t ctrl = row[kCtrlWord];
      actions[out_row] = y0 > 0.f ? ((ctrl & 1u) ? kActionFlag : kActionDrop)
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
  const int W4 = (W + 3) / 4 * 4;
  const size_t smem = xnor_smem_bytes(W4, kWarps);
  const int err = reserve_smem(fused_forward_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (block_b + kRowsPerCta - 1) / kRowsPerCta);
  fused_forward_kernel<<<grid, kWarps * kLanes, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(row_ids),
      static_cast<const int32_t*>(block_slots),
      static_cast<const uint32_t*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(scores), static_cast<int32_t*>(actions),
      block_b, n_x_rows, row_stride, meta_words, W, W4, H, C, num_slots);
  return cudaGetLastError();
}

extern "C" const char* fused_forward_error_string(int err) {
  return xnor_error_string(err);
}
