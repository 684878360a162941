// Device helpers shared by the XNOR-popcount kernels (fused_forward.cu,
// xnor_matmul.cu): one warp computes one input row against up to 32
// hidden units, lane j taking hidden unit j.
//
// Shared-memory layout of the weights: the (nh, W) rows are stored
// transposed as (W4, 32) with a pitch of 33 words.  Lane j reading word k of
// hidden unit j hits bank (33k + j) % 32 = (k + j) % 32, distinct across the
// warp; the staging writes (consecutive k, one j per warp) are conflict-free
// for the same reason.  Read in the natural (H, W) order, a warp would hit
// one bank 32 ways.
//
// W4 is W rounded up to a multiple of 4; the tail words of both the weights
// and the staged row are zero, so they add popc(0 ^ 0) = 0.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kLanes = 32;
constexpr int kPitch = kLanes + 1;

// Transposed copy of the nh <= 32 weight rows at w (row stride w_stride
// words) into sw; columns j >= nh are zero.  Called by the whole block.
__device__ inline void stage_weights(uint32_t* sw, const uint32_t* __restrict__ w,
                                     int nh, int W, int W4, long w_stride) {
  for (int idx = threadIdx.x; idx < kLanes * W4; idx += blockDim.x) {
    const int j = idx / W4, k = idx % W4;
    sw[k * kPitch + j] = (j < nh && k < W) ? w[j * w_stride + k] : 0u;
  }
}

// Coalesced copy of one row's W words into the warp's buffer sx.
__device__ inline void stage_row(uint32_t* sx, const uint32_t* __restrict__ row,
                                 int W, int W4, int lane) {
  for (int k = lane; k < W4; k += kLanes) sx[k] = k < W ? row[k] : 0u;
  __syncwarp();
}

// sum_k popc(x[k] ^ w[lane][k]) for the staged row.  The row is read as
// 16-byte broadcasts (every lane reads the same address); each lane reads
// its own weight column.
__device__ inline int row_mismatches(const uint32_t* sx, const uint32_t* sw,
                                     int W4, int lane) {
  const uint4* sx4 = reinterpret_cast<const uint4*>(sx);
  int acc = 0;
#pragma unroll 4
  for (int q = 0; q < W4 / 4; ++q) {
    const uint4 xv = sx4[q];
    const uint32_t* wk = sw + 4 * q * kPitch + lane;
    acc += __popc(xv.x ^ wk[0]) + __popc(xv.y ^ wk[kPitch]) +
           __popc(xv.z ^ wk[2 * kPitch]) + __popc(xv.w ^ wk[3 * kPitch]);
  }
  return acc;
}

// Dynamic shared memory the kernels need: the weights plus one row buffer
// per warp.
inline size_t xnor_smem_bytes(int W4, int warps) {
  return (size_t)(W4 * kPitch + warps * W4) * sizeof(uint32_t);
}

// Returned by a launcher, in place of a cudaError_t, when a row of W words
// needs more shared memory than a block of the current device may have.
constexpr int kErrSmemTooLarge = -1;

// Allow more than the default 48 KB of dynamic shared memory where needed;
// kErrSmemTooLarge where the device's opt-in limit is below bytes.
template <typename Kernel>
inline int reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return kErrSmemTooLarge;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Text of a launcher's return code.
inline const char* xnor_error_string(int err) {
  if (err == kErrSmemTooLarge)
    return "a row of W words exceeds the kernel's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
