// Grouped slot-selected float matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/banked_matmul.py (_banked_kernel,
// reached through banked_matmul's pl.pallas_call): for every block of
// block_b rows that share one slot s = block_slots[block],
//   y[r][n] = sum_k x[r][k] * W[s][k][n] + b[s][n]
// accumulated in f32 and written in x's type (float or bf16, rounded to
// nearest even).
//
// Design.  A shared-memory tiled FMA matmul, simple and right first: the
// grid is (row tile, H tile); a row tile is kBM rows of one block, so each
// CTA reads one slot id from block_slots and only that slot's weights.
// Per step of kBK along D, the CTA stages a kBM x kBK tile of x (transposed)
// and a kBK x kBN tile of W[s] in shared memory as floats, and each of its
// 256 threads accumulates a 4 x 4 patch of outputs in registers with FMAs,
// in order of k.  Ragged D, H and blocks are masked.  No TF32 and no tensor
// cores: bf16 inputs are widened to f32 on staging.
//
// Bound.  2 B D H operations and (B D + D H per used slot + B H) elements
// moved: at the LM width (D = H = 960) the f32 case is bound by the 67
// TFLOP/s non-tensor f32 rate, the bf16 case by memory against the dense
// bf16 tensor rate.  This design runs on the f32 FMA pipes in both cases;
// a wgmma/TMA pipeline is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kT = 4;  // each thread owns a kT x kT patch
constexpr int kThreads = (kBM / kT) * (kBN / kT);
constexpr int kXPitch = kBM + 4;  // keeps float4 rows aligned, spreads banks

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b,
                     const int32_t* __restrict__ block_slots,
                     T* __restrict__ out, int block_b, int tiles_per_block,
                     int D, int H, int num_slots) {
  __shared__ __align__(16) float xs[kBK][kXPitch];
  __shared__ __align__(16) float ws[kBK][kBN];

  const int blk = blockIdx.x / tiles_per_block;
  const long r0 = (long)blk * block_b + (long)(blockIdx.x % tiles_per_block) * kBM;
  const long blk_end = (long)(blk + 1) * block_b;
  const long r_end = r0 + kBM < blk_end ? r0 + kBM : blk_end;
  const int n0 = blockIdx.y * kBN;
  const int s = min(max(block_slots[blk], 0), num_slots - 1);
  const T* __restrict__ wsl = w + (size_t)s * D * H;
  const int tx = threadIdx.x % (kBN / kT);
  const int ty = threadIdx.x / (kBN / kT);

  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      const long row = r0 + r;
      const int kk = k0 + k;
      xs[k][r] = (row < r_end && kk < D) ? to_float(x[row * D + kk]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;
      const int kk = k0 + k, col = n0 + n;
      ws[k][n] = (kk < D && col < H) ? to_float(wsl[(size_t)kk * H + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * kT]);
      const float4 c = *reinterpret_cast<const float4*>(&ws[k][tx * kT]);
      const float av[kT] = {a.x, a.y, a.z, a.w};
      const float cv[kT] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long row = r0 + ty * kT + i;
    if (row >= r_end) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int col = n0 + tx * kT + j;
      if (col < H)
        out[row * H + col] = from_float<T>(acc[i][j] + to_float(b[(size_t)s * H + col]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* block_slots,
           void* out, int n_blocks, int block_b, int D, int H, int num_slots,
           cudaStream_t stream) {
  const int tiles_per_block = (block_b + kBM - 1) / kBM;
  const dim3 grid(n_blocks * tiles_per_block, (H + kBN - 1) / kBN);
  banked_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const int32_t*>(block_slots),
      static_cast<T*>(out), block_b, tiles_per_block, D, H, num_slots);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float, 1 = bf16.
extern "C" int banked_matmul_launch(
    const void* x, const void* w, const void* b, const void* block_slots,
    void* out, int n_blocks, int block_b, int D, int H, int num_slots,
    int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, w, b, block_slots, out, n_blocks, block_b, D, H,
                         num_slots, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, block_slots, out, n_blocks, block_b,
                                 D, H, num_slots, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* banked_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
