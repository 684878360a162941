// Grouped slot-selected float matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/banked_matmul.py (_banked_kernel,
// reached through banked_matmul's pl.pallas_call): for every block of
// block_b rows that share one slot s = block_slots[block],
//   y[r][n] = sum_k x[r][k] * W[s][k][n] + b[s][n]
// accumulated in f32 and written in x's type (float or bf16, rounded to
// nearest even).  Every CTA's row tile lies inside one block, so a CTA reads
// one slot id and only that slot's weights.
//
// Bound.  2 B D H operations and (B D + D H per used slot + B H) elements
// moved.  At the LM width (B = 8192, D = H = 960) bf16 is bound by the dense
// bf16 tensor rate (0.0153 ms at 989 TFLOP/s) and f32 by the non-tensor f32
// rate (0.225 ms at 67 TFLOP/s).
//
// Three kernels, picked per call by a shape rule before launch
// (repro_torch.kernels.banked_matmul.matmul_variant):
//
// * bf16/wgmma (bf16, D and H multiples of 8, 16-byte aligned bases): a
//   warp-specialised CTA of 128 x 192 outputs.  One producer warp keeps TMA
//   loads of x (128 x 64) and W[s] (64 x BN) tiles in flight through a ring
//   of kStages shared-memory stages guarded by mbarriers; two consumer
//   warpgroups each run wgmma m64n192k16 (bf16 in, f32 accumulate) on 64
//   of the rows.  W is (K, D, H): one 3-D tensor map covers the whole bank and
//   the slot is the TMA coordinate, so no weight is gathered or copied.
//   x is K-major, W[s] N-major (wgmma's transpose flag for B); both use the
//   128-byte swizzle.  The epilogue adds b[s] in f32, rounds once to bf16,
//   and masks rows past the block and columns past H.  At the LM width five
//   192-column tiles cover H = 960 exactly (320 CTAs, one per SM, 2.4
//   waves); 192 columns measured faster there than 128, and 4 stages
//   faster than 3 or 5.  It replaces a 64 x 64 FMA tile that widened bf16
//   to f32 and never touched a tensor core.
// * f32/fma: exact f32, one FMA per product in order of k (TF32 tensor
//   cores would break the f32 limit chip_smoke.py holds it to).  128 x 128
//   CTA tiles, 8 x 8 outputs per thread read as float4 from shared memory
//   (one 16-byte load per 16 FMAs), x and W staged with cp.async, double
//   buffered, so the next k-step's loads overlap this one's FMAs.  16-byte
//   copies where D and H are multiples of 4, else 4-byte copies.
// * bf16/fma: the ragged bf16 shapes TMA cannot take (a row stride that is
//   not a multiple of 16 bytes): a 64 x 64 FMA tile that widens bf16 to f32
//   on staging.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// bf16/fma: 64 x 64 tile, bf16 widened to f32 on staging
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kT = 4;  // each thread owns a kT x kT patch
constexpr int kThreads = (kBM / kT) * (kBN / kT);
constexpr int kXPitch = kBM + 4;  // keeps float4 rows aligned, spreads banks

__global__ void __launch_bounds__(kThreads)
fma_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ b,
                const int32_t* __restrict__ block_slots,
                __nv_bfloat16* __restrict__ out, int block_b, int tiles_per_block,
                int D, int H, int num_slots) {
  __shared__ __align__(16) float xs[kBK][kXPitch];
  __shared__ __align__(16) float ws[kBK][kBN];

  const int blk = blockIdx.x / tiles_per_block;
  const long r0 = (long)blk * block_b + (long)(blockIdx.x % tiles_per_block) * kBM;
  const long blk_end = (long)(blk + 1) * block_b;
  const long r_end = r0 + kBM < blk_end ? r0 + kBM : blk_end;
  const int n0 = blockIdx.y * kBN;
  const int s = min(max(block_slots[blk], 0), num_slots - 1);
  const __nv_bfloat16* __restrict__ wsl = w + (size_t)s * D * H;
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
      xs[k][r] = (row < r_end && kk < D) ? __bfloat162float(x[row * D + kk]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;
      const int kk = k0 + k, col = n0 + n;
      ws[k][n] = (kk < D && col < H) ? __bfloat162float(wsl[(size_t)kk * H + col]) : 0.f;
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
        out[row * H + col] = __float2bfloat16_rn(
            acc[i][j] + __bfloat162float(b[(size_t)s * H + col]));
    }
  }
}

// ---------------------------------------------------------------------------
// f32/fma: 128 x 128 tile, 8 x 8 per thread, cp.async double buffer
// ---------------------------------------------------------------------------

constexpr int kFM = 128;           // rows per CTA
constexpr int kFN = 128;           // columns per CTA
constexpr int kFK = 16;            // k per stage
constexpr int kFThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (4 or 16) from src to shared dst, or zeros where !valid.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kN) : "memory");
}

// Stage k-step k0 of x (rows [r0, r_end)) and W[s] (columns [n0, H)).
// x goes to xs[row][k], W to ws[k][col]; what lies outside is zero.
template <bool kVec>
__device__ __forceinline__ void f32_stage(float (*xs)[kFK], float (*ws)[kFN],
                                          const float* __restrict__ x,
                                          const float* __restrict__ wsl,
                                          long r0, long r_end, int n0, int k0,
                                          int D, int H) {
  const int t = threadIdx.x;
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 128 rows x 4 chunks of 4 floats
      const int r = t / 4 + 64 * i, c = (t % 4) * 4;
      const long row = r0 + r;
      const bool ok = row < r_end && k0 + c < D;
      cp_async<16>(&xs[r][c], ok ? x + row * D + k0 + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // W: 16 rows x 32 chunks of 4 floats
      const int k = t / 32 + 8 * i, c = (t % 32) * 4;
      const bool ok = k0 + k < D && n0 + c < H;
      cp_async<16>(&ws[k][c], ok ? wsl + (size_t)(k0 + k) * H + n0 + c : wsl, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kFM * kFK / kFThreads; ++i) {
      const int e = t + kFThreads * i, r = e / kFK, c = e % kFK;
      const long row = r0 + r;
      const bool ok = row < r_end && k0 + c < D;
      cp_async<4>(&xs[r][c], ok ? x + row * D + k0 + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kFK * kFN / kFThreads; ++i) {
      const int e = t + kFThreads * i, k = e / kFN, c = e % kFN;
      const bool ok = k0 + k < D && n0 + c < H;
      cp_async<4>(&ws[k][c], ok ? wsl + (size_t)(k0 + k) * H + n0 + c : wsl, ok);
    }
  }
  cp_async_commit();
}

// Thread (tx, ty) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// tx*4 + {0..3} and 64 + tx*4 + {0..3}: a quarter-warp's 16-byte reads of
// a W row are contiguous, so they do not conflict.
template <bool kVec>
__global__ void __launch_bounds__(kFThreads)
fma_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, const int32_t* __restrict__ block_slots,
               float* __restrict__ out, int block_b, int tiles_per_block,
               int D, int H, int num_slots) {
  __shared__ __align__(16) float xs[2][kFM][kFK];
  __shared__ __align__(16) float ws[2][kFK][kFN];

  const int blk = blockIdx.x / tiles_per_block;
  const long r0 = (long)blk * block_b + (long)(blockIdx.x % tiles_per_block) * kFM;
  const long blk_end = (long)(blk + 1) * block_b;
  const long r_end = r0 + kFM < blk_end ? r0 + kFM : blk_end;
  const int n0 = blockIdx.y * kFN;
  const int s = min(max(block_slots[blk], 0), num_slots - 1);
  const float* __restrict__ wsl = w + (size_t)s * D * H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = (D + kFK - 1) / kFK;
  f32_stage<kVec>(xs[0], ws[0], x, wsl, r0, r_end, n0, 0, D, H);
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < steps) {
      f32_stage<kVec>(xs[buf ^ 1], ws[buf ^ 1], x, wsl, r0, r_end, n0,
                      (st + 1) * kFK, D, H);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < kFK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &xs[buf][(i < 4 ? 0 : 64) + ty * 4 + (i & 3)][k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 c0 = *reinterpret_cast<const float4*>(&ws[buf][k4 + kk][tx * 4]);
        const float4 c1 = *reinterpret_cast<const float4*>(&ws[buf][k4 + kk][64 + tx * 4]);
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, cv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

  const float* __restrict__ bs = b + (size_t)s * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = r0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (row >= r_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (kVec && col + 3 < H) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + col);
        *reinterpret_cast<float4*>(out + row * H + col) = make_float4(
            acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y,
            acc[i][4 * h + 2] + bv.z, acc[i][4 * h + 3] + bv.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < H) out[row * H + col + j] = acc[i][4 * h + j] + bs[col + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16/wgmma: TMA ring + two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWM = 128;             // rows per CTA: two warpgroups of 64
constexpr int kWK = 64;              // k per stage: one 128-byte swizzle row
constexpr int kWN = 192;             // columns per CTA: three 64-column boxes
constexpr int kStages = 4;
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kWThreads = kConsumers + 32;  // + one producer warp
constexpr int kABytes = kWM * kWK * 2;      // 16 KB per stage
constexpr int kAtomBytes = kWK * 64 * 2;    // one 64-column box of W: 8 KB
constexpr int kBBytes = kWN / 64 * kAtomBytes;
constexpr int kWSmem = kStages * (kABytes + kBBytes) + 2 * kStages * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Wait until the barrier's phase with parity `parity` has completed.  A
// wait of more than about 10 s of clocks means a copy never arrived: trap,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
                  "r"(c2)
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  Offsets in bytes:
// lbo is the stride between 64-element column atoms (N-major B; unused for
// K-major A), sbo the stride between groups of 8 rows.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 192, f32) += A (64 x 16, K-major) * B (16 x 192, N-major), bf16 in.
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "n"(1));
}

// One CTA: rows [r0, min(r0 + 128, block end)) of one block, columns
// [n0, n0 + 192).  Stage st holds x rows r0.. (128 x 64, K-major) and W[s]
// rows k0.. as three boxes of 64 x 64 (N-major), all 128-byte swizzled.
__global__ void __launch_bounds__(kWThreads)
wgmma_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __nv_bfloat16* __restrict__ b,
                  const int32_t* __restrict__ block_slots,
                  __nv_bfloat16* __restrict__ out, int block_b, int tiles_per_block,
                  int D, int H, int num_slots) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_smem = base;                           // kStages x kABytes
  const uint32_t b_smem = base + kStages * kABytes;       // kStages x kBBytes
  const uint32_t full_bar = b_smem + kStages * kBBytes;   // kStages x 8 B
  const uint32_t empty_bar = full_bar + kStages * 8;

  const int blk = blockIdx.x / tiles_per_block;
  const int r0 = blk * block_b + (blockIdx.x % tiles_per_block) * kWM;
  const int r_end = min(r0 + kWM, (blk + 1) * block_b);
  const int n0 = blockIdx.y * kWN;
  const int s = min(max(block_slots[blk], 0), num_slots - 1);
  const int k_tiles = (D + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full_bar + 8 * i, 1);
      mbar_init(empty_bar + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warp: one lane keeps the ring full.
    if (threadIdx.x == kConsumers) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % kStages;
        mbar_wait(empty_bar + 8 * st, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * st, kABytes + kBBytes);
        tma_load_2d(a_smem + st * kABytes, &x_map, full_bar + 8 * st, kt * kWK, r0);
#pragma unroll
        for (int j = 0; j < kWN / 64; ++j)
          tma_load_3d(b_smem + st * kBBytes + j * kAtomBytes, &w_map, full_bar + 8 * st,
                      n0 + 64 * j, kt * kWK, s);
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = threadIdx.x / 128;
  float acc[kWN / 2];
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % kStages;
    mbar_wait(full_bar + 8 * st, (kt / kStages) & 1);
    const uint32_t a_st = a_smem + st * kABytes + wg * 64 * 128;
    const uint32_t b_st = b_smem + st * kBBytes;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk)  // A: 32 bytes along the row; B: 16 rows
      wgmma_n192(acc, wgmma_desc(a_st + 32 * kk, 16, 1024),
                 wgmma_desc(b_st + 2048 * kk, kAtomBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    mbar_arrive(empty_bar + 8 * st);
  }

  // Epilogue: register i holds row 16 w + lane/4 + 8 ((i/2) % 2), column
  // 8 (i/4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 x 192 tile.
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* __restrict__ bs = b + (size_t)s * H;
#pragma unroll
  for (int i = 0; i < kWN / 2; i += 2) {
    const int row = r0 + wg * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
    if (row < r_end && col < H) {  // H is even, so col + 1 < H too
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bs + col);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * H + col) = __floats2bfloat162_rn(
          acc[i] + __bfloat162float(bv.x), acc[i + 1] + __bfloat162float(bv.y));
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle; dims and box innermost first.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides_bytes, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
             strides_bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Returned in place of a cudaError_t when the driver cannot encode a map.
constexpr int kErrTensorMap = -2;

int launch_wgmma(const void* x, const void* w, const void* b, const void* block_slots,
                 void* out, int n_blocks, int block_b, int D, int H, int num_slots,
                 cudaStream_t stream) {
  const int n_rows = n_blocks * block_b;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)D, (cuuint64_t)n_rows};
  const cuuint64_t x_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t x_box[2] = {kWK, kWM};
  const cuuint64_t w_dims[3] = {(cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)num_slots};
  const cuuint64_t w_strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)D * H * 2};
  const cuuint32_t w_box[3] = {64, kWK, 1};
  if (!make_map(&x_map, x, 2, x_dims, x_strides, x_box) ||
      !make_map(&w_map, w, 3, w_dims, w_strides, w_box))
    return kErrTensorMap;
  cudaError_t err = cudaFuncSetAttribute(wgmma_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return err;
  const int tiles_per_block = (block_b + kWM - 1) / kWM;
  const dim3 grid(n_blocks * tiles_per_block, (H + kWN - 1) / kWN);
  wgmma_bf16_kernel<<<grid, kWThreads, kWSmem, stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(b),
      static_cast<const int32_t*>(block_slots), static_cast<__nv_bfloat16*>(out), block_b,
      tiles_per_block, D, H, num_slots);
  return cudaGetLastError();
}

int launch_fma_f32(const void* x, const void* w, const void* b, const void* block_slots,
                   void* out, int n_blocks, int block_b, int D, int H, int num_slots,
                   bool vec, cudaStream_t stream) {
  const int tiles_per_block = (block_b + kFM - 1) / kFM;
  const dim3 grid(n_blocks * tiles_per_block, (H + kFN - 1) / kFN);
  auto kernel = vec ? fma_f32_kernel<true> : fma_f32_kernel<false>;
  kernel<<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const int32_t*>(block_slots),
      static_cast<float*>(out), block_b, tiles_per_block, D, H, num_slots);
  return cudaGetLastError();
}

int launch_fma_bf16(const void* x, const void* w, const void* b, const void* block_slots,
                    void* out, int n_blocks, int block_b, int D, int H, int num_slots,
                    cudaStream_t stream) {
  const int tiles_per_block = (block_b + kBM - 1) / kBM;
  const dim3 grid(n_blocks * tiles_per_block, (H + kBN - 1) / kBN);
  fma_bf16_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<const int32_t*>(block_slots),
      static_cast<__nv_bfloat16*>(out), block_b, tiles_per_block, D, H, num_slots);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// variant: 0 = f32/fma, 1 = bf16/fma, 2 = bf16/wgmma (the wrapper's
// matmul_variant picks it).
extern "C" int banked_matmul_launch(
    const void* x, const void* w, const void* b, const void* block_slots,
    void* out, int n_blocks, int block_b, int D, int H, int num_slots,
    int variant, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    const bool vec = D % 4 == 0 && H % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(b);
    return launch_fma_f32(x, w, b, block_slots, out, n_blocks, block_b, D, H, num_slots,
                          vec, st);
  }
  if (variant == 1)
    return launch_fma_bf16(x, w, b, block_slots, out, n_blocks, block_b, D, H, num_slots, st);
  if (variant == 2 && D % 8 == 0 && H % 8 == 0 && aligned16(x) && aligned16(w))
    return launch_wgmma(x, w, b, block_slots, out, n_blocks, block_b, D, H, num_slots, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* banked_matmul_error_string(int err) {
  if (err == kErrTensorMap) return "the driver could not encode a TMA tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
