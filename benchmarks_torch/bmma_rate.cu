// Throughput of the binary and int8 tensor-core MMAs and of the POPC pipe
// on one GPU (sm_90a).  chip_smoke.py builds this file with nvcc and runs
// it before its kernel checks: the b1.and.popc rate is the binary peak its
// bounds price a binary dot product at, and the others record why the fused
// kernel's layer 1 runs on b1 MMA.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -o bmma_rate bmma_rate.cu
//   ./bmma_rate
//
// Prints one JSON line per family: bit-MACs per second and per clock per
// SM at the card's maximum clock.  A binary dot product of d bits counts d
// bit-MACs; the s8 MMA counts one MAC per bit (one byte per +-1 value).
// Each warp runs CH independent chains of one instruction, on every SM.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int CH = 8;
enum Family { XOR_B1 = 0, AND_B1 = 1, S8 = 2, POPC = 3 };

template <int F>
__global__ void bench(int* out, int iters, uint32_t seed) {
  uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
  uint32_t b0 = a0 * 11u, b1 = a0 * 13u;
  int acc[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = c;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if constexpr (F == XOR_B1) {
        asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]), "+r"(acc[c][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else if constexpr (F == AND_B1) {
        asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]), "+r"(acc[c][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else if constexpr (F == S8) {
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]), "+r"(acc[c][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        uint32_t t0, t1, t2, t3;
        asm volatile("popc.b32 %0, %1;" : "=r"(t0) : "r"(a0 ^ b0 ^ (uint32_t)acc[c][0]));
        asm volatile("popc.b32 %0, %1;" : "=r"(t1) : "r"(a1 ^ b0 ^ (uint32_t)acc[c][1]));
        asm volatile("popc.b32 %0, %1;" : "=r"(t2) : "r"(a2 ^ b1 ^ (uint32_t)acc[c][2]));
        asm volatile("popc.b32 %0, %1;" : "=r"(t3) : "r"(a3 ^ b1 ^ (uint32_t)acc[c][3]));
        acc[c][0] += t0; acc[c][1] += t1; acc[c][2] += t2; acc[c][3] += t3;
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int F>
static bool run(const char* name, double bit_macs_per_warp_inst, int insts_per_chain,
                int iters, int* out, int nsm, int clk_khz) {
  const int threads = 256, blocks = nsm * 4;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e30f;
  for (int rep = 0; rep < 5; ++rep) {  // the first call warms up and is not kept
    cudaEventRecord(e0);
    bench<F><<<blocks, threads>>>(out, iters, rep);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (rep && ms < best) best = ms;
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  const cudaError_t err = cudaGetLastError();
  const double insts = (double)blocks * threads / 32 * iters * CH * insts_per_chain;
  const double per_s = insts * bit_macs_per_warp_inst / (best * 1e-3);
  printf("{\"family\": \"%s\", \"err\": \"%s\", \"ms\": %.4f, \"bit_macs_per_s\": %.4e, "
         "\"bit_macs_per_clock_per_sm_at_max_clock\": %.1f, \"sms\": %d, "
         "\"max_clock_mhz\": %.0f}\n",
         name, cudaGetErrorString(err), best, per_s, per_s / nsm / (clk_khz * 1e3), nsm,
         clk_khz / 1e3);
  return err == cudaSuccess;
}

int main() {
  int nsm = 0, clk_khz = 0;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clk_khz, cudaDevAttrClockRate, 0);
  int* out;
  if (cudaMalloc(&out, sizeof(int) * 256 * nsm * 4) != cudaSuccess) return 1;
  bool ok = run<XOR_B1>("b1.xor.popc m16n8k256", 16.0 * 8 * 256, 1, 1024, out, nsm, clk_khz);
  ok &= run<AND_B1>("b1.and.popc m16n8k256", 16.0 * 8 * 256, 1, 1024, out, nsm, clk_khz);
  ok &= run<S8>("s8 m16n8k32", 16.0 * 8 * 32, 1, 1024, out, nsm, clk_khz);
  ok &= run<POPC>("xor+popc.b32", 32.0 * 32, 4, 2048, out, nsm, clk_khz);
  cudaFree(out);
  return ok ? 0 : 1;
}
