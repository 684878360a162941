// Decode attention over a static KV cache for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's decode attention
// (src/repro/nn/modules.py, attention_apply with a kv_cache) is plain jnp,
// which XLA fuses on the TPU.  Eagerly the port ran it as separate PyTorch
// operations: every call upcast the whole (B, G, L, D) K and V caches to f32
// copies, scored and softmaxed all L positions and masked the invalid ones.
// This kernel computes the same function for one new query token a row:
//   n_b   = min(cache_len[b] + 1, L)               (causal and ring caches)
//   s_j   = scale * sum_d f32(q[b,g,m,d]) * f32(k[b,g,j,d])        j < n_b
//   p_j   = round_kv(exp(s_j - max_j s) / sum_j exp(s_j - max_j s))
//   out   = round_out(sum_j p_j * f32(v[b,g,j,d]))
// where round_kv rounds to the cache's type (bf16, or nothing for f32), as
// the plain version casts the probabilities to the values' type, and the
// sums are f32.  Only the order of summation differs from the plain version.
//
// Bound.  The valid K and V rows once (2 n_b D bytes each in bf16), q and
// the output: at zamba2-7b-instruct.chat64-sat's shape (64 rows, 32 heads,
// D 224, L 1536, ~13 % of the positions valid) ~361 MB a call, 108 us at
// 3.35 TB/s.  One query a head is ~1 FLOP a byte, far below the ~295 FLOP a
// byte at which the tensor cores would matter, so the kernel stays on CUDA
// cores and its aim is to keep 16-byte loads of valid rows in flight.
//
// Design.  Flash-decoding's split over positions, in three launches on the
// stream, with f32 scratch the wrapper allocates:
//   1. scores: one CTA a (chunk of kChunk positions, group g, row b); a CTA
//      whose chunk starts at or past n_b returns at once.  The gq query
//      heads of a group (M = gq x tokens) sit in shared memory as f32 and
//      share one read of each K row.  A team of `team` lanes (the least
//      power of two >= D / 8 bf16 or D / 4 f32 values, at most 32) reads one
//      row in 16-byte loads, kUnroll rows in flight; each query's dot
//      product is summed across the team by shuffles.  Scores go to scratch
//      (B, G, M, L).
//   2. values: the same grid.  Each CTA takes the row's exact max and sum
//      over all n_b scores (a few KB from L2), forms its chunk's
//      probabilities rounded to the cache's type, and sums p x V over its
//      positions: each lane its 16 bytes of dims for MQ queries at a time,
//      teams summed by shuffles, warps in shared memory in a fixed order,
//      into scratch (B, G, M, n_chunks, D).
//   3. combine: one CTA a (row, group) sums its row's chunks in order and
//      rounds once to the output type.
// No position at or past n_b is read (the loads are guarded by it, and the
// scratch past it is neither written nor read), and no f32 copy of the
// cache is written.  Sums are in a fixed order: the result repeats bit for
// bit from run to run.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;   // positions a CTA takes (the wrapper's CHUNK)
constexpr int kUnroll = 4;    // K or V rows a team has in flight
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Kv;
template <> struct Kv<__nv_bfloat16> {
  static constexpr int kVec = 8;  // values in 16 bytes
  static __device__ __forceinline__ void widen(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float to_kv(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};
template <> struct Kv<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ float to_kv(float x) { return x; }
};

// 16-byte vectors a lane holds of one row: D <= kMaxD over a team of <= 32
template <typename T> constexpr int kPerLane = kMaxD / (Kv<T>::kVec * 32);

__device__ __forceinline__ int valid_len(const int64_t* cache_len, int b, int L) {
  const int64_t n = cache_len[b] + 1;
  return n < L ? (int)n : L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const void* __restrict__ q, int q_bf16, const T* __restrict__ k,
              const int64_t* __restrict__ cache_len, float* __restrict__ scores,
              int G, int M, int L, int D, long long sb, long long sg, long long sl,
              float scale, int team) {
  constexpr int V = Kv<T>::kVec, NV = kPerLane<T>;
  extern __shared__ float qs[];  // [M][D]
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int start = c * kChunk;
  const int n = valid_len(cache_len, b, L);
  if (start >= n) return;
  const int len = min(kChunk, n - start);
  const long long bg = (long long)b * G + g;
  for (int i = threadIdx.x; i < M * D; i += kThreads)
    qs[i] = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[bg * M * D + i])
                   : static_cast<const float*>(q)[bg * M * D + i];
  __syncthreads();

  const int nvec = D / V, lane = threadIdx.x % 32, t = lane % team;
  const int my_team = threadIdx.x / team, n_teams = kThreads / team;
  const int warp_first = (threadIdx.x / 32) * (32 / team);  // the warp's first team
  const T* kr = k + b * sb + g * sg + (long long)start * sl;
  float* out = scores + bg * M * L + start;
  // a bound uniform over the warp, so every lane reaches every shuffle
  for (int base = 0; base + warp_first < len; base += n_teams * kUnroll) {
    uint4 raw[kUnroll][NV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * n_teams + my_team;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = t + j * team;
        raw[u][j] = p < len && vi < nvec
            ? __ldg(reinterpret_cast<const uint4*>(kr + p * sl + vi * V))
            : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * n_teams + my_team;
      float kf[NV][V];
#pragma unroll
      for (int j = 0; j < NV; ++j) Kv<T>::widen(raw[u][j], kf[j]);
      for (int m = 0; m < M; ++m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int vi = t + j * team;
          if (vi < nvec) {
            const float* qv = qs + m * D + vi * V;
#pragma unroll
            for (int e = 0; e < V; ++e) s = fmaf(qv[e], kf[j][e], s);
          }
        }
        for (int o = team / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (t == 0 && p < len) out[(long long)m * L + p] = s * scale;
      }
    }
  }
}

template <typename T, int MQ>
__global__ void __launch_bounds__(kThreads)
values_kernel(const T* __restrict__ v, const int64_t* __restrict__ cache_len,
              const float* __restrict__ scores, float* __restrict__ partial,
              int G, int M, int L, int D, long long sb, long long sg, long long sl,
              int team, int n_chunks) {
  constexpr int V = Kv<T>::kVec, NV = kPerLane<T>;
  extern __shared__ float smem[];
  float* pr = smem;                    // [MQ][kChunk] probabilities, rounded
  float* red = smem + MQ * kChunk;     // [kWarps][MQ][D] the warps' sums
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int start = c * kChunk;
  const int n = valid_len(cache_len, b, L);
  if (start >= n) return;
  const int len = min(kChunk, n - start);
  const long long bg = (long long)b * G + g;

  const int nvec = D / V, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = lane % team, my_team = threadIdx.x / team, n_teams = kThreads / team;
  const int warp_first = warp * (32 / team);
  const T* vr = v + b * sb + g * sg + (long long)start * sl;

  for (int m0 = 0; m0 < M; m0 += MQ) {
    // the row's exact softmax statistics over its n scores, a warp a query
    if (warp < MQ && m0 + warp < M) {
      const float* s = scores + (bg * M + m0 + warp) * L;
      float mx = __uint_as_float(0xff800000u);  // -inf
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s[j]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      float l = 0.f;
      for (int j = lane; j < n; j += 32) l += expf(s[j] - mx);
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
      for (int p = lane; p < len; p += 32)
        pr[warp * kChunk + p] = Kv<T>::to_kv(expf(s[start + p] - mx) / l);
    }
    __syncthreads();

    float acc[MQ][NV][V];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][j][e] = 0.f;
    for (int base = 0; base + warp_first < len; base += n_teams * kUnroll) {
      uint4 raw[kUnroll][NV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * n_teams + my_team;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int vi = t + j * team;
          raw[u][j] = p < len && vi < nvec
              ? __ldg(reinterpret_cast<const uint4*>(vr + p * sl + vi * V))
              : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * n_teams + my_team;
        if (p >= len) continue;
        float vf[NV][V];
#pragma unroll
        for (int j = 0; j < NV; ++j) Kv<T>::widen(raw[u][j], vf[j]);
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const float pm = m0 + i < M ? pr[i * kChunk + p] : 0.f;
#pragma unroll
          for (int j = 0; j < NV; ++j)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i][j][e] = fmaf(pm, vf[j][e], acc[i][j][e]);
        }
      }
    }
    // the teams of a warp hold the same dims: sum them, then the warps in order
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e)
          for (int o = team; o < 32; o <<= 1)
            acc[i][j][e] += __shfl_xor_sync(kFull, acc[i][j][e], o);
    if (lane < team) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = t + j * team;
        if (vi < nvec)
#pragma unroll
          for (int i = 0; i < MQ; ++i)
#pragma unroll
            for (int e = 0; e < V; ++e) red[(warp * MQ + i) * D + vi * V + e] = acc[i][j][e];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < MQ * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      if (m0 + i >= M) continue;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[(w * MQ + i) * D + d];
      partial[((bg * M + m0 + i) * n_chunks + c) * D + d] = s;
    }
    __syncthreads();  // pr and red are reused by the next queries
  }
}

__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ partial, const int64_t* __restrict__ cache_len,
               void* __restrict__ out, int out_bf16, int G, int M, int L, int D,
               int n_chunks) {
  const int bg = blockIdx.x, b = bg / G;
  const int nc = (valid_len(cache_len, b, L) + kChunk - 1) / kChunk;
  for (int idx = threadIdx.x; idx < M * D; idx += kThreads) {
    const int m = idx / D, d = idx % D;
    const float* pc = partial + ((long long)bg * M + m) * n_chunks * D + d;
    float s = 0.f;
    for (int c = 0; c < nc; ++c) s += pc[(long long)c * D];
    const long long o = (long long)bg * M * D + idx;
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(s);
    else
      static_cast<float*>(out)[o] = s;
  }
}

int team_for(int nvec) {
  int team = 1;
  while (team < nvec && team < 32) team *= 2;
  return team;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int MQ>
int launch(const void* q, int q_bf16, const void* k, const void* v, const int64_t* cache_len,
           float* scores, float* partial, void* out, int out_bf16, int B, int G, int M, int L,
           int D, long long sb, long long sg, long long sl, float scale, cudaStream_t st) {
  constexpr int V = Kv<T>::kVec;
  if (D % V || sb % V || sg % V || sl % V || !aligned16(k) || !aligned16(v))
    return cudaErrorInvalidValue;
  const int team = team_for(D / V);
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const dim3 grid(n_chunks, G, B);
  scores_kernel<T><<<grid, kThreads, M * D * sizeof(float), st>>>(
      q, q_bf16, static_cast<const T*>(k), cache_len, scores, G, M, L, D, sb, sg, sl, scale,
      team);
  if (const cudaError_t err = cudaGetLastError()) return err;
  values_kernel<T, MQ><<<grid, kThreads, (MQ * kChunk + kWarps * MQ * D) * sizeof(float), st>>>(
      static_cast<const T*>(v), cache_len, scores, partial, G, M, L, D, sb, sg, sl, team,
      n_chunks);
  if (const cudaError_t err = cudaGetLastError()) return err;
  combine_kernel<<<B * G, kThreads, 0, st>>>(partial, cache_len, out, out_bf16, G, M, L, D,
                                             n_chunks);
  return cudaGetLastError();
}

template <typename T>
int launch_mq(const void* q, int q_bf16, const void* k, const void* v,
              const int64_t* cache_len, float* scores, float* partial, void* out, int out_bf16,
              int B, int G, int M, int L, int D, long long sb, long long sg, long long sl,
              float scale, cudaStream_t st) {
  auto fn = M == 1 ? launch<T, 1> : M == 2 ? launch<T, 2> : launch<T, 4>;
  return fn(q, q_bf16, k, v, cache_len, scores, partial, out, out_bf16, B, G, M, L, D, sb, sg,
            sl, scale, st);
}

}  // namespace

// q (B, G, M, D) contiguous, f32 or bf16 (q_bf16); k and v (B, G, L, D) with
// element strides sb, sg, sl and unit stride over D, f32 (kv_bf16 0) or bf16;
// cache_len (B,) int64 >= 0; scores (B, G, M, L) and partial (B, G, M,
// ceil(L / chunk), D) f32 scratch; out (B, G, M, D) f32 or bf16 (out_bf16).
// chunk must be this file's kChunk; D a multiple of 8 up to 256; M * D * 4
// bytes within 48 KB (the scores kernel's shared q).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* cache_len, void* scores,
    void* partial, void* out, int B, int G, int M, int L, int D, long long sb, long long sg,
    long long sl, float scale, int q_bf16, int kv_bf16, int out_bf16, int chunk,
    void* stream) {
  if (chunk != kChunk || D % 8 || D > kMaxD || M < 1 || M * D * 4 > 48 * 1024 || L < 1)
    return cudaErrorInvalidValue;
  if (B == 0 || G == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto cl = static_cast<const int64_t*>(cache_len);
  auto s = static_cast<float*>(scores);
  auto p = static_cast<float*>(partial);
  return kv_bf16
      ? launch_mq<__nv_bfloat16>(q, q_bf16, k, v, cl, s, p, out, out_bf16, B, G, M, L, D, sb,
                                 sg, sl, scale, st)
      : launch_mq<float>(q, q_bf16, k, v, cl, s, p, out, out_bf16, B, G, M, L, D, sb, sg, sl,
                         scale, st);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
