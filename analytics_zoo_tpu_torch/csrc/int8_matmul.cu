// K5 — fused int8 matmul for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/int8_fused.py, `_int8_matmul_kernel`
// (wrapper `int8_matmul_fused`), and, with g = K and rule 1, the lax route
// `int8_matmul_unfused` of analytics_zoo_tpu/ops/int8.py.
//
// Computes y = (sum over K-groups of f32(int8(x_g / s_row,g) . Wq[g]) *
// s_row,g) * s_channel for x (M, K) in f32 or bf16, Wq (K, N) int8 and the
// per-channel scales (N,) f32; y (M, N) in x's dtype. Activations are
// quantized in the kernel, one abs-max scale per (row, group of g columns):
// g is the TPU route's block_k on the fused route and K on the lax route
// (csrc/int8_tile.cuh has the rounding rules). K % g == 0; ragged M and N
// are masked.
//
// What bounds it on the H100: 2·M·N·K integer operations (68.7 G at the
// int8 MLP's 2048 x 4096 x 4096) against 1979 TOP/s of int8 tensor cores;
// the bytes (x once, Wq once, y once) come second.
//
// What the simple design does: one block per 64 x 64 output tile. For each
// group it first takes the 64 rows' abs-max over the whole group (a warp
// per row), then walks the group in 64-wide chunks: quantize the x chunk
// into shared memory as int8, transpose the Wq chunk into shared memory,
// __dp4a into int32 partials; at the group's end each partial is rescaled
// into the f32 accumulator. No quantized activation ever reaches device
// memory. x is read twice per group (abs-max, then quantize) by every
// column tile. __dp4a runs on the integer pipes, not the tensor cores:
// mma.sync m16n8k32 s8 / wgmma tiles are later work.
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace zoo::i8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const T* __restrict__ x,
                       const int8_t* __restrict__ wq,
                       const float* __restrict__ ws, T* __restrict__ y, int M,
                       int N, int K, int g, int rule, float recip) {
  __shared__ Tile<kBK> t;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[4][4];
  int part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      part[i][j] = 0;
    }

  for (int s0 = 0; s0 < K; s0 += g) {
    const int s1 = s0 + g;
    // 1. each row's abs-max over the whole group, before any of it is
    //    quantized
    for (int r = warp; r < kBM; r += kWarps) {
      const int m = m0 + r;
      float amax = 0.f;
      if (m < M) {
        const T* row = x + (long long)m * K;
        for (int c = s0 + lane; c < s1; c += 32)
          amax = fmaxf(amax, fabsf(zoo::to_f(row[c])));
      }
      amax = zoo::warp_max(amax);
      if (lane == 0) t.scale[r] = group_scale(amax, rule, recip);
    }
    for (int k0 = s0; k0 < s1; k0 += kBK) {
      __syncthreads();  // scales written; the previous chunk consumed
      // 2. quantize the x chunk and stage the Wq chunk as [n][k]
      for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
        const int r = idx / kBK;
        const int c = idx % kBK;
        const int m = m0 + r;
        const int k = k0 + c;
        int8_t q = 0;
        if (m < M && k < s1)
          q = quantize(zoo::to_f(x[(long long)m * K + k]), t.scale[r]);
        bytes(t.a[r])[c] = q;
      }
      for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
        const int kk = idx / kBN;
        const int n = idx % kBN;
        const int k = k0 + kk;
        int8_t w = 0;
        if (k < s1 && n0 + n < N) w = wq[(long long)k * N + n0 + n];
        bytes(t.b[n])[kk] = w;
      }
      __syncthreads();
      // 3. int32 products
      tile_dot(t, ty, tx, part);
    }
    // 4. the group's partial, rescaled into the f32 accumulator
    fold(t, ty, part, acc);
    __syncthreads();  // the next group's scales overwrite t.scale
  }
  // 5. the channel scale on writeback
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        y[(long long)m * N + n] = zoo::from_f<T>(__fmul_rn(acc[i][j], ws[n]));
    }
  }
}

template <typename T>
void launch(const void* x, const int8_t* wq, const float* ws, void* y, int M,
            int N, int K, int g, int rule, float recip, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), wq, ws, static_cast<T*>(y), M, N, K, g, rule,
      recip);
}

}  // namespace

// x (M, K) and y (M, N) contiguous in the dtype `dtype` (0 f32, 1 bf16), wq
// (K, N) int8 and ws (N,) f32 contiguous. g divides K and g * 127^2 fits in
// int32. rule 0: scale = max(amax, 1e-12) * recip; rule 1: / 127. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// it does not take; the grid's row dimension caps M at 65535 * 64).
extern "C" int zoo_int8_matmul(const void* x, const void* wq, const void* ws,
                               void* y, int dtype, int M, int N, int K, int g,
                               int rule, float recip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(ws);
  if (M < 1 || N < 1 || K < 1 || g < 1 || K % g != 0 ||
      (long long)g * 127 * 127 > 2147483647LL || (M + kBM - 1) / kBM > 65535 ||
      (rule != 0 && rule != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == zoo::kF32)
    launch<float>(x, w, s, y, M, N, K, g, rule, recip, st);
  else if (dtype == zoo::kBF16)
    launch<__nv_bfloat16>(x, w, s, y, M, N, K, g, rule, recip, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
