// Gumbel-max sampling with the JAX package's threefry bits, in one launch.
//
// Mirrors: analytics_zoo_tpu/ops/kv_cache.py `sample_tokens`, which draws
// each row at temperature > 0 as
// `jax.random.categorical(fold_in(PRNGKey(seed), token_idx), row)`. That is
// not a Pallas kernel; the port's plain version (`gumbel_max_plain` in
// ops/kv_cache.py) reproduces it bit for bit with ~180 elementwise torch
// ops over (rows, V) int64 tensors, which costs a decode step about 2 ms of
// launches. This kernel computes the same function in one pass.
//
// For hot row i with folded key (k1, k2) (computed on the host) and the
// f32 row `scaled[row_i]` (logits / temperature, top-k masked):
//   bits[j]  = w1 ^ w2,  (w1, w2) = threefry2x32((k1, k2), (0, j))
//   u[j]     = max(float(0x3F800000 | bits[j] >> 9) - 1 + tiny, tiny)
//   token_i  = argmax_j (-log(-log(u[j])) + scaled[row_i, j])
// in uint32 and f32 arithmetic exactly as the plain version orders it,
// ties to the first index (torch.argmax).
//
// What bounds it: ~90 operations per element and 4 bytes read, for a few
// rows of V = 32000: launch latency, not the chip's rates.
//
// Design: one block per hot row; each thread strides over the row keeping
// its best (value, index), then a warp-shuffle and shared-memory reduction
// with the first-index rule.
#include <math.h>
#include <stdint.h>

#include "zoo_cuda.cuh"

namespace {

constexpr int kThreads = 512;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the count pair (0, j) under key (k1, k2): w1 ^ w2
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint32_t j) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x1 = ks[0];
  uint32_t x2 = j + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][r]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x1 ^ x2;
}

// (a, ia) beats (b, ib): larger value, NaN above all, first index on ties
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
    gumbel_max_kernel(const float* __restrict__ scaled, int V,
                      const long long* __restrict__ meta,
                      long long* __restrict__ out) {
  const long long* m = meta + 3 * blockIdx.x;  // (row, k1, k2)
  const float* x = scaled + m[0] * (long long)V;
  const uint32_t k1 = (uint32_t)m[1];
  const uint32_t k2 = (uint32_t)m[2];
  const float tiny = 1.17549435e-38f;  // finfo(float32).tiny

  float best = -INFINITY;
  int best_j = V;
  for (int j = threadIdx.x; j < V; j += kThreads) {
    const uint32_t bits = threefry_bits(k1, k2, (uint32_t)j);
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
    const float u = fmaxf(__fadd_rn(__fsub_rn(f, 1.0f), tiny), tiny);
    const float g = -logf(-logf(u));
    const float val = __fadd_rn(g, x[j]);
    if (beats(val, j, best, best_j)) {
      best = val;
      best_j = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (beats(ov, oj, best, best_j)) {
      best = ov;
      best_j = oj;
    }
  }
  __shared__ float sv[kThreads / 32];
  __shared__ int sj[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sv[warp] = best;
    sj[warp] = best_j;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      if (beats(sv[w], sj[w], best, best_j)) {
        best = sv[w];
        best_j = sj[w];
      }
    }
    out[blockIdx.x] = best_j;
  }
}

}  // namespace

// scaled: contiguous (B, V) f32; meta: contiguous (n, 3) int64 rows of
// (row of scaled, k1, k2) with the keys in [0, 2**32); out: (n,) int64.
// Returns cudaGetLastError() after the launch.
extern "C" int zoo_gumbel_max(const void* scaled, int V, const void* meta,
                              void* out, int n, void* stream) {
  if (n < 1 || V < 1) return (int)cudaErrorInvalidValue;
  gumbel_max_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scaled), V,
      static_cast<const long long*>(meta), static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
