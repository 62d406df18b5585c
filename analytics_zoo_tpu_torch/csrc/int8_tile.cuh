// The int8 tile shared by K5 (csrc/int8_matmul.cu) and K6
// (csrc/int8_conv.cu): a 64 x 64 output tile per block of 256 threads, each
// thread owning 4 x 4 outputs; the contraction walks BK-wide chunks, with
// the activations quantized into shared memory and the weights transposed
// there to [n][k], so that both operands pack 4 int8 per 32-bit word along k
// for __dp4a.
//
// Arithmetic, held bit for bit to the plain versions in ops/int8_fused.py:
// - a scale group's scale is max(amax, 1e-12) * f32(1/127) (the fused TPU
//   route, rule 0) or max(amax, 1e-12) / 127 (the lax route, rule 1);
// - the code is clip(rint(x / scale), -127, 127): IEEE division, rounding
//   half to even as jnp.round does;
// - a group's int32 partial becomes f32 by round-to-nearest, is multiplied
//   by its scale and added to the f32 accumulator as two rounded operations
//   (no contraction into an FMA), in group order; the channel scale lands
//   once on writeback.
#pragma once

#include <stdint.h>

#include "zoo_cuda.cuh"

namespace zoo {
namespace i8 {

constexpr int kBM = 64;        // output rows (matmul rows, conv pixels)
constexpr int kBN = 64;        // output channels
constexpr int kBK = 64;        // contraction chunk (K6 takes 4 at Cin <= 4)
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;

template <int BK>
struct Tile {
  static constexpr int kPitch = BK / 4 + 1;  // 32-bit words a row (+1: banks)
  int a[kBM][kPitch];  // quantized activations, [row][k]
  int b[kBN][kPitch];  // int8 weights, [n][k]
  float scale[kBM];    // the current group's scale of each row
};

__device__ __forceinline__ int8_t* bytes(int* row) {
  return reinterpret_cast<int8_t*>(row);
}

__device__ __forceinline__ float group_scale(float amax, int rule,
                                             float recip) {
  const float m = fmaxf(amax, 1e-12f);
  return rule ? __fdiv_rn(m, 127.f) : __fmul_rn(m, recip);
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

// part[i][j] += a[ty + 16 i] . b[tx + 16 j] over the chunk in shared memory
template <int BK>
__device__ __forceinline__ void tile_dot(const Tile<BK>& t, int ty, int tx,
                                         int (&part)[4][4]) {
#pragma unroll 4
  for (int kk = 0; kk < BK / 4; ++kk) {
    int a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = t.a[ty + 16 * i][kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = t.b[tx + 16 * j][kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = __dp4a(a[i], b[j], part[i][j]);
  }
}

// acc += f32(part) * scale of the row, then part = 0
template <int BK>
__device__ __forceinline__ void fold(const Tile<BK>& t, int ty,
                                     int (&part)[4][4], float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = t.scale[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__int2float_rn(part[i][j]), s));
      part[i][j] = 0;
    }
  }
}

}  // namespace i8
}  // namespace zoo
