// K6 — fused int8 convolution for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/int8_fused.py, `_int8_conv_kernel`
// (wrapper `int8_conv2d_fused`, stride 1), and, with its stride and rule 1,
// the lax route `int8_conv2d_unfused` of analytics_zoo_tpu/ops/int8.py.
//
// Computes the NHWC x HWIO convolution y[b, ho, wo, n] = (sum over taps
// t = kh * KW + kw, in that order, of f32(sum_c q[b, hi, wi, c] *
// Wq[kh, kw, c, n]) * s[b, hi, wi]) * s_channel[n], with hi = ho * sh + kh -
// pad_top and wi = wo * sw + kw - pad_left, where q and s quantize each
// input pixel's Cin vector with its own abs-max scale (csrc/int8_tile.cuh
// has the rounding rules). Pixels outside the input are the zero padding:
// they quantize to 0, so their scale never matters. x in f32 or bf16, y
// (B, Ho, Wo, Cout) in x's dtype.
//
// What bounds it on the H100: 2 * B * Ho * Wo * Cout * KH * KW * Cin integer
// operations against 1979 TOP/s of int8 tensor cores at ResNet-50's 3x3
// convs; the 1x1 convs at 7 px and the stem sit nearer the bytes (x, Wq and
// y once).
//
// What the simple design does: one block per (64 output pixels of the
// flattened B x Ho x Wo, 64 output channels), so every block owns its
// outputs, nothing is carried between blocks, and the small late-stage
// images (7, 14 px) fill whole tiles. It walks the taps in order; per tap it
// finds each row's input pixel (or the zero padding) and takes its abs-max
// over the whole Cin (a warp per pixel, a thread at Cin <= 8), then walks
// Cin in 64-wide chunks (4-wide at Cin <= 4: the stem's 3 channels),
// quantizing the pixels as it loads them into shared memory and __dp4a-ing
// them against the tap's (Cin, Cout) int8 slice into int32 partials,
// rescaled into the f32 accumulator at the tap's end. One launch: no
// quantized activation and no padded copy of x reaches device memory. A
// pixel's scale is recomputed for every tap that reads it, and tensor cores
// are later work.
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace zoo::i8;

struct ConvShape {
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, sh, sw, pt, pl;
};

template <typename T, int BK>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ ws, T* __restrict__ y,
                     ConvShape s, int rule, float recip) {
  __shared__ Tile<BK> t;
  __shared__ const T* px[kBM];  // this tap's input pixel of each row, or null
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long n_px = (long long)s.B * s.Ho * s.Wo;
  const long long p0 = (long long)blockIdx.x * kBM;  // first output pixel
  const int n0 = blockIdx.y * kBN;

  float acc[4][4];
  int part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      part[i][j] = 0;
    }

  for (int kh = 0; kh < s.KH; ++kh) {
    for (int kw = 0; kw < s.KW; ++kw) {
      // 1. each row's input pixel at this tap, and its abs-max over the
      //    whole Cin (a thread per pixel at a small Cin, else a warp)
      if (tid < kBM) {
        const long long p = p0 + tid;
        const T* ptr = nullptr;
        if (p < n_px) {
          const int b = (int)(p / ((long long)s.Ho * s.Wo));
          const int rem = (int)(p % ((long long)s.Ho * s.Wo));
          const int hi = (rem / s.Wo) * s.sh + kh - s.pt;
          const int wi = (rem % s.Wo) * s.sw + kw - s.pl;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
            ptr = x + (((long long)b * s.H + hi) * s.W + wi) * s.Cin;
        }
        px[tid] = ptr;
      }
      __syncthreads();
      if (s.Cin <= 8) {
        if (tid < kBM) {
          float amax = 0.f;
          if (px[tid] != nullptr)
            for (int c = 0; c < s.Cin; ++c)
              amax = fmaxf(amax, fabsf(zoo::to_f(px[tid][c])));
          t.scale[tid] = group_scale(amax, rule, recip);
        }
      } else {
        for (int r = warp; r < kBM; r += kWarps) {
          float amax = 0.f;
          if (px[r] != nullptr)
            for (int c = lane; c < s.Cin; c += 32)
              amax = fmaxf(amax, fabsf(zoo::to_f(px[r][c])));
          amax = zoo::warp_max(amax);
          if (lane == 0) t.scale[r] = group_scale(amax, rule, recip);
        }
      }
      const int8_t* wt = wq + (long long)(kh * s.KW + kw) * s.Cin * s.Cout;
      for (int c0 = 0; c0 < s.Cin; c0 += BK) {
        __syncthreads();  // scales written; the previous chunk consumed
        // 2. quantize the pixels' chunk, stage the weights as [n][k]
        for (int idx = tid; idx < kBM * BK; idx += kThreads) {
          const int r = idx / BK;
          const int c = idx % BK;
          int8_t q = 0;
          if (px[r] != nullptr && c0 + c < s.Cin)
            q = quantize(zoo::to_f(px[r][c0 + c]), t.scale[r]);
          bytes(t.a[r])[c] = q;
        }
        for (int idx = tid; idx < BK * kBN; idx += kThreads) {
          const int kk = idx / kBN;
          const int n = idx % kBN;
          int8_t w = 0;
          if (c0 + kk < s.Cin && n0 + n < s.Cout)
            w = wt[(long long)(c0 + kk) * s.Cout + n0 + n];
          bytes(t.b[n])[kk] = w;
        }
        __syncthreads();
        // 3. int32 products over the chunk
        tile_dot(t, ty, tx, part);
      }
      // 4. the tap's partial, rescaled by each pixel's scale
      fold(t, ty, part, acc);
      __syncthreads();  // the next tap overwrites px and t.scale
    }
  }
  // 5. the channel scale on writeback (NHWC: pixel-major)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= n_px) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < s.Cout)
        y[p * s.Cout + n] = zoo::from_f<T>(__fmul_rn(acc[i][j], ws[n]));
    }
  }
}

template <typename T>
void launch(const void* x, const int8_t* wq, const float* ws, void* y,
            const ConvShape& s, int rule, float recip, cudaStream_t stream) {
  const long long n_px = (long long)s.B * s.Ho * s.Wo;
  dim3 grid((unsigned)((n_px + kBM - 1) / kBM), (s.Cout + kBN - 1) / kBN);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (s.Cin <= 4)  // the stem's 3 channels: a 4-wide chunk, not 64
    int8_conv_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xt, wq, ws, yt, s,
                                                          rule, recip);
  else
    int8_conv_kernel<T, kBK><<<grid, kThreads, 0, stream>>>(xt, wq, ws, yt, s,
                                                            rule, recip);
}

}  // namespace

// x (B, H, W, Cin) and y (B, Ho, Wo, Cout) contiguous in the dtype `dtype`
// (0 f32, 1 bf16); wq (KH, KW, Cin, Cout) int8 and ws (Cout,) f32
// contiguous. Strides sh, sw >= 1; pad_top/pad_left place the window (the
// bottom/right padding follows from Ho, Wo). rule 0: scale = max(amax,
// 1e-12) * recip; rule 1: / 127. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int zoo_int8_conv(const void* x, const void* wq, const void* ws,
                             void* y, int dtype, int B, int H, int W, int Cin,
                             int Ho, int Wo, int Cout, int KH, int KW, int sh,
                             int sw, int pad_top, int pad_left, int rule,
                             float recip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(ws);
  const ConvShape s{B,  H,  W,  Cin, Ho, Wo,      Cout,
                    KH, KW, sh, sw,  pad_top, pad_left};
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Ho < 1 || Wo < 1 || Cout < 1 ||
      KH < 1 || KW < 1 || sh < 1 || sw < 1 || pad_top < 0 || pad_left < 0 ||
      ((long long)B * Ho * Wo + kBM - 1) / kBM > 2147483647LL ||
      (Cout + kBN - 1) / kBN > 65535 ||
      (long long)Cin * 127 * 127 > 2147483647LL || (rule != 0 && rule != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == zoo::kF32)
    launch<float>(x, w, sc, y, s, rule, recip, st);
  else if (dtype == zoo::kBF16)
    launch<__nv_bfloat16>(x, w, sc, y, s, rule, recip, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
