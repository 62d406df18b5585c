// K1 — flash-attention forward for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/flash_attention.py, `_fwd_kernel` (launched
// by `_flash_fwd`, entry point `flash_attention`).
//
// Computes, for q (B, Tq, H, D) and k, v (B, Tk, H, D) in their storage dtype
// (f32 or bf16), O = softmax(q k^T / sqrt(D) [+ causal mask]) v in the storage
// dtype and the row log-sum-exp lse = m + log(l) in f32, laid out (B, H, Tq).
// The causal mask compares absolute positions from 0 (query i sees keys <= i),
// as the JAX kernel does.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (B=1, H=16, D=64, T a power of two from 16 to 1024) the work is small — one
// causal 512-token layer is ~0.5 GFLOP — so the kernel is bound by memory
// traffic and launch latency, not by FLOPs. The bytes it must move are q, k,
// v and o once each (T*H*D*4 elements) plus the lse row.
//
// What the simple design does about it: one block per (64-row Q tile, b*h)
// pair; every block is independent (on the TPU the lse out-block forced the
// Q grid axis to run in order; here each block writes its own lse slice). Two
// threads own one query row, each holding the interleaved half of the q row
// and of the f32 accumulator in registers (element d = 2*i + half), so a
// score is two half dots joined by one shuffle. K/V tiles of 32 keys are
// staged in shared memory as f32 with coalesced loads; the online softmax
// (m, l, acc) stays in f32; K tiles wholly in the future of the Q tile are
// never loaded under the causal mask; keys past Tk and rows past Tq are
// masked inside the kernel, so a ragged T needs no fallback. Products are FMA
// loops: correct first, tensor cores (wgmma/TMA) are later work.
#include <stdint.h>

#include "zoo_cuda.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 32;            // keys per shared-memory tile
constexpr int kThreads = 2 * kBQ;  // two threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh, int causal,
                     float scale) {
  constexpr int DH = D / 2;
  __shared__ float ks[kBK][D];
  __shared__ float vs[kBK][D];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = tid >> 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int qpos = q0 + row;
  const bool active = qpos < Tq;

  float qr[DH];
  float acc[DH];
  {
    const int qrow_pos = active ? qpos : Tq - 1;
    const T* qrow = q + b * qsb + (long long)qrow_pos * qst + h * qsh;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      qr[i] = zoo::to_f(qrow[2 * i + half]);
      acc[i] = 0.f;
    }
  }
  float m = zoo::kNegInf;
  float l = 0.f;

  const T* kbase = k + b * ksb + h * ksh;
  const T* vbase = v + b * vsb + h * vsh;
  // causal: keys past the tile's last query row are in every row's future
  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Tk) {
        kv = zoo::to_f(kbase[(long long)kp * kst + c]);
        vv = zoo::to_f(vbase[(long long)kp * vst + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = zoo::kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) part = fmaf(qr[i], ks[j][2 * i + half], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kp = k0 + j;
      const bool ok = kp < Tk && (!causal || kp <= qpos);
      s[j] = ok ? part * scale : zoo::kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const int kp = k0 + j;
      const bool ok = kp < Tk && (!causal || kp <= qpos);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      s[j] = p;
      psum += p;
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBK; ++j) a = fmaf(s[j], vs[j][2 * i + half], a);
      acc[i] = a;
    }
    m = m_new;
  }

  if (active) {
    const float safe_l = l == 0.f ? 1.f : l;
    T* orow = o + (((long long)b * Tq + qpos) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DH; ++i) orow[2 * i + half] = zoo::from_f<T>(acc[i] / safe_l);
    if (half == 0) lse[(long long)bh * Tq + qpos] = m + logf(safe_l);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, int H, int Tq, int Tk, const long long* qs,
            const long long* ks, const long long* vs, int causal, float scale,
            cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      causal, scale);
}

}  // namespace

// Strides are in elements: (batch, position, head) for q, k and v; the head
// dim is contiguous. o is a contiguous (B, Tq, H, D) tensor and lse a
// contiguous (B, H, Tq) f32 tensor. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a dtype/head-dim it does not take).
extern "C" int zoo_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int B, int H,
                             int Tq, int Tk, int D, long long qsb,
                             long long qst, long long qsh, long long ksb,
                             long long kst, long long ksh, long long vsb,
                             long long vst, long long vsh, int causal,
                             float scale, void* stream) {
  const long long qs[3] = {qsb, qst, qsh};
  const long long kss[3] = {ksb, kst, ksh};
  const long long vss[3] = {vsb, vst, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq < 1 || Tk < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == zoo::kF32 && D == 64)
    launch<float, 64>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
  else if (dtype == zoo::kF32 && D == 128)
    launch<float, 128>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
  else if (dtype == zoo::kBF16 && D == 64)
    launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
  else if (dtype == zoo::kBF16 && D == 128)
    launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
