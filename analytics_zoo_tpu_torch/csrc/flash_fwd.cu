// K1 — flash-attention forward for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/flash_attention.py, `_fwd_kernel` (launched
// by `_flash_fwd`, entry point `flash_attention`).
//
// Computes, for q (B, Tq, H, D) and k, v (B, Tk, H, D) in their storage dtype
// (f32 or bf16), O = softmax(q k^T / sqrt(D) [+ causal mask]) v in the storage
// dtype and the row log-sum-exp lse = m + log(l) in f32, laid out (B, H, Tq).
// The causal mask compares absolute positions from 0 (query i sees keys <= i),
// as the JAX kernel does. As there, the probabilities are rounded to v's
// dtype before the P V product (a no-op in f32) and l sums them in f32.
//
// Two kernels, chosen by dtype in `zoo_flash_fwd`:
// - bf16: `flash_fwd_mma_kernel`, on the tensor cores;
// - f32: `flash_fwd_kernel`, f32 FMA loops. On the tensor cores f32 would
//   run as TF32, about three decimal digits, which the f32 checks against
//   the plain version (1e-4) cannot take; f32 is neither the training nor
//   the serving dtype.
#include <stdint.h>

#include "attn_mma.cuh"
#include "zoo_cuda.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 32;            // keys per shared-memory tile
constexpr int kThreads = 2 * kBQ;  // two threads per query row

// The f32 kernel, written "correct first". Two threads own one query row,
// each holding the interleaved half of the q row and of the f32 accumulator
// in registers (element d = 2*i + half), so a score is two half dots joined
// by one shuffle. K/V tiles of 32 keys are staged in shared memory with
// coalesced loads; the online softmax (m, l, acc) stays in f32; K tiles
// wholly in the future of the Q tile are never loaded under the causal
// mask; keys past Tk and rows past Tq are masked inside the kernel.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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
    const float* qrow = q + b * qsb + (long long)qrow_pos * qst + h * qsh;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      qr[i] = qrow[2 * i + half];
      acc[i] = 0.f;
    }
  }
  float m = zoo::kNegInf;
  float l = 0.f;

  const float* kbase = k + b * ksb + h * ksh;
  const float* vbase = v + b * vsb + h * vsh;
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
        kv = kbase[(long long)kp * kst + c];
        vv = vbase[(long long)kp * vst + c];
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
    float* orow = o + (((long long)b * Tq + qpos) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DH; ++i) orow[2 * i + half] = acc[i] / safe_l;
    if (half == 0) lse[(long long)bh * Tq + qpos] = m + logf(safe_l);
  }
}

// The bf16 kernel, designed for Hopper's tensor cores.
//
// Replaces the same TPU kernel, `_fwd_kernel`
// (analytics_zoo_tpu/ops/flash_attention.py:46), for bf16 inputs.
//
// What bounds it on the H100: at the serving prefill (B=1, T=1024, H=16,
// D=64, causal) the bound is bytes, ~8.5 MB in ~2.5 us, below what a
// launch itself costs; at the training micro-batch (B=2, T=2048) it is the
// ~17 GFLOP of the two products, ~17 us at 989 TFLOP/s. So both products
// must run on the tensor cores, fed from shared memory without stalling
// the warps.
//
// What the design does about it: one block of 4 warps per (64-row Q tile,
// b*h), each warp owning 16 query rows. Q is staged once through shared
// memory into A fragments held in registers. K and V tiles of BK keys
// stream through a two-stage cp.async ring of bf16 tiles (rows past Tk
// zero-filled), so the next tile loads while this one is multiplied.
// S = Q K^T runs on mma.sync m16n8k16 with K's fragments from ldmatrix;
// the online softmax runs on the f32 accumulators in registers, in the
// log2 domain (exp2f of scores prescaled by scale * log2(e)), with row max
// and sum over the quad of lanes that holds a row; P, rounded to bf16 in
// registers, is the A operand of O += P V, with V's fragments from
// ldmatrix.trans. Only tiles that cross Tk or the diagonal of a warp's rows
// are masked; tiles wholly in the future are never loaded. O / l goes out
// in bf16 through shared memory as 16-byte stores, the LSE in f32. The
// grid's x runs over the Q tiles in reverse, so the longest causal rows
// start first. D=64 takes BK = 64 and 45 KB of shared memory; D=128 takes
// BK = 32 (fewer score registers) and 51 KB.
// Next: wgmma with a TMA producer warp, and persistent blocks.
template <int D, int BK>
__global__ void __launch_bounds__(zoo::mma::kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int H, int Tq, int Tk,
                         long long qsb, long long qst, long long qsh,
                         long long ksb, long long kst, long long ksh,
                         long long vsb, long long vst, long long vsh,
                         int causal, float scale) {
  namespace mm = zoo::mma;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = mm::kRows;
  constexpr int STAGES = mm::kStages;
  constexpr int P = mm::Tile<D>::kPitch;
  constexpr int NT = BK / 8;  // n8 score tiles per key tile
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 output tiles

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // BQ x P
  bf16* sk = sq + BQ * P;                    // STAGES x BK x P
  bf16* sv = sk + STAGES * BK * P;           // STAGES x BK x P

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int wrow = q0 + warp * 16;  // the warp's first query row
  const int row0 = wrow + g;        // this lane's rows: row0, row0 + 8

  // causal: keys past the tile's last query row are in every row's future
  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  const int nk = (kend + BK - 1) / BK;

  // Q, then the first STAGES - 1 K/V tiles, one commit group per tile
  mm::load_tile<D, BQ>(sq, q + b * qsb + h * qsh, qst, q0, Tq);
  const mm::TileRing<D, BK> ring{sk, sv, k + b * ksb + h * ksh,
                                 v + b * vsb + h * vsh, kst, vst, Tk, nk};
  ring.prologue();

  const float sl2 = scale * mm::kLog2e;
  const float ninf = mm::neg_inf();
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {ninf, ninf};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};    // this lane's part of the row sum

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    ring.step(j);
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mm::load_a<D>(qf[kk], sq, warp * 16, kk * 16);
    }
    const bf16* ks = ring.tile_a(j);
    const bf16* vs = ring.tile_b(j);

    // S = Q K^T; a k16 step's K fragments are all loaded before its
    // products, so one ldmatrix latency is exposed per step
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        mm::load_b<D>(kf[np], ks, np * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        mm::mma_bf16(s[2 * np], qf[kk], kf[np][0], kf[np][1]);
        mm::mma_bf16(s[2 * np + 1], qf[kk], kf[np][2], kf[np][3]);
      }
    }

    // the online softmax in the log2 domain; only a tile that crosses Tk
    // or the diagonal of this warp's rows is masked
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > wrow);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Tk || (causal && key > row)) x = ninf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = mm::quad_max(mx[i]);
      // a row with no visible key yet keeps its sums at 0
      base[i] = mx[i] == ninf ? 0.f : mx[i];
      corr[i] = mm::ex2(m[i] - base[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = mm::ex2(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      acc[jd][0] *= corr[0];
      acc[jd][1] *= corr[0];
      acc[jd][2] *= corr[1];
      acc[jd][3] *= corr[1];
    }

    // O += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4], vf[D / 16][4];
      mm::c_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp)
        mm::load_bt<D>(vf[dp], vs, kc * 16, dp * 16);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        mm::mma_bf16(acc[2 * dp], pa, vf[dp][0], vf[dp][1]);
        mm::mma_bf16(acc[2 * dp + 1], pa, vf[dp][2], vf[dp][3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = mm::quad_sum(l[i]);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  // the warp's rows of sq were read only by this warp, into qf
  mm::store_rows<D>(acc, inv[0], inv[1], sq + warp * 16 * P,
                    o + ((long long)b * Tq * H + h) * D, (long long)H * D,
                    wrow, Tq);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Tq)
        lse[(long long)bh * Tq + row] =
            m[i] * mm::kLn2 + logf(l[i] > 0.f ? l[i] : 1.f);
    }
  }
}

template <int D, int BK>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Tq, int Tk, const long long* qs,
               const long long* ks, const long long* vs, int causal,
               float scale, cudaStream_t stream) {
  namespace mm = zoo::mma;
  constexpr int smem =
      (mm::kRows + 2 * mm::kStages * BK) * mm::Tile<D>::kPitch * 2;
  static std::atomic<uint64_t> granted{0};
  const cudaError_t err =
      mm::grant_smem(flash_fwd_mma_kernel<D, BK>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + mm::kRows - 1) / mm::kRows, B * H);
  flash_fwd_mma_kernel<D, BK><<<grid, mm::kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Tq,
          Tk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
          causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, int H, int Tq, int Tk, const long long* qs,
            const long long* ks, const long long* vs, int causal, float scale,
            cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tq, Tk, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], causal, scale);
}

}  // namespace

// Strides are in elements: (batch, position, head) for q, k and v; the head
// dim is contiguous. o is a contiguous (B, Tq, H, D) tensor and lse a
// contiguous (B, H, Tq) f32 tensor. bf16 rows must start 16-byte aligned
// (the wrapper checks: cp.async moves 16-byte chunks). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// dtype/head-dim it does not take).
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
  if (dtype == zoo::kBF16) {
    if (D == 64)
      return launch_mma<64, 64>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
    if (D == 128)
      return launch_mma<128, 32>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == zoo::kF32 && D == 64)
    launch<64>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
  else if (dtype == zoo::kF32 && D == 128)
    launch<128>(q, k, v, o, lse, B, H, Tq, Tk, qs, kss, vss, causal, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
