// K3 and K4 — flash-attention backward for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/flash_attention.py, `_bwd_dq_kernel` (K3)
// and `_bwd_dkv_kernel` (K4), launched by `_flash_bwd` under the custom VJP
// of `flash_attention`; both recompute the tile math of `_bwd_p_ds`.
//
// For q, dO (B, Tq, H, D) and k, v (B, Tk, H, D) in their storage dtype (f32
// or bf16), the f32 row log-sum-exp lse (B, H, Tq) saved by K1 and the f32
// delta = rowsum(dO * O) (B, H, Tq) computed outside:
//   P  = exp(q k^T * scale - lse)             (causal: 0 where q_pos < k_pos)
//   dS = P * (dO v^T - delta) * scale
//   K3: dQ = dS k                              in q's dtype
//   K4: dV = P^T dO,  dK = dS^T q              in k's / v's dtype
// As in the JAX kernels, P and dS are rounded to the operand dtype before
// each product (a no-op in f32), and every sum is kept in f32.
//
// What bounds them on the H100: at the training shape (B=4, T=2048, H=16,
// D=64, causal) K3 does ~3 and K4 ~4 multiply-adds of length D per (query,
// key) pair below the diagonal, ~52 and ~69 GFLOP, against ~34 MB of inputs
// and outputs: bound by operations (tensor-core rate), by a factor of ~50
// over bytes.
//
// Each has two kernels, chosen by dtype in `zoo_flash_bwd_dq` and
// `zoo_flash_bwd_dkv`: bf16 takes `flash_bwd_dq_mma_kernel` and
// `flash_bwd_dkv_mma_kernel`, on the tensor cores (their own notes are
// below); f32 takes `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, FMA
// loops (TF32 would not hold the f32 checks at 1e-4).
//
// The f32 FMA kernels do nothing for the tensor cores: products are f32
// FMA loops from shared memory, correct first. The structure is the JAX
// one and needs no atomics: K3 has one block per (64-row Q tile, b*h) that
// walks the K tiles up to the causal limit and keeps dQ in registers; K4
// has one block per (64-key tile, b*h) that walks the Q tiles from the
// causal start and keeps dK and dV in registers. D/32 neighbouring threads
// own one row, each holding 32 interleaved elements (d = TPR*i + part) of
// the row's operands and accumulators, so a dot product is D/32 partial
// sums joined by shuffles. The streamed tiles are staged in shared memory
// with coalesced loads (32 rows: 16 KB at D=64, 32 KB at D=128; 16 rows,
// 32 KB, at D=256; under the 48 KB static limit). Keys past Tk and rows
// past Tq are masked inside the kernels, as in K1, so a ragged T needs no
// fallback. D is the compile-time tile (32, 64, 128 or 256) and d <= D the
// head dim: columns d..D are zero and never stored.
#include <stdint.h>

#include "attn_mma.cuh"
#include "zoo_cuda.cuh"

namespace {

constexpr int kRows = 64;  // rows a block owns (Q rows in K3, keys in K4)
// rows of the streamed tile per shared-memory load: two (rows, D) f32
// tiles stay under the 48 KB of static shared memory
template <int D>
constexpr int kTile = D <= 128 ? 32 : 16;

// element strides (batch, position, head) of q, k, v and dO (g)
struct Strides {
  long long q[3], k[3], v[3], g[3];
};

// sum of one row's TPR partial dot products (neighbouring lanes)
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a row's elements TPR*i + part, zero at or past the head dim d
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int part, int d, float (&dst)[32]) {
  constexpr int TPR = D / 32;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dst[i] = TPR * i + part < d ? src[TPR * i + part] : 0.f;
}

// stage rows [r0, r0 + kTile) of two (rows, d) operands into D-wide tiles;
// rows at or past n and columns at or past d are zero
template <int D, int NT>
__device__ __forceinline__ void stage_tile(const float* __restrict__ a,
                                           long long as,
                                           const float* __restrict__ b,
                                           long long bs, int r0, int n, int d,
                                           float (*sa)[D], float (*sb)[D]) {
  for (int idx = threadIdx.x; idx < kTile<D> * D; idx += NT) {
    const int r = idx / D;
    const int c = idx % D;
    const int p = r0 + r;
    float x = 0.f, y = 0.f;
    if (p < n && c < d) {
      x = a[(long long)p * as + c];
      y = b[(long long)p * bs + c];
    }
    sa[r][c] = x;
    sb[r][c] = y;
  }
}

// K3 in f32: dQ for one 64-row Q tile of one (b, h)
template <int D>
__global__ void __launch_bounds__(kRows * D / 32)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Tq, int Tk,
                        int d, const Strides s, int causal, float scale) {
  constexpr int TPR = D / 32;
  constexpr int NT = kRows * TPR;
  constexpr int kT = kTile<D>;
  __shared__ float ks[kT][D];
  __shared__ float vs[kT][D];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int row = tid / TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int qpos = q0 + row;
  const bool active = qpos < Tq;
  const int qp = active ? qpos : Tq - 1;  // inactive rows compute, never store

  float qr[32], gr[32], acc[32];
  load_row<D>(q + b * s.q[0] + qp * s.q[1] + h * s.q[2], part, d, qr);
  load_row<D>(g + b * s.g[0] + qp * s.g[1] + h * s.g[2], part, d, gr);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const float row_lse = lse[(long long)bh * Tq + qp];
  const float row_delta = delta[(long long)bh * Tq + qp];

  const float* kbase = k + b * s.k[0] + h * s.k[2];
  const float* vbase = v + b * s.v[0] + h * s.v[2];
  // causal: keys past the tile's last query row are in every row's future
  const int kend = causal ? min(Tk, q0 + kRows) : Tk;

  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<D, NT>(kbase, s.k[1], vbase, s.v[1], k0, Tk, d, ks, vs);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kT; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc = fmaf(qr[i], ks[j][TPR * i + part], sc);
        dp = fmaf(gr[i], vs[j][TPR * i + part], dp);
      }
      sc = row_sum<TPR>(sc);
      dp = row_sum<TPR>(dp);
      const int kp = k0 + j;
      const bool ok = kp < Tk && (!causal || kp <= qpos);
      const float p = ok ? expf(sc * scale - row_lse) : 0.f;
      const float ds = p * (dp - row_delta) * scale;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(ds, ks[j][TPR * i + part], acc[i]);
    }
  }

  if (active) {
    float* out = dq + (((long long)b * Tq + qpos) * H + h) * d;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (TPR * i + part < d) out[TPR * i + part] = acc[i];
  }
}

// K4 in f32: dK and dV for one 64-key tile of one (b, h)
template <int D>
__global__ void __launch_bounds__(kRows * D / 32)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Tq, int Tk, int d, const Strides s,
                         int causal, float scale) {
  constexpr int TPR = D / 32;
  constexpr int NT = kRows * TPR;
  constexpr int kT = kTile<D>;
  __shared__ float qs[kT][D];
  __shared__ float gs[kT][D];
  __shared__ float ls[kT];
  __shared__ float dls[kT];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int row = tid / TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int kpos = k0 + row;
  const bool active = kpos < Tk;
  const int kp = active ? kpos : Tk - 1;

  float kr[32], vr[32], dka[32], dva[32];
  load_row<D>(k + b * s.k[0] + kp * s.k[1] + h * s.k[2], part, d, kr);
  load_row<D>(v + b * s.v[0] + kp * s.v[1] + h * s.v[2], part, d, vr);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  const float* qbase = q + b * s.q[0] + h * s.q[2];
  const float* gbase = g + b * s.g[0] + h * s.g[2];
  const float* lrow = lse + (long long)bh * Tq;
  const float* drow = delta + (long long)bh * Tq;
  // causal: query rows before the tile's first key see none of its keys
  const int qstart = causal ? k0 : 0;

  for (int q0 = qstart; q0 < Tq; q0 += kT) {
    __syncthreads();
    stage_tile<D, NT>(qbase, s.q[1], gbase, s.g[1], q0, Tq, d, qs, gs);
    if (tid < kT) {
      const int p = q0 + tid;
      ls[tid] = p < Tq ? lrow[p] : 0.f;
      dls[tid] = p < Tq ? drow[p] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kT; ++i) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        sc = fmaf(kr[c], qs[i][TPR * c + part], sc);
        dp = fmaf(vr[c], gs[i][TPR * c + part], dp);
      }
      sc = row_sum<TPR>(sc);
      dp = row_sum<TPR>(dp);
      const int qp = q0 + i;
      const bool ok = qp < Tq && (!causal || kpos <= qp);
      const float p = ok ? expf(sc * scale - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]) * scale;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        dva[c] = fmaf(p, gs[i][TPR * c + part], dva[c]);
        dka[c] = fmaf(ds, qs[i][TPR * c + part], dka[c]);
      }
    }
  }

  if (active) {
    const long long o = (((long long)b * Tk + kpos) * H + h) * d;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      if (TPR * c + part < d) {
        dk[o + TPR * c + part] = dka[c];
        dv[o + TPR * c + part] = dva[c];
      }
    }
  }
}

// K3 for bf16, designed for Hopper's tensor cores.
//
// Replaces the same TPU kernel, `_bwd_dq_kernel`
// (analytics_zoo_tpu/ops/flash_attention.py:191), for bf16 inputs.
//
// What bounds it on the H100: at the training micro-batch (B=2, T=2048,
// H=16, D=64, causal) its three products (S = Q K^T, dP = dO V^T,
// dQ = dS K) come to ~26 GFLOP against ~6 MB of inputs and outputs:
// operations at the tensor cores' rate (~26 us at 989 TFLOP/s) bound it,
// by ~15x over bytes. So all three products run on the tensor cores, and
// P and dS never leave registers.
//
// What the design does about it: one block of 4 warps per (64-row Q tile,
// b*h, DO-column slice of dQ), each warp owning 16 query rows. Q and dO
// are staged once through shared memory, with the rows' lse (prescaled by
// log2(e)) and delta; up to D = 128 their A fragments are then held in
// registers for the whole walk, above it they are loaded from shared
// memory per key chunk, KG k16 steps at a time. The K and V tiles up to the
// causal limit stream through the same two-stage cp.async ring as K1's.
// Per 16-key chunk of a tile: S and dP on mma.sync (B fragments of K and V
// by ldmatrix, non-transposed), P = exp2(S scale log2(e) - lse) and
// dS = P (dP - delta) scale in f32 registers, dS rounded to bf16 and
// repacked as an A fragment, then dQ += dS K over the block's DO columns
// with K's fragments by ldmatrix.trans. Working a chunk at a time keeps 16
// score and 16 dP registers live instead of a whole tile's, and a chunk
// wholly in the future of a warp's rows is skipped. dQ stays in f32
// registers and goes out once, in bf16, through shared memory as 16-byte
// stores. Blocks run the Q tiles in reverse, the longest causal walks
// first. D is the compile-time tile (32, 64, 128 or 256) and d <= D the
// head dim: columns d..D load as zeros, which change no product, and are
// not stored. Up to D = 128 a block owns all of dQ's columns (DO = D); at
// D = 256 two blocks own 128 columns each and both compute S and dP, since
// 256 f32 accumulators a row would not fit in registers beside the
// operands. D <= 64 takes BK = 64, D = 128 and 256 BK = 32; shared memory
// is 54 KB at D = 64, 68 KB at 128 and 135 KB at 256.
// Next: wgmma with a TMA producer warp, and persistent blocks.
template <int D, int BK, int DO>
__global__ void __launch_bounds__(zoo::mma::kThreads)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int H, int Tq,
                            int Tk, int d, const Strides s, int causal,
                            float scale) {
  namespace mm = zoo::mma;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = mm::kRows;
  constexpr int STAGES = mm::kStages;
  constexpr int P = mm::Tile<D>::kPitch;
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int NO = DO / 8;  // n8 tiles of the block's dQ columns
  // Q/dO A fragments held in registers for the walk (D <= 128), or loaded
  // per chunk; KG k16 steps (and DG n16 column pairs) of fragments are
  // loaded together before their products
  constexpr bool kHold = D <= 128;
  constexpr int KG = kHold ? KD : 2;
  constexpr int DG = kHold ? DO / 16 : 2;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // BQ x P
  bf16* sg = sq + BQ * P;                    // BQ x P (dO)
  bf16* sk = sg + BQ * P;                    // STAGES x BK x P
  bf16* sv = sk + STAGES * BK * P;           // STAGES x BK x P

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int c0 = blockIdx.z * DO;   // the block's first dQ column
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int wrow = q0 + warp * 16;  // the warp's first query row
  const int row0 = wrow + g;        // this lane's rows: row0, row0 + 8

  // causal: keys past the tile's last query row are in every row's future
  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  const int nk = (kend + BK - 1) / BK;

  // Q and dO, then the first STAGES - 1 K/V tiles, one commit group per
  // tile
  mm::load_tile<D, BQ>(sq, q + b * s.q[0] + h * s.q[2], s.q[1], q0, Tq, d);
  mm::load_tile<D, BQ>(sg, dout + b * s.g[0] + h * s.g[2], s.g[1], q0, Tq,
                       d);
  const mm::TileRing<D, BK> ring{sk, sv, k + b * s.k[0] + h * s.k[2],
                                 v + b * s.v[0] + h * s.v[2], s.k[1],
                                 s.v[1], Tk, nk, d};
  ring.prologue();

  const float sl2 = scale * mm::kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool ok = row < Tq;  // rows past Tq compute, never store
    lse2[i] = ok ? lse[(long long)bh * Tq + row] * mm::kLog2e : 0.f;
    dl[i] = ok ? delta[(long long)bh * Tq + row] : 0.f;
  }
  uint32_t qf[kHold ? KD : 1][4], gf[kHold ? KD : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    ring.step(j);
    if constexpr (kHold) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          mm::load_a<D>(qf[kk], sq, warp * 16, kk * 16);
          mm::load_a<D>(gf[kk], sg, warp * 16, kk * 16);
        }
      }
    }
    const bf16* ks = ring.tile_a(j);
    const bf16* vs = ring.tile_b(j);

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const int key0 = k0 + 16 * kc;
      // warp-uniform: every key of the chunk past Tk or in the future of
      // all of this warp's rows
      if (key0 >= Tk || (causal && key0 > wrow + 15)) continue;
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
      // a group's K and V fragments are all loaded before its products, so
      // one ldmatrix latency is exposed per group, not one per product
#pragma unroll
      for (int kg = 0; kg < KD; kg += KG) {
        uint32_t kf[KG][4], vf[KG][4];
        uint32_t qa[kHold ? 1 : KG][4], ga[kHold ? 1 : KG][4];
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          mm::load_b<D>(kf[i], ks, kc * 16, (kg + i) * 16);
          mm::load_b<D>(vf[i], vs, kc * 16, (kg + i) * 16);
          if constexpr (!kHold) {
            mm::load_a<D>(qa[i], sq, warp * 16, (kg + i) * 16);
            mm::load_a<D>(ga[i], sg, warp * 16, (kg + i) * 16);
          }
        }
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          if constexpr (kHold) {
            mm::mma_pair(sc, qf[kg + i], kf[i]);
            mm::mma_pair(dp, gf[kg + i], vf[i]);
          } else {
            mm::mma_pair(sc, qa[i], kf[i]);
            mm::mma_pair(dp, ga[i], vf[i]);
          }
        }
      }
      const bool edge = key0 + 16 > Tk || (causal && key0 + 15 > wrow);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = mm::ex2(sc[n][e] * sl2 - lse2[e >> 1]);
          if (edge) {
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (key >= Tk || (causal && key > row)) p = 0.f;
          }
          sc[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;  // dS
        }
      }
      // dQ += dS K over the block's columns: dS rounded to bf16 in
      // registers is the A operand
      uint32_t da[4];
      mm::c_to_a(da, sc[0], sc[1]);
#pragma unroll
      for (int dg = 0; dg < DO / 16; dg += DG) {
        uint32_t kt[DG][4];
#pragma unroll
        for (int i = 0; i < DG; ++i)
          mm::load_bt<D>(kt[i], ks, kc * 16, c0 + (dg + i) * 16);
#pragma unroll
        for (int i = 0; i < DG; ++i) mm::mma_pair(acc + 2 * (dg + i), da, kt[i]);
      }
    }
  }

  // the warp's rows of sq were read only by this warp
  mm::store_rows<DO>(acc, 1.f, 1.f, sq + warp * 16 * P,
                     dq + ((long long)b * Tq * H + h) * d + c0,
                     (long long)H * d, wrow, Tq, min(DO, d - c0));
}

// K4 for bf16, designed for Hopper's tensor cores.
//
// Replaces the same TPU kernel, `_bwd_dkv_kernel`
// (analytics_zoo_tpu/ops/flash_attention.py:222), for bf16 inputs.
//
// What bounds it on the H100: at the training micro-batch (B=2, T=2048,
// H=16, D=64, causal) its four products (S^T = K Q^T, dP^T = V dO^T,
// dV = P^T dO, dK = dS^T Q) come to ~34 GFLOP against ~7 MB of inputs and
// outputs: operations at the tensor cores' rate (~35 us at 989 TFLOP/s)
// bound it, by ~17x over bytes. So all four products run on the tensor
// cores, and P^T and dS^T never leave registers.
//
// What the design does about it: it is K3's design with the two sequence
// axes swapped, so every operand keeps the layout K3 reads it in and no
// shared-memory transpose is needed. One block of 4 warps per (64-key
// tile, b*h, DO-column slice of dK and dV), each warp owning 16 keys. K
// and V are staged once through shared memory; up to D = 64 their A
// fragments are then held in registers for the whole walk, above it
// (whose dK and dV alone take 128 registers a thread at DO = 128) they
// are loaded from shared memory per query chunk. The Q and dO tiles from
// the causal start (query k0) stream through the two-stage cp.async ring,
// with the rows' lse and delta beside them (per column of S^T now). Per
// 16-query chunk: S^T and dP^T on mma.sync (B fragments of Q and dO by
// ldmatrix, non-transposed, as K3 loads K and V),
// P^T = exp2(S^T scale log2(e) - lse log2(e)) and
// dS^T = P^T (dP^T - delta) scale in f32 registers, both repacked as bf16
// A fragments (the JAX kernel's p.astype(g.dtype) and ds.astype(q.dtype)),
// then dV += P^T dO and dK += dS^T Q over the block's DO columns with B
// fragments by ldmatrix.trans. A chunk wholly before the warp's first key
// is skipped; only chunks that cross Tq or the diagonal are masked. dK and
// dV stay in f32 registers and go out once, in bf16, through shared memory
// as 16-byte stores. Blocks run in key order, so the longest causal walks
// (small k0) start first. The head dim is handled as in K3 (D the tile,
// d <= D; DO = D up to 128, two 128-column slices at D = 256). D <= 64
// takes BQ = 64, D = 128 and 256 BQ = 32; shared memory is 55 KB at
// D = 64, 69 KB at 128 and 136 KB at 256. The launch bounds ask for two
// blocks an SM: left to itself ptxas aims at three at D=64 (168
// registers) and spills a 64-bit value.
// Next: wgmma with a TMA producer warp, and persistent blocks.
template <int D, int BQ, int DO>
__global__ void __launch_bounds__(zoo::mma::kThreads, 2)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int Tq,
                             int Tk, int d, const Strides s, int causal,
                             float scale) {
  namespace mm = zoo::mma;
  using bf16 = __nv_bfloat16;
  constexpr int BK = mm::kRows;  // keys a block owns
  constexpr int STAGES = mm::kStages;
  constexpr int P = mm::Tile<D>::kPitch;
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int NO = DO / 8;  // n8 tiles of the block's dK and dV columns
  // K/V A fragments held in registers for the walk (D <= 64), or loaded per
  // chunk; KG k16 steps (and DG n16 column pairs) of fragments are loaded
  // together before their products
  constexpr bool kHold = D <= 64;
  constexpr int KG = kHold ? KD : 2;
  constexpr int DG = kHold ? DO / 16 : 2;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // BK x P
  bf16* sv = sk + BK * P;                    // BK x P
  bf16* sq = sv + BK * P;                    // STAGES x BQ x P
  bf16* sg = sq + STAGES * BQ * P;           // STAGES x BQ x P (dO)
  float* sl = reinterpret_cast<float*>(sg + STAGES * BQ * P);  // lse
  float* sd = sl + STAGES * BQ;                                // delta

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int c0 = blockIdx.z * DO;   // the block's first dK/dV column
  const int k0 = blockIdx.x * BK;
  const int wkey = k0 + warp * 16;  // the warp's first key
  const int key0 = wkey + g;        // this lane's keys: key0, key0 + 8

  // causal: query rows before the tile's first key see none of its keys
  const int qstart = causal ? min(k0, Tq) : 0;
  const int nq = (Tq - qstart + BQ - 1) / BQ;

  // K and V, then the first STAGES - 1 Q/dO tiles, one commit group per
  // tile
  mm::load_tile<D, BK>(sk, k + b * s.k[0] + h * s.k[2], s.k[1], k0, Tk, d);
  mm::load_tile<D, BK>(sv, v + b * s.v[0] + h * s.v[2], s.v[1], k0, Tk, d);
  const long long rows = (long long)bh * Tq + qstart;
  const mm::TileRing<D, BQ, true> ring{
      sq, sg, q + b * s.q[0] + h * s.q[2] + qstart * s.q[1],
      dout + b * s.g[0] + h * s.g[2] + qstart * s.g[1], s.q[1], s.g[1],
      Tq - qstart, nq, d, lse + rows, delta + rows, sl, sd};
  ring.prologue();

  const float sl2 = scale * mm::kLog2e;
  uint32_t kf[kHold ? KD : 1][4], vf[kHold ? KD : 1][4];
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] = 0.f;
      dva[j][e] = 0.f;
    }

  for (int j = 0; j < nq; ++j) {
    const int q0 = qstart + j * BQ;
    ring.step(j);
    if constexpr (kHold) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          mm::load_a<D>(kf[kk], sk, warp * 16, kk * 16);
          mm::load_a<D>(vf[kk], sv, warp * 16, kk * 16);
        }
      }
    }
    const bf16* qs = ring.tile_a(j);
    const bf16* gs = ring.tile_b(j);
    const float* ls = ring.rows_a(j);
    const float* ds = ring.rows_b(j);

#pragma unroll
    for (int qc = 0; qc < BQ / 16; ++qc) {
      const int qq0 = q0 + 16 * qc;
      // warp-uniform: every query of the chunk past Tq, every key of the
      // warp past Tk, or (causal) every query before all of the warp's keys
      if (qq0 >= Tq || wkey >= Tk || (causal && qq0 + 15 < wkey)) continue;
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
      // S^T = K Q^T and dP^T = V dO^T; a group's fragments are all loaded
      // before its products, so one ldmatrix latency is exposed per group
#pragma unroll
      for (int kg = 0; kg < KD; kg += KG) {
        uint32_t qb[KG][4], gb[KG][4];
        uint32_t ka[kHold ? 1 : KG][4], va[kHold ? 1 : KG][4];
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          mm::load_b<D>(qb[i], qs, qc * 16, (kg + i) * 16);
          mm::load_b<D>(gb[i], gs, qc * 16, (kg + i) * 16);
          if constexpr (!kHold) {
            mm::load_a<D>(ka[i], sk, warp * 16, (kg + i) * 16);
            mm::load_a<D>(va[i], sv, warp * 16, (kg + i) * 16);
          }
        }
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          if constexpr (kHold) {
            mm::mma_pair(sc, kf[kg + i], qb[i]);
            mm::mma_pair(dp, vf[kg + i], gb[i]);
          } else {
            mm::mma_pair(sc, ka[i], qb[i]);
            mm::mma_pair(dp, va[i], gb[i]);
          }
        }
      }
      // P^T and dS^T; the rows' lse and delta are this tile's columns
      const bool edge = qq0 + 16 > Tq || (causal && wkey + 15 > qq0);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 16 * qc + 8 * n + 2 * t;  // column within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lc = (e & 1) ? l2.y : l2.x;
          const float dc = (e & 1) ? d2.y : d2.x;
          float p = mm::ex2(sc[n][e] * sl2 - lc * mm::kLog2e);
          if (edge) {
            const int query = q0 + c + (e & 1);
            const int key = key0 + (e >> 1) * 8;
            if (query >= Tq || (causal && key > query)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dc) * scale;  // dS^T
          sc[n][e] = p;                            // P^T
        }
      }
      // dV += P^T dO and dK += dS^T Q over the block's columns: P^T and
      // dS^T rounded to bf16 in registers are the A operands
      uint32_t pa[4], da[4];
      mm::c_to_a(pa, sc[0], sc[1]);
      mm::c_to_a(da, dp[0], dp[1]);
#pragma unroll
      for (int dg = 0; dg < DO / 16; dg += DG) {
        uint32_t gt[DG][4], qt[DG][4];
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          mm::load_bt<D>(gt[i], gs, qc * 16, c0 + (dg + i) * 16);
          mm::load_bt<D>(qt[i], qs, qc * 16, c0 + (dg + i) * 16);
        }
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          mm::mma_pair(dva + 2 * (dg + i), pa, gt[i]);
          mm::mma_pair(dka + 2 * (dg + i), da, qt[i]);
        }
      }
    }
  }

  // every copy has landed (a block with no query tile still has K and V
  // in flight) and every warp is done reading the ring; each warp's rows
  // of sk and sv were read only by that warp
  mm::cp_async_wait<0>();
  __syncthreads();
  const long long out = ((long long)b * Tk * H + h) * d + c0;
  const int ncols = min(DO, d - c0);
  mm::store_rows<DO>(dka, 1.f, 1.f, sk + warp * 16 * P, dk + out,
                     (long long)H * d, wkey, Tk, ncols);
  mm::store_rows<DO>(dva, 1.f, 1.f, sv + warp * 16 * P, dv + out,
                     (long long)H * d, wkey, Tk, ncols);
}

// the column slice a bf16 backward block owns: all of D up to 128
template <int D>
constexpr int kSlice = D <= 128 ? D : 128;

template <int D, int BQ>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int Tq, int Tk, int d,
                   const Strides& s, int causal, float scale,
                   cudaStream_t stream) {
  namespace mm = zoo::mma;
  constexpr int DO = kSlice<D>;
  constexpr int smem =
      (2 * mm::kRows + 2 * mm::kStages * BQ) * mm::Tile<D>::kPitch * 2 +
      2 * mm::kStages * BQ * 4;
  static std::atomic<uint64_t> granted{0};
  const cudaError_t err =
      mm::grant_smem(flash_bwd_dkv_mma_kernel<D, BQ, DO>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + mm::kRows - 1) / mm::kRows, B * H, D / DO);
  flash_bwd_dkv_mma_kernel<D, BQ, DO><<<grid, mm::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, d, s, causal, scale);
  return (int)cudaGetLastError();
}

template <int D, int BK>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, void* dq, int B, int H,
                  int Tq, int Tk, int d, const Strides& s, int causal,
                  float scale, cudaStream_t stream) {
  namespace mm = zoo::mma;
  constexpr int DO = kSlice<D>;
  constexpr int smem =
      (2 * mm::kRows + 2 * mm::kStages * BK) * mm::Tile<D>::kPitch * 2;
  static std::atomic<uint64_t> granted{0};
  const cudaError_t err =
      mm::grant_smem(flash_bwd_dq_mma_kernel<D, BK, DO>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + mm::kRows - 1) / mm::kRows, B * H, D / DO);
  flash_bwd_dq_mma_kernel<D, BK, DO><<<grid, mm::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
      Tq, Tk, d, s, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Tq, int Tk, int d, const Strides& s, int causal,
              float scale, cudaStream_t stream) {
  dim3 grid((Tq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<D><<<grid, kRows * D / 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Tq, Tk, d, s, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Tq, int Tk, int d, const Strides& s, int causal,
               float scale, cudaStream_t stream) {
  dim3 grid((Tk + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kRows * D / 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, d, s,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, position, head) for q, k, v and dO (g);
// head dims are contiguous. lse and delta are contiguous (B, H, Tq) f32;
// dq is a contiguous (B, Tq, H, D) tensor and dk, dv contiguous
// (B, Tk, H, D) tensors in the storage dtype. D is a multiple of 8 from 8
// to 256; each dtype runs on the smallest compile-time tile of 32, 64, 128
// or 256 columns that holds it. bf16 rows must start 16-byte aligned (the
// wrapper checks: cp.async moves 16-byte chunks). Each entry returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a
// dtype/head dim it does not take).
extern "C" int zoo_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dq, int dtype, int B,
                                int H, int Tq, int Tk, int D, long long qsb,
                                long long qst, long long qsh, long long ksb,
                                long long kst, long long ksh, long long vsb,
                                long long vst, long long vsh, long long gsb,
                                long long gst, long long gsh, int causal,
                                float scale, void* stream) {
  const Strides s{{qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
                  {gsb, gst, gsh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq < 1 || Tk < 1 || B < 1 || H < 1 || D < 8 || D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
#define ZOO_DQ(F, ...) F<__VA_ARGS__>(q, k, v, g, lse, delta, dq, B, H, Tq, Tk, D, s, causal, scale, st)
  if (dtype == zoo::kBF16)
    return D <= 32    ? ZOO_DQ(launch_dq_mma, 32, 64)
           : D <= 64  ? ZOO_DQ(launch_dq_mma, 64, 64)
           : D <= 128 ? ZOO_DQ(launch_dq_mma, 128, 32)
                      : ZOO_DQ(launch_dq_mma, 256, 32);
  if (dtype == zoo::kF32)
    return D <= 32    ? ZOO_DQ(launch_dq, 32)
           : D <= 64  ? ZOO_DQ(launch_dq, 64)
           : D <= 128 ? ZOO_DQ(launch_dq, 128)
                      : ZOO_DQ(launch_dq, 256);
#undef ZOO_DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int zoo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int dtype, int B, int H, int Tq, int Tk,
                                 int D, long long qsb, long long qst,
                                 long long qsh, long long ksb, long long kst,
                                 long long ksh, long long vsb, long long vst,
                                 long long vsh, long long gsb, long long gst,
                                 long long gsh, int causal, float scale,
                                 void* stream) {
  const Strides s{{qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
                  {gsb, gst, gsh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq < 1 || Tk < 1 || B < 1 || H < 1 || D < 8 || D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
#define ZOO_DKV(F, ...) F<__VA_ARGS__>(q, k, v, g, lse, delta, dk, dv, B, H, Tq, Tk, D, s, causal, scale, st)
  if (dtype == zoo::kBF16)
    return D <= 32    ? ZOO_DKV(launch_dkv_mma, 32, 64)
           : D <= 64  ? ZOO_DKV(launch_dkv_mma, 64, 64)
           : D <= 128 ? ZOO_DKV(launch_dkv_mma, 128, 32)
                      : ZOO_DKV(launch_dkv_mma, 256, 32);
  if (dtype == zoo::kF32)
    return D <= 32    ? ZOO_DKV(launch_dkv, 32)
           : D <= 64  ? ZOO_DKV(launch_dkv, 64)
           : D <= 128 ? ZOO_DKV(launch_dkv, 128)
                      : ZOO_DKV(launch_dkv, 256);
#undef ZOO_DKV
  return (int)cudaErrorInvalidValue;
}
