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
// Each has three kernels, chosen by dtype and head dim in
// `zoo_flash_bwd_dq` and `zoo_flash_bwd_dkv`: bf16 up to D = 256 takes
// `flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkv_wgmma_kernel`, on wgmma
// fed by TMA (their own notes are below); f32 up to D = 256 takes
// `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, FMA loops (TF32 would
// not hold the f32 checks at 1e-4); either dtype above D = 256 takes
// `flash_bwd_dq_wide_kernel` and `flash_bwd_dkv_wide_kernel`, the FMA
// tiles of csrc/attn_wide.cuh, which take any head dim.
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
// head dim, any: columns d..D are zero and never stored.
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attn_mma.cuh"
#include "attn_wide.cuh"
#include "tma.cuh"
#include "wgmma.cuh"
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

// K3 at a head dim above 256, in f32 or bf16: one block per (32 query
// rows, b*h, 64-column slice of dQ) on the FMA tiles of csrc/attn_wide.cuh.
// Per 32-key tile up to the causal limit: S = Q K^T and dP = dO V^T summed
// over the head dim in 64-column chunks, dS = P (dP - delta) scale with
// P = exp(S scale - lse), rounded to T, then dQ += dS K over the slice.
template <typename T>
__global__ void __launch_bounds__(zoo::wide::kThreads)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, int H, int Tq, int Tk, int d,
                             const Strides s, int causal, float scale) {
  namespace wd = zoo::wide;
  __shared__ float sa[wd::kRows][wd::kPitch], sb[wd::kCols][wd::kPitch];
  __shared__ float sp[wd::kRows][wd::kCols + 1];
  __shared__ float sv[wd::kCols][wd::kSlice];
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * wd::kRows;
  const int row = min(q0 + r, Tq - 1);  // rows past Tq compute, never store
  const float row_lse = lse[(long long)bh * Tq + row];
  const float row_delta = delta[(long long)bh * Tq + row];
  auto qr = [&](int i) -> const T* {
    return q0 + i < Tq ? q + b * s.q[0] + (q0 + i) * s.q[1] + h * s.q[2]
                       : nullptr;
  };
  auto gr = [&](int i) -> const T* {
    return q0 + i < Tq ? g + b * s.g[0] + (q0 + i) * s.g[1] + h * s.g[2]
                       : nullptr;
  };
  const int kend = causal ? min(Tk, q0 + wd::kRows) : Tk;
  for (int sl = blockIdx.z; sl < wd::slices(d); sl += gridDim.z) {
    float acc[wd::kOut];
#pragma unroll
    for (int u = 0; u < wd::kOut; ++u) acc[u] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += wd::kCols) {
      auto kt = [&](int j) -> const T* {
        return k0 + j < Tk ? k + b * s.k[0] + (k0 + j) * s.k[1] + h * s.k[2]
                           : nullptr;
      };
      auto vt = [&](int j) -> const T* {
        return k0 + j < Tk ? v + b * s.v[0] + (k0 + j) * s.v[1] + h * s.v[2]
                           : nullptr;
      };
      float sc[wd::kScores], dp[wd::kScores];
      wd::scores<T>(sc, qr, kt, d, sa, sb);
      wd::scores<T>(dp, gr, vt, d, sa, sb);
#pragma unroll
      for (int u = 0; u < wd::kScores; ++u) {
        const int key = k0 + c + 8 * u;
        const bool ok = key < Tk && (!causal || key <= q0 + r);
        const float p = ok ? expf(sc[u] * scale - row_lse) : 0.f;
        sp[r][c + 8 * u] = wd::round_to<T>(p * (dp[u] - row_delta) * scale);
      }
      wd::stage_slice<T>(sv, kt, sl * wd::kSlice, d);
      __syncthreads();
      wd::accumulate(acc, sp, sv);
    }
    wd::store<T>(dq + (((long long)b * Tq + q0) * H + h) * d,
                 (long long)H * d, min(wd::kRows, Tq - q0), acc, 1.f,
                 sl * wd::kSlice, d);
  }
}

// K4 at a head dim above 256, in f32 or bf16: K3's wide kernel with the
// sequence axes swapped, one block per (32 keys, b*h, 64-column slice of
// dK and dV) walking the 32-query tiles from the causal start: S^T = K Q^T
// and dP^T = V dO^T, P^T and dS^T rounded to T, then dV += P^T dO and
// dK += dS^T Q over the slice.
template <typename T>
__global__ void __launch_bounds__(zoo::wide::kThreads)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ g,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int H,
                              int Tq, int Tk, int d, const Strides s,
                              int causal, float scale) {
  namespace wd = zoo::wide;
  __shared__ float sa[wd::kRows][wd::kPitch], sb[wd::kCols][wd::kPitch];
  __shared__ float sp[wd::kRows][wd::kCols + 1], sd[wd::kRows][wd::kCols + 1];
  __shared__ float sg[wd::kCols][wd::kSlice], sq[wd::kCols][wd::kSlice];
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * wd::kRows;
  auto kr = [&](int i) -> const T* {
    return k0 + i < Tk ? k + b * s.k[0] + (k0 + i) * s.k[1] + h * s.k[2]
                       : nullptr;
  };
  auto vr = [&](int i) -> const T* {
    return k0 + i < Tk ? v + b * s.v[0] + (k0 + i) * s.v[1] + h * s.v[2]
                       : nullptr;
  };
  // causal: query rows before the block's first key see none of its keys
  const int qstart = causal ? min(k0, Tq) : 0;
  const float* lrow = lse + (long long)bh * Tq;
  const float* drow = delta + (long long)bh * Tq;
  for (int sl = blockIdx.z; sl < wd::slices(d); sl += gridDim.z) {
    float dka[wd::kOut], dva[wd::kOut];
#pragma unroll
    for (int u = 0; u < wd::kOut; ++u) {
      dka[u] = 0.f;
      dva[u] = 0.f;
    }
    for (int q0 = qstart; q0 < Tq; q0 += wd::kCols) {
      auto qt = [&](int j) -> const T* {
        return q0 + j < Tq ? q + b * s.q[0] + (q0 + j) * s.q[1] + h * s.q[2]
                           : nullptr;
      };
      auto gt = [&](int j) -> const T* {
        return q0 + j < Tq ? g + b * s.g[0] + (q0 + j) * s.g[1] + h * s.g[2]
                           : nullptr;
      };
      float sc[wd::kScores], dp[wd::kScores];
      wd::scores<T>(sc, kr, qt, d, sa, sb);
      wd::scores<T>(dp, vr, gt, d, sa, sb);
#pragma unroll
      for (int u = 0; u < wd::kScores; ++u) {
        const int query = q0 + c + 8 * u;
        const bool ok = query < Tq && (!causal || k0 + r <= query);
        const float p = ok ? expf(sc[u] * scale - lrow[query]) : 0.f;
        const float ds = ok ? p * (dp[u] - drow[query]) * scale : 0.f;
        sp[r][c + 8 * u] = wd::round_to<T>(p);
        sd[r][c + 8 * u] = wd::round_to<T>(ds);
      }
      wd::stage_slice<T>(sg, gt, sl * wd::kSlice, d);
      wd::stage_slice<T>(sq, qt, sl * wd::kSlice, d);
      __syncthreads();
      wd::accumulate(dva, sp, sg);
      wd::accumulate(dka, sd, sq);
    }
    const long long out = (((long long)b * Tk + k0) * H + h) * d;
    const int rows = min(wd::kRows, Tk - k0);
    wd::store<T>(dk + out, (long long)H * d, rows, dka, 1.f, sl * wd::kSlice,
                 d);
    wd::store<T>(dv + out, (long long)H * d, rows, dva, 1.f, sl * wd::kSlice,
                 d);
  }
}

// The bf16 K3 and K4, designed for Hopper: wgmma fed by TMA.
//
// Replace the same TPU kernels, `_bwd_dq_kernel`
// (analytics_zoo_tpu/ops/flash_attention.py:191) and `_bwd_dkv_kernel`
// (:222), for bf16 inputs.
//
// What bounds them on the H100: at the training micro-batch (B=2, T=2048,
// H=16, D=64, causal) K3's three products (S = Q K^T, dP = dO V^T,
// dQ = dS K) come to ~26 GFLOP and K4's four (S^T = K Q^T, dP^T = V dO^T,
// dV = P^T dO, dK = dS^T Q) to ~34 GFLOP, against ~6-7 MB of inputs and
// outputs: operations at the tensor cores' rate bound them (~26 and
// ~35 us at 989 TFLOP/s), by ~15x over bytes. Only wgmma reaches that
// rate, with its operands in shared memory on time and no issue slots
// spent on copies.
//
// What the design does about it: K1's design (csrc/flash_fwd.cu), with dS
// where K1 has P. Persistent blocks, one an SM, of three warpgroups; the
// work items are (128 rows, b*h, column slice), the rows query rows in K3
// and keys in K4, sorted heaviest first under the causal mask (K3's last
// query tiles, K4's first key tiles) and dealt to the blocks in snake
// order. One thread of the producer warpgroup keeps TMA loads in flight
// (its warpgroup gives its registers to the others with setmaxnreg): the
// item's 128 rows of its two own operands (K3: Q and dO; K4: K and V),
// then the streamed operands' tiles up to the causal limit (K3: K and V
// tiles of BN keys; K4: Q and dO tiles of BN queries from the causal
// start) into a three-stage ring of 128-byte-swizzled tiles, completing
// "full" mbarriers; the consumers' 256 threads complete the "empty" ones.
// Two consumer warpgroups own 64 of the item's rows each:
// - the two score tiles are wgmma m64nBNk16 with both operands in shared
//   memory, K-major (K3: S = Q K^T, dP = dO V^T; K4: S^T = K Q^T,
//   dP^T = V dO^T), D/16 k-steps each;
// - P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP - delta) scale
//   in f32 registers (one FFMA and one MUFU an exponent), rounded to bf16
//   (the JAX kernels' p.astype and ds.astype) into register A operands;
//   the query rows' lse and delta come from global memory once an item in
//   K3, and in K4 with each tile, staged into the ring by a warp of the
//   producer warpgroup that arrives on the tile's "full" mbarrier;
// - the outputs are wgmma m64nDOk16 with A in registers and B read
//   MN-major from the tile the score product read K-major (no transpose
//   copy): K3 dQ += dS K; K4 dV += P^T dO and dK += dS^T Q — K1's P V with
//   V's place taken by K, dO and Q.
// Within a warpgroup the score products of tile j and the output products
// of tile j - 1 are issued together, and the exponentials of tile j run
// while the output products are on the tensor cores; the A operands are
// double-buffered (the loop unrolled by two) since a pending wgmma still
// reads the last ones, and the score registers are fresh each tile and
// masked on reading (only tiles crossing T or the diagonal): a write to a
// register a pending wgmma reads or writes makes ptxas serialize every
// wgmma (C7513). A pair of named barriers makes the two warpgroups take
// turns issuing. A stage is released as soon as its last reader is done
// (K3: V after dP, K after dQ; K4: Q and dO after dV and dK), the item's
// own operands after the last score product, so the next item's load
// overlaps this one's epilogue. Every dQ, dK and dV element is summed by
// one warpgroup in a fixed order and written once, from registers: no
// atomics, the same bits every run. TMA's out-of-bounds fill gives zeros
// for rows past T and columns d..D (D = 64 NB, the 64-column boxes that
// hold d). Up to D = 128 an item owns all of D's output columns; at
// D = 256 two items own 128 each (both compute the score tiles), so K4's
// dK and dV take 128 f32 registers a thread. setmaxnreg gives a consumer
// thread 232 registers and the producer's 40 (24 made the row loader
// warp spill); ptxas then spills nothing at D = 64, and in K4 36 bytes at
// D = 128 and ~300 at D = 256.
constexpr int kBox = zoo::tma::kBox;  // columns a TMA box holds
constexpr int kWgRows = 64;           // rows a consumer warpgroup owns
constexpr int kItemRows = 2 * kWgRows;
constexpr int kWgThreads = 3 * 128;   // two consumer warpgroups, a producer
constexpr int kWgStages = 3;          // stages of the streamed ring

template <int NB, int BN>
struct BwdLayout {
  static constexpr int D = kBox * NB;
  static constexpr int kItem = NB * kItemRows * 128;  // bytes of an item operand
  static constexpr int kTile = NB * BN * 128;         // bytes of a ring tile
  static constexpr int kSmem = 2 * kItem + 2 * kWgStages * kTile;
};

// The work of a block: items it = 0 .. items - 1 are (row tile, unit)
// pairs, unit = (b*h, column slice), numbered heaviest row tile first;
// block `blk` of `nblk` takes items in snake order.
struct BwdItems {
  int blk, nblk, items, units, nbh;
  __device__ __forceinline__ int item(int n) const {
    return zoo::wg::snake_item(n, blk, nblk);
  }
  __device__ __forceinline__ int tile(int it) const { return it / units; }
  __device__ __forceinline__ int bh(int it) const { return it % units % nbh; }
  __device__ __forceinline__ int slice(int it) const {
    return it % units / nbh;
  }
};

// S (or S^T) and dP (or dP^T) of one ring tile: D/16 k-steps each, both
// operands K-major, `a` and `b` at the warpgroup's own rows (`a_rows`
// rows a box) and the tile (BN rows a box)
template <int NB, int BN>
__device__ __forceinline__ void issue_scores(float (&sc)[BN / 2],
                                             float (&dp)[BN / 2],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t b0, uint32_t b1) {
  namespace wg = zoo::wg;
  wg::fence_regs(sc);
  wg::fence_regs(dp);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk) {
    const uint32_t a = (kk >> 2) * kItemRows * 128 + (kk & 3) * 32;
    const uint32_t b = (kk >> 2) * BN * 128 + (kk & 3) * 32;
    wg::Wgmma<BN>::ss(sc, wg::desc(a0 + a, 16, 1024),
                      wg::desc(b0 + b, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk) {
    const uint32_t a = (kk >> 2) * kItemRows * 128 + (kk & 3) * 32;
    const uint32_t b = (kk >> 2) * BN * 128 + (kk & 3) * 32;
    wg::Wgmma<BN>::ss(dp, wg::desc(a1 + a, 16, 1024),
                      wg::desc(b1 + b, 16, 1024), kk > 0);
  }
  wg::commit();
}

// acc += A B over a ring tile of BN rows: A (64 x BN) in registers, B the
// tile's DO columns from `b` (the slice's first box) read MN-major
template <int BN, int DO>
__device__ __forceinline__ void rs_tile(float (&acc)[DO / 2],
                                        const uint32_t (&a)[BN / 16][4],
                                        uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
    zoo::wg::Wgmma<DO>::rs(acc, a[kc],
                           zoo::wg::desc(b + kc * 16 * 128, BN * 128, 1024));
}

// a warpgroup's 64 x DO f32 accumulator rows as bf16 rows of a contiguous
// (rows, H, d) output from `out` (its first row and column); lane rows
// row0 and row0 + 8, rows at or past n and columns at or past `cols` not
// written
template <int DO>
__device__ __forceinline__ void store_acc(const float (&acc)[DO / 2],
                                          __nv_bfloat16* out, long long stride,
                                          int row0, int n, int cols) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= n) continue;
    __nv_bfloat16* o = out + (long long)(row0 + 8 * r) * stride;
#pragma unroll
    for (int n8 = 0; n8 < DO / 8; ++n8)
      if (8 * n8 < cols)
        *reinterpret_cast<uint32_t*>(o + 8 * n8 + 2 * t) = zoo::mma::pack_bf16(
            acc[4 * n8 + 2 * r], acc[4 * n8 + 2 * r + 1]);
  }
}

// A consumer warpgroup of K3: 64 query rows of each item's 128 over the K
// and V tiles the producer streams in (`jt` counts them across items:
// ring stage jt % S, phase (jt / S) & 1).
template <int NB, int BK, int NS>
__device__ __forceinline__ void dq_consume(
    const unsigned char* sq, const unsigned char* sg, const unsigned char* sk,
    const unsigned char* sv, uint64_t* q_full, uint64_t* q_empty,
    uint64_t* k_full, uint64_t* v_full, uint64_t* k_empty, uint64_t* v_empty,
    const BwdItems& work, int nqt, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
    int Tq, int Tk, int d, int causal, float scale) {
  namespace mm = zoo::mma;
  namespace wg = zoo::wg;
  using L = BwdLayout<NB, BK>;
  constexpr int S = kWgStages;
  constexpr int DO = L::D / NS;  // dQ columns an item owns
  wg::set_max_regs_inc<232>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = warp >> 2;  // warpgroup 0 or 1
  const int g = lane >> 2;
  const int t = lane & 3;
  const float sl2 = scale * mm::kLog2e;
  const uint32_t q_addr = wg::smem_u32(sq) + w * kWgRows * 128;
  const uint32_t g_addr = wg::smem_u32(sg) + w * kWgRows * 128;
  int jt0 = 0;  // K/V tiles of the items before this one

  for (int n = 0; work.item(n) < work.items; ++n) {
    const int it = work.item(n);
    const int bh = work.bh(it);
    const int c0 = work.slice(it) * DO;
    const int q0 = (nqt - 1 - work.tile(it)) * kItemRows;
    const int kend = causal ? min(Tk, q0 + kItemRows) : Tk;
    const int nk = (kend + BK - 1) / BK;
    const int wrow = q0 + w * kWgRows + (warp & 3) * 16;  // the warp's rows
    const int row0 = wrow + g;  // this lane's rows: row0, row0 + 8
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool ok = row < Tq;  // rows past Tq compute, never store
      lse2[r] = ok ? lse[(long long)bh * Tq + row] * mm::kLog2e : 0.f;
      dl[r] = ok ? delta[(long long)bh * Tq + row] : 0.f;
    }
    float acc[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) acc[i] = 0.f;
    // dS of two tiles in turn: the one dQ += dS K reads and the one the
    // exponentials write
    uint32_t ds0[BK / 16][4], ds1[BK / 16][4];

    auto issue_sdp = [&](int jt, float (&sc)[BK / 2], float (&dp)[BK / 2]) {
      const int s = jt % S;
      wg::mbar_wait(&k_full[s], (jt / S) & 1);
      wg::mbar_wait(&v_full[s], (jt / S) & 1);
      issue_scores<NB, BK>(sc, dp, q_addr, g_addr,
                           wg::smem_u32(sk) + s * L::kTile,
                           wg::smem_u32(sv) + s * L::kTile);
    };
    auto issue_dq = [&](int jt, const uint32_t (&ds)[BK / 16][4]) {
      wg::fence_regs(acc);
      wg::fence();
      rs_tile<BK, DO>(acc, ds,
                      wg::smem_u32(sk) + (jt % S) * L::kTile +
                          (c0 / kBox) * BK * 128);
      wg::commit();
    };
    // dS of tile j from its S and dP, masked on reading (only a tile that
    // crosses Tk or the diagonal of this warp's rows)
    auto ds_tile = [&](int j, const float (&sc)[BK / 2],
                       const float (&dp)[BK / 2], uint32_t (&dn)[BK / 16][4],
                       auto edge) {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kc + e;
          const int r = (e >> 1) & 1;
          const int key = j * BK + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool hidden = decltype(edge)::value &&
                              (key >= Tk || (causal && key > row0 + 8 * r));
          const float p =
              hidden ? 0.f : mm::ex2(fmaf(sc[i], sl2, -lse2[r]));
          x[e] = p * (dp[i] - dl[r]) * scale;
        }
        dn[kc][0] = mm::pack_bf16(x[0], x[1]);
        dn[kc][1] = mm::pack_bf16(x[2], x[3]);
        dn[kc][2] = mm::pack_bf16(x[4], x[5]);
        dn[kc][3] = mm::pack_bf16(x[6], x[7]);
      }
    };
    auto ds_of = [&](int j, const float (&sc)[BK / 2],
                     const float (&dp)[BK / 2], uint32_t (&dn)[BK / 16][4]) {
      if (j * BK + BK > Tk || (causal && j * BK + BK - 1 > wrow))
        ds_tile(j, sc, dp, dn, std::true_type{});
      else
        ds_tile(j, sc, dp, dn, std::false_type{});
    };
    // tile j: S_j, dP_j and dQ += dS_{j-1} K_{j-1} issued in this
    // warpgroup's turn; dS_j computed while the dQ product runs
    auto step = [&](int j, const uint32_t (&dv)[BK / 16][4],
                    uint32_t (&dn)[BK / 16][4]) {
      float sc[BK / 2], dp[BK / 2];
      wg::bar_sync(1 + w, 256);
      issue_sdp(jt0 + j, sc, dp);
      issue_dq(jt0 + j - 1, dv);
      wg::bar_arrive(2 - w, 256);  // the other warpgroup's turn
      wg::wait<1>();               // S_j and dP_j have landed
      wg::fence_regs(sc);
      wg::fence_regs(dp);
      wg::mbar_arrive(&v_empty[(jt0 + j) % S]);
      ds_of(j, sc, dp, dn);
      wg::wait<0>();  // dQ += dS_{j-1} K_{j-1} too
      wg::fence_regs(acc);
      wg::mbar_arrive(&k_empty[(jt0 + j - 1) % S]);
    };

    wg::mbar_wait(q_full, n & 1);
    // named barrier 1 + w: warpgroup w may issue; warpgroup 0 goes first
    if (w == 1) wg::bar_arrive(1, 256);
    {
      float sc[BK / 2], dp[BK / 2];
      wg::bar_sync(1 + w, 256);
      issue_sdp(jt0, sc, dp);
      wg::bar_arrive(2 - w, 256);
      wg::wait<0>();
      wg::fence_regs(sc);
      wg::fence_regs(dp);
      wg::mbar_arrive(&v_empty[jt0 % S]);
      ds_of(0, sc, dp, ds0);
    }
    for (int j = 1; j < nk; j += 2) {
      step(j, ds0, ds1);
      if (j + 1 < nk) step(j + 1, ds1, ds0);
    }
    // the other warpgroup's arrival after its last turn; then Q and dO,
    // read only by the score products, are free for the next item's load
    if (w == 0) wg::bar_sync(1, 256);
    wg::mbar_arrive(q_empty);
    if ((nk - 1) & 1)
      issue_dq(jt0 + nk - 1, ds1);
    else
      issue_dq(jt0 + nk - 1, ds0);
    wg::wait<0>();
    wg::fence_regs(acc);
    wg::mbar_arrive(&k_empty[(jt0 + nk - 1) % S]);
    jt0 += nk;

    const int b = bh / H;
    const int h = bh % H;
    store_acc<DO>(acc, dq + ((long long)b * Tq * H + h) * d + c0,
                  (long long)H * d, row0, Tq, d - c0);
  }
}

template <int NB, int BK, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int B, int H,
                              int Tq, int Tk, int d, int causal,
                              float scale) {
  namespace wg = zoo::wg;
  using L = BwdLayout<NB, BK>;
  constexpr int S = kWgStages;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t q_full, q_empty, k_full[S], v_full[S], k_empty[S],
      v_empty[S];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  unsigned char* sq = base;             // NB boxes x 128 rows x 128 B
  unsigned char* sg = sq + L::kItem;    // the same for dO
  unsigned char* sk = sg + L::kItem;    // S stages x NB boxes x BK x 128 B
  unsigned char* sv = sk + S * L::kTile;  // the same for V
  const int nqt = (Tq + kItemRows - 1) / kItemRows;
  const BwdItems work{(int)blockIdx.x, (int)gridDim.x, nqt * B * H * NS,
                      B * H * NS, B * H};

  if (threadIdx.x == 0) {
    wg::mbar_init(&q_full, 1);
    wg::mbar_init(&q_empty, 256);
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(&k_full[s], 1);
      wg::mbar_init(&v_full[s], 1);
      wg::mbar_init(&k_empty[s], 256);
      wg::mbar_init(&v_empty[s], 256);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread loads
    wg::set_max_regs_dec<40>();
    if (threadIdx.x == 256) {
      int jt = 0;  // K/V tiles loaded, over the items
      for (int n = 0; work.item(n) < work.items; ++n) {
        const int it = work.item(n);
        const int bh = work.bh(it);
        const int b = bh / H;
        const int h = bh % H;
        const int q0 = (nqt - 1 - work.tile(it)) * kItemRows;
        // causal: keys past the item's last query row are in every row's
        // future
        const int kend = causal ? min(Tk, q0 + kItemRows) : Tk;
        const int nk = (kend + BK - 1) / BK;
        if (n > 0) wg::mbar_wait(&q_empty, (n - 1) & 1);
        wg::mbar_expect_tx(&q_full, 2 * L::kItem);
        for (int nb = 0; nb < NB; ++nb) {
          wg::tma_load_4d(sq + nb * kItemRows * 128, &tq, &q_full, nb * kBox,
                          h, q0, b);
          wg::tma_load_4d(sg + nb * kItemRows * 128, &tg, &q_full, nb * kBox,
                          h, q0, b);
        }
        for (int j = 0; j < nk; ++j, ++jt) {
          const int s = jt % S;
          // V's stage is released first (after dP), K's after dQ
          if (jt >= S) wg::mbar_wait(&v_empty[s], (jt / S - 1) & 1);
          wg::mbar_expect_tx(&v_full[s], L::kTile);
          for (int nb = 0; nb < NB; ++nb)
            wg::tma_load_4d(sv + s * L::kTile + nb * BK * 128, &tv,
                            &v_full[s], nb * kBox, h, j * BK, b);
          if (jt >= S) wg::mbar_wait(&k_empty[s], (jt / S - 1) & 1);
          wg::mbar_expect_tx(&k_full[s], L::kTile);
          for (int nb = 0; nb < NB; ++nb)
            wg::tma_load_4d(sk + s * L::kTile + nb * BK * 128, &tk,
                            &k_full[s], nb * kBox, h, j * BK, b);
        }
      }
    }
  } else {
    dq_consume<NB, BK, NS>(sq, sg, sk, sv, &q_full, &q_empty, k_full, v_full,
                           k_empty, v_empty, work, nqt, lse, delta, dq, H, Tq,
                           Tk, d, causal, scale);
  }
}

// A consumer warpgroup of K4: 64 keys of each item's 128 over the Q and dO
// tiles the producer streams in from the causal start (`jt` counts them
// across items, `nl` the items that loaded K and V).
template <int NB, int BQ, int NS>
__device__ __forceinline__ void dkv_consume(
    const unsigned char* sk, const unsigned char* sv, const unsigned char* sq,
    const unsigned char* sg, const float* srows, uint64_t* kv_full,
    uint64_t* kv_empty, uint64_t* t_full, uint64_t* t_empty,
    const BwdItems& work, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int Tq, int Tk, int d, int causal, float scale) {
  namespace mm = zoo::mma;
  namespace wg = zoo::wg;
  using L = BwdLayout<NB, BQ>;
  constexpr int S = kWgStages;
  constexpr int DO = L::D / NS;  // dK/dV columns an item owns
  wg::set_max_regs_inc<232>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = warp >> 2;  // warpgroup 0 or 1
  const int g = lane >> 2;
  const int t = lane & 3;
  const float sl2 = scale * mm::kLog2e;
  const uint32_t k_addr = wg::smem_u32(sk) + w * kWgRows * 128;
  const uint32_t v_addr = wg::smem_u32(sv) + w * kWgRows * 128;
  int jt0 = 0;  // Q/dO tiles of the items before this one
  int nl = 0;   // items before this one that loaded K and V

  for (int n = 0; work.item(n) < work.items; ++n) {
    const int it = work.item(n);
    const int bh = work.bh(it);
    const int c0 = work.slice(it) * DO;
    const int k0 = work.tile(it) * kItemRows;
    // causal: query rows before the item's first key see none of its keys
    const int qstart = causal ? min(k0, Tq) : 0;
    const int nq = (Tq - qstart + BQ - 1) / BQ;
    const int wkey = k0 + w * kWgRows + (warp & 3) * 16;  // the warp's keys
    const int key0 = wkey + g;  // this lane's keys: key0, key0 + 8
    float dka[DO / 2], dva[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) {
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
    if (nq > 0) {
      // P^T and dS^T of two tiles in turn: the ones dV and dK read and the
      // ones the exponentials write
      uint32_t pa0[BQ / 16][4], da0[BQ / 16][4], pa1[BQ / 16][4],
          da1[BQ / 16][4];

      auto issue_s = [&](int jt, float (&sc)[BQ / 2], float (&dp)[BQ / 2]) {
        const int s = jt % S;
        wg::mbar_wait(&t_full[s], (jt / S) & 1);
        issue_scores<NB, BQ>(sc, dp, k_addr, v_addr,
                             wg::smem_u32(sq) + s * L::kTile,
                             wg::smem_u32(sg) + s * L::kTile);
      };
      auto issue_dkv = [&](int jt, const uint32_t (&pa)[BQ / 16][4],
                           const uint32_t (&da)[BQ / 16][4]) {
        const uint32_t col = (jt % S) * L::kTile + (c0 / kBox) * BQ * 128;
        wg::fence_regs(dva);
        wg::fence_regs(dka);
        wg::fence();
        rs_tile<BQ, DO>(dva, pa, wg::smem_u32(sg) + col);
        rs_tile<BQ, DO>(dka, da, wg::smem_u32(sq) + col);
        wg::commit();
      };
      // P^T and dS^T of tile j, masked on reading (only a tile that
      // crosses Tq or the diagonal of this warp's keys); the query rows'
      // lse (times log2(e)) and delta are the stage's `rows`
      auto p_tile = [&](int j, const float (&sc)[BQ / 2],
                        const float (&dp)[BQ / 2], const float* rows,
                        uint32_t (&pn)[BQ / 16][4],
                        uint32_t (&dn)[BQ / 16][4], auto edge) {
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          float p[8], x[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = 8 * kc + e;
            const int col = 8 * (i >> 2) + 2 * t + (i & 1);
            const int query = qstart + j * BQ + col;
            const int key = key0 + 8 * ((i >> 1) & 1);
            const bool hidden = decltype(edge)::value &&
                                (query >= Tq || (causal && key > query));
            p[e] = hidden ? 0.f : mm::ex2(fmaf(sc[i], sl2, -rows[col]));
            x[e] = p[e] * (dp[i] - rows[BQ + col]) * scale;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pn[kc][e] = mm::pack_bf16(p[2 * e], p[2 * e + 1]);
            dn[kc][e] = mm::pack_bf16(x[2 * e], x[2 * e + 1]);
          }
        }
      };
      auto p_of = [&](int j, const float (&sc)[BQ / 2],
                      const float (&dp)[BQ / 2], uint32_t (&pn)[BQ / 16][4],
                      uint32_t (&dn)[BQ / 16][4]) {
        const int q0 = qstart + j * BQ;
        const float* rows = srows + (jt0 + j) % S * 2 * BQ;
        if (q0 + BQ > Tq || (causal && wkey + 15 > q0))
          p_tile(j, sc, dp, rows, pn, dn, std::true_type{});
        else
          p_tile(j, sc, dp, rows, pn, dn, std::false_type{});
      };
      // tile j: S^T_j, dP^T_j and tile j - 1's dV and dK products issued
      // in this warpgroup's turn; P^T_j and dS^T_j computed while the
      // products run
      auto step = [&](int j, const uint32_t (&pv)[BQ / 16][4],
                      const uint32_t (&dv_)[BQ / 16][4],
                      uint32_t (&pn)[BQ / 16][4],
                      uint32_t (&dn)[BQ / 16][4]) {
        float sc[BQ / 2], dp[BQ / 2];
        wg::bar_sync(1 + w, 256);
        issue_s(jt0 + j, sc, dp);
        issue_dkv(jt0 + j - 1, pv, dv_);
        wg::bar_arrive(2 - w, 256);  // the other warpgroup's turn
        wg::wait<1>();  // S^T_j and dP^T_j have landed
        wg::fence_regs(sc);
        wg::fence_regs(dp);
        p_of(j, sc, dp, pn, dn);
        wg::wait<0>();  // tile j - 1's dV and dK too
        wg::fence_regs(dva);
        wg::fence_regs(dka);
        wg::mbar_arrive(&t_empty[(jt0 + j - 1) % S]);
      };

      wg::mbar_wait(kv_full, nl & 1);
      // named barrier 1 + w: warpgroup w may issue; warpgroup 0 goes first
      if (w == 1) wg::bar_arrive(1, 256);
      {
        float sc[BQ / 2], dp[BQ / 2];
        wg::bar_sync(1 + w, 256);
        issue_s(jt0, sc, dp);
        wg::bar_arrive(2 - w, 256);
        wg::wait<0>();
        wg::fence_regs(sc);
        wg::fence_regs(dp);
        p_of(0, sc, dp, pa0, da0);
      }
      for (int j = 1; j < nq; j += 2) {
        step(j, pa0, da0, pa1, da1);
        if (j + 1 < nq) step(j + 1, pa1, da1, pa0, da0);
      }
      // the other warpgroup's arrival after its last turn; then K and V,
      // read only by the score products, are free for the next item's
      // load, which overlaps the last products and the epilogue
      if (w == 0) wg::bar_sync(1, 256);
      wg::mbar_arrive(kv_empty);
      if ((nq - 1) & 1)
        issue_dkv(jt0 + nq - 1, pa1, da1);
      else
        issue_dkv(jt0 + nq - 1, pa0, da0);
      wg::wait<0>();
      wg::fence_regs(dva);
      wg::fence_regs(dka);
      wg::mbar_arrive(&t_empty[(jt0 + nq - 1) % S]);
      jt0 += nq;
      ++nl;
    }

    // keys no query sees (causal, past Tq) get zeros
    const int b = bh / H;
    const int h = bh % H;
    const long long out = ((long long)b * Tk * H + h) * d + c0;
    store_acc<DO>(dka, dk + out, (long long)H * d, key0, Tk, d - c0);
    store_acc<DO>(dva, dv + out, (long long)H * d, key0, Tk, d - c0);
  }
}

template <int NB, int BQ, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int B, int H,
                               int Tq, int Tk, int d, int causal,
                               float scale) {
  namespace wg = zoo::wg;
  using L = BwdLayout<NB, BQ>;
  constexpr int S = kWgStages;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t kv_full, kv_empty, t_full[S], t_empty[S];
  // each stage's query rows: lse times log2(e), then delta
  __shared__ float srows[S][2 * BQ];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  unsigned char* sk = base;             // NB boxes x 128 rows x 128 B
  unsigned char* sv = sk + L::kItem;    // the same for V
  unsigned char* sq = sv + L::kItem;    // S stages x NB boxes x BQ x 128 B
  unsigned char* sg = sq + S * L::kTile;  // the same for dO
  const int nkt = (Tk + kItemRows - 1) / kItemRows;
  const BwdItems work{(int)blockIdx.x, (int)gridDim.x, nkt * B * H * NS,
                      B * H * NS, B * H};

  if (threadIdx.x == 0) {
    wg::mbar_init(&kv_full, 1);
    wg::mbar_init(&kv_empty, 256);
    for (int s = 0; s < S; ++s) {
      // the TMA thread's arrival and the row loader warp's 32
      wg::mbar_init(&t_full[s], 1 + 32);
      wg::mbar_init(&t_empty[s], 256);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread loads,
    wg::set_max_regs_dec<40>();  // one warp stages the rows' lse and delta
    if (threadIdx.x >= 288 && threadIdx.x < 320) {
      const int lane = threadIdx.x & 31;
      int jt = 0;
      for (int n = 0; work.item(n) < work.items; ++n) {
        const int it = work.item(n);
        const long long row0 = (long long)work.bh(it) * Tq;
        const int k0 = work.tile(it) * kItemRows;
        const int qstart = causal ? min(k0, Tq) : 0;
        const int nq = (Tq - qstart + BQ - 1) / BQ;
        for (int j = 0; j < nq; ++j, ++jt) {
          const int s = jt % S;
          if (jt >= S) wg::mbar_wait(&t_empty[s], (jt / S - 1) & 1);
          for (int i = lane; i < BQ; i += 32) {
            const int query = qstart + j * BQ + i;
            const bool ok = query < Tq;
            srows[s][i] = ok ? lse[row0 + query] * zoo::mma::kLog2e : 0.f;
            srows[s][BQ + i] = ok ? delta[row0 + query] : 0.f;
          }
          wg::mbar_arrive(&t_full[s]);
        }
      }
    } else if (threadIdx.x == 256) {
      int jt = 0;  // Q/dO tiles loaded, over the items
      int nl = 0;  // items whose K and V were loaded
      for (int n = 0; work.item(n) < work.items; ++n) {
        const int it = work.item(n);
        const int bh = work.bh(it);
        const int b = bh / H;
        const int h = bh % H;
        const int k0 = work.tile(it) * kItemRows;
        const int qstart = causal ? min(k0, Tq) : 0;
        const int nq = (Tq - qstart + BQ - 1) / BQ;
        if (nq == 0) continue;  // no query sees these keys
        if (nl > 0) wg::mbar_wait(&kv_empty, (nl - 1) & 1);
        ++nl;
        wg::mbar_expect_tx(&kv_full, 2 * L::kItem);
        for (int nb = 0; nb < NB; ++nb) {
          wg::tma_load_4d(sk + nb * kItemRows * 128, &tk, &kv_full, nb * kBox,
                          h, k0, b);
          wg::tma_load_4d(sv + nb * kItemRows * 128, &tv, &kv_full, nb * kBox,
                          h, k0, b);
        }
        for (int j = 0; j < nq; ++j, ++jt) {
          const int s = jt % S;
          if (jt >= S) wg::mbar_wait(&t_empty[s], (jt / S - 1) & 1);
          wg::mbar_expect_tx(&t_full[s], 2 * L::kTile);
          for (int nb = 0; nb < NB; ++nb) {
            wg::tma_load_4d(sq + s * L::kTile + nb * BQ * 128, &tq,
                            &t_full[s], nb * kBox, h, qstart + j * BQ, b);
            wg::tma_load_4d(sg + s * L::kTile + nb * BQ * 128, &tg,
                            &t_full[s], nb * kBox, h, qstart + j * BQ, b);
          }
        }
      }
    }
  } else {
    dkv_consume<NB, BQ, NS>(sk, sv, sq, sg, &srows[0][0], &kv_full,
                            &kv_empty, t_full, t_empty, work, dk, dv, H, Tq,
                            Tk, d, causal, scale);
  }
}

// the 4-D maps of q, k, v and dO, boxes of `item` rows for the item's own
// operands and `tile` rows for the streamed ones
bool encode_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                 const void* v, const void* g, int B, int H, int Tq, int Tk,
                 int d, const Strides& s, int q_rows, int k_rows) {
  namespace tma = zoo::tma;
  return tma::cached_operand(&m[0], q, B, H, Tq, d, s.q[0], s.q[1], s.q[2],
                             q_rows) &&
         tma::cached_operand(&m[1], k, B, H, Tk, d, s.k[0], s.k[1], s.k[2],
                             k_rows) &&
         tma::cached_operand(&m[2], v, B, H, Tk, d, s.v[0], s.v[1], s.v[2],
                             k_rows) &&
         tma::cached_operand(&m[3], g, B, H, Tq, d, s.g[0], s.g[1], s.g[2],
                             q_rows);
}

template <int NB, int BK, int NS>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    void* dq, int B, int H, int Tq, int Tk, int d,
                    const Strides& s, int causal, float scale,
                    cudaStream_t stream) {
  constexpr int smem = BwdLayout<NB, BK>::kSmem + 1024;
  CUtensorMap m[4];
  if (!encode_maps(m, q, k, v, g, B, H, Tq, Tk, d, s, kItemRows, BK))
    return zoo::tma::kErrTensorMap;
  static std::atomic<uint64_t> granted{0};
  cudaError_t err = zoo::mma::grant_smem(
      flash_bwd_dq_wgmma_kernel<NB, BK, NS>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int grid = zoo::tma::persistent_grid(
      (long long)B * H * NS * ((Tq + kItemRows - 1) / kItemRows), &err);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_wgmma_kernel<NB, BK, NS><<<grid, kWgThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), B, H,
      Tq, Tk, d, causal, scale);
  return (int)cudaGetLastError();
}

template <int NB, int BQ, int NS>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* g, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int Tq, int Tk, int d,
                     const Strides& s, int causal, float scale,
                     cudaStream_t stream) {
  constexpr int smem = BwdLayout<NB, BQ>::kSmem + 1024;
  CUtensorMap m[4];
  if (!encode_maps(m, q, k, v, g, B, H, Tq, Tk, d, s, BQ, kItemRows))
    return zoo::tma::kErrTensorMap;
  static std::atomic<uint64_t> granted{0};
  cudaError_t err = zoo::mma::grant_smem(
      flash_bwd_dkv_wgmma_kernel<NB, BQ, NS>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int grid = zoo::tma::persistent_grid(
      (long long)B * H * NS * ((Tk + kItemRows - 1) / kItemRows), &err);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_wgmma_kernel<NB, BQ, NS><<<grid, kWgThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, H, Tq, Tk, d, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* delta, void* dq, int B, int H,
                   int Tq, int Tk, int d, const Strides& s, int causal,
                   float scale, cudaStream_t stream) {
  namespace wd = zoo::wide;
  dim3 grid((Tq + wd::kRows - 1) / wd::kRows, B * H,
            min(wd::slices(d), 65535));
  flash_bwd_dq_wide_kernel<T><<<grid, wd::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Tq, Tk, d, s, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv_wide(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Tq, int Tk, int d,
                    const Strides& s, int causal, float scale,
                    cudaStream_t stream) {
  namespace wd = zoo::wide;
  dim3 grid((Tk + wd::kRows - 1) / wd::kRows, B * H,
            min(wd::slices(d), 65535));
  flash_bwd_dkv_wide_kernel<T><<<grid, wd::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, d, s, causal,
      scale);
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
// (B, Tk, H, D) tensors in the storage dtype. D is any head dim from 1: up
// to 256, f32 runs on the smallest compile-time tile of 32, 64, 128 or 256
// columns that holds it and bf16, at a multiple of 8 (the wrapper pads
// other head dims), on the wgmma kernels (64, 128 or 256 columns); above
// 256 both run the wide kernels. bf16 q, k, v and dO up to 256 must start
// 16-byte aligned with strides of multiples of 8 elements (the wrapper
// checks: TMA's tensor maps take no other). Each entry returns
// cudaGetLastError() after its launch, cudaErrorInvalidValue for a
// dtype/head dim it does not take, or zoo::tma::kErrTensorMap when a
// tensor map cannot be encoded.
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
  if (Tq < 1 || Tk < 1 || B < 1 || H < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
#define ZOO_DQ(F, ...) F<__VA_ARGS__>(q, k, v, g, lse, delta, dq, B, H, Tq, Tk, D, s, causal, scale, st)
  if (D > 256)
    return dtype == zoo::kBF16 ? ZOO_DQ(launch_dq_wide, __nv_bfloat16)
           : dtype == zoo::kF32 ? ZOO_DQ(launch_dq_wide, float)
                                : (int)cudaErrorInvalidValue;
  if (dtype == zoo::kBF16 && D % 8 == 0)
    return D <= 64    ? ZOO_DQ(launch_dq_wgmma, 1, 64, 1)
           : D <= 128 ? ZOO_DQ(launch_dq_wgmma, 2, 64, 1)
                      : ZOO_DQ(launch_dq_wgmma, 4, 32, 2);
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
  if (Tq < 1 || Tk < 1 || B < 1 || H < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
#define ZOO_DKV(F, ...) F<__VA_ARGS__>(q, k, v, g, lse, delta, dk, dv, B, H, Tq, Tk, D, s, causal, scale, st)
  if (D > 256)
    return dtype == zoo::kBF16 ? ZOO_DKV(launch_dkv_wide, __nv_bfloat16)
           : dtype == zoo::kF32 ? ZOO_DKV(launch_dkv_wide, float)
                                : (int)cudaErrorInvalidValue;
  if (dtype == zoo::kBF16 && D % 8 == 0)
    return D <= 64    ? ZOO_DKV(launch_dkv_wgmma, 1, 64, 1)
           : D <= 128 ? ZOO_DKV(launch_dkv_wgmma, 2, 32, 1)
                      : ZOO_DKV(launch_dkv_wgmma, 4, 32, 2);
  if (dtype == zoo::kF32)
    return D <= 32    ? ZOO_DKV(launch_dkv, 32)
           : D <= 64  ? ZOO_DKV(launch_dkv, 64)
           : D <= 128 ? ZOO_DKV(launch_dkv, 128)
                      : ZOO_DKV(launch_dkv, 256);
#undef ZOO_DKV
  return (int)cudaErrorInvalidValue;
}
