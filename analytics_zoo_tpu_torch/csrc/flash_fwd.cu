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
// Three kernels, chosen by dtype and head dim in `zoo_flash_fwd`:
// - bf16 up to D = 256: `flash_fwd_wgmma_kernel`, on wgmma fed by TMA (its
//   note is below);
// - f32 up to D = 256: `flash_fwd_kernel`, f32 FMA loops. On the tensor
//   cores f32 would run as TF32, about three decimal digits, which the f32
//   checks against the plain version (1e-4) cannot take; f32 is neither
//   the training nor the serving dtype;
// - either dtype above D = 256: `flash_fwd_wide_kernel`, the FMA tiles of
//   csrc/attn_wide.cuh, which take any head dim.
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "attn_wide.cuh"
#include "tma.cuh"
#include "wgmma.cuh"
#include "zoo_cuda.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kThreads = 2 * kBQ;  // two threads per query row
// keys per shared-memory tile: two (keys, D) f32 tiles stay under the 48 KB
// of static shared memory
template <int D>
constexpr int kBK = D <= 128 ? 32 : 16;

// The f32 kernel, written "correct first". Two threads own one query row,
// each holding the interleaved half of the q row and of the f32 accumulator
// in registers (element d = 2*i + half), so a score is two half dots joined
// by one shuffle. K/V tiles of 32 keys are staged in shared memory with
// coalesced loads; the online softmax (m, l, acc) stays in f32; K tiles
// wholly in the future of the Q tile are never loaded under the causal
// mask; keys past Tk and rows past Tq are masked inside the kernel. D is
// the compile-time tile (32, 64, 128 or 256) and d <= D the head dim:
// columns d..D are zero and never stored.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk, int d,
                     long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh, int causal,
                     float scale) {
  constexpr int DH = D / 2;
  constexpr int BK = kBK<D>;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

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
      qr[i] = 2 * i + half < d ? qrow[2 * i + half] : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = zoo::kNegInf;
  float l = 0.f;

  const float* kbase = k + b * ksb + h * ksh;
  const float* vbase = v + b * vsb + h * vsh;
  // causal: keys past the tile's last query row are in every row's future
  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Tk && c < d) {
        kv = kbase[(long long)kp * kst + c];
        vv = vbase[(long long)kp * vst + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[BK];
    float tile_max = zoo::kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
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
    for (int j = 0; j < BK; ++j) {
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
      for (int j = 0; j < BK; ++j) a = fmaf(s[j], vs[j][2 * i + half], a);
      acc[i] = a;
    }
    m = m_new;
  }

  if (active) {
    const float safe_l = l == 0.f ? 1.f : l;
    float* orow = o + (((long long)b * Tq + qpos) * H + h) * d;
#pragma unroll
    for (int i = 0; i < DH; ++i)
      if (2 * i + half < d) orow[2 * i + half] = acc[i] / safe_l;
    if (half == 0) lse[(long long)bh * Tq + qpos] = m + logf(safe_l);
  }
}

// The bf16 kernel, redesigned for Hopper: wgmma fed by TMA.
//
// Replaces the same TPU kernel, `_fwd_kernel`
// (analytics_zoo_tpu/ops/flash_attention.py:46), for bf16 inputs.
//
// What bounds it on the H100: at the serving prefill (B=1, T=1024, H=16,
// D=64, causal) the bound is bytes, ~8.5 MB in ~2.5 us, below what a
// launch itself costs; at the training micro-batch (B=2, T=2048) it is the
// ~17 GFLOP of the two products, ~17 us at 989 TFLOP/s. Only wgmma reaches
// that rate (mma.sync, the previous design, cannot), and it needs its
// operands in shared memory on time without the warps spending issue
// slots on copies.
//
// What the design does about it: persistent blocks, one an SM, of three
// warpgroups. The work items are (128 query rows, b*h), the query tiles in
// reverse so the longest causal walks of every head start first, dealt to
// the blocks in snake order. One thread of the producer warpgroup keeps
// TMA loads in flight (its warpgroup gives its registers to the others
// with setmaxnreg): an item's Q, then its K and V tiles of BK keys up to
// the causal limit into a two-stage ring of 128-byte-swizzled tiles. Each
// stage has "full" mbarriers for K and for V, which the TMA transactions
// complete, and "empty" ones for K and for V, which the consumers' 256
// threads complete: K as soon as S has read it, V after P V, so the next K
// streams in while this tile's P V runs; the next item's Q loads under
// this item's epilogue. Two consumer warpgroups own 64 query rows each:
// S = Q K^T is wgmma m64nBKk16 with both operands in shared memory (D/16
// k-steps); P, rounded to bf16 in registers (the JAX kernel's
// p.astype(v.dtype)), is the A operand of O += P V, wgmma m64nDk16 with V
// read MN-major from its tile (no transpose copy). Within a warpgroup,
// S(j) and P(j-1) V(j-1) are issued together and the online softmax of
// S(j) (f32, the exponent one FFMA and one MUFU an element, l summing the
// unrounded e) runs while P V is on the tensor cores; across the two
// warpgroups a pair of named barriers makes them take turns issuing, so
// one's exponentials overlap the other's products. ptxas serializes every
// wgmma (C7513) if a register a pending wgmma reads or writes is also
// written by another instruction; so the scores are fresh registers each
// tile, masked on reading (only tiles crossing Tk or the diagonal), and P
// is double-buffered (the loop unrolled by two), never copied. TMA's
// out-of-bounds fill gives zeros for rows past Tq/Tk and for columns
// d..D (D = 64, 128 or 256, the 64-column boxes that hold d), so any head
// dim that is a multiple of 8 and any T need no masking of the loads. O / l
// goes out in bf16 from registers, the LSE in f32. D = 64 and 128 take
// BK = 128 (80 and 160 KB of shared memory), D = 256 BK = 32 (128 KB),
// which keeps the 240 registers a consumer thread has free of spills.
// Next: three consumer warpgroups (192 rows) at D = 64, exponentials
// partly on the FMA pipes, a TMA store of O.
constexpr int kWgRows = 64;                 // query rows a warpgroup owns
constexpr int kWgBlockRows = 2 * kWgRows;   // query rows a block owns
constexpr int kWgThreads = 3 * 128;  // two consumer warpgroups, a producer
constexpr int kBox = zoo::tma::kBox;        // columns a TMA box holds
constexpr int kWgStages = 2;                // stages of the K/V ring

template <int NB, int BK>
struct WgLayout {
  static constexpr int D = kBox * NB;
  static constexpr int kQ = NB * kWgBlockRows * 128;  // bytes of Q
  static constexpr int kKV = NB * BK * 128;           // bytes of a K/V tile
  static constexpr int kSmem = kQ + 2 * kWgStages * kKV;
};

// The work of a block of flash_fwd_wgmma_kernel: items i = 0 .. items - 1
// are (Q tile, b*h) pairs, the Q tiles in reverse (the longest causal walks
// first, over every head); block `blk` of `nblk` takes items in snake
// order (blk, 2 nblk - 1 - blk, 2 nblk + blk, ...), which evens out the
// blocks' work.
struct WgItems {
  int blk, nblk, items, bhs, nqt;
  __device__ __forceinline__ int item(int n) const {
    return zoo::wg::snake_item(n, blk, nblk);
  }
  __device__ __forceinline__ int bh(int it) const { return it % bhs; }
  __device__ __forceinline__ int q0(int it) const {
    return (nqt - 1 - it / bhs) * kWgBlockRows;
  }
};

// A consumer warpgroup of flash_fwd_wgmma_kernel: 64 query rows of each
// item's 128, over the K/V tiles the producer streams in (`jt` counts
// them across items: ring stage jt % S, phase (jt / S) & 1).
template <int NB, int BK>
__device__ __forceinline__ void consume(
    const unsigned char* sq, const unsigned char* sk, const unsigned char* sv,
    uint64_t* q_full, uint64_t* q_empty, uint64_t* k_full, uint64_t* v_full,
    uint64_t* k_empty, uint64_t* v_empty, const WgItems& work,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Tq,
    int Tk, int d, int causal, float scale) {
  namespace mm = zoo::mma;
  namespace wg = zoo::wg;
  using L = WgLayout<NB, BK>;
  constexpr int S = kWgStages;
  constexpr int D = L::D;
  wg::set_max_regs_inc<240>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = warp >> 2;  // warpgroup 0 or 1
  const int g = lane >> 2;
  const int t = lane & 3;
  const float sl2 = scale * mm::kLog2e;
  const float ninf = mm::neg_inf();
  const uint32_t q_addr = wg::smem_u32(sq) + w * kWgRows * 128;
  int jt0 = 0;  // K/V tiles of the items before this one

  for (int n = 0; work.item(n) < work.items; ++n) {
    const int item = work.item(n);
    const int bh = work.bh(item);
    const int q0 = work.q0(item);
    const int kend = causal ? min(Tk, q0 + kWgBlockRows) : Tk;
    const int nk = (kend + BK - 1) / BK;
    const int wrow = q0 + w * kWgRows + (warp & 3) * 16;  // the warp's rows
    const int row0 = wrow + g;  // this lane's rows: row0, row0 + 8

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {ninf, ninf};  // running row max of the raw scores
    float l[2] = {0.f, 0.f};    // this lane's part of the row sum
    // P of two tiles in turn: the one P V reads and the one the softmax
    // writes (a copy from one to the other makes ptxas serialize, C7513)
    uint32_t pa0[BK / 16][4], pa1[BK / 16][4];

    // S = Q K^T of tile j (ring index jt) into sc, fresh each tile: D/16
    // k-steps, both operands K-major
    auto issue_s = [&](int jt, float (&sc)[BK / 2]) {
      const int s = jt % S;
      wg::mbar_wait(&k_full[s], (jt / S) & 1);
      const uint32_t k_addr = wg::smem_u32(sk) + s * L::kKV;
      wg::fence_regs(sc);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // a k16 step in the box
        wg::Wgmma<BK>::ss(
            sc,
            wg::desc(q_addr + (kk >> 2) * kWgBlockRows * 128 + off, 16,
                     1024),
            wg::desc(k_addr + (kk >> 2) * BK * 128 + off, 16, 1024),
            kk > 0);
      }
      wg::commit();
    };
    // O += P V of ring tile jt, V MN-major: 16 keys a k-step, the next 64
    // columns one box on
    auto issue_pv = [&](int jt, const uint32_t (&pa)[BK / 16][4]) {
      const int s = jt % S;
      wg::mbar_wait(&v_full[s], (jt / S) & 1);
      const uint32_t v_addr = wg::smem_u32(sv) + s * L::kKV;
      wg::fence_regs(acc);
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wg::Wgmma<D>::rs(acc, pa[kc],
                         wg::desc(v_addr + kc * 16 * 128, BK * 128, 1024));
      wg::commit();
    };
    // the online softmax of tile j's scores in sc: the new row max, the
    // factor corr for what O and l hold, and P rounded to bf16 into pn.
    // exp2(s scale log2(e) - m scale log2(e)) is one FFMA and one MUFU an
    // element. Only a tile that crosses Tk or the diagonal of this warp's
    // rows is masked, and sc is only read: a write to it while P V is in
    // flight makes ptxas serialize every wgmma (C7513)
    auto softmax_tile = [&](int j, const float (&sc)[BK / 2],
                            uint32_t (&pn)[BK / 16][4], float (&corr)[2],
                            auto edge) {
      const int k0 = j * BK;
      auto hidden = [&](int i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        return decltype(edge)::value &&
               (key >= Tk || (causal && key > row));
      };
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], hidden(i) ? ninf : sc[i]);
      float nb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = mm::quad_max(mx[r]);
        // a row with no visible key yet keeps its sums at 0
        const float base = mx[r] == ninf ? 0.f : mx[r] * sl2;
        corr[r] = mm::ex2(m[r] * sl2 - base);
        nb[r] = -base;
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = hidden(8 * kc + e)
                     ? 0.f
                     : mm::ex2(fmaf(sc[8 * kc + e], sl2, nb[(e >> 1) & 1]));
          l[(e >> 1) & 1] += p[e];
        }
        // keys 16 kc .. 16 kc + 15 (n8 blocks 2 kc, 2 kc + 1): the A
        // fragment of one k16 step of P V
        pn[kc][0] = mm::pack_bf16(p[0], p[1]);
        pn[kc][1] = mm::pack_bf16(p[2], p[3]);
        pn[kc][2] = mm::pack_bf16(p[4], p[5]);
        pn[kc][3] = mm::pack_bf16(p[6], p[7]);
      }
    };
    auto softmax = [&](int j, const float (&sc)[BK / 2],
                       uint32_t (&pn)[BK / 16][4], float (&corr)[2]) {
      if (j * BK + BK > Tk || (causal && j * BK + BK - 1 > wrow))
        softmax_tile(j, sc, pn, corr, std::true_type{});
      else
        softmax_tile(j, sc, pn, corr, std::false_type{});
    };
    // tile j: S_j and P_{j-1} V_{j-1} issued in this warpgroup's turn;
    // the softmax of S_j runs while P_{j-1} V_{j-1} is on the tensor cores
    // (and the other warpgroup's products after it)
    auto step = [&](int j, const uint32_t (&pv)[BK / 16][4],
                    uint32_t (&pn)[BK / 16][4]) {
      float sc[BK / 2], corr[2];
      wg::bar_sync(1 + w, 256);
      issue_s(jt0 + j, sc);
      issue_pv(jt0 + j - 1, pv);
      wg::bar_arrive(2 - w, 256);  // the other warpgroup's turn
      wg::wait<1>();               // S_j has landed
      wg::fence_regs(sc);
      wg::mbar_arrive(&k_empty[(jt0 + j) % S]);
      softmax(j, sc, pn, corr);
      wg::wait<0>();               // P_{j-1} V_{j-1} too
      wg::fence_regs(acc);
      wg::mbar_arrive(&v_empty[(jt0 + j - 1) % S]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    };

    wg::mbar_wait(q_full, n & 1);
    // named barrier 1 + w: warpgroup w may issue its S product; warpgroup
    // 0 goes first. (Past q_full: warpgroup 0 has ended the last item.)
    if (w == 1) wg::bar_arrive(1, 256);
    {  // tile 0: S in this warpgroup's turn, then its softmax
      float sc[BK / 2], corr[2];
      wg::bar_sync(1 + w, 256);
      issue_s(jt0, sc);
      wg::bar_arrive(2 - w, 256);
      wg::wait<0>();
      wg::fence_regs(sc);
      wg::mbar_arrive(&k_empty[jt0 % S]);
      softmax(0, sc, pa0, corr);
    }
    for (int j = 1; j < nk; j += 2) {
      step(j, pa0, pa1);
      if (j + 1 < nk) step(j + 1, pa1, pa0);
    }
    if ((nk - 1) & 1)
      issue_pv(jt0 + nk - 1, pa1);
    else
      issue_pv(jt0 + nk - 1, pa0);
    wg::wait<0>();
    wg::fence_regs(acc);
    wg::mbar_arrive(&v_empty[(jt0 + nk - 1) % S]);
    // the other warpgroup's arrival after its last S product; then Q is
    // free for the next item's load, which overlaps this epilogue
    if (w == 0) wg::bar_sync(1, 256);
    wg::mbar_arrive(q_empty);
    jt0 += nk;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = mm::quad_sum(l[r]);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    const int b = bh / H;
    const int h = bh % H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Tq) continue;
      __nv_bfloat16* orow = o + (((long long)b * Tq + row) * H + h) * d;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        if (8 * n8 < d)
          *reinterpret_cast<uint32_t*>(orow + 8 * n8 + 2 * t) =
              mm::pack_bf16(acc[4 * n8 + 2 * r] * inv[r],
                            acc[4 * n8 + 2 * r + 1] * inv[r]);
      }
      if (t == 0)
        lse[(long long)bh * Tq + row] =
            m[r] * scale + logf(l[r] > 0.f ? l[r] : 1.f);
    }
  }
}

template <int NB, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int B, int H, int Tq,
                           int Tk, int d, int causal, float scale) {
  namespace wg = zoo::wg;
  using L = WgLayout<NB, BK>;
  constexpr int S = kWgStages;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t q_full, q_empty, k_full[S], v_full[S], k_empty[S],
      v_empty[S];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  unsigned char* sq = base;              // NB boxes x 128 rows x 128 B
  unsigned char* sk = sq + L::kQ;        // S stages x NB boxes x BK x 128 B
  unsigned char* sv = sk + S * L::kKV;   // the same for V
  const int nqt = (Tq + kWgBlockRows - 1) / kWgBlockRows;
  const WgItems work{(int)blockIdx.x, (int)gridDim.x, nqt * B * H, B * H,
                     nqt};

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
    wg::set_max_regs_dec<24>();
    if (threadIdx.x == 256) {
      int jt = 0;  // K/V tiles loaded, over the items
      for (int n = 0; work.item(n) < work.items; ++n) {
        const int item = work.item(n);
        const int bh = work.bh(item);
        const int b = bh / H;
        const int h = bh % H;
        const int q0 = work.q0(item);
        // causal: keys past the item's last query row are in every row's
        // future
        const int kend = causal ? min(Tk, q0 + kWgBlockRows) : Tk;
        const int nk = (kend + BK - 1) / BK;
        if (n > 0) wg::mbar_wait(&q_empty, (n - 1) & 1);
        wg::mbar_expect_tx(&q_full, L::kQ);
        for (int nb = 0; nb < NB; ++nb)
          wg::tma_load_4d(sq + nb * kWgBlockRows * 128, &tq, &q_full,
                          nb * kBox, h, q0, b);
        for (int j = 0; j < nk; ++j, ++jt) {
          const int s = jt % S;
          if (jt >= S) wg::mbar_wait(&k_empty[s], (jt / S - 1) & 1);
          wg::mbar_expect_tx(&k_full[s], L::kKV);
          for (int nb = 0; nb < NB; ++nb)
            wg::tma_load_4d(sk + s * L::kKV + nb * BK * 128, &tk,
                            &k_full[s], nb * kBox, h, j * BK, b);
          if (jt >= S) wg::mbar_wait(&v_empty[s], (jt / S - 1) & 1);
          wg::mbar_expect_tx(&v_full[s], L::kKV);
          for (int nb = 0; nb < NB; ++nb)
            wg::tma_load_4d(sv + s * L::kKV + nb * BK * 128, &tv,
                            &v_full[s], nb * kBox, h, j * BK, b);
        }
      }
    }
  } else {
    consume<NB, BK>(sq, sk, sv, &q_full, &q_empty, k_full, v_full,
                       k_empty, v_empty, work, o, lse, H, Tq, Tk, d, causal,
                       scale);
  }
}

template <int NB, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int H, int Tq, int Tk, int d,
                 const long long* qs, const long long* ks,
                 const long long* vs, int causal, float scale,
                 cudaStream_t stream) {
  constexpr int smem = WgLayout<NB, BK>::kSmem + 1024;
  namespace tma = zoo::tma;
  CUtensorMap tq, tk, tv;
  if (!tma::cached_operand(&tq, q, B, H, Tq, d, qs[0], qs[1], qs[2],
                           kWgBlockRows) ||
      !tma::cached_operand(&tk, k, B, H, Tk, d, ks[0], ks[1], ks[2], BK) ||
      !tma::cached_operand(&tv, v, B, H, Tk, d, vs[0], vs[1], vs[2], BK))
    return tma::kErrTensorMap;
  static std::atomic<uint64_t> granted{0};
  const cudaError_t err = zoo::mma::grant_smem(
      flash_fwd_wgmma_kernel<NB, BK>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM (its registers fill the SM), each taking
  // its share of the items
  cudaError_t e;
  const int grid = tma::persistent_grid(
      (long long)B * H * ((Tq + kWgBlockRows - 1) / kWgBlockRows), &e);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wgmma_kernel<NB, BK><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      B, H, Tq, Tk, d, causal, scale);
  return (int)cudaGetLastError();
}

// K1 at a head dim above 256, in f32 or bf16: one block per (32 query
// rows, b*h, 64-column slice of O) runs zoo::wide::attend over the keys up
// to the causal limit (csrc/attn_wide.cuh). Any head dim and any strides.
template <typename T>
__global__ void __launch_bounds__(zoo::wide::kThreads)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int H, int Tq, int Tk,
                          int d, long long qsb, long long qst, long long qsh,
                          long long ksb, long long kst, long long ksh,
                          long long vsb, long long vst, long long vsh,
                          int causal, float scale) {
  namespace wd = zoo::wide;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * wd::kRows;
  auto qr = [&](int i) -> const T* {
    return q0 + i < Tq ? q + b * qsb + (q0 + i) * qst + h * qsh : nullptr;
  };
  auto kr = [&](int j) -> const T* { return k + b * ksb + j * kst + h * ksh; };
  auto vr = [&](int j) -> const T* { return v + b * vsb + j * vst + h * vsh; };
  auto visible = [&](int i, int j) { return !causal || j <= q0 + i; };
  wd::attend<T>(qr, kr, vr, causal ? min(Tk, q0 + wd::kRows) : Tk, visible,
                d, scale, o + (((long long)b * Tq + q0) * H + h) * d,
                (long long)H * d, min(wd::kRows, Tq - q0),
                lse + (long long)bh * Tq + q0);
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Tq, int Tk, int d,
                const long long* qs, const long long* ks, const long long* vs,
                int causal, float scale, cudaStream_t stream) {
  namespace wd = zoo::wide;
  dim3 grid((Tq + wd::kRows - 1) / wd::kRows, B * H,
            min(wd::slices(d), 65535));
  flash_fwd_wide_kernel<T><<<grid, wd::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tk, d, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Tq, int Tk, int d, const long long* qs,
           const long long* ks, const long long* vs, int causal, float scale,
           cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tq, Tk, d, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, position, head) for q, k and v; the head
// dim is contiguous. o is a contiguous (B, Tq, H, D) tensor and lse a
// contiguous (B, H, Tq) f32 tensor. D is any head dim from 1; up to 256,
// f32 runs on the smallest compile-time tile of 32, 64, 128 or 256 columns
// that holds it and bf16, at a multiple of 8 (the wrapper pads other head
// dims), on 64, 128 or 256; above 256 both run the wide kernel. bf16 q, k
// and v up to 256 must start 16-byte aligned with strides of multiples of
// 8 elements (the wrapper checks: TMA's tensor maps take no other).
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// dtype/head dim it does not take, or kErrTensorMap when a tensor map
// cannot be encoded.
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
  if (Tq < 1 || Tk < 1 || B < 1 || H < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
#define ZOO_FWD(F, ...) F<__VA_ARGS__>(q, k, v, o, lse, B, H, Tq, Tk, D, qs, kss, vss, causal, scale, st)
  if (D > 256)
    return dtype == zoo::kBF16 ? ZOO_FWD(launch_wide, __nv_bfloat16)
           : dtype == zoo::kF32 ? ZOO_FWD(launch_wide, float)
                                : (int)cudaErrorInvalidValue;
  if (dtype == zoo::kBF16 && D % 8 == 0)
    return D <= 64    ? ZOO_FWD(launch_wgmma, 1, 128)
           : D <= 128 ? ZOO_FWD(launch_wgmma, 2, 128)
                      : ZOO_FWD(launch_wgmma, 4, 32);
  if (dtype == zoo::kF32)
    return D <= 32    ? ZOO_FWD(launch, 32)
           : D <= 64  ? ZOO_FWD(launch, 64)
           : D <= 128 ? ZOO_FWD(launch, 128)
                      : ZOO_FWD(launch, 256);
#undef ZOO_FWD
  return (int)cudaErrorInvalidValue;
}
