// K2 — fused paged attention for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/paged_attention.py, `_paged_kernel`
// (entry point `paged_attention`).
//
// Computes attention read straight from the KV page pool through the page
// table: q (B, q_len, H, D); k/v pages (P, page_size, H, D) of one layer, in
// the pool's dtype (f32 or bf16, the same as q's); table (B, pages_per_slot)
// int32; lengths (B,) int32 counting the valid positions INCLUDING the q_len
// new tokens. Query i of slot b sees positions <= lengths[b] - q_len + i;
// positions past the length are never read; a row with no valid position
// writes zeros. Output (B, q_len, H, D) in q's dtype.
//
// What bounds it on the H100: the bytes of K/V it reads,
// slots * length * H * D * 2 (K and V) * bytes per element per layer per
// decode step; the FLOPs (4 per K/V element per query row) are far below the
// card's ratio of operations to bytes. At the serving decode step (8 slots,
// ~2300 valid positions, H=16, D=64, bf16) that is ~9.5 MB, ~2.8 us, less
// than a launch: what the card can be made to do is read those bytes with
// enough requests in flight, and no more.
//
// Three kernels, chosen by dtype and head dim in `zoo_paged_attention`:
// - bf16 at a multiple of 8 up to D = 256: `paged_attn_mma_kernel`, split
//   across the context on the tensor cores (its note is below);
// - either dtype above D = 256, and bf16 at a head dim that is not a
//   multiple of 8: `paged_attn_wide_kernel`, the FMA tiles of
//   csrc/attn_wide.cuh, which take any head dim and any strides (a pool
//   row of such a bf16 head dim is not 16 bytes long, and the pool is
//   neither copied nor allocated wider for it);
// - f32 up to D = 256: `paged_attn_kernel`, one block per (head, slot, 16-row q tile)
//   walking the whole context with FMA loops. The block reads its own
//   lengths[b] and table row (the TPU kernel's scalar prefetch) and walks
//   only the positions below the length, 64 keys per tile (32 above
//   D = 64): each tile gathers the
//   keys' pages from the pool with coalesced row loads into shared memory,
//   so no contiguous copy of the cache ever exists. Scores come from thread
//   pairs (interleaved half dots joined by a shuffle), one warp per query
//   row folds a tile into the f32 online softmax (m, l), and the f32
//   accumulator is spread over the block. f32 is not the serving dtype, and
//   TF32 would not hold its 1e-4 check.
#include <stdint.h>

#include "attn_mma.cuh"
#include "attn_wide.cuh"
#include "zoo_cuda.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQRows = 16;  // query rows a block owns: one q tile

// The f32 kernel (see above). D is the compile-time tile (32, 64, 128 or
// 256) and d <= D the head dim: columns d..D are zero-filled, which
// changes no product, and never stored. Its shared memory is dynamic
// (84 KB at D = 256).
template <int D>
constexpr int kKT = D <= 64 ? 64 : 32;  // keys per shared-memory tile

template <int D>
constexpr int f32_smem_bytes() {
  return ((kQRows + 2 * kKT<D>) * (D + 2) + kQRows * kKT<D>) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const float* __restrict__ q,
                      const float* __restrict__ kp,
                      const float* __restrict__ vp,
                      const int* __restrict__ table,
                      const int* __restrict__ lengths, float* __restrict__ o,
                      int H, int d, int q_len, int page_size,
                      int pages_per_slot, long long qsb, long long qst,
                      long long qsh, long long psp, long long pst,
                      long long psh, float scale) {
  constexpr int DP = D + 2;  // row pitch: pairs of lanes on distinct banks
  constexpr int KT = kKT<D>;
  constexpr int DH = D / 2;
  constexpr int kElems = kQRows * D / kThreads;  // acc elements per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float(*qs)[DP] = reinterpret_cast<float(*)[DP]>(smem);
  float(*ks)[DP] = qs + kQRows;
  float(*vs)[DP] = ks + KT;
  float(*ss)[KT] = reinterpret_cast<float(*)[KT]>(vs + KT);
  __shared__ float m_s[kQRows];
  __shared__ float l_s[kQRows];
  __shared__ float corr_s[kQRows];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * kQRows;  // the tile's first query row
  const int rows = min(kQRows, q_len - r0);
  const int length = lengths[b];
  const int* trow = table + (long long)b * pages_per_slot;
  const int max_pos = pages_per_slot * page_size;

  for (int idx = tid; idx < kQRows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    qs[r][c] = r < rows && c < d ? q[b * qsb + (r0 + r) * qst + h * qsh + c]
                                 : 0.f;
  }
  if (tid < kQRows) {
    m_s[tid] = zoo::kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) acc[u] = 0.f;

  const int half = tid & 1;
  const int pair = tid >> 1;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_pos = min(length, max_pos);

  for (int k0 = 0; k0 < n_pos; k0 += KT) {
    __syncthreads();  // previous tile consumed; q/m/l initialised
    // gather this tile's keys from their pages
    for (int idx = tid; idx < KT * D; idx += kThreads) {
      const int j = idx / D;
      const int c = idx % D;
      const int pos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (pos < n_pos && c < d) {
        const int page = trow[pos / page_size];
        const long long off = page * psp + (long long)(pos % page_size) * pst +
                              h * psh + c;
        kv = kp[off];
        vv = vp[off];
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    __syncthreads();
    // scores: two threads per (row, key)
    for (int idx = pair; idx < rows * KT; idx += kThreads / 2) {
      const int r = idx / KT;
      const int j = idx % KT;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i)
        part = fmaf(qs[r][2 * i + half], ks[j][2 * i + half], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) ss[r][j] = part * scale;
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int r = warp; r < rows; r += kWarps) {
      const int bound = length - q_len + r0 + r;  // last position row sees
      float sv[KT / 32];
      float tmax = zoo::kNegInf;
#pragma unroll
      for (int u = 0; u < KT / 32; ++u) {
        const int j = lane + 32 * u;
        sv[u] = (k0 + j <= bound) ? ss[r][j] : zoo::kNegInf;
        tmax = fmaxf(tmax, sv[u]);
      }
      tmax = zoo::warp_max(tmax);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < KT / 32; ++u) {
        const int j = lane + 32 * u;
        const float p = (k0 + j <= bound) ? expf(sv[u] - m_new) : 0.f;
        ss[r][j] = p;
        psum += p;
      }
      psum = zoo::warp_sum(psum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[r] = c;
        l_s[r] = l_s[r] * c + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + P V, the accumulator spread over the block
#pragma unroll
    for (int u = 0; u < kElems; ++u) {
      const int e = tid + kThreads * u;
      const int r = e / D;
      const int c = e % D;
      if (r < rows) {
        float a = acc[u] * corr_s[r];
#pragma unroll 8
        for (int j = 0; j < KT; ++j) a = fmaf(ss[r][j], vs[j][c], a);
        acc[u] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int e = tid + kThreads * u;
    const int r = e / D;
    const int c = e % D;
    if (r < rows && c < d) {
      const float l = l_s[r];
      const float safe_l = l == 0.f ? 1.f : l;  // no valid position -> 0
      o[(((long long)b * q_len + r0 + r) * H + h) * d + c] = acc[u] / safe_l;
    }
  }
}

template <int D>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* o, int B, int H, int d, int q_len,
           int page_size, int pages_per_slot, const long long* qs,
           const long long* ps, float scale, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  if constexpr (smem > 48 * 1024) {
    static std::atomic<uint64_t> granted{0};
    const cudaError_t err =
        zoo::mma::grant_smem(paged_attn_kernel<D>, smem, granted);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, B, (q_len + kQRows - 1) / kQRows);
  paged_attn_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), table, lengths, static_cast<float*>(o),
      H, d, q_len, page_size, pages_per_slot, qs[0], qs[1], qs[2], ps[0],
      ps[1], ps[2], scale);
  return (int)cudaGetLastError();
}

// K2 at the head dims the other two kernels do not take (see the top):
// one block per (32 query rows, slot * H + head, 64-column slice of the
// output) runs zoo::wide::attend over the slot's valid positions, each
// key's K/V row found through the page table.
template <typename T>
__global__ void __launch_bounds__(zoo::wide::kThreads)
    paged_attn_wide_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths,
                           T* __restrict__ o, int H, int d, int q_len,
                           int page_size, int pages_per_slot, long long qsb,
                           long long qst, long long qsh, long long psp,
                           long long pst, long long psh, float scale) {
  namespace wd = zoo::wide;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int r0 = blockIdx.x * wd::kRows;
  const int length = lengths[b];
  const int* trow = table + (long long)b * pages_per_slot;
  auto qr = [&](int i) -> const T* {
    return r0 + i < q_len ? q + b * qsb + (r0 + i) * qst + h * qsh : nullptr;
  };
  auto kr = [&](int pos) -> const T* {
    return kp + trow[pos / page_size] * psp + (pos % page_size) * pst +
           h * psh;
  };
  auto vr = [&](int pos) -> const T* {
    return vp + trow[pos / page_size] * psp + (pos % page_size) * pst +
           h * psh;
  };
  // query row i sees positions up to length - q_len + i
  auto visible = [&](int i, int pos) {
    return pos <= length - q_len + r0 + i;
  };
  wd::attend<T>(qr, kr, vr, min(length, pages_per_slot * page_size),
                visible, d, scale,
                o + ((long long)(b * q_len + r0) * H + h) * d,
                (long long)H * d, min(wd::kRows, q_len - r0), nullptr);
}

template <typename T>
int launch_wide(const void* q, const void* kp, const void* vp,
                const int* table, const int* lengths, void* o, int B, int H,
                int d, int q_len, int page_size, int pages_per_slot,
                const long long* qs, const long long* ps, float scale,
                cudaStream_t stream) {
  namespace wd = zoo::wide;
  dim3 grid((q_len + wd::kRows - 1) / wd::kRows, B * H,
            min(wd::slices(d), 65535));
  paged_attn_wide_kernel<T><<<grid, wd::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(o), H, d,
      q_len, page_size, pages_per_slot, qs[0], qs[1], qs[2], ps[0], ps[1],
      ps[2], scale);
  return (int)cudaGetLastError();
}

// K2 for bf16, designed for Hopper: split across the context, on the
// tensor cores.
//
// Replaces the same TPU kernel, `_paged_kernel`
// (analytics_zoo_tpu/ops/paged_attention.py:113), for bf16 pools.
//
// What the design does about the bound above (bytes, and the latency of
// reaching them): the grid is (head, slot, split x q tile), each split a
// fixed span of `span` positions (a multiple of the page size: 128 for
// pages up to 128 by default, up to 1024 by the tile table's choice,
// kSplitPositions), so the serving step's 8 slots x 16 heads become
// hundreds of blocks, each with its whole span of K/V requested at once; a
// split at or past the slot's length returns at once. A block reads its
// span's table entries once into shared memory, then gathers each
// position's head row (d contiguous bf16 in the pool) with 16-byte
// cp.async copies through the table into 64-key tiles of a two-stage ring;
// pages are never copied to a contiguous tensor. A block owns a q tile of
// 16 query rows, one m16 A fragment (rows past q_len zero; at q_len 1 the
// MMA wastes 15/16, irrelevant to a kernel bound by bytes); q_len above 16
// (speculative verify, prefill chunks of 48, 64, 128) takes ceil(q_len /
// 16) q tiles, each its own blocks over the same spans, which read the
// span's K/V again from L2. Each of the 4 warps owns 16 keys of a tile:
// S = Q K^T on mma.sync, the per-row bound length - q_len + i and the
// split's end applied in registers, an online softmax in the log2 domain,
// P rounded to bf16 as the A operand of O += P V (the JAX kernel's
// p.astype(v.dtype)). The 4 warps' (m, l, acc) are merged through shared
// memory into the split's f32 partial; the last split of a (head, slot, q
// tile) to finish, chosen by an atomic counter, folds the partials into
// the output, writing 0 for a row with no valid position (l == 0), as the
// TPU kernel does. One launch a call: the wrapper runs 12 times a decode
// step in a host-bound loop, and a second launch would cost it host time.
// D is the compile-time tile (32, 64, 128 or 256) and d <= D the head dim:
// columns d..D are zero-filled and never stored; up to D = 128 the query
// fragments are held in registers, at 256 they are loaded per k16 group.
// The launch bounds ask for two blocks an SM: left to itself ptxas aims
// at five at D=64 (96 registers) and spills a 64-bit value.
// Next: more heads per block (one K/V row read feeds every head of a
// GQA group once the model has them), and one q tile of 64 rows (a warp
// each) for the long q_len of prefill chunks.
constexpr int kBK = 64;             // keys a tile, 16 per warp
constexpr int kMaxSpanPages = 128;  // table entries a split reads

// The tile table (ops/tuning.py, PAGED_CANDIDATES): the positions a split
// covers, rounded up to whole pages and capped at kMaxSpanPages pages.
// Entry 0, 128 positions, is the default; a longer span launches fewer
// splits, so a long q_len writes fewer f32 partials and the last split
// folds fewer of them, at the cost of fewer blocks in flight.
constexpr int kSplitPositions[] = {128, 256, 512, 1024};
constexpr int kSplitTiles = sizeof(kSplitPositions) / sizeof(int);

constexpr int split_span(int page_size, int tile) {
  return page_size *
         ((kSplitPositions[tile] + page_size - 1) / page_size < kMaxSpanPages
              ? (kSplitPositions[tile] + page_size - 1) / page_size
              : kMaxSpanPages);
}

template <int D>
__global__ void __launch_bounds__(zoo::mma::kThreads, 2)
    paged_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ table,
                          const int* __restrict__ lengths,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ part_ml,
                          float* __restrict__ part_acc,
                          unsigned int* __restrict__ done, int H, int d,
                          int q_len, int page_size, int pages_per_slot,
                          int span, int n_split, long long qsb, long long qst,
                          long long qsh, long long psp, long long pst,
                          long long psh, float scale) {
  namespace mm = zoo::mma;
  using bf16 = __nv_bfloat16;
  constexpr int P = mm::Tile<D>::kPitch;
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of the output
  constexpr int kChunks = mm::Tile<D>::kChunks;
  constexpr int STAGES = 2;
  constexpr int kStage = kBK * P;
  // query A fragments held in registers (D <= 128), or loaded per group;
  // KG k16 steps (and DG n16 column pairs) of fragments are loaded
  // together before their products
  constexpr bool kHold = D <= 128;
  constexpr int KG = kHold ? KD : 2;
  constexpr int DG = kHold ? D / 16 : 2;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // 16 x P
  bf16* sk = sq + 16 * P;                    // STAGES x kBK x P
  bf16* sv = sk + STAGES * kStage;           // STAGES x kBK x P
  __shared__ int tbl[kMaxSpanPages];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_qt = (q_len + kQRows - 1) / kQRows;
  const int split = blockIdx.z / n_qt;
  const int qt = blockIdx.z % n_qt;
  const int r0 = qt * kQRows;  // the q tile's first row
  const int rows = min(kQRows, q_len - r0);
  const int length = lengths[b];
  const int n_pos = min(length, pages_per_slot * page_size);
  const int s0 = split * span;
  // row r of the tile at (r0 + r) * H * d
  bf16* orow = o + ((long long)(b * q_len + r0) * H + h) * d;
  if (s0 >= n_pos) {  // block-uniform; an empty slot's rows are 0
    if (n_pos == 0 && split == 0)
      for (int i = tid; i < rows * d; i += mm::kThreads)
        orow[(long long)(i / d) * H * d + i % d] = __float2bfloat16(0.f);
    return;
  }
  const int s1 = min(s0 + span, n_pos);
  const int nt = (s1 - s0 + kBK - 1) / kBK;

  // the span's table entries, read once; the tile's query rows, zero past
  // q_len and past d
  const int pg0 = s0 / page_size;
  for (int i = tid; i < (s1 - s0 + page_size - 1) / page_size; i += kThreads)
    tbl[i] = table[(long long)b * pages_per_slot + pg0 + i];
  for (int i = tid; i < 16 * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    sq[r * P + c] = r < rows && c < d
                        ? q[b * qsb + (r0 + r) * qst + h * qsh + c]
                        : __float2bfloat16(0.f);
  }
  __syncthreads();

  // start tile j's gather into its stage and commit it as one group
  const bf16* kh = kp + h * psh;
  const bf16* vh = vp + h * psh;
  auto load = [&](int j) {
    if (j < nt) {
      bf16* ks = sk + (j % STAGES) * kStage;
      bf16* vs = sv + (j % STAGES) * kStage;
#pragma unroll
      for (int i = 0; i < kBK * kChunks / mm::kThreads; ++i) {
        const int idx = tid + i * mm::kThreads;
        const int r = idx / kChunks;
        const int c = idx % kChunks;
        const int rel = j * kBK + r;  // position s0 + rel
        const bool ok = s0 + rel < s1 && c * 8 < d;
        const long long off =
            ok ? (long long)tbl[rel / page_size] * psp +
                     (long long)(rel % page_size) * pst + c * 8
               : 0;
        mm::cp_async16(mm::smem_addr(ks + r * P + c * 8), kh + off, ok);
        mm::cp_async16(mm::smem_addr(vs + r * P + c * 8), vh + off, ok);
      }
    }
    mm::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES; ++j) load(j);

  const float sl2 = scale * mm::kLog2e;
  const float ninf = mm::neg_inf();
  const int bound0 = length - q_len + r0;  // the last position row r0 sees
  uint32_t qf[kHold ? KD : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {ninf, ninf};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};    // this lane's part of the row sum

  for (int j = 0; j < nt; ++j) {
    mm::cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile j has landed for the whole block
    if constexpr (kHold) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) mm::load_a<D>(qf[kk], sq, 0, kk * 16);
      }
    }
    const bf16* ks = sk + (j % STAGES) * kStage;
    const bf16* vs = sv + (j % STAGES) * kStage;
    const int key0 = s0 + j * kBK + warp * 16;  // the warp's first key
    // warp-uniform: every key of the warp past the split's end
    if (key0 < s1) {
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kg = 0; kg < KD; kg += KG) {
        uint32_t kf[KG][4], qa[kHold ? 1 : KG][4];
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          mm::load_b<D>(kf[i], ks, warp * 16, (kg + i) * 16);
          if constexpr (!kHold) mm::load_a<D>(qa[i], sq, 0, (kg + i) * 16);
        }
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          if constexpr (kHold)
            mm::mma_pair(s, qf[kg + i], kf[i]);
          else
            mm::mma_pair(s, qa[i], kf[i]);
        }
      }

      // mask keys past the split's end or past a row's bound; only a key
      // group that crosses either is masked
      const bool edge = key0 + 16 > s1 || key0 + 15 > bound0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (edge) {
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            const int bound = bound0 + g + (e >> 1) * 8;
            if (key >= s1 || key > bound) x = ninf;
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
      for (int n = 0; n < 2; ++n) {
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
      uint32_t pa[4];
      mm::c_to_a(pa, s[0], s[1]);
#pragma unroll
      for (int dg = 0; dg < D / 16; dg += DG) {
        uint32_t vf[DG][4];
#pragma unroll
        for (int i = 0; i < DG; ++i)
          mm::load_bt<D>(vf[i], vs, warp * 16, (dg + i) * 16);
#pragma unroll
        for (int i = 0; i < DG; ++i) mm::mma_pair(acc + 2 * (dg + i), pa, vf[i]);
      }
    }
    __syncthreads();  // every warp is done with tile j's stage
    load(j + STAGES);
  }

  // merge the 4 warps' (m, l, acc) through the ring's shared memory, now
  // free (only empty commit groups are outstanding)
  float* wacc = reinterpret_cast<float*>(sk);  // kWarps x 16 x D
  float* wm = wacc + mm::kWarps * 16 * D;      // kWarps x 16
  float* wl = wm + mm::kWarps * 16;            // kWarps x 16
  float* mine = wacc + warp * 16 * D;
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) {
    mine[g * D + 8 * jd + 2 * t] = acc[jd][0];
    mine[g * D + 8 * jd + 2 * t + 1] = acc[jd][1];
    mine[(g + 8) * D + 8 * jd + 2 * t] = acc[jd][2];
    mine[(g + 8) * D + 8 * jd + 2 * t + 1] = acc[jd][3];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = mm::quad_sum(l[i]);
    if (t == 0) {
      wm[warp * 16 + g + 8 * i] = m[i];
      wl[warp * 16 + g + 8 * i] = li;
    }
  }
  __syncthreads();
  // partials of row r0 + r of split sp at ((slot0 + sp) * q_len + r0 + r)
  const long long slot0 = (long long)(b * H + h) * n_split;  // split 0
  const long long pr0 = (slot0 + split) * q_len + r0;
  for (int i = tid; i < rows * D; i += mm::kThreads) {
    const int r = i / D;  // compile-time D: shifts, not divisions
    const int c = i % D;
    if (c >= d) continue;
    float M = ninf;
#pragma unroll
    for (int w = 0; w < mm::kWarps; ++w) M = fmaxf(M, wm[w * 16 + r]);
    float L = 0.f, a = 0.f;
    if (M != ninf) {
#pragma unroll
      for (int w = 0; w < mm::kWarps; ++w) {
        const float f = mm::ex2(wm[w * 16 + r] - M);
        L += f * wl[w * 16 + r];
        a += f * wacc[(w * 16 + r) * D + c];
      }
    }
    part_acc[(pr0 + r) * d + c] = a;
    if (c == 0) {
      part_ml[2 * (pr0 + r)] = M;
      part_ml[2 * (pr0 + r) + 1] = L;
    }
  }

  // the last of the slot's ns live splits to finish folds their partials
  // into the tile's output rows; atomicInc wraps the counter back to 0 for
  // the next launch on the stream
  __shared__ bool last;
  __threadfence();  // this thread's partials, device-wide, before the count
  __syncthreads();
  const int ns = (n_pos + span - 1) / span;
  if (tid == 0)
    last = atomicInc(done + (b * H + h) * n_qt + qt, (unsigned)(ns - 1)) ==
           (unsigned)(ns - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < rows * D; i += mm::kThreads) {
    const int r = i / D;  // compile-time D: shifts, not divisions
    const int c = i % D;
    if (c >= d) continue;
    float M = ninf;
    for (int sp = 0; sp < ns; ++sp)
      M = fmaxf(M, __ldcg(part_ml + 2 * ((slot0 + sp) * q_len + r0 + r)));
    float L = 0.f, a = 0.f;
    if (M != ninf) {
      for (int sp = 0; sp < ns; ++sp) {
        const long long pr = (slot0 + sp) * q_len + r0 + r;
        const float f = mm::ex2(__ldcg(part_ml + 2 * pr) - M);
        L += f * __ldcg(part_ml + 2 * pr + 1);
        a += f * __ldcg(part_acc + pr * d + c);
      }
    }
    orow[(long long)r * H * d + c] = __float2bfloat16(L > 0.f ? a / L : 0.f);
  }
}

template <int D>
int launch_mma(const void* q, const void* kp, const void* vp,
               const int* table, const int* lengths, void* o, void* work,
               void* done, int B, int H, int d, int q_len, int page_size,
               int pages_per_slot, int span, const long long* qs,
               const long long* ps, float scale, cudaStream_t stream) {
  namespace mm = zoo::mma;
  constexpr int smem = (16 + 4 * kBK) * mm::Tile<D>::kPitch * 2;
  static_assert((mm::kWarps * 16 * D + 2 * mm::kWarps * 16) * 4 <=
                    4 * kBK * mm::Tile<D>::kPitch * 2,
                "the warps' merge does not fit in the ring");
  if constexpr (smem > 48 * 1024) {  // D >= 128; D <= 64 fits the default
    static std::atomic<uint64_t> granted{0};
    const cudaError_t err =
        mm::grant_smem(paged_attn_mma_kernel<D>, smem, granted);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_split = (pages_per_slot * page_size + span - 1) / span;
  const int n_qt = (q_len + kQRows - 1) / kQRows;
  if ((long long)n_split * n_qt > 65535) return (int)cudaErrorInvalidValue;
  float* part_ml = static_cast<float*>(work);
  float* part_acc = part_ml + 2LL * B * H * n_split * q_len;
  paged_attn_mma_kernel<D><<<dim3(H, B, n_split * n_qt), mm::kThreads, smem,
                             stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), table, lengths,
      static_cast<__nv_bfloat16*>(o), part_ml, part_acc,
      static_cast<unsigned int*>(done), H, d, q_len, page_size,
      pages_per_slot, span, n_split, qs[0], qs[1], qs[2], ps[0], ps[1], ps[2],
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q strides (slot, query row, head) and pool strides (page, in-page position,
// head) are in elements; the head dim D, any from 1, is contiguous in
// both, and k_pages and v_pages share their strides. o is a contiguous
// (B, q_len, H, D) tensor; q_len is any positive count. The bf16 tensor-
// core kernel (D a multiple of 8 up to 256) takes `tile`, an index of the
// tile table (kSplitPositions), and `span`, which must be that tile's
// split_span(page_size, tile); `work`, f32 scratch of
// B * H * n_split * q_len * (D + 2) values, n_split =
// ceil(pages_per_slot * page_size / span); `done`, B * H * ceil(q_len / 16)
// unsigned counters that are 0 before the launch and 0 again after it (so
// launches on one stream may share them); and pools whose rows start
// 16-byte aligned (the wrapper checks: cp.async moves 16-byte chunks) when D
// is a multiple of 8 up to 256. f32, and the wide kernel, take none of
// them, and only tile 0. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape, dtype or tile it does not take).
extern "C" int zoo_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, void* o, void* work,
                                   void* done, int dtype, int B, int H, int D,
                                   int q_len,
                                   int page_size, int pages_per_slot,
                                   int span, long long qsb, long long qst,
                                   long long qsh, long long psp,
                                   long long pst, long long psh, float scale,
                                   int tile, void* stream) {
  const long long qs[3] = {qsb, qst, qsh};
  const long long ps[3] = {psp, pst, psh};
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_len < 1 || B < 1 || H < 1 || page_size < 1 || pages_per_slot < 1 ||
      D < 1 || tile < 0 || tile >= kSplitTiles)
    return (int)cudaErrorInvalidValue;
  const bool tc = dtype == zoo::kBF16 && D % 8 == 0 && D <= 256;
  if (!tc && tile != 0) return (int)cudaErrorInvalidValue;
#define ZOO_K2(T) launch_wide<T>(q, k_pages, v_pages, tb, ln, o, B, H, D, q_len, page_size, pages_per_slot, qs, ps, scale, st)
  if (D > 256 || (dtype == zoo::kBF16 && D % 8))
    return dtype == zoo::kBF16 ? ZOO_K2(__nv_bfloat16)
           : dtype == zoo::kF32 ? ZOO_K2(float)
                                : (int)cudaErrorInvalidValue;
#undef ZOO_K2
  if (dtype == zoo::kBF16) {
    if (span != split_span(page_size, tile) || work == nullptr ||
        done == nullptr)
      return (int)cudaErrorInvalidValue;
#define ZOO_K2(D_) launch_mma<D_>(q, k_pages, v_pages, tb, ln, o, work, done, B, H, D, q_len, page_size, pages_per_slot, span, qs, ps, scale, st)
    return D <= 32 ? ZOO_K2(32) : D <= 64 ? ZOO_K2(64)
           : D <= 128 ? ZOO_K2(128) : ZOO_K2(256);
#undef ZOO_K2
  }
  if (dtype == zoo::kF32) {
#define ZOO_K2(D_) launch<D_>(q, k_pages, v_pages, tb, ln, o, B, H, D, q_len, page_size, pages_per_slot, qs, ps, scale, st)
    return D <= 32 ? ZOO_K2(32) : D <= 64 ? ZOO_K2(64)
           : D <= 128 ? ZOO_K2(128) : ZOO_K2(256);
#undef ZOO_K2
  }
  return (int)cudaErrorInvalidValue;
}

// The tile table's record of the bf16 kernel at head dim D (a multiple of
// 8 up to 256): registers a thread, static and dynamic shared bytes into
// out[0..2] (zoo::kernel_attrs); every tile runs the same instance.
extern "C" int zoo_paged_attention_attrs(int D, int tile, int* out) {
  if (D < 8 || D > 256 || D % 8 || tile < 0 || tile >= kSplitTiles)
    return (int)cudaErrorInvalidValue;
  namespace mm = zoo::mma;
#define ZOO_K2(D_) zoo::kernel_attrs(paged_attn_mma_kernel<D_>, (16 + 4 * kBK) * mm::Tile<D_>::kPitch * 2, out)
  return D <= 32 ? ZOO_K2(32) : D <= 64 ? ZOO_K2(64)
         : D <= 128 ? ZOO_K2(128) : ZOO_K2(256);
#undef ZOO_K2
}
