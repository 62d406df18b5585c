// The int8 machinery shared by K5 (csrc/int8_matmul.cu) and K6
// (csrc/int8_conv.cu): the quantize pass, and one int8 tensor-core GEMM
// whose A rows each kernel gathers its own way.
//
// Arithmetic, held bit for bit to the plain versions in ops/int8_fused.py:
// - a scale group's scale is max(amax, 1e-12) * f32(1/127) (the fused TPU
//   route, rule 0) or max(amax, 1e-12) / 127 (the lax route, rule 1);
// - the code is clip(rint(x / scale), -127, 127): IEEE division, rounding
//   half to even as jnp.round does;
// - a segment's int32 partial (a scale group of K5, a tap of K6) becomes
//   f32 by round-to-nearest, is multiplied by its row's scale and added to
//   the f32 accumulator as two rounded operations (no contraction into an
//   FMA), in segment order; the channel scale lands once on writeback.
// Integer sums are exact in any order, so the tensor cores keep the bits
// as long as the int32 partial is folded and restarted at every segment.
//
// 1. The quantize pass (quantize_rows_kernel): one pass over the rows of
//    x, lanes-per-group sized to the group, takes each group's abs-max,
//    makes its scale and writes the int8 codes and f32 scales to scratch
//    the wrapper allocates. Each group's codes are padded with zero codes
//    to a multiple of the tensor cores' depth, 32 bytes (4 bytes, one
//    word, for K6 at Cin <= 4, which runs __dp4a). So every activation is
//    divided once per call, not once per column tile (and, in K6, per
//    tap): x is read once in its dtype (4 bytes a value in f32), its codes
//    cost 1 byte to write and are read back mostly from L2.
// 2. The mma.sync GEMM (gemm_kernel): a block owns a BM x BN output tile;
//    its warps own WM x WN, as m16n8k32 s8 mma.sync tiles with int32
//    partials and f32 accumulators in registers. The contraction walks
//    segments, each in BK-byte chunks through a cp.async ring of A rows, B
//    rows (the weights kernel-major, k contiguous: what the "col" B operand
//    takes) and the A rows' scales; fragments come from shared memory by
//    ldmatrix. A chunk past a segment's end, an A row past M, and a K6 tap
//    on the zero padding are zero-filled by cp.async (src-size 0), so they
//    add nothing and their scales never matter. A segment's first product
//    restarts its partial through the mma's C operand. Blocks are
//    persistent (as many as fit, walking the tiles in turn) and the ring
//    runs across tile boundaries, so a shallow tile (a 1x1 conv: one
//    stage) loads the next while it writes back. Each tile is one block's
//    own: no split-K, which would change the f32 fold order. Three tile
//    shapes; the largest that still gives two tiles an SM.
// What bounds this GEMM on the H100: mma.sync reaches a fraction of the
// int8 rate that wgmma does, and with an f32 accumulator beside each int32
// partial a thread holds 64 x 32 outputs at most (~190 registers: one
// 8-warp block an SM). K5's large layers run a wgmma GEMM instead
// (int8_matmul.cu); K6's taps gather rows TMA boxes do not.
#pragma once

#include <stdint.h>

#include <atomic>

#include "attn_mma.cuh"
#include "zoo_cuda.cuh"

namespace zoo {
namespace i8 {

using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldsm_x4;
using mma::smem_addr;

constexpr int kDepth = 32;  // bytes of k an mma takes
// int32 + kMagic reinterpreted as f32 is 1.5 * 2^23 + i exactly for
// |i| < 2^22, so subtracting kMagicF converts i without I2F (a quarter-rate
// instruction) and, i being exact in f32, with the bits of __int2float_rn
constexpr int kMagic = 0x4B400000;
constexpr float kMagicF = 12582912.f;
constexpr int kMaxSmall = (1 << 22) / (127 * 127);  // segment bytes for it

__host__ __device__ constexpr int depth_of(int g) {
  return (g + kDepth - 1) / kDepth * kDepth;
}

__device__ __forceinline__ float group_scale(float amax, int rule,
                                             float recip) {
  const float m = fmaxf(amax, 1e-12f);
  return rule ? __fdiv_rn(m, 127.f) : __fmul_rn(m, recip);
}

__device__ __forceinline__ int quantize(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// exact int32 -> f32 of a partial that started at `init`
__device__ __forceinline__ float part_to_f(int p, bool small) {
  return small ? __fsub_rn(__int_as_float(p), kMagicF) : __int2float_rn(p);
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// c += a b on the tensor cores: s8 operands, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = init + a b: a segment's first product, so the partial restarts
// without rewriting its registers
__device__ __forceinline__ void mma_s8_from(int (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1,
                                            int init) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(init));
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

// two adjacent outputs, rounded to T as from_f does, in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ quantize pass

// Which x row a codes row quantizes. SameRows: the same row (a matmul, or
// a conv's input pixels). StridedPixels: output pixel r of a 1x1 conv
// reads input pixel (b, ho * sh, wo * sw), so only the pixels the conv
// reads are coded.
struct SameRows {
  int rows;
  __device__ long long src(int r) const { return r; }
};

struct StridedPixels {
  int rows;  // B * Ho * Wo
  int wo, howo, sh, sw, w, hw;
  __device__ long long src(int r) const {
    const int b = r / howo;
    const int rem = r - b * howo;
    const int ho = rem / wo;
    return (long long)b * hw + (long long)(ho * sh) * w +
           (long long)(rem - ho * wo) * sw;
  }
};

// One (row, group) a unit of 2^lg lanes: codes[r][grp * gp + c] and
// scales[r * G + grp] from x[src(r)][grp * g + c], c < g; bytes g..gp-1
// zero. VEC: 4 values a load (g, L and x aligned to it). A group that
// takes a lane at most KEEP (1 to 16) loads stays in registers between its
// abs-max and its codes, and a lane group then takes max(1, kLoads / KEEP)
// consecutive units, issuing all their loads before the first reduction (a
// conv pixel of 64 channels is one load a lane). KEEP 0: a longer group,
// one a lane group, read twice (the second time from L1/L2). kLoads 4
// beat 8 on the H100 (scripts/torch_int8_variants.py): more threads with
// fewer loads each keep more of the reads in flight across a wave.
constexpr int kLoads = 4;

template <typename T>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[4]) {
  load4(p, v);
}

template <typename T>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[1]) {
  v[0] = to_f(*p);
}

__device__ __forceinline__ void store_codes(int8_t* p, const float (&v)[4],
                                            float s) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w |= (uint32_t)(quantize(v[e], s) & 0xff) << (8 * e);
  *reinterpret_cast<uint32_t*>(p) = w;
}

__device__ __forceinline__ void store_codes(int8_t* p, const float (&v)[1],
                                            float s) {
  *p = static_cast<int8_t>(quantize(v[0], s));
}

template <typename T, class Map, bool VEC, int KEEP>
__global__ void __launch_bounds__(256)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                         float* __restrict__ scales, Map map, int L, int g,
                         int gp, int G, int lg, int rule, float recip) {
  constexpr int E = VEC ? 4 : 1;  // values a load
  constexpr int U = KEEP > 0 && KEEP < kLoads ? kLoads / KEEP : 1;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lanes = 1 << lg;
  const int sub = t & (lanes - 1);
  const int step = E * lanes;  // values a round of loads covers
  const int total = map.rows * G;
  const int first = (t >> lg) * U;
  auto src_of = [&](int unit) {
    const int r = unit / G;
    return x + map.src(r) * L + (long long)(unit - r * G) * g;
  };
  auto pad = [&](int8_t* dst) {
    for (int c = g + E * sub; c < gp; c += step) {
      if (VEC)
        *reinterpret_cast<uint32_t*>(dst + c) = 0u;
      else
        dst[c] = 0;
    }
  };
  if constexpr (KEEP > 0) {
    float v[U][KEEP][E];
    float amax[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      amax[u] = 0.f;
      if (first + u < total) {
        const T* src = src_of(first + u);
#pragma unroll
        for (int i = 0; i < KEEP; ++i) {
          const int c = E * sub + i * step;
          if (c < g) load_vals(src + c, v[u][i]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (first + u < total) {
#pragma unroll
        for (int i = 0; i < KEEP; ++i)
          if (E * sub + i * step < g)
#pragma unroll
            for (int e = 0; e < E; ++e)
              amax[u] = fmaxf(amax[u], fabsf(v[u][i][e]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        if (off < lanes)
          amax[u] = fmaxf(amax[u], __shfl_xor_sync(0xffffffffu, amax[u], off));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int unit = first + u;
      if (unit >= total) break;
      const float s = group_scale(amax[u], rule, recip);
      if (sub == 0) scales[unit] = s;
      int8_t* dst = codes + (long long)unit * gp;
      if (!VEC && lanes == 1 && gp == 4) {  // one word a pixel (Cin <= 4)
        uint32_t w = 0;
#pragma unroll
        for (int i = 0; i < KEEP; ++i)
          if (i < g)
            w |= (uint32_t)(quantize(v[u][i][0], s) & 0xff) << (8 * i);
        *reinterpret_cast<uint32_t*>(dst) = w;
        continue;
      }
#pragma unroll
      for (int i = 0; i < KEEP; ++i) {
        const int c = E * sub + i * step;
        if (c < g) store_codes(dst + c, v[u][i], s);
      }
      pad(dst);
    }
  } else {
    const bool live = first < total;
    const T* src = src_of(live ? first : 0);
    float amax = 0.f;
    if (live)
      for (int c = E * sub; c < g; c += step) {
        float u[E];
        load_vals(src + c, u);
#pragma unroll
        for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(u[e]));
      }
    for (int off = lanes >> 1; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (!live) return;
    const float s = group_scale(amax, rule, recip);
    if (sub == 0) scales[first] = s;
    int8_t* dst = codes + (long long)first * gp;
    for (int c = E * sub; c < g; c += step) {
      float u[E];
      load_vals(src + c, u);
      store_codes(dst + c, u, s);
    }
    pad(dst);
  }
}

template <typename T, class Map, bool VEC, int KEEP>
void launch_quantize_as(const T* x, int8_t* codes, float* scales,
                        const Map& map, int L, int g, int gp, int lg,
                        long long total, int rule, float recip,
                        cudaStream_t st) {
  constexpr int U = KEEP > 0 && KEEP < kLoads ? kLoads / KEEP : 1;
  const long long threads = (total + U - 1) / U << lg;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  quantize_rows_kernel<T, Map, VEC, KEEP><<<blocks, 256, 0, st>>>(
      x, codes, scales, map, L, g, gp, L / g, lg, rule, recip);
}

template <typename T, class Map, bool VEC>
void launch_quantize_keep(const T* x, int8_t* codes, float* scales,
                          const Map& map, int L, int g, int gp, int lg,
                          int loads, long long total, int rule, float recip,
                          cudaStream_t st) {
  if (loads <= 1)
    launch_quantize_as<T, Map, VEC, 1>(x, codes, scales, map, L, g, gp, lg,
                                       total, rule, recip, st);
  else if (loads <= 2)
    launch_quantize_as<T, Map, VEC, 2>(x, codes, scales, map, L, g, gp, lg,
                                       total, rule, recip, st);
  else if (loads <= 4)
    launch_quantize_as<T, Map, VEC, 4>(x, codes, scales, map, L, g, gp, lg,
                                       total, rule, recip, st);
  else if (loads <= 8)
    launch_quantize_as<T, Map, VEC, 8>(x, codes, scales, map, L, g, gp, lg,
                                       total, rule, recip, st);
  else if (loads <= 16)
    launch_quantize_as<T, Map, VEC, 16>(x, codes, scales, map, L, g, gp, lg,
                                        total, rule, recip, st);
  else
    launch_quantize_as<T, Map, VEC, 0>(x, codes, scales, map, L, g, gp, lg,
                                       total, rule, recip, st);
}

// map.rows x G groups of g values of the rows of x (row length L), codes
// at gp bytes a group
template <typename T, class Map>
cudaError_t launch_quantize(const T* x, int8_t* codes, float* scales,
                            const Map& map, int L, int g, int gp, int rule,
                            float recip, cudaStream_t st) {
  const bool vec = g % 4 == 0 && L % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const int per = vec ? g / 4 : g;  // loads a group
  int lg = 0;  // one lane a group of at most 4 bytes of codes
  while (lg < 5 && (2 << lg) <= per && gp > 4) ++lg;
  const int loads = (per + (1 << lg) - 1) >> lg;  // a lane, a group
  const long long total = (long long)map.rows * (L / g);
  if (total > 2147483647LL || (total << lg) > 2147483647LL - 255)
    return cudaErrorInvalidValue;
  if (vec)
    launch_quantize_keep<T, Map, true>(x, codes, scales, map, L, g, gp, lg,
                                       loads, total, rule, recip, st);
  else
    launch_quantize_keep<T, Map, false>(x, codes, scales, map, L, g, gp, lg,
                                        loads, total, rule, recip, st);
  return cudaGetLastError();
}

// --------------------------------------------------------------------- GEMM

// A block's tile: BM x BN outputs, warps of WM x WN, a ring of STAGES
// stages of BK bytes of k (a shared row pitch of BK + 16 bytes puts the 8
// rows an ldmatrix phase reads on 8 different bank groups); 4 threads load
// a row, BK / 64 16-byte chunks each.
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_;
  static constexpr int kStages = STAGES_;
  static constexpr int kPitch = BK + 16;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;  // mma tiles a warp
  static constexpr int kLoadRows = kThreads / 4;  // rows a pass of loads
  static constexpr int kChunks = BK / 64;         // 16-byte chunks a thread
  static constexpr int kARows = BM / kLoadRows, kBRows = BN / kLoadRows;
  static constexpr int kStageBytes = (BM + BN) * kPitch + BM * 4;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kThreads >= BM && BM % kLoadRows == 0 &&
                    BN % kLoadRows == 0 && WN % 16 == 0 && BK % 64 == 0,
                "tile shape");
};

// 8 warps a block (one block an SM: ~190 registers a thread) or 4 (two or
// more); BK 128 where a segment is that deep, 64 where it is not (K6's
// 64-channel taps), and 256 for the large tile where a segment is that
// deep (K5's groups of 512)
using TileL256 = Cfg<128, 128, 64, 32, 256, 3>;
using TileL = Cfg<128, 128, 64, 32, 128, 4>;
using TileM = Cfg<128, 64, 64, 32, 128, 3>;
using TileS = Cfg<64, 64, 32, 32, 128, 3>;
using TileL64 = Cfg<128, 128, 64, 32, 64, 4>;
using TileM64 = Cfg<128, 64, 64, 32, 64, 3>;
using TileS64 = Cfg<64, 64, 32, 32, 64, 4>;

// A rows that lie whole in the codes: K5's x rows (one segment a scale
// group) and K6's 1x1 convs at zero padding (one segment)
struct RowGather {
  const int8_t* codes;
  const float* scales;
  long long M;
  int G, D;  // segments a row, bytes a segment
  struct Row {
    int m;  // -1 past M
  };
  struct Seg {
    int s;
  };
  __device__ Row row(long long m) const { return Row{m < M ? (int)m : -1}; }
  __device__ Seg seg(int s) const { return Seg{s}; }
  __device__ const int8_t* a_src(const Row& r, const Seg& sg, int byte,
                                 bool& ok) const {
    ok = r.m >= 0;
    return codes + ((long long)(ok ? r.m : 0) * G + sg.s) * D + byte;
  }
  __device__ const float* s_src(const Row& r, const Seg& sg, bool& ok) const {
    ok = r.m >= 0;
    return scales + (long long)(ok ? r.m : 0) * G + sg.s;
  }
};

// K6's taps: output pixel m at tap (kh, kw) reads input pixel (b, ho * sh +
// kh - pt, wo * sw + kw - pl), or the zero padding
struct TapGather {
  const int8_t* codes;  // one row of D bytes an input pixel
  const float* scales;  // one an input pixel
  long long M;          // B * Ho * Wo, below 2^31
  int H, W, Ho, Wo, KW, sh, sw, pt, pl, D;
  struct Row {
    int pix0, hi0, wi0;
  };
  struct Seg {
    int kh, kw;
  };
  __device__ Row row(long long m) const {
    if (m >= M) return Row{0, -(1 << 29), 0};  // every tap off the image
    const int hw = Ho * Wo;
    const int b = (int)m / hw;
    const int rem = (int)m - b * hw;
    const int ho = rem / Wo;
    return Row{b * H * W, ho * sh - pt, (rem - ho * Wo) * sw - pl};
  }
  __device__ Seg seg(int s) const { return Seg{s / KW, s % KW}; }
  __device__ long long pixel(const Row& r, const Seg& sg, bool& ok) const {
    const int hi = r.hi0 + sg.kh, wi = r.wi0 + sg.kw;
    ok = (unsigned)hi < (unsigned)H && (unsigned)wi < (unsigned)W;
    return ok ? (long long)r.pix0 + hi * W + wi : 0;
  }
  __device__ const int8_t* a_src(const Row& r, const Seg& sg, int byte,
                                 bool& ok) const {
    return codes + pixel(r, sg, ok) * D + byte;
  }
  __device__ const float* s_src(const Row& r, const Seg& sg, bool& ok) const {
    return scales + pixel(r, sg, ok);
  }
};

// B[seg][n][k] at wt + seg * seg_stride + n * n_stride + k (kernel-major)
struct Operands {
  const int8_t* wt;
  long long n_stride, seg_stride;
  const float* ws;  // channel scales
  int N, n_seg, D;  // D: bytes a segment, a multiple of kDepth
};

// Persistent: block b walks the output tiles b, b + gridDim.x, ... (m
// tiles fastest); the ring runs on across tile boundaries, so the next
// tile's first stages load while this one folds and writes back.
template <class C, class G, typename T>
__global__ void __launch_bounds__(C::kThreads, 1)
    gemm_kernel(const G g, const Operands op, T* __restrict__ y) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp / C::kWarpsN) * C::WM;
  const int wn0 = (warp % C::kWarpsN) * C::WN;
  const int lr = tid >> 2;         // loader row
  const int lc = (tid & 3) * 16;   // loader byte in a 64-byte piece
  constexpr int BK = C::BK, kPitch = C::kPitch, kStages = C::kStages;
  const int m_tiles = (int)((g.M + C::BM - 1) / C::BM);
  const int tiles = m_tiles * ((op.N + C::BN - 1) / C::BN);
  const int my_tiles =
      (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                              : 0;
  const int nc = (op.D + BK - 1) / BK;  // chunks a segment
  const bool small = op.D <= kMaxSmall;
  const int init = small ? kMagic : 0;

  // the loads run kStages - 1 stages ahead of the products, on their own
  // counters: tile (of this block's), segment and chunk
  int l_tile = 0, l_seg = 0, l_chunk = 0, l_slot = 0;
  typename G::Row arow[C::kARows];
  typename G::Row srow;
  const int8_t* bsrc[C::kBRows];
  bool bok[C::kBRows];
  auto load_tile = [&](int i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int m0 = (t % m_tiles) * C::BM;
    const int n0 = (t / m_tiles) * C::BN;
#pragma unroll
    for (int j = 0; j < C::kARows; ++j)
      arow[j] = g.row(m0 + lr + j * C::kLoadRows);
    srow = g.row(m0 + (tid < C::BM ? tid : 0));
#pragma unroll
    for (int j = 0; j < C::kBRows; ++j) {
      const int n = n0 + lr + j * C::kLoadRows;
      bok[j] = n < op.N;
      bsrc[j] = op.wt + (bok[j] ? n : 0) * op.n_stride;
    }
  };
  if (my_tiles) load_tile(0);

  auto issue = [&]() {
    if (l_tile < my_tiles) {
      const int c0 = l_chunk * BK;
      const typename G::Seg sg = g.seg(l_seg);
      uint8_t* st = smem + l_slot * C::kStageBytes;
#pragma unroll
      for (int j = 0; j < C::kARows; ++j) {
#pragma unroll
        for (int h = 0; h < C::kChunks; ++h) {
          const int byte = c0 + 64 * h + lc;
          bool ok;
          const int8_t* src = g.a_src(arow[j], sg, byte, ok);
          ok = ok && byte < op.D;
          cp_async16(smem_addr(st + (lr + j * C::kLoadRows) * kPitch +
                               64 * h + lc),
                     ok ? src : op.wt, ok);
        }
      }
#pragma unroll
      for (int j = 0; j < C::kBRows; ++j) {
#pragma unroll
        for (int h = 0; h < C::kChunks; ++h) {
          const int byte = c0 + 64 * h + lc;
          const bool ok = bok[j] && byte < op.D;
          cp_async16(smem_addr(st + (C::BM + lr + j * C::kLoadRows) * kPitch +
                               64 * h + lc),
                     ok ? bsrc[j] + l_seg * op.seg_stride + byte : op.wt, ok);
        }
      }
      if (tid < C::BM) {
        bool ok;
        const float* src = g.s_src(srow, sg, ok);
        cp_async4(smem_addr(st + (C::BM + C::BN) * kPitch + tid * 4),
                  ok ? src : op.ws, ok);
      }
      if (++l_chunk == nc) {
        l_chunk = 0;
        if (++l_seg == op.n_seg) {
          l_seg = 0;
          if (++l_tile < my_tiles) load_tile(l_tile);
        }
      }
      l_slot = l_slot + 1 == kStages ? 0 : l_slot + 1;
    }
    cp_async_commit();
  };

  int part[C::kMT][C::kNT][4];  // set by each segment's first product
  float acc[C::kMT][C::kNT][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();

  int tile = 0, seg = 0, chunk = 0, slot = 0;  // the products' counters
  while (tile < my_tiles) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; the previous one consumed by all
    issue();
    const uint8_t* st = smem + slot * C::kStageBytes;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    const uint8_t* As = st;
    const uint8_t* Bs = st + C::BM * kPitch;
    const int c0 = chunk * BK;
#pragma unroll
    for (int ks = 0; ks < BK; ks += kDepth) {
      if (c0 + ks >= op.D) break;  // the zero tail of a segment
      uint32_t a[C::kMT][4];
      uint32_t b[C::kNT / 2][4];
#pragma unroll
      for (int i = 0; i < C::kMT; ++i)
        ldsm_x4(a[i], smem_addr(As +
                                (wm0 + 16 * i + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * kPitch +
                                ks + (lane >> 4) * 16));
#pragma unroll
      for (int j = 0; j < C::kNT / 2; ++j)
        ldsm_x4(b[j], smem_addr(Bs +
                                (wn0 + 16 * j + (lane & 7) +
                                 (lane >> 4) * 8) * kPitch +
                                ks + ((lane >> 3) & 1) * 16));
      if (c0 + ks == 0) {
#pragma unroll
        for (int i = 0; i < C::kMT; ++i)
#pragma unroll
          for (int j = 0; j < C::kNT; ++j)
            mma_s8_from(part[i][j], a[i], b[j / 2][(j & 1) * 2],
                        b[j / 2][(j & 1) * 2 + 1], init);
      } else {
#pragma unroll
        for (int i = 0; i < C::kMT; ++i)
#pragma unroll
          for (int j = 0; j < C::kNT; ++j)
            mma_s8(part[i][j], a[i], b[j / 2][(j & 1) * 2],
                   b[j / 2][(j & 1) * 2 + 1]);
      }
    }
    if (++chunk < nc) continue;
    chunk = 0;
    {
      // the segment ends: its partial, rescaled by each row's scale, into
      // the accumulator (the next segment's first product restarts it)
      const float* S = reinterpret_cast<const float*>(
          st + (C::BM + C::BN) * kPitch);
#pragma unroll
      for (int i = 0; i < C::kMT; ++i) {
        const int r = wm0 + 16 * i + (lane >> 2);
        const float s_lo = S[r], s_hi = S[r + 8];
#pragma unroll
        for (int j = 0; j < C::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sc = e < 2 ? s_lo : s_hi;
            acc[i][j][e] = __fadd_rn(
                acc[i][j][e], __fmul_rn(part_to_f(part[i][j][e], small), sc));
          }
      }
    }
    if (++seg < op.n_seg) continue;
    seg = 0;
    // the tile ends: the channel scale on writeback, from registers (a
    // thread holds column pairs); then the next tile starts from zero
    const int t = blockIdx.x + tile * gridDim.x;
    const long long m0 = (long long)(t % m_tiles) * C::BM;
    const int n0 = (t / m_tiles) * C::BN;
    float wsv[C::kNT][2];
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn0 + 8 * j + 2 * (lane & 3) + e;
        wsv[j][e] = n < op.N ? op.ws[n] : 0.f;
      }
    const bool pairs = (op.N & 1) == 0;
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm0 + 16 * i + (lane >> 2) + 8 * h;
        if (m >= g.M) continue;
        T* row = y + m * op.N;
#pragma unroll
        for (int j = 0; j < C::kNT; ++j) {
          const int n = n0 + wn0 + 8 * j + 2 * (lane & 3);
          if (n >= op.N) continue;
          const float v0 = __fmul_rn(acc[i][j][2 * h], wsv[j][0]);
          const float v1 = __fmul_rn(acc[i][j][2 * h + 1], wsv[j][1]);
          if (pairs) {
            store2(row + n, v0, v1);
          } else {
            row[n] = from_f<T>(v0);
            if (n + 1 < op.N) row[n + 1] = from_f<T>(v1);
          }
        }
      }
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    ++tile;
  }
  cp_async_wait<0>();
}

inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <class C, class G, typename T>
cudaError_t launch_gemm_as(const G& g, const Operands& op, T* y,
                           cudaStream_t st) {
  static std::atomic<uint64_t> granted{0};
  static std::atomic<int> per_sm{0};  // resident blocks an SM
  auto kernel = gemm_kernel<C, G, T>;
  cudaError_t err = mma::grant_smem(kernel, C::kSmem, granted);
  if (err != cudaSuccess) return err;
  int n = per_sm.load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        C::kThreads, C::kSmem);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    per_sm.store(n, std::memory_order_relaxed);
  }
  const long long tiles =
      (g.M + C::BM - 1) / C::BM * ((op.N + C::BN - 1) / C::BN);
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const long long grid = tiles < (long long)n * sm_count()
                             ? tiles
                             : (long long)n * sm_count();
  kernel<<<(unsigned)grid, C::kThreads, C::kSmem, st>>>(g, op, y);
  return cudaGetLastError();
}

// The mma.sync tile of `launch_gemm`: 0 (128 x 128), 1 (128 x 64) or 2
// (64 x 64), the largest that gives at least two blocks an SM, else the
// small one
inline int gemm_tile(long long M, int N) {
  const long long enough = 2LL * sm_count();
  auto blocks = [&](int bm, int bn) {
    return (M + bm - 1) / bm * ((N + bn - 1) / bn);
  };
  return N > 64 && blocks(128, 128) >= enough ? 0
         : blocks(128, 64) >= enough          ? 1
                                              : 2;
}

// `f(C{})` for the Cfg of mma.sync tile `tile` (gemm_tile's codes) at a
// segment `depth` bytes deep: BK 256 or 128 where a segment is at least
// that deep
template <class F>
cudaError_t with_gemm_cfg(int tile, int depth, F&& f) {
  if (depth >= 256 && tile == 0) return f(TileL256{});
  if (depth >= 128) {
    if (tile == 0) return f(TileL{});
    if (tile == 1) return f(TileM{});
    return f(TileS{});
  }
  if (tile == 0) return f(TileL64{});
  if (tile == 1) return f(TileM64{});
  return f(TileS64{});
}

// The GEMM at gemm_tile's choice, or at mma.sync tile `tile` when it is
// 0, 1 or 2
template <class G, typename T>
cudaError_t launch_gemm(const G& g, const Operands& op, T* y,
                        cudaStream_t st, int tile = -1) {
  if (tile < 0) tile = gemm_tile(g.M, op.N);
  return with_gemm_cfg(tile, op.D, [&](auto c) {
    return launch_gemm_as<decltype(c)>(g, op, y, st);
  });
}

}  // namespace i8
}  // namespace zoo
