// K5 — fused int8 matmul for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/int8_fused.py, `_int8_matmul_kernel`
// (wrapper `int8_matmul_fused`), and, with g = K and rule 1, the lax route
// `int8_matmul_unfused` of analytics_zoo_tpu/ops/int8.py.
//
// Computes y = (sum over K-groups of f32(int8(x_g / s_row,g) . Wq[g]) *
// s_row,g) * s_channel for x (M, K) in f32 or bf16, the int8 weights
// kernel-major (N, K) and the per-channel scales (N,) f32; y (M, N) in x's
// dtype. One abs-max scale per (row, group of g columns): g is the TPU
// route's block_k on the fused route and K on the lax route
// (csrc/int8_tile.cuh has the rounding rules). K % g == 0.
//
// What bounds it on the H100: 2·M·N·K integer operations (68.7 G at the
// int8 MLP's 2048 x 4096 x 4096) against 1979 TOP/s of int8 tensor cores;
// the bytes (x once, the weights once, y once) come second.
//
// The design: two launches on the caller's stream. The quantize pass
// (int8_tile.cuh) reads x once and writes its codes (M x G x gp bytes, gp
// = g rounded up to 32, the pad zero) and scales (M x G f32) to the
// scratch the wrapper passes: at the MLP's layer 32 MB of f32 x read once
// and 8 MB of codes written, where the __dp4a kernel this replaces read x
// twice per group for each of its 64 column tiles. Then a GEMM walks the
// groups, folding each group's int32 partial into the f32 accumulator;
// the weights come kernel-major, each group padded to gp (`packed["qt"]`,
// made once where the layer is packed).
// - Where groups are whole 128-byte chunks and 128 x 128 output tiles
//   fill the SMs (the MLP's 4096-wide layers): matmul_wgmma_kernel, a
//   persistent block of a TMA producer warpgroup and two consumer
//   warpgroups on m64n128k32 s8 wgmma; a group's first product restarts
//   the int32 accumulator through scale-d, so no instruction writes a
//   register a pending wgmma reads (ptxas' C7513), and the fold runs after
//   wgmma.wait_group. 0.106 ms against mma.sync's 0.185 at the MLP's
//   layer on the H100 (scripts/torch_int8_variants.py).
// - Elsewhere (a narrow N, a small M, a group off the 128 grid): the
//   mma.sync GEMM of int8_tile.cuh, which K6 shares.
// That choice is entry 0 of the tile table (ops/tuning.py,
// MATMUL_CANDIDATES); the others force the wgmma GEMM (groups of whole
// 128-byte chunks only), or the mma.sync GEMM at 128 x 128 or 64 x 64.
// Every entry computes the same bits: the int32 partials are exact and the
// folds run in the same order with the same roundings. The table never
// changes the group length g, which is numerics.
#include <stdint.h>

#include "int8_tile.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace zoo::i8;
namespace wg = zoo::wg;

// named for the profiler: K5's instances of the shared kernels
struct MatmulRows : RowGather {};
struct MatmulMap : SameRows {};

// d (64 x 128, s32) = A B (scale_d 0) or d + A B (1): A and B K-major s8
// tiles of 128-byte rows in shared memory, 128-byte swizzled
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_regs(int (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// one box of a 2-D tensor map at (c0, c1), innermost first, into shared
// memory; completion counts on `bar`'s transactions
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg::smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The wgmma GEMM: a persistent block of three warpgroups walks 128 x 128
// output tiles; one producer thread streams 128-byte k-chunks of the codes
// and the kernel-major weights by TMA into a ring; two consumer
// warpgroups (64 rows each) issue m64n128k32 s8 wgmma on them, a group's
// first product restarting the int32 accumulator through scale-d (no
// register write a pending wgmma could see), wait for them, release the
// stage, and at each group's end fold the partial into the f32
// accumulator with the row's scale, as the mma.sync tile does.
constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 128;  // rows, rows, bytes
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;
constexpr int kWgStage = (kWgBM + kWgBN) * kWgBK;
constexpr int kWgSmem = kWgStages * kWgStage + 1024;

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const float* __restrict__ scales,
                      const float* __restrict__ ws, T* __restrict__ y, int M,
                      int N, int nk, int gchunks, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kWgStages], empty[kWgStages];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  const int m_tiles = (M + kWgBM - 1) / kWgBM;
  const int tiles = m_tiles * ((N + kWgBN - 1) / kWgBN);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 256);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread loads
    wg::set_max_regs_dec<40>();
    if (threadIdx.x == 256) {
      int q = 0;  // stages loaded, over the tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * kWgBM, n0 = (t / m_tiles) * kWgBN;
        for (int kc = 0; kc < nk; ++kc, ++q) {
          const int s = q % kWgStages;
          if (q >= kWgStages)
            wg::mbar_wait(&empty[s], (q / kWgStages - 1) & 1);
          wg::mbar_expect_tx(&full[s], kWgStage);
          unsigned char* st = base + s * kWgStage;
          tma_load_2d(st, &ta, &full[s], kc * kWgBK, m0);
          tma_load_2d(st + kWgBM * kWgBK, &tb, &full[s], kc * kWgBK, n0);
        }
      }
    }
    return;
  }
  wg::set_max_regs_inc<232>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp >> 2;  // consumer warpgroup 0 or 1
  const int g = lane >> 2, t4 = lane & 3;
  int part[64];
  float acc[64];
  int q = 0;  // stages consumed, over the tiles
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * kWgBM, n0 = (t / m_tiles) * kWgBN;
    const int r0 = m0 + w * 64 + (warp & 3) * 16 + g;  // rows r0, r0 + 8
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++q) {
      const int s = q % kWgStages;
      wg::mbar_wait(&full[s], (q / kWgStages) & 1);
      const uint32_t a = wg::smem_u32(base + s * kWgStage) + w * 64 * kWgBK;
      const uint32_t b = wg::smem_u32(base + s * kWgStage + kWgBM * kWgBK);
      const int first = kc % gchunks == 0;
      fence_regs(part);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / kDepth; ++kk)
        wgmma_s8(part, wg::desc(a + kk * kDepth, 16, 1024),
                 wg::desc(b + kk * kDepth, 16, 1024), first && kk == 0 ? 0 : 1);
      wg::commit();
      wg::wait<0>();
      fence_regs(part);
      wg::mbar_arrive(&empty[s]);
      if (kc % gchunks != gchunks - 1) continue;
      // the group ends: its partial, rescaled by each row's scale, into
      // the accumulator (the next group's first product restarts it)
      const int grp = kc / gchunks;
      const float s_lo = r0 < M ? scales[(long long)r0 * G + grp] : 0.f;
      const float s_hi =
          r0 + 8 < M ? scales[(long long)(r0 + 8) * G + grp] : 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__int2float_rn(part[i]),
                                             (i & 2) ? s_hi : s_lo));
    }
    // the channel scale on writeback: d[4 n + e] is row r0 + 8 (e >> 1),
    // column n0 + 8 n + 2 t4 + (e & 1)
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
      T* row = y + (long long)m * N;
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
        const int n = n0 + 8 * n8 + 2 * t4;
        if (n >= N) continue;
        const float v0 = __fmul_rn(acc[4 * n8 + 2 * h], ws[n]);
        const float v1 = n + 1 < N ? __fmul_rn(acc[4 * n8 + 2 * h + 1],
                                               ws[n + 1])
                                   : 0.f;
        if (pairs) {
          store2(row + n, v0, v1);
        } else {
          row[n] = zoo::from_f<T>(v0);
          if (n + 1 < N) row[n + 1] = zoo::from_f<T>(v1);
        }
      }
    }
  }
}

// the 2-D map (Kc bytes, rows) of a K-major int8 operand, read in boxes
// of 128 bytes x 128 rows, 128-byte swizzled; rows past the end read as
// zeros
bool encode_rows(CUtensorMap* map, const void* ptr, long long rows,
                 long long kc) {
  const zoo::tma::EncodeTiled encode = zoo::tma::encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)kc, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)kc};
  cuuint32_t box[2] = {(cuuint32_t)kWgBK, 128};
  cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// where the wgmma GEMM runs: groups of whole 128-byte chunks, and enough
// 128 x 128 tiles to fill the SMs
bool wgmma_fits(long long M, int N, int gp) {
  return gp % kWgBK == 0 &&
         (M + kWgBM - 1) / kWgBM * ((N + kWgBN - 1) / kWgBN) >= sm_count();
}

// codes (M, G * gp) and the kernel-major weights (N, G * gp) by TMA
template <typename T>
cudaError_t launch_wgmma(const int8_t* codes, const float* scales,
                         const int8_t* wt, const float* ws, T* y, int M,
                         int N, int G, int gp, cudaStream_t st) {
  const long long kc = (long long)G * gp;
  CUtensorMap ta, tb;
  if (!encode_rows(&ta, codes, M, kc) || !encode_rows(&tb, wt, N, kc))
    return (cudaError_t)zoo::tma::kErrTensorMap;
  static std::atomic<uint64_t> granted{0};
  const cudaError_t err =
      zoo::mma::grant_smem(matmul_wgmma_kernel<T>, kWgSmem, granted);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kWgBM - 1) / kWgBM * ((N + kWgBN - 1) / kWgBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  matmul_wgmma_kernel<T><<<grid, kWgThreads, kWgSmem, st>>>(
      ta, tb, scales, ws, y, M, N, (int)(kc / kWgBK), gp / kWgBK, G);
  return cudaGetLastError();
}

// The tile table: entry 0 the shape's own choice (wgmma where it fits,
// else gemm_tile's mma.sync tile), 1 the wgmma GEMM, 2 and 3 the mma.sync
// GEMM at 128 x 128 and 64 x 64 (int8_tile.cuh's codes 0 and 2)
enum MatmulTile : int { kAuto = 0, kWgmma = 1, kMma128 = 2, kMma64 = 3 };
constexpr int kMatmulTiles = 4;

// The GEMM `tile` runs at this shape: kWgmma, or an mma.sync tile code of
// int8_tile.cuh (0 .. 2) plus 10; -1 for a tile the shape cannot take
int resolve_tile(long long M, int N, int gp, int tile) {
  switch (tile) {
    case kAuto:
      return wgmma_fits(M, N, gp) ? kWgmma : 10 + gemm_tile(M, N);
    case kWgmma: return gp % kWgBK == 0 ? kWgmma : -1;
    case kMma128: return 10;
    case kMma64: return 12;
  }
  return -1;
}

template <typename T>
cudaError_t run(const void* x, const int8_t* wt, const float* ws, void* y,
                int8_t* codes, float* scales, int M, int N, int K, int g,
                int rule, float recip, int gemm, cudaStream_t st) {
  const int gp = depth_of(g);
  const int G = K / g;
  cudaError_t err = launch_quantize(static_cast<const T*>(x), codes, scales,
                                    MatmulMap{{M}}, K, g, gp, rule, recip, st);
  if (err != cudaSuccess) return err;
  if (gemm == kWgmma)
    return launch_wgmma(codes, scales, wt, ws, static_cast<T*>(y), M, N, G,
                        gp, st);
  const MatmulRows rows{{codes, scales, M, G, gp}};
  const Operands op{wt, (long long)G * gp, gp, ws, N, G, gp};
  return launch_gemm(rows, op, static_cast<T*>(y), st, gemm - 10);
}

bool bad_group(int K, int g) {
  return K < 1 || g < 1 || K % g != 0 ||
         (long long)g * 127 * 127 > 2147483647LL;
}

}  // namespace

// x (M, K) and y (M, N) contiguous in the dtype `dtype` (0 f32, 1 bf16);
// wt (N, G * gp) int8, the weights kernel-major with each of the G = K / g
// groups padded with zeros to gp = g rounded up to 32; ws (N,) f32; the
// scratch codes (M, G * gp) int8 and scales (M, G) f32, all contiguous and
// 16-byte aligned. rule 0: scale = max(amax, 1e-12) * recip; rule 1: /
// 127. `tile` indexes the tile table (MatmulTile). Returns the first CUDA
// error of the two launches (cudaErrorInvalidValue for arguments it does
// not take, a tile past the table or one the shape cannot take, before
// either launch).
extern "C" int zoo_int8_matmul(const void* x, const void* wt, const void* ws,
                               void* y, void* codes, void* scales, int dtype,
                               int M, int N, int K, int g, int rule,
                               float recip, int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* s = static_cast<const float*>(ws);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scales);
  if (M < 1 || N < 1 || bad_group(K, g) || (rule != 0 && rule != 1))
    return (int)cudaErrorInvalidValue;
  const int gemm = resolve_tile(M, N, depth_of(g), tile);
  if (gemm < 0) return (int)cudaErrorInvalidValue;
  if (dtype == zoo::kF32)
    return (int)run<float>(x, w, s, y, c, sc, M, N, K, g, rule, recip, gemm,
                           st);
  if (dtype == zoo::kBF16)
    return (int)run<__nv_bfloat16>(x, w, s, y, c, sc, M, N, K, g, rule,
                                   recip, gemm, st);
  return (int)cudaErrorInvalidValue;
}

// The tile table's record of the GEMM `tile` runs for an (M, K) x (K, N)
// product at group length g in `dtype`: registers a thread, static and
// dynamic shared bytes into out[0..2] (zoo::kernel_attrs).
// cudaErrorInvalidValue where zoo_int8_matmul would refuse the tile.
extern "C" int zoo_int8_matmul_attrs(int dtype, int M, int N, int K, int g,
                                     int tile, int* out) {
  if (M < 1 || N < 1 || bad_group(K, g) ||
      (dtype != zoo::kF32 && dtype != zoo::kBF16))
    return (int)cudaErrorInvalidValue;
  const int gp = depth_of(g);
  const int gemm = resolve_tile(M, N, gp, tile);
  if (gemm < 0) return (int)cudaErrorInvalidValue;
  auto attrs = [&](auto t) -> int {
    using T = decltype(t);
    if (gemm == kWgmma)
      return zoo::kernel_attrs(matmul_wgmma_kernel<T>, kWgSmem, out);
    return (int)with_gemm_cfg(gemm - 10, gp, [&](auto c) {
      using C = decltype(c);
      return (cudaError_t)zoo::kernel_attrs(gemm_kernel<C, MatmulRows, T>,
                                            C::kSmem, out);
    });
  };
  return dtype == zoo::kF32 ? attrs(float{}) : attrs(__nv_bfloat16{});
}

// The quantize pass alone, for checking it: x (R, L) -> codes (R, G * gp)
// int8 and scales (R, G) f32 with G = L / g, as zoo_int8_matmul makes them.
extern "C" int zoo_int8_quantize(const void* x, void* codes, void* scales,
                                 int dtype, int R, int L, int g, int rule,
                                 float recip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scales);
  if (R < 1 || bad_group(L, g) || (rule != 0 && rule != 1))
    return (int)cudaErrorInvalidValue;
  const MatmulMap map{{R}};
  if (dtype == zoo::kF32)
    return (int)launch_quantize(static_cast<const float*>(x), c, sc, map, L,
                                g, depth_of(g), rule, recip, st);
  if (dtype == zoo::kBF16)
    return (int)launch_quantize(static_cast<const __nv_bfloat16*>(x), c, sc,
                                map, L, g, depth_of(g), rule, recip, st);
  return (int)cudaErrorInvalidValue;
}
