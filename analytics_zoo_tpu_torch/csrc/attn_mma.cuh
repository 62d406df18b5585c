// Tensor-core tile machinery of the bf16 mma.sync attention kernel (K2 in
// csrc/paged_attention.cu; the wgmma kernels, K1 in csrc/flash_fwd.cu and
// K3/K4 in csrc/flash_bwd.cu, take its fragment layouts, quad reductions,
// bf16 packing and shared-memory grant from here too): 16-byte cp.async
// copies, fragment loads with ldmatrix, the m16n8k16 bf16 mma.sync with
// f32 accumulators, the accumulator-to-operand repack that keeps P in
// registers between two products, and quad row reductions.
//
// A block has 4 warps; each warp owns 16 rows of the block's tile.
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
// - A (16 x 16, row major), 4 x b32: a0 (row g, cols 2t, 2t+1),
//   a1 (row g+8, same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, ...);
// - B (16 x 8, k x n), 2 x b32: b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9);
// - C (16 x 8, f32), 4 x f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//   g+8, same cols).
// So two adjacent n8 C tiles, rounded to bf16 in pairs, are one k16 A
// fragment: the probabilities of a score tile feed the next product
// without leaving registers.
//
// Shared-memory tiles are row major with a pitch of D + 8 elements: a row
// is 16 bytes longer than its data, so the 8 rows one ldmatrix phase reads
// fall on 8 different 4-bank groups (no bank conflicts), and every 16-byte
// chunk stays 16-byte aligned as cp.async and ldmatrix require.
#pragma once

#include <stdint.h>

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zoo {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kPitch = D + 8;  // elements a shared-memory row
  static constexpr int kChunks = D / 8;  // 16-byte chunks a row
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

// 2^x on the special-function unit (flush to zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with valid false the source is
// not read and the 16 bytes are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Grant `bytes` of dynamic shared memory (past the 48 KB default) to a
// kernel, once per device; `granted` is the caller's record for that
// kernel, one bit a device. A failure is not recorded: the next launch
// asks again and gets it again.
template <typename Kernel>
inline cudaError_t grant_smem(Kernel kernel, int bytes,
                              std::atomic<uint64_t>& granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (granted.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) granted.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment of rows [r0, r0 + 16), cols [c0, c0 + 16) of a tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, smem_addr(tile + (r0 + (l & 7) + ((l >> 3) & 1) * 8) *
                                  Tile<D>::kPitch +
                              c0 + (l >> 4) * 8));
}

// B fragments of two n8 tiles with B[k][n] = tile[n0 + n][c0 + k]: the
// tile's rows are the product's columns (S = Q K^T, dP = dO V^T).
// b[0], b[1] serve columns n0..n0+7, b[2], b[3] columns n0+8..n0+15.
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int c0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, smem_addr(tile + (n0 + (l & 7) + (l >> 4) * 8) *
                                  Tile<D>::kPitch +
                              c0 + ((l >> 3) & 1) * 8));
}

// B fragments of two n8 tiles with B[k][n] = tile[k0 + k][n0 + n]: the
// tile read transposed (O += P V, dQ += dS K). b[0], b[1] serve columns
// n0..n0+7, b[2], b[3] columns n0+8..n0+15.
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_trans(b, smem_addr(tile + (k0 + (l & 7) + ((l >> 3) & 1) * 8) *
                                        Tile<D>::kPitch +
                                    n0 + (l >> 4) * 8));
}

// c += a b on the tensor cores: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[0] and c[1] += a b over the two n8 tiles of one load_b / load_bt
// fragment pair b
__device__ __forceinline__ void mma_pair(float (*c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_bf16(c[0], a, b[0], b[1]);
  mma_bf16(c[1], a, b[2], b[3]);
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the k16 A fragment made of two adjacent n8 accumulator tiles
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// a row's max / sum over the 4 lanes (one quad) that hold it
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
}  // namespace zoo
