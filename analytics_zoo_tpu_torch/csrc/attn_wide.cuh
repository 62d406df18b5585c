// Wide-head attention tiles: the FMA machinery of the attention kernels
// that take any head dim — K1's `flash_fwd_wide_kernel`, K3's
// `flash_bwd_dq_wide_kernel`, K4's `flash_bwd_dkv_wide_kernel` and K2's
// `paged_attn_wide_kernel`. They run every head dim above 256, which no
// compile-time tile of the other kernels holds in registers or shared
// memory, in f32 and bf16, and K2's bf16 head dims that are not a
// multiple of 8, which its pool's rows cannot feed to 16-byte copies.
//
// A block of kThreads threads owns kRows rows (queries, or keys in K4)
// and one slice of kSlice output columns; the other slices of the same
// rows are other blocks (grid dimension z, each block looping when there
// are more slices than the grid holds), which recompute the scores. The
// streamed operand comes kCols rows a tile. A score tile is summed over
// the head dim in chunks of kChunk columns staged through shared memory,
// so neither registers nor shared memory grow with d, and the products
// P V, dS K, P^T dO and dS^T Q read a (kCols, kSlice) slice staged the
// same way. Everything is f32 FMA: these head dims are correct first
// (no model of the repo has one); the operands are read in their storage
// dtype and P and dS rounded to it before their products, as in the JAX
// kernels. Thread layout: row r = tid / 8; score columns tid % 8 + 8 u
// (u < 4); output columns tid % 8 + 8 u (u < 8).
#pragma once

#include "zoo_cuda.cuh"

namespace zoo {
namespace wide {

constexpr int kThreads = 256;
constexpr int kRows = 32;   // rows a block owns
constexpr int kCols = 32;   // rows of the streamed operand a tile
constexpr int kChunk = 64;  // head-dim columns a score chunk stages
constexpr int kSlice = 64;  // output columns a block owns
constexpr int kPitch = kChunk + 1;
constexpr int kScores = kRows * kCols / kThreads;  // score elements a thread
constexpr int kOut = kRows * kSlice / kThreads;    // output elements a thread
static_assert(kRows == kCols && kCols == 32 && kThreads == 256,
              "the layouts below assume 32 x 32 tiles over 8 warps");

// output slices of a head dim d
__host__ __device__ inline int slices(int d) {
  return (d + kSlice - 1) / kSlice;
}

// x rounded to T and back (a no-op in f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// s[u] = sum over x < d of A[r][x] B[c][x], r = tid / 8, c = tid % 8 + 8 u:
// a(i) and b(i) give row i's first element, or nullptr for a row past its
// tensor (read as zeros). Every thread of the block calls it.
template <typename T, typename RowA, typename RowB>
__device__ __forceinline__ void scores(float (&s)[kScores], RowA a, RowB b,
                                       int d, float (*sa)[kPitch],
                                       float (*sb)[kPitch]) {
  const int tid = threadIdx.x;
  const int r = tid >> 3, c = tid & 7;
#pragma unroll
  for (int u = 0; u < kScores; ++u) s[u] = 0.f;
  for (int x0 = 0; x0 < d; x0 += kChunk) {
    __syncthreads();  // the last chunk (and the caller's last tile) is read
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int row = i / kChunk, x = i % kChunk;
      const T* pa = a(row);
      const T* pb = b(row);
      sa[row][x] = pa != nullptr && x0 + x < d ? to_f(pa[x0 + x]) : 0.f;
      sb[row][x] = pb != nullptr && x0 + x < d ? to_f(pb[x0 + x]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int x = 0; x < kChunk; ++x) {
      const float av = sa[r][x];
#pragma unroll
      for (int u = 0; u < kScores; ++u) s[u] = fmaf(av, sb[c + 8 * u][x], s[u]);
    }
  }
}

// sv[j][x] = column c0 + x of row j of the streamed operand (zero past
// its rows and past d)
template <typename T, typename Row>
__device__ __forceinline__ void stage_slice(float (*sv)[kSlice], Row row,
                                            int c0, int d) {
  for (int i = threadIdx.x; i < kCols * kSlice; i += kThreads) {
    const int j = i / kSlice, x = i % kSlice;
    const T* p = row(j);
    sv[j][x] = p != nullptr && c0 + x < d ? to_f(p[c0 + x]) : 0.f;
  }
}

// out[u] += sum over j of w[r][j] sv[j][tid % 8 + 8 u], r = tid / 8
__device__ __forceinline__ void accumulate(float (&out)[kOut],
                                           const float (*w)[kCols + 1],
                                           const float (*sv)[kSlice]) {
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
#pragma unroll 4
  for (int j = 0; j < kCols; ++j) {
    const float wv = w[r][j];
#pragma unroll
    for (int u = 0; u < kOut; ++u) out[u] = fmaf(wv, sv[j][c + 8 * u], out[u]);
  }
}

// write this thread's outputs (times f) as row r = tid / 8 of rows lying
// `stride` elements apart from `out`, columns c0 + tid % 8 + 8 u below d
template <typename T>
__device__ __forceinline__ void store(T* out, long long stride, int rows,
                                      const float (&acc)[kOut], float f,
                                      int c0, int d) {
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  if (r >= rows) return;
#pragma unroll
  for (int u = 0; u < kOut; ++u)
    if (c0 + c + 8 * u < d)
      out[r * stride + c0 + c + 8 * u] = from_f<T>(acc[u] * f);
}

// One block's rows of O = softmax(scale Q K^T) V, online over the keys
// 0 .. n_keys in tiles of kCols, for the block's output slices: q(i),
// k(j) and v(j) give query row i of the block and key j's rows (nullptr
// past them), visible(i, j) whether row i sees key j (the causal or
// length mask). P is rounded to T before P V and l sums it unrounded, as
// K1's and K2's other kernels do. Writes `rows` rows of O from `o`
// (`o_stride` apart; a row that sees no key is 0) and, when `lse` is not
// null, the rows' f32 log-sum-exp. Every thread of the block calls it.
template <typename T, typename QRow, typename KRow, typename VRow,
          typename Visible>
__device__ __forceinline__ void attend(QRow q, KRow k, VRow v, int n_keys,
                                       Visible visible, int d, float scale,
                                       T* o, long long o_stride, int rows,
                                       float* lse) {
  __shared__ float sa[kRows][kPitch], sb[kCols][kPitch];
  __shared__ float sp[kRows][kCols + 1];
  __shared__ float sv[kCols][kSlice];
  __shared__ float m_s[kRows], l_s[kRows], corr_s[kRows];
  const int tid = threadIdx.x;
  const int r = tid >> 3, c = tid & 7;
  const int warp = tid >> 5, lane = tid & 31;
  for (int sl = blockIdx.z; sl < slices(d); sl += gridDim.z) {
    const int c0 = sl * kSlice;
    float acc[kOut];
#pragma unroll
    for (int u = 0; u < kOut; ++u) acc[u] = 0.f;
    __syncthreads();  // the last slice's epilogue has read m_s and l_s
    if (tid < kRows) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    for (int k0 = 0; k0 < n_keys; k0 += kCols) {
      auto kt = [&](int j) { return k0 + j < n_keys ? k(k0 + j) : nullptr; };
      auto vt = [&](int j) { return k0 + j < n_keys ? v(k0 + j) : nullptr; };
      float s[kScores];
      scores<T>(s, q, kt, d, sa, sb);
#pragma unroll
      for (int u = 0; u < kScores; ++u) sp[r][c + 8 * u] = s[u] * scale;
      __syncthreads();
      // the online softmax: a warp a row, a lane a key
      for (int i = warp; i < kRows; i += kThreads / 32) {
        const bool ok = k0 + lane < n_keys && visible(i, k0 + lane);
        const float x = sp[i][lane];
        const float m_old = m_s[i];
        const float m_new = fmaxf(m_old, warp_max(ok ? x : kNegInf));
        const float p = ok ? expf(x - m_new) : 0.f;
        const float sum = warp_sum(p);
        sp[i][lane] = round_to<T>(p);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[i] = corr;
          l_s[i] = l_s[i] * corr + sum;
          m_s[i] = m_new;
        }
      }
      stage_slice<T>(sv, vt, c0, d);
      __syncthreads();
      const float corr = corr_s[r];
#pragma unroll
      for (int u = 0; u < kOut; ++u) acc[u] *= corr;
      accumulate(acc, sp, sv);
    }
    __syncthreads();
    const float l = l_s[r];
    store<T>(o, o_stride, rows, acc, l > 0.f ? 1.f / l : 0.f, c0, d);
    if (lse != nullptr && sl == 0 && c == 0 && r < rows)
      lse[r] = m_s[r] + logf(l > 0.f ? l : 1.f);
  }
}

}  // namespace wide
}  // namespace zoo
