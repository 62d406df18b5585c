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
// card's ratio of operations to bytes.
//
// What the simple design does about it: one block per (head, slot). The block
// reads its own lengths[b] and table row (the TPU kernel's scalar prefetch)
// and walks only the positions below the length, 64 keys per tile (32 at
// D=128): each tile
// gathers the keys' pages from the pool with coalesced row loads into shared
// memory as f32, so no contiguous copy of the cache and no dtype copy of the
// pool ever exists. Scores come from thread pairs (interleaved half dots
// joined by a shuffle), one warp per query row folds a tile into the f32
// online softmax (m, l), and the f32 accumulator is spread over the block.
// FMA loops: correct first; more heads per block, split-K over long contexts
// and tensor cores are later work.
#include <stdint.h>

#include "zoo_cuda.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQLen = 16;  // decode (1), speculative verify (k), chunks

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const int* __restrict__ table,
                      const int* __restrict__ lengths, T* __restrict__ o,
                      int H, int q_len, int page_size, int pages_per_slot,
                      long long qsb, long long qst, long long qsh,
                      long long psp, long long pst, long long psh,
                      float scale) {
  constexpr int DP = D + 2;  // row pitch: pairs of lanes on distinct banks
  // keys per shared-memory tile: keeps the static shared memory under 48 KB
  constexpr int kKT = D == 64 ? 64 : 32;
  constexpr int DH = D / 2;
  constexpr int kElems = kMaxQLen * D / kThreads;  // acc elements per thread
  __shared__ float qs[kMaxQLen][DP];
  __shared__ float ks[kKT][DP];
  __shared__ float vs[kKT][DP];
  __shared__ float ss[kMaxQLen][kKT];
  __shared__ float m_s[kMaxQLen];
  __shared__ float l_s[kMaxQLen];
  __shared__ float corr_s[kMaxQLen];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int length = lengths[b];
  const int* trow = table + (long long)b * pages_per_slot;
  const int max_pos = pages_per_slot * page_size;

  for (int idx = tid; idx < q_len * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    qs[r][c] = zoo::to_f(q[b * qsb + r * qst + h * qsh + c]);
  }
  if (tid < q_len) {
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

  for (int k0 = 0; k0 < n_pos; k0 += kKT) {
    __syncthreads();  // previous tile consumed; q/m/l initialised
    // gather this tile's keys from their pages
    for (int idx = tid; idx < kKT * D; idx += kThreads) {
      const int j = idx / D;
      const int c = idx % D;
      const int pos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (pos < n_pos) {
        const int page = trow[pos / page_size];
        const long long off = page * psp + (long long)(pos % page_size) * pst +
                              h * psh + c;
        kv = zoo::to_f(kp[off]);
        vv = zoo::to_f(vp[off]);
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    __syncthreads();
    // scores: two threads per (row, key)
    for (int idx = pair; idx < q_len * kKT; idx += kThreads / 2) {
      const int r = idx / kKT;
      const int j = idx % kKT;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i)
        part = fmaf(qs[r][2 * i + half], ks[j][2 * i + half], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) ss[r][j] = part * scale;
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int r = warp; r < q_len; r += kWarps) {
      const int bound = length - q_len + r;  // last position row r sees
      float sv[kKT / 32];
      float tmax = zoo::kNegInf;
#pragma unroll
      for (int u = 0; u < kKT / 32; ++u) {
        const int j = lane + 32 * u;
        sv[u] = (k0 + j <= bound) ? ss[r][j] : zoo::kNegInf;
        tmax = fmaxf(tmax, sv[u]);
      }
      tmax = zoo::warp_max(tmax);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kKT / 32; ++u) {
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
      const int d = e % D;
      if (r < q_len) {
        float a = acc[u] * corr_s[r];
#pragma unroll 8
        for (int j = 0; j < kKT; ++j) a = fmaf(ss[r][j], vs[j][d], a);
        acc[u] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int e = tid + kThreads * u;
    const int r = e / D;
    const int d = e % D;
    if (r < q_len) {
      const float l = l_s[r];
      const float safe_l = l == 0.f ? 1.f : l;  // no valid position -> 0
      o[(((long long)b * q_len + r) * H + h) * D + d] =
          zoo::from_f<T>(acc[u] / safe_l);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* kp, const void* vp, const int* table,
            const int* lengths, void* o, int B, int H, int q_len,
            int page_size, int pages_per_slot, const long long* qs,
            const long long* ps, float scale, cudaStream_t stream) {
  dim3 grid(H, B);
  paged_attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(o), H, q_len,
      page_size, pages_per_slot, qs[0], qs[1], qs[2], ps[0], ps[1], ps[2],
      scale);
}

}  // namespace

// q strides (slot, query row, head) and pool strides (page, in-page position,
// head) are in elements; the head dim is contiguous in both, and k_pages and
// v_pages share their strides. o is a contiguous (B, q_len, H, D) tensor.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape or dtype it does not take).
extern "C" int zoo_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, void* o, int dtype,
                                   int B, int H, int D, int q_len,
                                   int page_size, int pages_per_slot,
                                   long long qsb, long long qst, long long qsh,
                                   long long psp, long long pst, long long psh,
                                   float scale, void* stream) {
  const long long qs[3] = {qsb, qst, qsh};
  const long long ps[3] = {psp, pst, psh};
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_len < 1 || q_len > kMaxQLen || B < 1 || H < 1 || page_size < 1 ||
      pages_per_slot < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == zoo::kF32 && D == 64)
    launch<float, 64>(q, k_pages, v_pages, tb, ln, o, B, H, q_len, page_size, pages_per_slot, qs, ps, scale, st);
  else if (dtype == zoo::kF32 && D == 128)
    launch<float, 128>(q, k_pages, v_pages, tb, ln, o, B, H, q_len, page_size, pages_per_slot, qs, ps, scale, st);
  else if (dtype == zoo::kBF16 && D == 64)
    launch<__nv_bfloat16, 64>(q, k_pages, v_pages, tb, ln, o, B, H, q_len, page_size, pages_per_slot, qs, ps, scale, st);
  else if (dtype == zoo::kBF16 && D == 128)
    launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tb, ln, o, B, H, q_len, page_size, pages_per_slot, qs, ps, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
