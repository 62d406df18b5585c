// Host side of the TMA loads of the wgmma attention kernels (K1's bf16
// kernel in csrc/flash_fwd.cu, K3's and K4's in csrc/flash_bwd.cu): the
// tensor maps of their (B, T, H, D) bf16 operands, encoded with
// cuTensorMapEncodeTiled, which the runtime's cudaGetDriverEntryPoint
// hands over (no link to libcuda).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace zoo {
namespace tma {

constexpr int kBox = 64;  // columns (bf16, 128 bytes) a box holds

// a tensor map that cuTensorMapEncodeTiled refused (or could not be found)
constexpr int kErrTensorMap = 10000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 4-D map (d, H, T, B) of a bf16 operand with element strides (sb, st,
// sh) and a contiguous head dim, read in boxes of 64 columns x `rows`
// positions of one head and batch, 128-byte swizzled; coordinates past
// the tensor read as zeros. The stride of a dim of size 1 is never used:
// it is replaced by one TMA accepts (a multiple of 16 bytes).
inline bool encode_operand(CUtensorMap* map, const void* ptr, int B, int H,
                           int T, int d, long long sb, long long st,
                           long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)T,
                        (cuuint64_t)B};
  long long el[3] = {sh, st, sb};
  cuuint64_t strides[3];
  long long span = (long long)d * 2;  // bytes the dims below reach
  for (int i = 0; i < 3; ++i) {
    long long s = el[i] * 2;
    if (dims[i + 1] == 1) s = (span + 15) / 16 * 16;
    strides[i] = (cuuint64_t)s;
    span = s * (long long)dims[i + 1];
  }
  cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_operand through a small per-thread cache keyed by everything the
// map is encoded from: a wrapper called again on tensors at the same
// addresses and geometry (the caching allocator hands the same blocks to
// each layer and micro-step) skips the encode's host time. A map holds
// only the address and the geometry, so a hit is right whatever tensor
// lies there now.
inline bool cached_operand(CUtensorMap* map, const void* ptr, int B, int H,
                           int T, int d, long long sb, long long st,
                           long long sh, int rows) {
  struct Key {
    const void* ptr;
    long long v[8];
  };
  constexpr int kSlots = 32;
  thread_local Key keys[kSlots] = {};
  thread_local CUtensorMap maps[kSlots];
  thread_local int next = 0;
  const Key key{ptr, {B, H, T, d, sb, st, sh, rows}};
  for (int i = 0; i < kSlots; ++i) {
    bool same = keys[i].ptr == key.ptr && key.ptr != nullptr;
    for (int j = 0; same && j < 8; ++j) same = keys[i].v[j] == key.v[j];
    if (same) {
      *map = maps[i];
      return true;
    }
  }
  if (!encode_operand(map, ptr, B, H, T, d, sb, st, sh, rows)) return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kSlots;
  return true;
}

// blocks for a persistent launch of `items` work items: one an SM (the
// count read once a device), or fewer when there are fewer items; 0 (and
// `err` set) on a failure
inline int persistent_grid(long long items, cudaError_t* err) {
  static int sms_of[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  int sms = sms_of[dev & 63];
  if (sms == 0) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    sms_of[dev & 63] = sms;
  }
  if (items > (1ll << 30)) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  return (int)(items < sms ? items : sms);
}

}  // namespace tma
}  // namespace zoo
