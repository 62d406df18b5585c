// Small helpers shared by the port's CUDA kernels: storage-dtype <-> f32
// conversion and warp reductions. Every kernel keeps its arithmetic in f32
// and reads/writes its tensors in their storage dtype (f32 or bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zoo {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

// What the tile table records of a kernel instance (ops/tuning.py): into
// out[0..2] its registers a thread, its static shared memory and the
// dynamic shared memory its launch asks for, in bytes. Returns the CUDA
// error of cudaFuncGetAttributes.
template <typename Kernel>
inline int kernel_attrs(Kernel kernel, int dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = dynamic_smem;
  return 0;
}

}  // namespace zoo
