// Shared helpers of the port's CUDA kernels (fp32 math, fp32/bf16 storage).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lln {

constexpr float kEps = 1e-6f;       // LLN normalizer guard (reference EPS)
constexpr float kNegInf = -1e30f;   // masked score (reference NEG_INF)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);       // round to nearest even, as torch
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Allow a kernel more than 48 KB of dynamic shared memory when it asks.
// Past the block's opt-in limit (232,448 bytes on the H100) the attribute
// is refused with cudaErrorInvalidValue: returned here, and cleared from
// the runtime's last-error state, so that it is reported by this launch
// and not again by the next launch's cudaGetLastError().
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Registers and local (spill) bytes a thread, CTAs per SM at `threads`
// threads, and `bytes` of dynamic shared memory, of one kernel, into
// out[0..3] (the last is `bytes`).
template <typename Kernel>
inline cudaError_t kernel_attrs(Kernel kernel, int threads, size_t bytes,
                                int* out) {
  cudaError_t err = allow_smem(kernel, bytes);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        threads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = ctas;
  out[3] = static_cast<int>(bytes);
  return cudaSuccess;
}

}  // namespace lln
