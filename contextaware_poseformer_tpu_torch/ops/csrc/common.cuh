// Shared helpers for the port's hand-written kernels (sm_90a).
//
// Every kernel stores in T (float or __nv_bfloat16) and computes in fp32.
// round_to<T> reproduces a store-and-reload through T, at the points where
// the JAX kernels cast an intermediate to the compute dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace capf {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch .to()
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// grid_sample's [-1, 1] -> pixel mapping (ops/grid_sample.py), shared by
// the sampler's forward (K1) and backward (K6)
__device__ __forceinline__ float unnormalize(float v, int size, bool align) {
  return align ? (v + 1.f) * 0.5f * static_cast<float>(size - 1)
               : ((v + 1.f) * static_cast<float>(size) - 1.f) * 0.5f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace capf
