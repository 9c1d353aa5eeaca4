// Shared helpers for the structured-coupling block-tridiagonal kernels.
//
// Each kernel source is compiled on its own into a shared library with
// a plain C interface (nvcc -gencode arch=compute_90a,code=sm_90a) and
// loaded with ctypes; every entry point returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define OBCA_EXPORT extern "C" __attribute__((visibility("default")))

OBCA_EXPORT const char* obca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sum over the 32 lanes of a warp; every lane receives the total.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy a small int array from device memory into shared memory.
__device__ __forceinline__ void load_ints(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Dynamic shared memory above 48 KB needs an explicit opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
