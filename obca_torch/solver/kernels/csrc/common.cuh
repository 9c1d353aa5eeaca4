// Shared helpers for the block-tridiagonal kernels.
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

// In-place Gauss-Jordan inverse of the n x n row-major block `a` with
// partial pivoting: at step p the row with the largest |a[i][p]|, i >= p,
// is swapped into place (perm[p] records it), and the inverse's columns
// are unscrambled at the end, last interchange first.
// rowp, rowq, colp: [n] scratch; perm: [n].  Every thread of the block
// takes part; the call begins and ends with a block barrier.
__device__ inline void pivoted_inverse(float* a, int n, float* rowp,
                                       float* rowq, float* colp, int* perm) {
  const int tid = threadIdx.x;
  for (int p = 0; p < n; ++p) {
    __syncthreads();
    if (tid < 32) {
      // Largest |a[i][p]| over the remaining rows; ties to the smaller row.
      float best = -1.0f;
      int bi = p;
      for (int i = p + tid; i < n; i += 32) {
        const float v = fabsf(a[i * n + p]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (tid == 0) perm[p] = bi;
    }
    __syncthreads();
    const int r = perm[p];
    for (int i = tid; i < n; i += blockDim.x) {
      rowp[i] = a[r * n + i];  // the pivot row, moving to p
      rowq[i] = a[p * n + i];  // the old row p, moving to r
      colp[i] = a[i * n + p];
    }
    __syncthreads();
    const float d = 1.0f / rowp[p];
    for (int e = tid; e < n * n; e += blockDim.x) {
      const int i = e / n;
      const int j = e - i * n;
      float v;
      if (i == p) {
        v = (j == p) ? d : rowp[j] * d;
      } else {
        const bool moved = (i == r);
        const float c = moved ? rowq[p] : colp[i];
        v = (j == p) ? -c * d
                     : (moved ? rowq[j] : a[e]) - c * (rowp[j] * d);
      }
      a[e] = v;
    }
  }
  // inv(A) = inv(P A) P: swap columns back, last interchange first.
  for (int p = n - 1; p >= 0; --p) {
    __syncthreads();
    const int r = perm[p];
    if (r != p) {
      for (int i = tid; i < n; i += blockDim.x) {
        const float t = a[i * n + p];
        a[i * n + p] = a[i * n + r];
        a[i * n + r] = t;
      }
    }
  }
  __syncthreads();
}
