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

// Copy a small int array from device memory into shared memory.
__device__ __forceinline__ void load_ints(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Asynchronous copies from device memory into shared memory (cp.async):
// 16 bytes (both addresses 16-byte aligned) or 4 bytes.  Copies issued
// between two commits form one group; cp_async_wait<N> returns once at
// most N of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers in shared memory and bulk (TMA) copies that report to them.
// A barrier initialised with count 1 completes a phase when its one
// arrival (mbar_expect_tx) and the announced bytes have both come in.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory into shared memory, reported to `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Walks e = first, first + step, ... over a row-major index space with
// m columns, keeping (row, col) without a division inside the loop (the
// two divisions happen once, here).
struct Walk2 {
  int row, col, drow, dcol, m;
  __device__ Walk2(int first, int step, int m_) : m(m_) {
    row = first / m;
    col = first - row * m;
    drow = step / m;
    dcol = step - drow * m;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= m) {
      col -= m;
      ++row;
    }
  }
};

// Dynamic shared memory above 48 KB needs an explicit opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
