// stream_add_one, fma_probe: the two probe kernels of the kernel bench
// (obca_torch/tools/kernel_bench.py), which measures what this card
// streams and computes, as the yardsticks of the solver kernels.  They
// run on no solver path.
//
// stream_add_one: out = x + 1 over a flat float32 array of n elements.
// Replaces tools/kernel_bench.py:236, _pstream_kernel, a Pallas copy
// pipelined over a grid of S stages of [1, nzp, nzp, Bp] blocks, which
// read the TPU's streaming rate.  On the card a grid over stages buys
// nothing (blocks run in parallel, in no order): one thread a float4
// (16-byte load and store) when both pointers are 16-byte aligned, the
// n % 4 elements past the last float4 one a thread, and one thread an
// element otherwise; no loop.  In timings on an H100 this layout
// streamed as fast as PyTorch's own x + 1, and a grid-stride loop over
// 8 resident blocks an SM, with four float4 loads in flight a thread,
// streamed more slowly.
// Bound: 8 n bytes at the card's memory rate (the bench's [128, 81,
// 56, 56] array: 260.1 MB, 0.0776 ms at 3.35 TB/s); it does nothing
// else, so its time is the rate a streaming kernel reaches on this card.
//
// fma_probe: per element, 16 independent chains y_i = x (1 + 1e-6 i),
// 16 FMAs y_i = y_i 1.0000001 + 1e-7 on each, and the 16 chains summed
// in order: 2*16*16 + 16 + 15 = 543 operations per element.  The
// counterpart of fma_chain (tools/kernel_bench.py:263-271), which has no
// pallas_call: XLA fuses that expression into one kernel.  Eager PyTorch
// runs it as about 300 separate elementwise kernels, each streaming the
// whole array, which would measure the memory rate and not the FMA
// rate; hence a kernel by hand, the chains in registers, x read once and
// the sum written once.  Bound: operations, 543 n at 67 TFLOP/s (the
// bench's array: 17.66 GFLOP, 0.2635 ms) against 0.0776 ms of bytes; 16
// independent chains cover the FMA latency.  A grid-stride loop over
// kFmaBlocksPerSm blocks an SM (two waves of the 8 that fit) ran faster
// in timings on an H100 than one wave or one element a thread.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kFmaBlocksPerSm = 16;
constexpr int kChains = 16;
constexpr int kChainLen = 16;

__global__ void __launch_bounds__(kThreads)
stream_add_one_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long n, bool vec) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (!vec) {
    if (i < n) out[i] = x[i] + 1.0f;
    return;
  }
  const long long n4 = n >> 2;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    reinterpret_cast<float4*>(out)[i] = v;
  } else if (i - n4 < (n & 3)) {
    const long long t = 4 * n4 + (i - n4);
    out[t] = x[t] + 1.0f;
  }
}

// The chains' scales 1 + 1e-6 c, rounded to float on the host as
// jnp.float32 rounds them; as a kernel argument they are constant
// operands of the multiplies.
struct ChainScales {
  float s[kChains];
};

__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, ChainScales sc) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float v = x[i];
    float y[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      y[c] = v * sc.s[c];
#pragma unroll
    for (int s = 0; s < kChainLen; ++s) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) y[c] = fmaf(y[c], 1.0000001f, 1e-7f);
    }
    float sum = y[0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) sum += y[c];
    out[i] = sum;
  }
}

OBCA_EXPORT int obca_stream_add_one_f32(const float* x, float* out,
                                        long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(x) && aligned16(out);
  const long long work = vec ? (n >> 2) + (n & 3) : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  stream_add_one_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, vec);
  return static_cast<int>(cudaGetLastError());
}

OBCA_EXPORT int obca_fma_probe_f32(const float* x, float* out, long long n,
                                   void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  ChainScales sc;
  for (int c = 0; c < kChains; ++c)
    sc.s[c] = static_cast<float>(1.0 + 1e-6 * c);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kFmaBlocksPerSm;
  const long long blocks = need < most ? (need > 0 ? need : 1) : most;
  fma_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n, sc);
  return static_cast<int>(cudaGetLastError());
}
