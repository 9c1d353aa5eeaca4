// fwd_dense, bwd_dense: forward and backward substitution through the
// factored block-tridiagonal system with dense coupling blocks.
//
// Replace obca_tpu/solver/pallas/blocktri_kernel.py:solve_batched (its
// two pallas_calls, kernel bodies _fwd_kernel and _bwd_kernel).
//
// Per scenario b (one thread block each):
//   fwd_dense, stages k = 0..S-1 in order:
//     yhat_k = r_k - E'_{k-1} y_{k-1}   (yhat_0 = r_0)
//     y_k    = Sinv_k yhat_k
//   bwd_dense, stages k = S-1..0 in order:
//     x_{S-1} = y_{S-1},  x_k = y_k - W_k x_{k+1}
// (E' y)[i] = sum_l E[l][i] y[l] is one thread per output i, so a warp
// reads consecutive elements of a row of E; Sinv_k yhat and W_k x are
// one warp per row (contiguous, coalesced), as in fwd_se.
//
// Bounds on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56:
// fwd_dense Sinv 130.1 MB + E 128.5 MB + r 2.3 MB in, y 2.3 MB out
// ~ 263 MB (~79 us); bwd_dense W 128.5 MB + y 2.3 MB in, x 2.3 MB out
// ~ 133 MB (~40 us); 4 nz^2 S B and 2 nz^2 S B operations are negligible.
// Memory-bound on paper; the chain of S dependent stages, each waiting
// on one or two 12.5 KB blocks, makes both latency-bound.
#include "common.cuh"

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
fwd_dense_kernel(const float* __restrict__ Sinv, const float* __restrict__ E,
                 const float* __restrict__ r, int S, int nz,
                 float* __restrict__ y) {
  extern __shared__ float smem[];
  float* yprev = smem;        // [nz] y_{k-1}
  float* yhat = yprev + nz;   // [nz]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t blk = static_cast<size_t>(nz) * nz;
  const float* Sb = Sinv + static_cast<size_t>(b) * S * blk;
  const float* Eb = E + static_cast<size_t>(b) * (S - 1) * blk;
  const float* rb = r + static_cast<size_t>(b) * S * nz;
  float* yb = y + static_cast<size_t>(b) * S * nz;

  for (int k = 0; k < S; ++k) {
    for (int i = tid; i < nz; i += blockDim.x) {
      float sub = 0.0f;
      if (k > 0) {
        const float* Ek = Eb + (k - 1) * blk;
        for (int l = 0; l < nz; ++l) sub += Ek[l * nz + i] * yprev[l];
      }
      yhat[i] = rb[k * nz + i] - sub;
    }
    __syncthreads();
    const float* Sk = Sb + k * blk;
    for (int row = warp; row < nz; row += nwarps) {
      const float* Srow = Sk + row * nz;
      float acc = 0.0f;
      for (int c = lane; c < nz; c += 32) acc += Srow[c] * yhat[c];
      acc = warp_sum(acc);
      if (lane == 0) {
        yprev[row] = acc;
        yb[k * nz + row] = acc;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_dense_kernel(const float* __restrict__ W, const float* __restrict__ y,
                 int S, int nz, float* __restrict__ x) {
  extern __shared__ float smem[];
  float* buf = smem;  // [2, nz] x_{k+1} and x_k, alternating

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t blk = static_cast<size_t>(nz) * nz;
  const float* Wb = W + static_cast<size_t>(b) * (S - 1) * blk;
  const float* yb = y + static_cast<size_t>(b) * S * nz;
  float* xb = x + static_cast<size_t>(b) * S * nz;

  for (int i = tid; i < nz; i += blockDim.x) {
    const float v = yb[(S - 1) * nz + i];
    buf[((S - 1) & 1) * nz + i] = v;
    xb[(S - 1) * nz + i] = v;
  }
  __syncthreads();
  for (int k = S - 2; k >= 0; --k) {
    const float* xn = buf + ((k + 1) & 1) * nz;  // x_{k+1}
    float* xc = buf + (k & 1) * nz;              // x_k
    const float* Wk = Wb + k * blk;
    for (int row = warp; row < nz; row += nwarps) {
      const float* Wrow = Wk + row * nz;
      float acc = 0.0f;
      for (int c = lane; c < nz; c += 32) acc += Wrow[c] * xn[c];
      acc = warp_sum(acc);
      if (lane == 0) {
        const float v = yb[k * nz + row] - acc;
        xc[row] = v;
        xb[k * nz + row] = v;
      }
    }
    // One barrier a stage: stage k-1 writes the slot stage k read.
    __syncthreads();
  }
}

OBCA_EXPORT int obca_fwd_dense_f32(const float* Sinv, const float* E,
                                   const float* r, int B, int S, int nz,
                                   float* y, void* stream) {
  const size_t smem = sizeof(float) * 2 * nz;
  cudaError_t err = allow_smem(fwd_dense_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_dense_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Sinv, E, r, S, nz, y);
  return static_cast<int>(cudaGetLastError());
}

OBCA_EXPORT int obca_bwd_dense_f32(const float* W, const float* y, int B,
                                   int S, int nz, float* x, void* stream) {
  const size_t smem = sizeof(float) * 2 * nz;
  cudaError_t err = allow_smem(bwd_dense_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dense_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      W, y, S, nz, x);
  return static_cast<int>(cudaGetLastError());
}
