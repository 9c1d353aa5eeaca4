// fwd_se: forward substitution through the factored block-tridiagonal
// system with a sparse coupling block.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:fwd_se (kernel body
// _fwd_se_kernel).
//
// Per scenario b (one thread block each), stages k = 0..S-1 in order:
//   yhat_k = r_k - E'_{k-1} y_{k-1}   (yhat[cols[j]] -= ev_j y_{k-1}[rows[j]])
//   y_k    = Sinv_k yhat_k
// The sparse correction is one thread per output row (deterministic, no
// atomics); the dense product is one warp per row of Sinv_k, whose row is
// contiguous in memory, so each warp's loads coalesce without staging.
//
// Bound on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56:
// bytes Sinv 130.0 MB + r 2.3 MB in + y 2.3 MB out ~ 135 MB (~40 us);
// 2 nz^2 S B ~ 65 MFLOP is negligible.  Memory-bound on paper; the
// stage-to-stage dependency makes each block wait for one Sinv_k block
// (12.5 KB) per stage, so this design is latency-bound.
#include "common.cuh"

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
fwd_se_kernel(const float* __restrict__ Sinv, const float* __restrict__ ev,
              const float* __restrict__ r, const int* __restrict__ rows,
              const int* __restrict__ cols, int S, int nz, int nnz,
              float* __restrict__ y) {
  extern __shared__ float smem[];
  float* yprev = smem;          // [nz] y_{k-1}
  float* yhat = yprev + nz;     // [nz]
  int* irow = reinterpret_cast<int*>(yhat + nz);  // [nnz]
  int* icol = irow + nnz;                          // [nnz]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t blk = static_cast<size_t>(nz) * nz;
  const float* Sb = Sinv + static_cast<size_t>(b) * S * blk;
  const float* evb = ev + static_cast<size_t>(b) * (S - 1) * nnz;
  const float* rb = r + static_cast<size_t>(b) * S * nz;
  float* yb = y + static_cast<size_t>(b) * S * nz;

  load_ints(irow, rows, nnz);
  load_ints(icol, cols, nnz);
  __syncthreads();

  for (int k = 0; k < S; ++k) {
    for (int i = tid; i < nz; i += blockDim.x) {
      float sub = 0.0f;
      if (k > 0) {
        const float* evk = evb + (k - 1) * nnz;
        for (int j = 0; j < nnz; ++j)
          if (icol[j] == i) sub += evk[j] * yprev[irow[j]];
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

OBCA_EXPORT int obca_fwd_se_f32(const float* Sinv, const float* ev,
                                const float* r, const int* rows,
                                const int* cols, int B, int S, int nz,
                                int nnz, float* y, void* stream) {
  const size_t smem = sizeof(float) * 2 * nz + sizeof(int) * 2 * nnz;
  cudaError_t err = allow_smem(fwd_se_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_se_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Sinv, ev, r, rows, cols, S, nz, nnz, y);
  return static_cast<int>(cudaGetLastError());
}
