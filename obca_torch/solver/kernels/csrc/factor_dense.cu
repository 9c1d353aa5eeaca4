// factor_dense: Schur recursion of the block-tridiagonal quasidefinite
// KKT system with dense coupling blocks.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:factor_batched
// (kernel body _factor_kernel with _qd_inv_b / _spd_inv_b).
//
// Per scenario b (one thread block each) and stage k = 0..S-1:
//   W_{k-1} = S_{k-1}^{-1} E_{k-1}                   (k > 0, slot k-1)
//   S_k     = K_k - E'_{k-1} W_{k-1}                 (S_0 = K_0)
//   Sinv_k  = S_k^{-1}
// K already carries the factor's diagonal regularization (the caller
// adds it); slot j of W holds S_j^{-1} E_j, as on the TPU.
//
// Inverse: Gauss-Jordan with partial pivoting (pivoted_inverse,
// common.cuh), shared with factor_se, in place of the TPU's pivot-free,
// primal-first _qd_inv_b, which is off by a relative 6.51 in f32 on the
// main path's real stage-0 block (PERF.md).
//
// Shared memory: three nz x nz buffers (37.6 KB at nz=56, f32).  X holds
// Sinv_{k-1}, Y holds E_{k-1}; Z = X Y is W_{k-1}; then X is overwritten
// by K_k - Y' Z (Sinv_{k-1} is no longer needed) and inverted in place,
// so X carries Sinv_k to the next stage.  Products are one thread per
// output element: in X Y the warp reads one X element (broadcast) and
// consecutive Y elements; in Y' Z one Y element and consecutive Z ones.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), main-path shape B=128, S=81, nz=56: bytes K 130.1 MB + E
// 128.5 MB in, Sinv 130.1 MB + W 128.5 MB out ~ 517 MB (~154 us);
// operations 3 x 2 nz^3 per stage (two products and the inverse)
// ~ 10.9 GFLOP (~163 us): bound by operations.  This design is
// latency-bound like factor_se: S stages of nz pivots, each three block
// barriers, on 128 blocks.
#include "common.cuh"

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
factor_dense_kernel(const float* __restrict__ K, const float* __restrict__ E,
                    int S, int nz, float* __restrict__ Sinv,
                    float* __restrict__ W) {
  extern __shared__ float smem[];
  const int blk_n = nz * nz;
  float* X = smem;            // [nz, nz] Sinv_{k-1}, then S_k in place
  float* Y = X + blk_n;       // [nz, nz] E_{k-1}
  float* Z = Y + blk_n;       // [nz, nz] W_{k-1}
  float* rowp = Z + blk_n;    // [nz] pivot row
  float* rowq = rowp + nz;    // [nz] row it swaps with
  float* colp = rowq + nz;    // [nz] pivot column
  int* perm = reinterpret_cast<int*>(colp + nz);  // [nz]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t blk = static_cast<size_t>(blk_n);
  const float* Kb = K + static_cast<size_t>(b) * S * blk;
  const float* Eb = E + static_cast<size_t>(b) * (S - 1) * blk;
  float* Sb = Sinv + static_cast<size_t>(b) * S * blk;
  float* Wb = W + static_cast<size_t>(b) * (S - 1) * blk;

  for (int e = tid; e < blk_n; e += nt) X[e] = Kb[e];
  for (int k = 0; k < S; ++k) {
    if (k > 0) {
      const float* Ek = Eb + (k - 1) * blk;
      for (int e = tid; e < blk_n; e += nt) Y[e] = Ek[e];
      __syncthreads();
      // Z = X Y = Sinv_{k-1} E_{k-1}
      float* Wk = Wb + (k - 1) * blk;
      for (int e = tid; e < blk_n; e += nt) {
        const int i = e / nz;
        const int j = e - i * nz;
        float acc = 0.0f;
        for (int l = 0; l < nz; ++l) acc += X[i * nz + l] * Y[l * nz + j];
        Z[e] = acc;
        Wk[e] = acc;
      }
      __syncthreads();
      // X = K_k - Y' Z
      const float* Kk = Kb + k * blk;
      for (int e = tid; e < blk_n; e += nt) {
        const int i = e / nz;
        const int j = e - i * nz;
        float acc = 0.0f;
        for (int l = 0; l < nz; ++l) acc += Y[l * nz + i] * Z[l * nz + j];
        X[e] = Kk[e] - acc;
      }
    }
    pivoted_inverse(X, nz, rowp, rowq, colp, perm);
    float* Sk = Sb + k * blk;
    for (int e = tid; e < blk_n; e += nt) Sk[e] = X[e];
  }
}

OBCA_EXPORT int obca_factor_dense_f32(const float* K, const float* E, int B,
                                      int S, int nz, float* Sinv, float* W,
                                      void* stream) {
  const size_t smem = sizeof(float) * (3 * nz * nz + 3 * nz)
                      + sizeof(int) * nz;
  cudaError_t err = allow_smem(factor_dense_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_dense_kernel<<<B, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      K, E, S, nz, Sinv, W);
  return static_cast<int>(cudaGetLastError());
}
