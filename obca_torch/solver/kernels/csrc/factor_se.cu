// factor_se: Schur recursion of the block-tridiagonal quasidefinite KKT
// system with a sparse, constant-pattern coupling block.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:factor_batched_se
// (kernel body _factor_se_kernel with _qd_inv_b / _spd_inv_b).
//
// Per scenario b (one thread block each) and stage k = 0..S-1:
//   S_k    = K_k + diag(reg) - E'_{k-1} S_{k-1}^{-1} E_{k-1}
//   Sinv_k = S_k^{-1}
//   Wc_k   = (S_k^{-1} E_k)[:, ucols]          (k < S-1, stored at slot k)
// E_k has nnz values ev[b, k, j] at static (rows[j], cols[j]); only the
// C x C block on E's distinct columns (ucols) receives a Schur update.
//
// Inverse: in-place Gauss-Jordan elimination with partial (row) pivoting
// (pivoted_inverse, common.cuh), in place of the TPU kernel's pivot-free,
// primal-block-first recursive halving.  Measured on the main path's first IPM iteration (B=128,
// N=80, f32; see PERF.md), the primal-first order leaves the stage
// inverse with a relative error near 1e2 whether or not rows are
// swapped inside each block (the TPU scheme returns non-finite blocks on
// 46 of 128 lanes there), although the whole stage block has a condition
// number near 2e4; partial pivoting over all rows gives 6e-7.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at the main-path shape B=128, S=81, nz=56, nnz=11, C=11:
// bytes K 130.1 MB in + Sinv 130.1 MB out + Wc 25.2 MB out ~ 286 MB
// (~85 us); operations 2 nz^3 per stage-inverse ~ 3.6 GFLOP (~54 us).
// Memory-bound on paper.  This design is latency-bound instead: the S
// stages of a scenario are sequential and each of the nz pivots of a
// stage takes three block-wide barrier steps (pivot search, row fetch,
// update), so 128 blocks (one per scenario, 128 of 132 SMs) each walk
// 3 S nz = 13608 barrier steps.  The working
// block lives in shared memory (nz*nz floats); K, Sinv and Wc stream
// through device memory once.
#include "common.cuh"

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
factor_se_kernel(const float* __restrict__ K, const float* __restrict__ ev,
                 const float* __restrict__ reg, const int* __restrict__ rows,
                 const int* __restrict__ cidx,
                 const int* __restrict__ ucols, int S, int nz, int nnz,
                 int C, float* __restrict__ Sinv, float* __restrict__ Wc) {
  extern __shared__ float smem[];
  float* a = smem;              // [nz, nz] working stage block
  float* w = a + nz * nz;       // [nz, C]  Wc of the previous stage
  float* rowp = w + nz * C;     // [nz]     pivot row
  float* rowq = rowp + nz;      // [nz]     row it swaps with
  float* colp = rowq + nz;      // [nz]     pivot column
  float* evs = colp + nz;       // [nnz]    coupling values of E_{k-1}
  int* irow = reinterpret_cast<int*>(evs + nnz);  // [nnz]
  int* icid = irow + nnz;                          // [nnz]
  int* iuc = icid + nnz;                           // [C]
  int* perm = iuc + C;                             // [nz]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t blk = static_cast<size_t>(nz) * nz;
  const float* Kb = K + static_cast<size_t>(b) * S * blk;
  const float* evb = ev + static_cast<size_t>(b) * (S - 1) * nnz;
  const float* regb = reg + static_cast<size_t>(b) * nz;
  float* Sb = Sinv + static_cast<size_t>(b) * S * blk;
  float* Wb = Wc + static_cast<size_t>(b) * (S - 1) * nz * C;

  load_ints(irow, rows, nnz);
  load_ints(icid, cidx, nnz);
  load_ints(iuc, ucols, C);

  for (int k = 0; k < S; ++k) {
    const float* Kk = Kb + k * blk;
    for (int e = tid; e < nz * nz; e += nt) {
      const int i = e / nz;
      a[e] = Kk[e] + ((e == i * nz + i) ? regb[i] : 0.0f);
    }
    __syncthreads();
    if (k > 0) {
      // S_k[ucols[ai], ucols[ci]] -= sum_{j: cidx[j] = ai} ev_j W[rows[j], ci]
      for (int e = tid; e < C * C; e += nt) {
        const int ai = e / C;
        const int ci = e - ai * C;
        float u = 0.0f;
        for (int j = 0; j < nnz; ++j)
          if (icid[j] == ai) u += evs[j] * w[irow[j] * C + ci];
        a[iuc[ai] * nz + iuc[ci]] -= u;
      }
    }
    pivoted_inverse(a, nz, rowp, rowq, colp, perm);
    float* Sk = Sb + k * blk;
    for (int e = tid; e < nz * nz; e += nt) Sk[e] = a[e];
    if (k < S - 1) {
      for (int j = tid; j < nnz; j += nt) evs[j] = evb[k * nnz + j];
      __syncthreads();
      // Wc_k[:, ci] = sum_{j: cidx[j] = ci} ev_j Sinv_k[:, rows[j]]
      float* Wk = Wb + static_cast<size_t>(k) * nz * C;
      for (int e = tid; e < nz * C; e += nt) {
        const int i = e / C;
        const int ci = e - i * C;
        float acc = 0.0f;
        for (int j = 0; j < nnz; ++j)
          if (icid[j] == ci) acc += evs[j] * a[i * nz + irow[j]];
        w[e] = acc;
        Wk[e] = acc;
      }
      __syncthreads();
    }
  }
}

OBCA_EXPORT int obca_factor_se_f32(const float* K, const float* ev,
                                   const float* reg, const int* rows,
                                   const int* cidx, const int* ucols, int B,
                                   int S, int nz, int nnz, int C,
                                   float* Sinv, float* Wc, void* stream) {
  const size_t smem = sizeof(float) * (nz * nz + nz * C + 3 * nz + nnz)
                      + sizeof(int) * (2 * nnz + C + nz);
  cudaError_t err = allow_smem(factor_se_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_se_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, ev, reg, rows, cidx, ucols, S, nz, nnz, C, Sinv, Wc);
  return static_cast<int>(cudaGetLastError());
}
