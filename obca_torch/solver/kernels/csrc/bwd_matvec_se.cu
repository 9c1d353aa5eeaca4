// bwd_matvec_se: backward substitution fused with the block-tridiagonal
// matvec of the true system, one (p, Ap) pair per GCR step.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:bwd_matvec_se
// (kernel body _bwdmv_se_kernel).
//
// Per scenario b (one thread block each):
//   1. backward sweep, stages s = S-1..0 in order, p held in shared memory:
//        p_{S-1} = y_{S-1},  p_s = y_s - sum_c Wc_s[:, c] p_{s+1}[ucols[c]]
//   2. after one block barrier, every row of
//        Ap_t = K_t p_t + E_t p_{t+1} + E'_{t-1} p_{t-1}
//      in parallel over (t, row), one warp per row of K_t (contiguous,
//      coalesced).  The E terms come from (rows, cols, ev) directly; there
//      are no E terms past the ends.  K is the unregularized system.
// The TPU kernel's one-stage-lagged matvec and its one-hot placement
// matrices are not needed here: all of p sits in shared memory.
//
// Bound on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56,
// C=11: bytes Wc 25.2 MB + K 130.0 MB + y 2.3 MB in, p 2.3 MB + Ap 2.3 MB
// out ~ 162 MB (~48 us); 2 nz^2 S B ~ 65 MFLOP is negligible.  Phase 2
// streams K at full parallelism; phase 1 is a sequential chain of S
// barrier steps per scenario.
#include "common.cuh"

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
bwd_matvec_se_kernel(const float* __restrict__ Wc,
                     const float* __restrict__ y,
                     const float* __restrict__ K,
                     const float* __restrict__ ev,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const int* __restrict__ ucols, int S, int nz, int nnz,
                     int C, float* __restrict__ p, float* __restrict__ Ap) {
  extern __shared__ float smem[];
  float* ps = smem;                               // [S, nz]
  int* irow = reinterpret_cast<int*>(ps + S * nz);  // [nnz]
  int* icol = irow + nnz;                           // [nnz]
  int* iuc = icol + nnz;                            // [C]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t vec = static_cast<size_t>(S) * nz;
  const float* Wb = Wc + static_cast<size_t>(b) * (S - 1) * nz * C;
  const float* yb = y + static_cast<size_t>(b) * vec;
  const float* Kb = K + static_cast<size_t>(b) * vec * nz;
  const float* evb = ev + static_cast<size_t>(b) * (S - 1) * nnz;
  float* pb = p + static_cast<size_t>(b) * vec;
  float* Apb = Ap + static_cast<size_t>(b) * vec;

  load_ints(irow, rows, nnz);
  load_ints(icol, cols, nnz);
  load_ints(iuc, ucols, C);
  for (int i = tid; i < nz; i += blockDim.x)
    ps[(S - 1) * nz + i] = yb[(S - 1) * nz + i];
  __syncthreads();

  // 1. backward sweep.
  for (int s = S - 2; s >= 0; --s) {
    const float* pn = ps + (s + 1) * nz;
    for (int i = tid; i < nz; i += blockDim.x) {
      const float* Wrow = Wb + (static_cast<size_t>(s) * nz + i) * C;
      float acc = yb[s * nz + i];
      for (int c = 0; c < C; ++c) acc -= Wrow[c] * pn[iuc[c]];
      ps[s * nz + i] = acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < S * nz; e += blockDim.x) pb[e] = ps[e];

  // 2. Ap = T p, one warp per (stage, row).
  for (int tr = warp; tr < S * nz; tr += nwarps) {
    const int t = tr / nz;
    const int i = tr - t * nz;
    const float* Krow = Kb + static_cast<size_t>(tr) * nz;
    const float* pt = ps + t * nz;
    float acc = 0.0f;
    for (int c = lane; c < nz; c += 32) acc += Krow[c] * pt[c];
    acc = warp_sum(acc);
    if (lane == 0) {
      if (t < S - 1) {  // + E_t p_{t+1}
        const float* evt = evb + t * nnz;
        const float* pn = pt + nz;
        float e1 = 0.0f;
        for (int j = 0; j < nnz; ++j)
          if (irow[j] == i) e1 += evt[j] * pn[icol[j]];
        acc += e1;
      }
      if (t > 0) {      // + E'_{t-1} p_{t-1}
        const float* evp = evb + (t - 1) * nnz;
        const float* pp = pt - nz;
        float e2 = 0.0f;
        for (int j = 0; j < nnz; ++j)
          if (icol[j] == i) e2 += evp[j] * pp[irow[j]];
        acc += e2;
      }
      Apb[tr] = acc;
    }
  }
}

OBCA_EXPORT int obca_bwd_matvec_se_f32(const float* Wc, const float* y,
                                       const float* K, const float* ev,
                                       const int* rows, const int* cols,
                                       const int* ucols, int B, int S, int nz,
                                       int nnz, int C, float* p, float* Ap,
                                       void* stream) {
  const size_t smem = sizeof(float) * S * nz + sizeof(int) * (2 * nnz + C);
  cudaError_t err = allow_smem(bwd_matvec_se_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_matvec_se_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      Wc, y, K, ev, rows, cols, ucols, S, nz, nnz, C, p, Ap);
  return static_cast<int>(cudaGetLastError());
}
