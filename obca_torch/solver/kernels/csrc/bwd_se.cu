// bwd_se: backward substitution through the factored block-tridiagonal
// system with a sparse coupling block, with no matvec.  The second half
// of the mixed-precision solve (fwd_se, then bwd_se), whose true-system
// matvec runs in the residual's (wider) dtype outside the kernel.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:solve_batched_se,
// its second pallas_call (kernel body _bwd_se_kernel); the first is
// fwd_se.cu.
//
// Per scenario b (one thread block each), stages s = S-1..0 in order:
//   p_{S-1} = y_{S-1},  p_s = y_s - sum_c Wc_s[:, c] p_{s+1}[ucols[c]]
// One thread per row of the stage; p_{s+1} sits in a two-slot buffer in
// shared memory, so each stage takes one block barrier, and p goes to
// device memory as it is made.
//
// Bound on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56,
// C=11: bytes Wc 25.2 MB + y 2.3 MB in, p 2.3 MB out ~ 30 MB (~9 us);
// 2 nz C (S-1) B ~ 13 MFLOP is negligible.  Memory-bound on paper; the
// chain of S dependent stages, each waiting on one stage's Wc rows, makes
// this design latency-bound.
#include "common.cuh"

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
bwd_se_kernel(const float* __restrict__ Wc, const float* __restrict__ y,
              const int* __restrict__ ucols, int S, int nz, int C,
              float* __restrict__ p) {
  extern __shared__ float smem[];
  float* buf = smem;                                // [2, nz]
  int* iuc = reinterpret_cast<int*>(buf + 2 * nz);  // [C]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t vec = static_cast<size_t>(S) * nz;
  const float* Wb = Wc + static_cast<size_t>(b) * (S - 1) * nz * C;
  const float* yb = y + static_cast<size_t>(b) * vec;
  float* pb = p + static_cast<size_t>(b) * vec;

  load_ints(iuc, ucols, C);
  for (int i = tid; i < nz; i += blockDim.x) {
    const float v = yb[(S - 1) * nz + i];
    buf[((S - 1) & 1) * nz + i] = v;
    pb[(S - 1) * nz + i] = v;
  }
  __syncthreads();

  for (int s = S - 2; s >= 0; --s) {
    const float* pn = buf + ((s + 1) & 1) * nz;  // p_{s+1}
    float* pc = buf + (s & 1) * nz;              // p_s
    for (int i = tid; i < nz; i += blockDim.x) {
      const float* Wrow = Wb + (static_cast<size_t>(s) * nz + i) * C;
      float acc = yb[s * nz + i];
      for (int c = 0; c < C; ++c) acc -= Wrow[c] * pn[iuc[c]];
      pc[i] = acc;
      pb[s * nz + i] = acc;
    }
    // One barrier a stage: stage s-1 writes the slot stage s read.
    __syncthreads();
  }
}

OBCA_EXPORT int obca_bwd_se_f32(const float* Wc, const float* y,
                                const int* ucols, int B, int S, int nz,
                                int C, float* p, void* stream) {
  const size_t smem = sizeof(float) * 2 * nz + sizeof(int) * C;
  cudaError_t err = allow_smem(bwd_se_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_se_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Wc, y, ucols, S, nz, C, p);
  return static_cast<int>(cudaGetLastError());
}
