// factor_se: Schur recursion of the block-tridiagonal quasidefinite KKT
// system with a sparse, constant-pattern coupling block.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:404,
// factor_batched_se (kernel body _factor_se_kernel with _qd_inv_b /
// _spd_inv_b).
//
// Per scenario b (one thread block each) and stage k = 0..S-1:
//   S_k    = K_k + diag(reg) - E'_{k-1} S_{k-1}^{-1} E_{k-1}
//   Sinv_k = S_k^{-1}
//   Wc_k   = (S_k^{-1} E_k)[:, ucols]          (k < S-1, stored at slot k)
// E_k has nnz values ev[b, k, j] at static (rows[j], cols[j]); only the
// C x C block on E's distinct columns (ucols) receives a Schur update.
//
// Inverse: Gauss-Jordan elimination with partial pivoting over all
// rows, in place of the TPU kernel's pivot-free, primal-block-first
// recursive halving.  On the main path's first-iteration system (B=128,
// N=80, f32; PERF.md) the stage-0 block has a condition number near
// 2e4, yet the primal-first order is off by a relative 6.5 there;
// partial pivoting gives 4e-7.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at the main-path shape B=128, S=81, nz=56, nnz=11, C=11:
// bytes K 130.1 MB in + Sinv 130.1 MB out + Wc 25.2 MB out ~ 286 MB
// (~85 us); operations 2 nz^3 per stage inverse ~ 3.6 GFLOP (~54 us).
// The S stages of a scenario are sequential, and so are the nz pivots
// of a stage: the kernel is latency-bound, not bound by either.  On an
// H100 80GB HBM3 (700 W) it takes 1.017 ms a call at that shape (the
// one-barrier-a-pivot elimination took 1.822 ms, same card and call)
// and 2.370 ms at nz = 72 against a bound of 0.1382 ms (4.157 ms).
//
// The first design took 8.1 ms per call at that shape on an H100: 1024
// threads per scenario ran a shared-memory Gauss-Jordan inverse (since
// removed), with three block-wide barriers per pivot, a one-warp pivot
// search down a bank-conflicted column, physical row swaps, an integer
// division per element, and a synchronous load of K_k at the start of
// every stage.
// This design:
//
// - The block is inverted in registers, four threads per column, by
//   Gauss-Jordan elimination with implicit partial pivoting and
//   deferred row scaling, in panels of eight pivots with one block
//   barrier each, each panel eliminated in rows by the warp that holds
//   it.  That elimination lives in gauss_jordan.cuh (gj_eliminate,
//   gj_stage), which factor_dense.cu shares; its header describes it.
//   It gives the factor of the earlier one-barrier-a-pivot elimination
//   bit for bit.
// - K_{k+1} (and ev_{k+1}) are fetched with 16-byte cp.async into the
//   second of two stage buffers while stage k eliminates; Sinv_k is
//   staged in the buffer K_k came in and written back with 16-byte
//   stores.  Wc_k and the next Schur update walk each column's
//   coupling entries (a list built once), not all nnz of them.
// Shared memory: 2 nz^2 + nz C + C^2 + 2 nnz floats, the published
// columns and the panel transpositions (5 KB and 5 KB for nz <= 64,
// 9 KB and 9 KB above), and a few arrays of at most 128; it does not
// grow with S.
//
// Two instantiations of the same code, picked by nz at launch: 16 rows
// a thread for nz <= 64 (256 threads at most), and 32 rows a thread for
// 64 < nz <= 128 (512 threads at most; the randomized-obstacle families
// run at nz = 72).  Its shared memory must fit in 227 KB: about 154 KB
// at nz = 128 and C = 11, but a pattern with C near nz at nz = 128 does
// not fit and its launch is refused.  nz is capped at 128 (the wrapper
// raises above it; the entry point refuses it too).
#include "gauss_jordan.cuh"

template <int kRows>
__global__ void __launch_bounds__(gj_nz_max<kRows>() * kGroups)
factor_se_kernel(const float* __restrict__ K, const float* __restrict__ ev,
                 const float* __restrict__ reg, const int* __restrict__ rows,
                 const int* __restrict__ cidx,
                 const int* __restrict__ ucols, int S, int nz, int nnz,
                 int C, bool vec, float* __restrict__ Sinv,
                 float* __restrict__ Wc) {
  constexpr int kNzMax = gj_nz_max<kRows>();
  constexpr int kCb = gj_cb_floats<kRows>();
  constexpr int kPb = gj_pbuf_floats<kRows>();
  extern __shared__ __align__(16) float smem[];
  const int blk = nz * nz;
  float* colbuf = smem;                // [kCb] published columns
  float* kbuf = colbuf + kCb;          // [2][nz*nz] K_k in, Sinv_k out
  float* w = kbuf + 2 * blk;           // [nz, C] Wc_k
  float* U = w + nz * C;               // [C, C] Schur update of S_{k+1}
  float* pbuf = U + C * C;             // [kPb] a panel in transposition
  float* pinv = pbuf + kPb;            // [kNzMax] 1 / pivot of step p
  float* evs = pinv + kNzMax;          // [2][nnz] ev_k
  int* prow = reinterpret_cast<int*>(evs + 2 * nnz);  // [kNzMax] r_p
  int* pof = prow + kNzMax;    // [kNzMax] step at which row i pivoted
  int* uidx = pof + kNzMax;    // [kNzMax] position in ucols, or -1
  int* irow = uidx + kNzMax;   // [nnz]
  int* cent = irow + nnz;      // [nnz] entries j ordered by cidx[j]
  int* cstart = cent + nnz;    // [C + 1] first entry of each ucol
  const GjPivots pv{colbuf, pbuf, pinv, prow, pof};

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int j = tid >> 2;               // column
  const int g = tid & (kGroups - 1);    // rows kRows*g .. kRows*g+kRows-1
  const int i0 = g * kRows;
  const bool active = j < nz;
  const int jc = active ? j : 0;
  const size_t sblk = static_cast<size_t>(blk);
  const float* Kb = K + static_cast<size_t>(b) * S * sblk;
  const float* evb = ev + static_cast<size_t>(b) * (S - 1) * nnz;
  float* Sb = Sinv + static_cast<size_t>(b) * S * sblk;
  float* Wb = Wc + static_cast<size_t>(b) * (S - 1) * nz * C;

  // K_s and ev_s into stage buffer s & 1, as one cp.async group.
  auto fetch = [&](int s) {
    float* kd = kbuf + (s & 1) * blk;
    const float* ks = Kb + s * sblk;
    if (vec) {
      for (int e = tid; e < blk / 4; e += nt)
        cp_async16(kd + 4 * e, ks + 4 * e);
    } else {
      for (int e = tid; e < blk; e += nt) cp_async4(kd + e, ks + e);
    }
    if (s < S - 1)
      for (int e = tid; e < nnz; e += nt)
        cp_async4(evs + (s & 1) * nnz + e, evb + s * nnz + e);
    cp_async_commit();
  };

  fetch(0);
  for (int e = tid; e < kNzMax; e += nt) uidx[e] = -1;
  for (int e = tid; e < kCb; e += nt) colbuf[e] = 0.0f;
  load_ints(irow, rows, nnz);
  __syncthreads();
  for (int c = tid; c < C; c += nt) uidx[ucols[c]] = c;
  if (tid == 0) {
    // The coupling entries of each distinct column, in order of j.
    int e = 0;
    for (int c = 0; c < C; ++c) {
      cstart[c] = e;
      for (int jj = 0; jj < nnz; ++jj)
        if (cidx[jj] == c) cent[e++] = jj;
    }
    cstart[C] = e;
  }
  const float regj = active ? reg[static_cast<size_t>(b) * nz + j] : 0.0f;
  const Walk2 walk_c(tid, nt, C);  // (row, column) over [*, C] arrays
  __syncthreads();
  const int cj = active ? uidx[j] : -1;

  float a[kRows];
  for (int k = 0; k < S; ++k) {
    const int cur = k & 1;
    cp_async_wait<0>();
    // K_k visible to all; the other buffer's readers (stage k-1) done.
    __syncthreads();
    if (k + 1 < S) fetch(k + 1);

    // S_k = K_k + diag(reg) - U_k (U_k formed at the end of stage k-1).
    // Rows past nz read row nz-1 and are never used: no branches here.
    const float* kc = kbuf + cur * blk;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = min(i0 + q, nz - 1);
      float v = kc[i * nz + jc];
      if (i == j) v += regj;
      const int ai = uidx[i];
      if (k > 0 && cj >= 0 && ai >= 0) v -= U[ai * C + cj];
      a[q] = v;
    }
    gj_eliminate(a, nz, j, g, pv);

    // Stage Sinv_k where K_k came in.
    float* sb = kbuf + cur * blk;
    gj_stage(a, nz, j, g, pv, sb, nz, nullptr);
    __syncthreads();
    float* Sk = Sb + k * sblk;
    if (vec) {
      const float4* s4 = reinterpret_cast<const float4*>(sb);
      float4* d4 = reinterpret_cast<float4*>(Sk);
      for (int e = tid; e < blk / 4; e += nt) d4[e] = s4[e];
    } else {
      for (int e = tid; e < blk; e += nt) Sk[e] = sb[e];
    }
    if (k + 1 < S) {
      // Wc_k[:, ci] = sum_{j: cidx[j] = ci} ev_j Sinv_k[:, rows[j]]
      const float* evk = evs + cur * nnz;
      float* Wk = Wb + static_cast<size_t>(k) * nz * C;
      Walk2 it = walk_c;
      for (int e = tid; e < nz * C; e += nt, it.next()) {
        float acc = 0.0f;
        for (int t = cstart[it.col]; t < cstart[it.col + 1]; ++t) {
          const int jj = cent[t];
          acc += evk[jj] * sb[it.row * nz + irow[jj]];
        }
        w[e] = acc;
        Wk[e] = acc;
      }
      __syncthreads();
      // U_{k+1}[ai, ci] = sum_{j: cidx[j] = ai} ev_j Wc_k[rows[j], ci]
      it = walk_c;
      for (int e = tid; e < C * C; e += nt, it.next()) {
        float u = 0.0f;
        for (int t = cstart[it.row]; t < cstart[it.row + 1]; ++t) {
          const int jj = cent[t];
          u += evk[jj] * w[irow[jj] * C + it.col];
        }
        U[e] = u;
      }
    }
  }
}

// Launches factor_se_kernel<kRows> with its shared memory.
template <int kRows>
static int launch_factor_se(const float* K, const float* ev,
                            const float* reg, const int* rows,
                            const int* cidx, const int* ucols, int B, int S,
                            int nz, int nnz, int C, float* Sinv, float* Wc,
                            void* stream) {
  constexpr int kNzMax = gj_nz_max<kRows>();
  const int threads = (kGroups * nz + 31) / 32 * 32;
  // 16-byte copies need nz even (so nz^2 % 4 == 0) and aligned blocks.
  const bool vec = nz % 2 == 0 && aligned16(K) && aligned16(Sinv);
  const size_t smem =
      sizeof(float) * (gj_cb_floats<kRows>() + 2 * nz * nz + nz * C +
                       C * C + gj_pbuf_floats<kRows>() + kNzMax +
                       2 * nnz) +
      sizeof(int) * (3 * kNzMax + 2 * nnz + C + 1);
  cudaError_t err = allow_smem(factor_se_kernel<kRows>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_se_kernel<kRows>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          K, ev, reg, rows, cidx, ucols, S, nz, nnz, C, vec, Sinv, Wc);
  return static_cast<int>(cudaGetLastError());
}

OBCA_EXPORT int obca_factor_se_f32(const float* K, const float* ev,
                                   const float* reg, const int* rows,
                                   const int* cidx, const int* ucols, int B,
                                   int S, int nz, int nnz, int C,
                                   float* Sinv, float* Wc, void* stream) {
  if (nz < 1 || nz > gj_nz_max<32>() || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nz <= gj_nz_max<16>())
    return launch_factor_se<16>(K, ev, reg, rows, cidx, ucols, B, S, nz,
                                nnz, C, Sinv, Wc, stream);
  return launch_factor_se<32>(K, ev, reg, rows, cidx, ucols, B, S, nz, nnz,
                              C, Sinv, Wc, stream);
}
