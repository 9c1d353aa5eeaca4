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
// of a stage: the kernel is latency-bound, not bound by either.
//
// The first design took 8.1 ms per call at that shape on an H100: 1024
// threads per scenario ran common.cuh's pivoted_inverse, with three
// block-wide barriers per pivot, a one-warp pivot search down a
// bank-conflicted column, physical row swaps, an integer division per
// element, and a synchronous load of K_k at the start of every stage.
// This design:
//
// - Four threads per column (4 nz <= 256 threads per scenario).  Thread
//   (j, g) holds rows 16g .. 16g+15 of column j in registers for the
//   whole stage; its cells are fixed once, by shifts.
// - Implicit pivoting: rows never move.  Step p pivots on r_p, the
//   unused row with the largest |a[r, p]|, and updates in place with
//   h = a[r_p, :] / a[r_p, p], h_p = 1 / a[r_p, p]: every row i other
//   than r_p becomes a[i, :] - a[i, p] h, column p replaced by e_{r_p}
//   first.  Row r_p itself keeps its values and its scaling 1 / a[r_p,
//   p] is deferred (later updates are linear in the row, so they apply
//   to the unscaled row alike), which makes every cell's update one
//   FMA with no select.  At the end Sinv[p, r_q] = a[r_p, q] / a[r_p,
//   p]: the permutation and the scaling are applied when Sinv_k is
//   staged for its write-out, and Wc_k is formed from the staged
//   Sinv_k.
// - One barrier per pivot: while the others finish step p, the warp
//   that holds column p+1 keys that column's unused rows (|a| with the
//   low 7 mantissa bits dropped, packed with the row; ties to the
//   smaller row) and publishes the column, its pivot row and the
//   pivot's reciprocal into a double buffer in shared memory.  The
//   largest key comes from one reduction over the whole warp, to which
//   the other columns' threads contribute 0; the branch around it is
//   warp-uniform.  (A reduction over only the column's four lanes, with
//   a per-thread mask, compiles to a loop, and was much slower.)  A
//   thread takes the pivot row's value in its own column by a shuffle
//   from the thread that holds it, picked from registers by a select
//   tree.
// - The published column is read as float4 with 20 floats between row
//   groups, so the four row groups of a warp fall on distinct banks.
// - K_{k+1} (and ev_{k+1}) are fetched with 16-byte cp.async into the
//   second of two stage buffers while stage k eliminates; Sinv_k is
//   staged in the buffer K_k came in and written back with 16-byte
//   stores.  Wc_k and the next Schur update walk each column's
//   coupling entries (a list built once), not all nnz of them.
// Shared memory: 2 nz^2 + nz C + C^2 + 2 nnz floats and a few arrays of
// at most 64; it does not grow with S.  nz is capped at kNzMax = 64 (the
// wrapper raises above it; the entry point refuses it too).
#include "common.cuh"

constexpr int kNzMax = 64;               // largest nz the kernel takes
constexpr int kGroups = 4;               // threads per column
constexpr int kRows = kNzMax / kGroups;  // rows held by each thread
constexpr int kCbStride = 20;            // floats between row groups
constexpr int kCbSlot = kGroups * kCbStride;
constexpr int kColsPerWarp = 32 / kGroups;
static_assert(kRows == 16, "row group = r >> 4; pick16");

// a[ql] (0 <= ql < 16) by a select tree of depth 4.
__device__ __forceinline__ float pick16(const float (&a)[kRows], int ql) {
  const bool b0 = ql & 1, b1 = ql & 2, b2 = ql & 4, b3 = ql & 8;
  const float s0 = b0 ? a[1] : a[0], s1 = b0 ? a[3] : a[2];
  const float s2 = b0 ? a[5] : a[4], s3 = b0 ? a[7] : a[6];
  const float s4 = b0 ? a[9] : a[8], s5 = b0 ? a[11] : a[10];
  const float s6 = b0 ? a[13] : a[12], s7 = b0 ? a[15] : a[14];
  const float t0 = b1 ? s1 : s0, t1 = b1 ? s3 : s2;
  const float t2 = b1 ? s5 : s4, t3 = b1 ? s7 : s6;
  const float u0 = b2 ? t1 : t0, u1 = b2 ? t3 : t2;
  return b3 ? u1 : u0;
}

// 1 / x to within an ulp or so for normal x: the hardware's approximate
// reciprocal and one Newton step, inline (no call to a slow path).
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// Run by the whole warp that holds column p (a warp-uniform branch).
// `freem` has bit q set when row 16 g + q exists and has not pivoted.
// The key of a row packs |a| (non-negative floats order as their bits;
// the low 7 mantissa bits dropped) with 127 - row, so ties go to the
// smaller row and an unused row keys above 0.  Every thread forms its
// best key and the reciprocal of that row's value; one warp reduction,
// to which only column p's threads contribute, picks the pivot, and the
// thread that holds it publishes its row and reciprocal.
__device__ __forceinline__ void publish_column(
    const float (&a)[kRows], int p, int j, int g, unsigned freem,
    float* colbuf, int* prow, int* pof, float* pinv) {
  const bool mine = j == p;
  float4* cb = reinterpret_cast<float4*>(colbuf + (p & 1) * kCbSlot +
                                         g * kCbStride);
  if (mine) {
    // Rows past nz land in the padding and are never read as pivots.
#pragma unroll
    for (int m = 0; m < kRows / 4; ++m)
      cb[m] = make_float4(a[4 * m], a[4 * m + 1], a[4 * m + 2],
                          a[4 * m + 3]);
  }
  const unsigned rowkey = 127u - static_cast<unsigned>(g * kRows);
  unsigned kq[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
    kq[q] = ((freem >> q) & 1u)
                ? (__float_as_uint(a[q]) & 0x7FFFFF80u) | (rowkey - q)
                : 0u;
  // The tree is spelled out: as a loop over levels it was compiled to a
  // round trip through local memory per level.
  const unsigned kmine =
      max(max(max(max(kq[0], kq[1]), max(kq[2], kq[3])),
              max(max(kq[4], kq[5]), max(kq[6], kq[7]))),
          max(max(max(kq[8], kq[9]), max(kq[10], kq[11])),
              max(max(kq[12], kq[13]), max(kq[14], kq[15]))));
  const int rmine = 127 - static_cast<int>(kmine & 127u);
  const float dmine = recip(pick16(a, rmine & (kRows - 1)));
  const unsigned kmax = __reduce_max_sync(0xffffffffu, mine ? kmine : 0u);
  if (mine && kmine == kmax) {
    // This thread holds the pivot row; its entry of the published
    // column is 0, so the update leaves the pivot row as it is.
    reinterpret_cast<float*>(cb)[rmine & (kRows - 1)] = 0.0f;
    prow[p] = rmine;
    pof[rmine] = p;
    pinv[p] = dmine;
  }
}

__global__ void __launch_bounds__(kNzMax * kGroups)
factor_se_kernel(const float* __restrict__ K, const float* __restrict__ ev,
                 const float* __restrict__ reg, const int* __restrict__ rows,
                 const int* __restrict__ cidx,
                 const int* __restrict__ ucols, int S, int nz, int nnz,
                 int C, bool vec, float* __restrict__ Sinv,
                 float* __restrict__ Wc) {
  extern __shared__ __align__(16) float smem[];
  const int blk = nz * nz;
  float* colbuf = smem;               // [2][kCbSlot] published column
  float* kbuf = colbuf + 2 * kCbSlot;  // [2][nz*nz] K_k in, Sinv_k out
  float* w = kbuf + 2 * blk;           // [nz, C] Wc_k
  float* U = w + nz * C;               // [C, C] Schur update of S_{k+1}
  float* pinv = U + C * C;             // [kNzMax] 1 / pivot of step p
  float* evs = pinv + kNzMax;          // [2][nnz] ev_k
  int* prow = reinterpret_cast<int*>(evs + 2 * nnz);  // [kNzMax] r_p
  int* pof = prow + kNzMax;    // [kNzMax] step at which row i pivoted
  int* uidx = pof + kNzMax;    // [kNzMax] position in ucols, or -1
  int* irow = uidx + kNzMax;   // [nnz]
  int* cent = irow + nnz;      // [nnz] entries j ordered by cidx[j]
  int* cstart = cent + nnz;    // [C + 1] first entry of each ucol

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
  for (int e = tid; e < 2 * kCbSlot; e += nt) colbuf[e] = 0.0f;
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
    // Rows of this thread that exist and have not pivoted yet.
    const int nrows = nz - i0;
    unsigned freem = nrows >= kRows ? 0xFFFFu
                     : nrows > 0    ? (1u << nrows) - 1u
                                    : 0u;
    if (warp == 0) publish_column(a, 0, j, g, freem, colbuf, prow, pof, pinv);
    __syncthreads();

    for (int p = 0; p < nz; ++p) {
      const int r = prow[p];
      const float d = pinv[p];
      const int gr = r >> 4;  // r / kRows
      if (g == gr) freem &= ~(1u << (r & (kRows - 1)));
      // a[r, j] from the thread of column j that holds row r.
      const float v = __shfl_sync(0xffffffffu, pick16(a, r & (kRows - 1)),
                                  (lane & ~(kGroups - 1)) | gr);
      const float gj = (j == p) ? d : v * d;
      if (j == p) {
        // Column p becomes e_r (in the stored scaling) before the update.
        const int myrl = (g == gr) ? (r & (kRows - 1)) : -1;
#pragma unroll
        for (int q = 0; q < kRows; ++q) a[q] = (q == myrl) ? 1.0f : 0.0f;
      }
      const float4* cb = reinterpret_cast<const float4*>(
          colbuf + (p & 1) * kCbSlot + g * kCbStride);
#pragma unroll
      for (int m = 0; m < kRows / 4; ++m) {
        const float4 c4 = cb[m];
        a[4 * m] = fmaf(-c4.x, gj, a[4 * m]);
        a[4 * m + 1] = fmaf(-c4.y, gj, a[4 * m + 1]);
        a[4 * m + 2] = fmaf(-c4.z, gj, a[4 * m + 2]);
        a[4 * m + 3] = fmaf(-c4.w, gj, a[4 * m + 3]);
      }
      if (p + 1 < nz) {
        if ((p + 1) / kColsPerWarp == warp)
          publish_column(a, p + 1, j, g, freem, colbuf, prow, pof, pinv);
        __syncthreads();
      }
    }

    // Stage Sinv_k where K_k came in: Sinv[p, r_q] = a[r_p, q] / a_p,
    // with the pivot row's deferred scaling 1 / a_p = pinv[p].
    float* sb = kbuf + cur * blk;
    if (active) {
      const int col = prow[j];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = i0 + q;
        if (i < nz) {
          const int pi = pof[i];
          sb[pi * nz + col] = a[q] * pinv[pi];
        }
      }
    }
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

OBCA_EXPORT int obca_factor_se_f32(const float* K, const float* ev,
                                   const float* reg, const int* rows,
                                   const int* cidx, const int* ucols, int B,
                                   int S, int nz, int nnz, int C,
                                   float* Sinv, float* Wc, void* stream) {
  if (nz < 1 || nz > kNzMax || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (kGroups * nz + 31) / 32 * 32;
  // 16-byte copies need nz even (so nz^2 % 4 == 0) and aligned blocks.
  const bool vec = nz % 2 == 0 && aligned16(K) && aligned16(Sinv);
  const size_t smem =
      sizeof(float) * (2 * kCbSlot + 2 * nz * nz + nz * C + C * C + kNzMax +
                       2 * nnz) +
      sizeof(int) * (3 * kNzMax + 2 * nnz + C + 1);
  cudaError_t err = allow_smem(factor_se_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_se_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, ev, reg, rows, cidx, ucols, S, nz, nnz, C, vec, Sinv, Wc);
  return static_cast<int>(cudaGetLastError());
}
