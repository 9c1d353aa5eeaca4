// factor_dense: Schur recursion of the block-tridiagonal quasidefinite
// KKT system with dense coupling blocks.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:172,
// factor_batched (kernel body _factor_kernel with _qd_inv_b /
// _spd_inv_b).
//
// Per scenario b (one thread block each) and stage k = 0..S-1:
//   W_{k-1} = S_{k-1}^{-1} E_{k-1}                   (k > 0, slot k-1)
//   S_k     = K_k - E'_{k-1} W_{k-1}                 (S_0 = K_0)
//   Sinv_k  = S_k^{-1}
// K already carries the factor's diagonal regularization (the caller
// adds it); slot j of W holds S_j^{-1} E_j, as on the TPU.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), main-path shape B=128, S=81, nz=56: bytes K 130.1 MB + E
// 128.5 MB in, Sinv 130.1 MB + W 128.5 MB out ~ 517 MB (~154 us);
// operations 3 x 2 nz^3 per stage (two products and the inverse)
// ~ 10.9 GFLOP (~163 us): bound by operations.  The S stages of a
// scenario are sequential, and so are the nz pivots of a stage: the
// kernel is latency-bound like factor_se.
//
// The first design took 8.07 ms per call at that shape on an H100:
// 1024 threads per scenario ran a shared-memory Gauss-Jordan inverse
// with three block barriers per pivot, and the two products were one
// output per thread, an integer division per element, with K_k and
// E_{k-1} loaded synchronously on the chain.  This design:
//
// - The inverse is factor_se's: the block in registers, four threads
//   per column, implicit partial pivoting with deferred row scaling and
//   one barrier per pivot (gauss_jordan.cuh).  The staging of Sinv_k
//   writes it twice, row-major where K_k came in (written back with
//   16-byte stores) and transposed, for the next stage's product.
// - Both products are 4 x 4 register tiles from shared memory, one tile
//   per thread (the (P/4)^2 tiles never outnumber the threads):
//     W_{k-1}[i, j] = sum_l Sinv_{k-1}'[l, i] E_{k-1}[l, j],
//     S_k[i, j]     = K_k[i, j] - sum_l E_{k-1}[l, i] W_{k-1}[l, j],
//   each step of l one float4 of the left factor's row l (four rows of
//   the tile) and one of the right's (four columns), 16 FMAs; the lanes
//   of a warp take consecutive column chunks, so a float4 read is one
//   broadcast and one conflict-free row segment.  l runs in steps of
//   four with every load of a step issued before its FMAs, and no
//   division.  W_{k-1} goes to shared memory (the second product reads
//   it) and out with 16-byte stores from registers; S_k overwrites K_k
//   in place, and each thread then loads its 16 cells of S_k into the
//   registers that eliminate it.  (Tiles of the elimination's own
//   cells, 16 rows of one column, made every warp read four rows of the
//   left factor per l for eight columns: about 12 us a stage.)
// - K_{k+1} and E_k are fetched with 16-byte cp.async into the second
//   of two pairs of stage buffers while stage k multiplies and
//   eliminates.
// - Every stage buffer has row stride P = nz rounded up to 4 and room
//   for 64 rows, zeroed once: the elimination's loads of rows past nz
//   stay inside it, and the padding rows and columns are zero, so the l
//   loop needs no bound finer than four and the rows past nz are zero.
//   Shapes with nz % 4 != 0 or an unaligned block take 4-byte cp.async
//   into that layout and scalar stores (`vec` false).
// Shared memory: six buffers of 64 P floats (K_k, E_{k-1} twice, the
// transposed Sinv_{k-1}, W_{k-1}), 86 KB at nz=56, and a few arrays of
// at most 64; it does not grow with S.  256 threads at most; nz is
// capped at kNzMax = 64 (the wrapper raises above it; the entry point
// refuses it too).
#include "gauss_jordan.cuh"

// acc[r] += sum_{l < nz} X[l, 4 ti + r] Y[l, 4 tj .. 4 tj + 3] (kSub:
// -=), r < 4, for X and Y in shared memory with row stride P (a
// multiple of 4) whose rows nz .. P-1 are zero.  Rows of l in steps of
// four, every load of a step before its FMAs.
template <bool kSub>
__device__ __forceinline__ void tile_product(const float* X, const float* Y,
                                             int P, int nz, int ti, int tj,
                                             float4 (&acc)[4]) {
  const int P4 = P >> 2;
  const float4* X4 = reinterpret_cast<const float4*>(X) + ti;
  const float4* Y4 = reinterpret_cast<const float4*>(Y) + tj;
  for (int l0 = 0; l0 < nz; l0 += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = X4[(l0 + u) * P4];
      y[u] = Y4[(l0 + u) * P4];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float c = kSub ? -xs[r] : xs[r];
        acc[r].x = fmaf(c, y[u].x, acc[r].x);
        acc[r].y = fmaf(c, y[u].y, acc[r].y);
        acc[r].z = fmaf(c, y[u].z, acc[r].z);
        acc[r].w = fmaf(c, y[u].w, acc[r].w);
      }
    }
  }
}

__global__ void __launch_bounds__(kNzMax * kGroups)
factor_dense_kernel(const float* __restrict__ K, const float* __restrict__ E,
                    int S, int nz, bool vec, float* __restrict__ Sinv,
                    float* __restrict__ W) {
  extern __shared__ __align__(16) float smem[];
  const int P = (nz + 3) & ~3;  // row stride of the stage buffers
  const int bsz = kNzMax * P;   // floats of one stage buffer
  float* colbuf = smem;                // [2][kCbSlot] published column
  float* kbuf = colbuf + 2 * kCbSlot;  // [2][bsz] K_k in, Sinv_k out
  float* ebuf = kbuf + 2 * bsz;        // [2][bsz] E_{k-1}
  float* tbuf = ebuf + 2 * bsz;        // [bsz] Sinv_{k-1}'
  float* wbuf = tbuf + bsz;            // [bsz] W_{k-1}
  float* pinv = wbuf + bsz;            // [kNzMax] 1 / pivot of step p
  int* prow = reinterpret_cast<int*>(pinv + kNzMax);  // [kNzMax] r_p
  int* pof = prow + kNzMax;  // [kNzMax] step at which row i pivoted
  const GjPivots pv{colbuf, pinv, prow, pof};

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int j = tid >> 2;             // column
  const int g = tid & (kGroups - 1);  // rows kRows*g .. kRows*g+kRows-1
  const int i0 = g * kRows;
  const int jc = j < nz ? j : 0;
  // The products' 4 x 4 output tile (ti, tj), one per thread: (P/4)^2
  // tiles never outnumber the 4 nz threads rounded up to whole warps.
  const int ti = tid / (P >> 2);
  const int tj = tid - ti * (P >> 2);
  const bool has_tile = ti < (P >> 2);
  const int blk = nz * nz;
  const size_t sblk = static_cast<size_t>(blk);
  const float* Kb = K + static_cast<size_t>(b) * S * sblk;
  const float* Eb = E + static_cast<size_t>(b) * (S - 1) * sblk;
  float* Sb = Sinv + static_cast<size_t>(b) * S * sblk;
  float* Wb = W + static_cast<size_t>(b) * (S - 1) * sblk;

  // K_s and E_{s-1} into stage buffers s & 1, as one cp.async group.
  auto fetch = [&](int s) {
    float* kd = kbuf + (s & 1) * bsz;
    float* ed = ebuf + (s & 1) * bsz;
    const float* ks = Kb + s * sblk;
    const float* es = s > 0 ? Eb + (s - 1) * sblk : nullptr;
    if (vec) {
      for (int e = tid; e < blk / 4; e += nt) {
        cp_async16(kd + 4 * e, ks + 4 * e);
        if (es) cp_async16(ed + 4 * e, es + 4 * e);
      }
    } else {
      Walk2 it(tid, nt, nz);
      for (int e = tid; e < blk; e += nt, it.next()) {
        const int d = it.row * P + it.col;
        cp_async4(kd + d, ks + e);
        if (es) cp_async4(ed + d, es + e);
      }
    }
    cp_async_commit();
  };

  // Zero the stage buffers (their padding stays zero) and the published
  // column's slots, then fetch stage 0.
  for (int e = tid; e < 2 * kCbSlot + 6 * bsz; e += nt) smem[e] = 0.0f;
  __syncthreads();
  fetch(0);

  float a[kRows];
  for (int k = 0; k < S; ++k) {
    const int cur = k & 1;
    float* kc = kbuf + cur * bsz;
    cp_async_wait<0>();
    // Stage k's buffers visible to all; the other pair's readers (stage
    // k-1) and the pivot state's (stage k-1's staging) done.
    __syncthreads();
    if (k + 1 < S) fetch(k + 1);

    const float* ec = ebuf + cur * bsz;
    if (k > 0) {
      if (has_tile) {
        // W_{k-1} = Sinv_{k-1} E_{k-1}: into wbuf, and out.
        float4 w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) w[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        tile_product<false>(tbuf, ec, P, nz, ti, tj, w);
        float* Wk = Wb + (k - 1) * sblk;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ti + r;
          reinterpret_cast<float4*>(wbuf + i * P)[tj] = w[r];
          if (i < nz) {
            if (vec) {
              reinterpret_cast<float4*>(Wk + i * nz)[tj] = w[r];
            } else {
              const float wv[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (4 * tj + c < nz) Wk[i * nz + 4 * tj + c] = wv[c];
            }
          }
        }
      }
      __syncthreads();
      if (has_tile) {
        // S_k = K_k - E'_{k-1} W_{k-1}, in place of K_k.
        float4* kt = reinterpret_cast<float4*>(kc + 4 * ti * P) + tj;
        float4 sk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) sk[r] = kt[r * (P >> 2)];
        tile_product<true>(ec, wbuf, P, nz, ti, tj, sk);
#pragma unroll
        for (int r = 0; r < 4; ++r) kt[r * (P >> 2)] = sk[r];
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) a[q] = kc[(i0 + q) * P + jc];
    // Rows past nz are zero, and stay zero through the elimination.
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (i0 + q >= nz) a[q] = 0.0f;

    gj_eliminate(a, nz, j, g, pv);

    // Stage Sinv_k where K_k came in, and its transpose for stage k+1.
    gj_stage(a, nz, j, g, pv, kc, P, tbuf);
    __syncthreads();
    float* Sk = Sb + k * sblk;
    if (vec) {
      const float4* s4 = reinterpret_cast<const float4*>(kc);
      for (int e = tid; e < blk / 4; e += nt)
        reinterpret_cast<float4*>(Sk)[e] = s4[e];
    } else {
      Walk2 it(tid, nt, nz);
      for (int e = tid; e < blk; e += nt, it.next())
        Sk[e] = kc[it.row * P + it.col];
    }
  }
}

OBCA_EXPORT int obca_factor_dense_f32(const float* K, const float* E, int B,
                                      int S, int nz, float* Sinv, float* W,
                                      void* stream) {
  if (nz < 1 || nz > kNzMax) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (kGroups * nz + 31) / 32 * 32;
  // 16-byte copies and stores need whole 16-byte rows and aligned
  // blocks.
  const bool vec = nz % 4 == 0 && aligned16(K) && aligned16(E) &&
                   aligned16(Sinv) && aligned16(W);
  const int P = (nz + 3) & ~3;
  const size_t smem = sizeof(float) * (2 * kCbSlot + 6 * kNzMax * P +
                                       kNzMax) +
                      sizeof(int) * 2 * kNzMax;
  cudaError_t err = allow_smem(factor_dense_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_dense_kernel<<<B, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      K, E, S, nz, vec, Sinv, W);
  return static_cast<int>(cudaGetLastError());
}
