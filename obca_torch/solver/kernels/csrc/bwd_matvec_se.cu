// bwd_matvec_se: backward substitution fused with the block-tridiagonal
// matvec of the true system, one (p, Ap) pair per GCR step.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:bwd_matvec_se
// (kernel body _bwdmv_se_kernel).
//
// Per scenario b (one thread block each), steps g = 0..S (bwd_sweep.cuh):
// the sweep makes p_s, s = S-1-g; one stage behind it, the row
//   Ap_{s+1} = K_{s+1} p_{s+1} + E_{s+1} p_{s+2} + E'_s p_s
// (K the unregularized system; no E terms past the ends), as the TPU
// kernel does, with K riding the same descending stream as Wc.
//
// Bound on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56,
// C=11: bytes Wc 25.2 MB + K 130.0 MB + y 2.3 MB in, p 2.3 MB + Ap 2.3 MB
// out ~ 162 MB (~48 us); 2 nz^2 S B ~ 65 MFLOP is negligible.
// Memory-bound: a step moves about 15.3 KB (K_{s+1} 12.5 KB, Wc_s
// 2.4 KB, y_s, two ev rows) per SM, one SM's share of 3.35 TB/s is about
// 25 GB/s, so a step costs about 0.6 us of bandwidth against a few
// hundred cycles of compute, and 25-40 KB must be in flight to cover
// the memory latency under load: the ring holds 8 steps (about 122 KB,
// a step fetched 6 steps before it computes).  A pattern too large for
// 8 buffers takes 4; one too large for 4 is refused.
// 352 threads: eight product warps (four lanes per row of K_t), two
// sweep warps and the fetching warp, for nz <= 64.  For 64 < nz <= 128
// (the randomized-obstacle families, nz = 72) the same design with
// sixteen product warps and four sweep warps (672 threads) and a ring of
// 8 (about 194 KB at nz = 72, C = 11); where 8 do not fit, a ring of 3
// without K_{s+1}, which the product warps then read from device memory.
// nz is capped at 128.
#include "bwd_sweep.cuh"

constexpr int kNzMax = 128;

template <int kRowsMax, int kRing, bool kSmallC, bool kKRing>
__global__ void __launch_bounds__(bwd_threads(kRowsMax, true))
    bwd_matvec_se_kernel(BwdArgs a) {
  bwd_sweep<kRowsMax, true, kRing, kSmallC, kKRing>(a);
}

OBCA_EXPORT int obca_bwd_matvec_se_f32(
    const float* Wc, const float* y, const float* K, const float* ev,
    const int* rows, const int* cols, const int* ucols, const int* rstart,
    const int* rent, const int* cstart, const int* cent, int B, int S,
    int nz, int nnz, int C, float* p, float* Ap, void* stream) {
  if (nz < 1 || nz > kNzMax || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{Wc, y, K, ev, ucols, rows, cols, rstart, rent, cstart,
                  cent, S, nz, nnz, C,
                  // Bulk copies and float4 reads need whole 16-byte rows
                  // (nz % 4 == 0 covers nz C too) and aligned blocks.
                  nz % 4 == 0 && aligned16(Wc) && aligned16(y) &&
                      aligned16(K),
                  p, Ap};
  const bool small = C <= kCmax;
  if (nz <= 64) {
    if (bwd_smem<true, 8>(a) <= kSmemMax)
      return launch_bwd<64, true, 8>(
          small ? bwd_matvec_se_kernel<64, 8, true, true>
                : bwd_matvec_se_kernel<64, 8, false, true>,
          a, B, stream);
    return launch_bwd<64, true, 4>(
        small ? bwd_matvec_se_kernel<64, 4, true, true>
              : bwd_matvec_se_kernel<64, 4, false, true>,
        a, B, stream);
  }
  if (bwd_smem<true, 8>(a) <= kSmemMax)
    return launch_bwd<128, true, 8>(
        small ? bwd_matvec_se_kernel<128, 8, true, true>
              : bwd_matvec_se_kernel<128, 8, false, true>,
        a, B, stream);
  return launch_bwd<128, true, 3, false>(
      small ? bwd_matvec_se_kernel<128, 3, true, false>
            : bwd_matvec_se_kernel<128, 3, false, false>,
      a, B, stream);
}
