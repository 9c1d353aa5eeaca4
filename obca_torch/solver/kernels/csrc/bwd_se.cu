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
// The sweep of bwd_sweep.cuh without its lagged matvec.
//
// Bound on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56,
// C=11: bytes Wc 25.2 MB + y 2.3 MB in, p 2.3 MB out ~ 30 MB (~9 us);
// 2 nz C (S-1) B ~ 13 MFLOP is negligible.  Memory-bound on paper, but
// each stage waits for the one before: once the stages arrive ahead of
// time, the pace is the latency of one stage's chain (a barrier, the
// u loads, C FMAs, the stores).  A stage is only Wc_s + y_s (about
// 2.7 KB at that shape), so the ring holds 16 of them (about 43 KB; a
// stage is fetched 14 steps before it is swept, far more than the
// memory latency).  A pattern too wide for 16 buffers (C near nz at the
// cap) takes a ring of 4; one too wide for 4 is refused.
// 96 threads: two sweep warps, one per row, and the fetching warp, for
// nz <= 64.  For 64 < nz <= 128 (the randomized-obstacle families, nz =
// 72) the same sweep with four sweep warps (160 threads) and a ring of
// 16, or of 3 where 16 do not fit.  nz is capped at 128.
#include "bwd_sweep.cuh"

constexpr int kNzMax = 128;

template <int kRowsMax, int kRing, bool kSmallC>
__global__ void __launch_bounds__(bwd_threads(kRowsMax, false))
    bwd_se_kernel(BwdArgs a) {
  bwd_sweep<kRowsMax, false, kRing, kSmallC>(a);
}

OBCA_EXPORT int obca_bwd_se_f32(const float* Wc, const float* y,
                                const int* ucols, int B, int S, int nz,
                                int C, float* p, void* stream) {
  if (nz < 1 || nz > kNzMax || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{Wc, y, nullptr, nullptr, ucols, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, S, nz, 0, C,
                  // Bulk copies and float4 reads need whole 16-byte rows
                  // (nz % 4 == 0 covers nz C too) and aligned blocks.
                  nz % 4 == 0 && aligned16(Wc) && aligned16(y), p,
                  nullptr};
  const bool small = C <= kCmax;
  if (nz <= 64) {
    if (bwd_smem<false, 16>(a) <= kSmemMax)
      return launch_bwd<64, false, 16>(
          small ? bwd_se_kernel<64, 16, true> : bwd_se_kernel<64, 16, false>,
          a, B, stream);
    return launch_bwd<64, false, 4>(
        small ? bwd_se_kernel<64, 4, true> : bwd_se_kernel<64, 4, false>, a,
        B, stream);
  }
  if (bwd_smem<false, 16>(a) <= kSmemMax)
    return launch_bwd<128, false, 16>(
        small ? bwd_se_kernel<128, 16, true> : bwd_se_kernel<128, 16, false>,
        a, B, stream);
  return launch_bwd<128, false, 3>(
      small ? bwd_se_kernel<128, 3, true> : bwd_se_kernel<128, 3, false>, a,
      B, stream);
}
