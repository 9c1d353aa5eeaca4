// fwd_se: forward substitution through the factored block-tridiagonal
// system with a sparse coupling block.
//
// Replaces obca_tpu/solver/pallas/blocktri_kernel.py:748, fwd_se (kernel
// body _fwd_se_kernel).
//
// Per scenario b (one thread block each), stages k = 0..S-1 in order:
//   yhat_k = r_k - E'_{k-1} y_{k-1}   (yhat[cols[j]] -= ev_j y_{k-1}[rows[j]])
//   y_k    = Sinv_k yhat_k
//
// Bound on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56:
// bytes Sinv 130.0 MB + r 2.3 MB in + y 2.3 MB out ~ 135 MB (~40 us);
// 2 nz^2 S B ~ 65 MFLOP is negligible.  Memory-bound on paper; each
// stage waits for the one before, so the pace is set by the latency of
// a stage and by how many bytes are in flight.
//
// The first design took 0.38 ms per call at that shape on an H100
// (about 4.7 us per stage against 0.5 us for the stage's 12.5 KB at an
// SM's share of the bandwidth): 1024 threads read ev_{k-1}, r_k and,
// after a barrier, the rows of Sinv_k from device memory, two dependent
// round trips in every stage, none of it fetched ahead.  This design:
//
// - Stages stream through a ring of kRing buffers in shared memory,
//   stage k+3 in flight while stage k computes.  One thread of the last
//   warp fetches Sinv_k (one contiguous block) and r_k with two bulk
//   (TMA) copies that report to the buffer's mbarrier; the warp's lanes
//   fetch ev_{k-1} with 4-byte cp.async.  Issuing 16-byte cp.async from
//   every thread instead stalled the issuing threads on every stage.
// - A stage's critical path is shared memory only: the correction, one
//   thread per row over that row's coupling entries (a list built
//   once), a barrier, then the product, four lanes per row with float4
//   reads and two shuffles.  The lanes of a 128-bit shared-memory phase
//   read 4 rows x 2 adjacent chunks, which fall on distinct banks at
//   nz = 56 (row stride 14 chunks).
// - 256 threads for nz <= 64.  Shapes with nz % 4 != 0 or an unaligned
//   block take 4-byte cp.async and scalar reads instead.
// Shared memory: kRing (nz^2 + nz + nnz) + 2 nz floats, independent of S.
//
// A second instantiation of the same code for 64 < nz <= 128 (the
// randomized-obstacle families run at nz = 72): 512 threads, so four
// lanes still make each row, and a ring of 4 stage buffers where it
// fits in shared memory (nz up to about 118), else of 2 (the fetch of
// stage k+1 then overlaps stage k alone).  nz is capped at 128.
#include "common.cuh"

constexpr int kLanes = 4;      // lanes per row of Sinv_k
constexpr int kNzMax = 128;    // the wide instantiation's rows
constexpr int kSmemMax = 232448;  // shared memory a block can use

// kThreads / kLanes rows; kRing stage buffers in flight (a power of 2).
template <int kThreads, int kRing>
__global__ void __launch_bounds__(kThreads)
fwd_se_kernel(const float* __restrict__ Sinv, const float* __restrict__ ev,
              const float* __restrict__ r, const int* __restrict__ rows,
              const int* __restrict__ cols, int S, int nz, int nnz,
              int slot, bool vec, float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(smem);  // [kRing]
  // Stage buffer s: Sinv_s [nz, nz], r_s [nz], ev_{s-1} [nnz].
  float* ring = smem + 2 * kRing;          // [kRing][slot]
  float* yprev = ring + kRing * slot;      // [nz] y_{k-1}
  float* yhat = yprev + ((nz + 3) & ~3);   // [nz], 16-byte aligned
  int* irow = reinterpret_cast<int*>(yhat + ((nz + 3) & ~3));  // [nnz]
  int* ent = irow + nnz;     // [nnz] coupling entries ordered by column
  int* rstart = ent + nnz;   // [nz + 1] first entry of each column

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // Product: lane = 16 quad + 8 h + 2 rr + par holds row 8 warp + 4 quad
  // + rr and reads its chunks l, l+4, ... with l = 2 h + par.
  const int row = (tid >> 5) * 8 + (lane >> 4) * 4 + ((lane >> 1) & 3);
  const int l = ((lane >> 3) & 1) * 2 + (lane & 1);
  const int plane = tid - (kThreads - 32);  // lane in the fetching warp
  const size_t blk = static_cast<size_t>(nz) * nz;
  const float* Sb = Sinv + static_cast<size_t>(b) * S * blk;
  const float* evb = ev + static_cast<size_t>(b) * (S - 1) * nnz;
  const float* rb = r + static_cast<size_t>(b) * S * nz;
  float* yb = y + static_cast<size_t>(b) * S * nz;

  // Stage s into buffer s % kRing (run by the last warp; one cp.async
  // group per call, empty past S).
  auto fetch = [&](int s) {
    if (s < S) {
      float* dst = ring + (s & (kRing - 1)) * slot;
      const float* src = Sb + s * blk;
      float* rd = dst + blk;
      if (vec) {
        if (plane == 0) {
          unsigned long long* bar = mbar + (s & (kRing - 1));
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect_tx(bar, static_cast<unsigned>((blk + nz) * 4));
          bulk_copy(dst, src, static_cast<unsigned>(blk * 4), bar);
          bulk_copy(rd, rb + static_cast<size_t>(s) * nz,
                    static_cast<unsigned>(nz * 4), bar);
        }
      } else {
        for (int e = plane; e < static_cast<int>(blk); e += 32)
          cp_async4(dst + e, src + e);
        for (int e = plane; e < nz; e += 32)
          cp_async4(rd + e, rb + static_cast<size_t>(s) * nz + e);
      }
      if (s > 0)
        for (int e = plane; e < nnz; e += 32)
          cp_async4(rd + nz + e, evb + static_cast<size_t>(s - 1) * nnz + e);
    }
    cp_async_commit();
  };

  load_ints(irow, rows, nnz);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(mbar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // The coupling entries of each column, in order of j.
    int e = 0;
    for (int i = 0; i < nz; ++i) {
      rstart[i] = e;
      for (int j = 0; j < nnz; ++j)
        if (cols[j] == i) ent[e++] = j;
    }
    rstart[nz] = e;
  }
  __syncthreads();
  if (plane >= 0)
    for (int s = 0; s < kRing - 1; ++s) fetch(s);

  for (int k = 0; k < S; ++k) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage k
    if (vec) mbar_wait(mbar + (k & (kRing - 1)), (k / kRing) & 1);
    __syncthreads();
    const float* st = ring + (k & (kRing - 1)) * slot;
    const float* rk = st + blk;
    const float* evk = rk + nz;
    if (tid < nz) {
      float sub = 0.0f;
      if (k > 0)
        for (int e = rstart[tid]; e < rstart[tid + 1]; ++e) {
          const int j = ent[e];
          sub += evk[j] * yprev[irow[j]];
        }
      yhat[tid] = rk[tid] - sub;
    }
    __syncthreads();
    float acc = 0.0f;
    if (row < nz) {
      const float* Srow = st + row * nz;
      if (vec) {
        float acc1 = 0.0f;
        const float4* S4 = reinterpret_cast<const float4*>(Srow);
        const float4* y4 = reinterpret_cast<const float4*>(yhat);
        for (int c = l; c < nz / 4; c += kLanes) {
          const float4 s4 = S4[c], v4 = y4[c];
          acc = fmaf(s4.x, v4.x, fmaf(s4.y, v4.y, acc));
          acc1 = fmaf(s4.z, v4.z, fmaf(s4.w, v4.w, acc1));
        }
        acc += acc1;
      } else {
        for (int c = l; c < nz; c += kLanes) acc = fmaf(Srow[c], yhat[c], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 8);
    if (row < nz && l == 0) {
      yprev[row] = acc;
      yb[static_cast<size_t>(k) * nz + row] = acc;
    }
    // Buffer (k + kRing - 1) % kRing last held stage k-1, read before the
    // barrier at the top of this stage.
    if (plane >= 0) fetch(k + kRing - 1);
  }
}

// Shared memory of a launch with kRing stage buffers.
template <int kRing>
static size_t fwd_se_smem(int nz, int slot, int nnz) {
  return sizeof(float) * (2 * kRing + kRing * slot + 2 * ((nz + 3) & ~3)) +
         sizeof(int) * (2 * nnz + nz + 1);
}

template <int kThreads, int kRing>
static int launch_fwd_se(const float* Sinv, const float* ev, const float* r,
                         const int* rows, const int* cols, int B, int S,
                         int nz, int nnz, int slot, bool vec, float* y,
                         void* stream) {
  const size_t smem = fwd_se_smem<kRing>(nz, slot, nnz);
  cudaError_t err = allow_smem(fwd_se_kernel<kThreads, kRing>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_se_kernel<kThreads, kRing>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          Sinv, ev, r, rows, cols, S, nz, nnz, slot, vec, y);
  return static_cast<int>(cudaGetLastError());
}

OBCA_EXPORT int obca_fwd_se_f32(const float* Sinv, const float* ev,
                                const float* r, const int* rows,
                                const int* cols, int B, int S, int nz,
                                int nnz, float* y, void* stream) {
  if (nz < 1 || nz > kNzMax) return static_cast<int>(cudaErrorInvalidValue);
  // Bulk copies and float4 reads need whole 16-byte rows and aligned
  // blocks.
  const bool vec = nz % 4 == 0 && aligned16(Sinv) && aligned16(r);
  const int slot = (nz * nz + nz + nnz + 3) / 4 * 4;
  if (nz <= 64)
    return launch_fwd_se<256, 4>(Sinv, ev, r, rows, cols, B, S, nz, nnz,
                                 slot, vec, y, stream);
  if (fwd_se_smem<4>(nz, slot, nnz) <= kSmemMax)
    return launch_fwd_se<512, 4>(Sinv, ev, r, rows, cols, B, S, nz, nnz,
                                 slot, vec, y, stream);
  return launch_fwd_se<512, 2>(Sinv, ev, r, rows, cols, B, S, nz, nnz, slot,
                               vec, y, stream);
}
