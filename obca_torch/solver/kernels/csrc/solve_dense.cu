// fwd_dense, bwd_dense: forward and backward substitution through the
// factored block-tridiagonal system with dense coupling blocks.
//
// Replace obca_tpu/solver/pallas/blocktri_kernel.py:262, solve_batched
// (its two pallas_calls, kernel bodies _fwd_kernel and _bwd_kernel).
//
// Per scenario b (one thread block each):
//   fwd_dense, stages k = 0..S-1 in order:
//     yhat_k = r_k - E'_{k-1} y_{k-1}   (yhat_0 = r_0)
//     y_k    = Sinv_k yhat_k
//   bwd_dense, stages k = S-1..0 in order:
//     x_{S-1} = y_{S-1},  x_k = y_k - W_k x_{k+1}
//
// Bounds on an H100 SXM (3.35 TB/s), main-path shape B=128, S=81, nz=56:
// fwd_dense Sinv 130.1 MB + E 128.5 MB + r 2.3 MB in, y 2.3 MB out
// ~ 263 MB (~79 us); bwd_dense W 128.5 MB + y 2.3 MB in, x 2.3 MB out
// ~ 133 MB (~40 us); 4 nz^2 S B and 2 nz^2 S B operations are negligible.
// Memory-bound on paper; each stage waits for the one before, so the
// pace is set by the latency of a stage and by how many bytes are in
// flight.  At one SM's share of the bandwidth (about 25 GB/s) a stage of
// fwd_dense (25 KB at nz=56) takes about 1 us to arrive.
//
// fwd_dense.  The first design took 0.70 ms per call at that shape on an
// H100: 1024 threads read E_{k-1} and Sinv_k straight from device memory
// on the stage chain, two barriers a stage, 56 threads busy in the E'y
// phase.  This design gives each warp one role:
// - one fetching warp: the stages stream through a ring of kRing
//   buffers in shared memory (Sinv_k, E_{k-1}, r_k; 25 KB at nz=56),
//   stage k+3 in flight while stage k computes.  Lane 0 fetches each
//   part with one bulk (TMA) copy that reports to the buffer's mbarrier;
//   before the barrier that ends stage k the warp waits until stage k+1
//   has landed, so that the barrier publishes it to every warp and no
//   other warp waits on an mbarrier.
// - eight compute warps, two short phases from shared memory a stage,
//   one barrier after each:
//   yhat = r_k - E'_{k-1} y_{k-1}: four lanes per output i, lane part t
//   over rows l = t, t+4, ... of E (the lanes of a warp read four rows
//   of eight consecutive columns, distinct banks at nz = 56), two
//   shuffles;
//   y_k = Sinv_k yhat: four lanes per row with float4 reads and two
//   shuffles (as in fwd_se).
//   Every loop has a compile-time bound (rows and chunks up to the cap,
//   predicated past nz) and issues all its loads before its FMAs.
// Shapes that break the bulk copy's 16-byte rule (nz % 4 != 0, or an
// unaligned base) take 4-byte cp.async for every part and scalar reads
// (`vec` false).  Shared memory: kRing (2 nz^2 + nz) floats and 128 more
// (101 KB at nz=56), independent of S.  288 threads for nz <= 64 (the
// wrapper raises above the cap of 128; the entry point refuses it too).
//
// bwd_dense.  The first design took 0.2223 ms per call at that shape on
// an H100: 1024 threads, one warp per row of W_k read from device memory
// on the stage chain, so every stage waited on a round trip to device
// memory for its 12.5 KB.  This design is fwd_dense's with one phase:
// - one fetching warp streams W_k and y_k (12.5 KB at nz=56) through a
//   ring of kBwdRing buffers by bulk copies, stage k-7 in flight while
//   stage k computes (about the bytes in flight of fwd_dense's ring);
//   before the barrier that ends stage k it waits until stage k-1 has
//   landed, so no other warp waits on an mbarrier;
// - eight compute warps: x_k = y_k - W_k x_{k+1}, four lanes per row
//   with float4 reads and two shuffles, as fwd_dense's second phase
//   (quad_row_dot); one barrier a stage, since x_k needs all of x_{k+1}.
// The same 4-byte route for odd nz or an unaligned base.  Shared memory:
// kBwdRing (nz^2 + nz) floats and 128 more (102 KB at nz=56).
//
// Both have a second instantiation for 64 < nz <= 128 (the randomized-
// obstacle families run at nz = 72): sixteen compute warps, so four
// lanes still make each row or output, and register arrays twice as
// long.  Two stages of Sinv_k and E_{k-1} do not fit in shared memory at
// nz = 128, so the wide fwd_dense streams Sinv_k and r_k alone through
// its ring (4 buffers, or 2 where 4 do not fit) and reads E_{k-1} from
// device memory in the E'y phase, every load of a thread issued before
// its FMAs.  The wide bwd_dense keeps a ring of 8, or of 2 where 8 do
// not fit.  A ring of 2 still has stage k+1 fetched before stage k
// ends, but overlaps one stage only.  nz is capped at 128.
#include "common.cuh"

constexpr int kLanes = 4;         // lanes per output or row
constexpr int kSmemMax = 232448;  // shared memory a block can use

// kWarps compute warps (8 or 16) hold kWarps * 8 rows; one fetching warp.
__host__ __device__ constexpr int dense_threads(int warps) {
  return 32 * (warps + 1);
}
__host__ __device__ constexpr int dense_nz_max(int warps) {
  return 32 * warps / kLanes;
}
constexpr int kNzMax = dense_nz_max(16);  // 128

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Offsets (floats) of a stage's parts inside one ring buffer; each part
// starts 16-byte aligned.  E_{k-1} rides along only with ering.
struct FwdLayout {
  int sinv, e, r, slot;
  __host__ __device__ FwdLayout(int nz, bool ering)
      : sinv(0),
        e(round4(nz * nz)),
        r((ering ? 2 : 1) * round4(nz * nz)),
        slot(r + round4(nz)) {}
};

// The same for bwd_dense's W_k and y_k.
struct BwdLayout {
  int w, y, slot;
  __host__ __device__ explicit BwdLayout(int nz)
      : w(0), y(round4(nz * nz)), slot(round4(nz * nz) + round4(nz)) {}
};

// Row `row` of an nz x nz block in shared memory (mrow points at it)
// times the vector v (shared memory, kNz floats, zero past nz): lane
// part pl = 0..3 of the row's four lanes sums chunks pl, pl+4, ...
// (float4 when vec), loads before FMAs, and two shuffles give each of
// the four lanes the total.  The quad's lanes differ in lane bits 0 and
// 3 (lane = 16 quad + 8 h + 2 rr + par, pl = 2 h + par), so the lanes
// of a 128-bit shared-memory phase fall on distinct banks at nz = 56.
template <int kNz>
__device__ __forceinline__ float quad_row_dot(const float* mrow,
                                              const float* v, int nz,
                                              int pl, bool vec) {
  float acc0 = 0.0f, acc1 = 0.0f;
  if (vec) {
    const int nch = nz >> 2;
    const float4* m4 = reinterpret_cast<const float4*>(mrow);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float4 mq[kNz / 16], vq[kNz / 16];
#pragma unroll
    for (int u = 0; u < kNz / 16; ++u) {
      const int c = pl + kLanes * u;
      mq[u] = c < nch ? m4[c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vq[u] = v4[c];
    }
#pragma unroll
    for (int u = 0; u < kNz / 16; ++u) {
      acc0 = fmaf(mq[u].x, vq[u].x, fmaf(mq[u].y, vq[u].y, acc0));
      acc1 = fmaf(mq[u].z, vq[u].z, fmaf(mq[u].w, vq[u].w, acc1));
    }
  } else {
    float mv[kNz / kLanes], vv[kNz / kLanes];
#pragma unroll
    for (int u = 0; u < kNz / kLanes; ++u) {
      const int c = pl + kLanes * u;
      mv[u] = c < nz ? mrow[c] : 0.0f;
      vv[u] = v[c];
    }
#pragma unroll
    for (int u = 0; u < kNz / kLanes; u += 2) {
      acc0 = fmaf(mv[u], vv[u], acc0);
      acc1 = fmaf(mv[u + 1], vv[u + 1], acc1);
    }
  }
  float acc = acc0 + acc1;
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 8);
  return acc;
}

template <int kWarps, int kRing, bool kERing>
__global__ void __launch_bounds__(dense_threads(kWarps))
fwd_dense_kernel(const float* __restrict__ Sinv, const float* __restrict__ E,
                 const float* __restrict__ r, int S, int nz, bool vec,
                 float* __restrict__ y) {
  static_assert((kRing & (kRing - 1)) == 0 && kRing >= 2,
                "a power of two, and stage k+1 fetched before stage k ends");
  constexpr int kNzMax = dense_nz_max(kWarps);
  const FwdLayout lay(nz, kERing);
  extern __shared__ __align__(16) float smem[];
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(smem);  // [kRing]
  float* ring = smem + 2 * kRing;                   // [kRing][lay.slot]
  float* yprev = ring + kRing * lay.slot;           // [kNzMax] y_{k-1}
  float* yhat = yprev + kNzMax;                     // [kNzMax]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool fetcher = warp == kWarps;
  const int blk = nz * nz;
  const size_t sblk = static_cast<size_t>(blk);
  const float* Sb = Sinv + static_cast<size_t>(b) * S * sblk;
  const float* Eb = E + static_cast<size_t>(b) * (S - 1) * sblk;
  const float* rb = r + static_cast<size_t>(b) * S * nz;
  float* yb = y + static_cast<size_t>(b) * S * nz;

  // Stage s into buffer s % kRing (run by the fetching warp; one
  // cp.async group per call, empty past S).
  auto fetch = [&](int s) {
    if (s < S) {
      float* dst = ring + (s & (kRing - 1)) * lay.slot;
      const float* ssrc = Sb + s * sblk;
      const float* esrc = kERing && s > 0 ? Eb + (s - 1) * sblk : nullptr;
      const float* rsrc = rb + static_cast<size_t>(s) * nz;
      if (vec) {
        if (lane == 0) {
          unsigned long long* bar = mbar + (s & (kRing - 1));
          mbar_expect_tx(bar, 4u * ((esrc ? 2 * blk : blk) + nz));
          bulk_copy(dst + lay.sinv, ssrc, 4u * blk, bar);
          if (esrc) bulk_copy(dst + lay.e, esrc, 4u * blk, bar);
          bulk_copy(dst + lay.r, rsrc, 4u * nz, bar);
        }
      } else {
        for (int e = lane; e < blk; e += 32) {
          cp_async4(dst + lay.sinv + e, ssrc + e);
          if (esrc) cp_async4(dst + lay.e + e, esrc + e);
        }
        for (int e = lane; e < nz; e += 32)
          cp_async4(dst + lay.r + e, rsrc + e);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(mbar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < 2 * kNzMax; e += blockDim.x) yprev[e] = 0.0f;
  __syncthreads();
  if (fetcher) {
    for (int s = 0; s < kRing - 1; ++s) fetch(s);
    cp_async_wait<kRing - 2>();  // stage 0
    if (vec) mbar_wait(mbar, 0);
  }

  // E'y phase: output i = tid / 4, part t over rows t, t+4, ...  Outputs
  // past nz read column nz-1 and are not stored.
  const int oi = tid >> 2;
  const int ot = tid & 3;
  const int oic = min(oi, nz - 1);
  // Product phase: row 8 warp + 4 quad + rr, lane part pl (see
  // quad_row_dot).  Rows past nz read row nz-1 and are not stored.
  const int row = warp * 8 + (lane >> 4) * 4 + ((lane >> 1) & 3);
  const int pl = ((lane >> 3) & 1) * 2 + (lane & 1);
  const int rowc = min(row, nz - 1);
  __syncthreads();

  for (int k = 0; k < S; ++k) {
    const float* st = ring + (k & (kRing - 1)) * lay.slot;
    if (fetcher) {
      // Buffer (k - 1) % kRing: its readers (stage k-1) are done.
      fetch(k + kRing - 1);
    } else {
      float s0 = 0.0f, s1 = 0.0f;
      if (k > 0) {
        const float* ec =
            (kERing ? st + lay.e : Eb + (k - 1) * sblk) + oic;
        float ev[kNzMax / kLanes], yv[kNzMax / kLanes];
#pragma unroll
        for (int u = 0; u < kNzMax / kLanes; ++u) {
          const int l = ot + kLanes * u;
          ev[u] = l < nz ? ec[l * nz] : 0.0f;
          yv[u] = yprev[l];
        }
#pragma unroll
        for (int u = 0; u < kNzMax / kLanes; u += 2) {
          s0 = fmaf(ev[u], yv[u], s0);
          s1 = fmaf(ev[u + 1], yv[u + 1], s1);
        }
      }
      float sub = s0 + s1;
      sub += __shfl_xor_sync(0xffffffffu, sub, 1);
      sub += __shfl_xor_sync(0xffffffffu, sub, 2);
      if (ot == 0 && oi < nz) yhat[oi] = st[lay.r + oi] - sub;
    }
    // yhat is published.
    __syncthreads();
    if (!fetcher) {
      const float acc = quad_row_dot<kNzMax>(st + lay.sinv + rowc * nz,
                                             yhat, nz, pl, vec);
      if (row < nz && pl == 0) {
        yprev[row] = acc;
        yb[static_cast<size_t>(k) * nz + row] = acc;
      }
    } else if (k + 1 < S) {
      // Stage k+1 has landed: the barrier publishes it to every warp.
      cp_async_wait<kRing - 2>();
      const int h = k + 1;
      if (vec) mbar_wait(mbar + (h & (kRing - 1)), (h / kRing) & 1);
    }
    // y_k is published; every thread is done with stage k's buffer.
    __syncthreads();
  }
}

template <int kWarps, int kBwdRing>
__global__ void __launch_bounds__(dense_threads(kWarps))
bwd_dense_kernel(const float* __restrict__ W, const float* __restrict__ y,
                 int S, int nz, bool vec, float* __restrict__ x) {
  static_assert((kBwdRing & (kBwdRing - 1)) == 0 && kBwdRing >= 2,
                "a power of two, and step j+1 fetched before step j ends");
  constexpr int kNzMax = dense_nz_max(kWarps);
  const BwdLayout lay(nz);
  extern __shared__ __align__(16) float smem[];
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(smem);  // [kBwdRing]
  float* ring = smem + 2 * kBwdRing;                // [kBwdRing][lay.slot]
  float* xs = ring + kBwdRing * lay.slot;  // [2][kNzMax] x_{k+1}, x_k

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool fetcher = warp == kWarps;
  const int blk = nz * nz;
  const size_t sblk = static_cast<size_t>(blk);
  const float* Wb = W + static_cast<size_t>(b) * (S - 1) * sblk;
  const float* yb = y + static_cast<size_t>(b) * S * nz;
  float* xb = x + static_cast<size_t>(b) * S * nz;
  // Step j computes stage k = S-2-j.
  const int steps = S - 1;

  // Step j's W_k and y_k into buffer j % kBwdRing (run by the fetching
  // warp; one cp.async group per call, empty past the last step).
  auto fetch = [&](int j) {
    if (j < steps) {
      const int k = S - 2 - j;
      float* dst = ring + (j & (kBwdRing - 1)) * lay.slot;
      const float* wsrc = Wb + k * sblk;
      const float* ysrc = yb + static_cast<size_t>(k) * nz;
      if (vec) {
        if (lane == 0) {
          unsigned long long* bar = mbar + (j & (kBwdRing - 1));
          mbar_expect_tx(bar, 4u * (blk + nz));
          bulk_copy(dst + lay.w, wsrc, 4u * blk, bar);
          bulk_copy(dst + lay.y, ysrc, 4u * nz, bar);
        }
      } else {
        for (int e = lane; e < blk; e += 32)
          cp_async4(dst + lay.w + e, wsrc + e);
        for (int e = lane; e < nz; e += 32)
          cp_async4(dst + lay.y + e, ysrc + e);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    for (int s = 0; s < kBwdRing; ++s) mbar_init(mbar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // x_{S-1} = y_{S-1}; both halves of xs are zero past nz.
  for (int e = tid; e < 2 * kNzMax; e += blockDim.x) {
    const float v = e < nz ? yb[static_cast<size_t>(S - 1) * nz + e] : 0.0f;
    xs[e] = v;
    if (e < nz) xb[static_cast<size_t>(S - 1) * nz + e] = v;
  }
  __syncthreads();
  if (fetcher) {
    for (int j = 0; j < kBwdRing - 1; ++j) fetch(j);
    cp_async_wait<kBwdRing - 2>();  // step 0
    if (vec && steps > 0) mbar_wait(mbar, 0);
  }

  // Row 8 warp + 4 quad + rr, lane part pl (see quad_row_dot).  Rows
  // past nz read row nz-1 and are not stored.
  const int row = warp * 8 + (lane >> 4) * 4 + ((lane >> 1) & 3);
  const int pl = ((lane >> 3) & 1) * 2 + (lane & 1);
  const int rowc = min(row, nz - 1);
  __syncthreads();

  for (int j = 0; j < steps; ++j) {
    const float* st = ring + (j & (kBwdRing - 1)) * lay.slot;
    if (fetcher) {
      // Buffer (j - 1) % kBwdRing: its readers (step j-1) are done.
      fetch(j + kBwdRing - 1);
      if (j + 1 < steps) {
        // Step j+1 has landed: the barrier publishes it to every warp.
        cp_async_wait<kBwdRing - 2>();
        const int h = j + 1;
        if (vec) mbar_wait(mbar + (h & (kBwdRing - 1)), (h / kBwdRing) & 1);
      }
    } else {
      const float acc = quad_row_dot<kNzMax>(st + lay.w + rowc * nz,
                                             xs + (j & 1) * kNzMax, nz, pl,
                                             vec);
      if (row < nz && pl == 0) {
        const int k = S - 2 - j;
        const float v = st[lay.y + row] - acc;
        xs[((j + 1) & 1) * kNzMax + row] = v;
        xb[static_cast<size_t>(k) * nz + row] = v;
      }
    }
    // x_k is published; every thread is done with step j's buffer and
    // with x_{k+1}, which step j+1 overwrites with x_{k-1}.
    __syncthreads();
  }
}

template <int kWarps, int kRing, bool kERing>
static size_t fwd_dense_smem(int nz) {
  return sizeof(float) * (2 * kRing + kRing * FwdLayout(nz, kERing).slot +
                          2 * dense_nz_max(kWarps));
}

template <int kWarps, int kRing, bool kERing>
static int launch_fwd_dense(const float* Sinv, const float* E,
                            const float* r, int B, int S, int nz, bool vec,
                            float* y, void* stream) {
  const size_t smem = fwd_dense_smem<kWarps, kRing, kERing>(nz);
  auto kernel = fwd_dense_kernel<kWarps, kRing, kERing>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, dense_threads(kWarps), smem,
           static_cast<cudaStream_t>(stream)>>>(Sinv, E, r, S, nz, vec, y);
  return static_cast<int>(cudaGetLastError());
}

OBCA_EXPORT int obca_fwd_dense_f32(const float* Sinv, const float* E,
                                   const float* r, int B, int S, int nz,
                                   float* y, void* stream) {
  if (nz < 1 || nz > kNzMax) return static_cast<int>(cudaErrorInvalidValue);
  // Bulk copies and float4 reads need whole 16-byte rows and aligned
  // blocks.
  const bool vec = nz % 4 == 0 && aligned16(Sinv) && aligned16(E) &&
                   aligned16(r);
  if (nz <= dense_nz_max(8))
    return launch_fwd_dense<8, 4, true>(Sinv, E, r, B, S, nz, vec, y,
                                        stream);
  if (fwd_dense_smem<16, 4, false>(nz) <= kSmemMax)
    return launch_fwd_dense<16, 4, false>(Sinv, E, r, B, S, nz, vec, y,
                                          stream);
  return launch_fwd_dense<16, 2, false>(Sinv, E, r, B, S, nz, vec, y,
                                        stream);
}

template <int kWarps, int kBwdRing>
static size_t bwd_dense_smem(int nz) {
  return sizeof(float) * (2 * kBwdRing + kBwdRing * BwdLayout(nz).slot +
                          2 * dense_nz_max(kWarps));
}

template <int kWarps, int kBwdRing>
static int launch_bwd_dense(const float* W, const float* y, int B, int S,
                            int nz, bool vec, float* x, void* stream) {
  const size_t smem = bwd_dense_smem<kWarps, kBwdRing>(nz);
  auto kernel = bwd_dense_kernel<kWarps, kBwdRing>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, dense_threads(kWarps), smem,
           static_cast<cudaStream_t>(stream)>>>(W, y, S, nz, vec, x);
  return static_cast<int>(cudaGetLastError());
}

OBCA_EXPORT int obca_bwd_dense_f32(const float* W, const float* y, int B,
                                   int S, int nz, float* x, void* stream) {
  if (nz < 1 || nz > kNzMax) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = nz % 4 == 0 && aligned16(W) && aligned16(y);
  if (nz <= dense_nz_max(8))
    return launch_bwd_dense<8, 8>(W, y, B, S, nz, vec, x, stream);
  if (bwd_dense_smem<16, 8>(nz) <= kSmemMax)
    return launch_bwd_dense<16, 8>(W, y, B, S, nz, vec, x, stream);
  return launch_bwd_dense<16, 2>(W, y, B, S, nz, vec, x, stream);
}
