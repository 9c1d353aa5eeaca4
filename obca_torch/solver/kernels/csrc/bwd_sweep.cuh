// The backward sweep through the factor of a block-tridiagonal system
// with a sparse coupling block, shared by bwd_se.cu (the sweep alone)
// and bwd_matvec_se.cu (the sweep with the true system's matvec one
// stage behind it).
//
// Per scenario b (one thread block each), steps g = 0, 1, ... in order,
// p-stage s = S-1-g:
//   sweep (g < S):   p_{S-1} = y_{S-1},
//                    p_s = y_s - sum_c Wc_s[:, c] p_{s+1}[ucols[c]]
//   lagged matvec (kMatvec, g >= 1), t = s+1:
//                    Ap_t = K_t p_t + E_t p_{t+1} + E'_{t-1} p_{t-1}
//   (no E terms past the ends; the last step, g = S, forms Ap_0 alone).
// The matvec of stage t needs p_{t-1} = p_s, so it runs right after the
// sweep has made p_s, as the TPU kernel's one-stage-lagged matvec does;
// the TPU's one-hot placement matrices become per-row coupling lists.
//
// A step is one block barrier, and each warp has one role in it:
// - two sweep warps, one thread per row of p_s (nz <= 64): C FMAs from
//   shared memory, the Wc_s row (stride C, bank-conflict-free for odd C)
//   against u_{s+1} = p_{s+1}[ucols], which the thread of row ucols[c]
//   stores at u[c] as it makes p, so nothing on the chain is an indexed
//   read.
// - one fetching warp: the data of a step streams through a ring of
//   kRing buffers in shared memory.  After the barrier of step g, lane 0
//   fetches each contiguous part of step g+kRing-1 (Wc_s, y_s and, with
//   the matvec, K_{s+1}) with one bulk (TMA) copy that reports to the
//   buffer's mbarrier, and the lanes fetch the 44-byte ev rows with
//   4-byte cp.async; before that barrier the warp waits until step g+1
//   has landed, so that the barrier publishes it to every warp and no
//   other warp waits on an mbarrier.  Shapes that break the bulk copy's
//   16-byte rule (nz % 4 != 0, which covers nz C % 4, or an unaligned
//   base) take 4-byte cp.async for every part and scalar reads (`vec`
//   false).
// - with the matvec, eight product warps: row Ap_{s+1} in step g, four
//   lanes per row of K_{s+1} with float4 reads and two shuffles, while
//   the sweep warps make p_{s-1}.  Two of the four lanes walk the row's
//   coupling lists (entries with rows[j] == i, entries with cols[j] ==
//   i; built once per pattern on the host), the first kEregs entries of
//   each from registers, any further ones from device memory.
// Each step's path is short, straight code: the loops over columns and
// chunks have compile-time bounds (kCmax columns, or a plain loop for
// wider patterns) and every shared-memory load of a row is issued before
// its FMAs.  A block holds one warp per scheduler or so, so each
// dependent instruction on that path costs its full latency.
// p_s and u_s live in four-slot buffers (slot s % 4): the sweep of step
// g+1 writes the slot that no lagged row of step g reads.  Shared memory
// does not grow with S.
//
// Two instantiations by kRowsMax, the rows a block holds: 64 (two sweep
// warps, eight product warps) for nz <= 64, and 128 (four sweep warps,
// sixteen product warps) for 64 < nz <= 128, where the randomized-
// obstacle families run (nz = 72).  Their code is the same; the wide
// one's register arrays are twice as long.  A ring whose stage buffers
// do not fit may hold 3 of them (any kRing >= 3 keeps step g+1 fetched
// before step g ends), and with kKRing false the product warps read
// K_{s+1} straight from device memory instead of the ring, which keeps
// the stage small enough at nz = 128 with C near nz.
#pragma once

#include "common.cuh"

constexpr int kLanes = 4;          // lanes per row of K_t in the product
constexpr int kPSlots = 4;         // p_s, p_{s+1}, p_{s+2}, the next p
constexpr int kCmax = 12;          // columns of the unrolled sweep row
constexpr int kEregs = 4;          // coupling entries held in registers
constexpr int kSmemMax = 232448;   // shared memory a block can use

// Warps of a block that holds kRowsMax rows: product warps (eight rows
// of four lanes each) and sweep warps (one thread a row).
__host__ __device__ constexpr int product_warps(int rows_max) {
  return rows_max / 8;
}
__host__ __device__ constexpr int sweep_warps(int rows_max) {
  return rows_max / 32;
}

// Threads of a block: the product warps, the sweep warps, one fetching.
__host__ __device__ constexpr int bwd_threads(int rows_max, bool matvec) {
  return 32 * ((matvec ? product_warps(rows_max) : 0) +
               sweep_warps(rows_max) + 1);
}

// Buffer of step g in a ring of kRing.
template <int kRing>
__device__ __forceinline__ int ring_at(int g) {
  if constexpr ((kRing & (kRing - 1)) == 0) {
    return g & (kRing - 1);
  } else {
    return g % kRing;
  }
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Offsets (floats) of a step's parts inside one stage buffer; each part
// starts 16-byte aligned.  K_{s+1} rides along only with the matvec and
// kring.
struct StageLayout {
  int wc, y, k, ev, slot;
  __host__ __device__ StageLayout(bool matvec, bool kring, int nz, int nnz,
                                  int C)
      : wc(0),
        y(round4(nz * C)),
        k(y + round4(nz)),
        ev(k + (kring ? round4(nz * nz) : 0)),
        slot(matvec ? ev + round4(2 * nnz) : k) {}
};

// Floats of one u slot (read as float4 up to kCmax).
__host__ __device__ inline int uslot(int C) {
  return round4(C > kCmax ? C : kCmax);
}

struct BwdArgs {
  const float* Wc;     // [B, S-1, nz, C]
  const float* y;      // [B, S, nz]
  const float* K;      // [B, S, nz, nz] (matvec only)
  const float* ev;     // [B, S-1, nnz] (matvec only)
  const int* ucols;    // [C]
  const int* rows;     // [nnz] (matvec only, as are the lists below)
  const int* cols;     // [nnz]
  const int* rstart;   // [nz + 1] entries with rows[j] == i:
  const int* rent;     //   rent[rstart[i] .. rstart[i+1])
  const int* cstart;   // [nz + 1] entries with cols[j] == i:
  const int* cent;     //   cent[cstart[i] .. cstart[i+1])
  int S, nz, nnz, C;
  bool vec;            // bulk copies and float4 reads
  float* p;            // [B, S, nz]
  float* Ap;           // [B, S, nz] (matvec only)
};

// Dynamic shared memory of a launch: mbarriers, the ring, the p and u
// slots and ucols.
template <bool kMatvec, int kRing, bool kKRing = true>
inline size_t bwd_smem(const BwdArgs& a) {
  const StageLayout lay(kMatvec, kKRing, a.nz, a.nnz, a.C);
  const size_t floats = round4(2 * kRing) +
                        static_cast<size_t>(kRing) * lay.slot +
                        kPSlots * (round4(a.nz) + uslot(a.C));
  return sizeof(float) * floats + sizeof(int) * a.C;
}

// One row of the sweep from shared memory: y - sum_c wrow[c] u[c], u
// 16-byte aligned with uslot(C) floats.
template <bool kSmallC>
__device__ __forceinline__ float sweep_row(const float* wrow,
                                           const float* u, int C, float y) {
  float acc[4] = {y, 0.0f, 0.0f, 0.0f};
  const float4* u4 = reinterpret_cast<const float4*>(u);
  if constexpr (kSmallC) {
    // Every load first, each into a register of its own; the loads past
    // C stay inside shared memory and feed no FMA.
    float w[kCmax], v[kCmax];
#pragma unroll
    for (int c = 0; c < kCmax; c += 4) {
      const float4 q = u4[c >> 2];
      v[c] = q.x;
      v[c + 1] = q.y;
      v[c + 2] = q.z;
      v[c + 3] = q.w;
    }
#pragma unroll
    for (int c = 0; c < kCmax; ++c) w[c] = wrow[c];
#pragma unroll
    for (int c = 0; c < kCmax; ++c)
      if (c < C) acc[c & 3] = fmaf(-w[c], v[c], acc[c & 3]);
  } else {
    int c = 0;
    for (; c + 4 <= C; c += 4) {
      const float4 q = u4[c >> 2];
      acc[0] = fmaf(-wrow[c], q.x, acc[0]);
      acc[1] = fmaf(-wrow[c + 1], q.y, acc[1]);
      acc[2] = fmaf(-wrow[c + 2], q.z, acc[2]);
      acc[3] = fmaf(-wrow[c + 3], q.w, acc[3]);
    }
    for (; c < C; ++c) acc[0] = fmaf(-wrow[c], u[c], acc[0]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int kRowsMax, bool kMatvec, int kRing, bool kSmallC,
          bool kKRing = true>
__device__ __forceinline__ void bwd_sweep(const BwdArgs& a) {
  static_assert(kRing >= 3, "step g+1 fetched before step g ends");
  constexpr int kPW = kMatvec ? product_warps(kRowsMax) : 0;
  constexpr int kSW = sweep_warps(kRowsMax);
  const int S = a.S, nz = a.nz, nnz = a.nnz, C = a.C;
  const bool vec = a.vec;
  const StageLayout lay(kMatvec, kKRing, nz, nnz, C);
  const int nz4 = round4(nz), us = uslot(C);

  extern __shared__ __align__(16) float smem[];
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(smem);  // [kRing]
  // The ring starts 16-byte aligned after the mbarriers.
  float* ring = smem + round4(2 * kRing);           // [kRing][lay.slot]
  float* pbuf = ring + kRing * lay.slot;            // [kPSlots][nz4]
  float* ubuf = pbuf + kPSlots * nz4;               // [kPSlots][us]
  int* uc = reinterpret_cast<int*>(ubuf + kPSlots * us);  // [C]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int i = tid - 32 * kPW;  // row of a sweep thread
  const bool sweeper = warp >= kPW && warp < kPW + kSW && i < nz;
  const bool fetcher = warp == kPW + kSW;
  const int nsteps = kMatvec ? S + 1 : S;
  const size_t vsz = static_cast<size_t>(S) * nz;
  const float* Wb = a.Wc + static_cast<size_t>(b) * (S - 1) * nz * C;
  const float* yb = a.y + b * vsz;

  // The data of step g into buffer g % kRing (run by the fetching warp;
  // one cp.async group per call, empty past the last step).
  auto fetch = [&](int g) {
    if (g < nsteps) {
      const int s = S - 1 - g;
      float* dst = ring + ring_at<kRing>(g) * lay.slot;
      const bool has_w = g >= 1 && s >= 0;  // Wc_s (and ev_s)
      const bool has_y = s >= 0;
      const bool has_k = kMatvec && kKRing && g >= 1;  // K_{s+1}
      const int sw = has_y ? s : 0;          // s, kept in range
      const float* wsrc = Wb + static_cast<size_t>(sw) * nz * C;
      const float* ysrc = yb + static_cast<size_t>(sw) * nz;
      const float* ksrc = nullptr;
      if constexpr (kMatvec)
        ksrc = a.K + (b * vsz + static_cast<size_t>(s + 1) * nz) * nz;
      if (vec) {
        if (lane == 0) {
          unsigned long long* bar = mbar + ring_at<kRing>(g);
          mbar_expect_tx(bar, 4u * ((has_w ? nz * C : 0) + (has_y ? nz : 0) +
                                    (has_k ? nz * nz : 0)));
          if (has_w) bulk_copy(dst + lay.wc, wsrc, 4u * nz * C, bar);
          if (has_y) bulk_copy(dst + lay.y, ysrc, 4u * nz, bar);
          if (has_k) bulk_copy(dst + lay.k, ksrc, 4u * nz * nz, bar);
        }
      } else {
        if (has_w)
          for (int e = lane; e < nz * C; e += 32)
            cp_async4(dst + lay.wc + e, wsrc + e);
        if (has_y)
          for (int e = lane; e < nz; e += 32)
            cp_async4(dst + lay.y + e, ysrc + e);
        if (has_k)
          for (int e = lane; e < nz * nz; e += 32)
            cp_async4(dst + lay.k + e, ksrc + e);
      }
      if constexpr (kMatvec) {
        // ev_s (E'_s of the row t = s+1) and ev_{s+1} (E_{s+1}; g >= 2).
        const float* evb = a.ev + static_cast<size_t>(b) * (S - 1) * nnz;
        for (int e = lane; e < nnz; e += 32) {
          if (has_w) cp_async4(dst + lay.ev + e, evb + sw * nnz + e);
          if (g >= 2)
            cp_async4(dst + lay.ev + nnz + e, evb + (s + 1) * nnz + e);
        }
      }
    }
    cp_async_commit();
  };

  load_ints(uc, a.ucols, C);
  if (tid == 0) {
    for (int r = 0; r < kRing; ++r) mbar_init(mbar + r, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (fetcher) {
    for (int g = 0; g < kRing - 1; ++g) fetch(g);
    cp_async_wait<kRing - 2>();  // step 0
    if (vec) mbar_wait(mbar, 0);
  }

  // Per-thread constants.  Sweep: the row's Wc offset and its position
  // in ucols (-1 if none).
  const int wofs = lay.wc + i * C;
  int myc = -1;
  if (sweeper)
    for (int c = 0; c < C; ++c)
      if (uc[c] == i) myc = c;
  float* prow = a.p + b * vsz + static_cast<size_t>(S - 1) * nz + i;
  // Product: lane = 16 quad + 8 h + 2 rr + par holds row 8 warp + 4 quad
  // + rr and reads its chunks l, l+4, ... with l = 2 h + par (the lanes
  // of a 128-bit shared-memory phase fall on distinct banks at nz = 56).
  // Lane l = 2 walks the row's list by row (E_t p_{t+1}), l = 3 its list
  // by column (E'_s p_s), the lanes with the fewest chunks.
  const int row = warp * 8 + (lane >> 4) * 4 + ((lane >> 1) & 3);
  const int l = ((lane >> 3) & 1) * 2 + (lane & 1);
  // Its entries j, with cols[j] (by row) or rows[j] (by column).
  const bool pwarp = kMatvec && warp < kPW;  // warp-uniform
  const bool by_row = l == 2;
  const int* ent = by_row ? a.rent : a.cent;
  const int* other = by_row ? a.cols : a.rows;
  int e0 = 0, elen = 0, eend = 0;
  if (pwarp && row < nz && l >= 2) {
    const int* start = by_row ? a.rstart : a.cstart;
    e0 = start[row];
    eend = start[row + 1];
    elen = min(eend - e0, kEregs);
  }
  int2 ereg[kEregs];
#pragma unroll
  for (int k = 0; k < kEregs; ++k) {
    const int j = k < elen ? ent[e0 + k] : 0;
    ereg[k] = make_int2(j, k < elen ? other[j] : 0);
  }
  float* aprow = kMatvec ? a.Ap + b * vsz + row : nullptr;
  __syncthreads();

  for (int g = 0; g < nsteps; ++g) {
    const int s = S - 1 - g;
    const float* st = ring + ring_at<kRing>(g) * lay.slot;
    if (sweeper && s >= 0) {
      float v = st[lay.y + i];
      if (g > 0)
        v = sweep_row<kSmallC>(st + wofs,
                               ubuf + ((s + 1) & (kPSlots - 1)) * us, C, v);
      if (kMatvec) pbuf[(s & (kPSlots - 1)) * nz4 + i] = v;
      if (myc >= 0) ubuf[(s & (kPSlots - 1)) * us + myc] = v;
      *prow = v;
      prow -= nz;
    }
    if (fetcher && g + 1 < nsteps) {
      // Step g+1 has landed: the barrier publishes it to every warp.
      cp_async_wait<kRing - 3>();
      const int h = g + 1;
      if (vec) mbar_wait(mbar + ring_at<kRing>(h), (h / kRing) & 1);
    }
    // p_s is published; every thread is done with step g-1's buffer,
    // which the next fetch refills.
    __syncthreads();
    if (fetcher) fetch(g + kRing - 1);

    if (pwarp && g >= 1) {
      const int t = s + 1;
      float acc0 = 0.0f, acc1 = 0.0f;
      if (row < nz) {
        const float* Krow =
            kKRing ? st + lay.k + row * nz
                   : a.K + (b * vsz + static_cast<size_t>(t) * nz + row) * nz;
        const float* pt = pbuf + (t & (kPSlots - 1)) * nz4;
        if (vec) {
          // Chunks l, l+4, ...: every load of a batch of four first,
          // then its FMAs (one batch for kRowsMax = 64; two halve the
          // registers of the wide instantiation).
          constexpr int kBatch = 4;
          const int nch = nz >> 2;
          const float4* K4 = reinterpret_cast<const float4*>(Krow);
          const float4* p4 = reinterpret_cast<const float4*>(pt);
#pragma unroll
          for (int k0 = 0; k0 < kRowsMax / 16; k0 += kBatch) {
            float4 kq[kBatch], pq[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
              if (l + 4 * (k0 + k) < nch) {
                kq[k] = K4[l + 4 * (k0 + k)];
                pq[k] = p4[l + 4 * (k0 + k)];
              }
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
              if (l + 4 * (k0 + k) < nch) {
                acc0 = fmaf(kq[k].x, pq[k].x, fmaf(kq[k].y, pq[k].y, acc0));
                acc1 = fmaf(kq[k].z, pq[k].z, fmaf(kq[k].w, pq[k].w, acc1));
              }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kRowsMax / 4; ++k)
            if (l + 4 * k < nz)
              acc0 = fmaf(Krow[l + 4 * k], pt[l + 4 * k], acc0);
        }
        // The coupling terms: E_t p_{t+1} (by row, g >= 2) or E'_s p_s
        // (by column, s >= 0).
        if (l >= 2 && (by_row ? g >= 2 : s >= 0)) {
          const float* evp = st + lay.ev + (by_row ? nnz : 0);
          const float* pp =
              pbuf + ((by_row ? t + 1 : s) & (kPSlots - 1)) * nz4;
#pragma unroll
          for (int k = 0; k < kEregs; ++k)
            if (k < elen) acc1 = fmaf(evp[ereg[k].x], pp[ereg[k].y], acc1);
          for (int e = e0 + kEregs; e < eend; ++e) {
            const int j = ent[e];
            acc1 = fmaf(evp[j], pp[other[j]], acc1);
          }
        }
      }
      float acc = acc0 + acc1;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 8);
      if (row < nz && l == 0) aprow[static_cast<size_t>(t) * nz] = acc;
    }
  }
}

// Launch bwd_sweep through `kernel`, its __global__ instance.
template <int kRowsMax, bool kMatvec, int kRing, bool kKRing = true,
          typename Kernel>
inline int launch_bwd(Kernel kernel, const BwdArgs& a, int B,
                      void* stream) {
  const size_t smem = bwd_smem<kMatvec, kRing, kKRing>(a);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, bwd_threads(kRowsMax, kMatvec), smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
