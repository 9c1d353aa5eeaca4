// Register-resident Gauss-Jordan inverse of one nz x nz stage block,
// shared by factor_se.cu and factor_dense.cu.
//
// Four threads per column (4 nz <= 256 threads per block): thread
// (j, g), j = tid >> 2, g = tid & 3, holds rows 16g .. 16g+15 of column
// j in registers for the whole elimination; its cells are fixed once,
// by shifts.
//
// - Implicit pivoting: rows never move.  Step p pivots on r_p, the
//   unused row with the largest |a[r, p]|, and updates in place with
//   h = a[r_p, :] / a[r_p, p], h_p = 1 / a[r_p, p]: every row i other
//   than r_p becomes a[i, :] - a[i, p] h, column p replaced by e_{r_p}
//   first.  Row r_p itself keeps its values and its scaling 1 / a[r_p,
//   p] is deferred (later updates are linear in the row, so they apply
//   to the unscaled row alike), which makes every cell's update one
//   FMA with no select.  At the end Sinv[p, r_q] = a[r_p, q] / a[r_p,
//   p]: gj_stage applies the permutation and the scaling as it stages
//   the inverse in shared memory.
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
//
// Rows past nz take no part: they are never keyed as pivots, and their
// cells only ever receive updates from the rows below nz.
#pragma once

#include "common.cuh"

constexpr int kNzMax = 64;               // largest nz the kernels take
constexpr int kGroups = 4;               // threads per column
constexpr int kRows = kNzMax / kGroups;  // rows held by each thread
constexpr int kCbStride = 20;            // floats between row groups
constexpr int kCbSlot = kGroups * kCbStride;
constexpr int kColsPerWarp = 32 / kGroups;
static_assert(kRows == 16, "row group = r >> 4; pick16");

// The elimination's state in shared memory.  colbuf holds 2 kCbSlot
// floats, zeroed once by the kernel; the other three kNzMax entries.
struct GjPivots {
  float* colbuf;  // [2][kCbSlot] published column, double-buffered
  float* pinv;    // 1 / pivot of step p
  int* prow;      // r_p
  int* pof;       // step at which row i pivoted
};

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
__device__ __forceinline__ void publish_column(const float (&a)[kRows],
                                               int p, int j, int g,
                                               unsigned freem,
                                               const GjPivots& pv) {
  const bool mine = j == p;
  float4* cb = reinterpret_cast<float4*>(pv.colbuf + (p & 1) * kCbSlot +
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
    pv.prow[p] = rmine;
    pv.pof[rmine] = p;
    pv.pinv[p] = dmine;
  }
}

// Eliminates the block that every thread of the block holds in `a`
// (thread (j, g) as above; threads with j >= nz take part in the
// barriers and shuffles only).  The caller's last barrier must follow
// its last read of the pivot state of an earlier call.  Ends with the
// pivots of every step published and visible to all threads, and no
// barrier after the last step.
__device__ __forceinline__ void gj_eliminate(float (&a)[kRows], int nz,
                                             int j, int g,
                                             const GjPivots& pv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Rows of this thread that exist and have not pivoted yet.
  const int nrows = nz - g * kRows;
  unsigned freem = nrows >= kRows ? 0xFFFFu
                   : nrows > 0    ? (1u << nrows) - 1u
                                  : 0u;
  if (warp == 0) publish_column(a, 0, j, g, freem, pv);
  __syncthreads();

  for (int p = 0; p < nz; ++p) {
    const int r = pv.prow[p];
    const float d = pv.pinv[p];
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
        pv.colbuf + (p & 1) * kCbSlot + g * kCbStride);
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
        publish_column(a, p + 1, j, g, freem, pv);
      __syncthreads();
    }
  }
}

// Stages the inverse after gj_eliminate: Sinv[p, r_q] = a[r_p, q] / a_p,
// with the pivot row's deferred scaling 1 / a_p = pinv[p], into dst
// (row stride ld) and, if dstT is not null, its transpose into dstT
// (row stride ld).  No barrier; the caller publishes the stores.
__device__ __forceinline__ void gj_stage(const float (&a)[kRows], int nz,
                                         int j, int g, const GjPivots& pv,
                                         float* dst, int ld, float* dstT) {
  if (j >= nz) return;
  const int col = pv.prow[j];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = g * kRows + q;
    if (i < nz) {
      const int pi = pv.pof[i];
      const float v = a[q] * pv.pinv[pi];
      dst[pi * ld + col] = v;
      if (dstT != nullptr) dstT[col * ld + pi] = v;
    }
  }
}
