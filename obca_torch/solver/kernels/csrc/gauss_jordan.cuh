// Register-resident Gauss-Jordan inverse of one nz x nz stage block,
// shared by factor_se.cu and factor_dense.cu.
//
// Four threads per column (4 nz threads per block): thread (j, g),
// j = tid >> 2, g = tid & 3, holds rows kRows g .. kRows g + kRows - 1
// of column j in registers for the whole elimination; its cells are
// fixed once, by shifts.
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
// - The published column is read as float4 with kRows + 4 floats
//   between row groups, so the four row groups of a warp fall on
//   distinct banks.
//
// Rows past nz take no part: they are never keyed as pivots, and their
// cells only ever receive updates from the rows below nz.
//
// Two instantiations, by the rows each thread holds: kRows = 16 for nz
// <= 64 (256 threads at most) and kRows = 32 for 64 < nz <= 128 (512
// threads at most).  Row keys keep 7 bits for the row in both (rows <
// 128).
#pragma once

#include "common.cuh"

constexpr int kGroups = 4;               // threads per column
constexpr int kColsPerWarp = 32 / kGroups;

// The largest nz an instantiation takes, and its published column.
template <int kRows>
__host__ __device__ constexpr int gj_nz_max() {
  return kGroups * kRows;
}
template <int kRows>
__host__ __device__ constexpr int gj_cb_stride() {  // floats a row group
  return kRows + 4;
}
template <int kRows>
__host__ __device__ constexpr int gj_cb_slot() {
  return kGroups * gj_cb_stride<kRows>();
}
template <int kRows>
__host__ __device__ constexpr int gj_shift() {  // row group: r >> shift
  static_assert(kRows == 16 || kRows == 32, "16 or 32 rows a thread");
  return kRows == 16 ? 4 : 5;
}

// The elimination's state in shared memory.  colbuf holds 2
// gj_cb_slot floats, zeroed once by the kernel; the other three
// gj_nz_max entries.
struct GjPivots {
  float* colbuf;  // [2][gj_cb_slot] published column, double-buffered
  float* pinv;    // 1 / pivot of step p
  int* prow;      // r_p
  int* pof;       // step at which row i pivoted
};

// a[kOff + ql] (0 <= ql < 16) by a select tree of depth 4.
template <int kOff, int kRows>
__device__ __forceinline__ float pick16(const float (&a)[kRows], int ql) {
  const bool b0 = ql & 1, b1 = ql & 2, b2 = ql & 4, b3 = ql & 8;
  const float s0 = b0 ? a[kOff + 1] : a[kOff + 0];
  const float s1 = b0 ? a[kOff + 3] : a[kOff + 2];
  const float s2 = b0 ? a[kOff + 5] : a[kOff + 4];
  const float s3 = b0 ? a[kOff + 7] : a[kOff + 6];
  const float s4 = b0 ? a[kOff + 9] : a[kOff + 8];
  const float s5 = b0 ? a[kOff + 11] : a[kOff + 10];
  const float s6 = b0 ? a[kOff + 13] : a[kOff + 12];
  const float s7 = b0 ? a[kOff + 15] : a[kOff + 14];
  const float t0 = b1 ? s1 : s0, t1 = b1 ? s3 : s2;
  const float t2 = b1 ? s5 : s4, t3 = b1 ? s7 : s6;
  const float u0 = b2 ? t1 : t0, u1 = b2 ? t3 : t2;
  return b3 ? u1 : u0;
}

// a[ql] (0 <= ql < kRows): one tree of depth 4, or two and a select.
template <int kRows>
__device__ __forceinline__ float pick(const float (&a)[kRows], int ql) {
  if constexpr (kRows == 16) {
    return pick16<0>(a, ql);
  } else {
    return (ql & 16) ? pick16<16>(a, ql) : pick16<0>(a, ql);
  }
}

// The largest of kq[kOff .. kOff+15].  The tree is spelled out: as a
// loop over levels it was compiled to a round trip through local
// memory per level.
template <int kOff, int kRows>
__device__ __forceinline__ unsigned key_max16(const unsigned (&kq)[kRows]) {
  return max(max(max(max(kq[kOff + 0], kq[kOff + 1]),
                     max(kq[kOff + 2], kq[kOff + 3])),
                 max(max(kq[kOff + 4], kq[kOff + 5]),
                     max(kq[kOff + 6], kq[kOff + 7]))),
             max(max(max(kq[kOff + 8], kq[kOff + 9]),
                     max(kq[kOff + 10], kq[kOff + 11])),
                 max(max(kq[kOff + 12], kq[kOff + 13]),
                     max(kq[kOff + 14], kq[kOff + 15]))));
}

// 1 / x to within an ulp or so for normal x: the hardware's approximate
// reciprocal and one Newton step, inline (no call to a slow path).
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// Run by the whole warp that holds column p (a warp-uniform branch).
// `freem` has bit q set when row kRows g + q exists and has not
// pivoted.  The key of a row packs |a| (non-negative floats order as
// their bits; the low 7 mantissa bits dropped) with 127 - row, so ties
// go to the smaller row and an unused row keys above 0 (row 127 only
// when its |a| is below the dropped bits).  Every thread forms its best
// key and the reciprocal of that row's value; one warp reduction, to
// which only column p's threads contribute, picks the pivot, and the
// thread that holds it publishes its row and reciprocal.
template <int kRows>
__device__ __forceinline__ void publish_column(const float (&a)[kRows],
                                               int p, int j, int g,
                                               unsigned freem,
                                               const GjPivots& pv) {
  const bool mine = j == p;
  float4* cb = reinterpret_cast<float4*>(pv.colbuf +
                                         (p & 1) * gj_cb_slot<kRows>() +
                                         g * gj_cb_stride<kRows>());
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
  unsigned kmine;
  if constexpr (kRows == 16) {
    kmine = key_max16<0>(kq);
  } else {
    kmine = max(key_max16<0>(kq), key_max16<16>(kq));
  }
  const int rmine = 127 - static_cast<int>(kmine & 127u);
  const float dmine = recip(pick(a, rmine & (kRows - 1)));
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
template <int kRows>
__device__ __forceinline__ void gj_eliminate(float (&a)[kRows], int nz,
                                             int j, int g,
                                             const GjPivots& pv) {
  constexpr unsigned kAll = kRows == 16 ? 0xFFFFu : 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Rows of this thread that exist and have not pivoted yet.
  const int nrows = nz - g * kRows;
  unsigned freem = nrows >= kRows ? kAll
                   : nrows > 0    ? (1u << nrows) - 1u
                                  : 0u;
  if (warp == 0) publish_column(a, 0, j, g, freem, pv);
  __syncthreads();

  for (int p = 0; p < nz; ++p) {
    const int r = pv.prow[p];
    const float d = pv.pinv[p];
    const int gr = r >> gj_shift<kRows>();  // r / kRows
    if (g == gr) freem &= ~(1u << (r & (kRows - 1)));
    // a[r, j] from the thread of column j that holds row r.
    const float v = __shfl_sync(0xffffffffu, pick(a, r & (kRows - 1)),
                                (lane & ~(kGroups - 1)) | gr);
    const float gj = (j == p) ? d : v * d;
    if (j == p) {
      // Column p becomes e_r (in the stored scaling) before the update.
      const int myrl = (g == gr) ? (r & (kRows - 1)) : -1;
#pragma unroll
      for (int q = 0; q < kRows; ++q) a[q] = (q == myrl) ? 1.0f : 0.0f;
    }
    const float4* cb = reinterpret_cast<const float4*>(
        pv.colbuf + (p & 1) * gj_cb_slot<kRows>() +
        g * gj_cb_stride<kRows>());
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

// Sinv[p, r_q] = a[r_p, q] / a_p of row i = kRows g + q (with the pivot
// row's deferred scaling 1 / a_p = pinv[p]) for the rows i < nz this
// thread holds: f(pi, col, v) with pi = p of row i, col = r_j.
template <int kRows, typename Store>
__device__ __forceinline__ void gj_each(const float (&a)[kRows], int nz,
                                        int j, int g, const GjPivots& pv,
                                        Store f) {
  if (j >= nz) return;
  const int col = pv.prow[j];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = g * kRows + q;
    if (i < nz) {
      const int pi = pv.pof[i];
      f(pi, col, a[q] * pv.pinv[pi]);
    }
  }
}

// Stages the inverse after gj_eliminate into dst (row stride ld) and, if
// dstT is not null, its transpose into dstT (row stride ld).  No
// barrier; the caller publishes the stores.
template <int kRows>
__device__ __forceinline__ void gj_stage(const float (&a)[kRows], int nz,
                                         int j, int g, const GjPivots& pv,
                                         float* dst, int ld, float* dstT) {
  gj_each(a, nz, j, g, pv, [&](int pi, int col, float v) {
    dst[pi * ld + col] = v;
    if (dstT != nullptr) dstT[col * ld + pi] = v;
  });
}
