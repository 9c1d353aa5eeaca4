// Register-resident Gauss-Jordan inverse of one nz x nz stage block,
// shared by factor_se.cu and factor_dense.cu.
//
// Four threads per column (4 nz threads per block): thread (j, g),
// j = tid >> 2, g = tid & 3, holds rows kRows g .. kRows g + kRows - 1
// of column j in registers ("in columns"); its cells are fixed once, by
// shifts.  Warp w holds columns 8 w .. 8 w + 7: panel w.
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
// - Panels of eight pivots, one block barrier each: a stage takes
//   ceil(nz / 8) block barriers (7 at nz = 56, 9 at nz = 72) where one
//   barrier a pivot took nz.  The warp that holds a panel eliminates
//   its eight pivots alone, with warp synchronisation only, and
//   publishes each pivot's column (0 at r_p), r_p and 1 / a[r_p, p] in
//   shared memory; after the panel's barrier every other warp applies
//   the eight pivots to its cells, in pivot order.
// - In rows.  A panel's warp works on it transposed: thread `lane`
//   holds rows lane kR .. lane kR + kR - 1 (kR = kRows / 8) of the
//   panel's eight columns.  Keying column p is then kR rows a thread
//   and one warp reduction; the pivot row's thread hands the warp that
//   row and the reciprocal by shuffles; and each thread's update is
//   kR rows of eight FMAs whose column factor it already holds.  (In
//   columns, four threads key a column of 4 kRows rows while 28 idle,
//   and the pivot row's value comes from a select tree over kRows
//   registers: clock stamps of block 0 at B = 128, nz = 56 put the
//   one-barrier-a-pivot elimination at about 950 cycles a pivot, of
//   which the barrier about 100, and the same panels in columns at
//   about 630; in rows a pivot takes about 190-300.)  Warp w goes into
//   rows once it has applied panel w - 2, applies panel w - 1 in rows
//   right after that panel's barrier and eliminates its own panel at
//   once, then comes back into columns while the others apply panel w.  A
//   transposition goes through pbuf (one half into rows, one back),
//   padded so that at most two threads meet on a bank.
// - The arithmetic is the one-barrier-a-pivot elimination's, bit for
//   bit: every cell (i, j) receives, pivot by pivot in order,
//   a[i, j] = fmaf(-c_p[i], a[r_p, j] * d_p, a[i, j]) (column p:
//   fmaf(-c_p[i], d_p, e_{r_p}[i])), with c_p column p after the
//   earlier pivots (0 at r_p), a[r_p, j] the pivot row's value after
//   them and d_p = recip(a[r_p, p]), the product a[r_p, j] * d_p formed
//   in single precision wherever it is formed; the pivots are chosen by
//   the same keys (|a| with the low 7 mantissa bits dropped, packed
//   with 127 - row, so ties go to the smaller row).  Only the order in
//   which different cells are updated, and the threads that hold them,
//   change.
// - Published columns: two sets of eight slots (panels alternate), each
//   read as float4 with kRows + 4 floats between row groups, so the four
//   row groups of a warp fall on distinct banks.
//
// Rows past nz take no part: they are never keyed as pivots, and their
// cells only ever receive updates from the rows below nz.  A last panel
// of nz % 8 columns takes that many pivots.
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
// Floats of the published columns: two sets of kColsPerWarp slots.
template <int kRows>
__host__ __device__ constexpr int gj_cb_floats() {
  return 2 * kColsPerWarp * gj_cb_slot<kRows>();
}
template <int kRows>
__host__ __device__ constexpr int gj_shift() {  // row group: r >> shift
  static_assert(kRows == 16 || kRows == 32, "16 or 32 rows a thread");
  return kRows == 16 ? 4 : 5;
}

// A panel in rows: thread `lane` of the panel's warp holds rows
// lane kR .. lane kR + kR - 1 (kR = kRows / 8) of the warp's
// kColsPerWarp columns (all 4 kRows rows over the warp's 32 threads).
template <int kRows>
__host__ __device__ constexpr int gj_panel_rows() {
  return kRows / kColsPerWarp;
}
// The panel's transposition buffer: 4 kRows rows of kColsPerWarp floats
// and one of padding, and 5 floats more after each row group, so that
// no access to it meets more than two threads on one bank.
constexpr int kPbStride = kColsPerWarp + 1;
template <int kRows>
__host__ __device__ constexpr int gj_pbuf_group() {
  return kRows * kPbStride + 5;
}
template <int kRows>
__host__ __device__ constexpr int gj_pbuf_floats() {  // two halves
  return 2 * kGroups * gj_pbuf_group<kRows>();
}

// The elimination's state in shared memory.  colbuf holds
// gj_cb_floats floats, zeroed once by the kernel, pbuf gj_pbuf_floats;
// the other three gj_nz_max entries.
struct GjPivots {
  float* colbuf;  // [2][kColsPerWarp][gj_cb_slot] published columns
  float* pbuf;    // [2][4][gj_pbuf_group] panels between their layouts
  float* pinv;    // 1 / pivot of step p
  int* prow;      // r_p
  int* pof;       // step at which row i pivoted
};

// Step p's published column (the slots of alternate panels alternate).
template <int kRows>
__device__ __forceinline__ float* gj_column(const GjPivots& pv, int p) {
  return pv.colbuf + (p & (2 * kColsPerWarp - 1)) * gj_cb_slot<kRows>();
}

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

// 1 / x to within an ulp or so for normal x: the hardware's approximate
// reciprocal and one Newton step, inline (no call to a slow path).
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// a[i, j] = fmaf(-c[i], h, a[i, j]) for this thread's rows, c being
// its row group of the published column `col`.
template <int kRows>
__device__ __forceinline__ void gj_fma(float (&a)[kRows], const float* col,
                                       int g, float h) {
  const float4* cb =
      reinterpret_cast<const float4*>(col + g * gj_cb_stride<kRows>());
#pragma unroll
  for (int m = 0; m < kRows / 4; ++m) {
    const float4 c4 = cb[m];
    a[4 * m] = fmaf(-c4.x, h, a[4 * m]);
    a[4 * m + 1] = fmaf(-c4.y, h, a[4 * m + 1]);
    a[4 * m + 2] = fmaf(-c4.z, h, a[4 * m + 2]);
    a[4 * m + 3] = fmaf(-c4.w, h, a[4 * m + 3]);
  }
}

// Pivot row r leaves this thread's unused rows.
template <int kRows>
__device__ __forceinline__ void gj_take_row(unsigned& freem, int r, int g) {
  if (g == r >> gj_shift<kRows>()) freem &= ~(1u << (r & (kRows - 1)));
}

// The published pivots p0 .. p0 + np - 1 of a panel applied, in order,
// to the cells of a warp that holds none of its columns: each a[r_p, j]
// comes by a shuffle from the thread of column j that holds row r_p,
// after the previous pivot (kFull: np is kColsPerWarp).
template <int kRows, bool kFull>
__device__ __forceinline__ void gj_apply_panel_n(float (&a)[kRows], int p0,
                                                 int np, int g, int lane,
                                                 unsigned& freem,
                                                 const GjPivots& pv) {
#pragma unroll
  for (int t = 0; t < kColsPerWarp; ++t) {
    if (kFull || t < np) {
      const int r = pv.prow[p0 + t];
      gj_take_row<kRows>(freem, r, g);
      const float v =
          __shfl_sync(0xffffffffu, pick(a, r & (kRows - 1)),
                      (lane & ~(kGroups - 1)) | (r >> gj_shift<kRows>()));
      gj_fma(a, gj_column<kRows>(pv, p0 + t), g, v * pv.pinv[p0 + t]);
    }
  }
}

// Where the first of thread `lane`'s panel rows starts in a half of
// pbuf.
template <int kRows>
__device__ __forceinline__ int gj_pbuf_offset(int lane) {
  const int i0 = lane * gj_panel_rows<kRows>();
  return (i0 >> gj_shift<kRows>()) * gj_pbuf_group<kRows>() +
         (i0 & (kRows - 1)) * kPbStride;
}

// The warp's panel from columns into rows, in place: thread (j, g) holds
// rows kRows g .. kRows g + kRows - 1 of column j in a[q], and after it
// rows lane kR + s of the panel's column c (column 8 w + c of
// the block) in a[s kColsPerWarp + c].  `buf` is a half of pbuf.
template <int kRows>
__device__ __forceinline__ void gj_to_rows(float (&a)[kRows], int g,
                                           int lane, float* buf) {
  float* mine = buf + g * gj_pbuf_group<kRows>() + (lane >> 2);
#pragma unroll
  for (int q = 0; q < kRows; ++q) mine[q * kPbStride] = a[q];
  __syncwarp();
  const float* rows = buf + gj_pbuf_offset<kRows>(lane);
#pragma unroll
  for (int s = 0; s < gj_panel_rows<kRows>(); ++s)
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
      a[s * kColsPerWarp + c] = rows[s * kPbStride + c];
  __syncwarp();
}

// The inverse of gj_to_rows.
template <int kRows>
__device__ __forceinline__ void gj_from_rows(float (&a)[kRows], int g,
                                             int lane, float* buf) {
  float* rows = buf + gj_pbuf_offset<kRows>(lane);
#pragma unroll
  for (int s = 0; s < gj_panel_rows<kRows>(); ++s)
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
      rows[s * kPbStride + c] = a[s * kColsPerWarp + c];
  __syncwarp();
  const float* mine = buf + g * gj_pbuf_group<kRows>() + (lane >> 2);
#pragma unroll
  for (int q = 0; q < kRows; ++q) a[q] = mine[q * kPbStride];
  __syncwarp();
}

// In rows: the cell of the thread's row sr (run-time) in column c.
template <int kRows>
__device__ __forceinline__ float gj_pick_row(const float (&a)[kRows], int sr,
                                             int c) {
  constexpr int kR = gj_panel_rows<kRows>();
  if constexpr (kR == 2) {
    return sr ? a[kColsPerWarp + c] : a[c];
  } else {
    static_assert(kR == 4, "2 or 4 rows a thread in a panel");
    const float lo = (sr & 1) ? a[kColsPerWarp + c] : a[c];
    const float hi =
        (sr & 1) ? a[3 * kColsPerWarp + c] : a[2 * kColsPerWarp + c];
    return (sr & 2) ? hi : lo;
  }
}

// Where thread `lane`'s panel rows lie in a published column.
template <int kRows>
__device__ __forceinline__ int gj_rows_offset(int lane) {
  const int i0 = lane * gj_panel_rows<kRows>();
  return (i0 >> gj_shift<kRows>()) * gj_cb_stride<kRows>() +
         (i0 & (kRows - 1));
}

// kR consecutive floats at p (4 kR-byte aligned) in one access.
template <int kR>
__device__ __forceinline__ void gj_load(float (&v)[kR], const float* p) {
  if constexpr (kR == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
}
template <int kR>
__device__ __forceinline__ void gj_store(float* p, const float (&v)[kR]) {
  if constexpr (kR == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Panel pivots p0 .. p0 + np - 1 applied, in order, to the next panel,
// held in rows: a[r_p, c] comes by a shuffle from the thread that holds
// row r_p, after the previous pivot (kFull: np is kColsPerWarp).
template <int kRows, bool kFull>
__device__ __forceinline__ void gj_rows_apply_n(float (&a)[kRows], int p0,
                                                int np, int g, int lane,
                                                unsigned& freem,
                                                const GjPivots& pv) {
  constexpr int kR = gj_panel_rows<kRows>();
  const int off = gj_rows_offset<kRows>(lane);
#pragma unroll
  for (int t = 0; t < kColsPerWarp; ++t) {
    if (!kFull && t == np) break;
    const int r = pv.prow[p0 + t];
    const float d = pv.pinv[p0 + t];
    gj_take_row<kRows>(freem, r, g);
    float c[kR];
    gj_load(c, gj_column<kRows>(pv, p0 + t) + off);
    float h[kColsPerWarp];
#pragma unroll
    for (int c2 = 0; c2 < kColsPerWarp; ++c2)
      h[c2] = __shfl_sync(0xffffffffu, gj_pick_row(a, r & (kR - 1), c2) * d,
                          r / kR);
#pragma unroll
    for (int s = 0; s < kR; ++s)
#pragma unroll
      for (int c2 = 0; c2 < kColsPerWarp; ++c2)
        a[s * kColsPerWarp + c2] =
            fmaf(-c[s], h[c2], a[s * kColsPerWarp + c2]);
  }
}

// Panel pivots p0 .. p0 + np - 1 (column p of the panel: t = p - p0),
// run in rows by the warp that holds their columns, with warp
// synchronisation only.  For pivot p every thread keys its unused rows
// of column t; one warp reduction picks the pivot row r, and meanwhile
// every thread forms the reciprocal of its best row's value in column t.
// The thread that holds r hands that reciprocal d and its row to the
// warp by shuffles, and each thread forms the multipliers a[r, c] d
// (d for c = t).  Each thread then
// publishes its cells of column t (0 at r) and updates its cells (kFull:
// np is kColsPerWarp).
template <int kRows, bool kFull>
__device__ __forceinline__ void gj_rows_panel_n(float (&a)[kRows], int p0,
                                                int np, int g, int lane,
                                                unsigned& freem,
                                                const GjPivots& pv) {
  constexpr int kR = gj_panel_rows<kRows>();
  const int i0 = lane * kR;
  const int off = gj_rows_offset<kRows>(lane);
  // This thread's rows that exist and have not pivoted, from the
  // threads of their row group (thread (0, g) is lane g).
  unsigned rf = (__shfl_sync(0xffffffffu, freem, i0 >> gj_shift<kRows>()) >>
                 (i0 & (kRows - 1))) &
                ((1u << kR) - 1u);
#pragma unroll
  for (int t = 0; t < kColsPerWarp; ++t) {
    if (!kFull && t == np) break;
    const int p = p0 + t;
    unsigned kmine = 0u;
#pragma unroll
    for (int s = 0; s < kR; ++s) {
      const unsigned k =
          (__float_as_uint(a[s * kColsPerWarp + t]) & 0x7FFFFF80u) |
          static_cast<unsigned>(127 - i0 - s);
      kmine = max(kmine, ((rf >> s) & 1u) ? k : 0u);
    }
    const unsigned kmax = __reduce_max_sync(0xffffffffu, kmine);
    // While the reduction runs: this thread's best row and the
    // reciprocal of its value in column t.
    const int sm = (127 - static_cast<int>(kmine & 127u) - i0) & (kR - 1);
    const float dm = recip(gj_pick_row(a, sm, t));
    const int r = 127 - static_cast<int>(kmax & 127u);
    const int owner = r / kR;
    float h[kColsPerWarp];
    h[t] = __shfl_sync(0xffffffffu, dm, owner);
#pragma unroll
    for (int c2 = 0; c2 < kColsPerWarp; ++c2)
      if (c2 != t)
        h[c2] = __shfl_sync(0xffffffffu, gj_pick_row(a, sm, c2), owner) *
                h[t];
    // Column p as the other warps apply it: 0 at the pivot row, so the
    // update leaves that row as it is.
    float c[kR];
#pragma unroll
    for (int s = 0; s < kR; ++s)
      c[s] = i0 + s == r ? 0.0f : a[s * kColsPerWarp + t];
    gj_store(gj_column<kRows>(pv, p) + off, c);
    // Every thread stores the same r and reciprocal.
    pv.prow[p] = r;
    pv.pof[r] = p;
    pv.pinv[p] = h[t];
    if (i0 == (r & ~(kR - 1))) rf &= ~(1u << (r & (kR - 1)));
    gj_take_row<kRows>(freem, r, g);
#pragma unroll
    for (int s = 0; s < kR; ++s) {
      float* as = a + s * kColsPerWarp;
      // Column p becomes e_r (in the stored scaling) before the update.
      as[t] = fmaf(-c[s], h[t], i0 + s == r ? 1.0f : 0.0f);
#pragma unroll
      for (int c2 = 0; c2 < kColsPerWarp; ++c2)
        if (c2 != t) as[c2] = fmaf(-c[s], h[c2], as[c2]);
    }
  }
}

// The three panel steps with np known at compile time for a whole
// panel, so that nothing bars their pivots' loads from moving ahead.
template <int kRows>
__device__ __forceinline__ void gj_apply_panel(float (&a)[kRows], int p0,
                                               int np, int g, int lane,
                                               unsigned& freem,
                                               const GjPivots& pv) {
  if (np == kColsPerWarp)
    gj_apply_panel_n<kRows, true>(a, p0, np, g, lane, freem, pv);
  else
    gj_apply_panel_n<kRows, false>(a, p0, np, g, lane, freem, pv);
}
template <int kRows>
__device__ __forceinline__ void gj_rows_apply(float (&a)[kRows], int p0,
                                              int np, int g, int lane,
                                              unsigned& freem,
                                              const GjPivots& pv) {
  if (np == kColsPerWarp)
    gj_rows_apply_n<kRows, true>(a, p0, np, g, lane, freem, pv);
  else
    gj_rows_apply_n<kRows, false>(a, p0, np, g, lane, freem, pv);
}
template <int kRows>
__device__ __forceinline__ void gj_rows_panel(float (&a)[kRows], int p0,
                                              int np, int g, int lane,
                                              unsigned& freem,
                                              const GjPivots& pv) {
  if (np == kColsPerWarp)
    gj_rows_panel_n<kRows, true>(a, p0, np, g, lane, freem, pv);
  else
    gj_rows_panel_n<kRows, false>(a, p0, np, g, lane, freem, pv);
}

// Eliminates the block that every thread of the block holds in `a`
// (thread (j, g) as above; threads with j >= nz take part in the
// barriers and shuffles only).  The block has ceil(nz / 8) warps, warp w
// holding panel w.  Warp w goes into rows after it has applied panel
// w - 2, applies panel w - 1 and eliminates its own in rows, and comes
// back into columns while the others apply panel w; pbuf's first half
// takes the transpositions into rows (but warp 0's), the second those
// back.  The caller's last barrier must follow its last read of the
// pivot state of an earlier call.  Ends with the pivots of every step
// published and visible to all threads, every warp back in columns, and
// no barrier after the last panel.
template <int kRows>
__device__ __forceinline__ void gj_eliminate(float (&a)[kRows], int nz,
                                             int j, int g,
                                             const GjPivots& pv) {
  constexpr unsigned kAll = kRows == 16 ? 0xFFFFu : 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* const into_rows = pv.pbuf;
  float* const into_cols = pv.pbuf + kGroups * gj_pbuf_group<kRows>();
  // Rows of this thread that exist and have not pivoted yet.
  const int nrows = nz - g * kRows;
  unsigned freem = nrows >= kRows ? kAll
                   : nrows > 0    ? (1u << nrows) - 1u
                                  : 0u;
  if (warp == 0) {
    gj_to_rows(a, g, lane, into_cols);
    gj_rows_panel(a, 0, min(kColsPerWarp, nz), g, lane, freem, pv);
  } else if (warp == 1) {
    gj_to_rows(a, g, lane, into_rows);
  }
  for (int p0 = 0; p0 < nz; p0 += kColsPerWarp) {
    // Panel p0 / 8 published.
    __syncthreads();
    const int np = min(kColsPerWarp, nz - p0);
    const int panel = p0 / kColsPerWarp;
    if (warp == panel + 1) {
      gj_rows_apply(a, p0, np, g, lane, freem, pv);
      gj_rows_panel(a, p0 + kColsPerWarp,
                    min(kColsPerWarp, nz - p0 - kColsPerWarp), g, lane,
                    freem, pv);
    } else if (warp == panel) {
      gj_from_rows(a, g, lane, into_cols);
    } else {
      gj_apply_panel(a, p0, np, g, lane, freem, pv);
      if (warp == panel + 2) gj_to_rows(a, g, lane, into_rows);
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
