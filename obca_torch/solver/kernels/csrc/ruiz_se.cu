// ruiz_se: symmetric Ruiz equilibration of the block-tridiagonal KKT
// system with a sparse coupling block, (K, ev, rhs) -> (K_s, ev_s,
// rhs_s, d), once per IPM iteration.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses obca_tpu's _ruiz
// (obca_tpu/solver/ipm.py) into its own loops.  In PyTorch the same
// arithmetic took about 15 passes over K-sized tensors a call (|K|, a
// broadcast product and a row maximum in every sweep, two broadcast
// products at the end), the largest byte stream of an IPM turn.
//
// d starts at 1; each of `iters` sweeps computes the row norms
//   rn_i = max(max_j(|K_ij| d_j) d_i, coupling terms)
// of every stage, where entry j of coupling block s (between stages s
// and s+1) gives (|ev_sj| d_s[rows_j]) d_{s+1}[cols_j] to row rows_j of
// stage s and to row cols_j of stage s+1, then d_i <- d_i /
// sqrt(max(rn_i, 1e-10)).  Then K_s = (K_ij d_i) d_j, ev_s = (ev_j
// d_s[rows_j]) d_{s+1}[cols_j], rhs_s = rhs d.
//
// Same bits as the plain version (blocktri_se.ruiz_se_plain) on the
// card: every product, quotient and root is one IEEE-rounded operation
// in the plain version's order (__fmul_rn, __fdiv_rn, __fsqrt_rn and
// their double twins), and every max and the clamp carry NaN as
// torch.amax, scatter_reduce("amax") and torch.clamp do (fmax would
// drop it).  A maximum's value does not depend on the order it is taken
// in, so the rows' and the coupling terms' maxima may be taken in any.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, one read of K and one write
// of K_s, 2 K (B=128, S=81, nz=56: 260 MB, 0.078 ms; B=1024: 2.08 GB,
// 0.621 ms); about 3 nz^2 operations a stage a sweep are negligible.
//
// Design: one launch a sweep, since a sweep needs the neighbouring
// stages' d from the sweep before; the last sweep also writes K_s, and
// a small launch then writes ev_s (which needs two stages' final d) and
// rhs_s.  So K is read `iters` times and written once (4 K at iters =
// 3, against about 16.7 K for the PyTorch passes), and no K-sized
// temporary exists.  Bound by bytes, a sweep is paced by the bytes it
// keeps in flight and by how soon a block is done with a stage:
// - Each block takes up to kItems (lane, stage) items in turn through a
//   ring of two buffers in shared memory fed by cp.async (16 bytes
//   where the rows allow): an item's stage block, the three stages' d
//   and its two coupling blocks' values arrive while the item before it
//   computes.  Fewer items a block where the blocks would not fill the
//   card (B=1: one item a block).
// - Two lanes to a row (128 thread pairs, a row each): each takes
//   max_j |K_ij| d_j over half the row's 16-byte chunks, and half the
//   row's coupling terms (from the pattern's row and column lists, each
//   entry's partner index taken once a block); one shuffle joins the
//   halves, and the pair's first lane writes the row's new d.  The
//   maxima compare bit patterns as integers (max_bits), one instruction
//   each.
// - Every other sweep walks the items in reverse, so that its first
//   blocks read what the sweep before read last, which may still sit in
//   the 50 MB L2 cache.  d ping-pongs between the output and one scratch
//   array of [B, S, nz].
// Measured on an H100 (B=1024, S=81, nz=56, 3 sweeps): about 1.5 ms a call,
// a read-only sweep 0.378 ms (2.75 TB/s), the last sweep 0.731 ms (2.85
// TB/s).  One item a block with K in registers, eight lanes a row, took
// 2.11 ms: too few bytes in flight for how long a block held its stage.
// TMA bulk copies in place of cp.async gained 1%, a ring of three
// buffers lost (fewer blocks fit).
//
// float32 (the f32 route) and float64 (the mixed route's IPM); nz up to
// 128 (a ring of one buffer where two do not fit).  Rows whose bytes are
// not a whole number of 16-byte chunks, or unaligned arrays, take
// element-sized copies into rows padded to 16 bytes with zeros.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kGroup = 2;                     // lanes of a row
constexpr int kNzMax = 128;
static_assert(kThreads / kGroup >= kNzMax, "a row for every thread pair");
constexpr int kItems = 8;                     // items a block, at most
constexpr int kBlocksPerSm = 8;               // blocks an SM, to fill it
constexpr int kSmemMax = 232448;              // shared memory a block can use

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// One element copied from device memory into shared memory (cp.async).
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src) {
  const unsigned s = smem_u32(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// kV elements, read and written as one 16-byte access.
template <typename T>
struct alignas(16) Chunk {
  static constexpr int kV = 16 / sizeof(T);
  T v[kV];
};

template <typename T>
struct RuizArgs {
  const T* K;    // [B, S, nz, nz]
  const T* ev;   // [B, S-1, nnz]
  const T* rhs;  // [B, S, nz]
  const int* rows;
  const int* cols;
  const int* rstart;  // entries of row i: rent[rstart[i]:rstart[i+1]]
  const int* rent;
  const int* cstart;  // entries of column i: cent[cstart[i]:cstart[i+1]]
  const int* cent;
  int B, S, nz, nnz;
  bool vec;  // 16-byte copies of K and K_s
  T* K_s;
  T* ev_s;
  T* rhs_s;
};

// The larger of two values that are each >= +0 or a NaN with its sign
// bit clear (every term of a row norm: a product of |K_ij| or |ev_j|
// with d's, which start at 1 and only ever divide by roots), NaN if
// either is NaN: on such values the order of their bit patterns as
// integers is that of the numbers, with every NaN above +inf.
__device__ __forceinline__ float max_bits(float a, float b) {
  return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
}
__device__ __forceinline__ double max_bits(double a, double b) {
  return __longlong_as_double(
      max(__double_as_longlong(a), __double_as_longlong(b)));
}

// A ring buffer: the stage block in rows of ldk elements (nz rounded up
// to 16 bytes), the d of stages s-1, s, s+1 in rows of ldk, then the
// values of coupling blocks s-1 and s.  Padding holds zeros.
struct SlotLayout {
  int ldk, d_off, ev_off, size;  // in elements
  template <typename T>
  static __host__ __device__ SlotLayout of(int nz, int nnz) {
    constexpr int kV = 16 / sizeof(T);
    SlotLayout l;
    l.ldk = (nz + kV - 1) / kV * kV;
    l.d_off = nz * l.ldk;
    l.ev_off = l.d_off + 3 * l.ldk;
    l.size = l.ev_off + (2 * nnz + kV - 1) / kV * kV;
    return l;
  }
};

// Shared memory of a block: the ring, the last sweep's new d of the
// item's stage, the pattern's row and column lists with each entry's
// partner (the column of a row entry, the row of a column entry).
template <typename T>
static size_t ruiz_smem(int nz, int nnz, int ring) {
  return sizeof(T) * (static_cast<size_t>(ring) *
                          SlotLayout::of<T>(nz, nnz).size +
                      kNzMax) +
         sizeof(int) * (4 * nnz + 2 * (nz + 1));
}

// One sweep: d_new from d_old (nullptr: all ones); each block takes
// `per` items.  The last sweep also writes K_s.
template <typename T, int kRing, bool kLast>
__global__ void __launch_bounds__(kThreads)
    ruiz_sweep_kernel(RuizArgs<T> a, const T* __restrict__ d_old,
                      T* __restrict__ d_new, int per, bool reverse) {
  using C = Chunk<T>;
  constexpr int kV = C::kV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = a.nz, S = a.S, nnz = a.nnz;
  const SlotLayout L = SlotLayout::of<T>(nz, nnz);
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kRing][L.size]
  T* dn = ring + kRing * L.size;             // [kNzMax]
  int* rent = reinterpret_cast<int*>(dn + kNzMax);
  int* rpart = rent + nnz;
  int* cent = rpart + nnz;
  int* cpart = cent + nnz;
  int* rstart = cpart + nnz;      // [nz + 1]
  int* cstart = rstart + nz + 1;  // [nz + 1]
  const int tid = threadIdx.x;
  const int lane = tid % kGroup, i = tid / kGroup;  // the pair's row
  const int n_items = a.B * S, ncv = L.ldk / kV;

  // Item it of this block: a (lane, stage) index, or -1 past the end.
  auto item = [&](int it) {
    const int g = blockIdx.x * per + it;
    if (it >= per || g >= n_items) return -1;
    return reverse ? n_items - 1 - g : g;
  };
  // Copy item it into its buffer (one cp.async group, empty past the
  // end).
  auto fetch = [&](int it) {
    const int g = item(it);
    if (g >= 0) {
      T* slot = ring + (it % kRing) * L.size;
      const int s = g % S;
      const T* Kb = a.K + static_cast<size_t>(g) * nz * nz;
      if (a.vec) {
        for (int c = tid; c < nz * ncv; c += kThreads)
          cp_async16(slot + c * kV, Kb + c * kV);
      } else {
        for (int e = tid; e < nz * nz; e += kThreads) {
          const int r = e / nz;
          cp_async_elem(slot + r * L.ldk + (e - r * nz), Kb + e);
        }
      }
      if (d_old != nullptr) {
        // Stages max(s-1, 0)..min(s+1, S-1) of the item's lane.
        const T* db = d_old + (static_cast<long long>(g) - 1) * nz;
        const int e0 = s > 0 ? 0 : nz, e1 = s + 1 < S ? 3 * nz : 2 * nz;
        for (int e = e0 + tid; e < e1; e += kThreads) {
          const int w = e / nz;
          cp_async_elem(slot + L.d_off + w * L.ldk + (e - w * nz), db + e);
        }
      }
      const T* evb = a.ev + (static_cast<size_t>(g / S) * (S - 1) + s) * nnz;
      for (int e = tid; e < 2 * nnz; e += kThreads) {
        const int blk = e < nnz ? s - 1 : s;  // coupling block
        if (blk >= 0 && blk + 1 < S)
          cp_async_elem(slot + L.ev_off + e, evb + e - nnz);
      }
    }
    cp_async_commit();
  };

  // Zero the ring (its padding stays zero: |0| d = 0 adds nothing to a
  // row's maximum); in the first sweep every d is 1 and never copied.
  for (int e = tid; e < kRing * L.size; e += kThreads) {
    const int w = (e % L.size - L.d_off) / L.ldk;
    const int col = (e % L.size - L.d_off) - w * L.ldk;
    ring[e] = (d_old == nullptr && e % L.size >= L.d_off && w < 3 && col < nz)
                  ? T(1)
                  : T(0);
  }
  for (int e = tid; e < nnz; e += kThreads) {
    rent[e] = a.rent[e];
    rpart[e] = a.cols[a.rent[e]];
    cent[e] = a.cent[e];
    cpart[e] = a.rows[a.cent[e]];
  }
  for (int e = tid; e <= nz; e += kThreads) {
    rstart[e] = a.rstart[e];
    cstart[e] = a.cstart[e];
  }
  __syncthreads();
  for (int it = 0; it < kRing - 1; ++it) fetch(it);

  const T lo = static_cast<T>(1e-10);
  for (int it = 0; it < per; ++it) {
    fetch(it + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const int g = item(it);
    if (g < 0) break;  // uniform: the items past the end
    const T* slot = ring + (it % kRing) * L.size;
    const T* dm = slot + L.d_off;  // d of stages s-1, s, s+1 (rows of ldk)
    const T* evp = slot + L.ev_off;
    const int s = g % S;

    // mk = max_j |K_ij| d_j over the lane's chunks of row i, mc = the
    // row's coupling terms the lane takes; both are then joined over the
    // pair, and rn = max(mk d_i, mc).
    T mk = T(0), mc = T(0);
    if (i < nz) {
      for (int c = lane; c < ncv; c += kGroup) {
        const C k = *reinterpret_cast<const C*>(slot + i * L.ldk + c * kV);
        const C d = *reinterpret_cast<const C*>(dm + L.ldk + c * kV);
#pragma unroll
        for (int e = 0; e < kV; ++e)
          mk = max_bits(mk, mul_rn(abs_of(k.v[e]), d.v[e]));
      }
      const T di = dm[L.ldk + i];
      if (s + 1 < S)
        for (int q = rstart[i] + lane; q < rstart[i + 1]; q += kGroup)
          mc = max_bits(mc, mul_rn(mul_rn(abs_of(evp[nnz + rent[q]]), di),
                                   dm[2 * L.ldk + rpart[q]]));
      if (s > 0)
        for (int q = cstart[i] + lane; q < cstart[i + 1]; q += kGroup)
          mc = max_bits(mc, mul_rn(mul_rn(abs_of(evp[cent[q]]), dm[cpart[q]]),
                                   di));
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o /= 2) {
      mk = max_bits(mk, __shfl_xor_sync(0xffffffffu, mk, o));
      mc = max_bits(mc, __shfl_xor_sync(0xffffffffu, mc, o));
    }
    if (lane == 0 && i < nz) {
      const T di = dm[L.ldk + i];
      T r = max_bits(mul_rn(mk, di), mc);
      r = (isnan(r) || r >= lo) ? r : lo;
      const T d = div_rn(di, sqrt_rn(r));
      d_new[static_cast<size_t>(g) * nz + i] = d;
      if (kLast) dn[i] = d;
    }
    if (kLast) {
      __syncthreads();
      T* Ko = a.K_s + static_cast<size_t>(g) * nz * nz;
      if (a.vec) {
        for (int c = tid; c < nz * ncv; c += kThreads) {
          const int r = c / ncv, j = (c - r * ncv) * kV;
          C k = *reinterpret_cast<const C*>(slot + c * kV);
#pragma unroll
          for (int e = 0; e < kV; ++e)
            k.v[e] = mul_rn(mul_rn(k.v[e], dn[r]), dn[j + e]);
          *reinterpret_cast<C*>(Ko + c * kV) = k;
        }
      } else {
        for (int e = tid; e < nz * nz; e += kThreads) {
          const int r = e / nz, j = e - r * nz;
          Ko[e] = mul_rn(mul_rn(slot[r * L.ldk + j], dn[r]), dn[j]);
        }
      }
    }
    __syncthreads();  // the buffer and dn are free again
  }
  cp_async_wait<0>();
}

// ev_s and rhs_s from the final d, one thread an entry of either.
template <typename T>
__global__ void ruiz_ev_rhs_kernel(RuizArgs<T> a, const T* __restrict__ d,
                                   long long n_ev, long long n_rhs) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t < n_ev) {
    const long long bk = t / a.nnz;  // b (S-1) + k
    const int j = static_cast<int>(t - bk * a.nnz);
    const long long b = bk / (a.S - 1), k = bk - b * (a.S - 1);
    const T* dk = d + (b * a.S + k) * a.nz;
    a.ev_s[t] = mul_rn(mul_rn(a.ev[t], dk[a.rows[j]]), dk[a.nz + a.cols[j]]);
  } else if (t - n_ev < n_rhs) {
    a.rhs_s[t - n_ev] = mul_rn(a.rhs[t - n_ev], d[t - n_ev]);
  }
}

template <typename T, int kRing, bool kLast>
static cudaError_t launch_sweep(const RuizArgs<T>& a, const T* d_old,
                                T* d_new, bool reverse, int fill,
                                cudaStream_t stream) {
  const size_t smem = ruiz_smem<T>(a.nz, a.nnz, kRing);
  const cudaError_t err =
      allow_smem(ruiz_sweep_kernel<T, kRing, kLast>, smem);
  if (err != cudaSuccess) return err;
  // Items a block: up to kItems, fewer where the blocks would not fill
  // the card's `fill` block slots (MPC's single lane runs one item a
  // block).
  const int n_items = a.B * a.S;
  const int per = n_items / fill < 1 ? 1
                  : n_items / fill > kItems ? kItems : n_items / fill;
  ruiz_sweep_kernel<T, kRing, kLast>
      <<<(n_items + per - 1) / per, kThreads, smem, stream>>>(
          a, d_old, d_new, per, reverse);
  return cudaGetLastError();
}

template <typename T>
static int run_ruiz(const RuizArgs<T>& a, int iters, T* d, T* d_tmp,
                    cudaStream_t stream) {
  const bool ring2 = ruiz_smem<T>(a.nz, a.nnz, 2) <= kSmemMax;
  if (!ring2 && ruiz_smem<T>(a.nz, a.nnz, 1) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t qerr = cudaGetDevice(&dev);
  if (qerr == cudaSuccess)
    qerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (qerr != cudaSuccess) return static_cast<int>(qerr);
  const int fill = sms * kBlocksPerSm;
  const T* prev = nullptr;
  for (int it = 0; it < iters; ++it) {
    // The last sweep writes d itself, the one before it d_tmp, and so on.
    T* out = (iters - 1 - it) % 2 == 0 ? d : d_tmp;
    const bool last = it == iters - 1, reverse = it % 2 == 1;
    const cudaError_t err =
        ring2
            ? (last ? launch_sweep<T, 2, true>(a, prev, out, reverse, fill,
                                               stream)
                    : launch_sweep<T, 2, false>(a, prev, out, reverse, fill,
                                                stream))
            : (last ? launch_sweep<T, 1, true>(a, prev, out, reverse, fill,
                                               stream)
                    : launch_sweep<T, 1, false>(a, prev, out, reverse, fill,
                                                stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    prev = out;
  }
  const long long n_ev = static_cast<long long>(a.B) * (a.S - 1) * a.nnz;
  const long long n_rhs = static_cast<long long>(a.B) * a.S * a.nz;
  ruiz_ev_rhs_kernel<T>
      <<<static_cast<unsigned>((n_ev + n_rhs + 255) / 256), 256, 0,
         stream>>>(a, d, n_ev, n_rhs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ruiz_typed(const void* K, const void* ev, const void* rhs,
                      const int* rows, const int* cols, const int* rstart,
                      const int* rent, const int* cstart, const int* cent,
                      int B, int S, int nz, int nnz, int iters, void* K_s,
                      void* ev_s, void* rhs_s, void* d, void* d_tmp,
                      cudaStream_t stream) {
  const RuizArgs<T> a{
      static_cast<const T*>(K), static_cast<const T*>(ev),
      static_cast<const T*>(rhs), rows, cols, rstart, rent, cstart, cent,
      B, S, nz, nnz,
      // 16-byte copies need whole 16-byte rows and aligned blocks.
      (nz * sizeof(T)) % 16 == 0 && aligned16(K) && aligned16(K_s),
      static_cast<T*>(K_s), static_cast<T*>(ev_s), static_cast<T*>(rhs_s)};
  return run_ruiz<T>(a, iters, static_cast<T*>(d), static_cast<T*>(d_tmp),
                     stream);
}

// elem_bytes 4: float32 arrays; 8: float64.
OBCA_EXPORT int obca_ruiz_se(const void* K, const void* ev, const void* rhs,
                             const int* rows, const int* cols,
                             const int* rstart, const int* rent,
                             const int* cstart, const int* cent, int B, int S,
                             int nz, int nnz, int iters, int elem_bytes,
                             void* K_s, void* ev_s, void* rhs_s, void* d,
                             void* d_tmp, void* stream) {
  if (nz < 1 || nz > kNzMax || B < 1 || S < 1 || nnz < 0 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return ruiz_typed<float>(K, ev, rhs, rows, cols, rstart, rent, cstart,
                             cent, B, S, nz, nnz, iters, K_s, ev_s, rhs_s, d,
                             d_tmp, st);
  if (elem_bytes == 8)
    return ruiz_typed<double>(K, ev, rhs, rows, cols, rstart, rent, cstart,
                              cent, B, S, nz, nnz, iters, K_s, ev_s, rhs_s,
                              d, d_tmp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
