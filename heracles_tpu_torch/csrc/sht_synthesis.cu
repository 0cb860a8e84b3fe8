// Folded spin-0 Wigner-d synthesis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _synth_kernel of
// heracles_tpu/ops/pallas_sht.py (:1704), behind synthesis_spin0_folded
// (:2043), its nb program included, and its compensated variant
// _synth_kernel_comp (:1828) as the kComp instantiation.  The
// double-single variant (_dd :1933) maps to the double instantiation.
// (The spin pair, _synth_pair_kernel :2161, is sht_synthesis_pair.cu.)
//
// What it computes, per batch element b, order m and northern ring r,
// summed over l = m..lmax, with a the alm times sqrt((2l+1)/4pi) and lam
// the function of wigner_recurrence.cuh at x_r = cos(theta_r):
//   GN = sum a lam            GS = (-1)^m sum (-1)^l a lam
// GS is the mirrored southern ring's spectrum (lam(pi - t) = (-1)^{l+m}
// lam(t)).
//
// What bounds it: FP32 (or FP64) vector issue.  One map at nside 4096,
// lmax 3000 has 3.69e10 (ring, l, m) triples; each needs 9 flop (the
// recurrence's 4 unfused operations, the emit multiply, 2 FMAs), while the
// alms are read once (72 MB in float32) and G written once (0.4 GB).  So
// the design spends its effort on the instructions per triple: most
// triples need neither the emit factor nor the rescale, and take a path
// that has neither.
//
// Design (the pair synthesis' shape, sht_synthesis_pair.cu, with one
// recurrence, one exponent and two sums per parity):
//   * one block of 128 threads per (order m, batch element), blockIdx.x =
//     m - m0 so the longest columns start first; each thread owns
//     kRings = 4 rings of a tile of 512 and steps l from j0 = m to lmax
//     with its rings' recurrence and 4 sums each in registers: the sum
//     over l is the recurrence's own loop, so no reduction across
//     threads is needed;
//   * a warp owns 128 adjacent rings (lane + 32 r of its 128), so its
//     rings leave the poles' underflow close together, and picks one of
//     three paths at the start of every sub-chunk of kSub = 8 multipoles
//     (sht_paths.cuh):
//       steady  every ring sits at k = -1: no rescale and no emit factor
//               (dp = dc; dc = dn), the recurrence's 5 operations and the
//               2 FMAs only.  A seed below 1 starts at k <= -1 and
//               |d| <= 1, so an emitting ring stays at k = -1; where
//               rounding takes a value past 1 the unrescaled mantissa
//               still holds the same number (a power-of-two scale commutes
//               with the recurrence's roundings), so the path is exact
//               and, once taken, kept to the end of the tile: k no longer
//               changes, and the warp stops looking at its exponents;
//       dead    every exponent is <= -3: nothing emits in this sub-chunk,
//               so only the recurrence runs, and its rescale once at the
//               sub-chunk's end;
//       full    otherwise: emit factor and rescale on every step (the
//               order 0, whose functions are of order 1, sits at k = 0 and
//               stays here);
//   * the alm rows of the shared table are held times 2^-60 and the emit
//     factor times 2^60 (2^60 at k = 0, 1 at k = -1), so the steady step
//     multiplies d itself.  Both scalings are powers of two, so each FMA's
//     product is the same exact number as that of the unscaled pair and
//     the sums round as they would without the paths (a float32 alm times
//     its norm below 2^-66, ~1e-20, would turn subnormal and lose that);
//   * the terms of even and odd l are summed apart (the southern sums'
//     (-1)^l), each in the order of l, and GN = E + O, GS = (-1)^m (E - O)
//     are formed once per output, so a term costs its FMAs and no sign;
//   * spin 0's a0 is -0.0 in every row (m s = 0), and x + (-0.0) = x, so
//     the step leaves that addition out (step_a0_zero) and rounds as
//     before: 4 operations of recurrence a triple, not 5;
//   * the recurrence coefficients (float64, rounded to T) and the order's
//     alm column, times the norm, stream through static shared memory in
//     chunks of 128 multipoles, double-buffered: while the block works on
//     one chunk each thread fills one row of the next, so the table does
//     not grow with lmax; a row is 4 values (a1, b, re, im), one 16-byte
//     read in float32 and two in float64, the same row by every thread (a
//     broadcast);
//   * each (ring, m) output is one 8-byte (float32) or 16-byte (float64)
//     store of (re, im), written once, with no atomics, so results repeat
//     bit for bit;
//   * the recurrence itself (seed, coefficients, unfused step, rescale) is
//     wigner_recurrence.cuh, shared with the other SHT kernels, and rounds
//     as the plain version does;
//   * the compensated float32 instantiation (kComp) gives each ring r =
//     x_lo / x_hi and a lo stream (wigner::step_lo_a0_zero, whose a1 x d
//     is the step's own product), which shares d's rescales and paths and
//     adds to d where it emits: 6 operations a triple more and 3
//     registers a ring; kComp = false compiles to the plain kernel;
//   * a batch runs in groups of NB = 1, 2, 4 or 8 maps, the twin of the
//     reference's nb program (_synth_kernel's nb, pallas_sht.py:1705):
//     NB = 1 is the kernel above, one block per (order, map); NB > 1 is
//     synth_group_kernel, one block per (order, group), which runs the
//     recurrence, its paths and its rescales once for the group (4 of a
//     map-triple's 6 operations) and gives each map its 2 FMAs.  What
//     limits a group is registers, each (ring, map) keeping 4 sums, so a
//     thread owns fewer rings as NB grows: 8 (ring, map) pairs from NB = 2
//     on (4 rings of 2 maps, 2 of 4, 1 of 8), a tile of 128 x that many
//     rings.  A row of the shared table carries the NB maps' alms after
//     (a1, b), padded to whole 16-byte reads (4 + 2 (NB - 1) values
//     rounded up), so no table grows with lmax.  Every output is the
//     NB = 1 kernel's, bit for bit (the grouped kernel's comment says
//     why).
//
// C interface (loaded with ctypes): heracles_synthesis_spin0_{f32,f64}
// and heracles_synthesis_spin0_comp_f32 (with the rings' r after x)
// launch the batch in groups of nb maps (1, 2, 4 or 8, dividing the
// batch, else cudaErrorInvalidValue) on the given stream and return
// cudaGetLastError(); heracles_synthesis_spin0_blocks_per_sm gives the
// resident blocks per SM of a variant and nb;
// heracles_synthesis_spin0_{,comp_}paths_f32 are diagnostic launches (nb
// 1, one map a block) that also count the warps' sub-chunks on each path
// (steady, dead, full).
// Every launch takes the block of orders m0..m0+nm-1 into its columns
// 0..nm-1 (the seed planes are the block's, indexed by column), so a
// device mesh can give each shard its own block; m0 = 0 is every order
// from 0, and an order above lmax gives a column of zeros.

#include <cuda_runtime.h>
#include <stddef.h>

#include "sht_paths.cuh"
#include "wigner_recurrence.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRings = 4;                 // rings per thread at NB = 1
constexpr int LC = kThreads;              // multipoles per chunk: a row each
constexpr int NA = 2;                     // (re, im) of the alm
constexpr int kSub = sht_paths::kSub;     // multipoles per path decision

using sht_paths::emit_scaled;
using sht_paths::madd;
using sht_paths::Path;
using sht_paths::PathCounts;
using sht_paths::rescale_deferred;
using wigner::advance;
using wigner::advance_comp;
using wigner::Arith;
using wigner::coef_row;
using wigner::kNoSeed;
using wigner::norm_of;
using wigner::seed_of;
using wigner::step_a0_zero;
using wigner::step_lo_a0_zero;

// Rings per thread of a group of NB maps: 8 (ring, map) pairs of sums a
// thread from NB = 2 on (4 rings of 2 maps, 2 of 4, 1 of 8), the NB = 1
// kernel's 4 rings of one map below.
template <int NB>
__host__ __device__ constexpr int rings_of() {
  return NB == 1 ? kRings : 8 / NB;
}

// Values of a table row: a1, b and each map's (re, im), padded to whole
// 16-byte reads.
template <typename T, int NB>
__host__ __device__ constexpr int row_width() {
  return (2 + NA * NB + 16 / int(sizeof(T)) - 1) / (16 / int(sizeof(T))) *
         (16 / int(sizeof(T)));
}

template <typename T>
struct Ring {
  T x, dp, dc;    // cos(theta); d^{l-1}, d^l
  int k;          // the 2^60 exponent
  T r, dpl, dcl;  // comp only: x_lo / x_hi; the lo stream's l-1, l
};

template <typename T, int NB>
struct Row {
  T a1, b;
  T al[NB][NA];  // each map's (re, im) of the alm, times the norm and 2^-60
};

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x, v[1] = a.y;
}

template <typename T, int NB>
__device__ __forceinline__ void load_row(const T* row, Row<T, NB>& w) {
  constexpr int W = row_width<T, NB>();
  T v[W];
#pragma unroll
  for (int i = 0; i < W; i += 16 / int(sizeof(T))) load16(row + i, v + i);
  w.a1 = v[0], w.b = v[1];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    w.al[j][0] = v[2 + NA * j];
    w.al[j][1] = v[3 + NA * j];
  }
}

// Row l of the table: the coefficients taking d^l to d^{l+1} (a0 is -0.0
// at spin 0 and left out) and each map's alm at l times the norm and
// 2^-60 (zeros past lmax); map j's column starts ``plane`` values after
// map j - 1's.
template <typename T, int NB>
__device__ __forceinline__ void fill_row(T* row, int l, int m, int lmax,
                                         const T* a0, size_t off,
                                         size_t plane, int nm) {
  T a0_unused;
  coef_row<T>(l + 1, m, m, 0, lmax, &row[0], &a0_unused, &row[1]);
  T* al = row + 2;
  if (l <= lmax) {
    const T norm = norm_of<T>(l);
    const T inv = Arith<T>::inv_scale();
    const size_t o = off + size_t(l) * nm * 2;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      al[NA * j] = a0[o + j * plane] * norm * inv;
      al[NA * j + 1] = a0[o + j * plane + 1] * norm * inv;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NA * NB; ++c) al[c] = T(0);
  }
#pragma unroll
  for (int c = 2 + NA * NB; c < row_width<T, NB>(); ++c) row[c] = T(0);
}

// One multipole for every ring of the thread: add its terms to ``par``,
// the sums of this l's parity of each ring and map, and step the
// recurrence.  Each map's FMAs are those of the NB = 1 kernel, in its
// order.
template <typename T, Path P, bool kComp, int NB, int R>
__device__ __forceinline__ void synth_step(const T* __restrict__ row,
                                           Ring<T> (&rs)[R],
                                           T (&par)[R][NB][NA]) {
  Row<T, NB> w;
  load_row(row, w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    Ring<T>& q = rs[r];
    if (P != Path::kDead) {
      const T d = kComp ? Arith<T>::add(q.dc, q.dcl) : q.dc;
      const T lp = P == Path::kSteady ? d : d * emit_scaled<T>(q.k);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        par[r][j][0] = madd(w.al[j][0], lp, par[r][j][0]);
        par[r][j][1] = madd(w.al[j][1], lp, par[r][j][1]);
      }
    }
    const T a1x = Arith<T>::mul(w.a1, q.x);
    const T dn = step_a0_zero<T>(a1x, w.b, q.dc, q.dp);
    if (kComp) {
      const T dnl = step_lo_a0_zero<T>(a1x, w.b, q.r, q.dc, q.dcl, q.dpl);
      if (P == Path::kFull) {
        advance_comp<T>(dn, dnl, q.dp, q.dc, q.dpl, q.dcl, q.k);
      } else {
        q.dp = q.dc;
        q.dc = dn;
        q.dpl = q.dcl;
        q.dcl = dnl;
      }
    } else if (P == Path::kFull) {
      advance<T>(dn, q.dp, q.dc, q.k);
    } else {  // steady: no rescale is due; dead: it waits for synth_sub
      q.dp = q.dc;
      q.dc = dn;
    }
  }
}

// kSub multipoles from ``rows`` (``W`` values a row) on; the first has
// the parity of j0.
template <typename T, Path P, bool kComp, int NB, int R>
__device__ __forceinline__ void synth_sub(const T* __restrict__ rows,
                                          Ring<T> (&rs)[R],
                                          T (&e0)[R][NB][NA],
                                          T (&e1)[R][NB][NA]) {
  constexpr int W = row_width<T, NB>();
#pragma unroll
  for (int t = 0; t < kSub; t += 2) {
    synth_step<T, P, kComp, NB, R>(rows + t * W, rs, e0);
    synth_step<T, P, kComp, NB, R>(rows + (t + 1) * W, rs, e1);
  }
  if (P == Path::kDead) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kComp) {
        rescale_deferred<T>(rs[r].dp, rs[r].dc, rs[r].dpl, rs[r].dcl, rs[r].k);
      } else {
        rescale_deferred<T>(rs[r].dp, rs[r].dc, rs[r].k);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float re, float im) {
  *reinterpret_cast<float2*>(p) = make_float2(re, im);
}
__device__ __forceinline__ void store2(double* p, double re, double im) {
  *reinterpret_cast<double2*>(p) = make_double2(re, im);
}

// The body of both kernels: the block of order m0 + blockIdx.x and maps
// NB blockIdx.y .. NB blockIdx.y + NB - 1, with ``tab`` the block's
// double-buffered table, 2 x LC rows of row_width<T, NB>() values.
// xr: the rings' r = x_lo / x_hi, read only by the comp instantiation.
template <typename T, bool kComp, bool kCount, int NB>
__device__ __forceinline__ void synthesis_body(
    T* __restrict__ tab, const T* __restrict__ a0, const T* __restrict__ x,
    const T* __restrict__ xr, const double* __restrict__ logch,
    const double* __restrict__ logsh, const double* __restrict__ seed,
    T* __restrict__ gn0, T* __restrict__ gs0, int nhalf, int nm, int lmax,
    int m0, unsigned long long* __restrict__ counts) {
  static_assert(kSub % 2 == 0 && LC % kSub == 0,
                "sub-chunks keep the parity of l and tile the chunk");
  static_assert(!kComp || sizeof(T) == 4, "comp is a float32 mode");
  constexpr int R = rings_of<NB>();
  constexpr int kTile = kThreads * R;  // rings per tile
  constexpr int W = row_width<T, NB>();

  const int mc = blockIdx.x;  // the column: this order's place in the block
  const int m = m0 + mc;      // the order
  const int b = blockIdx.y * NB;  // the group's first map
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = m;
  const int ntiles = (nhalf + kTile - 1) / kTile;
  const size_t out_plane = size_t(nhalf) * nm * 2;
  const size_t out_col = (size_t(b) * nhalf * nm + mc) * 2;

  if (j0 > lmax) {  // an order above lmax: zeros
    for (int ring = tid; ring < nhalf; ring += kThreads) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const size_t off = out_col + j * out_plane + size_t(ring) * nm * 2;
        store2(gn0 + off, T(0), T(0));
        store2(gs0 + off, T(0), T(0));
      }
    }
    return;
  }

  const size_t alm_plane = size_t(lmax + 1) * nm * 2;
  const size_t alm_col = (size_t(b) * (lmax + 1) * nm + mc) * 2;
  const int nchunks = (lmax - j0 + LC) / LC;
  const double logc_p = seed[mc];
  const double sign_p = seed[nm + mc];
  // seed exponents of cos(t/2) and sin(t/2): both m
  const double pc = double(m);
  const double ps = double(m);
  // GS = (-1)^m sum (-1)^l (...) = (-1)^(m + j0) (E0 - E1), with E0 the
  // sum over l of j0's parity and E1 over the other
  const T gsign = ((m + j0) & 1) ? T(-1) : T(1);
  PathCounts<kCount> tally;

  fill_row<T, NB>(tab + tid * W, j0 + tid, m, lmax, a0, alm_col, alm_plane,
                  nm);
  __syncthreads();

  int g = 0;  // running chunk count: selects the double buffers
  for (int tile = 0; tile < ntiles; ++tile) {
    Ring<T> rs[R];
    T e0[R][NB][NA], e1[R][NB][NA];
    bool settled = false;  // the warp has taken the steady path
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ring = tile * kTile + (warp * R + r) * 32 + lane;
      Ring<T>& q = rs[r];
      q.dp = T(0);
      if (kComp) q.r = q.dpl = q.dcl = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int c = 0; c < NA; ++c) e0[r][j][c] = e1[r][j][c] = T(0);
      }
      if (ring < nhalf) {
        const double lch = logch[ring], lsh = logsh[ring];
        q.x = x[ring];
        if (kComp) q.r = xr[ring];
        seed_of<T>(logc_p, sign_p, pc, ps, lch, lsh, q.dc, q.k);
      } else {
        q.x = T(0);
        q.dc = T(0);
        q.k = kNoSeed;
      }
    }

    for (int c = 0; c < nchunks; ++c, ++g) {
      const int buf = g & 1;
      // the next chunk's rows (the next tile's first after the last chunk)
      const int cn = (c + 1 < nchunks) ? c + 1 : 0;
      fill_row<T, NB>(tab + ((buf ^ 1) * LC + tid) * W, j0 + cn * LC + tid,
                      m, lmax, a0, alm_col, alm_plane, nm);
      // rows past lmax are zeros, so the count rounds up to a sub-chunk
      const int n = min(LC, lmax - j0 - c * LC + 1);
      for (int t = 0; t < n; t += kSub) {
        Path path = Path::kSteady;
        if (!settled) {
          bool steady = true, dead = true;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            steady = steady && sht_paths::is_steady(rs[r].k);
            dead = dead && sht_paths::is_dead(rs[r].k);
          }
          path = sht_paths::warp_path(steady, dead);
          settled = path == Path::kSteady;
        }
        const T* rows = tab + (buf * LC + t) * W;
        tally.add(path);
        if (path == Path::kSteady) {
          synth_sub<T, Path::kSteady, kComp, NB, R>(rows, rs, e0, e1);
        } else if (path == Path::kDead) {
          synth_sub<T, Path::kDead, kComp, NB, R>(rows, rs, e0, e1);
        } else {
          synth_sub<T, Path::kFull, kComp, NB, R>(rows, rs, e0, e1);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ring = tile * kTile + (warp * R + r) * 32 + lane;
      if (ring >= nhalf) continue;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const size_t off = out_col + j * out_plane + size_t(ring) * nm * 2;
        store2(gn0 + off, e0[r][j][0] + e1[r][j][0],
               e0[r][j][1] + e1[r][j][1]);
        store2(gs0 + off, gsign * (e0[r][j][0] - e1[r][j][0]),
               gsign * (e0[r][j][1] - e1[r][j][1]));
      }
    }
  }
  tally.flush(counts, lane);
}

// One block per (order, map).
template <typename T, bool kComp, bool kCount>
__global__ void __launch_bounds__(kThreads)
    synthesis_kernel(const T* __restrict__ a0, const T* __restrict__ x,
                     const T* __restrict__ xr,
                     const double* __restrict__ logch,
                     const double* __restrict__ logsh,
                     const double* __restrict__ seed, T* __restrict__ gn0,
                     T* __restrict__ gs0, int nhalf, int nm, int lmax,
                     int m0, unsigned long long* __restrict__ counts) {
  __shared__ __align__(16) T tab[2 * LC * row_width<T, 1>()];
  synthesis_body<T, kComp, kCount, 1>(tab, a0, x, xr, logch, logsh, seed,
                                      gn0, gs0, nhalf, nm, lmax, m0, counts);
}

// The twin of the reference's nb program: one block per (order, group of
// NB maps) runs the recurrence of its rings once for the group.  A
// thread owns rings_of<NB>() rings of a tile of kThreads of them; each
// map's sums are those of the NB = 1 kernel, taken in its order, with the
// same scalings and the same even / odd split, and every path gives the
// same values (sht_paths.cuh), so that which rings share a warp's path
// decision changes no bit: every output is the NB = 1 kernel's.
template <typename T, bool kComp, int NB>
__global__ void __launch_bounds__(kThreads)
    synth_group_kernel(const T* __restrict__ a0, const T* __restrict__ x,
                       const T* __restrict__ xr,
                       const double* __restrict__ logch,
                       const double* __restrict__ logsh,
                       const double* __restrict__ seed, T* __restrict__ gn0,
                       T* __restrict__ gs0, int nhalf, int nm, int lmax,
                       int m0) {
  static_assert(NB > 1, "a group of maps");
  __shared__ __align__(16) T tab[2 * LC * row_width<T, NB>()];
  synthesis_body<T, kComp, false, NB>(tab, a0, x, xr, logch, logsh, seed,
                                      gn0, gs0, nhalf, nm, lmax, m0, nullptr);
}

template <typename T, bool kComp, bool kCount>
int launch(const void* a0, const void* x, const void* xr, const void* logch,
           const void* logsh, const void* seed, void* gn0, void* gs0,
           int batch, int nhalf, int nm, int lmax, int m0, void* counts,
           void* stream) {
  if (batch == 0 || nm == 0 || nhalf == 0) return int(cudaSuccess);
  synthesis_kernel<T, kComp, kCount>
      <<<dim3(nm, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a0), static_cast<const T*>(x),
          static_cast<const T*>(xr), static_cast<const double*>(logch),
          static_cast<const double*>(logsh),
          static_cast<const double*>(seed), static_cast<T*>(gn0),
          static_cast<T*>(gs0), nhalf, nm, lmax, m0,
          static_cast<unsigned long long*>(counts));
  return int(cudaGetLastError());
}

template <typename T, bool kComp, int NB>
int launch_group(const void* a0, const void* x, const void* xr,
                 const void* logch, const void* logsh, const void* seed,
                 void* gn0, void* gs0, int batch, int nhalf, int nm, int lmax,
                 int m0, void* stream) {
  if (batch == 0 || nm == 0 || nhalf == 0) return int(cudaSuccess);
  synth_group_kernel<T, kComp, NB>
      <<<dim3(nm, batch / NB), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a0), static_cast<const T*>(x),
          static_cast<const T*>(xr), static_cast<const double*>(logch),
          static_cast<const double*>(logsh),
          static_cast<const double*>(seed), static_cast<T*>(gn0),
          static_cast<T*>(gs0), nhalf, nm, lmax, m0);
  return int(cudaGetLastError());
}

// The launch of groups of nb maps: nb = 1 is the kernel above, 2, 4 and 8
// the grouped kernel; any other nb, or one that does not divide the batch,
// is refused.
template <typename T, bool kComp>
int launch_nb(const void* a0, const void* x, const void* xr,
              const void* logch, const void* logsh, const void* seed,
              void* gn0, void* gs0, int batch, int nhalf, int nm, int lmax,
              int m0, int nb, void* stream) {
  if (nb < 1 || batch % nb != 0) return int(cudaErrorInvalidValue);
  switch (nb) {
    case 1:
      return launch<T, kComp, false>(a0, x, xr, logch, logsh, seed, gn0, gs0,
                                     batch, nhalf, nm, lmax, m0, nullptr,
                                     stream);
    case 2:
      return launch_group<T, kComp, 2>(a0, x, xr, logch, logsh, seed, gn0,
                                       gs0, batch, nhalf, nm, lmax, m0,
                                       stream);
    case 4:
      return launch_group<T, kComp, 4>(a0, x, xr, logch, logsh, seed, gn0,
                                       gs0, batch, nhalf, nm, lmax, m0,
                                       stream);
    case 8:
      return launch_group<T, kComp, 8>(a0, x, xr, logch, logsh, seed, gn0,
                                       gs0, batch, nhalf, nm, lmax, m0,
                                       stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, bool kComp>
int blocks_nb(int nb, int* n) {
  switch (nb) {
    case 1:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, synthesis_kernel<T, kComp, false>, kThreads, 0));
    case 2:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, synth_group_kernel<T, kComp, 2>, kThreads, 0));
    case 4:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, synth_group_kernel<T, kComp, 4>, kThreads, 0));
    case 8:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, synth_group_kernel<T, kComp, 8>, kThreads, 0));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int heracles_synthesis_spin0_f32(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 int m0, int nb, void* stream) {
  return launch_nb<float, false>(alm, x, nullptr, logch, logsh, seed, gn, gs,
                                 batch, nhalf, nm, lmax, m0, nb, stream);
}

int heracles_synthesis_spin0_f64(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 int m0, int nb, void* stream) {
  return launch_nb<double, false>(alm, x, nullptr, logch, logsh, seed, gn, gs,
                                  batch, nhalf, nm, lmax, m0, nb, stream);
}

// The compensated float32 launch: xr holds each ring's r = x_lo / x_hi.
int heracles_synthesis_spin0_comp_f32(const void* alm, const void* x,
                                      const void* xr, const void* logch,
                                      const void* logsh, const void* seed,
                                      void* gn, void* gs, int batch, int nhalf,
                                      int nm, int lmax, int m0, int nb,
                                      void* stream) {
  return launch_nb<float, true>(alm, x, xr, logch, logsh, seed, gn, gs, batch,
                                nhalf, nm, lmax, m0, nb, stream);
}

// The float32 launch with ``counts`` (3 x uint64, zeroed by the caller)
// taking the warps' sub-chunks on the steady, dead and full paths; the
// counted kernel is the nb = 1 one, any other nb is refused.
int heracles_synthesis_spin0_paths_f32(const void* alm, const void* x,
                                       const void* logch, const void* logsh,
                                       const void* seed, void* gn, void* gs,
                                       void* counts, int batch, int nhalf,
                                       int nm, int lmax, int m0, int nb,
                                       void* stream) {
  if (nb != 1) return int(cudaErrorInvalidValue);
  return launch<float, false, true>(alm, x, nullptr, logch, logsh, seed, gn,
                                    gs, batch, nhalf, nm, lmax, m0, counts,
                                    stream);
}

// The compensated float32 launch with the path counts.
int heracles_synthesis_spin0_comp_paths_f32(const void* alm, const void* x,
                                            const void* xr, const void* logch,
                                            const void* logsh,
                                            const void* seed, void* gn,
                                            void* gs, void* counts, int batch,
                                            int nhalf, int nm, int lmax,
                                            int m0, int nb, void* stream) {
  if (nb != 1) return int(cudaErrorInvalidValue);
  return launch<float, true, true>(alm, x, xr, logch, logsh, seed, gn, gs,
                                   batch, nhalf, nm, lmax, m0, counts, stream);
}

// Resident blocks per SM of the spin-0 synthesis in groups of nb maps (its
// shared memory does not depend on lmax), written to *blocks; variant 0 is
// the float32 kernel, 1 the float64 one, 2 the compensated float32 one.
// Returns the CUDA error code.
int heracles_synthesis_spin0_blocks_per_sm(int variant, int nb,
                                           void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (variant == 1) return blocks_nb<double, false>(nb, n);
  if (variant == 2) return blocks_nb<float, true>(nb, n);
  return blocks_nb<float, false>(nb, n);
}

}  // extern "C"
