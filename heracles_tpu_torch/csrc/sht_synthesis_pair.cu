// Folded spin-pair Wigner-d synthesis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _synth_pair_kernel (:2161) and its
// l-chunked twin _synth_pair_kernel_lc (:2332, the same function with
// another VMEM tiling) of heracles_tpu/ops/pallas_sht.py, behind
// synthesis_pair_folded (:2829), their nb program included, and the
// compensated variant _synth_pair_kernel_comp (:2501) as the kComp
// instantiation.  The
// double-single variant (_dd :2660) maps to the double instantiation.
// (The spin-0 synthesis, _synth_kernel :1704, is sht_synthesis.cu.)
//
// What it computes, per batch element b, order m and northern ring r,
// summed over l = j0..lmax, with a_p / a_m the alms of the +-s columns
// times sqrt((2l+1)/4pi) and lp / lm those columns' functions of
// wigner_recurrence.cuh at x_r = cos(theta_r):
//   GNp = sum a_p lp          GSp = (-1)^m sum (-1)^l a_p lm
//   GNm = sum a_m lm          GSm = (-1)^m sum (-1)^l a_m lp
// GS is the mirrored southern ring's spectrum (lam(pi - t) = (-1)^{l+m}
// times the partner column's lam(t)).
//
// What bounds it: FP32 (or FP64) vector issue.  One spin-2 map at nside
// 4096, lmax 3000 has 3.69e10 (ring, l, m) triples; each needs 27 flop (two
// recurrences sharing a1 x, two emit multiplies, 8 FMAs), while the alms
// are read once (0.1 GB) and G written once (0.8 GB in float32).
//
// Design:
//   * one block of 128 threads per (order m, batch element), blockIdx.x =
//     m - m0 so the longest columns start first; each thread owns
//     kRings = 4 rings of a tile of 512 and steps l from j0 to lmax
//     with its rings' two recurrences and 12 sums each in registers:
//     the sum over l is the recurrence's own loop, so no reduction
//     across threads is needed;
//   * a warp owns 128 adjacent rings (lane + 32 r of its 128), so its
//     rings leave the poles' underflow close together, and picks one of
//     three paths at the start of every sub-chunk of kSub = 8 multipoles:
//       steady  every ring sits at k = -1 in both columns: no rescale and
//               no emit factor (dp = dc; dc = dn).  A seed below 1 starts
//               at k <= -1 and |d| <= 1, so an emitting ring stays at
//               k = -1 (see sht_analysis_pair.cu); where rounding takes a
//               value past 1 the unrescaled mantissa still holds the same
//               number (a power-of-two scale commutes with the
//               recurrence's roundings), so the path is exact and, once
//               taken, kept to the end of the tile;
//       dead    every exponent is <= -3: nothing emits in this sub-chunk
//               (sht_paths.cuh says why no value can get that far within
//               it), so only the recurrence runs, and its rescale once at
//               the sub-chunk's end;
//       full    otherwise: emit factor and rescale on every step;
//   * the alm rows of the shared table are held times 2^-60 and the emit
//     factor times 2^60 (2^60 at k = 0, 1 at k = -1), so the steady step
//     multiplies d itself and each FMA's product is the same exact number
//     as with the unscaled pair (a float32 alm times its norm below 2^-66,
//     ~1e-20, would turn subnormal and lose that);
//   * the terms of even and odd l are summed apart (the southern sums'
//     (-1)^l), and GS = (-1)^m (E - O) is formed once per output, so a term
//     costs its FMAs and no sign;
//   * the recurrence coefficients (float64, rounded to T) and the order's
//     two alm columns, times the norm, stream through shared memory in
//     chunks of 128 multipoles, double-buffered: while the block works on
//     one chunk each thread fills one row of the next, so the table does
//     not grow with lmax; a row is 8 values (a1, a0, b, pad, the alms) read
//     as vector loads, the same row by every thread (a broadcast);
//   * each (ring, m) output is one 8-byte (float32) or 16-byte (float64)
//     store of (re, im), written once, with no atomics, so results repeat
//     bit for bit.  A block owns one order, so its stores lie nm complex
//     values apart; staging a tile through shared memory could not make
//     them contiguous in m;
//   * the recurrence itself (seed, coefficients, unfused step, rescale) is
//     wigner_recurrence.cuh, shared with the other SHT kernels, and rounds
//     as the plain version does;
//   * the compensated float32 instantiation (kComp) gives each ring r =
//     x_lo / x_hi and a lo stream per column (wigner::step_lo), which
//     shares its column's rescales and paths and adds to it where it
//     emits: 14 operations a triple more (two lo steps of 6, two adds)
//     and 5 registers a ring; kComp = false compiles to the plain kernel;
//   * a batch runs in groups of NB = 1, 2 or 4 maps, the twin of the
//     reference's nb program (_synth_pair_kernel's nb, pallas_sht.py:2161
//     and its _lc, _comp and _dd bodies): NB = 1 is the kernel above, one
//     block per (order, map); NB > 1 is synth_pair_group_kernel, one block
//     per (order, group), which runs the two recurrences, their paths and
//     their rescales once for the group (11 of a map-triple's 27
//     operations) and gives each map its 8 FMAs.  What limits a group is
//     registers: a (ring, map) keeps 12 sums (the northern pair and the
//     even and odd southern ones), so a thread owns 4 / NB rings of NB
//     maps, the 48 sums of the NB = 1 kernel, in a tile of 512 / NB
//     rings.  A row of the shared table carries the NB maps' 4 alm values
//     after (a1, a0, b, pad), 4 + 4 NB values, so no table grows with
//     lmax.  Every output is the NB = 1 kernel's, bit for bit (the grouped
//     kernel's comment says why).
//
// C interface (loaded with ctypes): heracles_synthesis_pair_{f32,f64} and
// heracles_synthesis_pair_comp_f32 (with the rings' r after x) launch the
// batch in groups of nb maps (1, 2 or 4, dividing the batch, else
// cudaErrorInvalidValue) on the given stream and return
// cudaGetLastError(); heracles_synthesis_pair_blocks_per_sm gives the
// resident blocks per SM of a variant and nb;
// heracles_synthesis_pair_{,comp_}paths_f32 are diagnostic launches (nb
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
using wigner::step;
using wigner::step_lo;

// Rings per thread of a group of NB maps: the 4 (ring, map) pairs of sums
// of the NB = 1 kernel.
template <int NB>
__host__ __device__ constexpr int rings_of() {
  return kRings / NB;
}

// Values of a table row: a1, a0, b, pad and each map's 4 alm values.
template <int NB>
__host__ __device__ constexpr int row_width() {
  return 4 + 4 * NB;
}

template <typename T>
struct PairRing {
  T x, dp, dc, dpm, dcm;  // cos(theta); the +s and -s columns' d^{l-1}, d^l
  int k, km;              // their 2^60 exponents
  // comp only: x_lo / x_hi; the lo streams of the +s and -s columns
  T r, dpl, dcl, dpml, dcml;
};

template <typename T, int NB>
struct Row {
  T a1, a0, b;
  T al[NB][4];  // each map's (re, im) of a_p and a_m, times the norm and 2^-60
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
  constexpr int W = row_width<NB>();
  T v[W];
#pragma unroll
  for (int i = 0; i < W; i += 16 / int(sizeof(T))) load16(row + i, v + i);
  w.a1 = v[0], w.a0 = v[1], w.b = v[2];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) w.al[j][c] = v[4 + 4 * j + c];
  }
}

// Row l of the table: the coefficients taking d^l to d^{l+1} and each
// map's alms at l times the norm and 2^-60 (zeros past lmax); map j's
// columns start ``plane`` values after map j - 1's.
template <typename T, int NB>
__device__ __forceinline__ void fill_row(T* row, int l, int j0, int m, int s,
                                         int lmax, const T* ap, const T* am,
                                         size_t off, size_t plane, int nm) {
  coef_row<T>(l + 1, j0, m, s, lmax, &row[0], &row[1], &row[2]);
  row[3] = T(0);
  T* al = row + 4;
  if (l <= lmax) {
    const T norm = norm_of<T>(l);
    const T inv = Arith<T>::inv_scale();
    const size_t o = off + size_t(l) * nm * 2;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const size_t oj = o + j * plane;
      al[4 * j] = ap[oj] * norm * inv;
      al[4 * j + 1] = ap[oj + 1] * norm * inv;
      al[4 * j + 2] = am[oj] * norm * inv;
      al[4 * j + 3] = am[oj + 1] * norm * inv;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4 * NB; ++c) al[c] = T(0);
  }
}

// One multipole for every ring of the thread: add its terms and step the
// two recurrences.  ``gn`` takes the terms of every l (the northern sums),
// ``par`` those whose sign is (-1)^l, for this l's parity, of each ring
// and map.  Each map's FMAs are those of the NB = 1 kernel, in its order.
template <typename T, Path P, bool kComp, int NB, int R>
__device__ __forceinline__ void pair_step(const T* __restrict__ row,
                                          PairRing<T> (&rs)[R],
                                          T (&gn)[R][NB][4],
                                          T (&par)[R][NB][4]) {
  Row<T, NB> w;
  load_row(row, w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    PairRing<T>& q = rs[r];
    if (P != Path::kDead) {
      const T dp_ = kComp ? Arith<T>::add(q.dc, q.dcl) : q.dc;
      const T dm_ = kComp ? Arith<T>::add(q.dcm, q.dcml) : q.dcm;
      const T lp = P == Path::kSteady ? dp_ : dp_ * emit_scaled<T>(q.k);
      const T lm = P == Path::kSteady ? dm_ : dm_ * emit_scaled<T>(q.km);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        gn[r][j][0] = madd(w.al[j][0], lp, gn[r][j][0]);
        gn[r][j][1] = madd(w.al[j][1], lp, gn[r][j][1]);
        par[r][j][0] = madd(w.al[j][0], lm, par[r][j][0]);
        par[r][j][1] = madd(w.al[j][1], lm, par[r][j][1]);
        gn[r][j][2] = madd(w.al[j][2], lm, gn[r][j][2]);
        gn[r][j][3] = madd(w.al[j][3], lm, gn[r][j][3]);
        par[r][j][2] = madd(w.al[j][2], lp, par[r][j][2]);
        par[r][j][3] = madd(w.al[j][3], lp, par[r][j][3]);
      }
    }
    // the -s column's a0 is minus the +s column's
    const T a1x = Arith<T>::mul(w.a1, q.x);
    const T dnp = step<T>(a1x, w.a0, w.b, q.dc, q.dp);
    const T dnm = step<T>(a1x, -w.a0, w.b, q.dcm, q.dpm);
    if (kComp) {
      const T dnpl = step_lo<T>(a1x, w.a0, w.b, q.r, q.dc, q.dcl, q.dpl);
      const T dnml = step_lo<T>(a1x, -w.a0, w.b, q.r, q.dcm, q.dcml, q.dpml);
      if (P == Path::kFull) {
        advance_comp<T>(dnp, dnpl, q.dp, q.dc, q.dpl, q.dcl, q.k);
        advance_comp<T>(dnm, dnml, q.dpm, q.dcm, q.dpml, q.dcml, q.km);
      } else {
        q.dp = q.dc;
        q.dc = dnp;
        q.dpm = q.dcm;
        q.dcm = dnm;
        q.dpl = q.dcl;
        q.dcl = dnpl;
        q.dpml = q.dcml;
        q.dcml = dnml;
      }
    } else if (P == Path::kFull) {
      advance<T>(dnp, q.dp, q.dc, q.k);
      advance<T>(dnm, q.dpm, q.dcm, q.km);
    } else {  // steady: no rescale is due; dead: it waits for pair_sub
      q.dp = q.dc;
      q.dc = dnp;
      q.dpm = q.dcm;
      q.dcm = dnm;
    }
  }
}

template <typename T, Path P, bool kComp, int NB, int R>
__device__ __forceinline__ void pair_sub(const T* __restrict__ rows,
                                         PairRing<T> (&rs)[R],
                                         T (&gn)[R][NB][4],
                                         T (&e0)[R][NB][4],
                                         T (&e1)[R][NB][4]) {
  constexpr int W = row_width<NB>();
#pragma unroll
  for (int t = 0; t < kSub; t += 2) {
    pair_step<T, P, kComp, NB, R>(rows + t * W, rs, gn, e0);
    pair_step<T, P, kComp, NB, R>(rows + (t + 1) * W, rs, gn, e1);
  }
  if (P == Path::kDead) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      PairRing<T>& q = rs[r];
      if (kComp) {
        rescale_deferred<T>(q.dp, q.dc, q.dpl, q.dcl, q.k);
        rescale_deferred<T>(q.dpm, q.dcm, q.dpml, q.dcml, q.km);
      } else {
        rescale_deferred<T>(q.dp, q.dc, q.k);
        rescale_deferred<T>(q.dpm, q.dcm, q.km);
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
// double-buffered table, 2 x LC rows of row_width<NB>() values.
// xr: the rings' r = x_lo / x_hi, read only by the comp instantiation.
template <typename T, bool kComp, bool kCount, int NB>
__device__ __forceinline__ void pair_synthesis_body(
    T* __restrict__ tab, const T* __restrict__ ap, const T* __restrict__ am,
    const T* __restrict__ x, const T* __restrict__ xr,
    const double* __restrict__ logch, const double* __restrict__ logsh,
    const double* __restrict__ seed, T* __restrict__ gnp,
    T* __restrict__ gsp, T* __restrict__ gnm, T* __restrict__ gsm, int nhalf,
    int nm, int lmax, int s, int m0,
    unsigned long long* __restrict__ counts) {
  static_assert(kSub % 2 == 0 && LC % kSub == 0,
                "sub-chunks keep the parity of l and tile the chunk");
  static_assert(!kComp || sizeof(T) == 4, "comp is a float32 mode");
  static_assert(kRings % NB == 0, "a thread's rings hold whole groups");
  constexpr int R = rings_of<NB>();
  constexpr int kTile = kThreads * R;  // rings per tile
  constexpr int W = row_width<NB>();

  const int mc = blockIdx.x;  // the column: this order's place in the block
  const int m = m0 + mc;      // the order
  const int b = blockIdx.y * NB;  // the group's first map
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = max(m, s);
  const int ntiles = (nhalf + kTile - 1) / kTile;
  const size_t out_plane = size_t(nhalf) * nm * 2;
  const size_t out_col = (size_t(b) * nhalf * nm + mc) * 2;

  if (j0 > lmax) {  // an order above lmax: zeros
    for (int ring = tid; ring < nhalf; ring += kThreads) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const size_t off = out_col + j * out_plane + size_t(ring) * nm * 2;
        store2(gnp + off, T(0), T(0));
        store2(gsp + off, T(0), T(0));
        store2(gnm + off, T(0), T(0));
        store2(gsm + off, T(0), T(0));
      }
    }
    return;
  }

  const size_t alm_plane = size_t(lmax + 1) * nm * 2;
  const size_t alm_col = (size_t(b) * (lmax + 1) * nm + mc) * 2;
  const int nchunks = (lmax - j0 + LC) / LC;
  const double logc_p = seed[mc];
  const double sign_p = seed[nm + mc];
  const double logc_m = seed[2 * nm + mc];
  const double sign_m = seed[3 * nm + mc];
  // seed exponents of cos(t/2) and sin(t/2): (m+s, |m-s|) for +s and
  // swapped for -s
  const double pc = double(m + s);
  const double ps = fabs(double(m - s));
  // GS = (-1)^m sum (-1)^l (...) = (-1)^(m + j0) (E0 - E1), with E0 the
  // sum over l of j0's parity and E1 over the other
  const T gsign = ((m + j0) & 1) ? T(-1) : T(1);
  PathCounts<kCount> tally;

  fill_row<T, NB>(tab + tid * W, j0 + tid, j0, m, s, lmax, ap, am, alm_col,
                  alm_plane, nm);
  __syncthreads();

  int g = 0;  // running chunk count: selects the double buffers
  for (int tile = 0; tile < ntiles; ++tile) {
    PairRing<T> rs[R];
    T gn[R][NB][4], e0[R][NB][4], e1[R][NB][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ring = tile * kTile + (warp * R + r) * 32 + lane;
      PairRing<T>& q = rs[r];
      q.dp = T(0);
      q.dpm = T(0);
      if (kComp) q.r = q.dpl = q.dcl = q.dpml = q.dcml = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gn[r][j][c] = e0[r][j][c] = e1[r][j][c] = T(0);
        }
      }
      if (ring < nhalf) {
        const double lch = logch[ring], lsh = logsh[ring];
        q.x = x[ring];
        if (kComp) q.r = xr[ring];
        seed_of<T>(logc_p, sign_p, pc, ps, lch, lsh, q.dc, q.k);
        seed_of<T>(logc_m, sign_m, ps, pc, lch, lsh, q.dcm, q.km);
      } else {
        q.x = T(0);
        q.dc = T(0);
        q.dcm = T(0);
        q.k = kNoSeed;
        q.km = kNoSeed;
      }
    }

    for (int c = 0; c < nchunks; ++c, ++g) {
      const int buf = g & 1;
      // the next chunk's rows (the next tile's first after the last chunk)
      const int cn = (c + 1 < nchunks) ? c + 1 : 0;
      fill_row<T, NB>(tab + ((buf ^ 1) * LC + tid) * W, j0 + cn * LC + tid,
                      j0, m, s, lmax, ap, am, alm_col, alm_plane, nm);
      // rows past lmax are zeros, so the count rounds up to a sub-chunk
      const int n = min(LC, lmax - j0 - c * LC + 1);
      for (int t = 0; t < n; t += kSub) {
        bool steady = true, dead = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          steady = steady && sht_paths::is_steady(rs[r].k) &&
                   sht_paths::is_steady(rs[r].km);
          dead = dead && sht_paths::is_dead(rs[r].k) &&
                 sht_paths::is_dead(rs[r].km);
        }
        const T* rows = tab + (buf * LC + t) * W;
        const Path path = sht_paths::warp_path(steady, dead);
        tally.add(path);
        if (path == Path::kSteady) {
          pair_sub<T, Path::kSteady, kComp, NB, R>(rows, rs, gn, e0, e1);
        } else if (path == Path::kDead) {
          pair_sub<T, Path::kDead, kComp, NB, R>(rows, rs, gn, e0, e1);
        } else {
          pair_sub<T, Path::kFull, kComp, NB, R>(rows, rs, gn, e0, e1);
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
        store2(gnp + off, gn[r][j][0], gn[r][j][1]);
        store2(gsp + off, gsign * (e0[r][j][0] - e1[r][j][0]),
               gsign * (e0[r][j][1] - e1[r][j][1]));
        store2(gnm + off, gn[r][j][2], gn[r][j][3]);
        store2(gsm + off, gsign * (e0[r][j][2] - e1[r][j][2]),
               gsign * (e0[r][j][3] - e1[r][j][3]));
      }
    }
  }
  tally.flush(counts, lane);
}

// One block per (order, map).
template <typename T, bool kComp, bool kCount>
__global__ void __launch_bounds__(kThreads)
    pair_synthesis_kernel(const T* __restrict__ ap, const T* __restrict__ am,
                          const T* __restrict__ x, const T* __restrict__ xr,
                          const double* __restrict__ logch,
                          const double* __restrict__ logsh,
                          const double* __restrict__ seed, T* __restrict__ gnp,
                          T* __restrict__ gsp, T* __restrict__ gnm,
                          T* __restrict__ gsm, int nhalf, int nm, int lmax,
                          int s, int m0,
                          unsigned long long* __restrict__ counts) {
  __shared__ __align__(16) T tab[2 * LC * row_width<1>()];
  pair_synthesis_body<T, kComp, kCount, 1>(tab, ap, am, x, xr, logch, logsh,
                                           seed, gnp, gsp, gnm, gsm, nhalf,
                                           nm, lmax, s, m0, counts);
}

// The twin of the reference's nb program: one block per (order, group of
// NB maps) runs the two recurrences of its rings once for the group.  A
// thread owns rings_of<NB>() rings of a tile of kThreads of them; each
// map's sums are those of the NB = 1 kernel, taken in its order, with the
// same scalings and the same even / odd split, and every path gives the
// same values (sht_paths.cuh), so that which rings share a warp's path
// decision changes no bit: every output is the NB = 1 kernel's.
template <typename T, bool kComp, int NB>
__global__ void __launch_bounds__(kThreads)
    synth_pair_group_kernel(const T* __restrict__ ap,
                            const T* __restrict__ am, const T* __restrict__ x,
                            const T* __restrict__ xr,
                            const double* __restrict__ logch,
                            const double* __restrict__ logsh,
                            const double* __restrict__ seed,
                            T* __restrict__ gnp, T* __restrict__ gsp,
                            T* __restrict__ gnm, T* __restrict__ gsm,
                            int nhalf, int nm, int lmax, int s, int m0) {
  static_assert(NB > 1, "a group of maps");
  __shared__ __align__(16) T tab[2 * LC * row_width<NB>()];
  pair_synthesis_body<T, kComp, false, NB>(tab, ap, am, x, xr, logch, logsh,
                                           seed, gnp, gsp, gnm, gsm, nhalf,
                                           nm, lmax, s, m0, nullptr);
}

template <typename T, bool kComp, bool kCount>
int launch(const void* ap, const void* am, const void* x, const void* xr,
           const void* logch, const void* logsh, const void* seed, void* gnp,
           void* gsp, void* gnm, void* gsm, int batch, int nhalf, int nm,
           int lmax, int spin, int m0, void* counts, void* stream) {
  if (batch == 0 || nm == 0 || nhalf == 0) return int(cudaSuccess);
  pair_synthesis_kernel<T, kComp, kCount>
      <<<dim3(nm, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(ap), static_cast<const T*>(am),
          static_cast<const T*>(x), static_cast<const T*>(xr),
          static_cast<const double*>(logch),
          static_cast<const double*>(logsh), static_cast<const double*>(seed),
          static_cast<T*>(gnp), static_cast<T*>(gsp), static_cast<T*>(gnm),
          static_cast<T*>(gsm), nhalf, nm, lmax, spin, m0,
          static_cast<unsigned long long*>(counts));
  return int(cudaGetLastError());
}

template <typename T, bool kComp, int NB>
int launch_group(const void* ap, const void* am, const void* x,
                 const void* xr, const void* logch, const void* logsh,
                 const void* seed, void* gnp, void* gsp, void* gnm, void* gsm,
                 int batch, int nhalf, int nm, int lmax, int spin, int m0,
                 void* stream) {
  if (batch == 0 || nm == 0 || nhalf == 0) return int(cudaSuccess);
  synth_pair_group_kernel<T, kComp, NB>
      <<<dim3(nm, batch / NB), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(ap), static_cast<const T*>(am),
          static_cast<const T*>(x), static_cast<const T*>(xr),
          static_cast<const double*>(logch),
          static_cast<const double*>(logsh), static_cast<const double*>(seed),
          static_cast<T*>(gnp), static_cast<T*>(gsp), static_cast<T*>(gnm),
          static_cast<T*>(gsm), nhalf, nm, lmax, spin, m0);
  return int(cudaGetLastError());
}

// The launch of groups of nb maps: nb = 1 is the kernel above, 2 and 4 the
// grouped kernel; any other nb, or one that does not divide the batch, is
// refused.
template <typename T, bool kComp>
int launch_nb(const void* ap, const void* am, const void* x, const void* xr,
              const void* logch, const void* logsh, const void* seed,
              void* gnp, void* gsp, void* gnm, void* gsm, int batch,
              int nhalf, int nm, int lmax, int spin, int m0, int nb,
              void* stream) {
  if (nb < 1 || batch % nb != 0) return int(cudaErrorInvalidValue);
  switch (nb) {
    case 1:
      return launch<T, kComp, false>(ap, am, x, xr, logch, logsh, seed, gnp,
                                     gsp, gnm, gsm, batch, nhalf, nm, lmax,
                                     spin, m0, nullptr, stream);
    case 2:
      return launch_group<T, kComp, 2>(ap, am, x, xr, logch, logsh, seed, gnp,
                                       gsp, gnm, gsm, batch, nhalf, nm, lmax,
                                       spin, m0, stream);
    case 4:
      return launch_group<T, kComp, 4>(ap, am, x, xr, logch, logsh, seed, gnp,
                                       gsp, gnm, gsm, batch, nhalf, nm, lmax,
                                       spin, m0, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, bool kComp>
int blocks_nb(int nb, int* n) {
  switch (nb) {
    case 1:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, pair_synthesis_kernel<T, kComp, false>, kThreads, 0));
    case 2:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, synth_pair_group_kernel<T, kComp, 2>, kThreads, 0));
    case 4:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, synth_pair_group_kernel<T, kComp, 4>, kThreads, 0));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int heracles_synthesis_pair_f32(const void* alm_p, const void* alm_m,
                                const void* x, const void* logch,
                                const void* logsh, const void* seed,
                                void* gnp, void* gsp, void* gnm, void* gsm,
                                int batch, int nhalf, int nm, int lmax,
                                int spin, int m0, int nb, void* stream) {
  return launch_nb<float, false>(alm_p, alm_m, x, nullptr, logch, logsh, seed,
                                 gnp, gsp, gnm, gsm, batch, nhalf, nm, lmax,
                                 spin, m0, nb, stream);
}

int heracles_synthesis_pair_f64(const void* alm_p, const void* alm_m,
                                const void* x, const void* logch,
                                const void* logsh, const void* seed,
                                void* gnp, void* gsp, void* gnm, void* gsm,
                                int batch, int nhalf, int nm, int lmax,
                                int spin, int m0, int nb, void* stream) {
  return launch_nb<double, false>(alm_p, alm_m, x, nullptr, logch, logsh,
                                  seed, gnp, gsp, gnm, gsm, batch, nhalf, nm,
                                  lmax, spin, m0, nb, stream);
}

// The compensated float32 launch: xr holds each ring's r = x_lo / x_hi.
int heracles_synthesis_pair_comp_f32(const void* alm_p, const void* alm_m,
                                     const void* x, const void* xr,
                                     const void* logch, const void* logsh,
                                     const void* seed, void* gnp, void* gsp,
                                     void* gnm, void* gsm, int batch,
                                     int nhalf, int nm, int lmax, int spin,
                                     int m0, int nb, void* stream) {
  return launch_nb<float, true>(alm_p, alm_m, x, xr, logch, logsh, seed, gnp,
                                gsp, gnm, gsm, batch, nhalf, nm, lmax, spin,
                                m0, nb, stream);
}

// The float32 launch with ``counts`` (3 x uint64, zeroed by the caller)
// taking the warps' sub-chunks on the steady, dead and full paths; the
// counted kernel is the nb = 1 one, any other nb is refused.
int heracles_synthesis_pair_paths_f32(const void* alm_p, const void* alm_m,
                                      const void* x, const void* logch,
                                      const void* logsh, const void* seed,
                                      void* gnp, void* gsp, void* gnm,
                                      void* gsm, void* counts, int batch,
                                      int nhalf, int nm, int lmax, int spin,
                                      int m0, int nb, void* stream) {
  if (nb != 1) return int(cudaErrorInvalidValue);
  return launch<float, false, true>(alm_p, alm_m, x, nullptr, logch, logsh,
                                    seed, gnp, gsp, gnm, gsm, batch, nhalf, nm,
                                    lmax, spin, m0, counts, stream);
}

// The compensated float32 launch with the path counts.
int heracles_synthesis_pair_comp_paths_f32(
    const void* alm_p, const void* alm_m, const void* x, const void* xr,
    const void* logch, const void* logsh, const void* seed, void* gnp,
    void* gsp, void* gnm, void* gsm, void* counts, int batch, int nhalf,
    int nm, int lmax, int spin, int m0, int nb, void* stream) {
  if (nb != 1) return int(cudaErrorInvalidValue);
  return launch<float, true, true>(alm_p, alm_m, x, xr, logch, logsh, seed,
                                   gnp, gsp, gnm, gsm, batch, nhalf, nm, lmax,
                                   spin, m0, counts, stream);
}

// Resident blocks per SM of the pair synthesis in groups of nb maps (its
// shared memory does not depend on lmax), written to *blocks; variant 0 is
// the float32 kernel, 1 the float64 one, 2 the compensated float32 one.
// Returns the CUDA error code.
int heracles_synthesis_pair_blocks_per_sm(int variant, int nb,
                                          void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (variant == 1) return blocks_nb<double, false>(nb, n);
  if (variant == 2) return blocks_nb<float, true>(nb, n);
  return blocks_nb<float, false>(nb, n);
}

}  // extern "C"
