// Folded spin-pair Wigner-d synthesis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _synth_pair_kernel (:2161) and its
// l-chunked twin _synth_pair_kernel_lc (:2332, the same function with
// another VMEM tiling) of heracles_tpu/ops/pallas_sht.py, behind
// synthesis_pair_folded (:2829), and the compensated variant
// _synth_pair_kernel_comp (:2501) as the kComp instantiation.  The
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
//     and 5 registers a ring; kComp = false compiles to the plain kernel.
//
// C interface (loaded with ctypes): heracles_synthesis_pair_{f32,f64} and
// heracles_synthesis_pair_comp_f32 (with the rings' r after x) launch on
// the given stream and return cudaGetLastError();
// heracles_synthesis_pair_blocks_per_sm gives the resident blocks per SM;
// heracles_synthesis_pair_{,comp_}paths_f32 are diagnostic launches that
// also count the warps' sub-chunks on each path (steady, dead, full).
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
constexpr int kRings = 4;                 // rings per thread
constexpr int kTile = kThreads * kRings;  // rings per tile
constexpr int LC = kThreads;              // multipoles per chunk: a row each
constexpr int NR = 8;                     // a row: a1, a0, b, pad, 4 alm values
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

template <typename T>
struct PairRing {
  T x, dp, dc, dpm, dcm;  // cos(theta); the +s and -s columns' d^{l-1}, d^l
  int k, km;              // their 2^60 exponents
  // comp only: x_lo / x_hi; the lo streams of the +s and -s columns
  T r, dpl, dcl, dpml, dcml;
};

template <typename T>
struct Row {
  T a1, a0, b;
  T al[4];  // (re, im) of a_p and a_m, times the norm and 2^-60
};

__device__ __forceinline__ void load_row(const float* row, Row<float>& w) {
  const float4 c = *reinterpret_cast<const float4*>(row);
  const float4 a = *reinterpret_cast<const float4*>(row + 4);
  w.a1 = c.x, w.a0 = c.y, w.b = c.z;
  w.al[0] = a.x, w.al[1] = a.y, w.al[2] = a.z, w.al[3] = a.w;
}
__device__ __forceinline__ void load_row(const double* row, Row<double>& w) {
  const double2 c = *reinterpret_cast<const double2*>(row);
  const double2 p = *reinterpret_cast<const double2*>(row + 4);
  const double2 q = *reinterpret_cast<const double2*>(row + 6);
  w.a1 = c.x, w.a0 = c.y, w.b = row[2];
  w.al[0] = p.x, w.al[1] = p.y, w.al[2] = q.x, w.al[3] = q.y;
}

// Row l of the table: the coefficients taking d^l to d^{l+1} and the alms
// at l times the norm and 2^-60 (zeros past lmax).
template <typename T>
__device__ __forceinline__ void fill_row(T* row, int l, int j0, int m, int s,
                                         int lmax, const T* ap, const T* am,
                                         size_t off, int nm) {
  coef_row<T>(l + 1, j0, m, s, lmax, &row[0], &row[1], &row[2]);
  T* al = row + 4;
  if (l <= lmax) {
    const T norm = norm_of<T>(l);
    const T inv = Arith<T>::inv_scale();
    const size_t o = off + size_t(l) * nm * 2;
    al[0] = ap[o] * norm * inv;
    al[1] = ap[o + 1] * norm * inv;
    al[2] = am[o] * norm * inv;
    al[3] = am[o + 1] * norm * inv;
  } else {
    al[0] = al[1] = al[2] = al[3] = T(0);
  }
}

// One multipole for every ring of the thread: add its terms and step the
// two recurrences.  ``gn`` takes the terms of every l (the northern sums),
// ``par`` those whose sign is (-1)^l, for this l's parity.
template <typename T, Path P, bool kComp>
__device__ __forceinline__ void pair_step(const T* __restrict__ row,
                                          PairRing<T> (&rs)[kRings],
                                          T (&gn)[kRings][4],
                                          T (&par)[kRings][4]) {
  Row<T> w;
  load_row(row, w);
#pragma unroll
  for (int r = 0; r < kRings; ++r) {
    PairRing<T>& q = rs[r];
    if (P != Path::kDead) {
      const T dp_ = kComp ? Arith<T>::add(q.dc, q.dcl) : q.dc;
      const T dm_ = kComp ? Arith<T>::add(q.dcm, q.dcml) : q.dcm;
      const T lp = P == Path::kSteady ? dp_ : dp_ * emit_scaled<T>(q.k);
      const T lm = P == Path::kSteady ? dm_ : dm_ * emit_scaled<T>(q.km);
      gn[r][0] = madd(w.al[0], lp, gn[r][0]);
      gn[r][1] = madd(w.al[1], lp, gn[r][1]);
      par[r][0] = madd(w.al[0], lm, par[r][0]);
      par[r][1] = madd(w.al[1], lm, par[r][1]);
      gn[r][2] = madd(w.al[2], lm, gn[r][2]);
      gn[r][3] = madd(w.al[3], lm, gn[r][3]);
      par[r][2] = madd(w.al[2], lp, par[r][2]);
      par[r][3] = madd(w.al[3], lp, par[r][3]);
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

template <typename T, Path P, bool kComp>
__device__ __forceinline__ void pair_sub(const T* __restrict__ rows,
                                         PairRing<T> (&rs)[kRings],
                                         T (&gn)[kRings][4],
                                         T (&e0)[kRings][4],
                                         T (&e1)[kRings][4]) {
#pragma unroll
  for (int t = 0; t < kSub; t += 2) {
    pair_step<T, P, kComp>(rows + t * NR, rs, gn, e0);
    pair_step<T, P, kComp>(rows + (t + 1) * NR, rs, gn, e1);
  }
  if (P == Path::kDead) {
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
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

// xr: the rings' r = x_lo / x_hi, read only by the comp instantiation.
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
  static_assert(kSub % 2 == 0 && LC % kSub == 0,
                "sub-chunks keep the parity of l and tile the chunk");
  static_assert(!kComp || sizeof(T) == 4, "comp is a float32 mode");

  __shared__ __align__(16) T tab[2][LC][NR];

  const int mc = blockIdx.x;  // the column: this order's place in the block
  const int m = m0 + mc;      // the order
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = max(m, s);
  const int ntiles = (nhalf + kTile - 1) / kTile;
  const size_t out_col = (size_t(b) * nhalf * nm + mc) * 2;

  if (j0 > lmax) {  // an order above lmax: zeros
    for (int ring = tid; ring < nhalf; ring += kThreads) {
      const size_t off = out_col + size_t(ring) * nm * 2;
      store2(gnp + off, T(0), T(0));
      store2(gsp + off, T(0), T(0));
      store2(gnm + off, T(0), T(0));
      store2(gsm + off, T(0), T(0));
    }
    return;
  }

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

  fill_row<T>(&tab[0][tid][0], j0 + tid, j0, m, s, lmax, ap, am, alm_col, nm);
  __syncthreads();

  int g = 0;  // running chunk count: selects the double buffers
  for (int tile = 0; tile < ntiles; ++tile) {
    PairRing<T> rs[kRings];
    T gn[kRings][4], e0[kRings][4], e1[kRings][4];
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + (warp * kRings + r) * 32 + lane;
      PairRing<T>& q = rs[r];
      q.dp = T(0);
      q.dpm = T(0);
      if (kComp) q.r = q.dpl = q.dcl = q.dpml = q.dcml = T(0);
#pragma unroll
      for (int c = 0; c < 4; ++c) gn[r][c] = e0[r][c] = e1[r][c] = T(0);
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
      fill_row<T>(&tab[buf ^ 1][tid][0], j0 + cn * LC + tid, j0, m, s, lmax,
                  ap, am, alm_col, nm);
      // rows past lmax are zeros, so the count rounds up to a sub-chunk
      const int n = min(LC, lmax - j0 - c * LC + 1);
      for (int t = 0; t < n; t += kSub) {
        bool steady = true, dead = true;
#pragma unroll
        for (int r = 0; r < kRings; ++r) {
          steady = steady && sht_paths::is_steady(rs[r].k) &&
                   sht_paths::is_steady(rs[r].km);
          dead = dead && sht_paths::is_dead(rs[r].k) &&
                 sht_paths::is_dead(rs[r].km);
        }
        const T* rows = &tab[buf][t][0];
        const Path path = sht_paths::warp_path(steady, dead);
        tally.add(path);
        if (path == Path::kSteady) {
          pair_sub<T, Path::kSteady, kComp>(rows, rs, gn, e0, e1);
        } else if (path == Path::kDead) {
          pair_sub<T, Path::kDead, kComp>(rows, rs, gn, e0, e1);
        } else {
          pair_sub<T, Path::kFull, kComp>(rows, rs, gn, e0, e1);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + (warp * kRings + r) * 32 + lane;
      if (ring >= nhalf) continue;
      const size_t off = out_col + size_t(ring) * nm * 2;
      store2(gnp + off, gn[r][0], gn[r][1]);
      store2(gsp + off, gsign * (e0[r][0] - e1[r][0]),
             gsign * (e0[r][1] - e1[r][1]));
      store2(gnm + off, gn[r][2], gn[r][3]);
      store2(gsm + off, gsign * (e0[r][2] - e1[r][2]),
             gsign * (e0[r][3] - e1[r][3]));
    }
  }
  tally.flush(counts, lane);
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

}  // namespace

extern "C" {

int heracles_synthesis_pair_f32(const void* alm_p, const void* alm_m,
                                const void* x, const void* logch,
                                const void* logsh, const void* seed,
                                void* gnp, void* gsp, void* gnm, void* gsm,
                                int batch, int nhalf, int nm, int lmax,
                                int spin, int m0, void* stream) {
  return launch<float, false, false>(alm_p, alm_m, x, nullptr, logch, logsh,
                                     seed, gnp, gsp, gnm, gsm, batch, nhalf,
                                     nm, lmax, spin, m0, nullptr, stream);
}

int heracles_synthesis_pair_f64(const void* alm_p, const void* alm_m,
                                const void* x, const void* logch,
                                const void* logsh, const void* seed,
                                void* gnp, void* gsp, void* gnm, void* gsm,
                                int batch, int nhalf, int nm, int lmax,
                                int spin, int m0, void* stream) {
  return launch<double, false, false>(alm_p, alm_m, x, nullptr, logch, logsh,
                                      seed, gnp, gsp, gnm, gsm, batch, nhalf,
                                      nm, lmax, spin, m0, nullptr, stream);
}

// The compensated float32 launch: xr holds each ring's r = x_lo / x_hi.
int heracles_synthesis_pair_comp_f32(const void* alm_p, const void* alm_m,
                                     const void* x, const void* xr,
                                     const void* logch, const void* logsh,
                                     const void* seed, void* gnp, void* gsp,
                                     void* gnm, void* gsm, int batch,
                                     int nhalf, int nm, int lmax, int spin,
                                     int m0, void* stream) {
  return launch<float, true, false>(alm_p, alm_m, x, xr, logch, logsh, seed,
                                    gnp, gsp, gnm, gsm, batch, nhalf, nm, lmax,
                                    spin, m0, nullptr, stream);
}

// The float32 launch with ``counts`` (3 x uint64, zeroed by the caller)
// taking the warps' sub-chunks on the steady, dead and full paths.
int heracles_synthesis_pair_paths_f32(const void* alm_p, const void* alm_m,
                                      const void* x, const void* logch,
                                      const void* logsh, const void* seed,
                                      void* gnp, void* gsp, void* gnm,
                                      void* gsm, void* counts, int batch,
                                      int nhalf, int nm, int lmax, int spin,
                                      int m0, void* stream) {
  return launch<float, false, true>(alm_p, alm_m, x, nullptr, logch, logsh,
                                    seed, gnp, gsp, gnm, gsm, batch, nhalf, nm,
                                    lmax, spin, m0, counts, stream);
}

// The compensated float32 launch with the path counts.
int heracles_synthesis_pair_comp_paths_f32(
    const void* alm_p, const void* alm_m, const void* x, const void* xr,
    const void* logch, const void* logsh, const void* seed, void* gnp,
    void* gsp, void* gnm, void* gsm, void* counts, int batch, int nhalf,
    int nm, int lmax, int spin, int m0, void* stream) {
  return launch<float, true, true>(alm_p, alm_m, x, xr, logch, logsh, seed,
                                   gnp, gsp, gnm, gsm, batch, nhalf, nm, lmax,
                                   spin, m0, counts, stream);
}

// Resident blocks per SM of the pair synthesis (its shared memory does not
// depend on lmax), written to *blocks; variant 0 is the float32 kernel, 1
// the float64 one, 2 the compensated float32 one.  Returns the CUDA error
// code.
int heracles_synthesis_pair_blocks_per_sm(int variant, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (variant == 1) {
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, pair_synthesis_kernel<double, false, false>, kThreads, 0));
  }
  if (variant == 2) {
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, pair_synthesis_kernel<float, true, false>, kThreads, 0));
  }
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, pair_synthesis_kernel<float, false, false>, kThreads, 0));
}

}  // extern "C"
