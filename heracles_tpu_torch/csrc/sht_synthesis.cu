// Folded spin-0 Wigner-d synthesis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _synth_kernel of
// heracles_tpu/ops/pallas_sht.py (:1704), behind synthesis_spin0_folded
// (:2043).  The compensated and double-single variants (_comp :1828, _dd
// :1933) map to the double instantiation.  (The spin pair,
// _synth_pair_kernel :2161, is sht_synthesis_pair.cu.)
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
//   * one block of 128 threads per (order m, batch element), blockIdx.x = m
//     so the longest columns start first; each thread owns kRings = 4 rings
//     of a tile of 512 and steps l from j0 = m to lmax with its rings'
//     recurrence and 4 sums each in registers: the sum over l is the
//     recurrence's own loop, so no reduction across threads is needed;
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
//     as the plain version does.
//
// C interface (loaded with ctypes): heracles_synthesis_spin0_{f32,f64}
// launch on the given stream and return cudaGetLastError();
// heracles_synthesis_spin0_blocks_per_sm gives the resident blocks per SM;
// heracles_synthesis_spin0_paths_f32 is a diagnostic launch that also
// counts the warps' sub-chunks on each path (steady, dead, full).

#include <cuda_runtime.h>
#include <stddef.h>

#include "sht_paths.cuh"
#include "wigner_recurrence.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRings = 4;                 // rings per thread
constexpr int kTile = kThreads * kRings;  // rings per tile
constexpr int LC = kThreads;              // multipoles per chunk: a row each
constexpr int NA = 2;                     // (re, im) of the alm
constexpr int NR = 4;                     // a row: a1, b, re, im
constexpr int kSub = sht_paths::kSub;     // multipoles per path decision

using sht_paths::emit_scaled;
using sht_paths::madd;
using sht_paths::Path;
using sht_paths::PathCounts;
using sht_paths::rescale_deferred;
using wigner::advance;
using wigner::Arith;
using wigner::coef_row;
using wigner::kNoSeed;
using wigner::norm_of;
using wigner::seed_of;
using wigner::step_a0_zero;

template <typename T>
struct Ring {
  T x, dp, dc;  // cos(theta); d^{l-1}, d^l
  int k;        // the 2^60 exponent
};

template <typename T>
struct Row {
  T a1, b;
  T al[NA];  // (re, im) of the alm, times the norm and 2^-60
};

__device__ __forceinline__ void load_row(const float* row, Row<float>& w) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  w.a1 = v.x, w.b = v.y;
  w.al[0] = v.z, w.al[1] = v.w;
}
__device__ __forceinline__ void load_row(const double* row, Row<double>& w) {
  const double2 c = *reinterpret_cast<const double2*>(row);
  const double2 a = *reinterpret_cast<const double2*>(row + 2);
  w.a1 = c.x, w.b = c.y;
  w.al[0] = a.x, w.al[1] = a.y;
}

// Row l of the table: the coefficients taking d^l to d^{l+1} (a0 is -0.0
// at spin 0 and left out) and the alm at l times the norm and 2^-60 (zeros
// past lmax).
template <typename T>
__device__ __forceinline__ void fill_row(T* row, int l, int m, int lmax,
                                         const T* a0, size_t off, int nm) {
  T a0_unused;
  coef_row<T>(l + 1, m, m, 0, lmax, &row[0], &a0_unused, &row[1]);
  T* al = row + 2;
  if (l <= lmax) {
    const T norm = norm_of<T>(l);
    const T inv = Arith<T>::inv_scale();
    const size_t o = off + size_t(l) * nm * 2;
    al[0] = a0[o] * norm * inv;
    al[1] = a0[o + 1] * norm * inv;
  } else {
    al[0] = al[1] = T(0);
  }
}

// One multipole for every ring of the thread: add its terms to ``par``,
// the sums of this l's parity, and step the recurrence.
template <typename T, Path P>
__device__ __forceinline__ void synth_step(const T* __restrict__ row,
                                           Ring<T> (&rs)[kRings],
                                           T (&par)[kRings][NA]) {
  Row<T> w;
  load_row(row, w);
#pragma unroll
  for (int r = 0; r < kRings; ++r) {
    Ring<T>& q = rs[r];
    if (P != Path::kDead) {
      const T lp = P == Path::kSteady ? q.dc : q.dc * emit_scaled<T>(q.k);
      par[r][0] = madd(w.al[0], lp, par[r][0]);
      par[r][1] = madd(w.al[1], lp, par[r][1]);
    }
    const T a1x = Arith<T>::mul(w.a1, q.x);
    const T dn = step_a0_zero<T>(a1x, w.b, q.dc, q.dp);
    if (P == Path::kFull) {
      advance<T>(dn, q.dp, q.dc, q.k);
    } else {  // steady: no rescale is due; dead: it waits for synth_sub
      q.dp = q.dc;
      q.dc = dn;
    }
  }
}

// kSub multipoles from ``rows`` on; the first has the parity of j0.
template <typename T, Path P>
__device__ __forceinline__ void synth_sub(const T* __restrict__ rows,
                                          Ring<T> (&rs)[kRings],
                                          T (&e0)[kRings][NA],
                                          T (&e1)[kRings][NA]) {
#pragma unroll
  for (int t = 0; t < kSub; t += 2) {
    synth_step<T, P>(rows + t * NR, rs, e0);
    synth_step<T, P>(rows + (t + 1) * NR, rs, e1);
  }
  if (P == Path::kDead) {
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      rescale_deferred<T>(rs[r].dp, rs[r].dc, rs[r].k);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float re, float im) {
  *reinterpret_cast<float2*>(p) = make_float2(re, im);
}
__device__ __forceinline__ void store2(double* p, double re, double im) {
  *reinterpret_cast<double2*>(p) = make_double2(re, im);
}

template <typename T, bool kCount>
__global__ void __launch_bounds__(kThreads)
    synthesis_kernel(const T* __restrict__ a0, const T* __restrict__ x,
                     const double* __restrict__ logch,
                     const double* __restrict__ logsh,
                     const double* __restrict__ seed, T* __restrict__ gn0,
                     T* __restrict__ gs0, int nhalf, int nm, int lmax,
                     unsigned long long* __restrict__ counts) {
  static_assert(kSub % 2 == 0 && LC % kSub == 0,
                "sub-chunks keep the parity of l and tile the chunk");

  __shared__ __align__(16) T tab[2][LC][NR];

  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = m;
  const int ntiles = (nhalf + kTile - 1) / kTile;
  const size_t out_col = (size_t(b) * nhalf * nm + m) * 2;

  if (j0 > lmax) {  // an order above lmax: zeros
    for (int ring = tid; ring < nhalf; ring += kThreads) {
      const size_t off = out_col + size_t(ring) * nm * 2;
      store2(gn0 + off, T(0), T(0));
      store2(gs0 + off, T(0), T(0));
    }
    return;
  }

  const size_t alm_col = (size_t(b) * (lmax + 1) * nm + m) * 2;
  const int nchunks = (lmax - j0 + LC) / LC;
  const double logc_p = seed[m];
  const double sign_p = seed[nm + m];
  // seed exponents of cos(t/2) and sin(t/2): both m
  const double pc = double(m);
  const double ps = double(m);
  // GS = (-1)^m sum (-1)^l (...) = (-1)^(m + j0) (E0 - E1), with E0 the
  // sum over l of j0's parity and E1 over the other
  const T gsign = ((m + j0) & 1) ? T(-1) : T(1);
  PathCounts<kCount> tally;

  fill_row<T>(&tab[0][tid][0], j0 + tid, m, lmax, a0, alm_col, nm);
  __syncthreads();

  int g = 0;  // running chunk count: selects the double buffers
  for (int tile = 0; tile < ntiles; ++tile) {
    Ring<T> rs[kRings];
    T e0[kRings][NA], e1[kRings][NA];
    bool settled = false;  // the warp has taken the steady path
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + (warp * kRings + r) * 32 + lane;
      Ring<T>& q = rs[r];
      q.dp = T(0);
#pragma unroll
      for (int c = 0; c < NA; ++c) e0[r][c] = e1[r][c] = T(0);
      if (ring < nhalf) {
        const double lch = logch[ring], lsh = logsh[ring];
        q.x = x[ring];
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
      fill_row<T>(&tab[buf ^ 1][tid][0], j0 + cn * LC + tid, m, lmax, a0,
                  alm_col, nm);
      // rows past lmax are zeros, so the count rounds up to a sub-chunk
      const int n = min(LC, lmax - j0 - c * LC + 1);
      for (int t = 0; t < n; t += kSub) {
        Path path = Path::kSteady;
        if (!settled) {
          bool steady = true, dead = true;
#pragma unroll
          for (int r = 0; r < kRings; ++r) {
            steady = steady && sht_paths::is_steady(rs[r].k);
            dead = dead && sht_paths::is_dead(rs[r].k);
          }
          path = sht_paths::warp_path(steady, dead);
          settled = path == Path::kSteady;
        }
        const T* rows = &tab[buf][t][0];
        tally.add(path);
        if (path == Path::kSteady) {
          synth_sub<T, Path::kSteady>(rows, rs, e0, e1);
        } else if (path == Path::kDead) {
          synth_sub<T, Path::kDead>(rows, rs, e0, e1);
        } else {
          synth_sub<T, Path::kFull>(rows, rs, e0, e1);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + (warp * kRings + r) * 32 + lane;
      if (ring >= nhalf) continue;
      const size_t off = out_col + size_t(ring) * nm * 2;
      store2(gn0 + off, e0[r][0] + e1[r][0], e0[r][1] + e1[r][1]);
      store2(gs0 + off, gsign * (e0[r][0] - e1[r][0]),
             gsign * (e0[r][1] - e1[r][1]));
    }
  }
  tally.flush(counts, lane);
}

template <typename T, bool kCount>
int launch(const void* a0, const void* x, const void* logch,
           const void* logsh, const void* seed, void* gn0, void* gs0,
           int batch, int nhalf, int nm, int lmax, void* counts,
           void* stream) {
  if (batch == 0 || nm == 0 || nhalf == 0) return int(cudaSuccess);
  synthesis_kernel<T, kCount>
      <<<dim3(nm, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a0), static_cast<const T*>(x),
          static_cast<const double*>(logch), static_cast<const double*>(logsh),
          static_cast<const double*>(seed), static_cast<T*>(gn0),
          static_cast<T*>(gs0), nhalf, nm, lmax,
          static_cast<unsigned long long*>(counts));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_synthesis_spin0_f32(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 void* stream) {
  return launch<float, false>(alm, x, logch, logsh, seed, gn, gs, batch, nhalf,
                              nm, lmax, nullptr, stream);
}

int heracles_synthesis_spin0_f64(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 void* stream) {
  return launch<double, false>(alm, x, logch, logsh, seed, gn, gs, batch,
                               nhalf, nm, lmax, nullptr, stream);
}

// The float32 launch with ``counts`` (3 x uint64, zeroed by the caller)
// taking the warps' sub-chunks on the steady, dead and full paths.
int heracles_synthesis_spin0_paths_f32(const void* alm, const void* x,
                                       const void* logch, const void* logsh,
                                       const void* seed, void* gn, void* gs,
                                       void* counts, int batch, int nhalf,
                                       int nm, int lmax, void* stream) {
  return launch<float, true>(alm, x, logch, logsh, seed, gn, gs, batch, nhalf,
                             nm, lmax, counts, stream);
}

// Resident blocks per SM of the spin-0 synthesis (its shared memory does
// not depend on lmax), written to *blocks; returns the CUDA error code.
int heracles_synthesis_spin0_blocks_per_sm(int is_double, void* blocks) {
  int* n = static_cast<int*>(blocks);
  return int(is_double
                 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       n, synthesis_kernel<double, false>, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       n, synthesis_kernel<float, false>, kThreads, 0));
}

}  // extern "C"
