// Folded Wigner-d synthesis kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of heracles_tpu/ops/pallas_sht.py:
//   * synthesis_kernel<T, false> <- _synth_kernel (:1704), behind
//     synthesis_spin0_folded (:2043);
//   * synthesis_kernel<T, true>  <- _synth_pair_kernel (:2161) and its
//     l-chunked twin _synth_pair_kernel_lc (:2332, the same function with
//     another VMEM tiling), behind synthesis_pair_folded (:2829).
// The compensated and double-single variants (_comp :1828, :2501; _dd
// :1933, :2660) map to the double instantiation.
//
// What they compute, per batch element b, order m and northern ring r,
// summed over l = j0..lmax, with a the alm times sqrt((2l+1)/4pi) and
// lam (spin 0), lp / lm (the +-s columns of the spin pair) the functions
// of wigner_recurrence.cuh at x_r = cos(theta_r):
//   spin 0: GN = sum a lam            GS = (-1)^m sum (-1)^l a lam
//   pair:   GNp = sum a_p lp          GSp = (-1)^m sum (-1)^l a_p lm
//           GNm = sum a_m lm          GSm = (-1)^m sum (-1)^l a_m lp
// GS is the mirrored southern ring's spectrum (lam(pi - t) = (-1)^{l+m}
// times the partner column's lam(t)).
//
// What bounds them: FP32 (or FP64) vector issue.  One map at nside 4096,
// lmax 3000 has ~3.69e10 (ring, l, m) triples; each costs 5 operations of
// recurrence (unfused, so that it rounds as the plain version does), 1
// emit multiply per column and 2 (spin 0) or 8 (pair) FMAs, while the
// alms are read once (48 MB) and G written once (0.4 GB per spin-0 map in
// float32).
//
// Design:
//   * one block per (order m, batch element); blockIdx.x = m, so the
//     longest columns (low m) start first;
//   * each thread owns kRings rings of a tile of kTile; the block walks the
//     northern rings tile by tile, and for each tile every thread steps l
//     from j0 to lmax with its rings' recurrence state and sums in
//     registers: the sum over l is the recurrence's own loop, so no
//     reduction across threads is needed;
//   * the terms of even and odd l are summed apart (the southern sums'
//     (-1)^l), and GN = E + O, GS = (-1)^m (E - O) are formed once per
//     output, so a term costs its FMAs and no sign;
//   * the recurrence coefficients (float64, rounded to T) and the order's
//     alm column(s), times the norm, stream through shared memory in
//     chunks of LC multipoles, double-buffered: while the block works on
//     one chunk each thread fills one row of the next, so the table's size
//     does not grow with lmax; every thread reads the same row at each
//     step (a broadcast, no bank conflicts);
//   * the seed is evaluated in float64 on the card in both instantiations;
//   * each (ring, m) output is written once, with no atomics, so results
//     repeat bit for bit.
//
// C interface (loaded with ctypes): heracles_synthesis_{spin0,pair}_{f32,f64}
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "wigner_recurrence.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRings = 4;                 // rings per thread
constexpr int kTile = kThreads * kRings;  // rings per tile
constexpr int LC = kThreads;              // multipoles per chunk: a row each

using wigner::advance;
using wigner::Arith;
using wigner::coef_row;
using wigner::emit_of;
using wigner::kNoSeed;
using wigner::norm_of;
using wigner::seed_of;
using wigner::step;

template <bool kPair>
struct SynthShape {
  static constexpr int NA = kPair ? 4 : 2;  // (re, im) of one or two alms
  static constexpr int NR = 3 + NA;         // a row: a1, a0, b, then the alms
};

template <typename T, bool kPair>
size_t smem_bytes() {
  return size_t(2) * LC * SynthShape<kPair>::NR * sizeof(T);
}

template <typename T>
struct Ring {
  T x, dp, dc, dpm, dcm;  // cos(theta); the +s and -s columns' d^{l-1}, d^l
  int k, km;              // their 2^60 exponents
};

// Row l of the table: the coefficients taking d^l to d^{l+1} and the alms
// at l times the norm (zeros past lmax).
template <typename T, bool kPair>
__device__ __forceinline__ void fill_row(T* row, int l, int j0, int m, int s,
                                         int lmax, const T* a0, const T* a1,
                                         size_t off, int nm) {
  coef_row<T>(l + 1, j0, m, s, lmax, &row[0], &row[1], &row[2]);
  T* al = row + 3;
  if (l <= lmax) {
    const T norm = norm_of<T>(l);
    const size_t o = off + size_t(l) * nm * 2;
    al[0] = a0[o] * norm;
    al[1] = a0[o + 1] * norm;
    if (kPair) {
      al[2] = a1[o] * norm;
      al[3] = a1[o + 1] * norm;
    }
  } else {
#pragma unroll
    for (int c = 0; c < SynthShape<kPair>::NA; ++c) al[c] = T(0);
  }
}

// One multipole for every ring of the thread: add its terms and step the
// recurrence.  ``gn`` takes the terms of every l (the pair's northern
// sums), ``par`` those whose sign is (-1)^l, for this l's parity.
template <typename T, bool kPair, int NA>
__device__ __forceinline__ void synth_step(const T* __restrict__ row,
                                           Ring<T> (&rs)[kRings],
                                           T (&gn)[kRings][NA],
                                           T (&par)[kRings][NA]) {
  const T ca1 = row[0], ca0 = row[1], cb = row[2];
  const T* al = row + 3;
#pragma unroll
  for (int r = 0; r < kRings; ++r) {
    Ring<T>& q = rs[r];
    const T a1x = Arith<T>::mul(ca1, q.x);
    const T lp = q.dc * emit_of<T>(q.k);
    if constexpr (!kPair) {
      par[r][0] += al[0] * lp;
      par[r][1] += al[1] * lp;
      advance<T>(step<T>(a1x, ca0, cb, q.dc, q.dp), q.dp, q.dc, q.k);
    } else {
      const T lm = q.dcm * emit_of<T>(q.km);
      gn[r][0] += al[0] * lp;
      gn[r][1] += al[1] * lp;
      par[r][0] += al[0] * lm;
      par[r][1] += al[1] * lm;
      gn[r][2] += al[2] * lm;
      gn[r][3] += al[3] * lm;
      par[r][2] += al[2] * lp;
      par[r][3] += al[3] * lp;
      // the -s column's a0 is minus the +s column's
      const T dnp = step<T>(a1x, ca0, cb, q.dc, q.dp);
      const T dnm = step<T>(a1x, -ca0, cb, q.dcm, q.dpm);
      advance<T>(dnp, q.dp, q.dc, q.k);
      advance<T>(dnm, q.dpm, q.dcm, q.km);
    }
  }
}

template <typename T, bool kPair>
__global__ void __launch_bounds__(kThreads)
    synthesis_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
                     const T* __restrict__ x, const double* __restrict__ logch,
                     const double* __restrict__ logsh,
                     const double* __restrict__ seed, T* __restrict__ gn0,
                     T* __restrict__ gs0, T* __restrict__ gn1,
                     T* __restrict__ gs1, int nhalf, int nm, int lmax,
                     int spin) {
  constexpr int NA = SynthShape<kPair>::NA;
  constexpr int NR = SynthShape<kPair>::NR;
  static_assert(LC % 2 == 0, "chunks must keep the parity of l");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);  // [2][LC][NR]

  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int s = kPair ? spin : 0;
  const int j0 = max(m, s);
  const int ntiles = (nhalf + kTile - 1) / kTile;
  const size_t out_col = (size_t(b) * nhalf * nm + m) * 2;

  if (j0 > lmax) {  // an order above lmax: zeros
    for (int ring = tid; ring < nhalf; ring += kThreads) {
      const size_t off = out_col + size_t(ring) * nm * 2;
      gn0[off] = gn0[off + 1] = gs0[off] = gs0[off + 1] = T(0);
      if (kPair) gn1[off] = gn1[off + 1] = gs1[off] = gs1[off + 1] = T(0);
    }
    return;
  }

  const size_t alm_col = (size_t(b) * (lmax + 1) * nm + m) * 2;
  const int nchunks = (lmax - j0 + LC) / LC;
  const double logc_p = seed[m];
  const double sign_p = seed[nm + m];
  const double logc_m = kPair ? seed[2 * nm + m] : 0.0;
  const double sign_m = kPair ? seed[3 * nm + m] : 0.0;
  // seed exponents of cos(t/2) and sin(t/2): (m+s, |m-s|) for +s and
  // swapped for -s (spin 0: both m)
  const double pc = double(m + s);
  const double ps = fabs(double(m - s));
  // GS = (-1)^m sum (-1)^l (...) = (-1)^(m + j0) (E0 - E1), with E0 the
  // sum over l of j0's parity and E1 over the other
  const T gsign = ((m + j0) & 1) ? T(-1) : T(1);

  fill_row<T, kPair>(tab + NR * tid, j0 + tid, j0, m, s, lmax, a0, a1,
                     alm_col, nm);
  __syncthreads();

  int g = 0;  // running chunk count: selects the double buffers
  for (int tile = 0; tile < ntiles; ++tile) {
    Ring<T> rs[kRings];
    T gn[kRings][NA], e0[kRings][NA], e1[kRings][NA];
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + r * kThreads + tid;
      Ring<T>& q = rs[r];
      q.dp = T(0);
      q.dpm = T(0);
#pragma unroll
      for (int c = 0; c < NA; ++c) gn[r][c] = e0[r][c] = e1[r][c] = T(0);
      if (ring < nhalf) {
        const double lch = logch[ring], lsh = logsh[ring];
        q.x = x[ring];
        seed_of<T>(logc_p, sign_p, pc, ps, lch, lsh, q.dc, q.k);
        if (kPair) seed_of<T>(logc_m, sign_m, ps, pc, lch, lsh, q.dcm, q.km);
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
      fill_row<T, kPair>(tab + ((buf ^ 1) * LC + tid) * NR, j0 + cn * LC + tid,
                         j0, m, s, lmax, a0, a1, alm_col, nm);
      const T* cur = tab + buf * LC * NR;
      // rows past lmax are zeros, so an odd count rounds up to a pair
      const int n = min(LC, lmax - j0 - c * LC + 1);
      for (int t = 0; t < n; t += 2) {
        synth_step<T, kPair, NA>(cur + t * NR, rs, gn, e0);
        synth_step<T, kPair, NA>(cur + (t + 1) * NR, rs, gn, e1);
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + r * kThreads + tid;
      if (ring >= nhalf) continue;
      const size_t off = out_col + size_t(ring) * nm * 2;
      if (!kPair) {
        gn0[off] = e0[r][0] + e1[r][0];
        gn0[off + 1] = e0[r][1] + e1[r][1];
        gs0[off] = gsign * (e0[r][0] - e1[r][0]);
        gs0[off + 1] = gsign * (e0[r][1] - e1[r][1]);
      } else {
        gn0[off] = gn[r][0];
        gn0[off + 1] = gn[r][1];
        gs0[off] = gsign * (e0[r][0] - e1[r][0]);
        gs0[off + 1] = gsign * (e0[r][1] - e1[r][1]);
        gn1[off] = gn[r][2];
        gn1[off + 1] = gn[r][3];
        gs1[off] = gsign * (e0[r][2] - e1[r][2]);
        gs1[off + 1] = gsign * (e0[r][3] - e1[r][3]);
      }
    }
  }
}

template <typename T, bool kPair>
int launch(const void* a0, const void* a1, const void* x, const void* logch,
           const void* logsh, const void* seed, void* gn0, void* gs0,
           void* gn1, void* gs1, int batch, int nhalf, int nm, int lmax,
           int spin, void* stream) {
  const size_t smem = smem_bytes<T, kPair>();
  auto kern = synthesis_kernel<T, kPair>;
  if (batch == 0 || nm == 0 || nhalf == 0) return int(cudaSuccess);
  kern<<<dim3(nm, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a0), static_cast<const T*>(a1),
      static_cast<const T*>(x), static_cast<const double*>(logch),
      static_cast<const double*>(logsh), static_cast<const double*>(seed),
      static_cast<T*>(gn0), static_cast<T*>(gs0), static_cast<T*>(gn1),
      static_cast<T*>(gs1), nhalf, nm, lmax, spin);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_synthesis_spin0_f32(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 void* stream) {
  return launch<float, false>(alm, nullptr, x, logch, logsh, seed, gn, gs,
                              nullptr, nullptr, batch, nhalf, nm, lmax, 0,
                              stream);
}

int heracles_synthesis_spin0_f64(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 void* stream) {
  return launch<double, false>(alm, nullptr, x, logch, logsh, seed, gn, gs,
                               nullptr, nullptr, batch, nhalf, nm, lmax, 0,
                               stream);
}

int heracles_synthesis_pair_f32(const void* alm_p, const void* alm_m,
                                const void* x, const void* logch,
                                const void* logsh, const void* seed,
                                void* gnp, void* gsp, void* gnm, void* gsm,
                                int batch, int nhalf, int nm, int lmax,
                                int spin, void* stream) {
  return launch<float, true>(alm_p, alm_m, x, logch, logsh, seed, gnp, gsp,
                             gnm, gsm, batch, nhalf, nm, lmax, spin, stream);
}

int heracles_synthesis_pair_f64(const void* alm_p, const void* alm_m,
                                const void* x, const void* logch,
                                const void* logsh, const void* seed,
                                void* gnp, void* gsp, void* gnm, void* gsm,
                                int batch, int nhalf, int nm, int lmax,
                                int spin, void* stream) {
  return launch<double, true>(alm_p, alm_m, x, logch, logsh, seed, gnp, gsp,
                              gnm, gsm, batch, nhalf, nm, lmax, spin, stream);
}

}  // extern "C"
