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
// lmax 3000 has ~3.69e10 (ring, l, m) triples; each costs 5 operations of
// recurrence (unfused, so that it rounds as the plain version does), 1
// emit multiply and 2 FMAs, while the alms are read once (48 MB) and G
// written once (0.4 GB in float32).
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
//     alm column, times the norm, stream through shared memory in
//     chunks of LC multipoles, double-buffered: while the block works on
//     one chunk each thread fills one row of the next, so the table's size
//     does not grow with lmax; every thread reads the same row at each
//     step (a broadcast, no bank conflicts);
//   * the seed is evaluated in float64 on the card in both instantiations;
//   * each (ring, m) output is written once, with no atomics, so results
//     repeat bit for bit.
//
// C interface (loaded with ctypes): heracles_synthesis_spin0_{f32,f64}
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

constexpr int NA = 2;       // (re, im) of the alm
constexpr int NR = 3 + NA;  // a row: a1, a0, b, then the alm

template <typename T>
size_t smem_bytes() {
  return size_t(2) * LC * NR * sizeof(T);
}

template <typename T>
struct Ring {
  T x, dp, dc;  // cos(theta); d^{l-1}, d^l
  int k;        // the 2^60 exponent
};

// Row l of the table: the coefficients taking d^l to d^{l+1} and the alm
// at l times the norm (zeros past lmax).
template <typename T>
__device__ __forceinline__ void fill_row(T* row, int l, int m, int lmax,
                                         const T* a0, size_t off, int nm) {
  coef_row<T>(l + 1, m, m, 0, lmax, &row[0], &row[1], &row[2]);
  T* al = row + 3;
  if (l <= lmax) {
    const T norm = norm_of<T>(l);
    const size_t o = off + size_t(l) * nm * 2;
    al[0] = a0[o] * norm;
    al[1] = a0[o + 1] * norm;
  } else {
    al[0] = al[1] = T(0);
  }
}

// One multipole for every ring of the thread: add its terms to ``par``,
// the sums of this l's parity, and step the recurrence.
template <typename T>
__device__ __forceinline__ void synth_step(const T* __restrict__ row,
                                           Ring<T> (&rs)[kRings],
                                           T (&par)[kRings][NA]) {
  const T ca1 = row[0], ca0 = row[1], cb = row[2];
  const T* al = row + 3;
#pragma unroll
  for (int r = 0; r < kRings; ++r) {
    Ring<T>& q = rs[r];
    const T a1x = Arith<T>::mul(ca1, q.x);
    const T lp = q.dc * emit_of<T>(q.k);
    par[r][0] += al[0] * lp;
    par[r][1] += al[1] * lp;
    advance<T>(step<T>(a1x, ca0, cb, q.dc, q.dp), q.dp, q.dc, q.k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    synthesis_kernel(const T* __restrict__ a0, const T* __restrict__ x,
                     const double* __restrict__ logch,
                     const double* __restrict__ logsh,
                     const double* __restrict__ seed, T* __restrict__ gn0,
                     T* __restrict__ gs0, int nhalf, int nm, int lmax) {
  static_assert(LC % 2 == 0, "chunks must keep the parity of l");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);  // [2][LC][NR]

  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j0 = m;
  const int ntiles = (nhalf + kTile - 1) / kTile;
  const size_t out_col = (size_t(b) * nhalf * nm + m) * 2;

  if (j0 > lmax) {  // an order above lmax: zeros
    for (int ring = tid; ring < nhalf; ring += kThreads) {
      const size_t off = out_col + size_t(ring) * nm * 2;
      gn0[off] = gn0[off + 1] = gs0[off] = gs0[off + 1] = T(0);
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

  fill_row<T>(tab + NR * tid, j0 + tid, m, lmax, a0, alm_col, nm);
  __syncthreads();

  int g = 0;  // running chunk count: selects the double buffers
  for (int tile = 0; tile < ntiles; ++tile) {
    Ring<T> rs[kRings];
    T e0[kRings][NA], e1[kRings][NA];
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + r * kThreads + tid;
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
      fill_row<T>(tab + ((buf ^ 1) * LC + tid) * NR, j0 + cn * LC + tid, m,
                  lmax, a0, alm_col, nm);
      const T* cur = tab + buf * LC * NR;
      // rows past lmax are zeros, so an odd count rounds up to a pair
      const int n = min(LC, lmax - j0 - c * LC + 1);
      for (int t = 0; t < n; t += 2) {
        synth_step<T>(cur + t * NR, rs, e0);
        synth_step<T>(cur + (t + 1) * NR, rs, e1);
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      const int ring = tile * kTile + r * kThreads + tid;
      if (ring >= nhalf) continue;
      const size_t off = out_col + size_t(ring) * nm * 2;
      gn0[off] = e0[r][0] + e1[r][0];
      gn0[off + 1] = e0[r][1] + e1[r][1];
      gs0[off] = gsign * (e0[r][0] - e1[r][0]);
      gs0[off + 1] = gsign * (e0[r][1] - e1[r][1]);
    }
  }
}

template <typename T>
int launch(const void* a0, const void* x, const void* logch,
           const void* logsh, const void* seed, void* gn0, void* gs0,
           int batch, int nhalf, int nm, int lmax, void* stream) {
  const size_t smem = smem_bytes<T>();
  auto kern = synthesis_kernel<T>;
  if (batch == 0 || nm == 0 || nhalf == 0) return int(cudaSuccess);
  kern<<<dim3(nm, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a0), static_cast<const T*>(x),
      static_cast<const double*>(logch), static_cast<const double*>(logsh),
      static_cast<const double*>(seed), static_cast<T*>(gn0),
      static_cast<T*>(gs0), nhalf, nm, lmax);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_synthesis_spin0_f32(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 void* stream) {
  return launch<float>(alm, x, logch, logsh, seed, gn, gs, batch, nhalf, nm,
                       lmax, stream);
}

int heracles_synthesis_spin0_f64(const void* alm, const void* x,
                                 const void* logch, const void* logsh,
                                 const void* seed, void* gn, void* gs,
                                 int batch, int nhalf, int nm, int lmax,
                                 void* stream) {
  return launch<double>(alm, x, logch, logsh, seed, gn, gs, batch, nhalf, nm,
                        lmax, stream);
}

}  // extern "C"
