// Folded spin-pair Wigner-d analysis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pair_kernel of
// heracles_tpu/ops/pallas_sht.py (:1049), behind analysis_pair_folded
// (:1582).  Per batch element b and order m, for l = j0..lmax:
//   a_p[b,l,m] = sum_r lp_lm(x_r) FNp[b,r,m] + (-1)^l lm_lm(x_r) Sp[b,r,m]
//   a_m[b,l,m] = sum_r lm_lm(x_r) FNm[b,r,m] + (-1)^l lp_lm(x_r) Sm[b,r,m]
// with lp / lm the +s and -s columns of the normalised Wigner-d functions
// of wigner_recurrence.cuh (seeded at j0 = max(m, s), scaled by 2^(60 k),
// emitting at k = 0 or -1).  The (-1)^m sign of the southern rows is
// applied by the caller; the (-1)^l sign here.
//
// What bounds it: FP32 (or FP64) vector issue.  One spin-2 map at nside
// 4096, lmax 3000 has 3.69e10 (ring, l, m) triples; each needs 27 flop
// (two recurrences sharing a1 x, two emit multiplies, 8 FMAs), 14.9 ms at
// the FP32 peak, against 0.9 GB of spectra and alms moved once (0.3 ms).
//
// Design (the synthesis kernels' shape, sht_synthesis.cu):
//   * one block of 128 threads per (order m, batch element), blockIdx.x =
//     m - m0 so the longest columns start first; each thread owns kRings = 4
//     rings of a tile of 512 (lane + 32 r of its warp's 128) and runs
//     their two recurrences from j0 to lmax with F in registers;
//   * the sum over rings needs a reduction across threads, once per chunk
//     of LC = 8 multipoles: a warp butterfly reduce-scatter of the V = 32
//     partial sums (31 shuffles), then the 4 warps' parts through shared
//     memory in a fixed order.  With 4 rings per thread each shuffle
//     serves twice as many triples as with the 2 of the spin-0 kernel, and
//     the float32 kernel fits 128 registers: 4 blocks per SM (a chunk of
//     16, 64 sums, took 168 registers, 3 blocks per SM, and ran slower);
//   * no table that grows with lmax: each chunk's block sum, times the
//     norm, goes straight to its rows of the output, which this block alone
//     owns.  The first ring tile writes them, later tiles add to them: the
//     thread that flushes a row is the same in every tile and loads the
//     row's earlier sum before the chunk's compute, so the read-modify-
//     write needs no atomics, waits on no load, and each output is summed
//     over tiles in a fixed order;
//   * the recurrence coefficients (float64, rounded to T) stream through a
//     double-buffered shared table of 128 rows, one row filled by each
//     thread per 128 multipoles while the block works on the other buffer;
//     each step's row is one broadcast read;
//   * a warp whose rings all sit at k = -1 for both columns (checked at
//     the start of each chunk) runs the chunk without the rescale and
//     with the constant emit factor 2^-60.  A seed below 1 starts at
//     k <= -1 and |d| <= 1, so an emitting ring stays at k = -1: the
//     rescale fires above 2^60, on |d| > 1, which only a value rounded
//     past 1 near theta = 0 at m = s can reach, and rescaling it there
//     changes no emitted value (a power-of-two scale commutes with the
//     recurrence's roundings in the normal range).  Other warps (rings
//     still rising from the poles' underflow) run the full step.  Each
//     warp owns 128 adjacent rings (4 groups of 32), so its rings reach
//     k = -1 close together;
//   * the spectra are held times 2^-60 and the emit factor times 2^60, so
//     the steady step multiplies d itself: the product of the two factors
//     of each FMA is the same exact number as before;
//   * the contraction is 8 explicit FMAs per triple (acc + lp F, then + lm
//     S), not a product-sum plus an add;
//   * the recurrence itself (seed, coefficients, unfused step, rescale) is
//     wigner_recurrence.cuh, shared with the spin-0 analysis and the
//     synthesis kernels, and rounds as the plain version does;
//   * the float32 kernel has a compensated instantiation (kComp), the twin
//     of _pair_kernel_comp (pallas_sht.py:1218): each ring carries r =
//     x_lo / x_hi and a lo stream per column (wigner::step_lo), which
//     shares its column's rescales and adds to it at emission.  It costs
//     14 operations a triple more (two lo steps of 6, two emit adds) and 5
//     registers a ring; kComp = false compiles to the plain kernel.
//
// C interface (loaded with ctypes): heracles_analysis_pair_{f32,f64} and
// heracles_analysis_pair_comp_f32 (with the rings' r after x) launch on
// the given stream and return cudaGetLastError();
// heracles_analysis_pair_blocks_per_sm gives the resident blocks per SM.
// Every launch takes the block of orders m0..m0+nm-1 into its columns
// 0..nm-1 (the seed planes are the block's, indexed by column), so a
// device mesh can give each shard its own block; m0 = 0 is every order
// from 0, and an order above lmax gives a column of zeros.

#include <cuda_runtime.h>
#include <stddef.h>

#include "warp_reduce.cuh"
#include "wigner_recurrence.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRings = 4;                 // rings per thread
constexpr int kTile = kThreads * kRings;  // rings per tile
constexpr int kRows = kThreads;           // coefficient rows: one per thread
constexpr int NC = 4;                     // (re, im) of a_p and a_m
constexpr int LC = 8;                     // multipoles per chunk
constexpr int V = NC * LC;                // register sums per thread

using warp_reduce::reduce_scatter;
using wigner::advance;
using wigner::advance_comp;
using wigner::Arith;
using wigner::coef_row;
using wigner::kNoSeed;
using wigner::norm_of;
using wigner::seed_of;
using wigner::step;
using wigner::step_lo;

// The emit factor times 2^60, for spectra held times 2^-60: 2^60 at k = 0,
// 1 at k = -1, 0 below.  (dc e) (F 2^-60) is the exact product of the
// plain version's dc emit_of(k) and F, both factors being power-of-two
// scalings, so the FMA that takes it rounds as before.
template <typename T>
__device__ __forceinline__ T emit_scaled(int k) {
  return k == 0 ? Arith<T>::scale() : (k == -1 ? T(1) : T(0));
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// A coefficient row (a1, a0, b, pad) of the shared table, in vector reads.
__device__ __forceinline__ void load_row(const float* row, float& a1,
                                         float& a0, float& b) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  a1 = v.x;
  a0 = v.y;
  b = v.z;
}
__device__ __forceinline__ void load_row(const double* row, double& a1,
                                         double& a0, double& b) {
  const double2 v = *reinterpret_cast<const double2*>(row);
  a1 = v.x;
  a0 = v.y;
  b = row[2];
}

template <typename T>
struct PairRing {
  T x, dp, dc, dpm, dcm;  // cos(theta); the +s and -s columns' d^{l-1}, d^l
  int k, km;              // their 2^60 exponents
  // FNp, Sp (-1)^j0, FNm, Sm (-1)^j0, each times 2^-60
  T fa[2], fb[2], fc[2], fd[2];
  // comp only: x_lo / x_hi; the lo streams of the +s and -s columns
  T r, dpl, dcl, dpml, dcml;
};

template <typename T, bool kSteady, bool kComp>
__device__ __forceinline__ void pair_chunk(const T* __restrict__ cf,
                                           PairRing<T> (&rs)[kRings],
                                           T (&acc)[V]) {
#pragma unroll
  for (int t = 0; t < LC; ++t) {
    T a1, a0, bb;
    load_row(cf + 4 * t, a1, a0, bb);
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      PairRing<T>& q = rs[r];
      const T dp_ = kComp ? Arith<T>::add(q.dc, q.dcl) : q.dc;
      const T dm_ = kComp ? Arith<T>::add(q.dcm, q.dcml) : q.dcm;
      const T lp = kSteady ? dp_ : dp_ * emit_scaled<T>(q.k);
      const T lm = kSteady ? dm_ : dm_ * emit_scaled<T>(q.km);
      // (-1)^l = (-1)^j0 (-1)^t: the (-1)^j0 is in fb and fd
      const T lps = (t & 1) ? -lp : lp;
      const T lms = (t & 1) ? -lm : lm;
      const int o = NC * t;
      acc[o] = madd(lms, q.fb[0], madd(lp, q.fa[0], acc[o]));
      acc[o + 1] = madd(lms, q.fb[1], madd(lp, q.fa[1], acc[o + 1]));
      acc[o + 2] = madd(lps, q.fd[0], madd(lm, q.fc[0], acc[o + 2]));
      acc[o + 3] = madd(lps, q.fd[1], madd(lm, q.fc[1], acc[o + 3]));
      // the -s column's a0 is minus the +s column's
      const T a1x = Arith<T>::mul(a1, q.x);
      const T dnp = step<T>(a1x, a0, bb, q.dc, q.dp);
      const T dnm = step<T>(a1x, -a0, bb, q.dcm, q.dpm);
      if (kComp) {
        const T dnpl = step_lo<T>(a1x, a0, bb, q.r, q.dc, q.dcl, q.dpl);
        const T dnml = step_lo<T>(a1x, -a0, bb, q.r, q.dcm, q.dcml, q.dpml);
        if (kSteady) {
          q.dp = q.dc;
          q.dc = dnp;
          q.dpm = q.dcm;
          q.dcm = dnm;
          q.dpl = q.dcl;
          q.dcl = dnpl;
          q.dpml = q.dcml;
          q.dcml = dnml;
        } else {
          advance_comp<T>(dnp, dnpl, q.dp, q.dc, q.dpl, q.dcl, q.k);
          advance_comp<T>(dnm, dnml, q.dpm, q.dcm, q.dpml, q.dcml, q.km);
        }
      } else if (kSteady) {
        q.dp = q.dc;
        q.dc = dnp;
        q.dpm = q.dcm;
        q.dcm = dnm;
      } else {
        advance<T>(dnp, q.dp, q.dc, q.k);
        advance<T>(dnm, q.dpm, q.dcm, q.km);
      }
    }
  }
}

// xr: the rings' r = x_lo / x_hi, read only by the comp instantiation.
template <typename T, bool kComp>
__global__ void __launch_bounds__(kThreads)
    pair_analysis_kernel(const T* __restrict__ fnp, const T* __restrict__ sp,
                         const T* __restrict__ fnm, const T* __restrict__ sm,
                         const T* __restrict__ x, const T* __restrict__ xr,
                         const double* __restrict__ logch,
                         const double* __restrict__ logsh,
                         const double* __restrict__ seed,
                         T* __restrict__ out_p, T* __restrict__ out_m,
                         int nhalf, int nm, int lmax, int s, int m0) {
  static_assert(LC % 2 == 0 && kRows % LC == 0,
                "chunks keep the parity of l and tile the table");
  static_assert(!kComp || sizeof(T) == 4, "comp is a float32 mode");

  __shared__ __align__(16) T tab[2][kRows][4];  // a1, a0, b, (pad)
  __shared__ T part[2][kWarps][V];

  const int mc = blockIdx.x;  // the column: this order's place in the block
  const int m = m0 + mc;      // the order
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = max(m, s);
  const int ntiles = (nhalf + kTile - 1) / kTile;
  // output (b, l, m) at col + l rs, (re, im) adjacent
  const size_t col = (size_t(b) * (lmax + 1) * nm + mc) * 2;
  const size_t rs = size_t(nm) * 2;

  // rows that no tile sums: l < j0, and every row of an empty column
  const int lz = (j0 <= lmax && ntiles > 0) ? j0 : lmax + 1;
  for (int l = tid; l < lz; l += kThreads) {
    const size_t o = col + l * rs;
    out_p[o] = out_p[o + 1] = out_m[o] = out_m[o + 1] = T(0);
  }
  if (lz > lmax) return;

  const int n = lmax - j0 + 1;  // multipoles of the column
  const int nsec = (n + kRows - 1) / kRows;
  const double logc_p = seed[mc];
  const double sign_p = seed[nm + mc];
  const double logc_m = seed[2 * nm + mc];
  const double sign_m = seed[3 * nm + mc];
  // seed exponents of cos(t/2) and sin(t/2): (m+s, |m-s|) for +s and
  // swapped for -s
  const double pc = double(m + s);
  const double ps = fabs(double(m - s));
  const T par = (j0 & 1) ? -Arith<T>::inv_scale() : Arith<T>::inv_scale();
  const T inv = Arith<T>::inv_scale();
  // the value this thread flushes: row offset tid / NC within a chunk,
  // component tid % NC
  T* const fout = (tid % NC) < 2 ? out_p : out_m;
  const int fcomp = tid & 1;

  coef_row<T>(j0 + tid + 1, j0, m, s, lmax, &tab[0][tid][0], &tab[0][tid][1],
              &tab[0][tid][2]);
  __syncthreads();

  int g = 0;  // running chunk count: selects the part buffer
  int q = 0;  // running section count: selects the table buffer
  for (int tile = 0; tile < ntiles; ++tile) {
    PairRing<T> rings[kRings];
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      PairRing<T>& p = rings[r];
      const int ring = tile * kTile + (warp * kRings + r) * 32 + lane;
      p.dp = T(0);
      p.dpm = T(0);
      if (kComp) p.r = p.dpl = p.dcl = p.dpml = p.dcml = T(0);
      if (ring < nhalf) {
        const size_t off = ((size_t(b) * nhalf + ring) * nm + mc) * 2;
        const double lch = logch[ring], lsh = logsh[ring];
        p.x = x[ring];
        if (kComp) p.r = xr[ring];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p.fa[c] = fnp[off + c] * inv;
          p.fb[c] = par * sp[off + c];
          p.fc[c] = fnm[off + c] * inv;
          p.fd[c] = par * sm[off + c];
        }
        seed_of<T>(logc_p, sign_p, pc, ps, lch, lsh, p.dc, p.k);
        seed_of<T>(logc_m, sign_m, ps, pc, lch, lsh, p.dcm, p.km);
      } else {
        p.x = T(0);
        p.dc = T(0);
        p.dcm = T(0);
        p.k = kNoSeed;
        p.km = kNoSeed;
#pragma unroll
        for (int c = 0; c < 2; ++c) p.fa[c] = p.fb[c] = p.fc[c] = p.fd[c] = T(0);
      }
    }

    for (int sec = 0; sec < nsec; ++sec, ++q) {
      const int tb = q & 1;
      // the next section's rows (the next tile's first after the last)
      const int sn = (sec + 1 < nsec) ? sec + 1 : 0;
      coef_row<T>(j0 + sn * kRows + tid + 1, j0, m, s, lmax,
                  &tab[tb ^ 1][tid][0], &tab[tb ^ 1][tid][1],
                  &tab[tb ^ 1][tid][2]);
      const int nch = (min(kRows, n - sec * kRows) + LC - 1) / LC;
      for (int c = 0; c < nch; ++c, ++g) {
        const int lf = j0 + sec * kRows + c * LC + tid / NC;
        const bool flush = tid < V && lf <= lmax;
        const size_t fo = col + lf * rs + fcomp;
        // this row's sum over the earlier tiles, read before the compute
        const T prev = (flush && tile > 0) ? fout[fo] : T(0);

        T acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = T(0);
        bool steady = true;
#pragma unroll
        for (int r = 0; r < kRings; ++r) {
          steady = steady && rings[r].k == -1 && rings[r].km == -1;
        }
        const T* cf = &tab[tb][c * LC][0];
        if (__all_sync(0xffffffffu, steady)) {
          pair_chunk<T, true, kComp>(cf, rings, acc);
        } else {
          pair_chunk<T, false, kComp>(cf, rings, acc);
        }

        // k never decreases: a warp whose every exponent is still below -1
        // emitted only zeros in this chunk and skips its reduction
        bool live = false;
#pragma unroll
        for (int r = 0; r < kRings; ++r) {
          live = live || rings[r].k >= -1 || rings[r].km >= -1;
        }
        if (__any_sync(0xffffffffu, live)) {
          reduce_scatter<T, V>(acc, lane);
          part[g & 1][warp][lane] = acc[0];
        } else {
          part[g & 1][warp][lane] = T(0);
        }
        __syncthreads();
        if (flush) {
          T sum = T(0);
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum += part[g & 1][w][tid];
          fout[fo] = prev + sum * norm_of<T>(lf);
        }
      }
    }
  }
}

template <typename T, bool kComp>
int launch(const void* fnp, const void* sp, const void* fnm, const void* sm,
           const void* x, const void* xr, const void* logch,
           const void* logsh, const void* seed, void* out_p, void* out_m,
           int batch, int nhalf, int nm, int lmax, int spin, int m0,
           void* stream) {
  if (batch == 0 || nm == 0) return int(cudaSuccess);
  pair_analysis_kernel<T, kComp>
      <<<dim3(nm, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(fnp), static_cast<const T*>(sp),
          static_cast<const T*>(fnm), static_cast<const T*>(sm),
          static_cast<const T*>(x), static_cast<const T*>(xr),
          static_cast<const double*>(logch),
          static_cast<const double*>(logsh), static_cast<const double*>(seed),
          static_cast<T*>(out_p), static_cast<T*>(out_m), nhalf, nm, lmax,
          spin, m0);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_analysis_pair_f32(const void* fnp, const void* sp,
                               const void* fnm, const void* sm, const void* x,
                               const void* logch, const void* logsh,
                               const void* seed, void* out_p, void* out_m,
                               int batch, int nhalf, int nm, int lmax,
                               int spin, int m0, void* stream) {
  return launch<float, false>(fnp, sp, fnm, sm, x, nullptr, logch, logsh,
                              seed, out_p, out_m, batch, nhalf, nm, lmax, spin,
                              m0, stream);
}

int heracles_analysis_pair_f64(const void* fnp, const void* sp,
                               const void* fnm, const void* sm, const void* x,
                               const void* logch, const void* logsh,
                               const void* seed, void* out_p, void* out_m,
                               int batch, int nhalf, int nm, int lmax,
                               int spin, int m0, void* stream) {
  return launch<double, false>(fnp, sp, fnm, sm, x, nullptr, logch, logsh,
                               seed, out_p, out_m, batch, nhalf, nm, lmax,
                               spin, m0, stream);
}

// The compensated float32 launch: xr holds each ring's r = x_lo / x_hi.
int heracles_analysis_pair_comp_f32(const void* fnp, const void* sp,
                                    const void* fnm, const void* sm,
                                    const void* x, const void* xr,
                                    const void* logch, const void* logsh,
                                    const void* seed, void* out_p,
                                    void* out_m, int batch, int nhalf, int nm,
                                    int lmax, int spin, int m0, void* stream) {
  return launch<float, true>(fnp, sp, fnm, sm, x, xr, logch, logsh, seed,
                             out_p, out_m, batch, nhalf, nm, lmax, spin, m0,
                             stream);
}

// Resident blocks per SM of the pair analysis (its shared memory does not
// depend on lmax), written to *blocks; variant 0 is the float32 kernel, 1
// the float64 one, 2 the compensated float32 one.  Returns the CUDA error
// code.
int heracles_analysis_pair_blocks_per_sm(int variant, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (variant == 1) {
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, pair_analysis_kernel<double, false>, kThreads, 0));
  }
  if (variant == 2) {
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, pair_analysis_kernel<float, true>, kThreads, 0));
  }
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, pair_analysis_kernel<float, false>, kThreads, 0));
}

}  // extern "C"
