// Folded spin-0 Wigner-d analysis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of heracles_tpu/ops/pallas_sht.py
// (:713), behind analysis_spin0_folded (:3101).  (The spin pair,
// _pair_kernel :1049, is sht_analysis_pair.cu.)
//
// What it computes, per batch element b and order m, for l = m..lmax:
//   alm[b,l,m] = sum_r lam_lm(x_r) (l even ? Fe : Fo)[b,r,m]
// where lam is the normalised Wigner-d function of wigner_recurrence.cuh:
// the three-term recurrence in l, seeded at j0 = m, with the seed's
// magnitude carried as a mantissa and a count k of factors 2^60 (block
// rescaling), and only k = 0 or -1 emitting.
//
// What bounds it: FP32 (or FP64) vector issue.  One map at nside 4096,
// lmax 3000 has 3.69e10 (ring, l, m) triples; each needs 10 flop (the
// recurrence's 5 unfused operations, the emit multiply, 2 FMAs), while F is
// read once (0.4 GB in float32) and the alms written once.
//
// Design (the pair analysis' shape, sht_analysis_pair.cu, with the block's
// warps decoupled):
//   * one block of 128 threads per (order m, batch element), blockIdx.x =
//     m - m0 so the longest columns start first; each thread owns
//     kRings = 4 rings of a tile of 512 (lane + 32 r of its warp's 128
//     adjacent rings) and runs their recurrence from j0 to lmax with F
//     in registers (read with a stride of nm complex values: the read is
//     small beside the compute, so F is not transposed);
//   * the sum over rings needs a reduction across threads, once per chunk
//     of LC = 16 multipoles: a warp butterfly reduce-scatter of the V = 32
//     partial sums (31 shuffles per 64 triples of a lane);
//   * the block's four warps do not meet at every chunk.  Each warp writes
//     its chunk sums into a slot of its own, part[warp][128 rows][2], through
//     the 128 multipoles of a table section, with no barrier between chunks;
//     at the section's end, where the coefficient table's double buffer
//     needs a barrier anyway, thread t sums the four slots of row t in a
//     fixed order, multiplies by the norm and flushes the row.  The slots
//     are double-buffered too, so that one barrier per 128 multipoles
//     serves both, and a warp on a cheap path does not wait for one on the
//     full step inside a section;
//   * no column that grows with lmax: a section's rows go straight to the
//     output, which this block alone owns.  The first ring tile writes
//     them, later tiles add to them: the thread that flushes a row is the
//     same in every tile and loads the row's earlier sum before the
//     section's compute, so the read-modify-write needs no atomics, waits
//     on no load, and each output is summed over tiles in a fixed order;
//     results repeat bit for bit;
//   * every warp picks the steady, dead or full path at the start of each
//     sub-chunk of 8 multipoles (sht_paths.cuh); the spectra are held times
//     2^-60 and the emit factor times 2^60, so the steady step multiplies d
//     itself and each FMA's product is the same exact number as before.
//     (The order 0 sits at k = 0, its functions being of order 1, and runs
//     the full step throughout.)  Rows past lmax are zeros, so a chunk
//     always runs both its sub-chunks;
//   * the recurrence coefficients (float64, rounded to T) stream through a
//     double-buffered shared table of 128 rows, one row filled by each
//     thread per section while the block works on the other buffer; each
//     step's row is one broadcast vector read;
//   * the contraction is 2 explicit FMAs per triple;
//   * the seed is evaluated in float64 from the host log-coefficients and
//     the float64 ring half-angle logs in both instantiations;
//   * the recurrence itself (seed, coefficients, unfused step, rescale) is
//     wigner_recurrence.cuh, shared with the other SHT kernels, and rounds
//     as the plain version does;
//   * the float32 kernel has a compensated instantiation (kComp), the twin
//     of _kernel_comp (pallas_sht.py:835): each ring carries r = x_lo /
//     x_hi and one lo stream (wigner::step_lo) beside d, shares d's
//     rescales and paths, and emits d + lo.  It costs 7 operations a
//     triple more (the lo step's 6 and the emit's add) and 3 registers a
//     ring; kComp = false compiles to the plain kernel.
//
// C interface (loaded with ctypes): heracles_analysis_spin0_{f32,f64} and
// heracles_analysis_spin0_comp_f32 (with the rings' r after x) launch on
// the given stream and return cudaGetLastError();
// heracles_analysis_spin0_blocks_per_sm gives the resident blocks per SM
// (the shared memory does not depend on lmax);
// heracles_analysis_spin0_{,comp_}paths_f32 are diagnostic launches that
// also count the warps' sub-chunks on each path (steady, dead, full).
// Every launch takes the block of orders m0..m0+nm-1 into its columns
// 0..nm-1 (the seed planes are the block's, indexed by column), so a
// device mesh can give each shard its own block; m0 = 0 is every order
// from 0, and an order above lmax gives a column of zeros.

#include <cuda_runtime.h>
#include <stddef.h>

#include "sht_paths.cuh"
#include "warp_reduce.cuh"
#include "wigner_recurrence.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRings = 4;                 // rings per thread
constexpr int kTile = kThreads * kRings;  // rings per tile
constexpr int kRows = kThreads;           // rows of a section: one per thread
constexpr int NC = 2;                     // (re, im)
constexpr int LC = 16;                    // multipoles per chunk
constexpr int V = NC * LC;                // register sums per thread
constexpr int kSub = sht_paths::kSub;     // multipoles per path decision

using sht_paths::emit_scaled;
using sht_paths::madd;
using sht_paths::Path;
using sht_paths::PathCounts;
using sht_paths::rescale_deferred;
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

__device__ __forceinline__ void load2(const float* p, float& re, float& im) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  re = v.x;
  im = v.y;
}
__device__ __forceinline__ void load2(const double* p, double& re, double& im) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  re = v.x;
  im = v.y;
}
__device__ __forceinline__ void store2(float* p, float re, float im) {
  *reinterpret_cast<float2*>(p) = make_float2(re, im);
}
__device__ __forceinline__ void store2(double* p, double re, double im) {
  *reinterpret_cast<double2*>(p) = make_double2(re, im);
}

template <typename T>
struct Ring {
  T x, dp, dc;  // cos(theta); d^{l-1}, d^l
  int k;        // the 2^60 exponent
  // F of the parity of j0 and of j0 + 1, (re, im), each times 2^-60
  T fa[2], fb[2];
  T r, dpl, dcl;  // comp only: x_lo / x_hi; the lo stream's l-1, l
};

// kSub multipoles of a chunk, from its multipole kOff on.
template <typename T, Path P, int kOff, bool kComp>
__device__ __forceinline__ void spin0_sub(const T* __restrict__ cf,
                                          Ring<T> (&rs)[kRings], T (&acc)[V]) {
#pragma unroll
  for (int t = kOff; t < kOff + kSub; ++t) {
    T a1, a0, bb;
    load_row(cf + 4 * t, a1, a0, bb);
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      Ring<T>& q = rs[r];
      if (P != Path::kDead) {
        const T d = kComp ? Arith<T>::add(q.dc, q.dcl) : q.dc;
        const T lam = P == Path::kSteady ? d : d * emit_scaled<T>(q.k);
        // chunks start at j0's parity
        const T fre = (t & 1) ? q.fb[0] : q.fa[0];
        const T fim = (t & 1) ? q.fb[1] : q.fa[1];
        acc[2 * t] = madd(lam, fre, acc[2 * t]);
        acc[2 * t + 1] = madd(lam, fim, acc[2 * t + 1]);
      }
      const T a1x = Arith<T>::mul(a1, q.x);
      const T dn = step<T>(a1x, a0, bb, q.dc, q.dp);
      if (kComp) {
        const T dnl = step_lo<T>(a1x, a0, bb, q.r, q.dc, q.dcl, q.dpl);
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
      } else {  // steady: no rescale is due; dead: it waits for the end
        q.dp = q.dc;
        q.dc = dn;
      }
    }
  }
  if (P == Path::kDead) {
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      if (kComp) {
        rescale_deferred<T>(rs[r].dp, rs[r].dc, rs[r].dpl, rs[r].dcl, rs[r].k);
      } else {
        rescale_deferred<T>(rs[r].dp, rs[r].dc, rs[r].k);
      }
    }
  }
}

template <typename T, int kOff, bool kCount, bool kComp>
__device__ __forceinline__ void spin0_sub_any(const T* __restrict__ cf,
                                              Ring<T> (&rs)[kRings],
                                              T (&acc)[V],
                                              PathCounts<kCount>& tally) {
  bool steady = true, dead = true;
#pragma unroll
  for (int r = 0; r < kRings; ++r) {
    steady = steady && sht_paths::is_steady(rs[r].k);
    dead = dead && sht_paths::is_dead(rs[r].k);
  }
  const Path path = sht_paths::warp_path(steady, dead);
  tally.add(path);
  if (path == Path::kSteady) {
    spin0_sub<T, Path::kSteady, kOff, kComp>(cf, rs, acc);
  } else if (path == Path::kDead) {
    spin0_sub<T, Path::kDead, kOff, kComp>(cf, rs, acc);
  } else {
    spin0_sub<T, Path::kFull, kOff, kComp>(cf, rs, acc);
  }
}

// xr: the rings' r = x_lo / x_hi, read only by the comp instantiation.
template <typename T, bool kComp, bool kCount>
__global__ void __launch_bounds__(kThreads)
    analysis_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                    const T* __restrict__ x, const T* __restrict__ xr,
                    const double* __restrict__ logch,
                    const double* __restrict__ logsh,
                    const double* __restrict__ seed, T* __restrict__ out,
                    int nhalf, int nm, int lmax, int m0,
                    unsigned long long* __restrict__ counts) {
  static_assert(LC == 2 * kSub && kRows % LC == 0 && V == 32,
                "two sub-chunks per chunk, chunks tile the section, one sum "
                "per lane after the butterfly");
  static_assert(!kComp || sizeof(T) == 4, "comp is a float32 mode");

  __shared__ __align__(16) T tab[2][kRows][4];  // a1, a0, b, (pad)
  __shared__ __align__(16) T part[2][kWarps][kRows * NC];

  const int mc = blockIdx.x;  // the column: this order's place in the block
  const int m = m0 + mc;      // the order
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = 0;
  const int j0 = m;
  const int ntiles = (nhalf + kTile - 1) / kTile;
  // output (b, l, m) at col + l rs, (re, im) adjacent
  const size_t col = (size_t(b) * (lmax + 1) * nm + mc) * 2;
  const size_t rs = size_t(nm) * 2;

  // rows that no tile sums: l < j0, and every row of an empty column
  const int lz = (j0 <= lmax && ntiles > 0) ? j0 : lmax + 1;
  for (int l = tid; l < lz; l += kThreads) store2(out + col + l * rs, T(0), T(0));
  if (lz > lmax) return;

  const int n = lmax - j0 + 1;  // multipoles of the column
  const int nsec = (n + kRows - 1) / kRows;
  const double logc = seed[mc];
  const double sign = seed[nm + mc];
  // seed exponents of cos(t/2) and sin(t/2): both m
  const double pc = double(m);
  const double ps = double(m);
  const T inv = Arith<T>::inv_scale();
  const T* const fe = (j0 & 1) ? f1 : f0;  // F of j0's parity
  const T* const fo = (j0 & 1) ? f0 : f1;
  PathCounts<kCount> tally;

  coef_row<T>(j0 + tid + 1, j0, m, s, lmax, &tab[0][tid][0], &tab[0][tid][1],
              &tab[0][tid][2]);
  __syncthreads();

  int q = 0;  // running section count: selects the table and slot buffers
  for (int tile = 0; tile < ntiles; ++tile) {
    Ring<T> rings[kRings];
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
      Ring<T>& p = rings[r];
      const int ring = tile * kTile + (warp * kRings + r) * 32 + lane;
      p.dp = T(0);
      if (kComp) p.dpl = p.dcl = p.r = T(0);
      if (ring < nhalf) {
        const size_t off = ((size_t(b) * nhalf + ring) * nm + mc) * 2;
        const double lch = logch[ring], lsh = logsh[ring];
        p.x = x[ring];
        if (kComp) p.r = xr[ring];
        load2(fe + off, p.fa[0], p.fa[1]);
        load2(fo + off, p.fb[0], p.fb[1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p.fa[c] *= inv;
          p.fb[c] *= inv;
        }
        seed_of<T>(logc, sign, pc, ps, lch, lsh, p.dc, p.k);
      } else {
        p.x = T(0);
        p.dc = T(0);
        p.k = kNoSeed;
        p.fa[0] = p.fa[1] = p.fb[0] = p.fb[1] = T(0);
      }
    }

    for (int sec = 0; sec < nsec; ++sec, ++q) {
      const int tb = q & 1;
      // the next section's rows (the next tile's first after the last)
      const int sn = (sec + 1 < nsec) ? sec + 1 : 0;
      coef_row<T>(j0 + sn * kRows + tid + 1, j0, m, s, lmax,
                  &tab[tb ^ 1][tid][0], &tab[tb ^ 1][tid][1],
                  &tab[tb ^ 1][tid][2]);
      // the row this thread flushes, and its sum over the earlier tiles,
      // read before the compute
      const int lf = j0 + sec * kRows + tid;
      const bool flush = lf <= lmax;
      T* const fo_row = out + col + lf * rs;
      T prev[2] = {T(0), T(0)};
      if (flush && tile > 0) load2(fo_row, prev[0], prev[1]);

      const int nch = (min(kRows, n - sec * kRows) + LC - 1) / LC;
      for (int c = 0; c < nch; ++c) {
        T acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = T(0);
        const T* cf = &tab[tb][c * LC][0];
        spin0_sub_any<T, 0, kCount, kComp>(cf, rings, acc, tally);
        spin0_sub_any<T, kSub, kCount, kComp>(cf, rings, acc, tally);

        // k never decreases: a warp whose every exponent is still below -1
        // emitted only zeros in this chunk and skips its reduction
        bool live = false;
#pragma unroll
        for (int r = 0; r < kRings; ++r) live = live || rings[r].k >= -1;
        T sum = T(0);
        if (__any_sync(0xffffffffu, live)) {
          reduce_scatter<T, V>(acc, lane);
          sum = acc[0];
        }
        // lane i holds value i of the chunk: row i / 2, component i % 2
        part[tb][warp][c * V + lane] = sum;
      }
      __syncthreads();
      if (flush) {
        T re = T(0), im = T(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          T pr, pi;
          load2(&part[tb][w][NC * tid], pr, pi);
          re += pr;
          im += pi;
        }
        const T norm = norm_of<T>(lf);
        store2(fo_row, prev[0] + re * norm, prev[1] + im * norm);
      }
    }
  }
  tally.flush(counts, lane);
}

template <typename T, bool kComp, bool kCount>
int launch(const void* f0, const void* f1, const void* x, const void* xr,
           const void* logch, const void* logsh, const void* seed, void* out,
           int batch, int nhalf, int nm, int lmax, int m0, void* counts,
           void* stream) {
  if (batch == 0 || nm == 0) return int(cudaSuccess);
  analysis_kernel<T, kComp, kCount>
      <<<dim3(nm, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(f0), static_cast<const T*>(f1),
          static_cast<const T*>(x), static_cast<const T*>(xr),
          static_cast<const double*>(logch),
          static_cast<const double*>(logsh), static_cast<const double*>(seed),
          static_cast<T*>(out), nhalf, nm, lmax, m0,
          static_cast<unsigned long long*>(counts));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_analysis_spin0_f32(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, int m0,
                                void* stream) {
  return launch<float, false, false>(fe, fo, x, nullptr, logch, logsh, seed,
                                     out, batch, nhalf, nm, lmax, m0, nullptr,
                                     stream);
}

int heracles_analysis_spin0_f64(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, int m0,
                                void* stream) {
  return launch<double, false, false>(fe, fo, x, nullptr, logch, logsh, seed,
                                      out, batch, nhalf, nm, lmax, m0, nullptr,
                                      stream);
}

// The compensated float32 launch: xr holds each ring's r = x_lo / x_hi.
int heracles_analysis_spin0_comp_f32(const void* fe, const void* fo,
                                     const void* x, const void* xr,
                                     const void* logch, const void* logsh,
                                     const void* seed, void* out, int batch,
                                     int nhalf, int nm, int lmax, int m0,
                                     void* stream) {
  return launch<float, true, false>(fe, fo, x, xr, logch, logsh, seed, out,
                                    batch, nhalf, nm, lmax, m0, nullptr,
                                    stream);
}

// The float32 launch with ``counts`` (3 x uint64, zeroed by the caller)
// taking the warps' sub-chunks on the steady, dead and full paths.
int heracles_analysis_spin0_paths_f32(const void* fe, const void* fo,
                                      const void* x, const void* logch,
                                      const void* logsh, const void* seed,
                                      void* out, void* counts, int batch,
                                      int nhalf, int nm, int lmax, int m0,
                                      void* stream) {
  return launch<float, false, true>(fe, fo, x, nullptr, logch, logsh, seed,
                                    out, batch, nhalf, nm, lmax, m0, counts,
                                    stream);
}

// The compensated float32 launch with the path counts.
int heracles_analysis_spin0_comp_paths_f32(const void* fe, const void* fo,
                                           const void* x, const void* xr,
                                           const void* logch,
                                           const void* logsh, const void* seed,
                                           void* out, void* counts, int batch,
                                           int nhalf, int nm, int lmax, int m0,
                                           void* stream) {
  return launch<float, true, true>(fe, fo, x, xr, logch, logsh, seed, out,
                                   batch, nhalf, nm, lmax, m0, counts, stream);
}

// Resident blocks per SM of the spin-0 analysis (its shared memory does not
// depend on lmax), written to *blocks; variant 0 is the float32 kernel, 1
// the float64 one, 2 the compensated float32 one.  Returns the CUDA error
// code.
int heracles_analysis_spin0_blocks_per_sm(int variant, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (variant == 1) {
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, analysis_kernel<double, false, false>, kThreads, 0));
  }
  if (variant == 2) {
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, analysis_kernel<float, true, false>, kThreads, 0));
  }
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, analysis_kernel<float, false, false>, kThreads, 0));
}

const char* heracles_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
