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
//     registers a ring; kComp = false compiles to the plain kernel;
//   * a batch runs in groups of NB = 1, 2 or 4 maps (the reference's pair
//     limit, pallas_sht.py:1603), the twin of _pair_kernel's nb
//     (pallas_sht.py:1051, picked at :1601-1603): NB = 1 is the kernel
//     above, NB > 1 pair_group_kernel, one block per (order, group), which
//     runs both columns' recurrences once for the group (11 of a
//     map-triple's 27 operations) and contracts them against the group's
//     spectra on the tensor cores as two products, (FNp, Sm) lp and (Sp,
//     FNm) lm (tc_contract.cuh: 3xTF32 mma.sync in float32 and comp, DMMA
//     in float64), the (-1)^l applied to the products' columns.  Once the
//     contraction leaves the FP32 pipe, what bounds the group is the
//     shared recurrence (and the splits and staging that feed the tensor
//     cores), no longer each map's FMAs and warp butterfly: on an H100
//     the float32 nb 4 runs 11-14% faster than the FP32 contraction it
//     replaced, and nb 2, whose 8 rows fill half of each product, 15-16%
//     slower; float64 runs faster at both.
//     It has the spin-0 group's paths and pace: steady, dead or full per
//     warp and sub-chunk of 8 multipoles (sht_paths.cuh; a dead sub-chunk
//     costs nothing per map), a ring tile of 256, the spectra kept whole
//     in fragment order (split into TF32 parts as a k-step reads them),
//     and the warps meeting once per section of 128 multipoles.  Not
//     wgmma, for the reason sht_analysis.cu gives.  Its outputs agree with
//     NB = 1's to the float32 (float64) bar, not bit for bit; each launch
//     repeats bit for bit.  Its shared memory is 45 / 77 KB at NB 2 / 4 in
//     float32, 90 / 154 KB in float64.
//
// C interface (loaded with ctypes): heracles_analysis_pair_{f32,f64} and
// heracles_analysis_pair_comp_f32 (with the rings' r after x) launch the
// batch in groups of nb maps (1, 2 or 4, dividing the batch, else
// cudaErrorInvalidValue) on the given stream and return
// cudaGetLastError(); heracles_analysis_pair_blocks_per_sm gives the
// resident blocks per SM of a variant and nb;
// heracles_analysis_pair_{,comp_}paths_f32 are diagnostic launches of the
// grouped kernel (nb 2 or 4) that also count the warps' sub-chunks on
// each path (steady, dead, full).
// Every launch takes the block of orders m0..m0+nm-1 into its columns
// 0..nm-1 (the seed planes are the block's, indexed by column), so a
// device mesh can give each shard its own block; m0 = 0 is every order
// from 0, and an order above lmax gives a column of zeros.

#include <cuda_runtime.h>
#include <stddef.h>

#include "sht_paths.cuh"
#include "tc_contract.cuh"
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

template <typename T>
struct PairRing {
  T x, dp, dc, dpm, dcm;  // cos(theta); the +s and -s columns' d^{l-1}, d^l
  int k, km;              // their 2^60 exponents
  // FNp, Sp (-1)^j0, FNm, Sm (-1)^j0, each times 2^-60
  T fa[2], fb[2], fc[2], fd[2];
  // comp only: x_lo / x_hi; the lo streams of the +s and -s columns
  T r, dpl, dcl, dpml, dcml;
};

// The NB = 1 kernel's use of a step's values: its 8 FMAs into the chunk's
// sums, at the chunk's multipole t.
template <typename T>
struct PairContract {
  const PairRing<T> (&rs)[kRings];
  T (&acc)[V];
  __device__ __forceinline__ void operator()(int t, int r, T lp, T lm) const {
    const PairRing<T>& q = rs[r];
    // (-1)^l = (-1)^j0 (-1)^t: the (-1)^j0 is in fb and fd
    const T lps = (t & 1) ? -lp : lp;
    const T lms = (t & 1) ? -lm : lm;
    const int o = NC * t;
    acc[o] = madd(lms, q.fb[0], madd(lp, q.fa[0], acc[o]));
    acc[o + 1] = madd(lms, q.fb[1], madd(lp, q.fa[1], acc[o + 1]));
    acc[o + 2] = madd(lps, q.fd[0], madd(lm, q.fc[0], acc[o + 2]));
    acc[o + 3] = madd(lps, q.fd[1], madd(lm, q.fc[1], acc[o + 3]));
  }
};

// The grouped kernel's: keep them for the group's maps.
template <typename T, int R>
struct PairKeep {
  T (&lp)[kSub][R];
  T (&lm)[kSub][R];
  __device__ __forceinline__ void operator()(int t, int r, T vp, T vm) const {
    lp[t][r] = vp;
    lm[t][r] = vm;
  }
};

// kSteps steps of both columns' recurrences of the thread's rings from the
// coefficient row cf on, on path P (sht_paths.cuh); on a path that emits,
// emit(t, r, lp, lm) takes step t's values of ring r before the step.
template <typename T, Path P, bool kComp, int kSteps, int R, typename Emit>
__device__ __forceinline__ void pair_steps(const T* __restrict__ cf,
                                           PairRing<T> (&rs)[R],
                                           const Emit& emit) {
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    T a1, a0, bb;
    load_row(cf + 4 * t, a1, a0, bb);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      PairRing<T>& q = rs[r];
      if (P != Path::kDead) {
        const T dp_ = kComp ? Arith<T>::add(q.dc, q.dcl) : q.dc;
        const T dm_ = kComp ? Arith<T>::add(q.dcm, q.dcml) : q.dcm;
        emit(t, r, P == Path::kSteady ? dp_ : dp_ * emit_scaled<T>(q.k),
             P == Path::kSteady ? dm_ : dm_ * emit_scaled<T>(q.km));
      }
      // the -s column's a0 is minus the +s column's
      const T a1x = Arith<T>::mul(a1, q.x);
      const T dnp = step<T>(a1x, a0, bb, q.dc, q.dp);
      const T dnm = step<T>(a1x, -a0, bb, q.dcm, q.dpm);
      if (kComp) {
        const T dnpl = step_lo<T>(a1x, a0, bb, q.r, q.dc, q.dcl, q.dpl);
        const T dnml = step_lo<T>(a1x, -a0, bb, q.r, q.dcm, q.dcml, q.dpml);
        if (P != Path::kFull) {
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
      } else if (P != Path::kFull) {
        // steady: no rescale is due; dead: it waits for the end
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

// Whether the warp's rings all sit at k = -1 for both columns.
template <typename T>
__device__ __forceinline__ bool warp_steady(const PairRing<T> (&rs)[kRings]) {
  bool steady = true;
#pragma unroll
  for (int r = 0; r < kRings; ++r) {
    steady = steady && rs[r].k == -1 && rs[r].km == -1;
  }
  return __all_sync(0xffffffffu, steady);
}

// Whether any ring of the warp emits from here on: k never decreases, so
// a warp whose every exponent is still below -1 emitted only zeros.
template <typename T, int R>
__device__ __forceinline__ bool warp_live(const PairRing<T> (&rs)[R]) {
  bool live = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    live = live || rs[r].k >= -1 || rs[r].km >= -1;
  }
  return __any_sync(0xffffffffu, live);
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
        const T* cf = &tab[tb][c * LC][0];
        if (warp_steady(rings)) {
          pair_steps<T, Path::kSteady, kComp, LC>(cf, rings,
                                                  PairContract<T>{rings, acc});
        } else {
          pair_steps<T, Path::kFull, kComp, LC>(cf, rings,
                                                PairContract<T>{rings, acc});
        }

        // a warp that emitted only zeros in this chunk skips its reduction
        if (warp_live(rings)) {
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

// Ring slots a thread of the grouped kernel: a ring tile of 256, so that
// the A tiles of 4 maps leave room for two blocks an SM.
constexpr int kGR = 2;
constexpr int kGTile = kThreads * kGR;
constexpr int kGSteps = 4 * kGR;  // k-steps of 8 rings: a warp's 32 kGR rings

// The grouped kernel's dynamic shared memory, in elements of T, per warp:
// its A tiles for the two products (tc_contract.cuh; row tile j / 4 of
// product 0 holds map j's FNp in rows 2 j + c and Sm in rows 2 j + c + 8,
// product 1 its Sp and FNm, c = re, im), its staging buffer (one, used by
// the products in turn), and its sums of a section, part[NB][kRows][NC].
template <typename T, int NB>
struct GroupSmem {
  static constexpr int kTiles = (NB + 3) / 4;           // row tiles of 16
  static constexpr int kLanes = NB >= 4 ? 32 : 8 * NB;  // lanes with rows
  static constexpr int kStep = tc::step_elems<kLanes>();
  static constexpr int kProduct = kTiles * kGSteps * kStep;
  static constexpr int kA = 2 * kProduct;
  static constexpr int kStaged = 2 * 8 * tc::kStage;
  static constexpr int kPart = NB * kRows * NC;
  static constexpr size_t kBytes =
      sizeof(T) * size_t(kWarps) * (kA + kStaged + kPart);
  // blocks an SM its shared memory allows (228 KB an SM, 1 KB reserved a
  // block, the coefficient table beside): the launch bounds tell ptxas,
  // which otherwise trades registers for an occupancy the shared memory
  // never gives, and spills
  static constexpr int kResident = int(
      (228 * 1024) / (kBytes + sizeof(T) * 2 * kRows * 4 + 1024));
};

// The warp's path for its next sub-chunk (sht_paths.cuh), from both
// columns' exponents.
template <typename T, int R>
__device__ __forceinline__ Path pair_path(const PairRing<T> (&rs)[R]) {
  bool steady = true, dead = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    steady = steady && sht_paths::is_steady(rs[r].k) &&
             sht_paths::is_steady(rs[r].km);
    dead = dead && sht_paths::is_dead(rs[r].k) && sht_paths::is_dead(rs[r].km);
  }
  return sht_paths::warp_path(steady, dead);
}

// The grouped kernel (NB > 1), the twin of the reference's nb program:
// one block per (order, group of NB maps) runs both columns' recurrences
// of its rings once (PairKeep) and contracts them against all NB maps'
// spectra on the tensor cores (tc_contract.cuh): per sub-chunk of kSub
// multipoles a warp stages lp and multiplies product 0's A tiles by it
// (D0 = (FNp, Sm) lp), then the same for lm (D1 = (Sp, FNm) lm), and
// forms a_p = D0[FNp] + (-1)^t D1[Sp], a_m = D1[FNm] + (-1)^t D0[Sm] in
// the lane that holds all four (the (-1)^j0 of (-1)^l is in the S
// spectra).  The warp takes the steady, dead or full path a sub-chunk
// (sht_paths.cuh), for the group; a dead sub-chunk, or one that emitted
// only zeros, costs nothing per map: its sums are zeros.  The warps' sums
// meet in part[] once per section, where the coefficient table's double
// buffer needs a barrier anyway, and are summed in a fixed order and
// flushed; part[] has one buffer, so a second barrier closes the flush.
// The sums run in another order than the NB = 1 kernel's (and 3xTF32 in
// float32), so the outputs are not its bits; every launch repeats bit for
// bit.  kCount: the diagnostic twin that counts the warps' sub-chunks on
// each path.
template <typename T, bool kComp, int NB, bool kCount>
__global__ void __launch_bounds__(kThreads, GroupSmem<T, NB>::kResident)
    pair_group_kernel(const T* __restrict__ fnp, const T* __restrict__ sp,
                      const T* __restrict__ fnm, const T* __restrict__ sm,
                      const T* __restrict__ x, const T* __restrict__ xr,
                      const double* __restrict__ logch,
                      const double* __restrict__ logsh,
                      const double* __restrict__ seed, T* __restrict__ out_p,
                      T* __restrict__ out_m, int nhalf, int nm, int lmax,
                      int s, int m0, unsigned long long* __restrict__ counts) {
  using S = GroupSmem<T, NB>;
  static_assert(NB > 1 && kRows % kSub == 0 && kSub == 8 && kGR % 2 == 0 &&
                    NC == 4,
                "a group of maps; sub-chunks tile the section; a sub-chunk "
                "is one mma's 8 columns; ring slots in pairs; (re, im) of "
                "a_p and a_m");
  static_assert(!kComp || sizeof(T) == 4, "comp is a float32 mode");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  T* const base = reinterpret_cast<T*>(smem);
  T* const at = base + warp * S::kA;
  T* const stg = base + kWarps * S::kA + warp * S::kStaged;
  T* const part = base + kWarps * (S::kA + S::kStaged);
  __shared__ __align__(16) T tab[2][kRows][4];  // a1, a0, b, (pad)

  const int mc = blockIdx.x;  // the column: this order's place in the block
  const int m = m0 + mc;      // the order
  const int g0 = blockIdx.y * NB;  // the group's first map
  const int j0 = max(m, s);
  const int ntiles = (nhalf + kGTile - 1) / kGTile;
  // output (g0 + j, l, m) at col + j plane + l rs, (re, im) adjacent
  const size_t plane = size_t(lmax + 1) * nm * 2;
  const size_t col = size_t(g0) * plane + size_t(mc) * 2;
  const size_t rs = size_t(nm) * 2;
  PathCounts<kCount> tally;

  const int lz = (j0 <= lmax && ntiles > 0) ? j0 : lmax + 1;
  for (int l = tid; l < lz; l += kThreads) {
    for (int j = 0; j < NB; ++j) {
      const size_t o = col + j * plane + l * rs;
      out_p[o] = out_p[o + 1] = out_m[o] = out_m[o + 1] = T(0);
    }
  }
  if (lz > lmax) return;

  const int n = lmax - j0 + 1;
  const int nsec = (n + kRows - 1) / kRows;

  coef_row<T>(j0 + tid + 1, j0, m, s, lmax, &tab[0][tid][0], &tab[0][tid][1],
              &tab[0][tid][2]);
  __syncthreads();

  int q = 0;  // running section count: selects the table buffer
  for (int tile = 0; tile < ntiles; ++tile) {
    // what only a tile's start reads is read there again, to keep it out
    // of the registers of the sections: seed exponents of cos(t/2) and
    // sin(t/2), (m+s, |m-s|) for +s and swapped for -s
    const double pc = double(m + s);
    const double ps = fabs(double(m - s));
    const T par = (j0 & 1) ? -Arith<T>::inv_scale() : Arith<T>::inv_scale();
    const T inv = Arith<T>::inv_scale();
    PairRing<T> rings[kGR];
#pragma unroll
    for (int r = 0; r < kGR; ++r) {
      PairRing<T>& p = rings[r];
      const int ring = tile * kGTile + (warp * kGR + r) * 32 + lane;
      p.dp = T(0);
      p.dpm = T(0);
      if (kComp) p.r = p.dpl = p.dcl = p.dpml = p.dcml = T(0);
      if (ring < nhalf) {
        const double lch = logch[ring], lsh = logsh[ring];
        p.x = x[ring];
        if (kComp) p.r = xr[ring];
        seed_of<T>(seed[mc], seed[nm + mc], pc, ps, lch, lsh, p.dc, p.k);
        seed_of<T>(seed[2 * nm + mc], seed[3 * nm + mc], ps, pc, lch, lsh,
                   p.dcm, p.km);
      } else {
        p.x = T(0);
        p.dc = T(0);
        p.dcm = T(0);
        p.k = kNoSeed;
        p.km = kNoSeed;
      }
      // this ring is k = lane % 4 + 4 (r % 2) of k-step 8 (r / 2) + lane / 4
      T* const step = at + (8 * (r / 2) + (lane >> 2)) * S::kStep;
      for (int j = 0; j < NB; ++j) {
        // FNp, Sp (-1)^j0, FNm, Sm (-1)^j0, (re, im) each, times 2^-60
        T f[4][2] = {};
        if (ring < nhalf) {
          const size_t off = ((size_t(g0 + j) * nhalf + ring) * nm + mc) * 2;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            f[0][c] = fnp[off + c] * inv;
            f[1][c] = par * sp[off + c];
            f[2][c] = fnm[off + c] * inv;
            f[3][c] = par * sm[off + c];
          }
        }
        T* const tj = step + (j / 4) * kGSteps * S::kStep;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int al = (2 * (j % 4) + c) * 4 + (lane & 3);
          tc::put(tj, al, r & 1, f[0][c], f[3][c]);
          tc::put(tj + S::kProduct, al, r & 1, f[1][c], f[2][c]);
        }
      }
    }

    for (int sec = 0; sec < nsec; ++sec, ++q) {
      const int tb = q & 1;
      const int sn = (sec + 1 < nsec) ? sec + 1 : 0;
      coef_row<T>(j0 + sn * kRows + tid + 1, j0, m, s, lmax,
                  &tab[tb ^ 1][tid][0], &tab[tb ^ 1][tid][1],
                  &tab[tb ^ 1][tid][2]);

      const int nsub = (min(kRows, n - sec * kRows) + kSub - 1) / kSub;
      for (int u = 0; u < nsub; ++u) {
        T lp[kSub][kGR], lm[kSub][kGR];
        const T* cf = &tab[tb][u * kSub][0];
        const PairKeep<T, kGR> keep{lp, lm};
        const Path path = pair_path(rings);
        tally.add(path);
        if (path == Path::kSteady) {
          pair_steps<T, Path::kSteady, kComp, kSub>(cf, rings, keep);
        } else if (path == Path::kDead) {
          pair_steps<T, Path::kDead, kComp, kSub>(cf, rings, keep);
        } else {
          pair_steps<T, Path::kFull, kComp, kSub>(cf, rings, keep);
        }
        T d0[S::kTiles][4] = {}, d1[S::kTiles][4] = {};
        if (path != Path::kDead && warp_live(rings)) {
#pragma unroll
          for (int p = 0; p < kGR / 2; ++p) {
            const T* const ap = at + 8 * p * S::kStep;
            __syncwarp();
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
              tc::stage(stg, lane, t, lp[t][2 * p], lp[t][2 * p + 1]);
            }
            __syncwarp();
            tc::contract<S::kTiles, S::kLanes>(d0, stg, ap,
                                               kGSteps * S::kStep, lane);
            __syncwarp();
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
              tc::stage(stg, lane, t, lm[t][2 * p], lm[t][2 * p + 1]);
            }
            __syncwarp();
            tc::contract<S::kTiles, S::kLanes>(d1, stg, ap + S::kProduct,
                                               kGSteps * S::kStep, lane);
          }
        }
        // lane (g, t) holds rows g and g + 8 at multipoles 2 t + e in
        // d[e] and d[2 + e]: map 4 tq + g / 2, component g % 2
        const int g = lane >> 2;
        if (g < 2 * NB) {
#pragma unroll
          for (int tq = 0; tq < S::kTiles; ++tq) {
            T* const pj = part +
                          (warp * NB + 4 * tq + g / 2) * (kRows * NC) +
                          (u * kSub + 2 * (lane & 3)) * NC + (g & 1);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // (-1)^t with t = 2 (lane % 4) + e
              pj[e * NC] = e ? d0[tq][e] - d1[tq][e] : d0[tq][e] + d1[tq][e];
              pj[e * NC + 2] = e ? d1[tq][2 + e] - d0[tq][2 + e]
                                 : d1[tq][2 + e] + d0[tq][2 + e];
            }
          }
        }
      }
      __syncthreads();
      const int lf = j0 + sec * kRows + tid;
      if (lf <= lmax) {
        const T norm = norm_of<T>(lf);
        for (int j = 0; j < NB; ++j) {
          const size_t fo = col + j * plane + lf * rs;
          T sum[NC] = {};
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            const T* const pw = &part[(w * NB + j) * (kRows * NC) + NC * tid];
#pragma unroll
            for (int i = 0; i < NC; ++i) sum[i] += pw[i];
          }
          const T pr = tile > 0 ? out_p[fo] : T(0);
          const T pi = tile > 0 ? out_p[fo + 1] : T(0);
          const T mr = tile > 0 ? out_m[fo] : T(0);
          const T mi = tile > 0 ? out_m[fo + 1] : T(0);
          out_p[fo] = pr + sum[0] * norm;
          out_p[fo + 1] = pi + sum[1] * norm;
          out_m[fo] = mr + sum[2] * norm;
          out_m[fo + 1] = mi + sum[3] * norm;
        }
      }
      __syncthreads();
    }
  }
  tally.flush(counts, lane);
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

// Lets the grouped kernel take its shared memory, and returns it.
template <typename T, bool kComp, int NB, bool kCount>
cudaError_t group_smem_attr(size_t* smem) {
  *smem = GroupSmem<T, NB>::kBytes;
  return cudaFuncSetAttribute(pair_group_kernel<T, kComp, NB, kCount>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(*smem));
}

template <typename T, bool kComp, int NB, bool kCount>
int launch_group(const void* fnp, const void* sp, const void* fnm,
                 const void* sm, const void* x, const void* xr,
                 const void* logch, const void* logsh, const void* seed,
                 void* out_p, void* out_m, int batch, int nhalf, int nm,
                 int lmax, int spin, int m0, void* counts, void* stream) {
  if (batch == 0 || nm == 0) return int(cudaSuccess);
  size_t smem = 0;
  const cudaError_t err = group_smem_attr<T, kComp, NB, kCount>(&smem);
  if (err != cudaSuccess) return int(err);
  pair_group_kernel<T, kComp, NB, kCount>
      <<<dim3(nm, batch / NB), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(fnp), static_cast<const T*>(sp),
          static_cast<const T*>(fnm), static_cast<const T*>(sm),
          static_cast<const T*>(x), static_cast<const T*>(xr),
          static_cast<const double*>(logch),
          static_cast<const double*>(logsh), static_cast<const double*>(seed),
          static_cast<T*>(out_p), static_cast<T*>(out_m), nhalf, nm, lmax,
          spin, m0, static_cast<unsigned long long*>(counts));
  return int(cudaGetLastError());
}

// The launch of groups of nb maps: nb = 1 is the kernel above, 2 and 4 the
// grouped kernel; any other nb, or one that does not divide the batch, is
// refused.
template <typename T, bool kComp>
int launch_nb(const void* fnp, const void* sp, const void* fnm,
              const void* sm, const void* x, const void* xr,
              const void* logch, const void* logsh, const void* seed,
              void* out_p, void* out_m, int batch, int nhalf, int nm,
              int lmax, int spin, int m0, int nb, void* stream) {
  if (nb < 1 || batch % nb != 0) return int(cudaErrorInvalidValue);
  switch (nb) {
    case 1:
      return launch<T, kComp>(fnp, sp, fnm, sm, x, xr, logch, logsh, seed,
                              out_p, out_m, batch, nhalf, nm, lmax, spin, m0,
                              stream);
    case 2:
      return launch_group<T, kComp, 2, false>(
          fnp, sp, fnm, sm, x, xr, logch, logsh, seed, out_p, out_m, batch,
          nhalf, nm, lmax, spin, m0, nullptr, stream);
    case 4:
      return launch_group<T, kComp, 4, false>(
          fnp, sp, fnm, sm, x, xr, logch, logsh, seed, out_p, out_m, batch,
          nhalf, nm, lmax, spin, m0, nullptr, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The grouped float32 launch with the path counts (nb 2 or 4).
template <bool kComp>
int launch_paths(const void* fnp, const void* sp, const void* fnm,
                 const void* sm, const void* x, const void* xr,
                 const void* logch, const void* logsh, const void* seed,
                 void* out_p, void* out_m, void* counts, int batch, int nhalf,
                 int nm, int lmax, int spin, int m0, int nb, void* stream) {
  if (nb < 1 || batch % nb != 0) return int(cudaErrorInvalidValue);
  switch (nb) {
    case 2:
      return launch_group<float, kComp, 2, true>(
          fnp, sp, fnm, sm, x, xr, logch, logsh, seed, out_p, out_m, batch,
          nhalf, nm, lmax, spin, m0, counts, stream);
    case 4:
      return launch_group<float, kComp, 4, true>(
          fnp, sp, fnm, sm, x, xr, logch, logsh, seed, out_p, out_m, batch,
          nhalf, nm, lmax, spin, m0, counts, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, bool kComp, int NB>
int group_blocks(int* n) {
  size_t smem = 0;
  const cudaError_t err = group_smem_attr<T, kComp, NB, false>(&smem);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, pair_group_kernel<T, kComp, NB, false>, kThreads, smem));
}

template <typename T, bool kComp>
int blocks_nb(int nb, int* n) {
  switch (nb) {
    case 1:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, pair_analysis_kernel<T, kComp>, kThreads, 0));
    case 2:
      return group_blocks<T, kComp, 2>(n);
    case 4:
      return group_blocks<T, kComp, 4>(n);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int heracles_analysis_pair_f32(const void* fnp, const void* sp,
                               const void* fnm, const void* sm, const void* x,
                               const void* logch, const void* logsh,
                               const void* seed, void* out_p, void* out_m,
                               int batch, int nhalf, int nm, int lmax,
                               int spin, int m0, int nb, void* stream) {
  return launch_nb<float, false>(fnp, sp, fnm, sm, x, nullptr, logch, logsh,
                                 seed, out_p, out_m, batch, nhalf, nm, lmax,
                                 spin, m0, nb, stream);
}

int heracles_analysis_pair_f64(const void* fnp, const void* sp,
                               const void* fnm, const void* sm, const void* x,
                               const void* logch, const void* logsh,
                               const void* seed, void* out_p, void* out_m,
                               int batch, int nhalf, int nm, int lmax,
                               int spin, int m0, int nb, void* stream) {
  return launch_nb<double, false>(fnp, sp, fnm, sm, x, nullptr, logch,
                                  logsh, seed, out_p, out_m, batch, nhalf, nm,
                                  lmax, spin, m0, nb, stream);
}

// The compensated float32 launch: xr holds each ring's r = x_lo / x_hi.
int heracles_analysis_pair_comp_f32(const void* fnp, const void* sp,
                                    const void* fnm, const void* sm,
                                    const void* x, const void* xr,
                                    const void* logch, const void* logsh,
                                    const void* seed, void* out_p,
                                    void* out_m, int batch, int nhalf, int nm,
                                    int lmax, int spin, int m0, int nb,
                                    void* stream) {
  return launch_nb<float, true>(fnp, sp, fnm, sm, x, xr, logch, logsh, seed,
                                out_p, out_m, batch, nhalf, nm, lmax, spin, m0,
                                nb, stream);
}

// The float32 launch in groups of nb maps (2 or 4: the grouped kernel)
// with ``counts`` (3 x uint64, zeroed by the caller) taking the warps'
// sub-chunks on the steady, dead and full paths.
int heracles_analysis_pair_paths_f32(const void* fnp, const void* sp,
                                     const void* fnm, const void* sm,
                                     const void* x, const void* logch,
                                     const void* logsh, const void* seed,
                                     void* out_p, void* out_m, void* counts,
                                     int batch, int nhalf, int nm, int lmax,
                                     int spin, int m0, int nb, void* stream) {
  return launch_paths<false>(fnp, sp, fnm, sm, x, nullptr, logch, logsh, seed,
                             out_p, out_m, counts, batch, nhalf, nm, lmax,
                             spin, m0, nb, stream);
}

// The compensated float32 launch with the path counts.
int heracles_analysis_pair_comp_paths_f32(
    const void* fnp, const void* sp, const void* fnm, const void* sm,
    const void* x, const void* xr, const void* logch, const void* logsh,
    const void* seed, void* out_p, void* out_m, void* counts, int batch,
    int nhalf, int nm, int lmax, int spin, int m0, int nb, void* stream) {
  return launch_paths<true>(fnp, sp, fnm, sm, x, xr, logch, logsh, seed,
                            out_p, out_m, counts, batch, nhalf, nm, lmax, spin,
                            m0, nb, stream);
}

// Resident blocks per SM of the pair analysis in groups of nb maps (its
// shared memory does not depend on lmax), written to *blocks; variant 0 is
// the float32 kernel, 1 the float64 one, 2 the compensated float32 one.
// Returns the CUDA error code.
int heracles_analysis_pair_blocks_per_sm(int variant, int nb, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (variant == 1) return blocks_nb<double, false>(nb, n);
  if (variant == 2) return blocks_nb<float, true>(nb, n);
  return blocks_nb<float, false>(nb, n);
}

}  // extern "C"
