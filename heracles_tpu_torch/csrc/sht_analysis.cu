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
//     ring; kComp = false compiles to the plain kernel;
//   * a batch runs in groups of NB = 1, 2, 4 or 8 maps, the twin of the
//     reference's nb program (_kernel's nb, pallas_sht.py:714, picked at
//     :3123): NB = 1 is the kernel above, one block per (order, map);
//     NB > 1 is analysis_group_kernel, one block per (order, group),
//     which runs the recurrence once for the group (5 of a map-triple's 9
//     operations) and contracts it against the group's spectra on the
//     tensor cores (3xTF32 mma.sync in float32 and comp, DMMA in
//     float64).  It has two bodies, chosen by the type:
//   * float64 runs the tc body (tc_group_body, tc_contract.cuh, DMMA):
//     each warp in turn runs the recurrence of its 64 rings (2 a thread,
//     a ring tile of 256), stages a sub-chunk of 8 multipoles through
//     shared memory (the transpose from one ring a lane to one multipole
//     a lane) and multiplies the tile's spectra, kept whole in A tiles in
//     fragment order (rows: each map's (re, im) at both parities, half of
//     each product spent on rows a multipole does not read), by them; the
//     warps meet once per section of 128 multipoles.  Its shared memory
//     (58 / 90 / 154 KB at NB 2 / 4 / 8) sets its blocks per SM.  It is
//     not the warp-specialised body's float64 instantiation (mma.sync has
//     a DMMA form) because that does not fit the block's 227 KB as laid
//     out below: a stage of 32 multipoles x 64 rings is 16 KB in float64,
//     256 KB for 8 producers x 2 stages; at windows of 16 the stages take
//     128 KB and part[] 66 / 132 KB at NB 4 / 8 (276 KB at NB 8).  Whether
//     a narrower float64 layout (fewer producers or windows of 16 at NB 2
//     and 4) would beat the tc body was not measured;
//   * float32 and comp run the warp-specialised body (ws_group_body,
//     ws_pipeline.cuh): 8 producer warps run the recurrence of 64 rings
//     each (a ring tile of 512) and 8 consumer warps contract, each
//     paired with one producer through a ring of 2 stages in shared
//     memory guarded by full / empty mbarriers.  A stage is a window of
//     32 multipoles x the producer's 64 rings (8 KB), stored by the
//     producer in the consumer's A-fragment order (rows of one parity:
//     multipoles 4 g + p and 4 g + 2 + p of row g; bit 2 of a lane's slot
//     flipped in odd k-steps, so that a quarter-warp's 16-byte stores
//     fall on distinct banks); the consumer keeps its rings' spectra,
//     split into TF32 hi and lo once per ring tile, as B fragments in
//     registers (64 a column tile of 4 maps) and per stage runs 8 k-steps
//     x 2 parities x 3 mma.sync m16n8k8 a column tile: A = 16 multipoles
//     of one parity, B = that parity's spectra, so no product is spent
//     on the other parity, and the spectra are split once per tile, not
//     at every k-step.  The emitted values are split in the consumer (4
//     bytes a value through shared memory, not 8).  The producers drop
//     spin 0's + a0 (-0.0: the same values) and read the coefficient
//     table as (a1, b) pairs, two rows a 16-byte read.  The consumer
//     warps meet once per section of 128 multipoles (part[], a padded
//     row of each (producer, map) so that the stores are conflict-free),
//     where each thread flushes its rows as in NB = 1, their earlier
//     tiles' sums copied in (cp.async) while the section ran.  NB 8 holds
//     two column tiles (128 registers of B fragments): setmaxnreg moves
//     registers from the producers (80) to the consumers (176), whose two
//     tiles share one accumulator chain (lo hi, hi lo, hi hi in turn);
//     NB 2 and 4 keep two chains, (lo hi + hi lo) and hi hi.
//     What bounds it on an H100: shared memory and issue, near each
//     other.  A window of 2048 triples moves 152 wavefronts of 128 B
//     (the stage written and read, 64 each; the table 16; part 8), ~24 ms
//     for two groups of 4 n4096 / l3000 maps at 128 B a clock, and issues
//     ~330 producer and ~270 consumer instructions, ~23 ms at one a clock
//     a scheduler; it runs at about half of that (the two roles wait on
//     each other through 2 stages; a third does not fit).  At NB 8 a
//     window serves 8 maps for ~160 wavefronts and ~650 instructions.
//     The output's read-modify-write over ring tiles (strided rows of 8
//     bytes) costs ~4.5 ms of the two n4096 groups at a tile of 512 (~8
//     at 256).  Not wgmma: its 64 rows of one parity make a stage 128
//     multipoles long, 32 KB a producer's 64 rings, 512 KB for 8
//     producers x 2 stages against the 227 KB a block has; with A read
//     from shared memory the 3xTF32 products would also read each value
//     three times after a split store (20 bytes a triple, not 8).  The
//     tensor pipe is not the limit (the products of two n4096 groups of
//     4 are ~3.6 ms at wgmma's rate).  Times, 8 float32 maps, ms (one
//     H100, 700 W, tools/sht_kernel_bench.py, best of 3): n1024 / l1536
//     nb 2 / 4 / 8: 10.23 / 5.50 / 5.82 (tc body) -> 7.79 / 4.47 / 3.66;
//     n4096 / l3000: 134.89 / 72.96 / 78.77 -> 99.99 / 55.70 / 47.02;
//     comp n1024 13.05 / 6.68 / 6.56 -> 10.21 / 5.67 / 4.37, n4096
//     174.78 / 88.29 / 86.77 -> 132.79 / 70.32 / 54.05: comp's lo stream
//     fits the producers' registers and is faster at both sizes, so it
//     takes this body.  Both bodies sum in another order than NB = 1's,
//     so their outputs agree with it to the float32 (float64) bar, not
//     bit for bit; each launch repeats bit for bit, and a map's bits do
//     not depend on NB within a body's NB 2 / 4 (one chain at NB 8).
//
// C interface (loaded with ctypes): heracles_analysis_spin0_{f32,f64} and
// heracles_analysis_spin0_comp_f32 (with the rings' r after x) launch the
// batch in groups of nb maps (1, 2, 4 or 8, dividing the batch, else
// cudaErrorInvalidValue) on the given stream and return
// cudaGetLastError(); heracles_analysis_spin0_blocks_per_sm gives the
// resident blocks per SM of a variant and nb (the shared memory does not
// depend on lmax), heracles_analysis_spin0_ws whether that launch runs
// the warp-specialised group body;
// heracles_analysis_spin0_{,comp_}paths_f32 are diagnostic launches (nb
// 1, one map a block) that also count the warps' sub-chunks on each path
// (steady, dead, full).
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
#include "ws_pipeline.cuh"

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

// The NB = 1 kernel's use of each emitted value: its 2 FMAs into the
// chunk's sums, at the chunk's multipole kOff + t.
template <typename T, int kOff>
struct Contract {
  const Ring<T> (&rs)[kRings];
  T (&acc)[V];
  __device__ __forceinline__ void operator()(int t, int r, T lam) const {
    const int u = kOff + t;
    // chunks start at j0's parity
    const T fre = (u & 1) ? rs[r].fb[0] : rs[r].fa[0];
    const T fim = (u & 1) ? rs[r].fb[1] : rs[r].fa[1];
    acc[2 * u] = madd(lam, fre, acc[2 * u]);
    acc[2 * u + 1] = madd(lam, fim, acc[2 * u + 1]);
  }
};

// The grouped kernel's: keep it for the group's maps.
template <typename T, int R>
struct Keep {
  T (&lam)[kSub][R];
  __device__ __forceinline__ void operator()(int t, int r, T v) const {
    lam[t][r] = v;
  }
};

// A coefficient table's rows as spin0_steps reads them: rows(t, a1, a0,
// b) gives row t.  TableRows: (a1, a0, b, pad) a row, the NB = 1 kernel's
// and the tc body's table.
template <typename T>
struct TableRows {
  static constexpr bool kA0Zero = false;
  const T* cf;
  __device__ __forceinline__ void operator()(int t, T& a1, T& a0, T& b) {
    load_row(cf + 4 * t, a1, a0, b);
  }
};

// The warp-specialised producers' table: (a1, b) pairs, two rows a 16-byte
// read; spin 0's a0 is -0.0 and the step drops it (wigner::step_a0_zero:
// the same values, bit for bit).
struct PairRows {
  static constexpr bool kA0Zero = true;
  const float* cf;
  float4 v;
  __device__ __forceinline__ void operator()(int t, float& a1, float& a0,
                                             float& b) {
    if (!(t & 1)) v = *reinterpret_cast<const float4*>(cf + 2 * t);
    a1 = (t & 1) ? v.z : v.x;
    b = (t & 1) ? v.w : v.y;
    a0 = -0.f;
  }
};

// kSub steps of the recurrence of the thread's rings from the coefficient
// rows on; on a path that emits, emit(t, r, value) takes step t's value
// of ring r before the step.
template <typename T, Path P, bool kComp, int R, typename Rows, typename Emit>
__device__ __forceinline__ void spin0_steps(Rows rows, Ring<T> (&rs)[R],
                                            const Emit& emit) {
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    T a1, a0, bb;
    rows(t, a1, a0, bb);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Ring<T>& q = rs[r];
      if (P != Path::kDead) {
        const T d = kComp ? Arith<T>::add(q.dc, q.dcl) : q.dc;
        emit(t, r, P == Path::kSteady ? d : d * emit_scaled<T>(q.k));
      }
      const T a1x = Arith<T>::mul(a1, q.x);
      T dn;
      if constexpr (Rows::kA0Zero) {
        dn = wigner::step_a0_zero<T>(a1x, bb, q.dc, q.dp);
      } else {
        dn = step<T>(a1x, a0, bb, q.dc, q.dp);
      }
      if (kComp) {
        T dnl;
        if constexpr (Rows::kA0Zero) {
          dnl = wigner::step_lo_a0_zero<T>(a1x, bb, q.r, q.dc, q.dcl, q.dpl);
        } else {
          dnl = step_lo<T>(a1x, a0, bb, q.r, q.dc, q.dcl, q.dpl);
        }
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
    for (int r = 0; r < R; ++r) {
      if (kComp) {
        rescale_deferred<T>(rs[r].dp, rs[r].dc, rs[r].dpl, rs[r].dcl, rs[r].k);
      } else {
        rescale_deferred<T>(rs[r].dp, rs[r].dc, rs[r].k);
      }
    }
  }
}

// The warp's path for its next sub-chunk (sht_paths.cuh).
template <typename T, int R>
__device__ __forceinline__ Path sub_path(const Ring<T> (&rs)[R]) {
  bool steady = true, dead = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    steady = steady && sht_paths::is_steady(rs[r].k);
    dead = dead && sht_paths::is_dead(rs[r].k);
  }
  return sht_paths::warp_path(steady, dead);
}

// kSub steps on the warp's path, emit taking the values.
template <typename T, bool kComp, int R, typename Emit>
__device__ __forceinline__ void spin0_sub_on(Path path, const T* __restrict__ cf,
                                             Ring<T> (&rs)[R],
                                             const Emit& emit) {
  const TableRows<T> rows{cf};
  if (path == Path::kSteady) {
    spin0_steps<T, Path::kSteady, kComp>(rows, rs, emit);
  } else if (path == Path::kDead) {
    spin0_steps<T, Path::kDead, kComp>(rows, rs, emit);
  } else {
    spin0_steps<T, Path::kFull, kComp>(rows, rs, emit);
  }
}

// Whether any ring of the warp emits from here on: k never decreases, so
// a warp whose every exponent is still below -1 emitted only zeros.
template <typename T, int R>
__device__ __forceinline__ bool warp_live(const Ring<T> (&rs)[R]) {
  bool live = false;
#pragma unroll
  for (int r = 0; r < R; ++r) live = live || rs[r].k >= -1;
  return __any_sync(0xffffffffu, live);
}

template <typename T, int kOff, bool kCount, bool kComp>
__device__ __forceinline__ void spin0_sub_any(const T* __restrict__ cf,
                                              Ring<T> (&rs)[kRings],
                                              T (&acc)[V],
                                              PathCounts<kCount>& tally) {
  const Path path = sub_path(rs);
  tally.add(path);
  spin0_sub_on<T, kComp>(path, cf + 4 * kOff, rs, Contract<T, kOff>{rs, acc});
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

        // a warp that emitted only zeros in this chunk skips its reduction
        T sum = T(0);
        if (warp_live(rings)) {
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

// A group body's ring ``ring`` of the order m (column mc) at the start of
// a ring tile: cos(theta) (and comp's r), the seed of d at l = m, or an
// empty ring past nhalf.
template <typename T, bool kComp>
__device__ __forceinline__ void seed_ring(Ring<T>& p, int ring, int nhalf,
                                          const T* __restrict__ x,
                                          const T* __restrict__ xr,
                                          const double* __restrict__ logch,
                                          const double* __restrict__ logsh,
                                          const double* __restrict__ seed,
                                          int mc, int nm, int m) {
  p.dp = T(0);
  if (kComp) p.dpl = p.dcl = p.r = T(0);
  if (ring < nhalf) {
    const double lch = logch[ring], lsh = logsh[ring];
    p.x = x[ring];
    if (kComp) p.r = xr[ring];
    // seed exponents of cos(t/2) and sin(t/2): both m
    seed_of<T>(seed[mc], seed[nm + mc], double(m), double(m), lch, lsh, p.dc,
               p.k);
  } else {
    p.x = T(0);
    p.dc = T(0);
    p.k = kNoSeed;
  }
}

// Ring slots a lane of both group bodies: 2, the two k of a fragment
// that a lane's slot pair fills (a tile of 256 rings in the tc body's 4
// warps, of 512 in the warp-specialised body's 8 producers).
constexpr int kGR = 2;
constexpr int kGTile = kThreads * kGR;
constexpr int kGSteps = 4 * kGR;  // k-steps of 8 rings: a warp's 32 kGR rings

// The tc body's dynamic shared memory, in elements of T, per warp: its A
// tiles (the ring tile's spectra of the NB maps in fragment order,
// tc_contract.cuh: rows 2 j + c and 2 j + c + 8 of row tile j / 4 hold
// map j's component c at j0's parity and at the other), its staging
// buffer, and its sums of a section, part[NB][kRows][NC].
template <typename T, int NB>
struct GroupSmem {
  static constexpr int kTiles = (NB + 3) / 4;           // row tiles of 16
  static constexpr int kLanes = NB >= 4 ? 32 : 8 * NB;  // lanes with rows
  static constexpr int kStep = tc::step_elems<kLanes>();
  static constexpr int kA = kTiles * kGSteps * kStep;
  static constexpr int kStaged = 2 * 8 * tc::kStage;
  static constexpr int kPart = NB * kRows * NC;
  static constexpr size_t kBytes =
      sizeof(T) * size_t(kWarps) * (kA + kStaged + kPart);
  // blocks an SM for the launch bounds: what the shared memory allows
  // (228 KB an SM, 1 KB reserved a block, the coefficient table beside):
  // 3 / 2 / 1 in float64 at NB 2 / 4 / 8
  static constexpr int kResident = int(
      (228 * 1024) / (kBytes + sizeof(T) * 2 * kRows * 4 + 1024));
};

// The grouped kernel's tc body (NB > 1; float64), the twin of the
// reference's nb program: one block per (order, group of NB maps) runs
// the recurrence of its rings once (Keep) and contracts it against all NB
// maps' spectra on the tensor cores (tc_contract.cuh): per sub-chunk of
// kSub multipoles a warp stages its emitted values and multiplies its A
// tiles by them, D[rows, l] for the 16 rows of each row tile (both
// parities of each map's (re, im)), keeping for each l the rows of its
// parity.  The path of a sub-chunk is a property of the rings, so one
// decision serves the group, and a dead sub-chunk, or one that emitted
// only zeros, costs nothing per map: its sums are zeros.  The warps' sums
// meet in part[] once per section, where the coefficient table's double
// buffer needs a barrier anyway, and are summed in a fixed order and
// flushed as in the NB = 1 kernel; part[] has one buffer, so a second
// barrier closes the flush.  The sums run in another order than the
// NB = 1 kernel's, so the outputs are not its bits; every launch repeats
// bit for bit.
template <typename T, int NB>
__device__ __forceinline__ void tc_group_body(
    const T* __restrict__ f0, const T* __restrict__ f1,
    const T* __restrict__ x, const T* __restrict__ xr,
    const double* __restrict__ logch, const double* __restrict__ logsh,
    const double* __restrict__ seed, T* __restrict__ out, int nhalf, int nm,
    int lmax, int m0, unsigned char* smem) {
  using S = GroupSmem<T, NB>;
  static_assert(NB > 1 && kRows % kSub == 0 && kSub == 8 && kGR % 2 == 0,
                "a group of maps; sub-chunks tile the section; a sub-chunk "
                "is one mma's 8 columns; ring slots in pairs");
  static_assert(sizeof(T) == 8, "float32 and comp run ws_group_body");
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
  const int s = 0;
  const int j0 = m;
  const int ntiles = (nhalf + kGTile - 1) / kGTile;
  // output (g0 + j, l, m) at col + j plane + l rs, (re, im) adjacent
  const size_t plane = size_t(lmax + 1) * nm * 2;
  const size_t col = size_t(g0) * plane + size_t(mc) * 2;
  const size_t rs = size_t(nm) * 2;

  const int lz = (j0 <= lmax && ntiles > 0) ? j0 : lmax + 1;
  for (int l = tid; l < lz; l += kThreads) {
    for (int j = 0; j < NB; ++j) store2(out + col + j * plane + l * rs, T(0), T(0));
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
    // of the registers of the sections
    const T inv = Arith<T>::inv_scale();
    const T* const fe = (j0 & 1) ? f1 : f0;  // F of j0's parity
    const T* const fo = (j0 & 1) ? f0 : f1;
    Ring<T> rings[kGR];
#pragma unroll
    for (int r = 0; r < kGR; ++r) {
      const int ring = tile * kGTile + (warp * kGR + r) * 32 + lane;
      seed_ring<T, false>(rings[r], ring, nhalf, x, xr, logch, logsh, seed,
                          mc, nm, m);
      // this ring is k = lane % 4 + 4 (r % 2) of k-step 8 (r / 2) + lane / 4
      T* const step = at + (8 * (r / 2) + (lane >> 2)) * S::kStep;
      for (int j = 0; j < NB; ++j) {
        T f[4] = {T(0), T(0), T(0), T(0)};
        if (ring < nhalf) {
          const size_t off = ((size_t(g0 + j) * nhalf + ring) * nm + mc) * 2;
          load2(fe + off, f[0], f[1]);
          load2(fo + off, f[2], f[3]);
#pragma unroll
          for (int c = 0; c < 4; ++c) f[c] *= inv;
        }
        T* const tj = step + (j / 4) * kGSteps * S::kStep;
        const int row = 2 * (j % 4);
        tc::put(tj, row * 4 + (lane & 3), r & 1, f[0], f[2]);
        tc::put(tj, (row + 1) * 4 + (lane & 3), r & 1, f[1], f[3]);
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
        T lam[kSub][kGR];
        const Path path = sub_path(rings);
        spin0_sub_on<T, false>(path, &tab[tb][u * kSub][0], rings,
                               Keep<T, kGR>{lam});
        T d[S::kTiles][4] = {};
        if (path != Path::kDead && warp_live(rings)) {
#pragma unroll
          for (int p = 0; p < kGR / 2; ++p) {
            __syncwarp();
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
              tc::stage(stg, lane, t, lam[t][2 * p], lam[t][2 * p + 1]);
            }
            __syncwarp();
            tc::contract<S::kTiles, S::kLanes>(d, stg, at + 8 * p * S::kStep,
                                               kGSteps * S::kStep, lane);
          }
        }
        // lane (g, t) holds row g's sum at multipole 2 t (j0's parity) in
        // d[0] and row g + 8's at 2 t + 1 in d[3]
        const int g = lane >> 2;
        if (g < 2 * NB) {
#pragma unroll
          for (int tq = 0; tq < S::kTiles; ++tq) {
            T* const pj = part +
                          (warp * NB + 4 * tq + g / 2) * (kRows * NC) +
                          (u * kSub + 2 * (lane & 3)) * NC + (g & 1);
            pj[0] = d[tq][0];
            pj[NC] = d[tq][3];
          }
        }
      }
      __syncthreads();
      const int lf = j0 + sec * kRows + tid;
      if (lf <= lmax) {
        const T norm = norm_of<T>(lf);
        for (int j = 0; j < NB; ++j) {
          T* const fo_row = out + col + j * plane + lf * rs;
          T prev[2] = {T(0), T(0)};
          if (tile > 0) load2(fo_row, prev[0], prev[1]);
          T re = T(0), im = T(0);
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            T pr, pi;
            load2(&part[(w * NB + j) * (kRows * NC) + NC * tid], pr, pi);
            re += pr;
            im += pi;
          }
          store2(fo_row, prev[0] + re * norm, prev[1] + im * norm);
        }
      }
      __syncthreads();
    }
  }
}

// The warp-specialised group body's shape (float32 and comp, see
// ws_group_body): kPairs producer warps, each running the recurrence of 64
// rings of the block's ring tile (kGR = 2 a lane, as in the tc body), and
// as many consumer warps, each contracting what one producer emits against
// the group's spectra on the tensor cores, for all kNT column tiles of 8
// (4 maps' re and im).  Between each producer and its consumer a ring of
// kStages stages, each a window of kWin multipoles of the producer's 64
// rings in the consumer's A-fragment order.
template <int NB>
struct WsShape {
  static constexpr int kNT = (NB + 3) / 4;  // column tiles of 8
  static constexpr int kPairs = 8;          // producer (and consumer) warps
  static constexpr int kTile = kPairs * 32 * kGR;  // rings: 512
  static constexpr int kThreads = 2 * 32 * kPairs;
  // the consumer threads' flush: row ct % 128 of a section, kFlushMaps maps
  static constexpr int kFlushMaps = (NB * kRows) / (32 * kPairs);
  static constexpr int kStages = 2;
  static constexpr int kWin = 32;          // multipoles a stage
  static constexpr int kKSteps = 4 * kGR;  // k-steps of 8 rings: 64 rings
  static constexpr int kStep = 32 * 4;     // a k-step's fragments
  static constexpr int kParity = kKSteps * kStep;  // one parity's 16 rows
  static constexpr int kStage = 2 * kParity;       // floats a stage
  // part[] rows of one (producer, map): 128 (re, im) and a pair of
  // padding, so that a consumer warp's stores of 8 rows x 4 maps fall on
  // distinct banks
  static constexpr int kPartRows = kRows * NC + 2;
  static constexpr int kPart = kPairs * NB * kPartRows;
  static constexpr int kPrev = NB * kRows * NC;  // the rows' earlier sums
  static constexpr size_t kBytes =
      sizeof(float) * (size_t(kPairs) * kStages * kStage + kPart + kPrev) +
      sizeof(unsigned long long) * 2 * kPairs * kStages +
      sizeof(int) * kPairs * kStages;
  static constexpr int kResident = 1;
  // registers a thread after setmaxnreg where the consumers hold two
  // column tiles of spectra (NB = 8: 128 registers of B fragments); 0:
  // the launch's even share (128 of the 16 warps' 65536) serves both
  static constexpr int kProducerRegs = kNT == 2 ? 80 : 0;
  static constexpr int kConsumerRegs = kNT == 2 ? 256 - kProducerRegs : 0;
  static_assert(kProducerRegs + kConsumerRegs <= 256 &&
                    (NB * kRows) % (32 * kPairs) == 0,
                "the warps' registers fit the file; the flush tiles the "
                "section's rows and maps");
};

// The place of a consumer lane's A fragment in a k-step of a stage: lane
// c's four values at 4 c, with bit 2 of c flipped in odd k-steps, so that
// the producer lanes of a quarter-warp (two k-steps, the same rows) store
// their 16 bytes on distinct banks while a consumer's k-step stays one
// 512-byte read.
__device__ __forceinline__ int ws_frag(int ks, int c) {
  return 4 * (c ^ (4 * (ks & 1)));
}

// kSub steps of a producer's rings (sub-chunk u of its window), their
// emitted values stored where the consumer's A fragments read them: rows
// g and g + 8 of parity p's tile are the window's multipoles 4 g + p and
// 4 g + 2 + p, so sub-chunk u fills g = 2 u and 2 u + 1, and a lane's two
// rings are k = lane % 4 and lane % 4 + 4 of k-step lane / 4.  ``st`` is
// the stage; a dead sub-chunk stores zeros.
template <Path P, bool kComp, int kParity>
__device__ __forceinline__ void ws_produce(const float* __restrict__ cf,
                                           Ring<float> (&rs)[kGR], float* st,
                                           int lane, int u) {
  float lam[kSub][kGR];
  spin0_steps<float, P, kComp>(PairRows{cf}, rs, Keep<float, kGR>{lam});
  const int ks = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* const at =
        st + ks * 128 + ws_frag(ks, 4 * (2 * u + h) + (lane & 3));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (P != Path::kDead) {
        v = make_float4(lam[4 * h + p][0], lam[4 * h + 2 + p][0],
                        lam[4 * h + p][1], lam[4 * h + 2 + p][1]);
      }
      *reinterpret_cast<float4*>(at + p * kParity) = v;
    }
  }
}

// The grouped kernel's float32 and comp body on Hopper: the tc body's
// recurrence and contraction split between warps of their own (the
// source note has why and the numbers).  Producer warp w runs the
// recurrence of its 64 rings (the same steps, paths and rounding as the tc
// body) and writes each window of kWin multipoles into a stage of its
// ring, in fragment order; consumer warp w holds the spectra of those 64
// rings, split into TF32 hi and lo once per ring tile, as B fragments in
// registers, and per stage runs, for each of its column tiles, 8 k-steps
// x 2 parities x 3 mma.sync m16n8k8 (A = the emitted values of 16
// multipoles of one parity, B = that parity's spectra of 4 maps' re and
// im: no product on rows a multipole does not read).  A window in which
// the producer's rings emitted nothing is flagged and costs its consumer
// no product.  The consumers' sums of a window go to part[] (warp, map,
// row); the consumer warps meet once per section of 128 multipoles, where
// each thread sums the producers' slots of its rows in a fixed order and
// flushes them as the tc body does, with their earlier sums copied in
// while the section ran; the producers meet once per section for the
// coefficient table's double buffer.  Every sum runs in a fixed order, so
// launches repeat bit for bit.
template <bool kComp, int NB>
__device__ __forceinline__ void ws_group_body(
    const float* __restrict__ f0, const float* __restrict__ f1,
    const float* __restrict__ x, const float* __restrict__ xr,
    const double* __restrict__ logch, const double* __restrict__ logsh,
    const double* __restrict__ seed, float* __restrict__ out, int nhalf,
    int nm, int lmax, int m0, unsigned char* smem) {
  using W = WsShape<NB>;
  using Slot = ws::Slot<W::kStages>;
  static_assert(kRows % W::kWin == 0 && W::kWin % kSub == 0 && kGR == 2,
                "windows tile the section; sub-chunks tile a window; a "
                "lane's two rings are a fragment's two k");
  float* const stages = reinterpret_cast<float*>(smem);
  float* const part = stages + W::kPairs * W::kStages * W::kStage;
  float* const prev = part + W::kPart;
  unsigned long long* const full =
      reinterpret_cast<unsigned long long*>(prev + W::kPrev);
  unsigned long long* const empty = full + W::kPairs * W::kStages;
  int* const live = reinterpret_cast<int*>(empty + W::kPairs * W::kStages);
  __shared__ __align__(16) float tab[2][kRows][2];  // a1, b (a0 is -0.0)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mc = blockIdx.x;
  const int m = m0 + mc;
  const int g0 = blockIdx.y * NB;
  const int s = 0;
  const int j0 = m;
  const int ntiles = (nhalf + W::kTile - 1) / W::kTile;
  const size_t plane = size_t(lmax + 1) * nm * 2;
  const size_t col = size_t(g0) * plane + size_t(mc) * 2;
  const size_t rs = size_t(nm) * 2;

  const int lz = (j0 <= lmax && ntiles > 0) ? j0 : lmax + 1;
  for (int l = tid; l < lz; l += W::kThreads) {
    for (int j = 0; j < NB; ++j) {
      store2(out + col + j * plane + l * rs, 0.f, 0.f);
    }
  }
  if (lz > lmax) return;

  const int n = lmax - j0 + 1;
  const int nsec = (n + kRows - 1) / kRows;

  if (tid == 0) {
    for (int i = 0; i < W::kPairs * W::kStages; ++i) {
      ws::bar_init(&full[i], 32);
      ws::bar_init(&empty[i], 32);
    }
    ws::bar_init_fence();
  }
  if (tid < kRows) {
    float a0;
    coef_row<float>(j0 + tid + 1, j0, m, s, lmax, &tab[0][tid][0], &a0,
                    &tab[0][tid][1]);
  }
  __syncthreads();

  if (warp < W::kPairs) {
    // a producer: the recurrence of rings (warp kGR + r) 32 + lane of
    // each tile
    if constexpr (W::kProducerRegs > 0) ws::release_regs<W::kProducerRegs>();
    int q = 0;      // running section count: selects the table buffer
    int taken = 0;  // stages filled
    float* const own = stages + warp * W::kStages * W::kStage;
    for (int tile = 0; tile < ntiles; ++tile) {
      Ring<float> rings[kGR];
#pragma unroll
      for (int r = 0; r < kGR; ++r) {
        const int ring = tile * W::kTile + (warp * kGR + r) * 32 + lane;
        seed_ring<float, kComp>(rings[r], ring, nhalf, x, xr, logch, logsh,
                                seed, mc, nm, m);
      }
      for (int sec = 0; sec < nsec; ++sec, ++q) {
        const int tb = q & 1;
        const int sn = (sec + 1 < nsec) ? sec + 1 : 0;
        // the next section's row, stored after the windows: its float64
        // latency is not waited on here
        float ca1 = 0.f, ca0, cb = 0.f;
        if (tid < kRows) {
          coef_row<float>(j0 + sn * kRows + tid + 1, j0, m, s, lmax, &ca1,
                          &ca0, &cb);
        }
        const int nwin =
            (min(kRows, n - sec * kRows) + W::kWin - 1) / W::kWin;
        for (int w = 0; w < nwin; ++w, ++taken) {
          const Slot slot(taken);
          const int idx = warp * W::kStages + slot.stage;
          ws::wait(&empty[idx], slot.parity ^ 1u);
          float* const st = own + slot.stage * W::kStage;
          bool any = false;
#pragma unroll 1
          for (int u = 0; u < W::kWin / kSub; ++u) {
            const float* cf = &tab[tb][w * W::kWin + u * kSub][0];
            const Path path = sub_path(rings);
            if (path == Path::kSteady) {
              ws_produce<Path::kSteady, kComp, W::kParity>(cf, rings, st,
                                                           lane, u);
            } else if (path == Path::kDead) {
              ws_produce<Path::kDead, kComp, W::kParity>(cf, rings, st, lane,
                                                         u);
            } else {
              ws_produce<Path::kFull, kComp, W::kParity>(cf, rings, st, lane,
                                                         u);
            }
            // warp-uniform: a path and warp_live are the warp's votes
            any = any || (path != Path::kDead && warp_live(rings));
          }
          if (lane == 0) live[idx] = any;
          ws::arrive(&full[idx]);
        }
        if (tid < kRows) {
          tab[tb ^ 1][tid][0] = ca1;
          tab[tb ^ 1][tid][1] = cb;
        }
        ws::named_sync(1, 32 * W::kPairs);
      }
    }
  } else {
    // a consumer: producer pw's rings against every column tile h, columns
    // c = 2 (map - 4 h) + (re, im)
    if constexpr (W::kConsumerRegs > 0) ws::claim_regs<W::kConsumerRegs>();
    const int pw = warp - W::kPairs;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ct = tid - 32 * W::kPairs;  // the consumer thread: its flush
    const unsigned nthreads = 32 * W::kPairs;
    int taken = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      // B(k, c) of k-step ks, parity p and column tile h: the spectrum of
      // ring k of the k-step (lane k % 4's slot k / 4 of producer pw) at
      // column c, times 2^-60, split; lane (g, t) holds B(t, g) and
      // B(t + 4, g)
      unsigned bh[W::kNT][2][W::kKSteps][2], bl[W::kNT][2][W::kKSteps][2];
      {
        const float inv = Arith<float>::inv_scale();
        const float* const fe = (j0 & 1) ? f1 : f0;  // F of j0's parity
        const float* const fo = (j0 & 1) ? f0 : f1;
#pragma unroll
        for (int h = 0; h < W::kNT; ++h) {
          const int j = 4 * h + (g >> 1);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int ks = 0; ks < W::kKSteps; ++ks) {
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int ring =
                    tile * W::kTile + (pw * kGR + i) * 32 + 4 * ks + t;
                float v = 0.f;
                if (ring < nhalf && j < NB) {
                  const size_t off =
                      ((size_t(g0 + j) * nhalf + ring) * nm + mc) * 2 +
                      (g & 1);
                  v = (p ? fo : fe)[off] * inv;
                }
                tc::split(v, bh[h][p][ks][i], bl[h][p][ks][i]);
              }
            }
          }
        }
      }
      for (int sec = 0; sec < nsec; ++sec) {
        const int nwin =
            (min(kRows, n - sec * kRows) + W::kWin - 1) / W::kWin;
        // the thread's flush: row u of the section, maps j1 <= j < j2;
        // their sums over the earlier tiles are copied in while the
        // section runs
        const int u = ct % kRows;
        const int lf = j0 + sec * kRows + u;
        const int j1 = W::kFlushMaps * (ct / kRows);
        const int j2 = j1 + W::kFlushMaps;
        if (tile > 0 && lf <= lmax) {
          for (int j = j1; j < j2; ++j) {
            ws::copy8_async(&prev[(j * kRows + u) * NC],
                            out + col + j * plane + lf * rs);
          }
          ws::commit_copies();
        }
        for (int w = 0; w < nwin; ++w, ++taken) {
          const Slot slot(taken);
          const int idx = pw * W::kStages + slot.stage;
          ws::wait(&full[idx], slot.parity);
          // per (column tile, parity) two chains, summed at the window's
          // end, the small products (lo hi, hi lo) and hi hi; with two
          // column tiles one chain, lo hi, hi lo and hi hi in turn (the
          // registers of its second B tile)
          float d[W::kNT][2][4] = {};
          if (live[idx]) {
            const float* const a = stages + idx * W::kStage;
            float sm[W::kNT][2][4] = {};
            float bg[2][4] = {};  // the hi hi chain of one column tile
#pragma unroll
            for (int ks = 0; ks < W::kKSteps; ++ks) {
#pragma unroll
              for (int p = 0; p < 2; ++p) {
                const float4 av = *reinterpret_cast<const float4*>(
                    a + p * W::kParity + ks * W::kStep + ws_frag(ks, lane));
                uint4 ah, alo;
                tc::split(av.x, ah.x, alo.x);
                tc::split(av.y, ah.y, alo.y);
                tc::split(av.z, ah.z, alo.z);
                tc::split(av.w, ah.w, alo.w);
#pragma unroll
                for (int h = 0; h < W::kNT; ++h) {
                  tc::mma(sm[h][p], alo, bh[h][p][ks]);
                  tc::mma(sm[h][p], ah, bl[h][p][ks]);
                  tc::mma(W::kNT == 1 ? bg[p] : sm[h][p], ah, bh[h][p][ks]);
                }
              }
            }
#pragma unroll
            for (int h = 0; h < W::kNT; ++h) {
#pragma unroll
              for (int p = 0; p < 2; ++p) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  d[h][p][i] =
                      W::kNT == 1 ? sm[h][p][i] + bg[p][i] : sm[h][p][i];
                }
              }
            }
          }
          ws::arrive(&empty[idx]);
          // lane (g, t) holds map 4 h + t's (re, im) at row g
          // (d[h][p][0..1]) and row g + 8 (d[h][p][2..3]): the window's
          // multipoles 4 g + p and 4 g + 2 + p
#pragma unroll
          for (int h = 0; h < W::kNT; ++h) {
            const int jt = 4 * h + t;
            if (jt < NB) {
#pragma unroll
              for (int p = 0; p < 2; ++p) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                  const int r = w * W::kWin + 4 * g + 2 * hf + p;
                  store2(&part[(pw * NB + jt) * W::kPartRows + r * NC],
                         d[h][p][2 * hf], d[h][p][2 * hf + 1]);
                }
              }
            }
          }
        }
        ws::named_sync(2, nthreads);
        if (lf <= lmax) {
          const float norm = norm_of<float>(lf);
          if (tile > 0) ws::wait_copies();
          for (int j = j1; j < j2; ++j) {
            float* const fo_row = out + col + j * plane + lf * rs;
            float pv[2] = {0.f, 0.f};
            if (tile > 0) load2(&prev[(j * kRows + u) * NC], pv[0], pv[1]);
            float re = 0.f, im = 0.f;
#pragma unroll
            for (int v = 0; v < W::kPairs; ++v) {
              float pr, pi;
              load2(&part[(v * NB + j) * W::kPartRows + u * NC], pr, pi);
              re += pr;
              im += pi;
            }
            store2(fo_row, pv[0] + re * norm, pv[1] + im * norm);
          }
        }
        ws::named_sync(2, nthreads);
      }
    }
  }
}

// Which body a grouped instantiation runs, and its launch: float64 runs
// the tc body, float32 and comp the warp-specialised one (the source note
// has why).  heracles_analysis_spin0_ws reports kWS to the caller, so that
// this is the one place of the rule.
template <typename T, bool kComp, int NB>
struct GroupLaunch {
  static constexpr bool kWS = sizeof(T) == 4;
  static constexpr int kBlock = kWS ? WsShape<NB>::kThreads : kThreads;
  static constexpr int kResident =
      kWS ? WsShape<NB>::kResident : GroupSmem<T, NB>::kResident;
  static constexpr size_t kBytes =
      kWS ? WsShape<NB>::kBytes : GroupSmem<T, NB>::kBytes;
};

template <typename T, bool kComp, int NB>
__global__ void __launch_bounds__(GroupLaunch<T, kComp, NB>::kBlock,
                                  GroupLaunch<T, kComp, NB>::kResident)
    analysis_group_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                          const T* __restrict__ x, const T* __restrict__ xr,
                          const double* __restrict__ logch,
                          const double* __restrict__ logsh,
                          const double* __restrict__ seed, T* __restrict__ out,
                          int nhalf, int nm, int lmax, int m0) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (GroupLaunch<T, kComp, NB>::kWS) {
    ws_group_body<kComp, NB>(f0, f1, x, xr, logch, logsh, seed, out, nhalf,
                             nm, lmax, m0, smem);
  } else {
    tc_group_body<T, NB>(f0, f1, x, xr, logch, logsh, seed, out, nhalf, nm,
                         lmax, m0, smem);
  }
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

// Lets the grouped kernel take its shared memory, and returns it.
template <typename T, bool kComp, int NB>
cudaError_t group_smem_attr(size_t* smem) {
  *smem = GroupLaunch<T, kComp, NB>::kBytes;
  return cudaFuncSetAttribute(analysis_group_kernel<T, kComp, NB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(*smem));
}

template <typename T, bool kComp, int NB>
int launch_group(const void* f0, const void* f1, const void* x,
                 const void* xr, const void* logch, const void* logsh,
                 const void* seed, void* out, int batch, int nhalf, int nm,
                 int lmax, int m0, void* stream) {
  if (batch == 0 || nm == 0) return int(cudaSuccess);
  size_t smem = 0;
  const cudaError_t err = group_smem_attr<T, kComp, NB>(&smem);
  if (err != cudaSuccess) return int(err);
  analysis_group_kernel<T, kComp, NB>
      <<<dim3(nm, batch / NB), GroupLaunch<T, kComp, NB>::kBlock, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(f0), static_cast<const T*>(f1),
          static_cast<const T*>(x), static_cast<const T*>(xr),
          static_cast<const double*>(logch),
          static_cast<const double*>(logsh), static_cast<const double*>(seed),
          static_cast<T*>(out), nhalf, nm, lmax, m0);
  return int(cudaGetLastError());
}

// The launch of groups of nb maps: nb = 1 is the kernel above, 2, 4 and 8
// the grouped kernel; any other nb, or one that does not divide the batch,
// is refused.
template <typename T, bool kComp>
int launch_nb(const void* f0, const void* f1, const void* x, const void* xr,
              const void* logch, const void* logsh, const void* seed,
              void* out, int batch, int nhalf, int nm, int lmax, int m0,
              int nb, void* stream) {
  if (nb < 1 || batch % nb != 0) return int(cudaErrorInvalidValue);
  switch (nb) {
    case 1:
      return launch<T, kComp, false>(f0, f1, x, xr, logch, logsh, seed, out,
                                     batch, nhalf, nm, lmax, m0, nullptr,
                                     stream);
    case 2:
      return launch_group<T, kComp, 2>(f0, f1, x, xr, logch, logsh, seed, out,
                                       batch, nhalf, nm, lmax, m0, stream);
    case 4:
      return launch_group<T, kComp, 4>(f0, f1, x, xr, logch, logsh, seed, out,
                                       batch, nhalf, nm, lmax, m0, stream);
    case 8:
      return launch_group<T, kComp, 8>(f0, f1, x, xr, logch, logsh, seed, out,
                                       batch, nhalf, nm, lmax, m0, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, bool kComp, int NB>
int group_blocks(int* n) {
  size_t smem = 0;
  const cudaError_t err = group_smem_attr<T, kComp, NB>(&smem);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, analysis_group_kernel<T, kComp, NB>,
      GroupLaunch<T, kComp, NB>::kBlock, smem));
}

// Whether the grouped launch at nb runs the warp-specialised body (0 at
// nb = 1 or an nb without a group).
template <typename T, bool kComp>
int ws_nb(int nb) {
  switch (nb) {
    case 2:
      return GroupLaunch<T, kComp, 2>::kWS;
    case 4:
      return GroupLaunch<T, kComp, 4>::kWS;
    case 8:
      return GroupLaunch<T, kComp, 8>::kWS;
    default:
      return 0;
  }
}

template <typename T, bool kComp>
int blocks_nb(int nb, int* n) {
  switch (nb) {
    case 1:
      return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, analysis_kernel<T, kComp, false>, kThreads, 0));
    case 2:
      return group_blocks<T, kComp, 2>(n);
    case 4:
      return group_blocks<T, kComp, 4>(n);
    case 8:
      return group_blocks<T, kComp, 8>(n);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int heracles_analysis_spin0_f32(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, int m0, int nb,
                                void* stream) {
  return launch_nb<float, false>(fe, fo, x, nullptr, logch, logsh, seed, out,
                                 batch, nhalf, nm, lmax, m0, nb, stream);
}

int heracles_analysis_spin0_f64(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, int m0, int nb,
                                void* stream) {
  return launch_nb<double, false>(fe, fo, x, nullptr, logch, logsh, seed, out,
                                  batch, nhalf, nm, lmax, m0, nb, stream);
}

// The compensated float32 launch: xr holds each ring's r = x_lo / x_hi.
int heracles_analysis_spin0_comp_f32(const void* fe, const void* fo,
                                     const void* x, const void* xr,
                                     const void* logch, const void* logsh,
                                     const void* seed, void* out, int batch,
                                     int nhalf, int nm, int lmax, int m0,
                                     int nb, void* stream) {
  return launch_nb<float, true>(fe, fo, x, xr, logch, logsh, seed, out, batch,
                                nhalf, nm, lmax, m0, nb, stream);
}

// The float32 launch with ``counts`` (3 x uint64, zeroed by the caller)
// taking the warps' sub-chunks on the steady, dead and full paths; the
// counted kernel is the nb = 1 one, any other nb is refused.
int heracles_analysis_spin0_paths_f32(const void* fe, const void* fo,
                                      const void* x, const void* logch,
                                      const void* logsh, const void* seed,
                                      void* out, void* counts, int batch,
                                      int nhalf, int nm, int lmax, int m0,
                                      int nb, void* stream) {
  if (nb != 1) return int(cudaErrorInvalidValue);
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
                                           int nb, void* stream) {
  if (nb != 1) return int(cudaErrorInvalidValue);
  return launch<float, true, true>(fe, fo, x, xr, logch, logsh, seed, out,
                                   batch, nhalf, nm, lmax, m0, counts, stream);
}

// Resident blocks per SM of the spin-0 analysis in groups of nb maps (its
// shared memory does not depend on lmax), written to *blocks; variant 0 is
// the float32 kernel, 1 the float64 one, 2 the compensated float32 one.
// Returns the CUDA error code.
int heracles_analysis_spin0_blocks_per_sm(int variant, int nb, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (variant == 1) return blocks_nb<double, false>(nb, n);
  if (variant == 2) return blocks_nb<float, true>(nb, n);
  return blocks_nb<float, false>(nb, n);
}

// 1 if the spin-0 analysis' launch of a variant (as above) in groups of
// nb maps runs the warp-specialised group body, else 0.
int heracles_analysis_spin0_ws(int variant, int nb) {
  if (variant == 1) return ws_nb<double, false>(nb);
  if (variant == 2) return ws_nb<float, true>(nb);
  return ws_nb<float, false>(nb);
}

const char* heracles_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
