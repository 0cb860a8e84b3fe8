// Exponential-of-semicircle (ES) kernel spreading of points onto the torus
// grid, for NVIDIA Hopper (sm_90a).
//
// Replaces heracles_tpu/ops/_spread.cpp:42 spread_es, the host C++ loop of
// the gridded adjoint synthesis (heracles_tpu/ops/nufft.py); the JAX
// package ran it on the host because a TPU elementwise scatter is slow.
// Here the scatter runs on the card and the grid never leaves it.
//
// What it computes: for every point p and row r,
//   pad[r, jt + a, jp + b] += v[r, p] * kappa((jt + a - ut) / (w/2))
//                                     * kappa((jp + b - up) / (w/2)),
// a, b = 0..w-1, with kappa(z) = exp(beta (sqrt(1 - z^2) - 1)) on |z| < 1,
// ut = theta / ht - 1/2 (grid rows at (j + 1/2) ht), up = phi / hp, and
// (jt, jp) the stencil's first cell, ceil(u - w/2), wrapped into the torus
// with ut and up shifted by the same amount (the weights' arguments are
// unchanged).  The grid is wrap-padded, (ntheta + w) x (nphi + w): a
// stencil that runs past the torus lands in the margin, which the caller
// folds back onto the start (nufft.fold_padded), so no addition needs a
// modulo.  Values are real (ncomp 1) or complex (ncomp 2, interleaved).
//
// What bounds it: w^2 ncomp additions per (point, row) at random places
// in a grid far larger than L2 (4102^2 x 8 bytes at lmax 1000).  Done as
// float64 atomics into the grid straight from each point, they were the
// whole cost; the bound (each input read once, the grid written once) is
// ~60x below that.  Next come 2 w float64 exp + sqrt per (point, row) and
// the scattered traffic of sorting the points.
//
// Design: the subproblem method of cuFINUFFT (Shih et al., IPDPSW 2021),
// in float64.  The points are sorted by grid tile on the card, each tile
// is summed in shared memory, and each tile reaches the grid in one pass
// of coalesced global atomics.  Four stages, all on the launch's stream,
// with no host readback between them:
//
//   A. bin (one thread per point): the point's stencil corner (jt, jp)
//      picks its bin, the kTile x kTile tile (jt / kTile, jp / kTile) of
//      the unpadded torus; an int32 atomicAdd on the bin's count (one per
//      group of a warp's lanes in one bin, __match_any_sync) returns the
//      point's slot in its bin, and an atomicMax (only where a point's is
//      larger) keeps the bin's largest exponent of |v| per row.  ut and up
//      are computed with explicit round-to-nearest products (no FMA
//      contraction), so the bins equal nufft.bin_points_plain's exactly.
//      The point's record (ut, up, jt, jp and its values, whole 32-byte
//      sectors) is written in input order, coalesced.  The blocks take
//      the input's chunks in a scrambled order (chunk b P mod nblocks, P
//      a prime near nblocks / 1.618), so that blocks that run together
//      take points far apart: points sorted by position would otherwise
//      all meet at the counters of one row of tiles.
//   B. scan (one block, over tiles of 8192 bins read coalesced): the
//      exclusive prefix of the bins' counts (each bin's offset) and of
//      their subproblems, ceil(count / kMaxSub), and the map from each
//      subproblem to its bin.
//   C. order (one thread per point, the chunks in the bin stage's order):
//      order[offset[bin] + slot] = p, the counting sort of the host code
//      (_spread.cpp:77-97) done on the card.  Only the 4-byte index moves:
//      scattered 32-byte records cost several times a scattered index,
//      and a record is read once, by the spread stage, through the index.
//   D. spread (one block per (subproblem, row)): the grid has an upper
//      bound of ceil(npts / kMaxSub) + nbins blocks in x, each reads its
//      bin from the scan's map (its chunk is its distance from the bin's
//      first subproblem; a binary search in the prefix cost a sparse page
//      at lmax 3000 17 dependent loads a block), and blocks past the
//      total return at once.  The block zeroes its tile of
//      (kTile + w - 1)^2 ncomp cells in shared memory, adds its <= kMaxSub
//      points' w^2 products into it (one thread per point, its 2 w weights
//      in registers), and after a barrier adds the tile's nonzero cells to
//      the padded grid, one float64 atomicAdd per cell, along phi.  A point
//      of bin (bt, bp) touches rows jt .. jt + w - 1 <= bt kTile + kTile +
//      w - 2, so the tile with its halo of w - 1 holds every addition; its
//      extent is clipped to the padded grid (ntheta need not be a multiple
//      of kTile).
//
// How a tile is summed.  sm_90 has no float64 (nor 64-bit integer) add in
// shared memory: atomicAdd on a shared double compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64) that took twice the time of
// the same additions without atomics, and warp-private tiles (one point
// per warp at a time, no atomics) lost at w 6.  So the tile holds fixed
// point in three native 32-bit integer atomics per addition: with 2^e
// above the bin's largest finite |v| in the row (weights are <= 1), each
// contribution x becomes q = rint(x 2^(52 - e)), |q| <= 2^52, split as q =
// l0 + 2^22 l1 + 2^44 l2 (l0, l1 in [0, 2^22), l2 signed), each limb
// summed in its own 32-bit word: at most kMaxSub = 1024 contributions per
// cell keep every limb sum inside 32 bits.  The flush rebuilds the int64
// sum exactly and scales it back.  Rounding q costs at most 2^(e - 53) <=
// max |v| 2^-52 per contribution, the size of a float64 rounding of the
// bin's largest value; integer sums are exact, so a tile does not
// depend on the order of its adds (the global atomics' order still varies
// from run to run, and the result with it, at the rounding level).  A
// point with a non-finite value adds straight to the grid, as the plain
// version adds it.
//
// Scratch (allocated by the caller, nothing here allocates): key (npts
// int2: bin, slot), counts (nbins int32), offsets and subs (nbins + 1
// int32, the totals last), sub_bin (a bin per subproblem: at most
// ceil(npts / kMaxSub) + nbins int32), emax (nbins x nrows int32: the
// bins' largest exponents), records (npts x record_stride doubles), order
// (npts int32: the points' original indices in bin order).
//
// C interface (loaded with ctypes): heracles_spread_es runs the stages in
// the mask `stages` (1 bin + scan, 2 order, 4 spread) on the given stream
// and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kTile = 32;      // grid cells on a side of a bin's tile
constexpr int kMaxSub = 1024;  // points of a subproblem: the limbs' headroom
constexpr double kTwoPi = 6.283185307179586;

// A point's record, record_stride(nrows ncomp) doubles: ut, up, (jt, jp)
// as two int32, then its nrows x ncomp values, zero-padded to whole
// 32-byte sectors.
__host__ __device__ constexpr int record_stride(int nvals) {
  return 4 * ((3 + nvals + 3) / 4);
}

// The biased exponent of |v| (0 for zero and subnormals, 2047 for inf and
// NaN): |v| < 2^(exponent - 1022).
__device__ __forceinline__ int exponent(double v) {
  return (__double2hiint(v) >> 20) & 0x7ff;
}

// The stencil's first cell, wrapped into [0, n), and the position u
// shifted with it.
__device__ __forceinline__ int64_t first_cell(double& u, double half_w,
                                              int64_t n) {
  const int64_t j = static_cast<int64_t>(ceil(u - half_w));
  int64_t jw = j % n;
  if (jw < 0) jw += n;
  u += static_cast<double>(jw - j);
  return jw;
}

__device__ __forceinline__ double es_weight(double u, int64_t j, int w,
                                            double beta) {
  const double z = (static_cast<double>(j) - u) * (2.0 / w);
  const double t = 1.0 - z * z;
  return t > 0.0 ? exp(beta * (sqrt(t) - 1.0)) : 0.0;
}

// -- A. bin ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    bin_kernel(const double* __restrict__ theta,
               const double* __restrict__ phi,
               const double* __restrict__ values, int64_t npts, int nrows,
               int ncomp, int64_t ntheta, int64_t nphi, double half_w,
               int nbp, int64_t spread, int* __restrict__ counts,
               int* __restrict__ emax, int2* __restrict__ key,
               double* __restrict__ records) {
  // block b takes chunk b spread mod gridDim.x: blocks that run together
  // take chunks far apart, so that points sorted by position do not all
  // meet at the same few counters
  const int64_t chunk = int64_t(blockIdx.x) * spread % gridDim.x;
  const int64_t p = chunk * kThreads + threadIdx.x;
  const bool valid = p < npts;
  const int nvals = nrows * ncomp;
  double* rec = records + p * record_stride(nvals);
  int bin = -1;
  if (valid) {
    // the products rounded apart from the subtraction, as torch does
    double ut = __dsub_rn(__dmul_rn(theta[p], double(ntheta) / kTwoPi), 0.5);
    double up = __dmul_rn(phi[p], double(nphi) / kTwoPi);
    const int64_t jt = first_cell(ut, half_w, ntheta);
    const int64_t jp = first_cell(up, half_w, nphi);
    bin = int(jt / kTile) * nbp + int(jp / kTile);
    reinterpret_cast<double2*>(rec)[0] = make_double2(ut, up);
    reinterpret_cast<int2*>(rec)[2] = make_int2(int(jt), int(jp));
    for (int e = 3 + nvals; e < record_stride(nvals); ++e) rec[e] = 0.0;
  }
  // one atomic per group of lanes in one bin
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (valid && lane == leader) base = atomicAdd(counts + bin, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (valid) key[p] = make_int2(bin, base + rank);
  for (int r = 0; r < nrows; ++r) {
    int e = 0;
    for (int c = 0; c < ncomp; ++c) {
      const double v = valid ? values[(r * npts + p) * ncomp + c] : 0.0;
      if (valid) rec[3 + r * ncomp + c] = v;
      const int ev = exponent(v);
      if (ev < 2047) e = max(e, ev);  // non-finite values take another path
    }
    e = __reduce_max_sync(peers, e);
    // the bin's exponent only grows: most points need no atomic
    int* em = emax + int64_t(bin) * nrows + r;
    if (valid && lane == leader && e > *em) atomicMax(em, e);
  }
}

// -- B. scan ---------------------------------------------------------------

// inclusive scan of x over the block's threads; `total` gets the sum
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[31];
  return x + (warp ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ counts, int nbins,
                int* __restrict__ offsets, int* __restrict__ subs,
                int* __restrict__ sub_bin) {
  __shared__ int tile[kScanTile];
  __shared__ int sums_c[32], sums_s[32];
  int carry_c = 0, carry_s = 0;
  // tiles of kScanTile bins, read coalesced; each thread scans kScanItems
  // consecutive bins of a tile
  for (int base = 0; base < nbins; base += kScanTile) {
    for (int k = threadIdx.x; k < kScanTile; k += kScanThreads)
      tile[k] = base + k < nbins ? counts[base + k] : 0;
    __syncthreads();
    int n[kScanItems], c = 0, sb = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      n[k] = tile[threadIdx.x * kScanItems + k];
      c += n[k];
      sb += (n[k] + kMaxSub - 1) / kMaxSub;
    }
    int total_c, total_s;
    int oc = block_scan(c, sums_c, total_c) - c + carry_c;
    int os = block_scan(sb, sums_s, total_s) - sb + carry_s;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int b = base + threadIdx.x * kScanItems + k;
      if (b >= nbins) break;
      const int nsub = (n[k] + kMaxSub - 1) / kMaxSub;
      offsets[b] = oc;
      subs[b] = os;
      for (int j = 0; j < nsub; ++j) sub_bin[os + j] = b;
      oc += n[k];
      os += nsub;
    }
    carry_c += total_c;
    carry_s += total_s;
    __syncthreads();  // the tile and the warp sums are read again
  }
  if (threadIdx.x == 0) {
    offsets[nbins] = carry_c;
    subs[nbins] = carry_s;
  }
}

// -- C. order --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    order_kernel(const int2* __restrict__ key, const int* __restrict__ offsets,
                 int64_t npts, int64_t spread, int* __restrict__ order) {
  // the bin stage's order of chunks: each bin's slots are then written
  // about in turn, as they were handed out
  const int64_t chunk = int64_t(blockIdx.x) * spread % gridDim.x;
  const int64_t p = chunk * kThreads + threadIdx.x;
  if (p >= npts) return;
  const int2 k = key[p];
  order[offsets[k.x] + k.y] = int(p);
}

// -- D. spread -------------------------------------------------------------

struct SpreadArgs {
  const double* records;
  const int* order;
  const int* offsets;
  const int* subs;
  const int* sub_bin;
  const int* emax;
  double* pad;
  int nbins, nbp, nrows;
  int64_t ntheta, nphi;
  double beta;
};

// 2^k as two factors that stay inside the float64 range (|k| <= 2100)
__device__ __forceinline__ double2 pow2(int k) {
  const int k1 = k / 2;
  return make_double2(ldexp(1.0, k1), ldexp(1.0, k - k1));
}

template <int kW, int kNcomp>
__global__ void __launch_bounds__(kThreads) spread_kernel(const SpreadArgs g) {
  constexpr int kSide = kTile + kW - 1;
  constexpr int kRow = kSide * kNcomp;
  constexpr int kCells = kSide * kRow;
  constexpr long long kMask = (1 << 22) - 1;
  // three planes of kCells limbs (dynamic: above 48 KB at w 15, 16 complex)
  extern __shared__ unsigned int limbs[];
  unsigned int* l0 = limbs;
  unsigned int* l1 = limbs + kCells;
  unsigned int* l2 = limbs + 2 * kCells;

  // the block's bin, from the scan's map, and its chunk in the bin
  const int i = blockIdx.x;
  if (i >= g.subs[g.nbins]) return;
  const int lo = g.sub_bin[i];
  const int begin = g.offsets[lo] + (i - g.subs[lo]) * kMaxSub;
  const int end = min(begin + kMaxSub, g.offsets[lo + 1]);
  const int row0 = (lo / g.nbp) * kTile;
  const int col0 = (lo % g.nbp) * kTile;
  const int r = blockIdx.y;
  const int stride = record_stride(g.nrows * kNcomp);
  const int64_t gtheta = g.ntheta + kW, gphi = g.nphi + kW;
  double* g0 = g.pad + ((r * gtheta + row0) * gphi + col0) * kNcomp;
  // every finite |v| of the bin's row is below 2^e
  const int e = g.emax[int64_t(lo) * g.nrows + r] - 1022;
  const double2 scale = pow2(52 - e), unscale = pow2(e - 52);

  for (int c = threadIdx.x; c < kCells; c += kThreads)
    l0[c] = l1[c] = l2[c] = 0u;
  __syncthreads();

  for (int s = begin + threadIdx.x; s < end; s += kThreads) {
    const double* rec = g.records + int64_t(g.order[s]) * stride;
    const double2 u = reinterpret_cast<const double2*>(rec)[0];
    const int2 j = reinterpret_cast<const int2*>(rec)[2];
    double v[kNcomp];
    bool finite = true;
#pragma unroll
    for (int c = 0; c < kNcomp; ++c) {
      v[c] = rec[3 + r * kNcomp + c];
      finite = finite && exponent(v[c]) < 2047;
    }
    const int lt = j.x - row0, lp = j.y - col0;
    if (!finite) {  // NaN and inf: to the grid, as the plain version adds
      for (int a = 0; a < kW; ++a)
        for (int b = 0; b < kW; ++b) {
          const double coef = es_weight(u.x, j.x + a, kW, g.beta) *
                               es_weight(u.y, j.y + b, kW, g.beta);
          for (int c = 0; c < kNcomp; ++c)
            atomicAdd(g0 + ((lt + a) * gphi + lp + b) * kNcomp + c,
                      v[c] * coef);
        }
      continue;
    }
    double wt[kW], wp[kW];
#pragma unroll
    for (int a = 0; a < kW; ++a) {
      wt[a] = es_weight(u.x, j.x + a, kW, g.beta);
      wp[a] = es_weight(u.y, j.y + a, kW, g.beta);
    }
    const int e0 = (lt * kSide + lp) * kNcomp;
#pragma unroll
    for (int c = 0; c < kNcomp; ++c) {
      const double vs = v[c] * scale.x * scale.y;  // |vs| < 2^52, exact
#pragma unroll
      for (int a = 0; a < kW; ++a) {
        const double va = vs * wt[a];
#pragma unroll
        for (int b = 0; b < kW; ++b) {
          const int cell = e0 + a * kRow + b * kNcomp + c;
          const long long q = __double2ll_rn(va * wp[b]);
          atomicAdd(l0 + cell, unsigned(q & kMask));
          atomicAdd(l1 + cell, unsigned((q >> 22) & kMask));
          atomicAdd(l2 + cell, unsigned(q >> 44));
        }
      }
    }
  }
  __syncthreads();

  // the tile's nonzero cells into the padded grid, clipped to it
  const int64_t nr = min(int64_t(kSide), gtheta - row0);
  const int64_t nc = min(int64_t(kSide), gphi - col0) * kNcomp;
  for (int c = threadIdx.x; c < kCells; c += kThreads) {
    const int ti = c / kRow, tj = c % kRow;
    if (ti >= nr || tj >= nc) continue;
    const long long q = static_cast<long long>(l0[c]) +
                        (static_cast<long long>(l1[c]) << 22) +
                        (static_cast<long long>(int(l2[c])) << 44);
    if (q != 0)
      atomicAdd(g0 + ti * gphi * kNcomp + tj,
                static_cast<double>(q) * unscale.x * unscale.y);
  }
}

template <int kW, int kNcomp>
cudaError_t launch_spread(const SpreadArgs& g, int64_t npts, cudaStream_t s) {
  constexpr int kSide = kTile + kW - 1;
  constexpr int kBytes = 3 * kSide * kSide * kNcomp * int(sizeof(unsigned));
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spread_kernel<kW, kNcomp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(unsigned((npts + kMaxSub - 1) / kMaxSub + g.nbins),
                  unsigned(g.nrows));
  spread_kernel<kW, kNcomp><<<grid, kThreads, kBytes, s>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// theta, phi: (npts,) float64; values: (nrows, npts, ncomp) float64; pad:
// (nrows, ntheta + w, nphi + w, ncomp) float64, accumulated into; w in
// 4..16.  Scratch: key (npts, 2) int32; counts (nbins,) int32; offsets,
// subs (nbins + 1,) int32; sub_bin (ceil(npts / max_sub) + nbins,) int32;
// emax (nbins, nrows) int32; records (npts, record_stride(nrows ncomp))
// float64; order (npts,) int32; nbins = ceil(ntheta / tile) ceil(nphi /
// tile).  tile, max_sub and stride (a record's doubles) must be the
// compiled kTile, kMaxSub and record_stride(nrows ncomp).  stages: 1 bin +
// scan, 2 order, 4 spread (a mask).
int heracles_spread_es(const void* theta, const void* phi, const void* values,
                       void* pad, long long npts, int nrows, int ncomp,
                       long long ntheta, long long nphi, int w, double beta,
                       void* key, void* counts, void* offsets, void* subs,
                       void* sub_bin, void* emax, void* records, void* order,
                       int tile, int max_sub, int stride, int stages,
                       void* stream) {
  if (ncomp != 1 && ncomp != 2) return int(cudaErrorInvalidValue);
  if (w < 4 || w > 16 || tile != kTile || max_sub != kMaxSub ||
      stride != record_stride(nrows * ncomp))
    return int(cudaErrorInvalidValue);
  if (npts < 0 || npts >= (1ll << 31) || nrows < 0 || nrows > 65535 ||
      ntheta < 1 || nphi < 1)
    return int(cudaErrorInvalidValue);
  if (int64_t(npts) * nrows == 0) return int(cudaSuccess);
  const int nbp = int((nphi + kTile - 1) / kTile);
  const int nbins = int((ntheta + kTile - 1) / kTile) * nbp;
  int2* k = static_cast<int2*>(key);
  int* cnt = static_cast<int*>(counts);
  int* off = static_cast<int*>(offsets);
  int* sub = static_cast<int*>(subs);
  int* sb = static_cast<int*>(sub_bin);
  int* em = static_cast<int*>(emax);
  double* rec = static_cast<double*>(records);
  int* ord = static_cast<int*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = unsigned((npts + kThreads - 1) / kThreads);
  // a prime near blocks / golden ratio: coprime to blocks (it is above
  // blocks / 2), so chunk = b spread mod blocks is a permutation
  int64_t spread = 1;
  if (blocks > 2) {
    for (spread = int64_t(0.618 * blocks) | 1;; spread += 2) {
      bool prime = true;
      for (int64_t f = 3; f * f <= spread && prime; f += 2)
        prime = spread % f != 0;
      if (prime) break;
    }
  }
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    err = cudaMemsetAsync(cnt, 0, sizeof(int) * size_t(nbins), s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(em, 0, sizeof(int) * size_t(nbins) * nrows, s);
    if (err != cudaSuccess) return int(err);
    bin_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(theta), static_cast<const double*>(phi),
        static_cast<const double*>(values), npts, nrows, ncomp, ntheta, nphi,
        0.5 * w, nbp, spread, cnt, em, k, rec);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    scan_kernel<<<1, kScanThreads, 0, s>>>(cnt, nbins, off, sub, sb);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  if (stages & 2) {
    order_kernel<<<blocks, kThreads, 0, s>>>(k, off, npts, spread, ord);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  if (stages & 4) {
    const SpreadArgs g{rec, ord, off, sub, sb, em, static_cast<double*>(pad),
                       nbins, nbp, nrows, ntheta, nphi, beta};
    switch (w) {
#define HERACLES_SPREAD_W(W)                                      \
  case W:                                                         \
    err = ncomp == 1 ? launch_spread<W, 1>(g, npts, s)            \
                     : launch_spread<W, 2>(g, npts, s);           \
    break;
      HERACLES_SPREAD_W(4)
      HERACLES_SPREAD_W(5)
      HERACLES_SPREAD_W(6)
      HERACLES_SPREAD_W(7)
      HERACLES_SPREAD_W(8)
      HERACLES_SPREAD_W(9)
      HERACLES_SPREAD_W(10)
      HERACLES_SPREAD_W(11)
      HERACLES_SPREAD_W(12)
      HERACLES_SPREAD_W(13)
      HERACLES_SPREAD_W(14)
      HERACLES_SPREAD_W(15)
      HERACLES_SPREAD_W(16)
#undef HERACLES_SPREAD_W
    }
  }
  return int(err);
}

}  // extern "C"
