// Folded Wigner-d analysis kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of heracles_tpu/ops/pallas_sht.py:
//   * analysis_kernel<T, false> <- _kernel (:713), behind
//     analysis_spin0_folded (:3101);
//   * analysis_kernel<T, true>  <- _pair_kernel (:1049), behind
//     analysis_pair_folded (:1582).
//
// What they compute, per batch element b and order m, for l = j0..lmax:
//   spin 0: alm[b,l,m] = sum_r lam_lm(x_r) (l even ? Fe : Fo)[b,r,m]
//   pair:   a_p[b,l,m] = sum_r lp_lm(x_r) FNp[b,r,m] + (-1)^l lm_lm(x_r) Sp[b,r,m]
//           a_m[b,l,m] = sum_r lm_lm(x_r) FNm[b,r,m] + (-1)^l lp_lm(x_r) Sm[b,r,m]
// where lam (spin 0) and lp / lm (the +-s columns of the spin pair) are
// the normalised Wigner-d functions of heracles_tpu/ops/wigner.py: the
// three-term recurrence in l, seeded at j0 = max(m, s), with the seed's
// magnitude carried as a mantissa and a count k of factors 2^60 (block
// rescaling), and only k = 0 or -1 emitting.  The (-1)^m sign of the
// southern rows is applied by the caller; the (-1)^l sign here.
//
// What bounds them: FP32 (or FP64) vector issue.  Per (ring, l, m) triple
// the recurrence costs ~10 operations (unfused, so that it rounds as the
// plain version does) and the contraction 2 (spin 0) or 8 (pair) FMAs,
// while F is read once per (ring, m): ~3.7e10 triples against ~0.4 GB of
// F for one spin-0 map at nside 4096, lmax 3000.
//
// Design:
//   * one block per (order m, batch element); blockIdx.x = m, so the
//     longest columns (low m) start first;
//   * each thread owns kRings rings; the block walks the northern rings in
//     tiles of kTile and runs the recurrence from j0 to lmax for each tile
//     with F in registers (read with a stride of nm complex values: the
//     read is small beside the compute, so F is not transposed);
//   * the contributions of LC consecutive l stay in registers, are summed
//     over the warp by a butterfly reduce-scatter (V - V/32 shuffles for
//     V values, after which lane i holds values FV*i..FV*i+FV-1), over the
//     block's warps through shared memory in a fixed order, and into the
//     order's output column, which stays in shared memory until every tile
//     is done (the TPU kernel's resident out tile); the column is written
//     once and no atomics are used, so results repeat bit for bit;
//   * the seed is evaluated in float64 from the host log-coefficients and
//     the float64 ring half-angle logs in both instantiations, which makes
//     the TPU's compensated hi/lo seed planes unnecessary;
//   * the recurrence coefficients of each chunk of LC multipoles are
//     computed in float64 by LC threads into a double-buffered shared
//     table while the block works on the previous chunk;
//   * the recurrence itself (seed, coefficients, step, rescale, emit) is
//     wigner_recurrence.cuh, shared with the synthesis kernels.
//
// C interface (loaded with ctypes): heracles_analysis_{spin0,pair}_{f32,f64}
// launch on the given stream and return cudaGetLastError();
// heracles_analysis_smem_bytes gives a launch's dynamic shared memory.

#include <cuda_runtime.h>
#include <stddef.h>

#include "wigner_recurrence.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRings = 2;                 // rings per thread
constexpr int kTile = kThreads * kRings;  // rings per tile

using wigner::advance;
using wigner::Arith;
using wigner::coef_row;
using wigner::emit_of;
using wigner::kNoSeed;
using wigner::norm_of;
using wigner::seed_of;
using wigner::step;

// register accumulators per thread
template <typename T>
struct AccValues;
template <>
struct AccValues<float> {
  static constexpr int n = 64;
};
template <>
struct AccValues<double> {
  static constexpr int n = 32;
};

template <typename T, bool kPair>
struct Shape {
  static constexpr int NC = kPair ? 4 : 2;  // (re, im) of one or two outputs
  static constexpr int V = AccValues<T>::n;
  static constexpr int LC = V / NC;  // multipoles per chunk
};

template <typename T, bool kPair>
size_t smem_bytes(int lmax) {
  using S = Shape<T, kPair>;
  return (size_t(lmax + 1) * S::NC + 2 * kWarps * S::V + 2 * 3 * S::LC) *
         sizeof(T);
}

// One butterfly stage: lanes with bit O set keep the upper H values, the
// others the lower H, each adding the partner lane's copy of that half.
template <int O, int H, typename T, int V>
__device__ __forceinline__ void butterfly(T (&acc)[V], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T send = upper ? acc[i] : acc[H + i];
    const T keep = upper ? acc[H + i] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Butterfly reduce-scatter over the warp: afterwards acc[j], j < V/32, of
// lane i holds the warp sum of the original acc[(V/32) i + j].  Every
// index is a compile-time constant, so acc stays in registers.
template <typename T, int V>
__device__ __forceinline__ void reduce_scatter(T (&acc)[V], int lane) {
  butterfly<16, V / 2>(acc, lane);
  butterfly<8, V / 4>(acc, lane);
  butterfly<4, V / 8>(acc, lane);
  butterfly<2, V / 16>(acc, lane);
  butterfly<1, V / 32>(acc, lane);
}

template <typename T, bool kPair>
__global__ void __launch_bounds__(kThreads)
    analysis_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                    const T* __restrict__ f2, const T* __restrict__ f3,
                    const T* __restrict__ x, const double* __restrict__ logch,
                    const double* __restrict__ logsh,
                    const double* __restrict__ seed, T* __restrict__ out0,
                    T* __restrict__ out1, int nhalf, int nm, int lmax,
                    int spin) {
  constexpr int NC = Shape<T, kPair>::NC;
  constexpr int V = Shape<T, kPair>::V;
  constexpr int LC = Shape<T, kPair>::LC;
  constexpr int FV = V / 32;
  static_assert(LC % 2 == 0, "chunks must keep the parity of l");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);  // [lmax+1][NC]
  T* part = col + (lmax + 1) * NC;          // [2][kWarps][V]
  T* coef = part + 2 * kWarps * V;          // [2][3][LC]: a1, a0, b

  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = kPair ? spin : 0;
  const int j0 = max(m, s);

  for (int i = tid; i < (lmax + 1) * NC; i += kThreads) col[i] = T(0);

  if (j0 <= lmax) {
    const int nchunks = (lmax - j0 + LC) / LC;
    const int ntiles = (nhalf + kTile - 1) / kTile;
    const double logc_p = seed[m];
    const double sign_p = seed[nm + m];
    const double logc_m = kPair ? seed[2 * nm + m] : 0.0;
    const double sign_m = kPair ? seed[3 * nm + m] : 0.0;
    // seed exponents of cos(t/2) and sin(t/2): (m+s, |m-s|) for +s and
    // swapped for -s (spin 0: both m)
    const double pc = double(m + s);
    const double ps = fabs(double(m - s));
    const bool odd = (j0 & 1) != 0;
    // (-1)^l = (-1)^j0 (-1)^t inside every chunk, LC being even
    const T par = odd ? T(-1) : T(1);

    if (tid < LC) {
      coef_row<T>(j0 + tid + 1, j0, m, s, lmax, &coef[tid], &coef[LC + tid],
                  &coef[2 * LC + tid]);
    }
    __syncthreads();

    int g = 0;  // running chunk count: selects the double buffers
    for (int tile = 0; tile < ntiles; ++tile) {
      T xr[kRings], dp[kRings], dc[kRings], dpm[kRings], dcm[kRings];
      int k[kRings], km[kRings];
      // spin 0: fa/fb = F of the parity of j0 / of j0+1 (re, im);
      // pair: fa = FNp, fb = Sp, fc = FNm, fd = Sm, south rows * (-1)^j0
      T fa[kRings][2], fb[kRings][2], fc[kRings][2], fd[kRings][2];
#pragma unroll
      for (int r = 0; r < kRings; ++r) {
        const int ring = tile * kTile + r * kThreads + tid;
        dp[r] = T(0);
        dpm[r] = T(0);
        if (ring < nhalf) {
          const size_t off = ((size_t(b) * nhalf + ring) * nm + m) * 2;
          const double lch = logch[ring], lsh = logsh[ring];
          xr[r] = x[ring];
          if (!kPair) {
            const T* fe = odd ? f1 : f0;
            const T* fo = odd ? f0 : f1;
            fa[r][0] = fe[off];
            fa[r][1] = fe[off + 1];
            fb[r][0] = fo[off];
            fb[r][1] = fo[off + 1];
          } else {
            fa[r][0] = f0[off];
            fa[r][1] = f0[off + 1];
            fb[r][0] = par * f1[off];
            fb[r][1] = par * f1[off + 1];
            fc[r][0] = f2[off];
            fc[r][1] = f2[off + 1];
            fd[r][0] = par * f3[off];
            fd[r][1] = par * f3[off + 1];
          }
          seed_of<T>(logc_p, sign_p, pc, ps, lch, lsh, dc[r], k[r]);
          if (kPair) seed_of<T>(logc_m, sign_m, ps, pc, lch, lsh, dcm[r], km[r]);
        } else {
          xr[r] = T(0);
          dc[r] = T(0);
          dcm[r] = T(0);
          k[r] = kNoSeed;
          km[r] = kNoSeed;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            fa[r][c] = T(0);
            fb[r][c] = T(0);
            fc[r][c] = T(0);
            fd[r][c] = T(0);
          }
        }
      }

      for (int c = 0; c < nchunks; ++c, ++g) {
        const int buf = g & 1;
        if (tid < LC) {
          // the next chunk's coefficients (the next tile's first after the
          // last chunk)
          const int cn = (c + 1 < nchunks) ? c + 1 : 0;
          T* cb = coef + (buf ^ 1) * 3 * LC;
          coef_row<T>(j0 + cn * LC + tid + 1, j0, m, s, lmax, &cb[tid],
                      &cb[LC + tid], &cb[2 * LC + tid]);
        }
        const T* cf = coef + buf * 3 * LC;

        T acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = T(0);

#pragma unroll
        for (int t = 0; t < LC; ++t) {
          const T a1 = cf[t];
          const T a0 = cf[LC + t];
          const T bb = cf[2 * LC + t];
#pragma unroll
          for (int r = 0; r < kRings; ++r) {
            if (!kPair) {
              const T lam = dc[r] * emit_of<T>(k[r]);
              const T fre = (t & 1) ? fb[r][0] : fa[r][0];
              const T fim = (t & 1) ? fb[r][1] : fa[r][1];
              acc[2 * t] += lam * fre;
              acc[2 * t + 1] += lam * fim;
              const T a1x = Arith<T>::mul(a1, xr[r]);
              advance<T>(step<T>(a1x, a0, bb, dc[r], dp[r]), dp[r], dc[r], k[r]);
            } else {
              const T lp = dc[r] * emit_of<T>(k[r]);
              const T lm = dcm[r] * emit_of<T>(km[r]);
              const T lps = (t & 1) ? -lp : lp;
              const T lms = (t & 1) ? -lm : lm;
              acc[4 * t] += lp * fa[r][0] + lms * fb[r][0];
              acc[4 * t + 1] += lp * fa[r][1] + lms * fb[r][1];
              acc[4 * t + 2] += lm * fc[r][0] + lps * fd[r][0];
              acc[4 * t + 3] += lm * fc[r][1] + lps * fd[r][1];
              // the -s column's a0 is minus the +s column's
              const T a1x = Arith<T>::mul(a1, xr[r]);
              const T dnp = step<T>(a1x, a0, bb, dc[r], dp[r]);
              const T dnm = step<T>(a1x, -a0, bb, dcm[r], dpm[r]);
              advance<T>(dnp, dp[r], dc[r], k[r]);
              advance<T>(dnm, dpm[r], dcm[r], km[r]);
            }
          }
        }

        // k never decreases: a warp whose every exponent is still below -1
        // emitted only zeros in this chunk and skips its reduction
        bool live = false;
#pragma unroll
        for (int r = 0; r < kRings; ++r) {
          live = live || k[r] >= -1 || (kPair && km[r] >= -1);
        }
        T* pw = part + (buf * kWarps + warp) * V;
        if (__any_sync(0xffffffffu, live)) {
          reduce_scatter<T, V>(acc, lane);
#pragma unroll
          for (int j = 0; j < FV; ++j) pw[FV * lane + j] = acc[j];
        } else {
#pragma unroll
          for (int j = 0; j < FV; ++j) pw[FV * lane + j] = T(0);
        }
        __syncthreads();
        if (tid < V) {
          const int l = j0 + c * LC + tid / NC;
          if (l <= lmax) {
            T sum = T(0);
#pragma unroll
            for (int w = 0; w < kWarps; ++w) sum += part[(buf * kWarps + w) * V + tid];
            const T norm = norm_of<T>(l);
            col[l * NC + tid % NC] += sum * norm;
          }
        }
      }
    }
  }
  __syncthreads();

  // rows l < j0 (and every row of an order above lmax) stay zero
  for (int i = tid; i < (lmax + 1) * NC; i += kThreads) {
    const int l = i / NC;
    const int c = i % NC;
    T* o = c < 2 ? out0 : out1;
    o[((size_t(b) * (lmax + 1) + l) * nm + m) * 2 + (c & 1)] = col[i];
  }
}

template <typename T, bool kPair>
int launch(const void* f0, const void* f1, const void* f2, const void* f3,
           const void* x, const void* logch, const void* logsh,
           const void* seed, void* out0, void* out1, int batch, int nhalf,
           int nm, int lmax, int spin, void* stream) {
  const size_t smem = smem_bytes<T, kPair>(lmax);
  auto kern = analysis_kernel<T, kPair>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (batch == 0 || nm == 0) return int(cudaSuccess);
  kern<<<dim3(nm, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f0), static_cast<const T*>(f1),
      static_cast<const T*>(f2), static_cast<const T*>(f3),
      static_cast<const T*>(x), static_cast<const double*>(logch),
      static_cast<const double*>(logsh), static_cast<const double*>(seed),
      static_cast<T*>(out0), static_cast<T*>(out1), nhalf, nm, lmax, spin);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_analysis_spin0_f32(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, void* stream) {
  return launch<float, false>(fe, fo, nullptr, nullptr, x, logch, logsh, seed,
                              out, nullptr, batch, nhalf, nm, lmax, 0, stream);
}

int heracles_analysis_spin0_f64(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, void* stream) {
  return launch<double, false>(fe, fo, nullptr, nullptr, x, logch, logsh, seed,
                               out, nullptr, batch, nhalf, nm, lmax, 0, stream);
}

int heracles_analysis_pair_f32(const void* fnp, const void* sp,
                               const void* fnm, const void* sm, const void* x,
                               const void* logch, const void* logsh,
                               const void* seed, void* out_p, void* out_m,
                               int batch, int nhalf, int nm, int lmax,
                               int spin, void* stream) {
  return launch<float, true>(fnp, sp, fnm, sm, x, logch, logsh, seed, out_p,
                             out_m, batch, nhalf, nm, lmax, spin, stream);
}

int heracles_analysis_pair_f64(const void* fnp, const void* sp,
                               const void* fnm, const void* sm, const void* x,
                               const void* logch, const void* logsh,
                               const void* seed, void* out_p, void* out_m,
                               int batch, int nhalf, int nm, int lmax,
                               int spin, void* stream) {
  return launch<double, true>(fnp, sp, fnm, sm, x, logch, logsh, seed, out_p,
                              out_m, batch, nhalf, nm, lmax, spin, stream);
}

size_t heracles_analysis_smem_bytes(int pair, int is_double, int lmax) {
  if (pair) {
    return is_double ? smem_bytes<double, true>(lmax)
                     : smem_bytes<float, true>(lmax);
  }
  return is_double ? smem_bytes<double, false>(lmax)
                   : smem_bytes<float, false>(lmax);
}

const char* heracles_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
