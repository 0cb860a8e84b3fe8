// Folded spin-0 Wigner-d analysis kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of heracles_tpu/ops/pallas_sht.py
// (:713), behind analysis_spin0_folded (:3101).  (The spin pair,
// _pair_kernel :1049, is sht_analysis_pair.cu.)
//
// What it computes, per batch element b and order m, for l = m..lmax:
//   alm[b,l,m] = sum_r lam_lm(x_r) (l even ? Fe : Fo)[b,r,m]
// where lam is the normalised Wigner-d function of
// heracles_tpu/ops/wigner.py: the three-term recurrence in l, seeded at
// j0 = m, with the seed's magnitude carried as a mantissa and a count k of
// factors 2^60 (block rescaling), and only k = 0 or -1 emitting.
//
// What bounds it: FP32 (or FP64) vector issue.  Per (ring, l, m) triple
// the recurrence costs ~10 operations (unfused, so that it rounds as the
// plain version does) and the contraction 2 FMAs, while F is read once per
// (ring, m): ~3.7e10 triples against ~0.4 GB of F for one map at nside
// 4096, lmax 3000.
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
//     wigner_recurrence.cuh, shared with the pair analysis and the
//     synthesis kernels.
//
// C interface (loaded with ctypes): heracles_analysis_spin0_{f32,f64}
// launch on the given stream and return cudaGetLastError();
// heracles_analysis_spin0_smem_bytes gives a launch's dynamic shared
// memory.

#include <cuda_runtime.h>
#include <stddef.h>

#include "warp_reduce.cuh"
#include "wigner_recurrence.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRings = 2;                 // rings per thread
constexpr int kTile = kThreads * kRings;  // rings per tile
constexpr int NC = 2;                     // (re, im)

using warp_reduce::reduce_scatter;
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

template <typename T>
size_t smem_bytes(int lmax) {
  constexpr int V = AccValues<T>::n;
  constexpr int LC = V / NC;
  return (size_t(lmax + 1) * NC + 2 * kWarps * V + 2 * 3 * LC) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    analysis_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                    const T* __restrict__ x, const double* __restrict__ logch,
                    const double* __restrict__ logsh,
                    const double* __restrict__ seed, T* __restrict__ out0,
                    int nhalf, int nm, int lmax) {
  constexpr int V = AccValues<T>::n;
  constexpr int LC = V / NC;  // multipoles per chunk
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
  const int s = 0;
  const int j0 = m;

  for (int i = tid; i < (lmax + 1) * NC; i += kThreads) col[i] = T(0);

  if (j0 <= lmax) {
    const int nchunks = (lmax - j0 + LC) / LC;
    const int ntiles = (nhalf + kTile - 1) / kTile;
    const double logc_p = seed[m];
    const double sign_p = seed[nm + m];
    // seed exponents of cos(t/2) and sin(t/2): both m
    const double pc = double(m + s);
    const double ps = fabs(double(m - s));
    const bool odd = (j0 & 1) != 0;

    if (tid < LC) {
      coef_row<T>(j0 + tid + 1, j0, m, s, lmax, &coef[tid], &coef[LC + tid],
                  &coef[2 * LC + tid]);
    }
    __syncthreads();

    int g = 0;  // running chunk count: selects the double buffers
    for (int tile = 0; tile < ntiles; ++tile) {
      T xr[kRings], dp[kRings], dc[kRings];
      int k[kRings];
      // fa/fb = F of the parity of j0 / of j0+1 (re, im)
      T fa[kRings][2], fb[kRings][2];
#pragma unroll
      for (int r = 0; r < kRings; ++r) {
        const int ring = tile * kTile + r * kThreads + tid;
        dp[r] = T(0);
        if (ring < nhalf) {
          const size_t off = ((size_t(b) * nhalf + ring) * nm + m) * 2;
          const double lch = logch[ring], lsh = logsh[ring];
          xr[r] = x[ring];
          const T* fe = odd ? f1 : f0;
          const T* fo = odd ? f0 : f1;
          fa[r][0] = fe[off];
          fa[r][1] = fe[off + 1];
          fb[r][0] = fo[off];
          fb[r][1] = fo[off + 1];
          seed_of<T>(logc_p, sign_p, pc, ps, lch, lsh, dc[r], k[r]);
        } else {
          xr[r] = T(0);
          dc[r] = T(0);
          k[r] = kNoSeed;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            fa[r][c] = T(0);
            fb[r][c] = T(0);
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
            const T lam = dc[r] * emit_of<T>(k[r]);
            const T fre = (t & 1) ? fb[r][0] : fa[r][0];
            const T fim = (t & 1) ? fb[r][1] : fa[r][1];
            acc[2 * t] += lam * fre;
            acc[2 * t + 1] += lam * fim;
            const T a1x = Arith<T>::mul(a1, xr[r]);
            advance<T>(step<T>(a1x, a0, bb, dc[r], dp[r]), dp[r], dc[r], k[r]);
          }
        }

        // k never decreases: a warp whose every exponent is still below -1
        // emitted only zeros in this chunk and skips its reduction
        bool live = false;
#pragma unroll
        for (int r = 0; r < kRings; ++r) live = live || k[r] >= -1;
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
    out0[((size_t(b) * (lmax + 1) + l) * nm + m) * 2 + c] = col[i];
  }
}

template <typename T>
int launch(const void* f0, const void* f1, const void* x, const void* logch,
           const void* logsh, const void* seed, void* out0, int batch,
           int nhalf, int nm, int lmax, void* stream) {
  const size_t smem = smem_bytes<T>(lmax);
  auto kern = analysis_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (batch == 0 || nm == 0) return int(cudaSuccess);
  kern<<<dim3(nm, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f0), static_cast<const T*>(f1),
      static_cast<const T*>(x), static_cast<const double*>(logch),
      static_cast<const double*>(logsh), static_cast<const double*>(seed),
      static_cast<T*>(out0), nhalf, nm, lmax);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_analysis_spin0_f32(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, void* stream) {
  return launch<float>(fe, fo, x, logch, logsh, seed, out, batch, nhalf, nm,
                       lmax, stream);
}

int heracles_analysis_spin0_f64(const void* fe, const void* fo, const void* x,
                                const void* logch, const void* logsh,
                                const void* seed, void* out, int batch,
                                int nhalf, int nm, int lmax, void* stream) {
  return launch<double>(fe, fo, x, logch, logsh, seed, out, batch, nhalf, nm,
                        lmax, stream);
}

size_t heracles_analysis_spin0_smem_bytes(int is_double, int lmax) {
  return is_double ? smem_bytes<double>(lmax) : smem_bytes<float>(lmax);
}

const char* heracles_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
