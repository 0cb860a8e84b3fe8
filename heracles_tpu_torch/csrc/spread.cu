// Exponential-of-semicircle (ES) kernel spreading of points onto the torus
// grid, for NVIDIA Hopper (sm_90a).
//
// Replaces heracles_tpu/ops/_spread.cpp:42 spread_es, the host C++ loop of
// the gridded adjoint synthesis (heracles_tpu/ops/nufft.py); the JAX
// package ran it on the host because a TPU elementwise scatter is slow.
// On this card a float64 atomicAdd is native, so the scatter runs here and
// the grid never leaves the device.
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
// folds back onto the start (nufft.fold_padded), so the inner loop needs
// no modulo.  Values are real (ncomp 1) or complex (ncomp 2, interleaved).
//
// What bounds it: the w^2 ncomp float64 atomic additions per (point, row)
// into a grid far larger than L2 (4102^2 x 8 bytes at lmax 1000), not the
// 2 w exponentials per point.  The bound counts each input read once and
// the grid written once.
//
// Design (the simple one): one thread per (point, row), the point index
// fastest so that a warp reads adjacent angles and values; the kernel is
// instantiated for each width w = 4..16 (nufft.kernel_width's range), so
// the 2 w weights stay in registers and the w^2 ncomp atomicAdd into the
// padded grid are unrolled.  No sort by theta row and no shared-memory
// tiles: the order of the additions varies from run to run, and the result
// with it, at the rounding level.
//
// C interface (loaded with ctypes): heracles_spread_es launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kTwoPi = 6.283185307179586;

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

template <int kW>
__device__ __forceinline__ void es_weights(double u, int64_t j0, double beta,
                                           double (&out)[kW]) {
  constexpr double inv_half_w = 2.0 / kW;
#pragma unroll
  for (int a = 0; a < kW; ++a) {
    const double z = (static_cast<double>(j0 + a) - u) * inv_half_w;
    const double t = 1.0 - z * z;
    out[a] = t > 0.0 ? exp(beta * (sqrt(t) - 1.0)) : 0.0;
  }
}

template <int kW, int kNcomp>
__global__ void __launch_bounds__(kThreads)
    spread_kernel(const double* __restrict__ theta,
                  const double* __restrict__ phi,
                  const double* __restrict__ values, double* __restrict__ pad,
                  int64_t npts, int nrows, int64_t ntheta, int64_t nphi,
                  double beta) {
  const int64_t idx = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= npts * nrows) return;
  const int64_t p = idx % npts;
  const int64_t r = idx / npts;

  constexpr double half_w = 0.5 * kW;
  double ut = theta[p] * (double(ntheta) / kTwoPi) - 0.5;
  double up = phi[p] * (double(nphi) / kTwoPi);
  const int64_t jt = first_cell(ut, half_w, ntheta);
  const int64_t jp = first_cell(up, half_w, nphi);
  double wt[kW], wp[kW];
  es_weights<kW>(ut, jt, beta, wt);
  es_weights<kW>(up, jp, beta, wp);

  const int64_t gphi = nphi + kW;
  const double* v = values + (r * npts + p) * kNcomp;
  double* g0 = pad + ((r * (ntheta + kW) + jt) * gphi + jp) * kNcomp;
  double vc[kNcomp];
#pragma unroll
  for (int c = 0; c < kNcomp; ++c) vc[c] = v[c];
#pragma unroll
  for (int a = 0; a < kW; ++a) {
    double* g = g0 + a * gphi * kNcomp;
#pragma unroll
    for (int b = 0; b < kW; ++b) {
      const double coef = wt[a] * wp[b];
#pragma unroll
      for (int c = 0; c < kNcomp; ++c) atomicAdd(g + b * kNcomp + c, vc[c] * coef);
    }
  }
}

template <int kW>
void launch(const double* th, const double* ph, const double* v, double* g,
            int64_t npts, int nrows, int ncomp, int64_t ntheta, int64_t nphi,
            double beta, cudaStream_t s) {
  const int64_t n = npts * nrows;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (ncomp == 1) {
    spread_kernel<kW, 1><<<blocks, kThreads, 0, s>>>(th, ph, v, g, npts, nrows,
                                                     ntheta, nphi, beta);
  } else {
    spread_kernel<kW, 2><<<blocks, kThreads, 0, s>>>(th, ph, v, g, npts, nrows,
                                                     ntheta, nphi, beta);
  }
}

}  // namespace

extern "C" {

// theta, phi: (npts,) float64; values: (nrows, npts, ncomp) float64; pad:
// (nrows, ntheta + w, nphi + w, ncomp) float64, accumulated into; w in
// 4..16.
int heracles_spread_es(const void* theta, const void* phi, const void* values,
                       void* pad, long long npts, int nrows, int ncomp,
                       long long ntheta, long long nphi, int w, double beta,
                       void* stream) {
  if (ncomp != 1 && ncomp != 2) return int(cudaErrorInvalidValue);
  if (int64_t(npts) * nrows == 0) return int(cudaSuccess);
  const double* th = static_cast<const double*>(theta);
  const double* ph = static_cast<const double*>(phi);
  const double* v = static_cast<const double*>(values);
  double* g = static_cast<double*>(pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define HERACLES_SPREAD_W(W)                                               \
  case W:                                                                  \
    launch<W>(th, ph, v, g, npts, nrows, ncomp, ntheta, nphi, beta, s);    \
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
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
