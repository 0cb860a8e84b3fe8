// FMA-peak probe for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tools/vpu_peak.py (behind run :70):
//   * probe_kernel<T, kFma, NC>  <- _fma_kernel (:31);
//   * probe_kernel<T, kRec3, NC> <- _rec3_kernel (:49).
//
// Each thread runs NC independent chains on one element of a (rows, 128)
// block, with the dataflow of the TPU kernels:
//   fma:  acc = acc * b + a        (one dependent FMA per step)
//   rec3: new = 1.0001 (x curr) - 0.9999 prev   (mul, mul, FMA; the
//         Wigner recurrence step's shape, with a 2-deep dependency)
// for steps = iters * 64 steps, and writes the sum of its chains so that
// nothing is optimised away.  The float instantiation measures the FP32
// rate that bounds the analysis kernels (sht_analysis.cu), the double one
// the FP64 rate that bounds the Gram kernel (gram.cu).
//
// What bounds it: nothing but FP issue, by construction: two loads and one
// store per thread against thousands of dependent operations, and with
// enough resident warps the FMA latency is hidden by the other chains and
// warps.
//
// C interface (loaded with ctypes): heracles_fma_peak_{f32,f64} launch on
// the given stream and return cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported kind or chain count).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // one (rows, 128) row per block
constexpr int kUnroll = 64;    // steps per loop iteration
constexpr int kFma = 0;
constexpr int kRec3 = 1;

__device__ __forceinline__ float fma_rn(float x, float y, float z) { return __fmaf_rn(x, y, z); }
__device__ __forceinline__ double fma_rn(double x, double y, double z) { return __fma_rn(x, y, z); }

template <typename T, int kKind, int NC>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const T* __restrict__ a_in, const T* __restrict__ b_in,
                 T* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const T a = a_in[i];
  const T b = b_in[i];
  T sum;
  if (kKind == kFma) {
    T acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = a * T(0.5 + 0.125 * c);
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < kUnroll; ++s)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fma_rn(acc[c], b, a);
    }
    sum = acc[0];
#pragma unroll
    for (int c = 1; c < NC; ++c) sum += acc[c];
  } else {
    const T x = b;
    T prev[NC], curr[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      prev[c] = a * T(0.25 * (c + 1));
      curr[c] = a * T(0.125 * (c + 1));
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < kUnroll; ++s)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const T nw = T(1.0001) * (x * curr[c]) - T(0.9999) * prev[c];
          prev[c] = curr[c];
          curr[c] = nw;
        }
    }
    sum = curr[0];
#pragma unroll
    for (int c = 1; c < NC; ++c) sum += curr[c];
  }
  out[i] = sum;
}

template <typename T, int kKind>
int launch_kind(const T* a, const T* b, T* out, int n, int nchain, int iters,
                cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  switch (nchain) {
    case 1: probe_kernel<T, kKind, 1><<<blocks, kThreads, 0, stream>>>(a, b, out, n, iters); break;
    case 2: probe_kernel<T, kKind, 2><<<blocks, kThreads, 0, stream>>>(a, b, out, n, iters); break;
    case 4: probe_kernel<T, kKind, 4><<<blocks, kThreads, 0, stream>>>(a, b, out, n, iters); break;
    case 8: probe_kernel<T, kKind, 8><<<blocks, kThreads, 0, stream>>>(a, b, out, n, iters); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* out, int n, int kind,
           int nchain, int iters, void* stream) {
  if (n == 0) return int(cudaSuccess);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kFma) return launch_kind<T, kFma>(ap, bp, op, n, nchain, iters, s);
  if (kind == kRec3) return launch_kind<T, kRec3>(ap, bp, op, n, nchain, iters, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int heracles_fma_peak_f32(const void* a, const void* b, void* out, int n,
                          int kind, int nchain, int iters, void* stream) {
  return launch<float>(a, b, out, n, kind, nchain, iters, stream);
}

int heracles_fma_peak_f64(const void* a, const void* b, void* out, int n,
                          int kind, int nchain, int iters, void* stream) {
  return launch<double>(a, b, out, n, kind, nchain, iters, stream);
}

}  // extern "C"
