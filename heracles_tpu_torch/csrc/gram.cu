// Weighted float64 Gram contraction for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _gram_kernel of heracles_tpu/ops/df32.py
// (:93, called by _gram_call :146 behind gram_df32 :217 and matmul_df32
// :331).  It computes
//
//   M[a, b] = sum_k A[k, a] u[k] B[k, b]      (u = 1 when no u is given)
//
// with A (K, L1), B (K, L2) and u (K,) row-major float64 and M (L1, L2):
// the Gauss-Legendre quadrature of the MASTER mixing matrices, where A and
// B are Wigner-d tables on K nodes and u the node weights times the mask
// correlation.  The TPU kernel emulated float64 with (hi, lo) float32
// pairs, Dekker products and a compensated halving tree; the H100 has
// native float64, so none of that is carried over.
//
// What bounds it: FP64 issue.  At the production size (K 4501, L1 = L2 =
// 3001) one contraction is 2 L1 L2 K = 8.1e10 flop against 0.2 GB of
// tables, so a tiled product that reuses each staged value 64 times is far
// from the memory bound.
//
// Design (simple and right first; DMMA, TMA and split-K come later):
//   * one block of 256 threads per 64 x 64 output tile; thread (ty, tx)
//     owns the 4 x 4 outputs a = ty + 16 i, b = tx + 16 j in registers, so
//     the shared-memory reads of a warp are broadcasts (A) or 16
//     consecutive doubles (B);
//   * K is walked in chunks of 16 rows staged through shared memory; the
//     loads run along the contiguous L axis (coalesced), u is folded into
//     the B chunk as it is loaded, and ragged edges (K, L1, L2 that are
//     multiples of nothing) are zero-filled;
//   * each output is summed over k in a fixed order by one thread: no
//     split-K and no atomics, so results repeat bit for bit.
//
// C interface (loaded with ctypes): heracles_gram_f64 launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;              // output tile edge
constexpr int kChunk = 16;             // K rows per shared-memory stage
constexpr int kSide = 16;              // threads along each tile edge
constexpr int kThreads = kSide * kSide;
constexpr int kSub = kTile / kSide;    // register tile edge

__global__ void __launch_bounds__(kThreads)
    gram_kernel(const double* __restrict__ A, const double* __restrict__ B,
                const double* __restrict__ u, double* __restrict__ M, int K,
                int L1, int L2) {
  __shared__ double As[kChunk][kTile];
  __shared__ double Bs[kChunk][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;

  double acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.0;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
#pragma unroll
    for (int r = 0; r < kChunk * kTile / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int kk = i / kTile;
      const int c = i % kTile;
      const int k = k0 + kk;
      double av = 0.0, bv = 0.0;
      if (k < K) {
        if (a0 + c < L1) av = A[size_t(k) * L1 + a0 + c];
        if (b0 + c < L2) {
          bv = B[size_t(k) * L2 + b0 + c];
          if (u != nullptr) bv *= u[k];
        }
      }
      As[kk][c] = av;
      Bs[kk][c] = bv;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      double ar[kSub], br[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) ar[i] = As[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) br[j] = Bs[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fma(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int a = a0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int b = b0 + tx + kSide * j;
      if (a < L1 && b < L2) M[size_t(a) * L2 + b] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int heracles_gram_f64(const void* A, const void* B, const void* u, void* M,
                      int K, int L1, int L2, void* stream) {
  if (L1 == 0 || L2 == 0) return int(cudaSuccess);
  const dim3 grid((L2 + kTile - 1) / kTile, (L1 + kTile - 1) / kTile);
  gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<const double*>(B),
      static_cast<const double*>(u), static_cast<double*>(M), K, L1, L2);
  return int(cudaGetLastError());
}

}  // extern "C"
