// The warp butterfly reduce-scatter shared by the analysis kernels
// (sht_analysis.cu, sht_analysis_pair.cu): each thread holds V partial
// sums, and afterwards lane i holds the warp's sums of values
// (V/32) i .. (V/32) i + V/32 - 1, in V - V/32 shuffles and no shared
// memory.  Every index is a compile-time constant, so the values stay in
// registers.
//
// Each value's sum is one fixed tree over the lanes: stage O adds the
// partial sums of lanes that differ in bit O, from O = 16 down to 1,
// whichever index the value has and whichever lane keeps it.

#pragma once

#include <cuda_runtime.h>

namespace warp_reduce {

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

// Afterwards acc[j], j < V/32, of lane i holds the warp sum of the
// original acc[(V/32) i + j].
template <typename T, int V>
__device__ __forceinline__ void reduce_scatter(T (&acc)[V], int lane) {
  static_assert(V % 32 == 0, "at least one value per lane");
  butterfly<16, V / 2>(acc, lane);
  butterfly<8, V / 4>(acc, lane);
  butterfly<4, V / 8>(acc, lane);
  butterfly<2, V / 16>(acc, lane);
  butterfly<1, V / 32>(acc, lane);
}

}  // namespace warp_reduce
