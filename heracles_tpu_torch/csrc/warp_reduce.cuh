// The warp butterfly reduce-scatter shared by the analysis kernels
// (sht_analysis.cu, sht_analysis_pair.cu): each thread holds V partial
// sums, and afterwards lane i holds the warp's sums of values
// (V/32) i .. (V/32) i + V/32 - 1, in V - V/32 shuffles and no shared
// memory.  Every index is a compile-time constant, so the values stay in
// registers.
//
// Each value's sum is one fixed tree over the lanes: stage O adds the
// partial sums of lanes that differ in bit O, from O = 16 down to 1,
// whichever index the value has and whichever lane keeps it; a sum of two
// does not depend on the order of its terms.  So reduce_pairs, which
// takes 16 values through the same stages, gives each value the same
// number as reduce_scatter of 32 values holding it.

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

// The 16 values of one map's sub-chunk in the grouped analysis kernels:
// the first four stages of reduce_scatter, then the last one as an
// exchange, so that lanes 2i and 2i + 1 both hold the warp sum of the
// original acc[i] in acc[0] (16 shuffles).
template <typename T>
__device__ __forceinline__ void reduce_pairs(T (&acc)[16], int lane) {
  butterfly<16, 8>(acc, lane);
  butterfly<8, 4>(acc, lane);
  butterfly<4, 2>(acc, lane);
  butterfly<2, 1>(acc, lane);
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
}

}  // namespace warp_reduce
