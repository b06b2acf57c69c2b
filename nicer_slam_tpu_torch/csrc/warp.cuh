// Warp-level sums and scans shared by the per-ray kernels (composite.cu,
// sampler.cu): one warp holds one ray, each lane a contiguous chunk of its
// samples, and these combine the lanes' chunk values.

#pragma once

#include <cuda_runtime.h>

namespace nsl {

constexpr unsigned kFull = 0xffffffffu;

// the sum over the warp's lanes, in the same order on every lane (a
// butterfly: float addition commutes, so every lane holds the same bits)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// exclusive prefix over lanes of a per-lane value. The inclusive scan is
// shifted by one lane instead of subtracting the lane's own value: the last
// sample's free energy is ~1e10 * sigma, and incl - v would cancel the
// whole prefix away in float32.
__device__ __forceinline__ float warp_excl_prefix(float v, int lane) {
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.0f : excl;
}

// exclusive suffix over lanes (sum of the values of higher lanes)
__device__ __forceinline__ float warp_excl_suffix(float v, int lane) {
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float t = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += t;
  }
  float excl = __shfl_down_sync(kFull, incl, 1);
  return lane == 31 ? 0.0f : excl;
}

}  // namespace nsl
