// The voxel visit counter's index and its beta (K7), shared by the
// counter's kernels (voxels.cu) and the fused SDF-to-density kernel
// (sdf_density.cu):
//   index   i_d = clip(int((x_d + 1) / 2 * res), 0, res - 1), truncating;
//           -1 where any |x_d| > 0.99 (a boundary point counts 0);
//   beta    A exp(-B 1e-4 count D) + C.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nsl {

// flat counter index (i_0 res + i_1) res + i_2 of the point v, or -1 for a
// boundary point
__device__ __forceinline__ int voxel_flat(const float v[3], int res) {
  int flat = 0;
  bool boundary = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    boundary |= fabsf(v[d]) > 0.99f;
    // the plain version's ((x + 1) / 2) * res, then truncation; (x + 1) *
    // 0.5 is the same bits (a halving is exact either way) without a
    // division
    float u = __fmul_rn(__fadd_rn(v[d], 1.0f), 0.5f);
    int i = (int)__fmul_rn(u, (float)res);
    i = min(max(i, 0), res - 1);
    flat = flat * res + i;
  }
  return boundary ? -1 : flat;
}

// (-B 1e-4) count D, exp, A e + C: each rounded as the plain version
// rounds it (no fused multiply-add)
__device__ __forceinline__ float voxel_beta(float count, float neg_b_1e4, float d,
                                            float a, float c) {
  const float e = expf(__fmul_rn(__fmul_rn(neg_b_1e4, count), d));
  return __fadd_rn(__fmul_rn(a, e), c);
}

}  // namespace nsl
