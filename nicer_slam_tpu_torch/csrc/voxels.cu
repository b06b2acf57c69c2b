// Voxel visit counter for Hopper (sm_90a): K7.
//
// Replaces nicer_slam_tpu/ops/density.py update_voxels (:61-70) and
// voxel_counts_at / grid_predefined_beta (:35-51):
//   index   i_d = clip(int((x_d + 1) / 2 * res), 0, res - 1), truncating;
//   scatter counter[i] += 1 for every point with all |x_d| <= 0.99;
//   read    count = counter[i] (0 where any |x_d| > 0.99),
//           beta = A exp(-B 1e-4 count D) + C.
// The counter is float32 [res^3], flat index (i_0 res + i_1) res + i_2.
//
// What bounds it on the card: per point, 12 bytes of x in, and one 4-byte
// atomic add (scatter) or gather and 4-byte store (read) on a 1 MB
// counter that stays in L2; 800k points per flagship mapping iteration,
// 100k per tracking iteration, 131k per density-cache chunk. Each launch
// is a few microseconds above the ~5 us launch floor. The design, one
// thread per point:
//   * scatter: the path's points are ray-ordered samples, sorted along
//     each ray, so neighbouring lanes often fall in the same voxel, and
//     the voxels near the surface are hot. Where any lane shares its left
//     neighbour's voxel, the lanes of the warp on one voxel are found with
//     __match_any_sync and one of them adds the group's size as one float
//     atomic; a warp with no such pair (unordered points) skips the match.
//     Adds of small integers are exact while the count stays below 2^24,
//     so the counter equals the plain version's bit for bit, whatever
//     order the atomics land in (the plain index_put with accumulate is a
//     sort by index and a segmented sum on the card).
//   * the index: (x + 1) * 0.5 in place of (x + 1) / 2, the same bits (a
//     halving is exact either way) without a division.
//   * x, an array of float3, is read with three 4-byte loads per thread:
//     a warp's loads cover one 384-byte run, which L1 serves after the
//     first. Staging it in shared memory through 16-byte loads (a block's
//     run as one coalesced copy, one or more points per thread), and
//     reading the counter through L2 only, were each slower at every shape
//     in a variant timing on the card, so neither is kept.
// The scatter writes into a copy of the counter that the wrapper makes
// (the function does not mutate its input): folding that copy into the
// kernel would need a grid-wide barrier between a block's copy and any
// other block's first add.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "voxel_grid.cuh"

namespace {

constexpr int kThreads = 256;

// flat counter index of point n, or -1 for a boundary point
__device__ __forceinline__ int voxel_index(const float* __restrict__ x, int64_t n,
                                           int res) {
  float v[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) v[d] = __ldg(x + n * 3 + d);
  return nsl::voxel_flat(v, res);
}

__global__ void voxel_scatter_kernel(const float* __restrict__ x,
                                     float* __restrict__ counter, int64_t N,
                                     int res) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int i = n < N ? voxel_index(x, n, res) : -1;
  const int left = __shfl_up_sync(0xffffffffu, i, 1);
  const bool pair = i >= 0 && lane > 0 && left == i;
  if (__any_sync(0xffffffffu, pair)) {
    // the lanes on this voxel; the lowest adds for all of them
    const unsigned peers = __match_any_sync(0xffffffffu, i);
    if (i >= 0 && lane == __ffs(peers) - 1) atomicAdd(counter + i, (float)__popc(peers));
  } else if (i >= 0) {
    atomicAdd(counter + i, 1.0f);
  }
}

__global__ void voxel_beta_kernel(const float* __restrict__ x,
                                  const float* __restrict__ counter,
                                  float* __restrict__ beta, int64_t N, int res,
                                  float neg_b_1e4, float d, float a, float c) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int i = voxel_index(x, n, res);
  const float count = i >= 0 ? __ldg(counter + i) : 0.0f;
  beta[n] = nsl::voxel_beta(count, neg_b_1e4, d, a, c);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// counter += one visit per non-boundary point (in place: the wrapper hands
// in a fresh copy); res^3 < 2^31 (the wrapper checks)
int nsl_voxel_scatter(const void* x, void* counter, int64_t N, int res,
                      void* stream) {
  if (N == 0) return 0;
  voxel_scatter_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)counter, N, res);
  return (int)cudaGetLastError();
}

int nsl_voxel_beta(const void* x, const void* counter, void* beta, int64_t N,
                   int res, float neg_b_1e4, float d, float a, float c,
                   void* stream) {
  if (N == 0) return 0;
  voxel_beta_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)counter, (float*)beta, N, res, neg_b_1e4,
      d, a, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
