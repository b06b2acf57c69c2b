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
// What bounds it on the card: one 4-byte atomic add (scatter) or gather
// (read) per point into a 1 MB counter that stays in L2; 800k points per
// mapping iteration. It is bound by atomic throughput on the few hot
// voxels near the surface, not by memory bandwidth. The design is one
// thread per point with a plain atomicAdd: float adds of 1.0 are exact
// below 2^24, so the counter equals the plain version's bit for bit,
// whatever order the atomics land in (the plain index_put with accumulate
// is a sort by index and a segmented sum on the card).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// flat counter index of a point, or -1 for a boundary point (any |x| > 0.99)
__device__ __forceinline__ int64_t voxel_index(const float* __restrict__ x,
                                               int64_t n, int res) {
  int64_t flat = 0;
  bool boundary = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float v = x[n * 3 + d];
    boundary |= fabsf(v) > 0.99f;
    // the plain version's order: ((x + 1) / 2) * res, then truncation
    float u = __fdiv_rn(__fadd_rn(v, 1.0f), 2.0f);
    int i = (int)__fmul_rn(u, (float)res);
    i = min(max(i, 0), res - 1);
    flat = flat * res + i;
  }
  return boundary ? -1 : flat;
}

__global__ void voxel_scatter_kernel(const float* __restrict__ x,
                                     float* __restrict__ counter, int64_t N,
                                     int res) {
  int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int64_t i = voxel_index(x, n, res);
  if (i >= 0) atomicAdd(counter + i, 1.0f);
}

__global__ void voxel_beta_kernel(const float* __restrict__ x,
                                  const float* __restrict__ counter,
                                  float* __restrict__ beta, int64_t N, int res,
                                  float neg_b_1e4, float d, float a, float c) {
  int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int64_t i = voxel_index(x, n, res);
  float count = i >= 0 ? __ldg(counter + i) : 0.0f;
  // (-B 1e-4) count D, exp, A e + C: each rounded as the plain version
  // rounds it (no fused multiply-add)
  float e = expf(__fmul_rn(__fmul_rn(neg_b_1e4, count), d));
  beta[n] = __fadd_rn(__fmul_rn(a, e), c);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// counter += one visit per non-boundary point (in place: the wrapper hands
// in a fresh copy)
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
