// TSDF integration of one depth frame for Hopper (sm_90a): K9.
//
// Replaces nicer_slam_tpu/preprocess/tsdf_fusion.py make_integrate_fn's
// `integrate` (:33-58), one fused jit per frame over the dense res^3 volume.
// Per voxel (i, j, k) at (xs[i], ys[j], zs[k]), flat index (i res + j) res + k:
//   c      = w2c[:3, :3] x + w2c[:3, 3]             (camera space)
//   u, v   = fx c_x / c_z + cx, fy c_y / c_z + cy    (rounded half to even)
//   inb    = c_z > 0 and (u, v) inside the frame
//   d      = depth[v, u] where inb, else 0
//   w_obs  = 1 where inb, 0 < d < depth_max and d - c_z > -trunc, else 0
//   tsdf   = (tsdf w + clip((d - c_z) / trunc, -1, 1) w_obs) / max(w + w_obs, 1e-9)
//            where w + w_obs > 0; w += w_obs
// in place on float32 tsdf and weight [res^3].
//
// What bounds it on the card: the bytes it must move. Every voxel's weight
// is read (4 bytes); only a voxel with weight or an observation (nw > 0)
// has its tsdf read and written (8 bytes), and only an observed one its
// weight written (4 bytes); the depth frame (3.3 MB at 680 x 1200) stays in
// L2 and the three coordinate arrays in L1. A frame observes a thin shell
// of the volume, so at 256^3 the weight read (67 MB, 0.020 ms at 3.35 TB/s)
// is most of it; the ~30 operations per voxel (0.5 GFLOP) are far below.
// The design is the simple one: a thread per voxel, a block per (i, j) row
// (or a part of it), k the thread, so a warp reads and writes 128
// contiguous bytes of each volume and a thread needs no 64-bit division to
// find its voxel (splitting a flat index so took longer than the bytes);
// the voxel centre is formed from the per-axis coordinates (no [res^3, 3]
// grid in memory).
//
// It agrees with the plain version (ops/tsdf.py integrate_plain) bit for
// bit: every product and sum is rounded on its own (__fmul_rn/__fadd_rn,
// so nvcc contracts nothing into an FMA that the plain version's separate
// torch ops do not make), in the plain version's order; rounding is rintf
// (half to even, as torch.round and jnp.round; roundf rounds half away from
// zero); divisions are IEEE (__fdiv_rn).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void tsdf_integrate_kernel(float* __restrict__ tsdf, float* __restrict__ weight,
                                      const float* __restrict__ depth,
                                      const float* __restrict__ w2c,
                                      const float* __restrict__ K,
                                      const float* __restrict__ xs,
                                      const float* __restrict__ ys,
                                      const float* __restrict__ zs, int res, int H, int W,
                                      float trunc, float depth_max) {
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= res) return;
  const int row = blockIdx.x;  // i res + j
  const int i = row / res, j = row - i * res;
  const int64_t n = (int64_t)row * res + k;
  const float p[3] = {__ldg(xs + i), __ldg(ys + j), __ldg(zs + k)};
  float c[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = w2c + 4 * r;
    float s = __fadd_rn(__fmul_rn(__ldg(m), p[0]), __fmul_rn(__ldg(m + 1), p[1]));
    s = __fadd_rn(s, __fmul_rn(__ldg(m + 2), p[2]));
    c[r] = __fadd_rn(s, __ldg(m + 3));
  }
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(__ldg(K), c[0]), c[2]), __ldg(K + 2));
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(__ldg(K + 4), c[1]), c[2]), __ldg(K + 5));
  const float ui = rintf(u), vi = rintf(v);
  const bool inb = c[2] > 0.f && ui >= 0.f && ui < (float)W && vi >= 0.f && vi < (float)H;
  const float d = inb ? __ldg(depth + (int64_t)vi * W + (int64_t)ui) : 0.f;
  const float sdf = __fsub_rn(d, c[2]);
  const bool valid = inb && d > 0.f && d < depth_max && sdf > -trunc;
  const float obs = fminf(fmaxf(__fdiv_rn(sdf, trunc), -1.f), 1.f);
  const float w_obs = valid ? 1.f : 0.f;
  const float w = weight[n];
  const float nw = __fadd_rn(w, w_obs);
  // an unobserved voxel keeps its weight (w + 0 = w), and one that no frame
  // has observed (nw = 0) keeps its tsdf: neither is read or written
  if (valid) weight[n] = nw;
  if (nw > 0.f) {
    tsdf[n] = __fdiv_rn(__fadd_rn(__fmul_rn(tsdf[n], w), __fmul_rn(obs, w_obs)),
                        fmaxf(nw, 1e-9f));
  }
}

}  // namespace

extern "C" {

// tsdf, weight [res^3] float32 (updated in place), depth [H, W], w2c [4, 4],
// K [3, 3], xs/ys/zs [res] float32
int nsl_tsdf_integrate(void* tsdf, void* weight, const void* depth, const void* w2c,
                       const void* K, const void* xs, const void* ys, const void* zs,
                       int res, int H, int W, float trunc, float depth_max, void* stream) {
  if (res <= 0) return 0;
  const int threads = res < kMaxThreads ? (res + 31) / 32 * 32 : kMaxThreads;
  const dim3 grid((unsigned)res * (unsigned)res, (unsigned)((res + threads - 1) / threads));
  tsdf_integrate_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (float*)tsdf, (float*)weight, (const float*)depth, (const float*)w2c, (const float*)K,
      (const float*)xs, (const float*)ys, (const float*)zs, res, H, W, trunc, depth_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
