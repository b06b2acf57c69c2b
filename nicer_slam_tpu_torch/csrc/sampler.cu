// Importance sampler with the density-cache read fused in, for Hopper
// (sm_90a): K5 (with the K6 read).
//
// Replaces nicer_slam_tpu/ops/ray_sampling.py importance_z_vals (:112-163),
// _sample_cdf (:86-109) and uniform_z_vals (:62-83), with the density
// supplied by nicer_slam_tpu/models/scene_model.py _density_cache_lookup
// (:145-162) — the "cached" prepass. Per ray:
//   1. stratified z over [near, far(cube)] at Ne = 640 points, jittered by
//      the given t_rand (training) or not;
//   2. trilinear read of the plain [res^3] density volume at each point
//      (0 outside |p| <= 1);
//   3. weights from the free-energy exclusive cumsum (last dist 1e10);
//   4. pdf = w[:-1] + 1e-5, normalised, cdf with a leading 0;
//   5. inverse CDF at u = linspace(0, 1, Ns) with searchsorted(right);
//   6. merge with near, far and the Nextra shared extras z[perm], sort;
//   7. z_eik = sorted[eik_idx].
// All random draws are inputs. No gradient.
//
// Given-density mode replaces the same pipeline with the "exact" prepass
// (ray_sampling.py:131-134 with scene_model.py:246-260), which an eval
// render takes: the caller computes the unjittered z [R, Ne] and the
// densities of the SDF network (K3) with the voxel beta (K7) at those z,
// and the kernel runs steps 3-7 on them. z comes in as an input, so the
// inverse CDF uses bit for bit the z the network was evaluated at.
//
// What bounds it on the card: per ray, 640 trilinear reads of an 8 MB
// volume (L2 resident) and two sequential 640-long scans; the output is
// 98 floats. It is latency bound, not bandwidth bound. The design gives
// one 128-thread block to a ray: the stratified z, the 640 cache reads,
// the 64 binary searches and a 98-element rank sort run in parallel; the
// two scans run on one thread, in the order of the plain version's
// cumsum, so the inverse CDF (a discontinuous function of the cdf) sees
// the same numbers. Nothing but z_vals and z_eik touches device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float cache_read(const float* __restrict__ cache,
                                            int res, float px, float py,
                                            float pz) {
  if (!(fabsf(px) <= 1.0f && fabsf(py) <= 1.0f && fabsf(pz) <= 1.0f))
    return 0.0f;
  float half = 0.5f * (float)(res - 1);
  float p[3] = {px, py, pz};
  int g0[3];
  float f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float g = (p[d] + 1.0f) * half;
    float fl = fminf(fmaxf(floorf(g), 0.0f), (float)(res - 2));
    g0[d] = (int)fl;
    f[d] = fminf(fmaxf(g - fl, 0.0f), 1.0f);
  }
  int64_t base = ((int64_t)g0[0] * res + g0[1]) * res + g0[2];
  int64_t sx = (int64_t)res * res, sy = res;
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
    float w = (bx ? f[0] : 1.0f - f[0]) * (by ? f[1] : 1.0f - f[1]) *
              (bz ? f[2] : 1.0f - f[2]);
    acc += __ldg(cache + base + bx * sx + by * sy + bz) * w;
  }
  return acc;
}

// Steps 3-7 for one ray, all threads of the block: zs [Ne] holds the
// stratified z and buf [Ne] the free energy dist * density; writes the
// sorted z_out row [St] and z_eik.
__device__ void sample_from_free_energy(float* zs, float* buf, float* merged,
                                        int Ne, int Ns, int Nextra,
                                        float near, float far,
                                        const int64_t* __restrict__ perm,
                                        float u_step, int64_t eik,
                                        float* __restrict__ z_out_row,
                                        float* __restrict__ z_eik_out) {
  const int St = Ns + 2 + Nextra;
  const int tid = threadIdx.x;
  // 3-4. weights, pdf, cdf: sequential, in the plain version's order
  if (tid == 0) {
    float run = 0.0f;
    float total = 0.0f;
    for (int i = 0; i < Ne; ++i) {
      float e = buf[i];
      float w = (1.0f - expf(-e)) * expf(-run);
      run += e;
      buf[i] = w + 1e-5f;  // pdf (index Ne-1 unused)
      if (i < Ne - 1) total += buf[i];
    }
    float c = 0.0f;
    float prev = buf[0];
    buf[0] = 0.0f;
    for (int i = 1; i < Ne; ++i) {
      float pdf = prev / total;
      prev = buf[i];
      c += pdf;
      buf[i] = c;
    }
  }
  __syncthreads();
  // 5. inverse CDF at u = linspace(0, 1, Ns)
  for (int j = tid; j < Ns; j += kThreads) {
    float u = (j == Ns - 1) ? 1.0f : (float)j * u_step;
    int lo = 0, hi = Ne;  // first index with cdf > u
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (buf[mid] <= u) lo = mid + 1; else hi = mid;
    }
    int below = max(lo - 1, 0), above = min(lo, Ne - 1);
    float c0 = buf[below], c1 = buf[above];
    float b0 = zs[below], b1 = zs[above];
    float denom = c1 - c0;
    if (denom < 1e-5f) denom = 1.0f;
    float t = (u - c0) / denom;
    merged[j] = b0 + t * (b1 - b0);
  }
  // 6. near, far, extras
  if (tid == 0) {
    merged[Ns] = near;
    merged[Ns + 1] = far;
  }
  for (int k = tid; k < Nextra; k += kThreads) merged[Ns + 2 + k] = zs[perm[k]];
  __syncthreads();
  // rank sort (stable): position = #smaller + #equal before
  float* sorted = buf;  // reuse: St <= Ne
  for (int j = tid; j < St; j += kThreads) {
    float v = merged[j];
    int rank = 0;
    for (int k = 0; k < St; ++k) {
      float m = merged[k];
      rank += (m < v) || (m == v && k < j);
    }
    sorted[rank] = v;
  }
  __syncthreads();
  for (int j = tid; j < St; j += kThreads) z_out_row[j] = sorted[j];
  if (tid == 0) *z_eik_out = sorted[eik];
}

__global__ void importance_sample_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ cache, const float* __restrict__ t_rand,
    const int64_t* __restrict__ perm, const int64_t* __restrict__ eik_idx,
    float* __restrict__ z_out, float* __restrict__ z_eik, int res, int Ne,
    int Ns, int Nextra, float bound, float near, float far_max, float t_step,
    float u_step) {
  extern __shared__ float smem[];
  float* zs = smem;             // [Ne] stratified z
  float* buf = smem + Ne;       // [Ne] free energy, then cdf
  float* merged = buf + Ne;     // [Ns + 2 + Nextra]
  const int St = Ns + 2 + Nextra;
  const int64_t r = blockIdx.x;
  const int tid = threadIdx.x;

  float o[3] = {rays_o[r * 3], rays_o[r * 3 + 1], rays_o[r * 3 + 2]};
  float d[3] = {rays_d[r * 3], rays_d[r * 3 + 1], rays_d[r * 3 + 2]};
  // far from the cube intersection; near is the configured constant
  float nc = -INFINITY, fc = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = (-bound - o[k]) / (d[k] + 1e-15f);
    float t1 = (bound - o[k]) / (d[k] + 1e-15f);
    nc = fmaxf(nc, fminf(t0, t1));
    fc = fminf(fc, fmaxf(t0, t1));
  }
  float far = (fc < nc) ? 1e9f : fc;
  far = fminf(far, far_max);

  // 1. stratified z
  for (int i = tid; i < Ne; i += kThreads) {
    float ti = (i == Ne - 1) ? 1.0f : (float)i * t_step;
    float zi = near * (1.0f - ti) + far * ti;
    if (t_rand != nullptr) {
      float tn = (i + 1 == Ne - 1) ? 1.0f : (float)(i + 1) * t_step;
      float tp = (i - 1 == Ne - 1) ? 1.0f : (float)(i - 1) * t_step;
      float zn = near * (1.0f - tn) + far * tn;
      float zp = near * (1.0f - tp) + far * tp;
      float upper = (i < Ne - 1) ? 0.5f * (zi + zn) : zi;
      float lower = (i > 0) ? 0.5f * (zp + zi) : zi;
      zi = lower + (upper - lower) * t_rand[r * Ne + i];
    }
    zs[i] = zi;
  }
  __syncthreads();
  // 2. cache read -> free energy
  for (int i = tid; i < Ne; i += kThreads) {
    float z = zs[i];
    float sg = cache_read(cache, res, o[0] + z * d[0], o[1] + z * d[1],
                          o[2] + z * d[2]);
    float dist = (i < Ne - 1) ? (zs[i + 1] - z) : 1e10f;
    buf[i] = dist * sg;
  }
  __syncthreads();
  sample_from_free_energy(zs, buf, merged, Ne, Ns, Nextra, near, far, perm,
                          u_step, eik_idx[r], z_out + r * St, z_eik + r);
}

// Given-density mode (the exact prepass of an eval render): z [R, Ne] and
// the densities the SDF network gave at those z come in; near and far are
// z's ends (linspace puts them there exactly).
__global__ void importance_sample_given_kernel(
    const float* __restrict__ z, const float* __restrict__ density,
    const int64_t* __restrict__ perm, const int64_t* __restrict__ eik_idx,
    float* __restrict__ z_out, float* __restrict__ z_eik, int Ne, int Ns,
    int Nextra, float u_step) {
  extern __shared__ float smem[];
  float* zs = smem;
  float* buf = smem + Ne;
  float* merged = buf + Ne;
  const int St = Ns + 2 + Nextra;
  const int64_t r = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < Ne; i += kThreads) zs[i] = z[r * Ne + i];
  __syncthreads();
  for (int i = tid; i < Ne; i += kThreads) {
    float dist = (i < Ne - 1) ? (zs[i + 1] - zs[i]) : 1e10f;
    buf[i] = dist * density[r * Ne + i];
  }
  __syncthreads();
  sample_from_free_energy(zs, buf, merged, Ne, Ns, Nextra, zs[0], zs[Ne - 1],
                          perm, u_step, eik_idx[r], z_out + r * St, z_eik + r);
}

}  // namespace

extern "C" {

int nsl_importance_sample(const void* rays_o, const void* rays_d,
                          const void* cache, const void* t_rand,
                          const void* perm, const void* eik_idx, void* z_out,
                          void* z_eik, int64_t R, int res, int Ne, int Ns,
                          int Nextra, float bound, float near, float far_max,
                          float t_step, float u_step, void* stream) {
  if (R == 0) return 0;
  int St = Ns + 2 + Nextra;
  if (St > Ne || Ne < 2 || Ns < 2) return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(float) * (size_t)(2 * Ne + St);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  importance_sample_kernel<<<(unsigned)R, kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)cache,
      (const float*)t_rand, (const int64_t*)perm, (const int64_t*)eik_idx,
      (float*)z_out, (float*)z_eik, res, Ne, Ns, Nextra, bound, near, far_max,
      t_step, u_step);
  return (int)cudaGetLastError();
}

int nsl_importance_sample_given(const void* z, const void* density,
                                const void* perm, const void* eik_idx,
                                void* z_out, void* z_eik, int64_t R, int Ne,
                                int Ns, int Nextra, float u_step,
                                void* stream) {
  if (R == 0) return 0;
  int St = Ns + 2 + Nextra;
  if (St > Ne || Ne < 2 || Ns < 2) return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(float) * (size_t)(2 * Ne + St);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  importance_sample_given_kernel<<<(unsigned)R, kThreads, smem,
                                   (cudaStream_t)stream>>>(
      (const float*)z, (const float*)density, (const int64_t*)perm,
      (const int64_t*)eik_idx, (float*)z_out, (float*)z_eik, Ne, Ns, Nextra,
      u_step);
  return (int)cudaGetLastError();
}

}  // extern "C"
