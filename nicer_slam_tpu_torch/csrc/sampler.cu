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
// (ray_sampling.py:131-134 with scene_model.py:246-287), the JAX package's
// default in training and what every eval render takes: the caller
// computes z [R, Ne] (jittered in training), near and far [R, 1] (the
// configured near and the cube's far, not z's ends, which jitter moves)
// and the densities of the SDF network with the voxel beta at those z (K6),
// and the kernel runs steps 3-7 on them. z comes in as an input, so the
// inverse CDF uses bit for bit the z the network was evaluated at. The
// extras come from perm [n_chunks, Nextra], ray r reading row r / chunk:
// the JAX package draws them per chunk of prepass_ray_chunk rays
// (scene_model.py:264-282), one key per chunk.
//
// What bounds it on the card: per ray, 640 trilinear reads of an 8 MB
// volume (L2 resident) and two 640-long scans; the output is 98 floats.
// It is latency bound, not bandwidth bound: what matters is how long one
// ray's chain of dependent steps is and how many rays are in flight. The
// design gives one warp to a ray, 4 rays to a 128-thread block, and keeps
// everything but z_vals and z_eik in the warp's rows of shared memory
// (z [Ne] | free energy, then cdf [Ne] | merged row [128]):
//   * steps 1-2 run lane-strided (lane i takes samples i, i + 32, ...), so
//     a warp's loads of t_rand, z or density are one coalesced row and its
//     cache reads are 32 neighbouring points of the ray;
//   * steps 3-4 are scans: each lane owns ceil(Ne/32) contiguous samples
//     (20 at Ne = 640) in registers, scans them serially and combines the
//     lanes' chunk sums with a shuffle scan (warp.cuh); the pdf total is a
//     shuffle reduction;
//   * step 5 is Ns binary searches over the warp's cdf row, lane-strided
//     (2 per lane at Ns = 64);
//   * step 6 sorts the merged row with a warp bitonic sort in 128 slots
//     (+inf padding), 4 per lane in registers, exchanging across lanes by
//     shuffles: 28 compare-exchange stages, no shared memory traffic;
//   * z_vals leaves through the merged row as one coalesced row per ray.
// The plain version (ops/ray_sampling.py) sums in the same lane-chunked
// order, and every other operation here rounds once, as the plain
// version's tensor operations do (__fmul_rn/__fadd_rn keep the compiler
// from fusing a multiply-add): the inverse CDF is discontinuous in the cdf
// (the u = 1 sample and the 1e-5 floor under a bin's cdf step), so the two
// must see the same float32 numbers.
// Limits: Ne <= 1024 (32 samples per lane in registers) and Ns + 2 +
// Nextra <= 128 (the sort's slots); the wrapper raises above them.
//
// It replaces an earlier design (one 128-thread block per ray, both scans
// on one thread, an O(St^2) rank sort) whose serial scan set its time.
// Measured against it in one call (H100 80GB HBM3, 700 W;
// tools/hash_kernel_ab.py, PERF.md §6): 0.019 / 0.037 / 0.063 ms at 1024 /
// 4096 / 8192 rays against 0.064 / 0.225 / 0.405 ms, given densities at
// 2580 rays 0.015 against 0.117 ms; the outputs bit for bit those of the
// plain version. Variants that were no faster, timed in turns on the same
// card: the cache-read loop fully unrolled; each lane's jitter draws (or
// z and densities) loaded into registers before use; 2 or 8 warps per
// block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "warp.cuh"

namespace {

using nsl::kFull;
using nsl::warp_excl_prefix;
using nsl::warp_sum;

constexpr int kWarpsPerBlock = 4;
// the merged row is sorted in 32 * kSlots slots, kSlots per lane
constexpr int kSlots = 4;
constexpr int kMaxSorted = 32 * kSlots;
// prepass samples per lane in registers, at most: Ne <= 32 * kMaxChunk
constexpr int kMaxChunk = 32;

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
    acc = __fadd_rn(acc, __fmul_rn(__ldg(cache + base + bx * sx + by * sy + bz), w));
  }
  return acc;
}

// z_i = near (1 - t_i) + far t_i at t_i = i * f32(1/(Ne-1)), the last t
// exactly 1 (linspace), each operation rounded on its own
__device__ __forceinline__ float linspace_z(int i, int Ne, float near, float far,
                                            float t_step) {
  const float t = (i == Ne - 1) ? 1.0f : (float)i * t_step;
  return __fadd_rn(__fmul_rn(near, 1.0f - t), __fmul_rn(far, t));
}

// the warp's rows of the block's shared memory
struct RayRows {
  float* z;       // [Ne] prepass z
  float* c;       // [Ne] free energy, then the cdf
  float* merged;  // [kMaxSorted] merged samples, then the sorted row
};

__host__ __device__ constexpr int row_floats(int Ne) { return 2 * Ne + kMaxSorted; }

__device__ __forceinline__ RayRows ray_rows(float* smem, int Ne) {
  float* base = smem + (threadIdx.x >> 5) * row_floats(Ne);
  return {base, base + Ne, base + 2 * Ne};
}

// ascending sort of the 32 * kSlots values of a warp, lane l holding slots
// kSlots l .. kSlots l + kSlots - 1: the bitonic network, a partner in the
// same lane compared in registers, one in another lane read by a shuffle
__device__ __forceinline__ void warp_bitonic_sort(float v[kSlots], int lane) {
#pragma unroll
  for (int k = 2; k <= kMaxSorted; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < kSlots) {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int q2 = q ^ j;
          if (q2 > q) {
            const bool up = ((lane * kSlots + q) & k) == 0;
            const float a = v[q], b = v[q2];
            v[q] = up ? fminf(a, b) : fmaxf(a, b);
            v[q2] = up ? fmaxf(a, b) : fminf(a, b);
          }
        }
      } else {
        const int lanes = j / kSlots;
        const bool lower = (lane & lanes) == 0;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const float o = __shfl_xor_sync(kFull, v[q], lanes);
          const bool up = ((lane * kSlots + q) & k) == 0;
          v[q] = (lower == up) ? fminf(v[q], o) : fmaxf(v[q], o);
        }
      }
    }
  }
}

// Steps 3-7 for the warp's ray: rows.z holds the prepass z and rows.c their
// free energy dist * density; writes the sorted z_out row [St] and z_eik.
// CH >= ceil(Ne / 32) is the register chunk of the scans.
template <int CH>
__device__ __forceinline__ void sample_ray(const RayRows& rows, int lane, int Ne, int Ns,
                                           int Nextra, float near, float far,
                                           const int64_t* __restrict__ perm,
                                           float u_step, int64_t eik,
                                           float* __restrict__ z_out_row,
                                           float* __restrict__ z_eik_out) {
  const int St = Ns + 2 + Nextra;
  const int n = (Ne + 31) / 32;
  const int i0 = lane * n;  // this lane's samples: [i0, i0 + n) within [0, Ne)
  // 3. weights w_i = (1 - exp(-e_i)) exp(-sum_{k<i} e_k), pdf = w + 1e-5
  float p[CH];
  float loc = 0.0f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    p[j] = (j < n && i0 + j < Ne) ? rows.c[i0 + j] : 0.0f;
    loc += p[j];
  }
  float run = warp_excl_prefix(loc, lane);
  float part = 0.0f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const float e = p[j];
    p[j] = __fadd_rn(__fmul_rn(1.0f - expf(-e), expf(-run)), 1e-5f);
    run += e;
    if (j < n && i0 + j < Ne - 1) part += p[j];  // the last pdf bin is unused
  }
  // 4. cdf[i] = sum_{k<i} pdf_k / total
  const float total = warp_sum(part);
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    p[j] = p[j] / total;
    if (j < n && i0 + j < Ne - 1) q += p[j];
  }
  float c = warp_excl_prefix(q, lane);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j < n && i0 + j < Ne) rows.c[i0 + j] = c;
    if (j < n && i0 + j < Ne - 1) c += p[j];
  }
  __syncwarp();
  // 5. inverse CDF at u = linspace(0, 1, Ns): the first cdf entry > u
  for (int s = lane; s < Ns; s += 32) {
    const float u = (s == Ns - 1) ? 1.0f : (float)s * u_step;
    int lo = 0, hi = Ne;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rows.c[mid] <= u) lo = mid + 1; else hi = mid;
    }
    const int below = max(lo - 1, 0), above = min(lo, Ne - 1);
    const float c0 = rows.c[below], c1 = rows.c[above];
    const float b0 = rows.z[below], b1 = rows.z[above];
    float denom = c1 - c0;
    if (denom < 1e-5f) denom = 1.0f;
    const float t = (u - c0) / denom;
    rows.merged[s] = __fadd_rn(b0, __fmul_rn(t, b1 - b0));
  }
  // 6. near, far and the extras, then the sort
  for (int k = lane; k < Nextra + 2; k += 32)
    rows.merged[Ns + k] = k == 0 ? near : (k == 1 ? far : rows.z[perm[k - 2]]);
  __syncwarp();
  float v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = lane * kSlots + s;
    v[s] = e < St ? rows.merged[e] : INFINITY;
  }
  warp_bitonic_sort(v, lane);
  __syncwarp();  // every lane has read its slots before the row is rewritten
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = lane * kSlots + s;
    if (e < St) rows.merged[e] = v[s];
  }
  __syncwarp();
  // 7. the sorted row out, coalesced; the eikonal anchor from it
  for (int i = lane; i < St; i += 32) z_out_row[i] = rows.merged[i];
  if (lane == 0) *z_eik_out = rows.merged[eik];
}

template <int CH>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) importance_sample_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ cache, const float* __restrict__ t_rand,
    const int64_t* __restrict__ perm, const int64_t* __restrict__ eik_idx,
    float* __restrict__ z_out, float* __restrict__ z_eik, int64_t R, int res,
    int Ne, int Ns, int Nextra, float bound, float near, float far_max,
    float t_step, float u_step) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform per warp; the block never synchronises
  const RayRows rows = ray_rows(smem, Ne);

  const float o[3] = {rays_o[r * 3], rays_o[r * 3 + 1], rays_o[r * 3 + 2]};
  const float d[3] = {rays_d[r * 3], rays_d[r * 3 + 1], rays_d[r * 3 + 2]};
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
  for (int i = lane; i < Ne; i += 32) {
    float zi = linspace_z(i, Ne, near, far, t_step);
    if (t_rand != nullptr) {
      float upper = (i < Ne - 1) ? 0.5f * (zi + linspace_z(i + 1, Ne, near, far, t_step)) : zi;
      float lower = (i > 0) ? 0.5f * (linspace_z(i - 1, Ne, near, far, t_step) + zi) : zi;
      zi = __fadd_rn(lower, __fmul_rn(upper - lower, t_rand[r * Ne + i]));
    }
    rows.z[i] = zi;
  }
  __syncwarp();
  // 2. cache read -> free energy
#pragma unroll 4
  for (int i = lane; i < Ne; i += 32) {
    const float z = rows.z[i];
    const float sg = cache_read(cache, res, __fadd_rn(o[0], __fmul_rn(z, d[0])),
                                __fadd_rn(o[1], __fmul_rn(z, d[1])),
                                __fadd_rn(o[2], __fmul_rn(z, d[2])));
    const float dist = (i < Ne - 1) ? (rows.z[i + 1] - z) : 1e10f;
    rows.c[i] = dist * sg;
  }
  __syncwarp();
  sample_ray<CH>(rows, lane, Ne, Ns, Nextra, near, far, perm, u_step, eik_idx[r],
                 z_out + r * (Ns + 2 + Nextra), z_eik + r);
}

// Given-density mode (the exact prepass): z [R, Ne], near and far [R, 1]
// and the densities the SDF network gave at those z come in; ray r takes
// its extras from perm row r / chunk.
template <int CH>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) importance_sample_given_kernel(
    const float* __restrict__ z, const float* __restrict__ near,
    const float* __restrict__ far, const float* __restrict__ density,
    const int64_t* __restrict__ perm, const int64_t* __restrict__ eik_idx,
    float* __restrict__ z_out, float* __restrict__ z_eik, int64_t R, int64_t chunk,
    int Ne, int Ns, int Nextra, float u_step) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const RayRows rows = ray_rows(smem, Ne);
  for (int i = lane; i < Ne; i += 32) rows.z[i] = z[r * Ne + i];
  __syncwarp();
  for (int i = lane; i < Ne; i += 32) {
    const float dist = (i < Ne - 1) ? (rows.z[i + 1] - rows.z[i]) : 1e10f;
    rows.c[i] = dist * density[r * Ne + i];
  }
  __syncwarp();
  sample_ray<CH>(rows, lane, Ne, Ns, Nextra, near[r], far[r], perm + (r / chunk) * Nextra,
                 u_step, eik_idx[r], z_out + r * (Ns + 2 + Nextra), z_eik + r);
}

// launch kern<CH> with CH the smallest of 4, 8, 20, 32 that holds
// ceil(Ne / 32) samples; invalid shapes are refused before any launch
template <typename Launch>
int launch_rays(int64_t R, int Ne, int Ns, int Nextra, cudaStream_t s, Launch launch) {
  if (R == 0) return 0;
  if (Ne < 2 || Ne > 32 * kMaxChunk || Ns < 2 || Nextra < 0 ||
      Ns + 2 + Nextra > kMaxSorted)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((R + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  const size_t smem = sizeof(float) * (size_t)kWarpsPerBlock * row_floats(Ne);
  const int n = (Ne + 31) / 32;
  if (n <= 4) launch(std::integral_constant<int, 4>{}, grid, block, smem, s);
  else if (n <= 8) launch(std::integral_constant<int, 8>{}, grid, block, smem, s);
  else if (n <= 20) launch(std::integral_constant<int, 20>{}, grid, block, smem, s);
  else launch(std::integral_constant<int, kMaxChunk>{}, grid, block, smem, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nsl_importance_sample(const void* rays_o, const void* rays_d,
                          const void* cache, const void* t_rand,
                          const void* perm, const void* eik_idx, void* z_out,
                          void* z_eik, int64_t R, int res, int Ne, int Ns,
                          int Nextra, float bound, float near, float far_max,
                          float t_step, float u_step, void* stream) {
  return launch_rays(R, Ne, Ns, Nextra, (cudaStream_t)stream,
                     [&](auto ch, dim3 grid, dim3 block, size_t smem, cudaStream_t s) {
                       importance_sample_kernel<decltype(ch)::value><<<grid, block, smem, s>>>(
                           (const float*)rays_o, (const float*)rays_d, (const float*)cache,
                           (const float*)t_rand, (const int64_t*)perm,
                           (const int64_t*)eik_idx, (float*)z_out, (float*)z_eik, R, res,
                           Ne, Ns, Nextra, bound, near, far_max, t_step, u_step);
                     });
}

int nsl_importance_sample_given(const void* z, const void* near, const void* far,
                                const void* density, const void* perm,
                                const void* eik_idx, void* z_out, void* z_eik,
                                int64_t R, int64_t chunk, int Ne, int Ns, int Nextra,
                                float u_step, void* stream) {
  if (R > 0 && (chunk < 1 || R % chunk != 0)) return (int)cudaErrorInvalidValue;
  return launch_rays(R, Ne, Ns, Nextra, (cudaStream_t)stream,
                     [&](auto ch, dim3 grid, dim3 block, size_t smem, cudaStream_t s) {
                       importance_sample_given_kernel<decltype(ch)::value>
                           <<<grid, block, smem, s>>>(
                               (const float*)z, (const float*)near, (const float*)far,
                               (const float*)density, (const int64_t*)perm,
                               (const int64_t*)eik_idx, (float*)z_out, (float*)z_eik, R,
                               chunk, Ne, Ns, Nextra, u_step);
                     });
}

}  // extern "C"
