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
//     (padding after NaN, which sorts after +inf as torch.sort puts it), 4
//     per lane in registers as unsigned keys, exchanging across lanes by
//     shuffles: 28 compare-exchange stages, no shared memory traffic;
//   * z_vals leaves through the merged row as one coalesced row per ray.
// The plain version (ops/ray_sampling.py) sums in the same lane-chunked
// order, and every other operation here rounds once, as the plain
// version's tensor operations do (__fmul_rn/__fadd_rn keep the compiler
// from fusing a multiply-add): the inverse CDF is discontinuous in the cdf
// (the u = 1 sample and the 1e-5 floor under a bin's cdf step), so the two
// must see the same float32 numbers.
// Any Ne >= 1, Ns >= 0 and Nextra >= 0 run (St = Ns + 2 + Nextra sorted
// samples). The kernels of the design above, unchanged, take 2 <= Ne <=
// 1024, Ns >= 2 and St <= 128 (the shipped Ne = 640, St = 98 among them);
// sampler_kernel below takes every other shape, with the same steps:
//   * Ne > 1024 (more than 32 samples a lane): each lane keeps its chunk of
//     ceil(Ne/32) contiguous samples, the order the plain version sums in,
//     and the scans read and write the chunk in the warp's row in four
//     passes instead of holding it in registers (CH = 0 below): the same
//     operations on the same float32 numbers, so still bit for bit;
//   * St > 128: the warp bitonic sort with 8 or 16 keys a lane in
//     registers (256 or 512 slots); past 512, a bitonic sort of the keys in
//     place in the warp's merged row (the next power of two of St slots,
//     each stage's pairs taken lane-strided between __syncwarp()s), NaN
//     still last;
//   * where a block's rows (4 (2 Ne + slots) bytes a warp) outgrow 227 KB
//     at 4 warps, blocks of 2 or 1 warps; past one warp's (Ne ~ 29 k), the
//     rows live in a global scratch (nsl_importance_sample_global), one row
//     per resident warp, each warp walking rays kRowsWarps apart, so that
//     the rows in use stay few and in L2.
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

// The sort's order as unsigned keys: -inf, the finite values and +inf
// ascending, then NaN, then the padding. torch.sort (the plain version)
// places NaN last too: a ray whose prepass weights overflow (its z running
// backwards from a camera outside the cube, PERF.md) keeps its NaN samples
// at the end of its row, where a float min/max network would drop them and
// duplicate finite ones.
constexpr unsigned kNanKey = 0xfffffffeu;
constexpr unsigned kPadKey = 0xffffffffu;

__device__ __forceinline__ unsigned sort_key(float x) {
  const unsigned b = __float_as_uint(x);
  return isnan(x) ? kNanKey : (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return k >= kNanKey ? __uint_as_float(0x7fc00000u)
                      : __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ascending sort of the 32 * kSlots keys of a warp, lane l holding slots
// kSlots l .. kSlots l + kSlots - 1: the bitonic network, a partner in the
// same lane compared in registers, one in another lane read by a shuffle
__device__ __forceinline__ void warp_bitonic_sort(unsigned v[kSlots], int lane) {
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
            const unsigned a = v[q], b = v[q2];
            v[q] = up ? min(a, b) : max(a, b);
            v[q2] = up ? max(a, b) : min(a, b);
          }
        }
      } else {
        const int lanes = j / kSlots;
        const bool lower = (lane & lanes) == 0;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const unsigned o = __shfl_xor_sync(kFull, v[q], lanes);
          const bool up = ((lane * kSlots + q) & k) == 0;
          v[q] = (lower == up) ? min(v[q], o) : max(v[q], o);
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
  unsigned v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = lane * kSlots + s;
    v[s] = e < St ? sort_key(rows.merged[e]) : kPadKey;
  }
  warp_bitonic_sort(v, lane);
  __syncwarp();  // every lane has read its slots before the row is rewritten
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = lane * kSlots + s;
    if (e < St) rows.merged[e] = key_value(v[s]);
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

// the shapes the kernels above take: 2 <= Ne <= 1024, Ns >= 2 and St <= 128
// (the shipped Ne = 640, St = 98 among them)
inline bool shipped_shape(int Ne, int Ns, int Nextra) {
  return Ne >= 2 && Ne <= 32 * kMaxChunk && Ns >= 2 && Nextra >= 0 &&
         Ns + 2 + Nextra <= kMaxSorted;
}

// launch kern<CH> with CH the smallest of 4, 8, 20, 32 that holds
// ceil(Ne / 32) samples; shapes past the shipped kernels are refused before
// any launch (launch_any takes them)
template <typename Launch>
int launch_shipped(int64_t R, int Ne, int Ns, int Nextra, cudaStream_t s, Launch launch) {
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

// ---------------------------------------------------------------------------
// Any other shape: the same steps for any Ne, Ns, Nextra
// ---------------------------------------------------------------------------

// warps that share the global scratch rows, per SM (the scratch path)
constexpr int kRowsWarpsPerSm = 8;

template <int V>
using IC = std::integral_constant<int, V>;

__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// z_i = near (1 - t_i) + far t_i at t_i = i * f32(1/(Ne-1)), the last t
// exactly 1 where Ne > 1 (linspace; linspace(0, 1, 1) is 0, with t_step
// 0), each operation rounded on its own
__device__ __forceinline__ float linspace_z_any(int i, int Ne, float near, float far,
                                                float t_step) {
  const float t = (i == Ne - 1 && i > 0) ? 1.0f : (float)i * t_step;
  return __fadd_rn(__fmul_rn(near, 1.0f - t), __fmul_rn(far, t));
}

// the warp's rows, in the block's shared memory or in the global scratch
struct AnyRows {
  float* z;       // [Ne] prepass z
  float* c;       // [Ne] free energy, then the pdf, then the cdf
  float* merged;  // [sort slots] merged samples, then the sorted row
};

// the sort for St samples: 4, 8 or 16 keys a lane in registers, or 0 (the
// keys sorted in place in the merged row)
__host__ __device__ constexpr int sort_slots(int St) {
  return St <= 128 ? 4 : St <= 256 ? 8 : St <= 512 ? 16 : 0;
}

__host__ __device__ inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// floats of the merged row and of a warp's rows
__host__ __device__ inline int merged_floats(int St) {
  const int slots = sort_slots(St);
  return slots ? 32 * slots : next_pow2(St);
}

__host__ __device__ inline int64_t any_row_floats(int Ne, int St) {
  return 2 * (int64_t)Ne + merged_floats(St);
}

__device__ __forceinline__ AnyRows any_rows(float* base, int Ne) {
  return {base, base + Ne, base + 2 * Ne};
}

// ascending sort of the 32 * SLOTS keys of a warp, lane l holding slots
// SLOTS l .. SLOTS l + SLOTS - 1: the bitonic network, a partner in the
// same lane compared in registers, one in another lane read by a shuffle
template <int SLOTS>
__device__ __forceinline__ void warp_bitonic_sort_n(unsigned v[SLOTS], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * SLOTS; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < SLOTS) {
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) {
          const int q2 = q ^ j;
          if (q2 > q) {
            const bool up = ((lane * SLOTS + q) & k) == 0;
            const unsigned a = v[q], b = v[q2];
            v[q] = up ? min(a, b) : max(a, b);
            v[q2] = up ? max(a, b) : min(a, b);
          }
        }
      } else {
        const int lanes = j / SLOTS;
        const bool lower = (lane & lanes) == 0;
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) {
          const unsigned o = __shfl_xor_sync(kFull, v[q], lanes);
          const bool up = ((lane * SLOTS + q) & k) == 0;
          v[q] = (lower == up) ? min(v[q], o) : max(v[q], o);
        }
      }
    }
  }
}

// the same network over P (a power of two) keys in place in the warp's row:
// each stage's P / 2 pairs taken lane-strided, a __syncwarp() between stages
__device__ __forceinline__ void row_bitonic_sort(unsigned* keys, int P, int lane) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < P / 2; i += 32) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1)), b = a + j;
        const bool up = (a & k) == 0;
        const unsigned x = keys[a], y = keys[b];
        if (up ? x > y : x < y) {
          keys[a] = y;
          keys[b] = x;
        }
      }
      __syncwarp();
    }
  }
}

// Steps 3-4 with the lane's chunk in registers (CH >= ceil(Ne / 32)):
// rows.c holds the free energy on entry and the cdf on exit
template <int CH>
__device__ __forceinline__ void cdf_in_registers(const AnyRows& rows, int lane, int Ne) {
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
}

// Steps 3-4 for any Ne: the same lane chunks and the same operations in
// the same order, the chunk read and rewritten in the row in four passes
// (free energy -> pdf -> pdf / total -> cdf)
__device__ __forceinline__ void cdf_in_row(const AnyRows& rows, int lane, int Ne) {
  const int n = (Ne + 31) / 32;
  const int i0 = lane * n, i1 = min(i0 + n, Ne);
  float* c = rows.c;
  float loc = 0.0f;
  for (int i = i0; i < i1; ++i) loc += c[i];
  float run = warp_excl_prefix(loc, lane);
  float part = 0.0f;
  for (int i = i0; i < i1; ++i) {
    const float e = c[i];
    const float p = __fadd_rn(__fmul_rn(1.0f - expf(-e), expf(-run)), 1e-5f);
    run += e;
    c[i] = p;
    if (i < Ne - 1) part += p;  // the last pdf bin is unused
  }
  const float total = warp_sum(part);
  float q = 0.0f;
  for (int i = i0; i < i1; ++i) {
    const float p = c[i] / total;
    c[i] = p;
    if (i < Ne - 1) q += p;
  }
  float cc = warp_excl_prefix(q, lane);
  for (int i = i0; i < i1; ++i) {
    const float p = c[i];
    c[i] = cc;
    if (i < Ne - 1) cc += p;
  }
}

// Steps 3-7 for the warp's ray: rows.z holds the prepass z and rows.c their
// free energy dist * density; writes the sorted z_out row [St] and z_eik.
// CH: the register chunk of the scans (0: passes over the row); SLOTS: the
// sort's keys a lane (0: the sort in the row)
template <int CH, int SLOTS>
__device__ __forceinline__ void sample_ray_any(const AnyRows& rows, int lane, int Ne, int Ns,
                                           int Nextra, float near, float far,
                                           const int64_t* __restrict__ perm,
                                           float u_step, int64_t eik,
                                           float* __restrict__ z_out_row,
                                           float* __restrict__ z_eik_out) {
  const int St = Ns + 2 + Nextra;
  if constexpr (CH > 0) cdf_in_registers<CH>(rows, lane, Ne);
  else cdf_in_row(rows, lane, Ne);
  __syncwarp();
  // 5. inverse CDF at u = linspace(0, 1, Ns): the first cdf entry > u (the
  // last u is 1 where Ns > 1; linspace(0, 1, 1) is 0)
  for (int s = lane; s < Ns; s += 32) {
    const float u = (s == Ns - 1 && s > 0) ? 1.0f : (float)s * u_step;
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
    rows.merged[Ns + k] = k == 0 ? near : (k == 1 ? far : rows.z[ldg64(perm + k - 2)]);
  __syncwarp();
  if constexpr (SLOTS > 0) {
    unsigned v[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = lane * SLOTS + s;
      v[s] = e < St ? sort_key(rows.merged[e]) : kPadKey;
    }
    warp_bitonic_sort_n<SLOTS>(v, lane);
    __syncwarp();  // every lane has read its slots before the row is rewritten
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = lane * SLOTS + s;
      if (e < St) rows.merged[e] = key_value(v[s]);
    }
  } else {
    unsigned* keys = reinterpret_cast<unsigned*>(rows.merged);
    const int P = next_pow2(St);
    for (int e = lane; e < P; e += 32) keys[e] = e < St ? sort_key(rows.merged[e]) : kPadKey;
    __syncwarp();
    row_bitonic_sort(keys, P, lane);
    for (int e = lane; e < St; e += 32) rows.merged[e] = key_value(keys[e]);
  }
  __syncwarp();
  // 7. the sorted row out, coalesced; the eikonal anchor from it
  for (int i = lane; i < St; i += 32) z_out_row[i] = rows.merged[i];
  if (lane == 0) *z_eik_out = rows.merged[eik];
}

struct CachedArgs {
  const float* __restrict__ rays_o;
  const float* __restrict__ rays_d;
  const float* __restrict__ cache;
  const float* __restrict__ t_rand;
  const int64_t* __restrict__ perm;
  const int64_t* __restrict__ eik_idx;
  float* __restrict__ z_out;
  float* __restrict__ z_eik;
  int64_t R;
  int res, Ne, Ns, Nextra;
  float bound, near, far_max, t_step, u_step;
};

struct GivenArgs {
  const float* __restrict__ z;
  const float* __restrict__ near;
  const float* __restrict__ far;
  const float* __restrict__ density;
  const int64_t* __restrict__ perm;
  const int64_t* __restrict__ eik_idx;
  float* __restrict__ z_out;
  float* __restrict__ z_eik;
  int64_t R, chunk;
  int Ne, Ns, Nextra;
  float u_step;
};

// the cached prepass of ray r: far from the cube intersection (near is the
// configured constant), stratified z, the cache read, then steps 3-7
template <int CH, int SLOTS>
__device__ __forceinline__ void cached_ray(const CachedArgs& a, int64_t r, const AnyRows& rows,
                                           int lane) {
  const int Ne = a.Ne;
  const float o[3] = {__ldg(a.rays_o + r * 3), __ldg(a.rays_o + r * 3 + 1),
                      __ldg(a.rays_o + r * 3 + 2)};
  const float d[3] = {__ldg(a.rays_d + r * 3), __ldg(a.rays_d + r * 3 + 1),
                      __ldg(a.rays_d + r * 3 + 2)};
  float nc = -INFINITY, fc = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = (-a.bound - o[k]) / (d[k] + 1e-15f);
    float t1 = (a.bound - o[k]) / (d[k] + 1e-15f);
    nc = fmaxf(nc, fminf(t0, t1));
    fc = fminf(fc, fmaxf(t0, t1));
  }
  float far = (fc < nc) ? 1e9f : fc;
  far = fminf(far, a.far_max);
  const float near = a.near;

  // 1. stratified z
  for (int i = lane; i < Ne; i += 32) {
    float zi = linspace_z_any(i, Ne, near, far, a.t_step);
    if (a.t_rand != nullptr) {
      float upper = (i < Ne - 1) ? 0.5f * (zi + linspace_z_any(i + 1, Ne, near, far, a.t_step)) : zi;
      float lower = (i > 0) ? 0.5f * (linspace_z_any(i - 1, Ne, near, far, a.t_step) + zi) : zi;
      zi = __fadd_rn(lower, __fmul_rn(upper - lower, __ldg(a.t_rand + r * Ne + i)));
    }
    rows.z[i] = zi;
  }
  __syncwarp();
  // 2. cache read -> free energy
#pragma unroll 4
  for (int i = lane; i < Ne; i += 32) {
    const float z = rows.z[i];
    const float sg = cache_read(a.cache, a.res, __fadd_rn(o[0], __fmul_rn(z, d[0])),
                                __fadd_rn(o[1], __fmul_rn(z, d[1])),
                                __fadd_rn(o[2], __fmul_rn(z, d[2])));
    const float dist = (i < Ne - 1) ? (rows.z[i + 1] - z) : 1e10f;
    rows.c[i] = dist * sg;
  }
  __syncwarp();
  sample_ray_any<CH, SLOTS>(rows, lane, Ne, a.Ns, a.Nextra, near, far, a.perm, a.u_step,
                        ldg64(a.eik_idx + r), a.z_out + r * (a.Ns + 2 + a.Nextra), a.z_eik + r);
}

// Given-density mode (the exact prepass): z [R, Ne], near and far [R, 1]
// and the densities the SDF network gave at those z come in; ray r takes
// its extras from perm row r / chunk.
template <int CH, int SLOTS>
__device__ __forceinline__ void given_ray(const GivenArgs& a, int64_t r, const AnyRows& rows,
                                          int lane) {
  const int Ne = a.Ne;
  for (int i = lane; i < Ne; i += 32) rows.z[i] = __ldg(a.z + r * Ne + i);
  __syncwarp();
  for (int i = lane; i < Ne; i += 32) {
    const float dist = (i < Ne - 1) ? (rows.z[i + 1] - rows.z[i]) : 1e10f;
    rows.c[i] = dist * __ldg(a.density + r * Ne + i);
  }
  __syncwarp();
  sample_ray_any<CH, SLOTS>(rows, lane, Ne, a.Ns, a.Nextra, __ldg(a.near + r), __ldg(a.far + r),
                        a.perm + (r / a.chunk) * a.Nextra, a.u_step, ldg64(a.eik_idx + r),
                        a.z_out + r * (a.Ns + 2 + a.Nextra), a.z_eik + r);
}

// One warp a ray with its rows in shared memory (rows_g null; the block's
// warps from blockDim), or, CH = 0 only, n_rows warps each with a row of
// the global scratch rows_g, walking rays n_rows apart. The block never
// synchronises: a warp past the last ray returns.
template <int CH, int SLOTS, bool kGiven, typename A>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    sampler_kernel(const A a, float* __restrict__ rows_g, int64_t n_rows) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t rf = any_row_floats(a.Ne, a.Ns + 2 + a.Nextra);
  auto run = [&](int64_t r, const AnyRows& rows) {
    if constexpr (kGiven) given_ray<CH, SLOTS>(a, r, rows, lane);
    else cached_ray<CH, SLOTS>(a, r, rows, lane);
  };
  if constexpr (CH == 0) {
    if (rows_g != nullptr) {
      const int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
      if (g >= n_rows) return;
      const AnyRows rows = any_rows(rows_g + g * rf, a.Ne);
      for (int64_t r = g; r < a.R; r += n_rows) {
        run(r, rows);
        __syncwarp();  // the row is free for the next ray
      }
      return;
    }
  }
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= a.R) return;  // uniform per warp
  run(r, any_rows(smem + warp * rf, a.Ne));
}

// Launch sampler_kernel for Ne prepass and St sorted samples: the chunk in
// registers up to 1024 prepass samples, else in passes over the row, and
// the sort for St, with 4, 2 or 1 warps a block as the rows fit the
// block's shared memory (rows_g null), or the rows in rows_g ([n_rows,
// any_row_floats]). Invalid shapes are refused before any launch.
template <bool kGiven, typename A>
int launch_any(const A& a, float* rows_g, int64_t n_rows, cudaStream_t s) {
  if (a.R == 0) return 0;
  const int Ne = a.Ne, St = a.Ns + 2 + a.Nextra;
  if (Ne < 1 || a.Ns < 0 || a.Nextra < 0 || (rows_g != nullptr && n_rows < 1))
    return (int)cudaErrorInvalidValue;
  const int64_t rf = any_row_floats(Ne, St);
  int warps = kWarpsPerBlock;
  dim3 grid;
  size_t smem = 0;
  if (rows_g == nullptr) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    while (warps > 0 && (int64_t)warps * rf * 4 > optin) warps >>= 1;
    if (warps == 0) return (int)cudaErrorInvalidValue;  // nsl_importance_sample*_global
    smem = sizeof(float) * (size_t)warps * rf;
    grid = dim3((unsigned)((a.R + warps - 1) / warps));
  } else {
    grid = dim3((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  }
  const dim3 block(32 * warps);
  cudaError_t e = cudaSuccess;
  auto go = [&](auto ch, auto slots) {
    auto kern = sampler_kernel<decltype(ch)::value, decltype(slots)::value, kGiven, A>;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) kern<<<grid, block, smem, s>>>(a, rows_g, n_rows);
  };
  const int n = (Ne + 31) / 32, slots = sort_slots(St);
  if (rows_g != nullptr || n > kMaxChunk) {
    if (slots == 4) go(IC<0>{}, IC<4>{});
    else if (slots == 8) go(IC<0>{}, IC<8>{});
    else if (slots == 16) go(IC<0>{}, IC<16>{});
    else go(IC<0>{}, IC<0>{});
  } else {
    if (slots == 4) go(IC<kMaxChunk>{}, IC<4>{});
    else if (slots == 8) go(IC<kMaxChunk>{}, IC<8>{});
    else if (slots == 16) go(IC<kMaxChunk>{}, IC<16>{});
    else go(IC<kMaxChunk>{}, IC<0>{});
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// floats of one ray's rows in the global scratch that
// nsl_importance_sample*_global take, or 0 where 4, 2 or 1 warps' rows fit
// a block's shared memory (nsl_importance_sample* then take the shape);
// -1 for an invalid shape
int64_t nsl_importance_sample_rows(int Ne, int Ns, int Nextra) {
  if (Ne < 1 || Ns < 0 || Nextra < 0) return -1;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  const int64_t rf = any_row_floats(Ne, Ns + 2 + Nextra);
  return rf * 4 <= optin ? 0 : rf;
}

// warps that share the scratch rows on this card for R rays: at most
// kRowsWarpsPerSm an SM
int64_t nsl_importance_sample_row_warps(int64_t R) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int64_t most = (int64_t)sms * kRowsWarpsPerSm;
  return R < most ? R : most;
}

int nsl_importance_sample(const void* rays_o, const void* rays_d,
                          const void* cache, const void* t_rand,
                          const void* perm, const void* eik_idx, void* z_out,
                          void* z_eik, int64_t R, int res, int Ne, int Ns,
                          int Nextra, float bound, float near, float far_max,
                          float t_step, float u_step, void* stream) {
  if (!shipped_shape(Ne, Ns, Nextra)) {
    const CachedArgs a{(const float*)rays_o, (const float*)rays_d, (const float*)cache,
                       (const float*)t_rand, (const int64_t*)perm, (const int64_t*)eik_idx,
                       (float*)z_out, (float*)z_eik, R, res, Ne, Ns, Nextra, bound, near,
                       far_max, t_step, u_step};
    return launch_any<false>(a, nullptr, 0, (cudaStream_t)stream);
  }
  return launch_shipped(R, Ne, Ns, Nextra, (cudaStream_t)stream,
                        [&](auto ch, dim3 grid, dim3 block, size_t smem, cudaStream_t s) {
                          importance_sample_kernel<decltype(ch)::value><<<grid, block, smem, s>>>(
                              (const float*)rays_o, (const float*)rays_d, (const float*)cache,
                              (const float*)t_rand, (const int64_t*)perm,
                              (const int64_t*)eik_idx, (float*)z_out, (float*)z_eik, R, res,
                              Ne, Ns, Nextra, bound, near, far_max, t_step, u_step);
                        });
}

// the same with the rows in rows [n_rows, nsl_importance_sample_rows floats]
int nsl_importance_sample_global(const void* rays_o, const void* rays_d,
                                 const void* cache, const void* t_rand,
                                 const void* perm, const void* eik_idx, void* z_out,
                                 void* z_eik, int64_t R, int res, int Ne, int Ns,
                                 int Nextra, float bound, float near, float far_max,
                                 float t_step, float u_step, void* rows, int64_t n_rows,
                                 void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  const CachedArgs a{(const float*)rays_o, (const float*)rays_d, (const float*)cache,
                     (const float*)t_rand, (const int64_t*)perm, (const int64_t*)eik_idx,
                     (float*)z_out, (float*)z_eik, R, res, Ne, Ns, Nextra, bound, near,
                     far_max, t_step, u_step};
  return launch_any<false>(a, (float*)rows, n_rows, (cudaStream_t)stream);
}

int nsl_importance_sample_given(const void* z, const void* near, const void* far,
                                const void* density, const void* perm,
                                const void* eik_idx, void* z_out, void* z_eik,
                                int64_t R, int64_t chunk, int Ne, int Ns, int Nextra,
                                float u_step, void* stream) {
  if (R > 0 && (chunk < 1 || R % chunk != 0)) return (int)cudaErrorInvalidValue;
  if (!shipped_shape(Ne, Ns, Nextra)) {
    const GivenArgs a{(const float*)z, (const float*)near, (const float*)far,
                      (const float*)density, (const int64_t*)perm, (const int64_t*)eik_idx,
                      (float*)z_out, (float*)z_eik, R, chunk, Ne, Ns, Nextra, u_step};
    return launch_any<true>(a, nullptr, 0, (cudaStream_t)stream);
  }
  return launch_shipped(R, Ne, Ns, Nextra, (cudaStream_t)stream,
                        [&](auto ch, dim3 grid, dim3 block, size_t smem, cudaStream_t s) {
                          importance_sample_given_kernel<decltype(ch)::value>
                              <<<grid, block, smem, s>>>(
                                  (const float*)z, (const float*)near, (const float*)far,
                                  (const float*)density, (const int64_t*)perm,
                                  (const int64_t*)eik_idx, (float*)z_out, (float*)z_eik, R,
                                  chunk, Ne, Ns, Nextra, u_step);
                        });
}

int nsl_importance_sample_given_global(const void* z, const void* near, const void* far,
                                       const void* density, const void* perm,
                                       const void* eik_idx, void* z_out, void* z_eik,
                                       int64_t R, int64_t chunk, int Ne, int Ns, int Nextra,
                                       float u_step, void* rows, int64_t n_rows,
                                       void* stream) {
  if (rows == nullptr || (R > 0 && (chunk < 1 || R % chunk != 0)))
    return (int)cudaErrorInvalidValue;
  const GivenArgs a{(const float*)z, (const float*)near, (const float*)far,
                    (const float*)density, (const int64_t*)perm, (const int64_t*)eik_idx,
                    (float*)z_out, (float*)z_eik, R, chunk, Ne, Ns, Nextra, u_step};
  return launch_any<true>(a, (float*)rows, n_rows, (cudaStream_t)stream);
}

}  // extern "C"
