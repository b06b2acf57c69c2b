// Per-ray volume-rendering composite for Hopper (sm_90a): K4.
//
// Replaces nicer_slam_tpu/ops/volume_rendering.py render_weights (:15-26)
// and the per-ray composites of nicer_slam_tpu/models/scene_model.py
// render_rays (:353-357 rgb and depth, :489-494 normal map):
//   e_i = dist_i sigma_i (last dist 1e10), T_i = exp(-sum_{j<i} e_j),
//   w_i = (1 - exp(-e_i)) T_i,
//   rgb = sum w rgb_i, depth = sum w z / (sum w + 1e-8), normal = sum w n_i.
// Backward (z carries no gradient), with g_w_i the total cotangent on w_i:
//   dL/de_k = g_w_k T_k exp(-e_k) - sum_{i>k} g_w_i w_i,
//   dL/dsigma_k = dist_k dL/de_k.
//
// What bounds it on the card: it streams z, sigma, rgb and normals once
// (8 floats per sample, 3.2 MB per 1024 x 98 rays) — memory bound, and
// small next to the field evaluation. The design gives one warp to a ray:
// each lane owns a contiguous chunk of ceil(S/32) samples, the exclusive
// prefix sum of the free energy (and the backward's suffix sum) is a warp
// shuffle scan over the lanes' chunk sums, and every per-ray sum is a
// shuffle reduction — no shared memory, no atomics, deterministic. The
// [R, S] weights and the four composites come out of one pass instead of
// the eight elementwise/cumsum/reduction passes of the plain version.
//
// The colour top-k path (scene_model.py:323-353, training with
// 0 < color_topk < S) splits the composite in two: weights_topk_kernel
// writes the weights, the depth and normal composites and the indices of
// the Kc largest weights of each ray (a warp arg-max per pick, ties to the
// lower index as lax.top_k), and the colour network runs only at the kept
// samples; topk_rgb_*_kernel composites their colours with the kept
// weights renormalised to the ray's whole weight, forward and backward.
// The weights pass's backward is composite_bwd_kernel without colour: the
// gradients on the kept weights and on their sum arrive in g_weights.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp.cuh"

namespace {

using nsl::kFull;
using nsl::warp_excl_prefix;
using nsl::warp_excl_suffix;
using nsl::warp_sum;

constexpr int kWarpsPerBlock = 4;

// g_rgb . rgb_s (0 without colour: the weights pass of the top-k path)
__device__ __forceinline__ float rgb_dot(const float* cr, int s, float gr,
                                         float gg, float gb) {
  if (cr == nullptr) return 0.0f;
  return gr * cr[3 * s] + gg * cr[3 * s + 1] + gb * cr[3 * s + 2];
}

__device__ __forceinline__ float free_energy(const float* z, const float* sg,
                                             int s, int S) {
  float dist = (s < S - 1) ? (z[s + 1] - z[s]) : 1e10f;
  return dist * sg[s];
}

__global__ void composite_fwd_kernel(const float* __restrict__ z,
                                     const float* __restrict__ sigma,
                                     const float* __restrict__ rgb,
                                     const float* __restrict__ nrm,
                                     float* __restrict__ weights,
                                     float* __restrict__ rgb_out,
                                     float* __restrict__ depth_out,
                                     float* __restrict__ normal_out,
                                     int64_t R, int S) {
  int64_t ray = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (ray >= R) return;  // uniform per warp
  const float* zr = z + ray * S;
  const float* sr = sigma + ray * S;
  const float* cr = rgb + ray * S * 3;
  const float* nr = nrm + ray * S * 3;
  int chunk = (S + 31) / 32;
  int s0 = min(S, lane * chunk), s1 = min(S, s0 + chunk);

  float loc = 0.0f;
  for (int s = s0; s < s1; ++s) loc += free_energy(zr, sr, s, S);
  float run = warp_excl_prefix(loc, lane);

  float a_r = 0.f, a_g = 0.f, a_b = 0.f, a_nx = 0.f, a_ny = 0.f, a_nz = 0.f;
  float a_w = 0.f, a_wz = 0.f;
  for (int s = s0; s < s1; ++s) {
    float e = free_energy(zr, sr, s, S);
    float w = (1.0f - expf(-e)) * expf(-run);
    run += e;
    weights[ray * S + s] = w;
    a_r += w * cr[3 * s];
    a_g += w * cr[3 * s + 1];
    a_b += w * cr[3 * s + 2];
    a_nx += w * nr[3 * s];
    a_ny += w * nr[3 * s + 1];
    a_nz += w * nr[3 * s + 2];
    a_w += w;
    a_wz += w * zr[s];
  }
  a_r = warp_sum(a_r); a_g = warp_sum(a_g); a_b = warp_sum(a_b);
  a_nx = warp_sum(a_nx); a_ny = warp_sum(a_ny); a_nz = warp_sum(a_nz);
  a_w = warp_sum(a_w); a_wz = warp_sum(a_wz);
  if (lane == 0) {
    rgb_out[ray * 3] = a_r;
    rgb_out[ray * 3 + 1] = a_g;
    rgb_out[ray * 3 + 2] = a_b;
    normal_out[ray * 3] = a_nx;
    normal_out[ray * 3 + 1] = a_ny;
    normal_out[ray * 3 + 2] = a_nz;
    depth_out[ray] = a_wz / (a_w + 1e-8f);
  }
}

__global__ void composite_bwd_kernel(
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ rgb, const float* __restrict__ nrm,
    const float* __restrict__ g_weights, const float* __restrict__ g_rgb_out,
    const float* __restrict__ g_depth, const float* __restrict__ g_normal_out,
    float* __restrict__ g_sigma, float* __restrict__ g_rgb,
    float* __restrict__ g_nrm, int64_t R, int S) {
  int64_t ray = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (ray >= R) return;
  const float* zr = z + ray * S;
  const float* sr = sigma + ray * S;
  const float* cr = rgb == nullptr ? nullptr : rgb + ray * S * 3;
  const float* nr = nrm + ray * S * 3;
  int chunk = (S + 31) / 32;
  int s0 = min(S, lane * chunk), s1 = min(S, s0 + chunk);

  // forward recompute: prefix of the free energy, sum w and sum w z
  float loc = 0.0f;
  for (int s = s0; s < s1; ++s) loc += free_energy(zr, sr, s, S);
  const float run0 = warp_excl_prefix(loc, lane);
  float run = run0, a_w = 0.f, a_wz = 0.f;
  for (int s = s0; s < s1; ++s) {
    float e = free_energy(zr, sr, s, S);
    float w = (1.0f - expf(-e)) * expf(-run);
    run += e;
    a_w += w;
    a_wz += w * zr[s];
  }
  a_w = warp_sum(a_w);
  a_wz = warp_sum(a_wz);
  const float inv = 1.0f / (a_w + 1e-8f);
  const float depth = a_wz * inv;
  const float gr = cr == nullptr ? 0.0f : g_rgb_out[ray * 3],
              gg = cr == nullptr ? 0.0f : g_rgb_out[ray * 3 + 1],
              gb = cr == nullptr ? 0.0f : g_rgb_out[ray * 3 + 2];
  const float gnx = g_normal_out[ray * 3], gny = g_normal_out[ray * 3 + 1],
              gnz = g_normal_out[ray * 3 + 2];
  const float gd = g_depth[ray];

  // total cotangent on each w_i, and the lanes' sums of g_w w
  float lt = 0.0f;
  run = run0;
  for (int s = s0; s < s1; ++s) {
    float e = free_energy(zr, sr, s, S);
    float w = (1.0f - expf(-e)) * expf(-run);
    run += e;
    float gw = rgb_dot(cr, s, gr, gg, gb) + gnx * nr[3 * s] +
               gny * nr[3 * s + 1] + gnz * nr[3 * s + 2] +
               gd * (zr[s] - depth) * inv;
    if (g_weights != nullptr) gw += g_weights[ray * S + s];
    lt += gw * w;
  }
  // tail = sum_{i > s} g_w_i w_i, accumulated walking the lane's chunk
  // backwards (a forward walk would subtract, and the last sample's
  // cancellation residue would be multiplied by its 1e10 distance)
  float tail = warp_excl_suffix(lt, lane);
  for (int s = s1 - 1; s >= s0; --s) {
    float run_s = run0;  // prefix at s, recomputed: chunks are short
    for (int j = s0; j < s; ++j) run_s += free_energy(zr, sr, j, S);
    float e = free_energy(zr, sr, s, S);
    float T = expf(-run_s);
    float ex = expf(-e);
    float w = (1.0f - ex) * T;
    float gw = rgb_dot(cr, s, gr, gg, gb) + gnx * nr[3 * s] +
               gny * nr[3 * s + 1] + gnz * nr[3 * s + 2] +
               gd * (zr[s] - depth) * inv;
    if (g_weights != nullptr) gw += g_weights[ray * S + s];
    float ge = gw * T * ex - tail;
    tail += gw * w;
    float dist = (s < S - 1) ? (zr[s + 1] - zr[s]) : 1e10f;
    g_sigma[ray * S + s] = ge * dist;
    if (cr != nullptr) {
      g_rgb[(ray * S + s) * 3] = gr * w;
      g_rgb[(ray * S + s) * 3 + 1] = gg * w;
      g_rgb[(ray * S + s) * 3 + 2] = gb * w;
    }
    g_nrm[(ray * S + s) * 3] = gnx * w;
    g_nrm[(ray * S + s) * 3 + 1] = gny * w;
    g_nrm[(ray * S + s) * 3 + 2] = gnz * w;
  }
}

// The weights pass of the colour top-k path: weights, depth and normal
// composites as composite_fwd_kernel computes them (no colour), then the
// Kc largest weights of the ray, largest first, ties to the lower index
// (lax.top_k's order). Kc rounds of a warp arg-max: each lane offers the
// best sample of its chunk not taken yet.
__global__ void weights_topk_kernel(const float* __restrict__ z,
                                    const float* __restrict__ sigma,
                                    const float* __restrict__ nrm,
                                    float* __restrict__ weights,
                                    float* __restrict__ depth_out,
                                    float* __restrict__ normal_out,
                                    int64_t* __restrict__ topk_idx, int64_t R,
                                    int S, int Kc) {
  int64_t ray = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (ray >= R) return;
  const float* zr = z + ray * S;
  const float* sr = sigma + ray * S;
  const float* nr = nrm + ray * S * 3;
  float* wr = weights + ray * S;
  int chunk = (S + 31) / 32;
  int s0 = min(S, lane * chunk), s1 = min(S, s0 + chunk);

  float loc = 0.0f;
  for (int s = s0; s < s1; ++s) loc += free_energy(zr, sr, s, S);
  float run = warp_excl_prefix(loc, lane);
  float a_nx = 0.f, a_ny = 0.f, a_nz = 0.f, a_w = 0.f, a_wz = 0.f;
  for (int s = s0; s < s1; ++s) {
    float e = free_energy(zr, sr, s, S);
    float w = (1.0f - expf(-e)) * expf(-run);
    run += e;
    wr[s] = w;
    a_nx += w * nr[3 * s];
    a_ny += w * nr[3 * s + 1];
    a_nz += w * nr[3 * s + 2];
    a_w += w;
    a_wz += w * zr[s];
  }
  a_nx = warp_sum(a_nx); a_ny = warp_sum(a_ny); a_nz = warp_sum(a_nz);
  a_w = warp_sum(a_w); a_wz = warp_sum(a_wz);
  if (lane == 0) {
    normal_out[ray * 3] = a_nx;
    normal_out[ray * 3 + 1] = a_ny;
    normal_out[ray * 3 + 2] = a_nz;
    depth_out[ray] = a_wz / (a_w + 1e-8f);
  }

  // the lane re-reads its own stores: S <= 1024, so a chunk is <= 32
  // samples and `taken` fits a 32-bit mask
  uint32_t taken = 0u;
  for (int k = 0; k < Kc; ++k) {
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int s = s0; s < s1; ++s) {
      if ((taken >> (s - s0)) & 1u) continue;
      float w = wr[s];
      if (w > best || bi == INT_MAX) { best = w; bi = s; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float ob = __shfl_xor_sync(kFull, best, o);
      int oi = __shfl_xor_sync(kFull, bi, o);
      if (oi != INT_MAX && (bi == INT_MAX || ob > best || (ob == best && oi < bi))) {
        best = ob;
        bi = oi;
      }
    }
    if (bi >= s0 && bi < s1) taken |= 1u << (bi - s0);
    if (lane == 0) topk_idx[ray * Kc + k] = bi;
  }
}

// rgb = sum_k w_k r rgb_k with r = W / (sum_k w_k + 1e-8): the kept
// samples' colours, their weights renormalised to the ray's whole mass W
// (scene_model.py:338-353). One thread per ray; Kc is small.
__global__ void topk_rgb_fwd_kernel(const float* __restrict__ topk_w,
                                    const float* __restrict__ wsum,
                                    const float* __restrict__ rgb,
                                    float* __restrict__ out, int64_t R,
                                    int Kc) {
  int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= R) return;
  const float* w = topk_w + ray * Kc;
  const float* c = rgb + ray * Kc * 3;
  float s = 0.0f;
  for (int k = 0; k < Kc; ++k) s += w[k];
  float r = wsum[ray] / (s + 1e-8f);
  float o0 = 0.f, o1 = 0.f, o2 = 0.f;
  for (int k = 0; k < Kc; ++k) {
    float wc = w[k] * r;
    o0 += wc * c[3 * k];
    o1 += wc * c[3 * k + 1];
    o2 += wc * c[3 * k + 2];
  }
  out[ray * 3] = o0;
  out[ray * 3 + 1] = o1;
  out[ray * 3 + 2] = o2;
}

// with a_k = g . rgb_k and A = sum_k w_k a_k:
//   d/drgb_k = g w_k r,  d/dw_k = r a_k - A r / (s + 1e-8),  d/dW = A / (s + 1e-8)
__global__ void topk_rgb_bwd_kernel(const float* __restrict__ topk_w,
                                    const float* __restrict__ wsum,
                                    const float* __restrict__ rgb,
                                    const float* __restrict__ g_out,
                                    float* __restrict__ g_topk_w,
                                    float* __restrict__ g_wsum,
                                    float* __restrict__ g_rgb, int64_t R,
                                    int Kc) {
  int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= R) return;
  const float* w = topk_w + ray * Kc;
  const float* c = rgb + ray * Kc * 3;
  const float g0 = g_out[ray * 3], g1 = g_out[ray * 3 + 1], g2 = g_out[ray * 3 + 2];
  float s = 0.0f;
  for (int k = 0; k < Kc; ++k) s += w[k];
  const float inv = 1.0f / (s + 1e-8f);
  const float r = wsum[ray] * inv;
  float A = 0.0f;
  for (int k = 0; k < Kc; ++k)
    A += w[k] * (g0 * c[3 * k] + g1 * c[3 * k + 1] + g2 * c[3 * k + 2]);
  for (int k = 0; k < Kc; ++k) {
    float a = g0 * c[3 * k] + g1 * c[3 * k + 1] + g2 * c[3 * k + 2];
    g_topk_w[ray * Kc + k] = r * a - A * r * inv;
    float wr = w[k] * r;
    g_rgb[(ray * Kc + k) * 3] = g0 * wr;
    g_rgb[(ray * Kc + k) * 3 + 1] = g1 * wr;
    g_rgb[(ray * Kc + k) * 3 + 2] = g2 * wr;
  }
  g_wsum[ray] = A * inv;
}

constexpr int kRayThreads = 128;

inline unsigned blocks_for(int64_t R) {
  return (unsigned)((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

inline unsigned ray_blocks_for(int64_t R) {
  return (unsigned)((R + kRayThreads - 1) / kRayThreads);
}

}  // namespace

extern "C" {

int nsl_composite_fwd(const void* z, const void* sigma, const void* rgb,
                      const void* nrm, void* weights, void* rgb_out,
                      void* depth_out, void* normal_out, int64_t R, int S,
                      void* stream) {
  if (R == 0) return 0;
  composite_fwd_kernel<<<blocks_for(R), 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)rgb,
      (const float*)nrm, (float*)weights, (float*)rgb_out, (float*)depth_out,
      (float*)normal_out, R, S);
  return (int)cudaGetLastError();
}

int nsl_composite_bwd(const void* z, const void* sigma, const void* rgb,
                      const void* nrm, const void* g_weights,
                      const void* g_rgb_out, const void* g_depth,
                      const void* g_normal_out, void* g_sigma, void* g_rgb,
                      void* g_nrm, int64_t R, int S, void* stream) {
  if (R == 0) return 0;
  composite_bwd_kernel<<<blocks_for(R), 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)rgb,
      (const float*)nrm, (const float*)g_weights, (const float*)g_rgb_out,
      (const float*)g_depth, (const float*)g_normal_out, (float*)g_sigma,
      (float*)g_rgb, (float*)g_nrm, R, S);
  return (int)cudaGetLastError();
}

int nsl_weights_topk_fwd(const void* z, const void* sigma, const void* nrm,
                         void* weights, void* depth_out, void* normal_out,
                         void* topk_idx, int64_t R, int S, int Kc,
                         void* stream) {
  if (R == 0) return 0;
  if (S > 32 * 32 || Kc < 1 || Kc > S) return (int)cudaErrorInvalidValue;
  weights_topk_kernel<<<blocks_for(R), 32 * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)nrm, (float*)weights,
      (float*)depth_out, (float*)normal_out, (int64_t*)topk_idx, R, S, Kc);
  return (int)cudaGetLastError();
}

int nsl_topk_rgb_fwd(const void* topk_w, const void* wsum, const void* rgb,
                     void* out, int64_t R, int Kc, void* stream) {
  if (R == 0) return 0;
  topk_rgb_fwd_kernel<<<ray_blocks_for(R), kRayThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)topk_w, (const float*)wsum, (const float*)rgb,
      (float*)out, R, Kc);
  return (int)cudaGetLastError();
}

int nsl_topk_rgb_bwd(const void* topk_w, const void* wsum, const void* rgb,
                     const void* g_out, void* g_topk_w, void* g_wsum,
                     void* g_rgb, int64_t R, int Kc, void* stream) {
  if (R == 0) return 0;
  topk_rgb_bwd_kernel<<<ray_blocks_for(R), kRayThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)topk_w, (const float*)wsum, (const float*)rgb,
      (const float*)g_out, (float*)g_topk_w, (float*)g_wsum, (float*)g_rgb, R,
      Kc);
  return (int)cudaGetLastError();
}

}  // extern "C"
