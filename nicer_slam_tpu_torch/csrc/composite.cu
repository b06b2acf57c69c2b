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
// small next to the field evaluation; the top-k pick makes the weights
// pass instruction-bound at 8192 rays and a warp's dependent chain at
// 1024, and the top-k colour composite sits near the launch floor. Every
// kernel uses no atomics (deterministic).
//
// Every per-ray kernel (the plain composite's forward, the weights pass of
// the colour top-k path, scene_model.py:323-353, training with 0 <
// color_topk < S, and the backward of both paths) keeps a ray's samples
// interleaved over the lanes: lane l holds samples l + 32 j for j < NR
// rounds (NR = 4 covers S <= 128, the paths' 98 samples; the plain
// composite's forward takes NR = 8 and 16 up to 512, the others NR = 32 up
// to 1024), so z and sigma arrive as coalesced 128-byte rows and e, T and
// w stay in registers for the whole kernel. The
// transmittance is an inclusive warp scan per round plus the earlier
// rounds' carry; a ray's 3 S normal (and colour) floats are read and
// written as coalesced rows too, each float meeting its sample's weight by
// a shuffle. weights_topk_kernel writes the weights, the depth and normal
// composites, the weight sum, and the Kc largest weights of the ray with
// their flat indices ray S + i, largest first, ties to the lower index
// (lax.top_k's values and order), so the caller needs no gather, sum or
// index arithmetic. The pick is a radix select over the weights' bit
// patterns with warp ballots: weights are (1 - exp(-e)) T with e >= 0,
// never negative nor -0.0, so their bits order as the floats do,
// subnormals included (the build keeps them: no fast-math flags in
// ops/_cuda.py); ties go to the lower index by a 64-bit key (~weight
// bits, index). A ray with at most Kc non-zero weights takes them all and
// its first zeros, with no walk over the bits; otherwise the walk stops as
// soon as exactly Kc weights lie at or above the prefix. A warp bitonic
// sort of the keys gave the same picks and was as fast at 1024 rays and
// slower at 8192 and on surface-like rays, where the pass is bound by its
// instruction rate and the sort network runs more instructions (PERF.md).
//
// Any S >= 1 and 0 < Kc <= S run (lax.top_k's own rule): longer rays run
// in tiles with the transmittance carried across them (the tiled kernels
// below); the shipped shapes take the kernels above.
//
// composite_bwd_kernel is the backward of both the plain composite (with
// colour) and the weights pass, in one pass: the cotangents on the top-k
// values are added at their picks through a per-warp shared row (picks
// are distinct, so no conflicts), and the sum_{i>k} tail is an exclusive
// suffix scan (rounds walked from the last, never a subtraction).
//
// topk_rgb_*_kernel composite the kept samples' colours with the kept
// weights renormalised to the ray's whole weight: G lanes per ray (Kc
// rounded up to a power of two, at most 32; looping over chunks of 32
// above), 32 / G rays per warp, per-ray sums by shuffles, the colour rows
// moved through shared memory as coalesced rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp.cuh"

namespace {

using nsl::kFull;
using nsl::warp_incl_prefix;
using nsl::warp_incl_suffix;
using nsl::warp_sum;

constexpr int kWarpsPerBlock = 4;

// ---------------------------------------------------------------------------
// The interleaved layout: lane l holds samples l + 32 j, j < NR
// ---------------------------------------------------------------------------

// z, dist and e = dist sigma of the warp's ray (0 past the ray's end). The
// next sample's z is the next lane's, or for lane 31 lane 0's of the next
// round; the last sample's distance is 1e10.
template <int NR>
__device__ __forceinline__ void load_ray(const float* __restrict__ zr,
                                         const float* __restrict__ sr, int S,
                                         int lane, float z[NR], float dist[NR],
                                         float e[NR]) {
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = lane + 32 * j;
    z[j] = s < S ? zr[s] : 0.0f;
    e[j] = s < S ? sr[s] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = lane + 32 * j;
    float zn = __shfl_down_sync(kFull, z[j], 1);
    if (j + 1 < NR) {
      const float wrap = __shfl_sync(kFull, z[j + 1], 0);
      if (lane == 31) zn = wrap;
    }
    dist[j] = s < S - 1 ? zn - z[j] : 1e10f;
    e[j] = s < S ? dist[j] * e[j] : 0.0f;
  }
}

// w = (1 - exp(-e)) T with T = exp(-sum_{i<s} e_i): a warp scan per round
// plus the earlier rounds' carry, the exclusive prefix taken by a shift
// (never incl - e: the last e is ~1e10 sigma)
template <int NR>
__device__ __forceinline__ void weights_of(const float e[NR], int lane,
                                           float T[NR], float ex[NR],
                                           float w[NR]) {
  float incl[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) incl[j] = warp_incl_prefix(e[j], lane);
  float carry = 0.0f;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const float excl = __shfl_up_sync(kFull, incl[j], 1);
    const float run = lane == 0 ? carry : carry + excl;
    carry += __shfl_sync(kFull, incl[j], 31);
    T[j] = expf(-run);
    ex[j] = expf(-e[j]);
    w[j] = (1.0f - ex[j]) * T[j];
  }
}

// component c of the f-th float of a round's 96 (f = lane + 32 m): (lane + 2 m) % 3
__device__ __forceinline__ float pick3(const float v[3], int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

// The plain composite's forward: the weights, then sum w rgb, sum w n and
// the depth sum w z / (sum w + 1e-8), the ray's 3 S colour and normal
// floats read as coalesced rows, each float meeting its sample's weight by
// a shuffle. Against the earlier design (each lane a contiguous chunk of
// ceil(S/32) samples, strided loads), in turns on an H100 80GB HBM3 at 700
// W (tools/hash_kernel_ab.py, PERF.md §6): 0.0101 -> 0.0092 ms at the
// demo's 4096 x 98, 0.0084 -> 0.0082 at a render chunk's 2580 x 98, and
// 0.0075 -> 0.0090 at 64 x 200 (64 warps, 8 dependent scan rounds each),
// a shape no path gives it; the launch floor is ~0.005 ms.
template <int NR>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    composite_fwd_kernel(const float* __restrict__ z,
                         const float* __restrict__ sigma,
                         const float* __restrict__ rgb,
                         const float* __restrict__ nrm,
                         float* __restrict__ weights,
                         float* __restrict__ rgb_out,
                         float* __restrict__ depth_out,
                         float* __restrict__ normal_out, int64_t R, int S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // uniform per warp
  float zz[NR], dist[NR], e[NR], T[NR], ex[NR], w[NR];
  load_ray<NR>(z + ray * S, sigma + ray * S, S, lane, zz, dist, e);
  weights_of<NR>(e, lane, T, ex, w);

  float a_w = 0.f, a_wz = 0.f, a_c[3] = {0.f, 0.f, 0.f}, a_n[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = lane + 32 * j;
    if (s < S) weights[ray * S + s] = w[j];
    a_w += w[j];
    a_wz += w[j] * zz[j];
  }
  // the f-th float of round j belongs to sample 32 j + f / 3, whose weight
  // lane f / 3 holds
  const float* cr = rgb + ray * 3 * S;
  const float* nr = nrm + ray * 3 * S;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int f = lane + 32 * m, i = 96 * j + f, c = (lane + 2 * m) % 3;
      const float wv = __shfl_sync(kFull, w[j], f / 3);
      const bool in = i < 3 * S;
      const float vc = in ? cr[i] * wv : 0.0f;
      const float vn = in ? nr[i] * wv : 0.0f;
      a_c[0] += c == 0 ? vc : 0.0f;
      a_c[1] += c == 1 ? vc : 0.0f;
      a_c[2] += c == 2 ? vc : 0.0f;
      a_n[0] += c == 0 ? vn : 0.0f;
      a_n[1] += c == 1 ? vn : 0.0f;
      a_n[2] += c == 2 ? vn : 0.0f;
    }
  }
  a_w = warp_sum(a_w);
  a_wz = warp_sum(a_wz);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a_c[c] = warp_sum(a_c[c]);
    a_n[c] = warp_sum(a_n[c]);
  }
  if (lane < 3) rgb_out[ray * 3 + lane] = pick3(a_c, lane);
  if (lane >= 3 && lane < 6) normal_out[ray * 3 + lane - 3] = pick3(a_n, lane - 3);
  if (lane == 6) depth_out[ray] = a_wz / (a_w + 1e-8f);
}

// the pick's sort key: ascending (~weight bits, index) is descending
// weight, ties to the lower index
__device__ __forceinline__ unsigned long long pick_key(float w, int s) {
  return ((unsigned long long)(~__float_as_uint(w)) << 32) | (unsigned)s;
}

__device__ __forceinline__ void write_pick(unsigned long long key, int k,
                                           float* __restrict__ topk_w,
                                           int64_t* __restrict__ picks,
                                           int64_t ray_base) {
  topk_w[k] = __uint_as_float(~(unsigned)(key >> 32));
  picks[k] = ray_base + (int64_t)(unsigned)(key & 0xffffffffu);
}

// the pick, a radix select: the Kc-th largest weight's bits tau, bit by
// bit from the top, counted with ballots; the weights above tau and
// the first ties at tau in index order go to a per-warp shared row, and
// each pick's place is the count of picks with a smaller key (keys are
// distinct)
template <int NR>
__device__ __forceinline__ void pick_radix(const float w[NR], int S, int Kc,
                                           int lane,
                                           unsigned long long* __restrict__ row,
                                           float* __restrict__ tw,
                                           int64_t* __restrict__ pk,
                                           int64_t ray_base) {
  unsigned bits[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j)
    bits[j] = lane + 32 * j < S ? __float_as_uint(w[j]) : 0u;
  // tau: the longest prefix with at least Kc weights at or above it, or 0
  // with no walk when at most Kc weights are non-zero; the walk stops once exactly Kc are (every one of them is picked), so rays
  // whose Kc-th and Kc+1-th weights part in the high bits take few rounds
  int n_nz = 0;
#pragma unroll
  for (int j = 0; j < NR; ++j) n_nz += __popc(__ballot_sync(kFull, bits[j] != 0u));
  unsigned tau = 0u;
  for (int b = n_nz > Kc ? 30 : -1; b >= 0; --b) {  // weights >= 0: sign bit 0
    const unsigned cand = tau | (1u << b);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < NR; ++j) cnt += __popc(__ballot_sync(kFull, bits[j] >= cand));
    if (cnt >= Kc) {
      tau = cand;
      if (cnt == Kc) break;  // uniform: cnt is the same on every lane
    }
  }
  int n_gt = 0;
#pragma unroll
  for (int j = 0; j < NR; ++j) n_gt += __popc(__ballot_sync(kFull, bits[j] > tau));
  const int need = Kc - n_gt;  // ties at tau, taken in index order
  const unsigned below = (1u << lane) - 1u;
  int taken = 0, eq_before = 0;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = lane + 32 * j;
    const bool eq = s < S && bits[j] == tau;
    const unsigned beq = __ballot_sync(kFull, eq);
    const bool take = bits[j] > tau || (eq && eq_before + __popc(beq & below) < need);
    const unsigned bt = __ballot_sync(kFull, take);
    if (take) row[taken + __popc(bt & below)] = pick_key(w[j], s);
    taken += __popc(bt);
    eq_before += __popc(beq);
  }
  __syncwarp();
  for (int k = lane; k < Kc; k += 32) {
    const unsigned long long key = row[k];
    int r = 0;
    for (int i = 0; i < Kc; ++i) r += row[i] < key;
    write_pick(key, r, tw, pk, ray_base);
  }
}

template <int NR>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    weights_topk_kernel(const float* __restrict__ z,
                        const float* __restrict__ sigma,
                        const float* __restrict__ nrm,
                        float* __restrict__ weights,
                        float* __restrict__ depth_out,
                        float* __restrict__ normal_out,
                        float* __restrict__ topk_w, float* __restrict__ wsum,
                        int64_t* __restrict__ picks, int64_t R, int S, int Kc) {
  __shared__ unsigned long long pick_rows[kWarpsPerBlock][32 * NR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // uniform per warp
  float zz[NR], dist[NR], e[NR], T[NR], ex[NR], w[NR];
  load_ray<NR>(z + ray * S, sigma + ray * S, S, lane, zz, dist, e);
  weights_of<NR>(e, lane, T, ex, w);

  float a_w = 0.f, a_wz = 0.f, a_n[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = lane + 32 * j;
    if (s < S) weights[ray * S + s] = w[j];
    a_w += w[j];
    a_wz += w[j] * zz[j];
  }
  // sum_s w_s n_s from the ray's 3 S normal floats as coalesced rows: the
  // f-th float of round j belongs to sample 32 j + f / 3, whose weight
  // lane f / 3 holds
  const float* nr = nrm + ray * 3 * S;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int f = lane + 32 * m, i = 96 * j + f, c = (lane + 2 * m) % 3;
      const float wv = __shfl_sync(kFull, w[j], f / 3);
      const float v = i < 3 * S ? nr[i] * wv : 0.0f;
      a_n[0] += c == 0 ? v : 0.0f;
      a_n[1] += c == 1 ? v : 0.0f;
      a_n[2] += c == 2 ? v : 0.0f;
    }
  }
  a_w = warp_sum(a_w);
  a_wz = warp_sum(a_wz);
  a_n[0] = warp_sum(a_n[0]);
  a_n[1] = warp_sum(a_n[1]);
  a_n[2] = warp_sum(a_n[2]);
  if (lane < 3) normal_out[ray * 3 + lane] = pick3(a_n, lane);
  if (lane == 3) depth_out[ray] = a_wz / (a_w + 1e-8f);
  if (lane == 4) wsum[ray] = a_w;

  pick_radix<NR>(w, S, Kc, lane, pick_rows[warp], topk_w + ray * Kc,
                 picks + ray * Kc, ray * S);
}

// The backward of the plain composite (rgb != nullptr) and of the weights
// pass (rgb == nullptr; picks, g_topk_w [R, Kc] and g_wsum [R] carry the
// cotangents on the top-k values and on the weight sum; g_weights may be
// nullptr). One pass, the ray in registers:
//   g_w_i = g_weights_i + g_wsum + sum_k [pick_k = i] g_topk_w_k
//           + g_normal . n_i + g_rgb . rgb_i + g_depth (z_i - depth) / (W + 1e-8)
template <int NR>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) composite_bwd_kernel(
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ rgb, const float* __restrict__ nrm,
    const int64_t* __restrict__ picks, const float* __restrict__ g_weights,
    const float* __restrict__ g_rgb_out, const float* __restrict__ g_depth,
    const float* __restrict__ g_normal_out, const float* __restrict__ g_topk_w,
    const float* __restrict__ g_wsum, float* __restrict__ g_sigma,
    float* __restrict__ g_rgb, float* __restrict__ g_nrm, int64_t R, int S,
    int Kc) {
  __shared__ float gw_rows[kWarpsPerBlock][32 * NR];
  __shared__ float dot_rows[kWarpsPerBlock][96];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // uniform per warp
  // every load starts here, ahead of the __syncwarp()s below (which the
  // compiler does not move loads across): the first 32 top-k picks
  // and their cotangents, and the ray's normal and colour rows
  const bool topk0 = g_topk_w != nullptr && lane < Kc;
  const int64_t pick0 = topk0 ? picks[ray * Kc + lane] - ray * S : 0;
  const float gtop0 = topk0 ? g_topk_w[ray * Kc + lane] : 0.0f;
  const float* nr = nrm + ray * 3 * S;
  const float* cr = rgb == nullptr ? nullptr : rgb + ray * 3 * S;
  float nv[NR][3], cv[NR][3];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int i = 96 * j + lane + 32 * m;
      nv[j][m] = i < 3 * S ? nr[i] : 0.0f;
      cv[j][m] = (cr != nullptr && i < 3 * S) ? cr[i] : 0.0f;
    }
  }
  float zz[NR], dist[NR], e[NR], T[NR], ex[NR], w[NR], gw[NR];
  load_ray<NR>(z + ray * S, sigma + ray * S, S, lane, zz, dist, e);
  weights_of<NR>(e, lane, T, ex, w);
  float a_w = 0.f, a_wz = 0.f;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    a_w += w[j];
    a_wz += w[j] * zz[j];
  }
  a_w = warp_sum(a_w);
  a_wz = warp_sum(a_wz);
  const float inv = 1.0f / (a_w + 1e-8f);
  const float depth = a_wz * inv;
  const float gd = g_depth[ray];
  const float gws = g_wsum == nullptr ? 0.0f : g_wsum[ray];
  float gn[3], gc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gn[c] = g_normal_out[ray * 3 + c];
    gc[c] = rgb == nullptr ? 0.0f : g_rgb_out[ray * 3 + c];
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = lane + 32 * j;
    gw[j] = s < S ? (g_weights == nullptr ? 0.0f : g_weights[ray * S + s]) + gws +
                        gd * (zz[j] - depth) * inv
                  : 0.0f;
  }
  // g_normal . n_s + g_rgb . rgb_s: the round's coalesced floats, each
  // times its component's cotangent, summed per sample through a row
  float* dots = dot_rows[warp];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int c = (lane + 2 * m) % 3;
      float v = pick3(gn, c) * nv[j][m];
      if (cr != nullptr) v += pick3(gc, c) * cv[j][m];
      dots[lane + 32 * m] = v;
    }
    __syncwarp();
    gw[j] += dots[3 * lane] + dots[3 * lane + 1] + dots[3 * lane + 2];
    __syncwarp();
  }
  // the top-k values' cotangents at their picks
  if (g_topk_w != nullptr) {
    float* row = gw_rows[warp];
#pragma unroll
    for (int j = 0; j < NR; ++j) row[lane + 32 * j] = gw[j];
    __syncwarp();
    if (topk0) row[pick0] += gtop0;
    for (int k = lane + 32; k < Kc; k += 32)
      row[picks[ray * Kc + k] - ray * S] += g_topk_w[ray * Kc + k];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NR; ++j) gw[j] = row[lane + 32 * j];
  }
  // tail = sum_{i>s} g_w_i w_i: an exclusive suffix per round (a shift of
  // the inclusive one) plus the later rounds' carry, walked from the last
  // round; a forward walk would subtract, and the last sample's
  // cancellation residue would be multiplied by its 1e10 distance
  float incl[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) incl[j] = warp_incl_suffix(gw[j] * w[j], lane);
  float carry = 0.0f;
#pragma unroll
  for (int j = NR - 1; j >= 0; --j) {
    const int s = lane + 32 * j;
    const float excl = __shfl_down_sync(kFull, incl[j], 1);
    const float tail = lane == 31 ? carry : carry + excl;
    carry += __shfl_sync(kFull, incl[j], 0);
    const float ge = gw[j] * T[j] * ex[j] - tail;
    if (s < S) g_sigma[ray * S + s] = ge * dist[j];
  }
  // g_normals (and g_rgb) = g w_s, written as the round's coalesced rows
  float* gnr = g_nrm + ray * 3 * S;
  float* gcr = rgb == nullptr ? nullptr : g_rgb + ray * 3 * S;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int f = lane + 32 * m, i = 96 * j + f, c = (lane + 2 * m) % 3;
      const float wv = __shfl_sync(kFull, w[j], f / 3);
      if (i < 3 * S) {
        gnr[i] = pick3(gn, c) * wv;
        if (gcr != nullptr) gcr[i] = pick3(gc, c) * wv;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The top-k colour composite: G lanes per ray, 32 / G rays per warp
// ---------------------------------------------------------------------------

// Kc rounded up to a power of two, at most 32
inline int group_lanes(int Kc) {
  int g = 1;
  while (g < Kc && g < 32) g <<= 1;
  return g;
}

__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The warp's slice of the [R, Kc] picks for the chunk starting at pick kb:
// for Kc <= 32 (one chunk) the warp's whole rays, which are consecutive;
// for Kc > 32 (G = 32, one ray) 32 consecutive picks. Either way the slice
// is `n` consecutive picks from `first`, and the lane's pick is the p-th.
struct Slice {
  int64_t first;
  int n, p;
  bool live;
};

__device__ __forceinline__ Slice slice_of(int64_t r0, int64_t R, int rpw, int G,
                                          int Kc, int kb, int lane) {
  const int kl = lane & (G - 1), rl = lane / G;
  const int rays = (int)min((int64_t)rpw, R - r0);
  Slice sl;
  sl.first = r0 * Kc + kb;
  sl.n = rpw > 1 ? rays * Kc : min(32, Kc - kb);
  sl.p = rl * Kc + kl;
  sl.live = rl < rays && kb + kl < Kc;
  return sl;
}

// copy n floats between device memory and the warp's shared row, coalesced
__device__ __forceinline__ void row_in(const float* __restrict__ src, int n,
                                       float* row, int lane) {
  for (int f = lane; f < n; f += 32) row[f] = src[f];
  __syncwarp();
}

__device__ __forceinline__ void row_out(float* __restrict__ dst, int n,
                                        const float* row, int lane) {
  __syncwarp();
  for (int f = lane; f < n; f += 32) dst[f] = row[f];
  __syncwarp();
}

// rgb = r sum_k w_k rgb_k with r = W / (sum_k w_k + 1e-8): the kept
// samples' colours, their weights renormalised to the ray's whole mass W
// (scene_model.py:338-353)
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    topk_rgb_fwd_kernel(const float* __restrict__ topk_w,
                        const float* __restrict__ wsum,
                        const float* __restrict__ rgb, float* __restrict__ out,
                        int64_t R, int Kc, int G) {
  __shared__ float rows[kWarpsPerBlock][96];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpw = 32 / G;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * rpw;
  if (r0 >= R) return;  // uniform per warp
  const int64_t ray = r0 + lane / G;
  float* row = rows[warp];
  // loads ahead of the row copy's __syncwarp()
  const float W = ray < R ? wsum[ray] : 0.f;
  float s = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f;
  for (int kb = 0; kb < Kc; kb += G) {
    const Slice sl = slice_of(r0, R, rpw, G, Kc, kb, lane);
    const float w = sl.live ? topk_w[sl.first + sl.p] : 0.f;
    row_in(rgb + 3 * sl.first, 3 * sl.n, row, lane);
    if (sl.live) {
      s += w;
      o0 += w * row[3 * sl.p];
      o1 += w * row[3 * sl.p + 1];
      o2 += w * row[3 * sl.p + 2];
    }
    __syncwarp();
  }
  s = group_sum(s, G);
  o0 = group_sum(o0, G);
  o1 = group_sum(o1, G);
  o2 = group_sum(o2, G);
  if ((lane & (G - 1)) == 0 && ray < R) {
    const float r = W / (s + 1e-8f);
    out[ray * 3] = r * o0;
    out[ray * 3 + 1] = r * o1;
    out[ray * 3 + 2] = r * o2;
  }
}

// with a_k = g . rgb_k and A = sum_k w_k a_k:
//   d/drgb_k = g w_k r,  d/dw_k = r a_k - A r / (s + 1e-8),  d/dW = A / (s + 1e-8)
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    topk_rgb_bwd_kernel(const float* __restrict__ topk_w,
                        const float* __restrict__ wsum,
                        const float* __restrict__ rgb,
                        const float* __restrict__ g_out,
                        float* __restrict__ g_topk_w,
                        float* __restrict__ g_wsum, float* __restrict__ g_rgb,
                        int64_t R, int Kc, int G) {
  __shared__ float rows[kWarpsPerBlock][96];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpw = 32 / G;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * rpw;
  if (r0 >= R) return;  // uniform per warp
  const int64_t ray = r0 + lane / G;
  const bool ray_live = ray < R;
  float* row = rows[warp];
  // loads ahead of the row copy's __syncwarp()
  const float g0 = ray_live ? g_out[ray * 3] : 0.f,
              g1 = ray_live ? g_out[ray * 3 + 1] : 0.f,
              g2 = ray_live ? g_out[ray * 3 + 2] : 0.f;
  const float W = ray_live ? wsum[ray] : 0.f;
  float s = 0.f, A = 0.f, w0 = 0.f;
  for (int kb = 0; kb < Kc; kb += G) {
    const Slice sl = slice_of(r0, R, rpw, G, Kc, kb, lane);
    const float w = sl.live ? topk_w[sl.first + sl.p] : 0.f;
    if (kb == 0) w0 = w;
    row_in(rgb + 3 * sl.first, 3 * sl.n, row, lane);
    if (sl.live) {
      s += w;
      A += w * (g0 * row[3 * sl.p] + g1 * row[3 * sl.p + 1] + g2 * row[3 * sl.p + 2]);
    }
    __syncwarp();
  }
  s = group_sum(s, G);
  A = group_sum(A, G);
  const float inv = 1.0f / (s + 1e-8f);
  const float r = W * inv;
  for (int kb = 0; kb < Kc; kb += G) {
    const Slice sl = slice_of(r0, R, rpw, G, Kc, kb, lane);
    // one chunk (Kc <= G): the row and w0 still hold its colours and weight
    float w = w0;
    if (Kc > G) {
      w = sl.live ? topk_w[sl.first + sl.p] : 0.f;
      row_in(rgb + 3 * sl.first, 3 * sl.n, row, lane);
    }
    if (sl.live) {
      const int p = sl.p;
      const float a = g0 * row[3 * p] + g1 * row[3 * p + 1] + g2 * row[3 * p + 2];
      g_topk_w[sl.first + p] = r * a - A * r * inv;
      const float wr = w * r;
      row[3 * p] = g0 * wr;  // the lane's own entries, read above
      row[3 * p + 1] = g1 * wr;
      row[3 * p + 2] = g2 * wr;
    }
    row_out(g_rgb + 3 * sl.first, 3 * sl.n, row, lane);
  }
  if ((lane & (G - 1)) == 0 && ray_live) g_wsum[ray] = A * inv;
}

// ---------------------------------------------------------------------------
// Rays longer than one register round set: tiles of 32 NR samples
// ---------------------------------------------------------------------------
//
// A ray of S samples past the kernels above (the composite's forward past
// 512, its backward and the weights pass past 1024) runs in tiles of 32 NR
// samples, the lanes interleaved in each tile as above: the transmittance's
// prefix is carried from tile to tile, the backward's tail sum from the
// last tile back to the first (the forward prefix of each sample kept in
// the g_sigma row it then overwrites), and the top-k pick counts over the
// tiles, reading the weights it wrote back (each lane its own samples).
// Shipped shapes never come here.

// load_ray for the tile at s0: the next sample's z past the tile's last
// lane is sample s0 + 32 NR's
template <int NR>
__device__ __forceinline__ void load_tile(const float* __restrict__ zr,
                                          const float* __restrict__ sr, int S, int s0,
                                          int lane, float z[NR], float dist[NR], float e[NR]) {
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = s0 + lane + 32 * j;
    z[j] = s < S ? zr[s] : 0.0f;
    e[j] = s < S ? sr[s] : 0.0f;
  }
  const int sn = s0 + 32 * NR;
  const float z_after = sn < S ? zr[sn] : 0.0f;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int s = s0 + lane + 32 * j;
    float zn = __shfl_down_sync(kFull, z[j], 1);
    const float wrap = j + 1 < NR ? __shfl_sync(kFull, z[j + 1], 0) : z_after;
    if (lane == 31) zn = wrap;
    dist[j] = s < S - 1 ? zn - z[j] : 1e10f;
    e[j] = s < S ? dist[j] * e[j] : 0.0f;
  }
}

// the exclusive prefix of e over the tile plus the earlier tiles' carry
// (updated to include this tile)
template <int NR>
__device__ __forceinline__ void prefix_tile(const float e[NR], int lane, float& carry,
                                            float run[NR]) {
  float incl[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) incl[j] = warp_incl_prefix(e[j], lane);
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const float excl = __shfl_up_sync(kFull, incl[j], 1);
    run[j] = lane == 0 ? carry : carry + excl;
    carry += __shfl_sync(kFull, incl[j], 31);
  }
}

// sum_s w_s v_s over the tile's 3 (32 NR) floats of v (colour or normal rows
// from row, at the tile's first float), added to acc[3]
template <int NR>
__device__ __forceinline__ void rows_dot(const float* __restrict__ row, int n3, const float w[NR],
                                         int lane, float acc[3]) {
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int f = lane + 32 * m, i = 96 * j + f, c = (lane + 2 * m) % 3;
      const float wv = __shfl_sync(kFull, w[j], f / 3);
      const float v = i < n3 ? row[i] * wv : 0.0f;
      acc[0] += c == 0 ? v : 0.0f;
      acc[1] += c == 1 ? v : 0.0f;
      acc[2] += c == 2 ? v : 0.0f;
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    composite_fwd_tiled_kernel(const float* __restrict__ z, const float* __restrict__ sigma,
                               const float* __restrict__ rgb, const float* __restrict__ nrm,
                               float* __restrict__ weights, float* __restrict__ rgb_out,
                               float* __restrict__ depth_out, float* __restrict__ normal_out,
                               int64_t R, int S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // uniform per warp
  float carry = 0.f, a_w = 0.f, a_wz = 0.f, a_c[3] = {0.f, 0.f, 0.f}, a_n[3] = {0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < S; s0 += 32 * NR) {
    float zz[NR], dist[NR], e[NR], run[NR], w[NR];
    load_tile<NR>(z + ray * S, sigma + ray * S, S, s0, lane, zz, dist, e);
    prefix_tile<NR>(e, lane, carry, run);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int s = s0 + lane + 32 * j;
      w[j] = (1.0f - expf(-e[j])) * expf(-run[j]);
      if (s < S) weights[ray * S + s] = w[j];
      a_w += w[j];
      a_wz += w[j] * zz[j];
    }
    const int n3 = 3 * (S - s0);
    rows_dot<NR>(rgb + ray * 3 * S + 3 * s0, n3, w, lane, a_c);
    rows_dot<NR>(nrm + ray * 3 * S + 3 * s0, n3, w, lane, a_n);
  }
  a_w = warp_sum(a_w);
  a_wz = warp_sum(a_wz);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a_c[c] = warp_sum(a_c[c]);
    a_n[c] = warp_sum(a_n[c]);
  }
  if (lane < 3) rgb_out[ray * 3 + lane] = pick3(a_c, lane);
  if (lane >= 3 && lane < 6) normal_out[ray * 3 + lane - 3] = pick3(a_n, lane - 3);
  if (lane == 6) depth_out[ray] = a_wz / (a_w + 1e-8f);
}

// the weight bits of the lane's sample s of the warp's ray (0 past S): the
// weights row as this lane wrote it
__device__ __forceinline__ unsigned wbits(const float* __restrict__ wr, int s, int S) {
  return s < S ? __float_as_uint(wr[s]) : 0u;
}

template <int NR>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    weights_topk_tiled_kernel(const float* __restrict__ z, const float* __restrict__ sigma,
                              const float* __restrict__ nrm, float* __restrict__ weights,
                              float* __restrict__ depth_out, float* __restrict__ normal_out,
                              float* __restrict__ topk_w, float* __restrict__ wsum,
                              int64_t* __restrict__ picks, int64_t R, int S, int Kc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // uniform per warp
  float* wr = weights + ray * S;
  float carry = 0.f, a_w = 0.f, a_wz = 0.f, a_n[3] = {0.f, 0.f, 0.f};
  int n_nz = 0;
  for (int s0 = 0; s0 < S; s0 += 32 * NR) {
    float zz[NR], dist[NR], e[NR], run[NR], w[NR];
    load_tile<NR>(z + ray * S, sigma + ray * S, S, s0, lane, zz, dist, e);
    prefix_tile<NR>(e, lane, carry, run);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int s = s0 + lane + 32 * j;
      w[j] = (1.0f - expf(-e[j])) * expf(-run[j]);
      if (s < S) wr[s] = w[j];
      a_w += w[j];
      a_wz += w[j] * zz[j];
      n_nz += __popc(__ballot_sync(kFull, s < S && w[j] != 0.0f));
    }
    rows_dot<NR>(nrm + ray * 3 * S + 3 * s0, 3 * (S - s0), w, lane, a_n);
  }
  a_w = warp_sum(a_w);
  a_wz = warp_sum(a_wz);
#pragma unroll
  for (int c = 0; c < 3; ++c) a_n[c] = warp_sum(a_n[c]);
  if (lane < 3) normal_out[ray * 3 + lane] = pick3(a_n, lane);
  if (lane == 3) depth_out[ray] = a_wz / (a_w + 1e-8f);
  if (lane == 4) wsum[ray] = a_w;

  // tau, bit by bit over every tile (as pick_radix)
  unsigned tau = 0u;
  for (int b = n_nz > Kc ? 30 : -1; b >= 0; --b) {
    const unsigned cand = tau | (1u << b);
    int cnt = 0;
    for (int s = lane; s - lane < S; s += 32)
      cnt += __popc(__ballot_sync(kFull, wbits(wr, s, S) >= cand));
    if (cnt >= Kc) {
      tau = cand;
      if (cnt == Kc) break;
    }
  }
  int n_gt = 0;
  for (int s = lane; s - lane < S; s += 32)
    n_gt += __popc(__ballot_sync(kFull, wbits(wr, s, S) > tau));
  const int need = Kc - n_gt;  // ties at tau, taken in index order
  const unsigned below = (1u << lane) - 1u;
  int eq_before = 0;
  const int64_t ray_base = ray * S;
  for (int s = lane; s - lane < S; s += 32) {
    const unsigned bits = wbits(wr, s, S);
    const bool eq = s < S && bits == tau;
    const unsigned beq = __ballot_sync(kFull, eq);
    const int tie = eq_before + __popc(beq & below);
    if (eq && tie < need) {  // a tie's place: after every weight above tau
      topk_w[ray * Kc + n_gt + tie] = __uint_as_float(bits);
      picks[ray * Kc + n_gt + tie] = ray_base + s;
    }
    eq_before += __popc(beq);
    // a weight above tau: its place is the count of weights above it, and
    // of equal ones at a lower index, over the whole ray
    unsigned above = __ballot_sync(kFull, s < S && bits > tau);
    while (above) {
      const int src = __ffs(above) - 1;
      above &= above - 1;
      const unsigned bs = __shfl_sync(kFull, bits, src);
      const int ss = __shfl_sync(kFull, s, src);
      int place = 0;
      for (int x = lane; x - lane < S; x += 32) {
        const unsigned bx = wbits(wr, x, S);
        place += __popc(__ballot_sync(kFull, x < S && (bx > bs || (bx == bs && x < ss))));
      }
      if (lane == src) {
        topk_w[ray * Kc + place] = __uint_as_float(bs);
        picks[ray * Kc + place] = ray_base + ss;
      }
    }
  }
}

// composite_bwd_kernel in tiles: a forward pass keeps each sample's
// transmittance prefix in its g_sigma slot, then the tiles from the last
// take the tail sum back to the first
template <int NR>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) composite_bwd_tiled_kernel(
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ rgb, const float* __restrict__ nrm,
    const int64_t* __restrict__ picks, const float* __restrict__ g_weights,
    const float* __restrict__ g_rgb_out, const float* __restrict__ g_depth,
    const float* __restrict__ g_normal_out, const float* __restrict__ g_topk_w,
    const float* __restrict__ g_wsum, float* __restrict__ g_sigma,
    float* __restrict__ g_rgb, float* __restrict__ g_nrm, int64_t R, int S,
    int Kc) {
  __shared__ float gw_rows[kWarpsPerBlock][32 * NR];
  __shared__ float dot_rows[kWarpsPerBlock][96];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // uniform per warp
  float* gs = g_sigma + ray * S;
  float carry = 0.f, a_w = 0.f, a_wz = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32 * NR) {
    float zz[NR], dist[NR], e[NR], run[NR];
    load_tile<NR>(z + ray * S, sigma + ray * S, S, s0, lane, zz, dist, e);
    prefix_tile<NR>(e, lane, carry, run);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int s = s0 + lane + 32 * j;
      const float w = (1.0f - expf(-e[j])) * expf(-run[j]);
      if (s < S) gs[s] = run[j];
      a_w += w;
      a_wz += w * zz[j];
    }
  }
  a_w = warp_sum(a_w);
  a_wz = warp_sum(a_wz);
  const float inv = 1.0f / (a_w + 1e-8f);
  const float depth = a_wz * inv;
  const float gd = g_depth[ray];
  const float gws = g_wsum == nullptr ? 0.0f : g_wsum[ray];
  float gn[3], gc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gn[c] = g_normal_out[ray * 3 + c];
    gc[c] = rgb == nullptr ? 0.0f : g_rgb_out[ray * 3 + c];
  }
  float* dots = dot_rows[warp];
  float* row = gw_rows[warp];
  float tail_carry = 0.0f;
  const int last = (S - 1) / (32 * NR) * (32 * NR);
  for (int s0 = last; s0 >= 0; s0 -= 32 * NR) {
    float zz[NR], dist[NR], e[NR], T[NR], ex[NR], w[NR], gw[NR];
    load_tile<NR>(z + ray * S, sigma + ray * S, S, s0, lane, zz, dist, e);
    const float* nr = nrm + ray * 3 * S + 3 * s0;
    const float* cr = rgb == nullptr ? nullptr : rgb + ray * 3 * S + 3 * s0;
    const int n3 = 3 * (S - s0);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int s = s0 + lane + 32 * j;
      T[j] = expf(-(s < S ? gs[s] : 0.0f));
      ex[j] = expf(-e[j]);
      w[j] = (1.0f - ex[j]) * T[j];
      gw[j] = s < S ? (g_weights == nullptr ? 0.0f : g_weights[ray * S + s]) + gws +
                          gd * (zz[j] - depth) * inv
                    : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int i = 96 * j + lane + 32 * m, c = (lane + 2 * m) % 3;
        float v = i < n3 ? pick3(gn, c) * nr[i] : 0.0f;
        if (cr != nullptr && i < n3) v += pick3(gc, c) * cr[i];
        dots[lane + 32 * m] = v;
      }
      __syncwarp();
      gw[j] += dots[3 * lane] + dots[3 * lane + 1] + dots[3 * lane + 2];
      __syncwarp();
    }
    if (g_topk_w != nullptr) {
#pragma unroll
      for (int j = 0; j < NR; ++j) row[lane + 32 * j] = gw[j];
      __syncwarp();
      for (int k = lane; k < Kc; k += 32) {
        const int64_t p = picks[ray * Kc + k] - ray * S - s0;
        if (p >= 0 && p < 32 * NR) row[p] += g_topk_w[ray * Kc + k];
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NR; ++j) gw[j] = row[lane + 32 * j];
      __syncwarp();
    }
    float incl[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) incl[j] = warp_incl_suffix(gw[j] * w[j], lane);
#pragma unroll
    for (int j = NR - 1; j >= 0; --j) {
      const int s = s0 + lane + 32 * j;
      const float excl = __shfl_down_sync(kFull, incl[j], 1);
      const float tail = lane == 31 ? tail_carry : tail_carry + excl;
      tail_carry += __shfl_sync(kFull, incl[j], 0);
      const float ge = gw[j] * T[j] * ex[j] - tail;
      if (s < S) gs[s] = ge * dist[j];
    }
    float* gnr = g_nrm + ray * 3 * S + 3 * s0;
    float* gcr = rgb == nullptr ? nullptr : g_rgb + ray * 3 * S + 3 * s0;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int f = lane + 32 * m, i = 96 * j + f, c = (lane + 2 * m) % 3;
        const float wv = __shfl_sync(kFull, w[j], f / 3);
        if (i < n3) {
          gnr[i] = pick3(gn, c) * wv;
          if (gcr != nullptr) gcr[i] = pick3(gc, c) * wv;
        }
      }
    }
  }
}

inline unsigned ray_blocks(int64_t R) {
  return (unsigned)((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

inline unsigned group_blocks(int64_t R, int G) {
  const int64_t per_block = (int64_t)kWarpsPerBlock * (32 / G);
  return (unsigned)((R + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int nsl_composite_fwd(const void* z, const void* sigma, const void* rgb,
                      const void* nrm, void* weights, void* rgb_out,
                      void* depth_out, void* normal_out, int64_t R, int S,
                      void* stream) {
  if (R == 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(ray_blocks(R));
  const cudaStream_t st = (cudaStream_t)stream;
#define NSL_FWD_ARGS                                                        \
  (const float*)z, (const float*)sigma, (const float*)rgb, (const float*)nrm, \
      (float*)weights, (float*)rgb_out, (float*)depth_out, (float*)normal_out, R, S
  if (S <= 32 * 4)
    composite_fwd_kernel<4><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_FWD_ARGS);
  else if (S <= 32 * 8)
    composite_fwd_kernel<8><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_FWD_ARGS);
  else if (S <= 32 * 16)
    composite_fwd_kernel<16><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_FWD_ARGS);
  else
    composite_fwd_tiled_kernel<16><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_FWD_ARGS);
#undef NSL_FWD_ARGS
  return (int)cudaGetLastError();
}

// rgb == NULL: the weights pass's backward (no colour); g_topk_w != NULL
// needs picks [R, Kc]
int nsl_composite_bwd(const void* z, const void* sigma, const void* rgb,
                      const void* nrm, const void* picks, const void* g_weights,
                      const void* g_rgb_out, const void* g_depth,
                      const void* g_normal_out, const void* g_topk_w,
                      const void* g_wsum, void* g_sigma, void* g_rgb,
                      void* g_nrm, int64_t R, int S, int Kc, void* stream) {
  if (R == 0) return 0;
  if (S < 1 || Kc < 0 || Kc > S ||
      (g_topk_w != nullptr && picks == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ray_blocks(R));
  const cudaStream_t st = (cudaStream_t)stream;
#define NSL_BWD_ARGS                                                        \
  (const float*)z, (const float*)sigma, (const float*)rgb, (const float*)nrm, \
      (const int64_t*)picks, (const float*)g_weights, (const float*)g_rgb_out, \
      (const float*)g_depth, (const float*)g_normal_out,                      \
      (const float*)g_topk_w, (const float*)g_wsum, (float*)g_sigma,          \
      (float*)g_rgb, (float*)g_nrm, R, S, Kc
  if (S <= 32 * 4)
    composite_bwd_kernel<4><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_BWD_ARGS);
  else if (S <= 32 * 32)
    composite_bwd_kernel<32><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_BWD_ARGS);
  else
    composite_bwd_tiled_kernel<16><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_BWD_ARGS);
#undef NSL_BWD_ARGS
  return (int)cudaGetLastError();
}

int nsl_weights_topk_fwd(const void* z, const void* sigma, const void* nrm,
                         void* weights, void* depth_out, void* normal_out,
                         void* topk_w, void* wsum, void* picks, int64_t R,
                         int S, int Kc, void* stream) {
  if (R == 0) return 0;
  if (S < 1 || Kc < 1 || Kc > S) return (int)cudaErrorInvalidValue;
  const dim3 grid(ray_blocks(R));
  const cudaStream_t st = (cudaStream_t)stream;
#define NSL_FWD_ARGS                                                          \
  (const float*)z, (const float*)sigma, (const float*)nrm, (float*)weights,   \
      (float*)depth_out, (float*)normal_out, (float*)topk_w, (float*)wsum,    \
      (int64_t*)picks, R, S, Kc
  if (S <= 32 * 4)
    weights_topk_kernel<4><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_FWD_ARGS);
  else if (S <= 32 * 32)
    weights_topk_kernel<32><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_FWD_ARGS);
  else
    weights_topk_tiled_kernel<32><<<grid, 32 * kWarpsPerBlock, 0, st>>>(NSL_FWD_ARGS);
#undef NSL_FWD_ARGS
  return (int)cudaGetLastError();
}

int nsl_topk_rgb_fwd(const void* topk_w, const void* wsum, const void* rgb,
                     void* out, int64_t R, int Kc, void* stream) {
  if (R == 0) return 0;
  if (Kc < 1) return (int)cudaErrorInvalidValue;
  const int G = group_lanes(Kc);
  topk_rgb_fwd_kernel<<<group_blocks(R, G), 32 * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(
      (const float*)topk_w, (const float*)wsum, (const float*)rgb,
      (float*)out, R, Kc, G);
  return (int)cudaGetLastError();
}

int nsl_topk_rgb_bwd(const void* topk_w, const void* wsum, const void* rgb,
                     const void* g_out, void* g_topk_w, void* g_wsum,
                     void* g_rgb, int64_t R, int Kc, void* stream) {
  if (R == 0) return 0;
  if (Kc < 1) return (int)cudaErrorInvalidValue;
  const int G = group_lanes(Kc);
  topk_rgb_bwd_kernel<<<group_blocks(R, G), 32 * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(
      (const float*)topk_w, (const float*)wsum, (const float*)rgb,
      (const float*)g_out, (float*)g_topk_w, (float*)g_wsum, (float*)g_rgb, R,
      Kc, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
