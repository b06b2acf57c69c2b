// Multiresolution hash-grid encode for Hopper (sm_90a): K1 and K2.
//
// K1 replaces nicer_slam_tpu/ops/hash_encoder.py hash_encode_with_grad
// (:266-375): features AND the analytic input Jacobian dfeat/dx from one
// gather. K2 replaces hash_encode (:177-263) with its big-grid variant
// _hash_encode_unified/_grid_corner_values (:601-678, :784-834): features
// only. Both share one forward and one backward kernel, templated on the
// channel count C in {2, 4, 8} and on whether the Jacobian is carried.
//
// Semantics (reference hashencoder.cu): level l has scale s_l and
// resolution r_l; u = (x + size) / (2 size); pos = u s_l; smoothstep
// weights wb = f^2 (3 - 2f) per dim; 8 corners; dense index
// x + y r + z r^2 or hashed xor(x*1, y*2654435761, z*805459861), both
// mod the level size, in uint32 arithmetic (the wrap is native here).
// Inputs outside [0,1] give zero features and zero gradients.
//
// Table layout is [C, T] (channel-major), the checkpoint layout.
//
// What bounds it on the card: random 4-byte gathers (forward) and 4-byte
// float atomics (backward) into tables of 0.5 MB (coarse) to 1.06 GB
// (color, 133M entries x 2 channels) — memory-latency and sector bound,
// about 32 B moved per 4 B used. The design keeps one thread per
// (point, level): N*L independent threads hide latency by occupancy, the
// corner loop is unrolled so the 8*C loads of a thread are in flight
// together, and the backward writes grad_x per level into an [N, L, 3]
// buffer (summed by the caller) so only the table needs atomics. The
// table scatter is skipped entirely when the table needs no gradient
// (tracking). Coalesced [T, C] rows and sorted scatters are later work.
//
// K3 replaces hash_encode_packed (:858-905) with its pack_table_bf16_pairs
// (:849-855): the no-grad encode of the SDF grids (density-cache build,
// the exact prepass of an eval render) from tables rounded to bfloat16,
// nearest-even, as astype(bfloat16) rounds them. The TPU packs channel
// pairs into uint32 words to halve its gather count; here the table is
// [T, C] bf16, so a corner's C channels are one 16-byte (C = 8), 8-byte
// (C = 4) or 4-byte (C = 2) load, half the sectors of the fp32 [C, T]
// layout's C separate loads. Values widen to float32 exactly (a bf16 is
// the top half of a float32) and the sums run in float32, as the
// reference's. Forward only: the caller holds no gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

struct LevelGeom {
  float f[3], wb[3], wa[3], dwb[3], ddwb[3];
  uint32_t left[3];
};

// meta[l] = {offset, size, resolution, dense}; scl[l] = {scale, scale*chain}
__device__ __forceinline__ bool level_geom(const float* x, float size,
                                           float scale, float dscale,
                                           LevelGeom& g) {
  bool oob = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float u = (x[d] + size) / (2.0f * size);
    oob |= (u < 0.0f) || (u > 1.0f);
    float pos = u * scale;
    float lf = floorf(pos);
    float f = pos - lf;
    g.f[d] = f;
    g.left[d] = (uint32_t)(int)lf;
    g.wb[d] = f * f * (3.0f - 2.0f * f);
    g.wa[d] = 1.0f - g.wb[d];
    g.dwb[d] = 6.0f * f * (1.0f - f) * dscale;
    g.ddwb[d] = 6.0f * (1.0f - 2.0f * f) * dscale * dscale;
  }
  return oob;
}

__device__ __forceinline__ uint32_t corner_row(const LevelGeom& g, int k,
                                               uint32_t res, uint32_t lsize,
                                               uint32_t offset, bool dense) {
  uint32_t c0 = g.left[0] + (k & 1);
  uint32_t c1 = g.left[1] + ((k >> 1) & 1);
  uint32_t c2 = g.left[2] + ((k >> 2) & 1);
  uint32_t idx = dense ? (c0 + c1 * res + c2 * (res * res))
                       : (c0 ^ (c1 * kPrime1) ^ (c2 * kPrime2));
  return idx % lsize + offset;
}

// corner weight w, dw/dx_d, and (second order) d(dw_d)/dx_e
__device__ __forceinline__ void corner_weights(const LevelGeom& g, int k,
                                               float& w, float dw[3]) {
  float sel[3], dsel[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    bool bit = (k >> d) & 1;
    sel[d] = bit ? g.wb[d] : g.wa[d];
    dsel[d] = bit ? g.dwb[d] : -g.dwb[d];
  }
  w = sel[0] * sel[1] * sel[2];
  dw[0] = dsel[0] * sel[1] * sel[2];
  dw[1] = dsel[1] * sel[0] * sel[2];
  dw[2] = dsel[2] * sel[0] * sel[1];
}

__device__ __forceinline__ void corner_hessian(const LevelGeom& g, int k,
                                               float h[3][3]) {
  // h[d][e] = d(dw_d)/dx_e
  float sel[3], dsel[3], ddsel[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    bool bit = (k >> d) & 1;
    sel[d] = bit ? g.wb[d] : g.wa[d];
    dsel[d] = bit ? g.dwb[d] : -g.dwb[d];
    ddsel[d] = bit ? g.ddwb[d] : -g.ddwb[d];
  }
  h[0][0] = ddsel[0] * sel[1] * sel[2];
  h[1][1] = ddsel[1] * sel[0] * sel[2];
  h[2][2] = ddsel[2] * sel[0] * sel[1];
  h[0][1] = h[1][0] = dsel[0] * dsel[1] * sel[2];
  h[0][2] = h[2][0] = dsel[0] * dsel[2] * sel[1];
  h[1][2] = h[2][1] = dsel[1] * dsel[2] * sel[0];
}

template <int C, bool JAC>
__global__ void hash_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                float* __restrict__ feats,
                                float* __restrict__ dfeat, int64_t N, int L,
                                int64_t T, float size) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  int64_t n = i / L;
  int l = (int)(i - n * L);
  float xp[3] = {x[n * 3], x[n * 3 + 1], x[n * 3 + 2]};
  LevelGeom g;
  bool oob = level_geom(xp, size, scl[2 * l], scl[2 * l + 1], g);
  float acc[C], dacc[C][3];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = 0.0f;
    dacc[c][0] = dacc[c][1] = dacc[c][2] = 0.0f;
  }
  if (!oob) {
    uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
    uint32_t res = (uint32_t)meta[4 * l + 2];
    bool dense = meta[4 * l + 3] != 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t row = corner_row(g, k, res, lsize, offset, dense);
      float w, dw[3];
      corner_weights(g, k, w, dw);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = __ldg(table + (int64_t)c * T + row);
        acc[c] += w * v;
        if (JAC) {
          dacc[c][0] += dw[0] * v;
          dacc[c][1] += dw[1] * v;
          dacc[c][2] += dw[2] * v;
        }
      }
    }
  }
  float* fo = feats + (n * L + l) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) fo[c] = acc[c];
  if (JAC) {
    float* dfo = dfeat + (n * L + l) * C * 3;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dfo[c * 3] = dacc[c][0];
      dfo[c * 3 + 1] = dacc[c][1];
      dfo[c * 3 + 2] = dacc[c][2];
    }
  }
}

// g_table[c, row] += g_feat[c] w + sum_d g_dfeat[c, d] dw_d      (atomic)
// g_x[n, l, e] = sum_k sum_c v[c] (g_feat[c] dw_e + sum_d g_dfeat[c,d] h[d][e])
template <int C, bool JAC>
__global__ void hash_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                const float* __restrict__ g_feat,
                                const float* __restrict__ g_dfeat,
                                float* __restrict__ g_table,
                                float* __restrict__ g_x, int64_t N, int L,
                                int64_t T, float size) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  int64_t n = i / L;
  int l = (int)(i - n * L);
  float xp[3] = {x[n * 3], x[n * 3 + 1], x[n * 3 + 2]};
  LevelGeom g;
  bool oob = level_geom(xp, size, scl[2 * l], scl[2 * l + 1], g);
  float gx[3] = {0.0f, 0.0f, 0.0f};
  if (!oob) {
    float gf[C], gd[C][3];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gf[c] = g_feat[(n * L + l) * C + c];
      if (JAC) {
        const float* p = g_dfeat + ((n * L + l) * C + c) * 3;
        gd[c][0] = p[0];
        gd[c][1] = p[1];
        gd[c][2] = p[2];
      }
    }
    uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
    uint32_t res = (uint32_t)meta[4 * l + 2];
    bool dense = meta[4 * l + 3] != 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t row = corner_row(g, k, res, lsize, offset, dense);
      float w, dw[3];
      corner_weights(g, k, w, dw);
      float h[3][3];
      if (JAC && g_x != nullptr) corner_hessian(g, k, h);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (g_table != nullptr) {
          float gt = gf[c] * w;
          if (JAC) gt += gd[c][0] * dw[0] + gd[c][1] * dw[1] + gd[c][2] * dw[2];
          atomicAdd(g_table + (int64_t)c * T + row, gt);
        }
        if (g_x != nullptr) {
          float v = __ldg(table + (int64_t)c * T + row);
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            float t = gf[c] * dw[e];
            if (JAC) t += gd[c][0] * h[0][e] + gd[c][1] * h[1][e] + gd[c][2] * h[2][e];
            gx[e] += v * t;
          }
        }
      }
    }
  }
  if (g_x != nullptr) {
    float* o = g_x + (n * L + l) * 3;
    o[0] = gx[0];
    o[1] = gx[1];
    o[2] = gx[2];
  }
}

// the C bf16 channels of one [T, C] row, widened to float32
template <int C>
__device__ __forceinline__ void load_bf16_row(const uint16_t* __restrict__ t,
                                              uint32_t row, float v[C]);

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <>
__device__ __forceinline__ void load_bf16_row<2>(const uint16_t* __restrict__ t,
                                                 uint32_t row, float v[2]) {
  uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(t) + row);
  v[0] = bf16_lo(w);
  v[1] = bf16_hi(w);
}

template <>
__device__ __forceinline__ void load_bf16_row<4>(const uint16_t* __restrict__ t,
                                                 uint32_t row, float v[4]) {
  uint2 w = __ldg(reinterpret_cast<const uint2*>(t) + row);
  v[0] = bf16_lo(w.x);
  v[1] = bf16_hi(w.x);
  v[2] = bf16_lo(w.y);
  v[3] = bf16_hi(w.y);
}

template <>
__device__ __forceinline__ void load_bf16_row<8>(const uint16_t* __restrict__ t,
                                                 uint32_t row, float v[8]) {
  uint4 w = __ldg(reinterpret_cast<const uint4*>(t) + row);
  uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(ws[i]);
    v[2 * i + 1] = bf16_hi(ws[i]);
  }
}

// K3: features from a [T, C] bf16 table; one thread per (point, level)
template <int C>
__global__ void hash_bf16_fwd_kernel(const float* __restrict__ x,
                                     const uint16_t* __restrict__ table,
                                     const int* __restrict__ meta,
                                     const float* __restrict__ scl,
                                     float* __restrict__ feats, int64_t N,
                                     int L, float size) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  int64_t n = i / L;
  int l = (int)(i - n * L);
  float xp[3] = {x[n * 3], x[n * 3 + 1], x[n * 3 + 2]};
  LevelGeom g;
  bool oob = level_geom(xp, size, scl[2 * l], scl[2 * l + 1], g);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  if (!oob) {
    uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
    uint32_t res = (uint32_t)meta[4 * l + 2];
    bool dense = meta[4 * l + 3] != 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t row = corner_row(g, k, res, lsize, offset, dense);
      float w, dw[3];
      corner_weights(g, k, w, dw);
      float v[C];
      load_bf16_row<C>(table, row, v);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * v[c];
    }
  }
  float* fo = feats + (n * L + l) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) fo[c] = acc[c];
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

template <int C>
void launch_fwd(const float* x, const float* table, const int* meta,
                const float* scl, float* feats, float* dfeat, int64_t N, int L,
                int64_t T, float size, cudaStream_t s) {
  if (dfeat != nullptr)
    hash_fwd_kernel<C, true><<<blocks_for(N * L), kThreads, 0, s>>>(
        x, table, meta, scl, feats, dfeat, N, L, T, size);
  else
    hash_fwd_kernel<C, false><<<blocks_for(N * L), kThreads, 0, s>>>(
        x, table, meta, scl, feats, dfeat, N, L, T, size);
}

template <int C>
void launch_bwd(const float* x, const float* table, const int* meta,
                const float* scl, const float* g_feat, const float* g_dfeat,
                float* g_table, float* g_x, int64_t N, int L, int64_t T,
                float size, cudaStream_t s) {
  if (g_dfeat != nullptr)
    hash_bwd_kernel<C, true><<<blocks_for(N * L), kThreads, 0, s>>>(
        x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, N, L, T, size);
  else
    hash_bwd_kernel<C, false><<<blocks_for(N * L), kThreads, 0, s>>>(
        x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, N, L, T, size);
}

}  // namespace

extern "C" {

// dfeat == NULL selects K2 (features only); otherwise K1.
int nsl_hash_encode_fwd(const void* x, const void* table, const void* meta,
                        const void* scl, void* feats, void* dfeat, int64_t N,
                        int L, int C, int64_t T, float size, void* stream) {
  if (N == 0) return 0;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    launch((const float*)x, (const float*)table, (const int*)meta,
           (const float*)scl, (float*)feats, (float*)dfeat, N, L, T, size, s);
  };
  switch (C) {
    case 2: args(launch_fwd<2>); break;
    case 4: args(launch_fwd<4>); break;
    case 8: args(launch_fwd<8>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g_dfeat == NULL selects K2; g_table / g_x may each be NULL (not needed).
int nsl_hash_encode_bwd(const void* x, const void* table, const void* meta,
                        const void* scl, const void* g_feat,
                        const void* g_dfeat, void* g_table, void* g_x,
                        int64_t N, int L, int C, int64_t T, float size,
                        void* stream) {
  if (N == 0) return 0;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    launch((const float*)x, (const float*)table, (const int*)meta,
           (const float*)scl, (const float*)g_feat, (const float*)g_dfeat,
           (float*)g_table, (float*)g_x, N, L, T, size, s);
  };
  switch (C) {
    case 2: args(launch_bwd<2>); break;
    case 4: args(launch_bwd<4>); break;
    case 8: args(launch_bwd<8>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K3: table is [T, C] bfloat16 (C in {2, 4, 8}), 2 C bytes per row, the
// base aligned to 16 bytes (the wrapper checks)
int nsl_hash_encode_bf16_fwd(const void* x, const void* table,
                             const void* meta, const void* scl, void* feats,
                             int64_t N, int L, int C, float size,
                             void* stream) {
  if (N == 0) return 0;
  auto s = (cudaStream_t)stream;
  unsigned blocks = blocks_for(N * L);
  const float* xf = (const float*)x;
  const uint16_t* t = (const uint16_t*)table;
  const int* m = (const int*)meta;
  const float* sc = (const float*)scl;
  float* f = (float*)feats;
  switch (C) {
    case 2: hash_bf16_fwd_kernel<2><<<blocks, kThreads, 0, s>>>(xf, t, m, sc, f, N, L, size); break;
    case 4: hash_bf16_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(xf, t, m, sc, f, N, L, size); break;
    case 8: hash_bf16_fwd_kernel<8><<<blocks, kThreads, 0, s>>>(xf, t, m, sc, f, N, L, size); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
