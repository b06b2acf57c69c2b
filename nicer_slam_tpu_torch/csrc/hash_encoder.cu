// Multiresolution hash-grid encode for Hopper (sm_90a): K1, K2 and K3.
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
// Table layout is [T, C] fp32 (row-major: a corner's C channels are one
// 8-, 16- or 32-byte row); the checkpoint files keep the JAX package's
// [C, T] and slam/checkpoint.py transposes at that boundary.
//
// What bounds K1/K2 on the card: bytes. Per (point, level) the forward
// writes C features and 3C Jacobian entries (two thirds of its bytes are
// dfeat) and gathers 8 random rows from tables of 0.5 MB (coarse) to
// 1.06 GB (color, 133M rows x 2 channels); the backward reads the same
// cotangents, gathers the rows again for grad_x and scatters 8 rows of
// gradient. The design:
//   * one vector load (and one vector atomicAdd, sm_90's float2/float4
//     atomics in global memory) per corner row instead of C scalar ones;
//   * a block is 32 consecutive points x L levels, one warp per level, so a
//     warp's 32 lanes are 32 points of one level. The path's points are
//     ray-major and sorted along each ray, so neighbouring lanes often fall
//     in the same cell on the coarse levels: the backward finds the lanes
//     that share a corner row (__match_any_sync), sums their gradients in
//     shared memory and lets one lane issue the atomic;
//   * the block's output tiles (feats [32, L*C], dfeat [32, L*C*3]) and
//     cotangent tiles are staged in shared memory (rows padded by one
//     float against bank conflicts) and move to device memory as contiguous
//     coalesced runs; grad_x is summed over the levels in shared memory and
//     written as [N, 3];
//   * the table scatter is skipped entirely when the table needs no
//     gradient (tracking), and grad_x when the input needs none.
// The atomics' order changes from run to run: the table gradient is equal
// to the plain version's up to float32 rounding, not bit for bit.
//
// Measured on an H100 (PERF.md §6): the forward reaches 34-50 % of its
// byte bound on the SDF grids; the colour grid's random 8-byte rows cost a
// whole 32-byte sector each, forward and backward. The backward takes the
// same time on ray-ordered and uniform points of the dense coarse grid: it
// is bound by the instructions and latency of its per-corner chain, not by
// bytes. Variants measured against this one: grad_x in a loop of its own
// (its row loads in flight together) raised the registers to 127-168 and
// lost ~50 % on the SDF grids; no lane merging won 12 % on the coarse grid
// and lost 40 % on the colour grid's top-16 points; a division-free level
// modulo chosen inside the corner loop lost 23 % in the forward, while
// chosen once per level before it (corner_rows, this version) it took
// 4-12 % off the SDF backward and 5-8 % off K3 and added 2-5 % to the
// colour backward.
//
// K3 replaces hash_encode_packed (:858-905) with its pack_table_bf16_pairs
// (:849-855): the no-grad encode of the SDF grids (density-cache build,
// the exact prepass of an eval render) from tables rounded to bfloat16,
// nearest-even, as astype(bfloat16) rounds them. The TPU packs channel
// pairs into uint32 words to halve its gather count; here the table is
// [T, C] bf16, so a corner's C channels are one 16-byte (C = 8), 8-byte
// (C = 4) or 4-byte (C = 2) load, half the bytes of the fp32 [T, C]
// table's row. Values widen to float32 exactly (a bf16 is the top half of
// a float32) and the sums run in float32, as the reference's. Forward
// only: the caller holds no gradient. It keeps one thread per
// (point, level).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
// points per K1/K2 block: one per lane of each level's warp
constexpr int kPts = 32;
// the corner row of a lane that has no point in range (never a table row)
constexpr uint32_t kNoRow = 0xffffffffu;

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

// the table rows of the 8 corners. The modulo by the level size is picked
// once per level (a warp is one level), outside the loops that load rows:
// a mask for a power-of-two size (every hashed level of the shipped grids,
// and the coarse grid's 32^3), one conditional subtraction for a dense
// level (an in-range point's corner coordinates are at most res, so its
// index is below res + res^2 + res^3 < 2 size), the remainder otherwise
__device__ __forceinline__ void corner_rows(const LevelGeom& g, uint32_t res,
                                            uint32_t lsize, uint32_t offset,
                                            bool dense, uint32_t rows[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t c0 = g.left[0] + (k & 1);
    uint32_t c1 = g.left[1] + ((k >> 1) & 1);
    uint32_t c2 = g.left[2] + ((k >> 2) & 1);
    rows[k] = dense ? (c0 + c1 * res + c2 * (res * res))
                    : (c0 ^ (c1 * kPrime1) ^ (c2 * kPrime2));
  }
  if ((lsize & (lsize - 1)) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) rows[k] = (rows[k] & (lsize - 1)) + offset;
  } else if (dense) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      rows[k] = (rows[k] >= lsize ? rows[k] - lsize : rows[k]) + offset;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) rows[k] = rows[k] % lsize + offset;
  }
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

// ---- one [T, C] fp32 row: vector load, vector store, vector atomic ----

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ t,
                                         uint32_t row, float v[C]) {
  if constexpr (C == 2) {
    float2 a = __ldg(reinterpret_cast<const float2*>(t) + row);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      float4 a = __ldg(reinterpret_cast<const float4*>(t) + (size_t)row * (C / 4) + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
}

// C floats at p (8- or 16-byte aligned: shared-memory scratch)
template <int C>
__device__ __forceinline__ void store_vec(float* p, const float v[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

template <int C>
__device__ __forceinline__ void atomic_add_row(float* t, uint32_t row,
                                               const float v[C]) {
  if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(t) + row, make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(t) + (size_t)row * (C / 4) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

// Shared memory of a K1/K2 block, in floats (every part a multiple of 4
// floats, so each starts 16-byte aligned). LC = L*C.
__host__ __device__ constexpr int smem_x() { return kPts * 3; }
__host__ __device__ constexpr int smem_feat(int LC) { return kPts * (LC + 1); }
__host__ __device__ constexpr int smem_dfeat(int LC) { return kPts * (3 * LC + 1); }

// the block's [np, W] tile of a row-major [N, W] array, staged in shared
// memory with rows padded to W + 1, to or from device memory in
// contiguous runs
__device__ __forceinline__ void tile_out(float* __restrict__ dst,
                                         const float* s, int np, int W) {
  for (int i = threadIdx.x; i < np * W; i += blockDim.x) {
    int p = i / W;
    dst[i] = s[i + p];
  }
}

__device__ __forceinline__ void tile_in(float* s, const float* __restrict__ src,
                                        int np, int W) {
  for (int i = threadIdx.x; i < np * W; i += blockDim.x) {
    int p = i / W;
    s[i + p] = src[i];
  }
}

// the block's points [np, 3] into shared memory; lane p's point, or the
// origin for a lane past the end (its outputs are never written)
__device__ __forceinline__ void block_points(float* s_x,
                                             const float* __restrict__ x,
                                             int64_t n0, int np, int lane,
                                             float xp[3]) {
  for (int i = threadIdx.x; i < np * 3; i += blockDim.x) s_x[i] = x[n0 * 3 + i];
  __syncthreads();
#pragma unroll
  for (int d = 0; d < 3; ++d) xp[d] = lane < np ? s_x[lane * 3 + d] : 0.0f;
}

// feats[n, l*C + c] = sum_k w_k v_k[c];  dfeat[n, l*C + c, d] = sum_k dw_k,d v_k[c]
template <int C, bool JAC>
__global__ void hash_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                float* __restrict__ feats,
                                float* __restrict__ dfeat, int64_t N, int L,
                                float size) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LC = L * C;
  float* s_x = smem;
  float* s_f = s_x + smem_x();
  float* s_d = s_f + smem_feat(LC);
  const int lane = threadIdx.x & 31, l = threadIdx.x >> 5;
  const int64_t n0 = (int64_t)blockIdx.x * kPts;
  const int np = (int)(N - n0 < kPts ? N - n0 : kPts);
  float xp[3];
  block_points(s_x, x, n0, np, lane, xp);

  LevelGeom g;
  bool oob = level_geom(xp, size, scl[2 * l], scl[2 * l + 1], g);
  float acc[C], dacc[C][3];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = 0.0f;
    dacc[c][0] = dacc[c][1] = dacc[c][2] = 0.0f;
  }
  if (lane < np && !oob) {
    uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
    uint32_t res = (uint32_t)meta[4 * l + 2];
    bool dense = meta[4 * l + 3] != 0;
    uint32_t rows[8];
    corner_rows(g, res, lsize, offset, dense, rows);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v[C];
      load_row<C>(table, rows[k], v);
      float w, dw[3];
      corner_weights(g, k, w, dw);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] += w * v[c];
        if (JAC) {
          dacc[c][0] += dw[0] * v[c];
          dacc[c][1] += dw[1] * v[c];
          dacc[c][2] += dw[2] * v[c];
        }
      }
    }
  }
  // lane p's row of each tile; rows padded by one float, so the 32 lanes
  // of a warp store to 32 different banks
  float* fr = s_f + lane * (LC + 1) + l * C;
#pragma unroll
  for (int c = 0; c < C; ++c) fr[c] = acc[c];
  if (JAC) {
    float* dr = s_d + lane * (3 * LC + 1) + l * C * 3;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dr[3 * c] = dacc[c][0];
      dr[3 * c + 1] = dacc[c][1];
      dr[3 * c + 2] = dacc[c][2];
    }
  }
  __syncthreads();
  tile_out(feats + n0 * LC, s_f, np, LC);
  if (JAC) tile_out(dfeat + n0 * LC * 3, s_d, np, 3 * LC);
}

// g_table[row(k), c] += g_feat[c] w_k + sum_d g_dfeat[c, d] dw_k,d     (atomic)
// g_x[n, e] = sum_l sum_k sum_c v_k[c] (g_feat[c] dw_k,e + sum_d g_dfeat[c, d] h_k[d][e])
template <int C, bool JAC>
__global__ void hash_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                const float* __restrict__ g_feat,
                                const float* __restrict__ g_dfeat,
                                float* __restrict__ g_table,
                                float* __restrict__ g_x, int64_t N, int L,
                                float size) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LC = L * C;
  // s_x [32, 3] | merge scratch [L][32, C] | s_gx [L][32, 3] |
  // s_f [32, LC + 1] | s_d [32, 3 LC + 1]
  float* s_x = smem;
  float* s_m = s_x + smem_x();
  float* s_gx = s_m + L * kPts * C;
  float* s_f = s_gx + L * kPts * 3;
  float* s_d = s_f + smem_feat(LC);
  const int lane = threadIdx.x & 31, l = threadIdx.x >> 5;
  const int64_t n0 = (int64_t)blockIdx.x * kPts;
  const int np = (int)(N - n0 < kPts ? N - n0 : kPts);
  tile_in(s_f, g_feat + n0 * LC, np, LC);
  if (JAC) tile_in(s_d, g_dfeat + n0 * LC * 3, np, 3 * LC);
  float xp[3];
  block_points(s_x, x, n0, np, lane, xp);   // synchronises the block

  LevelGeom g;
  bool oob = level_geom(xp, size, scl[2 * l], scl[2 * l + 1], g);
  const bool active = lane < np && !oob;
  float gf[C], gd[C][3];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gf[c] = active ? s_f[lane * (LC + 1) + l * C + c] : 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      gd[c][d] = (JAC && active) ? s_d[lane * (3 * LC + 1) + (l * C + c) * 3 + d] : 0.0f;
  }
  uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
  uint32_t res = (uint32_t)meta[4 * l + 2];
  bool dense = meta[4 * l + 3] != 0;
  float* s_mw = s_m + l * kPts * C;   // this warp's merge scratch
  uint32_t rows[8];
  corner_rows(g, res, lsize, offset, dense, rows);
  float gx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t row = active ? rows[k] : kNoRow;
    float w, dw[3];
    corner_weights(g, k, w, dw);
    if (g_table != nullptr) {
      float gt[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gt[c] = gf[c] * w;
        if (JAC) gt[c] += gd[c][0] * dw[0] + gd[c][1] * dw[1] + gd[c][2] * dw[2];
      }
      // lanes of this warp (32 points of one level) on the same row
      unsigned peers = __match_any_sync(0xffffffffu, row);
      if (__any_sync(0xffffffffu, row != kNoRow && __popc(peers) > 1)) {
        store_vec<C>(s_mw + lane * C, gt);
        __syncwarp();
        if (lane == __ffs(peers) - 1 && row != kNoRow) {
          float sum[C];
#pragma unroll
          for (int c = 0; c < C; ++c) sum[c] = 0.0f;
          for (unsigned m = peers; m != 0; m &= m - 1) {
            const float* src = s_mw + (__ffs(m) - 1) * C;
#pragma unroll
            for (int c = 0; c < C; ++c) sum[c] += src[c];
          }
          atomic_add_row<C>(g_table, row, sum);
        }
        __syncwarp();
      } else if (row != kNoRow) {
        atomic_add_row<C>(g_table, row, gt);
      }
    }
    if (g_x != nullptr && active) {
      // with a = v . g_feat and b_d = v . g_dfeat[:, d], this corner adds
      // a dw_e + sum_d b_d h[d][e] to grad_x[e]
      float v[C];
      load_row<C>(table, row, v);
      float a = 0.0f, b[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a += v[c] * gf[c];
        if (JAC) {
          b[0] += v[c] * gd[c][0];
          b[1] += v[c] * gd[c][1];
          b[2] += v[c] * gd[c][2];
        }
      }
      float h[3][3];
      if (JAC) corner_hessian(g, k, h);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        gx[e] += a * dw[e];
        if (JAC) gx[e] += b[0] * h[0][e] + b[1] * h[1][e] + b[2] * h[2][e];
      }
    }
  }
  if (g_x != nullptr) {
    // per level into shared memory, then the sum over levels per point
#pragma unroll
    for (int e = 0; e < 3; ++e) s_gx[l * kPts * 3 + lane * 3 + e] = gx[e];
    __syncthreads();
    for (int i = threadIdx.x; i < np * 3; i += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < L; ++q) s += s_gx[q * kPts * 3 + i];
      g_x[n0 * 3 + i] = s;
    }
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
    uint32_t rows[8];
    corner_rows(g, res, lsize, offset, dense, rows);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float w, dw[3];
      corner_weights(g, k, w, dw);
      float v[C];
      load_bf16_row<C>(table, rows[k], v);
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

// launch K1/K2 kernel `kern` with one block of L warps per 32 points and
// `floats` of dynamic shared memory (opting in above the default 48 KB)
template <typename Kernel, typename... Args>
int launch_blocks(Kernel kern, int64_t N, int L, int floats, cudaStream_t s,
                  Args... args) {
  size_t bytes = (size_t)floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned blocks = (unsigned)((N + kPts - 1) / kPts);
  kern<<<blocks, 32 * L, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int C>
int launch_fwd(const float* x, const float* table, const int* meta,
               const float* scl, float* feats, float* dfeat, int64_t N, int L,
               float size, cudaStream_t s) {
  const int LC = L * C;
  if (dfeat != nullptr)
    return launch_blocks(hash_fwd_kernel<C, true>, N, L,
                         smem_x() + smem_feat(LC) + smem_dfeat(LC), s, x, table,
                         meta, scl, feats, dfeat, N, L, size);
  return launch_blocks(hash_fwd_kernel<C, false>, N, L, smem_x() + smem_feat(LC), s,
                       x, table, meta, scl, feats, dfeat, N, L, size);
}

template <int C>
int launch_bwd(const float* x, const float* table, const int* meta,
               const float* scl, const float* g_feat, const float* g_dfeat,
               float* g_table, float* g_x, int64_t N, int L, float size,
               cudaStream_t s) {
  const int LC = L * C;
  const int floats = smem_x() + L * kPts * (C + 3) + smem_feat(LC);
  if (g_dfeat != nullptr)
    return launch_blocks(hash_bwd_kernel<C, true>, N, L, floats + smem_dfeat(LC), s,
                         x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, N, L,
                         size);
  return launch_blocks(hash_bwd_kernel<C, false>, N, L, floats, s, x, table, meta,
                       scl, g_feat, g_dfeat, g_table, g_x, N, L, size);
}

}  // namespace

extern "C" {

// dfeat == NULL selects K2 (features only); otherwise K1. table is [T, C]
// fp32 with a 16-byte aligned base, L <= 32 (the wrapper checks).
int nsl_hash_encode_fwd(const void* x, const void* table, const void* meta,
                        const void* scl, void* feats, void* dfeat, int64_t N,
                        int L, int C, float size, void* stream) {
  if (N == 0) return 0;
  if (L < 1 || L > 32) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return launch((const float*)x, (const float*)table, (const int*)meta,
                  (const float*)scl, (float*)feats, (float*)dfeat, N, L, size, s);
  };
  switch (C) {
    case 2: return args(launch_fwd<2>);
    case 4: return args(launch_fwd<4>);
    case 8: return args(launch_fwd<8>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g_dfeat == NULL selects K2; g_table (zeroed by the caller, accumulated
// into) and g_x ([N, 3], written) may each be NULL (not needed).
int nsl_hash_encode_bwd(const void* x, const void* table, const void* meta,
                        const void* scl, const void* g_feat,
                        const void* g_dfeat, void* g_table, void* g_x,
                        int64_t N, int L, int C, float size, void* stream) {
  if (N == 0) return 0;
  if (L < 1 || L > 32) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return launch((const float*)x, (const float*)table, (const int*)meta,
                  (const float*)scl, (const float*)g_feat, (const float*)g_dfeat,
                  (float*)g_table, (float*)g_x, N, L, size, s);
  };
  switch (C) {
    case 2: return args(launch_bwd<2>);
    case 4: return args(launch_bwd<4>);
    case 8: return args(launch_bwd<8>);
    default: return (int)cudaErrorInvalidValue;
  }
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
