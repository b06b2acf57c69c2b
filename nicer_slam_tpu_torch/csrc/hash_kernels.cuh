// The K1/K2/K3 kernels and their launch templates (the design note is at
// the top of hash_encoder.cu), shared by hash_encoder.cu, which
// instantiates them for the shipped grids' channel counts C = 2, 4, 8 and
// for K3, and hash_encoder_channels.cu, which instantiates K1/K2 for C =
// 1, 3, 5, 6, 7; the two sources compile in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using nsl::corner_rows;
using nsl::corner_weights;
using nsl::level_geom;
using nsl::LevelGeom;
using nsl::load_bf16_row;

// points per K1/K2 block: one per lane of each level's warp
constexpr int kPts = 32;
// the corner row of a lane that has no point in range (never a table row)
constexpr uint32_t kNoRow = 0xffffffffu;

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

// ---- one [T, C] fp32 row: vector load, vector store ----
// (float4 words for C = 4, 8; float2 for C = 2 and the other even C;
// single floats for an odd C)

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ t,
                                         uint32_t row, float v[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      float4 a = __ldg(reinterpret_cast<const float4*>(t) + (size_t)row * (C / 4) + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int q = 0; q < C / 2; ++q) {
      float2 a = __ldg(reinterpret_cast<const float2*>(t) + (size_t)row * (C / 2) + q);
      v[2 * q] = a.x;
      v[2 * q + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(t + (size_t)row * C + c);
  }
}

// C floats at p (shared-memory scratch, aligned to the row's word)
template <int C>
__device__ __forceinline__ void store_vec(float* p, const float v[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int q = 0; q < C / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = v[c];
  }
}

// ---- the table gradient in fixed point (see the header) ----

// the exponent of a level whose cotangents are not finite
constexpr int kNotFinite = -1000000;

// k_l from the level's maxima (float bits: maxes[l] = max|g_feat|,
// maxes[L + l] = max sum_d |g_dfeat[., d]|) and count_bits = ceil(log2 8N)
__device__ __forceinline__ int fixed_exp(const unsigned* __restrict__ maxes, int l, int L,
                                         float dscale, int count_bits) {
  float bound = __uint_as_float(maxes[l]) + 1.5f * fabsf(dscale) * __uint_as_float(maxes[L + l]);
  if (!isfinite(bound)) return kNotFinite;
  if (bound == 0.0f) return 0;
  int e;
  frexpf(bound, &e);   // bound < 2^e
  return 61 - count_bits - e;
}

template <int C>
__device__ __forceinline__ void add_row_fixed(long long* acc, uint32_t row,
                                              const float v[C], int k) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(acc) + (size_t)row * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    atomicAdd(p + c, (unsigned long long)__float2ll_rn(ldexpf(v[c], k)));
}

// per-level maxima of |g_feat| and of sum_d |g_dfeat[., d]| into maxes[2L]
// (zeroed), as the bits of non-negative floats, which order as the floats
// do (a NaN's above inf). A block is rows x LC threads, thread (r, col) on
// column col of points r, r + rows, ...
__global__ void level_max_kernel(const float* __restrict__ g_feat,
                                 const float* __restrict__ g_dfeat, int64_t N, int L,
                                 int C, unsigned* __restrict__ maxes) {
  __shared__ unsigned s_max[64];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s_max[i] = 0u;
  __syncthreads();
  const int LC = L * C, rows = blockDim.x / LC;
  const int col = threadIdx.x % LC, r = threadIdx.x / LC;
  unsigned a = 0u, b = 0u;
  for (int64_t n = (int64_t)blockIdx.x * rows + r; n < N; n += (int64_t)gridDim.x * rows) {
    a = max(a, __float_as_uint(fabsf(g_feat[n * LC + col])));
    if (g_dfeat != nullptr) {
      const float* d = g_dfeat + (n * LC + col) * 3;
      b = max(b, __float_as_uint(fabsf(d[0]) + fabsf(d[1]) + fabsf(d[2])));
    }
  }
  const int l = col / C;
  atomicMax(&s_max[l], a);
  atomicMax(&s_max[32 + l], b);
  __syncthreads();
  if (threadIdx.x < L) {
    atomicMax(&maxes[threadIdx.x], s_max[threadIdx.x]);
    atomicMax(&maxes[L + threadIdx.x], s_max[32 + threadIdx.x]);
  }
}

// The last pass of a backward with a table gradient: g_table = acc 2^-k_l
// for every row of level l = blockIdx.y (NaN for a non-finite level), and
// acc set back to 0 where it was not, so the accumulator is zero for the
// next call. A pass over the points that converted and re-zeroed only the
// touched rows was slower at every shape the paths give (PERF.md §6): the
// colour grid's touched rows lie at random, a 32-byte sector each, and
// the SDF grids' tables are small.
__global__ void fixed_sweep_kernel(long long* __restrict__ acc, float* __restrict__ g_table,
                                   const int* __restrict__ meta,
                                   const float* __restrict__ scl,
                                   const unsigned* __restrict__ maxes, int L, int C,
                                   int count_bits) {
  const int l = blockIdx.y;
  const int64_t off = (int64_t)meta[4 * l] * C, n = (int64_t)meta[4 * l + 1] * C;
  const int k = fixed_exp(maxes, l, L, scl[2 * l + 1], count_bits);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const long long v = acc[off + i];
    g_table[off + i] = k == kNotFinite ? __int_as_float(0x7fc00000)
                                       : ldexpf(__ll2float_rn(v), -k);
    if (v != 0) acc[off + i] = 0;
  }
}

// the forward kernel's table rows: fp32 (K1/K2) or bf16 widened (K3)
struct Fp32Rows {
  using Elem = float;
  template <int C>
  static __device__ __forceinline__ void load(const float* __restrict__ t,
                                              uint32_t row, float v[C]) {
    load_row<C>(t, row, v);
  }
};

struct Bf16Rows {
  using Elem = uint16_t;
  template <int C>
  static __device__ __forceinline__ void load(const uint16_t* __restrict__ t,
                                              uint32_t row, float v[C]) {
    load_bf16_row<C>(t, row, v);
  }
};

// Shared memory of a K1/K2/K3 block of `pts` points, in floats (every part
// a multiple of 4 floats, so each starts 16-byte aligned). LC = L*C.
__host__ __device__ constexpr int smem_x() { return kPts * 3; }
__host__ __device__ constexpr int smem_feat(int LC, int pts = kPts) { return pts * (LC + 1); }
__host__ __device__ constexpr int smem_dfeat(int LC, int pts = kPts) { return pts * (3 * LC + 1); }

// points per lane of a forward block: 2 without the Jacobian (K2, K3: a
// block of 64 points, one barrier per 64 points, 16 corner rows in flight
// per lane), 1 with it (K1: its dfeat tile would double)
template <bool JAC>
__host__ __device__ constexpr int fwd_points_per_lane() { return JAC ? 1 : 2; }

// the block's [np, W] tile of a row-major [N, W] array, staged in shared
// memory with rows padded to W + 1, to or from device memory in
// contiguous runs: each warp copies whole rows, its lanes along the row
// (no division by the runtime width W in the loop)
__device__ __forceinline__ void tile_out(float* __restrict__ dst,
                                         const float* s, int np, int W) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < np; p += nw)
    for (int c = lane; c < W; c += 32) dst[p * W + c] = s[p * (W + 1) + c];
}

__device__ __forceinline__ void tile_in(float* s, const float* __restrict__ src,
                                        int np, int W) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < np; p += nw)
    for (int c = lane; c < W; c += 32) s[p * (W + 1) + c] = src[p * W + c];
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
// A block is PPL * 32 points x L levels, one warp per level; lane i of a
// warp takes points i, i + 32, ... of the block at its level.
template <int C, bool JAC, typename Rows = Fp32Rows>
__global__ void hash_fwd_kernel(const float* __restrict__ x,
                                const typename Rows::Elem* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                float* __restrict__ feats,
                                float* __restrict__ dfeat, int64_t N, int L,
                                float size) {
  constexpr int PPL = fwd_points_per_lane<JAC>();
  constexpr int kBlockPts = kPts * PPL;
  extern __shared__ float4 smem4[];
  const int LC = L * C;
  float* s_f = reinterpret_cast<float*>(smem4);
  float* s_d = s_f + smem_feat(LC, kBlockPts);
  const int lane = threadIdx.x & 31, l = threadIdx.x >> 5;
  const int64_t n0 = (int64_t)blockIdx.x * kBlockPts;
  const int np = (int)(N - n0 < kBlockPts ? N - n0 : kBlockPts);
  const uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
  const uint32_t res = (uint32_t)meta[4 * l + 2];
  const bool dense = meta[4 * l + 3] != 0;
  const float scale = scl[2 * l], dscale = scl[2 * l + 1];
#pragma unroll
  for (int h = 0; h < PPL; ++h) {
    const int p = lane + kPts * h;
    // the point (the L warps of the block read it from L1), or the origin
    // for a lane past the end (its outputs are never written)
    float xp[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) xp[d] = p < np ? x[(n0 + p) * 3 + d] : 0.0f;
    LevelGeom g;
    bool oob = level_geom(xp, size, scale, dscale, g);
    float acc[C], dacc[C][3];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] = 0.0f;
      dacc[c][0] = dacc[c][1] = dacc[c][2] = 0.0f;
    }
    if (p < np && !oob) {
      uint32_t rows[8];
      corner_rows(g, res, lsize, offset, dense, rows);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v[C];
        Rows::template load<C>(table, rows[k], v);
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
    // point p's row of each tile; rows padded by one float, so the 32
    // lanes of a warp store to 32 different banks
    float* fr = s_f + p * (LC + 1) + l * C;
#pragma unroll
    for (int c = 0; c < C; ++c) fr[c] = acc[c];
    if (JAC) {
      float* dr = s_d + p * (3 * LC + 1) + l * C * 3;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dr[3 * c] = dacc[c][0];
        dr[3 * c + 1] = dacc[c][1];
        dr[3 * c + 2] = dacc[c][2];
      }
    }
  }
  __syncthreads();
  tile_out(feats + n0 * LC, s_f, np, LC);
  if (JAC) tile_out(dfeat + n0 * LC * 3, s_d, np, 3 * LC);
}

// acc[row(k), c] += (g_feat[c] w_k + sum_d g_dfeat[c, d] dw_k,d) 2^k_l   (atomic)
// g_x[n, e] = sum_l sum_k sum_c v_k[c] (g_feat[c] dw_k,e + sum_d g_dfeat[c, d] h_k[d][e])
template <int C, bool JAC>
__global__ void hash_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                const float* __restrict__ g_feat,
                                const float* __restrict__ g_dfeat,
                                long long* __restrict__ acc,
                                const unsigned* __restrict__ maxes,
                                float* __restrict__ g_x, int64_t N, int L,
                                float size, int count_bits) {
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
  const int k_fix = acc != nullptr ? fixed_exp(maxes, l, L, scl[2 * l + 1], count_bits) : 0;
  // a level with non-finite cotangents adds nothing (its rows become NaN)
  long long* acc_l = k_fix == kNotFinite ? nullptr : acc;
  uint32_t rows[8];
  corner_rows(g, res, lsize, offset, dense, rows);
  float gx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t row = active ? rows[k] : kNoRow;
    float w, dw[3];
    corner_weights(g, k, w, dw);
    if (acc_l != nullptr) {
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
          add_row_fixed<C>(acc_l, row, sum, k_fix);
        }
        __syncwarp();
      } else if (row != kNoRow) {
        add_row_fixed<C>(acc_l, row, gt, k_fix);
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

// launch K1/K2/K3 kernel `kern` with one block of L warps per `pts` points
// and `floats` of dynamic shared memory (opting in above the default 48 KB)
template <typename Kernel, typename... Args>
int launch_blocks(Kernel kern, int64_t N, int L, int pts, int floats, cudaStream_t s,
                  Args... args) {
  size_t bytes = (size_t)floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned blocks = (unsigned)((N + pts - 1) / pts);
  kern<<<blocks, 32 * L, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

// the forward kernel on a fp32 (K1/K2) or bf16 (K3) table
template <int C, bool JAC, typename Rows>
int launch_fwd_rows(const float* x, const typename Rows::Elem* table, const int* meta,
                    const float* scl, float* feats, float* dfeat, int64_t N, int L,
                    float size, cudaStream_t s) {
  const int LC = L * C, pts = kPts * fwd_points_per_lane<JAC>();
  return launch_blocks(hash_fwd_kernel<C, JAC, Rows>, N, L, pts,
                       smem_feat(LC, pts) + (JAC ? smem_dfeat(LC, pts) : 0), s, x, table,
                       meta, scl, feats, dfeat, N, L, size);
}

template <int C>
int launch_fwd(const float* x, const float* table, const int* meta,
               const float* scl, float* feats, float* dfeat, int64_t N, int L,
               float size, cudaStream_t s) {
  if (dfeat != nullptr)
    return launch_fwd_rows<C, true, Fp32Rows>(x, table, meta, scl, feats, dfeat, N, L,
                                              size, s);
  return launch_fwd_rows<C, false, Fp32Rows>(x, table, meta, scl, feats, dfeat, N, L,
                                             size, s);
}

template <int C>
int launch_bf16_fwd(const float* x, const uint16_t* table, const int* meta,
                    const float* scl, float* feats, int64_t N, int L, float size,
                    cudaStream_t s) {
  return launch_fwd_rows<C, false, Bf16Rows>(x, table, meta, scl, feats, nullptr, N, L,
                                             size, s);
}

// with a table gradient: zero the maxima, take them, scatter in fixed
// point, convert and re-zero; acc is [T C + L] int64 (the last L words
// hold the 2 L maxima), its first T C words zero on entry and on exit
template <int C>
int launch_bwd(const float* x, const float* table, const int* meta,
               const float* scl, const float* g_feat, const float* g_dfeat,
               float* g_table, float* g_x, long long* acc, int64_t N, int L,
               float size, int64_t T, cudaStream_t s) {
  const int LC = L * C;
  unsigned* maxes = nullptr;
  int count_bits = 0;
  if (g_table != nullptr) {
    maxes = reinterpret_cast<unsigned*>(acc + T * C);
    while ((int64_t(1) << count_bits) < 8 * N) ++count_bits;
    cudaError_t e = cudaMemsetAsync(maxes, 0, (size_t)L * sizeof(long long), s);
    if (e != cudaSuccess) return (int)e;
    const int rows = LC >= 256 ? 1 : 256 / LC;
    const int64_t want = (N + rows - 1) / rows;
    level_max_kernel<<<(unsigned)(want < 1056 ? want : 1056), rows * LC, 0, s>>>(
        g_feat, g_dfeat, N, L, C, maxes);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {
    acc = nullptr;
  }
  const int floats = smem_x() + L * kPts * (C + 3) + smem_feat(LC);
  int rc = g_dfeat != nullptr
      ? launch_blocks(hash_bwd_kernel<C, true>, N, L, kPts, floats + smem_dfeat(LC), s, x,
                      table, meta, scl, g_feat, g_dfeat, acc, (const unsigned*)maxes, g_x,
                      N, L, size, count_bits)
      : launch_blocks(hash_bwd_kernel<C, false>, N, L, kPts, floats, s, x, table, meta, scl,
                      g_feat, g_dfeat, acc, (const unsigned*)maxes, g_x, N, L, size,
                      count_bits);
  if (rc != 0 || g_table == nullptr) return rc;
  fixed_sweep_kernel<<<dim3(264, L), 256, 0, s>>>(acc, g_table, meta, scl, maxes, L, C,
                                                   count_bits);
  return (int)cudaGetLastError();
}

}  // namespace
