// The K1/K2/K3 kernels and their launch templates (the design note is at
// the top of hash_encoder.cu), shared by hash_encoder.cu, which
// instantiates them for C = 2, 4, 8 (the shipped grids' channel counts),
// and hash_encoder_segments.cu (forwards) and hash_encoder_segments_bwd.cu
// (backwards), which instantiate the segmented kernels (SEG, below) for
// every other C; the sources compile in parallel.
//
// Any level count L and channel count C. A level's C channels are walked
// in nseg = C / CS segments of CS channels, CS the largest divisor of C up
// to 8 (K3: of 8, 4 and 2, C even); a (level, segment) pair is a virtual
// level v = l nseg + s, one warp of a block, whose output columns
// v CS .. v CS + CS - 1 are the level's columns l C + s CS .. as the
// [N, L C] layout has them. A launch covers at most 32 virtual levels (a
// Slice); the host launches the slices of a grid one after another, the
// first writing grad_x and each later one adding its levels' sum to it,
// so grad_x is summed in a fixed order. Each slice's table gradient lands
// in its own rows and columns of the fixed-point accumulator. The kernels
// are templated on SEG: without it (C = 2, 4, 8) a row is CS = C channels
// wide and a warp's level is v0 + its index, with no division by the
// runtime row width; with it, the row is C wide and a level nseg >= 1
// segments (C 1, 3, 5, 6, 7 take one segment of C channels). A slice holds as many warps as the
// kernel's registers allow in one block (at most 32).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using nsl::corner_rows;
using nsl::corner_weights;
using nsl::level_geom;
using nsl::LevelGeom;

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

// The launch's share of a grid: virtual levels v0 .. v0 + nv - 1 (nv <=
// 32, a warp each) of nseg segments per level, C channels per level (the
// table's row width) and ldo = L C output columns.
struct Slice {
  int v0, nv, nseg, C, ldo;
};

// warp w's level and the first channel of its segment
template <int CS, bool SEG>
__device__ __forceinline__ void virtual_level(const Slice& sl, int w, int& l, int& c0) {
  const int v = sl.v0 + w;
  if constexpr (SEG) {
    l = v / sl.nseg;
    c0 = (v - l * sl.nseg) * CS;
  } else {
    l = v;
    c0 = 0;
  }
}

// the first word of a row's segment: row C + c0, or row CS without SEG
template <int CS, bool SEG>
__device__ __forceinline__ size_t row_word(const Slice& sl, uint32_t row, int c0) {
  if constexpr (SEG) return (size_t)row * sl.C + c0;
  return (size_t)row * CS;
}

// ---- CS fp32 channels of a row: vector load, vector store ----
// (float4 words for CS = 4, 8; float2 for CS = 2 and the other even CS;
// single floats for an odd CS). CS divides the row width C, so a segment
// starts on its word.

template <int C>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float v[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int q = 0; q < C / 2; ++q) {
      float2 a = __ldg(reinterpret_cast<const float2*>(p) + q);
      v[2 * q] = a.x;
      v[2 * q + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(p + c);
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

// the CS channels of a segment at acc + at
template <int CS>
__device__ __forceinline__ void add_row_fixed(long long* acc, size_t at, const float v[CS],
                                              int k) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(acc) + at;
#pragma unroll
  for (int c = 0; c < CS; ++c)
    atomicAdd(p + c, (unsigned long long)__float2ll_rn(ldexpf(v[c], k)));
}

// per-virtual-level maxima of |g_feat| and of sum_d |g_dfeat[., d]| over
// the slice's L = sl.nv virtual levels into maxes[2L] (zeroed), as the bits
// of non-negative floats, which order as the floats do (a NaN's above
// inf). A block is rows x LC threads (LC = L CS, the slice's columns
// from v0 CS), thread (r, col) on column col of points r, r + rows, ...
__global__ void level_max_kernel(const float* __restrict__ g_feat,
                                 const float* __restrict__ g_dfeat, int64_t N, Slice sl,
                                 int CS, unsigned* __restrict__ maxes) {
  __shared__ unsigned s_max[64];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s_max[i] = 0u;
  __syncthreads();
  const int L = sl.nv, LC = L * CS, rows = blockDim.x / LC;
  const int col = threadIdx.x % LC, r = threadIdx.x / LC;
  const int64_t col0 = (int64_t)sl.v0 * CS + col;
  unsigned a = 0u, b = 0u;
  for (int64_t n = (int64_t)blockIdx.x * rows + r; n < N; n += (int64_t)gridDim.x * rows) {
    a = max(a, __float_as_uint(fabsf(g_feat[n * sl.ldo + col0])));
    if (g_dfeat != nullptr) {
      const float* d = g_dfeat + (n * sl.ldo + col0) * 3;
      b = max(b, __float_as_uint(fabsf(d[0]) + fabsf(d[1]) + fabsf(d[2])));
    }
  }
  const int l = col / CS;
  atomicMax(&s_max[l], a);
  atomicMax(&s_max[32 + l], b);
  __syncthreads();
  if (threadIdx.x < L) {
    atomicMax(&maxes[threadIdx.x], s_max[threadIdx.x]);
    atomicMax(&maxes[L + threadIdx.x], s_max[32 + threadIdx.x]);
  }
}

// The last pass of a backward with a table gradient: g_table = acc 2^-k_v
// for every row of the level of virtual level v = v0 + blockIdx.y, in its
// segment's CS columns (NaN for a non-finite virtual level), and acc set
// back to 0 where it was not, so the accumulator is zero for the next
// call. A pass over the points that converted and re-zeroed only the
// touched rows was slower at every shape the paths give (PERF.md §6): the
// colour grid's touched rows lie at random, a 32-byte sector each, and
// the SDF grids' tables are small.
__global__ void fixed_sweep_kernel(long long* __restrict__ acc, float* __restrict__ g_table,
                                   const int* __restrict__ meta,
                                   const float* __restrict__ scl,
                                   const unsigned* __restrict__ maxes, Slice sl, int CS,
                                   int count_bits) {
  const int w = blockIdx.y, v = sl.v0 + w, l = v / sl.nseg, C = sl.C;
  const int c0 = (v - l * sl.nseg) * CS;
  const int k = fixed_exp(maxes, w, sl.nv, scl[2 * l + 1], count_bits);
  const int64_t row0 = meta[4 * l], n = (int64_t)meta[4 * l + 1] * CS;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    // one segment per level: the level's rows are one run of words
    int64_t at = row0 * C + i;
    if (sl.nseg > 1) {
      const int64_t r = i / CS;
      at = (row0 + r) * C + c0 + (i - r * CS);
    }
    const long long a = acc[at];
    g_table[at] = k == kNotFinite ? __int_as_float(0x7fc00000)
                                  : ldexpf(__ll2float_rn(a), -k);
    if (a != 0) acc[at] = 0;
  }
}

// the forward kernel's table rows: fp32 (K1/K2) or bf16 widened (K3)
// (CS channels from p)
struct Fp32Rows {
  using Elem = float;
  template <int CS>
  static __device__ __forceinline__ void load(const float* __restrict__ p, float v[CS]) {
    load_vec<CS>(p, v);
  }
};

struct Bf16Rows {
  using Elem = uint16_t;
  template <int CS>
  static __device__ __forceinline__ void load(const uint16_t* __restrict__ p, float v[CS]) {
    nsl::load_bf16_vec<CS>(p, v);
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

// the block's [np, W] tile of a row-major array whose rows are ld floats
// apart (W columns from dst / src), staged in shared memory with rows
// padded to W + 1, to or from device memory in contiguous runs: each warp
// copies whole rows, its lanes along the row (no division by the runtime
// width W in the loop)
__device__ __forceinline__ void tile_out(float* __restrict__ dst,
                                         const float* s, int np, int W, int ld) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < np; p += nw)
    for (int c = lane; c < W; c += 32) dst[p * ld + c] = s[p * (W + 1) + c];
}

__device__ __forceinline__ void tile_in(float* s, const float* __restrict__ src,
                                        int np, int W, int ld) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < np; p += nw)
    for (int c = lane; c < W; c += 32) s[p * (W + 1) + c] = src[p * ld + c];
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
// A block is PPL * 32 points x the slice's L = sl.nv virtual levels, one
// warp per virtual level (C below is its segment width CS); lane i of a
// warp takes points i, i + 32, ... of the block at its level.
template <int C, bool JAC, typename Rows, bool SEG>
__global__ void hash_fwd_kernel(const float* __restrict__ x,
                                const typename Rows::Elem* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                float* __restrict__ feats,
                                float* __restrict__ dfeat, int64_t N, Slice sl,
                                float size) {
  constexpr int PPL = fwd_points_per_lane<JAC>();
  constexpr int kBlockPts = kPts * PPL;
  extern __shared__ float4 smem4[];
  const int LC = sl.nv * C;
  float* s_f = reinterpret_cast<float*>(smem4);
  float* s_d = s_f + smem_feat(LC, kBlockPts);
  const int lane = threadIdx.x & 31, vw = threadIdx.x >> 5;
  int l, c0;
  virtual_level<C, SEG>(sl, vw, l, c0);
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
        Rows::template load<C>(table + row_word<C, SEG>(sl, rows[k], c0), v);
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
    float* fr = s_f + p * (LC + 1) + vw * C;
#pragma unroll
    for (int c = 0; c < C; ++c) fr[c] = acc[c];
    if (JAC) {
      float* dr = s_d + p * (3 * LC + 1) + vw * C * 3;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dr[3 * c] = dacc[c][0];
        dr[3 * c + 1] = dacc[c][1];
        dr[3 * c + 2] = dacc[c][2];
      }
    }
  }
  __syncthreads();
  const int64_t col0 = n0 * sl.ldo + (int64_t)sl.v0 * C;
  tile_out(feats + col0, s_f, np, LC, sl.ldo);
  if (JAC) tile_out(dfeat + col0 * 3, s_d, np, 3 * LC, 3 * sl.ldo);
}

// acc[row(k), c] += (g_feat[c] w_k + sum_d g_dfeat[c, d] dw_k,d) 2^k_v   (atomic)
// g_x[n, e] = sum_l sum_k sum_c v_k[c] (g_feat[c] dw_k,e + sum_d g_dfeat[c, d] h_k[d][e])
// over the slice's L = sl.nv virtual levels (C below is the segment width
// CS), added to g_x's earlier slices when v0 > 0
template <int C, bool JAC, bool SEG>
__global__ void hash_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                const float* __restrict__ g_feat,
                                const float* __restrict__ g_dfeat,
                                long long* __restrict__ acc,
                                const unsigned* __restrict__ maxes,
                                float* __restrict__ g_x, int64_t N, Slice sl,
                                float size, int count_bits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = sl.nv, LC = L * C;
  // s_x [32, 3] | merge scratch [L][32, C] | s_gx [L][32, 3] |
  // s_f [32, LC + 1] | s_d [32, 3 LC + 1]
  float* s_x = smem;
  float* s_m = s_x + smem_x();
  float* s_gx = s_m + L * kPts * C;
  float* s_f = s_gx + L * kPts * 3;
  float* s_d = s_f + smem_feat(LC);
  const int lane = threadIdx.x & 31, vw = threadIdx.x >> 5;
  int l, c0;
  virtual_level<C, SEG>(sl, vw, l, c0);
  const int64_t n0 = (int64_t)blockIdx.x * kPts;
  const int np = (int)(N - n0 < kPts ? N - n0 : kPts);
  const int64_t col0 = n0 * sl.ldo + (int64_t)sl.v0 * C;
  tile_in(s_f, g_feat + col0, np, LC, sl.ldo);
  if (JAC) tile_in(s_d, g_dfeat + col0 * 3, np, 3 * LC, 3 * sl.ldo);
  float xp[3];
  block_points(s_x, x, n0, np, lane, xp);   // synchronises the block

  LevelGeom g;
  bool oob = level_geom(xp, size, scl[2 * l], scl[2 * l + 1], g);
  const bool active = lane < np && !oob;
  float gf[C], gd[C][3];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gf[c] = active ? s_f[lane * (LC + 1) + vw * C + c] : 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      gd[c][d] = (JAC && active) ? s_d[lane * (3 * LC + 1) + (vw * C + c) * 3 + d] : 0.0f;
  }
  uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
  uint32_t res = (uint32_t)meta[4 * l + 2];
  bool dense = meta[4 * l + 3] != 0;
  float* s_mw = s_m + vw * kPts * C;   // this warp's merge scratch
  const int k_fix = acc != nullptr ? fixed_exp(maxes, vw, L, scl[2 * l + 1], count_bits) : 0;
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
          add_row_fixed<C>(acc_l, row_word<C, SEG>(sl, row, c0), sum, k_fix);
        }
        __syncwarp();
      } else if (row != kNoRow) {
        add_row_fixed<C>(acc_l, row_word<C, SEG>(sl, row, c0), gt, k_fix);
      }
    }
    if (g_x != nullptr && active) {
      // with a = v . g_feat and b_d = v . g_dfeat[:, d], this corner adds
      // a dw_e + sum_d b_d h[d][e] to grad_x[e]
      float v[C];
      load_vec<C>(table + row_word<C, SEG>(sl, row, c0), v);
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
    for (int e = 0; e < 3; ++e) s_gx[vw * kPts * 3 + lane * 3 + e] = gx[e];
    __syncthreads();
    for (int i = threadIdx.x; i < np * 3; i += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < L; ++q) s += s_gx[q * kPts * 3 + i];
      g_x[n0 * 3 + i] = sl.v0 > 0 ? g_x[n0 * 3 + i] + s : s;
    }
  }
}

// launch K1/K2/K3 kernel `kern` with one block of nv warps per `pts` points
// and `floats` of dynamic shared memory (opting in above the default 48 KB)
template <typename Kernel, typename... Args>
int launch_blocks(Kernel kern, int64_t N, int nv, int pts, int floats, cudaStream_t s,
                  Args... args) {
  size_t bytes = (size_t)floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned blocks = (unsigned)((N + pts - 1) / pts);
  kern<<<blocks, 32 * nv, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

// the warps of a block of `kern` that its registers allow (at most 32;
// 0 if the runtime cannot say); each launch template asks once per kernel
// (a static), not on every launch
template <typename Kernel>
int max_warps(Kernel kern) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kern) != cudaSuccess) return 0;
  return a.maxThreadsPerBlock / 32 < 32 ? a.maxThreadsPerBlock / 32 : 32;
}

// f(slice) for each launch of a grid of L levels x C channels walked in
// segments of CS: ceil(V / maxw) slices of the V = L C / CS virtual
// levels, as even as they divide, in level order
template <typename F>
int for_slices(int L, int C, int CS, int maxw, F f) {
  if (maxw < 1) return (int)cudaErrorInvalidValue;
  const int nseg = C / CS, V = L * nseg;
  const int n = (V + maxw - 1) / maxw, per = (V + n - 1) / n;
  for (int v0 = 0; v0 < V; v0 += per) {
    const Slice sl{v0, per < V - v0 ? per : V - v0, nseg, C, L * C};
    const int rc = f(sl);
    if (rc != 0) return rc;
  }
  return 0;
}

// the forward kernel on a fp32 (K1/K2) or bf16 (K3) table
template <int CS, bool JAC, typename Rows, bool SEG>
int launch_fwd_rows(const float* x, const typename Rows::Elem* table, const int* meta,
                    const float* scl, float* feats, float* dfeat, int64_t N, int L, int C,
                    float size, cudaStream_t s) {
  const int pts = kPts * fwd_points_per_lane<JAC>();
  auto kern = hash_fwd_kernel<CS, JAC, Rows, SEG>;
  static const int maxw = max_warps(kern);
  return for_slices(L, C, CS, maxw, [&](const Slice& sl) {
    const int LC = sl.nv * CS;
    return launch_blocks(kern, N, sl.nv, pts,
                         smem_feat(LC, pts) + (JAC ? smem_dfeat(LC, pts) : 0), s, x, table,
                         meta, scl, feats, dfeat, N, sl, size);
  });
}

template <int CS, bool SEG>
int launch_fwd(const float* x, const float* table, const int* meta,
               const float* scl, float* feats, float* dfeat, int64_t N, int L, int C,
               float size, cudaStream_t s) {
  if (dfeat != nullptr)
    return launch_fwd_rows<CS, true, Fp32Rows, SEG>(x, table, meta, scl, feats, dfeat, N, L,
                                                    C, size, s);
  return launch_fwd_rows<CS, false, Fp32Rows, SEG>(x, table, meta, scl, feats, dfeat, N, L,
                                                   C, size, s);
}

template <int CS, bool SEG>
int launch_bf16_fwd(const float* x, const uint16_t* table, const int* meta,
                    const float* scl, float* feats, int64_t N, int L, int C, float size,
                    cudaStream_t s) {
  return launch_fwd_rows<CS, false, Bf16Rows, SEG>(x, table, meta, scl, feats, nullptr, N,
                                                   L, C, size, s);
}

// with a table gradient, per slice: zero the maxima, take them, scatter
// in fixed point, convert and re-zero the slice's rows and columns; acc
// is [T C + 32] int64 (the last 32 words hold a slice's 2 nv <= 64
// maxima), its first T C words zero on entry and on exit
template <int CS, bool SEG>
int launch_bwd(const float* x, const float* table, const int* meta,
               const float* scl, const float* g_feat, const float* g_dfeat,
               float* g_table, float* g_x, long long* acc, int64_t N, int L, int C,
               float size, int64_t T, cudaStream_t s) {
  unsigned* maxes = nullptr;
  int count_bits = 0;
  if (g_table != nullptr) {
    maxes = reinterpret_cast<unsigned*>(acc + T * C);
    while ((int64_t(1) << count_bits) < 8 * N) ++count_bits;
  } else {
    acc = nullptr;
  }
  const bool jac = g_dfeat != nullptr;
  auto kern = jac ? hash_bwd_kernel<CS, true, SEG> : hash_bwd_kernel<CS, false, SEG>;
  static const int maxw_jac = max_warps(hash_bwd_kernel<CS, true, SEG>);
  static const int maxw = max_warps(hash_bwd_kernel<CS, false, SEG>);
  return for_slices(L, C, CS, jac ? maxw_jac : maxw, [&](const Slice& sl) {
    const int LC = sl.nv * CS;
    if (g_table != nullptr) {
      cudaError_t e = cudaMemsetAsync(maxes, 0, (size_t)sl.nv * sizeof(long long), s);
      if (e != cudaSuccess) return (int)e;
      const int rows = LC >= 256 ? 1 : 256 / LC;
      const int64_t want = (N + rows - 1) / rows;
      level_max_kernel<<<(unsigned)(want < 1056 ? want : 1056), rows * LC, 0, s>>>(
          g_feat, g_dfeat, N, sl, CS, maxes);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    const int floats = smem_x() + sl.nv * kPts * (CS + 3) + smem_feat(LC) +
                       (jac ? smem_dfeat(LC) : 0);
    const int rc = launch_blocks(kern, N, sl.nv, kPts, floats, s, x, table, meta, scl, g_feat,
                                 g_dfeat, acc, (const unsigned*)maxes, g_x, N, sl, size,
                                 count_bits);
    if (rc != 0 || g_table == nullptr) return rc;
    fixed_sweep_kernel<<<dim3(264, sl.nv), 256, 0, s>>>(acc, g_table, meta, scl, maxes, sl,
                                                         CS, count_bits);
    return (int)cudaGetLastError();
  });
}

// CS for K1/K2: the largest divisor of C up to 8
inline int segment_width(int C) {
  int cs = 8;
  while (C % cs != 0) --cs;
  return cs;
}

}  // namespace
