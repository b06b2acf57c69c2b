// The K1/K2/K3 kernels and their launch templates (the design note is at
// the top of hash_encoder.cu), shared by hash_encoder.cu, which
// instantiates them for C = 2, 4, 8 (the shipped grids' channel counts),
// and hash_encoder_segments.cu (forwards) and hash_encoder_segments_bwd.cu
// (backwards), which instantiate the segmented kernels (SEG, below) for
// every other C; the sources compile in parallel.
//
// Any level count L and channel count C. A level's C channels are walked
// in nseg = C / CS segments of CS channels, CS the largest divisor of C up
// to 8 in the forwards (K3 and the backwards: 8, 4 or 2 for an even C,
// bwd_segment_width); a (level, segment) pair is a virtual
// level v = l nseg + s, one warp of a block, whose output columns
// v CS .. v CS + CS - 1 are the level's columns l C + s CS .. as the
// [N, L C] layout has them. A launch covers at most 32 virtual levels (a
// Slice); the host launches the slices of a grid one after another, the
// first writing grad_x and each later one adding its levels' sum to it,
// so grad_x is summed in a fixed order. Each slice's table gradient lands
// in its own rows and columns of the fixed-point accumulator; the maxima
// pass before the first slice and the sweep after the last run once a
// grid, so every segment of a level takes the level's one exponent. The
// kernels are templated on SEG: without it (C = 2, 4, 8) a row is CS = C
// channels wide and a warp's level is v0 + its index, with no division by
// the runtime row width; with it, the row is C wide and a level nseg >= 1
// segments (C 1, 3, 5, 6, 7 take one segment of C channels). A slice holds
// as many warps as the kernel's registers and shared memory allow in one
// block (at most 32).

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

// C floats at p (shared memory or a [., C] row in device memory, aligned
// to the row's word)
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

// int64 words between the accumulator and the touched-row bitmap in the
// scratch: the 2 L level maxima (uint32 each), at least 32 words
__host__ __device__ constexpr int64_t maxima_words(int L) { return L > 32 ? L : 32; }

// k_l from level l's maxima (float bits: maxes[2 l] = max|g_feat|,
// maxes[2 l + 1] = max sum_d |g_dfeat[., d]|, over every channel of the
// level) and count_bits = ceil(log2 8N); each step rounded as written (no
// contraction), as the plain version (ops/hash_encoder.py,
// hash_table_grad_fixed_plain) computes it
__device__ __forceinline__ int fixed_exp(const unsigned* __restrict__ maxes, int l,
                                         float dscale, int count_bits) {
  const float bound = __fadd_rn(__uint_as_float(maxes[2 * l]),
                                __fmul_rn(__fmul_rn(1.5f, fabsf(dscale)),
                                          __uint_as_float(maxes[2 * l + 1])));
  if (!isfinite(bound)) return kNotFinite;
  if (bound == 0.0f) return 0;
  int e;
  frexpf(bound, &e);   // bound < 2^e
  return 61 - count_bits - e;
}

// Per-level maxima of |g_feat| and of sum_d |g_dfeat[., d]| over all L C
// columns of a grid (every segment of a level) into maxes[2 L] (zero on
// entry), as the bits of non-negative floats, which order as the floats do
// (a NaN's above inf). A block covers W = min(L C, blockDim.x) columns on
// blockDim.x / W point rows at once: thread (r, col) takes columns col,
// col + W, ... of points r, r + rows, ...; the block's maxima meet in
// shared memory (2 L words), then one atomicMax each.
__global__ void level_max_kernel(const float* __restrict__ g_feat,
                                 const float* __restrict__ g_dfeat, int64_t N, int L, int C,
                                 unsigned* __restrict__ maxes) {
  extern __shared__ unsigned s_max[];
  for (int i = threadIdx.x; i < 2 * L; i += blockDim.x) s_max[i] = 0u;
  __syncthreads();
  const int LC = L * C, W = LC < (int)blockDim.x ? LC : (int)blockDim.x;
  const int rows = blockDim.x / W, col = threadIdx.x % W, r = threadIdx.x / W;
  if (r < rows) {
    for (int c = col; c < LC; c += W) {
      unsigned a = 0u, b = 0u;
      for (int64_t n = (int64_t)blockIdx.x * rows + r; n < N; n += (int64_t)gridDim.x * rows) {
        a = max(a, __float_as_uint(fabsf(g_feat[n * LC + c])));
        if (g_dfeat != nullptr) {
          const float* d = g_dfeat + (n * LC + c) * 3;
          b = max(b, __float_as_uint(fabsf(d[0]) + fabsf(d[1]) + fabsf(d[2])));
        }
      }
      const int l = c / C;
      atomicMax(&s_max[2 * l], a);
      atomicMax(&s_max[2 * l + 1], b);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * L; i += blockDim.x) atomicMax(&maxes[i], s_max[i]);
}

// The last pass of a backward with a table gradient over every row: g_table
// = acc 2^-k_l in every row and column of level l = blockIdx.y (NaN for a
// non-finite level), and acc set back to 0 where it was not, so the
// accumulator is zero for the next call. The SDF grids' tables are small
// (0.05 ms for the fine grid's 2.3 M rows); the colour grid's 133 M rows
// take touched_sweep_kernel instead.
__global__ void fixed_sweep_kernel(long long* __restrict__ acc, float* __restrict__ g_table,
                                   const int* __restrict__ meta,
                                   const float* __restrict__ scl,
                                   const unsigned* __restrict__ maxes, int C, int count_bits) {
  const int l = blockIdx.y;
  const int k = fixed_exp(maxes, l, scl[2 * l + 1], count_bits);
  // the level's rows are one run of words
  const int64_t at0 = (int64_t)meta[4 * l] * C, n = (int64_t)meta[4 * l + 1] * C;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t at = at0 + i;
    const long long a = acc[at];
    g_table[at] = k == kNotFinite ? __int_as_float(0x7fc00000)
                                  : ldexpf(__ll2float_rn(a), -k);
    if (a != 0) acc[at] = 0;
  }
}

// The last pass where the scatter marked the rows it touched (bit r of
// the bitmap `touched`, set by hash_bwd_merge_kernel's first segment of a
// level), over level l = blockIdx.y: a warp loads 32 words of the bitmap
// at once, a lane each, then walks their 32 rows in turn, lane i on row
// 32 w + i. A touched row gets acc 2^-k_l in all its C columns (its nseg
// segments of CS) and its acc words set back to 0; every other row of the
// level is written 0 (NaN in every row of a non-finite level), so g_table
// is whole for the optimizer; then the word's bits of this level are
// cleared (a word at a level's edge is shared with the next level:
// atomicAnd). The colour grid's 1.06 GB of g_table is written once and its
// 2.1 GB accumulator is read only where touched.
template <int CS, bool SEG>
__global__ void touched_sweep_kernel(long long* __restrict__ acc, float* __restrict__ g_table,
                                     unsigned* __restrict__ touched,
                                     const int* __restrict__ meta, const float* __restrict__ scl,
                                     const unsigned* __restrict__ maxes, int C,
                                     int count_bits) {
  const int l = blockIdx.y;
  const int k = fixed_exp(maxes, l, scl[2 * l + 1], count_bits);
  // the row's width and its segments (one of CS = C channels without SEG)
  const int W = SEG ? C : CS, nseg = SEG ? C / CS : 1;
  const int64_t row0 = meta[4 * l], row1 = row0 + meta[4 * l + 1];
  const int64_t wd1 = (row1 + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t base = (row0 >> 5) +
                      32 * ((int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
       base < wd1; base += 32 * warps) {
    // lane i: word base + i, whose bits of this level it clears (a word at
    // a level's edge is shared with the next level: atomicAnd)
    const int64_t my = base + lane;
    const unsigned bits = my < wd1 ? touched[my] : 0u;
    if (bits != 0) {
      const int lo = (int)(row0 > my * 32 ? row0 - my * 32 : 0);
      const int hi = (int)(row1 < my * 32 + 32 ? row1 - my * 32 : 32);
      const unsigned mask = hi - lo == 32 ? ~0u : ((1u << (hi - lo)) - 1u) << lo;
      if (mask == ~0u)
        touched[my] = 0u;
      else if (bits & mask)
        atomicAnd(touched + my, ~mask);
    }
    const int nw = (int)(wd1 - base < 32 ? wd1 - base : 32);
    for (int t = 0; t < nw; ++t) {
      const unsigned b = __shfl_sync(0xffffffffu, bits, t);
      const int64_t r = (base + t) * 32 + lane;
      if (r < row0 || r >= row1) continue;
      for (int sg = 0; sg < nseg; ++sg) {
        const int64_t at = r * W + sg * CS;
        float v[CS];
        if (k == kNotFinite) {
#pragma unroll
          for (int c = 0; c < CS; ++c) v[c] = __int_as_float(0x7fc00000);
        } else if ((b >> lane) & 1u) {
          if constexpr (CS % 2 == 0) {
            // CS even: C even too, so the segment starts on a 16-byte word
            longlong2* a = reinterpret_cast<longlong2*>(acc + at);
#pragma unroll
            for (int q = 0; q < CS / 2; ++q) {
              const longlong2 s = a[q];
              v[2 * q] = ldexpf(__ll2float_rn(s.x), -k);
              v[2 * q + 1] = ldexpf(__ll2float_rn(s.y), -k);
              a[q] = make_longlong2(0, 0);
            }
          } else {
#pragma unroll
            for (int c = 0; c < CS; ++c) {
              v[c] = ldexpf(__ll2float_rn(acc[at + c]), -k);
              acc[at + c] = 0;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < CS; ++c) v[c] = 0.0f;
        }
        store_vec<CS>(g_table + at, v);
      }
    }
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

// g_x[n, e] = sum_l sum_k sum_c v_k[c] (g_feat[c] dw_k,e + sum_d g_dfeat[c, d] h_k[d][e])
// over the slice's L = sl.nv virtual levels (C below is the segment width
// CS), added to g_x's earlier slices when v0 > 0: the backward without a
// table gradient (tracking; the table gradient is hash_bwd_merge_kernel's).
// The corner rows v_k come from a fp32 table (K1/K2) or a bf16 one widened
// (Bf16Rows: the backward of the sharded colour encode, whose forward is K3
// on the gathered bf16 rows).
template <int C, bool JAC, typename Rows, bool SEG>
__global__ void hash_bwd_kernel(const float* __restrict__ x,
                                const typename Rows::Elem* __restrict__ table,
                                const int* __restrict__ meta,
                                const float* __restrict__ scl,
                                const float* __restrict__ g_feat,
                                const float* __restrict__ g_dfeat,
                                float* __restrict__ g_x, int64_t N, Slice sl, float size) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = sl.nv, LC = L * C;
  // s_x [32, 3] | s_gx [L][32, 3] | s_f [32, LC + 1] | s_d [32, 3 LC + 1]
  float* s_x = smem;
  float* s_gx = s_x + smem_x();
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
  uint32_t rows[8];
  corner_rows(g, res, lsize, offset, dense, rows);
  float gx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float w, dw[3];
    corner_weights(g, k, w, dw);
    if (active) {
      // with a = v . g_feat and b_d = v . g_dfeat[:, d], this corner adds
      // a dw_e + sum_d b_d h[d][e] to grad_x[e]
      float v[C];
      Rows::template load<C>(table + row_word<C, SEG>(sl, rows[k], c0), v);
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

// ---- the backward with a table gradient, at every C ----

// a merge warp's row of contributions, 8 corners x C floats (C the segment
// width), padded to an odd count of the vector words that store_vec<C>
// writes, so that the 32 lanes' stores of one corner fall in distinct
// banks
template <int C>
__host__ __device__ constexpr int merge_row() {
  return 8 * C + (C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1);
}

// Shared memory of a merge block, in floats: s_x | s_gx [L][32, 3] |
// heads [L][32] | the heads' corner rows [L][32, 8] | the cotangent
// tiles, and after they are read, the contributions [L][32, merge_row]
template <int C, bool JAC>
__host__ __device__ constexpr int merge_smem(int L) {
  return smem_x() + L * kPts * 12 +
         (smem_feat(L * C) + (JAC ? smem_dfeat(L * C) : 0) > L * kPts * merge_row<C>()
              ? smem_feat(L * C) + (JAC ? smem_dfeat(L * C) : 0)
              : L * kPts * merge_row<C>());
}

// warps a block of the merge kernel holds at most: 16 (164 KB of shared
// memory at 8-channel segments); a 40 x 2 grid ran 15-26 % faster in
// blocks of 14 warps than of 20, which the kernel's 56 registers allow
// one of an SM (PERF.md §6)
constexpr int kMergeWarps = 16;

// v 2^k to the nearest 64-bit integer: a product by 2^k where that is a
// normal float (exact, as ldexpf is), else ldexpf
__device__ __forceinline__ long long to_fixed(float v, int k, float pow2k) {
  return __float2ll_rn(pow2k != 0.0f ? __fmul_rn(v, pow2k) : ldexpf(v, k));
}

// The backward with a table gradient (every C): grad_x as hash_bwd_kernel,
// and each warp's contributions merged by cell before the 64-bit atomics.
// A block is 32 points x the slice's L virtual levels, a warp a (level,
// segment) pair (lane = point), as the forward; C below is the segment
// width CS, a row C channels wide without SEG and sl.C with it.
//   1. Each lane writes its point's 8 corners x C contributions (g_feat w +
//      sum_d g_dfeat_d dw_d, each product and sum rounded as written) to
//      the warp's rows in shared memory, which reuse the cotangent tiles'
//      space once every warp has read its cotangents.
//   2. Runs: lanes in one cell as the lane before (ray-ordered points on a
//      coarse level) are summed in lane order into the run's first lane,
//      the head, each lane of the warp on its own (corner, channel) column.
//   3. Lane t of the warp takes (head, corner, channel) t of a pass, so a
//      segment's C channels of a row are adjacent lanes, one sector's
//      atomics in one request; each sum becomes one fixed-point atomic at
//      the level's exponent (one a level, over all its segments).
// With `touched`, a row's channel-0 lane of the level's first segment whose
// atomic finds the row 0 (the first add to it does) also sets the row's
// bit for touched_sweep_kernel (every segment of a level touches the same
// rows); an atomicOr from every row instead ran 5-30 % slower on the
// colour grid (PERF.md §6). Every sum is in a fixed order and each rounds
// once, so the table gradient repeats bit for bit, and does not depend on
// the segment width; hash_table_grad_fixed_plain in ops/hash_encoder.py is
// the same arithmetic in torch. A non-finite level adds nothing.
template <int C, bool JAC, typename Rows, bool SEG>
__global__ void hash_bwd_merge_kernel(const float* __restrict__ x,
                                      const typename Rows::Elem* __restrict__ table,
                                      const int* __restrict__ meta,
                                      const float* __restrict__ scl,
                                      const float* __restrict__ g_feat,
                                      const float* __restrict__ g_dfeat,
                                      long long* __restrict__ acc,
                                      unsigned* __restrict__ touched,
                                      const unsigned* __restrict__ maxes,
                                      float* __restrict__ g_x, int64_t N, Slice sl,
                                      float size, int count_bits) {
  constexpr int S = 8 * C, SP = merge_row<C>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = sl.nv, LC = L * C;
  float* s_x = smem;
  float* s_gx = s_x + smem_x();
  int* s_head = reinterpret_cast<int*>(s_gx + L * kPts * 3);
  uint32_t* s_row = reinterpret_cast<uint32_t*>(s_head + L * kPts);
  float* s_f = reinterpret_cast<float*>(s_row + L * kPts * 8);
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
  const bool oob = level_geom(xp, size, scl[2 * l], scl[2 * l + 1], g);
  const bool active = lane < np && !oob;
  float gf[C], gd[C][3];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gf[c] = active ? s_f[lane * (LC + 1) + vw * C + c] : 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      gd[c][d] = (JAC && active) ? s_d[lane * (3 * LC + 1) + (vw * C + c) * 3 + d] : 0.0f;
  }
  const uint32_t offset = (uint32_t)meta[4 * l], lsize = (uint32_t)meta[4 * l + 1];
  const uint32_t res = (uint32_t)meta[4 * l + 2];
  const bool dense = meta[4 * l + 3] != 0;
  const int k_fix = fixed_exp(maxes, l, scl[2 * l + 1], count_bits);
  const bool merge = k_fix != kNotFinite;   // else the level adds nothing (its rows become NaN)
  const float pow2k = k_fix >= -126 && k_fix <= 127 ? __int_as_float((k_fix + 127) << 23) : 0.0f;
  __syncthreads();   // every warp holds its cotangents: the tiles' space is free
  float* s_v = s_f + vw * kPts * SP;   // this warp's contribution rows
  uint32_t rows[8];
  corner_rows(g, res, lsize, offset, dense, rows);
  float gx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float w, dw[3];
    corner_weights(g, k, w, dw);
    if (merge) {
      float t[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        t[c] = __fmul_rn(gf[c], w);
        if (JAC) {
          t[c] = __fadd_rn(t[c], __fmul_rn(gd[c][0], dw[0]));
          t[c] = __fadd_rn(t[c], __fmul_rn(gd[c][1], dw[1]));
          t[c] = __fadd_rn(t[c], __fmul_rn(gd[c][2], dw[2]));
        }
      }
      store_vec<C>(s_v + lane * SP + k * C, t);
    }
    if (g_x != nullptr && active) {
      float v[C];
      Rows::template load<C>(table + row_word<C, SEG>(sl, rows[k], c0), v);
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
  if (merge) {
    uint32_t* hrow = s_row + vw * kPts * 8;
    const unsigned A = __ballot_sync(0xffffffffu, active);
    const uint32_t p0 = __shfl_up_sync(0xffffffffu, g.left[0], 1);
    const uint32_t p1 = __shfl_up_sync(0xffffffffu, g.left[1], 1);
    const uint32_t p2 = __shfl_up_sync(0xffffffffu, g.left[2], 1);
    const bool same = lane > 0 && ((A >> (lane - 1)) & 1u) && p0 == g.left[0] &&
                      p1 == g.left[1] && p2 == g.left[2];
    const unsigned H = __ballot_sync(0xffffffffu, active && !same);
    const unsigned runs = H & (__ballot_sync(0xffffffffu, same) >> 1);   // heads of 2+ lanes
    const int nh = __popc(H);
    int* heads = s_head + vw * kPts;
    if (active && !same) {
      // the head's slot in order: its lane and its 8 corner rows
      const int i = __popc(H & ((1u << lane) - 1u));
      heads[i] = lane;
      uint4* r = reinterpret_cast<uint4*>(hrow + i * 8);
      r[0] = make_uint4(rows[0], rows[1], rows[2], rows[3]);
      r[1] = make_uint4(rows[4], rows[5], rows[6], rows[7]);
    }
    __syncwarp();
    // 2. each run of more than one lane into its head, in lane order
    for (unsigned m = runs; m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const unsigned stop = (H | ~A) & (j == 31 ? 0u : ~0u << (j + 1));
      const int e = stop != 0 ? __ffs(stop) - 1 : 32;
      for (int o = lane; o < S; o += 32) {
        float s = s_v[j * SP + o];
        for (int p = j + 1; p < e; ++p) s = __fadd_rn(s, s_v[p * SP + o]);
        s_v[j * SP + o] = s;
      }
    }
    __syncwarp();
    // 3. each (head, corner, channel) sum: one fixed-point atomic, a
    // segment's C channels of a row on adjacent lanes
    for (int o = lane; o < nh * S; o += 32) {
      const int i = o / S, slot = o - i * S, k = slot / C, c = slot - k * C;
      const uint32_t row = hrow[i * 8 + k];
      const unsigned long long q =
          (unsigned long long)to_fixed(s_v[heads[i] * SP + slot], k_fix, pow2k);
      unsigned long long* p =
          reinterpret_cast<unsigned long long*>(acc) + row_word<C, SEG>(sl, row, c0) + c;
      if (touched != nullptr) {
        // the first add to a row finds it 0 (so may a later one: no harm)
        if (atomicAdd(p, q) == 0ull && c == 0 && c0 == 0)
          atomicOr(touched + (row >> 5), 1u << (row & 31));
      } else {
        atomicAdd(p, q);
      }
    }
  }
  if (g_x != nullptr) {
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

// the grid's per-level maxima (zero on entry) for the fixed-point
// exponents: one pass over all L C columns of the cotangents; the block's
// 2 L words of shared memory hold up to kMaxGradLevels levels
constexpr int kMaxGradLevels = 6144;

inline int launch_level_max(const float* g_feat, const float* g_dfeat, int64_t N, int L,
                            int C, unsigned* maxes, cudaStream_t s) {
  if (L > kMaxGradLevels) return (int)cudaErrorInvalidValue;
  const int LC = L * C, rows = LC >= 256 ? 1 : 256 / LC;
  const size_t bytes = 2 * (size_t)L * sizeof(unsigned);
  const int64_t want = (N + rows - 1) / rows;
  level_max_kernel<<<(unsigned)(want < 1056 ? want : 1056), LC >= 256 ? 256 : rows * LC, bytes,
                     s>>>(g_feat, g_dfeat, N, L, C, maxes);
  return (int)cudaGetLastError();
}

// With a table gradient: take the grid's maxima, scatter in fixed point
// slice by slice (hash_bwd_merge_kernel), convert and re-zero every row
// in one last pass, then zero the maxima. acc is [T C + maxima_words(L) +
// ceil(T / 64)] int64: the accumulator, the 2 L level maxima, the
// touched-row bitmap, all zero on entry and on exit. Where the 8 N L
// corners are fewer than the T rows (the colour grid) the scatter marks
// the rows it touches and the last pass sweeps those alone. Without a
// table gradient (tracking) only hash_bwd_kernel runs, for grad_x. Rows:
// the table's rows, fp32 (K1/K2) or bf16 (the sharded colour encode,
// without the Jacobian)
template <int CS, bool JAC, typename Rows, bool SEG>
int launch_bwd_rows(const float* x, const typename Rows::Elem* table, const int* meta,
                    const float* scl, const float* g_feat, const float* g_dfeat,
                    float* g_table, float* g_x, long long* acc, int64_t N, int L, int C,
                    float size, int64_t T, cudaStream_t s) {
  if (g_table == nullptr) {
    if (g_x == nullptr) return 0;
    auto kern = hash_bwd_kernel<CS, JAC, Rows, SEG>;
    static const int maxw = max_warps(kern);
    return for_slices(L, C, CS, maxw, [&](const Slice& sl) {
      const int LC = sl.nv * CS;
      return launch_blocks(kern, N, sl.nv, kPts,
                           smem_x() + sl.nv * kPts * 3 + smem_feat(LC) +
                               (JAC ? smem_dfeat(LC) : 0),
                           s, x, table, meta, scl, g_feat, g_dfeat, g_x, N, sl, size);
    });
  }
  int count_bits = 0;
  while ((int64_t(1) << count_bits) < 8 * N) ++count_bits;
  unsigned* maxes = reinterpret_cast<unsigned*>(acc + T * C);
  unsigned* touched =
      8 * N * L < T ? reinterpret_cast<unsigned*>(acc + T * C + maxima_words(L)) : nullptr;
  int rc = launch_level_max(g_feat, g_dfeat, N, L, C, maxes, s);
  if (rc != 0) return rc;
  auto mkern = hash_bwd_merge_kernel<CS, JAC, Rows, SEG>;
  static const int mw = max_warps(mkern) < kMergeWarps ? max_warps(mkern) : kMergeWarps;
  rc = for_slices(L, C, CS, mw, [&](const Slice& sl) {
    return launch_blocks(mkern, N, sl.nv, kPts, merge_smem<CS, JAC>(sl.nv), s, x, table, meta,
                         scl, g_feat, g_dfeat, acc, touched, (const unsigned*)maxes, g_x, N, sl,
                         size, count_bits);
  });
  if (rc != 0) return rc;
  if (touched != nullptr)
    touched_sweep_kernel<CS, SEG><<<dim3(264, L), 256, 0, s>>>(acc, g_table, touched, meta, scl,
                                                              maxes, C, count_bits);
  else
    fixed_sweep_kernel<<<dim3(264, L), 256, 0, s>>>(acc, g_table, meta, scl, maxes, C,
                                                     count_bits);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return (int)cudaMemsetAsync(maxes, 0, 2 * (size_t)L * sizeof(unsigned), s);
}

template <int CS, bool SEG>
int launch_bwd(const float* x, const float* table, const int* meta,
               const float* scl, const float* g_feat, const float* g_dfeat,
               float* g_table, float* g_x, long long* acc, int64_t N, int L, int C,
               float size, int64_t T, cudaStream_t s) {
  auto launch = g_dfeat != nullptr ? launch_bwd_rows<CS, true, Fp32Rows, SEG>
                                   : launch_bwd_rows<CS, false, Fp32Rows, SEG>;
  return launch(x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, acc, N, L, C, size, T, s);
}

// K2's backward on bf16 rows: the sharded colour encode's backward
template <int CS, bool SEG>
int launch_bf16_bwd(const float* x, const uint16_t* table, const int* meta,
                    const float* scl, const float* g_feat, float* g_table, float* g_x,
                    long long* acc, int64_t N, int L, int C, float size, int64_t T,
                    cudaStream_t s) {
  return launch_bwd_rows<CS, false, Bf16Rows, SEG>(x, table, meta, scl, g_feat, nullptr,
                                                   g_table, g_x, acc, N, L, C, size, T, s);
}

// CS for the K1/K2 forwards: the largest divisor of C up to 8
inline int segment_width(int C) {
  int cs = 8;
  while (C % cs != 0) --cs;
  return cs;
}

// CS for the backwards (and K3): 8, 4 or 2 for an even C, the largest
// divisor up to 7 for an odd one. A segment of 6 channels took a block's
// shared memory for one block an SM and ran the 8 x 12 grid's backwards
// 1.9-2.2x slower than three of 4 (PERF.md §6); the table gradient does
// not depend on CS.
inline int bwd_segment_width(int C) {
  return C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : segment_width(C);
}

}  // namespace
