// Multiresolution hash-grid encode for Hopper (sm_90a): K1, K2 and K3.
//
// K1 replaces nicer_slam_tpu/ops/hash_encoder.py hash_encode_with_grad
// (:266-375): features AND the analytic input Jacobian dfeat/dx from one
// gather. K2 replaces hash_encode (:177-263) with its big-grid variant
// _hash_encode_unified/_grid_corner_values (:601-678, :784-834): features
// only. Both share one forward and one backward kernel (hash_kernels.cuh),
// templated on the channel count C and on whether the Jacobian is
// carried, instantiated here for C in {2, 4, 8} (the shipped grids); K3
// (below) is the same forward kernel reading a bf16 table. Any L and C:
// every other C walks a level's channels in segments of CS, the largest
// divisor of C up to 8 (hash_encoder_segments*.cu; one segment of C
// channels for C < 8), and a launch covers at
// most 32 (level, segment) pairs, one warp each, the host launching the
// slices of a wider grid in turn (hash_kernels.cuh).
//
// Semantics (reference hashencoder.cu): level l has scale s_l and
// resolution r_l; u = (x + size) / (2 size); pos = u s_l; smoothstep
// weights wb = f^2 (3 - 2f) per dim; 8 corners; dense index
// x + y r + z r^2 or hashed xor(x*1, y*2654435761, z*805459861), both
// mod the level size, in uint32 arithmetic (the wrap is native here).
// Inputs outside [0,1] give zero features and zero gradients.
//
// Table layout is [T, C] fp32 (row-major: a corner's C channels are one
// row, a segment's CS channels loaded as float4, float2 or single words); the
// checkpoint files keep the JAX package's
// [C, T] and slam/checkpoint.py transposes at that boundary.
//
// What bounds K1/K2 on the card: bytes. Per (point, level) the forward
// writes C features and 3C Jacobian entries (two thirds of its bytes are
// dfeat) and gathers 8 random rows from tables of 0.5 MB (coarse) to
// 1.06 GB (color, 133M rows x 2 channels); the backward reads the same
// cotangents, gathers the rows again for grad_x and scatters 8 rows of
// gradient. The design:
//   * one vector load per corner row instead of C scalar ones;
//   * a block is 32 consecutive points x L levels, one warp per level, so a
//     warp's 32 lanes are 32 points of one level (the features-only
//     forward of K2/K3 takes 64 points, two per lane). The path's points are
//     ray-major and sorted along each ray, so neighbouring lanes often fall
//     in one cell: the backward with a table gradient sums those lanes'
//     contributions before its atomics (hash_bwd_merge_kernel, below);
//   * the block's output tiles (feats [32, L*C], dfeat [32, L*C*3]) and
//     cotangent tiles are staged in shared memory (rows padded by one
//     float against bank conflicts) and move to device memory as contiguous
//     coalesced runs; grad_x is summed over the levels in shared memory and
//     written as [N, 3];
//   * the table scatter is skipped entirely when the table needs no
//     gradient (tracking), and grad_x when the input needs none.
//   * the table gradient is summed in fixed point, so it is the same bit
//     for bit from run to run (below).
//
// The table gradient in fixed point. Float atomics sum a row's
// contributions in whatever order they land, so the gradient changed in
// its last bits from run to run, and the SLAM loop amplified that into
// other maps and poses (PERF.md §7) where the JAX package's scatter is
// deterministic. Integer adds give the same sum in any order, so the
// backward adds each of its sums as a 64-bit integer, v 2^k_l rounded to
// nearest, into a [T, C] int64 accumulator that is zero on entry, and a
// last pass writes g_table = acc 2^-k_l and sets the accumulator back to
// 0, so the caller keeps it from call to call and no pass zeroes it up
// front (for the colour grid, 2.1 GB a launch). k_l is per level, from a
// bound on the size of any contribution there: |v| <= max|g_feat| + 1.5
// dscale_l max_n sum_d |g_dfeat[n, ., d]| (|w| <= 1, |dw/dx_d| <= 1.5
// dscale_l), the maxima taken by a first pass over the cotangents; with at
// most 8 N contributions to a row, k_l = 61 - ceil(log2 8N) - e_l for a
// bound below 2^e_l keeps every row's sum below 2^61. Each sum is then off
// by at most 2^-(k_l + 1), about 2^-40 of the level's bound at the
// flagship's 802,816 points, and the integer sums are exact. A level whose
// cotangents are not finite gets a NaN gradient in every row (the JAX
// package's scatter gives NaN at the rows it touches alone).
//
// The backward with a table gradient at C = 2, 4, 8 (hash_bwd_merge_kernel;
// the other channel counts, and every launch without a table gradient,
// keep the lane-merge kernel hash_bwd_kernel). An ablation of the
// lane-merge design (tools/hash_bwd_ablate.py, PERF.md §6) showed three
// costs: the colour grid's sweep over every row (1.43 of 2.06 ms at its
// top-16 points: 3.19 GB for a few million touched rows); the 64-bit
// atomics (0.78 of 1.92 ms on the fine grid's ray-ordered points, 2.5 of
// 3.6 on uniform ones); and the lane merge's chain of a __match_any_sync,
// an __any_sync, a shared-memory round trip and a serial sum at each of
// the 8 corners: without the merge the ray-ordered cases ran 1.1-2.3x
// slower, yet the merge itself held the coarse grid's scatter at ~1.05 ms
// with its atomics at 0.04. So a warp (32 points of one level) writes its
// 8 x C contributions to shared memory and sums the lanes that share a
// cell into the first of them (the run's head), every lane on its own
// (corner, channel) column; then the warp's lanes take (head, corner,
// channel) triples, so a row's channels are adjacent lanes and its
// atomics one request (2-4x fewer requests than a lane's own row of C
// atomics). Every sum is in a fixed order and each product and sum is
// rounded as written, so ops/hash_encoder.py's hash_table_grad_fixed_plain
// reproduces the table gradient bit for bit. A merge of the vertices that
// consecutive cells share (faces, edges, corners along a ray) was built
// and measured: with atomics this cheap it cost more than it saved (PERF.md
// §6). Where a launch's 8 N L corners are fewer than the table's rows (the
// colour grid), the first atomic to each row (it finds the row 0) also
// sets the row's bit in a bitmap kept beside the accumulator, and the last
// pass
// (touched_sweep_kernel) reads the accumulator at those rows alone and
// writes every other row 0: g_table stays dense, for the optimizer, but
// the 2.1 GB read goes. The SDF grids keep the sweep over every row (0.05
// ms on the fine grid).
//
// K3 replaces hash_encode_packed (:858-905) with its pack_table_bf16_pairs
// (:849-855): the no-grad encode of the SDF grids (density-cache build,
// the exact prepass of an eval render) from tables rounded to bfloat16,
// nearest-even, as astype(bfloat16) rounds them. The TPU packs channel
// pairs into uint32 words to halve its gather count; here the table is
// [T, C] bf16, so a corner's C channels are one 16-byte (C = 8), 8-byte
// (C = 4) or 4-byte (C = 2) load, half the bytes of the fp32 [T, C]
// table's row. Values widen to float32 exactly (a bf16 is the top half of
// a float32) and the sums run in float32, in the plain version's corner
// order. Forward only: the caller holds no gradient. K3 is the K1/K2
// forward kernel with the bf16 row loader (hash_fwd_kernel<C, false,
// Bf16Rows>): a warp per level over 64 points, two per lane, the feats
// tile written as contiguous runs. An
// earlier design gave each thread one (point, level): a warp's gathers fell
// in 8 level tables at once and its C-float stores were strided by 4 C
// bytes across lanes. Measured against it in one call (H100 80GB HBM3,
// 700 W; tools/hash_kernel_ab.py, PERF.md §6): 1.5-1.8x faster on the
// coarse grid (16-byte rows) at every point order; on the fine grid
// (8-byte rows) 3 % faster on a density-cache chunk, 0.5-1.6 % slower on
// ray-ordered and uniform points. Variants that did not beat this one on
// the fine grid, timed in turns on the same card: one point per lane; the
// levels mixed within a warp (thread t on point t / L); no tile, each lane
// storing its slice of the row; four points per lane; a warp per 32 points
// over every level with a warp-private tile and no block barrier; a
// shared-memory carveout sized to full occupancy; a multiply by
// 1 / (2 size) in place of the division.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_kernels.cuh"

// K1/K2 at every C other than 2, 4, 8, and K3 at every even C other than
// those, walked in segments of CS (hash_encoder_segments.cu,
// hash_encoder_segments_bwd.cu)
extern "C" int nsl_hash_fwd_segments(const float* x, const float* table, const int* meta,
                                     const float* scl, float* feats, float* dfeat, int64_t N,
                                     int L, int C, int CS, float size, cudaStream_t s);
extern "C" int nsl_hash_bwd_segments(const float* x, const float* table, const int* meta,
                                     const float* scl, const float* g_feat,
                                     const float* g_dfeat, float* g_table, float* g_x,
                                     long long* acc, int64_t N, int L, int C, int CS,
                                     float size, int64_t T, cudaStream_t s);
extern "C" int nsl_hash_bf16_bwd_segments(const float* x, const uint16_t* table,
                                          const int* meta, const float* scl,
                                          const float* g_feat, float* g_table, float* g_x,
                                          long long* acc, int64_t N, int L, int C, int CS,
                                          float size, int64_t T, cudaStream_t s);
extern "C" int nsl_hash_bf16_segments(const float* x, const uint16_t* table, const int* meta,
                                      const float* scl, float* feats, int64_t N, int L, int C,
                                      int CS, float size, cudaStream_t s);

extern "C" {

// dfeat == NULL selects K2 (features only); otherwise K1. table is [T, C]
// fp32 with a 16-byte aligned base, any L >= 1 and C >= 1 (the wrapper
// checks).
int nsl_hash_encode_fwd(const void* x, const void* table, const void* meta,
                        const void* scl, void* feats, void* dfeat, int64_t N,
                        int L, int C, float size, void* stream) {
  if (N == 0) return 0;
  if (L < 1 || C < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return launch((const float*)x, (const float*)table, (const int*)meta,
                  (const float*)scl, (float*)feats, (float*)dfeat, N, L, C, size, s);
  };
  switch (C) {
    case 2: return args(launch_fwd<2, false>);
    case 4: return args(launch_fwd<4, false>);
    case 8: return args(launch_fwd<8, false>);
    default:
      return nsl_hash_fwd_segments((const float*)x, (const float*)table, (const int*)meta,
                                   (const float*)scl, (float*)feats, (float*)dfeat, N, L, C,
                                   segment_width(C), size, s);
  }
}

// g_dfeat == NULL selects K2. g_table [T, C] (written) and g_x ([N, 3],
// written) may each be NULL (not needed); with g_table, scratch is
// [T C + 32 + ceil(T / 64)] int64 whose first T C words (the accumulator)
// and last ceil(T / 64) (the touched-row bitmap) are zero on entry, and
// are zero again on a successful return (the caller keeps it for the next
// call).
int nsl_hash_encode_bwd(const void* x, const void* table, const void* meta,
                        const void* scl, const void* g_feat,
                        const void* g_dfeat, void* g_table, void* g_x, void* scratch,
                        int64_t N, int L, int C, float size, int64_t T, void* stream) {
  if (L < 1 || C < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (N == 0)
    return g_table == nullptr
        ? 0 : (int)cudaMemsetAsync(g_table, 0, (size_t)(T * C) * sizeof(float), s);
  if (g_table != nullptr && scratch == nullptr) return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch((const float*)x, (const float*)table, (const int*)meta,
                  (const float*)scl, (const float*)g_feat, (const float*)g_dfeat,
                  (float*)g_table, (float*)g_x, (long long*)scratch, N, L, C, size, T, s);
  };
  switch (C) {
    case 2: return args(launch_bwd<2, false>);
    case 4: return args(launch_bwd<4, false>);
    case 8: return args(launch_bwd<8, false>);
    default:
      return nsl_hash_bwd_segments((const float*)x, (const float*)table, (const int*)meta,
                                   (const float*)scl, (const float*)g_feat,
                                   (const float*)g_dfeat, (float*)g_table, (float*)g_x,
                                   (long long*)scratch, N, L, C, segment_width(C), size, T,
                                   s);
  }
}

// K3: table is [T, C] bfloat16, any even C (walked in segments of 8, 4 or
// 2 channels, the widest that divides C), 2 C bytes per row, the base
// aligned to 16 bytes, any L >= 1 (the wrapper checks)
int nsl_hash_encode_bf16_fwd(const void* x, const void* table,
                             const void* meta, const void* scl, void* feats,
                             int64_t N, int L, int C, float size,
                             void* stream) {
  if (N == 0) return 0;
  if (L < 1 || C < 2 || C % 2 != 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return launch((const float*)x, (const uint16_t*)table, (const int*)meta,
                  (const float*)scl, (float*)feats, N, L, C, size, s);
  };
  switch (C) {
    case 2: return args(launch_bf16_fwd<2, false>);
    case 4: return args(launch_bf16_fwd<4, false>);
    case 8: return args(launch_bf16_fwd<8, false>);
    default:
      return nsl_hash_bf16_segments((const float*)x, (const uint16_t*)table,
                                    (const int*)meta, (const float*)scl, (float*)feats, N, L,
                                    C, C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : 2, size, s);
  }
}

// K2's backward on a [T, C] bfloat16 table (the sharded colour encode:
// its forward is K3 on the rows the ranks all-gathered in bf16, and this
// backward reads the same rows for grad_x), any even C as K3, any L >= 1.
// g_table [T, C] fp32 and g_x [N, 3] as nsl_hash_encode_bwd, either may be
// NULL; with g_table, scratch is the same [T C + 32 + ceil(T / 64)] int64
// accumulator and bitmap, zero on entry and on a successful return. The table gradient does not
// depend on the table, so it is K2's bit for bit.
int nsl_hash_encode_bf16_bwd(const void* x, const void* table, const void* meta,
                             const void* scl, const void* g_feat, void* g_table, void* g_x,
                             void* scratch, int64_t N, int L, int C, float size, int64_t T,
                             void* stream) {
  if (L < 1 || C < 2 || C % 2 != 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (N == 0)
    return g_table == nullptr
        ? 0 : (int)cudaMemsetAsync(g_table, 0, (size_t)(T * C) * sizeof(float), s);
  if (g_table != nullptr && scratch == nullptr) return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch((const float*)x, (const uint16_t*)table, (const int*)meta,
                  (const float*)scl, (const float*)g_feat, (float*)g_table, (float*)g_x,
                  (long long*)scratch, N, L, C, size, T, s);
  };
  switch (C) {
    case 2: return args(launch_bf16_bwd<2, false>);
    case 4: return args(launch_bf16_bwd<4, false>);
    case 8: return args(launch_bf16_bwd<8, false>);
    default:
      return nsl_hash_bf16_bwd_segments((const float*)x, (const uint16_t*)table,
                                        (const int*)meta, (const float*)scl,
                                        (const float*)g_feat, (float*)g_table, (float*)g_x,
                                        (long long*)scratch, N, L, C,
                                        C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : 2, size, T, s);
  }
}

}  // extern "C"
