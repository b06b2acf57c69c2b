// SDF to prepass density in one kernel for Hopper (sm_90a): K6.
//
// Replaces the density-cache build of nicer_slam_tpu/models/scene_model.py
// build_density_cache (:108-143) and the exact prepass of an eval render
// or, with prepass_mode = exact, of every training iteration (:238-287:
// sdf_prepass + density_prepass inside importance_z_vals), which
// compute, per point x:
//   sdf     = coarse_mlp([x, PE6(x), K3_coarse(x)])[0]
//           + fine_mlp([x, PE6(x), K3_fine(x)])[0]
//             (hidden layers softplus beta 100, threshold 20; the grids
//             from tables rounded to bfloat16; only row 0, the SDF, of each
//             last layer);
//   beta    = the voxel counter's beta at x (K7's read), or the learned
//             scalar beta, times beta_scale when given;
//   density = (1 / beta)(0.5 + 0.5 sign(sdf) expm1(-|sdf| / beta)).
// Two entry modes share the body: the grid (every point of the
// linspace(-1, 1, res)^3 grid, flat index (i res + j) res + k at
// (xs[i], xs[j], xs[k]), xs the caller's linspace tensor) and rays (point
// r S + s at o_r + z_rs d_r, rounded as torch rounds that expression).
//
// What bounds it on the card: operations. Per point ~35.9 k (the two MLPs'
// 17.4 k multiply-adds, 96 corner rows, 36 sines and cosines, 256 softplus)
// against ~16 bytes in and 4 out, so it is designed as a small SGEMM
// chain on the CUDA cores, not as the elementwise chain it replaces
// (K3 twice, two cuBLAS MLPs of which the last layer computed 65 columns
// for the one used, K7's read, ~6 elementwise launches, 16 chunks):
//   * persistent blocks, one per SM (217 KB of shared memory, opted in):
//     each loads the packed effective weights (17,672 floats, 70.7 KB, in
//     the order ops/sdf_density.pack_sdf_weights lays out) once and walks
//     over tiles of 256 points;
//   * a tile's inputs [x, PE, grid features] go to shared memory
//     transposed, one row per input column, rows 260 floats apart: the
//     coarse grid's features first, then, after the coarse network has
//     read them, the fine grid's in the same rows; the grid features come
//     from the bf16 row loader and geometry that K3 uses
//     (hash_grid.cuh), a warp per level over 32 consecutive points;
//   * each hidden layer is a register-blocked product: thread (og, pg)
//     of 512 holds 8 points (pg 8 + i) x 4 units (og + 16 j) and per input
//     column reads two float4 of the inputs (a broadcast in each half
//     warp) and one float4 of the weights, which the packer laid out so
//     that a thread's 4 units are adjacent; 32 fused multiply-adds per 3
//     loads. A layer's output goes to the other buffer in natural unit
//     order; the row stride of 260 floats (65 float4) puts the 8 threads
//     of each quarter warp's float4 stores in 8 different bank groups;
//   * only row 0 of each last layer: 64 multiply-adds per point (not 64 x
//     65), summed in float64 over each thread's 4 units and across the 16
//     lanes of its half warp; the coarse and fine SDF rows and their sum
//     stay in float64 until the one rounding to float32. The density
//     amplifies SDF rounding by ~1/(2 beta) ~ 35 relative to its largest
//     value; with these sums in float64 the kernel's density is 3.4-3.9e-6
//     of its largest value from a float64 evaluation, the plain version's
//     1.2-1.4e-5 (chip_smoke.py, flagship networks), so their difference
//     stays inside the 2e-5 that the plain version's own rounding needs;
//   * softplus as max(v, 0) + log(1 + exp(-100 |v|)) / 100 through the
//     MUFU's ex2/lg2: the logarithm's term is below 0.7, so its absolute
//     error (~2e-7) is ~2e-9 in the activation, and the threshold test is
//     the plain version's (100 v > 20 gives v);
//   * beta (K7's read, voxel_grid.cuh) and the Laplace density per point,
//     each product, quotient and sum rounded as the plain version rounds
//     them; one float written per point, coalesced.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3,
// PERF.md §6): 2.72 ms for the 128^3 cache (41 % of its 1.12 ms operation
// bound; the composition it replaces took 21-23 ms), 1.89 ms for a
// 2580 x 640 render chunk (47 % of 0.88 ms); 96 registers, no spills.
// The gather loop unrolled by 2 or fully (more corner rows in flight)
// timed within 1 % of this one (tools/sdf_density_ab.py), which suggests
// that the MLPs' instruction issue, not the gathers' latency, sets the
// time.
// Float32 FMAs on the CUDA cores throughout: TF32 or bf16 tensor cores
// would not hold the density's 2e-5 of its largest value. The kernel above
// serves the one SDF network every shipped configuration uses (coarse 71
// -> 64 -> 65 on a 4 x 8 grid, fine 71 -> 64 -> 64 -> 64 -> 65 on an 8 x 4
// grid, multires 6, no skip): sdf_density_kernel<1, 3>.
//
// Every other network the JAX package runs goes through the general kernel
// below (sdf_density_general_kernel), which reads the network's shape at
// run time from a descriptor that ops/sdf_density.pack_general builds:
// any number of layers and widths, skip_in ([h, inp] / sqrt(2) before a
// layer), multires 0 (x alone) or more, a grid of any L x C (or none:
// use_grid_feature = false drops its zero columns, exactly), divide_factor
// (x / divide_factor before the grid) and the fine clamp (tanh(sdf) 0.05);
// both divisions rounded as the plain version rounds them on the card, a
// product with the float32 reciprocal (torch's division by a scalar
// there). Its concat variant
// (concat_coarse_feature) reads fp32 tables, as the JAX package's prepass
// does there (models/scene_model.py:247-257, fp32 combine_sdf), computes the
// coarse network's whole last layer (the SDF row and the feature rows) and
// feeds the feature rows to the fine network's first layer. Its design:
//   * the activations live transposed in shared memory, one row per input
//     column, rows tile + 4 floats apart: X (x and its encoding, the grid
//     features, the coarse features) and one or two hidden buffers;
//   * a network whose packed weights fit beside them keeps the pack
//     resident (one cp.async.bulk a block) and runs blocks of 256 threads
//     on 128 points, three an SM where they fit (80 registers a thread),
//     else two, with two hidden buffers in turns: such a network is
//     narrow, its time goes to the gathers, the encodings and the
//     barriers, and the other blocks overlap them;
//   * a wider one streams its weights through a ring of 3 stages: each
//     layer's [K][N] weights and bias row are slices of as many rows as fit
//     (64 .. 4 at the widest layer), copied by cp.async.bulk from L2
//     (thread 0, an mbarrier a stage) two slices ahead of the multiply-adds
//     that read them, across layers, networks and tiles; one barrier a
//     slice frees its stage. No network's weights need to fit, and the
//     shared memory goes to the largest tile, since each slice then serves
//     the most points: one block of 512 threads on 256 points (16 warps an
//     SM, as the kernel above), else two of 256 on 128, one of 512 on 128,
//     ... 32;
//   * every width is padded to a multiple of 4 with zero units (exact: a
//     padded unit's outgoing weights are 0), and each layer picks the
//     smallest register block, P points x 4 units J times (P 4 or 8; J 1
//     wherever a plan allows it, 2 only for layers wider than 512 units),
//     whose items all fit in the block's threads at once: every thread is
//     busy at 64 units (128 points and 256 threads, or 256 and 512), and
//     every item is in registers when the layer's last slice has been read,
//     so a streaming layer writes its outputs over its inputs (one hidden
//     buffer). The packer
//     puts a thread's 4 units q, q + N/4, q + N/2, q + 3N/4 in one float4,
//     so the lanes of a warp read consecutive weights and store
//     consecutive rows;
//   * a streamed layer sums each unit's inputs in blocks of 16, each block
//     a chain of fused multiply-adds added to the total (nearer float64
//     than one long chain, as a resident layer, in 80 registers, and the
//     plain version's products take it);
//   * the SDF row of each last layer is split over the T / tile lanes of
//     each point and summed in float64 with shuffles, and the coarse and
//     fine SDF stay in float64 until their sum is rounded once;
//   * the grid features as K3 (bf16) or K2 (fp32) compute them, a warp on
//     consecutive points of one level, each corner row read in loads of
//     up to 16 bytes;
//   * any network the JAX package runs has a plan (the networks above keep
//     theirs: the search tries what it tried before first). The
//     descriptor has a slot a layer (16 at least): the first 16 layers
//     and 34 segments ride in the kernel's parameters, the rest in a
//     device buffer that the plan fills once per pack. A layer wider than
//     1024 units runs as column slices of 512 (each a segment of its own,
//     packed so by ops/sdf_density.py, writing its units' rows), with two
//     hidden buffers, since a slice must not write over its layer's input.
//     Where the activations do not fit beside the ring at 32 points a
//     tile, smaller tiles (16, 8 points) and slices of 2 or 1 weight rows
//     come next; past those, each block's activations go to a device
//     buffer (g.act, a block's part stays in L2 while it works on it) and
//     shared memory holds the ring, the points and the barriers. An SDF
//     row longer than 4096 floats streams in pieces of 4096.
// Measured on an H100 80GB HBM3 at 700 W (tools/sdf_density_ab.py in turns
// against the earlier design, the weights resident or read through L1/L2
// by 256 threads on 128 or 64 points; PERF.md §6): concat 3.77 ms for a
// 2580 x 640 render chunk and 11.97 for a mapping iteration's 8192 x 640
// (34 % of the operation bound; 7.58 and 24.05 before), a VolSDF-like 8 x
// 256 fine network 49.0 ms for a render chunk (47 %; 118.0 before), the
// narrow test networks 17-28 % (12-18 % before). What bounds concat now
// is the products themselves with a barrier every 16-row slice (32
// multiply-adds a thread per 3 shared loads at 64 units, one block an
// SM); the gathers take 10 % (tools/sdf_density_ablate.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <vector>

#include "hash_grid.cuh"
#include "voxel_grid.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 256;            // points per tile
constexpr int kThreads = 512;         // 32 point groups x 16 unit groups
constexpr int kLd = kTile + 4;        // row stride of the transposed tiles
constexpr int kWidth = 64;            // hidden width
constexpr int kPeCols = 39;           // x and sin, cos of x 2^f, f < 6
constexpr int kInCols = kPeCols + 32; // + the grid's L C = 32 features
constexpr int kFreqs = 6;

// the packed floats of one network with H hidden layers: the first layer
// [kInCols][kWidth] and its bias, H - 1 layers [kWidth][kWidth] and their
// biases, the last layer's SDF row [kWidth] and its bias padded to 4
__host__ __device__ constexpr int net_floats(int H) {
  return kInCols * kWidth + kWidth + (H - 1) * (kWidth * kWidth + kWidth) + kWidth + 4;
}

// shared memory, in floats (every part a multiple of 4 floats)
template <int HC, int HF>
struct Smem {
  static constexpr int weights = net_floats(HC) + net_floats(HF);
  static constexpr int x = weights;                  // [kInCols][kLd]
  static constexpr int h = x + kInCols * kLd;        // [kWidth][kLd]
  static constexpr int pts = h + kWidth * kLd;       // [kTile][3]
  static constexpr int beta = pts + kTile * 3;       // [kTile]
  static constexpr int sdf = beta + kTile;           // [kTile]
  static constexpr int sdf_c = sdf + kTile;          // [kTile] float64
  static constexpr int total = sdf_c + 2 * kTile;
};

struct Args {
  const float* weights;
  const uint16_t* table_c;
  const int* meta_c;
  const float* scl_c;
  const uint16_t* table_f;
  const int* meta_f;
  const float* scl_f;
  const float* xs;          // grid mode: linspace(-1, 1, res) (else null)
  int res;
  const float* o;           // ray mode: o, d [R, 3], z [R, S]
  const float* d;
  const float* z;
  int S;
  const float* counter;     // the voxel counter [vres^3] (null: beta given)
  int vres;
  float neg_b_1e4, vd, va, vc;
  const float* beta;        // the learned beta, one float (null: voxels)
  const float* beta_scale;  // one float, or null
  float* out;
  int64_t N;
};

// point n of the launch (the origin for a slot past the end)
__device__ __forceinline__ void point_of(const Args& a, int64_t n, float p[3]) {
  if (n >= a.N) {
    p[0] = p[1] = p[2] = 0.0f;
  } else if (a.xs != nullptr) {
    const int64_t rr = (int64_t)a.res * a.res;
    const int i = (int)(n / rr), j = (int)((n / a.res) % a.res), k = (int)(n % a.res);
    p[0] = __ldg(a.xs + i);
    p[1] = __ldg(a.xs + j);
    p[2] = __ldg(a.xs + k);
  } else {
    const int64_t r = n / a.S;
    const float zn = __ldg(a.z + n);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p[c] = __fadd_rn(__ldg(a.o + r * 3 + c), __fmul_rn(zn, __ldg(a.d + r * 3 + c)));
  }
}

__device__ __forceinline__ float beta_at(const Args& a, const float p[3]) {
  float b;
  if (a.beta != nullptr) {
    b = __ldg(a.beta);
  } else {
    const int i = nsl::voxel_flat(p, a.vres);
    b = nsl::voxel_beta(i >= 0 ? __ldg(a.counter + i) : 0.0f, a.neg_b_1e4, a.vd, a.va, a.vc);
  }
  return a.beta_scale != nullptr ? __fmul_rn(b, __ldg(a.beta_scale)) : b;
}

// alpha (0.5 + 0.5 sign(sdf) expm1(-|sdf| / beta)), alpha = 1 / beta, in
// the plain version's order of roundings
__device__ __forceinline__ float laplace(float sdf, float beta) {
  const float sgn = sdf > 0.0f ? 1.0f : (sdf < 0.0f ? -1.0f : 0.0f);
  const float em = expm1f(__fdiv_rn(-fabsf(sdf), beta));
  const float t = __fadd_rn(0.5f, __fmul_rn(__fmul_rn(0.5f, sgn), em));
  return __fmul_rn(__fdiv_rn(1.0f, beta), t);
}

// the tile's rows 0 .. kPeCols - 1: x, then sin and cos of x 2^f (x 2^f is
// exact, as torch's x * 2.0 ** f); one task per (point, frequency)
__device__ __forceinline__ void pe_rows(const float* s_pts, float* s_x) {
  for (int task = threadIdx.x; task < kTile * kFreqs; task += kThreads) {
    const int p = task & (kTile - 1), f = task / kTile;
    const float scale = (float)(1 << f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = s_pts[p * 3 + c];
      float s, co;
      sincosf(x * scale, &s, &co);
      s_x[(3 + 6 * f + c) * kLd + p] = s;
      s_x[(6 + 6 * f + c) * kLd + p] = co;
      if (f == 0) s_x[c * kLd + p] = x;
    }
  }
}

// rows kPeCols .. kInCols - 1: the grid's L C features of each point from
// its bf16 table (K3's arithmetic, size 1); one task per (point, level), a
// warp on 32 consecutive points of one level
template <int L, int C>
__device__ __forceinline__ void grid_rows(const uint16_t* __restrict__ table,
                                          const int* __restrict__ meta,
                                          const float* __restrict__ scl,
                                          const float* s_pts, float* s_x) {
#pragma unroll 1
  for (int task = threadIdx.x; task < kTile * L; task += kThreads) {
    const int p = task & (kTile - 1), l = task / kTile;
    const float xp[3] = {s_pts[p * 3], s_pts[p * 3 + 1], s_pts[p * 3 + 2]};
    nsl::LevelGeom g;
    const bool oob = nsl::level_geom(xp, 1.0f, __ldg(scl + 2 * l), 0.0f, g);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    if (!oob) {
      uint32_t rows[8];
      nsl::corner_rows(g, (uint32_t)__ldg(meta + 4 * l + 2), (uint32_t)__ldg(meta + 4 * l + 1),
                       (uint32_t)__ldg(meta + 4 * l), __ldg(meta + 4 * l + 3) != 0, rows);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v[C], w, dw[3];
        nsl::load_bf16_row<C>(table, rows[k], v);
        nsl::corner_weights(g, k, w, dw);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * v[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) s_x[(kPeCols + l * C + c) * kLd + p] = acc[c];
  }
}

// acc[i][j] = sum_k in[k][pg 8 + i] w[k][og 4 + j]: the thread's 8 points x
// 4 units (og + 16 j) of a layer with K inputs
template <int K>
__device__ __forceinline__ void dense(const float* in, const float* w, int og, int pg,
                                      float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const float* xi = in + pg * 8;
  const float* wi = w + og * 4;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(xi + k * kLd);
    const float4 b = *reinterpret_cast<const float4*>(xi + k * kLd + 4);
    const float4 c = *reinterpret_cast<const float4*>(wi + k * kWidth);
    const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const float wv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
  }
}

// softplus with beta 100 and threshold 20 (see the header)
__device__ __forceinline__ float softplus100(float v) {
  constexpr float kNegLog2eBeta = -144.26950408889634f;   // -100 log2(e)
  constexpr float kLn2OverBeta = 0.006931471805599453f;   // ln(2) / 100
  const float e = exp2f(kNegLog2eBeta * fabsf(v));
  const float r = fmaf(__log2f(1.0f + e), kLn2OverBeta, fmaxf(v, 0.0f));
  return v * 100.0f > 20.0f ? v : r;
}

// acc += bias (the unit's, in the packer's order), then softplus
__device__ __forceinline__ void bias_softplus(float acc[8][4], const float* b, int og) {
  const float4 bv = *reinterpret_cast<const float4*>(b + og * 4);
  const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = softplus100(acc[i][j] + bj[j]);
}

// the thread's 8 x 4 activations into rows og + 16 j of a transposed tile
__device__ __forceinline__ void store_rows(const float acc[8][4], float* dst, int og, int pg) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* r = dst + (og + 16 * j) * kLd + pg * 8;
    *reinterpret_cast<float4*>(r) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(r + 4) = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// one network from its packed weights w over the tile in s_x: its hidden
// layers through s_h and s_x in turn, then the SDF row in float64; every
// lane returns the SDF (bias included) of points pg 8 + i
template <int H>
__device__ __forceinline__ void run_net(const float* w, float* s_x, float* s_h, int og,
                                        int pg, double sdf[8]) {
  float acc[8][4];
  dense<kInCols>(s_x, w, og, pg, acc);
  w += kInCols * kWidth;
  bias_softplus(acc, w, og);
  w += kWidth;
#pragma unroll
  for (int l = 1; l < H; ++l) {
    // odd layers read s_h, even ones s_x; the barrier orders the stores
    // after every thread's reads of the buffer they overwrite
    float* buf = (l & 1) ? s_h : s_x;
    store_rows(acc, buf, og, pg);
    __syncthreads();
    dense<kWidth>(buf, w, og, pg, acc);
    w += kWidth * kWidth;
    bias_softplus(acc, w, og);
    w += kWidth;
  }
  const float4 wl = *reinterpret_cast<const float4*>(w + og * 4);
  const double wj[4] = {wl.x, wl.y, wl.z, wl.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) s = fma((double)acc[i][j], wj[j], s);
    // the 16 lanes of the half warp hold the point's 64 units
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
    sdf[i] = s + (double)w[kWidth];
  }
}

template <int HC, int HF>
__global__ void __launch_bounds__(kThreads, 1) sdf_density_kernel(const Args a) {
  using Sm = Smem<HC, HF>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* s_x = sm + Sm::x;
  float* s_h = sm + Sm::h;
  float* s_pts = sm + Sm::pts;
  float* s_beta = sm + Sm::beta;
  float* s_sdf = sm + Sm::sdf;
  double* s_sdf_c = reinterpret_cast<double*>(sm + Sm::sdf_c);
  const float* w_c = sm;
  const float* w_f = sm + net_floats(HC);
  for (int i = threadIdx.x; i < Sm::weights / 4; i += kThreads)
    smem4[i] = __ldg(reinterpret_cast<const float4*>(a.weights) + i);
  const int t = threadIdx.x, og = t & 15, pg = t >> 4;
  const int64_t tiles = (a.N + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t n0 = tile * kTile;
    // the previous tile's last reads (and, first, the weights) are done
    __syncthreads();
    if (t < kTile) {
      float p[3];
      point_of(a, n0 + t, p);
      s_pts[t * 3] = p[0];
      s_pts[t * 3 + 1] = p[1];
      s_pts[t * 3 + 2] = p[2];
      s_beta[t] = beta_at(a, p);
    }
    __syncthreads();
    pe_rows(s_pts, s_x);
    grid_rows<4, 8>(a.table_c, a.meta_c, a.scl_c, s_pts, s_x);
    __syncthreads();
    double sdf[8];
    run_net<HC>(w_c, s_x, s_h, og, pg, sdf);
    if (og == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) s_sdf_c[pg * 8 + i] = sdf[i];
    __syncthreads();   // the coarse features are read: the fine ones replace them
    grid_rows<8, 4>(a.table_f, a.meta_f, a.scl_f, s_pts, s_x);
    __syncthreads();
    run_net<HF>(w_f, s_x, s_h, og, pg, sdf);
    if (og == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) s_sdf[pg * 8 + i] = (float)(s_sdf_c[pg * 8 + i] + sdf[i]);
    __syncthreads();
    if (t < kTile && n0 + t < a.N) a.out[n0 + t] = laplace(s_sdf[t], s_beta[t]);
  }
}

// ---------------------------------------------------------------------------
// the general kernel: any network the JAX package runs
// ---------------------------------------------------------------------------

constexpr int kMaxLayers = 16;
// ints of one network's descriptor (ops/sdf_density.pack_general), for a
// descriptor of cap >= kMaxLayers layer slots (cap = kMaxLayers: the
// shape of every network up to 16 layers): n, n_pe, multires, L, C, d0,
// clamp, feat, divide_factor's bits, then K [cap], N [cap], skip [cap] and
// the weights' offset [cap]
constexpr int kDescHead = 9;
constexpr int kDescInts = kDescHead + 4 * kMaxLayers;
// torch on the card divides by a scalar as a product with its float32
// reciprocal: the plain version's / sqrt(2) and / divide_factor
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309505f;
constexpr int kStages = 3;                       // slices of weights in flight
constexpr int kMaxSegs = 2 * (kMaxLayers + 1);   // segments in the kernel's parameters
constexpr int kMaxThreads = 512;
constexpr int kTailFloats = 16;                  // the mbarriers and the cursor
constexpr int kSumBlock = 16;                    // inputs a partial sum (streaming)
// a dense layer wider than kSliceMax units (padded) is packed and run as
// column slices of kSliceUnits units (the last one the rest), each a
// segment of its own writing its units' rows: ops/sdf_density.py packs
// them so
constexpr int kSliceMax = 1024;
constexpr int kSliceUnits = 512;
// an SDF row longer than this many floats streams in pieces of it
constexpr int kRowChunk = 4096;

__host__ __device__ inline int slices_of(int N) {
  return N > kSliceMax ? (N + kSliceUnits - 1) / kSliceUnits : 1;
}

struct NetDesc {
  int n;                  // linear layers
  int n_pe;               // rows of x and its encoding: 3 (1 + 2 multires)
  int M;                  // multires
  int L, C;               // the grid's levels and channels (L = 0: none)
  int d0;                 // X rows the network reads (its input, padded)
  int clamp;              // the fine clamp, tanh(sdf) 0.05
  int feat;               // concat: the coarse last layer's feature rows (padded)
  float df;               // divide_factor
  float inv_df;           // 1 / divide_factor in float32 (torch's division by it)
  int K[kMaxLayers];      // input rows of layer l (l < kMaxLayers; the rest
  int N[kMaxLayers];      // in GArgs::layer_ext): output units of hidden
  int skip[kMaxLayers];   // layer l (a multiple of 4), whether layer l
  int off[kMaxLayers];    // reads [h, inp] / sqrt(2), its weights' offset
};

// layer l >= kMaxLayers of a network (the extension buffer, 4 ints a layer)
struct LayerDesc {
  int K, N, skip, off;
};

// one stretch of the packed weights that the block streams through its
// ring (or reads in place, resident), in the order the block reads them
// for each tile: rows of n floats, len floats in all (the last row may be
// short)
// (a dense layer or a column slice of one: its K weight rows [K][n] and
// then its bias row, its units written from row c0 of the output; an SDF
// row: ceil4(K) + 4 floats in rows of at most kRowChunk), ks rows per
// slice. mode: the dense layer's register block (kBlocks), -1 for an SDF
// row
struct Seg {
  int off, rows, n, ks, mode, c0, len;
};

// a thread's register block in a dense layer: P points x 4 units, J times
constexpr int kBlocks[4][2] = {{4, 1}, {8, 1}, {4, 2}, {8, 2}};

struct GArgs {
  Args p;                 // points, beta and output (weights: the general pack)
  NetDesc net[2];         // coarse, fine
  int tile, ld;           // points per tile, row stride of the activations
  int x_rows, h_rows;     // rows of X and of each hidden buffer
  int stage;              // floats of one ring stage
  int resident;           // the whole pack in shared memory, copied once
  int buffers;            // hidden buffers: 2 (in turns) or 1 (in place)
  int64_t w_floats;       // floats of the pack
  int nseg;
  Seg seg[kMaxSegs];
  // past the parameters (device memory, from the plan; null where unused):
  // layers kMaxLayers.. of each network, segments kMaxSegs..
  const LayerDesc* layer_ext[2];
  const Seg* seg_ext;
  // the activations (X and the hidden buffers) of block b at act + b
  // act_floats in device memory, where they do not fit in shared memory
  // (null: in shared memory)
  float* act;
  int64_t act_floats;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// segment i: X, the kernels for any network (the extension buffer past
// kMaxSegs), else the parameters only
template <bool X>
__device__ __forceinline__ const Seg& seg_at(const GArgs& g, int i) {
  if constexpr (X) return i < kMaxSegs ? g.seg[i] : g.seg_ext[i - kMaxSegs];
  else return g.seg[i];
}

__device__ __forceinline__ LayerDesc layer_at(const GArgs& g, int net, int l) {
  const NetDesc& nd = g.net[net];
  return l < kMaxLayers ? LayerDesc{nd.K[l], nd.N[l], nd.skip[l], nd.off[l]}
                        : g.layer_ext[net][l - kMaxLayers];
}

// --- the weight ring: cp.async.bulk into kStages stages, an mbarrier each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from global src to shared dst, completing on the mbarrier bar
// (thread 0; the stage's earlier reads are done: the caller's barrier)
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the cursor of the next slice to copy; thread 0's, in shared memory
struct Cursor {
  int64_t tile;   // the tile it belongs to
  int seg, row;   // its segment and first row
  int issued;     // slices copied so far
};

// thread 0: copy the next slice of the block's stream into its stage
template <bool X>
__device__ __forceinline__ void issue_slice(const GArgs& g, float* ring, uint64_t* full,
                                            Cursor* cur, int64_t tiles) {
  if (cur->tile >= tiles) return;
  const Seg& s = seg_at<X>(g, cur->seg);
  const int r1 = min(cur->row + s.ks, s.rows);
  uint32_t bytes;
  if constexpr (X) bytes = (uint32_t)min((r1 - cur->row) * s.n, s.len - cur->row * s.n) * 4u;
  else bytes = (uint32_t)((r1 - cur->row) * s.n) * 4u;
  const int st = cur->issued % kStages;
  bulk_copy(ring + st * g.stage, g.p.weights + s.off + (int64_t)cur->row * s.n, bytes,
            full + st);
  cur->issued += 1;
  cur->row = r1;
  if (r1 == s.rows) {
    cur->row = 0;
    if (++cur->seg == g.nseg) {
      cur->seg = 0;
      cur->tile += gridDim.x;
    }
  }
}

// what every thread of the block shares
struct Block {
  float* ring;
  uint64_t* full;
  Cursor* cur;
  int64_t tiles;
  uint32_t slice;   // slices read so far (the same in every thread)
  int seg;          // the segment being read
};

// the slice of segment b.seg that starts at row r0, once it is in (R: the
// pack is resident)
template <bool R, bool X>
__device__ __forceinline__ const float* slice_wait(const GArgs& g, const Block& b, int r0) {
  if constexpr (R) {
    mbar_wait(b.full, 0);
    const Seg& s = seg_at<X>(g, b.seg);
    return b.ring + s.off + r0 * s.n;
  }
  const int st = b.slice % kStages;
  mbar_wait(b.full + st, (b.slice / kStages) & 1);
  return b.ring + st * g.stage;
}

// the slice is read; streaming: once every thread has read it, its stage
// takes the slice kStages on
template <bool R, bool X>
__device__ __forceinline__ void slice_done(const GArgs& g, Block& b) {
  if constexpr (!R) {
    __syncthreads();
    if (threadIdx.x == 0) issue_slice<X>(g, b.ring, b.full, b.cur, b.tiles);
  }
  ++b.slice;
}

// --- the layers

// out rows [0, N) = act(in[0, K) . W + b) over the tile (act: softplus;
// halve: / sqrt(2), the next layer's skip concat), W and b from segment
// b.seg. Thread t holds item q = t % Q (and q + Q when J = 2) of points
// (t / Q) P .. + P: the float4 at 4 q of each weight row, which the packer
// fills with units q, q + N/4, q + N/2, q + 3N/4, so that the threads of a
// warp store consecutive rows. Every item is in registers when the last
// slice has been read, so out may overlap in (in_place; streaming passes
// a barrier after each slice anyway)
// part[i][m] += in[k][i] w[k][m] over rows k in [k0, k1) in order: the
// thread's P points at xi (rows ld apart) and its float4 of weights at wq
// (rows N apart)
template <int P, int U>
__device__ __forceinline__ void fma_rows(float (&part)[P][4], const float* xi, int ld,
                                         const float* wq, int N, int k0, int k1) {
#pragma unroll(U)
  for (int k = k0; k < k1; ++k) {
    float xv[P];
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xi + k * ld + i);
      xv[i] = a.x;
      xv[i + 1] = a.y;
      xv[i + 2] = a.z;
      xv[i + 3] = a.w;
    }
    const float4 c = *reinterpret_cast<const float4*>(wq + k * N);
    const float wv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) part[i][m] = fmaf(xv[i], wv[m], part[i][m]);
  }
}

// out rows [c0, c0 + N) = act(in[0, K) . W + b) over the tile (act:
// softplus; halve: / sqrt(2), the next layer's skip concat), W [K][N] and
// b from segment b.seg (N its n, c0 its first output row: 0 but for a
// column slice of a wide layer). Thread t holds item q = t % Q (and q + Q
// when J = 2) of points
// (t / Q) P .. + P: the float4 at 4 q of each weight row, which the packer
// fills with units q, q + N/4, q + N/2, q + 3N/4, so that the threads of a
// warp store consecutive rows. Streaming (R false), each item's sum is
// taken in blocks of kSumBlock inputs added in turn (blocked summation:
// nearer float64 than one long chain, as the plain version's products
// take it); a resident pack's layers (J 1, 80 registers) in one chain.
// Every item is in registers when the last slice has been read, so out may
// overlap in (in_place; streaming passes a barrier after each slice anyway)
template <int P, int J, bool R, bool X>
__device__ __forceinline__ void dense(const GArgs& g, Block& b, const float* in, int K,
                                      int N, float* out, bool act, bool halve, bool in_place) {
  const Seg& s = seg_at<X>(g, b.seg);
  if constexpr (X) {   // a column slice: its units, from its first row
    N = s.n;
    out += s.c0 * g.ld;
  }
  const int ld = g.ld, N4 = N >> 2, Q = (N4 + J - 1) / J;
  const int t = threadIdx.x, qq = t % Q, pg = t / Q;
  const bool busy = pg < g.tile / P;
  int q[J];
#pragma unroll
  for (int j = 0; j < J; ++j) q[j] = min(qq + j * Q, N4 - 1);
  float acc[J][P][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[j][i][m] = 0.0f;
  const float* xi = in + pg * P;
  for (int r0 = 0; r0 < s.rows; r0 += s.ks) {
    const float* w = slice_wait<R, X>(g, b, r0);
    const int r1 = min(r0 + s.ks, s.rows), k1 = min(r1, K);
    if (busy) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float* wq = w - r0 * N + 4 * q[j];   // row k at wq + k N
        if constexpr (R) {
          fma_rows<P, 2>(acc[j], xi, ld, wq, N, r0, k1);
        } else {
          for (int kb = r0; kb < k1; kb += kSumBlock) {
            float part[P][4];
#pragma unroll
            for (int i = 0; i < P; ++i)
#pragma unroll
              for (int m = 0; m < 4; ++m) part[i][m] = 0.0f;
            fma_rows<P, J == 1 ? 4 : 1>(part, xi, ld, wq, N, kb, min(kb + kSumBlock, k1));
#pragma unroll
            for (int i = 0; i < P; ++i)
#pragma unroll
              for (int m = 0; m < 4; ++m) acc[j][i][m] += part[i][m];
          }
        }
      }
      if (r1 > K) {   // the bias row
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float4 c = *reinterpret_cast<const float4*>(w + (K - r0) * N + 4 * q[j]);
          const float bv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int i = 0; i < P; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[j][i][m] += bv[m];
        }
      }
    }
    slice_done<R, X>(g, b);
  }
  ++b.seg;
  if constexpr (R) {
    if (in_place) __syncthreads();   // every read of in is done
  }
  if (!busy) return;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j > 0 && qq + j * Q >= N4) break;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float v[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        v[i] = acc[j][i][m];
        if (act) v[i] = softplus100(v[i]);
        if (halve) v[i] = __fmul_rn(v[i], kInvSqrt2);
      }
      float* r = out + (q[j] + N4 * m) * ld + pg * P;
#pragma unroll
      for (int i = 0; i < P; i += 4)
        *reinterpret_cast<float4*>(r + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

template <bool R, bool X>
__device__ __forceinline__ void dense_any(const GArgs& g, Block& b, const float* in, int K,
                                          int N, float* out, bool act, bool halve,
                                          bool in_place) {
  // a resident pack has one item a thread: its kernel holds no two-item code
  const int mode = seg_at<X>(g, b.seg).mode;
  if (mode == 0) dense<4, 1, R, X>(g, b, in, K, N, out, act, halve, in_place);
  else if (R || mode == 1) dense<8, 1, R, X>(g, b, in, K, N, out, act, halve, in_place);
  else if (mode == 2) dense<4, 2, R, X>(g, b, in, K, N, out, act, halve, in_place);
  else dense<8, 2, R, X>(g, b, in, K, N, out, act, halve, in_place);
}

// a dense layer of N units: its column slices one after another (one
// segment where N <= kSliceMax); a sliced layer never writes over its input
template <bool R>
__device__ __forceinline__ void dense_layer(const GArgs& g, Block& b, const float* in, int K,
                                            int N, float* out, bool act, bool halve,
                                            bool in_place) {
  const int ns = slices_of(N);
  for (int c = 0; c < ns; ++c) dense_any<R, true>(g, b, in, K, N, out, act, halve, in_place);
}

// the SDF row of a last layer with K inputs, in float64: the T / tile
// lanes of each point (point t / parts) take every parts-th input and sum
// over one another with shuffles; every lane returns its point's SDF
// (X: a row longer than kRowChunk floats comes in pieces of kRowChunk, a
// multiple of the lanes a point: each lane sums the same inputs in the same
// order)
template <bool R, bool X>
__device__ __forceinline__ double sdf_row(const GArgs& g, Block& b, const float* in, int K) {
  const int parts = blockDim.x / g.tile;
  const int p = threadIdx.x / parts, part = threadIdx.x % parts;
  if constexpr (!X) {
    const float* w = slice_wait<R, X>(g, b, 0);
    double s = 0.0;
    for (int k = part; k < K; k += parts) s = fma((double)in[k * g.ld + p], (double)w[k], s);
    for (int off = 1; off < parts; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
    s += (double)w[round4(K)];
    slice_done<R, X>(g, b);
    ++b.seg;
    return s;
  } else {
    const Seg& sg = seg_at<X>(g, b.seg);
    const int K4 = round4(K), rows = sg.rows, n = sg.n;
    double s = 0.0, bias = 0.0;
    for (int r = 0; r < rows; ++r) {
      const float* w = slice_wait<R, X>(g, b, r);
      const int k0 = r * n, k1 = min(k0 + n, K);
      for (int k = k0 + part; k < k1; k += parts)
        s = fma((double)in[k * g.ld + p], (double)w[k - k0], s);
      if (K4 >= k0 && K4 < k0 + n) bias = (double)w[K4 - k0];
      slice_done<R, X>(g, b);
    }
    for (int off = 1; off < parts; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
    s += bias;
    ++b.seg;
    return s;
  }
}

// X rows 0 .. n_pe - 1: x, then sin and cos of x 2^f, f < M
__device__ void pe_rows_general(int M, const float* s_pts, float* s_x, int tile, int ld) {
  for (int task = threadIdx.x; task < tile * (M + 1); task += blockDim.x) {
    const int p = task % tile, f = task / tile;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = s_pts[p * 3 + c];
      if (f == 0) {
        s_x[c * ld + p] = x;
      } else {
        float s, co;
        sincosf(x * (float)(1 << (f - 1)), &s, &co);
        s_x[(3 + 6 * (f - 1) + c) * ld + p] = s;
        s_x[(6 + 6 * (f - 1) + c) * ld + p] = co;
      }
    }
  }
}

// CV channels of a corner row at channel c0 of row r: float32 (CV 1, 2, 4)
// or bf16 (CV 2, 4, 8) in one load
template <bool kF32, int CV>
__device__ __forceinline__ void load_chunk(const void* table, uint32_t r, int C, int c0,
                                           float v[CV]) {
  if constexpr (kF32) {
    const float* p = reinterpret_cast<const float*>(table) + (size_t)r * C + c0;
    if constexpr (CV == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
    } else if constexpr (CV == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = a.x;
      v[1] = a.y;
    } else {
      v[0] = __ldg(p);
    }
  } else {
    nsl::load_bf16_vec<CV>(reinterpret_cast<const uint16_t*>(table) + (size_t)r * C + c0, v);
  }
}

// the 8 corners' rows summed in order, CV channels at a time
template <bool kF32, int CV>
__device__ __forceinline__ void gather_level(const void* table, const uint32_t rows[8],
                                             const float wk[8], int C, float* dst, int ld) {
  for (int c0 = 0; c0 < C; c0 += CV) {
    float v[8][CV];
#pragma unroll
    for (int k = 0; k < 8; ++k) load_chunk<kF32, CV>(table, rows[k], C, c0, v[k]);
    float acc[CV];
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[c] += wk[k] * v[k][c];
#pragma unroll
    for (int c = 0; c < CV; ++c) dst[(c0 + c) * ld] = acc[c];
  }
}

// X rows n_pe .. n_pe + L C - 1: the grid's features of each point at
// x / divide_factor, from a bf16 (K3's arithmetic) or an fp32 table [T, C]
// (K2's); one task per (point, level), a warp on consecutive points of one
// level, each corner row read in vector loads of up to 16 bytes, the 8
// corners summed in order for each channel
template <bool kF32>
__device__ void grid_rows_general(const NetDesc& nd, const void* table, const int* meta,
                                  const float* scl, const float* s_pts, float* s_x, int tile,
                                  int ld) {
  const int L = nd.L, C = nd.C;
  for (int task = threadIdx.x; task < tile * L; task += blockDim.x) {
    const int p = task % tile, l = task / tile;
    float xp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      xp[c] = nd.df == 1.0f ? s_pts[p * 3 + c] : __fmul_rn(s_pts[p * 3 + c], nd.inv_df);
    float* dst = s_x + (nd.n_pe + l * C) * ld + p;
    nsl::LevelGeom geo;
    if (nsl::level_geom(xp, 1.0f, __ldg(scl + 2 * l), 0.0f, geo)) {
      for (int c = 0; c < C; ++c) dst[c * ld] = 0.0f;
      continue;
    }
    uint32_t rows[8];
    nsl::corner_rows(geo, (uint32_t)__ldg(meta + 4 * l + 2), (uint32_t)__ldg(meta + 4 * l + 1),
                     (uint32_t)__ldg(meta + 4 * l), __ldg(meta + 4 * l + 3) != 0, rows);
    float wk[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float dw[3];
      nsl::corner_weights(geo, k, wk[k], dw);
    }
    if constexpr (kF32) {
      if (C % 4 == 0) gather_level<true, 4>(table, rows, wk, C, dst, ld);
      else if (C % 2 == 0) gather_level<true, 2>(table, rows, wk, C, dst, ld);
      else gather_level<true, 1>(table, rows, wk, C, dst, ld);
    } else {
      if (C % 8 == 0) gather_level<false, 8>(table, rows, wk, C, dst, ld);
      else if (C % 4 == 0) gather_level<false, 4>(table, rows, wk, C, dst, ld);
      else gather_level<false, 2>(table, rows, wk, C, dst, ld);
    }
  }
}

// one network over the tile in s_x: its hidden layers through s_h (in
// place) or s_h and s_h2 in turns (g.buffers), then
// its last layer: every lane's point's SDF row in float64, and, for the
// concat coarse network, the feature rows into X at feat_row. Ends with a
// barrier: X and the hidden rows are free
template <bool R, bool X>
__device__ double run_net_general(const GArgs& g, Block& b, int net, float* s_x,
                                  float* s_h, float* s_h2, int feat_row) {
  const NetDesc& nd = g.net[net];
  const int tile = g.tile, ld = g.ld;
  const float* in = s_x;
  for (int l = 0; l + 1 < nd.n; ++l) {
    int K, N;
    bool skip;
    float* out;
    if constexpr (X) {
      const LayerDesc ly = layer_at(g, net, l);
      K = ly.K;
      N = ly.N;
      skip = layer_at(g, net, l + 1).skip != 0;
      out = g.buffers == 2 && (l & 1) ? s_h2 : s_h;
      dense_layer<R>(g, b, in, K, N, out, true, skip, in == out);
    } else {
      K = nd.K[l];
      N = nd.N[l];
      skip = nd.skip[l + 1] != 0;
      out = R && g.buffers == 2 && (l & 1) ? s_h2 : s_h;
      dense_any<R, X>(g, b, in, K, N, out, true, skip, in == out);
    }
    if (skip) {
      // [h, inp] / sqrt(2): the input's rows after the layer's padded units
      float* dst = out + N * ld;
      for (int i = threadIdx.x; i < nd.d0 * tile; i += blockDim.x) {
        const int r = i / tile, p = i % tile;
        dst[r * ld + p] = __fmul_rn(s_x[r * ld + p], kInvSqrt2);
      }
    }
    __syncthreads();
    in = out;
  }
  int K;
  if constexpr (X) K = layer_at(g, net, nd.n - 1).K;
  else K = nd.K[nd.n - 1];
  const double sdf = sdf_row<R, X>(g, b, in, K);
  float* feat = s_x + feat_row * ld;
  if (nd.feat) {
    if constexpr (X) dense_layer<R>(g, b, in, K, nd.feat, feat, false, false, in == s_x);
    else dense_any<R, X>(g, b, in, K, nd.feat, feat, false, false, in == s_x);
  }
  __syncthreads();
  return sdf;
}

// kF32Tab: fp32 tables (concat), else bf16; R: the pack is resident
// (g.resident: 256 threads, one item a thread, registers for three blocks
// an SM), else streamed (up to 512 threads, 16 warps); X: the network needs
// the extension buffer, column slices, an SDF row in pieces or its
// activations in device memory (g.act), else the code for every network
// that needs none of these: its segments and layers in the parameters and
// its activations in shared memory, so that every pointer there is known
// to be shared (a run-time choice there cost those networks 14-26 %)
template <bool kF32Tab, bool R, bool X>
__global__ void __launch_bounds__(R ? 256 : kMaxThreads, R ? 3 : 1)
    sdf_density_general_kernel(const __grid_constant__ GArgs g) {
  const Args& a = g.p;
  const NetDesc& nc = g.net[0];
  const NetDesc& nf = g.net[1];
  const int tile = g.tile, ld = g.ld;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Block b;
  b.ring = sm;
  // the activations in shared memory after the weights (X: or in the
  // block's part of g.act)
  float* after = sm + (R ? g.w_floats : kStages * g.stage);
  float *s_x, *s_pts;
  if constexpr (X) {
    s_x = g.act == nullptr ? after : g.act + (int64_t)blockIdx.x * g.act_floats;
  } else {
    s_x = after;
  }
  float* s_h = s_x + g.x_rows * ld;
  float* s_h2 = s_h + g.h_rows * ld;
  if constexpr (X) s_pts = g.act == nullptr ? s_h + g.buffers * g.h_rows * ld : after;
  else s_pts = s_h + g.buffers * g.h_rows * ld;
  float* s_beta = s_pts + 3 * tile;
  b.full = reinterpret_cast<uint64_t*>(s_beta + tile);
  b.cur = reinterpret_cast<Cursor*>(b.full + kStages);
  b.tiles = (a.N + tile - 1) / tile;
  b.slice = 0;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(b.full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (R) {
      bulk_copy(b.ring, a.weights, (uint32_t)g.w_floats * 4u, b.full);
    } else {
      *b.cur = Cursor{(int64_t)blockIdx.x, 0, 0, 0};
      for (int i = 0; i < kStages; ++i) issue_slice<X>(g, b.ring, b.full, b.cur, b.tiles);
    }
  }
  const int parts = blockDim.x / tile, p = t / parts;
  for (int64_t ti = blockIdx.x; ti < b.tiles; ti += gridDim.x) {
    const int64_t n0 = ti * tile;
    __syncthreads();   // the mbarriers, or the previous tile's last reads
    b.seg = 0;
    if (t < tile) {
      float pt[3];
      point_of(a, n0 + t, pt);
      s_pts[t * 3] = pt[0];
      s_pts[t * 3 + 1] = pt[1];
      s_pts[t * 3 + 2] = pt[2];
      s_beta[t] = beta_at(a, pt);
    }
    __syncthreads();
    pe_rows_general(nc.M, s_pts, s_x, tile, ld);
    grid_rows_general<kF32Tab>(nc, a.table_c, a.meta_c, a.scl_c, s_pts, s_x, tile, ld);
    __syncthreads();
    const int feat_row = nf.n_pe + nf.L * nf.C;
    const double sdf_c = run_net_general<R, X>(g, b, 0, s_x, s_h, s_h2, feat_row);
    if (nf.M != nc.M) pe_rows_general(nf.M, s_pts, s_x, tile, ld);
    grid_rows_general<kF32Tab>(nf, a.table_f, a.meta_f, a.scl_f, s_pts, s_x, tile, ld);
    __syncthreads();
    double sdf_f = run_net_general<R, X>(g, b, 1, s_x, s_h, s_h2, 0);
    if (t % parts == 0 && n0 + p < a.N) {
      // the fine clamp rounds the fine SDF to float32 first, as the plain
      // version does
      if (nf.clamp) sdf_f = (double)__fmul_rn(tanhf((float)sdf_f), 0.05f);
      a.out[n0 + p] = laplace((float)(sdf_c + sdf_f), s_beta[p]);
    }
  }
}

// --- the host's plan

// a network as the host reads it from the descriptor: the head and every
// layer
struct HostNet {
  NetDesc nd;
  std::vector<LayerDesc> layers;
};

// parse and check desc (2 networks of kDescHead + 4 cap ints)
__host__ inline bool parse_desc(const int* desc, int cap, HostNet net[2]) {
  if (cap < kMaxLayers) return false;
  for (int i = 0; i < 2; ++i) {
    const int* q = desc + (int64_t)i * (kDescHead + 4 * cap);
    NetDesc& nd = net[i].nd;
    nd = NetDesc{};
    nd.n = q[0];
    nd.n_pe = q[1];
    nd.M = q[2];
    nd.L = q[3];
    nd.C = q[4];
    nd.d0 = q[5];
    nd.clamp = q[6];
    nd.feat = q[7];
    memcpy(&nd.df, q + 8, sizeof(float));
    nd.inv_df = 1.0f / nd.df;
    if (nd.n < 1 || nd.n > cap || nd.n_pe != 3 * (1 + 2 * nd.M) || nd.M > 30 ||
        nd.feat % 4 != 0 || (i == 1 && nd.feat != 0) || nd.C < 1)
      return false;
    net[i].layers.resize(nd.n);
    for (int l = 0; l < nd.n; ++l) {
      LayerDesc& ly = net[i].layers[l];
      ly = LayerDesc{q[kDescHead + l], q[kDescHead + cap + l], q[kDescHead + 2 * cap + l],
                     q[kDescHead + 3 * cap + l]};
      if (ly.off % 4 != 0 || ly.K < 1 || (l + 1 < nd.n && (ly.N % 4 != 0 || ly.N < 4)))
        return false;
      if (l < kMaxLayers) {
        nd.K[l] = ly.K;
        nd.N[l] = ly.N;
        nd.skip[l] = ly.skip;
        nd.off[l] = ly.off;
      }
    }
  }
  return true;
}

// the first register block (kBlocks, fewest multiply-adds a thread; J at
// most max_j) whose items all fit in the block's threads at once; -1 if
// none does
__host__ inline int pick_block(int N, int tile, int threads, int max_j) {
  for (int m = 0; m < 4; ++m) {
    const int P = kBlocks[m][0], J = kBlocks[m][1], Q = (N / 4 + J - 1) / J;
    if (J <= max_j && tile % P == 0 && Q * (tile / P) <= threads) return m;
  }
  return -1;
}

// whether a network has a layer that runs as column slices (it then needs
// two hidden buffers: a slice never writes over its input)
__host__ inline bool has_slices(const HostNet net[2]) {
  for (int i = 0; i < 2; ++i) {
    for (int l = 0; l + 1 < net[i].nd.n; ++l)
      if (slices_of(net[i].layers[l].N) > 1) return true;
    if (slices_of(net[i].nd.feat) > 1) return true;
  }
  return false;
}

// the plan for threads a block and tile points a tile, ks weight rows a
// slice at the widest segment (0: the whole pack resident, each segment
// one slice), at most max_j items a thread (1 for a resident pack); the
// segments in segs; false if a layer has no register block
__host__ inline bool plan_for(const HostNet net[2], int threads, int tile, int ks, int max_j,
                              GArgs& g, std::vector<Seg>& segs) {
  int x_rows = 4, h_rows = 4, nmax = 4, row_max = 8;
  for (int i = 0; i < 2; ++i) {
    const NetDesc& nd = net[i].nd;
    const std::vector<LayerDesc>& ly = net[i].layers;
    for (int l = 0; l + 1 < nd.n; ++l) {
      h_rows = std::max(h_rows, ly[l].N + (ly[l + 1].skip ? nd.d0 : 0));
      nmax = std::max(nmax, slices_of(ly[l].N) > 1 ? kSliceUnits : ly[l].N);
    }
    nmax = std::max(nmax, slices_of(nd.feat) > 1 ? kSliceUnits : nd.feat);
    row_max = std::max(row_max, std::min(round4(ly[nd.n - 1].K) + 4, kRowChunk));
    x_rows = std::max(x_rows, round4(nd.d0));
  }
  g.tile = tile;
  g.ld = tile + 4;
  g.x_rows = x_rows;
  g.h_rows = h_rows;
  g.resident = ks == 0;
  g.stage = g.resident ? 0 : round4(std::max(ks * nmax, row_max));
  segs.clear();
  for (int i = 0; i < 2; ++i) {
    const NetDesc& nd = net[i].nd;
    const std::vector<LayerDesc>& ly = net[i].layers;
    // a dense layer of N units from off: its column slices, each [K + 1][n]
    auto dense_segs = [&](int off, int K, int N) {
      const int ns = slices_of(N);
      for (int c = 0; c < ns; ++c) {
        const int n = ns == 1 ? N : std::min(kSliceUnits, N - c * kSliceUnits);
        const int mode = pick_block(n, tile, threads, g.resident ? 1 : max_j);
        if (mode < 0) return false;
        segs.push_back(Seg{off, K + 1, n, g.resident ? K + 1 : std::max(1, g.stage / n), mode,
                           c * kSliceUnits, (K + 1) * n});
        off += (K + 1) * n;
      }
      return true;
    };
    for (int l = 0; l + 1 < nd.n; ++l)
      if (!dense_segs(ly[l].off, ly[l].K, ly[l].N)) return false;
    const int l = nd.n - 1, K = ly[l].K, len = round4(K) + 4;
    const int n = std::min(len, kRowChunk);
    segs.push_back(Seg{ly[l].off, (len + n - 1) / n, n, 1, -1, 0, len});
    if (nd.feat && !dense_segs(ly[l].off + len, K, nd.feat)) return false;
  }
  g.nseg = (int)segs.size();
  for (int i = 0; i < std::min(g.nseg, kMaxSegs); ++i) g.seg[i] = segs[i];
  return true;
}

// floats of one block's activations: X and the hidden buffers
__host__ inline int64_t act_floats_of(const GArgs& g) {
  return (int64_t)(g.x_rows + g.buffers * g.h_rows) * g.ld;
}

__host__ inline int64_t general_smem_bytes(const GArgs& g) {
  return 4 * ((g.resident ? g.w_floats : (int64_t)kStages * g.stage) +
              (g.act != nullptr ? 0 : act_floats_of(g)) + 4 * g.tile + kTailFloats);
}

// the first plan that fits, with one item a thread where any plan allows
// it, else two (two re-read each input: on an H100, a 256-unit network
// took 51.4 ms with two items on 128 points, 48.6 with one on 64). A pack
// that fits beside its activations stays
// resident: blocks of 256 threads on 128 (or 64) points, three an SM where
// they fit, else two, with two hidden buffers in turns (one barrier a
// layer), else one in place: such a network is narrow, its time goes to
// the gathers, the encodings and the barriers, and the other blocks
// overlap them. Else the weights stream, at the largest tile (each slice
// then serves the most points): one block of 512 threads on 256 points,
// two of 256 on 128, one of 512 on 128, ... 32, 16, 8; with the most
// weight rows a slice (64 .. 1) that fit. A network with a layer in column
// slices takes two hidden buffers. Past every tile, the activations go to
// device memory (g.act, the caller's: a block of 512 threads on 32 points,
// or 256 on 16 or 8) and shared memory holds the weights' ring alone.
// g.w_floats: the pack's floats; smem_sm and reserved: the SM's shared
// memory and what each block costs beside its own
__host__ inline bool general_plan(const HostNet net[2], int smem_sm, int reserved, int optin,
                                  GArgs& g, int& threads, bool& global_act,
                                  std::vector<Seg>& segs) {
  // threads, tile, hidden buffers of a resident pack (0: streamed), blocks an SM
  const int cand[15][4] = {{256, 128, 2, 3}, {256, 128, 1, 3}, {256, 128, 2, 2},
                           {256, 128, 1, 2}, {256, 64, 2, 2},  {256, 64, 1, 2},
                           {512, 256, 0, 1}, {256, 128, 0, 2}, {512, 128, 0, 1},
                           {256, 64, 0, 2},  {512, 64, 0, 1},  {512, 32, 0, 1},
                           {512, 16, 0, 1},  {256, 16, 0, 1},  {256, 8, 0, 1}};
  const int global_cand[3][2] = {{512, 32}, {256, 16}, {256, 8}};
  const bool sliced = has_slices(net);
  g.act = nullptr;
  global_act = false;
  // first the plans up to 32 points a tile and 4 weight rows a slice, in
  // their order; then 16 and 8 points and slices of 2 or 1 rows
  for (int pass = 0; pass < 2; ++pass)
    for (int max_j = 1; max_j <= 2; ++max_j)
      for (int ci = 0; ci < 15; ++ci) {
        const int* c = cand[ci];
        if (sliced && c[2] == 1) continue;
        for (int ks : {64, 32, 16, 8, 4, 2, 1}) {
          if ((pass == 0) != (ci < 12 && ks >= 4)) {
            if (c[2]) break;
            continue;
          }
          const int limit = std::min(optin, smem_sm / c[3] - reserved);
          const bool fits = plan_for(net, c[0], c[1], c[2] ? 0 : ks, max_j, g, segs);
          g.buffers = sliced ? 2 : std::max(c[2], 1);
          if (fits && general_smem_bytes(g) <= limit) {
            threads = c[0];
            return true;
          }
          if (c[2]) break;
        }
      }
  // the activations in device memory: any network whose weights' ring fits
  g.act = reinterpret_cast<float*>(1);  // (set by the caller; non-null for the sizes)
  for (int max_j = 1; max_j <= 2; ++max_j)
    for (const auto& c : global_cand)
      for (int ks : {64, 32, 16, 8, 4, 2, 1}) {
        const bool fits = plan_for(net, c[0], c[1], ks, max_j, g, segs);
        g.buffers = sliced ? 2 : 1;
        if (fits && general_smem_bytes(g) <= std::min(optin, smem_sm - reserved)) {
          threads = c[0];
          global_act = true;
          g.act = nullptr;
          return true;
        }
      }
  g.act = nullptr;
  return false;
}

__host__ inline cudaError_t device_limits(int& sms, int& smem_sm, int& reserved, int& optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return e;
}

// the extension buffer's ints: layers kMaxLayers.. of each network (4 ints
// a layer), then segments kMaxSegs.. (7 ints a segment)
__host__ inline std::vector<int> ext_ints(const HostNet net[2], const std::vector<Seg>& segs) {
  std::vector<int> ext;
  for (int i = 0; i < 2; ++i)
    for (int l = kMaxLayers; l < net[i].nd.n; ++l) {
      const LayerDesc& ly = net[i].layers[l];
      ext.insert(ext.end(), {ly.K, ly.N, ly.skip, ly.off});
    }
  for (size_t i = kMaxSegs; i < segs.size(); ++i) {
    const Seg& s = segs[i];
    ext.insert(ext.end(), {s.off, s.rows, s.n, s.ks, s.mode, s.c0, s.len});
  }
  return ext;
}

// the kernel for these tables and this plan (x: needs the kernels for any
// network, any_network), and the blocks an SM it runs
__host__ inline cudaError_t general_kernel(bool f32_tables, bool resident, bool x, int threads,
                                           size_t bytes, void (*&kern)(const GArgs),
                                           int& per_sm) {
  void (*const kerns[2][2][2])(const GArgs) = {
      {{sdf_density_general_kernel<false, false, false>,
        sdf_density_general_kernel<false, false, true>},
       {sdf_density_general_kernel<false, true, false>,
        sdf_density_general_kernel<false, true, true>}},
      {{sdf_density_general_kernel<true, false, false>,
        sdf_density_general_kernel<true, false, true>},
       {sdf_density_general_kernel<true, true, false>,
        sdf_density_general_kernel<true, true, true>}}};
  kern = kerns[f32_tables ? 1 : 0][resident ? 1 : 0][x ? 1 : 0];
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, bytes);
  return e;
}

// whether a plan needs the kernels for any network: layers or segments
// past the parameters, column slices, an SDF row in pieces, or the
// activations in device memory
__host__ inline bool any_network(const HostNet net[2], const std::vector<Seg>& segs,
                                 bool global_act) {
  if (global_act || has_slices(net) || (int)segs.size() > kMaxSegs) return true;
  for (int i = 0; i < 2; ++i)
    if (net[i].nd.n > kMaxLayers) return true;
  for (const Seg& sg : segs)
    if (sg.mode < 0 && sg.rows > 1) return true;
  return false;
}
}  // namespace

extern "C" {

// One launch over N points: the grid (xs != NULL, N = res^3) or rays
// (o, d [R, 3], z [R, S], N = R S). beta from the voxel counter [vres^3]
// (counter != NULL) or the one float at beta; beta_scale may be NULL.
// weights: 17,672 floats in pack_sdf_weights' order, 16-byte aligned;
// tables [T, C] bf16 (coarse C 8, fine C 4), 16-byte aligned.
int nsl_sdf_density(const void* weights, const void* table_c, const void* meta_c,
                    const void* scl_c, const void* table_f, const void* meta_f,
                    const void* scl_f, const void* xs, int res, const void* o,
                    const void* d, const void* z, int S, const void* counter, int vres,
                    float neg_b_1e4, float vd, float va, float vc, const void* beta,
                    const void* beta_scale, void* out, int64_t N, void* stream) {
  if (N == 0) return 0;
  if ((xs == nullptr) == (z == nullptr) || (counter == nullptr) == (beta == nullptr) ||
      (xs != nullptr && N != (int64_t)res * res * res) || (z != nullptr && S < 1))
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)weights, (const uint16_t*)table_c, (const int*)meta_c,
         (const float*)scl_c, (const uint16_t*)table_f, (const int*)meta_f,
         (const float*)scl_f, (const float*)xs, res, (const float*)o, (const float*)d,
         (const float*)z, S, (const float*)counter, vres, neg_b_1e4, vd, va, vc,
         (const float*)beta, (const float*)beta_scale, (float*)out, N};
  auto kern = sdf_density_kernel<1, 3>;
  const size_t bytes = (size_t)Smem<1, 3>::total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (N + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  kern<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The general kernel: the same modes and operands as nsl_sdf_density, and
// desc, a HOST array of 2 (kDescHead + 4 cap) ints (ops/sdf_density.
// pack_general: coarse, then fine), w_floats the packed weights' floats
// (16-byte aligned); f32_tables: the tables are [T, C] float32 (the concat
// variant), else bfloat16. ext: the device copy of the extension ints that
// nsl_sdf_density_general_ext_plan wrote for this desc (null where it
// wrote none); act: device memory for the activations, the plan's
// act_floats (null where the plan keeps them in shared memory). It takes
// general_plan's first plan that fits.
int nsl_sdf_density_general_ext(const int* desc, int cap, const void* ext, void* act,
                                const void* weights, int64_t w_floats, const void* table_c,
                                const void* meta_c, const void* scl_c, const void* table_f,
                                const void* meta_f, const void* scl_f, int f32_tables,
                                const void* xs, int res, const void* o, const void* d,
                                const void* z, int S, const void* counter, int vres,
                                float neg_b_1e4, float vd, float va, float vc, const void* beta,
                                const void* beta_scale, void* out, int64_t N, void* stream) {
  if (N == 0) return 0;
  if ((xs == nullptr) == (z == nullptr) || (counter == nullptr) == (beta == nullptr) ||
      (xs != nullptr && N != (int64_t)res * res * res) || (z != nullptr && S < 1) ||
      w_floats % 4 != 0)
    return (int)cudaErrorInvalidValue;
  GArgs g{};
  g.p = Args{(const float*)weights, (const uint16_t*)table_c, (const int*)meta_c,
             (const float*)scl_c, (const uint16_t*)table_f, (const int*)meta_f,
             (const float*)scl_f, (const float*)xs, res, (const float*)o, (const float*)d,
             (const float*)z, S, (const float*)counter, vres, neg_b_1e4, vd, va, vc,
             (const float*)beta, (const float*)beta_scale, (float*)out, N};
  HostNet net[2];
  if (!parse_desc(desc, cap, net)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 2; ++i) {
    g.net[i] = net[i].nd;
    if (net[i].nd.L > 0 && !f32_tables && net[i].nd.C % 2 != 0) return (int)cudaErrorInvalidValue;
  }
  int sms = 0, smem_sm = 0, reserved = 0, optin = 0, threads = 0;
  cudaError_t e = device_limits(sms, smem_sm, reserved, optin);
  if (e != cudaSuccess) return (int)e;
  g.w_floats = w_floats;
  bool global_act = false;
  std::vector<Seg> segs;
  if (!general_plan(net, smem_sm, reserved, optin, g, threads, global_act, segs))
    return (int)cudaErrorInvalidConfiguration;
  for (const Seg& sg : segs)
    if ((int64_t)sg.off + (int64_t)sg.len > w_floats) return (int)cudaErrorInvalidValue;
  const bool need_ext = !ext_ints(net, segs).empty();
  if (need_ext != (ext != nullptr) || global_act != (act != nullptr))
    return (int)cudaErrorInvalidValue;
  if (need_ext) {
    const int* q = (const int*)ext;
    for (int i = 0; i < 2; ++i) {
      g.layer_ext[i] = reinterpret_cast<const LayerDesc*>(q);
      q += 4 * std::max(0, net[i].nd.n - kMaxLayers);
    }
    g.seg_ext = reinterpret_cast<const Seg*>(q);
  }
  g.act = (float*)act;
  g.act_floats = act_floats_of(g);
  const size_t bytes = (size_t)general_smem_bytes(g);
  void (*kern)(const GArgs);
  int per_sm = 0;
  e = general_kernel(f32_tables, g.resident, any_network(net, segs, global_act), threads,
                     bytes, kern, per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (N + g.tile - 1) / g.tile;
  const int64_t most = (int64_t)sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < most ? tiles : most);
  kern<<<blocks, threads, bytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// nsl_sdf_density_general_ext for a descriptor of kMaxLayers slots and a
// network whose plan needs no extension and keeps its activations in
// shared memory (every network up to 16 layers of up to 1024 units that
// fits there): the C interface of earlier trees, which
// tools/sdf_density_ab.py calls on every side
int nsl_sdf_density_general(const int* desc, const void* weights, int64_t w_floats,
                            const void* table_c, const void* meta_c, const void* scl_c,
                            const void* table_f, const void* meta_f, const void* scl_f,
                            int f32_tables, const void* xs, int res, const void* o,
                            const void* d, const void* z, int S, const void* counter,
                            int vres, float neg_b_1e4, float vd, float va, float vc,
                            const void* beta, const void* beta_scale, void* out, int64_t N,
                            void* stream) {
  return nsl_sdf_density_general_ext(desc, kMaxLayers, nullptr, nullptr, weights, w_floats,
                                     table_c, meta_c, scl_c, table_f, meta_f, scl_f, f32_tables,
                                     xs, res, o, d, z, S, counter, vres, neg_b_1e4, vd, va, vc,
                                     beta, beta_scale, out, N, stream);
}

// the general kernel's plan for desc (cap layer slots) on this card: the
// tile, the shared-memory bytes a block, the floats of weights in shared
// memory (the whole pack, or its ring), the extension's ints (written to
// ext_out where it is not null) and the floats of device memory the
// activations take (0: in shared memory; else for the most blocks the
// card runs at once); 0, -1, 0, 0, 0 where no plan fits. No stream: a
// probe for the wrapper and chip_smoke.py
int nsl_sdf_density_general_ext_plan(const int* desc, int cap, int64_t w_floats, int* tile_out,
                                     int64_t* bytes_out, int* w_smem_out, int* ext_out,
                                     int64_t* ext_n_out, int64_t* act_out) {
  GArgs g{};
  g.w_floats = w_floats;
  int sms = 0, smem_sm = 0, reserved = 0, optin = 0, threads = 0;
  *tile_out = 0;
  *bytes_out = -1;
  *w_smem_out = 0;
  *ext_n_out = 0;
  *act_out = 0;
  HostNet net[2];
  if (!parse_desc(desc, cap, net)) return 0;
  cudaError_t e = device_limits(sms, smem_sm, reserved, optin);
  if (e != cudaSuccess) return (int)e;
  bool global_act = false;
  std::vector<Seg> segs;
  if (general_plan(net, smem_sm, reserved, optin, g, threads, global_act, segs)) {
    *tile_out = g.tile;
    *w_smem_out = g.resident ? (int)w_floats : kStages * g.stage;
    const std::vector<int> ext = ext_ints(net, segs);
    *ext_n_out = (int64_t)ext.size();
    if (ext_out != nullptr) std::copy(ext.begin(), ext.end(), ext_out);
    if (global_act) {
      g.act = reinterpret_cast<float*>(1);
      void (*kern)(const GArgs);
      int per_sm = 0;
      e = general_kernel(false, g.resident, true, threads, (size_t)general_smem_bytes(g), kern,
                         per_sm);
      if (e != cudaSuccess) return (int)e;
      *act_out = act_floats_of(g) * sms * std::max(per_sm, 1);
    }
    *bytes_out = general_smem_bytes(g);
  }
  return 0;
}

// nsl_sdf_density_general_ext_plan for a descriptor of kMaxLayers slots:
// the tile, the bytes and the floats of weights in shared memory
int nsl_sdf_density_general_plan(const int* desc, int64_t w_floats, int* tile_out,
                                 int64_t* bytes_out, int* w_smem_out) {
  int64_t ext_n = 0, act = 0;
  return nsl_sdf_density_general_ext_plan(desc, kMaxLayers, w_floats, tile_out, bytes_out,
                                          w_smem_out, nullptr, &ext_n, &act);
}

}  // extern "C"
