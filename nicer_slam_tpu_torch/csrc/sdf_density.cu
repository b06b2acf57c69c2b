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
// (x / divide_factor before the grid, rounded as the plain version
// rounds it) and the fine clamp (tanh(sdf) 0.05). Its concat variant
// (concat_coarse_feature) reads fp32 tables, as the JAX package's prepass
// does there (models/scene_model.py:247-257, fp32 combine_sdf), computes the
// coarse network's whole last layer (the SDF row and the feature rows) and
// feeds the feature rows to the fine network's first layer. Its design is
// the simple one, not the fast one:
//   * a tile of TP points (128, 64 or 32: the largest whose activations fit)
//     and 256 threads; the activations live transposed in shared memory,
//     one row per input column: X (the net's input: x and its positional
//     encoding, the grid features, the coarse features), and two hidden
//     buffers that the layers write in turns;
//   * every width is padded to a multiple of 4 with zero units (exact: a
//     padded unit's outgoing weights are 0), and a layer is a loop over
//     (8 points x 4 units) items, one float4 of weights and two of inputs
//     per input row: 32 fused multiply-adds per 3 loads;
//   * the weights sit in shared memory when they fit beside the
//     activations, else every block reads them through L1/L2 (a VolSDF-like
//     fine network of 8 x 256 with a skip is ~2 MB);
//   * the SDF row of each last layer is summed in float64 as above, and the
//     coarse and fine SDF stay in float64 until their sum is rounded once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

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

constexpr int kGThreads = 256;
constexpr int kMaxLayers = 16;
// ints of one network's descriptor (ops/sdf_density.pack_general):
// n, n_pe, multires, L, C, d0, clamp, feat, divide_factor's bits, then
// per layer K, N, skip and the weights' offset
constexpr int kDescHead = 9;
constexpr int kDescInts = kDescHead + 4 * kMaxLayers;
constexpr float kSqrt2 = 1.41421356237309505f;

struct NetDesc {
  int n;                  // linear layers
  int n_pe;               // rows of x and its encoding: 3 (1 + 2 multires)
  int M;                  // multires
  int L, C;               // the grid's levels and channels (L = 0: none)
  int d0;                 // X rows the network reads (its input, padded)
  int clamp;              // the fine clamp, tanh(sdf) 0.05
  int feat;               // concat: the coarse last layer's feature rows (padded)
  float df;               // divide_factor
  int K[kMaxLayers];      // input rows of layer l
  int N[kMaxLayers];      // output units of hidden layer l (a multiple of 4)
  int skip[kMaxLayers];   // layer l reads [h, inp] / sqrt(2)
  int off[kMaxLayers];    // float offset of layer l's weights
};

struct GArgs {
  Args p;                 // points, beta and output (weights: the general pack)
  NetDesc net[2];         // coarse, fine
  int tile, ld;           // points per tile, row stride of the activations
  int x_rows, h_rows;     // rows of X and of each hidden buffer
  int w_smem;             // floats of weights held in shared memory (0: none)
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// the floats of shared memory a block needs (every part a multiple of 4)
__host__ inline int64_t general_smem_floats(int tile, int x_rows, int h_rows, int w_smem) {
  const int ld = tile + 4;
  return (int64_t)w_smem + (int64_t)(x_rows + 2 * h_rows) * ld + 4 * tile;  // + points, beta
}

template <bool kSmemW>
__device__ __forceinline__ float4 load_w4(const float* w) {
  if constexpr (kSmemW) return *reinterpret_cast<const float4*>(w);
  else return __ldg(reinterpret_cast<const float4*>(w));
}

template <bool kSmemW>
__device__ __forceinline__ float load_w(const float* w) {
  if constexpr (kSmemW) return *w;
  else return __ldg(w);
}

// out rows [0, N) = act(in[0, K) . W + b) over the tile, W [K][N] then
// b [N] at w; act: softplus (hidden) or none (the coarse feature rows);
// halve: / sqrt(2), the next layer's skip concat
template <bool kSmemW>
__device__ void dense_general(const float* in, int K, const float* w, int N, float* out,
                              bool act, bool halve, int tile, int ld) {
  const int pgs = tile >> 3, items = pgs * (N >> 2);
  for (int it = threadIdx.x; it < items; it += kGThreads) {
    const int pg = it % pgs, q = it / pgs;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const float* xi = in + pg * 8;
    const float* wi = w + q * 4;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(xi + k * ld);
      const float4 b = *reinterpret_cast<const float4*>(xi + k * ld + 4);
      const float4 c = load_w4<kSmemW>(wi + k * N);
      const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const float wv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    const float4 bv = load_w4<kSmemW>(w + K * N + q * 4);
    const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = acc[i][j] + bj[j];
        if (act) v[i] = softplus100(v[i]);
        if (halve) v[i] = __fdiv_rn(v[i], kSqrt2);
      }
      float* r = out + (q * 4 + j) * ld + pg * 8;
      *reinterpret_cast<float4*>(r) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(r + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// X rows 0 .. n_pe - 1: x, then sin and cos of x 2^f, f < M
__device__ void pe_rows_general(int M, const float* s_pts, float* s_x, int tile, int ld) {
  for (int task = threadIdx.x; task < tile * (M + 1); task += kGThreads) {
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

// X rows n_pe .. n_pe + L C - 1: the grid's features of each point at
// x / divide_factor, from a bf16 (K3's arithmetic) or an fp32 table [T, C]
// (K2's); one task per (point, level), a warp on consecutive points of one
// level, the 8 corners summed in order for each channel
template <bool kF32>
__device__ void grid_rows_general(const NetDesc& nd, const void* table, const int* meta,
                                  const float* scl, const float* s_pts, float* s_x, int tile,
                                  int ld) {
  const int L = nd.L, C = nd.C;
  for (int task = threadIdx.x; task < tile * L; task += kGThreads) {
    const int p = task % tile, l = task / tile;
    float xp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      xp[c] = nd.df == 1.0f ? s_pts[p * 3 + c] : __fdiv_rn(s_pts[p * 3 + c], nd.df);
    float* dst = s_x + (nd.n_pe + l * C) * ld + p;
    nsl::LevelGeom g;
    if (nsl::level_geom(xp, 1.0f, __ldg(scl + 2 * l), 0.0f, g)) {
      for (int c = 0; c < C; ++c) dst[c * ld] = 0.0f;
      continue;
    }
    uint32_t rows[8];
    nsl::corner_rows(g, (uint32_t)__ldg(meta + 4 * l + 2), (uint32_t)__ldg(meta + 4 * l + 1),
                     (uint32_t)__ldg(meta + 4 * l), __ldg(meta + 4 * l + 3) != 0, rows);
    float wk[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float dw[3];
      nsl::corner_weights(g, k, wk[k], dw);
    }
    if constexpr (kF32) {
      const float* t = reinterpret_cast<const float*>(table);
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += wk[k] * __ldg(t + (size_t)rows[k] * C + c);
        dst[c * ld] = acc;
      }
    } else {
      const uint32_t* t = reinterpret_cast<const uint32_t*>(table);
      const int half = C >> 1;
      for (int c2 = 0; c2 < half; ++c2) {
        float lo = 0.0f, hi = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t v = __ldg(t + (size_t)rows[k] * half + c2);
          lo += wk[k] * nsl::bf16_lo(v);
          hi += wk[k] * nsl::bf16_hi(v);
        }
        dst[(2 * c2) * ld] = lo;
        dst[(2 * c2 + 1) * ld] = hi;
      }
    }
  }
}

// one network over the tile in s_x: its hidden layers through hb[0] and
// hb[1] in turns, then its last layer: the SDF row of point p in float64
// into sdf (thread p < tile), and, for the concat coarse network, the
// feature rows into the hidden buffer the last layer does not read.
// Returns that buffer.
template <bool kSmemW>
__device__ float* run_net_general(const NetDesc& nd, const float* W, float* s_x, float* hb0,
                                  float* hb1, int tile, int ld, double& sdf) {
  float* hb[2] = {hb0, hb1};
  const float* in = s_x;
  int cur = 0;
  for (int l = 0; l + 1 < nd.n; ++l) {
    float* out = hb[cur];
    const bool skip = nd.skip[l + 1] != 0;
    dense_general<kSmemW>(in, nd.K[l], W + nd.off[l], nd.N[l], out, true, skip, tile, ld);
    if (skip) {
      // [h, inp] / sqrt(2): the input's rows after the layer's padded units
      float* dst = out + nd.N[l] * ld;
      for (int i = threadIdx.x; i < nd.d0 * tile; i += kGThreads) {
        const int r = i / tile, p = i % tile;
        dst[r * ld + p] = __fdiv_rn(s_x[r * ld + p], kSqrt2);
      }
    }
    __syncthreads();
    in = out;
    cur ^= 1;
  }
  const int l = nd.n - 1, K = nd.K[l];
  const float* w = W + nd.off[l];
  if (threadIdx.x < tile) {
    const int p = threadIdx.x;
    double s = 0.0;
    for (int k = 0; k < K; ++k) s = fma((double)in[k * ld + p], (double)load_w<kSmemW>(w + k), s);
    sdf = s + (double)load_w<kSmemW>(w + round4(K));
  }
  if (nd.feat)
    dense_general<kSmemW>(in, K, w + round4(K) + 4, nd.feat, hb[cur], false, false, tile, ld);
  return hb[cur];
}

template <bool kF32Tab, bool kSmemW>
__global__ void __launch_bounds__(kGThreads) sdf_density_general_kernel(const GArgs g) {
  const Args& a = g.p;
  const NetDesc& nc = g.net[0];
  const NetDesc& nf = g.net[1];
  const int tile = g.tile, ld = g.ld;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* s_x = sm + g.w_smem;
  float* s_h0 = s_x + g.x_rows * ld;
  float* s_h1 = s_h0 + g.h_rows * ld;
  float* s_pts = s_h1 + g.h_rows * ld;
  float* s_beta = s_pts + 3 * tile;
  const float* W = kSmemW ? sm : a.weights;
  if (kSmemW)
    for (int i = threadIdx.x; i < g.w_smem / 4; i += kGThreads)
      smem4[i] = __ldg(reinterpret_cast<const float4*>(a.weights) + i);
  const int t = threadIdx.x;
  const int64_t tiles = (a.N + tile - 1) / tile;
  for (int64_t ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const int64_t n0 = ti * tile;
    __syncthreads();   // the previous tile's last reads (and the weights) are done
    if (t < tile) {
      float p[3];
      point_of(a, n0 + t, p);
      s_pts[t * 3] = p[0];
      s_pts[t * 3 + 1] = p[1];
      s_pts[t * 3 + 2] = p[2];
      s_beta[t] = beta_at(a, p);
    }
    __syncthreads();
    pe_rows_general(nc.M, s_pts, s_x, tile, ld);
    grid_rows_general<kF32Tab>(nc, a.table_c, a.meta_c, a.scl_c, s_pts, s_x, tile, ld);
    __syncthreads();
    // thread p < tile owns point p's coarse and fine SDF rows
    double sdf_c = 0.0, sdf_f = 0.0;
    const float* feat = run_net_general<kSmemW>(nc, W, s_x, s_h0, s_h1, tile, ld, sdf_c);
    __syncthreads();   // the coarse network's reads of X are done
    if (nf.M != nc.M) pe_rows_general(nf.M, s_pts, s_x, tile, ld);
    grid_rows_general<kF32Tab>(nf, a.table_f, a.meta_f, a.scl_f, s_pts, s_x, tile, ld);
    if (nc.feat) {
      float* dst = s_x + (nf.n_pe + nf.L * nf.C) * ld;
      for (int i = t; i < nc.feat * tile; i += kGThreads)
        dst[(i / tile) * ld + i % tile] = feat[(i / tile) * ld + i % tile];
    }
    __syncthreads();
    run_net_general<kSmemW>(nf, W, s_x, s_h0, s_h1, tile, ld, sdf_f);
    if (t < tile && n0 + t < a.N) {
      // the fine clamp rounds the fine SDF to float32 first, as the plain
      // version does
      if (nf.clamp) sdf_f = (double)__fmul_rn(tanhf((float)sdf_f), 0.05f);
      a.out[n0 + t] = laplace((float)(sdf_c + sdf_f), s_beta[t]);
    }
  }
}


// the rows of X and of each hidden buffer that the two networks of desc
// need
__host__ inline void general_rows(const int* desc, int& x_rows, int& h_rows) {
  x_rows = h_rows = 4;
  for (int i = 0; i < 2; ++i) {
    const int* q = desc + i * kDescInts;
    const int n = q[0], d0 = q[5], feat = q[7];
    for (int l = 0; l + 1 < n && l + 1 < kMaxLayers; ++l)
      h_rows = std::max(h_rows, q[kDescHead + kMaxLayers + l] +
                                    (q[kDescHead + 2 * kMaxLayers + l + 1] ? d0 : 0));
    h_rows = std::max(h_rows, feat);
    x_rows = std::max(x_rows, round4(d0));
  }
}

// the largest tile (128, 64, 32 points) with the weights in shared memory,
// else the largest with the weights read through the caches; false when
// none fits in optin bytes
__host__ inline bool general_plan(int x_rows, int h_rows, int64_t w_floats, int optin,
                                  int& tile, int& w_smem) {
  const int tiles_try[3] = {128, 64, 32};
  for (int pass = 0; pass < 2; ++pass)
    for (int tt : tiles_try) {
      const int64_t ws = pass == 0 ? w_floats : 0;
      if (general_smem_floats(tt, x_rows, h_rows, (int)ws) * (int64_t)sizeof(float) <= optin) {
        tile = tt;
        w_smem = (int)ws;
        return true;
      }
    }
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
// desc, a HOST array of 2 kDescInts ints (ops/sdf_density.pack_general:
// coarse, then fine), w_floats the packed weights' floats (16-byte
// aligned); f32_tables: the tables are [T, C] float32 (the concat
// variant), else bfloat16. It takes the largest tile whose activations,
// and then the weights, fit in shared memory.
int nsl_sdf_density_general(const int* desc, const void* weights, int64_t w_floats,
                            const void* table_c, const void* meta_c, const void* scl_c,
                            const void* table_f, const void* meta_f, const void* scl_f,
                            int f32_tables, const void* xs, int res, const void* o,
                            const void* d, const void* z, int S, const void* counter,
                            int vres, float neg_b_1e4, float vd, float va, float vc,
                            const void* beta, const void* beta_scale, void* out, int64_t N,
                            void* stream) {
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
  for (int i = 0; i < 2; ++i) {
    const int* q = desc + i * kDescInts;
    NetDesc& nd = g.net[i];
    nd.n = q[0];
    nd.n_pe = q[1];
    nd.M = q[2];
    nd.L = q[3];
    nd.C = q[4];
    nd.d0 = q[5];
    nd.clamp = q[6];
    nd.feat = q[7];
    memcpy(&nd.df, q + 8, sizeof(float));
    if (nd.n < 1 || nd.n > kMaxLayers || nd.n_pe != 3 * (1 + 2 * nd.M) || nd.M > 30 ||
        nd.feat % 4 != 0 || (nd.L > 0 && !f32_tables && nd.C % 2 != 0))
      return (int)cudaErrorInvalidValue;
    for (int l = 0; l < nd.n; ++l) {
      nd.K[l] = q[kDescHead + l];
      nd.N[l] = q[kDescHead + kMaxLayers + l];
      nd.skip[l] = q[kDescHead + 2 * kMaxLayers + l];
      nd.off[l] = q[kDescHead + 3 * kMaxLayers + l];
      if (nd.off[l] % 4 != 0 || (l + 1 < nd.n && nd.N[l] % 4 != 0))
        return (int)cudaErrorInvalidValue;
    }
  }
  int x_rows, h_rows, tile = 0, w_smem = 0;
  general_rows(desc, x_rows, h_rows);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (!general_plan(x_rows, h_rows, w_floats, optin, tile, w_smem))
    return (int)cudaErrorInvalidConfiguration;
  g.tile = tile;
  g.ld = tile + 4;
  g.x_rows = x_rows;
  g.h_rows = h_rows;
  g.w_smem = w_smem;
  void (*kern)(const GArgs);
  if (f32_tables)
    kern = w_smem ? sdf_density_general_kernel<true, true> : sdf_density_general_kernel<true, false>;
  else
    kern = w_smem ? sdf_density_general_kernel<false, true> : sdf_density_general_kernel<false, false>;
  const size_t bytes =
      (size_t)general_smem_floats(tile, x_rows, h_rows, w_smem) * sizeof(float);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kGThreads, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (N + tile - 1) / tile;
  const int64_t most = (int64_t)sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < most ? tiles : most);
  kern<<<blocks, kGThreads, bytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// the tile and shared-memory bytes the general kernel takes for desc (0
// and -1 where nothing fits); a probe for the wrapper and chip_smoke.py
int nsl_sdf_density_general_plan(const int* desc, int64_t w_floats, int* tile_out,
                                 int64_t* bytes_out, int* w_smem_out) {
  int x_rows, h_rows, dev = 0, optin = 0, tile = 0, w_smem = 0;
  general_rows(desc, x_rows, h_rows);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const bool fits = general_plan(x_rows, h_rows, w_floats, optin, tile, w_smem);
  *tile_out = fits ? tile : 0;
  *bytes_out = fits ? general_smem_floats(tile, x_rows, h_rows, w_smem) * 4 : -1;
  *w_smem_out = w_smem;
  return 0;
}

}  // extern "C"
