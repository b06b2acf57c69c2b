// TSDF integration of one depth frame for Hopper (sm_90a): K9.
//
// Replaces nicer_slam_tpu/preprocess/tsdf_fusion.py make_integrate_fn's
// `integrate` (:33-58), one fused jit per frame over the dense res^3 volume.
// Per voxel (i, j, k) at (xs[i], ys[j], zs[k]), flat index (i res + j) res + k:
//   c      = w2c[:3, :3] x + w2c[:3, 3]             (camera space)
//   u, v   = fx c_x / c_z + cx, fy c_y / c_z + cy    (rounded half to even)
//   inb    = c_z > 0 and (u, v) inside the frame
//   d      = depth[v, u] where inb, else 0
//   w_obs  = 1 where inb, 0 < d < depth_max and d - c_z > -trunc, else 0
//   tsdf   = (tsdf w + clip((d - c_z) / trunc, -1, 1) w_obs) / max(w + w_obs, 1e-9)
//            where w + w_obs > 0; w += w_obs
// in place on float32 tsdf and weight [res^3].
//
// What bounds it on the card: the bytes it must move. Every voxel's weight
// is read (4 bytes); only a voxel with weight or an observation (nw > 0)
// has its tsdf read and written (8 bytes), and only an observed one its
// weight written (4 bytes); the depth frame (3.3 MB at 680 x 1200) stays in
// L2 and the three coordinate arrays in L1. A frame observes a thin shell
// of the volume, so at 256^3 the weight read (67 MB, 0.020 ms at 3.35 TB/s)
// is most of it; the ~30 operations per voxel (0.5 GFLOP) are far below.
// A first design (a thread a voxel, a block a row, every voxel projected:
// 12 rounded products and sums, three IEEE divisions and a depth gather)
// ran at 25 % of that bound (0.0974 ms; PERF.md §6). Copies of it that
// each leave one part out (tools/torch_tsdf_ablate.py) show what held it
// back: not the divisions (taken as products: no faster) nor the gather
// (-5 %), but each thread's chain of dependent steps at 4 bytes in
// flight: without the projection it ran 38 % faster, and with nothing but
// the weight read and the held voxels' rewrite it still took 0.054 ms,
// twice the bound. So this design puts more bytes in flight and spends
// the instructions only where a voxel can be seen:
//   * a warp takes 256 voxels of one (i, j) row along k, each lane two
//     chunks of 4 (lane l: k0 + 4 l and k0 + 128 + 4 l), weight and tsdf
//     moved as float4, every weight load issued before anything waits on
//     one, and the tsdf of a chunk that holds a weight read right after;
//     blocks of 128 threads, registers capped for ten blocks an SM;
//   * each chunk's 128-voxel stretch is classed once, four lanes testing
//     its two ends: behind the camera (c_z <= 0 at both ends, with a
//     margin for float32 rounding), dark (one of the frame's four edge
//     tests, linear in z along the row, fails at both ends), or possibly
//     seen. In a stretch of the first two classes no voxel is observed:
//     its voxels do only the weight read and, where the weight is above 0,
//     the tsdf rewrite the formula gives with w_obs = 0, (tsdf w + obs 0)
//     / w, obs 0 being +0 behind the camera (d - c_z >= +0) and -0 in
//     front (d - c_z = -c_z < 0), which the voxel's c_z decides;
//   * in a stretch that may be seen, a voxel in front of the camera first
//     compares f c_x and f c_y against the frame's edges times c_z (a
//     margin of a pixel), and divides only if it may land in the frame; a
//     chunk's depth reads are issued together; the obs division is taken
//     only for an observation (otherwise obs 0 is a zero with obs's sign,
//     the sign of d - c_z, or NaN where that is NaN: a NaN depth pixel
//     gives NaN in both versions, as in the JAX package, where the first
//     design's fmaxf gave -1);
//   * the row's x and y terms of c are formed once a thread, in the same
//     order.
//
// It agrees with the plain version (ops/tsdf.py integrate_plain) bit for
// bit: every product and sum is rounded on its own (__fmul_rn/__fadd_rn,
// so nvcc contracts nothing into an FMA that the plain version's separate
// torch ops do not make), in the plain version's order; rounding is rintf
// (half to even, as torch.round and jnp.round; roundf rounds half away from
// zero); divisions are IEEE (__fdiv_rn).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kChunks = 2;  // chunks of E voxels a lane; a warp takes 32 E kChunks of a row

// the flat index of voxel (i, j, 0)
__device__ __forceinline__ int64_t row_base(int i, int j, int res) {
  return ((int64_t)i * res + j) * res;
}

template <int E>
__device__ __forceinline__ void load_chunk(const float* __restrict__ p, float v[E]) {
  if constexpr (E == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    v[0] = *p;
  }
}

template <int E>
__device__ __forceinline__ void store_chunk(float* __restrict__ p, const float v[E]) {
  if constexpr (E == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

// What a stretch of a row (x, y fixed, z from z0 to z1) can show the
// frame: 0 where no voxel of it can land in the frame (dark), 1 where,
// moreover, every voxel lies behind the camera (c_z <= 0), 2 where some
// voxel may be seen. Each test is a function of z that is linear along the
// row: c_z, and the four edge tests f c_x - (-1.5 - c_x0) c_z etc. that
// the kernel makes on rounded values; a test below 0 at both ends, by more
// than the float32 rounding of the kernel's operations and of these (2^-18
// of the sum of the magnitudes involved, with room), is below 0 at every
// voxel in between, as the kernel rounds it. NaN is never dark. Lane 2 c +
// e of the warp evaluates stretch c's end e (its z, the other end's z from
// lane 2 c + 1 - e): bit 0 of the result says c_z is below 0 there, bits 1
// to 4 the edge tests.
struct Edge {
  float fx, fy, lo_u, hi_u, lo_v, hi_v;
};

__device__ __forceinline__ unsigned end_tests(const float m[12], const float pxy[3],
                                              const float mag_xy[3], const Edge& ed, float z,
                                              float z_other) {
  float c[3], mag[3];
  const float zmax = fmaxf(fabsf(z), fabsf(z_other));
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    c[r] = __fadd_rn(__fadd_rn(pxy[r], __fmul_rn(m[4 * r + 2], z)), m[4 * r + 3]);
    mag[r] = mag_xy[r] + fabsf(m[4 * r + 2]) * zmax + fabsf(m[4 * r + 3]);
  }
  const float tiny = 1e-30f;
  unsigned bits = c[2] + (mag[2] * 0x1p-18f + tiny) <= 0.f ? 1u : 0u;
  // the four edges, each off the frame where a c_x (or c_y) + b c_z < 0:
  // f c_x < (-1.5 - c_x0) c_z, f c_x > (W + 0.5 - c_x0) c_z, and in y
  const float ax[4] = {ed.fx, -ed.fx, ed.fy, -ed.fy};
  const float bz[4] = {-ed.lo_u, ed.hi_u, -ed.lo_v, ed.hi_v};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = q < 2 ? 0 : 1;
    const float mg = (fabsf(ax[q]) * mag[r] + fabsf(bz[q]) * mag[2]) * 0x1p-18f + tiny;
    if (ax[q] * c[r] + bz[q] * c[2] + mg <= 0.f) bits |= 2u << q;
  }
  return bits;
}

// E voxels a chunk (4: float4 rows, res % 4 == 0; else 1); lane l's chunk
// c covers voxels k0 + 32 E c + E l .. + E - 1 of the warp's row
template <int E>
__global__ void __launch_bounds__(32 * kWarps, 10)
    tsdf_integrate_kernel(float* __restrict__ tsdf, float* __restrict__ weight,
                          const float* __restrict__ depth, const float* __restrict__ w2c,
                          const float* __restrict__ K, const float* __restrict__ xs,
                          const float* __restrict__ ys, const float* __restrict__ zs, int res,
                          int H, int W, float trunc, float depth_max) {
  constexpr int SEG = 32 * E * kChunks;
  const int lane = threadIdx.x & 31;
  const int per_row = (res + SEG - 1) / SEG;
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t row = seg / per_row;  // i res + j
  if (row >= (int64_t)res * res) return;
  const int k0 = (int)(seg - row * per_row) * SEG;
  const int i = (int)(row / res), j = (int)(row - (int64_t)i * res);

  // 1. the lane's weights, every chunk, before anything waits on them
  float w[kChunks][E];
  int kc[kChunks];
  bool live[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    kc[c] = k0 + 32 * E * c + E * lane;
    live[c] = kc[c] < res;
    if (live[c]) load_chunk<E>(weight + row * res + kc[c], w[c]);
  }
  const float x = __ldg(xs + i), y = __ldg(ys + j);
  float m[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) m[q] = __ldg(w2c + q);
  // the row's x and y terms of c, formed as the plain version forms them
  float pxy[3], mag_xy[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float px = __fmul_rn(m[4 * r], x), py = __fmul_rn(m[4 * r + 1], y);
    pxy[r] = __fadd_rn(px, py);
    mag_xy[r] = fabsf(px) + fabsf(py);
  }
  const float fx = __ldg(K), cx0 = __ldg(K + 2), fy = __ldg(K + 4), cy0 = __ldg(K + 5);
  // u < -1.5 or u > W + 0.5 (v alike) rounds off the frame whatever the
  // divisions' last bits
  const Edge ed{fx, fy, __fsub_rn(-1.5f, cx0), __fsub_rn((float)W + 0.5f, cx0),
                __fsub_rn(-1.5f, cy0), __fsub_rn((float)H + 0.5f, cy0)};

  // 2. what each chunk's 32 E-voxel stretch can show (with trunc > 0, so
  // that obs 0 is a zero with d - c_z's sign), its two ends on two lanes;
  // 3. the tsdf of every chunk that holds a weight, early
  unsigned both;
  {
    const int tc = min(lane >> 1, kChunks - 1), te = lane & 1;
    const int a0 = min(k0 + 32 * E * tc, res - 1), a1 = min(a0 + 32 * E, res) - 1;
    const float z = __ldg(zs + (te ? a1 : a0)), zo = __ldg(zs + (te ? a0 : a1));
    const unsigned bits = end_tests(m, pxy, mag_xy, ed, z, zo);
    both = bits & __shfl_xor_sync(0xffffffffu, bits, 1);
  }
  int view[kChunks];
  bool held[kChunks];
  float t[kChunks][E];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned bc = __shfl_sync(0xffffffffu, both, 2 * c);
    view[c] = !(trunc > 0.f) ? 2 : (bc & 1u) ? 1 : (bc & 30u) ? 0 : 2;
    held[c] = false;
#pragma unroll
    for (int e = 0; e < E; ++e) held[c] |= live[c] && w[c][e] > 0.f;
    if (held[c]) load_chunk<E>(tsdf + row * res + kc[c], t[c]);
  }

#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!live[c]) continue;
    const int64_t n = row * res + kc[c];
    if (view[c] < 2) {
      // no voxel observed: (tsdf w + obs 0) / w where w > 0, obs 0 +0
      // behind the camera (c_z <= 0 makes d - c_z >= +0) and -0 in front
      // (d - c_z = -c_z < 0); the weights stay
      if (!held[c]) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!(w[c][e] > 0.f)) continue;
        float zero = 0.f;
        if (view[c] == 0) {
          const float z = __ldg(zs + kc[c] + e);
          const float cz = __fadd_rn(__fadd_rn(pxy[2], __fmul_rn(m[10], z)), m[11]);
          zero = cz > 0.f ? -0.f : 0.f;
        }
        const float nw = __fadd_rn(w[c][e], 0.f);
        t[c][e] = __fdiv_rn(__fadd_rn(__fmul_rn(t[c][e], w[c][e]), zero), fmaxf(nw, 1e-9f));
      }
      store_chunk<E>(tsdf + n, t[c]);
      continue;
    }
    // each voxel's pixel (a voxel a pixel or more off the frame divides
    // not), then the depth reads together, then obs
    float cz[E], d[E];
    bool inb[E];
    int pix[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float z = __ldg(zs + kc[c] + e);
      float cc[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        cc[r] = __fadd_rn(__fadd_rn(pxy[r], __fmul_rn(m[4 * r + 2], z)), m[4 * r + 3]);
      cz[e] = cc[2];
      inb[e] = false;
      pix[e] = 0;
      if (cc[2] > 0.f) {
        const float a = __fmul_rn(fx, cc[0]), b = __fmul_rn(fy, cc[1]);
        const bool off = cc[2] >= 1e-30f &&
                         (a < __fmul_rn(ed.lo_u, cc[2]) || a > __fmul_rn(ed.hi_u, cc[2]) ||
                          b < __fmul_rn(ed.lo_v, cc[2]) || b > __fmul_rn(ed.hi_v, cc[2]));
        if (!off) {
          const float ui = rintf(__fadd_rn(__fdiv_rn(a, cc[2]), cx0));
          const float vi = rintf(__fadd_rn(__fdiv_rn(b, cc[2]), cy0));
          inb[e] = ui >= 0.f && ui < (float)W && vi >= 0.f && vi < (float)H;
          pix[e] = inb[e] ? (int)vi * W + (int)ui : 0;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = inb[e] ? __ldg(depth + pix[e]) : 0.f;
    float term[E], nw[E];
    bool valid[E], any_nw = false, any_valid = false;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float sdf = __fsub_rn(d[e], cz[e]);
      valid[e] = inb[e] && d[e] > 0.f && d[e] < depth_max && sdf > -trunc;
      // obs w_obs: obs where observed, else obs 0, a zero with obs's sign
      // (NaN for a NaN d - c_z: the plain version's clamp keeps NaN)
      if (valid[e] || !(trunc > 0.f)) {
        const float q = __fdiv_rn(sdf, trunc);
        const float obs = isnan(q) ? q : fminf(fmaxf(q, -1.f), 1.f);
        term[e] = __fmul_rn(obs, valid[e] ? 1.f : 0.f);
      } else {
        term[e] = isnan(sdf) ? sdf : (signbit(sdf) ? -0.f : 0.f);
      }
      nw[e] = __fadd_rn(w[c][e], valid[e] ? 1.f : 0.f);
      any_nw |= nw[e] > 0.f;
      any_valid |= valid[e];
    }
    if (!any_nw) continue;  // no weight before or after: nothing changes
    if (!held[c]) load_chunk<E>(tsdf + n, t[c]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (nw[e] > 0.f)
        t[c][e] = __fdiv_rn(__fadd_rn(__fmul_rn(t[c][e], w[c][e]), term[e]),
                            fmaxf(nw[e], 1e-9f));
      if (valid[e]) w[c][e] = nw[e];
    }
    store_chunk<E>(tsdf + n, t[c]);
    if (any_valid) store_chunk<E>(weight + n, w[c]);
  }
}

}  // namespace

extern "C" {

// tsdf, weight [res^3] float32 (updated in place, 16-byte aligned), depth
// [H, W], w2c [4, 4], K [3, 3], xs/ys/zs [res] float32
int nsl_tsdf_integrate(void* tsdf, void* weight, const void* depth, const void* w2c,
                       const void* K, const void* xs, const void* ys, const void* zs,
                       int res, int H, int W, float trunc, float depth_max, void* stream) {
  if (res <= 0) return 0;
  const bool vec = res % 4 == 0 && ((uintptr_t)tsdf % 16) == 0 && ((uintptr_t)weight % 16) == 0;
  const int E = vec ? 4 : 1;
  const int64_t segs = (int64_t)res * res * ((res + 32 * E * kChunks - 1) / (32 * E * kChunks));
  const unsigned blocks = (unsigned)((segs + kWarps - 1) / kWarps);
  const cudaStream_t s = (cudaStream_t)stream;
#define NSL_TSDF_ARGS                                                                       \
  (float*)tsdf, (float*)weight, (const float*)depth, (const float*)w2c, (const float*)K,    \
      (const float*)xs, (const float*)ys, (const float*)zs, res, H, W, trunc, depth_max
  if (vec) tsdf_integrate_kernel<4><<<blocks, 32 * kWarps, 0, s>>>(NSL_TSDF_ARGS);
  else tsdf_integrate_kernel<1><<<blocks, 32 * kWarps, 0, s>>>(NSL_TSDF_ARGS);
#undef NSL_TSDF_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
