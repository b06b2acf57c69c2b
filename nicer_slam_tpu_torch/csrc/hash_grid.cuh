// Hash-grid geometry and the bf16 row loader, shared by the encode kernels
// (hash_encoder.cu: K1, K2, K3) and the fused SDF-to-density kernel
// (sdf_density.cu), so both read a grid with the same arithmetic.
//
// Semantics (reference hashencoder.cu): level l has scale s_l and
// resolution r_l; u = (x + size) / (2 size); pos = u s_l; smoothstep
// weights wb = f^2 (3 - 2f) per dim; 8 corners; dense index
// x + y r + z r^2 or hashed xor(x*1, y*2654435761, z*805459861), both
// mod the level size, in uint32 arithmetic (the wrap is native here).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nsl {

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

// corner weight w and dw/dx_d
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

// one [T, C] bf16 row: one 4-, 8- or 16-byte load, widened exactly (a bf16
// is the top half of a float32)

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// C bf16 values at p (C in {2, 4, 8}; p aligned to 2 C bytes)
template <int C>
__device__ __forceinline__ void load_bf16_vec(const uint16_t* __restrict__ p, float v[C]) {
  uint32_t ws[C / 2];
  if constexpr (C == 2) {
    ws[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else if constexpr (C == 4) {
    uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    ws[0] = w.x;
    ws[1] = w.y;
  } else {
    uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    ws[0] = w.x;
    ws[1] = w.y;
    ws[2] = w.z;
    ws[3] = w.w;
  }
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    v[2 * i] = bf16_lo(ws[i]);
    v[2 * i + 1] = bf16_hi(ws[i]);
  }
}

template <int C>
__device__ __forceinline__ void load_bf16_row(const uint16_t* __restrict__ t,
                                              uint32_t row, float v[C]) {
  load_bf16_vec<C>(t + (size_t)row * C, v);
}

}  // namespace nsl
