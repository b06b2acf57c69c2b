// K1/K2 forwards at every channel count other than 2, 4, 8, and K3 at
// every even one other than those: a level's C channels walked in
// segments of CS (the largest divisor of C up to 8, so one segment for
// C < 8; K3: 8, 4 or 2), one warp per (level, segment) pair, the kernels
// of hash_kernels.cuh with SEG set (a row C channels wide, a warp's
// segment from channel c0); the backwards are in
// hash_encoder_segments_bwd.cu. Sources of their own, so the build
// compiles them beside hash_encoder.cu. Called by hash_encoder.cu's entry
// points, which check L and C and pick CS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_kernels.cuh"

extern "C" {

int nsl_hash_fwd_segments(const float* x, const float* table, const int* meta,
                          const float* scl, float* feats, float* dfeat, int64_t N, int L,
                          int C, int CS, float size, cudaStream_t s) {
  auto args = [&](auto launch) {
    return launch(x, table, meta, scl, feats, dfeat, N, L, C, size, s);
  };
  switch (CS) {
    case 1: return args(launch_fwd<1, true>);
    case 2: return args(launch_fwd<2, true>);
    case 3: return args(launch_fwd<3, true>);
    case 4: return args(launch_fwd<4, true>);
    case 5: return args(launch_fwd<5, true>);
    case 6: return args(launch_fwd<6, true>);
    case 7: return args(launch_fwd<7, true>);
    case 8: return args(launch_fwd<8, true>);
    default: return (int)cudaErrorInvalidValue;
  }
}

int nsl_hash_bf16_segments(const float* x, const uint16_t* table, const int* meta,
                           const float* scl, float* feats, int64_t N, int L, int C, int CS,
                           float size, cudaStream_t s) {
  auto args = [&](auto launch) { return launch(x, table, meta, scl, feats, N, L, C, size, s); };
  switch (CS) {
    case 2: return args(launch_bf16_fwd<2, true>);
    case 4: return args(launch_bf16_fwd<4, true>);
    case 8: return args(launch_bf16_fwd<8, true>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
