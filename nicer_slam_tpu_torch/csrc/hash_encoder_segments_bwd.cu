// K1/K2 backwards at every channel count other than 2, 4, 8 (the
// forwards and the design are in hash_encoder_segments.cu): the backward
// kernel of hash_kernels.cuh with SEG set, in a source of its own so that the build
// compiles it beside the others; and the backward on bf16 rows (the
// sharded colour encode) at every even C other than those, in segments of
// 8, 4 or 2 channels as K3. Called by hash_encoder.cu's entry points,
// which check L and C and pick CS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_kernels.cuh"

extern "C" {

int nsl_hash_bwd_segments(const float* x, const float* table, const int* meta,
                          const float* scl, const float* g_feat, const float* g_dfeat,
                          float* g_table, float* g_x, long long* acc, int64_t N, int L,
                          int C, int CS, float size, int64_t T, cudaStream_t s) {
  auto args = [&](auto launch) {
    return launch(x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, acc, N, L, C, size, T,
                  s);
  };
  switch (CS) {
    case 1: return args(launch_bwd<1, true>);
    case 2: return args(launch_bwd<2, true>);
    case 3: return args(launch_bwd<3, true>);
    case 4: return args(launch_bwd<4, true>);
    case 5: return args(launch_bwd<5, true>);
    case 6: return args(launch_bwd<6, true>);
    case 7: return args(launch_bwd<7, true>);
    case 8: return args(launch_bwd<8, true>);
    default: return (int)cudaErrorInvalidValue;
  }
}

int nsl_hash_bf16_bwd_segments(const float* x, const uint16_t* table, const int* meta,
                               const float* scl, const float* g_feat, float* g_table,
                               float* g_x, long long* acc, int64_t N, int L, int C, int CS,
                               float size, int64_t T, cudaStream_t s) {
  auto args = [&](auto launch) {
    return launch(x, table, meta, scl, g_feat, g_table, g_x, acc, N, L, C, size, T, s);
  };
  switch (CS) {
    case 2: return args(launch_bf16_bwd<2, true>);
    case 4: return args(launch_bf16_bwd<4, true>);
    case 8: return args(launch_bf16_bwd<8, true>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
