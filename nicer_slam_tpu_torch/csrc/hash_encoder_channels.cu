// K1/K2 at the channel counts no shipped grid has (C = 1, 3, 5, 6, 7; the
// shipped grids' 2, 4, 8 are in hash_encoder.cu): the same kernels
// (hash_kernels.cuh), compiled in a source of their own so that the build
// compiles them beside hash_encoder.cu rather than after it. Called by
// hash_encoder.cu's entry points, which check L and the operands.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_kernels.cuh"

extern "C" {

int nsl_hash_fwd_channels(const float* x, const float* table, const int* meta,
                          const float* scl, float* feats, float* dfeat, int64_t N, int L,
                          int C, float size, cudaStream_t s) {
  switch (C) {
    case 1: return launch_fwd<1>(x, table, meta, scl, feats, dfeat, N, L, size, s);
    case 3: return launch_fwd<3>(x, table, meta, scl, feats, dfeat, N, L, size, s);
    case 5: return launch_fwd<5>(x, table, meta, scl, feats, dfeat, N, L, size, s);
    case 6: return launch_fwd<6>(x, table, meta, scl, feats, dfeat, N, L, size, s);
    case 7: return launch_fwd<7>(x, table, meta, scl, feats, dfeat, N, L, size, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int nsl_hash_bwd_channels(const float* x, const float* table, const int* meta,
                          const float* scl, const float* g_feat, const float* g_dfeat,
                          float* g_table, float* g_x, long long* acc, int64_t N, int L,
                          int C, float size, int64_t T, cudaStream_t s) {
  switch (C) {
    case 1:
      return launch_bwd<1>(x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, acc, N, L,
                           size, T, s);
    case 3:
      return launch_bwd<3>(x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, acc, N, L,
                           size, T, s);
    case 5:
      return launch_bwd<5>(x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, acc, N, L,
                           size, T, s);
    case 6:
      return launch_bwd<6>(x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, acc, N, L,
                           size, T, s);
    case 7:
      return launch_bwd<7>(x, table, meta, scl, g_feat, g_dfeat, g_table, g_x, acc, N, L,
                           size, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
