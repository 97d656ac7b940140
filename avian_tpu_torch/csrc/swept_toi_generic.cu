// Kernel R (swept_toi.cuh) for the canonical pairs of AVIAN_PAIRS_GENERIC
// (pair_dispatch.cuh); one translation unit per group keeps the parallel
// build's wall time.
#include "swept_toi.cuh"

extern "C" int avian_swept_toi_generic(int code, int n, int m, const int* pairs, const int* swept,
                                     const float* pos0, const float* quat0, const float* sweep,
                                     const float* aa, const float* ang, const float* inner,
                                     const float* params, const int* shape_type,
                                     const int* body_idx, const unsigned char* active,
                                     const int* layer_m, const int* layer_f, const float* disc,
                                     const float* pool, float* toi, int* rounds, void* stream) {
  AVIAN_SWEPT_BODY(AVIAN_PAIRS_GENERIC)
}
