// Kernel S (shape_cast.cuh) for the canonical pairs of AVIAN_PAIRS_HULL
// (pair_dispatch.cuh); one translation unit per group keeps the parallel
// build's wall time.
#include "shape_cast.cuh"

extern "C" int avian_shape_cast_hull(int code, int n, int st, int overlap, const int* cols,
                                      const float* query, const float* pos, const float* quat,
                                      const float* params, const int* shape_type,
                                      const float* disc, const float* pool, float* t_out,
                                      unsigned char* hit_out, float* pa_out, float* pb_out,
                                      float* n_out, int* rounds, void* stream) {
  AVIAN_CAST_BODY(AVIAN_PAIRS_HULL)
}
