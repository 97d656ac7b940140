// Kernel AI (toi_pair.cuh) for the canonical pairs of AVIAN_PAIRS_ANALYTIC
// (pair_dispatch.cuh); one translation unit per group keeps the parallel
// build's wall time.
#include "toi_pair.cuh"

extern "C" int avian_toi_pair_analytic(int code, int n, int iters, const int* idx, const int* type_a,
                                 const int* type_b, const float* pos_a, const float* quat_a,
                                 const float* prm_a, const float* pos_b, const float* quat_b,
                                 const float* prm_b, const float* rel, const float* max_t,
                                 const float* disc, const float* pool, unsigned char* hit_out,
                                 float* t_out, int* rounds, void* stream) {
  AVIAN_TOI_BODY(AVIAN_PAIRS_ANALYTIC)
}
