// Kernel U, first launch: the 2D grid sweep and the global pass's test.
//
// Replaces the window loop and the global candidate test of
// avian_tpu/dim2/broadphase_impl.py::grid_pairs_2d (:82-113, :135-160). One
// thread per sorted grid entry (d2::sweep_entry: its candidate bits, their
// popcount, its rank in its cell run, counted into the window overflow with
// an int32 atomicAdd) and one per (global, collider) candidate. The slots and
// the finish are Kernel L's pair_slots and pair_finish (compact_pairs.cu),
// which do not depend on the dimension. Bound by the loads of neighbouring
// entries, shared through L1.
#include "dim2.cuh"

namespace {

__global__ void grid_counts_2d_kernel(
    int n_e, int w, int g_cap, int m, const int* __restrict__ skey, const float* __restrict__ sf,
    const int* __restrict__ si, const float* __restrict__ aabb_min,
    const float* __restrict__ aabb_max, const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ is_global, const unsigned char* __restrict__ dyn,
    const int* __restrict__ body, const int* __restrict__ members, const int* __restrict__ filt,
    const long long* __restrict__ g_idx, const unsigned char* __restrict__ g_valid,
    long long* __restrict__ bits, int* __restrict__ cnt, int* __restrict__ gflag,
    int* __restrict__ window_overflow) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_e) {
    int rank;
    unsigned int mask = d2::sweep_entry((int)t, n_e, w, skey, sf, si, rank);
    bits[t] = (long long)mask;
    cnt[t] = __popc(mask);
    if (rank > w && skey[t] != d2::kSentinel) atomicAdd(window_overflow, 1);
  }
  if (t < (long)g_cap * m) {
    int g = (int)(t / m), i = (int)(t % m);
    gflag[t] = d2::global_candidate((int)g_idx[g], i, g_valid[g] != 0, aabb_min, aabb_max, active,
                                    is_global, dyn, body, members, filt) ? 1 : 0;
  }
}

}  // namespace

extern "C" int avian_grid_counts_2d(int n_e, int w, int g_cap, int m, const int* skey,
                                    const float* sf, const int* si, const float* aabb_min,
                                    const float* aabb_max, const unsigned char* active,
                                    const unsigned char* is_global, const unsigned char* dyn,
                                    const int* body, const int* members, const int* filt,
                                    const long long* g_idx, const unsigned char* g_valid,
                                    long long* bits, int* cnt, int* gflag, int* window_overflow,
                                    void* stream) {
  const int threads = 256;
  long n = n_e > (long)g_cap * m ? n_e : (long)g_cap * m;
  grid_counts_2d_kernel<<<(int)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      n_e, w, g_cap, m, skey, sf, si, aabb_min, aabb_max, active, is_global, dyn, body, members,
      filt, g_idx, g_valid, bits, cnt, gflag, window_overflow);
  return (int)cudaGetLastError();
}
