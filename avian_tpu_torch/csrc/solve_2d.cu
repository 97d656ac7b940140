// Kernel Y: one colour of the 2D engine's contact solver, one thread a row.
//
// Replaces, per colour, avian_tpu/dim2/solver.py::warm_start (:275, mode 0),
// _solve_bucket (:344, modes 1 = bias and 2 = relax) and _restitution_bucket
// (:483, mode 3); the row's work is d2::solve_row_2d in dim2.cuh. Kernel D's
// rules (solve_color.cu): a padded row writes nothing; an end with zero
// inverse mass and inertia is not written; colours before the last share no
// dynamic body and add their deltas directly; the last colour writes its
// deltas to scratch and a second kernel adds them per body in the fixed
// [a-sides..., b-sides...] order. No float atomics. Bound by launch latency
// and the dependent gathers of body state.
#include "dim2.cuh"

namespace {

__global__ void solve_2d_kernel(int mode, int color, int cap, int last, float* __restrict__ state,
                                const float* __restrict__ data, float* __restrict__ imp,
                                const int* __restrict__ bucket_a,
                                const int* __restrict__ bucket_b,
                                const unsigned char* __restrict__ valid,
                                const float* __restrict__ relax, float* __restrict__ scratch,
                                d2::SolveParams2 p) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= cap) return;
  long g = (long)color * cap + row;
  if (!valid[g]) return;
  const float* d = data + g * d2::D;
  float* ir = imp + g * d2::IMP;
  float* sa = state + (long)bucket_a[g] * d2::STATE;
  float* sb = state + (long)bucket_b[g] * d2::STATE;
  float ra[d2::STATE], rb[d2::STATE];
  for (int k = 0; k < d2::STATE; ++k) {
    ra[k] = sa[k];
    rb[k] = sb[k];
  }
  d2::Deltas2 dl;
  float out[d2::IMP];
  d2::solve_row_2d(mode, d, ir, ra, rb, relax[g], p, dl, out);
  if (mode != d2::kWarm)
    for (int k = 0; k < d2::IMP; ++k) ir[k] = out[k];
  if (last) {
    float* s0 = scratch + 3 * (long)row;
    float* s1 = scratch + 3 * ((long)cap + row);
    s0[0] = dl.vax;
    s0[1] = dl.vay;
    s0[2] = dl.wa;
    s1[0] = dl.vbx;
    s1[1] = dl.vby;
    s1[2] = dl.wb;
    return;
  }
  if (d2::writes2(d + d2::IMA, d[d2::IIA])) {
    sa[0] += dl.vax;
    sa[1] += dl.vay;
    sa[2] += dl.wa;
  }
  if (d2::writes2(d + d2::IMB, d[d2::IIB])) {
    sb[0] += dl.vbx;
    sb[1] += dl.vby;
    sb[2] += dl.wb;
  }
}

// Phase 2 of the overflow colour: per body, add its rows' deltas in order.
__global__ void overflow_reduce_2d_kernel(int entries, int n_bodies, float* __restrict__ state,
                                          const int* __restrict__ order,
                                          const int* __restrict__ key,
                                          const float* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  int body = key[i];
  if (body >= n_bodies || (i > 0 && key[i - 1] == body)) return;
  float* s = state + (long)body * d2::STATE;
  float v[3] = {s[0], s[1], s[2]};
  for (int j = i; j < entries && key[j] == body; ++j) {
    const float* src = scratch + 3 * (long)order[j];
    for (int k = 0; k < 3; ++k) v[k] += src[k];
  }
  for (int k = 0; k < 3; ++k) s[k] = v[k];
}

}  // namespace

extern "C" int avian_solve_2d(int mode, int color, int colors, int cap, int n_bodies,
                              float* state, const float* data, float* imp, const int* bucket_a,
                              const int* bucket_b, const unsigned char* valid,
                              const float* relax, const int* ovf_order, const int* ovf_key,
                              float* scratch, float h, float max_overlap, float stiction_t2,
                              float warm_coeff, float rest_threshold, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  int last = color == colors - 1;
  d2::SolveParams2 p{h, max_overlap, stiction_t2, warm_coeff, rest_threshold};
  solve_2d_kernel<<<(cap + threads - 1) / threads, threads, 0, s>>>(
      mode, color, cap, last, state, data, imp, bucket_a, bucket_b, valid, relax, scratch, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  overflow_reduce_2d_kernel<<<(2 * cap + threads - 1) / threads, threads, 0, s>>>(
      2 * cap, n_bodies, state, ovf_order, ovf_key, scratch);
  return (int)cudaGetLastError();
}
