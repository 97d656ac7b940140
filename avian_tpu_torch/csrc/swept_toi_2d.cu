// Kernel AB: the 2D engine's swept-CCD times of impact, one thread per
// (swept collider, collider) pair of the K x M grid.
//
// Replaces the grid of avian_tpu/dim2/ccd.py::solve_swept_ccd_2d (:28;
// toi_one :70, vs_other :72, body_fn :87): 8 rounds of conservative
// advancement in relative motion on Kernel V's manifold of the two colliders
// posed at t (d2::swept_toi_pair_2d in dim2.cuh, which calls V's
// d2::pair_manifold_at). Each thread writes min(TOI, 1) of its pair to
// toi[r * m + j] and, where `rounds` is not null, the rounds it ran (negated
// where a valid pair ran them all without a hit and stayed below t = 1), and
// lowers its body's entry of body_toi to its TOI with an integer atomicMin on
// the float's bits: the TOIs are non-negative, so the integer order is the
// float order, and the minimum is exact and the same in any order. A round is
// one manifold (at most some 1,500 operations for a polygon pair) on
// registers; the pair reads its two colliders' rows once, so the kernel is
// bound by operations and latency, not by bytes.
#include "dim2.cuh"

namespace {

__global__ void swept_toi_2d_kernel(int k_n, int m, const int* __restrict__ swept,
                                    d2::SweptTables2 T, float* __restrict__ toi,
                                    int* __restrict__ rounds, float* __restrict__ body_toi) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= k_n * m) return;
  int r = p / m;
  int j = p - r * m;
  int i = swept[r];
  int ran;
  float t = d2::swept_toi_pair_2d(i, j, T, &ran);
  toi[p] = t;
  if (rounds) rounds[p] = ran;
  if (t < 1.0f) atomicMin(reinterpret_cast<int*>(body_toi) + T.body_idx[i], __float_as_int(t));
}

}  // namespace

extern "C" int avian_swept_toi_2d(int k_n, int m, const int* swept, const float* pos0,
                                  const float* cs0, const float* angle0, const float* sweep,
                                  const float* dang, const float* ang, const float* inner,
                                  const float* verts, const int* count, const float* radius,
                                  const unsigned char* plane, const int* body_idx,
                                  const unsigned char* active, const int* layer_m,
                                  const int* layer_f, float* toi, int* rounds, float* body_toi,
                                  void* stream) {
  d2::SweptTables2 T{pos0,  cs0,    angle0, sweep,    dang,   ang,     inner,  verts,
                     count, radius, plane,  body_idx, active, layer_m, layer_f};
  const int threads = 64;
  int n = k_n * m;
  if (n == 0) return 0;
  swept_toi_2d_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      k_n, m, swept, T, toi, rounds, body_toi);
  return (int)cudaGetLastError();
}
