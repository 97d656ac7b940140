// Kernel V: manifolds of the 2D engine's rounded-polygon pairs, one thread a
// pair. Replaces avian_tpu/dim2/narrowphase.py::compute_manifold_2d (:339);
// the device code is d2::pair_manifold in dim2.cuh, which computes only the
// pair's own kind where the reference computes all six and selects. Bound by
// operations for polygon pairs (two 8 x 8 SATs), by bytes for the rest.
#include "dim2.cuh"

namespace {

__global__ void manifold_2d_kernel(int k_n, const long long* __restrict__ ca,
                                   const long long* __restrict__ cb,
                                   const float* __restrict__ pos, const float* __restrict__ cs,
                                   const float* __restrict__ verts, const int* __restrict__ count,
                                   const float* __restrict__ radius,
                                   const unsigned char* __restrict__ plane, float* normal,
                                   float* point_a, float* point_b, float* separation,
                                   int* feature_id, int* n_points) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_n) return;
  d2::manifold_2d_pair(k, ca, cb, pos, cs, verts, count, radius, plane, normal, point_a,
                       point_b, separation, feature_id, n_points);
}

}  // namespace

extern "C" int avian_manifold_2d(int k_n, const long long* ca, const long long* cb,
                                 const float* pos, const float* cs, const float* verts,
                                 const int* count, const float* radius,
                                 const unsigned char* plane, float* normal, float* point_a,
                                 float* point_b, float* separation, int* feature_id,
                                 int* n_points, void* stream) {
  const int threads = 128;
  manifold_2d_kernel<<<(k_n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      k_n, ca, cb, pos, cs, verts, count, radius, plane, normal, point_a, point_b, separation,
      feature_id, n_points);
  return (int)cudaGetLastError();
}
