// Kernel AD: the 2D engine's point projections, one thread per (point,
// collider).
//
// Replaces avian_tpu/dim2/queries.py::_point_one (:356, over
// avian_tpu/dim2/narrowphase.py::_closest_on_poly :113) as project_point
// (:373) and point_intersections (:400) call it for every collider under
// vmap: the signed distance from the point to the collider's rounded surface
// (negative inside) and the surface point closest to it. Each thread reads
// its point (8 bytes) and its collider (about 90 bytes) and writes 12 bytes;
// it projects the point on each of the collider's edges, some 190 arithmetic
// operations on a box, so the kernel is bound by the bytes it writes, a
// little more than by its operations. The device code is d2::point_one in
// dim2.cuh, with d2::closest_on_poly, which Kernel V's circle/polygon pairs
// share.
#include "dim2.cuh"

namespace {

__global__ void point_2d_kernel(int p_n, int m, const float* __restrict__ points,
                                const float* __restrict__ pos, const float* __restrict__ cs,
                                const float* __restrict__ verts, const int* __restrict__ count,
                                const float* __restrict__ radius,
                                const unsigned char* __restrict__ plane, float* __restrict__ dist,
                                float* __restrict__ surf) {
  long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long)p_n * m) return;
  int i = (int)(k / m);
  int j = (int)(k - (long)i * m);
  d2::Poly q;
  d2::load_collider(q, j, pos, cs, verts, count, radius);
  d2::V2 c;
  dist[k] = d2::point_one(d2::load2(points + 2 * i), q, plane[j] != 0, d2::load2(pos + 2 * j),
                          d2::plane_normal(j, cs, verts), &c);
  d2::store2(surf + 2 * k, c);
}

}  // namespace

extern "C" int avian_point_2d(int p_n, int m, const float* points, const float* pos,
                              const float* cs, const float* verts, const int* count,
                              const float* radius, const unsigned char* plane, float* dist,
                              float* surf, void* stream) {
  const int threads = 128;
  long n = (long)p_n * m;
  if (n == 0) return 0;
  point_2d_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      p_n, m, points, pos, cs, verts, count, radius, plane, dist, surf);
  return (int)cudaGetLastError();
}
