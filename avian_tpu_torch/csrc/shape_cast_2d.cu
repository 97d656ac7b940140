// Kernel AE: the 2D engine's shape casts and query manifolds, one thread per
// collider.
//
// Replaces avian_tpu/dim2/queries.py::_sweep_all (:500-544): up to 24 rounds
// (_CAST_ITERS) of conservative advancement of the query shape (at most 8
// vertices and a radius) along its cast against each collider, on Kernel V's
// manifold (d2::pair_manifold_at in dim2.cuh, side a read from the query
// shape's own arrays, the collider's angle as its cosine and sine); with 0
// rounds, the one manifold of _manifold_vs_all (:447), which
// shape_intersections (:460) and the character's depenetration read. Each
// thread reads the query (some 100 bytes, the same for all) and its collider
// (about 90 bytes) and writes 45 bytes; a round is one manifold (up to some
// 1,500 operations for a polygon pair) on registers, so the kernel is bound
// by operations and latency. The device code is d2::shape_cast_one.
#include "dim2.cuh"

namespace {

__global__ void shape_cast_2d_kernel(int m, int rounds, const float* __restrict__ query,
                                     const float* __restrict__ q_verts,
                                     const int* __restrict__ q_count,
                                     const float* __restrict__ q_radius,
                                     const float* __restrict__ pos, const float* __restrict__ cs,
                                     const float* __restrict__ verts,
                                     const int* __restrict__ count,
                                     const float* __restrict__ radius,
                                     const unsigned char* __restrict__ plane, float* t,
                                     unsigned char* hit, float* point_a, float* point_b,
                                     float* normal, float* sep, int* n_points, int* ran) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  d2::Query2 q{d2::load2(query), query[2], query[3], d2::load2(query + 4),
               query[6],          query[7], q_verts,  *q_count,
               *q_radius};
  d2::Cast2 c = d2::shape_cast_one(j, q, rounds, pos, cs, verts, count, radius, plane);
  t[j] = c.t;
  hit[j] = c.hit;
  d2::store2(point_a + 2 * j, c.pa);
  d2::store2(point_b + 2 * j, c.pb);
  d2::store2(normal + 2 * j, c.normal);
  sep[j] = c.sep;
  n_points[j] = c.count;
  if (ran) ran[j] = c.rounds;
}

}  // namespace

extern "C" int avian_shape_cast_2d(int m, int rounds, const float* query, const float* q_verts,
                                   const int* q_count, const float* q_radius, const float* pos,
                                   const float* cs, const float* verts, const int* count,
                                   const float* radius, const unsigned char* plane, float* t,
                                   unsigned char* hit, float* point_a, float* point_b,
                                   float* normal, float* sep, int* n_points, int* ran,
                                   void* stream) {
  const int threads = 64;
  if (m == 0) return 0;
  shape_cast_2d_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      m, rounds, query, q_verts, q_count, q_radius, pos, cs, verts, count, radius, plane, t, hit,
      point_a, point_b, normal, sep, n_points, ran);
  return (int)cudaGetLastError();
}
