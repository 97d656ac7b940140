// Kernel AC: the 2D engine's ray casts, one thread per (ray, collider).
//
// Replaces avian_tpu/dim2/queries.py::_ray_rounded_poly (:164, with _slab
// :143) as _all_ray_hits (:289) calls it for every collider under vmap: the
// exact first hit of a ray on a rounded convex polygon (the union of its core
// polygon, one disk a vertex and one rectangle an edge) or on a half-space,
// solid or hollow. Each thread reads its ray (16 bytes) and its collider (its
// pose, 8 vertices, count, radius: about 90 bytes) and writes t and the
// normal (12 bytes); for each of the collider's edges it computes a
// four-face slab and the core's face, and a disk a vertex where the radius is
// above 0: some 350 arithmetic operations on a box, so the kernel is bound by
// operations.
// The device code is d2::ray_rounded_poly and d2::ray_plane in dim2.cuh.
#include "dim2.cuh"

namespace {

__global__ void ray_cast_2d_kernel(int r_n, int m, const float* __restrict__ rays, int solid,
                                   const float* __restrict__ pos, const float* __restrict__ cs,
                                   const float* __restrict__ verts, const int* __restrict__ count,
                                   const float* __restrict__ radius,
                                   const unsigned char* __restrict__ plane, float* __restrict__ t,
                                   float* __restrict__ normal) {
  long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long)r_n * m) return;
  int r = (int)(p / m);
  int j = (int)(p - (long)r * m);
  d2::V2 o = d2::load2(rays + 4 * r), d = d2::load2(rays + 4 * r + 2);
  d2::V2 n;
  if (plane[j]) {
    t[p] = d2::ray_plane(o, d, d2::load2(pos + 2 * j), d2::plane_normal(j, cs, verts), solid != 0,
                         &n);
  } else {
    d2::Poly q;
    d2::load_collider(q, j, pos, cs, verts, count, radius);
    t[p] = d2::ray_rounded_poly(o, d, q, solid != 0, &n);
  }
  d2::store2(normal + 2 * p, n);
}

}  // namespace

extern "C" int avian_ray_cast_2d(int r_n, int m, const float* rays, int solid, const float* pos,
                                 const float* cs, const float* verts, const int* count,
                                 const float* radius, const unsigned char* plane, float* t,
                                 float* normal, void* stream) {
  const int threads = 128;
  long n = (long)r_n * m;
  if (n == 0) return 0;
  ray_cast_2d_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(r_n, m, rays, solid, pos, cs, verts, count, radius,
                                               plane, t, normal);
  return (int)cudaGetLastError();
}
