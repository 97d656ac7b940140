// Kernel T: ray casts, one thread per (ray, collider), templated on the
// collider's shape type.
//
// Replaces avian_tpu/queries/raycast.py::_ray_one_collider (:372) with
// _ray_sphere (:51), _ray_box (:68), _ray_plane (:90), _ray_capsule (:103),
// _ray_cylinder (:138), _ray_cone (:179), _ray_convex (:231) and _ray_miss
// (:320), under the vmap of _all_hits over every collider. Each thread takes
// the ray into the collider's frame, intersects it there and returns the
// distance and the world normal; a miss is distance 1e30. The analytic
// shapes are a few dozen operations on 60 bytes in and 16 out, bound by
// bytes; a pool-backed convex shape is sphere tracing (24 marches, each 12
// Frank-Wolfe steps over its at most 32 vertices, read from the pool through
// L1) and a face fit, some 60,000 dependent operations, bound by operations.
// The caller buckets colliders by shape type, one instance per type, so that
// the convex march never diverges a warp of analytic rays.
//
// The device code is ray_cast.cuh's, which Kernels AG and AF share.
#include "ray_cast.cuh"

namespace {

template <int T>
__global__ void ray_cast_kernel(int n, int n_rays, int m, const int* __restrict__ cols,
                                const float* __restrict__ rays, int solid,
                                const float* __restrict__ pos, const float* __restrict__ quat,
                                const float* __restrict__ params,
                                const float* __restrict__ pool, float* __restrict__ t_out,
                                float* __restrict__ n_out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * n_rays) return;
  int r = (int)(idx / n);
  int c = cols[idx - (long long)r * n];
  Q4 q = load4(quat + 4 * c);
  V3 o = rotate(conj(q), load3(rays + 6 * r) - load3(pos + 3 * c));
  V3 d = rotate(conj(q), load3(rays + 6 * r + 3));
  Hit h = ray_shape<T>(o, d, params + 8 * c, solid != 0, pool);
  long long out = (long long)r * m + c;
  t_out[out] = h.t;
  store3(n_out + 3 * out, rotate(q, h.n));
}

}  // namespace

// type: the bucket's shape code (0-5, 8; 6 for the shapes a ray misses).
extern "C" int avian_ray_cast(int type, int n, int n_rays, int m, const int* cols,
                              const float* rays, int solid, const float* pos, const float* quat,
                              const float* params, const float* pool, float* t_out,
                              float* n_out, void* stream) {
  const int threads = 128;
  long long total = (long long)n * n_rays;
  if (total == 0) return 0;
  int blocks = (int)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
#define AVIAN_RAY(T)                                                                      \
  case T:                                                                                 \
    ray_cast_kernel<T><<<blocks, threads, 0, st>>>(n, n_rays, m, cols, rays, solid, pos, quat, \
                                                   params, pool, t_out, n_out);            \
    break;
  switch (type) {
    AVIAN_RAY(kSphere)
    AVIAN_RAY(kCapsule)
    AVIAN_RAY(kBox)
    AVIAN_RAY(kPlane)
    AVIAN_RAY(kCylinder)
    AVIAN_RAY(kCone)
    AVIAN_RAY(kMiss)
    AVIAN_RAY(kConvex)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AVIAN_RAY
  return (int)cudaGetLastError();
}
