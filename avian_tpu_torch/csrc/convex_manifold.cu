// Kernel M (convex_manifold) and Kernel O (plane_patch_manifold): contact
// manifolds of support-mapped convex shapes, one thread per pair.
//
// Kernel M replaces avian_tpu/geometry/convex.py::generic_convex_pair (:468),
// Kernel O support_patch_plane_pair (:702) behind narrowphase.py's _swapped
// (:313). A pair of Kernel M runs 24 Frank-Wolfe and 20 subgradient steps,
// each two support functions under two rotations, two rounds of support
// patches, 8 half-plane clips of a 16-point ring and a 4-point reduction:
// some 15,000 dependent f32 operations on 80 bytes in and 148 out, so it is
// bound by latency and registers, not by bytes. The kernel is a template on
// the two shape types, instantiated for the sixteen pairs of spheres,
// capsules, boxes, cylinders, cones and segments that have no analytic
// function; the caller buckets pairs by shape code, so a warp runs one
// support function per side without divergence. The rings live in local
// memory. Kernel O is instantiated for cylinders, cones and segments.
//
// The device code, shared with Kernels P and Q (hull_manifold.cu), is in
// convex_pair.cuh; it follows the plain PyTorch version (geometry/convex.py)
// operation by operation, so the two agree to the last bit.
#include "convex_pair.cuh"

namespace {

// ---- Kernel M --------------------------------------------------------------

template <int TA, int TB>
__global__ void convex_manifold_kernel(int n, const float* __restrict__ pa,
                                       const float* __restrict__ qa,
                                       const float* __restrict__ prm_a,
                                       const float* __restrict__ pb,
                                       const float* __restrict__ qb,
                                       const float* __restrict__ prm_b,
                                       float* __restrict__ normal, float* __restrict__ point_a,
                                       float* __restrict__ point_b, float* __restrict__ sep,
                                       int* __restrict__ fid, int* __restrict__ count,
                                       const float* __restrict__ disc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Disc t = load_disc(disc);
  Pose A = load_pose(pa + 3 * i, qa + 4 * i, prm_a + 3 * i);
  Pose B = load_pose(pb + 3 * i, qb + 4 * i, prm_b + 3 * i);
  Out o;
  generic_pair<TA, TB>(A, B, t, o);
  store(o, i, normal, point_a, point_b, sep, fid, count);
}

// ---- Kernel O --------------------------------------------------------------

// Half-space A (local normal in prm) against shape B of type T.
template <int T>
__global__ void plane_patch_kernel(int n, const float* __restrict__ pa,
                                   const float* __restrict__ qa, const float* __restrict__ na,
                                   const float* __restrict__ pb, const float* __restrict__ qb,
                                   const float* __restrict__ prm_b, float* __restrict__ normal,
                                   float* __restrict__ point_a, float* __restrict__ point_b,
                                   float* __restrict__ sep, int* __restrict__ fid,
                                   int* __restrict__ count, const float* __restrict__ disc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Disc t = load_disc(disc);
  V3 n_plane = rotate(load4(qa + 4 * i), load3(na + 3 * i));
  Pose B = load_pose(pb + 3 * i, qb + 4 * i, prm_b + 3 * i);
  Out o;
  plane_patch<T>(load3(pa + 3 * i), n_plane, B, t, o);
  store(o, i, normal, point_a, point_b, sep, fid, count);
}

template <typename K>
int launch(K kernel, int n, const float* pa, const float* qa, const float* prm_a,
           const float* pb, const float* qb, const float* prm_b, float* normal, float* point_a,
           float* point_b, float* sep, int* fid, int* count, const float* disc, void* stream) {
  const int threads = 64;
  kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, pa, qa, prm_a, pb, qb, prm_b, normal, point_a, point_b, sep, fid, count, disc);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: the index of the canonical shape pair in
// kernels/convex_manifold.py::GENERIC_PAIRS.
extern "C" int avian_convex_manifold(int kind, int n, const float* pa, const float* qa,
                                     const float* prm_a, const float* pb, const float* qb,
                                     const float* prm_b, float* normal, float* point_a,
                                     float* point_b, float* sep, int* fid, int* count,
                                     const float* disc, void* stream) {
#define AVIAN_PAIR(KIND, TA, TB)                                                          \
  case KIND:                                                                              \
    return launch(convex_manifold_kernel<TA, TB>, n, pa, qa, prm_a, pb, qb, prm_b, normal, \
                  point_a, point_b, sep, fid, count, disc, stream);
  switch (kind) {
    AVIAN_PAIR(0, kSphere, kCylinder)
    AVIAN_PAIR(1, kSphere, kCone)
    AVIAN_PAIR(2, kCapsule, kBox)
    AVIAN_PAIR(3, kCapsule, kCylinder)
    AVIAN_PAIR(4, kCapsule, kCone)
    AVIAN_PAIR(5, kBox, kCylinder)
    AVIAN_PAIR(6, kBox, kCone)
    AVIAN_PAIR(7, kCylinder, kCylinder)
    AVIAN_PAIR(8, kCylinder, kCone)
    AVIAN_PAIR(9, kCone, kCone)
    AVIAN_PAIR(10, kSphere, kSegment)
    AVIAN_PAIR(11, kCapsule, kSegment)
    AVIAN_PAIR(12, kBox, kSegment)
    AVIAN_PAIR(13, kCylinder, kSegment)
    AVIAN_PAIR(14, kCone, kSegment)
    AVIAN_PAIR(15, kSegment, kSegment)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AVIAN_PAIR
}

// kind 0: half-space/cylinder, 1: half-space/cone, 2: half-space/segment.
extern "C" int avian_plane_patch_manifold(int kind, int n, const float* pa, const float* qa,
                                          const float* na, const float* pb, const float* qb,
                                          const float* prm_b, float* normal, float* point_a,
                                          float* point_b, float* sep, int* fid, int* count,
                                          const float* disc, void* stream) {
  if (kind == 0)
    return launch(plane_patch_kernel<kCylinder>, n, pa, qa, na, pb, qb, prm_b, normal, point_a,
                  point_b, sep, fid, count, disc, stream);
  if (kind == 1)
    return launch(plane_patch_kernel<kCone>, n, pa, qa, na, pb, qb, prm_b, normal, point_a,
                  point_b, sep, fid, count, disc, stream);
  if (kind == 2)
    return launch(plane_patch_kernel<kSegment>, n, pa, qa, na, pb, qb, prm_b, normal, point_a,
                  point_b, sep, fid, count, disc, stream);
  return (int)cudaErrorInvalidValue;
}
