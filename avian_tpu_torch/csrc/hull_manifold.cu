// Kernel P (hull_manifold) and Kernel Q (plane_hull_manifold): contact
// manifolds of pool-backed convex shapes (convex hulls, round cuboids, the
// triangles of trimeshes and heightfields), one thread per pair.
//
// Kernel P replaces avian_tpu/geometry/convex.py::generic_convex_pair_aux
// (:881) with support_convex (:762), patch_convex (:789) and the flat rule of
// generic_convex_pair (:533-545), for a sphere, capsule, box, cylinder, cone,
// segment or CONVEX shape A against a CONVEX shape B. Kernel Q replaces
// support_patch_plane_pair_aux (:902) behind narrowphase.py's _swapped_aux
// (:388): a half-space A against a CONVEX shape B.
//
// A CONVEX shape's params are 7 lanes (offset, count, hx, hy, hz, flat,
// radius); its count (at most 32) vertices are rows of the vertex pool from
// offset. A pair of Kernel P is Kernel M's pipeline (convex_pair.cuh) with a
// scan of the hull's vertices in each of its ~90 support calls and
// patch_convex's two bands, top 8 and angle sort in each of its four hull
// patches: some 20,000 dependent operations on 104 bytes of pair input, up to
// 384 bytes of vertices and 148 bytes out, so it is bound by latency, not by
// bytes. The kernel is a template on A's type, one instance per canonical
// pair; CONVEX/CONVEX reads both flat flags at run time. One thread takes one
// pair and reads a hull's vertices from the pool (through L1) when it needs
// them, never past offset + count; the sets of patch_convex are 32-bit masks
// and its selections are loops, so no vertex array is copied. The arithmetic
// is the plain version's, operation by operation (-fmad=false, IEEE sqrt and
// division, first extremum on ties, the top 8 as a stable descending
// selection, the angle order as a stable insertion sort).
#include "convex_pair.cuh"

namespace {

template <int TA>
__global__ void hull_manifold_kernel(int n, const float* __restrict__ pa,
                                     const float* __restrict__ qa,
                                     const float* __restrict__ prm_a,
                                     const float* __restrict__ pb,
                                     const float* __restrict__ qb,
                                     const float* __restrict__ prm_b,
                                     float* __restrict__ normal, float* __restrict__ point_a,
                                     float* __restrict__ point_b, float* __restrict__ sep,
                                     int* __restrict__ fid, int* __restrict__ count,
                                     const float* __restrict__ disc,
                                     const float* __restrict__ pool) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Disc t = load_disc(disc);
  Pose A = load_pose7<TA>(pa + 3 * i, qa + 4 * i, prm_a + 7 * i, pool);
  Pose B = load_pose7<kConvex>(pb + 3 * i, qb + 4 * i, prm_b + 7 * i, pool);
  Out o;
  generic_pair<TA, kConvex>(A, B, t, o);
  store(o, i, normal, point_a, point_b, sep, fid, count);
}

__global__ void plane_hull_kernel(int n, const float* __restrict__ pa,
                                  const float* __restrict__ qa, const float* __restrict__ na,
                                  const float* __restrict__ pb, const float* __restrict__ qb,
                                  const float* __restrict__ prm_b, float* __restrict__ normal,
                                  float* __restrict__ point_a, float* __restrict__ point_b,
                                  float* __restrict__ sep, int* __restrict__ fid,
                                  int* __restrict__ count, const float* __restrict__ pool) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Disc t{};  // a hull patch reads no disc
  V3 n_plane = rotate(load4(qa + 4 * i), load3(na + 7 * i));
  Pose B = load_pose7<kConvex>(pb + 3 * i, qb + 4 * i, prm_b + 7 * i, pool);
  Out o;
  plane_patch<kConvex>(load3(pa + 3 * i), n_plane, B, t, o);
  store(o, i, normal, point_a, point_b, sep, fid, count);
}

}  // namespace

// kind: the index of the canonical shape pair in
// kernels/hull_manifold.py::HULL_PAIRS.
extern "C" int avian_hull_manifold(int kind, int n, const float* pa, const float* qa,
                                   const float* prm_a, const float* pb, const float* qb,
                                   const float* prm_b, float* normal, float* point_a,
                                   float* point_b, float* sep, int* fid, int* count,
                                   const float* disc, const float* pool, void* stream) {
  const int threads = 64;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
#define AVIAN_HULL(KIND, TA)                                                              \
  case KIND:                                                                              \
    hull_manifold_kernel<TA><<<blocks, threads, 0, st>>>(n, pa, qa, prm_a, pb, qb, prm_b,  \
                                                         normal, point_a, point_b, sep, fid, \
                                                         count, disc, pool);               \
    break;
  switch (kind) {
    AVIAN_HULL(0, kSphere)
    AVIAN_HULL(1, kCapsule)
    AVIAN_HULL(2, kBox)
    AVIAN_HULL(3, kCylinder)
    AVIAN_HULL(4, kCone)
    AVIAN_HULL(5, kSegment)
    AVIAN_HULL(6, kConvex)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AVIAN_HULL
  return (int)cudaGetLastError();
}

// kind 0: half-space/CONVEX.
extern "C" int avian_plane_hull_manifold(int kind, int n, const float* pa,
                                         const float* qa, const float* na, const float* pb,
                                         const float* qb, const float* prm_b, float* normal,
                                         float* point_a, float* point_b, float* sep, int* fid,
                                         int* count, const float* pool, void* stream) {
  if (kind != 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  plane_hull_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, pa, qa, na, pb, qb, prm_b, normal, point_a, point_b, sep, fid, count, pool);
  return (int)cudaGetLastError();
}
