// One manifold of any canonical shape pair, for the kernels that evaluate
// many pairs in a loop (Kernel R, swept_toi*.cu, and Kernel S,
// shape_cast*.cu): the device code of Kernels A and N (box_pair.cuh,
// round_pair.cuh) and of M, O, P and Q (convex_pair.cuh) behind one
// template, dispatched as geometry/narrowphase.py's PAIR_KERNELS dispatches
// the plain versions. Each instance is one pair function; the callers bucket
// their work by canonical pair, so a warp never diverges on the shape types.
//
// The canonical pairs are listed in three groups, one translation unit each
// per kernel, so that the parallel build keeps its wall time:
// AVIAN_PAIRS_ANALYTIC (Kernels A, N, O, Q: closed forms and one patch),
// AVIAN_PAIRS_GENERIC (Kernel M: the support-map pipeline) and
// AVIAN_PAIRS_HULL (Kernel P: the pipeline on pool-backed shapes).
#pragma once
#include "box_pair.cuh"
#include "convex_pair.cuh"
#include "round_pair.cuh"

#define AVIAN_PAIRS_ANALYTIC(X)                                                         \
  X(0, 0) X(0, 1) X(0, 2) X(0, 3) X(1, 1) X(1, 3) X(2, 2) X(2, 3) X(3, 4) X(3, 5) X(3, 6) \
  X(3, 8)
#define AVIAN_PAIRS_GENERIC(X)                                                           \
  X(0, 4) X(0, 5) X(1, 2) X(1, 4) X(1, 5) X(2, 4) X(2, 5) X(4, 4) X(4, 5) X(5, 5) X(0, 6) \
  X(1, 6) X(2, 6) X(4, 6) X(5, 6) X(6, 6)
#define AVIAN_PAIRS_HULL(X) X(0, 8) X(1, 8) X(2, 8) X(4, 8) X(5, 8) X(6, 8) X(8, 8)

namespace {

constexpr int kPlane = 3;

// A side of a pair at world pose (p, q) with the 7 parameter lanes `prm`
// (stride free); a kConvex shape's vertices are rows of `pool`.
template <int T>
__device__ __forceinline__ Pose make_pose(V3 p, Q4 q, const float* prm, const float* pool) {
  Pose s{p, q, load3(prm), nullptr, 0, 0.0f, 0.0f, false};
  if (T == kConvex) {
    s.hv = pool + 3 * (long long)(int)prm[0];
    s.nv = (int)prm[1];
    s.size = fmaxf(fmaxf(fmaxf(prm[2], prm[3]), prm[4]), 1e-3f);
    s.flat = prm[5] > 0.5f;
    s.radius = prm[6];
  }
  return s;
}

template <typename O>
__device__ __forceinline__ void take(const O& s, Out& o) {
  o.normal = s.normal;
  for (int k = 0; k < 4; ++k) {
    o.pa[k] = s.pa[k];
    o.pb[k] = s.pb[k];
    o.sep[k] = s.sep[k];
    o.fid[k] = s.fid[k];
  }
  o.count = s.count;
}

// The manifold of canonical pair (TA, TB), TA <= TB; the normal points from
// A to B.
template <int TA, int TB>
__device__ void pair_manifold(const Pose& A, const Pose& B, const Disc& t, Out& o) {
  if constexpr (TA == kSphere && TB == kSphere) {
    round_pair::Out r;
    round_pair::sphere_sphere(A.p, A.prm, B.p, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kSphere && TB == kCapsule) {
    round_pair::Out r;
    round_pair::sphere_capsule(A.p, A.prm, B.p, B.q, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kSphere && TB == kBox) {
    round_pair::Out r;
    round_pair::sphere_box(A.p, A.prm, B.p, B.q, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kSphere && TB == kPlane) {
    round_pair::Out r;
    round_pair::sphere_plane(A.p, A.prm, B.p, B.q, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kCapsule && TB == kCapsule) {
    round_pair::Out r;
    round_pair::capsule_capsule(A.p, A.q, A.prm, B.p, B.q, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kCapsule && TB == kPlane) {
    round_pair::Out r;
    round_pair::capsule_plane(A.p, A.q, A.prm, B.p, B.q, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kBox && TB == kBox) {
    box_pair::Out r;
    box_pair::box_box(A.p, A.q, A.prm, B.p, B.q, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kBox && TB == kPlane) {
    box_pair::Out r;
    box_pair::box_plane(A.p, A.q, A.prm, B.p, B.q, B.prm, r);
    take(r, o);
  } else if constexpr (TA == kPlane) {
    // Kernels O and Q: the half-space first, its local normal in prm.
    plane_patch<TB>(A.p, rotate(A.q, A.prm), B, t, o);
  } else {
    generic_pair<TA, TB>(A, B, t, o);
  }
}

// The first of the smallest separations' lane.
__device__ __forceinline__ int first_min_lane(const Out& o) {
  int pi = 0;
  for (int k = 1; k < 4; ++k)
    if (o.sep[k] < o.sep[pi]) pi = k;
  return pi;
}

__device__ __forceinline__ float min_sep(const Out& o) {
  return fminf(fminf(o.sep[0], o.sep[1]), fminf(o.sep[2], o.sep[3]));
}

}  // namespace
