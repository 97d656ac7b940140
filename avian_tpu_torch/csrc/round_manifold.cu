// Kernel N: contact manifolds of the analytic round-shape pairs, one thread
// per pair: sphere/sphere, sphere/capsule, sphere/box, sphere/plane,
// capsule/capsule and capsule/plane.
//
// Replaces avian_tpu/geometry/narrowphase.py::sphere_sphere (:88),
// sphere_capsule (:96), capsule_capsule (:109) with _closest_segment_segment
// (:154), sphere_box (:172), sphere_plane (:204) and capsule_plane (:214). A
// pair reads 80 bytes of poses and parameters, does a few dozen to a few
// hundred f32 operations and writes a 148-byte manifold: bound by bytes. The
// kind is uniform over a launch (the caller buckets pairs by shape code), so
// a warp never diverges on it. The arithmetic follows the plain PyTorch
// version (geometry/narrowphase.py) operation by operation, with IEEE square
// roots and divisions (__fsqrt_rn, __fdiv_rn) and no fused multiply-adds
// (-fmad=false), so the two agree to the last bit.
#include "round_pair.cuh"

namespace {

using namespace round_pair;

__global__ void round_manifold_kernel(int kind, int n, const float* __restrict__ pa,
                                      const float* __restrict__ qa,
                                      const float* __restrict__ prm_a,
                                      const float* __restrict__ pb,
                                      const float* __restrict__ qb,
                                      const float* __restrict__ prm_b, float* __restrict__ normal,
                                      float* __restrict__ point_a, float* __restrict__ point_b,
                                      float* __restrict__ sep, int* __restrict__ fid,
                                      int* __restrict__ count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Out o;
  V3 a_p = load3(pa + 3 * i), b_p = load3(pb + 3 * i);
  Q4 a_q = load4(qa + 4 * i), b_q = load4(qb + 4 * i);
  V3 a_h = load3(prm_a + 3 * i), b_h = load3(prm_b + 3 * i);
  switch (kind) {
    case kSphereSphere: sphere_sphere(a_p, a_h, b_p, b_h, o); break;
    case kSphereCapsule: sphere_capsule(a_p, a_h, b_p, b_q, b_h, o); break;
    case kSphereBox: sphere_box(a_p, a_h, b_p, b_q, b_h, o); break;
    case kSpherePlane: sphere_plane(a_p, a_h, b_p, b_q, b_h, o); break;
    case kCapsuleCapsule: capsule_capsule(a_p, a_q, a_h, b_p, b_q, b_h, o); break;
    default: capsule_plane(a_p, a_q, a_h, b_p, b_q, b_h, o); break;
  }
  store3(normal + 3 * i, o.normal);
  for (int k = 0; k < 4; ++k) {
    store3(point_a + 12 * i + 3 * k, o.pa[k]);
    store3(point_b + 12 * i + 3 * k, o.pb[k]);
    sep[4 * i + k] = o.sep[k];
    fid[4 * i + k] = o.fid[k];
  }
  count[i] = o.count;
}

}  // namespace

extern "C" int avian_round_manifold(int kind, int n, const float* pa, const float* qa,
                                    const float* prm_a, const float* pb, const float* qb,
                                    const float* prm_b, float* normal, float* point_a,
                                    float* point_b, float* sep, int* fid, int* count,
                                    void* stream) {
  if (kind < 0 || kind > kCapsulePlane) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  round_manifold_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      kind, n, pa, qa, prm_a, pb, qb, prm_b, normal, point_a, point_b, sep, fid, count);
  return (int)cudaGetLastError();
}
