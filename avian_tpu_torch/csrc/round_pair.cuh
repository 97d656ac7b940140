// Device code of Kernel N (round_manifold.cu), shared with Kernels R and S
// (swept_toi.cu, shape_cast.cu): the six analytic pairs of spheres,
// capsules, boxes and half-spaces of avian_tpu/geometry/narrowphase.py,
// operation by operation as the plain PyTorch versions
// (geometry/narrowphase.py).
#pragma once
#include "common.cuh"

// Internal linkage (the outer unnamed namespace): every translation unit
// that includes this header gets its own copy, constant tables included.
namespace {
namespace round_pair {

constexpr int kSphereSphere = 0, kSphereCapsule = 1, kSphereBox = 2, kSpherePlane = 3,
              kCapsuleCapsule = 4, kCapsulePlane = 5;

struct Out {
  V3 normal;
  V3 pa[4];
  V3 pb[4];
  float sep[4];
  int fid[4];
  int count;
};

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ float minmax(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// vec.normalize_or_rn
__device__ V3 nrm_or(V3 a, V3 fb) {
  float n2 = dot(a, a);
  bool ok = n2 > 1e-12f;
  float inv = ok ? __fdiv_rn(1.0f, sqrt_rn(fmaxf(n2, 1e-12f))) : 0.0f;
  return ok ? a * inv : fb;
}

__device__ V3 any_orthonormal(V3 n) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = __fdiv_rn(-1.0f, sign + n.z);
  float b = n.x * n.y * a;
  return v3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
}

__device__ __forceinline__ V3 axis_y(Q4 q) { return rotate(q, v3(0.0f, 1.0f, 0.0f)); }

__device__ void one_point(Out& o, V3 n, V3 pa, V3 pb, float sep) {
  o.normal = n;
  for (int k = 0; k < 4; ++k) {
    o.pa[k] = v3(0.0f, 0.0f, 0.0f);
    o.pb[k] = v3(0.0f, 0.0f, 0.0f);
    o.sep[k] = 1e9f;
    o.fid[k] = 0;
  }
  o.pa[0] = pa;
  o.pb[0] = pb;
  o.sep[0] = sep;
  o.count = 1;
}

__device__ void two_points(Out& o, V3 n, V3 pa0, V3 pa1, V3 pb0, V3 pb1, float s0, float s1,
                           int f0, int f1) {
  one_point(o, n, pa0, pb0, s0);
  o.pa[1] = pa1;
  o.pb[1] = pb1;
  o.sep[1] = s1;
  o.fid[0] = f0;
  o.fid[1] = f1;
  o.count = 2;
}

__device__ void sphere_sphere(V3 pa, V3 prm_a, V3 pb, V3 prm_b, Out& o) {
  float ra = prm_a.x, rb = prm_b.x;
  V3 d = pb - pa;
  float dist = sqrt_rn(dot(d, d));
  V3 n = nrm_or(d, v3(1.0f, 0.0f, 0.0f));
  one_point(o, n, pa + n * ra, pb - n * rb, dist - (ra + rb));
}

__device__ void sphere_capsule(V3 pa, V3 prm_a, V3 pb, Q4 qb, V3 prm_b, Out& o) {
  float ra = prm_a.x, hb = prm_b.x, rb = prm_b.y;
  V3 axis = axis_y(qb);
  float t = minmax(dot(pa - pb, axis), -hb, hb);
  V3 c = pb + axis * t;
  V3 d = c - pa;
  float dist = sqrt_rn(dot(d, d));
  V3 n = nrm_or(d, v3(1.0f, 0.0f, 0.0f));
  one_point(o, n, pa + n * ra, c - n * rb, dist - (ra + rb));
}

// geometry/box_box.py::_closest_segment_segment (unit axes).
__device__ void closest_segment_segment(V3 pa, V3 ua, float ha, V3 pb, V3 ub, float hb,
                                        float& s, float& t_cl) {
  V3 r = pa - pb;
  float b = dot(ua, ub);
  float c = dot(ua, r);
  float f = dot(ub, r);
  float denom = 1.0f - b * b;
  s = denom > 1e-9f ? minmax(__fdiv_rn(b * f - c, fmaxf(denom, 1e-9f)), -ha, ha) : 0.0f;
  float t = b * s + f;
  t_cl = minmax(t, -hb, hb);
  s = minmax(b * t_cl - c, -ha, ha);
}

__device__ void capsule_capsule(V3 pa, Q4 qa, V3 prm_a, V3 pb, Q4 qb, V3 prm_b, Out& o) {
  float ha = prm_a.x, ra = prm_a.y, hb = prm_b.x, rb = prm_b.y;
  V3 ua = axis_y(qa), ub = axis_y(qb);
  bool parallel = fabsf(dot(ua, ub)) > 0.999f;
  float tb0 = dot((pb - ub * hb) - pa, ua);
  float tb1 = dot((pb + ub * hb) - pa, ua);
  float lo = fmaxf(-ha, fminf(tb0, tb1));
  float hi = fminf(ha, fmaxf(tb0, tb1));
  if (parallel && hi > lo) {
    // Parallel axes with overlapping extents: the two ends of the overlap.
    V3 ca0 = pa + ua * lo, ca1 = pa + ua * hi;
    V3 rel = pb - pa;
    V3 perp = rel - ua * dot(rel, ua);
    float pdist = sqrt_rn(dot(perp, perp));
    V3 np = nrm_or(perp, any_orthonormal(ua));
    float sep_par = pdist - (ra + rb);
    two_points(o, np, ca0 + np * ra, ca1 + np * ra, (ca0 + perp) - np * rb,
               (ca1 + perp) - np * rb, sep_par, sep_par, 1, 2);
    return;
  }
  float s, t;
  closest_segment_segment(pa, ua, ha, pb, ub, hb, s, t);
  V3 ca = pa + ua * s, cb = pb + ub * t;
  V3 d = cb - ca;
  float dist = sqrt_rn(dot(d, d));
  V3 n = nrm_or(d, v3(1.0f, 0.0f, 0.0f));
  one_point(o, n, ca + n * ra, cb - n * rb, dist - (ra + rb));
}

__device__ V3 onehot(int i) {
  return v3(i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f, i == 2 ? 1.0f : 0.0f);
}

__device__ void sphere_box(V3 pa, V3 prm_a, V3 pb, Q4 qb, V3 h, Out& o) {
  float ra = prm_a.x;
  V3 c_local = rotate(conj(qb), pa - pb);
  V3 q = v3(minmax(c_local.x, -h.x, h.x), minmax(c_local.y, -h.y, h.y),
            minmax(c_local.z, -h.z, h.z));
  V3 delta = c_local - q;
  float d2 = dot(delta, delta);
  bool outside = d2 > 1e-12f;
  float dist = sqrt_rn(fmaxf(d2, 1e-12f));
  // delta / dist as XLA compiles the reference: delta * rsqrt(d2).
  V3 n_out = delta * __fdiv_rn(1.0f, dist);
  V3 face = v3(h.x - fabsf(c_local.x), h.y - fabsf(c_local.y), h.z - fabsf(c_local.z));
  int ax = 0;  // axis of least penetration, the first of equals
  if (face.y < comp(face, ax)) ax = 1;
  if (face.z < comp(face, ax)) ax = 2;
  float sign = comp(c_local, ax) >= 0.0f ? 1.0f : -1.0f;
  V3 n_in = onehot(ax) * sign;
  float depth_in = comp(face, ax);
  V3 n_local = outside ? n_out : n_in;
  float sep = outside ? dist - ra : -(depth_in + ra);
  V3 q_surf = outside ? q : c_local + n_in * depth_in;
  V3 normal = -rotate(qb, n_local);
  one_point(o, normal, pa + normal * ra, pb + rotate(qb, q_surf), sep);
}

__device__ void sphere_plane(V3 pa, V3 prm_a, V3 pb, Q4 qb, V3 nb, Out& o) {
  float ra = prm_a.x;
  V3 n = rotate(qb, nb);
  float s = dot(pa - pb, n);
  V3 normal = -n;
  one_point(o, normal, pa + normal * ra, pa - n * s, s - ra);
}

__device__ void capsule_plane(V3 pa, Q4 qa, V3 prm_a, V3 pb, Q4 qb, V3 nb, Out& o) {
  float ha = prm_a.x, ra = prm_a.y;
  V3 n = rotate(qb, nb);
  V3 axis = axis_y(qa);
  V3 e0 = pa - axis * ha, e1 = pa + axis * ha;
  float s0 = dot(e0 - pb, n) - ra;
  float s1 = dot(e1 - pb, n) - ra;
  V3 normal = -n;
  V3 pa0 = e0 + normal * ra, pa1 = e1 + normal * ra;
  two_points(o, normal, pa0, pa1, pa0 - n * s0, pa1 - n * s1, s0, s1, 0, 1);
}

}  // namespace round_pair
}  // namespace
