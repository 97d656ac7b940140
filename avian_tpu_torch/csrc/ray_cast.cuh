// Kernel T's device code: a ray against one collider in the collider's
// frame, for each shape type, and the pool-backed hulls' helpers (vertex
// scans and the Frank-Wolfe closest point). ray_cast.cu (Kernel T) calls
// ray_shape<T> once per bucket, ray_cast_grid.cu (Kernel AG) ray_any on each
// grid entry, point_3d.cu (Kernel AF) the hull helpers.
//
// The arithmetic is the plain versions' (kernels/ray_cast.py) operation by
// operation, compiled without fused multiply-adds, with IEEE square roots and
// divisions; every argmax takes the first maximum and the vertex sums run
// from row 0 upward, as XLA:CPU sums them. A ray that starts inside a solid
// shape hits at 0 with normal -d; segments and triangles miss.
#pragma once
#include "common.cuh"

namespace {

constexpr int kSphere = 0, kCapsule = 1, kBox = 2, kPlane = 3, kCylinder = 4, kCone = 5,
              kMiss = 6, kConvex = 8;
constexpr int kHullVerts = 32, kMarches = 24, kFwSteps = 12;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }

// vec.normalize_or
__device__ V3 nrm_or(V3 a, V3 fb) {
  float n2 = dot(a, a);
  bool ok = n2 > 1e-12f;
  float inv = ok ? __fdiv_rn(1.0f, sqrt_rn(fmaxf(n2, 1e-12f))) : 0.0f;
  return ok ? a * inv : fb;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sign0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct Hit {
  float t;
  V3 n;
};

__device__ Hit ray_sphere(V3 o, V3 d, float r, bool solid) {
  float b = dot(o, d);
  float c = dot(o, o) - r * r;
  float disc = b * b - c;
  float sq = sqrt_rn(fmaxf(disc, 0.0f));
  float t0 = -b - sq;
  float t1 = -b + sq;
  bool inside = c < 0.0f;
  float t = disc < 0.0f ? kBig : (t0 >= 0.0f ? t0 : (t1 >= 0.0f ? t1 : kBig));
  t = (inside && solid) ? 0.0f : t;
  V3 n = nrm_or(o + d * t, -d);
  return Hit{t, (inside && solid) ? -d : n};
}

__device__ Hit ray_box(V3 o, V3 d, const float* prm, bool solid) {
  float h[3] = {prm[0], prm[1], prm[2]};
  float oa[3] = {o.x, o.y, o.z}, da[3] = {d.x, d.y, d.z};
  float tmin3[3], tmax3[3];
  for (int a = 0; a < 3; ++a) {
    float den = fabsf(da[a]) > 1e-12f ? da[a] : (da[a] >= 0.0f ? 1e-12f : -1e-12f);
    float inv = __fdiv_rn(1.0f, den);
    float t1 = (-h[a] - oa[a]) * inv;
    float t2 = (h[a] - oa[a]) * inv;
    tmin3[a] = fminf(t1, t2);
    tmax3[a] = fmaxf(t1, t2);
  }
  float tmin = fmaxf(fmaxf(tmin3[0], tmin3[1]), tmin3[2]);
  float tmax = fminf(fminf(tmax3[0], tmax3[1]), tmax3[2]);
  bool hit = tmax >= fmaxf(tmin, 0.0f);
  bool inside = tmin < 0.0f && tmax > 0.0f;
  float t = hit ? (inside ? (solid ? 0.0f : tmax) : tmin) : kBig;
  bool exiting = inside && !solid;
  float t_face = exiting ? tmax : tmin;
  int ax = 0;  // the first axis whose slab gives t_face
  for (int a = 2; a >= 0; --a)
    if ((exiting ? tmax3[a] : tmin3[a]) == t_face) ax = a;
  V3 p = o + d * t;
  float sign = comp(p, ax) >= 0.0f ? 1.0f : -1.0f;
  V3 n = v3(ax == 0 ? sign : 0.0f, ax == 1 ? sign : 0.0f, ax == 2 ? sign : 0.0f);
  return Hit{t, (inside && solid) ? -d : n};
}

__device__ Hit ray_plane(V3 o, V3 d, const float* prm, bool solid) {
  V3 n = load3(prm);
  float denom = dot(d, n);
  float dist = dot(o, n);
  float t = fabsf(denom) > 1e-12f ? __fdiv_rn(-dist, denom) : kBig;
  t = t >= 0.0f ? t : kBig;
  bool below = dist < 0.0f;
  t = (below && solid) ? 0.0f : t;
  V3 nr = below ? -n : n;
  return Hit{t, (below && solid) ? -d : nr};
}

// The side of the infinite cylinder of radius r about Y: the nearer root.
__device__ float side_root(V3 o, V3 d, float r) {
  V3 oxz = v3(o.x, 0.0f, o.z), dxz = v3(d.x, 0.0f, d.z);
  float a = dot(dxz, dxz);
  float b = dot(oxz, dxz);
  float c = dot(oxz, oxz) - r * r;
  float disc = b * b - a * c;
  float sq = sqrt_rn(fmaxf(disc, 0.0f));
  return (disc >= 0.0f && a > 1e-12f) ? __fdiv_rn(-b - sq, fmaxf(a, 1e-12f)) : kBig;
}

__device__ Hit ray_capsule(V3 o, V3 d, const float* prm, bool solid) {
  float hh = prm[0], r = prm[1];
  float t_cyl = side_root(o, d, r);
  float y_at = o.y + d.y * t_cyl;
  t_cyl = (t_cyl >= 0.0f && fabsf(y_at) <= hh) ? t_cyl : kBig;
  V3 up = v3(0.0f, 1.0f, 0.0f);
  Hit top = ray_sphere(o - up * hh, d, r, solid);
  Hit bot = ray_sphere(o + up * hh, d, r, solid);
  float t = fminf(t_cyl, fminf(top.t, bot.t));
  V3 p = o + d * t;
  V3 n_cyl = nrm_or(v3(p.x, 0.0f, p.z), -d);
  V3 n = t == t_cyl ? n_cyl : (t == top.t ? top.n : bot.n);
  float ty = clampf(o.y, -hh, hh);
  V3 rel = o - up * ty;
  bool inside = dot(rel, rel) < r * r;
  return Hit{(inside && solid) ? 0.0f : t, (inside && solid) ? -d : n};
}

__device__ float cyl_cap(V3 o, V3 d, float hh, float r, float sy) {
  float denom = d.y;
  float t = fabsf(denom) > 1e-12f ? __fdiv_rn(sy * hh - o.y, denom) : kBig;
  V3 p = o + d * t;
  bool ok = t >= 0.0f && p.x * p.x + p.z * p.z <= r * r;
  return ok ? t : kBig;
}

__device__ Hit ray_cylinder(V3 o, V3 d, const float* prm, bool solid) {
  float hh = prm[0], r = prm[1];
  float t_side = side_root(o, d, r);
  float y_at = o.y + d.y * t_side;
  t_side = (t_side >= 0.0f && fabsf(y_at) <= hh) ? t_side : kBig;
  float t_top = cyl_cap(o, d, hh, r, 1.0f);
  float t_bot = cyl_cap(o, d, hh, r, -1.0f);
  float t = fminf(t_side, fminf(t_top, t_bot));
  V3 p = o + d * t;
  V3 n_side = nrm_or(v3(p.x, 0.0f, p.z), -d);
  float s = t == t_top ? 1.0f : -1.0f;
  V3 n = t == t_side ? n_side : v3(0.0f * s, 1.0f * s, 0.0f * s);
  bool inside = fabsf(o.y) <= hh && o.x * o.x + o.z * o.z < r * r;
  return Hit{(inside && solid) ? 0.0f : t, (inside && solid) ? -d : n};
}

__device__ Hit ray_cone(V3 o, V3 d, const float* prm, bool solid) {
  float hh = prm[0], r = prm[1];
  float k = __fdiv_rn(r, 2.0f * hh);
  float kk = k * k;
  float A = (d.x * d.x + d.z * d.z) - kk * d.y * d.y;
  float B = 2.0f * (o.x * d.x + o.z * d.z) + 2.0f * k * k * d.y * (hh - o.y);
  float hy = hh - o.y;
  float C = (o.x * o.x + o.z * o.z) - kk * (hy * hy);
  float disc = B * B - 4.0f * A * C;
  float sq = sqrt_rn(fmaxf(disc, 0.0f));
  float safe_a = fabsf(A) > 1e-12f ? A : 1e-12f;
  float t0 = __fdiv_rn(-B - sq, 2.0f * safe_a);
  float t1 = __fdiv_rn(-B + sq, 2.0f * safe_a);
  bool b_ok = fabsf(B) > 1e-12f;
  float t_lin = b_ok ? __fdiv_rn(-C, b_ok ? B : 1.0f) : kBig;
  bool use_lin = fabsf(A) <= 1e-12f;
  float y0 = o.y + d.y * t0, y1 = o.y + d.y * t1;
  bool ok0 = disc >= 0.0f && t0 >= 0.0f && y0 >= -hh && y0 <= hh;
  bool ok1 = disc >= 0.0f && t1 >= 0.0f && y1 >= -hh && y1 <= hh;
  t0 = (!use_lin && ok0) ? t0 : kBig;
  t1 = (!use_lin && ok1) ? t1 : kBig;
  float y_lin = o.y + d.y * t_lin;
  t_lin = (use_lin && t_lin >= 0.0f && y_lin >= -hh && y_lin <= hh) ? t_lin : kBig;
  float t_side = fminf(fminf(t0, t1), t_lin);
  float t_base = fabsf(d.y) > 1e-12f ? __fdiv_rn(-hh - o.y, d.y) : kBig;
  V3 pb = o + d * t_base;
  t_base = (t_base >= 0.0f && pb.x * pb.x + pb.z * pb.z <= r * r) ? t_base : kBig;
  float t = fminf(t_side, t_base);
  V3 p = o + d * t;
  V3 n_side = nrm_or(v3(p.x, kk * (hh - p.y), p.z), -d);
  V3 n = t == t_side ? n_side : v3(0.0f, -1.0f, 0.0f);
  float r_at = k * (hh - o.y);
  bool inside = o.y >= -hh && o.y <= hh && o.x * o.x + o.z * o.z < r_at * r_at;
  return Hit{(inside && solid) ? 0.0f : t, (inside && solid) ? -d : n};
}

// ---- pool-backed convex shapes ----------------------------------------------

struct Hull {
  const float* v;  // the first of its rows in the pool
  int cnt;         // valid rows (at most kHullVerts)
};

__device__ __forceinline__ V3 vert(const Hull& h, int j) { return load3(h.v + 3 * j); }

// The first vertex farthest along u (index 0 without vertices).
__device__ int arg_support(const Hull& h, V3 u) {
  int best = 0;
  float bv = -1e30f;
  for (int j = 0; j < h.cnt; ++j) {
    float s = dot(vert(h, j), u);
    if (s > bv) {
      bv = s;
      best = j;
    }
  }
  return best;
}

// max over the valid rows of verts @ u (-1e30 without vertices).
__device__ float sigma(const Hull& h, V3 u) {
  float m = -1e30f;
  for (int j = 0; j < h.cnt; ++j) m = fmaxf(m, dot(vert(h, j), u));
  return m;
}

// Frank-Wolfe on min |x - p|^2 over the hull, from the mean of the window's
// 32 rows (invalid rows replaced by row 0), summed from row 0 upward: `iters`
// steps (12 in a ray's march, the reference's 16 in a point query).
__device__ V3 closest(const Hull& h, V3 p, int iters = kFwSteps) {
  V3 v0 = vert(h, 0);
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  for (int j = 0; j < kHullVerts; ++j) acc = acc + (j < h.cnt ? vert(h, j) : v0);
  V3 x = acc * (1.0f / kHullVerts);
  for (int it = 0; it < iters; ++it) {
    V3 g = x - p;
    V3 s = vert(h, arg_support(h, -g));
    V3 dxs = x - s;
    float gamma = clampf(__fdiv_rn(dot(g, dxs), fmaxf(dot(dxs, dxs), 1e-12f)), 0.0f, 1.0f);
    x = x - dxs * gamma;
  }
  return x;
}

__device__ Hit ray_convex(V3 o, V3 d, const float* prm, bool solid, const float* pool) {
  float rr = prm[6];
  Hull h{pool + 3 * (long long)(int)prm[0], (int)prm[1]};
  float t = 0.0f;
  bool done = false;
  V3 n = -d;
  for (int it = 0; it < kMarches; ++it) {
    V3 p = o + d * t;
    V3 x = closest(h, p);
    V3 u = nrm_or(p - x, -d);
    float lb = (dot(u, p) - sigma(h, u)) - rr;
    bool hit = lb < 1e-4f;
    float t_new = (done || hit) ? t : t + fmaxf(lb, 1e-5f);
    n = done ? n : u;
    t = fminf(t_new, 1e6f);
    done = done || hit;
  }
  // Fit the face plane from the support ring along n.
  float size = fmaxf(fmaxf(fmaxf(prm[2], prm[3]), prm[4]), 1e-3f);
  float top = sigma(h, n);
  float band = top - 0.35f * size;
  unsigned near = 0;
  int k_near = 0;
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  for (int j = 0; j < h.cnt; ++j) {
    if (dot(vert(h, j), n) > band) {
      near |= 1u << j;
      ++k_near;
    }
  }
  for (int j = 0; j < kHullVerts; ++j)
    acc = acc + (((near >> j) & 1u) ? vert(h, j) : v3(0.0f, 0.0f, 0.0f));
  float kf = fmaxf((float)k_near, 1.0f);
  V3 c_near = v3(__fdiv_rn(acc.x, kf), __fdiv_rn(acc.y, kf), __fdiv_rn(acc.z, kf));
  // rel[j] = near ? verts[j] - c_near : 0
  int i_a = 0;
  float best = 0.0f;
  for (int j = 0; j < h.cnt; ++j) {
    if (!((near >> j) & 1u)) continue;
    V3 rj = vert(h, j) - c_near;
    float q = dot(rj, rj);
    if (q > best) {
      best = q;
      i_a = j;
    }
  }
  V3 ra = ((near >> i_a) & 1u) ? vert(h, i_a) - c_near : v3(0.0f, 0.0f, 0.0f);
  int i_b = 0;
  best = 0.0f;
  for (int j = 0; j < h.cnt; ++j) {
    if (!((near >> j) & 1u)) continue;
    V3 cr = cross(ra, vert(h, j) - c_near);
    float q = dot(cr, cr);
    if (q > best) {
      best = q;
      i_b = j;
    }
  }
  V3 rb = ((near >> i_b) & 1u) ? vert(h, i_b) - c_near : v3(0.0f, 0.0f, 0.0f);
  V3 nf = nrm_or(cross(ra, rb), n);
  nf = nf * sign0(dot(nf, n) + 1e-12f);
  n = k_near >= 3 ? nf : n;
  // One exact refinement on the fitted face's support plane.
  float dn = dot(d, n);
  float t_ref = __fdiv_rn((sigma(h, n) + rr) - dot(n, o), fabsf(dn) > 1e-9f ? dn : 1e-9f);
  t = (fabsf(dn) > 1e-6f && fabsf(t_ref - t) < 0.1f && t_ref >= 0.0f) ? t_ref : t;
  t = done ? t : kBig;
  V3 off = closest(h, o) - o;
  bool inside = sqrt_rn(dot(off, off)) < rr + 1e-6f;
  return Hit{(inside && solid) ? 0.0f : t, (inside && solid) ? -d : n};
}

template <int T>
__device__ Hit ray_shape(V3 o, V3 d, const float* prm, bool solid, const float* pool) {
  if constexpr (T == kSphere) return ray_sphere(o, d, prm[0], solid);
  else if constexpr (T == kCapsule) return ray_capsule(o, d, prm, solid);
  else if constexpr (T == kBox) return ray_box(o, d, prm, solid);
  else if constexpr (T == kPlane) return ray_plane(o, d, prm, solid);
  else if constexpr (T == kCylinder) return ray_cylinder(o, d, prm, solid);
  else if constexpr (T == kCone) return ray_cone(o, d, prm, solid);
  else if constexpr (T == kConvex) return ray_convex(o, d, prm, solid, pool);
  else return Hit{kBig, -d};
}

// The ray test of a collider of ray kind `kind` (a runtime switch, for the
// kernels that meet many shapes in one thread).
__device__ Hit ray_any(int kind, V3 o, V3 d, const float* prm, bool solid, const float* pool) {
  switch (kind) {
    case kSphere: return ray_shape<kSphere>(o, d, prm, solid, pool);
    case kCapsule: return ray_shape<kCapsule>(o, d, prm, solid, pool);
    case kBox: return ray_shape<kBox>(o, d, prm, solid, pool);
    case kPlane: return ray_shape<kPlane>(o, d, prm, solid, pool);
    case kCylinder: return ray_shape<kCylinder>(o, d, prm, solid, pool);
    case kCone: return ray_shape<kCone>(o, d, prm, solid, pool);
    case kConvex: return ray_shape<kConvex>(o, d, prm, solid, pool);
    default: return ray_shape<kMiss>(o, d, prm, solid, pool);
  }
}

}  // namespace
