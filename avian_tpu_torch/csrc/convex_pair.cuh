// Device code shared by Kernels M and O (convex_manifold.cu) and Kernels P
// and Q (hull_manifold.cu): support functions, support patches, the
// Frank-Wolfe / subgradient direction search, the patch clip and the 4-point
// reduction of avian_tpu/geometry/convex.py, one thread per pair.
//
// The arithmetic follows the plain PyTorch version (geometry/convex.py)
// operation by operation: sums in its order, IEEE square roots and divisions
// (__fsqrt_rn, __fdiv_rn), no fused multiply-adds (-fmad=false), argmin and
// argmax taking the first of equals, sign 0 at 0, the clip's compaction in
// the reference's sort order. The disc tables come from the caller (numpy's
// float32 cos/sin); the code computes no cos. Where the reference selects
// between the clipped and the degenerate manifold at the end, generic_pair
// branches and computes only the one it keeps.
//
// A pool-backed convex shape (kConvex: hulls, round cuboids, triangles)
// reads its `nv` (at most 32) vertices from the world's vertex pool through
// `hv` and never past them; the reference reads a fixed window of 32 rows
// and masks the rest, which the masks below reproduce.
#pragma once
#include "common.cuh"

namespace {

constexpr int kSphere = 0, kCapsule = 1, kBox = 2, kCylinder = 4, kCone = 5, kSegment = 6,
              kConvex = 8;
constexpr int kPatch = 8, kClip = 16, kFwIters = 24, kDepthIters = 20, kHullVerts = 32;
constexpr float kEps = 1e-9f;
constexpr float kEps2 = (float)(1e-9 * 1e-9);
constexpr float kFaceSnap = 0.98f, kFaceTol = 0.98f, kSideTol = 0.05f;
constexpr float kCapsuleSide = (float)(1.0 - 0.05);

struct Out {
  V3 normal;
  V3 pa[4];
  V3 pb[4];
  float sep[4];
  int fid[4];
  int count;
};

struct Patch {
  V3 p[kPatch];
  V3 nf;
  int cnt;
};

struct Disc {
  float c[kPatch], s[kPatch];
};

// One side of a pair: its world pose and shape. Primitives read `prm` (the
// first three params); a kConvex shape reads `hv`/`nv` (its vertices in the
// pool), `size` (the largest of its half extents, at least 1e-3), `radius`
// (lane 6) and `flat` (lane 5 > 0.5).
struct Pose {
  V3 p;
  Q4 q;
  V3 prm;
  const float* hv;
  int nv;
  float size, radius;
  bool flat;
};

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ float sign0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ V3 x_axis() { return v3(1.0f, 0.0f, 0.0f); }
__device__ __forceinline__ V3 rotate_inv(Q4 q, V3 v) { return rotate(conj(q), v); }

// vec.normalize_or_rn
__device__ V3 nrm_or(V3 a, V3 fb) {
  float n2 = dot(a, a);
  bool ok = n2 > 1e-12f;
  float inv = ok ? __fdiv_rn(1.0f, sqrt_rn(fmaxf(n2, 1e-12f))) : 0.0f;
  return ok ? a * inv : fb;
}
__device__ __forceinline__ V3 nrm(V3 a) { return nrm_or(a, x_axis()); }

__device__ V3 any_orthonormal(V3 n) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = __fdiv_rn(-1.0f, sign + n.z);
  float b = n.x * n.y * a;
  return v3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
}

// r / sqrt(r^2 + 4 h^2), as XLA compiles the reference: r * (1 / sqrt(...)).
__device__ __forceinline__ float cone_sin(float h, float r) {
  return r * __fdiv_rn(1.0f, sqrt_rn(r * r + 4.0f * h * h));
}

// The rim point of the disc of radius r along d's xz part (0 if it vanishes).
__device__ void radial(V3 d, float r, float& x, float& z) {
  float dxz = sqrt_rn(d.x * d.x + d.z * d.z);
  float scale = __fdiv_rn(r, fmaxf(dxz, kEps));
  bool ok = dxz > kEps;
  x = ok ? d.x * scale : 0.0f;
  z = ok ? d.z * scale : 0.0f;
}

__device__ __forceinline__ V3 hull_vert(const Pose& s, int j) { return load3(s.hv + 3 * j); }

// ---- local support functions ---------------------------------------------

template <int T>
__device__ V3 support(const Pose& s, V3 d);

template <>
__device__ V3 support<kSphere>(const Pose& s, V3 d) {
  return s.prm.x * nrm(d);
}

template <>
__device__ V3 support<kCapsule>(const Pose& s, V3 d) {
  float h = s.prm.x, r = s.prm.y;
  V3 n = nrm(d);
  return v3(r * n.x, h * sign0(d.y) + r * n.y, r * n.z);
}

template <>
__device__ V3 support<kBox>(const Pose& s, V3 d) {
  V3 prm = s.prm;
  return v3(d.x >= 0.0f ? prm.x : -prm.x, d.y >= 0.0f ? prm.y : -prm.y,
            d.z >= 0.0f ? prm.z : -prm.z);
}

template <>
__device__ V3 support<kCylinder>(const Pose& s, V3 d) {
  float x, z;
  radial(d, s.prm.y, x, z);
  return v3(x, s.prm.x * sign0(d.y), z);
}

template <>
__device__ V3 support<kCone>(const Pose& s, V3 d) {
  float h = s.prm.x, r = s.prm.y;
  float dn = sqrt_rn(fmaxf(dot(d, d), kEps2));
  if (d.y > cone_sin(h, r) * dn) return v3(0.0f, h, 0.0f);
  float x, z;
  radial(d, r, x, z);
  return v3(x, -h, z);
}

// Segment on local x, half length prm.x: X * (h * sx).
template <>
__device__ V3 support<kSegment>(const Pose& s, V3 d) {
  float sx = sign0(d.x) + (d.x == 0.0f ? 1.0f : 0.0f);
  float hs = s.prm.x * sx;
  return v3(hs, 0.0f * hs, 0.0f * hs);
}

// The first vertex farthest along d, plus radius * d_hat.
template <>
__device__ V3 support<kConvex>(const Pose& s, V3 d) {
  int best = 0;
  float top = dot(hull_vert(s, 0), d);
  for (int j = 1; j < s.nv; ++j) {
    float v = dot(hull_vert(s, j), d);
    if (v > top) {
      top = v;
      best = j;
    }
  }
  return hull_vert(s, best) + s.radius * nrm(d);
}

// ---- support patches -------------------------------------------------------

__device__ void fill(Patch& p, V3 v, int from) {
  for (int k = from; k < kPatch; ++k) p.p[k] = v;
}

__device__ void disc(Patch& p, const Disc& t, float r, float y) {
  for (int k = 0; k < kPatch; ++k) p.p[k] = v3(r * t.c[k], y, r * t.s[k]);
}

template <int T>
__device__ void patch(const Pose& s, V3 d, const Disc& t, Patch& p);

template <>
__device__ void patch<kSphere>(const Pose& s, V3 d, const Disc&, Patch& p) {
  V3 dn = nrm(d);
  fill(p, s.prm.x * dn, 0);
  p.nf = dn;
  p.cnt = 1;
}

template <>
__device__ void patch<kCapsule>(const Pose& s, V3 d, const Disc&, Patch& p) {
  float h = s.prm.x, r = s.prm.y;
  V3 dn = nrm(d);
  V3 perp = nrm(v3(dn.x, 0.0f, dn.z));
  fill(p, support<kCapsule>(s, d), 0);
  if (fabsf(dn.y) < kCapsuleSide) {
    p.p[0] = v3(r * perp.x, -h, r * perp.z);
    p.p[1] = v3(r * perp.x, h, r * perp.z);
    p.nf = perp;
    p.cnt = 2;
  } else {
    p.nf = dn;
    p.cnt = 1;
  }
}

template <>
__device__ void patch<kBox>(const Pose& s, V3 d, const Disc&, Patch& p) {
  V3 prm = s.prm;
  V3 dn = nrm(d);
  V3 ad = v3(fabsf(dn.x), fabsf(dn.y), fabsf(dn.z));
  int ax = 0;
  if (ad.y > comp(ad, ax)) ax = 1;
  if (ad.z > comp(ad, ax)) ax = 2;
  float c = comp(dn, ax);
  float sg = sign0(c) + (c == 0.0f ? 1.0f : 0.0f);
  p.nf = v3(ax == 0 ? sg : 0.0f * sg, ax == 1 ? sg : 0.0f * sg, ax == 2 ? sg : 0.0f * sg);
  int iu = (ax + 1) % 3, iv = (ax + 2) % 3;
  float h_ax = comp(prm, ax), h_u = comp(prm, iu), h_v = comp(prm, iv);
  const float quad[4][2] = {{1.0f, 1.0f}, {-1.0f, 1.0f}, {-1.0f, -1.0f}, {1.0f, -1.0f}};
  for (int k = 0; k < 4; ++k) {
    float f[3] = {sg * h_ax, quad[k][0] * h_u, quad[k][1] * h_v};
    // component c is face coordinate (c - ax) mod 3
    p.p[k] = v3(f[(3 - ax) % 3], f[(4 - ax) % 3], f[(5 - ax) % 3]);
  }
  fill(p, p.p[0], 4);
  p.cnt = 4;
}

template <>
__device__ void patch<kCylinder>(const Pose& s, V3 d, const Disc& t, Patch& p) {
  float h = s.prm.x, r = s.prm.y;
  V3 dn = nrm(d);
  float sy = sign0(dn.y) + (dn.y == 0.0f ? 1.0f : 0.0f);
  V3 perp = nrm(v3(dn.x, 0.0f, dn.z));
  if (fabsf(dn.y) > kFaceTol) {  // cap
    disc(p, t, r, sy * h);
    p.nf = v3(0.0f, sy, 0.0f);
    p.cnt = kPatch;
    return;
  }
  fill(p, support<kCylinder>(s, d), 0);
  if (fabsf(dn.y) < kSideTol) {  // side line
    p.p[0] = v3(r * perp.x, -h, r * perp.z);
    p.p[1] = v3(r * perp.x, h, r * perp.z);
    p.nf = perp;
    p.cnt = 2;
  } else {  // rim point
    p.nf = dn;
    p.cnt = 1;
  }
}

template <>
__device__ void patch<kCone>(const Pose& s, V3 d, const Disc& t, Patch& p) {
  float h = s.prm.x, r = s.prm.y;
  V3 dn = nrm(d);
  V3 perp = nrm(v3(dn.x, 0.0f, dn.z));
  if (dn.y < -kFaceTol) {  // base disc
    disc(p, t, r, -h);
    p.nf = v3(0.0f, -1.0f, 0.0f);
    p.cnt = kPatch;
  } else if (dn.y > cone_sin(h, r) + kSideTol) {  // apex
    fill(p, v3(0.0f, h, 0.0f), 0);
    p.nf = dn;
    p.cnt = 1;
  } else {  // side line: apex -> base rim point, slant normal
    V3 rim = v3(r * perp.x, -h, r * perp.z);
    fill(p, rim, 0);
    p.p[0] = v3(0.0f, h, 0.0f);
    float two_h = 2.0f * h;
    p.nf = nrm(v3(two_h * perp.x, r, two_h * perp.z));
    p.cnt = 2;
  }
}

// The whole segment when d is mostly across it, else its near end.
template <>
__device__ void patch<kSegment>(const Pose& s, V3 d, const Disc&, Patch& p) {
  float h = s.prm.x;
  V3 dn = nrm(d);
  V3 perp = nrm_or(v3(0.0f * dn.x, dn.y, dn.z), v3(0.0f, 1.0f, 0.0f));
  fill(p, support<kSegment>(s, d), 0);
  if (fabsf(dn.x) < kCapsuleSide) {
    float nh = -h;
    p.p[0] = v3(nh, nh * 0.0f, nh * 0.0f);
    p.p[1] = v3(h, h * 0.0f, h * 0.0f);
    p.nf = perp;
    p.cnt = 2;
  } else {
    p.nf = dn;
    p.cnt = 1;
  }
}

// patch_convex: the hull's support face along d. Phase 1 takes the
// vertices within 0.35 size of the top support value along d and fits their
// plane (the cross of the two longest offsets from their centroid); phase 2
// takes those within 0.02 size along the fitted normal, unless that set is
// smaller than min(k1, 3); a shape of at most 3 vertices is its own face.
// The top 8 of the set by support value (ties: the lower index), ordered by
// angle about their centroid (a stable sort), padded with the first, the
// face normal from the ring, lifted by the radius. Sets are bit masks over
// the (at most 32) vertices.
template <>
__device__ void patch<kConvex>(const Pose& s, V3 d, const Disc&, Patch& p) {
  const int nv = s.nv;
  V3 dn = nrm(d);
  float dots_dn[kHullVerts];
  float top = -1e30f;
  for (int j = 0; j < nv; ++j) {
    dots_dn[j] = dot(hull_vert(s, j), dn);
    top = fmaxf(top, dots_dn[j]);
  }
  unsigned near1 = 0u;
  int k1 = 0;
  float lim1 = top - 0.35f * s.size;
  for (int j = 0; j < nv; ++j) {
    if (dots_dn[j] > lim1) {
      near1 |= 1u << j;
      ++k1;
    }
  }
  // Centroid of the loose set (summed from 0 upward; rows outside it add +0).
  V3 c1 = v3(0.0f, 0.0f, 0.0f);
  for (int j = 0; j < nv; ++j)
    if (near1 >> j & 1u) c1 = c1 + hull_vert(s, j);
  float k1f = fmaxf((float)k1, 1.0f);
  c1 = v3(__fdiv_rn(c1.x, k1f), __fdiv_rn(c1.y, k1f), __fdiv_rn(c1.z, k1f));
  // The longest offset, then the offset whose cross with it is longest
  // (first of equals; rows outside the set are 0).
  V3 zero = v3(0.0f, 0.0f, 0.0f);
  int ia = 0;
  float best = (near1 & 1u) ? dot(hull_vert(s, 0) - c1, hull_vert(s, 0) - c1) : 0.0f;
  for (int j = 1; j < nv; ++j) {
    if (!(near1 >> j & 1u)) continue;
    V3 r = hull_vert(s, j) - c1;
    float v = dot(r, r);
    if (v > best) {
      best = v;
      ia = j;
    }
  }
  V3 ra = (near1 >> ia & 1u) ? hull_vert(s, ia) - c1 : zero;
  int ib = 0;
  {
    V3 r0 = (near1 & 1u) ? hull_vert(s, 0) - c1 : zero;
    V3 c0 = cross(ra, r0);
    best = dot(c0, c0);
  }
  for (int j = 1; j < kHullVerts; ++j) {
    V3 r = (j < nv && (near1 >> j & 1u)) ? hull_vert(s, j) - c1 : zero;
    V3 c = cross(ra, r);
    float v = dot(c, c);
    if (v > best) {
      best = v;
      ib = j;
    }
  }
  V3 rb = (ib < nv && (near1 >> ib & 1u)) ? hull_vert(s, ib) - c1 : zero;
  V3 nf_fit = nrm_or(cross(ra, rb), dn);
  nf_fit = nf_fit * sign0(dot(nf_fit, dn) + 1e-12f);
  V3 axis2 = k1 >= 3 ? nf_fit : dn;

  // Phase 2: the tight band along the fitted normal.
  float dots2[kHullVerts];
  top = -1e30f;
  for (int j = 0; j < nv; ++j) {
    dots2[j] = dot(hull_vert(s, j), axis2);
    top = fmaxf(top, dots2[j]);
  }
  unsigned near2 = 0u;
  int k2 = 0;
  float lim2 = top - 0.02f * s.size;
  for (int j = 0; j < nv; ++j) {
    if (dots2[j] > lim2) {
      near2 |= 1u << j;
      ++k2;
    }
  }
  unsigned near = near1;
  const float* score = dots_dn;
  if (k2 >= (k1 < 3 ? k1 : 3)) {
    near = near2;
    score = dots2;
  }
  if (nv <= 3) {
    near = nv >= 32 ? 0xffffffffu : (1u << nv) - 1u;
    score = dots_dn;
  }

  // The top 8 of the set by score, ties to the lower index.
  int idx[kPatch];
  int k = 0;
  unsigned left = near;
  while (left && k < kPatch) {
    int bi = __ffs(left) - 1;
    for (int j = bi + 1; j < nv; ++j)
      if ((left >> j & 1u) && score[j] > score[bi]) bi = j;
    idx[k++] = bi;
    left &= ~(1u << bi);
  }

  // Angle order about the selected points' centroid (stable on ties).
  V3 t1 = any_orthonormal(dn);
  V3 t2 = cross(dn, t1);
  V3 pts[kPatch];
  V3 cen = v3(0.0f, 0.0f, 0.0f);
  for (int r = 0; r < k; ++r) {
    pts[r] = hull_vert(s, idx[r]);
    cen = cen + pts[r];
  }
  float kf = fmaxf((float)k, 1.0f);
  cen = v3(__fdiv_rn(cen.x, kf), __fdiv_rn(cen.y, kf), __fdiv_rn(cen.z, kf));
  float ang[kPatch];
  for (int r = 0; r < k; ++r) {
    V3 rel = pts[r] - cen;
    ang[r] = atan2f(dot(rel, t2), dot(rel, t1));
  }
  for (int r = 1; r < k; ++r) {
    float a = ang[r];
    V3 v = pts[r];
    int q = r - 1;
    while (q >= 0 && ang[q] > a) {
      ang[q + 1] = ang[q];
      pts[q + 1] = pts[q];
      --q;
    }
    ang[q + 1] = a;
    pts[q + 1] = v;
  }
  for (int r = 0; r < kPatch; ++r) p.p[r] = r < k ? pts[r] : pts[0];

  // Face normal from the ring, sign-aligned with d; d below 3 points.
  V3 nf = nrm_or(cross(p.p[1] - p.p[0], p.p[2] - p.p[0]), dn);
  nf = nf * sign0(dot(nf, dn) + 1e-12f);
  p.nf = k >= 3 ? nf : dn;
  for (int r = 0; r < kPatch; ++r) p.p[r] = p.p[r] + s.radius * p.nf;
  p.cnt = k;
}

// ---- world-frame supports --------------------------------------------------

template <int T>
__device__ __forceinline__ V3 wsupport(const Pose& s, V3 d) {
  return s.p + rotate(s.q, support<T>(s, rotate_inv(s.q, d)));
}

// Support of A (-) B.
template <int TA, int TB>
__device__ __forceinline__ V3 sk(const Pose& a, const Pose& b, V3 d) {
  return wsupport<TA>(a, d) - wsupport<TB>(b, -d);
}

template <int T>
__device__ void world_patch(const Pose& s, V3 d, const Disc& t, Patch& p) {
  patch<T>(s, rotate_inv(s.q, d), t, p);
  for (int k = 0; k < kPatch; ++k) p.p[k] = s.p + rotate(s.q, p.p[k]);
  p.nf = rotate(s.q, p.nf);
}

// Closest point to the origin on triangle (a, b, c), the reference's
// Voronoi-region priority.
__device__ V3 closest_on_triangle(V3 a, V3 b, V3 c) {
  V3 ab = b - a, ac = c - a, ap = -a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  V3 bp = -b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  V3 cp = -c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d1 <= 0.0f && d2 <= 0.0f) return a;
  if (d3 >= 0.0f && d4 <= d3) return b;
  if (d6 >= 0.0f && d5 <= d6) return c;
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    float t = __fdiv_rn(d1, fmaxf(d1 - d3, kEps));
    return a + t * ab;
  }
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    float t = __fdiv_rn(d2, fmaxf(d2 - d6, kEps));
    return a + t * ac;
  }
  float va = d3 * d6 - d5 * d4;
  if (va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f) {
    float t = __fdiv_rn(d4 - d3, fmaxf((d4 - d3) + (d5 - d6), kEps));
    return b + t * (c - b);
  }
  float denom = va + vb + vc;
  float safe = fabsf(denom) > kEps ? denom : kEps;
  float v = __fdiv_rn(vb, safe), w = __fdiv_rn(vc, safe);
  return a + ab * v + ac * w;
}

// ---- clipping and reduction --------------------------------------------------

__device__ __forceinline__ float dot2(float2 a, float2 b) { return a.x * b.x + a.y * b.y; }
__device__ __forceinline__ float2 sub2(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Sutherland-Hodgman clip of ring q[0..count) against dot(n2, p) <= off:
// kept points and crossings in ring order, the first 16, padded with the
// first (the reference's sort of 2 idx / 2 idx + 1 keys).
__device__ void clip_halfplane(float2 q[kClip], int fids[kClip], int& count, float2 n2, float off,
                               int fid_base) {
  float2 out[kClip];
  int of[kClip];
  int m = 0;
  for (int idx = 0; idx < count; ++idx) {
    int nxt = idx + 1 >= count ? 0 : idx + 1;
    float d_cur = dot2(q[idx], n2) - off;
    float d_nxt = dot2(q[nxt], n2) - off;
    bool in_cur = d_cur <= 0.0f;
    if (in_cur) {
      if (m < kClip) {
        out[m] = q[idx];
        of[m] = fids[idx];
      }
      ++m;
    }
    if (in_cur != (d_nxt <= 0.0f)) {
      float diff = d_cur - d_nxt;
      float t = __fdiv_rn(d_cur, fabsf(diff) > 1e-12f ? diff : 1e-12f);
      float tc = fminf(fmaxf(t, 0.0f), 1.0f);
      if (m < kClip) {
        out[m] = make_float2(q[idx].x + (q[nxt].x - q[idx].x) * tc,
                             q[idx].y + (q[nxt].y - q[idx].y) * tc);
        of[m] = fid_base + idx;
      }
      ++m;
    }
  }
  int out_count = m < kClip ? m : kClip;
  if (out_count == 0) out[0] = q[0];
  for (int k = 0; k < kClip; ++k) {
    q[k] = k < out_count ? out[k] : out[0];
    fids[k] = k < out_count ? of[k] : 0;
  }
  count = out_count;
}

// The deepest, the farthest from it, and the largest and smallest signed
// areas against that edge; ok[k] marks a new, valid pick.
template <int P>
__device__ void reduce4(const float2 uv[P], const float seps[P], int count, int sel[4],
                        bool ok[4]) {
  int i0 = 0;
  float best = 0 < count ? seps[0] : 1e9f;
  for (int j = 1; j < P; ++j) {
    float s = j < count ? seps[j] : 1e9f;
    if (s < best) {
      best = s;
      i0 = j;
    }
  }
  float2 p0 = uv[i0];
  int i1 = 0;
  float far = -2.0f;
  for (int j = 0; j < P; ++j) {
    float2 du = sub2(uv[j], p0);
    float d2 = (j < count && j != i0) ? du.x * du.x + du.y * du.y : -1.0f;
    if (d2 > far) {
      far = d2;
      i1 = j;
    }
  }
  float2 e1 = sub2(uv[i1], p0);
  int i2 = 0, i3 = 0;
  float hi = 0.0f, lo = 0.0f;
  for (int j = 0; j < P; ++j) {
    float2 du = sub2(uv[j], p0);
    float cr = (j < count && j != i0 && j != i1) ? e1.x * du.y - e1.y * du.x : 0.0f;
    if (j == 0 || cr > hi) {
      hi = cr;
      i2 = j;
    }
    if (j == 0 || cr < lo) {
      lo = cr;
      i3 = j;
    }
  }
  sel[0] = i0;
  sel[1] = i1;
  sel[2] = i2;
  sel[3] = i3;
  ok[0] = true;
  ok[1] = i1 != i0;
  ok[2] = i2 != i0 && i2 != i1;
  ok[3] = i3 != i0 && i3 != i1 && i3 != i2;
  for (int k = 0; k < 4; ++k) ok[k] = ok[k] && sel[k] < count;
}

// ---- one pair ----------------------------------------------------------------

// generic_convex_pair (with generic_convex_pair_aux's flat rule) for shape
// types TA, TB.
template <int TA, int TB>
__device__ void generic_pair(const Pose& A, const Pose& B, const Disc& t, Out& o) {
  // direction: Frank-Wolfe distance, subgradient depth
  V3 x = A.p - B.p;
  V3 s_prev = sk<TA, TB>(A, B, -x);
  for (int it = 0; it < kFwIters; ++it) {
    V3 s = sk<TA, TB>(A, B, -x);
    x = closest_on_triangle(x, s, s_prev);
    s_prev = s;
  }
  float dist = sqrt_rn(dot(x, x));
  V3 ab = nrm(B.p - A.p);
  V3 sep_dir = nrm_or(-x, ab);

  V3 d = ab, best_d = ab;
  float best_v = dot(sk<TA, TB>(A, B, ab), ab);
  for (int it = 0; it < kDepthIters; ++it) {
    V3 s = sk<TA, TB>(A, B, d);
    float v = dot(s, d);
    if (v < best_v) {
      best_d = d;
      best_v = v;
    }
    V3 g = s - v * d;
    float step = __fdiv_rn(0.5f, sqrt_rn(1.0f + (float)it));
    d = nrm_or(d - step * g, d);
  }
  bool penetrating = dist < 1e-4f || (dist < 1e-2f && best_v > 0.0f);
  V3 n = penetrating ? nrm(best_d) : sep_dir;

  // patches + polish
  Patch pa, pb;
  world_patch<TA>(A, n, t, pa);
  world_patch<TB>(B, -n, t, pb);
  float align_a = dot(pa.nf, n);
  float align_b = dot(pb.nf, -n);
  bool elig_a = align_a > kFaceSnap && pa.cnt >= 2;
  bool elig_b = align_b > kFaceSnap && pb.cnt >= 2;
  bool snap_a = elig_a && (!elig_b || align_a >= align_b);
  bool snap_b = elig_b && !snap_a;
  n = snap_a ? pa.nf : (snap_b ? -pb.nf : n);
  // Flat shapes dominate: a frontal contact takes the normal of their plane,
  // where the other shape's centre lies in front of the face the contact
  // sees (the reference asks only the alignment: ROADMAP 3b).
  bool prefer_b = TB == kConvex && B.flat && align_b > 0.3f && pb.cnt >= 3 &&
                  dot(pb.nf, A.p - B.p) > 0.0f;
  bool prefer_a = TA == kConvex && A.flat && align_a > 0.3f && pa.cnt >= 3 &&
                  dot(pa.nf, B.p - A.p) > 0.0f && (!prefer_b || align_a > align_b);
  n = nrm(prefer_a ? pa.nf : (prefer_b ? -pb.nf : n));
  world_patch<TA>(A, n, t, pa);
  world_patch<TB>(B, -n, t, pb);

  // 2D frame; reference = the patch with more points (tie: better aligned,
  // by the first patches' alignments)
  V3 t1 = any_orthonormal(n);
  V3 t2 = cross(n, t1);
  bool ref_is_a = pa.cnt > pb.cnt || (pa.cnt == pb.cnt && align_a >= align_b);
  const Patch& ref = ref_is_a ? pa : pb;
  const Patch& inc = ref_is_a ? pb : pa;
  int ref_cnt = ref.cnt;

  if (ref_cnt >= 3) {
    float2 ref2[kPatch];
    for (int k = 0; k < kPatch; ++k) ref2[k] = make_float2(dot(ref.p[k], t1), dot(ref.p[k], t2));
    float2 q[kClip];
    int fids[kClip];
    int inc_cnt = inc.cnt;
    float2 inc0 = make_float2(dot(inc.p[0], t1), dot(inc.p[0], t2));
    for (int k = 0; k < kClip; ++k) {
      bool in_ring = k < inc_cnt && k < kPatch;
      q[k] = in_ring ? make_float2(dot(inc.p[k], t1), dot(inc.p[k], t2)) : inc0;
      fids[k] = k < inc_cnt ? k : 0;
    }
    int cnt = inc_cnt < kClip ? inc_cnt : kClip;

    float2 centroid = ref_cnt > 0 ? ref2[0] : make_float2(0.0f, 0.0f);
    for (int j = 1; j < kPatch; ++j) {
      float2 add = ref_cnt > j ? ref2[j] : make_float2(0.0f, 0.0f);
      centroid = make_float2(centroid.x + add.x, centroid.y + add.y);
    }
    float denom = fmaxf((float)ref_cnt, 1.0f);
    centroid = make_float2(__fdiv_rn(centroid.x, denom), __fdiv_rn(centroid.y, denom));

    for (int e = 0; e < kPatch; ++e) {
      if (e >= ref_cnt) break;  // an inactive edge clips nothing
      float2 v0 = ref2[e];
      float2 v1 = ref2[ref_cnt <= e + 1 ? 0 : e + 1];
      float2 edge = sub2(v1, v0);
      if (!(sqrt_rn(dot2(edge, edge)) > 1e-9f)) continue;
      float2 n2 = make_float2(-edge.y, edge.x);
      float sg = sign0(dot2(n2, sub2(centroid, v0)) + 1e-12f);
      n2 = make_float2(-(n2.x * sg), -(n2.y * sg));
      clip_halfplane(q, fids, cnt, n2, dot2(n2, v0), 16 + 8 * e);
    }

    // lift back to 3D + separations
    float nfn_a = dot(pa.nf, n), nfn_b = dot(pb.nf, n);
    bool safe_a = fabsf(nfn_a) > 0.2f, safe_b = fabsf(nfn_b) > 0.2f;
    float off_a = dot(pa.nf, pa.p[0]), off_b = dot(pb.nf, pb.p[0]);
    float pn_a = dot(pa.p[0], n), pn_b = dot(pb.p[0], n);
    V3 on_a[kClip], on_b[kClip];
    float seps[kClip];
    for (int j = 0; j < kClip; ++j) {
      V3 p3 = q[j].x * t1 + q[j].y * t2;
      float p3n = dot(p3, n);
      float sa = safe_a ? __fdiv_rn(off_a - dot(p3, pa.nf), nfn_a) : pn_a - p3n;
      float sb = safe_b ? __fdiv_rn(off_b - dot(p3, pb.nf), nfn_b) : pn_b - p3n;
      on_a[j] = p3 + sa * n;
      on_b[j] = p3 + sb * n;
      seps[j] = dot(on_b[j] - on_a[j], n);
    }
    int sel[4];
    bool ok[4];
    reduce4<kClip>(q, seps, cnt, sel, ok);
    int out_cnt = 0;
    for (int k = 0; k < 4; ++k) out_cnt += ok[k] ? 1 : 0;
    if (out_cnt > 0) {
      o.normal = n;
      for (int k = 0; k < 4; ++k) {
        o.pa[k] = on_a[sel[k]];
        o.pb[k] = on_b[sel[k]];
        o.sep[k] = ok[k] ? seps[sel[k]] : 1e9f;
        o.fid[k] = ok[k] ? fids[sel[k]] : 0;
      }
      o.count = out_cnt;
      return;
    }
  }

  // degenerate: 1-2 points from the support witnesses
  bool both_seg = pa.cnt == 2 && pb.cnt == 2;
  V3 dir_a = nrm(pa.p[1] - pa.p[0]);
  bool parallel = fabsf(dot(dir_a, nrm(pb.p[1] - pb.p[0]))) > 0.999f;
  float ta0 = dot(pa.p[0], dir_a), ta1 = dot(pa.p[1], dir_a);
  float tb0 = dot(pb.p[0], dir_a), tb1 = dot(pb.p[1], dir_a);
  float lo = fmaxf(fminf(ta0, ta1), fminf(tb0, tb1));
  float hi = fminf(fmaxf(ta0, ta1), fmaxf(tb0, tb1));
  o.normal = n;
  for (int k = 2; k < 4; ++k) {
    o.pa[k] = v3(0.0f, 0.0f, 0.0f);
    o.pb[k] = v3(0.0f, 0.0f, 0.0f);
    o.sep[k] = 1e9f;
    o.fid[k] = 0;
  }
  o.fid[0] = 0;
  o.fid[1] = 1;
  if (both_seg && parallel && hi >= lo) {
    V3 ba = pb.p[0] - pa.p[0];
    V3 shift = ba - dot(ba, dir_a) * dir_a;
    float tm[2] = {lo, hi};
    for (int k = 0; k < 2; ++k) {
      o.pa[k] = pa.p[0] + (tm[k] - ta0) * dir_a;
      o.pb[k] = o.pa[k] + shift;
      o.sep[k] = dot(o.pb[k] - o.pa[k], n);
    }
    o.count = 2;
  } else {
    V3 wa = wsupport<TA>(A, n);
    V3 wb = wsupport<TB>(B, -n);
    o.pa[0] = wa;
    o.pb[0] = wb;
    o.pa[1] = pa.p[1];
    o.pb[1] = pb.p[1];
    o.sep[0] = dot(wb - wa, n);
    o.sep[1] = 1e9f;
    o.count = 1;
  }
}

// support_patch_plane_pair: the half-space through plane_p with world
// normal n_plane against shape B of type T: B's support patch along the
// plane's inward normal, reduced to 4 spread points; the normal points from
// the plane to the shape.
template <int T>
__device__ void plane_patch(V3 plane_p, V3 n_plane, const Pose& B, const Disc& t, Out& o) {
  Patch p;
  world_patch<T>(B, -n_plane, t, p);
  V3 t1 = any_orthonormal(n_plane);
  V3 t2 = cross(n_plane, t1);
  float2 uv[kPatch];
  float seps[kPatch];
  for (int k = 0; k < kPatch; ++k) {
    seps[k] = k < p.cnt ? dot(p.p[k] - plane_p, n_plane) : 1e9f;
    uv[k] = make_float2(dot(p.p[k], t1), dot(p.p[k], t2));
  }
  int sel[4];
  bool ok[4];
  reduce4<kPatch>(uv, seps, p.cnt, sel, ok);
  o.normal = n_plane;
  o.count = 0;
  for (int k = 0; k < 4; ++k) {
    V3 p4 = p.p[sel[k]];
    float s4 = seps[sel[k]];
    o.pa[k] = p4 - n_plane * s4;
    o.pb[k] = p4;
    o.sep[k] = ok[k] ? s4 : 1e9f;
    o.fid[k] = ok[k] ? sel[k] : 0;
    o.count += ok[k] ? 1 : 0;
  }
}

// ---- loads and stores ----------------------------------------------------------

__device__ __forceinline__ Disc load_disc(const float* disc) {
  Disc t;
  for (int k = 0; k < kPatch; ++k) {
    t.c[k] = disc[k];
    t.s[k] = disc[kPatch + k];
  }
  return t;
}

// A primitive side: params (stride 3).
__device__ __forceinline__ Pose load_pose(const float* p, const float* q, const float* prm) {
  return Pose{load3(p), load4(q), load3(prm), nullptr, 0, 0.0f, 0.0f, false};
}

// Any side from 7-lane params (offset, count, hx, hy, hz, flat, radius); the
// pool fields are set for a kConvex shape only. Offsets are exact in f32 up
// to 2^24 vertices.
template <int T>
__device__ __forceinline__ Pose load_pose7(const float* p, const float* q, const float* prm,
                                           const float* pool) {
  Pose s{load3(p), load4(q), load3(prm), nullptr, 0, 0.0f, 0.0f, false};
  if (T == kConvex) {
    s.hv = pool + 3 * (long long)(int)prm[0];
    s.nv = (int)prm[1];
    s.size = fmaxf(fmaxf(fmaxf(prm[2], prm[3]), prm[4]), 1e-3f);
    s.flat = prm[5] > 0.5f;
    s.radius = prm[6];
  }
  return s;
}

__device__ __forceinline__ void store(const Out& o, int i, float* normal, float* point_a,
                                      float* point_b, float* sep, int* fid, int* count) {
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
