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
// the two shape types, instantiated for the ten pairs of the mixed-shape
// path; the caller buckets pairs by shape code, so a warp runs one support
// function per side without divergence. The rings live in local memory.
//
// The arithmetic follows the plain PyTorch version (geometry/convex.py)
// operation by operation: sums in its order, IEEE square roots and divisions
// (__fsqrt_rn, __fdiv_rn), no fused multiply-adds (-fmad=false), argmin and
// argmax taking the first of equals, sign 0 at 0, the clip's compaction in
// the reference's sort order. The disc tables come from the caller (numpy's
// float32 cos/sin); the kernel computes no cos. Where the reference selects
// between the clipped and the degenerate manifold at the end, the kernel
// branches and computes only the one it keeps.
#include "common.cuh"

namespace {

constexpr int kSphere = 0, kCapsule = 1, kBox = 2, kCylinder = 4, kCone = 5;
constexpr int kPatch = 8, kClip = 16, kFwIters = 24, kDepthIters = 20;
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

// ---- local support functions ---------------------------------------------

template <int T>
__device__ V3 support(V3 prm, V3 d);

template <>
__device__ V3 support<kSphere>(V3 prm, V3 d) {
  return prm.x * nrm(d);
}

template <>
__device__ V3 support<kCapsule>(V3 prm, V3 d) {
  float h = prm.x, r = prm.y;
  V3 n = nrm(d);
  return v3(r * n.x, h * sign0(d.y) + r * n.y, r * n.z);
}

template <>
__device__ V3 support<kBox>(V3 prm, V3 d) {
  return v3(d.x >= 0.0f ? prm.x : -prm.x, d.y >= 0.0f ? prm.y : -prm.y,
            d.z >= 0.0f ? prm.z : -prm.z);
}

template <>
__device__ V3 support<kCylinder>(V3 prm, V3 d) {
  float x, z;
  radial(d, prm.y, x, z);
  return v3(x, prm.x * sign0(d.y), z);
}

template <>
__device__ V3 support<kCone>(V3 prm, V3 d) {
  float h = prm.x, r = prm.y;
  float dn = sqrt_rn(fmaxf(dot(d, d), kEps2));
  if (d.y > cone_sin(h, r) * dn) return v3(0.0f, h, 0.0f);
  float x, z;
  radial(d, r, x, z);
  return v3(x, -h, z);
}

// ---- support patches -------------------------------------------------------

__device__ void fill(Patch& p, V3 v, int from) {
  for (int k = from; k < kPatch; ++k) p.p[k] = v;
}

__device__ void disc(Patch& p, const Disc& t, float r, float y) {
  for (int k = 0; k < kPatch; ++k) p.p[k] = v3(r * t.c[k], y, r * t.s[k]);
}

template <int T>
__device__ void patch(V3 prm, V3 d, const Disc& t, Patch& p);

template <>
__device__ void patch<kSphere>(V3 prm, V3 d, const Disc&, Patch& p) {
  V3 dn = nrm(d);
  fill(p, prm.x * dn, 0);
  p.nf = dn;
  p.cnt = 1;
}

template <>
__device__ void patch<kCapsule>(V3 prm, V3 d, const Disc&, Patch& p) {
  float h = prm.x, r = prm.y;
  V3 dn = nrm(d);
  V3 perp = nrm(v3(dn.x, 0.0f, dn.z));
  fill(p, support<kCapsule>(prm, d), 0);
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
__device__ void patch<kBox>(V3 prm, V3 d, const Disc&, Patch& p) {
  V3 dn = nrm(d);
  V3 ad = v3(fabsf(dn.x), fabsf(dn.y), fabsf(dn.z));
  int ax = 0;
  if (ad.y > comp(ad, ax)) ax = 1;
  if (ad.z > comp(ad, ax)) ax = 2;
  float c = comp(dn, ax);
  float s = sign0(c) + (c == 0.0f ? 1.0f : 0.0f);
  p.nf = v3(ax == 0 ? s : 0.0f * s, ax == 1 ? s : 0.0f * s, ax == 2 ? s : 0.0f * s);
  int iu = (ax + 1) % 3, iv = (ax + 2) % 3;
  float h_ax = comp(prm, ax), h_u = comp(prm, iu), h_v = comp(prm, iv);
  const float quad[4][2] = {{1.0f, 1.0f}, {-1.0f, 1.0f}, {-1.0f, -1.0f}, {1.0f, -1.0f}};
  for (int k = 0; k < 4; ++k) {
    float f[3] = {s * h_ax, quad[k][0] * h_u, quad[k][1] * h_v};
    // component c is face coordinate (c - ax) mod 3
    p.p[k] = v3(f[(3 - ax) % 3], f[(4 - ax) % 3], f[(5 - ax) % 3]);
  }
  fill(p, p.p[0], 4);
  p.cnt = 4;
}

template <>
__device__ void patch<kCylinder>(V3 prm, V3 d, const Disc& t, Patch& p) {
  float h = prm.x, r = prm.y;
  V3 dn = nrm(d);
  float sy = sign0(dn.y) + (dn.y == 0.0f ? 1.0f : 0.0f);
  V3 perp = nrm(v3(dn.x, 0.0f, dn.z));
  if (fabsf(dn.y) > kFaceTol) {  // cap
    disc(p, t, r, sy * h);
    p.nf = v3(0.0f, sy, 0.0f);
    p.cnt = kPatch;
    return;
  }
  fill(p, support<kCylinder>(prm, d), 0);
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
__device__ void patch<kCone>(V3 prm, V3 d, const Disc& t, Patch& p) {
  float h = prm.x, r = prm.y;
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

// ---- world-frame supports --------------------------------------------------

struct Pose {
  V3 p;
  Q4 q;
  V3 prm;
};

template <int T>
__device__ __forceinline__ V3 wsupport(const Pose& s, V3 d) {
  return s.p + rotate(s.q, support<T>(s.prm, rotate_inv(s.q, d)));
}

// Support of A (-) B.
template <int TA, int TB>
__device__ __forceinline__ V3 sk(const Pose& a, const Pose& b, V3 d) {
  return wsupport<TA>(a, d) - wsupport<TB>(b, -d);
}

template <int T>
__device__ void world_patch(const Pose& s, V3 d, const Disc& t, Patch& p) {
  patch<T>(s.prm, rotate_inv(s.q, d), t, p);
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

// ---- Kernel M --------------------------------------------------------------

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
  n = nrm(snap_a ? pa.nf : (snap_b ? -pb.nf : n));
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

__device__ __forceinline__ Disc load_disc(const float* disc) {
  Disc t;
  for (int k = 0; k < kPatch; ++k) {
    t.c[k] = disc[k];
    t.s[k] = disc[kPatch + k];
  }
  return t;
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
  Pose A{load3(pa + 3 * i), load4(qa + 4 * i), load3(prm_a + 3 * i)};
  Pose B{load3(pb + 3 * i), load4(qb + 4 * i), load3(prm_b + 3 * i)};
  Out o;
  generic_pair<TA, TB>(A, B, t, o);
  store(o, i, normal, point_a, point_b, sep, fid, count);
}

// ---- Kernel O --------------------------------------------------------------

// Half-space A (local normal in prm) against shape B of type T: B's support
// patch along the plane's inward normal, reduced to 4 spread points; the
// normal points from the plane to the shape.
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
  V3 plane_p = load3(pa + 3 * i);
  V3 n_plane = rotate(load4(qa + 4 * i), load3(na + 3 * i));
  Pose B{load3(pb + 3 * i), load4(qb + 4 * i), load3(prm_b + 3 * i)};
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
  Out o;
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
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AVIAN_PAIR
}

// kind 0: half-space/cylinder, 1: half-space/cone.
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
  return (int)cudaErrorInvalidValue;
}
