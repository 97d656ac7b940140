// Device code of the 2D engine's kernels U-Z and AA-AE, one function per
// thread's work.
//
// Each function below is the body of one thread of a kernel in
// grid_pairs_2d.cu (U), manifold_2d.cu (V), contact_rows_2d.cu (W),
// pack_2d.cu (X), solve_2d.cu (Y), integrate_2d.cu (Z and its prologue),
// solve_joints_2d.cu (AA), swept_toi_2d.cu (AB), ray_cast_2d.cu (AC),
// point_2d.cu (AD) or shape_cast_2d.cu (AE), or of the 2D writeback
// in body_pass.cu (K); those files hold the
// __global__ wrappers and the C entry points. Every expression is written
// in the order of the plain PyTorch versions in kernels/*_2d.py (and the
// library is built with -fmad=false), so that the kernels agree with them to
// the bit; the few exceptions are named where they occur. The functions use
// nothing but float arithmetic and sqrtf/cosf/sinf/atan2f, so they also
// compile as host C++ behind a stand-in cuda_runtime.h, for a check without
// a card.
#pragma once
#include "common.cuh"

namespace d2 {

constexpr float kBig = 1e9f;
constexpr int kVerts = 8;
constexpr int kSentinel = 0x7fffffff;

struct V2 {
  float x, y;
};

__device__ __forceinline__ V2 v2(float x, float y) { return V2{x, y}; }
__device__ __forceinline__ V2 operator+(V2 a, V2 b) { return v2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ V2 operator-(V2 a, V2 b) { return v2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ V2 operator-(V2 a) { return v2(-a.x, -a.y); }
__device__ __forceinline__ V2 operator*(V2 a, float s) { return v2(a.x * s, a.y * s); }
__device__ __forceinline__ float dot2(V2 a, V2 b) { return a.x * b.x + a.y * b.y; }
__device__ __forceinline__ float norm2(V2 a) { return sqrtf(a.x * a.x + a.y * a.y); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ V2 load2(const float* p) { return v2(p[0], p[1]); }
__device__ __forceinline__ void store2(float* p, V2 a) {
  p[0] = a.x;
  p[1] = a.y;
}
// v rotated by the angle of cosine c and sine s.
__device__ __forceinline__ V2 rot2(float c, float s, V2 v) {
  return v2(c * v.x - s * v.y, s * v.x + c * v.y);
}
__device__ __forceinline__ int next_vertex(int i, int n) { return i + 1 < n ? i + 1 : 0; }

// ---------------------------------------------------------------------------
// Kernel V: manifolds of rounded convex polygons (dim2/narrowphase.py:339).
// ---------------------------------------------------------------------------

struct Poly {
  V2 v[kVerts];  // world vertices
  int n;
  float r;
};

struct Manifold {
  V2 normal;
  V2 pa[2], pb[2];
  float sep[2];
  int fid[2];
  int count;
};

__device__ __forceinline__ Manifold empty_manifold() {
  Manifold m;
  m.normal = v2(0.0f, 1.0f);
  for (int p = 0; p < 2; ++p) {
    m.pa[p] = v2(0.0f, 0.0f);
    m.pb[p] = v2(0.0f, 0.0f);
    m.sep[p] = kBig;
    m.fid[p] = 0;
  }
  m.count = 0;
  return m;
}

__device__ __forceinline__ Manifold flip_manifold(Manifold m) {
  Manifold f = m;
  f.normal = -m.normal;
  for (int p = 0; p < 2; ++p) {
    f.pa[p] = m.pb[p];
    f.pb[p] = m.pa[p];
  }
  return f;
}

// normalize(perp(e)), perp(e) = (e.y, -e.x): the outward normal of a CCW edge.
__device__ __forceinline__ V2 edge_normal(V2 e) {
  float len = fmaxf(sqrtf(e.y * e.y + e.x * e.x), 1e-9f);
  return v2(e.y / len, -e.x / len);
}

// d / max(dist, 1e-9) where dist > 1e-9, else fallback.
__device__ __forceinline__ V2 unit_or(V2 d, float dist, V2 fallback) {
  if (!(dist > 1e-9f)) return fallback;
  float m = fmaxf(dist, 1e-9f);
  return v2(d.x / m, d.y / m);
}

__device__ __forceinline__ void load_poly(Poly& p, V2 pos, float c, float s, const float* verts,
                                          int n, float r) {
  for (int k = 0; k < kVerts; ++k)
    p.v[k] = v2(pos.x + (c * verts[2 * k] - s * verts[2 * k + 1]),
                pos.y + (s * verts[2 * k] + c * verts[2 * k + 1]));
  p.n = n;
  p.r = r;
}

__device__ __forceinline__ Manifold one_point(V2 normal, V2 pa, V2 pb, float sep, int fid) {
  Manifold m = empty_manifold();
  m.normal = normal;
  m.pa[0] = pa;
  m.pb[0] = pb;
  m.sep[0] = sep;
  m.fid[0] = fid;
  m.count = 1;
  return m;
}

__device__ __forceinline__ Manifold circle_circle(V2 pa, float ra, V2 pb, float rb) {
  V2 d = pb - pa;
  float dist = norm2(d);
  V2 n = unit_or(d, dist, v2(1.0f, 0.0f));
  return one_point(n, pa + n * ra, pb - n * rb, dist - ra - rb, 0);
}

// Reference _closest_on_poly (:113): the point of q's core polygon closest
// to p (on its boundary), whether p is inside it (3 or more vertices), and
// the face whose line p is deepest behind (normal and depth). Ties in the
// closest edge and the deepest face go to the first edge.
struct Closest {
  V2 closest, n_face;
  float face_d;
  bool inside;
  int edge;
};

__device__ __forceinline__ Closest closest_on_poly(V2 p, const Poly& q) {
  Closest c{v2(0.0f, 0.0f), v2(0.0f, 0.0f), 0.0f, false, 0};
  float best_d2 = 0.0f;
  bool all_in = true;
  for (int i = 0; i < kVerts; ++i) {
    bool valid = i < q.n && q.n >= 2;
    V2 vi = q.v[i];
    V2 e = q.v[next_vertex(i, q.n)] - vi;
    V2 rel = p - vi;
    float t = clamp01(dot2(rel, e) / fmaxf(dot2(e, e), 1e-12f));
    V2 proj = vi + e * t;
    V2 dp = p - proj;
    float d2 = valid ? dot2(dp, dp) : kBig;
    if (i == 0 || d2 < best_d2) {
      c.edge = i;
      best_d2 = d2;
      c.closest = proj;
    }
    V2 nrm = edge_normal(e);
    float fd = valid ? dot2(nrm, rel) : -kBig;
    if (i == 0 || fd > c.face_d) {
      c.face_d = fd;
      c.n_face = nrm;
    }
    all_in = all_in && (!valid || fd <= 0.0f);
  }
  c.inside = all_in && q.n >= 3;
  return c;
}

// Circle of centre p, radius ra against the rounded polygon q (reference
// _circle_poly :136).
__device__ __forceinline__ Manifold circle_poly(V2 p, float ra, const Poly& q) {
  Closest c = closest_on_poly(p, q);
  V2 d = c.closest - p;
  float dist = norm2(d);
  V2 n_out = unit_or(d, dist, -c.n_face);
  V2 n = c.inside ? -c.n_face : n_out;
  float sep = c.inside ? c.face_d - ra - q.r : dist - ra - q.r;
  V2 pb = c.inside ? p + n * (ra + sep) : c.closest - n * q.r;
  return one_point(n, p + n * ra, pb, sep, c.edge);
}

// Reference _sat_faces (:170): the face of r that separates i the most.
__device__ __forceinline__ float sat_faces(const Poly& r, const Poly& i, int& best, V2& normal) {
  float best_sep = 0.0f;
  best = 0;
  normal = v2(0.0f, 0.0f);
  for (int k = 0; k < kVerts; ++k) {
    bool valid = k < r.n && r.n >= 2;
    V2 nrm = edge_normal(r.v[next_vertex(k, r.n)] - r.v[k]);
    float m = kBig;
    for (int j = 0; j < kVerts; ++j) {
      V2 rel = i.v[j] - r.v[k];
      float d = j < i.n ? nrm.x * rel.x + nrm.y * rel.y : kBig;
      m = fminf(m, d);
    }
    float sep = valid ? m : -kBig;
    if (k == 0 || sep > best_sep) {
      best = k;
      best_sep = sep;
      normal = nrm;
    }
  }
  return best_sep;
}

__device__ __forceinline__ Manifold poly_poly(const Poly& a, const Poly& b) {
  int edge_a, edge_b;
  V2 n_a, n_b;
  float sep_a = sat_faces(a, b, edge_a, n_a);
  float sep_b = sat_faces(b, a, edge_b, n_b);
  bool flip = sep_b > sep_a + 1e-4f;
  const Poly& r = flip ? b : a;
  const Poly& in = flip ? a : b;
  int ref = flip ? edge_b : edge_a;
  V2 n = flip ? n_b : n_a;

  int inc = 0;
  float best_anti = 0.0f;
  for (int k = 0; k < kVerts; ++k) {
    bool valid = k < in.n && in.n >= 2;
    float anti = valid ? dot2(edge_normal(in.v[next_vertex(k, in.n)] - in.v[k]), n) : kBig;
    if (k == 0 || anti < best_anti) {
      inc = k;
      best_anti = anti;
    }
  }
  V2 i0 = in.v[inc];
  V2 i1 = in.n >= 2 ? in.v[next_vertex(inc, in.n)] : i0;
  V2 r0 = r.v[ref];
  V2 r1 = r.v[next_vertex(ref, r.n)];

  // Clip the incident edge to the reference edge's slab (_clip_segment :190).
  V2 rd = r1 - r0;
  float tl = fmaxf(norm2(rd), 1e-9f);
  V2 t = v2(rd.x / tl, rd.y / tl);
  float length = dot2(t, rd);
  float a0 = dot2(t, i0 - r0);
  float a1 = dot2(t, i1 - r0);
  float da = a1 - a0;
  bool degen = fabsf(da) <= 1e-9f;
  float safe = degen ? 1e-9f : da;
  float s_at0 = (0.0f - a0) / safe;
  float s_atl = (length - a0) / safe;
  float s_min = degen ? 0.0f : clamp01(fminf(s_at0, s_atl));
  float s_max = degen ? 1.0f : clamp01(fmaxf(s_at0, s_atl));
  V2 di = i1 - i0;
  V2 cp[2] = {i0 + di * s_min, i0 + di * s_max};

  Manifold m = empty_manifold();
  int fid = (flip ? 4096 : 0) + ref * 256 + inc * 16;
  for (int p = 0; p < 2; ++p) {
    float s_raw = dot2(n, cp[p] - r0);
    float s = s_raw - r.r - in.r;
    V2 p_ref = cp[p] - n * (s_raw - r.r);
    V2 p_inc = cp[p] - n * in.r;
    m.pa[p] = flip ? p_inc : p_ref;
    m.pb[p] = flip ? p_ref : p_inc;
    m.sep[p] = s;
    m.fid[p] = fid + p;
  }
  V2 dc = cp[1] - cp[0];
  bool dup = dot2(dc, dc) < 1e-10f;
  if (dup) m.sep[1] = kBig;
  m.count = dup ? 1 : 2;
  m.normal = flip ? -n : n;
  return m;
}

// Rounded polygon q on the half-space through plane_pos with outward normal
// plane_n (_poly_plane :285): its two deepest vertices, the first of equals
// first (a stable sort's order).
__device__ __forceinline__ Manifold poly_plane(const Poly& q, V2 plane_pos, V2 plane_n) {
  float d[kVerts];
  int k0 = 0;
  for (int i = 0; i < kVerts; ++i) {
    d[i] = i < q.n ? dot2(plane_n, q.v[i] - plane_pos) - q.r : kBig;
    if (d[i] < d[k0]) k0 = i;
  }
  int k1 = k0 == 0 ? 1 : 0;
  for (int i = 0; i < kVerts; ++i)
    if (i != k0 && d[i] < d[k1]) k1 = i;
  V2 n_ab = -plane_n;
  Manifold m = empty_manifold();
  m.normal = n_ab;
  int ks[2] = {k0, k1};
  for (int p = 0; p < 2; ++p) {
    V2 vk = q.v[ks[p]];
    m.pa[p] = vk + n_ab * q.r;
    m.pb[p] = vk - plane_n * dot2(plane_n, vk - plane_pos);
    m.fid[p] = ks[p];
  }
  bool two = q.n >= 2 && d[k1] < kBig / 2.0f;
  m.sep[0] = d[k0];
  m.sep[1] = two ? d[k1] : kBig;
  m.count = two ? 2 : 1;
  return m;
}

// One pair at the given world poses (positions, cosines and sines of the
// world angles): the branch of its kind only (the reference selects among
// all).
__device__ __forceinline__ Manifold pair_manifold_at(V2 pa, float c_a, float s_a,
                                                     const float* la, int na, float ra, bool pla,
                                                     V2 pb, float c_b, float s_b,
                                                     const float* lb, int nb, float rb,
                                                     bool plb) {
  Poly a, b;
  load_poly(a, pa, c_a, s_a, la, na, ra);
  load_poly(b, pb, c_b, s_b, lb, nb, rb);
  if (pla && plb) return empty_manifold();
  if (plb) return poly_plane(a, pb, rot2(c_b, s_b, load2(lb)));
  if (pla) return flip_manifold(poly_plane(b, pa, rot2(c_a, s_a, load2(la))));
  bool circ_a = a.n == 1, circ_b = b.n == 1;
  if (circ_a && circ_b) return circle_circle(a.v[0], a.r, b.v[0], b.r);
  if (circ_a) return circle_poly(a.v[0], a.r, b);
  if (circ_b) return flip_manifold(circle_poly(b.v[0], b.r, a));
  return poly_poly(a, b);
}

// One pair of colliders at their poses in the tables.
__device__ __forceinline__ Manifold pair_manifold(int ca, int cb, const float* pos,
                                                  const float* cs, const float* verts,
                                                  const int* count, const float* radius,
                                                  const unsigned char* plane) {
  return pair_manifold_at(load2(pos + 2 * ca), cs[2 * ca], cs[2 * ca + 1],
                          verts + 2 * kVerts * (long)ca, count[ca], radius[ca], plane[ca] != 0,
                          load2(pos + 2 * cb), cs[2 * cb], cs[2 * cb + 1],
                          verts + 2 * kVerts * (long)cb, count[cb], radius[cb], plane[cb] != 0);
}

__device__ __forceinline__ void manifold_2d_pair(int k, const long long* ca, const long long* cb,
                                                 const float* pos, const float* cs,
                                                 const float* verts, const int* count,
                                                 const float* radius, const unsigned char* plane,
                                                 float* normal, float* point_a, float* point_b,
                                                 float* separation, int* feature_id,
                                                 int* n_points) {
  Manifold m = pair_manifold((int)ca[k], (int)cb[k], pos, cs, verts, count, radius, plane);
  store2(normal + 2 * (long)k, m.normal);
  for (int p = 0; p < 2; ++p) {
    store2(point_a + 4 * (long)k + 2 * p, m.pa[p]);
    store2(point_b + 4 * (long)k + 2 * p, m.pb[p]);
    separation[2 * (long)k + p] = m.sep[p];
    feature_id[2 * (long)k + p] = m.fid[p];
  }
  n_points[k] = m.count;
}

// ---------------------------------------------------------------------------
// Kernel U: one grid entry's window sweep (dim2/broadphase_impl.py:82-113).
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cell_key2(int x, int y) {
  return ((x & 0x7FFF) << 15) | (y & 0x7FFF);
}

// Candidate bits of entry t and its rank in its cell run, capped at w + 1.
__device__ __forceinline__ unsigned int sweep_entry(int t, int n, int w, const int* skey,
                                                    const float* sf, const int* si, int& rank) {
  int key = skey[t];
  int r = 0;
  while (r <= w && t - r - 1 >= 0 && skey[t - r - 1] == key) ++r;
  rank = r;
  unsigned int mask = 0u;
  if (key == kSentinel) return mask;
  const float* af = sf + 4 * (long)t;
  const int* ai = si + 6 * (long)t;
  for (int k = 1; k <= w; ++k) {
    int j = t + k;
    if (j >= n || skey[j] != key) break;
    const float* bf = sf + 4 * (long)j;
    const int* bi = si + 6 * (long)j;
    bool overlap = bf[0] <= af[2] && af[0] <= bf[2] && bf[1] <= af[3] && af[1] <= bf[3];
    int canon = cell_key2(ai[0] > bi[0] ? ai[0] : bi[0], ai[1] > bi[1] ? ai[1] : bi[1]);
    bool ok = overlap && canon == key && ai[2] != bi[2] && (ai[3] & bi[4]) != 0 &&
              (bi[3] & ai[4]) != 0 && (ai[5] | bi[5]) > 0;
    if (ok) mask |= 1u << (k - 1);
  }
  return mask;
}

// The global pass's test of candidate (global g_idx[g], collider i).
__device__ __forceinline__ bool global_candidate(int gi, int i, bool g_valid,
                                                 const float* aabb_min, const float* aabb_max,
                                                 const unsigned char* active,
                                                 const unsigned char* is_global,
                                                 const unsigned char* dyn, const int* body,
                                                 const int* members, const int* filt) {
  bool overlap = aabb_min[2 * gi] <= aabb_max[2 * i] && aabb_min[2 * i] <= aabb_max[2 * gi] &&
                 aabb_min[2 * gi + 1] <= aabb_max[2 * i + 1] &&
                 aabb_min[2 * i + 1] <= aabb_max[2 * gi + 1];
  return g_valid && active[i] && gi != i && (!is_global[i] || i < gi) && overlap &&
         body[gi] != body[i] && (members[gi] & filt[i]) != 0 && (members[i] & filt[gi]) != 0 &&
         (dyn[gi] || dyn[i]);
}

// ---------------------------------------------------------------------------
// Kernel W: one contact row (dim2/contacts.py:18 after the manifolds).
// ---------------------------------------------------------------------------

struct RowsIn2 {
  const unsigned char* valid;
  const int *ca, *cb;
  const float *m_pa, *m_pb, *m_sep;
  const int *m_fid, *m_count;
  const int* col_body;
  const float *col_spec, *col_margin, *col_fric, *col_sfric, *col_rest;
  const int *col_fcomb, *col_rcomb;
  const unsigned char* col_sensor;
  const float *b_pos, *b_cs, *b_com, *b_lin_vel;
  const int* hit;
  const unsigned char* survives;
  const int* new_rank;
  const unsigned char *o_active, *o_touching;
  const int *o_color, *o_cid, *o_next_cid, *o_fid;
  const float *o_anchor_a, *o_nimp, *o_timp;
  const int *o_npoints, *o_body_a, *o_body_b;
};

struct RowsOut2 {
  int *body_a, *body_b;
  unsigned char *touching, *was_touching, *is_sensor;
  int* num_points;
  float *anchor_a, *anchor_b, *penetration;
  int* feature_id;
  float *nimp, *timp, *friction, *sfriction, *restitution;
  int *color, *contact_id;
  unsigned char* evicted;
  int *ev_cid, *ev_ba, *ev_bb;
};

struct RowParams2 {
  float dt, spec_default, tol, dist_thresh;
  int match_contacts;
};

__device__ __forceinline__ V2 clamped_vel2(const RowsIn2& in, int body, int collider,
                                           const RowParams2& p) {
  V2 v = load2(in.b_lin_vel + 2 * body);
  float spec = fminf(in.col_spec[collider], p.spec_default);
  float scale = fminf(spec / fmaxf(norm2(v) * p.dt, 1e-9f), 1.0f);
  return v * scale;
}

__device__ __forceinline__ V2 body_com(const RowsIn2& in, int body) {
  return load2(in.b_pos + 2 * body) +
         rot2(in.b_cs[2 * body], in.b_cs[2 * body + 1], load2(in.b_com + 2 * body));
}

__device__ __forceinline__ void contact_row_2d(int c, const RowsIn2& in, const RowParams2& p,
                                               const RowsOut2& out) {
  bool valid = in.valid[c] != 0;
  int ca = in.ca[c], cb = in.cb[c];
  int ba = in.col_body[ca], bb = in.col_body[cb];
  float margin = p.dt * norm2(clamped_vel2(in, bb, cb, p) - clamped_vel2(in, ba, ca, p));
  float keep = fmaxf(margin, p.tol) + in.col_margin[ca] + in.col_margin[cb];

  int count = in.m_count[c];
  bool pv[2];
  int order[2], np = 0;
  for (int l = 0; l < 2; ++l) {
    pv[l] = valid && l < count && in.m_sep[2 * c + l] < keep;
    if (pv[l]) order[np++] = l;
  }
  int tail = np;
  for (int l = 0; l < 2; ++l)
    if (!pv[l]) order[tail++] = l;

  V2 com_a = body_com(in, ba), com_b = body_com(in, bb);
  int h = in.hit[c];
  bool matched = h > 0;
  int os = matched ? h - 1 : 0;
  int o_np = in.o_npoints[os];
  for (int i = 0; i < 2; ++i) {
    int l = order[i];
    int fid = in.m_fid[2 * c + l];
    V2 aa = load2(in.m_pa + 2 * (2 * c + l)) - com_a;
    V2 ab = load2(in.m_pb + 2 * (2 * c + l)) - com_b;
    store2(out.anchor_a + 2 * (2 * c + i), aa);
    store2(out.anchor_b + 2 * (2 * c + i), ab);
    out.penetration[2 * c + i] = -in.m_sep[2 * c + l];
    out.feature_id[2 * c + i] = fid;

    // Warm start: the old point with the same feature id; if none has it,
    // the nearest within the match distance; the first among equals.
    float d2[2];
    bool fid_m[2], dist_m[2], any_fid = false;
    for (int j = 0; j < 2; ++j) {
      bool o_valid = matched && j < o_np;
      V2 dd = aa - load2(in.o_anchor_a + 2 * (2 * os + j));
      d2[j] = dd.x * dd.x + dd.y * dd.y;
      fid_m[j] = o_valid && fid == in.o_fid[2 * os + j];
      dist_m[j] = o_valid && d2[j] < p.dist_thresh;
      any_fid = any_fid || fid_m[j];
    }
    int best = -1;
    for (int j = 0; j < 2; ++j) {
      bool use = any_fid ? fid_m[j] : dist_m[j];
      if (use && (best < 0 || d2[j] < d2[best])) best = j;
    }
    bool has = best >= 0 && p.match_contacts != 0;
    int src = 2 * os + (best < 0 ? 0 : best);
    out.nimp[2 * c + i] = has ? in.o_nimp[src] : 0.0f;
    out.timp[2 * c + i] = has ? in.o_timp[src] : 0.0f;
  }

  out.body_a[c] = ba;
  out.body_b[c] = bb;
  out.num_points[c] = np;
  out.touching[c] = (np > 0 && valid) ? 1 : 0;
  out.was_touching[c] = (matched && in.o_touching[os] != 0) ? 1 : 0;
  out.is_sensor[c] = (in.col_sensor[ca] != 0 || in.col_sensor[cb] != 0) ? 1 : 0;
  out.color[c] = matched ? in.o_color[os] : -1;
  out.contact_id[c] =
      matched ? in.o_cid[os] : (valid ? in.o_next_cid[0] + in.new_rank[c] : 0);
  out.friction[c] = combine(in.col_fric[ca], in.col_fric[cb], in.col_fcomb[ca], in.col_fcomb[cb]);
  out.sfriction[c] =
      combine(in.col_sfric[ca], in.col_sfric[cb], in.col_fcomb[ca], in.col_fcomb[cb]);
  out.restitution[c] =
      combine(in.col_rest[ca], in.col_rest[cb], in.col_rcomb[ca], in.col_rcomb[cb]);
  bool ev = in.o_active[c] != 0 && in.o_touching[c] != 0 && in.survives[c] == 0;
  out.evicted[c] = ev ? 1 : 0;
  out.ev_cid[c] = ev ? in.o_cid[c] : 0;
  out.ev_ba[c] = ev ? in.o_body_a[c] : 0;
  out.ev_bb[c] = ev ? in.o_body_b[c] : 0;
}

// ---------------------------------------------------------------------------
// Packed row layout of Kernels X and Y (dim2/solver.py:25-42).
// ---------------------------------------------------------------------------

enum {
  N_ = 0, FRICTION = 2, SF = 3, REST = 4, SOFT = 5, IMA = 8, IMB = 10, IIA = 12, IIB = 13,
  AA = 14, AB = 18, SEP = 22, NM = 24, TM = 26, NS = 28, PM = 30, SV = 32, D = 33, IMP = 6,
  STATE = 6
};

// ---------------------------------------------------------------------------
// Kernel X: one bucket slot's packed row (dim2/solver.py:87).
// ---------------------------------------------------------------------------

struct PackIn2 {
  const long long* buckets;
  const unsigned char* bucket_valid;
  const int *body_a, *body_b;
  const unsigned char *dyn_a, *dyn_b, *solve;
  const float *normal, *anchor_a, *anchor_b, *penetration;
  const int* num_points;
  const float *friction, *sfriction, *restitution, *surface_speed, *nimp, *timp;
  const int* body_type;
  const unsigned char* sleeping;
  const int* dominance;
  const float *state, *inv_mass, *inv_inertia;
  const int* cnt;
};

struct PackOut2 {
  float* data;
  float* imp;
  int *bucket_a, *bucket_b;
  float* relax;
};

__device__ __forceinline__ int eff_dominance(const PackIn2& in, int b) {
  return (in.body_type[b] == 1 && !in.sleeping[b]) ? in.dominance[b] : 127;
}

__device__ __forceinline__ void pack_slot_2d(int color, int row, int colors, int cap,
                                             const PackIn2& in, const float* dyn_soft,
                                             const float* non_dyn_soft, const PackOut2& out) {
  long g = (long)color * cap + row;
  int c = (int)in.buckets[g];
  bool valid = in.bucket_valid[g] != 0;
  int ba = in.body_a[c], bb = in.body_b[c];
  int rel = eff_dominance(in, ba) - eff_dominance(in, bb);
  bool a_static = rel > 0, b_static = rel < 0;
  V2 ima = a_static ? v2(0.0f, 0.0f) : load2(in.inv_mass + 2 * ba);
  V2 imb = b_static ? v2(0.0f, 0.0f) : load2(in.inv_mass + 2 * bb);
  float iia = a_static ? 0.0f : in.inv_inertia[ba];
  float iib = b_static ? 0.0f : in.inv_inertia[bb];
  const float* soft = rel != 0 ? non_dyn_soft : dyn_soft;

  V2 n = load2(in.normal + 2 * c);
  V2 t = v2(n.y, -n.x);
  float sx = ima.x + imb.x, sy = ima.y + imb.y;
  float* d = out.data + g * D;
  d[N_] = n.x;
  d[N_ + 1] = n.y;
  d[FRICTION] = in.friction[c];
  d[SF] = in.sfriction[c];
  d[REST] = in.restitution[c];
  for (int k = 0; k < 3; ++k) d[SOFT + k] = soft[k];
  d[IMA] = ima.x;
  d[IMA + 1] = ima.y;
  d[IMB] = imb.x;
  d[IMB + 1] = imb.y;
  d[IIA] = iia;
  d[IIB] = iib;
  const float* sa = in.state + STATE * (long)ba;
  const float* sb = in.state + STATE * (long)bb;
  bool solve = in.solve[c] != 0;
  for (int p = 0; p < 2; ++p) {
    V2 r1 = load2(in.anchor_a + 4 * (long)c + 2 * p);
    V2 r2 = load2(in.anchor_b + 4 * (long)c + 2 * p);
    store2(d + AA + 2 * p, r1);
    store2(d + AB + 2 * p, r2);
    float r1xn = r1.x * n.y - r1.y * n.x, r2xn = r2.x * n.y - r2.y * n.x;
    float kn = (n.x * (sx * n.x) + n.y * (sy * n.y)) + iia * r1xn * r1xn + iib * r2xn * r2xn;
    float r1xt = r1.x * t.y - r1.y * t.x, r2xt = r2.x * t.y - r2.y * t.x;
    float kt = (t.x * (sx * t.x) + t.y * (sy * t.y)) + iia * r1xt * r1xt + iib * r2xt * r2xt;
    d[NM + p] = kn > 1e-12f ? 1.0f / kn : 0.0f;
    d[TM + p] = kt > 1e-12f ? 1.0f / kt : 0.0f;
    V2 dr = r2 - r1;
    d[SEP + p] = -in.penetration[2 * c + p] - (dr.x * n.x + dr.y * n.y);
    float vbx = sb[0] + sb[2] * -r2.y, vby = sb[1] + sb[2] * r2.x;
    float vax = sa[0] + sa[2] * -r1.y, vay = sa[1] + sa[2] * r1.x;
    d[NS + p] = (vbx - vax) * n.x + (vby - vay) * n.y;
    d[PM + p] = (valid && solve && p < in.num_points[c]) ? 1.0f : 0.0f;
  }
  d[SV] = in.surface_speed[c];

  float* ir = out.imp + g * IMP;
  ir[0] = in.nimp[2 * c];
  ir[1] = in.nimp[2 * c + 1];
  ir[2] = in.timp[2 * c];
  ir[3] = in.timp[2 * c + 1];
  ir[4] = 0.0f;
  ir[5] = 0.0f;
  out.bucket_a[g] = ba;
  out.bucket_b[g] = bb;
  float rlx = 1.0f;
  if (color == colors - 1) {
    // 1 / the larger multiplicity of the row's dynamic ends in the last colour.
    float ma = (valid && in.dyn_a[c]) ? (float)in.cnt[ba] : 1.0f;
    float mb = (valid && in.dyn_b[c]) ? (float)in.cnt[bb] : 1.0f;
    rlx = 1.0f / fmaxf(fmaxf(ma, mb), 1.0f);
  }
  out.relax[g] = rlx;
}

// ---------------------------------------------------------------------------
// Kernel Y: one row of one colour (dim2/solver.py:275-548).
// ---------------------------------------------------------------------------

enum { kWarm = 0, kBias = 1, kRelax = 2, kRestitution = 3 };

struct SolveParams2 {
  float h, max_overlap, stiction_t2, warm_coeff, rest_threshold;
};

struct Deltas2 {
  float vax, vay, wa, vbx, vby, wb;
};

__device__ __forceinline__ void apply2(Deltas2& dl, const float* d, float applied, float ux,
                                       float uy, int i) {
  float pvx = applied * ux, pvy = applied * uy;
  float r1x = d[AA + 2 * i], r1y = d[AA + 2 * i + 1];
  float r2x = d[AB + 2 * i], r2y = d[AB + 2 * i + 1];
  dl.vax = dl.vax - pvx * d[IMA];
  dl.vay = dl.vay - pvy * d[IMA + 1];
  dl.wa = dl.wa - d[IIA] * (r1x * pvy - r1y * pvx);
  dl.vbx = dl.vbx + pvx * d[IMB];
  dl.vby = dl.vby + pvy * d[IMB + 1];
  dl.wb = dl.wb + d[IIB] * (r2x * pvy - r2y * pvx);
}

__device__ __forceinline__ void rel_vel2(const Deltas2& dl, const float* sa, const float* sb,
                                         const float* d, int i, float& rvx, float& rvy) {
  float r1x = d[AA + 2 * i], r1y = d[AA + 2 * i + 1];
  float r2x = d[AB + 2 * i], r2y = d[AB + 2 * i + 1];
  float wbt = sb[2] + dl.wb, wat = sa[2] + dl.wa;
  rvx = ((sb[0] + dl.vbx) + wbt * -r2y) - ((sa[0] + dl.vax) + wat * -r1y);
  rvy = ((sb[1] + dl.vby) + wbt * r2x) - ((sa[1] + dl.vay) + wat * r1x);
}

// Deltas of one row into dl and its new impulses into out[6]. In the bias and
// relax modes the cosine and sine of the delta angles are cosf/sinf here and
// torch.cos/torch.sin in the plain version.
__device__ __forceinline__ void solve_row_2d(int mode, const float* d, const float* ir,
                                             const float* sa, const float* sb, float rlx,
                                             const SolveParams2& p, Deltas2& dl, float* out) {
  float nx = d[N_], ny = d[N_ + 1];
  float tx = ny, ty = -nx;
  float pm[2] = {d[PM], d[PM + 1]};
  for (int k = 0; k < IMP; ++k) out[k] = ir[k];
  dl = Deltas2{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  if (mode == kWarm) {
    float px = 0.0f, py = 0.0f, cra = 0.0f, crb = 0.0f;
    for (int i = 0; i < 2; ++i) {
      float np = ir[i] * pm[i];
      float tp = ir[2 + i] * pm[i];
      float pxi = (np * nx + tp * tx) * p.warm_coeff;
      float pyi = (np * ny + tp * ty) * p.warm_coeff;
      float ca = d[AA + 2 * i] * pyi - d[AA + 2 * i + 1] * pxi;
      float cb = d[AB + 2 * i] * pyi - d[AB + 2 * i + 1] * pxi;
      if (i == 0) {
        px = pxi;
        py = pyi;
        cra = ca;
        crb = cb;
      } else {
        px = px + pxi;
        py = py + pyi;
        cra = cra + ca;
        crb = crb + cb;
      }
    }
    dl.vax = -px * d[IMA];
    dl.vay = -py * d[IMA + 1];
    dl.wa = -(d[IIA] * cra);
    dl.vbx = px * d[IMB];
    dl.vby = py * d[IMB + 1];
    dl.wb = d[IIB] * crb;
    return;
  }

  if (mode == kRestitution) {
    float rest = d[REST];
    float vmask = rest > 0.0f ? 1.0f : 0.0f;
    for (int i = 0; i < 2; ++i) {
      float ns = d[NS + i];
      float active = (ns < -p.rest_threshold && ir[4 + i] > 0.0f) ? 1.0f : 0.0f;
      float pmi = pm[i] * vmask * active;
      float rvx, rvy;
      rel_vel2(dl, sa, sb, d, i, rvx, rvy);
      float vn = rvx * nx + rvy * ny;
      float delta = -d[NM + i] * (vn + rest * ns);
      float acc = ir[i];
      float new_acc = fmaxf(acc + rlx * delta, 0.0f);
      float applied = (new_acc - acc) * pmi;
      out[i] = pmi > 0.0f ? new_acc : acc;
      out[4 + i] = ir[4 + i] + applied;
      apply2(dl, d, applied, nx, ny, i);
    }
    return;
  }

  bool use_bias = mode == kBias;
  float ca = cosf(sa[5]), s_a = sinf(sa[5]);
  float cb = cosf(sb[5]), s_b = sinf(sb[5]);
  float dtx = sb[3] - sa[3], dty = sb[4] - sa[4];
  float soft_bias = d[SOFT], soft_mass = d[SOFT + 1], soft_imp = d[SOFT + 2];
  for (int i = 0; i < 2; ++i) {
    float r1x = d[AA + 2 * i], r1y = d[AA + 2 * i + 1];
    float r2x = d[AB + 2 * i], r2y = d[AB + 2 * i + 1];
    float dsx = dtx + ((cb * r2x - s_b * r2y) - (ca * r1x - s_a * r1y));
    float dsy = dty + ((s_b * r2x + cb * r2y) - (s_a * r1x + ca * r1y));
    float sep = (dsx * nx + dsy * ny) + d[SEP + i];
    float rvx, rvy;
    rel_vel2(dl, sa, sb, d, i, rvx, rvy);
    float vn = rvx * nx + rvy * ny;
    float m_eff = d[NM + i];
    float acc = ir[i];
    float spec = -m_eff * (vn + sep / p.h);
    float inner;
    if (use_bias) {
      float sbias = fmaxf(soft_bias * sep, -p.max_overlap);
      inner = -m_eff * soft_mass * (vn + sbias) - soft_imp * acc;
    } else {
      inner = -m_eff * vn;
    }
    float delta = sep > 0.0f ? spec : inner;
    float new_acc = fmaxf(acc + rlx * delta, 0.0f);
    float applied = (new_acc - acc) * pm[i];
    bool on = pm[i] > 0.0f;
    out[i] = on ? new_acc : acc;
    out[4 + i] = ir[4 + i] + (on ? new_acc : 0.0f);
    apply2(dl, d, applied, nx, ny, i);
  }
  float sv = d[SV];
  for (int i = 0; i < 2; ++i) {
    float rvx, rvy;
    rel_vel2(dl, sa, sb, d, i, rvx, rvy);
    float vt = (rvx * tx + rvy * ty) + sv;
    float delta = d[TM + i] * vt;
    float acc = ir[2 + i];
    float mu = vt * vt <= p.stiction_t2 ? d[SF] : d[FRICTION];
    float limit = mu * out[i];
    float new_acc = fminf(fmaxf(acc - rlx * delta, -limit), limit);
    float applied = (new_acc - acc) * pm[i];
    out[2 + i] = pm[i] > 0.0f ? new_acc : acc;
    apply2(dl, d, applied, tx, ty, i);
  }
}

// Whether an end with these inverse masses and inertia receives deltas.
__device__ __forceinline__ bool writes2(const float* im, float ii) {
  return im[0] != 0.0f || im[1] != 0.0f || ii != 0.0f;
}

// ---------------------------------------------------------------------------
// Kernel Z: one body's substep integration (dim2/dynamics.py:141-174).
// ---------------------------------------------------------------------------

enum { T_LIN_INC = 0, T_ANG_INC = 2, T_LIN_DAMP = 3, T_ANG_DAMP = 4, T_DYN = 5, T_MAX_LIN = 6,
       T_MAX_ANG = 7, T_COLS = 8 };

__device__ __forceinline__ void integrate_body_2d(int mode, const float* s, const float* t,
                                                  float h, float* o) {
  for (int k = 0; k < STATE; ++k) o[k] = s[k];
  if (mode == 1) {
    o[3] = s[3] + s[0] * h;
    o[4] = s[4] + s[1] * h;
    o[5] = s[5] + s[2] * h;
    return;
  }
  bool dyn = t[T_DYN] > 0.0f;
  float lx = dyn ? s[0] * t[T_LIN_DAMP] + t[T_LIN_INC] : s[0];
  float ly = dyn ? s[1] * t[T_LIN_DAMP] + t[T_LIN_INC + 1] : s[1];
  float w = dyn ? s[2] * t[T_ANG_DAMP] + t[T_ANG_INC] : s[2];
  float speed = sqrtf(lx * lx + ly * ly);
  float scale = fminf(t[T_MAX_LIN] / fmaxf(speed, 1e-9f), 1.0f);
  o[0] = lx * scale;
  o[1] = ly * scale;
  float max_ang = t[T_MAX_ANG];
  o[2] = fminf(fmaxf(w, -max_ang), max_ang);
}

// Kernel Z's prologue: one body's solver row and table (dim2/dynamics.py
// prepare :46 and pre_process_velocity_increments :111).
struct BodyIn2 {
  int type, locks;
  bool active, sleeping;
  V2 lin_vel, force, const_force, gravity;
  float ang_vel, torque, const_torque, inv_mass, inv_inertia, gravity_scale, lin_damping,
      ang_damping, max_lin, max_ang;
};

constexpr int kStatic = 0, kDynamic = 1;
constexpr int kLockTX = 1, kLockTY = 2, kLockRot = 4;

__device__ __forceinline__ void prepare_body_2d(const BodyIn2& b, float h, float* state,
                                                float* inv_mass, float* inv_inertia,
                                                float* solve_mask, float* t) {
  bool dynamic = b.type == kDynamic;
  bool moving = b.active && !b.sleeping && b.type != kStatic;
  bool responds = dynamic && moving;
  float tx = (b.locks & kLockTX) > 0 ? 0.0f : 1.0f;
  float ty = (b.locks & kLockTY) > 0 ? 0.0f : 1.0f;
  float rm = (b.locks & kLockRot) > 0 ? 0.0f : 1.0f;
  state[0] = moving ? b.lin_vel.x : 0.0f;
  state[1] = moving ? b.lin_vel.y : 0.0f;
  state[2] = moving ? b.ang_vel : 0.0f;
  state[3] = 0.0f;
  state[4] = 0.0f;
  state[5] = 0.0f;
  inv_mass[0] = responds ? b.inv_mass * tx : 0.0f;
  inv_mass[1] = responds ? b.inv_mass * ty : 0.0f;
  *inv_inertia = responds ? b.inv_inertia * rm : 0.0f;
  *solve_mask = responds ? 1.0f : 0.0f;
  bool d1 = dynamic && b.active;
  float ax = b.gravity.x * b.gravity_scale + (b.force.x + b.const_force.x) * b.inv_mass;
  float ay = b.gravity.y * b.gravity_scale + (b.force.y + b.const_force.y) * b.inv_mass;
  float aw = (b.torque + b.const_torque) * b.inv_inertia;
  t[T_LIN_INC] = d1 ? ax * tx * h : 0.0f;
  t[T_LIN_INC + 1] = d1 ? ay * ty * h : 0.0f;
  t[T_ANG_INC] = d1 ? aw * rm * h : 0.0f;
  t[T_LIN_DAMP] = 1.0f / (1.0f + h * b.lin_damping);
  t[T_ANG_DAMP] = 1.0f / (1.0f + h * b.ang_damping);
  t[T_DYN] = (d1 && !b.sleeping) ? 1.0f : 0.0f;
  t[T_MAX_LIN] = b.max_lin;
  t[T_MAX_ANG] = b.max_ang;
}

// ---------------------------------------------------------------------------
// Kernel K in 2D: one body's writeback (dim2/dynamics.py:80): the delta pose
// applied about the centre of mass. Returns whether the body moved.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool writeback_body_2d(int type, bool active, bool sleeping,
                                                  const float* s, V2 pos, float angle, V2 com,
                                                  V2* pos_out, float* angle_out) {
  bool moving = active && !sleeping && type != kStatic;
  V2 old_com = rot2(cosf(angle), sinf(angle), com);
  float new_angle = angle + s[5];
  V2 new_com = rot2(cosf(new_angle), sinf(new_angle), com);
  V2 np = ((pos + load2(s + 3)) + old_com) - new_com;
  *pos_out = moving ? np : pos;
  *angle_out = moving ? new_angle : angle;
  return moving;
}


// ---------------------------------------------------------------------------
// Kernel AA: the 2D XPBD joints (dim2/xpbd.py): one joint's packed row
// (prepare_joints :71), its increments in one colour (_solve_color :197) and
// its damping (_joint_damping :313). Row layout of kernels/solve_joints_2d.py.
// ---------------------------------------------------------------------------

enum {
  J_R1 = 0, J_R2 = 2, J_CD = 4, J_BASE = 6, J_AXIS = 7, J_COMP = 9, J_LMIN = 13, J_LMAX = 14,
  J_LEN = 15, J_LDAMP = 16, J_ADAMP = 17, J_IMA = 18, J_IMB = 19, J_IMVA = 20, J_IMVB = 22,
  J_IIA = 24, J_IIB = 25, JD = 26, J_LAM = 3
};
enum { kFixed = 0, kDistance = 1, kRevolute = 2, kPrismatic = 3 };

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

struct JointIn2 {
  const int *body_a, *body_b;
  const unsigned char* active;
  const float *anchor_a, *anchor_b, *axis_cs, *reference_angle, *compliance, *limit_min,
      *limit_max;
  const unsigned char* limit_enabled;
  const float *lin_damping, *ang_damping;
  const float *pos, *angle, *com, *body_cs, *inv_mass, *inv_inertia, *solve_mask;
};

// One joint's row, whether it is solved and which ends respond. The cosines
// and sines of the body angles and of the joint's axis angle come in.
__device__ __forceinline__ void joint_row_2d(int j, const JointIn2& in, float* d,
                                             unsigned char* mask, unsigned char* dyn_a,
                                             unsigned char* dyn_b) {
  int a = in.body_a[j], b = in.body_b[j];
  bool da = in.solve_mask[a] > 0.0f, db = in.solve_mask[b] > 0.0f;
  *dyn_a = da;
  *dyn_b = db;
  *mask = in.active[j] != 0 && (da || db);
  float ca = in.body_cs[2 * a], sa = in.body_cs[2 * a + 1];
  float cb = in.body_cs[2 * b], sb = in.body_cs[2 * b + 1];
  V2 com_a = load2(in.com + 2 * a), com_b = load2(in.com + 2 * b);
  V2 wcom_a = rot2(ca, sa, com_a), wcom_b = rot2(cb, sb, com_b);
  store2(d + J_R1, rot2(ca, sa, load2(in.anchor_a + 2 * j) - com_a));
  store2(d + J_R2, rot2(cb, sb, load2(in.anchor_b + 2 * j) - com_b));
  store2(d + J_CD, (load2(in.pos + 2 * b) - load2(in.pos + 2 * a)) + (wcom_b - wcom_a));
  d[J_BASE] = (in.angle[b] - in.angle[a]) - in.reference_angle[j];
  store2(d + J_AXIS, rot2(ca, sa, load2(in.axis_cs + 2 * j)));
  for (int k = 0; k < 4; ++k) d[J_COMP + k] = in.compliance[4 * j + k];
  d[J_LMIN] = in.limit_min[j];
  d[J_LMAX] = in.limit_max[j];
  d[J_LEN] = in.limit_enabled[j] ? 1.0f : 0.0f;
  d[J_LDAMP] = in.lin_damping[j];
  d[J_ADAMP] = in.ang_damping[j];
  V2 ima = load2(in.inv_mass + 2 * a), imb = load2(in.inv_mass + 2 * b);
  d[J_IMA] = fmaxf(ima.x, ima.y);
  d[J_IMB] = fmaxf(imb.x, imb.y);
  store2(d + J_IMVA, ima);
  store2(d + J_IMVB, imb);
  d[J_IIA] = in.inv_inertia[a];
  d[J_IIB] = in.inv_inertia[b];
}

// _angular_correction (:129): cancel the scalar angle error c_err.
__device__ __forceinline__ void angular_2d(const float* d, float c_err, float compliance,
                                           float hh, bool on, float& da, float& db, float& dl) {
  float iia = d[J_IIA], iib = d[J_IIB];
  float w_sum = iia + iib;
  float tilde = compliance / hh;
  dl = (on && w_sum > 1e-12f) ? -c_err / clamp_lo(w_sum + tilde, 1e-12f) : 0.0f;
  da = -iia * dl;
  db = iib * dl;
}

struct JointInc2 {
  V2 dp_a, dp_b;
  float th_a, th_b;
  V2 tot_pos;
  float tot_rot;
};

// One solved joint of the colour: its increments from the delta poses of
// its ends and its Lagrange totals (lam, 3 floats). The cosines and sines of
// the delta angles and the revolute limit's atan2 are cosf/sinf/atan2f here
// and torch.cos/sin/atan2 in the plain version.
__device__ __forceinline__ JointInc2 joint_increments_2d(const float* d, int t, V2 dp_a,
                                                         V2 dp_b, float th_a0, float th_b0,
                                                         const float* lam, float hh) {
  bool is_distance = t == kDistance, is_revolute = t == kRevolute;
  bool is_prismatic = t == kPrismatic;
  V2 acc_dp_a = v2(0.0f, 0.0f), acc_dp_b = v2(0.0f, 0.0f);
  float acc_th_a = 0.0f, acc_th_b = 0.0f;
  V2 tot_pos = load2(lam);
  float tot_rot = lam[2];
  float lmin = d[J_LMIN], lmax = d[J_LMAX];
  bool len = d[J_LEN] > 0.0f;
  float da, db, dl;

  // 1. Angle alignment (fixed, prismatic).
  bool align = t == kFixed || is_prismatic;
  float cur = (d[J_BASE] + (th_b0 + acc_th_b)) - (th_a0 + acc_th_a);
  angular_2d(d, cur, d[J_COMP + 1], hh, align, da, db, dl);
  acc_th_a = acc_th_a + (align ? da : 0.0f);
  acc_th_b = acc_th_b + (align ? db : 0.0f);
  tot_rot = tot_rot + (align ? dl : 0.0f);

  // Revolute angle limit, only where violated.
  cur = (d[J_BASE] + (th_b0 + acc_th_b)) - (th_a0 + acc_th_a);
  bool lim = false;
  float err = 0.0f;
  if (is_revolute && len) {
    float wrapped = atan2f(sinf(cur), cosf(cur));
    lim = wrapped < lmin || wrapped > lmax;
    err = wrapped - fminf(fmaxf(wrapped, lmin), lmax);
  }
  angular_2d(d, err, d[J_COMP + 2], hh, lim, da, db, dl);
  acc_th_a = acc_th_a + (lim ? da : 0.0f);
  acc_th_b = acc_th_b + (lim ? db : 0.0f);
  tot_rot = tot_rot + (lim ? dl : 0.0f);

  // 2. Positional constraint.
  float ang_a = th_a0 + acc_th_a, ang_b = th_b0 + acc_th_b;
  float ca = cosf(ang_a), sa = sinf(ang_a), cb = cosf(ang_b), sb = sinf(ang_b);
  V2 r1 = rot2(ca, sa, load2(d + J_R1)), r2 = rot2(cb, sb, load2(d + J_R2));
  V2 sep = (((dp_b + acc_dp_b) - (dp_a + acc_dp_a)) + (r2 - r1)) + load2(d + J_CD);
  float dist = sqrtf(sep.x * sep.x + sep.y * sep.y);
  float dm = clamp_lo(dist, 1e-9f);
  V2 dir = v2(sep.x / dm, sep.y / dm);
  V2 dist_corr = dist < lmin ? (-dir) * (lmin - dist)
                             : (dist > lmax ? dir * (dist - lmax) : v2(0.0f, 0.0f));
  V2 axis = rot2(ca, sa, load2(d + J_AXIS));
  float along = sep.x * axis.x + sep.y * axis.y;
  V2 perp = sep - axis * along;
  float along_corr = (len && along < lmin) ? along - lmin
                                           : ((len && along > lmax) ? along - lmax : 0.0f);
  V2 pris = perp + axis * along_corr;
  V2 corr = is_distance ? dist_corr : (is_prismatic ? pris : sep);

  // _positional_correction (:140).
  float c = sqrtf(corr.x * corr.x + corr.y * corr.y);
  bool ok = c > 1e-9f;
  float cm = clamp_lo(c, 1e-9f);
  V2 n = v2(-corr.x / cm, -corr.y / cm);
  float r1xn = r1.x * n.y - r1.y * n.x, r2xn = r2.x * n.y - r2.y * n.x;
  float iia = d[J_IIA], iib = d[J_IIB];
  float w1 = d[J_IMA] + iia * r1xn * r1xn;
  float w2 = d[J_IMB] + iib * r2xn * r2xn;
  float w_sum = w1 + w2;
  float tilde = d[J_COMP] / hh;
  float dlp = (ok && w_sum > 1e-12f) ? -c / clamp_lo(w_sum + tilde, 1e-12f) : 0.0f;
  V2 imp = n * dlp;
  acc_dp_a = acc_dp_a + v2(imp.x * d[J_IMVA], imp.y * d[J_IMVA + 1]);
  acc_dp_b = acc_dp_b + v2(-imp.x * d[J_IMVB], -imp.y * d[J_IMVB + 1]);
  acc_th_a = acc_th_a + iia * (r1.x * imp.y - r1.y * imp.x);
  acc_th_b = acc_th_b + -iib * (r2.x * imp.y - r2.y * imp.x);
  tot_pos = tot_pos + imp;
  return JointInc2{acc_dp_a, acc_dp_b, acc_th_a, acc_th_b, tot_pos, tot_rot};
}

// One joint's damping increments (lin_a, ang_a, lin_b, ang_b: 3 floats each
// into out[6]) from the velocities of its ends.
__device__ __forceinline__ void joint_damping_2d(const float* d, const float* sa,
                                                 const float* sb, float h, float* out) {
  float ka = d[J_ADAMP] * h, kl = d[J_LDAMP] * h;
  ka = ka > 1.0f ? 1.0f : ka;
  kl = kl > 1.0f ? 1.0f : kl;
  float delta_omega = (sb[2] - sa[2]) * ka;
  V2 delta_v = (load2(sb) - load2(sa)) * kl;
  float w1 = d[J_IMA], w2 = d[J_IMB];
  float wsum = w1 + w2;
  float recip = wsum > 1e-12f ? 1.0f / clamp_lo(wsum, 1e-12f) : 0.0f;
  V2 p = delta_v * recip;
  store2(out, p * w1);
  out[2] = d[J_IIA] > 0.0f ? delta_omega : 0.0f;
  store2(out + 3, (-p) * w2);
  out[5] = d[J_IIB] > 0.0f ? -delta_omega : 0.0f;
}

// ---------------------------------------------------------------------------
// Kernel AB: one pair of the 2D swept CCD (dim2/ccd.py:70-116).
// ---------------------------------------------------------------------------

constexpr int kToiRounds2 = 8;
constexpr float kDeeper2 = 0.5f;  // kernels/swept_toi_2d.py::DEEPER

struct SweptTables2 {
  const float* pos0;    // [M, 2] collider positions at t = 0
  const float* cs0;     // [M, 2] cosine and sine of the collider angles at t = 0
  const float* angle0;  // [M]
  const float* sweep;   // [M, 2] delta position of each collider's body
  const float* dang;    // [M] delta angle along the sweep (0 in the linear mode)
  const float* ang;     // [M] angular travel bound
  const float* inner;   // [M] inner radius
  const float* verts;   // [M, 8, 2]
  const int* count;
  const float* radius;
  const unsigned char* plane;
  const int* body_idx;
  const unsigned char* active;
  const int* layer_m;  // u32 bit patterns
  const int* layer_f;
};

// Collider k's pose at t: its position moved along its sweep, and the cosine
// and sine of its angle (cosf/sinf only where it turns along the sweep).
__device__ __forceinline__ void pose_at_2d(const SweptTables2& T, int k, float t, V2& x,
                                           float& c, float& s) {
  x = load2(T.pos0 + 2 * k) + load2(T.sweep + 2 * k) * t;
  float da = T.dang[k];
  if (da != 0.0f) {
    float a = T.angle0[k] + da * t;
    c = cosf(a);
    s = sinf(a);
  } else {
    c = T.cs0[2 * k];
    s = T.cs0[2 * k + 1];
  }
}

// min(TOI, 1) of swept collider i against collider j (1 where the pair is
// invalid or passes t = 1), and in *ran the rounds it took, negated where a
// valid pair ran them all without a hit and stayed below t = 1. A pair stops
// once it has hit or t >= 1. The two departures from the reference are
// kernels/swept_toi_2d.py's.
__device__ __forceinline__ float swept_toi_pair_2d(int i, int j, const SweptTables2& T,
                                                   int* ran) {
  V2 s_i = load2(T.sweep + 2 * i), s_j = load2(T.sweep + 2 * j);
  V2 d_rel = s_i - s_j;
  float dist = sqrtf(d_rel.x * d_rel.x + d_rel.y * d_rel.y);
  float dm = fmaxf(dist, 1e-9f);
  V2 dirn = dist > 1e-9f ? v2(d_rel.x / dm, d_rel.y / dm) : v2(1.0f, 0.0f);
  float ang = T.ang[i] + T.ang[j];
  // kernels/swept_toi_2d.py::touch_depth
  float in_i = T.inner[i], in_j = T.inner[j];
  float deeper = kDeeper2 * fminf(in_i > 0.0f ? in_i : in_j, in_j > 0.0f ? in_j : in_i);
  const float* vi = T.verts + 2 * kVerts * (long)i;
  const float* vj = T.verts + 2 * kVerts * (long)j;
  bool pl_i = T.plane[i] != 0, pl_j = T.plane[j] != 0;
  float t = 0.0f, goal = 0.0f;
  bool done = false;
  int rounds = kToiRounds2;
  for (int k = 0; k < kToiRounds2; ++k) {
    V2 xi, xj;
    float ci, si, cj, sj;
    pose_at_2d(T, i, t, xi, ci, si);
    pose_at_2d(T, j, t, xj, cj, sj);
    Manifold m = pair_manifold_at(xi, ci, si, vi, T.count[i], T.radius[i], pl_i, xj, cj, sj, vj,
                                  T.count[j], T.radius[j], pl_j);
    float sep = fminf(m.sep[0], m.sep[1]);
    if (k == 0) goal = sep <= 1e-4f ? fminf(-deeper, sep - 2e-4f) : 0.0f;
    float approach = (dirn.x * m.normal.x + dirn.y * m.normal.y) * dist + ang;
    bool hit = sep < goal + 1e-4f;
    float step = approach > 1e-6f ? (sep - goal) / fmaxf(approach, 1e-6f) : 2.0f;
    float new_t = (done || hit) ? t : t + fmaxf(step, 0.0f);
    t = fminf(new_t, 1.5f);
    done = done || hit;
    if (done || t >= 1.0f) {
      rounds = k + 1;
      break;
    }
  }
  bool layers_ok = (T.layer_m[i] & T.layer_f[j]) != 0 && (T.layer_m[j] & T.layer_f[i]) != 0;
  bool valid = j != i && T.active[j] != 0 && T.body_idx[j] != T.body_idx[i] && layers_ok;
  *ran = (valid && !done && t < 1.0f) ? -rounds : rounds;
  return valid ? fminf(t, 1.0f) : 1.0f;
}

// ---------------------------------------------------------------------------
// The 2D queries (dim2/queries.py): Kernels AC (rays), AD (points) and AE
// (shape casts). A miss or a far collider is 1e30 there (the queries' _BIG).
// ---------------------------------------------------------------------------

constexpr float kFar = 1e30f;

// Collider j's world polygon (vertices at its pose), radius and count.
__device__ __forceinline__ void load_collider(Poly& q, int j, const float* pos, const float* cs,
                                              const float* verts, const int* count,
                                              const float* radius) {
  load_poly(q, load2(pos + 2 * j), cs[2 * j], cs[2 * j + 1], verts + 2 * kVerts * (long)j,
            count[j], radius[j]);
}

// A half-space's world outward normal: its local normal (vertex 0) turned.
__device__ __forceinline__ V2 plane_normal(int j, const float* cs, const float* verts) {
  return rot2(cs[2 * j], cs[2 * j + 1], load2(verts + 2 * kVerts * (long)j));
}

__device__ __forceinline__ V2 normalized(V2 v) {
  float m = fmaxf(norm2(v), 1e-9f);
  return v2(v.x / m, v.y / m);
}

struct Slab {
  float enter, exit;
  V2 n_enter;
  bool ok;
};

// Reference _slab (:143): where a ray enters and leaves the region behind k
// face lines (outward normals pn, points pp), the entering face's normal
// (the first of equals) and whether the interval is not empty.
__device__ __forceinline__ Slab slab(V2 o, V2 d, const V2* pn, const V2* pp, const bool* valid,
                                     int k_n) {
  float best = 0.0f, x = kFar;
  int kb = 0;
  bool parallel_out = false, any = false;
  for (int k = 0; k < k_n; ++k) {
    float denom = pn[k].x * d.x + pn[k].y * d.y;
    float num = pn[k].x * (pp[k].x - o.x) + pn[k].y * (pp[k].y - o.y);
    float t = num / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
    float te = (valid[k] && denom < -1e-12f) ? t : -kFar;
    if (k == 0 || te > best) {
      best = te;
      kb = k;
    }
    x = fminf(x, (valid[k] && denom > 1e-12f) ? t : kFar);
    parallel_out = parallel_out || (valid[k] && fabsf(denom) <= 1e-12f && num < 0.0f);
    any = any || valid[k];
  }
  Slab s;
  s.enter = fmaxf(best, -kFar);
  s.exit = x;
  s.n_enter = pn[kb];
  s.ok = s.enter <= x + 1e-9f && !parallel_out && any;
  return s;
}

// Kernel AC: the first hit of the ray (o, unit d) on collider q, a rounded
// polygon (reference _ray_rounded_poly :164): the union of its core polygon
// (3 or more vertices), one disk a vertex and one rectangle an edge (the edge
// swept outward by the radius) is convex, so the ray's interval is [least
// entry, greatest exit]. Returns t (kFar on a miss) and the normal in *n.
// The exit normal of a hollow ray cast from inside is the reference's
// approximation (:232-246), kept as it is.
__device__ __forceinline__ float ray_rounded_poly(V2 o, V2 d, const Poly& q, bool solid, V2* n) {
  V2 v1[kVerts], n_out[kVerts], n_disk[kVerts];
  float elen[kVerts], e_disk[kVerts], x_disk[kVerts];
  bool edge_ok[kVerts], core_valid[kVerts], disk_ok[kVerts];
  for (int i = 0; i < kVerts; ++i) {
    v1[i] = q.v[next_vertex(i, q.n)];
    V2 e = v1[i] - q.v[i];
    elen[i] = sqrtf(e.x * e.x + e.y * e.y);
    edge_ok[i] = i < q.n && q.n >= 2 && elen[i] > 1e-9f;
    core_valid[i] = i < q.n && q.n >= 3 && elen[i] > 1e-9f;
    n_out[i] = edge_normal(e);
    V2 oc = o - q.v[i];
    float b = oc.x * d.x + oc.y * d.y;
    float c = (oc.x * oc.x + oc.y * oc.y) - q.r * q.r;
    float disc = b * b - c;
    disk_ok[i] = i < q.n && disc >= 0.0f && q.r > 1e-12f;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    e_disk[i] = -b - sq;
    x_disk[i] = -b + sq;
    n_disk[i] = normalized((o + d * e_disk[i]) - q.v[i]);
  }
  Slab core = slab(o, d, n_out, q.v, core_valid, kVerts);
  bool ok_core = core.ok && q.n >= 3;

  // The union, in the reference's order: core, disks, rectangles.
  float t_in = kFar, t_out = -kFar;
  V2 n_in = core.n_enter;
  bool any_valid = false;
  auto take = [&](int k, bool valid, float enter, float exit, V2 normal) {
    float te = valid ? enter : kFar;
    if (k == 0 || te < t_in) {
      t_in = te;
      n_in = normal;
    }
    t_out = fmaxf(t_out, valid ? exit : -kFar);
    any_valid = any_valid || valid;
  };
  take(0, ok_core, core.enter, core.exit, core.n_enter);
  for (int i = 0; i < kVerts; ++i) take(1 + i, disk_ok[i], e_disk[i], x_disk[i], n_disk[i]);
  for (int i = 0; i < kVerts; ++i) {
    float l = fmaxf(elen[i], 1e-9f);
    V2 e = v1[i] - q.v[i];
    V2 th = v2(e.x / l, e.y / l);
    V2 pn[4] = {n_out[i], -n_out[i], -th, th};
    V2 pp[4] = {q.v[i] + n_out[i] * q.r, q.v[i], q.v[i], v1[i]};
    bool all[4] = {true, true, true, true};
    Slab r = slab(o, d, pn, pp, all, 4);
    take(1 + kVerts + i, r.ok && edge_ok[i], r.enter, r.exit, r.n_enter);
  }

  // The exit normal (:232-246): the farthest disk's, where a disk's exit is
  // the union's, else the face's whose line the exit point is deepest past.
  V2 exit_pt = o + d * t_out;
  float xd_best = 0.0f, fd_best = 0.0f;
  int jx = 0, jf = 0;
  for (int i = 0; i < kVerts; ++i) {
    float xd = disk_ok[i] ? x_disk[i] : -kFar;
    if (i == 0 || xd > xd_best) {
      xd_best = xd;
      jx = i;
    }
    V2 rel = exit_pt - q.v[i];
    float fd = (core_valid[i] || edge_ok[i]) ? n_out[i].x * rel.x + n_out[i].y * rel.y : -kFar;
    if (i == 0 || fd > fd_best) {
      fd_best = fd;
      jf = i;
    }
  }
  bool disk_exit_wins = xd_best >= t_out - 1e-6f;
  V2 n_exit = (disk_exit_wins && q.r > 1e-12f) ? normalized(exit_pt - q.v[jx]) : n_out[jf];

  bool inside = any_valid && t_in <= 0.0f && t_out >= 0.0f;
  bool hit_front = any_valid && t_in >= 0.0f;
  float t;
  if (solid) {
    t = inside ? 0.0f : (hit_front ? t_in : kFar);
    *n = inside ? -d : n_in;
  } else {
    t = inside ? (t_out >= 0.0f ? t_out : kFar) : (hit_front ? t_in : kFar);
    *n = inside ? n_exit : n_in;
  }
  return t < kFar ? t : kFar;
}

// Kernel AC on a half-space through pp with outward normal pn (:262-272).
__device__ __forceinline__ float ray_plane(V2 o, V2 d, V2 pp, V2 pn, bool solid, V2* n) {
  float denom = d.x * pn.x + d.y * pn.y;
  float o_side = (o.x - pp.x) * pn.x + (o.y - pp.y) * pn.y;
  float t_pl = -o_side / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
  bool inside = o_side <= 0.0f;
  float t;
  if (inside)
    t = solid ? 0.0f : (denom > 1e-12f ? t_pl : kFar);
  else
    t = denom < -1e-12f ? t_pl : kFar;
  *n = (inside && solid) ? -d : pn;
  return t < kFar ? t : kFar;
}

// Kernel AD: the signed distance from p to collider j's rounded surface and
// the surface point closest to it (reference _point_one :356).
__device__ __forceinline__ float point_one(V2 p, const Poly& q, bool plane, V2 pp, V2 pn,
                                           V2* surf) {
  if (plane) {
    float d = (p.x - pp.x) * pn.x + (p.y - pp.y) * pn.y;
    *surf = p - pn * d;
    return d;
  }
  Closest c = closest_on_poly(p, q);
  V2 out = p - c.closest;
  float dist_core = c.inside ? c.face_d : norm2(out);
  V2 u_raw = c.inside ? c.closest - p : out;
  V2 u = norm2(u_raw) > 1e-9f ? normalized(u_raw) : c.n_face;
  *surf = c.closest + u * q.r;
  return dist_core - q.r;
}

// Kernel AE's query: the shape (local vertices, count, radius) and its cast.
struct Query2 {
  V2 origin;
  float c, s;  // cosine and sine of the shape's angle
  V2 dir;      // unit direction
  float max_distance, max_distance_1;  // and max_distance + 1
  const float* verts;
  int n;
  float r;
};

struct Cast2 {
  float t, sep;
  V2 pa, pb, normal;
  bool hit;
  int count, rounds;
};

// Kernel AE: conservative advancement of the query shape along its cast
// against collider j over at most `rounds` rounds of V's manifold (reference
// _sweep_all :500-544, _CAST_ITERS = 24); with 0 rounds, the manifold at the
// origin (_manifold_vs_all :447). A collider stops once it has hit, or once
// t is capped at max_distance + 1 past max_distance, after which no round
// changes what it returns. The manifold's normal points from the shape to
// the collider.
__device__ __forceinline__ Cast2 shape_cast_one(int j, const Query2& q, int rounds,
                                                const float* pos, const float* cs,
                                                const float* verts, const int* count,
                                                const float* radius, const unsigned char* plane) {
  V2 pj = load2(pos + 2 * j);
  float cj = cs[2 * j], sj = cs[2 * j + 1];
  const float* vj = verts + 2 * kVerts * (long)j;
  bool plj = plane[j] != 0;
  float t = 0.0f;
  bool done = false;
  int ran = 0;
  for (int k = 0; k < rounds; ++k) {
    if (done || (t >= q.max_distance_1 && q.max_distance_1 > q.max_distance)) break;
    ++ran;
    Manifold m = pair_manifold_at(q.origin + q.dir * t, q.c, q.s, q.verts, q.n, q.r, false, pj,
                                  cj, sj, vj, count[j], radius[j], plj);
    float sep = fminf(m.sep[0], m.sep[1]);
    float approach = q.dir.x * m.normal.x + q.dir.y * m.normal.y;
    bool hit_now = sep < 1e-4f;
    float step = approach > 1e-6f ? sep / fmaxf(approach, 1e-6f) : kFar;
    float new_t = (done || hit_now) ? t : t + fmaxf(step, 0.0f);
    t = fminf(new_t, q.max_distance_1);
    done = done || hit_now;
  }
  Manifold m = pair_manifold_at(q.origin + q.dir * t, q.c, q.s, q.verts, q.n, q.r, false, pj, cj,
                                sj, vj, count[j], radius[j], plj);
  int pi = m.sep[1] < m.sep[0] ? 1 : 0;
  Cast2 out;
  out.t = t;
  out.sep = fminf(m.sep[0], m.sep[1]);
  out.pa = m.pa[pi];
  out.pb = m.pb[pi];
  out.normal = m.normal;
  out.hit = done && t <= q.max_distance;
  out.count = m.count;
  out.rounds = ran;
  return out;
}

}  // namespace d2
