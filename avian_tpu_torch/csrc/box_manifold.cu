// Kernel A: box/box and box/plane contact manifolds, one thread per pair.
//
// Replaces avian_tpu/geometry/box_box.py::box_box (+ _face_manifold,
// _clip_axis) and avian_tpu/geometry/narrowphase.py::box_plane. Each pair is
// thousands of dependent f32 operations on registers, so the kernel is bound
// by latency and register pressure; the design keeps the clip polygon in a
// fixed 8-slot array and emits clipped points in ring order instead of the
// reference's per-clip sort. The arithmetic follows the plain PyTorch version
// (geometry/box_box.py, geometry/narrowphase.py) operation by operation, so
// ties (SAT axis, box/plane corner order) break the same way on both.
#include "common.cuh"

namespace {

constexpr int kP = 8;  // clip polygon slots

struct Out {
  V3 normal;
  V3 pa[4];
  V3 pb[4];
  float sep[4];
  int fid[4];
  int count;
};

__device__ void to_mat3(Q4 q, float m[3][3]) {
  float x2 = q.x + q.x, y2 = q.y + q.y, z2 = q.z + q.z;
  float xx = q.x * x2, yy = q.y * y2, zz = q.z * z2;
  float xy = q.x * y2, xz = q.x * z2, yz = q.y * z2;
  float wx = q.w * x2, wy = q.w * y2, wz = q.w * z2;
  m[0][0] = 1.0f - (yy + zz); m[0][1] = xy - wz; m[0][2] = xz + wy;
  m[1][0] = xy + wz; m[1][1] = 1.0f - (xx + zz); m[1][2] = yz - wx;
  m[2][0] = xz - wy; m[2][1] = yz + wx; m[2][2] = 1.0f - (xx + yy);
}

// sum_j m[i][j] v[j]
__device__ V3 mv3(const float m[3][3], V3 v) {
  return v3(m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
            m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
            m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z);
}

// sum_i m[i][j] v[i]
__device__ V3 mtv3(const float m[3][3], V3 v) {
  return v3(m[0][0] * v.x + m[1][0] * v.y + m[2][0] * v.z,
            m[0][1] * v.x + m[1][1] * v.y + m[2][1] * v.z,
            m[0][2] * v.x + m[1][2] * v.y + m[2][2] * v.z);
}

__device__ V3 column(const float m[3][3], int j) { return v3(m[0][j], m[1][j], m[2][j]); }

__device__ V3 onehot(int i) { return v3(i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f, i == 2 ? 1.0f : 0.0f); }

__device__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// Sutherland-Hodgman clip of the polygon q[0..count) against
// s2 * q[axis2] <= lim, emitting kept vertices and crossings in ring order.
__device__ void clip_axis(float q[kP][3], int fids[kP], int& count, int axis2,
                          float s2, float lim, int fid_base) {
  float out[kP][3];
  int of[kP];
  int n = 0;
  for (int idx = 0; idx < kP; ++idx) {
    int nxt = (idx + 1 >= count) ? 0 : idx + 1;
    float d_cur = s2 * q[idx][axis2] - lim;
    float d_nxt = s2 * q[nxt][axis2] - lim;
    bool in_cur = d_cur <= 0.0f;
    bool edge_valid = idx < count;
    bool crossing = edge_valid && (in_cur != (d_nxt <= 0.0f));
    if (edge_valid && in_cur) {
      if (n < kP) {
        out[n][0] = q[idx][0];
        out[n][1] = q[idx][1];
        out[n][2] = q[idx][2];
        of[n] = fids[idx];
      }
      ++n;
    }
    if (crossing) {
      float diff = d_cur - d_nxt;
      float t = d_cur / (fabsf(diff) > 1e-12f ? diff : 1e-12f);
      float tc = clampf(t, 0.0f, 1.0f);
      if (n < kP) {
        for (int k = 0; k < 3; ++k) out[n][k] = q[idx][k] + (q[nxt][k] - q[idx][k]) * tc;
        of[n] = fid_base + idx;
      }
      ++n;
    }
  }
  int out_count = n < kP ? n : kP;
  if (out_count == 0) {  // the reference's sort then leads with old vertex 0
    out[0][0] = q[0][0];
    out[0][1] = q[0][1];
    out[0][2] = q[0][2];
    of[0] = fids[0];
  }
  for (int k = 0; k < kP; ++k) {
    int src = k < out_count ? k : 0;
    q[k][0] = out[src][0];
    q[k][1] = out[src][1];
    q[k][2] = out[src][2];
    fids[k] = k < out_count ? of[k] : 0;
  }
  count = out_count;
}

__device__ int argmax3(const float v[3]) {
  int best = 0;
  for (int i = 1; i < 3; ++i)
    if (v[i] > v[best]) best = i;
  return best;
}

// Reference _face_manifold, in the reference box's frame.
__device__ void face_manifold(const float r_inc[3][3], V3 t_inc, V3 h_ref, V3 h_inc,
                              int axis, V3 pts[4], V3 ref_pts[4], float seps4[4],
                              int fids4[4], int& count4, V3& n_ref) {
  float sign = signp(comp(t_inc, axis));
  n_ref = onehot(axis) * sign;
  float h_axis = comp(h_ref, axis);
  int u_r = (axis + 1) % 3, v_r = (axis + 2) % 3;
  float hu = comp(h_ref, u_r), hv = comp(h_ref, v_r);

  V3 dots = mtv3(r_inc, n_ref);
  float ad[3] = {fabsf(dots.x), fabsf(dots.y), fabsf(dots.z)};
  int j = argmax3(ad);
  float sj = -signp(comp(dots, j));
  int ju = (j + 1) % 3, jv = (j + 2) % 3;
  V3 fc = t_inc + (sj * comp(h_inc, j)) * column(r_inc, j);
  V3 b_u = column(r_inc, ju) * comp(h_inc, ju);
  V3 b_v = column(r_inc, jv) * comp(h_inc, jv);
  const float quad[4][2] = {{1.0f, 1.0f}, {-1.0f, 1.0f}, {-1.0f, -1.0f}, {1.0f, -1.0f}};
  float q[kP][3];
  int fids[kP];
  for (int v = 0; v < 4; ++v) {
    V3 vert = fc + quad[v][0] * b_u + quad[v][1] * b_v;
    q[v][0] = comp(vert, u_r);
    q[v][1] = comp(vert, v_r);
    q[v][2] = comp(vert, axis) * sign;
    fids[v] = v + 4 * j;
  }
  for (int v = 4; v < kP; ++v) {
    q[v][0] = q[0][0];
    q[v][1] = q[0][1];
    q[v][2] = q[0][2];
    fids[v] = 0;
  }
  int count = 4;
  clip_axis(q, fids, count, 0, 1.0f, hu, 32);
  clip_axis(q, fids, count, 0, -1.0f, hu, 40);
  clip_axis(q, fids, count, 1, 1.0f, hv, 48);
  clip_axis(q, fids, count, 1, -1.0f, hv, 56);

  float seps[kP], d2[kP], cr[kP];
  bool valid[kP];
  int idx0 = 0;
  for (int k = 0; k < kP; ++k) {
    valid[k] = k < count;
    seps[k] = valid[k] ? q[k][2] - h_axis : 1e9f;
    if (seps[k] < seps[idx0]) idx0 = k;
  }
  float p0u = q[idx0][0], p0v = q[idx0][1];
  int idx1 = 0;
  for (int k = 0; k < kP; ++k) {
    float du = q[k][0] - p0u, dv = q[k][1] - p0v;
    d2[k] = valid[k] ? du * du + dv * dv : -1.0f;
  }
  d2[idx0] = -1.0f;
  for (int k = 1; k < kP; ++k)
    if (d2[k] > d2[idx1]) idx1 = k;
  float e1u = q[idx1][0] - p0u, e1v = q[idx1][1] - p0v;
  for (int k = 0; k < kP; ++k) {
    float c = e1u * (q[k][1] - p0v) - e1v * (q[k][0] - p0u);
    cr[k] = valid[k] ? c : 0.0f;
  }
  cr[idx0] = 0.0f;
  cr[idx1] = 0.0f;
  int idx2 = 0, idx3 = 0;
  for (int k = 1; k < kP; ++k) {
    if (cr[k] > cr[idx2]) idx2 = k;
    if (cr[k] < cr[idx3]) idx3 = k;
  }
  int sel[4] = {idx0, idx1, idx2, idx3};
  bool first[4] = {true, idx1 != idx0, (idx2 != idx0) && (idx2 != idx1),
                   (idx3 != idx0) && (idx3 != idx1) && (idx3 != idx2)};
  V3 eu = onehot(u_r), ev = onehot(v_r), ea = onehot(axis);
  count4 = 0;
  for (int i = 0; i < 4; ++i) {
    int s = sel[i];
    bool ok = first[i] && valid[s];
    seps4[i] = ok ? seps[s] : 1e9f;
    fids4[i] = ok ? fids[s] : 0;
    count4 += ok ? 1 : 0;
    pts[i] = q[s][0] * eu + q[s][1] * ev + (q[s][2] * sign) * ea;
    ref_pts[i] = pts[i] - n_ref * clampf(seps4[i], -1e8f, 1e8f);
  }
}

// Reference _closest_segment_segment.
__device__ void closest_segment_segment(V3 pa, V3 ua, float ha, V3 pb, V3 ub, float hb,
                                        float& s_out, float& t_out) {
  V3 r = pa - pb;
  float b = dot(ua, ub);
  float c = dot(ua, r);
  float f = dot(ub, r);
  float denom = 1.0f - b * b;
  float s = denom > 1e-9f ? clampf((b * f - c) / fmaxf(denom, 1e-9f), -ha, ha) : 0.0f;
  float t = b * s + f;
  float t_cl = clampf(t, -hb, hb);
  s_out = clampf(b * t_cl - c, -ha, ha);
  t_out = t_cl;
}

__device__ void box_box(V3 pa, Q4 qa, V3 ha, V3 pb, Q4 qb, V3 hb, Out& o) {
  float rb[3][3];
  to_mat3(qmul(conj(qa), qb), rb);
  V3 t = rotate(conj(qa), pb - pa);
  float abs_rb[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) abs_rb[i][j] = fabsf(rb[i][j]) + 1e-6f;

  V3 mh = mv3(abs_rb, hb);
  float sep_a[3] = {fabsf(t.x) - (ha.x + mh.x), fabsf(t.y) - (ha.y + mh.y),
                    fabsf(t.z) - (ha.z + mh.z)};
  V3 t_b = mtv3(rb, t);
  V3 mha = mtv3(abs_rb, ha);
  float sep_b[3] = {fabsf(t_b.x) - (mha.x + hb.x), fabsf(t_b.y) - (mha.y + hb.y),
                    fabsf(t_b.z) - (mha.z + hb.z)};

  V3 axes_en[9];
  float sep_e[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      V3 ax = cross(onehot(i), column(rb, j));
      float len = sqrtf(dot(ax, ax));
      bool valid = len > 1e-6f;
      float den = fmaxf(len, 1e-6f);
      V3 an = v3(ax.x / den, ax.y / den, ax.z / den);
      float proj_a = fabsf(an.x) * ha.x + fabsf(an.y) * ha.y + fabsf(an.z) * ha.z;
      V3 adb = mtv3(rb, an);
      float proj_b = fabsf(adb.x) * hb.x + fabsf(adb.y) * hb.y + fabsf(adb.z) * hb.z;
      float s = fabsf(dot(an, t)) - (proj_a + proj_b);
      axes_en[3 * i + j] = an;
      sep_e[3 * i + j] = valid ? s : -1e9f;
    }
  }
  float bfa = fmaxf(fmaxf(sep_a[0], sep_a[1]), sep_a[2]);
  float bfb = fmaxf(fmaxf(sep_b[0], sep_b[1]), sep_b[2]);
  float best_face = fmaxf(bfa, bfb);
  int e_idx = 0;
  for (int e = 1; e < 9; ++e)
    if (sep_e[e] > sep_e[e_idx]) e_idx = e;
  float best_edge = sep_e[e_idx];
  bool use_edge = best_edge > best_face + fmaxf(0.05f * fabsf(best_face), 1e-4f);
  bool ref_on_a = bfa >= bfb - 1e-6f;

  if (use_edge) {
    int i_idx = e_idx / 3, j_idx = e_idx % 3;
    V3 axis = axes_en[e_idx];
    V3 n_e = axis * signp(dot(axis, t));
    V3 s_a = mulv(v3(signp(n_e.x), signp(n_e.y), signp(n_e.z)), ha);
    V3 ca = v3(i_idx == 0 ? 0.0f : s_a.x, i_idx == 1 ? 0.0f : s_a.y, i_idx == 2 ? 0.0f : s_a.z);
    V3 da = onehot(i_idx);
    V3 n_in_b = mtv3(rb, n_e);
    V3 s_b = mulv(v3(-signp(n_in_b.x), -signp(n_in_b.y), -signp(n_in_b.z)), hb);
    V3 cb_local = v3(j_idx == 0 ? 0.0f : s_b.x, j_idx == 1 ? 0.0f : s_b.y, j_idx == 2 ? 0.0f : s_b.z);
    V3 cb = t + mv3(rb, cb_local);
    V3 db = column(rb, j_idx);
    float s_par, t_par;
    closest_segment_segment(ca, da, comp(ha, i_idx), cb, db, comp(hb, j_idx), s_par, t_par);
    V3 pa_e = ca + da * s_par;
    V3 pb_e = cb + db * t_par;
    o.normal = rotate(qa, n_e);
    o.pa[0] = pa + rotate(qa, pa_e);
    o.pb[0] = pa + rotate(qa, pb_e);
    o.sep[0] = dot(pb_e - pa_e, n_e);
    o.fid[0] = 128 + e_idx;
    for (int i = 1; i < 4; ++i) {
      o.pa[i] = v3(0.0f, 0.0f, 0.0f);
      o.pb[i] = v3(0.0f, 0.0f, 0.0f);
      o.sep[i] = 1e9f;
      o.fid[i] = 0;
    }
    o.count = 1;
    return;
  }

  float r_in[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r_in[i][j] = ref_on_a ? rb[i][j] : rb[j][i];
  V3 t_in = ref_on_a ? t : -t_b;
  V3 h_ref = ref_on_a ? ha : hb;
  V3 h_inc = ref_on_a ? hb : ha;
  int axis = ref_on_a ? argmax3(sep_a) : argmax3(sep_b);
  V3 pts[4], ref_pts[4], n_local;
  float seps[4];
  int fids[4], count;
  face_manifold(r_in, t_in, h_ref, h_inc, axis, pts, ref_pts, seps, fids, count, n_local);
  Q4 rot_q = ref_on_a ? qa : qb;
  V3 origin = ref_on_a ? pa : pb;
  V3 n_w = rotate(rot_q, n_local);
  o.normal = ref_on_a ? n_w : -n_w;
  for (int i = 0; i < 4; ++i) {
    V3 pw = origin + rotate(rot_q, pts[i]);
    V3 rw = origin + rotate(rot_q, ref_pts[i]);
    o.pa[i] = ref_on_a ? rw : pw;
    o.pb[i] = ref_on_a ? pw : rw;
    o.sep[i] = seps[i];
    o.fid[i] = ref_on_a ? fids[i] : fids[i] + 64;
  }
  o.count = count;
}

__constant__ float kCorners[8][3] = {
    {-1.0f, -1.0f, -1.0f}, {1.0f, -1.0f, -1.0f}, {-1.0f, 1.0f, -1.0f}, {1.0f, 1.0f, -1.0f},
    {-1.0f, -1.0f, 1.0f},  {1.0f, -1.0f, 1.0f},  {-1.0f, 1.0f, 1.0f},  {1.0f, 1.0f, 1.0f}};

__device__ void box_plane(V3 pa, Q4 qa, V3 ha, V3 pb, Q4 qb, V3 nb, Out& o) {
  V3 n = rotate(qb, nb);
  float off = dot(pb, n);
  V3 corners[8];
  float seps[8];
  int order[8];
  for (int c = 0; c < 8; ++c) {
    V3 cl = mulv(v3(kCorners[c][0], kCorners[c][1], kCorners[c][2]), ha);
    corners[c] = pa + rotate(qa, cl);
    seps[c] = dot(corners[c], n) - off;
    // Stable insertion sort: ties keep the lower corner index first.
    int k = c;
    while (k > 0 && seps[c] < seps[order[k - 1]]) {
      order[k] = order[k - 1];
      --k;
    }
    order[k] = c;
  }
  o.normal = -n;
  for (int i = 0; i < 4; ++i) {
    int c = order[i];
    o.pa[i] = corners[c];
    o.pb[i] = corners[c] - n * seps[c];
    o.sep[i] = seps[c];
    o.fid[i] = c;
  }
  o.count = 4;
}

__global__ void box_manifold_kernel(int kind, int n, const float* __restrict__ pa,
                                    const float* __restrict__ qa, const float* __restrict__ ha,
                                    const float* __restrict__ pb, const float* __restrict__ qb,
                                    const float* __restrict__ hb, float* __restrict__ normal,
                                    float* __restrict__ point_a, float* __restrict__ point_b,
                                    float* __restrict__ sep, int* __restrict__ fid,
                                    int* __restrict__ count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Out o;
  V3 a_p = load3(pa + 3 * i), b_p = load3(pb + 3 * i);
  Q4 a_q = load4(qa + 4 * i), b_q = load4(qb + 4 * i);
  V3 a_h = load3(ha + 3 * i), b_h = load3(hb + 3 * i);
  if (kind == 0)
    box_box(a_p, a_q, a_h, b_p, b_q, b_h, o);
  else
    box_plane(a_p, a_q, a_h, b_p, b_q, b_h, o);
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

extern "C" int avian_box_manifold(int kind, int n, const float* pa, const float* qa,
                                  const float* ha, const float* pb, const float* qb,
                                  const float* hb, float* normal, float* point_a,
                                  float* point_b, float* sep, int* fid, int* count,
                                  void* stream) {
  const int threads = 128;
  box_manifold_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      kind, n, pa, qa, ha, pb, qb, hb, normal, point_a, point_b, sep, fid, count);
  return (int)cudaGetLastError();
}
