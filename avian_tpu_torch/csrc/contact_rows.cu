// Kernel F: contact persistence. Two launches.
//
// Replaces avian_tpu/pipeline/contacts.py::narrow_phase (:54) after the
// manifolds: the old/new pair-key join (:133-187), the keep predicate and
// in-row point compaction, COM anchors, contact ids, warm-start matching
// (:203-235), material combination and eviction (:256-275).
//
// contact_join: one thread per entry of the stably sorted [old keys ++ new
// keys] array. A new entry whose left neighbour is an old entry with the same
// key takes that old slot; an old entry whose right neighbour is a new entry
// with the same key survives. Each slot is written by exactly one thread.
//
// contact_rows: one thread per pair slot; all of a row's work happens in
// registers (4 points, a 4 x 4 match). Bound by bytes: a row reads about 300
// and writes about 250. Ties in the match go to the lowest old point, and a
// "no match" never enters arithmetic.
#include "common.cuh"

namespace {

__global__ void contact_join_kernel(int c_cap, const long long* __restrict__ ks,
                                    const long long* __restrict__ s, int* __restrict__ hit,
                                    unsigned char* __restrict__ survives) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int n = 2 * c_cap;
  if (j >= n) return;
  long long key = ks[j];
  long long src = s[j];
  bool key_ok = key >= 0;
  if (src >= c_cap) {
    int v = 0;
    if (key_ok && j > 0 && ks[j - 1] == key && s[j - 1] < c_cap) v = (int)s[j - 1] + 1;
    hit[src - c_cap] = v;
  } else {
    bool sv = key_ok && j + 1 < n && ks[j + 1] == key && s[j + 1] >= c_cap;
    survives[src] = sv ? 1 : 0;
  }
}

// Body velocity scaled so that it travels at most the collider's speculative
// margin in dt.
__device__ __forceinline__ V3 clamped_vel(const float* lin_vel, const float* spec_margin,
                                          int body, int collider, float dt,
                                          float spec_default) {
  V3 v = load3(lin_vel + 3 * body);
  float spec = spec_margin[collider];
  spec = spec > spec_default ? spec_default : spec;
  float travel = sqrtf(dot(v, v)) * dt;
  travel = travel < 1e-9f ? 1e-9f : travel;
  float scale = __fdiv_rn(spec, travel);
  scale = scale > 1.0f ? 1.0f : scale;
  return v * scale;
}

struct RowsIn {
  const unsigned char* valid;
  const int* ca;
  const int* cb;
  const float* m_pa;
  const float* m_pb;
  const float* m_sep;
  const int* m_fid;
  const int* m_count;
  const int* col_body;
  const float* col_spec;
  const float* col_margin;
  const float* col_fric;
  const float* col_sfric;
  const float* col_rest;
  const int* col_fcomb;
  const int* col_rcomb;
  const unsigned char* col_sensor;
  const float* b_pos;
  const float* b_quat;
  const float* b_com;
  const float* b_lin_vel;
  const int* hit;
  const unsigned char* survives;
  const int* new_id;
  const unsigned char* o_active;
  const unsigned char* o_touching;
  const int* o_color;
  const int* o_cid;
  const int* o_fid;
  const float* o_anchor_a;
  const float* o_nimp;
  const float* o_timp;
  const int* o_npoints;
  const int* o_body_a;
  const int* o_body_b;
};

struct RowsOut {
  int* body_a;
  int* body_b;
  unsigned char* touching;
  unsigned char* was_touching;
  unsigned char* is_sensor;
  int* num_points;
  float* anchor_a;
  float* anchor_b;
  float* penetration;
  int* feature_id;
  float* nimp;
  float* timp;
  float* friction;
  float* sfriction;
  float* restitution;
  int* color;
  int* contact_id;
  unsigned char* evicted;
  int* ev_cid;
  int* ev_ba;
  int* ev_bb;
};

__global__ void contact_rows_kernel(int c_cap, RowsIn in, float dt, float spec_default, float tol,
                                    float dist_thresh, int match_contacts, RowsOut out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_cap) return;
  bool valid = in.valid[c] != 0;
  int ca = in.ca[c], cb = in.cb[c];
  int ba = in.col_body[ca], bb = in.col_body[cb];

  // Effective speculative margin and the keep predicate.
  V3 va = clamped_vel(in.b_lin_vel, in.col_spec, ba, ca, dt, spec_default);
  V3 vb = clamped_vel(in.b_lin_vel, in.col_spec, bb, cb, dt, spec_default);
  V3 v_rel = vb - va;
  float margin = dt * sqrtf(dot(v_rel, v_rel));
  float keep_dist = (margin < tol ? tol : margin) + in.col_margin[ca] + in.col_margin[cb];

  int count = in.m_count[c];
  int order[4];
  int np = 0;
  bool pv[4];
  for (int l = 0; l < 4; ++l) {
    pv[l] = valid && l < count && in.m_sep[4 * c + l] < keep_dist;
    if (pv[l]) order[np++] = l;
  }
  int tail = np;
  for (int l = 0; l < 4; ++l)
    if (!pv[l]) order[tail++] = l;

  V3 com_a = load3(in.b_pos + 3 * ba) + rotate(load4(in.b_quat + 4 * ba), load3(in.b_com + 3 * ba));
  V3 com_b = load3(in.b_pos + 3 * bb) + rotate(load4(in.b_quat + 4 * bb), load3(in.b_com + 3 * bb));

  int h = in.hit[c];
  bool matched = h > 0;
  int os = h > 0 ? h - 1 : 0;
  bool is_new = valid && !matched;

  // The matched old row's points.
  int o_np = in.o_npoints[os];
  int o_fid[4];
  V3 o_anchor[4];
  bool o_valid[4];
  for (int j = 0; j < 4; ++j) {
    o_fid[j] = in.o_fid[4 * os + j];
    o_anchor[j] = load3(in.o_anchor_a + 3 * (4 * os + j));
    o_valid[j] = matched && j < o_np;
  }

  for (int i = 0; i < 4; ++i) {
    int l = order[i];
    int fid = in.m_fid[4 * c + l];
    V3 aa = load3(in.m_pa + 3 * (4 * c + l)) - com_a;
    V3 ab = load3(in.m_pb + 3 * (4 * c + l)) - com_b;
    store3(out.anchor_a + 3 * (4 * c + i), aa);
    store3(out.anchor_b + 3 * (4 * c + i), ab);
    out.penetration[4 * c + i] = -in.m_sep[4 * c + l];
    out.feature_id[4 * c + i] = fid;

    // Warm start: the old point with the same feature id; if no old point
    // has it, the nearest old point within the match distance. Ties go to
    // the lowest old point.
    float d2[4];
    bool fid_m[4], dist_m[4];
    bool any_fid = false;
    for (int j = 0; j < 4; ++j) {
      V3 dd = aa - o_anchor[j];
      d2[j] = dot(dd, dd);
      fid_m[j] = o_valid[j] && fid == o_fid[j];
      dist_m[j] = o_valid[j] && d2[j] < dist_thresh;
      any_fid = any_fid || fid_m[j];
    }
    int best = -1;
    float best_d2 = 0.0f;
    for (int j = 0; j < 4; ++j) {
      bool use = any_fid ? fid_m[j] : dist_m[j];
      if (use && (best < 0 || d2[j] < best_d2)) {
        best = j;
        best_d2 = d2[j];
      }
    }
    bool has = best >= 0 && match_contacts != 0;
    int src = 4 * os + (best < 0 ? 0 : best);
    out.nimp[4 * c + i] = has ? in.o_nimp[src] : 0.0f;
    out.timp[2 * (4 * c + i) + 0] = has ? in.o_timp[2 * src + 0] : 0.0f;
    out.timp[2 * (4 * c + i) + 1] = has ? in.o_timp[2 * src + 1] : 0.0f;
  }

  out.body_a[c] = ba;
  out.body_b[c] = bb;
  out.num_points[c] = np;
  out.touching[c] = (np > 0 && valid) ? 1 : 0;
  out.was_touching[c] = (matched && in.o_touching[os] != 0) ? 1 : 0;
  out.is_sensor[c] = (in.col_sensor[ca] != 0 || in.col_sensor[cb] != 0) ? 1 : 0;
  out.color[c] = matched ? in.o_color[os] : -1;
  out.contact_id[c] = matched ? in.o_cid[os] : (is_new ? in.new_id[c] : 0);
  out.friction[c] = combine(in.col_fric[ca], in.col_fric[cb], in.col_fcomb[ca], in.col_fcomb[cb]);
  out.sfriction[c] =
      combine(in.col_sfric[ca], in.col_sfric[cb], in.col_fcomb[ca], in.col_fcomb[cb]);
  out.restitution[c] =
      combine(in.col_rest[ca], in.col_rest[cb], in.col_rcomb[ca], in.col_rcomb[cb]);

  // CollisionEnd for the old row of this slot, if no new pair took it over.
  bool ev = in.o_active[c] != 0 && in.o_touching[c] != 0 && in.survives[c] == 0;
  out.evicted[c] = ev ? 1 : 0;
  out.ev_cid[c] = ev ? in.o_cid[c] : 0;
  out.ev_ba[c] = ev ? in.o_body_a[c] : 0;
  out.ev_bb[c] = ev ? in.o_body_b[c] : 0;
}

}  // namespace

extern "C" int avian_contact_join(int c_cap, const long long* ks, const long long* s, int* hit,
                                  unsigned char* survives, void* stream) {
  const int threads = 256;
  int n = 2 * c_cap;
  contact_join_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      c_cap, ks, s, hit, survives);
  return (int)cudaGetLastError();
}

extern "C" int avian_contact_rows(
    int c_cap, const unsigned char* valid, const int* ca, const int* cb, const float* m_pa,
    const float* m_pb, const float* m_sep, const int* m_fid, const int* m_count,
    const int* col_body, const float* col_spec, const float* col_margin, const float* col_fric,
    const float* col_sfric, const float* col_rest, const int* col_fcomb, const int* col_rcomb,
    const unsigned char* col_sensor, const float* b_pos, const float* b_quat, const float* b_com,
    const float* b_lin_vel, const int* hit, const unsigned char* survives, const int* new_id,
    const unsigned char* o_active, const unsigned char* o_touching, const int* o_color,
    const int* o_cid, const int* o_fid, const float* o_anchor_a,
    const float* o_nimp, const float* o_timp, const int* o_npoints, const int* o_body_a,
    const int* o_body_b, float dt, float spec_default, float tol, float dist_thresh,
    int match_contacts, int* body_a, int* body_b, unsigned char* touching,
    unsigned char* was_touching, unsigned char* is_sensor, int* num_points, float* anchor_a,
    float* anchor_b, float* penetration, int* feature_id, float* nimp, float* timp,
    float* friction, float* sfriction, float* restitution, int* color, int* contact_id,
    unsigned char* evicted, int* ev_cid, int* ev_ba, int* ev_bb, void* stream) {
  RowsIn in{valid,      ca,        cb,        m_pa,     m_pb,       m_sep,     m_fid,
            m_count,    col_body,  col_spec,  col_margin, col_fric, col_sfric, col_rest,
            col_fcomb,  col_rcomb, col_sensor, b_pos,   b_quat,     b_com,     b_lin_vel,
            hit,        survives,  new_id,    o_active, o_touching, o_color,   o_cid,
            o_fid,      o_anchor_a, o_nimp,   o_timp,   o_npoints,  o_body_a,  o_body_b};
  RowsOut out{body_a,     body_b,      touching,   was_touching, is_sensor, num_points,
              anchor_a,   anchor_b,    penetration, feature_id,  nimp,      timp,
              friction,   sfriction,   restitution, color,       contact_id, evicted,
              ev_cid,     ev_ba,       ev_bb};
  const int threads = 128;
  contact_rows_kernel<<<(c_cap + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      c_cap, in, dt, spec_default, tol, dist_thresh, match_contacts, out);
  return (int)cudaGetLastError();
}
