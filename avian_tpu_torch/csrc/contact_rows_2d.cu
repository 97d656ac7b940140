// Kernel W: the 2D engine's contact rows, one thread a pair slot.
//
// Replaces avian_tpu/dim2/contacts.py::narrow_phase (:18) after the manifolds
// and the key join (Kernel F's contact_join): keep predicate, point
// compaction, anchors, ids, warm-start match, materials, eviction
// (d2::contact_row_2d in dim2.cuh). All in registers; bound by bytes.
#include "dim2.cuh"

namespace {

__global__ void contact_rows_2d_kernel(int c_cap, d2::RowsIn2 in, d2::RowParams2 p,
                                       d2::RowsOut2 out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_cap) return;
  d2::contact_row_2d(c, in, p, out);
}

}  // namespace

extern "C" int avian_contact_rows_2d(
    int c_cap, const unsigned char* valid, const int* ca, const int* cb, const float* m_pa,
    const float* m_pb, const float* m_sep, const int* m_fid, const int* m_count,
    const int* col_body, const float* col_spec, const float* col_margin, const float* col_fric,
    const float* col_sfric, const float* col_rest, const int* col_fcomb, const int* col_rcomb,
    const unsigned char* col_sensor, const float* b_pos, const float* b_cs, const float* b_com,
    const float* b_lin_vel, const int* hit, const unsigned char* survives, const int* new_rank,
    const unsigned char* o_active, const unsigned char* o_touching, const int* o_color,
    const int* o_cid, const int* o_next_cid, const int* o_fid, const float* o_anchor_a,
    const float* o_nimp, const float* o_timp, const int* o_npoints, const int* o_body_a,
    const int* o_body_b, float dt, float spec_default, float tol, float dist_thresh,
    int match_contacts, int* body_a, int* body_b, unsigned char* touching,
    unsigned char* was_touching, unsigned char* is_sensor, int* num_points, float* anchor_a,
    float* anchor_b, float* penetration, int* feature_id, float* nimp, float* timp,
    float* friction, float* sfriction, float* restitution, int* color, int* contact_id,
    unsigned char* evicted, int* ev_cid, int* ev_ba, int* ev_bb, void* stream) {
  d2::RowsIn2 in{valid,      ca,        cb,         m_pa,       m_pb,      m_sep,     m_fid,
                 m_count,    col_body,  col_spec,   col_margin, col_fric,  col_sfric, col_rest,
                 col_fcomb,  col_rcomb, col_sensor, b_pos,      b_cs,      b_com,     b_lin_vel,
                 hit,        survives,  new_rank,   o_active,   o_touching, o_color,  o_cid,
                 o_next_cid, o_fid,     o_anchor_a, o_nimp,     o_timp,    o_npoints, o_body_a,
                 o_body_b};
  d2::RowsOut2 out{body_a,     body_b,    touching,   was_touching, is_sensor, num_points,
                   anchor_a,   anchor_b,  penetration, feature_id,  nimp,      timp,
                   friction,   sfriction, restitution, color,       contact_id, evicted,
                   ev_cid,     ev_ba,     ev_bb};
  d2::RowParams2 p{dt, spec_default, tol, dist_thresh, match_contacts};
  const int threads = 128;
  contact_rows_2d_kernel<<<(c_cap + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      c_cap, in, p, out);
  return (int)cudaGetLastError();
}
