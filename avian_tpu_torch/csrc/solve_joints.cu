// Kernel I: the XPBD joint solver of one substep.
//
// Replaces avian_tpu/pipeline/xpbd.py::solve_position_constraints (:229),
// _solve_color (:283) and _joint_damping (:464). See kernels/solve_joints.py.
// joint_color (one thread per joint of the colour) runs alignment, angle
// limit or swing, twist and the positional correction of all five joint
// types on its packed row; joint_velocities projects the velocities from the
// delta pose's change (one thread per body) and applies joint damping.
// Bound by launch latency and the dependent gathers of body rows, not by the
// arithmetic. An end with zero inverse mass and inertia is never written;
// proper colours write their ends directly; the overflow colour and the
// damping write increments to scratch and then one thread per body adds
// them in the fixed [a-sides..., b-sides...] order. No float atomics, so a
// rerun is bitwise identical. Every operation follows the plain version's
// order (the file is compiled with -fmad=false).
#include "common.cuh"

namespace {

enum { FIXED = 0, DISTANCE = 1, REVOLUTE = 2, PRISMATIC = 3, SPHERICAL = 4 };
enum {
  R1 = 0, R2 = 3, CD = 6, AXA = 9, AXB = 12, SECA = 15, SECB = 18, ROTD = 21, COMP = 25,
  LMIN = 29, LMAX = 30, LEN = 31, TMIN = 32, TMAX = 33, TEN = 34, LDAMP = 35, ADAMP = 36,
  IMA = 37, IMB = 38, IMVA = 39, IMVB = 42, IIA = 45, IIB = 51, JD = 57, LAM = 6
};
constexpr int kStateCols = 13;
constexpr float kPi = 3.14159265358979f;
constexpr float kTwoPi = 6.28318530717958f;
// The plain version squares pi in double before the f32 compare.
constexpr float kPiSq = 9.869604401089358f;

__device__ __forceinline__ V3 zero3() { return v3(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ Q4 from_scaled_axis(V3 v) {
  float angle_sq = dot(v, v);
  float angle = sqrtf(clamp_min(angle_sq, 1e-30f));
  bool small = angle_sq < 1e-12f;
  float half = 0.5f * angle;
  float s = small ? 0.5f - angle_sq / 48.0f : sinf(half) / angle;
  float w = small ? 1.0f - angle_sq / 8.0f : cosf(half);
  return Q4{v.x * s, v.y * s, v.z * s, w};
}

__device__ __forceinline__ Q4 from_axis_angle(V3 axis, float angle) {
  float half = 0.5f * angle;
  float s = sinf(half);
  return Q4{axis.x * s, axis.y * s, axis.z * s, cosf(half)};
}

__device__ __forceinline__ V3 normalize_or(V3 a, V3 fallback) {
  float n2 = dot(a, a);
  bool ok = n2 > 1e-12f;
  float inv = ok ? 1.0f / sqrtf(clamp_min(n2, 1e-12f)) : 0.0f;
  return ok ? a * inv : fallback;
}

__device__ __forceinline__ V3 clamp_length_max(V3 a, float max_len, float max2) {
  float n2 = dot(a, a);
  float scale = n2 > max2 ? max_len / sqrtf(clamp_min(n2, 1e-12f)) : 1.0f;
  return a * scale;
}

struct Angular {
  V3 rv_a, rv_b, imp;
};

__device__ __forceinline__ Angular angular_correction(const float* d, V3 diff, float compliance,
                                                      float hh, bool active) {
  float angle = length(diff);
  bool ok = active && angle > 1e-9f;
  float m = clamp_min(angle, 1e-9f);
  V3 axis = v3(diff.x / m, diff.y / m, diff.z / m);
  float w1 = dot(axis, sym_mv(d + IIA, axis));
  float w2 = dot(axis, sym_mv(d + IIB, axis));
  float w_sum = w1 + w2;
  float tilde = compliance / hh;
  float dl = (ok && w_sum > 1e-12f) ? -angle / clamp_min(w_sum + tilde, 1e-12f) : 0.0f;
  V3 imp = axis * -dl;
  return Angular{sym_mv(d + IIA, imp), -sym_mv(d + IIB, imp), imp};
}

__device__ __forceinline__ V3 angle_limit(V3 limit_axis, V3 axis1, V3 axis2, float lo, float hi,
                                          bool enabled, bool& violated) {
  float sphi = dot(cross(axis1, axis2), limit_axis);
  sphi = isnan(sphi) ? sphi : fminf(fmaxf(sphi, -1.0f), 1.0f);
  float phi = asinf(sphi);
  if (dot(axis1, axis2) < 0.0f) phi = kPi - phi;
  if (phi > kPi) phi = phi - kTwoPi;
  violated = enabled && (phi < lo || phi > hi);
  // torch.minimum(torch.maximum(phi, lo), hi), NaN-propagating.
  float phi_t = phi;
  if (!isnan(phi_t)) phi_t = isnan(lo) ? lo : (phi_t > lo ? phi_t : lo);
  if (!isnan(phi_t)) phi_t = isnan(hi) ? hi : (phi_t < hi ? phi_t : hi);
  Q4 rot = from_axis_angle(limit_axis, phi_t);
  V3 corr = clamp_length_max(cross(rotate(rot, axis1), axis2), kPi, kPiSq);
  return violated ? corr : zero3();
}

struct Increments {
  V3 dp_a, dp_b, rv_a, rv_b, tot_pos, tot_rot;
};

__device__ Increments joint_increments(const float* d, int t, V3 dp_a, V3 dp_b, Q4 dq_a, Q4 dq_b,
                                       const float* lam, float hh) {
  bool is_fixed = t == FIXED, is_distance = t == DISTANCE, is_revolute = t == REVOLUTE;
  bool is_prismatic = t == PRISMATIC, is_spherical = t == SPHERICAL;
  const V3 x_axis = v3(1.0f, 0.0f, 0.0f);
  V3 acc_dp_a = zero3(), acc_dp_b = zero3(), acc_rv_a = zero3(), acc_rv_b = zero3();
  V3 tot_pos = load3(lam), tot_rot = load3(lam + 3);
  float lmin = d[LMIN], lmax = d[LMAX];
  bool len = d[LEN] > 0.0f;
  V3 axa = load3(d + AXA), axb = load3(d + AXB), seca = load3(d + SECA), secb = load3(d + SECB);

  auto add = [&](bool c, const Angular& a) {
    acc_rv_a = acc_rv_a + sel(c, a.rv_a, zero3());
    acc_rv_b = acc_rv_b + sel(c, a.rv_b, zero3());
    tot_rot = tot_rot + sel(c, a.imp, zero3());
  };

  // 1. Alignment.
  Q4 qd_a = qmul(from_scaled_axis(acc_rv_a), dq_a);
  Q4 qd_b = qmul(from_scaled_axis(acc_rv_b), dq_b);
  Q4 fq = qmul(qmul(load4(d + ROTD), qd_a), conj(qd_b));
  V3 full = v3(fq.x * -2.0f, fq.y * -2.0f, fq.z * -2.0f);
  V3 a1 = rotate(qd_a, axa), a2 = rotate(qd_b, axb);
  V3 hinge = cross(a1, a2);
  V3 diff = (is_fixed || is_prismatic) ? full : (is_revolute ? hinge : zero3());
  bool on = is_fixed || is_prismatic || is_revolute;
  add(on, angular_correction(d, diff, d[COMP + 1], hh, on));

  // 2. Angle limits about the hinge (revolute) and swing (spherical).
  qd_a = qmul(from_scaled_axis(acc_rv_a), dq_a);
  qd_b = qmul(from_scaled_axis(acc_rv_b), dq_b);
  a1 = rotate(qd_a, axa);
  a2 = rotate(qd_b, axb);
  V3 b1 = rotate(qd_a, seca), b2 = rotate(qd_b, secb);
  bool viol_rev, viol_sph;
  V3 corr_rev = angle_limit(a1, b1, b2, lmin, lmax, len, viol_rev);
  V3 n_sw = normalize_or(cross(a1, a2), x_axis);
  V3 corr_sph = angle_limit(n_sw, a1, a2, lmin, lmax, len, viol_sph);
  V3 corr = is_revolute ? corr_rev : (is_spherical ? corr_sph : zero3());
  on = (is_revolute && viol_rev) || (is_spherical && viol_sph);
  add(on, angular_correction(d, corr, d[COMP + 2], hh, on));

  // 2b. Spherical twist.
  qd_a = qmul(from_scaled_axis(acc_rv_a), dq_a);
  qd_b = qmul(from_scaled_axis(acc_rv_b), dq_b);
  a1 = rotate(qd_a, axa);
  a2 = rotate(qd_b, axb);
  b1 = rotate(qd_a, seca);
  b2 = rotate(qd_b, secb);
  V3 n_tw = normalize_or(a1 + a2, x_axis);
  V3 n1 = normalize_or(b1 - n_tw * dot(n_tw, b1), x_axis);
  V3 n2 = normalize_or(b2 - n_tw * dot(n_tw, b2), x_axis);
  bool viol_tw;
  V3 corr_tw = angle_limit(n_tw, n1, n2, d[TMIN], d[TMAX], d[TEN] > 0.0f, viol_tw);
  on = is_spherical && viol_tw;
  add(on, angular_correction(d, on ? corr_tw : zero3(), d[COMP + 3], hh, on));

  // 3. Positional correction.
  qd_a = qmul(from_scaled_axis(acc_rv_a), dq_a);
  qd_b = qmul(from_scaled_axis(acc_rv_b), dq_b);
  V3 r1 = rotate(qd_a, load3(d + R1));
  V3 r2 = rotate(qd_b, load3(d + R2));
  V3 sep = (((dp_b + acc_dp_b) - (dp_a + acc_dp_a)) + (r2 - r1)) + load3(d + CD);
  float dist = length(sep);
  float dm = clamp_min(dist, 1e-9f);
  V3 dir = v3(sep.x / dm, sep.y / dm, sep.z / dm);
  V3 dist_corr = dist < lmin ? (-dir) * (lmin - dist)
                             : (dist > lmax ? dir * (dist - lmax) : zero3());
  V3 axis1 = rotate(qd_a, axa);
  float along = dot(sep, axis1);
  V3 perp = sep - axis1 * along;
  float along_corr = (len && along < lmin) ? along - lmin
                                           : ((len && along > lmax) ? along - lmax : 0.0f);
  V3 pris_corr = perp + axis1 * along_corr;
  V3 correction = is_distance ? dist_corr : (is_prismatic ? pris_corr : sep);
  V3 w_r1 = rotate(from_scaled_axis(acc_rv_a), load3(d + R1));
  V3 w_r2 = rotate(from_scaled_axis(acc_rv_b), load3(d + R2));
  float c = length(correction);
  bool ok = c > 1e-9f;
  float cm = clamp_min(c, 1e-9f);
  V3 ndir = -correction;
  ndir = v3(ndir.x / cm, ndir.y / cm, ndir.z / cm);
  r1 = rotate(qd_a, w_r1);
  r2 = rotate(qd_b, w_r2);
  V3 r1xn = cross(r1, ndir), r2xn = cross(r2, ndir);
  float w1 = d[IMA] + dot(r1xn, sym_mv(d + IIA, r1xn));
  float w2 = d[IMB] + dot(r2xn, sym_mv(d + IIB, r2xn));
  float w_sum = w1 + w2;
  float tilde = d[COMP] / hh;
  float dl = (ok && w_sum > 1e-12f) ? -c / clamp_min(w_sum + tilde, 1e-12f) : 0.0f;
  V3 imp = ndir * dl;
  acc_dp_a = acc_dp_a + mulv(imp, load3(d + IMVA));
  acc_dp_b = acc_dp_b + mulv(-imp, load3(d + IMVB));
  acc_rv_a = acc_rv_a + sym_mv(d + IIA, cross(r1, imp));
  acc_rv_b = acc_rv_b + -sym_mv(d + IIB, cross(r2, imp));
  tot_pos = tot_pos + imp;
  return Increments{acc_dp_a, acc_dp_b, acc_rv_a, acc_rv_b, tot_pos, tot_rot};
}

__device__ __forceinline__ bool writes(const float* im, const float* ii) {
  bool w = false;
  for (int k = 0; k < 3; ++k) w = w || im[k] != 0.0f;
  for (int k = 0; k < 6; ++k) w = w || ii[k] != 0.0f;
  return w;
}

__device__ __forceinline__ void apply_pose(float* s, V3 dp, V3 rv) {
  store3(s + 6, load3(s + 6) + dp);
  Q4 q = qmul(from_scaled_axis(zero3() + rv), load4(s + 9));
  s[9] = q.x;
  s[10] = q.y;
  s[11] = q.z;
  s[12] = q.w;
}

__global__ void joint_color_kernel(int color, int last, int j_n, float* __restrict__ state,
                                   const float* __restrict__ data, float* __restrict__ lam,
                                   const int* __restrict__ jtype, const int* __restrict__ body_a,
                                   const int* __restrict__ body_b, const int* __restrict__ jcolor,
                                   const float* __restrict__ mask, float* __restrict__ scratch,
                                   float hh) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= j_n || jcolor[j] != color || !(mask[j] > 0.0f)) return;
  const float* d = data + (long)j * JD;
  float* sa = state + (long)body_a[j] * kStateCols;
  float* sb = state + (long)body_b[j] * kStateCols;
  float* l = lam + (long)j * LAM;
  Increments inc = joint_increments(d, jtype[j], load3(sa + 6), load3(sb + 6), load4(sa + 9),
                                    load4(sb + 9), l, hh);
  store3(l, inc.tot_pos);
  store3(l + 3, inc.tot_rot);
  if (last) {
    float* s0 = scratch + 6 * (long)j;
    float* s1 = scratch + 6 * ((long)j_n + j);
    store3(s0, inc.dp_a);
    store3(s0 + 3, inc.rv_a);
    store3(s1, inc.dp_b);
    store3(s1 + 3, inc.rv_b);
  } else {
    if (writes(d + IMVA, d + IIA)) apply_pose(sa, inc.dp_a, inc.rv_a);
    if (writes(d + IMVB, d + IIB)) apply_pose(sb, inc.dp_b, inc.rv_b);
  }
}

// Phase 2 of the overflow colour: per body, its joints' increments in order,
// then one rotation by the summed rotation vector.
__global__ void joint_overflow_kernel(int entries, int n_bodies, float* __restrict__ state,
                                      const int* __restrict__ order, const int* __restrict__ key,
                                      const float* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  int body = key[i];
  if (body >= n_bodies || (i > 0 && key[i - 1] == body)) return;
  float* s = state + (long)body * kStateCols;
  V3 dp = load3(s + 6), rv = zero3();
  for (int k = i; k < entries && key[k] == body; ++k) {
    const float* src = scratch + 6 * (long)order[k];
    dp = dp + load3(src);
    rv = rv + load3(src + 3);
  }
  store3(s + 6, dp);
  Q4 q = qmul(from_scaled_axis(rv), load4(s + 9));
  s[9] = q.x;
  s[10] = q.y;
  s[11] = q.z;
  s[12] = q.w;
}

// Velocity projection from the delta pose's change since `pre`.
__global__ void joint_project_kernel(int n_bodies, float* __restrict__ state,
                                     const float* __restrict__ pre, float h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_bodies) return;
  float* s = state + (long)i * kStateCols;
  const float* p = pre + (long)i * 7;
  V3 dl = load3(s + 6) - load3(p);
  V3 new_lin = v3(dl.x / h, dl.y / h, dl.z / h);
  Q4 dq = qmul(load4(s + 9), conj(load4(p + 3)));
  V3 new_ang = v3((dq.x * 2.0f) / h, (dq.y * 2.0f) / h, (dq.z * 2.0f) / h);
  if (dq.w < 0.0f) new_ang = -new_ang;
  store3(s, load3(s) + new_lin);
  store3(s + 3, load3(s + 3) + new_ang);
}

// Joint damping, phase 1: each joint's velocity increments to scratch.
__global__ void joint_damp_kernel(int j_n, const float* __restrict__ state,
                                  const float* __restrict__ data, const int* __restrict__ body_a,
                                  const int* __restrict__ body_b, const float* __restrict__ mask,
                                  float* __restrict__ scratch, float h) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= j_n || !(mask[j] > 0.0f)) return;
  const float* d = data + (long)j * JD;
  const float* sa = state + (long)body_a[j] * kStateCols;
  const float* sb = state + (long)body_b[j] * kStateCols;
  V3 va = load3(sa), wa = load3(sa + 3), vb = load3(sb), wb = load3(sb + 3);
  float ka = d[ADAMP] * h, kl = d[LDAMP] * h;
  ka = ka > 1.0f ? 1.0f : ka;
  kl = kl > 1.0f ? 1.0f : kl;
  V3 delta_omega = (wb - wa) * ka;
  V3 delta_v = (vb - va) * kl;
  float w1 = d[IMA], w2 = d[IMB];
  float ws = w1 + w2;
  float recip = ws != 0.0f ? 1.0f / ws : 0.0f;
  V3 p = delta_v * recip;
  bool resp_a = false, resp_b = false;
  for (int k = 0; k < 6; ++k) {
    resp_a = resp_a || d[IIA + k] != 0.0f;
    resp_b = resp_b || d[IIB + k] != 0.0f;
  }
  float* s0 = scratch + 6 * (long)j;
  float* s1 = scratch + 6 * ((long)j_n + j);
  store3(s0, p * w1);
  store3(s0 + 3, resp_a ? delta_omega : zero3());
  store3(s1, (-p) * w2);
  store3(s1 + 3, resp_b ? -delta_omega : zero3());
}

// Joint damping, phase 2: per body, its joints' increments in order.
__global__ void joint_damp_reduce_kernel(int entries, int n_bodies, float* __restrict__ state,
                                         const int* __restrict__ order,
                                         const int* __restrict__ key,
                                         const float* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  int body = key[i];
  if (body >= n_bodies || (i > 0 && key[i - 1] == body)) return;
  float* s = state + (long)body * kStateCols;
  V3 lin = load3(s), ang = load3(s + 3);
  for (int k = i; k < entries && key[k] == body; ++k) {
    const float* src = scratch + 6 * (long)order[k];
    lin = lin + load3(src);
    ang = ang + load3(src + 3);
  }
  store3(s, lin);
  store3(s + 3, ang);
}

int blocks(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

extern "C" int avian_joint_color(int color, int last, int j_n, int n_bodies, float* state,
                                 const float* data, float* lam, const int* jtype,
                                 const int* body_a, const int* body_b, const int* jcolor,
                                 const float* mask, const int* ovf_order, const int* ovf_key,
                                 float* scratch, float hh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  joint_color_kernel<<<blocks(j_n, threads), threads, 0, s>>>(
      color, last, j_n, state, data, lam, jtype, body_a, body_b, jcolor, mask, scratch, hh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  joint_overflow_kernel<<<blocks(2 * j_n, threads), threads, 0, s>>>(
      2 * j_n, n_bodies, state, ovf_order, ovf_key, scratch);
  return (int)cudaGetLastError();
}

extern "C" int avian_joint_velocities(int j_n, int n_bodies, float* state, const float* pre,
                                      const float* data, const int* body_a, const int* body_b,
                                      const float* mask, const int* damp_order,
                                      const int* damp_key, float* scratch, float h,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  joint_project_kernel<<<blocks(n_bodies, threads), threads, 0, s>>>(n_bodies, state, pre, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || j_n == 0) return (int)err;
  joint_damp_kernel<<<blocks(j_n, threads), threads, 0, s>>>(j_n, state, data, body_a, body_b,
                                                             mask, scratch, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  joint_damp_reduce_kernel<<<blocks(2 * j_n, threads), threads, 0, s>>>(
      2 * j_n, n_bodies, state, damp_order, damp_key, scratch);
  return (int)cudaGetLastError();
}

// Per-step joint rows (xpbd.py::prepare_joints, :89): one thread per joint.
namespace {

__global__ void joint_rows_kernel(
    int j_n, const int* __restrict__ body_a, const int* __restrict__ body_b,
    const unsigned char* __restrict__ active, const float* __restrict__ frame_pos_a,
    const float* __restrict__ frame_pos_b, const float* __restrict__ frame_quat_a,
    const float* __restrict__ frame_quat_b, const float* __restrict__ compliance,
    const float* __restrict__ limit_min, const float* __restrict__ limit_max,
    const unsigned char* __restrict__ limit_enabled, const float* __restrict__ twist_min,
    const float* __restrict__ twist_max, const unsigned char* __restrict__ twist_enabled,
    const float* __restrict__ lin_damping, const float* __restrict__ ang_damping,
    const float* __restrict__ pos, const float* __restrict__ quat, const float* __restrict__ com,
    const float* __restrict__ inv_mass, const float* __restrict__ inv_inertia,
    const float* __restrict__ solve_mask, float* __restrict__ data,
    unsigned char* __restrict__ mask, unsigned char* __restrict__ dyn_a_out,
    unsigned char* __restrict__ dyn_b_out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= j_n) return;
  long a = body_a[j], b = body_b[j];
  bool dyn_a = solve_mask[a] > 0.0f, dyn_b = solve_mask[b] > 0.0f;
  dyn_a_out[j] = dyn_a;
  dyn_b_out[j] = dyn_b;
  mask[j] = active[j] && (dyn_a || dyn_b);
  Q4 qa = load4(quat + 4 * a), qb = load4(quat + 4 * b);
  V3 ca = load3(com + 3 * a), cb = load3(com + 3 * b);
  V3 com_a = rotate(qa, ca), com_b = rotate(qb, cb);
  float* d = data + (long)j * JD;
  store3(d + R1, rotate(qa, load3(frame_pos_a + 3 * (long)j) - ca));
  store3(d + R2, rotate(qb, load3(frame_pos_b + 3 * (long)j) - cb));
  store3(d + CD, (load3(pos + 3 * b) - load3(pos + 3 * a)) + (com_b - com_a));
  Q4 basis_a = qmul(qa, load4(frame_quat_a + 4 * (long)j));
  Q4 basis_b = qmul(qb, load4(frame_quat_b + 4 * (long)j));
  const V3 z = v3(0.0f, 0.0f, 1.0f), x = v3(1.0f, 0.0f, 0.0f);
  store3(d + AXA, rotate(basis_a, z));
  store3(d + AXB, rotate(basis_b, z));
  store3(d + SECA, rotate(basis_a, x));
  store3(d + SECB, rotate(basis_b, x));
  Q4 rd = qmul(basis_a, conj(basis_b));
  d[ROTD] = rd.x;
  d[ROTD + 1] = rd.y;
  d[ROTD + 2] = rd.z;
  d[ROTD + 3] = rd.w;
  for (int k = 0; k < 4; ++k) d[COMP + k] = compliance[4 * (long)j + k];
  d[LMIN] = limit_min[j];
  d[LMAX] = limit_max[j];
  d[LEN] = limit_enabled[j] ? 1.0f : 0.0f;
  d[TMIN] = twist_min[j];
  d[TMAX] = twist_max[j];
  d[TEN] = twist_enabled[j] ? 1.0f : 0.0f;
  d[LDAMP] = lin_damping[j];
  d[ADAMP] = ang_damping[j];
  V3 ima = load3(inv_mass + 3 * a), imb = load3(inv_mass + 3 * b);
  d[IMA] = fmaxf(fmaxf(ima.x, ima.y), ima.z);
  d[IMB] = fmaxf(fmaxf(imb.x, imb.y), imb.z);
  store3(d + IMVA, ima);
  store3(d + IMVB, imb);
  for (int k = 0; k < 6; ++k) {
    d[IIA + k] = inv_inertia[6 * a + k];
    d[IIB + k] = inv_inertia[6 * b + k];
  }
}

}  // namespace

extern "C" int avian_joint_rows(
    int j_n, const int* body_a, const int* body_b, const unsigned char* active,
    const float* frame_pos_a, const float* frame_pos_b, const float* frame_quat_a,
    const float* frame_quat_b, const float* compliance, const float* limit_min,
    const float* limit_max, const unsigned char* limit_enabled, const float* twist_min,
    const float* twist_max, const unsigned char* twist_enabled, const float* lin_damping,
    const float* ang_damping, const float* pos, const float* quat, const float* com,
    const float* inv_mass, const float* inv_inertia, const float* solve_mask, float* data,
    unsigned char* mask, unsigned char* dyn_a, unsigned char* dyn_b, void* stream) {
  const int threads = 128;
  joint_rows_kernel<<<blocks(j_n, threads), threads, 0, (cudaStream_t)stream>>>(
      j_n, body_a, body_b, active, frame_pos_a, frame_pos_b, frame_quat_a, frame_quat_b,
      compliance, limit_min, limit_max, limit_enabled, twist_min, twist_max, twist_enabled,
      lin_damping, ang_damping, pos, quat, com, inv_mass, inv_inertia, solve_mask, data, mask,
      dyn_a, dyn_b);
  return (int)cudaGetLastError();
}
