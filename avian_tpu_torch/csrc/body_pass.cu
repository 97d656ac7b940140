// Kernel K: the per-body passes at either end of the solver.
//
// Replaces avian_tpu/pipeline/solver_body.py::prepare (:85) and writeback
// (:117), integrator.py::pre_process_velocity_increments (:47) with Kernel
// C's per-step table, and the force clear of step.py. See
// kernels/body_pass.py. One thread per body; no gathers, nothing shared
// between bodies: bound by bytes. A flat world of several scenes
// (avian_tpu_torch/parallel) passes one gravity a scene: body i reads that of
// scene i / n_scene (a single world: n_scene = n, one gravity). Every sum follows the plain version's
// order and the file is compiled with -fmad=false, so the results are the
// plain version's to the bit.
//
// writeback_2d_kernel is the 2D engine's writeback (dim2/dynamics.py:80 and
// the force clear of dim2/step.py), d2::writeback_body_2d in dim2.cuh.
#include "dim2.cuh"

namespace {

constexpr int kStatic = 0, kDynamic = 1;
constexpr int kLockTX = 1, kLockTY = 2, kLockTZ = 4, kLockRX = 8, kLockRY = 16, kLockRZ = 32;

struct M3 {
  float m[3][3];
};

// quat_m.to_mat3.
__device__ __forceinline__ M3 to_mat3(Q4 q) {
  float x2 = q.x + q.x, y2 = q.y + q.y, z2 = q.z + q.z;
  float xx = q.x * x2, yy = q.y * y2, zz = q.z * z2;
  float xy = q.x * y2, xz = q.x * z2, yz = q.y * z2;
  float wx = q.w * x2, wy = q.w * y2, wz = q.w * z2;
  M3 r;
  r.m[0][0] = 1.0f - (yy + zz);
  r.m[0][1] = xy - wz;
  r.m[0][2] = xz + wy;
  r.m[1][0] = xy + wz;
  r.m[1][1] = 1.0f - (xx + zz);
  r.m[1][2] = yz - wx;
  r.m[2][0] = xz - wy;
  r.m[2][1] = yz + wx;
  r.m[2][2] = 1.0f - (xx + yy);
  return r;
}

// sym3.rotate: R S R^T as sym6 (xx, yy, zz, xy, xz, yz).
__device__ __forceinline__ void sym_rotate(const float* s, const M3& r, float* out) {
  float m[3][3] = {{s[0], s[3], s[4]}, {s[3], s[1], s[5]}, {s[4], s[5], s[2]}};
  float t[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      t[i][j] = r.m[i][0] * m[0][j] + r.m[i][1] * m[1][j] + r.m[i][2] * m[2][j];
  float o[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[i][j] = t[i][0] * r.m[j][0] + t[i][1] * r.m[j][1] + t[i][2] * r.m[j][2];
  out[0] = o[0][0];
  out[1] = o[1][1];
  out[2] = o[2][2];
  out[3] = o[0][1];
  out[4] = o[0][2];
  out[5] = o[1][2];
}

__device__ __forceinline__ float unlocked(int locks, int bit) { return (locks & bit) > 0 ? 0.0f : 1.0f; }

__global__ void prepare_bodies_kernel(
    int n, int n_scene, const int* __restrict__ body_type, const int* __restrict__ locked_axes,
    const unsigned char* __restrict__ active, const unsigned char* __restrict__ sleeping,
    const unsigned char* __restrict__ gyroscopic, const float* __restrict__ quat,
    const float* __restrict__ inv_inertia, const float* __restrict__ lin_vel,
    const float* __restrict__ ang_vel, const float* __restrict__ force,
    const float* __restrict__ torque, const float* __restrict__ const_force,
    const float* __restrict__ const_local_force, const float* __restrict__ const_torque,
    const float* __restrict__ const_local_torque, const float* __restrict__ const_lin_acc,
    const float* __restrict__ const_local_lin_acc, const float* __restrict__ const_ang_acc,
    const float* __restrict__ const_local_ang_acc, const float* __restrict__ inv_mass,
    const float* __restrict__ gravity_scale, const float* __restrict__ lin_damping,
    const float* __restrict__ ang_damping, const float* __restrict__ max_lin_speed,
    const float* __restrict__ max_ang_speed, const float* __restrict__ gravity,
    float* __restrict__ state, float* __restrict__ inv_mass_out,
    float* __restrict__ inv_inertia_out, float* __restrict__ solve_mask,
    float* __restrict__ table, float h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int type = body_type[i], locks = locked_axes[i];
  bool act = active[i], asleep = sleeping[i];
  bool dynamic = type == kDynamic;
  bool moving = act && !asleep && type != kStatic;
  bool responds = dynamic && moving;
  V3 tmask = v3(unlocked(locks, kLockTX), unlocked(locks, kLockTY), unlocked(locks, kLockTZ));
  V3 rmask = v3(unlocked(locks, kLockRX), unlocked(locks, kLockRY), unlocked(locks, kLockRZ));
  Q4 q = load4(quat + 4 * (long)i);
  const float* ii = inv_inertia + 6 * (long)i;
  float w_inv_i[6];
  sym_rotate(ii, to_mat3(q), w_inv_i);

  float im = inv_mass[i];
  V3 imv = v3(im * tmask.x, im * tmask.y, im * tmask.z);
  store3(inv_mass_out + 3 * (long)i, responds ? imv : v3(0.0f, 0.0f, 0.0f));
  float rm[6] = {rmask.x * rmask.x, rmask.y * rmask.y, rmask.z * rmask.z,
                 rmask.x * rmask.y, rmask.x * rmask.z, rmask.y * rmask.z};
  for (int k = 0; k < 6; ++k)
    inv_inertia_out[6 * (long)i + k] = responds ? w_inv_i[k] * rm[k] : 0.0f;
  solve_mask[i] = responds ? 1.0f : 0.0f;

  float* s = state + 13 * (long)i;
  V3 lv = load3(lin_vel + 3 * (long)i), av = load3(ang_vel + 3 * (long)i);
  store3(s, moving ? lv : v3(0.0f, 0.0f, 0.0f));
  store3(s + 3, moving ? av : v3(0.0f, 0.0f, 0.0f));
  store3(s + 6, v3(0.0f, 0.0f, 0.0f));
  s[9] = 0.0f;
  s[10] = 0.0f;
  s[11] = 0.0f;
  s[12] = 1.0f;

  // Velocity increments.
  long i3 = 3 * (long)i;
  V3 f = (load3(force + i3) + load3(const_force + i3)) + rotate(q, load3(const_local_force + i3));
  V3 g = load3(gravity + 3 * (long)(i / n_scene)) * gravity_scale[i];
  V3 lin_acc = ((g + f * im) + load3(const_lin_acc + i3)) + rotate(q, load3(const_local_lin_acc + i3));
  V3 tq = (load3(torque + i3) + load3(const_torque + i3)) + rotate(q, load3(const_local_torque + i3));
  V3 ang_acc = (sym_mv(w_inv_i, tq) + load3(const_ang_acc + i3)) +
               rotate(q, load3(const_local_ang_acc + i3));
  bool d1 = dynamic && act;
  float* t = table + 22 * (long)i;
  store3(t, d1 ? mulv(lin_acc, tmask) * h : v3(0.0f, 0.0f, 0.0f));
  store3(t + 3, d1 ? mulv(ang_acc, rmask) * h : v3(0.0f, 0.0f, 0.0f));
  t[6] = 1.0f / (1.0f + h * lin_damping[i]);
  t[7] = 1.0f / (1.0f + h * ang_damping[i]);
  t[8] = (d1 && !asleep) ? 1.0f : 0.0f;
  t[9] = gyroscopic[i] ? 1.0f : 0.0f;
  t[10] = q.x;
  t[11] = q.y;
  t[12] = q.z;
  t[13] = q.w;
  for (int k = 0; k < 6; ++k) t[14 + k] = ii[k];
  t[20] = max_lin_speed[i];
  t[21] = max_ang_speed[i];
}

__global__ void writeback_bodies_kernel(
    int n, const float* __restrict__ state, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ com,
    const float* __restrict__ lin_vel, const float* __restrict__ ang_vel,
    const unsigned char* __restrict__ active, const unsigned char* __restrict__ sleeping,
    const int* __restrict__ body_type, float* __restrict__ pos_out, float* __restrict__ quat_out,
    float* __restrict__ lin_out, float* __restrict__ ang_out, float* __restrict__ force_out,
    float* __restrict__ torque_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long i3 = 3 * (long)i, i4 = 4 * (long)i;
  const float* s = state + 13 * (long)i;
  bool moving = active[i] && !sleeping[i] && body_type[i] != kStatic;
  Q4 q = load4(quat + i4);
  V3 c = load3(com + i3);
  V3 old_com = rotate(q, c);
  Q4 nq = qmul(load4(s + 9), q);
  float n2 = ((nq.x * nq.x + nq.y * nq.y) + nq.z * nq.z) + nq.w * nq.w;
  float k = 0.5f * (3.0f - n2);
  nq = Q4{nq.x * k, nq.y * k, nq.z * k, nq.w * k};
  V3 new_com = rotate(nq, c);
  V3 p = load3(pos + i3);
  V3 np = ((p + load3(s + 6)) + old_com) - new_com;
  store3(pos_out + i3, moving ? np : p);
  Q4 oq = moving ? nq : q;
  quat_out[i4] = oq.x;
  quat_out[i4 + 1] = oq.y;
  quat_out[i4 + 2] = oq.z;
  quat_out[i4 + 3] = oq.w;
  store3(lin_out + i3, moving ? load3(s) : load3(lin_vel + i3));
  store3(ang_out + i3, moving ? load3(s + 3) : load3(ang_vel + i3));
  store3(force_out + i3, v3(0.0f, 0.0f, 0.0f));
  store3(torque_out + i3, v3(0.0f, 0.0f, 0.0f));
}

__global__ void writeback_2d_kernel(
    int n, const float* __restrict__ state, const float* __restrict__ pos,
    const float* __restrict__ angle, const float* __restrict__ com,
    const float* __restrict__ lin_vel, const float* __restrict__ ang_vel,
    const unsigned char* __restrict__ active, const unsigned char* __restrict__ sleeping,
    const int* __restrict__ body_type, float* __restrict__ pos_out, float* __restrict__ angle_out,
    float* __restrict__ lin_out, float* __restrict__ ang_out, float* __restrict__ force_out,
    float* __restrict__ torque_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long i2 = 2 * (long)i;
  const float* s = state + 6 * (long)i;
  d2::V2 p;
  float a;
  bool moving = d2::writeback_body_2d(body_type[i], active[i], sleeping[i], s,
                                      d2::load2(pos + i2), angle[i], d2::load2(com + i2), &p, &a);
  d2::store2(pos_out + i2, p);
  angle_out[i] = a;
  d2::store2(lin_out + i2, moving ? d2::load2(s) : d2::load2(lin_vel + i2));
  ang_out[i] = moving ? s[2] : ang_vel[i];
  d2::store2(force_out + i2, d2::v2(0.0f, 0.0f));
  torque_out[i] = 0.0f;
}

}  // namespace

extern "C" int avian_prepare_bodies(
    int n, int n_scene, const int* body_type, const int* locked_axes, const unsigned char* active,
    const unsigned char* sleeping, const unsigned char* gyroscopic, const float* quat,
    const float* inv_inertia, const float* lin_vel, const float* ang_vel, const float* force,
    const float* torque, const float* const_force, const float* const_local_force,
    const float* const_torque, const float* const_local_torque, const float* const_lin_acc,
    const float* const_local_lin_acc, const float* const_ang_acc,
    const float* const_local_ang_acc, const float* inv_mass, const float* gravity_scale,
    const float* lin_damping, const float* ang_damping, const float* max_lin_speed,
    const float* max_ang_speed, const float* gravity, float* state, float* inv_mass_out,
    float* inv_inertia_out, float* solve_mask, float* table, float h, void* stream) {
  const int threads = 128;
  prepare_bodies_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, n_scene, body_type, locked_axes, active, sleeping, gyroscopic, quat, inv_inertia, lin_vel,
      ang_vel, force, torque, const_force, const_local_force, const_torque, const_local_torque,
      const_lin_acc, const_local_lin_acc, const_ang_acc, const_local_ang_acc, inv_mass,
      gravity_scale, lin_damping, ang_damping, max_lin_speed, max_ang_speed, gravity, state,
      inv_mass_out, inv_inertia_out, solve_mask, table, h);
  return (int)cudaGetLastError();
}

extern "C" int avian_writeback_bodies(int n, const float* state, const float* pos,
                                      const float* quat, const float* com, const float* lin_vel,
                                      const float* ang_vel, const unsigned char* active,
                                      const unsigned char* sleeping, const int* body_type,
                                      float* pos_out, float* quat_out, float* lin_out,
                                      float* ang_out, float* force_out, float* torque_out,
                                      void* stream) {
  const int threads = 128;
  writeback_bodies_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, state, pos, quat, com, lin_vel, ang_vel, active, sleeping, body_type, pos_out, quat_out,
      lin_out, ang_out, force_out, torque_out);
  return (int)cudaGetLastError();
}

extern "C" int avian_writeback_2d(int n, const float* state, const float* pos, const float* angle,
                                  const float* com, const float* lin_vel, const float* ang_vel,
                                  const unsigned char* active, const unsigned char* sleeping,
                                  const int* body_type, float* pos_out, float* angle_out,
                                  float* lin_out, float* ang_out, float* force_out,
                                  float* torque_out, void* stream) {
  const int threads = 256;
  writeback_2d_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, state, pos, angle, com, lin_vel, ang_vel, active, sleeping, body_type, pos_out,
      angle_out, lin_out, ang_out, force_out, torque_out);
  return (int)cudaGetLastError();
}
