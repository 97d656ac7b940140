// Kernel Z: the 2D engine's substep integration, one thread a body.
//
// Replaces avian_tpu/dim2/dynamics.py::integrate_velocities (:141) with
// clamp_velocities (:160) (mode 0) and integrate_positions (:170) (mode 1):
// d2::integrate_body_2d in dim2.cuh, on the [N, 6] solver state with the
// per-body table of dim2/dynamics.py::integration_table. Elementwise; bound
// by bytes, and by launch latency at a few thousand bodies.
//
// The prologue, avian_prepare_2d, replaces dim2/dynamics.py::prepare (:46)
// and pre_process_velocity_increments (:111): d2::prepare_body_2d writes
// each body's solver row, masked inverse mass and inertia, solve mask and
// table row.
#include "dim2.cuh"

namespace {

__global__ void integrate_2d_kernel(int mode, int n, const float* __restrict__ state,
                                    const float* __restrict__ table, float* __restrict__ out,
                                    float h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  d2::integrate_body_2d(mode, state + d2::STATE * (long)i, table + d2::T_COLS * (long)i, h,
                        out + d2::STATE * (long)i);
}

__global__ void prepare_2d_kernel(
    int n, const int* __restrict__ body_type, const int* __restrict__ locked_axes,
    const unsigned char* __restrict__ active, const unsigned char* __restrict__ sleeping,
    const float* __restrict__ lin_vel, const float* __restrict__ force,
    const float* __restrict__ const_force, const float* __restrict__ ang_vel,
    const float* __restrict__ torque, const float* __restrict__ const_torque,
    const float* __restrict__ inv_mass, const float* __restrict__ inv_inertia,
    const float* __restrict__ gravity_scale, const float* __restrict__ lin_damping,
    const float* __restrict__ ang_damping, const float* __restrict__ max_lin_speed,
    const float* __restrict__ max_ang_speed, const float* __restrict__ gravity,
    float* __restrict__ state, float* __restrict__ inv_mass_out,
    float* __restrict__ inv_inertia_out, float* __restrict__ solve_mask,
    float* __restrict__ table, float h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long i2 = 2 * (long)i;
  d2::BodyIn2 b;
  b.type = body_type[i];
  b.locks = locked_axes[i];
  b.active = active[i];
  b.sleeping = sleeping[i];
  b.lin_vel = d2::load2(lin_vel + i2);
  b.force = d2::load2(force + i2);
  b.const_force = d2::load2(const_force + i2);
  b.gravity = d2::load2(gravity);
  b.ang_vel = ang_vel[i];
  b.torque = torque[i];
  b.const_torque = const_torque[i];
  b.inv_mass = inv_mass[i];
  b.inv_inertia = inv_inertia[i];
  b.gravity_scale = gravity_scale[i];
  b.lin_damping = lin_damping[i];
  b.ang_damping = ang_damping[i];
  b.max_lin = max_lin_speed[i];
  b.max_ang = max_ang_speed[i];
  d2::prepare_body_2d(b, h, state + d2::STATE * (long)i, inv_mass_out + i2, inv_inertia_out + i,
                      solve_mask + i, table + d2::T_COLS * (long)i);
}

}  // namespace

extern "C" int avian_prepare_2d(int n, const int* body_type, const int* locked_axes,
                                const unsigned char* active, const unsigned char* sleeping,
                                const float* lin_vel, const float* force,
                                const float* const_force, const float* ang_vel,
                                const float* torque, const float* const_torque,
                                const float* inv_mass, const float* inv_inertia,
                                const float* gravity_scale, const float* lin_damping,
                                const float* ang_damping, const float* max_lin_speed,
                                const float* max_ang_speed, const float* gravity, float* state,
                                float* inv_mass_out, float* inv_inertia_out, float* solve_mask,
                                float* table, float h, void* stream) {
  const int threads = 256;
  prepare_2d_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, body_type, locked_axes, active, sleeping, lin_vel, force, const_force, ang_vel, torque,
      const_torque, inv_mass, inv_inertia, gravity_scale, lin_damping, ang_damping,
      max_lin_speed, max_ang_speed, gravity, state, inv_mass_out, inv_inertia_out, solve_mask,
      table, h);
  return (int)cudaGetLastError();
}

extern "C" int avian_integrate_2d(int mode, int n, const float* state, const float* table,
                                  float* out, float h, void* stream) {
  const int threads = 256;
  integrate_2d_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      mode, n, state, table, out, h);
  return (int)cudaGetLastError();
}
