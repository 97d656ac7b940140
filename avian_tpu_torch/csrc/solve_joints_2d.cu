// Kernel AA: the 2D engine's XPBD joint solver of one substep.
//
// Replaces avian_tpu/dim2/xpbd.py::prepare_joints (:71), _solve_color (:197)
// with _angular_correction (:129) and _positional_correction (:140), the
// velocity projection of solve_position_constraints (:186-190) and
// _joint_damping (:313); the per-thread work is d2::joint_row_2d,
// d2::joint_increments_2d and d2::joint_damping_2d in dim2.cuh. Kernel I's
// rules (solve_joints.cu): an end with zero inverse mass and inertia is never
// written; colours before the last share no dynamic body and write their
// ends directly; the overflow colour and the damping write increments to
// scratch, and then one thread per body adds them in the fixed
// [a-sides..., b-sides...] order. No float atomics, so a rerun is bitwise
// identical. Bound by launch latency and the dependent gathers of the two
// bodies' rows, not by the arithmetic (some 150 flops a joint).
#include "dim2.cuh"

namespace {

using d2::JD;
using d2::J_LAM;
using d2::STATE;

__global__ void joint_rows_2d_kernel(int j_n, d2::JointIn2 in, float* __restrict__ data,
                                     unsigned char* __restrict__ mask,
                                     unsigned char* __restrict__ dyn_a,
                                     unsigned char* __restrict__ dyn_b) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= j_n) return;
  d2::joint_row_2d(j, in, data + (long)j * JD, mask + j, dyn_a + j, dyn_b + j);
}

__global__ void joint_color_2d_kernel(int color, int last, int j_n, float* __restrict__ state,
                                      const float* __restrict__ data, float* __restrict__ lam,
                                      const int* __restrict__ jtype,
                                      const int* __restrict__ body_a,
                                      const int* __restrict__ body_b,
                                      const int* __restrict__ jcolor,
                                      const float* __restrict__ mask,
                                      float* __restrict__ scratch, float hh) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= j_n || jcolor[j] != color || !(mask[j] > 0.0f)) return;
  const float* d = data + (long)j * JD;
  float* sa = state + (long)body_a[j] * STATE;
  float* sb = state + (long)body_b[j] * STATE;
  float* l = lam + (long)j * J_LAM;
  d2::JointInc2 inc = d2::joint_increments_2d(d, jtype[j], d2::load2(sa + 3), d2::load2(sb + 3),
                                              sa[5], sb[5], l, hh);
  d2::store2(l, inc.tot_pos);
  l[2] = inc.tot_rot;
  if (last) {
    float* s0 = scratch + 3 * (long)j;
    float* s1 = scratch + 3 * ((long)j_n + j);
    d2::store2(s0, inc.dp_a);
    s0[2] = inc.th_a;
    d2::store2(s1, inc.dp_b);
    s1[2] = inc.th_b;
    return;
  }
  if (d2::writes2(d + d2::J_IMVA, d[d2::J_IIA])) {
    sa[3] = sa[3] + inc.dp_a.x;
    sa[4] = sa[4] + inc.dp_a.y;
    sa[5] = sa[5] + inc.th_a;
  }
  if (d2::writes2(d + d2::J_IMVB, d[d2::J_IIB])) {
    sb[3] = sb[3] + inc.dp_b.x;
    sb[4] = sb[4] + inc.dp_b.y;
    sb[5] = sb[5] + inc.th_b;
  }
}

// Per body, its entries' 3-float increments from scratch added in order to
// the state's columns col .. col + 2.
__global__ void ordered_add_2d_kernel(int entries, int n_bodies, int col,
                                      float* __restrict__ state, const int* __restrict__ order,
                                      const int* __restrict__ key,
                                      const float* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  int body = key[i];
  if (body >= n_bodies || (i > 0 && key[i - 1] == body)) return;
  float* s = state + (long)body * STATE + col;
  float v[3] = {s[0], s[1], s[2]};
  for (int k = i; k < entries && key[k] == body; ++k) {
    const float* src = scratch + 3 * (long)order[k];
    for (int c = 0; c < 3; ++c) v[c] = v[c] + src[c];
  }
  for (int c = 0; c < 3; ++c) s[c] = v[c];
}

// Velocity projection from the delta pose's change since `pre` (f32[N, 3]).
__global__ void joint_project_2d_kernel(int n_bodies, float* __restrict__ state,
                                        const float* __restrict__ pre, float h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_bodies) return;
  float* s = state + (long)i * STATE;
  const float* p = pre + 3 * (long)i;
  for (int c = 0; c < 3; ++c) s[c] = s[c] + (s[3 + c] - p[c]) / h;
}

__global__ void joint_damp_2d_kernel(int j_n, const float* __restrict__ state,
                                     const float* __restrict__ data,
                                     const int* __restrict__ body_a,
                                     const int* __restrict__ body_b,
                                     const float* __restrict__ mask, float* __restrict__ scratch,
                                     float h) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= j_n || !(mask[j] > 0.0f)) return;
  float out[6];
  d2::joint_damping_2d(data + (long)j * JD, state + (long)body_a[j] * STATE,
                       state + (long)body_b[j] * STATE, h, out);
  for (int c = 0; c < 3; ++c) {
    scratch[3 * (long)j + c] = out[c];
    scratch[3 * ((long)j_n + j) + c] = out[3 + c];
  }
}

int blocks(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

extern "C" int avian_joint_rows_2d(int j_n, const int* body_a, const int* body_b,
                                   const unsigned char* active, const float* anchor_a,
                                   const float* anchor_b, const float* axis_cs,
                                   const float* reference_angle, const float* compliance,
                                   const float* limit_min, const float* limit_max,
                                   const unsigned char* limit_enabled, const float* lin_damping,
                                   const float* ang_damping, const float* pos,
                                   const float* angle, const float* com, const float* body_cs,
                                   const float* inv_mass, const float* inv_inertia,
                                   const float* solve_mask, float* data, unsigned char* mask,
                                   unsigned char* dyn_a, unsigned char* dyn_b, void* stream) {
  d2::JointIn2 in{body_a, body_b, active, anchor_a, anchor_b, axis_cs, reference_angle,
                  compliance, limit_min, limit_max, limit_enabled, lin_damping, ang_damping,
                  pos, angle, com, body_cs, inv_mass, inv_inertia, solve_mask};
  const int threads = 128;
  joint_rows_2d_kernel<<<blocks(j_n, threads), threads, 0, (cudaStream_t)stream>>>(
      j_n, in, data, mask, dyn_a, dyn_b);
  return (int)cudaGetLastError();
}

extern "C" int avian_joint_color_2d(int color, int last, int j_n, int n_bodies, float* state,
                                    const float* data, float* lam, const int* jtype,
                                    const int* body_a, const int* body_b, const int* jcolor,
                                    const float* mask, const int* ovf_order, const int* ovf_key,
                                    float* scratch, float hh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  joint_color_2d_kernel<<<blocks(j_n, threads), threads, 0, s>>>(
      color, last, j_n, state, data, lam, jtype, body_a, body_b, jcolor, mask, scratch, hh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  ordered_add_2d_kernel<<<blocks(2 * j_n, threads), threads, 0, s>>>(
      2 * j_n, n_bodies, 3, state, ovf_order, ovf_key, scratch);
  return (int)cudaGetLastError();
}

extern "C" int avian_joint_velocities_2d(int j_n, int n_bodies, float* state, const float* pre,
                                         const float* data, const int* body_a,
                                         const int* body_b, const float* mask,
                                         const int* damp_order, const int* damp_key,
                                         float* scratch, float h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  joint_project_2d_kernel<<<blocks(n_bodies, threads), threads, 0, s>>>(n_bodies, state, pre, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || j_n == 0) return (int)err;
  joint_damp_2d_kernel<<<blocks(j_n, threads), threads, 0, s>>>(j_n, state, data, body_a, body_b,
                                                                mask, scratch, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ordered_add_2d_kernel<<<blocks(2 * j_n, threads), threads, 0, s>>>(
      2 * j_n, n_bodies, 0, state, damp_order, damp_key, scratch);
  return (int)cudaGetLastError();
}
