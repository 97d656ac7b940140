// Kernel R: swept-CCD times of impact, one thread per (swept collider i,
// collider j) pair, templated on the pair's canonical shape types.
//
// Replaces the K x M grid of avian_tpu/pipeline/ccd.py::solve_swept_ccd (:40;
// toi_one :85, vs_other :97, body_fn :104): 8 rounds of conservative
// advancement in relative motion. Each round poses both colliders at t (their
// positions advanced along this step's delta positions, their rotations, in
// the nonlinear mode, along their accumulated rotations), evaluates the
// pair's manifold (pair_dispatch.cuh: the device code of Kernels A, M, N, O, P
// and Q), and advances t by the smallest separation over the closing speed
// along the normal plus both bodies' angular travel. A round is one manifold
// (up to some 15,000 dependent f32 operations for a support-map pair) on
// registers; the pair reads its two colliders' rows once, so the kernel is
// bound by operations and latency, not by bytes.
//
// Each thread writes min(TOI, 1) of its pair to toi[r * m + j] (the TOI where
// it hits, its last t where its rounds run out first, 1 where it is invalid)
// and, where `rounds` is not null, the rounds it ran (negated where a valid
// pair ran them all without a hit and t stayed below 1); the caller takes
// the row and body minima. A pair stops once it has hit (t no longer moves) or once
// t >= 1 (it can then only return a TOI >= 1, which the minimum with 1
// ignores); no other pair is culled. The pair j = i runs like any other and
// returns 1, since j = i is never valid: it cannot lower its row's minimum. A
// pair that touches at t = 0 (separation <= 1e-4) advances toward a depth
// of DEEPER x the larger inner radius (or 2e-4 past its depth at t = 0,
// where that is deeper) and hits within 1e-4 of it, as the others hit within
// 1e-4 of 0. That, and the last
// t of a pair whose rounds run out, depart from the reference, which drops
// the touching pairs and returns 1 for the others (kernels/swept_toi.py says
// why). The arithmetic is the plain version's (kernels/swept_toi.py)
// operation by operation, compiled without fused multiply-adds, with IEEE
// square roots and divisions; the nonlinear mode's sinf/cosf may differ from
// the plain version's by an ulp.
#pragma once
#include "pair_dispatch.cuh"

namespace {

constexpr int kToiRounds = 8;
constexpr float kDeeper = 0.5f;  // kernels/swept_toi.py::DEEPER

struct SweptTables {
  const float* pos0;      // [M, 3] collider positions at t = 0
  const float* quat0;     // [M, 4]
  const float* sweep;     // [M, 3] delta position of each collider's body
  const float* aa;        // [M, 3] scaled-axis rotation (0 in the linear mode)
  const float* ang;       // [M] angular travel bound
  const float* inner;     // [M] inner radius (pipeline/ccd.py::inner_radius)
  const float* params;    // [M, 8]
  const int* shape_type;  // [M]
  const int* body_idx;    // [M]
  const unsigned char* active;  // [M]
  const int* layer_m;     // [M] u32 bit patterns
  const int* layer_f;     // [M]
  const float* disc;      // [16] the patch disc's cos and sin
  const float* pool;      // [V, 3] the vertex pool
};

// quat.from_scaled_axis
__device__ __forceinline__ Q4 from_scaled_axis(V3 v) {
  float angle_sq = dot(v, v);
  float angle = sqrt_rn(fmaxf(angle_sq, 1e-30f));
  bool small = angle_sq < 1e-12f;
  float half = 0.5f * angle;
  float s = small ? 0.5f - __fdiv_rn(angle_sq, 48.0f) : __fdiv_rn(sinf(half), angle);
  float w = small ? 1.0f - __fdiv_rn(angle_sq, 8.0f) : cosf(half);
  return Q4{v.x * s, v.y * s, v.z * s, w};
}

template <int TA, int TB>
__global__ void swept_toi_kernel(int n, int m, const int* __restrict__ pairs,
                                 const int* __restrict__ swept, SweptTables T,
                                 float* __restrict__ toi, int* __restrict__ rounds) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int flat = pairs[p];
  int r = flat / m;
  int j = flat - r * m;
  int i = swept[r];
  bool swap = T.shape_type[i] > T.shape_type[j];
  Disc disc = load_disc(T.disc);
  V3 p_i = load3(T.pos0 + 3 * i), p_j = load3(T.pos0 + 3 * j);
  Q4 q_i0 = load4(T.quat0 + 4 * i), q_j0 = load4(T.quat0 + 4 * j);
  V3 s_i = load3(T.sweep + 3 * i), s_j = load3(T.sweep + 3 * j);
  V3 aa_i = load3(T.aa + 3 * i), aa_j = load3(T.aa + 3 * j);
  const float* prm_a = T.params + 8 * (swap ? j : i);
  const float* prm_b = T.params + 8 * (swap ? i : j);
  V3 d_rel = s_i - s_j;
  float dist = sqrt_rn(dot(d_rel, d_rel));
  V3 dirn = nrm_or(d_rel, x_axis());
  float ang = T.ang[i] + T.ang[j];
  float deeper = kDeeper * fmaxf(T.inner[i], T.inner[j]);

  float t = 0.0f, goal = 0.0f;
  bool touching = false;
  bool done = false;
  int ran = kToiRounds;
#pragma unroll 1
  for (int k = 0; k < kToiRounds; ++k) {
    Q4 qi = qmul(from_scaled_axis(aa_i * t), q_i0);
    Q4 qj = qmul(from_scaled_axis(aa_j * t), q_j0);
    V3 xi = p_i + s_i * t, xj = p_j + s_j * t;
    Pose A = make_pose<TA>(swap ? xj : xi, swap ? qj : qi, prm_a, T.pool);
    Pose B = make_pose<TB>(swap ? xi : xj, swap ? qi : qj, prm_b, T.pool);
    Out o;
    pair_manifold<TA, TB>(A, B, disc, o);
    float sep = min_sep(o);
    V3 nij = swap ? -o.normal : o.normal;  // from i to j
    if (k == 0) {
      touching = sep <= 1e-4f;
      goal = touching ? fminf(-deeper, sep - 2e-4f) : 0.0f;
    }
    float approach = dot(dirn, nij) * dist + ang;
    bool hit = sep < goal + 1e-4f;
    float step = approach > 1e-6f ? __fdiv_rn(sep - goal, fmaxf(approach, 1e-6f)) : 2.0f;
    float new_t = (done || hit) ? t : t + fmaxf(step, 0.0f);
    t = fminf(new_t, 1.5f);
    done = done || hit;
    if (done || t >= 1.0f) {
      ran = k + 1;
      break;
    }
  }
  bool layers_ok = (T.layer_m[i] & T.layer_f[j]) != 0 && (T.layer_m[j] & T.layer_f[i]) != 0;
  bool valid = j != i && T.active[j] != 0 && T.body_idx[j] != T.body_idx[i] && layers_ok;
  toi[flat] = valid ? fminf(t, 1.0f) : 1.0f;
  if (rounds) rounds[flat] = (valid && !done && t < 1.0f) ? -ran : ran;
}

// One launch of the instance of canonical pair (TA, TB).
template <int TA, int TB>
int launch_swept(int n, int m, const int* pairs, const int* swept, const SweptTables& T,
                 float* toi, int* rounds, void* stream) {
  const int threads = 64;
  swept_toi_kernel<TA, TB><<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, m, pairs, swept, T, toi, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// The body of a group's entry point (swept_toi_*.cu): `code` is type_a * 16 +
// type_b of the launch's canonical pair, one of PAIRS.
#define AVIAN_SWEPT_CASE(TA, TB) \
  case TA * 16 + TB:             \
    return launch_swept<TA, TB>(n, m, pairs, swept, T, toi, rounds, stream);
#define AVIAN_SWEPT_BODY(PAIRS)                                                            \
  SweptTables T{pos0, quat0, sweep, aa, ang, inner, params, shape_type, body_idx, active,  \
                layer_m, layer_f, disc, pool};                                              \
  if (n == 0) return 0;                                                                     \
  switch (code) {                                                                           \
    PAIRS(AVIAN_SWEPT_CASE)                                                                 \
    default:                                                                                \
      return (int)cudaErrorInvalidValue;                                                    \
  }
