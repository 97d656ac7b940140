// Kernel AI: times of impact of pairs of shapes in linear relative motion,
// one thread per pair, templated on the pair's canonical shape types.
//
// Replaces avian_tpu/geometry/contact_query.py::time_of_impact (:81, loop
// :95-108): 16 rounds of conservative advancement of one pair (the rounds
// are an argument). Each round moves shape a to pos_a + rel * t, takes the
// pair's manifold (pair_dispatch.cuh: the device code of Kernels A, M, N, O,
// P and Q), and advances t by the smallest separation over the closing speed
// along the normal, dot(dirn, n) * |rel|, or by 2 max_t where the shapes do
// not close; t is clamped to max_t * 1.01. A pair stops once it has hit,
// since t then no longer moves. It writes (hit and t <= max_t, t), and where
// `rounds` is not null the rounds the pair ran.
//
// The caller buckets the pairs by canonical pair (type_a <= type_b after a
// swap), so a pair whose shape codes were swapped runs with the moving shape
// a as the kernel's side B: its pose is B's, its params B's, and the
// manifold's normal, which points from the canonical A to B, is negated to
// point from a to b before the closing speed reads it. The positions are
// never swapped back: only t leaves the kernel.
//
// This is not Kernel S with a unit direction: the reference moves a by
// rel * t, and rel * t is not dirn * (|rel| * t) in f32. The arithmetic is
// the plain version's (kernels/toi_pair.py) operation by operation, compiled
// without fused multiply-adds, with IEEE square roots and divisions.
#pragma once
#include "pair_dispatch.cuh"

namespace {

struct ToiTables {
  const int* type_a;   // [P] shape codes
  const int* type_b;   // [P]
  const float* pos_a;  // [P, 3]
  const float* quat_a; // [P, 4]
  const float* prm_a;  // [P, 8]
  const float* pos_b;  // [P, 3]
  const float* quat_b; // [P, 4]
  const float* prm_b;  // [P, 8]
  const float* rel;    // [P, 3] vel_a - vel_b
  const float* max_t;  // [P]
  const float* disc;   // [16] the patch disc's cos and sin
  const float* pool;   // [V, 3] the vertex pool
};

template <int TA, int TB>
__global__ void toi_pair_kernel(int n, int iters, const int* __restrict__ idx, ToiTables T,
                                unsigned char* __restrict__ hit_out, float* __restrict__ t_out,
                                int* __restrict__ rounds) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  int p = idx[k];
  bool swap = T.type_a[p] > T.type_b[p];
  Disc disc = load_disc(T.disc);
  V3 pa = load3(T.pos_a + 3 * p), pb = load3(T.pos_b + 3 * p);
  Q4 qa = load4(T.quat_a + 4 * p), qb = load4(T.quat_b + 4 * p);
  const float* prm_a = T.prm_a + 8 * p;
  const float* prm_b = T.prm_b + 8 * p;
  V3 rel = load3(T.rel + 3 * p);
  float max_t = T.max_t[p];
  float lim = max_t * 1.01f;
  float dist0 = sqrt_rn(dot(rel, rel));
  V3 dirn = nrm_or(rel, x_axis());

  float t = 0.0f;
  bool done = false;
  int ran = iters;
#pragma unroll 1
  for (int r = 0; r < iters; ++r) {
    V3 xa = pa + rel * t;
    Pose A = make_pose<TA>(swap ? pb : xa, swap ? qb : qa, swap ? prm_b : prm_a, T.pool);
    Pose B = make_pose<TB>(swap ? xa : pb, swap ? qa : qb, swap ? prm_a : prm_b, T.pool);
    Out o;
    pair_manifold<TA, TB>(A, B, disc, o);
    float sep = min_sep(o);
    V3 nab = swap ? -o.normal : o.normal;  // from a to b
    float approach = dot(dirn, nab) * dist0;
    bool hit = sep < 1e-4f;
    float step = approach > 1e-6f ? __fdiv_rn(sep, fmaxf(approach, 1e-6f)) : 2.0f * max_t;
    float new_t = (done || hit) ? t : t + fmaxf(step, 0.0f);
    t = fminf(new_t, lim);
    done = done || hit;
    if (done) {
      ran = r + 1;
      break;
    }
  }
  hit_out[p] = (done && t <= max_t) ? 1 : 0;
  t_out[p] = t;
  if (rounds) rounds[p] = ran;
}

// One launch of the instance of canonical pair (TA, TB).
template <int TA, int TB>
int launch_toi(int n, int iters, const int* idx, const ToiTables& T, unsigned char* hit_out,
               float* t_out, int* rounds, void* stream) {
  const int threads = 64;
  toi_pair_kernel<TA, TB><<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, iters, idx, T, hit_out, t_out, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// The body of a group's entry point (toi_pair_*.cu): `code` is type_a * 16 +
// type_b of the launch's canonical pair, one of PAIRS.
#define AVIAN_TOI_CASE(TA, TB) \
  case TA * 16 + TB:           \
    return launch_toi<TA, TB>(n, iters, idx, T, hit_out, t_out, rounds, stream);
#define AVIAN_TOI_BODY(PAIRS)                                                              \
  ToiTables T{type_a, type_b, pos_a, quat_a, prm_a, pos_b, quat_b, prm_b, rel, max_t, disc, \
              pool};                                                                        \
  if (n == 0) return 0;                                                                     \
  switch (code) {                                                                           \
    PAIRS(AVIAN_TOI_CASE)                                                                   \
    default:                                                                                \
      return (int)cudaErrorInvalidValue;                                                    \
  }
