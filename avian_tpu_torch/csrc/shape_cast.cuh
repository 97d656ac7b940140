// Kernel S: shape casts, one thread per collider, templated on the canonical
// pair of (query shape, collider shape).
//
// Replaces the per-collider conservative advancement of
// avian_tpu/queries/shapecast.py::_sweep_all (:59, loop :92-121): 16 rounds,
// each the manifold of the query shape at origin + direction * t against the
// collider (pair_dispatch.cuh: the device code of Kernels A, M, N, O, P and
// Q), advancing t by the smallest separation over the closing speed along the
// normal, clamped to max_distance + 1; then one more manifold at t for the
// witness points (of the first smallest separation) and the normal. A round
// is one manifold on registers and the collider's row is read once, so the
// kernel is bound by operations and latency. A collider stops once it has
// hit, since t then no longer moves; where `rounds` is not null it gets the
// rounds each collider ran. The arithmetic is the plain version's
// (queries/shapecast.py) operation by operation (-fmad=false, IEEE sqrt and
// division).
//
// Overlap mode (`overlap` == 1, for avian_tpu/queries/intersect.py::
// shape_intersections :27, `one` :45) runs no round: one manifold of the query
// shape at its origin against the collider, and the flag count > 0 and
// smallest separation < 0 into hit_out, nothing else written. Manifold mode
// (`overlap` == 2, for avian_tpu/character/move_and_slide.py::depenetrate :57,
// `against` :77) runs the same one manifold and writes the smallest of its
// four separations into t_out and its normal, from the query shape to the
// collider, into n_out, nothing else. Both are more uses of the same
// instances, so they add nothing to the build.
//
// The query (20 floats): origin (3), rotation (4), unit direction (3), the
// shape's params padded to 8 lanes (a CONVEX query shape indexes the world's
// vertex pool through lanes 0 and 1), max_distance and max_distance + 1 (both
// rounded once to f32 on the host, as the reference's weakly typed Python
// floats are).
#pragma once
#include "pair_dispatch.cuh"

namespace {

constexpr int kCastRounds = 16;

template <int TA, int TB>
__device__ void cast_manifold(bool swap, V3 qp, Q4 qq, const float* qprm, V3 cp, Q4 cq,
                              const float* cprm, const float* pool, const Disc& disc, Out& o) {
  Pose A = make_pose<TA>(swap ? cp : qp, swap ? cq : qq, swap ? cprm : qprm, pool);
  Pose B = make_pose<TB>(swap ? qp : cp, swap ? qq : cq, swap ? qprm : cprm, pool);
  pair_manifold<TA, TB>(A, B, disc, o);
}

template <int TA, int TB>
__global__ void shape_cast_kernel(int n, int st, int overlap, const int* __restrict__ cols,
                                  const float* __restrict__ query, const float* __restrict__ pos,
                                  const float* __restrict__ quat,
                                  const float* __restrict__ params,
                                  const int* __restrict__ shape_type,
                                  const float* __restrict__ disc_tab,
                                  const float* __restrict__ pool, float* __restrict__ t_out,
                                  unsigned char* __restrict__ hit_out,
                                  float* __restrict__ pa_out, float* __restrict__ pb_out,
                                  float* __restrict__ n_out, int* __restrict__ rounds) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int c = cols[idx];
  bool swap = st > shape_type[c];
  Disc disc = load_disc(disc_tab);
  V3 o = load3(query), d = load3(query + 7);
  Q4 rot = load4(query + 3);
  const float* qprm = query + 10;
  float max_d = query[18], lim = query[19];
  V3 cp = load3(pos + 3 * c);
  Q4 cq = load4(quat + 4 * c);
  const float* cprm = params + 8 * c;

  float t = 0.0f;
  bool done = false;
  int ran = kCastRounds;
  Out m;
#pragma unroll 1
  for (int k = 0; k < (overlap ? 0 : kCastRounds); ++k) {
    cast_manifold<TA, TB>(swap, o + d * t, rot, qprm, cp, cq, cprm, pool, disc, m);
    float sep = min_sep(m);
    V3 nq = swap ? -m.normal : m.normal;  // from the query shape to the collider
    float approach = dot(d, nq);
    bool hit_now = sep < 1e-4f;
    float step = approach > 1e-6f ? __fdiv_rn(sep, fmaxf(approach, 1e-6f)) : 1e30f;
    float new_t = (done || hit_now) ? t : t + fmaxf(step, 0.0f);
    t = fminf(new_t, lim);
    done = done || hit_now;
    if (done) {
      ran = k + 1;
      break;
    }
  }
  cast_manifold<TA, TB>(swap, overlap ? o : o + d * t, rot, qprm, cp, cq, cprm, pool, disc, m);
  if (overlap == 1) {
    hit_out[c] = (m.count > 0 && min_sep(m) < 0.0f) ? 1 : 0;
    return;
  }
  if (overlap == 2) {
    t_out[c] = min_sep(m);
    store3(n_out + 3 * c, swap ? -m.normal : m.normal);
    return;
  }
  int pi = first_min_lane(m);
  t_out[c] = t;
  hit_out[c] = (done && t <= max_d) ? 1 : 0;
  store3(pa_out + 3 * c, swap ? m.pb[pi] : m.pa[pi]);
  store3(pb_out + 3 * c, swap ? m.pa[pi] : m.pb[pi]);
  store3(n_out + 3 * c, swap ? -m.normal : m.normal);
  if (rounds) rounds[c] = ran;
}

// One launch of the instance of canonical pair (TA, TB).
template <int TA, int TB>
int launch_cast(int n, int st, int overlap, const int* cols, const float* query, const float* pos,
                const float* quat, const float* params, const int* shape_type,
                const float* disc, const float* pool, float* t_out, unsigned char* hit_out,
                float* pa_out, float* pb_out, float* n_out, int* rounds, void* stream) {
  const int threads = 64;
  shape_cast_kernel<TA, TB><<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, st, overlap, cols, query, pos, quat, params, shape_type, disc, pool, t_out, hit_out,
      pa_out, pb_out, n_out, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// The body of a group's entry point (shape_cast_*.cu): `code` is type_a * 16 +
// type_b of the launch's canonical pair, one of PAIRS.
#define AVIAN_CAST_CASE(TA, TB)                                                           \
  case TA * 16 + TB:                                                                      \
    return launch_cast<TA, TB>(n, st, overlap, cols, query, pos, quat, params, shape_type, \
                               disc, pool, t_out, hit_out, pa_out, pb_out, n_out, rounds,  \
                               stream);
#define AVIAN_CAST_BODY(PAIRS)      \
  if (n == 0) return 0;             \
  switch (code) {                   \
    PAIRS(AVIAN_CAST_CASE)          \
    default:                        \
      return (int)cudaErrorInvalidValue; \
  }
