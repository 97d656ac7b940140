// The kernels of user shapes (api/custom_shapes.py), as templates on the
// shape code K = 16 + i. kernels/custom_build.py writes the translation
// units that instantiate them: each unit includes this header, wraps each
// shape's CUDA source in a namespace of its own, specialises user_support,
// user_aabb and user_patch on its code (AVIAN_CUSTOM_SHAPE below), and ends
// with the extern "C" entry points over the world's instances. A user
// shape is thus one more specialisation of convex_pair.cuh's support<T> and
// patch<T>, compiled into the pair kernels, and never a call back into
// Python.
//
// - Kernel E's custom pass (custom_aabb_kernel) replaces the custom branch
//   of avian_tpu/geometry/shapes.py::local_aabb_half_extents (:55-67) inside
//   pipeline/broadphase.py::update_aabbs (:96): the device aabb_half_extents
//   rotated by |R| and expanded as Kernel E expands, written over E's rows of
//   the custom colliders before the cell keys are emitted. One thread a
//   collider, bound by bytes (some 150 a collider).
// - The custom instances of Kernels M, O and P (custom_pair_kernel,
//   custom_plane_kernel) replace geometry/convex.py's generic_convex_pair
//   (:468), support_patch_plane_pair (:702) and generic_convex_pair_aux (:881)
//   as geometry/narrowphase.py::_custom_entries (:407-449) routes a custom
//   shape's pairs: generic_pair<TA, 16 + i> against every built-in support
//   shape, a pool-backed convex shape and every custom shape j <= i, and
//   plane_patch<16 + i> against a half-space. One thread a pair; some 100
//   support calls a pair on 80 bytes in and 148 out, bound by operations
//   and latency, as M and P are.
// - Kernel AJ (ray_support_kernel) replaces queries/raycast.py::_ray_support
//   (:324) in the custom branch of _ray_one_collider (:372-420): sphere
//   tracing with the support plane's lower bound, the closest point from 12
//   Frank-Wolfe steps with the support as the linear minimisation. One thread
//   a (ray, custom collider); at most 24 marches of 14 support calls and 13
//   more, so it is bound by operations. A thread stops marching at its hit
//   (the reference's later rounds change nothing), and counts the support
//   calls it made into `work` where the caller asks.
// - Kernel AF's custom instance (custom_point_kernel) replaces the custom
//   branch of queries/point.py::_closest_local (:135-162): the working-set
//   Frank-Wolfe distance (24 steps) and, inside, the subgradient depth (20
//   steps) on the support map less the point. One thread a (point, custom
//   collider), 47 support calls, bound by operations.
//
// A custom shape's 7 parameter lanes reach support<K> and patch<K> through
// Pose::hv, which only a pool-backed convex shape uses otherwise. The
// arithmetic is the plain versions' (kernels/custom_shapes.py,
// geometry/convex.py) operation by operation, compiled without fused
// multiply-adds; with a device source that does the torch function's
// operations in the same order, the kernels are bit-equal to their plain
// versions.
#pragma once
#include "convex_pair.cuh"

namespace {

// core/types.py's CUSTOM_SHAPE_BASE, which the generated unit defines.
constexpr int kCustomBase = AVIAN_CUSTOM_SHAPE_BASE;
constexpr int kRayMarches = 24, kRaySteps = 12;
constexpr float kRayBig = 1e30f;

template <int K>
__device__ V3 user_support(const float* prm, V3 d);
template <int K>
__device__ V3 user_aabb(const float* prm);
template <int K>
__device__ int user_patch(const float* prm, V3 d, V3* pts, V3& nf);

// api/custom_shapes.py::point_patch: the support point along the unit
// direction, 8 times, the direction as the normal.
template <int K>
__device__ __forceinline__ int point_patch(const float* prm, V3 d, V3* pts, V3& nf) {
  V3 dn = nrm(d);
  V3 s = user_support<K>(prm, dn);
  for (int k = 0; k < kPatch; ++k) pts[k] = s;
  nf = dn;
  return 1;
}

// A side of a pair from 8-lane-free params of stride 7: a custom shape reads
// its lanes through hv, a pool-backed convex shape its vertices.
template <int T>
__device__ __forceinline__ Pose custom_side(const float* p, const float* q, const float* prm,
                                            const float* pool) {
  Pose s = load_pose7<T>(p, q, prm, pool);
  if (T >= kCustomBase) s.hv = prm;
  return s;
}

// ---- Kernel E's custom pass --------------------------------------------------

template <int K>
__global__ void custom_aabb_kernel(int n, const int* __restrict__ cols,
                                   const int* __restrict__ body_idx,
                                   const float* __restrict__ params,
                                   const float* __restrict__ spec_margin,
                                   const float* __restrict__ coll_margin,
                                   const float* __restrict__ body_lin_vel,
                                   const float* __restrict__ pos, const float* __restrict__ quat,
                                   float dt, float spec_default, float tol,
                                   float* __restrict__ aabb_min, float* __restrict__ aabb_max) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  int i = cols[k];
  V3 h = user_aabb<K>(params + 8 * i);
  Q4 q = load4(quat + 4 * i);
  V3 p = load3(pos + 3 * i);
  float x2 = q.x + q.x, y2 = q.y + q.y, z2 = q.z + q.z;
  float xx = q.x * x2, yy = q.y * y2, zz = q.z * z2;
  float xy = q.x * y2, xz = q.x * z2, yz = q.y * z2;
  float wx = q.w * x2, wy = q.w * y2, wz = q.w * z2;
  float m00 = fabsf(1.0f - (yy + zz)), m01 = fabsf(xy - wz), m02 = fabsf(xz + wy);
  float m10 = fabsf(xy + wz), m11 = fabsf(1.0f - (xx + zz)), m12 = fabsf(yz - wx);
  float m20 = fabsf(xz - wy), m21 = fabsf(yz + wx), m22 = fabsf(1.0f - (xx + yy));
  V3 wh = v3(m00 * h.x + m01 * h.y + m02 * h.z, m10 * h.x + m11 * h.y + m12 * h.z,
             m20 * h.x + m21 * h.y + m22 * h.z);
  V3 v = load3(body_lin_vel + 3 * body_idx[i]);
  float speed = sqrtf(dot(v, v));
  float spec = spec_margin[i];
  spec = spec > spec_default ? spec_default : spec;
  float travel = speed * dt;
  float e = (travel < spec ? travel : spec) + coll_margin[i] + tol;
  V3 lo = p - wh, hi = p + wh;
  store3(aabb_min + 3 * i, v3(lo.x - e, lo.y - e, lo.z - e));
  store3(aabb_max + 3 * i, v3(hi.x + e, hi.y + e, hi.z + e));
}

// ---- the custom instances of Kernels M, P (pair) and O (plane) ----------------

template <int TA, int TB>
__global__ void custom_pair_kernel(int n, const float* __restrict__ pa,
                                   const float* __restrict__ qa, const float* __restrict__ prm_a,
                                   const float* __restrict__ pb, const float* __restrict__ qb,
                                   const float* __restrict__ prm_b, float* __restrict__ normal,
                                   float* __restrict__ point_a, float* __restrict__ point_b,
                                   float* __restrict__ sep, int* __restrict__ fid,
                                   int* __restrict__ count, const float* __restrict__ disc,
                                   const float* __restrict__ pool) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Disc t = load_disc(disc);
  Pose A = custom_side<TA>(pa + 3 * i, qa + 4 * i, prm_a + 7 * i, pool);
  Pose B = custom_side<TB>(pb + 3 * i, qb + 4 * i, prm_b + 7 * i, pool);
  Out o;
  generic_pair<TA, TB>(A, B, t, o);
  store(o, i, normal, point_a, point_b, sep, fid, count);
}

// Half-space A (its local normal in the first three lanes) against custom B.
template <int K>
__global__ void custom_plane_kernel(int n, const float* __restrict__ pa,
                                    const float* __restrict__ qa, const float* __restrict__ na,
                                    const float* __restrict__ pb, const float* __restrict__ qb,
                                    const float* __restrict__ prm_b, float* __restrict__ normal,
                                    float* __restrict__ point_a, float* __restrict__ point_b,
                                    float* __restrict__ sep, int* __restrict__ fid,
                                    int* __restrict__ count, const float* __restrict__ disc,
                                    const float* __restrict__ pool) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Disc t = load_disc(disc);
  V3 n_plane = rotate(load4(qa + 4 * i), load3(na + 7 * i));
  Pose B = custom_side<K>(pb + 3 * i, qb + 4 * i, prm_b + 7 * i, pool);
  Out o;
  plane_patch<K>(load3(pa + 3 * i), n_plane, B, t, o);
  store(o, i, normal, point_a, point_b, sep, fid, count);
}

// ---- Kernel AJ ------------------------------------------------------------------

// The closest point to p: 12 Frank-Wolfe steps from the support along the
// ray, the support against the gradient as the linear minimisation.
template <int K>
__device__ V3 ray_closest(const float* prm, V3 d, V3 p, unsigned& calls) {
  V3 x = user_support<K>(prm, d);
  for (int it = 0; it < kRaySteps; ++it) {
    V3 g = x - p;
    V3 sball = user_support<K>(prm, -g);
    V3 dxs = x - sball;
    float gamma = __fdiv_rn(dot(g, dxs), fmaxf(dot(dxs, dxs), 1e-12f));
    gamma = fminf(fmaxf(gamma, 0.0f), 1.0f);
    x = x - gamma * dxs;
  }
  calls += kRaySteps + 1;
  return x;
}

template <int K>
__global__ void ray_support_kernel(int n, int n_rays, int m, const int* __restrict__ cols,
                                   const float* __restrict__ rays, int solid,
                                   const float* __restrict__ pos, const float* __restrict__ quat,
                                   const float* __restrict__ params, float* __restrict__ t_out,
                                   float* __restrict__ n_out,
                                   unsigned long long* __restrict__ work) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * n_rays) return;
  int r = (int)(idx / n);
  int c = cols[idx - (long long)r * n];
  Q4 q = load4(quat + 4 * c);
  V3 o = rotate(conj(q), load3(rays + 6 * r) - load3(pos + 3 * c));
  V3 d = rotate(conj(q), load3(rays + 6 * r + 3));
  const float* prm = params + 8 * c;
  unsigned calls = 0;
  float t = 0.0f;
  bool done = false;
  V3 nl = -d;
  for (int it = 0; it < kRayMarches && !done; ++it) {
    V3 p = o + d * t;
    V3 x = ray_closest<K>(prm, d, p, calls);
    V3 u = nrm_or(p - x, -d);
    float lb = dot(u, p) - dot(user_support<K>(prm, u), u);
    ++calls;
    nl = u;
    if (lb < 1e-4f) done = true;
    else t = fminf(t + fmaxf(lb, 1e-5f), 1e6f);
  }
  t = done ? t : kRayBig;
  V3 off = ray_closest<K>(prm, d, o, calls) - o;
  if (sqrt_rn(dot(off, off)) < 1e-6f && solid) {
    t = 0.0f;
    nl = -d;
  }
  long long out = (long long)r * m + c;
  t_out[out] = t;
  store3(n_out + 3 * out, rotate(q, nl));
  if (work) atomicAdd(work, (unsigned long long)calls);
}

// ---- Kernel AF's custom instance ---------------------------------------------------

template <int K>
__device__ __forceinline__ V3 point_sk(const float* prm, V3 p, V3 u) {
  return user_support<K>(prm, u) - p;
}

template <int K>
__global__ void custom_point_kernel(int n, int p_n, int m, const int* __restrict__ cols,
                                    const float* __restrict__ points,
                                    const float* __restrict__ pos, const float* __restrict__ quat,
                                    const float* __restrict__ params, float* __restrict__ dist,
                                    float* __restrict__ closest_out,
                                    unsigned char* __restrict__ inside) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * p_n) return;
  int r = (int)(idx / n);
  int c = cols[idx - (long long)r * n];
  Q4 q = load4(quat + 4 * c);
  V3 cp = load3(pos + 3 * c);
  V3 p = rotate(conj(q), load3(points + 3 * r) - cp);
  const float* prm = params + 8 * c;
  // Frank-Wolfe distance from the support along +x.
  V3 x = point_sk<K>(prm, p, x_axis());
  V3 s_prev = point_sk<K>(prm, p, -x);
  for (int it = 0; it < kFwIters; ++it) {
    V3 s = point_sk<K>(prm, p, -x);
    x = closest_on_triangle(x, s, s_prev);
    s_prev = s;
  }
  float dd = sqrt_rn(dot(x, x));
  // Subgradient depth from the direction away from the closest point.
  V3 d = nrm_or(-x, v3(0.0f, 1.0f, 0.0f));
  V3 best_d = d;
  float best_v = dot(point_sk<K>(prm, p, d), d);
  for (int it = 0; it < kDepthIters; ++it) {
    V3 s = point_sk<K>(prm, p, d);
    float v = dot(s, d);
    if (v < best_v) {
      best_d = d;
      best_v = v;
    }
    V3 g = s - v * d;
    float step = __fdiv_rn(0.5f, sqrt_rn(1.0f + (float)it));
    d = nrm_or(d - step * g, d);
  }
  bool in = dd < 1e-5f;
  float dout = in ? -best_v : dd;
  V3 cl = in ? p + best_d * best_v : p + x;
  long long out = (long long)r * m + c;
  dist[out] = dout;
  store3(closest_out + 3 * out, cp + rotate(q, cl));
  inside[out] = dout < 0.0f ? 1 : 0;
}

template <typename Kern, typename... A>
__host__ int launch_1d(Kern kernel, long long total, int threads, void* stream, A... args) {
  if (total == 0) return 0;
  int blocks = (int)((total + threads - 1) / threads);
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// One custom shape's specialisations, after its source's namespace NS: the
// user functions on code K, and K as a shape of convex_pair.cuh.
#define AVIAN_CUSTOM_SHAPE(K, NS, PATCH_FN)                                           \
  namespace {                                                                         \
  template <>                                                                         \
  __device__ V3 user_support<K>(const float* prm, V3 d) {                             \
    return NS::support(prm, d);                                                       \
  }                                                                                   \
  template <>                                                                         \
  __device__ V3 user_aabb<K>(const float* prm) {                                      \
    return NS::aabb_half_extents(prm);                                                \
  }                                                                                   \
  template <>                                                                         \
  __device__ int user_patch<K>(const float* prm, V3 d, V3* pts, V3& nf) {             \
    return PATCH_FN(prm, d, pts, nf);                                                 \
  }                                                                                   \
  template <>                                                                         \
  __device__ V3 support<K>(const Pose& s, V3 d) {                                     \
    return user_support<K>(s.hv, d);                                                  \
  }                                                                                   \
  template <>                                                                         \
  __device__ void patch<K>(const Pose& s, V3 d, const Disc&, Patch& p) {              \
    p.cnt = user_patch<K>(s.hv, d, p.p, p.nf);                                        \
  }                                                                                   \
  }
