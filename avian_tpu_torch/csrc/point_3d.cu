// Kernel AF: point projections, one thread per (point, collider), templated
// on the collider's point kind.
//
// Replaces avian_tpu/queries/point.py::_closest_local (:17; the hull's
// avian_tpu/geometry/convex.py::closest_point_on_hull :768) as project_point
// (:167) and point_intersections (:198) run it on every collider under vmap:
// the point in the collider's frame, its signed distance (negative inside),
// the closest surface point back in world space, and an inside flag. The
// caller buckets colliders by kind, one instance per kind, so that a hull's
// vertex scans never diverge a warp of analytic shapes. An analytic shape is
// some 30-80 operations on its 60-byte row; the 17 bytes written a pair bound
// the kernel. A pool-backed hull runs the reference's 16 Frank-Wolfe steps
// over its own vertices (ray_cast.cuh's closest, read from the pool through
// L1), then the exact containment test of geometry/convex.py::hull_contains
// where the Frank-Wolfe point does not certify the point outside: a point
// inside the inner hull reports -radius, itself, and inside (the reference
// reports it outside, ROADMAP 3b).
//
// The arithmetic is the plain version's (kernels/point_3d.py) operation by
// operation, compiled without fused multiply-adds, with IEEE square roots and
// divisions, the first extremum on ties.
#include "ray_cast.cuh"

namespace {

constexpr int kSegment = 6, kPointMiss = 7;  // the other kinds are the shape codes
constexpr int kPointFwSteps = 16;
constexpr float kInsideTol = 1e-5f;  // convex.py::HULL_INSIDE_TOL

struct Proj {
  float d;
  V3 c;
  bool inside;
};

__device__ __forceinline__ V3 x_axis() { return v3(1.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float len(V3 a) { return sqrt_rn(dot(a, a)); }
// The reference's [0, 1, 0] * s, its zero products kept.
__device__ __forceinline__ V3 y_times(float s) { return v3(0.0f * s, 1.0f * s, 0.0f * s); }

__device__ Proj pt_sphere(V3 p, const float* prm) {
  float r = prm[0];
  float d = len(p) - r;
  return Proj{d, nrm_or(p, x_axis()) * r, d < 0.0f};
}

__device__ Proj pt_box(V3 p, const float* prm) {
  float h[3] = {prm[0], prm[1], prm[2]};
  float pa[3] = {p.x, p.y, p.z};
  float q[3], face[3];
  for (int a = 0; a < 3; ++a) {
    q[a] = clampf(pa[a], -h[a], h[a]);
    face[a] = h[a] - fabsf(pa[a]);
  }
  V3 qv = v3(q[0], q[1], q[2]);
  float outside = len(p - qv);
  int ax = 0;  // the first smallest face distance
  if (face[1] < face[ax]) ax = 1;
  if (face[2] < face[ax]) ax = 2;
  float qi[3] = {pa[0], pa[1], pa[2]};
  qi[ax] = (pa[ax] >= 0.0f ? 1.0f : -1.0f) * h[ax];
  bool is_out = outside > 0.0f;
  float d = is_out ? outside : -fminf(fminf(face[0], face[1]), face[2]);
  return Proj{d, is_out ? qv : v3(qi[0], qi[1], qi[2]), d < 0.0f};
}

__device__ Proj pt_capsule(V3 p, const float* prm) {
  float hh = prm[0], r = prm[1];
  V3 seg = y_times(clampf(p.y, -hh, hh));
  V3 delta = p - seg;
  float d = len(delta) - r;
  return Proj{d, seg + nrm_or(delta, x_axis()) * r, d < 0.0f};
}

__device__ Proj pt_plane(V3 p, const float* prm) {
  V3 n = load3(prm);
  float dist = dot(p, n);
  return Proj{dist, p - n * dist, dist < 0.0f};
}

// The (radial, y) half-plane of an axis-Y shape: rho and the unit radial
// direction.
__device__ __forceinline__ float radial(V3 p, V3* u) {
  *u = nrm_or(v3(1.0f * p.x, 0.0f * p.y, 1.0f * p.z), x_axis());
  return sqrt_rn(p.x * p.x + p.z * p.z);
}

__device__ Proj pt_cylinder(V3 p, const float* prm) {
  float hh = prm[0], r = prm[1];
  V3 u;
  float rho = radial(p, &u);
  float y = p.y;
  V3 q_out = u * fminf(rho, r) + y_times(clampf(y, -hh, hh));
  bool out = rho > r || fabsf(y) > hh;
  float d_side = r - rho;
  float d_cap = hh - fabsf(y);
  V3 q_cap = v3(p.x, (y >= 0.0f ? 1.0f : -1.0f) * hh, p.z);
  V3 q_in = d_side < d_cap ? u * r + y_times(y) : q_cap;
  float d = out ? len(p - q_out) : -fminf(d_side, d_cap);
  return Proj{d, out ? q_out : q_in, d < 0.0f};
}

// The point of the (radial, y) segment a-b closest to (rho, y).
__device__ __forceinline__ void seg2(float rho, float y, float ax, float ay, float bx, float by,
                                     float* qx, float* qy) {
  float abx = bx - ax, aby = by - ay;
  float t = clampf(__fdiv_rn((rho - ax) * abx + (y - ay) * aby,
                             fmaxf(abx * abx + aby * aby, 1e-12f)),
                   0.0f, 1.0f);
  *qx = ax + t * abx;
  *qy = ay + t * aby;
}

__device__ Proj pt_cone(V3 p, const float* prm) {
  float hh = prm[0], r = prm[1];
  V3 u;
  float rho = radial(p, &u);
  float y = p.y;
  float sx, sy, bx, by;
  seg2(rho, y, 0.0f, hh, r, -hh, &sx, &sy);   // the slant, apex to rim
  seg2(rho, y, 0.0f, -hh, r, -hh, &bx, &by);  // the base, centre to rim
  float l_sl = sqrt_rn((rho - sx) * (rho - sx) + (y - sy) * (y - sy));
  float l_ba = sqrt_rn((rho - bx) * (rho - bx) + (y - by) * (y - by));
  bool pick = l_sl < l_ba;
  float d2 = fminf(l_sl, l_ba);
  bool inside =
      y >= -hh && y <= hh && rho <= __fdiv_rn(r * (hh - y), fmaxf(2.0f * hh, 1e-9f));
  float d = inside ? -d2 : d2;
  return Proj{d, u * (pick ? sx : bx) + y_times(pick ? sy : by), d < 0.0f};
}

__device__ Proj pt_segment(V3 p, const float* prm) {
  V3 q = v3(clampf(p.x, -prm[0], prm[0]), 0.0f, 0.0f);
  float d = len(p - q);
  return Proj{d, q, d < 0.0f};
}

// convex.py::hull_contains: p strictly inside the inner hull, at least
// kInsideTol x its size from every face plane. `x` is the Frank-Wolfe point;
// every vertex strictly below p along p - x certifies p outside. Otherwise
// every plane through three vertices with all vertices on one side of it
// (within the margin) must have p strictly on that side, beyond the margin.
// `rows` gets the vertex rows the exact rule scanned.
__device__ bool hull_contains(const Hull& h, const float* prm, V3 p, V3 x,
                              unsigned long long* rows) {
  V3 u = p - x;
  if (sigma(h, u) < dot(p, u)) return false;
  if (h.cnt < 4) return false;
  float tol0 = kInsideTol * fmaxf(fmaxf(fmaxf(prm[2], prm[3]), prm[4]), 1e-3f);
  for (int i = 0; i < h.cnt; ++i) {
    V3 vi = vert(h, i);
    for (int j = i + 1; j < h.cnt; ++j) {
      V3 e1 = vert(h, j) - vi;
      for (int k = j + 1; k < h.cnt; ++k) {
        V3 n = cross(e1, vert(h, k) - vi);
        float nn = dot(n, n);
        if (!(nn > 0.0f)) continue;
        float tol = tol0 * sqrt_rn(nn);
        bool below = true, above = true;
        for (int l = 0; l < h.cnt && (below || above); ++l) {
          float s = dot(vert(h, l) - vi, n);
          below = below && s <= tol;
          above = above && s >= -tol;
          ++*rows;
        }
        float q = dot(p - vi, n);
        if ((below && !(q < -tol)) || (above && !(q > tol))) return false;
      }
    }
  }
  return true;
}

__device__ Proj pt_convex(V3 p, const float* prm, const float* pool,
                          unsigned long long* fw_rows, unsigned long long* exact_rows) {
  float rr = prm[6];
  Hull h{pool + 3 * (long long)(int)prm[0], (int)prm[1]};
  V3 x = closest(h, p, kPointFwSteps);
  *fw_rows += (unsigned long long)(kPointFwSteps + 1) * h.cnt;
  V3 delta = p - x;
  float dd = len(delta);
  V3 c = dd > 1e-6f ? x + nrm_or(delta, x_axis()) * rr : p;
  bool inner = hull_contains(h, prm, p, x, exact_rows);
  float d = inner ? -rr : dd - rr;
  return Proj{d, inner ? p : c, inner || d < 0.0f};
}

template <int K>
__global__ void point_3d_kernel(int n, int p_n, int m, const int* __restrict__ cols,
                                const float* __restrict__ points, const float* __restrict__ pos,
                                const float* __restrict__ quat,
                                const float* __restrict__ params,
                                const float* __restrict__ pool, float* __restrict__ dist,
                                float* __restrict__ closest_out,
                                unsigned char* __restrict__ inside,
                                unsigned long long* __restrict__ work) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * p_n) return;
  int r = (int)(idx / n);
  int c = cols[idx - (long long)r * n];
  Q4 q = load4(quat + 4 * c);
  V3 cp = load3(pos + 3 * c);
  V3 p = rotate(conj(q), load3(points + 3 * r) - cp);
  const float* prm = params + 8 * c;
  unsigned long long fw_rows = 0, exact_rows = 0;
  Proj o;
  if constexpr (K == kSphere) o = pt_sphere(p, prm);
  else if constexpr (K == kCapsule) o = pt_capsule(p, prm);
  else if constexpr (K == kBox) o = pt_box(p, prm);
  else if constexpr (K == kPlane) o = pt_plane(p, prm);
  else if constexpr (K == kCylinder) o = pt_cylinder(p, prm);
  else if constexpr (K == kCone) o = pt_cone(p, prm);
  else if constexpr (K == kSegment) o = pt_segment(p, prm);
  else if constexpr (K == kConvex) o = pt_convex(p, prm, pool, &fw_rows, &exact_rows);
  else o = Proj{kBig, p, false};
  long long out = (long long)r * m + c;
  dist[out] = o.d;
  store3(closest_out + 3 * out, cp + rotate(q, o.c));
  inside[out] = o.inside ? 1 : 0;
  if (work) {
    if (fw_rows) atomicAdd(work, fw_rows);
    if (exact_rows) atomicAdd(work + 1, exact_rows);
  }
}

}  // namespace

// kind: the bucket's point kind (the shape code 0-6 or 8; 7 for the shapes a
// point query never meets). work: null, or two u64 counters of vertex rows
// scanned (Frank-Wolfe and certificate; the exact test).
extern "C" int avian_point_3d(int kind, int n, int p_n, int m, const int* cols,
                              const float* points, const float* pos, const float* quat,
                              const float* params, const float* pool, float* dist,
                              float* closest_out, unsigned char* inside,
                              unsigned long long* work, void* stream) {
  const int threads = 128;
  long long total = (long long)n * p_n;
  if (total == 0) return 0;
  int blocks = (int)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
#define AVIAN_POINT(K)                                                                       \
  case K:                                                                                    \
    point_3d_kernel<K><<<blocks, threads, 0, st>>>(n, p_n, m, cols, points, pos, quat, params, \
                                                   pool, dist, closest_out, inside, work);     \
    break;
  switch (kind) {
    AVIAN_POINT(kSphere)
    AVIAN_POINT(kCapsule)
    AVIAN_POINT(kBox)
    AVIAN_POINT(kPlane)
    AVIAN_POINT(kCylinder)
    AVIAN_POINT(kCone)
    AVIAN_POINT(kSegment)
    AVIAN_POINT(kPointMiss)
    AVIAN_POINT(kConvex)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AVIAN_POINT
  return (int)cudaGetLastError();
}
