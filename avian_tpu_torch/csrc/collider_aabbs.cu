// Kernel E: collider poses, speculative AABBs and grid cell keys, one thread
// per collider.
//
// Replaces avian_tpu/pipeline/broadphase.py::update_collider_poses (:85) and
// update_aabbs (:96) with geometry/shapes.py::world_aabb (:71), and the key
// emission of broad_phase (:217-279). Bound by bytes: a collider reads about
// 120 bytes of its own and its body's columns and writes 52 (AABB and pose),
// then 64 of keys and 52 of table rows; the arithmetic is a few dozen
// operations. The cell sizes stay on the device and are read through a
// pointer. The division by the cell size is IEEE (__fdiv_rn), as the plain
// version's, so a collider on a cell edge lands in the same cell; the clamp
// to +-2e9 comes before the cast to int, where CUDA and the CPU differ.
//
// A flat world of B scenes (avian_tpu_torch/parallel) holds B runs of
// m_scene colliders: collider i is in scene i / m_scene, divides by that
// scene's cell size and puts the scene above the 31 bits of its packed key
// (the 30 bits of the cell, or the sentinel 2^31 - 1), so that one sort
// keeps every scene's entries together and no run of equal keys crosses two
// scenes. A single world is one scene: its keys are the 32-bit ones.
#include "common.cuh"

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kSceneShift = 31;
constexpr int kSphere = 0, kCapsule = 1, kBox = 2, kPlane = 3, kCylinder = 4, kCone = 5,
              kSegment = 6, kConvex = 8;
constexpr int kDynamic = 1;
constexpr float kBig = 1.0e9f;

__global__ void collider_aabbs_kernel(
    int m, const int* __restrict__ body_idx, const int* __restrict__ shape_type,
    const float* __restrict__ params, const float* __restrict__ local_pos,
    const float* __restrict__ local_quat, const float* __restrict__ spec_margin,
    const float* __restrict__ coll_margin, const float* __restrict__ body_pos,
    const float* __restrict__ body_quat, const float* __restrict__ body_lin_vel, float dt,
    float spec_default, float tol, float* __restrict__ aabb_min, float* __restrict__ aabb_max,
    float* __restrict__ pos_out, float* __restrict__ quat_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int b = body_idx[i];
  Q4 bq = load4(body_quat + 4 * b);
  V3 p = load3(body_pos + 3 * b) + rotate(bq, load3(local_pos + 3 * i));
  Q4 q = qmul(bq, load4(local_quat + 4 * i));

  int st = shape_type[i];
  const float* pr = params + 8 * i;
  float r = pr[0];
  V3 h = v3(r, r, r);
  // Capsule, cylinder, cone: pr = (half height along local y, radius).
  if (st == kCapsule) h = v3(pr[1], pr[0] + pr[1], pr[1]);
  if (st == kBox) h = v3(pr[0], pr[1], pr[2]);
  if (st == kCylinder || st == kCone) h = v3(pr[1], pr[0], pr[1]);
  // Segment: half length on local x. Convex (hulls, round cuboids,
  // triangles): the builder's half extents in pr[2..4].
  if (st == kSegment) h = v3(pr[0], 0.0f, 0.0f);
  if (st == kConvex) h = v3(pr[2], pr[3], pr[4]);
  if (st == kPlane) h = v3(kBig, kBig, kBig);

  float x2 = q.x + q.x, y2 = q.y + q.y, z2 = q.z + q.z;
  float xx = q.x * x2, yy = q.y * y2, zz = q.z * z2;
  float xy = q.x * y2, xz = q.x * z2, yz = q.y * z2;
  float wx = q.w * x2, wy = q.w * y2, wz = q.w * z2;
  float m00 = fabsf(1.0f - (yy + zz)), m01 = fabsf(xy - wz), m02 = fabsf(xz + wy);
  float m10 = fabsf(xy + wz), m11 = fabsf(1.0f - (xx + zz)), m12 = fabsf(yz - wx);
  float m20 = fabsf(xz - wy), m21 = fabsf(yz + wx), m22 = fabsf(1.0f - (xx + yy));
  V3 wh = v3(m00 * h.x + m01 * h.y + m02 * h.z, m10 * h.x + m11 * h.y + m12 * h.z,
             m20 * h.x + m21 * h.y + m22 * h.z);
  if (st == kSphere) wh = v3(r, r, r);

  V3 v = load3(body_lin_vel + 3 * b);
  float speed = sqrtf(dot(v, v));
  float spec = spec_margin[i];
  spec = spec > spec_default ? spec_default : spec;
  float travel = speed * dt;
  float e = (travel < spec ? travel : spec) + coll_margin[i] + tol;

  V3 lo = p - wh, hi = p + wh;
  store3(aabb_min + 3 * i, v3(lo.x - e, lo.y - e, lo.z - e));
  store3(aabb_max + 3 * i, v3(hi.x + e, hi.y + e, hi.z + e));
  store3(pos_out + 3 * i, p);
  quat_out[4 * i + 0] = q.x;
  quat_out[4 * i + 1] = q.y;
  quat_out[4 * i + 2] = q.z;
  quat_out[4 * i + 3] = q.w;
}

__device__ __forceinline__ int cell_key(int x, int y, int z) {
  return ((x & 1023) << 20) | ((y & 1023) << 10) | (z & 1023);
}

__device__ __forceinline__ int cell_of(float x, float cell) {
  float f = floorf(__fdiv_rn(x, cell));
  f = f < -2.0e9f ? -2.0e9f : f;
  f = f > 2.0e9f ? 2.0e9f : f;
  return (int)f;
}

__global__ void cell_keys_kernel(int m, int m_scene, const float* __restrict__ aabb_min,
                                 const float* __restrict__ aabb_max,
                                 const float* __restrict__ cell_ptr,
                                 const unsigned char* __restrict__ in_sweep,
                                 const int* __restrict__ body_idx, const int* __restrict__ mem,
                                 const int* __restrict__ fil, const int* __restrict__ body_type,
                                 const unsigned char* __restrict__ body_active,
                                 long long* __restrict__ ckey, float* __restrict__ fpack,
                                 int* __restrict__ ipack) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int scene = i / m_scene;
  float cell = cell_ptr[scene];
  long long base = (long long)scene << kSceneShift;
  float lo0 = aabb_min[3 * i], lo1 = aabb_min[3 * i + 1], lo2 = aabb_min[3 * i + 2];
  float hi0 = aabb_max[3 * i], hi1 = aabb_max[3 * i + 1], hi2 = aabb_max[3 * i + 2];
  int a0 = cell_of(lo0, cell), a1 = cell_of(lo1, cell), a2 = cell_of(lo2, cell);
  int b0 = cell_of(hi0, cell), b1 = cell_of(hi1, cell), b2 = cell_of(hi2, cell);
  bool sweep = in_sweep[i] != 0;
  for (int j = 0; j < 8; ++j) {
    int c0 = a0 + ((j >> 2) & 1), c1 = a1 + ((j >> 1) & 1), c2 = a2 + (j & 1);
    bool ok = sweep && c0 <= b0 && c1 <= b1 && c2 <= b2;
    ckey[8 * (long)i + j] = base | (ok ? cell_key(c0, c1, c2) : kSentinel);
  }
  float* f = fpack + 6 * i;
  f[0] = lo0;
  f[1] = lo1;
  f[2] = lo2;
  f[3] = hi0;
  f[4] = hi1;
  f[5] = hi2;
  int body = body_idx[i];
  int* o = ipack + 7 * i;
  o[0] = a0;
  o[1] = a1;
  o[2] = a2;
  o[3] = body;
  o[4] = mem[i];
  o[5] = fil[i];
  o[6] = (body_type[body] == kDynamic && body_active[body] != 0) ? 1 : 0;
}

}  // namespace

extern "C" int avian_collider_aabbs(int m, const int* body_idx, const int* shape_type,
                                    const float* params, const float* local_pos,
                                    const float* local_quat, const float* spec_margin,
                                    const float* coll_margin, const float* body_pos,
                                    const float* body_quat, const float* body_lin_vel, float dt,
                                    float spec_default, float tol, float* aabb_min,
                                    float* aabb_max, float* pos_out, float* quat_out,
                                    void* stream) {
  const int threads = 128;
  collider_aabbs_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      m, body_idx, shape_type, params, local_pos, local_quat, spec_margin, coll_margin, body_pos,
      body_quat, body_lin_vel, dt, spec_default, tol, aabb_min, aabb_max, pos_out, quat_out);
  return (int)cudaGetLastError();
}

extern "C" int avian_cell_keys(int m, int m_scene, const float* aabb_min,
                               const float* aabb_max, const float* cell_ptr,
                               const unsigned char* in_sweep, const int* body_idx,
                               const int* mem, const int* fil, const int* body_type,
                               const unsigned char* body_active, long long* ckey, float* fpack,
                               int* ipack, void* stream) {
  const int threads = 128;
  cell_keys_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      m, m_scene, aabb_min, aabb_max, cell_ptr, in_sweep, body_idx, mem, fil, body_type,
      body_active, ckey, fpack, ipack);
  return (int)cudaGetLastError();
}
