// Kernel AG: grid-accelerated first-hit ray casts, one thread per ray.
//
// Replaces avian_tpu/queries/accel.py::cast_ray_grid (:118; test_collider
// :144, visit :167, the dense pass :198-203) as update_ray_casters (:269)
// runs it under vmap. Each thread walks its ray through the query grid's
// cells with a 3D DDA (Amanatides-Woo: the first axis of the smallest
// t_max advances), max_cells cells whatever it has hit; in each cell a binary
// search of the sorted keys (searchsorted, left) finds the cell's run, of
// which the first cell_window entries are tested with Kernel T's device code
// (ray_cast.cuh's ray_any, a switch on the collider's ray kind); then the up
// to 16 global colliders. A hit is taken only where strictly nearer, so the
// first visited cell, and in it the first entry, wins ties, as the
// reference's argmin per cell and strict comparison do. A filtered-out entry
// is never tested (its distance would be 1e30), and a cell's run ends at the
// first key that differs (the keys are sorted).
//
// A ray is 64 binary searches of ~18 steps and the tests of the entries it
// meets, some 60 operations each on an analytic shape and some 60,000 on a
// hull; one thread a ray keeps the walk in registers, so the kernel is bound
// by the hull tests' operations and their latency. The arithmetic is the
// plain version's (kernels/ray_cast_grid.py) operation by operation, compiled
// without fused multiply-adds, with IEEE square roots and divisions.
#include "ray_cast.cuh"

namespace {

// grid_sweep.py::cell_key, accel.py::_pack: 10 bits a coordinate, wrapped.
__device__ __forceinline__ int pack_cell(const int* c) {
  return ((c[0] & 1023) << 20) | ((c[1] & 1023) << 10) | (c[2] & 1023);
}

// The first index of skey[0, ne) not below key.
__device__ __forceinline__ int lower_bound(const int* skey, int ne, int key) {
  int lo = 0, hi = ne;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (skey[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

struct Tables {
  const int* kind;
  const unsigned char* ok;
  const float* pos;
  const float* quat;
  const float* params;
  const float* pool;
};

struct Best {
  float t;
  V3 n;
  int ci;
  unsigned long long analytic, hulls, hull_rows;
};

// test_collider: ray vs collider ci, taken where strictly nearer.
__device__ __forceinline__ void test(int ci, V3 o, V3 d, bool solid, float max_d,
                                     const Tables& tb, Best& b) {
  if (!tb.ok[ci]) return;
  Q4 q = load4(tb.quat + 4 * ci);
  V3 ol = rotate(conj(q), o - load3(tb.pos + 3 * ci));
  V3 dl = rotate(conj(q), d);
  const float* prm = tb.params + 8 * ci;
  int kind = tb.kind[ci];
  Hit h = ray_any(kind, ol, dl, prm, solid, tb.pool);
  if (kind == kConvex) {
    ++b.hulls;
    b.hull_rows += (unsigned long long)(int)prm[1];
  } else {
    ++b.analytic;
  }
  float t = (h.t <= max_d && h.t >= 0.0f) ? h.t : kBig;
  if (t < b.t) {
    b.t = t;
    b.n = rotate(q, h.n);
    b.ci = ci;
  }
}

__global__ void ray_cast_grid_kernel(int r_n, int max_cells, int window, int ne, int g_n,
                                     const float* __restrict__ rays,
                                     const float* __restrict__ max_dist,
                                     const unsigned char* __restrict__ solid,
                                     const float* __restrict__ cell_ptr,
                                     const int* __restrict__ skey, const int* __restrict__ scol,
                                     const int* __restrict__ g_idx,
                                     const unsigned char* __restrict__ g_valid, Tables tb,
                                     float* __restrict__ t_out, float* __restrict__ n_out,
                                     int* __restrict__ ci_out,
                                     unsigned long long* __restrict__ work) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= r_n) return;
  V3 o = load3(rays + 6 * r), d = load3(rays + 6 * r + 3);
  bool sol = solid[r] != 0;
  float md = max_dist[r];
  float cell = *cell_ptr;
  float oa[3] = {o.x, o.y, o.z}, da[3] = {d.x, d.y, d.z};
  int cc[3], step[3];
  float t_max[3], t_delta[3];
  for (int a = 0; a < 3; ++a) {
    float den = fabsf(da[a]) > 1e-12f ? da[a] : (da[a] >= 0.0f ? 1e-12f : -1e-12f);
    float inv = __fdiv_rn(1.0f, den);
    step[a] = da[a] >= 0.0f ? 1 : -1;
    cc[a] = (int)floorf(__fdiv_rn(oa[a], cell));
    float next_b = ((float)cc[a] + (step[a] > 0 ? 1.0f : 0.0f)) * cell;
    t_max[a] = (next_b - oa[a]) * inv;
    t_delta[a] = fabsf(cell * inv);
  }
  Best b{kBig, v3(0.0f, 0.0f, 0.0f), -1, 0, 0, 0};
  for (int k = 0; k < max_cells; ++k) {
    int key = pack_cell(cc);
    int start = lower_bound(skey, ne, key);
    for (int j = 0; j < window; ++j) {
      int idx = min(start + j, ne - 1);
      if (skey[idx] != key) break;  // sorted: the run has ended
      test(scol[idx], o, d, sol, md, tb, b);
    }
    int ax = 0;  // the first smallest t_max
    if (t_max[1] < t_max[ax]) ax = 1;
    if (t_max[2] < t_max[ax]) ax = 2;
    cc[ax] += step[ax];
    t_max[ax] += t_delta[ax];
  }
  for (int g = 0; g < g_n; ++g)
    if (g_valid[g]) test(g_idx[g], o, d, sol, md, tb, b);
  t_out[r] = b.t;
  store3(n_out + 3 * r, b.n);
  ci_out[r] = b.ci;
  if (work) {
    atomicAdd(work, b.analytic);
    atomicAdd(work + 1, b.hulls);
    atomicAdd(work + 2, b.hull_rows);
  }
}

}  // namespace

// Rays (origin, unit direction) f32[R, 6] with their max distances and solid
// flags; the grid (cell size on the device, sorted keys and their colliders,
// global colliders); the colliders' ray kinds, query mask, poses, params and
// the pool. Writes the nearest distance (1e30: none), world normal (zero:
// none) and collider (-1: none) of each ray; work: null, or three u64
// counters (analytic tests, hull tests, hull vertex rows).
extern "C" int avian_ray_cast_grid(int r_n, int max_cells, int window, int ne, int g_n,
                                   const float* rays, const float* max_dist,
                                   const unsigned char* solid, const float* cell,
                                   const int* skey, const int* scol, const int* g_idx,
                                   const unsigned char* g_valid, const int* kind,
                                   const unsigned char* ok, const float* pos, const float* quat,
                                   const float* params, const float* pool, float* t_out,
                                   float* n_out, int* ci_out, unsigned long long* work,
                                   void* stream) {
  if (r_n == 0) return 0;
  const int threads = 64;
  Tables tb{kind, ok, pos, quat, params, pool};
  ray_cast_grid_kernel<<<(r_n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      r_n, max_cells, window, ne, g_n, rays, max_dist, solid, cell, skey, scol, g_idx, g_valid,
      tb, t_out, n_out, ci_out, work);
  return (int)cudaGetLastError();
}
