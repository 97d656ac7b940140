// Kernel A: box/box and box/plane contact manifolds, one thread per pair.
//
// Replaces avian_tpu/geometry/box_box.py::box_box (+ _face_manifold,
// _clip_axis) and avian_tpu/geometry/narrowphase.py::box_plane. Each pair is
// thousands of dependent f32 operations on registers, so the kernel is bound
// by latency and register pressure; the design keeps the clip polygon in a
// fixed 8-slot array and emits clipped points in ring order instead of the
// reference's per-clip sort. The arithmetic follows the plain PyTorch version
// (geometry/box_box.py, geometry/narrowphase.py) operation by operation, so
// ties (SAT axis, box/plane corner order) break the same way on both.
#include "box_pair.cuh"

namespace {

using namespace box_pair;

__global__ void box_manifold_kernel(int kind, int n, const float* __restrict__ pa,
                                    const float* __restrict__ qa, const float* __restrict__ ha,
                                    const float* __restrict__ pb, const float* __restrict__ qb,
                                    const float* __restrict__ hb, float* __restrict__ normal,
                                    float* __restrict__ point_a, float* __restrict__ point_b,
                                    float* __restrict__ sep, int* __restrict__ fid,
                                    int* __restrict__ count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Out o;
  V3 a_p = load3(pa + 3 * i), b_p = load3(pb + 3 * i);
  Q4 a_q = load4(qa + 4 * i), b_q = load4(qb + 4 * i);
  V3 a_h = load3(ha + 3 * i), b_h = load3(hb + 3 * i);
  if (kind == 0)
    box_box(a_p, a_q, a_h, b_p, b_q, b_h, o);
  else
    box_plane(a_p, a_q, a_h, b_p, b_q, b_h, o);
  store3(normal + 3 * i, o.normal);
  for (int k = 0; k < 4; ++k) {
    store3(point_a + 12 * i + 3 * k, o.pa[k]);
    store3(point_b + 12 * i + 3 * k, o.pb[k]);
    sep[4 * i + k] = o.sep[k];
    fid[4 * i + k] = o.fid[k];
  }
  count[i] = o.count;
}

}  // namespace

extern "C" int avian_box_manifold(int kind, int n, const float* pa, const float* qa,
                                  const float* ha, const float* pb, const float* qb,
                                  const float* hb, float* normal, float* point_a,
                                  float* point_b, float* sep, int* fid, int* count,
                                  void* stream) {
  const int threads = 128;
  box_manifold_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      kind, n, pa, qa, ha, pb, qb, hb, normal, point_a, point_b, sep, fid, count);
  return (int)cudaGetLastError();
}
