// Kernel AH: which colliders' stored AABBs overlap each of Q query boxes, one
// thread per (box, collider).
//
// Replaces the mask of avian_tpu/queries/intersect.py::aabb_intersections
// (:14): collider_query_mask & all((aabb_min <= hi) & (lo <= aabb_max)) over
// every collider. A thread compares six floats and writes one byte, so the
// kernel is bound by bytes: the colliders' 25 bytes are read once per box
// through L1/L2, and neighbouring threads write neighbouring bytes.

#include <cuda_runtime.h>

namespace {

__global__ void aabb_overlap_kernel(int q_n, int m, const float* __restrict__ lo,
                                    const float* __restrict__ hi,
                                    const float* __restrict__ amin,
                                    const float* __restrict__ amax,
                                    const unsigned char* __restrict__ ok,
                                    unsigned char* __restrict__ out) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)q_n * m) return;
  int q = (int)(k / m);
  int c = (int)(k - (long long)q * m);
  bool hit = ok[c] != 0;
  for (int a = 0; a < 3; ++a)
    hit = hit && amin[3 * c + a] <= hi[3 * q + a] && lo[3 * q + a] <= amax[3 * c + a];
  out[k] = hit ? 1 : 0;
}

}  // namespace

extern "C" int avian_aabb_overlap(int q_n, int m, const float* lo, const float* hi,
                                  const float* amin, const float* amax, const unsigned char* ok,
                                  unsigned char* out, void* stream) {
  const int threads = 256;
  long long n = (long long)q_n * m;
  if (n == 0) return 0;
  aabb_overlap_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(q_n, m, lo, hi, amin, amax, ok, out);
  return (int)cudaGetLastError();
}
