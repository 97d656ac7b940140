// Kernel B: the broadphase's same-cell window sweep, one thread per sorted
// grid entry.
//
// Replaces the window loop of avian_tpu/pipeline/broadphase.py::broad_phase
// (broadphase.py:297-345). Bound by the loads of the following entries
// (6 floats + 7 ints each), which neighbouring threads share through L1.
// A thread stops at the end of its cell run, where the reference's same_cell
// test is false for every remaining window position, and caps the run rank
// at w + 1, which is all window_overflow reads.
#include "common.cuh"

namespace {

constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ int cell_key(int x, int y, int z) {
  return ((x & 1023) << 20) | ((y & 1023) << 10) | (z & 1023);
}

__global__ void grid_sweep_kernel(const int* __restrict__ skey, const float* __restrict__ sf,
                                  const int* __restrict__ si, unsigned int* __restrict__ bits,
                                  int* __restrict__ rank, int n, int w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int key = skey[i];

  int r = 0;
  while (r <= w && i - r - 1 >= 0 && skey[i - r - 1] == key) ++r;
  rank[i] = r;

  unsigned int mask = 0u;
  if (key != kSentinel) {
    const float* af = sf + 6 * i;
    const int* ai = si + 7 * i;
    float amin0 = af[0], amin1 = af[1], amin2 = af[2];
    float amax0 = af[3], amax1 = af[4], amax2 = af[5];
    int c0 = ai[0], c1 = ai[1], c2 = ai[2], body = ai[3], mem = ai[4], fil = ai[5], dyn = ai[6];
    for (int k = 1; k <= w; ++k) {
      int j = i + k;
      if (j >= n || skey[j] != key) break;
      const float* bf = sf + 6 * j;
      const int* bi = si + 7 * j;
      bool overlap = (bf[0] <= amax0) && (amin0 <= bf[3]) && (bf[1] <= amax1) &&
                     (amin1 <= bf[4]) && (bf[2] <= amax2) && (amin2 <= bf[5]);
      int canon = cell_key(max(c0, bi[0]), max(c1, bi[1]), max(c2, bi[2]));
      bool ok = overlap && canon == key && body != bi[3] && (mem & bi[5]) != 0 &&
                (bi[4] & fil) != 0 && (dyn | bi[6]) > 0;
      if (ok) mask |= 1u << (k - 1);
    }
  }
  bits[i] = mask;
}

}  // namespace

extern "C" int avian_grid_sweep(const int* skey, const float* sf, const int* si, int* bits,
                                int* rank, int n, int w, void* stream) {
  const int threads = 256;
  grid_sweep_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      skey, sf, si, reinterpret_cast<unsigned int*>(bits), rank, n, w);
  return (int)cudaGetLastError();
}
