// Kernel L: the broadphase after the sweep.
//
// Replaces the compaction, the global dense pass, the joint-disabled probe
// and the pair keys of avian_tpu/pipeline/broadphase.py::broad_phase
// (:347-466). See kernels/compact_pairs.py.
// pair_counts: popcount of each grid entry's candidate bits, the window
// overflow count (int32 atomicAdd), and the global pass's test of every
// (global, collider) candidate.
// pair_slots (after two exclusive scans on the host stream): grid pairs in
// (entry, bit) order, global pairs after them in (global, collider) order.
// pair_finish (one thread per slot): binary search of the slot's body pair in
// the sorted disabled-joint keys, the canonical pair key, valid, the pair
// count (int32 atomicAdd) and `dropped`. Everything stays on the device.
#include "common.cuh"

namespace {

constexpr int kSentinel = 0x7fffffff;

__global__ void pair_counts_kernel(
    int n_e, int w, int g_cap, int m, const long long* __restrict__ bits,
    const int* __restrict__ rank,
    const int* __restrict__ skey, const float* __restrict__ aabb_min,
    const float* __restrict__ aabb_max, const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ is_global, const unsigned char* __restrict__ dyn,
    const int* __restrict__ body, const int* __restrict__ members, const int* __restrict__ filt,
    const long long* __restrict__ g_idx, const unsigned char* __restrict__ g_valid,
    int* __restrict__ cnt, int* __restrict__ gflag, int* __restrict__ window_overflow) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_e) {
    cnt[t] = __popcll((unsigned long long)bits[t]);
    if (rank[t] > w && skey[t] != kSentinel) atomicAdd(window_overflow, 1);
  }
  if (t < (long)g_cap * m) {
    int g = (int)(t / m), i = (int)(t % m);
    int gi = (int)g_idx[g];
    bool overlap = true;
    for (int k = 0; k < 3; ++k)
      overlap = overlap && aabb_min[3 * gi + k] <= aabb_max[3 * i + k] &&
                aabb_min[3 * i + k] <= aabb_max[3 * gi + k];
    bool ok = g_valid[g] && active[i] && gi != i && (!is_global[i] || i < gi) && overlap &&
              body[gi] != body[i] && (members[gi] & filt[i]) != 0 &&
              (members[i] & filt[gi]) != 0 && (dyn[gi] || dyn[i]);
    gflag[t] = ok ? 1 : 0;
  }
}

__global__ void pair_slots_kernel(int n_e, int g_cap, int m, int c_cap,
                                  const long long* __restrict__ bits,
                                  const int* __restrict__ cnt,
                                  const int* __restrict__ ends, const long long* __restrict__ scol,
                                  const int* __restrict__ gflag, const int* __restrict__ gl_ends,
                                  const long long* __restrict__ g_idx, int* __restrict__ ca,
                                  int* __restrict__ cb) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_e && cnt[t] > 0) {
    int slot = ends[t] - cnt[t];
    unsigned long long b = (unsigned long long)bits[t];
    int a = (int)scol[t];
    while (b != 0 && slot < c_cap) {
      int k = __ffsll((long long)b);  // bit k - 1: the entry k places later in the run
      b &= b - 1;
      long partner = t + k < n_e ? t + k : n_e - 1;
      ca[slot] = a;
      cb[slot] = (int)scol[partner];
      ++slot;
    }
  }
  long gm = (long)g_cap * m;
  if (t < gm && gflag[t]) {
    long slot = (long)ends[n_e - 1] + gl_ends[t] - 1;
    if (slot < c_cap) {
      ca[slot] = (int)(t % m);
      cb[slot] = (int)g_idx[t / m];
    }
  }
}

__global__ void pair_finish_kernel(int c_cap, int n_e, int gm, int m, int n_bodies, int j_n,
                                   const int* __restrict__ ends, const int* __restrict__ gl_ends,
                                   const int* __restrict__ ca_tmp, const int* __restrict__ cb_tmp,
                                   const int* __restrict__ body, const long long* __restrict__ jkeys,
                                   const int* __restrict__ window_overflow,
                                   const long long* __restrict__ global_overflow,
                                   int* __restrict__ ca, int* __restrict__ cb,
                                   long long* __restrict__ key, unsigned char* __restrict__ valid,
                                   int* __restrict__ num_pairs, int* __restrict__ dropped) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  long total = (long)ends[n_e - 1] + gl_ends[gm - 1];
  if (s == 0) {
    long over = total - c_cap;
    dropped[0] = (int)((over > 0 ? over : 0) + window_overflow[0] + global_overflow[0]);
  }
  if (s >= c_cap) return;
  bool got = s < total;
  int a = 0, b = 0;
  if (got) {
    a = ca_tmp[s];
    b = cb_tmp[s];
    long long pa = body[a], pb = body[b];
    long long pkey = (pa < pb ? pa : pb) * (long long)n_bodies + (pa < pb ? pb : pa);
    int lo = 0, hi = j_n;  // first jkeys[i] >= pkey
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (jkeys[mid] < pkey) lo = mid + 1; else hi = mid;
    }
    got = !(lo < j_n && jkeys[lo] == pkey);
  }
  if (!got) {
    a = 0;
    b = 0;
  }
  ca[s] = a;
  cb[s] = b;
  key[s] = got ? (long long)(a < b ? a : b) * m + (a < b ? b : a) : -1LL;
  valid[s] = got;
  if (got) atomicAdd(num_pairs, 1);
}

int blocks(long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" int avian_pair_counts(int n_e, int w, int g_cap, int m, const long long* bits,
                                 const int* rank,
                                 const int* skey, const float* aabb_min, const float* aabb_max,
                                 const unsigned char* active, const unsigned char* is_global,
                                 const unsigned char* dyn, const int* body, const int* members,
                                 const int* filt, const long long* g_idx,
                                 const unsigned char* g_valid, int* cnt, int* gflag,
                                 int* window_overflow, void* stream) {
  const int threads = 256;
  long n = n_e > (long)g_cap * m ? n_e : (long)g_cap * m;
  pair_counts_kernel<<<blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      n_e, w, g_cap, m, bits, rank, skey, aabb_min, aabb_max, active, is_global, dyn, body,
      members, filt, g_idx, g_valid, cnt, gflag, window_overflow);
  return (int)cudaGetLastError();
}

extern "C" int avian_pair_slots(int n_e, int g_cap, int m, int c_cap, const long long* bits,
                                const int* cnt, const int* ends, const long long* scol,
                                const int* gflag, const int* gl_ends, const long long* g_idx,
                                int* ca, int* cb, void* stream) {
  const int threads = 256;
  long n = n_e > (long)g_cap * m ? n_e : (long)g_cap * m;
  pair_slots_kernel<<<blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      n_e, g_cap, m, c_cap, bits, cnt, ends, scol, gflag, gl_ends, g_idx, ca, cb);
  return (int)cudaGetLastError();
}

extern "C" int avian_pair_finish(int c_cap, int n_e, int gm, int m, int n_bodies, int j_n,
                                 const int* ends, const int* gl_ends, const int* ca_tmp,
                                 const int* cb_tmp, const int* body, const long long* jkeys,
                                 const int* window_overflow, const long long* global_overflow,
                                 int* ca, int* cb, long long* key, unsigned char* valid,
                                 int* num_pairs, int* dropped, void* stream) {
  const int threads = 256;
  pair_finish_kernel<<<blocks(c_cap, threads), threads, 0, (cudaStream_t)stream>>>(
      c_cap, n_e, gm, m, n_bodies, j_n, ends, gl_ends, ca_tmp, cb_tmp, body, jkeys,
      window_overflow, global_overflow, ca, cb, key, valid, num_pairs, dropped);
  return (int)cudaGetLastError();
}
