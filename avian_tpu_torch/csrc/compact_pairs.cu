// Kernel L: the broadphase after the sweep.
//
// Replaces the compaction, the global dense pass, the joint-disabled probe
// and the pair keys of avian_tpu/pipeline/broadphase.py::broad_phase
// (:347-466). See kernels/compact_pairs.py.
// pair_counts: popcount of each grid entry's candidate bits, the window
// overflow count (int32 atomicAdd), and the global pass's test of every
// (global, collider of the same scene) candidate.
// pair_slots (after two inclusive scans on the host stream): grid pairs in
// (entry, bit) order, global pairs after them in (global, collider) order.
// pair_finish (one thread per slot): binary search of the slot's body pair in
// the sorted disabled-joint keys, the canonical pair key, valid, the pair
// count (int32 atomicAdd) and `dropped`. Everything stays on the device.
//
// Scenes: a flat world of b scenes (avian_tpu_torch/parallel) holds b equal
// runs of the sorted grid entries (e_s = n_e / b each: Kernel E's keys put the
// scene first), of the colliders (m_s = m / b), of the global candidates
// (g_cap x m_s each, the scene's globals against its own colliders) and of
// the slots (c_cap each). Each scene takes its slots from its own part of the
// two scans (the scan at its run's end less the scan before its run), so a
// scene's slots hold its grid pairs and then its global pairs in the
// reference's order, and overflow, drops and pair counts are its own. An
// empty slot holds the scene's first collider, as a single world's holds
// collider 0. A single world is b = 1.
#include "common.cuh"

namespace {

constexpr long long kCellBits = 0x7fffffffLL;  // Kernel E's packed cell; all ones: no cell

// The inclusive scan `ends` at the last entry before run `s` of `len`, 0 for
// the first run.
__device__ __forceinline__ long run_base(const int* __restrict__ ends, int s, long len) {
  return s > 0 ? ends[(long)s * len - 1] : 0;
}

__global__ void pair_counts_kernel(
    int n_e, int w, int g_cap, int m, int b, const long long* __restrict__ bits,
    const int* __restrict__ rank,
    const long long* __restrict__ skey, const float* __restrict__ aabb_min,
    const float* __restrict__ aabb_max, const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ is_global, const unsigned char* __restrict__ dyn,
    const int* __restrict__ body, const int* __restrict__ members, const int* __restrict__ filt,
    const long long* __restrict__ g_idx, const unsigned char* __restrict__ g_valid,
    int* __restrict__ cnt, int* __restrict__ gflag, int* __restrict__ window_overflow) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  int e_s = n_e / b, m_s = m / b;
  long gm_s = (long)g_cap * m_s;
  if (t < n_e) {
    cnt[t] = __popcll((unsigned long long)bits[t]);
    if (rank[t] > w && (skey[t] & kCellBits) != kCellBits)
      atomicAdd(window_overflow + t / e_s, 1);
  }
  if (t < b * gm_s) {
    int s = (int)(t / gm_s);
    long r = t - s * gm_s;
    int g = (int)(r / m_s), i = s * m_s + (int)(r % m_s);
    int gi = (int)g_idx[(long)s * g_cap + g];
    bool overlap = true;
    for (int k = 0; k < 3; ++k)
      overlap = overlap && aabb_min[3 * gi + k] <= aabb_max[3 * i + k] &&
                aabb_min[3 * i + k] <= aabb_max[3 * gi + k];
    bool ok = g_valid[(long)s * g_cap + g] && active[i] && gi != i &&
              (!is_global[i] || i < gi) && overlap && body[gi] != body[i] &&
              (members[gi] & filt[i]) != 0 &&
              (members[i] & filt[gi]) != 0 && (dyn[gi] || dyn[i]);
    gflag[t] = ok ? 1 : 0;
  }
}

__global__ void pair_slots_kernel(int n_e, int g_cap, int m, int c_cap, int b,
                                  const long long* __restrict__ bits,
                                  const int* __restrict__ cnt,
                                  const int* __restrict__ ends, const long long* __restrict__ scol,
                                  const int* __restrict__ gflag, const int* __restrict__ gl_ends,
                                  const long long* __restrict__ g_idx, int* __restrict__ ca,
                                  int* __restrict__ cb) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  int e_s = n_e / b, m_s = m / b;
  long gm_s = (long)g_cap * m_s;
  if (t < n_e && cnt[t] > 0) {
    int s = (int)(t / e_s);
    long out = (long)s * c_cap;
    long slot = ends[t] - cnt[t] - run_base(ends, s, e_s);
    unsigned long long mask = (unsigned long long)bits[t];
    int a = (int)scol[t];
    while (mask != 0 && slot < c_cap) {
      int k = __ffsll((long long)mask);  // bit k - 1: the entry k places later in the run
      mask &= mask - 1;
      long partner = t + k < n_e ? t + k : n_e - 1;
      ca[out + slot] = a;
      cb[out + slot] = (int)scol[partner];
      ++slot;
    }
  }
  if (t < b * gm_s && gflag[t]) {
    int s = (int)(t / gm_s);
    long r = t - s * gm_s;
    long grid = ends[(long)(s + 1) * e_s - 1] - run_base(ends, s, e_s);
    long slot = grid + gl_ends[t] - 1 - run_base(gl_ends, s, gm_s);
    if (slot < c_cap) {
      ca[(long)s * c_cap + slot] = s * m_s + (int)(r % m_s);
      cb[(long)s * c_cap + slot] = (int)g_idx[(long)s * g_cap + r / m_s];
    }
  }
}

__global__ void pair_finish_kernel(int c_cap, int n_e, int gm, int m, int b, int n_bodies,
                                   int j_n, const int* __restrict__ ends,
                                   const int* __restrict__ gl_ends,
                                   const int* __restrict__ ca_tmp, const int* __restrict__ cb_tmp,
                                   const int* __restrict__ body,
                                   const long long* __restrict__ jkeys,
                                   const int* __restrict__ window_overflow,
                                   const long long* __restrict__ global_overflow,
                                   int* __restrict__ ca, int* __restrict__ cb,
                                   long long* __restrict__ key, unsigned char* __restrict__ valid,
                                   int* __restrict__ num_pairs, int* __restrict__ dropped) {
  long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (long)b * c_cap) return;
  int s = (int)(j / c_cap), e_s = n_e / b, m_s = m / b;
  long slot = j - (long)s * c_cap, gm_s = gm / b;
  long total = ends[(long)(s + 1) * e_s - 1] - run_base(ends, s, e_s) +
               gl_ends[(s + 1) * gm_s - 1] - run_base(gl_ends, s, gm_s);
  if (slot == 0) {
    long over = total - c_cap;
    dropped[s] = (int)((over > 0 ? over : 0) + window_overflow[s] + global_overflow[s]);
  }
  bool got = slot < total;
  int a = s * m_s, c = s * m_s;
  if (got) {
    a = ca_tmp[j];
    c = cb_tmp[j];
    long long pa = body[a], pb = body[c];
    long long pkey = (pa < pb ? pa : pb) * (long long)n_bodies + (pa < pb ? pb : pa);
    int lo = 0, hi = j_n;  // first jkeys[i] >= pkey
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (jkeys[mid] < pkey) lo = mid + 1; else hi = mid;
    }
    got = !(lo < j_n && jkeys[lo] == pkey);
  }
  if (!got) {
    a = s * m_s;
    c = s * m_s;
  }
  ca[j] = a;
  cb[j] = c;
  key[j] = got ? (long long)(a < c ? a : c) * m + (a < c ? c : a) : -1LL;
  valid[j] = got;
  if (got) atomicAdd(num_pairs + s, 1);
}

int blocks(long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" int avian_pair_counts(int n_e, int w, int g_cap, int m, int b, const long long* bits,
                                 const int* rank, const long long* skey, const float* aabb_min,
                                 const float* aabb_max,
                                 const unsigned char* active, const unsigned char* is_global,
                                 const unsigned char* dyn, const int* body, const int* members,
                                 const int* filt, const long long* g_idx,
                                 const unsigned char* g_valid, int* cnt, int* gflag,
                                 int* window_overflow, void* stream) {
  const int threads = 256;
  long gm = (long)g_cap * (m / b) * b;
  long n = n_e > gm ? n_e : gm;
  pair_counts_kernel<<<blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      n_e, w, g_cap, m, b, bits, rank, skey, aabb_min, aabb_max, active, is_global, dyn, body,
      members, filt, g_idx, g_valid, cnt, gflag, window_overflow);
  return (int)cudaGetLastError();
}

extern "C" int avian_pair_slots(int n_e, int g_cap, int m, int c_cap, int b,
                                const long long* bits,
                                const int* cnt, const int* ends, const long long* scol,
                                const int* gflag, const int* gl_ends, const long long* g_idx,
                                int* ca, int* cb, void* stream) {
  const int threads = 256;
  long gm = (long)g_cap * (m / b) * b;
  long n = n_e > gm ? n_e : gm;
  pair_slots_kernel<<<blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      n_e, g_cap, m, c_cap, b, bits, cnt, ends, scol, gflag, gl_ends, g_idx, ca, cb);
  return (int)cudaGetLastError();
}

extern "C" int avian_pair_finish(int c_cap, int n_e, int gm, int m, int b, int n_bodies, int j_n,
                                 const int* ends, const int* gl_ends, const int* ca_tmp,
                                 const int* cb_tmp, const int* body, const long long* jkeys,
                                 const int* window_overflow, const long long* global_overflow,
                                 int* ca, int* cb, long long* key, unsigned char* valid,
                                 int* num_pairs, int* dropped, void* stream) {
  const int threads = 256;
  pair_finish_kernel<<<blocks((long)b * c_cap, threads), threads, 0, (cudaStream_t)stream>>>(
      c_cap, n_e, gm, m, b, n_bodies, j_n, ends, gl_ends, ca_tmp, cb_tmp, body, jkeys,
      window_overflow, global_overflow, ca, cb, key, valid, num_pairs, dropped);
  return (int)cudaGetLastError();
}
