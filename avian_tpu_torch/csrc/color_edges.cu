// Kernel G: constraint-graph edge colouring and per-colour bucketing.
//
// Replaces avian_tpu/pipeline/coloring.py::color_constraints (:41) with its
// run rank, and avian_tpu/pipeline/solver.py::_bucketize (:127). All integer
// work, so every output equals the plain version's exactly.
//
// The reference ranks sorted keys with a scan; here a thread finds where its
// key's run starts by binary search in the sorted array (run_rank, and inside
// color_rows and bucket_slots), which needs no scan and no scratch. The
// adjacency is one row of at most 32 edge ids per body. A colour round is two
// launches that read and write different arrays: color_propose reads the
// bodies' used-colour bitmasks (one u32 per body) and writes each edge's
// proposal; color_win gives an edge its proposal if no lower-indexed edge in
// either endpoint's row proposes the same colour, and ORs the colour into the
// endpoints' bitmasks (an integer atomic, so the result has no order). The
// same color_win launch validates the colours carried over from the last
// step. Bound by the dependent gathers of the row scan (up to 64 proposals an
// edge); the plain version's row winner builds [N, 32, 32] int64 tensors.
#include "common.cuh"

namespace {

// First index in sorted a[0..n) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void run_rank_kernel(int n, const int* __restrict__ skey, int* __restrict__ rank) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rank[i] = i - lower_bound(skey, n, skey[i]);
}

// Incidence keys: entry e is edge e's a side, entry E + e its b side; the key
// is the body where that side is a dynamic end of a live edge, else n_bodies.
__global__ void color_keys_kernel(int e_n, int n_bodies, const int* __restrict__ body_a,
                                  const int* __restrict__ body_b,
                                  const unsigned char* __restrict__ dyn_a,
                                  const unsigned char* __restrict__ dyn_b,
                                  const unsigned char* __restrict__ mask,
                                  int* __restrict__ key) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_n) return;
  bool live = mask[e] != 0;
  key[e] = (live && dyn_a[e] != 0) ? body_a[e] : n_bodies;
  key[e_n + e] = (live && dyn_b[e] != 0) ? body_b[e] : n_bodies;
}

// One thread per body: its row of the first d incident edges in sorted order
// (e_n = empty), whether each of its incidences fit, and a cleared bitmask.
__global__ void color_rows_kernel(int n_bodies, int n2, int e_n, int d,
                                  const int* __restrict__ skey,
                                  const long long* __restrict__ order, int* __restrict__ rows,
                                  unsigned char* __restrict__ fit,
                                  unsigned int* __restrict__ used) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_bodies) return;
  int lo = lower_bound(skey, n2, b);
  int hi = lower_bound(skey, n2, b + 1);
  for (int r = 0; r < d; ++r) {
    int j = lo + r;
    rows[b * d + r] = j < hi ? (int)(order[j] % e_n) : e_n;
  }
  for (int j = lo; j < hi; ++j) fit[order[j]] = (j - lo) < d ? 1 : 0;
  used[b] = 0u;
}

// Per edge: colourable (every dynamic end fit in its body's row), the carried
// colour as the first proposal, and no colour yet.
__global__ void color_init_kernel(int e_n, int assignable, int has_prev,
                                  const unsigned char* __restrict__ dyn_a,
                                  const unsigned char* __restrict__ dyn_b,
                                  const unsigned char* __restrict__ mask,
                                  const unsigned char* __restrict__ fit,
                                  const int* __restrict__ prev,
                                  unsigned char* __restrict__ colorable, int* __restrict__ prop,
                                  int* __restrict__ color) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_n) return;
  bool live = mask[e] != 0;
  bool ok = live && (dyn_a[e] == 0 || fit[e] != 0) && (dyn_b[e] == 0 || fit[e_n + e] != 0);
  colorable[e] = ok ? 1 : 0;
  int p = -1;
  if (has_prev != 0 && ok) {
    int c = prev[e];
    if (c >= 0 && c < assignable) p = c;
  }
  prop[e] = p;
  color[e] = -1;
}

// Lowest colour free at both ends; the highest for an edge with a
// non-dynamic end. -3 where there is none or the edge has its colour.
__global__ void color_propose_kernel(int e_n, int assignable, const int* __restrict__ body_a,
                                     const int* __restrict__ body_b,
                                     const unsigned char* __restrict__ dyn_a,
                                     const unsigned char* __restrict__ dyn_b,
                                     const unsigned char* __restrict__ colorable,
                                     const int* __restrict__ color,
                                     const unsigned int* __restrict__ used,
                                     int* __restrict__ prop) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_n) return;
  int p = -3;
  if (colorable[e] != 0 && color[e] < 0) {
    bool da = dyn_a[e] != 0, db = dyn_b[e] != 0;
    unsigned int lanes = assignable >= 32 ? 0xffffffffu : ((1u << assignable) - 1u);
    unsigned int avail = lanes;
    if (da) avail &= ~used[body_a[e]];
    if (db) avail &= ~used[body_b[e]];
    if (avail != 0u) p = (!da || !db) ? 31 - __clz(avail) : __ffs(avail) - 1;
  }
  prop[e] = p;
}

__device__ __forceinline__ bool row_has_lower(const int* __restrict__ row, int d, int e_n,
                                              int e, int p, const int* __restrict__ prop) {
  for (int r = 0; r < d; ++r) {
    int other = row[r];
    if (other >= e_n) break;
    if (other < e && prop[other] == p) return true;
  }
  return false;
}

// An edge takes its proposal unless a lower-indexed edge in the row of one of
// its dynamic ends proposes the same colour.
__global__ void color_win_kernel(int e_n, int d, const int* __restrict__ body_a,
                                 const int* __restrict__ body_b,
                                 const unsigned char* __restrict__ dyn_a,
                                 const unsigned char* __restrict__ dyn_b,
                                 const int* __restrict__ prop, const int* __restrict__ rows,
                                 int* __restrict__ color, unsigned int* __restrict__ used) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_n) return;
  int p = prop[e];
  if (p < 0) return;
  bool da = dyn_a[e] != 0, db = dyn_b[e] != 0;
  int ba = body_a[e], bb = body_b[e];
  if (da && row_has_lower(rows + ba * d, d, e_n, e, p, prop)) return;
  if (db && row_has_lower(rows + bb * d, d, e_n, e, p, prop)) return;
  color[e] = p;
  if (da) atomicOr(used + ba, 1u << p);
  if (db) atomicOr(used + bb, 1u << p);
}

__global__ void color_finish_kernel(int e_n, int max_colors,
                                    const unsigned char* __restrict__ mask,
                                    const unsigned char* __restrict__ colorable,
                                    int* __restrict__ color,
                                    unsigned char* __restrict__ is_overflow) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_n) return;
  int c = color[e];
  bool ok = colorable[e] != 0;
  is_overflow[e] = ((mask[e] != 0 && !ok) || (ok && c < 0)) ? 1 : 0;
  if (c < 0) color[e] = max_colors - 1;
}

// One thread per bucket slot (colour, r): the r-th constraint of that colour
// in sorted order. Thread 0 also counts the rows beyond capacity.
__global__ void bucket_slots_kernel(int c_n, int num_colors, int cap,
                                    const int* __restrict__ skey,
                                    const long long* __restrict__ order,
                                    long long* __restrict__ buckets,
                                    unsigned char* __restrict__ valid,
                                    int* __restrict__ counts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_colors * cap) return;
  int color = i / cap, r = i - color * cap;
  int lo = lower_bound(skey, c_n, color);
  int hi = lower_bound(skey, c_n, color + 1);
  bool ok = lo + r < hi;
  buckets[i] = ok ? order[lo + r] : 0;
  valid[i] = ok ? 1 : 0;
  if (i == 0) {
    int dropped = 0, last = 0, start = 0;
    for (int k = 0; k < num_colors; ++k) {
      int end = lower_bound(skey, c_n, k + 1);
      last = end - start;
      if (last > cap) dropped += last - cap;
      start = end;
    }
    counts[0] = dropped;
    counts[1] = (last > cap ? cap : last) + dropped;
  }
}

constexpr int kThreads = 256;

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

#define AVIAN_LAUNCH(kernel, n, ...)                                              \
  if ((n) <= 0) return 0;                                                         \
  kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(__VA_ARGS__);          \
  return (int)cudaGetLastError();

extern "C" int avian_run_rank(int n, const int* skey, int* rank, void* stream) {
  AVIAN_LAUNCH(run_rank_kernel, n, n, skey, rank)
}

extern "C" int avian_color_keys(int e_n, int n_bodies, const int* body_a, const int* body_b,
                                const unsigned char* dyn_a, const unsigned char* dyn_b,
                                const unsigned char* mask, int* key, void* stream) {
  AVIAN_LAUNCH(color_keys_kernel, e_n, e_n, n_bodies, body_a, body_b, dyn_a, dyn_b, mask, key)
}

extern "C" int avian_color_rows(int n_bodies, int n2, int e_n, int d, const int* skey,
                                const long long* order, int* rows, unsigned char* fit,
                                unsigned int* used, void* stream) {
  AVIAN_LAUNCH(color_rows_kernel, n_bodies, n_bodies, n2, e_n, d, skey, order, rows, fit, used)
}

extern "C" int avian_color_init(int e_n, int assignable, int has_prev,
                                const unsigned char* dyn_a, const unsigned char* dyn_b,
                                const unsigned char* mask, const unsigned char* fit,
                                const int* prev, unsigned char* colorable, int* prop, int* color,
                                void* stream) {
  AVIAN_LAUNCH(color_init_kernel, e_n, e_n, assignable, has_prev, dyn_a, dyn_b, mask, fit, prev,
               colorable, prop, color)
}

extern "C" int avian_color_propose(int e_n, int assignable, const int* body_a,
                                   const int* body_b, const unsigned char* dyn_a,
                                   const unsigned char* dyn_b, const unsigned char* colorable,
                                   const int* color, const unsigned int* used, int* prop,
                                   void* stream) {
  AVIAN_LAUNCH(color_propose_kernel, e_n, e_n, assignable, body_a, body_b, dyn_a, dyn_b,
               colorable, color, used, prop)
}

extern "C" int avian_color_win(int e_n, int d, const int* body_a, const int* body_b,
                               const unsigned char* dyn_a, const unsigned char* dyn_b,
                               const int* prop, const int* rows, int* color, unsigned int* used,
                               void* stream) {
  AVIAN_LAUNCH(color_win_kernel, e_n, e_n, d, body_a, body_b, dyn_a, dyn_b, prop, rows, color,
               used)
}

extern "C" int avian_color_finish(int e_n, int max_colors, const unsigned char* mask,
                                  const unsigned char* colorable, int* color,
                                  unsigned char* is_overflow, void* stream) {
  AVIAN_LAUNCH(color_finish_kernel, e_n, e_n, max_colors, mask, colorable, color, is_overflow)
}

extern "C" int avian_bucket_slots(int c_n, int num_colors, int cap, const int* skey,
                                  const long long* order, long long* buckets,
                                  unsigned char* valid, int* counts, void* stream) {
  AVIAN_LAUNCH(bucket_slots_kernel, num_colors * cap, c_n, num_colors, cap, skey, order, buckets,
               valid, counts)
}
