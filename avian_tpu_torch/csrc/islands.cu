// Kernel J: island labels and the sleep update.
//
// Replaces avian_tpu/pipeline/sleeping.py::compute_islands (:33) and
// update_sleeping (:99). See kernels/islands.py.
// island_table (one thread per sorted incidence): the fixed-degree neighbour
// table and the overflow flag.
// island_labels (one block): 10 Jacobi rounds of min-label propagation with
// pointer jumping, double-buffered: every step reads the other buffer, and a
// block barrier separates the steps, so the labels are the reference's after
// exactly 10 rounds whether or not they converged.
// sleep_update (one block): teleported islands, timers, the island all-ready
// reduction (integer atomicMin, order-free), sleep flags, zeroed velocities;
// sleep_update_2d is the same for the 2D engine (dim2/step.py:160).
// Bound by the latency of dependent integer gathers, not by bytes.
#include "common.cuh"

namespace {

constexpr int kDegree = 24;
constexpr int kStatic = 0, kDynamic = 1;
constexpr int kBlock = 1024;

__global__ void island_table_kernel(int e2, int n, const int* __restrict__ src,
                                    const int* __restrict__ sorted_key,
                                    const long long* __restrict__ order,
                                    const int* __restrict__ rank, int* __restrict__ table,
                                    unsigned char* __restrict__ overflow) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= e2) return;
  int body = sorted_key[i];
  if (body >= n) return;
  int r = rank[i];
  if (r < kDegree) {
    table[(long)body * kDegree + r] = src[order[i]];
  } else {
    overflow[body] = 1;  // every writer stores the same value
  }
}

__global__ void island_labels_kernel(int n, int rounds, const int* neighbors, int* label,
                                     int* tmp) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) label[i] = i;
  __syncthreads();
  for (int round = 0; round < rounds; ++round) {
    // label_pad[neighbors].min(1), then the minimum with the own label.
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int m = label[i];
      const int* nb = neighbors + (long)i * kDegree;
      int best = n;
      for (int k = 0; k < kDegree; ++k) {
        int j = nb[k];
        int v = j >= n ? n : label[j];
        best = v < best ? v : best;
      }
      tmp[i] = best < m ? best : m;
    }
    __syncthreads();
    // Pointer jumping: min(label, label[label]) on the step's labels.
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int l = tmp[i];
      int jump = tmp[l];
      label[i] = jump < l ? jump : l;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool teleported_body(int i, const unsigned char* sleeping,
                                                const float* pos, const float* sleep_pos,
                                                const float* quat, const float* sleep_quat) {
  if (!sleeping[i]) return false;
  bool moved = false;
  for (int k = 0; k < 3; ++k) moved = moved || fabsf(pos[3 * i + k] - sleep_pos[3 * i + k]) > 1e-6f;
  for (int k = 0; k < 4; ++k)
    moved = moved || fabsf(quat[4 * i + k] - sleep_quat[4 * i + k]) > 1e-6f;
  return moved;
}

__global__ void sleep_update_kernel(
    int n, const int* island, const unsigned char* overflow, const int* old_island,
    const unsigned char* sleeping, const unsigned char* active, const int* body_type,
    const unsigned char* sleep_disabled, const float* pos, const float* sleep_pos,
    const float* quat, const float* sleep_quat, const float* lin_vel, const float* ang_vel,
    const float* sleep_timer, unsigned char* tele_island, int* all_ready,
    unsigned char* sleep_out, float* timer_out, float* lin_out, float* ang_out, float lin_t2,
    float ang_t2, float dt, float time_to_sleep) {
  // 1. Islands (of the last step's labels) with a teleported sleeper.
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (teleported_body(i, sleeping, pos, sleep_pos, quat, sleep_quat))
      tele_island[old_island[i]] = 1;
  __syncthreads();
  // 2. Timers, and the all-ready minimum per island.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool tele = teleported_body(i, sleeping, pos, sleep_pos, quat, sleep_quat) ||
                tele_island[old_island[i]];
    V3 lv = load3(lin_vel + 3 * i), av = load3(ang_vel + 3 * i);
    bool below = dot(lv, lv) < lin_t2 && dot(av, av) < ang_t2 && !sleep_disabled[i] && !tele;
    float timer = below ? sleep_timer[i] + dt : 0.0f;
    timer_out[i] = timer;
    bool ready = timer >= time_to_sleep && !overflow[i];
    bool considered = active[i] && body_type[i] != kStatic;
    if (considered && !ready) atomicMin(all_ready + island[i], 0);
  }
  __syncthreads();
  // 3. Sleep flags, timers of woken bodies, velocities of sleepers.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool considered = active[i] && body_type[i] != kStatic;
    bool sleep = considered && all_ready[island[i]] > 0 && body_type[i] == kDynamic;
    if (sleeping[i] && !sleep) timer_out[i] = 0.0f;
    sleep_out[i] = sleep;
    for (int k = 0; k < 3; ++k) {
      lin_out[3 * i + k] = sleep ? 0.0f : lin_vel[3 * i + k];
      ang_out[3 * i + k] = sleep ? 0.0f : ang_vel[3 * i + k];
    }
  }
}

// sleep_update_kernel for the 2D engine: f32[N, 2] linear and f32[N]
// angular velocities, and no teleport test (2D bodies keep no sleep pose).
__global__ void sleep_update_2d_kernel(
    int n, const int* island, const unsigned char* overflow, const unsigned char* sleeping,
    const unsigned char* active, const int* body_type, const unsigned char* sleep_disabled,
    const float* lin_vel, const float* ang_vel, const float* sleep_timer, int* all_ready,
    unsigned char* sleep_out, float* timer_out, float* lin_out, float* ang_out, float lin_t2,
    float ang_t2, float dt, float time_to_sleep) {
  // 1. Timers, and the all-ready minimum per island.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float vx = lin_vel[2 * i], vy = lin_vel[2 * i + 1], w = ang_vel[i];
    bool below = vx * vx + vy * vy < lin_t2 && w * w < ang_t2 && !sleep_disabled[i];
    float timer = below ? sleep_timer[i] + dt : 0.0f;
    timer_out[i] = timer;
    bool ready = timer >= time_to_sleep && !overflow[i];
    bool considered = active[i] && body_type[i] != kStatic;
    if (considered && !ready) atomicMin(all_ready + island[i], 0);
  }
  __syncthreads();
  // 2. Sleep flags, timers of woken bodies, velocities of sleepers.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool considered = active[i] && body_type[i] != kStatic;
    bool sleep = considered && all_ready[island[i]] > 0 && body_type[i] == kDynamic;
    if (sleeping[i] && !sleep) timer_out[i] = 0.0f;
    sleep_out[i] = sleep;
    lin_out[2 * i] = sleep ? 0.0f : lin_vel[2 * i];
    lin_out[2 * i + 1] = sleep ? 0.0f : lin_vel[2 * i + 1];
    ang_out[i] = sleep ? 0.0f : ang_vel[i];
  }
}

}  // namespace

extern "C" int avian_island_table(int e2, int n, const int* src, const int* sorted_key,
                                  const long long* order, const int* rank, int* table,
                                  unsigned char* overflow, void* stream) {
  const int threads = 256;
  island_table_kernel<<<(e2 + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      e2, n, src, sorted_key, order, rank, table, overflow);
  return (int)cudaGetLastError();
}

extern "C" int avian_island_labels(int n, int rounds, const int* neighbors, int* label, int* tmp,
                                   void* stream) {
  island_labels_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(n, rounds, neighbors, label, tmp);
  return (int)cudaGetLastError();
}

extern "C" int avian_sleep_update(
    int n, const int* island, const unsigned char* overflow, const int* old_island,
    const unsigned char* sleeping, const unsigned char* active, const int* body_type,
    const unsigned char* sleep_disabled, const float* pos, const float* sleep_pos,
    const float* quat, const float* sleep_quat, const float* lin_vel, const float* ang_vel,
    const float* sleep_timer, unsigned char* tele_island, int* all_ready,
    unsigned char* sleep_out, float* timer_out, float* lin_out, float* ang_out, float lin_t2,
    float ang_t2, float dt, float time_to_sleep, void* stream) {
  sleep_update_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(
      n, island, overflow, old_island, sleeping, active, body_type, sleep_disabled, pos,
      sleep_pos, quat, sleep_quat, lin_vel, ang_vel, sleep_timer, tele_island, all_ready,
      sleep_out, timer_out, lin_out, ang_out, lin_t2, ang_t2, dt, time_to_sleep);
  return (int)cudaGetLastError();
}

extern "C" int avian_sleep_update_2d(
    int n, const int* island, const unsigned char* overflow, const unsigned char* sleeping,
    const unsigned char* active, const int* body_type, const unsigned char* sleep_disabled,
    const float* lin_vel, const float* ang_vel, const float* sleep_timer, int* all_ready,
    unsigned char* sleep_out, float* timer_out, float* lin_out, float* ang_out, float lin_t2,
    float ang_t2, float dt, float time_to_sleep, void* stream) {
  sleep_update_2d_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(
      n, island, overflow, sleeping, active, body_type, sleep_disabled, lin_vel, ang_vel,
      sleep_timer, all_ready, sleep_out, timer_out, lin_out, ang_out, lin_t2, ang_t2, dt,
      time_to_sleep);
  return (int)cudaGetLastError();
}
