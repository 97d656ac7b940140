// Kernel X: the 2D engine's packed constraint rows, straight into bucket order.
//
// Replaces avian_tpu/dim2/solver.py::prepare_constraints (:87) around the
// colouring. pack_count_2d: per row of the last (overflow) colour, an int32
// atomicAdd to each dynamic end's count (order free). pack_rows_2d: one
// thread a bucket slot writes its 33-float row, its 6 impulses, its bodies
// and its relaxation (d2::pack_slot_2d in dim2.cuh). Bound by bytes.
#include "dim2.cuh"

namespace {

__global__ void pack_count_2d_kernel(int cap, const long long* __restrict__ buckets_last,
                                     const unsigned char* __restrict__ valid_last,
                                     const int* __restrict__ body_a, const int* __restrict__ body_b,
                                     const unsigned char* __restrict__ dyn_a,
                                     const unsigned char* __restrict__ dyn_b, int* cnt) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= cap || !valid_last[row]) return;
  int c = (int)buckets_last[row];
  if (dyn_a[c]) atomicAdd(cnt + body_a[c], 1);
  if (dyn_b[c]) atomicAdd(cnt + body_b[c], 1);
}

struct Soft {
  float dyn[3], non_dyn[3];
};

__global__ void pack_rows_2d_kernel(int colors, int cap, d2::PackIn2 in, Soft soft,
                                    d2::PackOut2 out) {
  long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long)colors * cap) return;
  d2::pack_slot_2d((int)(g / cap), (int)(g % cap), colors, cap, in, soft.dyn, soft.non_dyn, out);
}

}  // namespace

extern "C" int avian_pack_count_2d(int cap, const long long* buckets_last,
                                   const unsigned char* valid_last, const int* body_a,
                                   const int* body_b, const unsigned char* dyn_a,
                                   const unsigned char* dyn_b, int* cnt, void* stream) {
  const int threads = 256;
  pack_count_2d_kernel<<<(cap + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      cap, buckets_last, valid_last, body_a, body_b, dyn_a, dyn_b, cnt);
  return (int)cudaGetLastError();
}

extern "C" int avian_pack_rows_2d(
    int colors, int cap, const long long* buckets, const unsigned char* bucket_valid,
    const int* body_a, const int* body_b, const unsigned char* dyn_a, const unsigned char* dyn_b,
    const unsigned char* solve, const float* normal, const float* anchor_a,
    const float* anchor_b, const float* penetration, const int* num_points,
    const float* friction, const float* sfriction, const float* restitution,
    const float* surface_speed, const float* nimp, const float* timp, const int* body_type,
    const unsigned char* sleeping, const int* dominance, const float* state,
    const float* inv_mass, const float* inv_inertia, const int* cnt, float* data, float* imp,
    int* bucket_a, int* bucket_b, float* relax, float d0, float d1, float d2_, float n0,
    float n1, float n2, void* stream) {
  d2::PackIn2 in{buckets,   bucket_valid, body_a,   body_b,      dyn_a,         dyn_b,
                 solve,     normal,       anchor_a, anchor_b,    penetration,   num_points,
                 friction,  sfriction,    restitution, surface_speed, nimp,      timp,
                 body_type, sleeping,     dominance, state,      inv_mass,      inv_inertia,
                 cnt};
  d2::PackOut2 out{data, imp, bucket_a, bucket_b, relax};
  Soft soft{{d0, d1, d2_}, {n0, n1, n2}};
  const int threads = 128;
  long n = (long)colors * cap;
  pack_rows_2d_kernel<<<(int)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      colors, cap, in, soft, out);
  return (int)cudaGetLastError();
}
