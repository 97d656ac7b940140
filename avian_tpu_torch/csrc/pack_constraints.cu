// Kernel H: packing of the contact constraints into colour-bucket order.
//
// Replaces avian_tpu/pipeline/solver.py::prepare_constraints (:158) around
// the colouring: the solve flags, the 88-float constraint row and 16-float
// impulse row of every bucket slot, bucket_a/b and the overflow colour's
// relaxation.
//
// pack_flags (one thread per constraint): which ends are dynamic, whether the
// constraint is solved, and its stored impulses as a 16-float row.
// pack_count (one thread per slot of the last colour): how many of that
// colour's rows touch each dynamic body, by atomicAdd on int32 (order-free).
// pack_rows (one thread per bucket slot): reads the slot's contact row and
// both bodies and writes data[colour, slot, 88], imp[colour, slot, 16],
// bucket_a/b and relax straight in bucket order: no [C, 88] intermediate and
// no gather. Bound by bytes: a slot reads about 330 and writes 428. Every
// sum is spelled in the plain version's order and the file is compiled with
// -fmad=false. A padded slot (valid false) packs constraint 0 with a zero
// point mask, so that it still names a real body.
#include "common.cuh"

namespace {

constexpr int kDynamic = 1;
constexpr int kD = 88, kImp = 16;

__global__ void pack_flags_kernel(int c_n, const int* __restrict__ body_a,
                                  const int* __restrict__ body_b,
                                  const unsigned char* __restrict__ active,
                                  const unsigned char* __restrict__ touching,
                                  const unsigned char* __restrict__ sensor,
                                  const float* __restrict__ solve_mask,
                                  const float* __restrict__ nimp, const float* __restrict__ timp,
                                  unsigned char* __restrict__ dyn_a,
                                  unsigned char* __restrict__ dyn_b,
                                  unsigned char* __restrict__ solve,
                                  float* __restrict__ base_imp) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_n) return;
  bool da = solve_mask[body_a[c]] > 0.0f;
  bool db = solve_mask[body_b[c]] > 0.0f;
  dyn_a[c] = da ? 1 : 0;
  dyn_b[c] = db ? 1 : 0;
  solve[c] = (active[c] != 0 && touching[c] != 0 && sensor[c] == 0 && (da || db)) ? 1 : 0;
  float* o = base_imp + kImp * c;
  for (int i = 0; i < 4; ++i) o[i] = nimp[4 * c + i];
  for (int i = 0; i < 8; ++i) o[4 + i] = timp[8 * c + i];
  for (int i = 12; i < 16; ++i) o[i] = 0.0f;
}

__global__ void pack_count_kernel(int cap, const long long* __restrict__ buckets_last,
                                  const unsigned char* __restrict__ valid_last,
                                  const int* __restrict__ body_a, const int* __restrict__ body_b,
                                  const unsigned char* __restrict__ dyn_a,
                                  const unsigned char* __restrict__ dyn_b,
                                  int* __restrict__ cnt) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= cap || valid_last[r] == 0) return;
  long long c = buckets_last[r];
  if (dyn_a[c] != 0) atomicAdd(cnt + body_a[c], 1);
  if (dyn_b[c] != 0) atomicAdd(cnt + body_b[c], 1);
}

__device__ __forceinline__ float safe_recip(float x) { return x != 0.0f ? __fdiv_rn(1.0f, x) : 0.0f; }

// A unit vector orthogonal to unit n (Duff et al. 2017).
__device__ __forceinline__ V3 any_orthonormal(V3 n) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = __fdiv_rn(-1.0f, sign + n.z);
  float b = n.x * n.y * a;
  return v3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
}

__device__ __forceinline__ V3 normalize_or(V3 a, V3 fallback) {
  float n2 = dot(a, a);
  if (!(n2 > 1e-12f)) return fallback;
  float inv = __fdiv_rn(1.0f, sqrtf(n2 < 1e-12f ? 1e-12f : n2));
  return a * inv;
}

struct PackIn {
  const long long* buckets;
  const unsigned char* valid;
  const int* body_a;
  const int* body_b;
  const unsigned char* dyn_a;
  const unsigned char* dyn_b;
  const unsigned char* solve;
  const float* normal;
  const float* anchor_a;
  const float* anchor_b;
  const float* penetration;
  const int* num_points;
  const float* friction;
  const float* restitution;
  const float* static_friction;
  const float* surface_velocity;
  const float* base_imp;
  const int* body_type;
  const unsigned char* sleeping;
  const int* dominance;
  const float* lin_vel;
  const float* state;
  const float* inv_mass;
  const float* inv_inertia;
  const int* cnt;
};

__global__ void pack_rows_kernel(int colors, int cap, PackIn in, float dyn_bias, float dyn_mass,
                                 float dyn_imp, float nd_bias, float nd_mass, float nd_imp,
                                 float* __restrict__ data, float* __restrict__ imp,
                                 int* __restrict__ bucket_a, int* __restrict__ bucket_b,
                                 float* __restrict__ relax) {
  int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= colors * cap) return;
  bool valid = in.valid[slot] != 0;
  long long c = in.buckets[slot];
  int ba = in.body_a[c], bb = in.body_b[c];
  bucket_a[slot] = ba;
  bucket_b[slot] = bb;

  // Overflow colour: 1 / (most rows of this colour on either dynamic end).
  float rlx = 1.0f;
  if (slot >= (colors - 1) * cap) {
    int na = (valid && in.dyn_a[c] != 0) ? in.cnt[ba] : 1;
    int nb = (valid && in.dyn_b[c] != 0) ? in.cnt[bb] : 1;
    float mult = (float)(na > nb ? na : nb);
    rlx = __fdiv_rn(1.0f, mult < 1.0f ? 1.0f : mult);
  }
  relax[slot] = rlx;

  float* io = imp + (long long)kImp * slot;
  const float* ii = in.base_imp + kImp * c;
  for (int i = 0; i < kImp; ++i) io[i] = ii[i];

  // Dominance: the body of higher dominance acts as static.
  int dom_a = (in.body_type[ba] == kDynamic && in.sleeping[ba] == 0) ? in.dominance[ba] : 127;
  int dom_b = (in.body_type[bb] == kDynamic && in.sleeping[bb] == 0) ? in.dominance[bb] : 127;
  int rel_dom = dom_a - dom_b;
  float ima[3], imb[3], iia[6], iib[6];
  for (int i = 0; i < 3; ++i) {
    ima[i] = rel_dom > 0 ? 0.0f : in.inv_mass[3 * ba + i];
    imb[i] = rel_dom < 0 ? 0.0f : in.inv_mass[3 * bb + i];
  }
  for (int i = 0; i < 6; ++i) {
    iia[i] = rel_dom > 0 ? 0.0f : in.inv_inertia[6 * ba + i];
    iib[i] = rel_dom < 0 ? 0.0f : in.inv_inertia[6 * bb + i];
  }

  V3 n = load3(in.normal + 3 * c);
  V3 fdir = -n;
  V3 rel_v = load3(in.lin_vel + 3 * ba) - load3(in.lin_vel + 3 * bb);
  V3 tang_v = rel_v - fdir * dot(fdir, rel_v);
  V3 t1 = normalize_or(tang_v, any_orthonormal(fdir));
  V3 t2 = cross(fdir, t1);

  float* d = data + (long long)kD * slot;
  store3(d + 0, n);
  store3(d + 3, t1);
  store3(d + 6, t2);
  d[9] = in.friction[c];
  d[10] = in.restitution[c];
  d[11] = rel_dom != 0 ? nd_bias : dyn_bias;
  d[12] = rel_dom != 0 ? nd_mass : dyn_mass;
  d[13] = rel_dom != 0 ? nd_imp : dyn_imp;
  for (int i = 0; i < 3; ++i) {
    d[14 + i] = ima[i];
    d[17 + i] = imb[i];
  }
  for (int i = 0; i < 6; ++i) {
    d[20 + i] = iia[i];
    d[26 + i] = iib[i];
  }

  V3 im_sum = v3(ima[0] + imb[0], ima[1] + imb[1], ima[2] + imb[2]);
  float kn_lin = dot(n, mulv(im_sum, n));
  float k1_lin = dot(t1, mulv(im_sum, t1));
  float k2_lin = dot(t2, mulv(im_sum, t2));
  const float* sa = in.state + 13 * ba;
  const float* sb = in.state + 13 * bb;
  V3 lva = load3(sa), wa = load3(sa + 3);
  V3 lvb = load3(sb), wb = load3(sb + 3);
  int np = in.num_points[c];
  bool solve = in.solve[c] != 0;

  for (int i = 0; i < 4; ++i) {
    V3 r1 = load3(in.anchor_a + 3 * (4 * c + i));
    V3 r2 = load3(in.anchor_b + 3 * (4 * c + i));
    store3(d + 32 + 3 * i, r1);
    store3(d + 44 + 3 * i, r2);

    V3 r1xn = cross(r1, n), r2xn = cross(r2, n);
    float k_normal = kn_lin + dot(r1xn, sym_mv(iia, r1xn)) + dot(r2xn, sym_mv(iib, r2xn));
    d[60 + i] = safe_recip(k_normal);

    V3 rt11 = cross(r1, t1), rt12 = cross(r2, t1);
    V3 rt21 = cross(r1, t2), rt22 = cross(r2, t2);
    V3 i1_rt11 = sym_mv(iia, rt11), i2_rt12 = sym_mv(iib, rt12);
    V3 i1_rt21 = sym_mv(iia, rt21), i2_rt22 = sym_mv(iib, rt22);
    d[64 + 3 * i + 0] = k1_lin + dot(rt11, i1_rt11) + dot(rt12, i2_rt12);
    d[64 + 3 * i + 1] = k2_lin + dot(rt21, i1_rt21) + dot(rt22, i2_rt22);
    d[64 + 3 * i + 2] = 2.0f * (dot(rt11, i1_rt21) + dot(rt12, i2_rt22));

    d[56 + i] = -in.penetration[4 * c + i] - dot(r2 - r1, n);
    V3 v_a = lva + cross(wa, r1);
    V3 v_b = lvb + cross(wb, r2);
    d[76 + i] = dot(v_b - v_a, n);
    d[80 + i] = (valid && solve && i < np) ? 1.0f : 0.0f;
  }
  store3(d + 84, load3(in.surface_velocity + 3 * c));
  d[87] = in.static_friction[c];
}

}  // namespace

extern "C" int avian_pack_flags(int c_n, const int* body_a, const int* body_b,
                                const unsigned char* active, const unsigned char* touching,
                                const unsigned char* sensor, const float* solve_mask,
                                const float* nimp, const float* timp, unsigned char* dyn_a,
                                unsigned char* dyn_b, unsigned char* solve, float* base_imp,
                                void* stream) {
  if (c_n <= 0) return 0;
  const int threads = 256;
  pack_flags_kernel<<<(c_n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      c_n, body_a, body_b, active, touching, sensor, solve_mask, nimp, timp, dyn_a, dyn_b, solve,
      base_imp);
  return (int)cudaGetLastError();
}

extern "C" int avian_pack_count(int cap, const long long* buckets_last,
                                const unsigned char* valid_last, const int* body_a,
                                const int* body_b, const unsigned char* dyn_a,
                                const unsigned char* dyn_b, int* cnt, void* stream) {
  const int threads = 256;
  pack_count_kernel<<<(cap + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      cap, buckets_last, valid_last, body_a, body_b, dyn_a, dyn_b, cnt);
  return (int)cudaGetLastError();
}

extern "C" int avian_pack_rows(
    int colors, int cap, const long long* buckets, const unsigned char* valid, const int* body_a,
    const int* body_b, const unsigned char* dyn_a, const unsigned char* dyn_b,
    const unsigned char* solve, const float* normal, const float* anchor_a,
    const float* anchor_b, const float* penetration, const int* num_points,
    const float* friction, const float* restitution, const float* static_friction,
    const float* surface_velocity, const float* base_imp, const int* body_type,
    const unsigned char* sleeping, const int* dominance, const float* lin_vel,
    const float* state, const float* inv_mass, const float* inv_inertia, const int* cnt,
    float* data, float* imp, int* bucket_a, int* bucket_b, float* relax, float dyn_bias,
    float dyn_mass, float dyn_imp, float nd_bias, float nd_mass, float nd_imp, void* stream) {
  PackIn in{buckets,     valid,       body_a,   body_b,      dyn_a,           dyn_b,
            solve,       normal,      anchor_a, anchor_b,    penetration,     num_points,
            friction,    restitution, static_friction, surface_velocity, base_imp,
            body_type,   sleeping,    dominance, lin_vel,    state,           inv_mass,
            inv_inertia, cnt};
  const int threads = 128;
  int n = colors * cap;
  pack_rows_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      colors, cap, in, dyn_bias, dyn_mass, dyn_imp, nd_bias, nd_mass, nd_imp, data, imp, bucket_a,
      bucket_b, relax);
  return (int)cudaGetLastError();
}
