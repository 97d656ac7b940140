// Kernel D: one color of the contact solver, one thread per bucket row.
//
// Replaces, per color, avian_tpu/pipeline/solver.py::warm_start (mode 0),
// _solve_bucket (modes 1 = bias, 2 = relax) and _restitution_bucket (mode 3).
// A launch is one color's rows; the substep is a chain of such launches, so
// the solver is bound by launch latency and the dependent gathers of body
// state, not by its arithmetic. Rules (see kernels/solve_color.py):
// - a padded row (valid == 0) writes nothing;
// - an endpoint with zero inverse mass and inertia gets exactly zero deltas
//   and is not written (the static ground body is in most rows);
// - colors before the last share no dynamic body: deltas go straight to the
//   body rows;
// - the last (overflow) color may share bodies: phase 1 writes each row's
//   deltas to scratch, phase 2 gives one thread to each body and adds them
//   in the fixed [a-sides..., b-sides...] order. No float atomics, so a
//   rerun is bitwise identical.
#include "common.cuh"

namespace {

enum { kWarm = 0, kBias = 1, kRelax = 2, kRestitution = 3 };
// Packed row layout (solver.py :46-67).
enum {
  N_ = 0, T1 = 3, T2 = 6, FRICTION = 9, REST = 10, SOFT = 11, IMA = 14, IMB = 17,
  IIA = 20, IIB = 26, AA = 32, AB = 44, SEP = 56, NM = 60, TK = 64, NS = 76, PM = 80,
  SV = 84, SF = 87, D = 88, IMP = 16
};
constexpr int kStateCols = 13;

struct Params {
  float h, max_overlap, stiction_t2, warm_coeff, rest_threshold;
};

struct Deltas {
  V3 va, wa, vb, wb;
};

__device__ __forceinline__ void apply(Deltas& dl, const float* d, V3 r1, V3 r2, V3 pvec) {
  V3 ima = load3(d + IMA), imb = load3(d + IMB);
  dl.va = dl.va - mulv(pvec, ima);
  dl.wa = dl.wa - sym_mv(d + IIA, cross(r1, pvec));
  dl.vb = dl.vb + mulv(pvec, imb);
  dl.wb = dl.wb + sym_mv(d + IIB, cross(r2, pvec));
}

__device__ __forceinline__ V3 rel_vel(const Deltas& dl, V3 va, V3 wa, V3 vb, V3 wb, V3 r1, V3 r2) {
  return (vb + dl.vb + cross(wb + dl.wb, r2)) - (va + dl.va + cross(wa + dl.wa, r1));
}

__device__ __forceinline__ bool writes(const float* im, const float* ii) {
  bool w = false;
  for (int k = 0; k < 3; ++k) w = w || im[k] != 0.0f;
  for (int k = 0; k < 6; ++k) w = w || ii[k] != 0.0f;
  return w;
}

__device__ void add_velocity(float* s, V3 dv, V3 dw) {
  s[0] += dv.x;
  s[1] += dv.y;
  s[2] += dv.z;
  s[3] += dw.x;
  s[4] += dw.y;
  s[5] += dw.z;
}

__global__ void solve_color_kernel(int mode, int color, int cap, int last,
                                   float* __restrict__ state, const float* __restrict__ data,
                                   float* __restrict__ imp, const int* __restrict__ bucket_a,
                                   const int* __restrict__ bucket_b,
                                   const unsigned char* __restrict__ valid,
                                   const float* __restrict__ relax,
                                   float* __restrict__ scratch, Params p) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= cap) return;
  long g = (long)color * cap + row;
  if (!valid[g]) return;
  const float* d = data + g * D;
  float* ir = imp + g * IMP;
  float* sa = state + (long)bucket_a[g] * kStateCols;
  float* sb = state + (long)bucket_b[g] * kStateCols;
  V3 va = load3(sa), wa = load3(sa + 3), vb = load3(sb), wb = load3(sb + 3);
  V3 n = load3(d + N_);
  float pm[4] = {d[PM], d[PM + 1], d[PM + 2], d[PM + 3]};
  float rlx = relax[g];
  Deltas dl{v3(0.f, 0.f, 0.f), v3(0.f, 0.f, 0.f), v3(0.f, 0.f, 0.f), v3(0.f, 0.f, 0.f)};
  float out[IMP];
  for (int k = 0; k < IMP; ++k) out[k] = ir[k];

  if (mode == kWarm) {
    V3 t1 = load3(d + T1), t2 = load3(d + T2);
    V3 p_sum = v3(0.f, 0.f, 0.f), ca = v3(0.f, 0.f, 0.f), cb = v3(0.f, 0.f, 0.f);
    for (int i = 0; i < 4; ++i) {
      float np = ir[i] * pm[i];
      float tp0 = ir[4 + 2 * i] * pm[i];
      float tp1 = ir[5 + 2 * i] * pm[i];
      V3 pv = (n * np + t1 * tp0 + t2 * tp1) * p.warm_coeff;
      p_sum = p_sum + pv;
      ca = ca + cross(load3(d + AA + 3 * i), pv);
      cb = cb + cross(load3(d + AB + 3 * i), pv);
    }
    dl.va = mulv(-p_sum, load3(d + IMA));
    dl.wa = -sym_mv(d + IIA, ca);
    dl.vb = mulv(p_sum, load3(d + IMB));
    dl.wb = sym_mv(d + IIB, cb);
  } else if (mode == kRestitution) {
    float rest = d[REST];
    float vmask = rest > 0.0f ? 1.0f : 0.0f;
    for (int i = 0; i < 4; ++i) {
      V3 r1 = load3(d + AA + 3 * i), r2 = load3(d + AB + 3 * i);
      float ns = d[NS + i];
      float active = (ns < -p.rest_threshold && ir[12 + i] > 0.0f) ? 1.0f : 0.0f;
      float pmi = pm[i] * vmask * active;
      float vn = dot(rel_vel(dl, va, wa, vb, wb, r1, r2), n);
      float delta = -d[NM + i] * (vn + rest * ns);
      float acc = ir[i];
      float new_acc = fmaxf(acc + rlx * delta, 0.0f);
      float applied = (new_acc - acc) * pmi;
      out[i] = pmi > 0.0f ? new_acc : acc;
      out[12 + i] = ir[12 + i] + applied;
      apply(dl, d, r1, r2, n * applied);
    }
  } else {
    bool use_bias = mode == kBias;
    Q4 dq_a = load4(sa + 9), dq_b = load4(sb + 9);
    V3 dtr = load3(sb + 6) - load3(sa + 6);
    float soft_bias = d[SOFT], soft_mass = d[SOFT + 1], soft_imp = d[SOFT + 2];
    for (int i = 0; i < 4; ++i) {
      V3 r1 = load3(d + AA + 3 * i), r2 = load3(d + AB + 3 * i);
      V3 delta_sep = dtr + (rotate(dq_b, r2) - rotate(dq_a, r1));
      float sep = dot(delta_sep, n) + d[SEP + i];
      float vn = dot(rel_vel(dl, va, wa, vb, wb, r1, r2), n);
      float m_eff = d[NM + i];
      float acc = ir[i];
      float spec = -m_eff * (vn + sep / p.h);
      float inner;
      if (use_bias) {
        float sbias = fmaxf(soft_bias * sep, -p.max_overlap);
        inner = -m_eff * soft_mass * (vn + sbias) - soft_imp * acc;
      } else {
        inner = -m_eff * vn;
      }
      float delta = sep > 0.0f ? spec : inner;
      float new_acc = fmaxf(acc + rlx * delta, 0.0f);
      float applied = (new_acc - acc) * pm[i];
      bool on = pm[i] > 0.0f;
      out[i] = on ? new_acc : acc;
      out[12 + i] = ir[12 + i] + (on ? new_acc : 0.0f);
      apply(dl, d, r1, r2, n * applied);
    }
    V3 t1 = load3(d + T1), t2 = load3(d + T2), sv = load3(d + SV);
    for (int i = 0; i < 4; ++i) {
      V3 r1 = load3(d + AA + 3 * i), r2 = load3(d + AB + 3 * i);
      V3 rv = rel_vel(dl, va, wa, vb, wb, r1, r2) + sv;
      float vt1 = dot(rv, t1), vt2 = dot(rv, t2);
      float k1 = d[TK + 3 * i], k2 = d[TK + 3 * i + 1], k12 = d[TK + 3 * i + 2];
      float t11 = vt1 * vt1, t22 = vt2 * vt2, t12 = vt1 * vt2;
      float inv = t11 * k1 + t22 * k2 + t12 * k12;
      float recip = inv != 0.0f ? 1.0f / inv : 0.0f;
      float m_eff = (t11 + t22) * recip;
      if (!isfinite(m_eff)) m_eff = 0.0f;
      float acc0 = ir[4 + 2 * i], acc1 = ir[5 + 2 * i];
      float mu = (t11 + t22 <= p.stiction_t2) ? d[SF] : d[FRICTION];
      float limit = mu * out[i];
      float x0 = acc0 - rlx * (m_eff * vt1);
      float x1 = acc1 - rlx * (m_eff * vt2);
      float n2 = x0 * x0 + x1 * x1;
      float scale = n2 > limit * limit ? limit / sqrtf(fmaxf(n2, 1e-12f)) : 1.0f;
      float new0 = x0 * scale, new1 = x1 * scale;
      bool on = pm[i] > 0.0f;
      float ap0 = (new0 - acc0) * pm[i], ap1 = (new1 - acc1) * pm[i];
      out[4 + 2 * i] = on ? new0 : acc0;
      out[5 + 2 * i] = on ? new1 : acc1;
      apply(dl, d, r1, r2, t1 * ap0 + t2 * ap1);
    }
  }

  if (mode != kWarm)
    for (int k = 0; k < IMP; ++k) ir[k] = out[k];
  if (last) {
    float* s0 = scratch + 6 * (long)row;
    float* s1 = scratch + 6 * ((long)cap + row);
    store3(s0, dl.va);
    store3(s0 + 3, dl.wa);
    store3(s1, dl.vb);
    store3(s1 + 3, dl.wb);
  } else {
    if (writes(d + IMA, d + IIA)) add_velocity(sa, dl.va, dl.wa);
    if (writes(d + IMB, d + IIB)) add_velocity(sb, dl.vb, dl.wb);
  }
}

// Phase 2 of the overflow color: per body, add its rows' deltas in order.
__global__ void overflow_reduce_kernel(int entries, int n_bodies, float* __restrict__ state,
                                       const int* __restrict__ order,
                                       const int* __restrict__ key,
                                       const float* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  int body = key[i];
  if (body >= n_bodies || (i > 0 && key[i - 1] == body)) return;
  float* s = state + (long)body * kStateCols;
  float v[6];
  for (int k = 0; k < 6; ++k) v[k] = s[k];
  for (int j = i; j < entries && key[j] == body; ++j) {
    const float* src = scratch + 6 * (long)order[j];
    for (int k = 0; k < 6; ++k) v[k] += src[k];
  }
  for (int k = 0; k < 6; ++k) s[k] = v[k];
}

}  // namespace

extern "C" int avian_solve_color(int mode, int color, int colors, int cap, int n_bodies,
                                 float* state, const float* data, float* imp,
                                 const int* bucket_a, const int* bucket_b,
                                 const unsigned char* valid, const float* relax,
                                 const int* ovf_order, const int* ovf_key, float* scratch,
                                 float h, float max_overlap, float stiction_t2,
                                 float warm_coeff, float rest_threshold, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  int last = color == colors - 1;
  Params p{h, max_overlap, stiction_t2, warm_coeff, rest_threshold};
  solve_color_kernel<<<(cap + threads - 1) / threads, threads, 0, s>>>(
      mode, color, cap, last, state, data, imp, bucket_a, bucket_b, valid, relax, scratch, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  overflow_reduce_kernel<<<(2 * cap + threads - 1) / threads, threads, 0, s>>>(
      2 * cap, n_bodies, state, ovf_order, ovf_key, scratch);
  return (int)cudaGetLastError();
}
