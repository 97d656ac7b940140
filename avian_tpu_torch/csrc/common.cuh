// Small f32 vector helpers shared by the kernels. Every sum is written in
// the order the plain PyTorch versions use ((x + y) + z), and the library is
// compiled with -fmad=false, so the kernels round like their twins.
#pragma once
#include <cuda_runtime.h>

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 mulv(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float comp(V3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
__device__ __forceinline__ Q4 load4(const float* p) { return Q4{p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ Q4 conj(Q4 q) { return Q4{-q.x, -q.y, -q.z, q.w}; }

// Hamilton product q1 * q2.
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return Q4{a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
            a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}

// v + w * t + cross(u, t), t = 2 * cross(u, v).
__device__ __forceinline__ V3 rotate(Q4 q, V3 v) {
  V3 u = v3(q.x, q.y, q.z);
  V3 t = cross(u, v) * 2.0f;
  V3 c = cross(u, t);
  return v3(v.x + q.w * t.x + c.x, v.y + q.w * t.y + c.y, v.z + q.w * t.z + c.z);
}

// Symmetric 3x3 (xx, yy, zz, xy, xz, yz) times v.
__device__ __forceinline__ V3 sym_mv(const float* s, V3 v) {
  return v3(s[0] * v.x + s[3] * v.y + s[4] * v.z,
            s[3] * v.x + s[1] * v.y + s[5] * v.z,
            s[4] * v.x + s[5] * v.y + s[2] * v.z);
}

__device__ __forceinline__ float signp(float x) { return x >= 0.0f ? 1.0f : -1.0f; }
