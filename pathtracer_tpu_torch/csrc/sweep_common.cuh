// The cluster sweep's per-ray arithmetic, shared by the production sweeps
// (cluster_sweep.cu) and the sweep ablation (sweep_ablate.cu), so that the
// ablation measures the sweep's own code and not a copy of it.  Every
// product and sum is rounded on its own (the _rn intrinsics; the library
// is also built with -fmad=false), in the order of the plain PyTorch
// versions (ops/cluster._subtile_hits), so kernels and plain versions agree
// bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 512;
constexpr int SUBT = 256;
constexpr int MAXC = 128;
constexpr int PLANE_FLOATS = 12 * SUBT;
constexpr int CTAB = 12;   // ctab row: lo xyz | hi xyz | centroid xyz | pad

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// NaN-propagating min / max, matching torch.minimum / torch.maximum in the
// plain versions, so kernel and plain version take the same skips.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Per-lane slab test of box = [lo xyz, hi xyz]: live iff the ray enters
// the box before its cap.
__device__ __forceinline__ bool slab_live(const float* box, const Ray& r,
                                          float cap) {
  float t1 = (box[0] - r.ox) * r.ix, t2 = (box[3] - r.ox) * r.ix;
  float tmin = nmin(t1, t2), tmax = nmax(t1, t2);
  t1 = (box[1] - r.oy) * r.iy;
  t2 = (box[4] - r.oy) * r.iy;
  tmin = nmax(tmin, nmin(t1, t2));
  tmax = nmin(tmax, nmax(t1, t2));
  t1 = (box[2] - r.oz) * r.iz;
  t2 = (box[5] - r.oz) * r.iz;
  tmin = nmax(tmin, nmin(t1, t2));
  tmax = nmin(tmax, nmax(t1, t2));
  const float entry = nmax(tmin, 0.f);
  return (tmax >= entry) && (entry < cap);
}

__device__ __forceinline__ Ray load_ray(const float* org, const float* dir,
                                        int r) {
  Ray ray;
  ray.ox = org[3 * r];
  ray.oy = org[3 * r + 1];
  ray.oz = org[3 * r + 2];
  ray.dx = dir[3 * r];
  ray.dy = dir[3 * r + 1];
  ray.dz = dir[3 * r + 2];
  ray.ix = 1.f / ray.dx;
  ray.iy = 1.f / ray.dy;
  ray.iz = 1.f / ray.dz;
  return ray;
}

// Copy one subtile's planes (12 x SUBT floats) into shared memory.
__device__ __forceinline__ void stage_planes(float* sp, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(sp);
  for (int i = threadIdx.x; i < PLANE_FLOATS / 4; i += BLOCK) d4[i] = s4[i];
}

// (a*x + b*y) + c*z with every product and sum rounded on its own: the
// _rn intrinsics are never contracted into FMAs, so the kernel rounds
// exactly as the plain PyTorch version (ops/cluster._subtile_hits) does.
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

// t and barycentric acceptance of triangle j of the staged subtile.
__device__ __forceinline__ bool tri_test(const float* sp, int j, float oxc,
                                         float oyc, float ozc, const Ray& r,
                                         float tn, float* t_out) {
  const float* n = sp + j;
  const float* u = sp + 4 * SUBT + j;
  const float* v = sp + 8 * SUBT + j;
  const float on = __fadd_rn(dot3(oxc, oyc, ozc, n[0], n[SUBT], n[2 * SUBT]),
                             n[3 * SUBT]);
  const float t = __fdiv_rn(on, -dot3(r.dx, r.dy, r.dz, n[0], n[SUBT],
                                      n[2 * SUBT]));
  const float ou = __fadd_rn(dot3(oxc, oyc, ozc, u[0], u[SUBT], u[2 * SUBT]),
                             u[3 * SUBT]);
  const float ov = __fadd_rn(dot3(oxc, oyc, ozc, v[0], v[SUBT], v[2 * SUBT]),
                             v[3 * SUBT]);
  const float beta = __fadd_rn(
      ou, __fmul_rn(t, dot3(r.dx, r.dy, r.dz, u[0], u[SUBT], u[2 * SUBT])));
  const float gamma = __fadd_rn(
      ov, __fmul_rn(t, dot3(r.dx, r.dy, r.dz, v[0], v[SUBT], v[2 * SUBT])));
  *t_out = t;
  return (t > tn) && (beta >= 0.f) && (gamma >= 0.f) &&
         (__fsub_rn(1.f, __fadd_rn(beta, gamma)) >= 0.f);
}

}  // namespace
