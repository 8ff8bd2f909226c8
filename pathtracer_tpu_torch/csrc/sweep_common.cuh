// The cluster sweep's per-ray arithmetic and plane staging, shared by the
// production sweeps (cluster_sweep.cu) and the sweep ablation
// (sweep_ablate.cu), so that the ablation measures the sweep's own code
// and not a copy of it.  Every
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

// ---- staging: the 1-D bulk copy of one subtile's planes and its mbarrier
// (PTX), and the lane group's barrier and vote ----

constexpr unsigned PLANE_BYTES = PLANE_FLOATS * sizeof(float);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// One thread: expect PLANE_BYTES on `bar` and start copying them from
// global `src` into shared `dst` (both 16-byte aligned).
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(PLANE_BYTES) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(PLANE_BYTES),
         "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A copy
// lands within microseconds; one that has not landed after about 2^33
// cycles (seconds) is a fault, and the kernel traps instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const long long t0 = clock64();
  unsigned done;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// Vote and barrier over a lane group of G threads (one block).
template <int G>
__device__ __forceinline__ bool group_any(bool p) {
  if constexpr (G == 32) return __any_sync(0xffffffffu, p);
  else return __syncthreads_or(p);
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32) __syncwarp();
  else __syncthreads();
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
