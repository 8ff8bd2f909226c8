// Hand-written Hopper (sm_90a) ablation of the cluster sweep, bound
// through a plain C interface (ctypes, ops/sweep_ablate.py).
//
// Replaces the TPU kernel scripts/tpu_ablate_sweep.py::make_kernel(variant)
// and asks its question of the port's own sweep (cluster_sweep.cu): what
// share of a slot's time goes to staging the planes, to the six ray-plane
// dot families, to the IEEE divide and to the winner logic.  Every variant
// runs the loop of sweep_kernel<false> at fixed work: every slot up to
// min(count, SLOTS) and every subtile, with no slab skip and no early
// break (the TPU variants have neither), so variants differ only in the
// per-pair arithmetic.  The per-pair code is sweep_common.cuh's own.
//
// Variants (each a deterministic function; ops/sweep_ablate.py holds the
// plain version of each):
//   FULL       closest hit, exact argmin, ties to the lower triangle: t, tri
//   NO_LOAD    FULL on the packet's first slot's first subtile, staged once
//              and reused for every slot and subtile (the TPU's no-dma
//              variant reads stale VMEM, which cannot be reproduced)
//   NO_PRODUCTS each dot family replaced by the sum of two plane rows, no
//              ray term (the TPU's no-mxu); the epilogue as FULL
//   NO_EPI     the six families, then the min of their sum into best t
//              (the TPU's no-epi keeps only o.n; here a compiler would then
//              drop the other five families, so their sum keeps them live)
//   TONLY      t = on / -dn, min into best t
//   ACC_ONLY   full acceptance, min accepted t, no winner index
//   LEAN, NOTB, PK  the TPU's packed-key winner (bits(t) & ~0xFF) | j, one
//              integer min per subtile: NOTB returns the truncated t, LEAN
//              and PK the exact t of the winning index; PK also beta, gamma
//
// What bounds it on an H100: fp32 instruction throughput, as the sweep
// (41 fp32 operations and one IEEE divide per ray-triangle pair, planes
// reused by 512 rays from shared memory).

#include <limits.h>

#include "sweep_common.cuh"

namespace {

constexpr int SLOTS = 8;          // slots swept per packet
constexpr float BIG_T = 1e30f;

enum Variant {
  FULL = 0, NO_LOAD, NO_PRODUCTS, NO_EPI, TONLY, ACC_ONLY, LEAN, NOTB, PK
};

// The six dot families of triangle j (dn, du, dv without the sweep's
// negation), rounded as tri_test rounds them.
struct Families {
  float on, ou, ov, dn, du, dv;
};

__device__ __forceinline__ Families families(const float* sp, int j,
                                             float oxc, float oyc, float ozc,
                                             const Ray& r) {
  const float* n = sp + j;
  const float* u = sp + 4 * SUBT + j;
  const float* v = sp + 8 * SUBT + j;
  Families f;
  f.on = __fadd_rn(dot3(oxc, oyc, ozc, n[0], n[SUBT], n[2 * SUBT]),
                   n[3 * SUBT]);
  f.ou = __fadd_rn(dot3(oxc, oyc, ozc, u[0], u[SUBT], u[2 * SUBT]),
                   u[3 * SUBT]);
  f.ov = __fadd_rn(dot3(oxc, oyc, ozc, v[0], v[SUBT], v[2 * SUBT]),
                   v[3 * SUBT]);
  f.dn = dot3(r.dx, r.dy, r.dz, n[0], n[SUBT], n[2 * SUBT]);
  f.du = dot3(r.dx, r.dy, r.dz, u[0], u[SUBT], u[2 * SUBT]);
  f.dv = dot3(r.dx, r.dy, r.dz, v[0], v[SUBT], v[2 * SUBT]);
  return f;
}

// NO_PRODUCTS: each family is the sum of two of the triangle's plane rows.
__device__ __forceinline__ Families row_sums(const float* sp, int j) {
  const float* n = sp + j;
  const float* u = sp + 4 * SUBT + j;
  const float* v = sp + 8 * SUBT + j;
  Families f;
  f.on = __fadd_rn(n[0], n[3 * SUBT]);
  f.ou = __fadd_rn(u[0], u[3 * SUBT]);
  f.ov = __fadd_rn(v[0], v[3 * SUBT]);
  f.dn = __fadd_rn(n[SUBT], n[2 * SUBT]);
  f.du = __fadd_rn(u[SUBT], u[2 * SUBT]);
  f.dv = __fadd_rn(v[SUBT], v[2 * SUBT]);
  return f;
}

// t, beta, gamma and acceptance from the families, as tri_test.
__device__ __forceinline__ bool accept(const Families& f, float tn, float* t,
                                       float* beta, float* gamma) {
  *t = __fdiv_rn(f.on, -f.dn);
  *beta = __fadd_rn(f.ou, __fmul_rn(*t, f.du));
  *gamma = __fadd_rn(f.ov, __fmul_rn(*t, f.dv));
  return (*t > tn) && (*beta >= 0.f) && (*gamma >= 0.f) &&
         (__fsub_rn(1.f, __fadd_rn(*beta, *gamma)) >= 0.f);
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
ablate_kernel(const int* __restrict__ ids, const int* __restrict__ counts,
              const float* __restrict__ planes, const float* __restrict__ ctab,
              const int* __restrict__ starts, int n_sub,
              const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ tmax, const float* __restrict__ tmin,
              float* __restrict__ t_out, int* __restrict__ tri_out,
              float* __restrict__ be_out, float* __restrict__ ga_out) {
  __shared__ __align__(16) float sp[PLANE_FLOATS];
  const int b = blockIdx.x;
  const int r = b * BLOCK + threadIdx.x;
  const Ray ray = load_ray(org, dir, r);
  const float tn = fmaxf(tmin[r], 0.f);
  float best = tmax[r];
  int btri = -1;
  float bb = 0.f, bg = 0.f;
  const int cnt = min(min(counts[b], MAXC), SLOTS);
  if (V == NO_LOAD && cnt > 0) {
    stage_planes(sp, planes + (size_t)max(ids[b * MAXC], 0) * n_sub *
                                  PLANE_FLOATS);
    __syncthreads();
  }
  for (int k = 0; k < cnt; ++k) {
    const int cid = max(ids[b * MAXC + k], 0);
    const float* ci = ctab + (size_t)cid * CTAB;
    const float oxc = ray.ox - ci[6], oyc = ray.oy - ci[7],
                ozc = ray.oz - ci[8];
    const int start = starts[cid];
    for (int s = 0; s < n_sub; ++s) {
      if (V != NO_LOAD) {
        stage_planes(sp, planes + ((size_t)cid * n_sub + s) * PLANE_FLOATS);
        __syncthreads();
      }
      const int base = start + s * SUBT;
      if (V == FULL || V == NO_LOAD) {
        for (int j = 0; j < SUBT; ++j) {
          float t;
          if (tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t) &&
              (t < best || (t == best && base + j < btri))) {
            best = t;
            btri = base + j;
          }
        }
      } else if (V == NO_PRODUCTS) {
        for (int j = 0; j < SUBT; ++j) {
          float t, be, ga;
          if (accept(row_sums(sp, j), tn, &t, &be, &ga) &&
              (t < best || (t == best && base + j < btri))) {
            best = t;
            btri = base + j;
          }
        }
      } else if (V == NO_EPI) {
        for (int j = 0; j < SUBT; ++j) {
          const Families f = families(sp, j, oxc, oyc, ozc, ray);
          const float v = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(
              __fadd_rn(f.on, f.ou), f.ov), f.dn), f.du), f.dv);
          if (v < best) best = v;
        }
      } else if (V == TONLY) {
        for (int j = 0; j < SUBT; ++j) {
          const float* n = sp + j;
          const float on = __fadd_rn(
              dot3(oxc, oyc, ozc, n[0], n[SUBT], n[2 * SUBT]), n[3 * SUBT]);
          const float t = __fdiv_rn(on, -dot3(ray.dx, ray.dy, ray.dz, n[0],
                                              n[SUBT], n[2 * SUBT]));
          if (t < best) best = t;
        }
      } else if (V == ACC_ONLY) {
        for (int j = 0; j < SUBT; ++j) {
          float t;
          if (tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t) && t < best)
            best = t;
        }
      } else {   // LEAN, NOTB, PK: the packed t | index key
        int kmin = INT_MAX;
        float tsel = BIG_T, bsel = 0.f, gsel = 0.f;
        for (int j = 0; j < SUBT; ++j) {
          float t, be = 0.f, ga = 0.f;
          bool ok;
          if (V == PK)
            ok = accept(families(sp, j, oxc, oyc, ozc, ray), tn, &t, &be, &ga);
          else
            ok = tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t);
          const float tm = ok ? t : BIG_T;
          const int key = (__float_as_int(tm) & ~0xFF) | j;
          if (key < kmin) {
            kmin = key;
            tsel = tm;
            bsel = be;
            gsel = ga;
          }
        }
        const float tj = V == NOTB ? __int_as_float(kmin & ~0xFF) : tsel;
        if (tj < best) {
          best = tj;
          btri = base + (kmin & 0xFF);
          bb = bsel;
          bg = gsel;
        }
      }
      if (V != NO_LOAD) __syncthreads();   // all lanes done with sp
    }
  }
  t_out[r] = best;
  tri_out[r] = btri;
  be_out[r] = bb;
  ga_out[r] = bg;
}

using Kernel = void (*)(const int*, const int*, const float*, const float*,
                        const int*, int, const float*, const float*,
                        const float*, const float*, float*, int*, float*,
                        float*);

const Kernel KERNELS[] = {
    ablate_kernel<FULL>,   ablate_kernel<NO_LOAD>, ablate_kernel<NO_PRODUCTS>,
    ablate_kernel<NO_EPI>, ablate_kernel<TONLY>,   ablate_kernel<ACC_ONLY>,
    ablate_kernel<LEAN>,   ablate_kernel<NOTB>,    ablate_kernel<PK>};

}  // namespace

// ids (nb, MAXC) int32, counts (nb, 1) int32: the cull output.  planes
// (C, n_sub, 12, SUBT), ctab (C, 12), starts (C,) int32: the clustered
// mesh.  org, dir (nb*BLOCK, 3), tmax, tmin (nb*BLOCK,).  Outputs t, beta,
// gamma f32 and tri int32, (nb*BLOCK,) each.  variant indexes Variant.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unknown variant).
extern "C" int sweep_ablate(const int* ids, const int* counts,
                            const float* planes, const float* ctab,
                            const int* starts, int n_sub, const float* org,
                            const float* dir, const float* tmax,
                            const float* tmin, float* t_out, int* tri_out,
                            float* be_out, float* ga_out, int nb, int variant,
                            void* stream) {
  if (variant < 0 || variant >= (int)(sizeof(KERNELS) / sizeof(Kernel)))
    return (int)cudaErrorInvalidValue;
  if (nb > 0)
    KERNELS[variant]<<<nb, BLOCK, 0, (cudaStream_t)stream>>>(
        ids, counts, planes, ctab, starts, n_sub, org, dir, tmax, tmin, t_out,
        tri_out, be_out, ga_out);
  return (int)cudaGetLastError();
}
