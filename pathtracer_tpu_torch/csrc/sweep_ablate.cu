// Hand-written Hopper (sm_90a) ablation of the cluster sweep, bound
// through a plain C interface (ctypes, ops/sweep_ablate.py).
//
// Replaces the TPU kernel scripts/tpu_ablate_sweep.py::make_kernel(variant)
// and asks its question of the port's own sweep (cluster_sweep.cu): what
// share of a slot's time goes to staging the planes, to the six ray-plane
// dot families, to the IEEE divide and to the winner logic.  Every variant
// runs the loop of sweep_kernel<false, G> at fixed work: every slot up to
// min(count, SLOTS) and every subtile, with no slab skip and no early
// break (the TPU variants have neither), so variants differ only in the
// per-pair arithmetic.  The per-pair code and the staging are
// sweep_common.cuh's own.
//
// Layout: the production sweep's.  One block is one lane group of G rays
// (ops/cluster.SWEEP_GROUP; any of cluster.GROUPS) of a 512-ray packet,
// one thread a ray, and block i takes unit order[i] (the wrapper's
// default: cluster.heaviest_first on the clamped counts, so the launch's
// last wave holds light groups).  The group's fixed walk is the sequence
// of (slot, subtile) steps; each subtile's 12 KB arrives by a bulk copy
// (cp.async.bulk) into one of two shared buffers, completed on an
// mbarrier, and step q + 1 is fetched while step q is tested (fixed work
// needs no guess).  One group barrier per step frees the buffer.  A
// lane's result depends only on its ray and its packet's slots, so the
// group size and the order change no bit.
//
// This replaced one 512-thread block per packet in packet order, staging
// each subtile with a synchronous copy between two block barriers: the
// first design of the production sweep, which cluster_sweep.cu gave up,
// so the shares it gave described a kernel the render path no longer ran
// (and its launch waited on the heaviest packets, taken last).
//
// Variants (each a deterministic function; ops/sweep_ablate.py holds the
// plain version of each):
//   FULL       closest hit, exact argmin, ties to the lower triangle: t, tri
//   NO_LOAD    FULL on the packet's first slot's first subtile, copied
//              once per group and reused for every slot and subtile, with
//              no copy and no barrier in the loop (the TPU's no-dma
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
// What bounds it on an H100: fp32 instruction issue, as the sweep (41
// counted fp32 operations, about 90 SASS instructions with the IEEE
// divide's, per ray-triangle pair, planes reused by G rays from shared
// memory), with two 12 KB buffers per group limiting residency to 9
// groups per SM (18 warps at G = 64).

#include <limits.h>

#include "sweep_common.cuh"

namespace {

constexpr int SLOTS = 8;          // slots swept per packet
constexpr float BIG_T = 1e30f;
constexpr int STATS = 2;          // per unit: subtiles swept, cycles

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

// The variant's work on one staged subtile (base: its first triangle's
// index), updating the lane's state.
template <int V>
__device__ __forceinline__ void sweep_subtile(const float* sp, int base,
                                              float oxc, float oyc, float ozc,
                                              const Ray& ray, float tn,
                                              float& best, int& btri,
                                              float& bb, float& bg) {
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
      if (tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t) && t < best) best = t;
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
}

template <int V, int G>
__global__ void __launch_bounds__(G)
ablate_kernel(const int* __restrict__ ids, const int* __restrict__ counts,
              const float* __restrict__ planes, const float* __restrict__ ctab,
              const int* __restrict__ starts, int n_sub,
              const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ tmax, const float* __restrict__ tmin,
              const int* __restrict__ order, float* __restrict__ t_out,
              int* __restrict__ tri_out, float* __restrict__ be_out,
              float* __restrict__ ga_out, long long* __restrict__ stats) {
  __shared__ __align__(128) float buf[2][PLANE_FLOATS];
  __shared__ __align__(8) unsigned long long bar[2];
  const long long c0 = clock64();
  const int u = order[blockIdx.x];            // lane group u of packet b
  const int b = u / (BLOCK / G);
  const int r = u * G + threadIdx.x;
  const Ray ray = load_ray(org, dir, r);
  const float tn = fmaxf(tmin[r], 0.f);
  float best = tmax[r];
  int btri = -1;
  float bb = 0.f, bg = 0.f;
  const int* pid = ids + (size_t)b * MAXC;
  const int cnt = min(min(counts[b], MAXC), SLOTS);
  const int steps = cnt * n_sub;               // (slot, subtile) steps
  // flat subtile of step q (NO_LOAD: the first one, always)
  auto sub_of = [&](int q) {
    return V == NO_LOAD ? (size_t)max(pid[0], 0) * n_sub
                        : (size_t)max(pid[q / n_sub], 0) * n_sub + q % n_sub;
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (steps > 0 && threadIdx.x == 0)
    bulk_load(buf[0], planes + sub_of(0) * PLANE_FLOATS, &bar[0]);
  if (V == NO_LOAD && steps > 0) mbar_wait(&bar[0], 0);
  int q = 0;
  for (int k = 0; k < cnt; ++k) {
    const int cid = max(pid[k], 0);
    const float* ci = ctab + (size_t)cid * CTAB;
    const float oxc = ray.ox - ci[6], oyc = ray.oy - ci[7],
                ozc = ray.oz - ci[8];
    const int start = starts[cid];
    for (int s = 0; s < n_sub; ++s, ++q) {
      const int cb = V == NO_LOAD ? 0 : (q & 1);
      if (V != NO_LOAD) {
        // the other buffer was freed by the last step's barrier
        if (q + 1 < steps && threadIdx.x == 0)
          bulk_load(buf[cb ^ 1], planes + sub_of(q + 1) * PLANE_FLOATS,
                    &bar[cb ^ 1]);
        mbar_wait(&bar[cb], (q >> 1) & 1);
      }
      sweep_subtile<V>(buf[cb], start + s * SUBT, oxc, oyc, ozc, ray, tn,
                       best, btri, bb, bg);
      if (V != NO_LOAD) group_sync<G>();   // every lane done with buf[cb]
    }
  }
  t_out[r] = best;
  tri_out[r] = btri;
  be_out[r] = bb;
  ga_out[r] = bg;
  if (stats != nullptr && threadIdx.x == 0) {
    stats[(size_t)u * STATS] = steps;
    stats[(size_t)u * STATS + 1] = clock64() - c0;
  }
}

template <int V>
const void* for_group(int group) {
  switch (group) {
    case 32: return (const void*)ablate_kernel<V, 32>;
    case 64: return (const void*)ablate_kernel<V, 64>;
    case 128: return (const void*)ablate_kernel<V, 128>;
    case 256: return (const void*)ablate_kernel<V, 256>;
    case 512: return (const void*)ablate_kernel<V, 512>;
  }
  return nullptr;
}

const void* kernel_for(int variant, int group) {
  switch (variant) {
    case FULL: return for_group<FULL>(group);
    case NO_LOAD: return for_group<NO_LOAD>(group);
    case NO_PRODUCTS: return for_group<NO_PRODUCTS>(group);
    case NO_EPI: return for_group<NO_EPI>(group);
    case TONLY: return for_group<TONLY>(group);
    case ACC_ONLY: return for_group<ACC_ONLY>(group);
    case LEAN: return for_group<LEAN>(group);
    case NOTB: return for_group<NOTB>(group);
    case PK: return for_group<PK>(group);
  }
  return nullptr;
}

}  // namespace

// ids (nb, MAXC) int32, counts (nb, 1) int32: the cull output.  planes
// (C, n_sub, 12, SUBT) (16-byte aligned), ctab (C, 12), starts (C,) int32:
// the clustered mesh.  org, dir (nb*BLOCK, 3), tmax, tmin (nb*BLOCK,).
// order (n_units,) int32: the unit of each block, n_units = nb * BLOCK /
// group.  Outputs t, beta, gamma f32 and tri int32, (nb*BLOCK,) each;
// stats (n_units, STATS) int64 or null: per unit the subtiles swept and
// the block's clock64 cycles.  variant indexes Variant.  Returns a CUDA
// error code (cudaErrorInvalidValue for an unknown variant or group).
extern "C" int sweep_ablate(const int* ids, const int* counts,
                            const float* planes, const float* ctab,
                            const int* starts, int n_sub, const float* org,
                            const float* dir, const float* tmax,
                            const float* tmin, const int* order, float* t_out,
                            int* tri_out, float* be_out, float* ga_out,
                            long long* stats, int n_units, int group,
                            int variant, void* stream) {
  const void* fn = kernel_for(variant, group);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (n_units > 0) {
    void* args[] = {&ids, &counts, &planes, &ctab, &starts, &n_sub, &org,
                    &dir, &tmax, &tmin, &order, &t_out, &tri_out, &be_out,
                    &ga_out, &stats};
    cudaError_t e = cudaLaunchKernel(fn, dim3(n_units), dim3(group), args, 0,
                                     (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Registers per thread, resident blocks per SM and threads per block of
// one variant's kernel at lane group `group`, into out[0..2].  Returns a
// CUDA error code.
extern "C" int sweep_ablate_info(int variant, int group, int* out) {
  const void* fn = kernel_for(variant, group);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, group, 0);
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = group;
  return (int)e;
}
