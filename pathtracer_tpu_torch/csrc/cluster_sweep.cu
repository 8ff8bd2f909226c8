// Hand-written Hopper (sm_90a) kernels for the cluster tier's phase-2
// sweeps, bound through a plain C interface (ctypes, ops/cluster.py).
//
// Replaces the TPU kernels
//   pathtracer_tpu/ops/pallas_cluster.py::_sweep_kernel      (closest hit)
//   pathtracer_tpu/ops/pallas_cluster.py::_sweep_any_kernel  (occlusion)
// and computes what they compute, not how: the TPU kernel forms the six
// ray-plane dot families as two (BLOCK, 4) x (4, 3*SUBT) MXU products
// per subtile; here one thread owns one ray and evaluates them in fp32
// against plane data staged in shared memory, every product and sum
// rounded on its own in the plain version's order, so kernel and plain
// version agree bit for bit (with FMA contraction, some 1080p primary
// lanes on the 2.4M-tri sphere hit in one version and missed in the
// other, on an NVIDIA H100 80GB HBM3 at a 700 W power limit).
//
// Design (first, simple version):
//   * one block per 512-ray packet, one thread per ray;
//   * the block walks its packet's emitted cluster slots in key order
//     (near-first); per slot every thread slab-tests the cluster AABB
//     against its own best t (closest) or live cap (any-hit), and
//     __syncthreads_or skips the slot when no lane enters it;
//   * per 256-triangle subtile the same skip on the subtile AABB, then
//     the subtile's 12 floats per triangle (centroid-recentred n, U', V'
//     with their offsets, 12 KB) are staged into shared memory and every
//     thread tests all 256 triangles;
//   * acceptance `t > max(tmin, 0)` and beta, gamma, 1 - beta - gamma
//     >= 0, written as comparisons so NaN (pad / degenerate planes give
//     t = 0/0) is rejected as on the TPU;
//   * closest hit keeps an exact argmin, equal t going to the lower
//     triangle index (the TPU's packed t|lane key may pick differently
//     within 2^-16 relative t);
//   * sound early break after each slot: the next slot's packet-min entry
//     key is >= every lane's own entry, so once it is >= the block max of
//     best t (or of live caps) no later slot can win;
//   * the any-hit kernel also leaves as soon as every lane is occluded.
//
// What bounds it on an H100: per ray-triangle pair about 40 fp32
// multiplies and adds and one IEEE division (exact division is required,
// no fast math), all from registers and broadcast shared-memory reads, so
// the sweep is fp32-issue bound; the plane bytes are 12 KB per subtile
// per slot, read once per block from L2/HBM and reused by 512 rays (about
// 300 FLOPs per byte), far above the H100's fp32 ridge.  The design
// therefore spends nothing on copy overlap yet (no TMA, no double
// buffering); it skips dead slots and subtiles and leaves early.
// Making it fast (wgmma tiling of the plane products, persistent blocks)
// is later work.

#include "sweep_common.cuh"

namespace {

// Block-wide max (every thread gets it).  `red` holds one float per warp.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                     // red may still be read from before
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[threadIdx.x & (BLOCK / 32 - 1)];
  for (int o = BLOCK / 64; o > 0; o >>= 1)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
sweep_kernel(const int* __restrict__ ids, const int* __restrict__ counts,
             const float* __restrict__ keys, const float* __restrict__ planes,
             const float* __restrict__ ctab, const int* __restrict__ starts,
             const float* __restrict__ sub_bounds, int n_sub,
             const float* __restrict__ org, const float* __restrict__ dir,
             const float* __restrict__ tmax, const float* __restrict__ tmin,
             float* __restrict__ t_out, int* __restrict__ tri_out,
             unsigned char* __restrict__ occ_out) {
  __shared__ __align__(16) float sp[PLANE_FLOATS];
  __shared__ float red[BLOCK / 32];
  const int b = blockIdx.x;
  const int r = b * BLOCK + threadIdx.x;
  const Ray ray = load_ray(org, dir, r);
  const float tx = tmax[r];
  const float tn = fmaxf(tmin[r], 0.f);
  float best = tx;      // closest: best t so far
  int btri = -1;
  bool occ = false;     // any-hit: occluded
  const int cnt = min(counts[b], MAXC);

  for (int k = 0; k < cnt; ++k) {
    const int cid = max(ids[b * MAXC + k], 0);
    const float* ci = ctab + (size_t)cid * CTAB;
    float cap = ANY ? (occ ? -1.f : tx) : best;
    if (__syncthreads_or(slab_live(ci, ray, cap))) {
      const float oxc = ray.ox - ci[6], oyc = ray.oy - ci[7],
                  ozc = ray.oz - ci[8];
      const int start = starts[cid];
      for (int s = 0; s < n_sub; ++s) {
        const size_t sub = (size_t)cid * n_sub + s;
        cap = ANY ? (occ ? -1.f : tx) : best;
        if (!__syncthreads_or(slab_live(sub_bounds + sub * 6, ray, cap)))
          continue;
        stage_planes(sp, planes + sub * PLANE_FLOATS);
        __syncthreads();
        if (ANY) {
          for (int j = 0; j < SUBT && !occ; ++j) {
            float t;
            if (tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t) && t < tx)
              occ = true;
          }
        } else {
          for (int j = 0; j < SUBT; ++j) {
            float t;
            if (tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t)) {
              const int tri = start + s * SUBT + j;
              if (t < best || (t == best && tri < btri)) {
                best = t;
                btri = tri;
              }
            }
          }
        }
        // every lane done with sp before the next stage overwrites it;
        // the any-hit block leaves once all its lanes are occluded
        if (ANY) {
          if (!__syncthreads_or(!occ)) break;
        } else {
          __syncthreads();
        }
      }
    }
    const float mx = block_max(ANY ? (occ ? -1.f : tx) : best, red);
    if (k + 1 >= cnt || !(keys[b * MAXC + k + 1] < mx)) break;
  }
  if (ANY) {
    occ_out[r] = occ ? 1 : 0;
  } else {
    t_out[r] = best;
    tri_out[r] = btri;
  }
}

}  // namespace

// ids (nb, MAXC) int32, counts (nb, 1) int32, keys (nb, MAXC) f32: the cull
// output.  planes (C, n_sub, 12, SUBT), ctab (C, 12), starts (C,) int32,
// sub_bounds (C, n_sub, 6): the clustered mesh.  org, dir (nb*BLOCK, 3),
// tmax, tmin (nb*BLOCK,).  Outputs t (nb*BLOCK,) f32 and tri int32.
// Returns cudaGetLastError() after the launch.
extern "C" int cluster_sweep_closest(
    const int* ids, const int* counts, const float* keys, const float* planes,
    const float* ctab, const int* starts, const float* sub_bounds, int n_sub,
    const float* org, const float* dir, const float* tmax, const float* tmin,
    float* t_out, int* tri_out, int nb, void* stream) {
  if (nb > 0)
    sweep_kernel<false><<<nb, BLOCK, 0, (cudaStream_t)stream>>>(
        ids, counts, keys, planes, ctab, starts, sub_bounds, n_sub, org, dir,
        tmax, tmin, t_out, tri_out, nullptr);
  return (int)cudaGetLastError();
}

// Same inputs; output occ (nb*BLOCK,) uint8, 1 iff a triangle is hit with
// tmin < t < tmax.
extern "C" int cluster_sweep_any(
    const int* ids, const int* counts, const float* keys, const float* planes,
    const float* ctab, const int* starts, const float* sub_bounds, int n_sub,
    const float* org, const float* dir, const float* tmax, const float* tmin,
    unsigned char* occ_out, int nb, void* stream) {
  if (nb > 0)
    sweep_kernel<true><<<nb, BLOCK, 0, (cudaStream_t)stream>>>(
        ids, counts, keys, planes, ctab, starts, sub_bounds, n_sub, org, dir,
        tmax, tmin, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}
