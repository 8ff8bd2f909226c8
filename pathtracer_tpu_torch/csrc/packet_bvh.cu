// Hand-written Hopper (sm_90a) kernel for the packet-BVH tier: closest hit
// of N rays over one flat BVH of a small mesh (<= 8000 triangles), bound
// through a plain C interface (ctypes, ops/packet_bvh.py).
//
// Replaces the TPU kernel
//   pathtracer_tpu/ops/pallas_bvh.py::_traverse_kernel   (via packet_hit)
// and computes what it computes, not how.  The TPU kernel walks a
// 1024-ray packet with one stack in SMEM, because Mosaic indexes
// dynamically only from scalar memory, and descends where ANY lane's slab
// is live.  On Hopper the native shape is one thread per ray:
//   * each thread walks the tree with its own depth-64 stack (local
//     memory, cached in L1): left child first, a child entered where the
//     ray's own slab is live and its entry is below the ray's best t;
//   * leaves test their triangles with the edge-matrix formula of
//     ops/traverse._tri_test_block: accept t >= 0, t > tmin, the three
//     barycentrics >= 0, NaN rejected, and strict t < best, so the first
//     triangle found at a given t keeps it; in BVH order that is the
//     lower index, as in the plain version (brute force, ties to the
//     lower index);
//   * strict fp32: every product and sum is rounded on its own in the
//     plain version's order (the _rn intrinsics are never contracted into
//     FMAs), 1/d and t are IEEE divisions.
// Where a ray grazes a leaf box, its own slab test can reject a leaf whose
// triangle the brute-force plain version hits (the TPU packet walk tests
// every lane against any lane's leaf, so it misses less of them); the
// comparison allows for that.
//
// What bounds it on an H100: per ray a few dozen slab tests (about 25
// fp32 operations each) and a few dozen triangle tests (about 45 fp32
// operations and one IEEE divide each), on node and triangle records
// that L2 holds (<= 8000 triangles: 0.5 MB of soup, about 0.4 MB of
// nodes).  The bytes that must move are the rays in and the hits out
// (about 50 bytes a ray), so the work is bound by fp32 operations, and in
// practice by the latency of the dependent node loads and by warp
// divergence on incoherent rays.  This first version does nothing about
// either (no ray sorting, no shared-memory node cache, no packet
// ordering); it keeps the code simple and exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STACK_DEPTH = 64;
constexpr int SOUP = 16;   // floats per triangle row (TriSoup field order)

// NaN-propagating min / max, matching jnp / torch minimum and maximum.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab test of box = [lo xyz, hi xyz] (pallas_bvh._traverse_kernel
// node_live): live iff the exit is at or past max(entry, 0) and the entry
// is below the ray's best t.
__device__ __forceinline__ bool slab_live(const float* box, const Ray& r,
                                          float best) {
  float t1 = __fmul_rn(__fsub_rn(box[0], r.ox), r.ix);
  float t2 = __fmul_rn(__fsub_rn(box[3], r.ox), r.ix);
  float tmin = nmin(t1, t2), tmax = nmax(t1, t2);
  t1 = __fmul_rn(__fsub_rn(box[1], r.oy), r.iy);
  t2 = __fmul_rn(__fsub_rn(box[4], r.oy), r.iy);
  tmin = nmax(tmin, nmin(t1, t2));
  tmax = nmin(tmax, nmax(t1, t2));
  t1 = __fmul_rn(__fsub_rn(box[2], r.oz), r.iz);
  t2 = __fmul_rn(__fsub_rn(box[5], r.oz), r.iz);
  tmin = nmax(tmin, nmin(t1, t2));
  tmax = nmin(tmax, nmax(t1, t2));
  return (tmax >= nmax(tmin, 0.f)) && (tmin < best);
}

// (a*x + b*y) + c*z, each product and sum rounded on its own.
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

// Edge-matrix triangle test of one soup row; returns acceptance (without
// the best-t and tmin bounds) and t, alpha, beta.
__device__ __forceinline__ bool tri_test(const float* s, const Ray& r,
                                         float* t_out, float* al_out,
                                         float* be_out) {
  // row: ax ay az ux uy uz vx vy vz nx ny nz m11 m12 m22 invdetm
  const float ax = s[0], ay = s[1], az = s[2];
  const float dn = dot3(r.dx, r.dy, r.dz, s[9], s[10], s[11]);
  const float num = dot3(__fsub_rn(ax, r.ox), __fsub_rn(ay, r.oy),
                         __fsub_rn(az, r.oz), s[9], s[10], s[11]);
  const float t = __fdiv_rn(num, dn);
  const float px = __fsub_rn(__fadd_rn(r.ox, __fmul_rn(t, r.dx)), ax);
  const float py = __fsub_rn(__fadd_rn(r.oy, __fmul_rn(t, r.dy)), ay);
  const float pz = __fsub_rn(__fadd_rn(r.oz, __fmul_rn(t, r.dz)), az);
  const float b11 = dot3(px, py, pz, s[3], s[4], s[5]);
  const float b21 = dot3(px, py, pz, s[6], s[7], s[8]);
  const float beta = __fmul_rn(
      __fsub_rn(__fmul_rn(b11, s[14]), __fmul_rn(b21, s[13])), s[15]);
  const float gamma = __fmul_rn(
      __fsub_rn(__fmul_rn(b21, s[12]), __fmul_rn(b11, s[13])), s[15]);
  const float alpha = __fsub_rn(__fsub_rn(1.f, beta), gamma);
  *t_out = t;
  *al_out = alpha;
  *be_out = beta;
  return (t >= 0.f) && (beta >= 0.f) && (gamma >= 0.f) && (alpha >= 0.f) &&
         (t == t);
}

__global__ void __launch_bounds__(THREADS)
packet_kernel(const float* __restrict__ box, const int* __restrict__ na,
              const int* __restrict__ nb, const int* __restrict__ nleaf,
              const float* __restrict__ soup, const float* __restrict__ org,
              const float* __restrict__ dir, const float* __restrict__ tmax,
              const float* __restrict__ tmin, int n,
              float* __restrict__ t_out, int* __restrict__ tri_out,
              float* __restrict__ al_out, float* __restrict__ be_out,
              int* __restrict__ work) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n) return;
  Ray ray;
  ray.ox = org[3 * r];
  ray.oy = org[3 * r + 1];
  ray.oz = org[3 * r + 2];
  ray.dx = dir[3 * r];
  ray.dy = dir[3 * r + 1];
  ray.dz = dir[3 * r + 2];
  ray.ix = __fdiv_rn(1.f, ray.dx);
  ray.iy = __fdiv_rn(1.f, ray.dy);
  ray.iz = __fdiv_rn(1.f, ray.dz);
  const float tn = tmin[r];
  float best = tmax[r], bal = 1.f, bbe = 0.f;
  int btri = -1, n_nodes = 0, n_tris = 0;

  int stack[STACK_DEPTH];
  int sp = 0;
  int node = 0;   // the root is entered without a test, as on the TPU
  for (;;) {
    if (nleaf[node]) {
      const int start = na[node], cnt = nb[node];
      for (int k = 0; k < cnt; ++k) {
        float t, al, be;
        ++n_tris;
        if (tri_test(soup + (size_t)(start + k) * SOUP, ray, &t, &al, &be) &&
            t < best && t > tn) {
          best = t;
          btri = start + k;
          bal = al;
          bbe = be;
        }
      }
    } else {
      ++n_nodes;
      const int a = na[node], b = nb[node];
      const bool la = slab_live(box + (size_t)a * 6, ray, best);
      const bool lb = slab_live(box + (size_t)b * 6, ray, best);
      if (la) {
        if (lb && sp < STACK_DEPTH) stack[sp++] = b;
        node = a;
        continue;
      }
      if (lb) {
        node = b;
        continue;
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  t_out[r] = best;
  tri_out[r] = btri;
  al_out[r] = bal;
  be_out[r] = bbe;
  if (work) {
    work[2 * r] = n_nodes;
    work[2 * r + 1] = n_tris;
  }
}

}  // namespace

// box (M, 6) f32 [lo xyz | hi xyz], na / nb / nleaf (M,) int32 (leaf: tri
// start / count), soup (T, 16) f32 rows in TriSoup field order, org and
// dir (n, 3), tmax and tmin (n,).  Outputs t, tri, alpha, beta (n,) and,
// when work is not null, (n, 2) int32 counts of inner nodes expanded (two
// slab tests each) and of triangle tests.
// Returns cudaGetLastError() after the launch.
extern "C" int packet_bvh_hit(const float* box, const int* na, const int* nb,
                              const int* nleaf, const float* soup,
                              const float* org, const float* dir,
                              const float* tmax, const float* tmin, int n,
                              float* t_out, int* tri_out, float* al_out,
                              float* be_out, int* work, void* stream) {
  if (n > 0)
    packet_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(box, na, nb, nleaf, soup, org,
                                            dir, tmax, tmin, n, t_out,
                                            tri_out, al_out, be_out, work);
  return (int)cudaGetLastError();
}
