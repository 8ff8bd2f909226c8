// Hand-written Hopper (sm_90a) kernel for the packet-BVH tier: closest hit
// of N rays over one flat BVH of a small mesh (<= 8000 triangles), bound
// through a plain C interface (ctypes, ops/packet_bvh.py).
//
// Replaces the TPU kernel
//   pathtracer_tpu/ops/pallas_bvh.py::_traverse_kernel   (via packet_hit)
// and computes what it computes, not how.  The TPU kernel walks a
// 1024-ray packet with one stack in SMEM, because Mosaic indexes
// dynamically only from scalar memory, and descends where ANY lane's slab
// is live.  On Hopper the native shape is one thread per ray, each with
// its own walk, which ops/packet_bvh.packet_walk_plain states in torch:
//   * left child first, a child entered where the ray's own slab is live
//     and its entry is below the ray's best t, the right one pushed;
//   * leaves test their triangles with the edge-matrix formula of
//     ops/traverse._tri_test_block: accept t >= 0, t > tmin, the three
//     barycentrics >= 0, NaN rejected, and strict t < best, so the first
//     triangle found at a given t keeps it;
//   * strict fp32: every product and sum is rounded on its own in the
//     plain version's order (the _rn intrinsics, -fmad=false), 1/d and t
//     are IEEE divisions.  The slab's min / max are min.NaN / max.NaN:
//     NaN in, NaN out, as torch.minimum; a slab's values only reach
//     comparisons, so the sign of a zero never shows;
//   * the slab test is conservative, so that a ray grazing a leaf box
//     still tests its triangles: an axis where the ray lies in the plane
//     of a face (0 * inf) holds the whole ray, and the exit grows by
//     1 + 2 gamma_3 (Ize 2013) before it is compared.  Without it, a ray
//     in the plane of a leaf box's top face aimed at a vertex on it
//     missed what brute force hits (tests/test_torch_cull_walk.py).
// So t, tri, alpha, beta and the per-ray counters equal the plain walk's
// bit for bit.  Brute force may still differ on a tie, or where the
// triangle test's rounding accepts a point just outside the box; the
// comparison with brute force allows for that.
//
// What bounds it on an H100: the bytes that must move are the rays in
// and the hits out (48 bytes a ray), 0.03 ms for 1080p; the operations
// (a few dozen slab tests of about 25 fp32 operations and a few triangle
// tests of about 45 and one IEEE divide per ray) are below that.  The
// first version (one thread per ray, 128-thread blocks) took 8 to 10
// times the bound: per inner node four to six dependent loads (nleaf,
// na, nb, then two unaligned 24-byte boxes), a depth-64 stack in local
// memory, 12-byte strided ray loads, no balance across rays.  This one:
//   * one 64-byte child-pair record per inner node (both children's
//     boxes, their records or leaf ranges; PackedBVH.pairs), read as four
//     16-byte read-only loads through L1 (a copy of the table in each
//     block's shared memory was no faster);
//   * each thread's stack in shared memory, as deep as the tree (entry i
//     of thread j at [i * THREADS + j]: no bank conflicts);
//   * persistent blocks, one per resident slot, whose warps fetch 32
//     consecutive rays at a time from an atomic counter,
//     staging their origins and directions through shared memory (three
//     coalesced 128-byte loads per array), so a warp with cheap rays takes
//     more of them;
//   * triangles read as four 16-byte loads of their 64-byte soup row;
//   * the walk runs while-while (Aila and Laine 2009): a warp steps inner
//     nodes until each of its lanes has reached a leaf or finished, then
//     runs the leaves, so it runs one kind of step at a time; each ray's
//     own sequence of steps is unchanged.  With one loop for both kinds, a
//     warp ran triangle tests at 37% SIMT efficiency on the primaries (the
//     lanes at inner nodes waiting); while-while gives 72% (inner-node
//     steps fall from 87% to 69%) and about 8% less time.  A warp vote per
//     step between the two kinds gave 78% / 64% and no gain.
// On the 1080p primaries of the 2k mesh this is 6 times the bound: a step
// of the walk (two slab tests, about 80 instructions, or one triangle
// test) takes about 1,500 cycles of a warp's time at 32 resident warps
// per SM (64 registers): the dependent chain of a step (record load, slab,
// compare, branch) is not hidden by 8 warps per scheduler.  Loading the
// rays takes about a tenth, and the heaviest batches run last: ordered
// heaviest first the same rays take about 10% less.  Variants with the
// table in shared memory, 128-thread blocks, rays copied ahead by
// cp.async or the counter read ahead were no faster (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STACK_DEPTH = 64;          // the walk's stack (pack_bvh refuses
                                         // trees this deep)

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  bool flat;      // some 1/d is infinite (a zero direction component)
};

// 1 + 2 gamma_3 in float32 (1 + 3 * 2^-23): the growth of a slab's exit
// that covers the rounding of its products (Ize 2013;
// packet_bvh.SLAB_GROW).
constexpr float SLAB_GROW = 1.0000003576278687f;

// One axis of a slab: the t interval between the box's two faces, or the
// whole line where the ray lies in the plane of a face (a zero direction
// component with the origin on the face: 0 * inf = NaN).
__device__ __forceinline__ void slab_axis(float l, float h, float o, float i,
                                          float& lo, float& hi) {
  const float t1 = __fmul_rn(__fsub_rn(l, o), i);
  const float t2 = __fmul_rn(__fsub_rn(h, o), i);
  lo = min_nan(t1, t2);
  hi = max_nan(t1, t2);
  if (isnan(lo) && isinf(i)) {
    lo = -INFINITY;
    hi = INFINITY;
  }
}

// Conservative slab test of box [lo xyz, hi xyz] (pallas_bvh.
// _traverse_kernel node_live, made robust): live iff the exit, grown by
// SLAB_GROW, is at or past max(entry, 0) and the entry is below the ray's
// best t.  The in-plane rule of slab_axis can only act on an axis whose
// 1/d is infinite, so a ray with none (Ray::flat false, nearly every ray)
// takes the plain interval, which is then the same.
__device__ __forceinline__ bool slab_live(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          const Ray& r, float best) {
  float tmin, tmax, lo, hi;
  if (r.flat) {
    slab_axis(lx, hx, r.ox, r.ix, tmin, tmax);
    slab_axis(ly, hy, r.oy, r.iy, lo, hi);
    tmin = max_nan(tmin, lo);
    tmax = min_nan(tmax, hi);
    slab_axis(lz, hz, r.oz, r.iz, lo, hi);
  } else {
    float t1 = __fmul_rn(__fsub_rn(lx, r.ox), r.ix);
    float t2 = __fmul_rn(__fsub_rn(hx, r.ox), r.ix);
    tmin = min_nan(t1, t2);
    tmax = max_nan(t1, t2);
    t1 = __fmul_rn(__fsub_rn(ly, r.oy), r.iy);
    t2 = __fmul_rn(__fsub_rn(hy, r.oy), r.iy);
    tmin = max_nan(tmin, min_nan(t1, t2));
    tmax = min_nan(tmax, max_nan(t1, t2));
    t1 = __fmul_rn(__fsub_rn(lz, r.oz), r.iz);
    t2 = __fmul_rn(__fsub_rn(hz, r.oz), r.iz);
    lo = min_nan(t1, t2);
    hi = max_nan(t1, t2);
  }
  tmin = max_nan(tmin, lo);
  tmax = min_nan(tmax, hi);
  return (__fmul_rn(tmax, SLAB_GROW) >= max_nan(tmin, 0.f)) && (tmin < best);
}

// (a*x + b*y) + c*z, each product and sum rounded on its own.
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

// Edge-matrix triangle test of one soup row (four float4: ax ay az ux |
// uy uz vx vy | vz nx ny nz | m11 m12 m22 invdetm); returns acceptance
// (without the best-t and tmin bounds) and t, alpha, beta.
__device__ __forceinline__ bool tri_test(const float4* __restrict__ row,
                                         const Ray& r, float* t_out,
                                         float* al_out, float* be_out) {
  const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2),
               q3 = __ldg(row + 3);
  const float ax = q0.x, ay = q0.y, az = q0.z;
  const float dn = dot3(r.dx, r.dy, r.dz, q2.y, q2.z, q2.w);
  const float num = dot3(__fsub_rn(ax, r.ox), __fsub_rn(ay, r.oy),
                         __fsub_rn(az, r.oz), q2.y, q2.z, q2.w);
  const float t = __fdiv_rn(num, dn);
  const float px = __fsub_rn(__fadd_rn(r.ox, __fmul_rn(t, r.dx)), ax);
  const float py = __fsub_rn(__fadd_rn(r.oy, __fmul_rn(t, r.dy)), ay);
  const float pz = __fsub_rn(__fadd_rn(r.oz, __fmul_rn(t, r.dz)), az);
  const float b11 = dot3(px, py, pz, q0.w, q1.x, q1.y);
  const float b21 = dot3(px, py, pz, q1.z, q1.w, q2.x);
  const float beta = __fmul_rn(
      __fsub_rn(__fmul_rn(b11, q3.z), __fmul_rn(b21, q3.y)), q3.w);
  const float gamma = __fmul_rn(
      __fsub_rn(__fmul_rn(b21, q3.x), __fmul_rn(b11, q3.y)), q3.w);
  const float alpha = __fsub_rn(__fsub_rn(1.f, beta), gamma);
  *t_out = t;
  *al_out = alpha;
  *be_out = beta;
  return (t >= 0.f) && (beta >= 0.f) && (gamma >= 0.f) && (alpha >= 0.f) &&
         (t == t);
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS, 2)
packet_kernel(const float4* __restrict__ nodes, int root_cnt, int stack_cap,
              const float4* __restrict__ soup,
              const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ tmax, const float* __restrict__ tmin,
              int n, int* __restrict__ next_ray, float* __restrict__ t_out,
              int* __restrict__ tri_out, float* __restrict__ al_out,
              float* __restrict__ be_out, int* __restrict__ work) {
  extern __shared__ int s_stack[];
  __shared__ float s_ray[WARPS][2][96];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* so = s_ray[warp][0];
  float* sd = s_ray[warp][1];

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) break;
    const long long t_start = COUNT ? clock64() : 0;
    // stage the 32 rays' origins and directions: three coalesced loads
    const int m = min(32, n - base);
    for (int c = 0; c < 3; ++c) {
      const int e = c * 32 + lane;
      if (e < 3 * m) {
        so[e] = org[3 * (size_t)base + e];
        sd[e] = dir[3 * (size_t)base + e];
      }
    }
    __syncwarp();
    const int r = base + lane;
    if (lane < m) {
      const long long t_loaded = COUNT ? clock64() : 0;
      Ray ray;
      ray.ox = so[3 * lane];
      ray.oy = so[3 * lane + 1];
      ray.oz = so[3 * lane + 2];
      ray.dx = sd[3 * lane];
      ray.dy = sd[3 * lane + 1];
      ray.dz = sd[3 * lane + 2];
      ray.ix = __fdiv_rn(1.f, ray.dx);
      ray.iy = __fdiv_rn(1.f, ray.dy);
      ray.iz = __fdiv_rn(1.f, ray.dz);
      ray.flat = isinf(ray.ix) || isinf(ray.iy) || isinf(ray.iz);
      const float tn = tmin[r];
      float best = tmax[r], bal = 1.f, bbe = 0.f;
      int btri = -1, n_nodes = 0, n_tris = 0;
      int sp = 0;
      // the current node: an inner record (cnt == 0) or a leaf's range;
      // the root is entered without a test, as on the TPU
      int ref = 0, cnt = root_cnt;
      int x_nodes = 0, x_tris = 0;   // path executions this lane led
      // the next entry of the stack; false at its end
      auto pop = [&]() {
        if (sp == 0) return false;
        // a pushed entry names its parent record and side
        const int e = s_stack[(--sp) * THREADS + tid];
        const float4 w = __ldg(nodes + 4 * (e >> 1) + 3);
        ref = __float_as_int((e & 1) ? w.y : w.x);
        cnt = __float_as_int((e & 1) ? w.w : w.z);
        return true;
      };
      // an inner node: false when neither child is live
      auto inner = [&]() {
        if (COUNT && lane == __ffs(__activemask()) - 1) ++x_nodes;
        ++n_nodes;
        const float4* rec = nodes + 4 * ref;
        const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1),
                     q2 = __ldg(rec + 2), q3 = __ldg(rec + 3);
        const bool la =
            slab_live(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ray, best);
        const bool lb =
            slab_live(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ray, best);
        if (la) {
          if (lb && sp < stack_cap)
            s_stack[(sp++) * THREADS + tid] = 2 * ref + 1;
          ref = __float_as_int(q3.x);
          cnt = __float_as_int(q3.z);
          return true;
        }
        if (lb) {
          ref = __float_as_int(q3.y);
          cnt = __float_as_int(q3.w);
          return true;
        }
        return false;
      };
      auto leaf = [&]() {
        for (int k = 0; k < cnt; ++k) {
          float t, al, be;
          if (COUNT && lane == __ffs(__activemask()) - 1) ++x_tris;
          ++n_tris;
          if (tri_test(soup + 4 * (size_t)(ref + k), ray, &t, &al, &be) &&
              t < best && t > tn) {
            best = t;
            btri = ref + k;
            bal = al;
            bbe = be;
          }
        }
      };
      // inner nodes until this lane reaches a leaf, then the leaf: the
      // warp runs one kind of step at a time (each ray's own sequence of
      // steps is that of packet_walk_plain)
      for (;;) {
        bool more = true;
        while (cnt == 0 && more) more = inner() || pop();
        if (!more) break;
        leaf();
        if (!pop()) break;
      }
      t_out[r] = best;
      tri_out[r] = btri;
      al_out[r] = bal;
      be_out[r] = bbe;
      if (COUNT) {
        int* w = work + 6 * (size_t)r;
        w[0] = n_nodes;
        w[1] = n_tris;
        w[2] = (int)(clock64() - t_start);
        w[3] = (int)(t_loaded - t_start);
        w[4] = x_nodes;
        w[5] = x_tris;
      }
    }
    __syncwarp();
  }
}

size_t smem_bytes(int stack_cap) {
  return (size_t)stack_cap * THREADS * 4;
}

struct Args {
  const float4 *pairs, *soup;
  int root_cnt, cap;
  const float *org, *dir, *tmax, *tmin;
  int n;
  int* next_ray;
  float* t_out;
  int* tri_out;
  float *al_out, *be_out;
  int* work;
};

// Resident blocks per SM of one instance (C: with the counters) and its
// launch, one persistent block per resident slot (info: no launch).
template <bool C>
cudaError_t run(const Args& a, cudaStream_t stream, bool info, int* blocks,
                cudaFuncAttributes* fa) {
  const size_t smem = smem_bytes(a.cap);
  cudaError_t e = cudaFuncSetAttribute(
      packet_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, packet_kernel<C>, THREADS, smem);
  if (e == cudaSuccess && fa) e = cudaFuncGetAttributes(fa, packet_kernel<C>);
  if (e != cudaSuccess || info) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  int grid = *blocks * sms;
  const int need = (a.n + THREADS - 1) / THREADS;
  if (grid > need) grid = need;
  packet_kernel<C><<<grid, THREADS, smem, stream>>>(
      a.pairs, a.root_cnt, a.cap, a.soup, a.org, a.dir, a.tmax, a.tmin, a.n,
      a.next_ray, a.t_out, a.tri_out, a.al_out, a.be_out, a.work);
  return cudaGetLastError();
}

int stack_cap(int depth) {
  return depth < 1 ? 1 : (depth < STACK_DEPTH ? depth : STACK_DEPTH);
}

}  // namespace

// pairs (R, 16) child-pair records (ops/packet_bvh.pair_records; R = 0
// when the root is a leaf of root_cnt triangles, else root_cnt = 0), depth
// the tree's deepest node, soup (T, 16) f32 rows in TriSoup field order,
// org and dir (n, 3), tmax and tmin (n,), next_ray one int32 that is 0.
// Outputs t, tri, alpha, beta (n,) and, when work is not null, (n, 6)
// int32 per ray from the instance with counters: inner nodes expanded (two
// slab tests each), triangle tests, the clock64 cycles from its warp's
// turn on the 32-ray batch to the ray's result and to its rays being
// loaded, and the inner-node steps and triangle tests its warp ran with
// this lane leading (their sums over 32 x the lanes' steps are the SIMT
// efficiency).  Returns the first CUDA error of the set-up or the launch,
// else 0.
extern "C" int packet_bvh_hit(const float* pairs, int root_cnt, int depth,
                              const float* soup, const float* org,
                              const float* dir, const float* tmax,
                              const float* tmin, int n, int* next_ray,
                              float* t_out, int* tri_out, float* al_out,
                              float* be_out, int* work, void* stream) {
  if (n <= 0) return 0;
  const Args a = {reinterpret_cast<const float4*>(pairs),
                  reinterpret_cast<const float4*>(soup), root_cnt,
                  stack_cap(depth), org, dir, tmax, tmin, n, next_ray, t_out,
                  tri_out, al_out, be_out, work};
  int blocks = 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(work ? run<true>(a, st, false, &blocks, nullptr)
                    : run<false>(a, st, false, &blocks, nullptr));
}

// out[4] for a tree of the given depth: registers per thread, resident
// blocks per SM, shared bytes per block (static and dynamic), threads per
// block, of the instance that runs without counters.  Returns the first
// CUDA error, else 0.
extern "C" int packet_bvh_info(int depth, int* out) {
  Args a = {};
  a.cap = stack_cap(depth);
  cudaFuncAttributes fa;
  int blocks = 0;
  const cudaError_t e = run<false>(a, 0, true, &blocks, &fa);
  out[0] = fa.numRegs;
  out[1] = blocks;
  out[2] = (int)(fa.sharedSizeBytes + smem_bytes(a.cap));
  out[3] = THREADS;
  return (int)e;
}
