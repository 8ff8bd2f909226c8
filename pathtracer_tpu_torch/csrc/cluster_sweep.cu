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
// rounded on its own in the plain version's order (sweep_common.cuh), so
// kernel and plain version agree bit for bit (with FMA contraction, some
// 1080p primary lanes on the 2.4M-tri sphere hit in one version and
// missed in the other, on an NVIDIA H100 80GB HBM3 at a 700 W limit).
//
// Design.  One block is one lane group of G rays (G in 32..512, a
// template parameter; ops/cluster.SWEEP_GROUP) of a 512-ray packet, one
// thread a ray.  The group walks its packet's emitted cluster slots in
// key order and makes every decision from its own lanes:
//   * slot skip and subtile skip: some lane of the group enters the
//     cluster / subtile AABB before its own best t (closest) or live cap
//     (any-hit);
//   * early break after each slot: the next slot's packet-min entry key
//     is >= every lane's own entry, so once it is >= the group's max cap
//     no later slot can win;
//   * the any-hit group leaves as soon as all its lanes are occluded.
// A vote is __any_sync and the max a shuffle tree when G = 32; block
// barriers are used only when G > 32.  The plain version
// (ops/cluster._sweep_plain) makes the same decisions for the same groups.
// One launch covers every packet of a round; block i takes unit order[i],
// which the wrapper sorts by the packet's emitted slot count, heaviest
// first, so the last wave holds light groups.  Each subtile's 12 KB of
// planes is staged by a 1-D bulk copy (cp.async.bulk, the TMA) into one
// of two shared-memory buffers, completed on an mbarrier: while one
// subtile is tested, the next subtile that the caps before this test
// still find live is fetched into the other buffer.  The group then
// re-decides with the current caps; the decisions only tighten as the
// caps fall, so a stale prefetch wastes bandwidth and changes nothing.
// Acceptance `t > max(tmin, 0)` and beta, gamma, 1 - beta - gamma >= 0,
// written as comparisons so NaN (pad / degenerate planes give t = 0/0) is
// rejected as on the TPU; closest hit keeps an exact argmin, equal t
// going to the lower triangle index.
//
// This replaced a first design: one 512-thread block per packet, launched
// once per 256-packet chunk in packet order, staging each subtile with a
// synchronous copy and deciding every skip for all 512 lanes.  On the
// 1080p first round of the 2.4M-triangle main path its counters showed
// the chunked launches (256 blocks on 132 SMs, each chunk waiting for its
// slowest packet) and the heaviest packet's serial path (104 subtiles for
// 512 lanes) as the time, not the pair loop (PERF.md, section 6).
//
// What bounds it now (G = 64 on an NVIDIA H100): the launch keeps the
// card busy to its end (mean cycles per group times groups over resident
// blocks is the launch time) and the per-pair arithmetic is fp32 issue
// bound: about 41 operations without FMA contraction and one IEEE
// division per lane and triangle, with two 12 KB buffers per group
// limiting residency to 9 groups (18 warps) per SM, so the division's and
// the shared loads' latency are partly exposed.
//
// No tensor cores: a TF32 product differs from fp32 by up to 0.44 on the
// probes' products (sweep_micro.cu) and flips barycentric tests; a split
// such as 3xTF32 does
// not reproduce the __fmul_rn / __fadd_rn rounding that keeps kernel and
// plain version bit-equal (and keeps hits from turning into misses).

#include "sweep_common.cuh"

namespace {

constexpr int STATS = 5;   // per unit: slots visited, clusters entered,
                           // subtile slab tests, subtiles swept, cycles

// ---- group-wide max (the copy, its mbarrier, the vote and the barrier
// are sweep_common.cuh's) ----

// NaN-propagating max over the group (every lane gets it); `red` holds one
// float per warp.
template <int G>
__device__ __forceinline__ float group_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if constexpr (G > 32) {
    __syncthreads();                   // red may still be read from before
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = red[threadIdx.x & (G / 32 - 1)];
    for (int o = G / 64; o > 0; o >>= 1)
      v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// ---- the slot walk ----

// Position in a unit's walk: slot k of cluster cid, subtile s (s < 0:
// the cluster's slab decision is next; s == n_sub: the slot is done).
// k < 0 marks the end.
struct Cursor {
  int k, s, cid;
};

struct Walk {
  const int* ids;      // the packet's MAXC slot ids
  const float* keys;   // the packet's MAXC slot keys
  int cnt;             // slots emitted, clamped to MAXC
  const float* ctab;
  const float* sub_bounds;
  int n_sub;
};

__device__ __forceinline__ Cursor slot_start(const Walk& w, int k) {
  return Cursor{k, -1, max(w.ids[k], 0)};
}

// From cursor c, the first subtile live under each lane's `cap`, or the
// end; every decision is the group's, in the plain version's order.
// COUNT: add the decisions to n[0..2] (slots visited, clusters entered,
// subtile slab tests); a lookahead walk counts nothing.
template <int G, bool COUNT>
__device__ __forceinline__ Cursor walk(const Walk& w, Cursor c,
                                       const Ray& ray, float cap, float* red,
                                       int* n) {
  bool have_mx = false;
  float mx = 0.f;
  while (true) {
    if (c.s < 0) {
      if (COUNT) ++n[0];
      if (group_any<G>(slab_live(w.ctab + (size_t)c.cid * CTAB, ray, cap))) {
        if (COUNT) ++n[1];
        c.s = 0;
      } else {
        c.s = w.n_sub;
      }
    }
    if (c.s < w.n_sub) {
      if (COUNT) ++n[2];
      const size_t sub = (size_t)c.cid * w.n_sub + c.s;
      if (group_any<G>(slab_live(w.sub_bounds + sub * 6, ray, cap))) return c;
      ++c.s;
      continue;
    }
    // slot done: the sound early break on the next slot's key
    if (!have_mx) {
      mx = group_max<G>(cap, red);
      have_mx = true;
    }
    if (c.k + 1 >= w.cnt || !(w.keys[c.k + 1] < mx)) return Cursor{-1, 0, 0};
    c = slot_start(w, c.k + 1);
  }
}

template <bool ANY, int G>
__global__ void __launch_bounds__(G)
sweep_kernel(const int* __restrict__ ids, const int* __restrict__ counts,
             const float* __restrict__ keys, const float* __restrict__ planes,
             const float* __restrict__ ctab, const int* __restrict__ starts,
             const float* __restrict__ sub_bounds, int n_sub,
             const float* __restrict__ org, const float* __restrict__ dir,
             const float* __restrict__ tmax, const float* __restrict__ tmin,
             const int* __restrict__ order, float* __restrict__ t_out,
             int* __restrict__ tri_out, unsigned char* __restrict__ occ_out,
             long long* __restrict__ stats) {
  __shared__ __align__(128) float buf[2][PLANE_FLOATS];
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ float red[G / 32];
  const long long c0 = clock64();
  const int u = order[blockIdx.x];            // lane group u of packet b
  const int b = u / (BLOCK / G);
  const int r = u * G + threadIdx.x;
  const Ray ray = load_ray(org, dir, r);
  const float tx = tmax[r];
  const float tn = fmaxf(tmin[r], 0.f);
  float best = tx;      // closest: best t so far
  int btri = -1;
  bool occ = false;     // any-hit: occluded
  const Walk w{ids + (size_t)b * MAXC, keys + (size_t)b * MAXC,
               min(counts[b], MAXC), ctab, sub_bounds, n_sub};
  int n[4] = {0, 0, 0, 0};

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // per buffer (uniform over the group): the flat subtile it holds or is
  // receiving, whether a copy is in flight, and the parity to wait for
  int held[2] = {-1, -1};
  bool pending[2] = {false, false};
  unsigned parity[2] = {0u, 0u};
  auto wait_copy = [&](int i) {
    if (pending[i]) {
      mbar_wait(&bar[i], parity[i]);
      parity[i] ^= 1u;
      pending[i] = false;
    }
  };
  auto fetch = [&](int i, int sub) {
    if (pending[i]) {          // a stale prefetch: let it land first
      wait_copy(i);
      group_sync<G>();
    }
    if (threadIdx.x == 0)
      bulk_load(buf[i], planes + (size_t)sub * PLANE_FLOATS, &bar[i]);
    pending[i] = true;
    held[i] = sub;
  };
  auto cap_now = [&]() { return ANY ? (occ ? -1.f : tx) : best; };

  Cursor cur = w.cnt > 0
                   ? walk<G, true>(w, slot_start(w, 0), ray, cap_now(), red, n)
                   : Cursor{-1, 0, 0};
  while (cur.k >= 0) {
    const int sub = cur.cid * n_sub + cur.s;
    int cb;
    if (held[0] == sub) {
      cb = 0;
    } else if (held[1] == sub) {
      cb = 1;
    } else {
      cb = pending[0] ? 1 : 0;
      fetch(cb, sub);
    }
    // prefetch the next subtile live under the caps before this test
    const Cursor guess = walk<G, false>(
        w, Cursor{cur.k, cur.s + 1, cur.cid}, ray, cap_now(), red, n);
    if (guess.k >= 0) {
      const int gsub = guess.cid * n_sub + guess.s;
      if (held[cb ^ 1] != gsub) fetch(cb ^ 1, gsub);
    }
    wait_copy(cb);
    const float* sp = buf[cb];
    const float* ci = ctab + (size_t)cur.cid * CTAB;
    const float oxc = ray.ox - ci[6], oyc = ray.oy - ci[7],
                ozc = ray.oz - ci[8];
    if (ANY) {
      for (int j = 0; j < SUBT && !occ; ++j) {
        float t;
        if (tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t) && t < tx) occ = true;
      }
    } else {
      const int base = starts[cur.cid] + cur.s * SUBT;
      for (int j = 0; j < SUBT; ++j) {
        float t;
        if (tri_test(sp, j, oxc, oyc, ozc, ray, tn, &t)) {
          const int tri = base + j;
          if (t < best || (t == best && tri < btri)) {
            best = t;
            btri = tri;
          }
        }
      }
    }
    ++n[3];
    group_sync<G>();           // every lane done with buf[cb]
    if (ANY && !group_any<G>(!occ)) break;
    cur = walk<G, true>(w, Cursor{cur.k, cur.s + 1, cur.cid}, ray, cap_now(),
                        red, n);
  }
  // no copy may still write into this block's shared memory when it exits
  wait_copy(0);
  wait_copy(1);

  if (ANY) {
    occ_out[r] = occ ? 1 : 0;
  } else {
    t_out[r] = best;
    tri_out[r] = btri;
  }
  if (stats != nullptr && threadIdx.x == 0) {
    long long* st = stats + (size_t)u * STATS;
    st[0] = n[0];
    st[1] = n[1];
    st[2] = n[2];
    st[3] = n[3];
    st[4] = clock64() - c0;
  }
}

template <bool ANY>
const void* kernel_for(int group) {
  switch (group) {
    case 32: return (const void*)sweep_kernel<ANY, 32>;
    case 64: return (const void*)sweep_kernel<ANY, 64>;
    case 128: return (const void*)sweep_kernel<ANY, 128>;
    case 256: return (const void*)sweep_kernel<ANY, 256>;
    case 512: return (const void*)sweep_kernel<ANY, 512>;
  }
  return nullptr;
}

template <bool ANY>
int launch(const int* ids, const int* counts, const float* keys,
           const float* planes, const float* ctab, const int* starts,
           const float* sub_bounds, int n_sub, const float* org,
           const float* dir, const float* tmax, const float* tmin,
           const int* order, float* t_out, int* tri_out,
           unsigned char* occ_out, long long* stats, int n_units, int group,
           void* stream) {
  const void* fn = kernel_for<ANY>(group);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (n_units > 0) {
    void* args[] = {&ids,  &counts, &keys, &planes, &ctab,  &starts,
                    &sub_bounds, &n_sub, &org, &dir, &tmax, &tmin,
                    &order, &t_out, &tri_out, &occ_out, &stats};
    cudaError_t e = cudaLaunchKernel(fn, dim3(n_units), dim3(group), args, 0,
                                     (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ids (nb, MAXC) int32, counts (nb, 1) int32, keys (nb, MAXC) f32: the cull
// output.  planes (C, n_sub, 12, SUBT), ctab (C, 12), starts (C,) int32,
// sub_bounds (C, n_sub, 6): the clustered mesh.  org, dir (nb*BLOCK, 3),
// tmax, tmin (nb*BLOCK,).  order (n_units,) int32: unit of each block,
// n_units = nb * BLOCK / group.  Outputs t (nb*BLOCK,) f32 and tri int32;
// stats (n_units, STATS) int64 or null.  Returns a CUDA error code.
extern "C" int cluster_sweep_closest(
    const int* ids, const int* counts, const float* keys, const float* planes,
    const float* ctab, const int* starts, const float* sub_bounds, int n_sub,
    const float* org, const float* dir, const float* tmax, const float* tmin,
    const int* order, float* t_out, int* tri_out, long long* stats,
    int n_units, int group, void* stream) {
  return launch<false>(ids, counts, keys, planes, ctab, starts, sub_bounds,
                       n_sub, org, dir, tmax, tmin, order, t_out, tri_out,
                       nullptr, stats, n_units, group, stream);
}

// Same inputs; output occ (nb*BLOCK,) uint8, 1 iff a triangle is hit with
// tmin < t < tmax.
extern "C" int cluster_sweep_any(
    const int* ids, const int* counts, const float* keys, const float* planes,
    const float* ctab, const int* starts, const float* sub_bounds, int n_sub,
    const float* org, const float* dir, const float* tmax, const float* tmin,
    const int* order, unsigned char* occ_out, long long* stats, int n_units,
    int group, void* stream) {
  return launch<true>(ids, counts, keys, planes, ctab, starts, sub_bounds,
                      n_sub, org, dir, tmax, tmin, order, nullptr, nullptr,
                      occ_out, stats, n_units, group, stream);
}

// Registers per thread, resident blocks per SM and static shared bytes of
// the sweep kernel (any = 0: closest hit, 1: any-hit) for lane groups of
// `group` rays, into out[0..2].  Returns a CUDA error code.
extern "C" int cluster_sweep_info(int any, int group, int* out) {
  const void* fn = any ? kernel_for<true>(group) : kernel_for<false>(group);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, group, 0);
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.sharedSizeBytes;
  return (int)e;
}
