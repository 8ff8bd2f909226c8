// Hand-written Hopper (sm_90a) kernel for the cluster tier's tree cull,
// used above DENSE_CULL_MAX clusters, bound through a plain C interface
// (ctypes, ops/cluster.py `cull_tree`).
//
// Replaces the TPU kernel
//   pathtracer_tpu/ops/pallas_cluster.py::_cull_kernel   (via _cull_call)
// and computes what it computes: per 512-ray packet, walk the top BVH over
// the cluster AABBs (one cluster per leaf) depth first, left child first,
// descending into a child where ANY lane's slab is live; emit every
// reached leaf's clusters with the packet-min slab entry key; keep the
// MAXC = 128 smallest keys (past 128, the worst kept key is replaced when
// the new one is smaller, and the count goes on, so count > MAXC flags
// an incomplete emission); sort the kept slots near-first.  The slab
// formula is the TPU kernel's: t = (lo - o) * (1/d) per axis, entry =
// max(tmin, 0), live = (tmax >= entry) & (tmin < tcap), with IEEE 1/d and
// every operation rounded on its own.
//
// Design (first, simple version):
//   * one block per packet, one thread per lane (512 threads);
//   * the walk is uniform across the block: every thread holds the same
//     node and stack pointer; the stack (node ids, and the entry keys of
//     pushed leaves) lives in shared memory and only thread 0 writes it;
//   * per inner node each thread slab-tests both children; one warp
//     reduction (ballot for liveness, shuffle min for the entry key) and
//     ONE __syncthreads per node combine the 16 warps, through
//     double-buffered shared slots, so every thread knows both children's
//     any-lane liveness and packet-min keys.  A leaf's key is therefore
//     known at its parent and costs no further barrier;
//   * the <= 128 kept ids and keys live in shared memory and only warp 0
//     touches them during the walk: the worst key for a replacement is a
//     warp argmax over the 128 slots (ties to the lowest slot, as the TPU
//     kernel's loop picks);
//   * the final near-first order is a rank sort (128 threads, each counts
//     the keys before its own), stable in slot order; it equals the TPU
//     kernel's selection sort up to the order of equal keys.
// A top tree with more than one cluster per leaf (failed splits) emits
// all of a leaf's clusters with the leaf's key, as the TPU kernel does.
// A root that is itself a leaf (one cluster) is emitted only when some
// lane is live for it, as the plain version does.
//
// What bounds it on an H100: per visited inner node 512 lanes x 2 slab
// tests (about 25 fp32 operations each), far below the card's fp32 rate,
// and the inputs are a few hundred kB of nodes plus the packet's rays.
// Neither bytes nor operations bound it: the walk is serial, one
// __syncthreads and a dependent node load per visited node, thousands of
// nodes per packet on incoherent rays.  Making it fast (wider nodes,
// fewer barriers, several packets per block) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 512;
constexpr int WARPS = BLOCK / 32;
constexpr int MAXC = 128;
constexpr int STACK_DEPTH = 64;
constexpr float BIG_T = 1e30f;

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tcap;
};

// TPU kernel slab (pallas_cluster._cull_kernel `slab`): returns live and
// writes the entry max(tmin, 0).
__device__ __forceinline__ bool slab(const float* box, const Ray& r,
                                     float* entry) {
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
  const float e = nmax(tmin, 0.f);
  *entry = e;
  return (tmax >= e) && (tmin < r.tcap);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Warp 0: add cluster `cid` with key `key` to the kept slots.  `count` is
// the number emitted before this one (uniform).
__device__ __forceinline__ void emit(int cid, float key, int count,
                                     int* s_ids, float* s_keys) {
  const int lane = threadIdx.x;   // called by warp 0 only
  if (count < MAXC) {
    if (lane == 0) {
      s_ids[count] = cid;
      s_keys[count] = key;
    }
  } else {
    // argmax of the kept keys, ties to the lowest slot
    float wk = s_keys[lane];
    int wi = lane;
    for (int j = lane + 32; j < MAXC; j += 32) {
      if (s_keys[j] > wk) {
        wk = s_keys[j];
        wi = j;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ok = __shfl_xor_sync(0xffffffffu, wk, o);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, o);
      if (ok > wk || (ok == wk && oi < wi)) {
        wk = ok;
        wi = oi;
      }
    }
    if (lane == 0 && key < wk) {
      s_ids[wi] = cid;
      s_keys[wi] = key;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(BLOCK)
cull_kernel(const float* __restrict__ box, const int* __restrict__ na,
            const int* __restrict__ nb, const int* __restrict__ nleaf,
            const int* __restrict__ order, const float* __restrict__ org,
            const float* __restrict__ dir, const float* __restrict__ tmax,
            int* __restrict__ ids_out, int* __restrict__ count_out,
            float* __restrict__ keys_out, int* __restrict__ work) {
  __shared__ int s_stack[STACK_DEPTH];
  __shared__ float s_stack_key[STACK_DEPTH];
  __shared__ int s_ids[MAXC];
  __shared__ float s_keys[MAXC];
  __shared__ float s_red_key[2][2][WARPS];
  __shared__ unsigned s_red_live[2][WARPS];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r = p * BLOCK + tid;
  Ray ray;
  ray.ox = org[3 * r];
  ray.oy = org[3 * r + 1];
  ray.oz = org[3 * r + 2];
  ray.ix = __fdiv_rn(1.f, dir[3 * r]);
  ray.iy = __fdiv_rn(1.f, dir[3 * r + 1]);
  ray.iz = __fdiv_rn(1.f, dir[3 * r + 2]);
  ray.tcap = tmax[r];
  if (tid < MAXC) {
    s_ids[tid] = -1;
    s_keys[tid] = BIG_T;
  }
  __syncthreads();

  int count = 0, sp = 0, par = 0, n_inner = 0;
  int node = 0;
  bool have = true;   // `node` is an inner node still to expand

  // Block-wide any-lane liveness and packet-min keys of two boxes.
  auto reduce2 = [&](const float* b0, const float* b1, bool* l0, bool* l1,
                     float* k0, float* k1) {
    float e0, e1;
    const bool v0 = slab(b0, ray, &e0);
    const bool v1 = slab(b1, ray, &e1);
    const unsigned m0 = __ballot_sync(0xffffffffu, v0);
    const unsigned m1 = __ballot_sync(0xffffffffu, v1);
    const float w0 = warp_min(v0 ? e0 : BIG_T);
    const float w1 = warp_min(v1 ? e1 : BIG_T);
    if (lane == 0) {
      s_red_key[par][0][warp] = w0;
      s_red_key[par][1][warp] = w1;
      s_red_live[par][warp] = (m0 ? 1u : 0u) | (m1 ? 2u : 0u);
    }
    __syncthreads();
    unsigned live = 0;
    float a0 = BIG_T, a1 = BIG_T;
    for (int w = 0; w < WARPS; ++w) {
      live |= s_red_live[par][w];
      a0 = fminf(a0, s_red_key[par][0][w]);
      a1 = fminf(a1, s_red_key[par][1][w]);
    }
    par ^= 1;
    *l0 = live & 1u;
    *l1 = live & 2u;
    *k0 = a0;
    *k1 = a1;
  };

  auto emit_leaf = [&](int leaf_node, float key) {
    const int start = na[leaf_node], cnt = nb[leaf_node];
    for (int k = 0; k < cnt; ++k) {
      if (warp == 0) emit(order[start + k], key, count, s_ids, s_keys);
      ++count;
    }
  };

  if (nleaf[0]) {
    // one-cluster tree: the root is the only leaf
    bool l0, l1;
    float k0, k1;
    reduce2(box, box, &l0, &l1, &k0, &k1);
    if (l0) emit_leaf(0, k0);
    have = false;
  }

  while (have) {
    ++n_inner;
    const int a = na[node], b = nb[node];
    bool la, lb;
    float ka, kb;
    reduce2(box + (size_t)a * 6, box + (size_t)b * 6, &la, &lb, &ka, &kb);
    const bool a_leaf = nleaf[a] != 0, b_leaf = nleaf[b] != 0;
    // the TPU kernel pushes b, then a, and pops a first: a's subtree,
    // then b, in that order
    if (la && !a_leaf) {
      if (lb) {
        if (tid == 0) {
          s_stack[sp] = b;
          s_stack_key[sp] = kb;
        }
        ++sp;
      }
      node = a;
      continue;
    }
    if (la) emit_leaf(a, ka);
    if (lb && !b_leaf) {
      node = b;
      continue;
    }
    if (lb) emit_leaf(b, kb);
    // pop: leaves pushed earlier are emitted on the way
    have = false;
    while (sp > 0) {
      --sp;
      const int nd = s_stack[sp];
      if (nleaf[nd]) {
        emit_leaf(nd, s_stack_key[sp]);
      } else {
        node = nd;
        have = true;
        break;
      }
    }
  }
  __syncthreads();

  // near-first rank sort of the kept slots (stable in slot order)
  const int m = count < MAXC ? count : MAXC;
  if (tid < MAXC) {
    int* out_ids = ids_out + (size_t)p * MAXC;
    float* out_keys = keys_out + (size_t)p * MAXC;
    if (tid < m) {
      const float k = s_keys[tid];
      int rank = 0;
      for (int j = 0; j < m; ++j) {
        const float kj = s_keys[j];
        rank += (kj < k || (kj == k && j < tid)) ? 1 : 0;
      }
      out_ids[rank] = s_ids[tid];
      out_keys[rank] = k;
    } else {
      out_ids[tid] = -1;
      out_keys[tid] = BIG_T;
    }
  }
  if (tid == 0) {
    count_out[p] = count;
    if (work) work[p] = n_inner;
  }
}

}  // namespace

// box (M, 6) f32 [lo xyz | hi xyz], na / nb / nleaf (M,) int32 (leaf:
// start in `order` / cluster count), order (C,) int32 leaf position ->
// cluster id; org, dir (nb*512, 3) f32, tmax (nb*512,) f32.  Outputs ids
// (nb, 128) int32 (-1 padded), count (nb,) int32, keys (nb, 128) f32
// (1e30 padded) and, when work is not null, (nb,) int32 inner nodes
// expanded per packet.  Returns cudaGetLastError() after the launch.
extern "C" int cluster_cull_tree(const float* box, const int* na,
                                 const int* nb_, const int* nleaf,
                                 const int* order, const float* org,
                                 const float* dir, const float* tmax,
                                 int n_packets, int* ids_out, int* count_out,
                                 float* keys_out, int* work, void* stream) {
  if (n_packets > 0)
    cull_kernel<<<n_packets, BLOCK, 0, (cudaStream_t)stream>>>(
        box, na, nb_, nleaf, order, org, dir, tmax, ids_out, count_out,
        keys_out, work);
  return (int)cudaGetLastError();
}
