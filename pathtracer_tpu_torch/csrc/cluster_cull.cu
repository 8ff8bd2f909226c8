// Hand-written Hopper (sm_90a) kernel for the cluster tier's tree cull,
// used above DENSE_CULL_MAX clusters, bound through a plain C interface
// (ctypes, ops/cluster.py `cull_tree`).
//
// Replaces the TPU kernel
//   pathtracer_tpu/ops/pallas_cluster.py::_cull_kernel   (via _cull_call)
// and computes what it computes: per 512-ray packet, walk the top BVH over
// the cluster AABBs, descending into a child where ANY lane's slab is
// live; emit every reached leaf's clusters with the packet-min slab entry
// key; count them all (count > MAXC = 128 flags an incomplete emission);
// keep the MAXC smallest and sort them near-first.  The slab formula is
// the TPU kernel's: t = (lo - o) * (1/d) per axis, entry = max(tmin, 0),
// live = (tmax >= entry) & (tmin < tcap), with IEEE 1/d and every
// operation rounded on its own (min / max are min.NaN / max.NaN, NaN in,
// NaN out, as torch.minimum; an entry of -0 is written +0).  Ties are
// broken by cluster id: the kept slots are the 128 smallest (key, id)
// pairs, sorted so, which is the plain version's stable sort in cluster
// order (ops/cluster.cull_tree_plain), so ids, counts and keys equal it
// exactly.  (The TPU kernel keeps the first found among keys equal to the
// 128th.)  Leaves holding several clusters emit each with the leaf's key;
// a root that is itself a leaf is emitted when some lane is live for it.
//
// What bounds it on an H100: the slab tests, 32 rays x 2 children of 23
// fp32 operations for each 32-ray chunk it tests (below), 0.029 ms for the
// 1080p primaries of a 19k-cluster tree (324 chunks per packet) and 0.045
// ms for one bounce of them (1,815); the bytes (nodes, rays, slots) are
// less.  Testing all 512 lanes at every node, as the TPU kernel does,
// would cost 0.039 and 0.186 ms (PERF.md).  The first
// version, one 512-thread block per packet walking depth first with one
// __syncthreads and a 16-warp reduction per node and its dependent node
// loads, took about 4,300 cycles per inner node at 3 blocks per SM, and
// its heaviest packets walked hundreds (primaries) to thousands (bounce
// rays) of nodes alone: 1.18 ms for 4,050 primary packets, 30 times the
// bound (PERF.md).  The set of nodes a packet reaches does not depend on
// the order of the walk (a node is reached iff some lane is live for it),
// so this one spreads the walk over nodes instead of rays and keeps every
// step off the block barrier:
//   * one 256-thread block (8 warps) per packet, 4 per SM (64 registers);
//     the packet's rays live in shared memory (origin and tmax, 1/d: 16 KB);
//   * a node is tested only on the rays live for its parent: a child's box
//     lies inside its parent's and a slab interval only narrows with the
//     box under rounding, so a ray whose parent test was dead (and not NaN)
//     is dead for every descendant.  A node carries a 512-bit ray mask,
//     16 bits in each lane (lane l owns rays l + 32 k), and only the chunks
//     k with a live ray in some lane are tested, four at a time while four
//     remain (eight slab tests in flight per lane, no shuffle or ballot in
//     the loop): deep nodes of a coherent packet cost a chunk or two.  (A
//     test of whole chunks on their rays' bounds first settled 43% of the
//     primaries' chunks and none of the bounce rays'; it took 5% off the
//     primaries and added 6 to 11% to the bounce rays, so it went);
//   * a warp walks depth first on its own, testing a node's two children
//     (then two votes and, for a leaf, a shuffle-min; no barrier), with its
//     own stack of (node, mask) entries.  The walk starts on warp 0; a warp
//     out of work waits, polling with a growing back-off so that it leaves
//     the issue slots to the walking warps, and a working warp hands the
//     shallowest entry of its stack (the largest subtree) to a shared pool
//     while some warp waits.  The walk ends when every warp waits and the
//     pool is empty.  So a coherent packet's walk (a few dozen nodes down
//     one path) pays no barrier per level, and an incoherent one's
//     (hundreds to thousands of nodes) spreads over eight warps (four, at
//     7 blocks per SM, took 6% longer on primaries, 10 to 19% on bounce
//     rays);
//   * each node is one 64-byte child-pair record (both children's boxes,
//     records or cluster ranges; ClusteredMesh.top_pairs); while a node is
//     tested, its inner children's records are loaded, one word per lane,
//     and the next node takes its record from those lanes;
//   * reached clusters go to the warp's own buffer of (key, id) pairs;
//     when it fills, the warp keeps its 128 smallest and drops later pairs
//     that are not below the 128th; the end merges the eight buffers by
//     rank and writes the 128 smallest, sorted.
// On the 1080p primaries of a 19k-cluster tree this takes about 28% of the
// first version's time.  What holds it now: the launch's end, as the
// heaviest packets (up to 452 nodes) start late; the same packets ordered
// heaviest first take about 23% less (the first round of a query
// has no counts to order them by).  And the walk of a coherent packet is
// one path down the tree, so about two warps per scheduler are busy and a
// node's chain of dependent steps sets the pace (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAYS = 512;            // lanes per packet
constexpr int NW = 8;                // warps per packet
constexpr int THREADS = NW * 32;
constexpr int CHUNKS = RAYS / 32;    // rays per lane: lane + 32 k
constexpr int MAXC = 128;
constexpr int STACK_DEPTH = 64;      // build_clustered refuses deeper trees
constexpr int CB = MAXC + 32;        // (key, id) pairs buffered per warp:
                                     // a trim, then one chunk of a leaf
constexpr int ENTRY = CHUNKS + 1;    // stack entry: 32 lanes' 16-bit ray
                                     // masks in 16 words, then the node
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG_T = 1e30f;
typedef unsigned long long u64;

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

struct Shared {
  float4 ro[RAYS];          // origin xyz, tmax
  float4 ri[RAYS];          // IEEE 1/d xyz, unused
  u64 buf[NW][CB];         // (key bits << 32 | cluster id), per warp
  int pool[NW][ENTRY];     // stack entries handed to waiting warps
  int state;               // waiting warps | pool entries << 8 (under lock)
  int lock;
  int fill[NW];
  int total[4];            // inner nodes, leaves reached, clusters,
                           // 32-ray chunks tested
};

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

struct Node {
  Box a, b;
  int ra, rb, ca, cb;      // child record or first cluster; cluster count
};

// A record from the lanes holding it, word j in lane base + j.
__device__ __forceinline__ Node shfl_node(float w, int base) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = __shfl_sync(FULL, w, base + j);
  return Node{{v[0], v[1], v[2], v[3], v[4], v[5]},
              {v[6], v[7], v[8], v[9], v[10], v[11]},
              __float_as_int(v[12]), __float_as_int(v[13]),
              __float_as_int(v[14]), __float_as_int(v[15])};
}

__device__ __forceinline__ Node load_node(const float4* __restrict__ pairs,
                                          int rec) {
  const float4* q = pairs + 4 * (size_t)rec;
  const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
               q3 = __ldg(q + 3);
  return Node{{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y},
              {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w},
              __float_as_int(q3.x), __float_as_int(q3.y),
              __float_as_int(q3.z), __float_as_int(q3.w)};
}

// TPU kernel slab (pallas_cluster._cull_kernel `slab`) of one box against
// a ray (o: origin and tmax, inv: 1/d): live, the entry max(tmin, 0) with
// -0 written +0 (ignored where not live), and whether a descendant can be
// live (live, or NaN).
__device__ __forceinline__ bool slab(const Box& b, float4 o, float4 inv,
                                     float* entry, bool* keep) {
  float t1 = __fmul_rn(__fsub_rn(b.lx, o.x), inv.x);
  float t2 = __fmul_rn(__fsub_rn(b.hx, o.x), inv.x);
  float tmin = min_nan(t1, t2), tmax = max_nan(t1, t2);
  t1 = __fmul_rn(__fsub_rn(b.ly, o.y), inv.y);
  t2 = __fmul_rn(__fsub_rn(b.hy, o.y), inv.y);
  tmin = max_nan(tmin, min_nan(t1, t2));
  tmax = min_nan(tmax, max_nan(t1, t2));
  t1 = __fmul_rn(__fsub_rn(b.lz, o.z), inv.z);
  t2 = __fmul_rn(__fsub_rn(b.hz, o.z), inv.z);
  tmin = max_nan(tmin, min_nan(t1, t2));
  tmax = min_nan(tmax, max_nan(t1, t2));
  const float e = tmin > 0.f ? tmin : 0.f;
  *entry = e;
  const bool live = (tmax >= e) && (tmin < o.w);
  *keep = live || tmin != tmin;
  return live;
}

// Liveness and packet-min keys of a node's two children, accumulated per
// lane over the rays it tests.
struct Acc {
  bool la, lb;
  float ka, kb;
};

// One warp tests a node's two children on the node's live rays: the lane
// owns rays lane + 32 k, live where bit k of m is set.  The chunks k with
// a live ray in some lane are tested, four at a time while four remain, so
// eight slab tests per lane are in flight.  Returns this lane's masks of
// the children.
__device__ __forceinline__ void test_node(const Node& nd, const Shared& s,
                                          unsigned m, int lane, Acc& acc,
                                          unsigned* ma, unsigned* mb,
                                          int& n_chunks) {
  unsigned todo = __reduce_or_sync(FULL, m);
  n_chunks += __popc(todo);
  unsigned wa = 0u, wb = 0u;
  auto chunk = [&](int k) {
    const bool on = (m >> k) & 1u;
    const int r = lane + 32 * k;
    const float4 o = s.ro[r], inv = s.ri[r];
    float ea, eb;
    bool keep_a, keep_b;
    const bool la = slab(nd.a, o, inv, &ea, &keep_a) && on;
    const bool lb = slab(nd.b, o, inv, &eb, &keep_b) && on;
    acc.la |= la;
    acc.lb |= lb;
    acc.ka = la ? fminf(acc.ka, ea) : acc.ka;
    acc.kb = lb ? fminf(acc.kb, eb) : acc.kb;
    wa |= (on && keep_a ? 1u : 0u) << k;
    wb |= (on && keep_b ? 1u : 0u) << k;
  };
  while (__popc(todo) >= 4) {
    int ks[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ks[j] = __ffs(todo) - 1;
      todo &= todo - 1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) chunk(ks[j]);
  }
  while (todo) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    chunk(k);
  }
  *ma = wa;
  *mb = wb;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Rank of v among the n distinct values of a (shared memory), counted by
// the calling lane.
__device__ __forceinline__ int rank_of(u64 v, const u64* a, int n) {
  int r = 0;
  for (int j = 0; j < n; ++j) r += a[j] < v ? 1 : 0;
  return r;
}

// One warp, n >= MAXC pairs buffered: keep the MAXC smallest, sorted, and
// return the largest kept (the bar a later pair must pass).
__device__ u64 trim(u64* b, int n, int lane) {
  u64 v[CB / 32];
  int rk[CB / 32];
#pragma unroll
  for (int k = 0; k < CB / 32; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < n ? b[i] : 0ull;
    rk[k] = i < n ? rank_of(v[k], b, n) : MAXC;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < CB / 32; ++k)
    if (rk[k] < MAXC) b[rk[k]] = v[k];
  __syncwarp();
  return b[MAXC - 1];
}

// The pool's lock, taken and released by one lane of a warp.
__device__ __forceinline__ void acquire(int* l) {
  while (atomicCAS(l, 0, 1) != 0) __nanosleep(32);
  __threadfence_block();
}
__device__ __forceinline__ void release(int* l) {
  __threadfence_block();
  atomicExch(l, 0);
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(THREADS, 4)
cull_kernel(const float4* __restrict__ pairs, int cap,
            const float* __restrict__ root, int root_cnt,
            const int* __restrict__ order, const float* __restrict__ org,
            const float* __restrict__ dir, const float* __restrict__ tmax,
            int* __restrict__ ids_out, int* __restrict__ count_out,
            float* __restrict__ keys_out, long long* __restrict__ work) {
  __shared__ Shared s;
  extern __shared__ int stacks[];  // per warp: cap entries of ENTRY words
  const long long t_start = clock64();
  const int p = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- the packet's rays into shared memory ----
  const float* po = org + (size_t)p * RAYS * 3;
  const float* pd = dir + (size_t)p * RAYS * 3;
  const float* pt = tmax + (size_t)p * RAYS;
#pragma unroll
  for (int i = tid; i < RAYS; i += THREADS) {
    s.ro[i] = make_float4(po[3 * i], po[3 * i + 1], po[3 * i + 2], pt[i]);
    s.ri[i] = make_float4(__fdiv_rn(1.f, pd[3 * i]),
                          __fdiv_rn(1.f, pd[3 * i + 1]),
                          __fdiv_rn(1.f, pd[3 * i + 2]), 0.f);
  }
  if (tid < 4) s.total[tid] = 0;
  if (tid == 0) {
    s.state = NW - 1;      // warp 0 starts at the root, the others wait
    s.lock = 0;
  }
  __syncthreads();
  const long long t_walk = clock64();

  // per-warp state, the same in every lane of the warp
  u64* buf = s.buf[warp];
  int fill = 0, n_inner = 0, n_leaves = 0, count = 0;
  int n_chunks = 0;
  u64 bar = ~0ull;         // a pair not below it cannot be kept

  // clusters order[start, start + cnt) reached with packet-min key `key`
  auto emit = [&](float key, int start, int cnt) {
    ++n_leaves;
    count += cnt;
    const u64 kb = (u64)__float_as_uint(key) << 32;
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      const int k = k0 + lane;
      const u64 v = k < cnt ? (kb | (unsigned)order[start + k]) : ~0ull;
      if (!__any_sync(FULL, v < bar)) continue;
      if (fill + __popc(__ballot_sync(FULL, v < bar)) > CB) {
        bar = trim(buf, fill, lane);
        fill = MAXC;
      }
      const unsigned m = __ballot_sync(FULL, v < bar);
      if (v < bar) buf[fill + __popc(m & ((1u << lane) - 1))] = v;
      fill += __popc(m);
      __syncwarp();
    }
  };

  if (root_cnt) {
    // one-cluster tree: the root is the only leaf
    if (warp == 0) {
      const Box br = {root[0], root[1], root[2], root[3], root[4], root[5]};
      bool l = false, keep;
      float key = BIG_T;
      for (int k = 0; k < CHUNKS; ++k) {
        float e;
        const int r = lane + 32 * k;
        if (slab(br, s.ro[r], s.ri[r], &e, &keep)) {
          l = true;
          key = fminf(key, e);
        }
      }
      if (__any_sync(FULL, l)) emit(warp_min(key), 0, root_cnt);
    }
  } else {
    // ---- each warp depth first; idle warps take donated subtrees ----
    int* stack = stacks + warp * cap * ENTRY;   // a ring of cap entries
    int bot = 0, top = 0;                        // entries [bot, top)
    bool have = warp == 0;
    int node = 0;
    unsigned m = (1u << CHUNKS) - 1;             // this lane's live rays
    // the inner children's records, loaded while their parent is tested:
    // word lane & 15 of child a's (lanes 0-15) and child b's (16-31)
    float pre = 0.f;
    int from = -1;          // the next node's record: in lanes `from` + j
    volatile int* state = &s.state;
    unsigned nap = 32;      // a waiting warp's poll interval, ns, doubling
    for (;;) {
      if (!have) {
        // wait: take a pool entry, or end when all wait and it is empty
        int st = 0;
        if (lane == 0) st = *state;
        st = __shfl_sync(FULL, st, 0);
        if (st == NW) break;
        if ((st >> 8) == 0) {
          // back off, so that waiting warps leave the issue slots to the
          // walking ones
          __nanosleep(nap);
          nap = nap < 512 ? 2 * nap : nap;
          continue;
        }
        int got = 0;
        if (lane == 0) {
          acquire(&s.lock);
          got = *state >> 8;
          if (got > 0) *state = *state - 256 - 1;
        }
        got = __shfl_sync(FULL, got, 0);
        __syncwarp();
        if (got) {
          const volatile int* e = s.pool[got - 1];
          node = e[CHUNKS];
          m = reinterpret_cast<const volatile unsigned short*>(e)[lane];
          have = true;
          nap = 32;
        }
        __syncwarp();
        if (lane == 0) release(&s.lock);
        continue;
      }
      ++n_inner;
      const Node nd = from < 0 ? load_node(pairs, node) : shfl_node(pre, from);
      {
        const int c = lane < 16 ? nd.ra : nd.rb;
        const int cnt = lane < 16 ? nd.ca : nd.cb;
        if (cnt == 0)
          pre = __ldg(reinterpret_cast<const float*>(pairs) + 16 * (size_t)c +
                      (lane & 15));
        else if (lane == 0 || lane == 16)
          prefetch_l1(order + c);
      }
      from = -1;
      Acc acc = {false, false, BIG_T, BIG_T};
      unsigned ma, mb;
      test_node(nd, s, m, lane, acc, &ma, &mb, n_chunks);
      const bool la = __any_sync(FULL, acc.la);
      const bool lb = __any_sync(FULL, acc.lb);
      int a = -1, b = -1;
      if (la) {
        if (nd.ca > 0)
          emit(warp_min(acc.ka), nd.ra, nd.ca);
        else
          a = nd.ra;
      }
      if (lb) {
        if (nd.cb > 0)
          emit(warp_min(acc.kb), nd.rb, nd.cb);
        else
          b = nd.rb;
      }
      if (a >= 0 && b >= 0) {
        int* e = stack + (top % cap) * ENTRY;
        reinterpret_cast<unsigned short*>(e)[lane] = (unsigned short)mb;
        if (lane == 0) e[CHUNKS] = b;
        ++top;
        node = a;
        m = ma;
        from = 0;
      } else if (a >= 0) {
        node = a;
        m = ma;
        from = 0;
      } else if (b >= 0) {
        node = b;
        m = mb;
        from = 16;
      } else if (top > bot) {
        __syncwarp();
        const int* e = stack + ((--top) % cap) * ENTRY;
        node = e[CHUNKS];
        m = reinterpret_cast<const unsigned short*>(e)[lane];
      } else {
        // out of work: wait (the pool's count of waiting warps rises)
        if (lane == 0) {
          acquire(&s.lock);
          *state = *state + 1;
          release(&s.lock);
        }
        have = false;
      }
      __syncwarp();
      // hand the shallowest entry to a waiting warp
      if (top > bot) {
        int st = 0;
        if (lane == 0) st = *state;
        st = __shfl_sync(FULL, st, 0);
        if ((st >> 8) < (st & 255)) {
          int slot = -1;
          if (lane == 0) {
            acquire(&s.lock);
            const int st2 = *state;
            if ((st2 >> 8) < (st2 & 255)) slot = st2 >> 8;
            else release(&s.lock);
          }
          slot = __shfl_sync(FULL, slot, 0);
          if (slot >= 0) {
            const int* e = stack + (bot % cap) * ENTRY;
            if (lane <= CHUNKS) s.pool[slot][lane] = e[lane];
            ++bot;
            __syncwarp();
            if (lane == 0) {
              *state = *state + 256;
              release(&s.lock);
            }
          }
        }
      }
    }
  }

  // ---- merge the warps' buffers: the MAXC smallest pairs, sorted ----
  if (fill > MAXC) {
    trim(buf, fill, lane);
    fill = MAXC;
  }
  if (lane == 0) {
    s.fill[warp] = fill;
    atomicAdd(&s.total[0], n_inner);
    atomicAdd(&s.total[1], n_leaves);
    atomicAdd(&s.total[2], count);
    atomicAdd(&s.total[3], n_chunks);
  }
  __syncthreads();
  const long long t_merge = clock64();
  int* out_ids = ids_out + (size_t)p * MAXC;
  float* out_keys = keys_out + (size_t)p * MAXC;
  int n_all = 0;
  for (int w = 0; w < NW; ++w) n_all += s.fill[w];
  for (int w = 0; w < NW; ++w) {
    for (int i = tid; i < s.fill[w]; i += THREADS) {
      const u64 v = s.buf[w][i];
      int rk = 0;
      for (int w2 = 0; w2 < NW; ++w2) rk += rank_of(v, s.buf[w2], s.fill[w2]);
      if (rk < MAXC) {
        out_ids[rk] = (int)(unsigned)(v & 0xffffffffu);
        out_keys[rk] = __uint_as_float((unsigned)(v >> 32));
      }
    }
  }
  for (int i = (n_all < MAXC ? n_all : MAXC) + tid; i < MAXC; i += THREADS) {
    out_ids[i] = -1;
    out_keys[i] = BIG_T;
  }
  if (tid == 0) {
    count_out[p] = s.total[2];
    if (work) {
      long long* w = work + 7 * (size_t)p;
      w[0] = s.total[0];
      w[1] = s.total[1];
      w[2] = s.total[2];
      w[3] = clock64() - t_start;
      w[4] = t_walk - t_start;
      w[5] = t_merge - t_walk;
      w[6] = s.total[3];
    }
  }
}

int stack_cap(int depth) {
  return depth < 1 ? 1 : (depth < STACK_DEPTH ? depth : STACK_DEPTH);
}

cudaError_t set_smem(size_t dyn) {
  return cudaFuncSetAttribute(cull_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dyn);
}

}  // namespace

// pairs (R, 16) child-pair records of the top tree's inner nodes
// (ops/packet_bvh.pair_records, leaf ranges in `order`), depth the top
// tree's deepest node; when the root is itself a leaf, R = 0, root is its
// box (6 f32) and root_cnt its cluster count, else root_cnt = 0.  order
// (C,) int32 leaf position -> cluster id; org, dir (nb*512, 3) f32, tmax
// (nb*512,) f32.  Outputs ids (nb, 128) int32 (-1 padded), count (nb,)
// int32, keys (nb, 128) f32 (1e30 padded) and, when work is not null,
// (nb, 7) int64 counters per packet: inner nodes expanded, leaves
// reached, clusters emitted; clock64 cycles in all, to stage the rays, and
// of the walk; 32-ray chunks tested (each 32 rays x 2 slab tests).  Returns the first CUDA error of the set-up or
// the launch, else 0.
extern "C" int cluster_cull_tree(const float* pairs, int depth,
                                 const float* root, int root_cnt,
                                 const int* order, const float* org,
                                 const float* dir, const float* tmax,
                                 int n_packets, int* ids_out, int* count_out,
                                 float* keys_out, long long* work,
                                 void* stream) {
  if (n_packets <= 0) return 0;
  const int cap = stack_cap(depth);
  const size_t dyn = (size_t)NW * cap * ENTRY * sizeof(int);
  cudaError_t e = set_smem(dyn);
  if (e != cudaSuccess) return (int)e;
  cull_kernel<<<n_packets, THREADS, dyn, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(pairs), cap, root, root_cnt, order, org,
      dir, tmax, ids_out, count_out, keys_out, work);
  return (int)cudaGetLastError();
}

// out[4] for a top tree of the given depth: registers per thread, resident
// blocks per SM, shared bytes per block (static and dynamic), threads per
// block.  Returns the first CUDA error, else 0.
extern "C" int cluster_cull_info(int depth, int* out) {
  const size_t dyn = (size_t)NW * stack_cap(depth) * ENTRY * sizeof(int);
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t e = set_smem(dyn);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, cull_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cull_kernel,
                                                      THREADS, dyn);
  out[0] = fa.numRegs;
  out[1] = blocks;
  out[2] = (int)(fa.sharedSizeBytes + dyn);
  out[3] = THREADS;
  return (int)e;
}
