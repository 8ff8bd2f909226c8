// Hand-written Hopper (sm_90a) kernel for the cluster tier's hierarchical
// cull, used from HIER_MIN_CLUSTERS + 1 = 257 up to DENSE_CULL_MAX = 16,384
// clusters, bound through a plain C interface (ctypes, ops/cluster.py
// `hier_cull`).
//
// It replaces no pl.pallas_call: the JAX package leaves this cull to XLA
// (pathtracer_tpu/ops/pallas_cluster.py:1258 `_hier_cull`), and the port
// ran it as about 1,600 torch launches per 256-packet chunk
// (ops/cluster._hier_cull, which stays as the plain version for CPU
// tensors).  It computes exactly what _hier_cull computes, per 512-ray
// packet, in one launch over every packet of a cull round:
//   stage A: the packet's live lanes (tmax > 0) split by direction octant;
//     per non-empty octant group the origin and direction boxes, and per
//     cluster and group the interval slab of _interval_axis on each axis
//     (with the group-level backface bound when normal bounds are given);
//     the group minimum entry and maximum exit; key = max(entry, 0), live
//     where exit >= key, entry < the packet's largest tmax and the
//     cluster is not excluded; then the CAND = 512 smallest packed int32
//     keys (key bits & ~idx_mask) | cluster, which are unique, so any
//     exact selection sorted gives the plain version's candidates;
//   stage B: per live candidate the exact per-ray slab of _slab_keys over
//     all 512 lanes (with the per-ray backface bound), min entry over the
//     live lanes; then the candidates stably sorted by that key (ties in
//     candidate order), the 128 first emitted, count = exact-live
//     candidates + stage-A-live clusters beyond the window (at least 129
//     when any was dropped, the last key then lowered to the dropped
//     clusters' bound), and the ids a windowed round may mark swept.
// The arithmetic is the plain version's, operation for operation: IEEE
// 1/d, every product and sum rounded on its own (-fmad=false), min / max
// NaN-propagating as torch.minimum / torch.maximum, clamp_min as torch's
// (NaN kept, else fmaxf(x, 0)), and the reductions over lanes are minima
// and maxima, which no order changes.  So ids, count, keys and the swept
// ids equal the plain version's bit for bit.
//
// What bounds it on an H100: stage B is 29 fp32 operations per (ray,
// live candidate) pair (42 with normal bounds), up to 512 x 512 pairs per
// packet; stage A 84 per (cluster, octant group) (108).  One bounce of
// the 1080p primaries on the 2.4M-triangle mesh (1,729 clusters, 1,118
// packets, 512 live candidates a packet) is 9.6e9 operations, 0.29 ms at
// the card's 33.45e12 per second; the primaries themselves (4,050 packets,
// half with no live lane, 5 live clusters in the others) are bound by
// their 73 MB of rays and outputs, 0.022 ms, and take 0.25-0.28 ms,
// mostly stage A and its sort of 2,048 keys (PERF.md).  The design:
//   * one 512-thread block per packet; the packet's rays (origin and tmax,
//     1/d, d) live in shared memory, 24 KB, staged once;
//   * the eight octant groups' boxes come from warp shuffles and one pass
//     over the sixteen warps' partials; a group no lane falls in is
//     skipped, as its where() makes it neutral;
//   * stage A: threads stride over the clusters, each cluster against the
//     non-empty groups (one or two for a camera packet, up to eight for
//     bounce rays), the packed keys written to dynamic shared memory (at
//     most 16,384 x 4 B) and sorted there by a block-wide bitonic sort;
//     a packet with no stage-A-live cluster writes its empty emission at
//     once (padding packets, lanes all dead);
//   * stage B: the live candidates are a prefix of the sorted ones; the
//     (candidate, 32-ray chunk) pairs are spread evenly over the 512
//     threads, consecutive threads on consecutive candidates of one chunk,
//     so a warp reads one ray at a time (a shared-memory broadcast) and no
//     thread idles while another holds a whole candidate; each pair's
//     minimum entry and liveness are merged with shared-memory atomics
//     (an unsigned minimum of the float bits is the float minimum for the
//     non-negative keys);
//   * the emission sorts 512 (key, candidate position) pairs, a bitonic
//     sort in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RAYS = 512;            // lanes per packet
constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;
constexpr int MAXC = 128;            // emitted slots per packet
constexpr int CAND = 512;            // CAND_FACTOR * MAXC candidates
constexpr int CHUNK = 32;            // rays per stage-B work item
constexpr int NCHUNK = RAYS / CHUNK;
constexpr int MAX_CLUSTERS = 16384;  // DENSE_CULL_MAX: 14 index bits
constexpr float BIG_T = 1e30f;
constexpr float LIVE_CAP = 9e29f;    // a candidate key below it is live
constexpr int WORK = 6;              // counters per packet (HIER_WORK)
constexpr unsigned FULL = 0xffffffffu;
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

// torch.clamp_min(x, 0.0) on the card: NaN stays NaN, else fmaxf(x, 0).
__device__ __forceinline__ float clamp0(float x) {
  return x != x ? x : fmaxf(x, 0.f);
}

// Order-preserving unsigned image of a float under torch.sort's
// comparison: -0 and +0 equal, NaN last.
__device__ __forceinline__ unsigned sort_bits(float f) {
  if (f != f) return 0xffffffffu;
  if (f == 0.f) return 0x80000000u;
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One axis of one octant group (ops/cluster._interval_axis's inputs).
struct Axis {
  float ol, oh, il1, il2;   // origin interval, 1/d interval ends
  float dl, dh;             // direction interval (the backface bound)
  int onesign, allzero;
};

struct Shared {
  float4 ro[RAYS];          // origin xyz, tmax
  float4 ri[RAYS];          // IEEE 1/d xyz
  float4 rd[RAYS];          // d xyz (the per-ray backface bound)
  float part[NW][8][12];    // per warp and group: olo, ohi, dlo, dhi xyz
  float wred[NW];
  Axis ax[8][3];
  u64 comp[CAND];           // (emission key bits, candidate position)
  int cand_col[CAND];       // candidate cluster
  int cand_id[CAND];        // cluster, or -1 for a dead candidate
  unsigned cand_min[CAND];  // stage B: min entry's bits over the lanes
  int cand_any[CAND];       // stage B: some lane live
  float cand_key[CAND];     // exact key, BIG_T where not live
  float tmx;                // the packet's largest tmax
  float dropped_lb;         // largest candidate key (stage A)
  int gmask;                // octant groups holding a live lane
  int n_live_i, n_live_c, n_live_e;
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min_nan(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Ascending bitonic sort of n (a power of two) values in shared memory by
// the whole block.
template <typename T>
__device__ void bitonic(T* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += THREADS) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const T x = a[lo], y = a[hi];
        if ((x > y) == ((lo & k) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// _interval_axis of one cluster slab [lo, hi] against one group's axis.
__device__ __forceinline__ void interval(const Axis& g, float lo, float hi,
                                         float* t_lo, float* t_hi) {
  if (g.onesign) {
    const float a1 = __fsub_rn(lo, g.oh), a2 = __fsub_rn(lo, g.ol);
    const float b1 = __fsub_rn(hi, g.oh), b2 = __fsub_rn(hi, g.ol);
    const float p0 = __fmul_rn(a1, g.il1), p1 = __fmul_rn(a1, g.il2);
    const float p2 = __fmul_rn(a2, g.il1), p3 = __fmul_rn(a2, g.il2);
    const float p4 = __fmul_rn(b1, g.il1), p5 = __fmul_rn(b1, g.il2);
    const float p6 = __fmul_rn(b2, g.il1), p7 = __fmul_rn(b2, g.il2);
    *t_lo = min_nan(min_nan(min_nan(p0, p1), min_nan(p2, p3)),
                    min_nan(min_nan(p4, p5), min_nan(p6, p7)));
    *t_hi = max_nan(max_nan(max_nan(p0, p1), max_nan(p2, p3)),
                    max_nan(max_nan(p4, p5), max_nan(p6, p7)));
  } else {
    *t_lo = -BIG_T;
    *t_hi = BIG_T;
  }
  if (g.allzero && (hi < g.ol || lo > g.oh)) {
    *t_lo = BIG_T;
    *t_hi = -BIG_T;
  }
}

template <bool NRM, bool EXCL>
__global__ void __launch_bounds__(THREADS, 2)
hier_kernel(const float* __restrict__ bounds, int bstride,
            const float* __restrict__ nrm, int nstride,
            const unsigned char* __restrict__ excl, long long estride,
            const float* __restrict__ org, const float* __restrict__ dir,
            const float* __restrict__ tmax, int c, int p2, int idx_bits,
            int* __restrict__ ids_out, int* __restrict__ count_out,
            float* __restrict__ keys_out, int* __restrict__ swept_out,
            long long* __restrict__ work) {
  __shared__ Shared s;
  extern __shared__ unsigned keys[];   // p2 packed stage-A keys
  const long long t_start = clock64();
  const int p = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int kk = c < CAND ? c : CAND;  // candidates
  const int ke = kk < MAXC ? kk : MAXC;
  int* swept = swept_out + (size_t)p * (kk + MAXC);

  // ---- the packet's rays into shared memory ----
  const size_t r = (size_t)p * RAYS + t;
  const float ox = org[3 * r], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float tm = tmax[r];
  s.ro[t] = make_float4(ox, oy, oz, tm);
  s.ri[t] = make_float4(__fdiv_rn(1.f, dx), __fdiv_rn(1.f, dy),
                        __fdiv_rn(1.f, dz), 0.f);
  s.rd[t] = make_float4(dx, dy, dz, 0.f);
  if (t == 0) {
    s.gmask = 0;
    s.n_live_i = s.n_live_c = s.n_live_e = 0;
  }
  __syncthreads();

  // ---- octant groups: where(group, x, +-BIG) reduced over the lanes ----
  {
    const float tw = warp_max(tm);
    if (lane == 0) s.wred[warp] = tw;
    const bool alive = tm > 0.f;
    const int oct = (dx > 0.f ? 4 : 0) + (dy > 0.f ? 2 : 0) +
                    (dz > 0.f ? 1 : 0);
    for (int og = 0; og < 8; ++og) {
      const bool in = alive && oct == og;
      const unsigned m = __ballot_sync(FULL, in);
      float* out = s.part[warp][og];
      if (m == 0) {
        // no lane of this warp in the group: every value the fill
        if (lane < 12) out[lane] = (lane / 3) % 2 ? -BIG_T : BIG_T;
        continue;
      }
      const float lo_o[3] = {in ? ox : BIG_T, in ? oy : BIG_T,
                             in ? oz : BIG_T};
      const float hi_o[3] = {in ? ox : -BIG_T, in ? oy : -BIG_T,
                             in ? oz : -BIG_T};
      const float lo_d[3] = {in ? dx : BIG_T, in ? dy : BIG_T,
                             in ? dz : BIG_T};
      const float hi_d[3] = {in ? dx : -BIG_T, in ? dy : -BIG_T,
                             in ? dz : -BIG_T};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v0 = warp_min(lo_o[a]), v1 = warp_max(hi_o[a]);
        const float v2 = warp_min(lo_d[a]), v3 = warp_max(hi_d[a]);
        if (lane == 0) {
          out[a] = v0;
          out[3 + a] = v1;
          out[6 + a] = v2;
          out[9 + a] = v3;
        }
      }
      if (lane == 0) atomicOr(&s.gmask, 1 << og);
    }
  }
  __syncthreads();
  if (t < 96) {
    const int g = t / 12, k = t % 12;
    const bool is_max = (k / 3) % 2;
    float v = s.part[0][g][k];
    for (int w = 1; w < NW; ++w)
      v = is_max ? max_nan(v, s.part[w][g][k]) : min_nan(v, s.part[w][g][k]);
    s.part[0][g][k] = v;
  } else if (t == 96) {
    float v = s.wred[0];
    for (int w = 1; w < NW; ++w) v = max_nan(v, s.wred[w]);
    s.tmx = v;
  }
  __syncthreads();
  if (t < 24) {
    const int g = t / 3, a = t % 3;
    const float* b = s.part[0][g];
    Axis x;
    x.ol = b[a];
    x.oh = b[3 + a];
    x.dl = b[6 + a];
    x.dh = b[9 + a];
    x.onesign = (x.dl > 0.f) || (x.dh < 0.f);
    x.allzero = (x.dl == 0.f) && (x.dh == 0.f);
    x.il1 = __fdiv_rn(1.f, x.onesign ? x.dl : 1.f);
    x.il2 = __fdiv_rn(1.f, x.onesign ? x.dh : 1.f);
    s.ax[g][a] = x;
  }
  __syncthreads();
  const int gmask = s.gmask;

  // the packet's counters: octant groups, stage-A-live clusters, live
  // candidates; clock64 cycles in all, to the end of stage A's sort, and
  // of stage B
  auto count_work = [&](int n_live, int n_cand, long long t_a,
                        long long t_b) {
    if (work && t == 0) {
      long long* w = work + (size_t)WORK * p;
      w[0] = __popc(gmask);
      w[1] = n_live;
      w[2] = n_cand;
      w[3] = clock64() - t_start;
      w[4] = t_a - t_start;
      w[5] = t_b - t_a;
    }
  };
  // a packet no cluster can be live for: the empty emission (candidates
  // are then the first columns, every one dead)
  auto empty = [&]() {
    for (int i = t; i < kk + MAXC; i += THREADS) swept[i] = -1;
    if (t < MAXC) {
      ids_out[(size_t)p * MAXC + t] = -1;
      keys_out[(size_t)p * MAXC + t] = BIG_T;
    }
    if (t == 0) count_out[p] = 0;
    const long long now = clock64();
    count_work(0, 0, now, now);
  };
  if (gmask == 0) {
    empty();
    return;
  }

  // ---- stage A: packed interval keys of every cluster ----
  const int idx_mask = (1 << idx_bits) - 1;
  const float tmx = s.tmx;
  int my_live = 0;
  for (int j = t; j < p2; j += THREADS) {
    if (j >= c) {
      keys[j] = 0xffffffffu;
      continue;
    }
    const float* bj = bounds + (size_t)j * bstride;
    const float lo[3] = {bj[0], bj[1], bj[2]};
    const float hi[3] = {bj[3], bj[4], bj[5]};
    float nl[3], nh[3];
    if (NRM) {
      const float* nj = nrm + (size_t)j * nstride;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        nl[a] = nj[a];
        nh[a] = nj[3 + a];
      }
    }
    float entry_lo = BIG_T, exit_hi = -BIG_T;
    for (int og = 0; og < 8; ++og) {
      if (!((gmask >> og) & 1)) continue;
      float e_lo, e_hi;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float a_lo, a_hi;
        interval(s.ax[og][a], lo[a], hi[a], &a_lo, &a_hi);
        e_lo = a == 0 ? a_lo : max_nan(e_lo, a_lo);
        e_hi = a == 0 ? a_hi : min_nan(e_hi, a_hi);
      }
      if (NRM) {
        float lb;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float dl = s.ax[og][a].dl, dh = s.ax[og][a].dh;
          const float m = min_nan(
              min_nan(__fmul_rn(nl[a], dl), __fmul_rn(nl[a], dh)),
              min_nan(__fmul_rn(nh[a], dl), __fmul_rn(nh[a], dh)));
          lb = a == 0 ? m : __fadd_rn(lb, m);
        }
        if (!(lb < 0.f)) {
          e_lo = BIG_T;
          e_hi = -BIG_T;
        }
      }
      entry_lo = min_nan(entry_lo, e_lo);
      exit_hi = max_nan(exit_hi, e_hi);
    }
    const float key = clamp0(entry_lo);
    bool live = (exit_hi >= key) && (entry_lo < tmx);
    if (EXCL) live = live && !excl[(size_t)p * estride + j];
    const int kb = __float_as_int(live ? key : BIG_T);
    keys[j] = (unsigned)((kb & ~idx_mask) | j) ^ 0x80000000u;
    my_live += live ? 1 : 0;
  }
  my_live = __reduce_add_sync(FULL, my_live);
  if (lane == 0 && my_live) atomicAdd(&s.n_live_i, my_live);
  __syncthreads();
  const int n_live_i = s.n_live_i;
  if (n_live_i == 0) {
    empty();
    return;
  }
  bitonic(keys, p2);
  const long long t_a = clock64();

  // ---- the candidates: the kk smallest packed keys, in order ----
  {
    float ck = -INFINITY;
    bool cl = false;
    if (t < kk) {
      const unsigned u = keys[t] ^ 0x80000000u;
      const int col = (int)(u & (unsigned)idx_mask);
      ck = __uint_as_float(u & ~(unsigned)idx_mask);
      cl = ck < LIVE_CAP;
      s.cand_col[t] = col;
      s.cand_id[t] = cl ? col : -1;
      s.cand_min[t] = 0x7f800000u;     // +inf
      s.cand_any[t] = 0;
    }
    const float w = warp_max(ck);
    const int n = __popc(__ballot_sync(FULL, cl));
    if (lane == 0) {
      s.wred[warp] = w;
      if (n) atomicAdd(&s.n_live_c, n);
    }
  }
  __syncthreads();
  if (t == 0) {
    float v = s.wred[0];
    for (int w = 1; w < NW; ++w) v = max_nan(v, s.wred[w]);
    s.dropped_lb = v;
  }

  // ---- stage B: the exact per-ray rectangle over the live candidates,
  // (candidate, 32-ray chunk) pairs spread over the threads ----
  const int nl = s.n_live_c;      // live candidates: a prefix
  for (int q = t; q < nl * NCHUNK; q += THREADS) {
    const int ci = q % nl, r0 = (q / nl) * CHUNK;
    const float* bj = bounds + (size_t)s.cand_col[ci] * bstride;
    const float lx = bj[0], ly = bj[1], lz = bj[2];
    const float hx = bj[3], hy = bj[4], hz = bj[5];
    float nlx = 0.f, nly = 0.f, nlz = 0.f, nhx = 0.f, nhy = 0.f, nhz = 0.f;
    if (NRM) {
      const float* nj = nrm + (size_t)s.cand_col[ci] * nstride;
      nlx = nj[0];
      nly = nj[1];
      nlz = nj[2];
      nhx = nj[3];
      nhy = nj[4];
      nhz = nj[5];
    }
    float acc = INFINITY;
    bool any = false;
#pragma unroll 4
    for (int i = 0; i < CHUNK; ++i) {
      const float4 o = s.ro[r0 + i], iv = s.ri[r0 + i];
      float t1 = __fmul_rn(__fsub_rn(lx, o.x), iv.x);
      float t2 = __fmul_rn(__fsub_rn(hx, o.x), iv.x);
      float tmin = min_nan(t1, t2), tx = max_nan(t1, t2);
      t1 = __fmul_rn(__fsub_rn(ly, o.y), iv.y);
      t2 = __fmul_rn(__fsub_rn(hy, o.y), iv.y);
      tmin = max_nan(tmin, min_nan(t1, t2));
      tx = min_nan(tx, max_nan(t1, t2));
      t1 = __fmul_rn(__fsub_rn(lz, o.z), iv.z);
      t2 = __fmul_rn(__fsub_rn(hz, o.z), iv.z);
      tmin = max_nan(tmin, min_nan(t1, t2));
      tx = min_nan(tx, max_nan(t1, t2));
      const float entry = clamp0(tmin);
      bool live = (tx >= entry) && (tmin < o.w);
      if (NRM) {
        const float4 d = s.rd[r0 + i];
        const float m0 = min_nan(__fmul_rn(nlx, d.x), __fmul_rn(nhx, d.x));
        const float m1 = min_nan(__fmul_rn(nly, d.y), __fmul_rn(nhy, d.y));
        const float m2 = min_nan(__fmul_rn(nlz, d.z), __fmul_rn(nhz, d.z));
        live = live && (__fadd_rn(__fadd_rn(m0, m1), m2) < 0.f);
      }
      acc = fminf(acc, live ? entry : BIG_T);
      any = any || live;
    }
    atomicMin(&s.cand_min[ci], __float_as_uint(acc));
    if (any) atomicOr(&s.cand_any[ci], 1);
  }
  __syncthreads();
  const long long t_b = clock64();

  // ---- the emission: candidates by (exact key, position) ----
  {
    bool le = false;
    if (t < kk) {
      le = t < nl && s.cand_any[t];
      const float k = le ? __uint_as_float(s.cand_min[t]) : BIG_T;
      s.cand_key[t] = k;
      s.comp[t] = ((u64)sort_bits(k) << 32) | (unsigned)t;
      swept[t] = le ? -1 : s.cand_id[t];
    } else {
      s.comp[t] = ~0ull;
    }
    const int n = __popc(__ballot_sync(FULL, le));
    if (lane == 0 && n) atomicAdd(&s.n_live_e, n);
  }
  __syncthreads();
  bitonic(s.comp, CAND);
  const int n_dropped = n_live_i - kk > 0 ? n_live_i - kk : 0;
  if (t < MAXC) {
    float key = BIG_T;
    int id = -1;
    if (t < ke) {
      const int j = (int)(s.comp[t] & 0xffffffffu);
      key = s.cand_key[j];
      id = key < BIG_T ? s.cand_id[j] : -1;
    }
    if (t == MAXC - 1 && n_dropped > 0) key = min_nan(key, s.dropped_lb);
    ids_out[(size_t)p * MAXC + t] = id;
    keys_out[(size_t)p * MAXC + t] = key;
    swept[kk + t] = id;
  }
  if (t == 0) {
    int n = s.n_live_e + n_dropped;
    if (n_dropped > 0 && n < MAXC + 1) n = MAXC + 1;
    count_out[p] = n;
  }
  count_work(n_live_i, nl, t_a, t_b);
}

int pow2_at_least(int c) {
  int n = 1;
  while (n < c) n <<= 1;
  return n;
}

template <bool NRM, bool EXCL>
cudaError_t launch(const float* bounds, int bstride, const float* nrm,
                   int nstride, const unsigned char* excl, long long estride,
                   const float* org, const float* dir, const float* tmax,
                   int n_packets, int c, int* ids, int* count, float* keys,
                   int* swept, long long* work, cudaStream_t stream) {
  const int p2 = pow2_at_least(c);
  const size_t dyn = (size_t)p2 * sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      hier_kernel<NRM, EXCL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (e != cudaSuccess) return e;
  hier_kernel<NRM, EXCL><<<n_packets, THREADS, dyn, stream>>>(
      bounds, bstride, nrm, nstride, excl, estride, org, dir, tmax, c, p2,
      c <= 8192 ? 13 : 14, ids, count, keys, swept, work);
  return cudaGetLastError();
}

template <bool NRM, bool EXCL>
cudaError_t info(int c, int* out) {
  const size_t dyn = (size_t)pow2_at_least(c) * sizeof(unsigned);
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t e = cudaFuncSetAttribute(
      hier_kernel<NRM, EXCL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, hier_kernel<NRM, EXCL>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, hier_kernel<NRM, EXCL>, THREADS, dyn);
  if (e != cudaSuccess) return e;
  out[0] = fa.numRegs;
  out[1] = blocks;
  out[2] = (int)(fa.sharedSizeBytes + dyn);
  out[3] = THREADS;
  return cudaSuccess;
}

}  // namespace

// bounds: C rows of >= 6 f32 (AABB lo xyz, hi xyz), row stride bstride
// floats; nrm: C rows of 6 f32 normal bounds (row stride nstride), or null;
// excl: (n_packets, C) bytes, row stride estride, 1 = excluded, or null;
// org, dir (n_packets * 512, 3) f32, tmax (n_packets * 512,) f32.  Outputs
// ids (n_packets, 128) int32, count (n_packets,) int32, keys (n_packets,
// 128) f32 and swept (n_packets, min(C, 512) + 128) int32, as
// ops/cluster._hier_cull returns them, and, when work is not null,
// (n_packets, 6) int64 counters per packet: octant groups holding a live
// lane, stage-A-live clusters, live candidates; clock64 cycles in all, to
// the end of stage A's sort, and of stage B.  1 <= C <= 16,384.  Returns
// the first CUDA error of the set-up or the launch, else 0.
extern "C" int cluster_hier_cull(const float* bounds, int bstride,
                                 const float* nrm, int nstride,
                                 const unsigned char* excl,
                                 long long estride, const float* org,
                                 const float* dir, const float* tmax,
                                 int n_packets, int c, int* ids, int* count,
                                 float* keys, int* swept, long long* work,
                                 void* stream) {
  if (c < 1 || c > MAX_CLUSTERS) return (int)cudaErrorInvalidValue;
  if (n_packets <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (nrm && excl)
    e = launch<true, true>(bounds, bstride, nrm, nstride, excl, estride, org,
                           dir, tmax, n_packets, c, ids, count, keys, swept,
                           work, st);
  else if (nrm)
    e = launch<true, false>(bounds, bstride, nrm, nstride, excl, estride,
                            org, dir, tmax, n_packets, c, ids, count, keys,
                            swept, work, st);
  else if (excl)
    e = launch<false, true>(bounds, bstride, nrm, nstride, excl, estride,
                            org, dir, tmax, n_packets, c, ids, count, keys,
                            swept, work, st);
  else
    e = launch<false, false>(bounds, bstride, nrm, nstride, excl, estride,
                             org, dir, tmax, n_packets, c, ids, count, keys,
                             swept, work, st);
  return (int)e;
}

// out[4] for C clusters and the given inputs: registers per thread,
// resident blocks per SM, shared bytes per block (static and dynamic),
// threads per block.  Returns the first CUDA error, else 0.
extern "C" int cluster_hier_cull_info(int c, int with_nrm, int with_excl,
                                      int* out) {
  if (c < 1 || c > MAX_CLUSTERS) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (with_nrm && with_excl) e = info<true, true>(c, out);
  else if (with_nrm) e = info<true, false>(c, out);
  else if (with_excl) e = info<false, true>(c, out);
  else e = info<false, false>(c, out);
  return (int)e;
}
