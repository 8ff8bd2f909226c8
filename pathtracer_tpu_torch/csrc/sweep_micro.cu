// Hand-written Hopper (sm_90a) kernels for the cluster sweep's cost probes,
// bound through a plain C interface (ctypes, ops/sweep_micro.py).
//
// Replaces the TPU kernels
//   scripts/tpu_prof_sweep.py::matmul_kernel   (DEFAULT / HIGHEST)  -> dot
//   scripts/tpu_proto_mxu.py::mxu_kernel, vpu_kernel                -> dot
//   scripts/tpu_prof_sweep.py::epilogue_kernel                      -> epilogue
//   scripts/tpu_prof_sweep.py::edgemat_kernel                       -> edgemat
// and computes what they compute, not how: the TPU kernels run one
// program over arrays held whole in VMEM; here each kernel spreads the
// rows (and, for the products, the columns) over the whole card and keeps
// the REPS loop inside each thread.
//
// dot: out = sum_{i < reps} (x + i*eps) @ w, x (M, 8), w (8, N) f32.
//   * FP32 route (the counterpart of Precision.HIGHEST and of the VPU
//     kernel): per rep r = x + i*eps, s = r[0] * w[0] rounded, then s =
//     fma(r[k], w[k], s) for k = 1..7 in order, each rounded once
//     (__fmaf_rn, an FFMA even under -fmad=false), and acc = acc + s; the
//     plain version states each FMA through ops/sweep_micro.fma_rn, so the
//     two agree bit for bit.  Bound: fp32 instruction issue, 9 instructions
//     per output per rep (FMUL, seven FFMA, FADD) and 8 per row (the
//     shifts).  acc is summed in rep order, so the reps stay in one
//     thread and the parallelism is the outputs': one thread per 2 x 8
//     tile, its x rows, w columns and accumulators in registers for the
//     whole launch (128 registers, 16 warps per SM), 16 shift FADDs a rep
//     beside 144 counted instructions.  Measured against it (PERF.md,
//     section 6): a 1 x 16 tile, 8 shift FADDs, needs over 168 registers
//     to overlap its chains (ptxas serializes them at 12 warps per SM) and
//     then leaves 8 warps per SM, too few for the 11.6 per SM of the
//     768-column probe; shifts shared by a warp through shared memory cost
//     more instructions than they saved.
//   * TF32 route (the counterpart of Precision.DEFAULT and of the MXU
//     kernel): one warpgroup per 64 x NT output tile, NT = 96 where it
//     divides N, else 64 (ops/sweep_micro.dot_tile, PERF.md section 6).  w's
//     tile is rounded to TF32 and written once into shared memory,
//     transposed to the K-major layout that TF32 wgmma takes; each rep
//     rounds x + i*eps (cvt.rna.tf32.f32) into a register A fragment and
//     issues one wgmma.m64nNTk8 into the fp32 accumulator, which stays in
//     registers for all reps.  The reps' wgmmas are committed REP_GROUP at
//     a time with A_SETS groups in flight, so the tensor pipe is fed back
//     to back.  The accumulator leaves through shared memory, each warp
//     storing whole row segments 16 bytes a lane.  Bound: the dense TF32
//     tensor rate.
//     This replaced one warp per 16 x 64 tile issuing eight dependent
//     mma.sync.m16n8k8 a rep: 11.6 warps per SM at 1536 columns, 5.8 at
//     768, with the tensor pipe waiting on latency (PERF.md, section 6).
//   The TPU kernel of tpu_prof_sweep keeps only out[:, :128]; a compiler
//   would drop the other columns, so every thread also writes the sums of
//   adjacent column pairs of its accumulators (`pairs`, (M, N/2)), which
//   keeps the whole product live every rep.
//
// epilogue: p (M, 6*256), tn (M,) f32; per rep the six-way split, t, beta,
//   gamma, acceptance, first-index argmin and best-t update of the sweep's
//   epilogue.  One block per ray and one thread per triangle, its six
//   values in registers (p is read once), the reps' shifts computed once
//   per block into shared memory; a thread keeps its first least accepted
//   t in rep order, and the block's threads combine their (t, rep, tri)
//   by the 64-bit key of pair_key, which gives exactly the per-rep
//   update's result, signed zeros included.  1,024 rays give 64 warps per
//   SM where registers allow.  Bound: fp32 instructions.  This replaced
//   one warp per ray with eight triangles a lane: under eight warps per SM,
//   too few to hide the divide's latency (PERF.md, section 6).
//
// edgemat: o, d (3, M), tr (12, 256) f32; per rep the edge-matrix ray x
//   triangle test and a min of t.  The result, the least accepted t over
//   all (rep, triangle) pairs of a ray, does not depend on the pairs'
//   order, so the reps are cut into ranges over blocks (enough blocks for
//   about four waves): one thread per triangle, eight rays per block read
//   from shared memory, tr + i*eps computed in registers once per rep for
//   the eight rays, no barrier per rep.  Partial minima are combined
//   exactly by pair_key, and a second small kernel reduces the ranges'
//   keys.  Bound: fp32 instructions (41 counted operations a pair, the
//   divide several instructions).
//
//   This replaced one warp per ray, four rays per block, writing tr +
//   i*eps into shared memory every rep behind a block barrier: 1,024 rays
//   gave under eight warps per SM, too few to hide the divide's and the
//   twelve shared loads' latency (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 8;              // depth of the ray matrix (the scripts' AR)
constexpr float BIG_T = 1e30f;
constexpr int SUBT = 256;         // triangles per subtile
constexpr unsigned long long NONE = ~0ull;

constexpr int TR = 2, TC = 8;     // FP32 route: rows x columns a thread
constexpr int DOT_THREADS = 64;   // FP32 route: threads per block
constexpr int WG_ROWS = 64;       // TF32 route: rows of a tile (wgmma's M)
constexpr int WG_THREADS = 128;   // one warpgroup
constexpr int REP_GROUP = 4;      // reps whose wgmmas are committed together
constexpr int A_SETS = 3;         // groups whose wgmmas may be in flight
constexpr int STAGE_COLS = 32;    // columns a warp stages at a time to store
constexpr int STAGE_ROW = STAGE_COLS + 4;   // padded, 16-byte aligned

// The combine key of an accepted t (>= 0, so -0.0 or positive) at (rep,
// tri): |t|'s bits, then the pair's place in (rep, tri) order, then t's
// sign.  The least key is the least t, -0.0 and +0.0 equal as floats,
// and among equal t the first pair in (rep, tri) order, whose sign it
// keeps.  NONE when no pair was accepted.
__device__ __forceinline__ unsigned long long pair_key(float t, int rep,
                                                       int tri) {
  if (!(t < BIG_T)) return NONE;
  const unsigned b = __float_as_uint(t);
  return ((unsigned long long)(b & 0x7fffffffu) << 32) |
         ((unsigned long long)(rep * SUBT + tri) << 1) | (b >> 31);
}

// The t of a key, its sign restored (BIG_T for NONE).
__device__ __forceinline__ float key_to_t(unsigned long long v) {
  return v == NONE ? BIG_T
                   : __uint_as_float((unsigned)(v >> 32) |
                                     ((unsigned)(v & 1) << 31));
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return b < a ? b : a;
}

// Thread g owns rows row0, row0 + 1 and eight columns in two groups of
// four, N / 2 apart: columns 4t .. 4t + 3 and N / 2 + 4t .. N / 2 + 4t + 3
// (t = g % (n / 8)), so a warp's 16-byte stores of one group are
// contiguous.  The grid has exactly (m / 2) * (n / 8) threads, a multiple
// of 64 under the wrapper's contract.  __launch_bounds__ holds the
// registers to 128, which keeps 16 warps per SM (8 blocks of 64).
__global__ void __launch_bounds__(DOT_THREADS, 8)
dot_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                int m, int n, int reps, float eps, int out_cols,
                float* __restrict__ out, float* __restrict__ pairs) {
  const int ncg = n / TC;
  const int g = blockIdx.x * DOT_THREADS + threadIdx.x;
  const int row0 = (g / ncg) * TR, t = g % ncg;
  const int col[2] = {4 * t, n / 2 + 4 * t};
  float xr[TR][K], wr[K][TC], acc[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k) xr[r][k] = x[(row0 + r) * K + k];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < TC; ++c) wr[k][c] = w[k * n + col[c / 4] + c % 4];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int i = 0; i < reps; ++i) {
    const float step = __fmul_rn((float)i, eps);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float rr[K];
#pragma unroll
      for (int k = 0; k < K; ++k) rr[k] = __fadd_rn(xr[r][k], step);
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        float s = __fmul_rn(rr[0], wr[0][c]);
#pragma unroll
        for (int k = 1; k < K; ++k) s = __fmaf_rn(rr[k], wr[k][c], s);
        acc[r][c] = __fadd_rn(acc[r][c], s);
      }
    }
  }
  // out and pairs come from the wrapper's torch.empty (16-byte aligned):
  // a group of out takes one 16-byte store where out_cols % 4 == 0, its
  // two pair sums one 8-byte store
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 a = make_float4(acc[r][4 * j], acc[r][4 * j + 1],
                                   acc[r][4 * j + 2], acc[r][4 * j + 3]);
      float* o = out + (size_t)row * out_cols + col[j];
      if (out_cols % 4 == 0 && col[j] + 4 <= out_cols) {
        *reinterpret_cast<float4*>(o) = a;
      } else {
        const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col[j] + q < out_cols) o[q] = e[q];
      }
      *reinterpret_cast<float2*>(pairs + (size_t)row * (n / 2) + col[j] / 2) =
          make_float2(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w));
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// One wgmma.m64nNk8.f32.tf32.tf32: D (64 x N, the N / 2 registers of d)
// += A (64 x 8, the four registers of a) * B (8 x N, shared memory, by
// descriptor b).  DREGS names the accumulators %0 .. %(N/2 - 1); A's
// registers, b and the scale-d flag (1: accumulate) follow them.
#define WGMMA_TF32(N, DREGS, A0, A1, A2, A3, B, SCALE, ...)                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SCALE ", 0;\n"        \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"  \
               DREGS "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B    \
               ", p, 1, 1;\n}\n"                                            \
               : __VA_ARGS__                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
// eight accumulators d[o] .. d[o + 7], and their operand numbers
#define ACC8(o)                                                             \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),              \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define REGS_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define REGS_8 "%8, %9, %10, %11, %12, %13, %14, %15"
#define REGS_16 "%16, %17, %18, %19, %20, %21, %22, %23"
#define REGS_24 "%24, %25, %26, %27, %28, %29, %30, %31"
#define REGS_32 "%32, %33, %34, %35, %36, %37, %38, %39"
#define REGS_40 "%40, %41, %42, %43, %44, %45, %46, %47"

// D (64 x N) += A (64 x 8, registers) * B (8 x N, shared memory), for the
// tile widths N of the TF32 route.
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  WGMMA_TF32(64, REGS_0 ", " REGS_8 ", " REGS_16 ", " REGS_24,
             32, 33, 34, 35, 36, 37, ACC8(0), ACC8(8), ACC8(16), ACC8(24));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  WGMMA_TF32(96, REGS_0 ", " REGS_8 ", " REGS_16 ", " REGS_24 ", " REGS_32
                     ", " REGS_40,
             48, 49, 50, 51, 52, 53, ACC8(0), ACC8(8), ACC8(16), ACC8(24),
             ACC8(32), ACC8(40));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of r across a wgmma boundary.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Matrix descriptor of a K-major wgmma operand in shared memory with no
// swizzle: core matrices of 8 rows x 16 bytes (128 contiguous bytes), the
// next along K `lbo` bytes on, the next along N `sbo` bytes on.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Reps i .. i + cnt - 1 (cnt <= REP_GROUP): their A fragments of x +
// i*eps in TF32, then a wgmma each into acc, committed as one group.
// Waiting for all but A_SETS - 1 groups leaves the fragments that the next
// group overwrites free.
template <int NT>
__device__ __forceinline__ void tf32_group(float (&acc)[NT / 2],
                                           uint32_t (&a)[REP_GROUP][4],
                                           const float (&xa)[4], int i,
                                           int cnt, float eps,
                                           uint64_t desc) {
#pragma unroll
  for (int g = 0; g < REP_GROUP; ++g) {
    if (g < cnt) {
      const float step = __fmul_rn((float)(i + g), eps);
#pragma unroll
      for (int q = 0; q < 4; ++q) a[g][q] = to_tf32(__fadd_rn(xa[q], step));
    }
  }
  wgmma_fence();
#pragma unroll
  for (int g = 0; g < REP_GROUP; ++g)
    if (g < cnt) wgmma_tf32<NT>(acc, a[g], desc);
  wgmma_commit();
  wgmma_wait<A_SETS - 1>();
}

// Block (column tile, row tile): rows row0 .. row0 + 63 (rows >= m read
// zeros and are not written) x columns col0 .. col0 + NT - 1.  Warp w of
// the warpgroup owns rows 16 w .. 16 w + 15 of the tile.  Fragments of
// wgmma .m64nNk8 .tf32 (PTX ISA), lane = 4 * grp + tig:
//   A: a0 (grp, tig), a1 (grp + 8, tig), a2 (grp, tig + 4),
//      a3 (grp + 8, tig + 4);
//   D: d[4 j + 2 h + c] at (grp + 8 h, 8 j + 2 tig + c).
// B (8 x NT) in shared memory, K-major: core matrix (g, h) holds columns
// 8 g .. 8 g + 7 x k = 4 h .. 4 h + 3, column 8 g + r at byte 16 r, and
// lies at byte 256 g + 128 h (lbo 128, sbo 256).
template <int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
dot_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                int m, int n, int reps, float eps, int out_cols,
                float* __restrict__ out, float* __restrict__ pairs) {
  __shared__ __align__(256) uint32_t bs[NT * K];
  __shared__ __align__(16) float stage[WG_THREADS / 32][16][STAGE_ROW];
  const int col0 = blockIdx.x * NT, row0 = blockIdx.y * WG_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int r0 = row0 + 16 * warp + grp, r1 = r0 + 8;
  const float xa[4] = {r0 < m ? x[r0 * K + tig] : 0.f,
                       r1 < m ? x[r1 * K + tig] : 0.f,
                       r0 < m ? x[r0 * K + tig + 4] : 0.f,
                       r1 < m ? x[r1 * K + tig + 4] : 0.f};
  for (int e = threadIdx.x; e < NT * K; e += WG_THREADS) {
    const int k = e / NT, c = e - k * NT;
    bs[(c >> 3) * 64 + (k >> 2) * 32 + (c & 7) * 4 + (k & 3)] =
        to_tf32(w[k * n + col0 + c]);
  }
  // generic-proxy writes, read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t desc = smem_desc(bs, 128, 256);
  float acc[NT / 2];
#pragma unroll
  for (int q = 0; q < NT / 2; ++q) {
    acc[q] = 0.f;
    fence_operand(acc[q]);
  }
  uint32_t a[A_SETS][REP_GROUP][4];
  constexpr int ROUND = REP_GROUP * A_SETS;
  int i = 0;
  for (; i + ROUND <= reps; i += ROUND) {
#pragma unroll
    for (int s = 0; s < A_SETS; ++s)
      tf32_group<NT>(acc, a[s], xa, i + REP_GROUP * s, REP_GROUP, eps, desc);
  }
#pragma unroll
  for (int s = 0; s < A_SETS; ++s) {
    const int cnt = min(REP_GROUP, reps - i - REP_GROUP * s);
    if (cnt > 0) tf32_group<NT>(acc, a[s], xa, i + REP_GROUP * s, cnt, eps,
                                desc);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < NT / 2; ++q) fence_operand(acc[q]);
  // Each warp stages its 16 rows x STAGE_COLS columns at a time in shared
  // memory and stores them back 16 bytes a lane, 8 lanes a row segment.
  float* st = &stage[warp][0][0];
#pragma unroll
  for (int c = 0; c < NT / STAGE_COLS; ++c) {
#pragma unroll
    for (int jj = 0; jj < STAGE_COLS / 8; ++jj) {
      const int j = STAGE_COLS / 8 * c + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(st + (grp + 8 * h) * STAGE_ROW + 8 * jj +
                                   2 * tig) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (lane >> 3) + 4 * k, q = lane & 7;
      const int row = row0 + 16 * warp + r;
      const int col = col0 + STAGE_COLS * c + 4 * q;
      if (row < m) {
        const float4 v =
            *reinterpret_cast<const float4*>(st + r * STAGE_ROW + 4 * q);
        float* o = out + (size_t)row * out_cols + col;
        if (out_cols % 4 == 0 && col + 3 < out_cols) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < out_cols) o[u] = e[u];
        }
        *reinterpret_cast<float2*>(pairs + (size_t)row * (n / 2) + col / 2) =
            make_float2(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
      }
    }
    __syncwarp();
  }
}

// ---- epilogue ----
constexpr int EPI_THREADS = SUBT;        // one thread per triangle
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int EPI_CHUNK = EPI_THREADS;   // reps whose shifts a block stages

// Block `ray`: thread j owns triangle j's six values.  The shifts i*eps of
// EPI_CHUNK reps at a time are computed once, one per thread, into shared
// memory and read four at a time.  A thread meets its pairs in rep order
// and keeps the first least accepted t; a warp shuffle and a pass over the
// block's warps take the least pair_key.
__global__ void __launch_bounds__(EPI_THREADS, 8)
epilogue_kernel(const float* __restrict__ p, const float* __restrict__ tn,
                int m, int reps, float eps, float* __restrict__ out) {
  __shared__ float4 steps[EPI_CHUNK / 4];
  __shared__ unsigned long long red[EPI_WARPS];
  const int j = threadIdx.x, ray = blockIdx.x;
  const float* row = p + (size_t)ray * 6 * SUBT + j;
  const float pn = row[0], pu = row[SUBT], pv = row[2 * SUBT];
  const float qn = row[3 * SUBT], qu = row[4 * SUBT], qv = row[5 * SUBT];
  const float tnr = tn[ray];
  float bt = BIG_T;
  int bi = 0;
  const auto test_pair = [&](float step, int i) {
    const float on = __fadd_rn(pn, step), ou = __fadd_rn(pu, step);
    const float ov = __fadd_rn(pv, step), dn = __fadd_rn(qn, step);
    const float du = __fadd_rn(qu, step), dv = __fadd_rn(qv, step);
    const float t = -__fdiv_rn(on, dn);
    const float beta = __fadd_rn(ou, __fmul_rn(t, du));
    const float gamma = __fadd_rn(ov, __fmul_rn(t, dv));
    const bool ok = (t >= 0.f) && (t > tnr) && (beta >= 0.f) &&
                    (gamma >= 0.f) && (__fadd_rn(beta, gamma) <= 1.f);
    if (ok && t < bt) {
      bt = t;
      bi = i;
    }
  };
  const float* st = reinterpret_cast<const float*>(steps);
  for (int c0 = 0; c0 < reps; c0 += EPI_CHUNK) {
    const int nc = min(EPI_CHUNK, reps - c0);
    __syncthreads();   // every thread is done with the last chunk's shifts
    reinterpret_cast<float*>(steps)[j] = __fmul_rn((float)(c0 + j), eps);
    __syncthreads();
    int i = 0;
    for (; i + 4 <= nc; i += 4) {
      const float4 s = steps[i >> 2];
      test_pair(s.x, c0 + i);
      test_pair(s.y, c0 + i + 1);
      test_pair(s.z, c0 + i + 2);
      test_pair(s.w, c0 + i + 3);
    }
    for (; i < nc; ++i) test_pair(st[i], c0 + i);
  }
  unsigned long long v = pair_key(bt, bi, j);
  for (int k = 16; k > 0; k >>= 1)
    v = umin64(v, __shfl_xor_sync(0xffffffffu, v, k));
  if ((j & 31) == 0) red[j >> 5] = v;
  __syncthreads();
  if (j == 0) {
#pragma unroll
    for (int w = 1; w < EPI_WARPS; ++w) v = umin64(v, red[w]);
    out[ray] = key_to_t(v);
    out[m + ray] = v == NONE ? 0.f : (float)((v >> 1) & (SUBT - 1));
  }
}

// ---- edge-matrix test ----
constexpr int EDGE_THREADS = SUBT;   // one thread per triangle
constexpr int EDGE_WARPS = EDGE_THREADS / 32;
constexpr int EDGE_RAYS = 8;         // rays per block (ops/sweep_micro.py)

// Block (tile, split): EDGE_RAYS rays x all SUBT triangles x the reps of
// range `split` (split * reps / splits up to the next).  Thread j owns
// triangle j: tr + i*eps in registers, from a copy of tr loaded once, each
// rep's shift amortized over the tile's rays, which every thread reads
// from shared memory (one barrier in all).  Per ray, each thread keeps the
// first least accepted t in its (rep) order; a warp shuffle and a pass
// over the block's warps combine the keys; partial[split][ray] is the
// block's key.
__global__ void __launch_bounds__(EDGE_THREADS, 4)
edgemat_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tr, int m, int reps, int splits,
               float eps, unsigned long long* __restrict__ partial) {
  __shared__ float4 ray_a[EDGE_RAYS];   // ox, oy, oz, dx
  __shared__ float2 ray_b[EDGE_RAYS];   // dy, dz
  __shared__ unsigned long long red[EDGE_WARPS][EDGE_RAYS];
  const int j = threadIdx.x;
  const int ray0 = blockIdx.x * EDGE_RAYS;
  const int split = blockIdx.y;
  const int r0 = (int)((long long)split * reps / splits);
  const int r1 = (int)((long long)(split + 1) * reps / splits);
  if (j < EDGE_RAYS) {
    const int ray = min(ray0 + j, m - 1);
    ray_a[j] = make_float4(o[ray], o[m + ray], o[2 * m + ray], d[ray]);
    ray_b[j] = make_float2(d[m + ray], d[2 * m + ray]);
  }
  float base[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) base[k] = tr[k * SUBT + j];
  __syncthreads();
  float best[EDGE_RAYS];
  int brep[EDGE_RAYS];
#pragma unroll
  for (int r = 0; r < EDGE_RAYS; ++r) {
    best[r] = BIG_T;
    brep[r] = 0;
  }
  for (int i = r0; i < r1; ++i) {
    const float step = __fmul_rn((float)i, eps);
    float s[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) s[k] = __fadd_rn(base[k], step);
    const float ax = s[0], ay = s[1], az = s[2], nx = s[3], ny = s[4],
                nz = s[5], ux = s[6], uy = s[7], uz = s[8], vx = s[9],
                vy = s[10], vz = s[11];
#pragma unroll
    for (int r = 0; r < EDGE_RAYS; ++r) {
      const float4 ra = ray_a[r];
      const float2 rb = ray_b[r];
      const float ox = ra.x, oy = ra.y, oz = ra.z;
      const float dx = ra.w, dy = rb.x, dz = rb.y;
      const float dn = __fadd_rn(__fadd_rn(__fmul_rn(dx, nx), __fmul_rn(dy, ny)),
                                 __fmul_rn(dz, nz));
      const float on = __fadd_rn(
          __fadd_rn(__fmul_rn(__fsub_rn(ox, ax), nx),
                    __fmul_rn(__fsub_rn(oy, ay), ny)),
          __fmul_rn(__fsub_rn(oz, az), nz));
      const float t = -__fdiv_rn(on, dn);
      const float px = __fsub_rn(__fadd_rn(ox, __fmul_rn(t, dx)), ax);
      const float py = __fsub_rn(__fadd_rn(oy, __fmul_rn(t, dy)), ay);
      const float pz = __fsub_rn(__fadd_rn(oz, __fmul_rn(t, dz)), az);
      const float beta = __fadd_rn(__fadd_rn(__fmul_rn(px, ux), __fmul_rn(py, uy)),
                                   __fmul_rn(pz, uz));
      const float gamma = __fadd_rn(__fadd_rn(__fmul_rn(px, vx), __fmul_rn(py, vy)),
                                    __fmul_rn(pz, vz));
      const bool ok = (t >= 0.f) && (beta >= 0.f) && (gamma >= 0.f) &&
                      (__fadd_rn(beta, gamma) <= 1.f);
      // this thread meets its pairs in rep order: the first least t stays
      if (ok && t < best[r]) {
        best[r] = t;
        brep[r] = i;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < EDGE_RAYS; ++r) {
    unsigned long long v = pair_key(best[r], brep[r], j);
    for (int k = 16; k > 0; k >>= 1)
      v = umin64(v, __shfl_xor_sync(0xffffffffu, v, k));
    if ((j & 31) == 0) red[j >> 5][r] = v;
  }
  __syncthreads();
  if (j < EDGE_RAYS && ray0 + j < m) {
    unsigned long long v = red[0][j];
#pragma unroll
    for (int w = 1; w < EDGE_WARPS; ++w) v = umin64(v, red[w][j]);
    partial[(size_t)split * m + ray0 + j] = v;
  }
}

// out[ray] = the t of the least key over the splits' partial keys (BIG_T
// when none), its sign restored.
__global__ void edgemat_finish(const unsigned long long* __restrict__ partial,
                               int m, int splits, float* __restrict__ out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= m) return;
  unsigned long long v = NONE;
  for (int s = 0; s < splits; ++s) v = umin64(v, partial[(size_t)s * m + ray]);
  out[ray] = key_to_t(v);
}

}  // namespace

// x (m, 8), w (8, n) f32; out (m, out_cols), pairs (m, n / 2).  tile 0
// takes the FP32 route (m % 16 == 0, n % 64 == 0: whole blocks of 64
// threads), tile 64 or 96 the TF32 route with tiles of 64 rows x `tile`
// columns (n % tile == 0).
// Returns cudaGetLastError() after the launch.
extern "C" int sweep_dot(const float* x, const float* w, int m, int n,
                         int reps, float eps, int out_cols, int tile,
                         float* out, float* pairs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(tile ? n / tile : 0, (m + WG_ROWS - 1) / WG_ROWS);
  switch (tile) {
    case 0:
      dot_fp32_kernel<<<(m / TR) * (n / TC) / DOT_THREADS, DOT_THREADS, 0,
                        s>>>(x, w, m, n, reps, eps, out_cols, out, pairs);
      break;
    case 64:
      dot_tf32_kernel<64><<<grid, WG_THREADS, 0, s>>>(x, w, m, n, reps, eps,
                                                      out_cols, out, pairs);
      break;
    case 96:
      dot_tf32_kernel<96><<<grid, WG_THREADS, 0, s>>>(x, w, m, n, reps, eps,
                                                      out_cols, out, pairs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// p (m, 6 * 256), tn (m,) f32; out (2, m) f32 = [tbest, tri].
extern "C" int sweep_epilogue(const float* p, const float* tn, int m,
                              int reps, float eps, float* out, void* stream) {
  epilogue_kernel<<<m, EPI_THREADS, 0, (cudaStream_t)stream>>>(p, tn, m, reps,
                                                               eps, out);
  return (int)cudaGetLastError();
}

// o, d (3, m), tr (12, 256) f32; out (m,) f32 = min accepted t (or 1e30).
// The reps are cut into `splits` ranges (ops/sweep_micro.edgemat_ranges);
// partial (splits, m) uint64 is scratch.  Returns cudaGetLastError().
extern "C" int sweep_edgemat(const float* o, const float* d, const float* tr,
                             int m, int reps, int splits, float eps,
                             unsigned long long* partial, float* out,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  edgemat_kernel<<<dim3((m + EDGE_RAYS - 1) / EDGE_RAYS, splits),
                   EDGE_THREADS, 0, s>>>(o, d, tr, m, reps, splits, eps,
                                         partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  edgemat_finish<<<(m + 255) / 256, 256, 0, s>>>(partial, m, splits, out);
  return (int)cudaGetLastError();
}

// Registers per thread, resident blocks per SM and threads per block of
// one probe kernel (0 dot_fp32, 1-2 dot_tf32 at tiles of 64 and 96
// columns, 3 epilogue, 4 edgemat), into out[0..2].  Returns a CUDA error
// code.
extern "C" int sweep_micro_info(int kernel, int* out) {
  const void* fns[] = {(const void*)dot_fp32_kernel,
                       (const void*)dot_tf32_kernel<64>,
                       (const void*)dot_tf32_kernel<96>,
                       (const void*)epilogue_kernel,
                       (const void*)edgemat_kernel};
  const int threads[] = {DOT_THREADS, WG_THREADS, WG_THREADS, EPI_THREADS,
                         EDGE_THREADS};
  if (kernel < 0 || kernel > 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fns[kernel]);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel],
                                                    threads[kernel], 0);
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = threads[kernel];
  return (int)e;
}
