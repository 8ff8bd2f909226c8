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
//     kernel): one thread per 4 x 4 output tile, x rows and w columns in
//     registers, the eight products summed in k order with every product
//     and sum rounded on its own (_rn intrinsics, -fmad=false), as the
//     sweep rounds.  Bound: fp32 instruction throughput; 16 instructions
//     per output per rep (no FMA), so at least 2 * M * N * 8 / 67e12 s per
//     rep, doubled.
//   * TF32 route (the counterpart of Precision.DEFAULT and of the MXU
//     kernel): one warp per 16 x 64 output tile, eight
//     mma.sync.m16n8k8 TF32 products per rep with the fp32 accumulator
//     kept in the tensor core's C operand; operands rounded by
//     cvt.rna.tf32.f32.  Bound: TF32 tensor-core rate.
//   The TPU kernel of tpu_prof_sweep keeps only out[:, :128]; a compiler
//   would drop the other columns, so every thread also writes the sums of
//   adjacent column pairs of its accumulators (`pairs`, (M, N/2)), which
//   keeps the whole product live every rep.
//
// epilogue: p (M, 6*256), tn (M,) f32; per rep the six-way split, t, beta,
//   gamma, acceptance, first-index argmin and best-t update of the sweep's
//   epilogue.  One warp per ray, each lane holding eight triangles' six
//   values in registers (p is read once); a lane keeps its best (t, rep,
//   tri) in (rep, tri) order, and one lexicographic warp reduction at the
//   end gives exactly the per-rep update's result.  Bound: fp32
//   instructions.
//
// edgemat: o, d (3, M), tr (12, 256) f32; per rep the edge-matrix ray x
//   triangle test and a min of t.  The result, the least accepted t over
//   all (rep, triangle) pairs of a ray, does not depend on the pairs'
//   order, so the reps are cut into ranges over blocks (enough blocks for
//   about four waves): one thread per triangle, eight rays per block read
//   from shared memory, tr + i*eps computed in registers once per rep for
//   the eight rays, no barrier per rep.  Partial minima are combined
//   exactly by a key of (|t|, rep, triangle, sign): -0.0 and +0.0 compare
//   equal and the first pair in (rep, triangle) order gives the sign, as
//   the plain version keeps the earlier rep on a tie (torch.minimum on
//   the CPU).  A second small kernel reduces the ranges' keys.  Bound:
//   fp32 instructions (41 counted operations a pair, the divide several
//   instructions).
//
//   This replaced one warp per ray, four rays per block, writing tr +
//   i*eps into shared memory every rep behind a block barrier: 1,024 rays
//   gave under eight warps per SM, too few to hide the divide's and the
//   twelve shared loads' latency (PERF.md, section 6).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int K = 8;              // depth of the ray matrix (the scripts' AR)
constexpr float BIG_T = 1e30f;

constexpr int TR = 4, TC = 4;     // FP32 route: rows x columns per thread
constexpr int DOT_THREADS = 256;
constexpr int WARP_COLS = 64;     // TF32 route: columns per warp (8 mma)
constexpr int TF32_WARPS = 4;

__global__ void __launch_bounds__(DOT_THREADS)
dot_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                int m, int n, int reps, float eps, int out_cols,
                float* __restrict__ out, float* __restrict__ pairs) {
  const int ncg = n / TC;
  const int g = blockIdx.x * DOT_THREADS + threadIdx.x;
  if (g >= (m / TR) * ncg) return;
  const int row0 = (g / ncg) * TR, col0 = (g % ncg) * TC;
  float xr[TR][K], wr[K][TC], acc[TR][TC];
  for (int r = 0; r < TR; ++r)
    for (int k = 0; k < K; ++k) xr[r][k] = x[(row0 + r) * K + k];
  for (int k = 0; k < K; ++k)
    for (int c = 0; c < TC; ++c) wr[k][c] = w[k * n + col0 + c];
  for (int r = 0; r < TR; ++r)
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
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
        for (int k = 1; k < K; ++k) s = __fadd_rn(s, __fmul_rn(rr[k], wr[k][c]));
        acc[r][c] = __fadd_rn(acc[r][c], s);
      }
    }
  }
  for (int r = 0; r < TR; ++r) {
    const int row = row0 + r;
    for (int c = 0; c < TC; ++c)
      if (col0 + c < out_cols) out[row * out_cols + col0 + c] = acc[r][c];
    for (int c = 0; c < TC; c += 2)
      pairs[row * (n / 2) + (col0 + c) / 2] = __fadd_rn(acc[r][c],
                                                        acc[r][c + 1]);
  }
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// D = A (16x8, row) * B (8x8, col) + D, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k8 .tf32 (PTX ISA), lane = 4 * grp + tig:
//   A: a0 (grp, tig), a1 (grp + 8, tig), a2 (grp, tig + 4), a3 (grp + 8,
//      tig + 4);  B: b0 (k = tig, n = grp), b1 (k = tig + 4, n = grp);
//   C/D: c0 (grp, 2 tig), c1 (grp, 2 tig + 1), c2 (grp + 8, 2 tig),
//        c3 (grp + 8, 2 tig + 1).
__global__ void __launch_bounds__(32 * TF32_WARPS)
dot_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                int m, int n, int reps, float eps, int out_cols,
                float* __restrict__ out, float* __restrict__ pairs) {
  constexpr int NT = WARP_COLS / 8;
  const int nwc = n / WARP_COLS;
  const int wg = blockIdx.x * TF32_WARPS + (threadIdx.x >> 5);
  if (wg >= (m / 16) * nwc) return;
  const int row0 = (wg / nwc) * 16, col0 = (wg % nwc) * WARP_COLS;
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
  const float xa[4] = {x[(row0 + grp) * K + tig], x[(row0 + grp + 8) * K + tig],
                       x[(row0 + grp) * K + tig + 4],
                       x[(row0 + grp + 8) * K + tig + 4]};
  uint32_t b0[NT], b1[NT];
  float acc[NT][4];
  for (int t = 0; t < NT; ++t) {
    const int col = col0 + t * 8 + grp;
    b0[t] = to_tf32(w[tig * n + col]);
    b1[t] = to_tf32(w[(tig + 4) * n + col]);
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;
  }
  for (int i = 0; i < reps; ++i) {
    const float step = __fmul_rn((float)i, eps);
    uint32_t a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = to_tf32(__fadd_rn(xa[q], step));
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(acc[t], a, b0[t], b1[t]);
  }
  for (int t = 0; t < NT; ++t) {
    const int col = col0 + t * 8 + 2 * tig;
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + grp + 8 * h;
      const float c0 = acc[t][2 * h], c1 = acc[t][2 * h + 1];
      if (col < out_cols) out[row * out_cols + col] = c0;
      if (col + 1 < out_cols) out[row * out_cols + col + 1] = c1;
      pairs[row * (n / 2) + col / 2] = __fadd_rn(c0, c1);
    }
  }
}

// ---- epilogue ----
constexpr int SUBT = 256;
constexpr int PER_LANE = SUBT / 32;
constexpr int EPI_WARPS = 4;

// (t, rep, tri) lexicographic less-than.
__device__ __forceinline__ bool lex_less(float t, int i, int j, float bt,
                                         int bi, int bj) {
  return t < bt || (t == bt && (i < bi || (i == bi && j < bj)));
}

__global__ void __launch_bounds__(32 * EPI_WARPS)
epilogue_kernel(const float* __restrict__ p, const float* __restrict__ tn,
                int m, int reps, float eps, float* __restrict__ out) {
  const int ray = blockIdx.x * EPI_WARPS + (threadIdx.x >> 5);
  if (ray >= m) return;
  const int lane = threadIdx.x & 31;
  const float* row = p + (size_t)ray * 6 * SUBT;
  float pv[6][PER_LANE];
  for (int f = 0; f < 6; ++f)
    for (int q = 0; q < PER_LANE; ++q) pv[f][q] = row[f * SUBT + lane + 32 * q];
  const float tnr = tn[ray];
  float bt = BIG_T;
  int bi = INT_MAX, bj = INT_MAX;
  for (int i = 0; i < reps; ++i) {
    const float step = __fmul_rn((float)i, eps);
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const float on = __fadd_rn(pv[0][q], step), ou = __fadd_rn(pv[1][q], step);
      const float ov = __fadd_rn(pv[2][q], step), dn = __fadd_rn(pv[3][q], step);
      const float du = __fadd_rn(pv[4][q], step), dv = __fadd_rn(pv[5][q], step);
      const float t = -__fdiv_rn(on, dn);
      const float beta = __fadd_rn(ou, __fmul_rn(t, du));
      const float gamma = __fadd_rn(ov, __fmul_rn(t, dv));
      const bool ok = (t >= 0.f) && (t > tnr) && (beta >= 0.f) &&
                      (gamma >= 0.f) && (__fadd_rn(beta, gamma) <= 1.f);
      // a lane meets its (rep, tri) pairs in increasing order
      if (ok && t < bt) {
        bt = t;
        bi = i;
        bj = lane + 32 * q;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, bt, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
    const int j2 = __shfl_xor_sync(0xffffffffu, bj, o);
    if (lex_less(t2, i2, j2, bt, bi, bj)) {
      bt = t2;
      bi = i2;
      bj = j2;
    }
  }
  if (lane == 0) {
    const bool hit = bt < BIG_T;
    out[ray] = hit ? bt : BIG_T;
    out[m + ray] = hit ? (float)bj : 0.f;
  }
}

// ---- edge-matrix test ----
constexpr int EDGE_THREADS = SUBT;   // one thread per triangle
constexpr int EDGE_WARPS = EDGE_THREADS / 32;
constexpr int EDGE_RAYS = 8;         // rays per block (ops/sweep_micro.py)
constexpr unsigned long long NONE = ~0ull;

// The combine key of an accepted t (>= 0, so -0.0 or positive) at (rep,
// tri): |t|'s bits, then the pair's place in (rep, tri) order, then t's
// sign.  The least key is the least t, -0.0 and +0.0 equal as floats,
// and among equal t the first pair in (rep, tri) order, whose sign it
// keeps.  NONE when no pair was accepted.
__device__ __forceinline__ unsigned long long edge_key(float t, int rep,
                                                       int tri) {
  if (!(t < BIG_T)) return NONE;
  const unsigned b = __float_as_uint(t);
  return ((unsigned long long)(b & 0x7fffffffu) << 32) |
         ((unsigned long long)(rep * SUBT + tri) << 1) | (b >> 31);
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return b < a ? b : a;
}

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
    unsigned long long v = edge_key(best[r], brep[r], j);
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
  out[ray] = v == NONE ? BIG_T
                       : __uint_as_float((unsigned)(v >> 32) |
                                         ((unsigned)(v & 1) << 31));
}

}  // namespace

// x (m, 8), w (8, n) f32; m % 16 == 0, n % 64 == 0; out (m, out_cols),
// pairs (m, n / 2).  tf32 != 0 takes the tensor-core route.  Returns
// cudaGetLastError() after the launch.
extern "C" int sweep_dot(const float* x, const float* w, int m, int n,
                         int reps, float eps, int out_cols, int tf32,
                         float* out, float* pairs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tf32) {
    const int warps = (m / 16) * (n / WARP_COLS);
    dot_tf32_kernel<<<(warps + TF32_WARPS - 1) / TF32_WARPS, 32 * TF32_WARPS,
                      0, s>>>(x, w, m, n, reps, eps, out_cols, out, pairs);
  } else {
    const int threads = (m / TR) * (n / TC);
    dot_fp32_kernel<<<(threads + DOT_THREADS - 1) / DOT_THREADS, DOT_THREADS,
                      0, s>>>(x, w, m, n, reps, eps, out_cols, out, pairs);
  }
  return (int)cudaGetLastError();
}

// p (m, 6 * 256), tn (m,) f32; out (2, m) f32 = [tbest, tri].
extern "C" int sweep_epilogue(const float* p, const float* tn, int m,
                              int reps, float eps, float* out, void* stream) {
  epilogue_kernel<<<(m + EPI_WARPS - 1) / EPI_WARPS, 32 * EPI_WARPS, 0,
                    (cudaStream_t)stream>>>(p, tn, m, reps, eps, out);
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
// one probe kernel (0 dot_fp32, 1 dot_tf32, 2 epilogue, 3 edgemat), into
// out[0..2].  Returns a CUDA error code.
extern "C" int sweep_micro_info(int kernel, int* out) {
  const void* fns[] = {(const void*)dot_fp32_kernel,
                       (const void*)dot_tf32_kernel,
                       (const void*)epilogue_kernel,
                       (const void*)edgemat_kernel};
  const int threads[] = {DOT_THREADS, 32 * TF32_WARPS, 32 * EPI_WARPS,
                         EDGE_THREADS};
  if (kernel < 0 || kernel > 3) return (int)cudaErrorInvalidValue;
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
