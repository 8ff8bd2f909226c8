// Hand-written Hopper (sm_90a) kernel for the per-path PCG32 streams,
// bound through a plain C interface (ctypes, ops/pcg_draw.py).
//
// It replaces no pl.pallas_call: the JAX package draws with jnp integer
// ops that XLA fuses (pathtracer_tpu/core/rng.py), and the port drew with
// about 75 int64 torch kernels a draw over every lane (the 64-bit LCG
// step from 16-bit limbs, the XSH-RR output, the gate's wheres, the float
// conversion; core/rng.py's *_plain functions, which stay as the plain
// version for CPU tensors).  It computes what they compute, one launch a
// call:
//   seed (make_stream): inc = (key << 1) | 1, state = (key + inc) * MULT
//     + inc, all mod 2^64;
//   draw (next_uniform, K = 1; next_uniform2, K = 2): out = XSH-RR of the
//     state, rotr32(((s ^ (s >> 18)) >> 27) mod 2^32, s >> 59); the
//     uniform float32(out) * INV_UINT32_MAX; the state steps to s * MULT
//     + inc.  A lane whose gate is False keeps its state, so its second
//     draw repeats the first (u2 == u1), as in the plain version.
// The 64-bit state and increment arrive as (hi, lo) halves, each a uint32
// value in an int64 tensor; the kernel rebuilds the 64-bit words and
// steps them in native 64-bit integer arithmetic, which is the limb
// code's value mod 2^64.  The float conversion is torch's int64 -> float32
// (__ll2float_rn) and the product one rounded float multiply (__fmul_rn;
// INV_UINT32_MAX is 2^-32 in float32, so the product is exact), built
// with -fmad=false like every kernel of the port.  So the halves and the
// uniforms equal the plain version's bit for bit.
//
// What bounds it on an H100: bytes.  A draw reads four int64 halves and
// the gate byte and writes two halves and a float32: 53 B a lane (57 B
// for a pair, 48 B for the seed), 2,073,600 lanes of a 1080p sample pass
// in 33 us at 3.35 TB/s; the arithmetic is a few dozen integer
// instructions a lane.  The increment halves are not written: the new
// state tuple shares the caller's tensors.  The design: a grid-stride
// loop, one lane a thread at a time; a warp's 8-byte loads of the int64
// halves are already whole 256-byte segments.  (Two lanes a thread with
// 16-byte loads measured 40.05 us a draw against this loop's 40.60 on an
// H100 at 2,073,600 lanes, and took a second path for unaligned views.)

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long MULT = 6364136223846793005ULL;
constexpr float INV_UINT32_MAX = 0x1p-32f;  // float32(1 / (2^32 - 1))
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ unsigned long long join(long long hi,
                                                   long long lo) {
  return ((unsigned long long)(unsigned)hi << 32) | (unsigned)lo;
}

__device__ __forceinline__ unsigned xsh_rr(unsigned long long s) {
  const unsigned xs = (unsigned)(((s >> 18) ^ s) >> 27);
  const unsigned rot = (unsigned)(s >> 59);
  return (xs >> rot) | (xs << ((32u - rot) & 31u));
}

__device__ __forceinline__ float uniform(unsigned out) {
  return __fmul_rn(__ll2float_rn((long long)out), INV_UINT32_MAX);
}

// one lane's K draws; s and the outputs in place
template <int K, bool GATED>
__device__ __forceinline__ void draw_lane(unsigned long long& s,
                                          unsigned long long inc, bool g,
                                          float& u1, float& u2) {
  u1 = uniform(xsh_rr(s));
  if (!GATED || g) s = s * MULT + inc;
  if (K == 2) {
    u2 = uniform(xsh_rr(s));
    if (!GATED || g) s = s * MULT + inc;
  }
}

template <int K, bool GATED>
__global__ void __launch_bounds__(THREADS)
draw_kernel(const long long* __restrict__ s_hi,
            const long long* __restrict__ s_lo,
            const long long* __restrict__ inc_hi,
            const long long* __restrict__ inc_lo,
            const unsigned char* __restrict__ gate,
            long long* __restrict__ o_hi, long long* __restrict__ o_lo,
            float* __restrict__ u1, float* __restrict__ u2, long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    unsigned long long s = join(s_hi[i], s_lo[i]);
    float a, b;
    draw_lane<K, GATED>(s, join(inc_hi[i], inc_lo[i]),
                        GATED ? gate[i] != 0 : true, a, b);
    o_hi[i] = (long long)(s >> 32);
    o_lo[i] = (long long)(s & 0xFFFFFFFFULL);
    u1[i] = a;
    if (K == 2) u2[i] = b;
  }
}

__global__ void __launch_bounds__(THREADS)
seed_kernel(const long long* __restrict__ key_hi,
            const long long* __restrict__ key_lo,
            long long* __restrict__ s_hi, long long* __restrict__ s_lo,
            long long* __restrict__ inc_hi, long long* __restrict__ inc_lo,
            long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long key = join(key_hi[i], key_lo[i]);
    const unsigned long long inc = (key << 1) | 1ULL;
    const unsigned long long s = (key + inc) * MULT + inc;
    s_hi[i] = (long long)(s >> 32);
    s_lo[i] = (long long)(s & 0xFFFFFFFFULL);
    inc_hi[i] = (long long)(inc >> 32);
    inc_lo[i] = (long long)(inc & 0xFFFFFFFFULL);
  }
}

int blocks_for(long long work) {
  const long long b = (work + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

template <int K, bool GATED>
cudaError_t launch_draw(const long long* s_hi, const long long* s_lo,
                        const long long* inc_hi, const long long* inc_lo,
                        const unsigned char* gate, long long* o_hi,
                        long long* o_lo, float* u1, float* u2, long long n,
                        cudaStream_t st) {
  draw_kernel<K, GATED><<<blocks_for(n), THREADS, 0, st>>>(
      s_hi, s_lo, inc_hi, inc_lo, gate, o_hi, o_lo, u1, u2, n);
  return cudaGetLastError();
}

}  // namespace

// key_hi, key_lo: n int64 holding uint32 values; writes the stream's
// state and increment halves (n int64 each), as core/rng.make_stream
// returns them.  Returns the launch's CUDA error, else 0.
extern "C" int pcg_seed(const long long* key_hi, const long long* key_lo,
                        long long* s_hi, long long* s_lo, long long* inc_hi,
                        long long* inc_lo, long long n, void* stream) {
  if (n <= 0) return 0;
  seed_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      key_hi, key_lo, s_hi, s_lo, inc_hi, inc_lo, n);
  return (int)cudaGetLastError();
}

// s_hi, s_lo, inc_hi, inc_lo: n int64 holding uint32 values; gate: n
// bytes (0 = the lane keeps its state) or null (every lane draws).
// Writes the new state halves o_hi, o_lo (n int64) and the uniforms u1
// and, when u2 is not null, a second draw u2 (n float32 each), as
// core/rng.next_uniform (u2 null) and next_uniform2 return them.
// Returns the launch's CUDA error, else 0.
extern "C" int pcg_draw(const long long* s_hi, const long long* s_lo,
                        const long long* inc_hi, const long long* inc_lo,
                        const unsigned char* gate, long long* o_hi,
                        long long* o_lo, float* u1, float* u2, long long n,
                        void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (u2 && gate)
    e = launch_draw<2, true>(s_hi, s_lo, inc_hi, inc_lo, gate, o_hi, o_lo,
                             u1, u2, n, st);
  else if (u2)
    e = launch_draw<2, false>(s_hi, s_lo, inc_hi, inc_lo, gate, o_hi, o_lo,
                              u1, u2, n, st);
  else if (gate)
    e = launch_draw<1, true>(s_hi, s_lo, inc_hi, inc_lo, gate, o_hi, o_lo,
                             u1, u2, n, st);
  else
    e = launch_draw<1, false>(s_hi, s_lo, inc_hi, inc_lo, gate, o_hi, o_lo,
                              u1, u2, n, st);
  return (int)e;
}
