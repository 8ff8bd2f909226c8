"""The cluster sweep's cost probes: a dense ray x plane product, the
sweep's epilogue and the old edge-matrix test, each repeated REPS times on
one subtile's worth of data.

Counterpart of the TPU probes scripts/tpu_prof_sweep.py (`matmul_kernel`,
`epilogue_kernel`, `edgemat_kernel`) and scripts/tpu_proto_mxu.py
(`mxu_kernel`, `vpu_kernel`); the entry points that time them are
pathtracer_tpu_torch/scripts/prof_sweep.py and proto_mxu.py.

Each function has a plain PyTorch version (`*_plain`), which serves CPU
tensors, and a wrapper that launches a hand-written CUDA kernel
(csrc/sweep_micro.cu) on CUDA tensors or raises:
  * `dot_fp32` / `dot_tf32`: out = sum_{i < reps} (x + i*eps) @ w with x
    (M, 8) and w (8, N).  `dot_plain` states the function: per rep r = x
    + i*eps, s = r[:, 0] * w[0], s = fma(r[:, k], w[k], s) for k = 1..7
    in order, each FMA rounded once (`fma_rn`), acc = acc + s, all fp32.
    `dot_fp32` computes it on the CUDA cores, bit-equal to `dot_plain`
    (the counterpart of Precision.HIGHEST and of the VPU kernel, whose
    contracts fix no rounding order); `dot_tf32` on the tensor cores in
    TF32 (Precision.DEFAULT and the MXU kernel, by wgmma in tiles of 64
    rows x `dot_tile` columns; `dot_plain(tf32=True)` takes the same
    chain over TF32-rounded operands, and the two agree within TF32_TOL
    of the absolute-value bound, not bit for bit: the tensor core adds in
    its own order).  Both return (out (M, out_cols), pairs (M, N / 2)):
    out is the TPU kernel's output, its first out_cols columns; pairs
    holds the sums of adjacent column pairs of the whole accumulator,
    which keeps every column of the product live in the kernel.
  * `epilogue`: per rep the sweep's six-way split, t, beta, gamma,
    acceptance, first-index argmin and best-t update; (2, M) f32
    [tbest, tri].  Bit-equal to `epilogue_plain`, signed zeros included
    (one thread per ray x triangle; the threads' bests are combined by
    the same exact key as the edge-matrix kernel's ranges).
  * `edgemat`: per rep the edge-matrix ray x triangle test and a min of
    t; (1, M) f32.  Bit-equal to `edgemat_plain`.  The kernel cuts the
    reps into ranges (`edgemat_ranges`) and combines the ranges' minima
    as `edgemat_combine` states it.

The products are never handed to cuBLAS or torch.matmul: the probes ask
what a hand-written product costs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import binding

BIG_T = float(np.float32(1e30))
AR = 8            # depth of the ray matrix
SUBT = 256        # triangles per subtile
TF32_TOL = 2.0 ** -14   # |dot_tf32 - dot_plain(tf32=True)| <= TF32_TOL * bound
EDGE_RAYS = 8     # rays per block of the edge-matrix kernel (sweep_micro.cu)
MAX_REPS = 1 << 22   # rep * SUBT + tri must fit the kernels' 31-bit key
DOT_TILES = (64, 96)   # the TF32 kernel's tile widths (sweep_micro.cu)
WG_ROWS = 64      # rows of a TF32 tile, one warpgroup's wgmma
FP32_TILE = (2, 8)   # rows x columns of a thread's fp32 tile (sweep_micro.cu)
KERNELS = ('dot_fp32', 'dot_tf32_64', 'dot_tf32_96', 'epilogue',
           'edgemat')   # sweep_micro_info's order


def rep_steps(reps: int, eps: float, dev) -> torch.Tensor:
    """f32(i) * f32(eps) for i < reps, rounded in fp32 as the TPU kernels'
    `i.astype(f32) * eps` and the CUDA kernels' __fmul_rn."""
    return (torch.arange(reps, dtype=torch.float32, device=dev)
            * torch.tensor(np.float32(eps), device=dev))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as `cvt.rna.tf32.f32`: add half of the dropped 13 bits to the
    magnitude bits, then clear them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors (broadcast), rounded once to float32
    to nearest even, as CUDA's __fmaf_rn: the same bits on any device,
    signed zeros, subnormal results and overflow to +-inf included.

    The product of two float32 values is exact in float64 and so is the
    error e of the float64 sum s = p + c (TwoSum).  Rounding s straight to
    float32 would round twice and miss the nearest float32 where the
    exact sum lies just off a float32 midpoint; rounded to odd instead (s
    moved one float64 step toward e where e != 0 and s's last bit is
    even), s has 53 >= 24 + 2 bits and its rounding to float32 is the
    correct one (Boldo and Melquiond, "Emulation of FMA and correctly
    rounded sums: proved algorithms using rounding to odd", IEEE Trans.
    Computers 57(4), 2008)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, torch.inf), e)
    s = torch.where((e != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, toward), s)
    return s.float()


def dot_plain(x, w, reps: int, eps: float, out_cols: int, tf32=False):
    """sum_{i < reps} (x + i*eps) @ w as the kernels state it: per rep, r =
    x + i*eps in fp32, s = r[:, 0] * w[0] rounded, then s = fma(r[:, k],
    w[k], s) for k = 1..7 in order, each rounded once (fma_rn), and acc =
    acc + s in fp32 in rep order.  With tf32, r and w are rounded to TF32
    first (their products are then exact in fp32 above the subnormal
    range, so there the chain rounds as the unfused one would).  Returns
    (out (M, out_cols), pairs (M, N / 2))."""
    steps = rep_steps(reps, eps, x.device)
    if tf32:
        w = round_tf32(w)
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for i in range(reps):
        r = x + steps[i]
        if tf32:
            r = round_tf32(r)
        s = r[:, 0:1] * w[0]
        for k in range(1, AR):
            s = fma_rn(r[:, k:k + 1], w[k], s)
        acc = acc + s
    return acc[:, :out_cols].contiguous(), acc[:, 0::2] + acc[:, 1::2]


def epilogue_plain(p, tn, reps: int, eps: float):
    """The sweep epilogue of tpu_prof_sweep.epilogue_kernel: p (M, 6*SUBT),
    tn (1, M); per rep prod = p + i*eps split into on, oU, oV, dn, dU, dV,
    t = -(on / dn), acceptance, the lowest index j with t <= min t, and
    (tbest, tri) updated where t[j] beats tbest.  (2, M) f32.

    -0.0 and +0.0 compare equal, and the result keeps the first such pair
    in (rep, tri) order with its own sign: a rep's t is that of its pair
    j, not `amin`'s, whose choice between -0.0 and +0.0 differs between
    the CPU and a card, and a later rep wins only with a smaller t."""
    m = p.shape[0]
    steps = rep_steps(reps, eps, p.device)
    tnr = tn[0][:, None]
    lane = torch.arange(SUBT, dtype=torch.int32, device=p.device)
    tbest = torch.full((m,), BIG_T, device=p.device)
    tri = torch.zeros((m,), dtype=torch.int32, device=p.device)
    for i in range(reps):
        on, ou, ov, dn, du, dv = (p + steps[i]).split(SUBT, dim=1)
        t = -(on / dn)
        beta = ou + t * du
        gamma = ov + t * dv
        ok = ((t >= 0.0) & (t > tnr) & (beta >= 0.0) & (gamma >= 0.0)
              & (beta + gamma <= 1.0))
        t = torch.where(ok, t, torch.full_like(t, BIG_T))
        j = torch.where(t <= t.amin(dim=-1, keepdim=True), lane,
                        SUBT).amin(dim=-1)
        tj = t.gather(-1, j[:, None].long())[:, 0]
        win = tj < tbest
        tbest = torch.where(win, tj, tbest)
        tri = torch.where(win, j, tri)
    return torch.stack([tbest, tri.to(torch.float32)])


def edgemat_plain(o, d, tr, reps: int, eps: float, rep0: int = 0):
    """The edge-matrix test of tpu_prof_sweep.edgemat_kernel: o, d (3, M),
    tr (12, SUBT) = [a | n | u | v] x xyz rows; per rep tr + i*eps, t, the
    barycentric acceptance, and the min accepted t, over the reps rep0 <=
    i < reps.  (1, M) f32."""
    steps = rep_steps(reps, eps, o.device)
    ox, oy, oz = (o[k][:, None] for k in range(3))
    dx, dy, dz = (d[k][:, None] for k in range(3))
    tbest = torch.full((o.shape[1],), BIG_T, device=o.device)
    for i in range(rep0, reps):
        ax, ay, az, nx, ny, nz, ux, uy, uz, vx, vy, vz = tr + steps[i]
        dn = dx * nx + dy * ny + dz * nz
        on = (ox - ax) * nx + (oy - ay) * ny + (oz - az) * nz
        t = -(on / dn)
        px = ox + t * dx - ax
        py = oy + t * dy - ay
        pz = oz + t * dz - az
        beta = px * ux + py * uy + pz * uz
        gamma = px * vx + py * vy + pz * vz
        ok = ((t >= 0.0) & (beta >= 0.0) & (gamma >= 0.0)
              & (beta + gamma <= 1.0))
        t = torch.where(ok, t, torch.full_like(t, BIG_T))
        tbest = torch.minimum(tbest, t.amin(dim=-1))
    return tbest[None, :]


# ---------------------------------------------------------------------------
# Hand-written CUDA kernels (csrc/sweep_micro.cu)
# ---------------------------------------------------------------------------

def kernel_info() -> dict:
    """{kernel: (registers per thread, resident blocks per SM, threads per
    block)} of the probe kernels, from the CUDA runtime."""
    return {name: binding.info('sweep_micro_info', i)
            for i, name in enumerate(KERNELS)}


def _takes_plain(name, tensors, shapes):
    """True for CPU tensors (they take the plain version); for CUDA
    tensors check device, type, shape and layout and return False; raise
    on any other device or on a mix of devices."""
    dev = tensors[0].device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} takes CUDA or CPU tensors, got {dev}')
    for x, shape in zip(tensors, shapes):
        if x.device != dev:
            raise ValueError(f'{name} inputs must lie on one device')
        if dev.type == 'cuda' and (x.dtype != torch.float32
                                   or not x.is_contiguous()
                                   or tuple(x.shape) != shape):
            raise ValueError(f'{name} takes contiguous float32 tensors of '
                             f'shapes {shapes}')
    return dev.type == 'cpu'


def dot_tile(n: int) -> int:
    """The TF32 kernel's tile width for an (m, 8) x (8, n) product: 96
    where it divides n, else 64 (the wrapper takes N % 64 == 0).  At both
    probe scripts' shapes 96 is faster than 64, and at 1536 columns no
    slower than the 192 it replaced (PERF.md, section 6)."""
    fits = [t for t in DOT_TILES if n % t == 0]
    if not fits:
        raise ValueError(f'dot_tf32 needs N divisible by one of {DOT_TILES}')
    return max(fits)


def _dot(x, w, reps, eps, out_cols, tf32, tile=None):
    name = 'dot_tf32' if tf32 else 'dot_fp32'
    m, n = x.shape[0], w.shape[1]
    if _takes_plain(name, (x, w), ((m, AR), (AR, n))):
        return dot_plain(x, w, reps, eps, out_cols, tf32)
    if m % 16 or n % 64 or not 0 < out_cols <= n:
        raise ValueError(f'{name} needs M % 16 == 0, N % 64 == 0 and '
                         f'0 < out_cols <= N')
    if not tf32:
        tile = 0
    elif tile is None:
        tile = dot_tile(n)
    elif tile not in DOT_TILES or n % tile:
        raise ValueError(f'{name} takes a tile width of {DOT_TILES} that '
                         f'divides N')
    out = torch.empty((m, out_cols), device=x.device)
    pairs = torch.empty((m, n // 2), device=x.device)
    getattr(torch.ops.pathtracer_tpu_torch, f'{name}_launch')(
        x, w, m, n, reps, eps, out_cols, tile, out, pairs)
    return out, pairs


def dot_fp32(x, w, reps: int, eps: float, out_cols: int):
    """sum_{i < reps} (x + i*eps) @ w in fp32, as dot_plain states it (an
    FMA chain in k order per rep).  CPU tensors take dot_plain; CUDA
    tensors launch the hand-written kernel (replaces the TPU kernels
    tpu_prof_sweep.matmul_kernel(HIGHEST) and tpu_proto_mxu.vpu_kernel) or
    raise."""
    return _dot(x, w, reps, eps, out_cols, False)


def dot_tf32(x, w, reps: int, eps: float, out_cols: int,
             tile: int | None = None):
    """sum_{i < reps} (x + i*eps) @ w in TF32 on the tensor cores (wgmma
    m64nNk8, N = `tile`, by default dot_tile(N)).  CPU tensors take
    dot_plain(tf32=True); CUDA tensors launch the hand-written kernel
    (replaces the TPU kernels tpu_prof_sweep.matmul_kernel(DEFAULT) and
    tpu_proto_mxu.mxu_kernel) or raise."""
    return _dot(x, w, reps, eps, out_cols, True, tile)


def epilogue(p, tn, reps: int, eps: float):
    """The sweep epilogue, (2, M) f32 [tbest, tri].  CPU tensors take
    epilogue_plain; CUDA tensors launch the hand-written kernel (replaces
    the TPU kernel tpu_prof_sweep.epilogue_kernel) or raise."""
    m = p.shape[0]
    if _takes_plain('epilogue', (p, tn), ((m, 6 * SUBT), (1, m))):
        return epilogue_plain(p, tn, reps, eps)
    if not 0 <= reps <= MAX_REPS:
        raise ValueError(f'epilogue takes 0 <= reps <= {MAX_REPS}')
    out = torch.empty((2, m), device=p.device)
    if m == 0:
        return out
    torch.ops.pathtracer_tpu_torch.epilogue_launch(p, tn, m, reps, eps, out)
    return out


def edgemat_ranges(m: int, reps: int, resident: int):
    """The edge-matrix kernel's cut of the reps into n contiguous ranges,
    one per block column: n * ceil(m / EDGE_RAYS) blocks fill at most four
    waves of `resident` blocks (blocks per SM times SMs), at least one
    range and at least one rep a range.  Range s is [s * reps // n, (s + 1)
    * reps // n)."""
    tiles = -(-m // EDGE_RAYS)
    n = max(1, min(reps, 4 * resident // max(tiles, 1)))
    return [(s * reps // n, (s + 1) * reps // n) for s in range(n)]


def edgemat_combine(parts):
    """The kernel's combine of the ranges' results, in rep order: the least
    t, and on a tie (-0.0 against +0.0) the earlier range's, as the plain
    version keeps the earlier rep's."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.where(p < out, p, out)
    return out


def edgemat(o, d, tr, reps: int, eps: float):
    """The edge-matrix test, (1, M) f32 min accepted t.  CPU tensors take
    edgemat_plain; CUDA tensors launch the hand-written kernel (replaces
    the TPU kernel tpu_prof_sweep.edgemat_kernel) or raise."""
    m = o.shape[1]
    if _takes_plain('edgemat', (o, d, tr), ((3, m), (3, m), (12, SUBT))):
        return edgemat_plain(o, d, tr, reps, eps)
    if not 0 <= reps <= MAX_REPS:
        raise ValueError(f'edgemat takes 0 <= reps <= {MAX_REPS}')
    out = torch.empty((1, m), device=o.device)
    if m == 0:
        return out
    sms = torch.cuda.get_device_properties(o.device).multi_processor_count
    splits = len(edgemat_ranges(m, reps, kernel_info()['edgemat'][1] * sms))
    partial = torch.empty((splits, m), dtype=torch.int64, device=o.device)
    torch.ops.pathtracer_tpu_torch.edgemat_launch(o, d, tr, m, reps, splits,
                                                  eps, partial, out)
    return out
