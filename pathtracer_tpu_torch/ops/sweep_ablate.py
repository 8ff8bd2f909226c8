"""Ablation of the cluster sweep: the closest-hit sweep's slot loop at
fixed work, with parts of its per-pair arithmetic replaced, so that the
time of each part (staging the planes, the six ray-plane dot families,
the IEEE divide, the winner logic) can be read off by difference.

Counterpart of the TPU probe scripts/tpu_ablate_sweep.py (`make_kernel`).
That script was written for the round-3 TPU sweep layout and no longer
runs against the JAX package, so this module ablates the port's own sweep
(csrc/cluster_sweep.cu, through csrc/sweep_common.cuh) at the port's
layout; its `full` variant is the closest hit of `cluster.cluster_sweep`
without slab skips and early break.  Fixed work: every packet sweeps its
first min(count, SLOTS) emitted slots, every subtile of each.

Variants (VARIANTS; csrc/sweep_ablate.cu states each):
  full, no-load, no-products, no-epi, tonly, acc-only, lean, notb, pk.
The TPU script's `*high*` variants chose the MXU's bf16x3 passes; the
port's sweep has no matrix product and no precision knob, so they have no
counterpart here (the tensor-core question is sweep_micro.dot_tf32's).

`sweep_ablate` launches the hand-written CUDA kernel on CUDA tensors (or
raises) and takes `sweep_ablate_plain` on CPU tensors; the two are
bit-equal.  Both return (t, tri, beta, gamma), (N,) each: t starts at
tmax, tri at -1, beta and gamma at 0, and each variant writes what it
computes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import device
from .cluster import BIG_T, BLOCK, MAXC, SUBT, ClusteredMesh

SLOTS = 8           # slots swept per packet (the TPU script's clamp)
VARIANTS = ('full', 'no-load', 'no-products', 'no-epi', 'tonly', 'acc-only',
            'lean', 'notb', 'pk')
PLAIN_CHUNK = 64    # packets per plain-version step (bounds its tensors)


def _dot(v, pl, r):
    """(v . plane rows r..r+2) as the kernel's dot3: (P, BLOCK, SUBT)."""
    return (v[:, :, 0:1] * pl[:, :, r] + v[:, :, 1:2] * pl[:, :, r + 1]
            + v[:, :, 2:3] * pl[:, :, r + 2])


def _families(planes, oc, d, variant):
    """on, ou, ov, dn, du, dv (dn, du, dv = d . plane, not negated)."""
    pl = planes[:, None]                                   # (P, 1, 12, S)
    if variant == 'no-products':
        return (pl[:, :, 0] + pl[:, :, 3], pl[:, :, 4] + pl[:, :, 7],
                pl[:, :, 8] + pl[:, :, 11], pl[:, :, 1] + pl[:, :, 2],
                pl[:, :, 5] + pl[:, :, 6], pl[:, :, 9] + pl[:, :, 10])
    return (_dot(oc, pl, 0) + pl[:, :, 3], _dot(oc, pl, 4) + pl[:, :, 7],
            _dot(oc, pl, 8) + pl[:, :, 11], _dot(d, pl, 0), _dot(d, pl, 4),
            _dot(d, pl, 8))


def _nan_min(x):
    """Min over the last axis ignoring NaN (+inf where all are NaN): the
    kernel's sequential `if (v < best) best = v`."""
    return torch.where(x == x, x, torch.full_like(x, float('inf'))) \
        .amin(dim=-1)


def _subtile(variant, planes, oc, d, tn, base, st):
    """Apply one subtile to the state st = [best, btri, bb, bg] of the
    (P, BLOCK) lanes given."""
    best, btri, bb, bg = st
    on, ou, ov, dn, du, dv = _families(planes, oc, d, variant)
    if variant == 'no-epi':
        v = on + ou + ov + dn + du + dv
        vmin = _nan_min(v)
        st[0] = torch.where(vmin < best, vmin, best)
        return
    t = on / -dn
    if variant == 'tonly':
        tmin = _nan_min(t)
        st[0] = torch.where(tmin < best, tmin, best)
        return
    beta = ou + t * du
    gamma = ov + t * dv
    ok = ((t > tn[:, :, None]) & (beta >= 0.0) & (gamma >= 0.0)
          & ((1.0 - (beta + gamma)) >= 0.0))
    shape = ok.shape
    t, beta, gamma = (x.expand(shape) for x in (t, beta, gamma))
    lane = torch.arange(SUBT, dtype=torch.int32, device=t.device)
    if variant in ('lean', 'notb', 'pk'):
        tm = torch.where(ok, t, torch.full_like(t, BIG_T))
        kmin = ((tm.view(torch.int32) & ~0xFF) | lane).amin(dim=-1)
        j = (kmin & 0xFF).long()[:, :, None]
        tj = (tm.gather(-1, j)[:, :, 0] if variant != 'notb'
              else (kmin & ~0xFF).view(torch.float32))
        win = tj < best
        st[0] = torch.where(win, tj, best)
        st[1] = torch.where(win, base[:, None] + j[:, :, 0].to(torch.int32),
                            btri)
        if variant == 'pk':
            st[2] = torch.where(win, beta.gather(-1, j)[:, :, 0], bb)
            st[3] = torch.where(win, gamma.gather(-1, j)[:, :, 0], bg)
        return
    tm = torch.where(ok, t, torch.full_like(t, float('inf')))
    tj = tm.amin(dim=-1)
    if variant == 'acc-only':
        st[0] = torch.where(tj < best, tj, best)
        return
    # full, no-load, no-products: exact argmin, ties to the lower index
    trj = base[:, None] + torch.where(tm == tj[:, :, None], lane,
                                      SUBT).amin(dim=-1)
    win = ok.any(dim=-1) & ((tj < best) | ((tj == best) & (trj < btri)))
    st[0] = torch.where(win, tj, best)
    st[1] = torch.where(win, trj, btri)


def _plain_chunk(cm, ids, counts, org, dirn, tmax, tmin, variant):
    nb = ids.shape[0]
    o = org.view(nb, BLOCK, 3)
    d = dirn.view(nb, BLOCK, 3)
    tn = torch.clamp_min(tmin, 0.0).view(nb, BLOCK)
    st = [tmax.view(nb, BLOCK).clone(),
          torch.full((nb, BLOCK), -1, dtype=torch.int32, device=org.device),
          torch.zeros((nb, BLOCK), device=org.device),
          torch.zeros((nb, BLOCK), device=org.device)]
    cnt = counts[:, 0].clamp(max=min(MAXC, SLOTS))
    first = cm.planes[ids[:, 0].clamp_min(0).long(), 0]     # no-load
    for k in range(SLOTS):
        p = (cnt > k).nonzero()[:, 0]
        if p.numel() == 0:
            break
        cid = ids[p, k].clamp_min(0).long()
        oc = o[p] - cm.ctab[cid, None, 6:9]
        for s in range(cm.n_sub):
            planes = first[p] if variant == 'no-load' else cm.planes[cid, s]
            sub = [x[p] for x in st]
            _subtile(variant, planes, oc, d[p], tn[p],
                     cm.starts[cid] + s * SUBT, sub)
            for x, y in zip(st, sub):
                x[p] = y
    return [x.reshape(-1) for x in st]


def sweep_ablate_plain(cm: ClusteredMesh, ids, counts, org, dirn, tmax,
                       tmin, variant: str):
    """The ablation variant computed with torch ops, PLAIN_CHUNK packets
    at a time: (t, tri, beta, gamma), (N,) each."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown ablation variant {variant!r}; one of '
                         f'{VARIANTS}')
    outs = []
    for p0 in range(0, ids.shape[0], PLAIN_CHUNK):
        pk = slice(p0, p0 + PLAIN_CHUNK)
        rk = slice(p0 * BLOCK, (p0 + PLAIN_CHUNK) * BLOCK)
        outs.append(_plain_chunk(cm, ids[pk], counts[pk], org[rk], dirn[rk],
                                 tmax[rk], tmin[rk], variant))
    return tuple(torch.cat(x) for x in zip(*outs))


_libs = {}


def load_kernels(log=None) -> ctypes.CDLL:
    """Build csrc/sweep_ablate.cu with nvcc for sm_90a (once, into the
    build directory) and load it.  `log` receives the compiler's output."""
    if 'ablate' not in _libs:
        lib = ctypes.CDLL(device.build_cuda('sweep_ablate', log=log))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sweep_ablate.argtypes = [ptr] * 5 + [i32] + [ptr] * 8 \
            + [i32, i32, ptr]
        lib.sweep_ablate.restype = i32
        _libs['ablate'] = lib
    return _libs['ablate']


def sweep_ablate(cm: ClusteredMesh, ids, counts, org, dirn, tmax, tmin,
                 variant: str):
    """One ablation variant over nb = N / BLOCK packets: (t, tri, beta,
    gamma).  CPU tensors take sweep_ablate_plain; CUDA tensors launch the
    hand-written kernel (replaces the TPU kernel
    tpu_ablate_sweep.make_kernel) or raise."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown ablation variant {variant!r}; one of '
                         f'{VARIANTS}')
    dev = org.device
    if dev.type == 'cpu':
        return sweep_ablate_plain(cm, ids, counts, org, dirn, tmax, tmin,
                                  variant)
    if dev.type != 'cuda':
        raise ValueError(f'sweep_ablate takes CUDA or CPU tensors, got {dev}')
    nb = ids.shape[0]
    n = nb * BLOCK
    i32, f32 = torch.int32, torch.float32
    checks = (('ids', ids, i32, (nb, MAXC)), ('counts', counts, i32, (nb, 1)),
              ('planes', cm.planes, f32, tuple(cm.planes.shape)),
              ('ctab', cm.ctab, f32, (cm.n_clusters, 12)),
              ('starts', cm.starts, i32, (cm.n_clusters,)),
              ('org', org, f32, (n, 3)), ('dirn', dirn, f32, (n, 3)),
              ('tmax', tmax, f32, (n,)), ('tmin', tmin, f32, (n,)))
    for name, x, dt, shape in checks:
        if (x.device != dev or x.dtype != dt or not x.is_contiguous()
                or tuple(x.shape) != shape):
            raise ValueError(f'sweep_ablate input {name} must be a '
                             f'contiguous {dt} tensor of shape {shape} on '
                             f'{dev}')
    t = torch.empty((n,), device=dev)
    tri = torch.empty((n,), dtype=i32, device=dev)
    be = torch.empty((n,), device=dev)
    ga = torch.empty((n,), device=dev)
    rc = load_kernels().sweep_ablate(
        ids.data_ptr(), counts.data_ptr(), cm.planes.data_ptr(),
        cm.ctab.data_ptr(), cm.starts.data_ptr(), cm.n_sub, org.data_ptr(),
        dirn.data_ptr(), tmax.data_ptr(), tmin.data_ptr(), t.data_ptr(),
        tri.data_ptr(), be.data_ptr(), ga.data_ptr(), nb,
        VARIANTS.index(variant),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'sweep_ablate launch failed: CUDA error {rc}')
    sweep_ablate.launches += 1
    return t, tri, be, ga


sweep_ablate.launches = 0
