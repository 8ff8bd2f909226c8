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

Layout: the production sweep's, lane groups of `group` rays (None:
cluster.SWEEP_GROUP) taken in `order` (None: cluster.heaviest_first on
the clamped counts), one launch; a lane's result depends only on its ray
and its packet's slots, so neither changes a bit.

`sweep_ablate` launches the hand-written CUDA kernel on CUDA tensors (or
raises) and takes `sweep_ablate_plain` on CPU tensors; the two are
bit-equal.  Both return (t, tri, beta, gamma), (N,) each: t starts at
tmax, tri at -1, beta and gamma at 0, and each variant writes what it
computes.  `stats` ((units, STATS) int64) receives each unit's subtiles
swept and, from the kernel, its clock64 cycles.
"""

from __future__ import annotations

import torch

from . import binding, cluster
from .cluster import BIG_T, BLOCK, MAXC, SUBT, ClusteredMesh, heaviest_first

SLOTS = 8           # slots swept per packet (the TPU script's clamp)
VARIANTS = ('full', 'no-load', 'no-products', 'no-epi', 'tonly', 'acc-only',
            'lean', 'notb', 'pk')
PLAIN_CHUNK = 64    # packets per plain-version step (bounds its tensors)
STATS = 2           # counters per unit: subtiles swept, clock64 cycles


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


def _plain_units(cm, ids, cnt, org, dirn, tmax, tmin, variant, units, g):
    """Sweep the lane groups `units` ((U,) int64) of g rays; returns their
    outputs as (U * g,) tensors and the lanes they belong to."""
    nu = units.shape[0]
    pk = units // (BLOCK // g)                              # packet of a unit
    lanes = (units[:, None] * g + torch.arange(g, device=org.device)
             ).reshape(-1)
    o = org[lanes].view(nu, g, 3)
    d = dirn[lanes].view(nu, g, 3)
    tn = torch.clamp_min(tmin[lanes], 0.0).view(nu, g)
    st = [tmax[lanes].view(nu, g).clone(),
          torch.full((nu, g), -1, dtype=torch.int32, device=org.device),
          torch.zeros((nu, g), device=org.device),
          torch.zeros((nu, g), device=org.device)]
    c = cnt[pk]
    first = cm.planes[ids[pk, 0].clamp_min(0).long(), 0]    # no-load
    for k in range(SLOTS):
        p = (c > k).nonzero()[:, 0]
        if p.numel() == 0:
            break
        cid = ids[pk[p], k].clamp_min(0).long()
        oc = o[p] - cm.ctab[cid, None, 6:9]
        for s in range(cm.n_sub):
            planes = first[p] if variant == 'no-load' else cm.planes[cid, s]
            sub = [x[p] for x in st]
            _subtile(variant, planes, oc, d[p], tn[p],
                     cm.starts[cid] + s * SUBT, sub)
            for x, y in zip(st, sub):
                x[p] = y
    return [x.reshape(-1) for x in st], lanes


def _order(order, counts, g, nu):
    """The unit order of a launch: heaviest_first on the clamped counts
    when None, else `order` checked to be a (units,) int32 permutation on
    the rays' device."""
    if order is None:
        return heaviest_first(counts.clamp(max=SLOTS), g)
    if (order.dtype != torch.int32 or tuple(order.shape) != (nu,)
            or order.device != counts.device
            or not torch.equal(torch.sort(order).values,
                               torch.arange(nu, dtype=torch.int32,
                                            device=order.device))):
        raise ValueError(f'sweep_ablate order must be an int32 permutation '
                         f'of the {nu} units on {counts.device}')
    return order


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f'unknown ablation variant {variant!r}; one of '
                         f'{VARIANTS}')


def sweep_ablate_plain(cm: ClusteredMesh, ids, counts, org, dirn, tmax,
                       tmin, variant: str, group=None, order=None,
                       stats=None):
    """The ablation variant computed with torch ops over lane groups of
    `group` rays (None: SWEEP_GROUP), PLAIN_CHUNK packets' worth of units
    at a time, taken in `order` (None: heaviest first): (t, tri, beta,
    gamma), (N,) each; neither the group size nor the order changes a
    bit.  `stats` ((units, STATS) int64), optional: column 0 receives each
    unit's subtiles swept (the kernel's cycles column is left as it is)."""
    _check_variant(variant)
    g = cluster._group(group)
    gpp = BLOCK // g
    nu = ids.shape[0] * gpp
    order = _order(order, counts, g, nu).long()
    cnt = counts[:, 0].clamp(max=min(MAXC, SLOTS))
    outs = [torch.empty_like(tmax),
            torch.empty(tmax.shape, dtype=torch.int32, device=org.device),
            torch.empty_like(tmax), torch.empty_like(tmax)]
    for u0 in range(0, nu, PLAIN_CHUNK * gpp):
        res, lanes = _plain_units(cm, ids, cnt, org, dirn, tmax, tmin,
                                  variant, order[u0:u0 + PLAIN_CHUNK * gpp],
                                  g)
        for out, x in zip(outs, res):
            out[lanes] = x
    if stats is not None:
        stats[:, 0] = cnt.repeat_interleave(gpp) * cm.n_sub
    return tuple(outs)


def kernel_info(group=None) -> dict:
    """{variant: (registers per thread, resident blocks per SM, threads
    per block)} of the ablation kernels at lane group `group` (None:
    SWEEP_GROUP), from the CUDA runtime."""
    g = cluster._group(group)
    return {v: binding.info('sweep_ablate_info', i, g)
            for i, v in enumerate(VARIANTS)}


def sweep_ablate(cm: ClusteredMesh, ids, counts, org, dirn, tmax, tmin,
                 variant: str, group=None, order=None, stats=None):
    """One ablation variant over nb = N / BLOCK packets in lane groups of
    `group` rays (None: SWEEP_GROUP), one launch: (t, tri, beta, gamma).
    CPU tensors take sweep_ablate_plain; CUDA tensors launch the
    hand-written kernel (replaces the TPU kernel
    tpu_ablate_sweep.make_kernel) or raise.  `order` ((units,) int32),
    optional: the unit each block takes, a permutation (None:
    heaviest_first on the clamped counts).  `stats` ((units, STATS)
    int64), optional: per unit the subtiles swept and, from the kernel,
    its clock64 cycles."""
    _check_variant(variant)
    g = cluster._group(group)
    dev = org.device
    nb = ids.shape[0]
    n, nu = nb * BLOCK, nb * (BLOCK // g)
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'sweep_ablate takes CUDA or CPU tensors, got {dev}')
    order = _order(order, counts, g, nu)
    if stats is not None and (
            stats.device != dev or stats.dtype != torch.int64
            or not stats.is_contiguous() or tuple(stats.shape) != (nu, STATS)):
        raise ValueError(f'sweep_ablate stats must be a contiguous (units, '
                         f'{STATS}) int64 tensor on {dev}')
    if dev.type == 'cpu':
        return sweep_ablate_plain(cm, ids, counts, org, dirn, tmax, tmin,
                                  variant, g, order, stats)
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
    if cm.planes.data_ptr() % 16:
        raise ValueError('sweep_ablate planes must be 16-byte aligned (the '
                         'bulk copy)')
    t = torch.empty((n,), device=dev)
    tri = torch.empty((n,), dtype=i32, device=dev)
    be = torch.empty((n,), device=dev)
    ga = torch.empty((n,), device=dev)
    torch.ops.pathtracer_tpu_torch.sweep_ablate_launch(
        ids, counts, cm.planes, cm.ctab, cm.starts, cm.n_sub, org, dirn, tmax,
        tmin, order, t, tri, be, ga, stats, order.shape[0], g,
        VARIANTS.index(variant))
    return t, tri, be, ga
