"""Triangle soup, brute force and the lockstep BVH traversal
(counterpart of pathtracer_tpu/ops/traverse.py).

* `brute_force_hit` / `brute_force_any` test every ray against every
  triangle with the precomputed edge-matrix formula: the exact oracle, and
  the small-mesh tier on the CPU.
* `bvh_hit` walks the flat BVH (ops/bvh.py) in lockstep, one short stack
  per lane, near child first, pruning by the lane's best t; with
  `any_hit_limit` it is the shadow variant.  `bvh_hit_sparse` runs it on
  the active lanes only, in fixed chunks: the safety net behind the
  cluster tree tier's residual lanes.  Both are torch code, as they are
  XLA code in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod

BIG_T = float(np.float32(1e30))


class TriSoup(NamedTuple):
    """Precomputed triangle data, one (T,) tensor per component."""

    ax: torch.Tensor; ay: torch.Tensor; az: torch.Tensor   # vertex A
    ux: torch.Tensor; uy: torch.Tensor; uz: torch.Tensor   # B - A
    vx: torch.Tensor; vy: torch.Tensor; vz: torch.Tensor   # C - A
    nx: torch.Tensor; ny: torch.Tensor; nz: torch.Tensor   # cross(u, v)
    m11: torch.Tensor; m12: torch.Tensor; m22: torch.Tensor
    invdetm: torch.Tensor


def make_soup(tri_verts: np.ndarray, device=None) -> TriSoup:
    """From (T,3,3) corner positions; float64 precompute, float32 out.
    device None: the card (device.default_device)."""
    device = device_mod.resolve(device)
    a = tri_verts[:, 0].astype(np.float64)
    u = tri_verts[:, 1].astype(np.float64) - a
    v = tri_verts[:, 2].astype(np.float64) - a
    n = np.cross(u, v)
    m11 = (u * u).sum(-1)
    m22 = (v * v).sum(-1)
    m12 = (u * v).sum(-1)
    det = m11 * m22 - m12 * m12
    invdetm = 1.0 / np.where(det != 0, det, 1.0)

    def f(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    return TriSoup(
        ax=f(a[:, 0]), ay=f(a[:, 1]), az=f(a[:, 2]),
        ux=f(u[:, 0]), uy=f(u[:, 1]), uz=f(u[:, 2]),
        vx=f(v[:, 0]), vy=f(v[:, 1]), vz=f(v[:, 2]),
        nx=f(n[:, 0]), ny=f(n[:, 1]), nz=f(n[:, 2]),
        m11=f(m11), m12=f(m12), m22=f(m22), invdetm=f(invdetm))


class MeshHit(NamedTuple):
    t: torch.Tensor        # (N,) BIG_T (or the caller's t_max) on a miss
    tri: torch.Tensor      # (N,) int32 soup index, -1 on a miss
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor


def bary_cleanup(alpha, beta, gamma):
    """NaN/Inf clamps of the winning barycentrics (TriangleMesh.cpp:1220-1226)."""
    one = torch.ones_like(alpha)
    zero = torch.zeros_like(alpha)
    all_nan = alpha.isnan() & beta.isnan() & gamma.isnan()
    alpha = torch.where(all_nan, one, torch.where(alpha.isnan(), zero, alpha))
    beta = torch.where(all_nan, zero, torch.where(beta.isnan(), zero, beta))
    gamma = torch.where(all_nan, zero, torch.where(gamma.isnan(), zero, gamma))
    alpha = torch.where(alpha.isinf(), one, alpha)
    beta = torch.where(beta.isinf(), one, beta)
    gamma = torch.where(gamma.isinf(), one, gamma)
    return alpha, beta, gamma


def _tri_test_block(soup: TriSoup, sl, org, dirn):
    """(N,) rays x (B,) triangles -> (N,B) t (BIG_T where rejected) and
    barycentrics: t = dot(A-O, N)/dot(D, N); accept t >= 0 and all
    barycentrics >= 0 (NaN rejected)."""
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]
    ax, ay, az = soup.ax[sl], soup.ay[sl], soup.az[sl]
    nx, ny, nz = soup.nx[sl], soup.ny[sl], soup.nz[sl]
    dn = dx * nx + dy * ny + dz * nz
    t = ((ax - ox) * nx + (ay - oy) * ny + (az - oz) * nz) / dn
    px = ox + t * dx - ax
    py = oy + t * dy - ay
    pz = oz + t * dz - az
    b11 = px * soup.ux[sl] + py * soup.uy[sl] + pz * soup.uz[sl]
    b21 = px * soup.vx[sl] + py * soup.vy[sl] + pz * soup.vz[sl]
    beta = (b11 * soup.m22[sl] - b21 * soup.m12[sl]) * soup.invdetm[sl]
    gamma = (b21 * soup.m11[sl] - b11 * soup.m12[sl]) * soup.invdetm[sl]
    alpha = 1.0 - beta - gamma
    ok = (t >= 0.0) & (beta >= 0.0) & (gamma >= 0.0) & (alpha >= 0.0) \
        & ~t.isnan()
    return torch.where(ok, t, torch.full_like(t, BIG_T)), alpha, beta, gamma


def brute_force_hit(soup: TriSoup, org, dirn, t_max=None, t_min=None,
                    chunk: int = 2048) -> MeshHit:
    """Dense all-pairs closest hit, chunked over triangles.  t_min (N,):
    hits at or below it are rejected.  Equal t goes to the lower index."""
    n = org.shape[0]
    dev = org.device
    best_t = (torch.full((n,), BIG_T, device=dev) if t_max is None
              else t_max.clone())
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best = [torch.ones(n, device=dev), torch.zeros(n, device=dev),
            torch.zeros(n, device=dev)]
    t_total = soup.ax.shape[0]
    for start in range(0, t_total, chunk):
        sl = slice(start, min(start + chunk, t_total))
        t, al, be, ga = _tri_test_block(soup, sl, org, dirn)
        if t_min is not None:
            t = torch.where(t > t_min[:, None], t, torch.full_like(t, BIG_T))
        tj, j = t.min(dim=-1)
        win = tj < best_t
        best_tri = torch.where(win, (j + start).to(torch.int32), best_tri)
        for k, x in enumerate((al, be, ga)):
            xj = x.gather(1, j[:, None])[:, 0]
            best[k] = torch.where(win, xj, best[k])
        best_t = torch.where(win, tj, best_t)
    return MeshHit(t=best_t, tri=best_tri, alpha=best[0], beta=best[1],
                   gamma=best[2])


def brute_force_any(soup: TriSoup, org, dirn, t_limit,
                    chunk: int = 2048):
    """Any hit with t < t_limit.  Returns bool (N,)."""
    blocked = torch.zeros(org.shape[0], dtype=torch.bool, device=org.device)
    t_total = soup.ax.shape[0]
    for start in range(0, t_total, chunk):
        sl = slice(start, min(start + chunk, t_total))
        t = _tri_test_block(soup, sl, org, dirn)[0]
        blocked |= (t < t_limit[:, None]).any(dim=-1)
    return blocked


# ---------------------------------------------------------------------------
# BVH traversal (lockstep, one short stack per lane)
# ---------------------------------------------------------------------------

class BVHArrays(NamedTuple):
    """Flat BVH on the device, one (M,) tensor per component."""

    lo_x: torch.Tensor; lo_y: torch.Tensor; lo_z: torch.Tensor
    hi_x: torch.Tensor; hi_y: torch.Tensor; hi_z: torch.Tensor
    a: torch.Tensor        # int32; internal: left child, leaf: tri start
    b: torch.Tensor        # int32; internal: right child, leaf: tri end
    leaf: torch.Tensor     # bool


def upload_bvh(fb, device=None) -> BVHArrays:
    """A FlatBVH's arrays on `device` (None: the card)."""
    device = device_mod.resolve(device)

    def t(x):
        # a copy: a cached FlatBVH's arrays are shared and read-only
        return torch.as_tensor(np.array(x, order='C'), device=device)

    return BVHArrays(
        lo_x=t(fb.node_lo[:, 0]), lo_y=t(fb.node_lo[:, 1]),
        lo_z=t(fb.node_lo[:, 2]), hi_x=t(fb.node_hi[:, 0]),
        hi_y=t(fb.node_hi[:, 1]), hi_z=t(fb.node_hi[:, 2]),
        a=t(fb.node_a.astype(np.int32)), b=t(fb.node_b.astype(np.int32)),
        leaf=t(fb.node_leaf.astype(bool)))


def _slab(bvh: BVHArrays, node, ox, oy, oz, ix, iy, iz):
    """Slab test of gathered nodes: (hit, t_near = max(entry, 0))."""
    t1x = (bvh.lo_x[node] - ox) * ix
    t2x = (bvh.hi_x[node] - ox) * ix
    t1y = (bvh.lo_y[node] - oy) * iy
    t2y = (bvh.hi_y[node] - oy) * iy
    t1z = (bvh.lo_z[node] - oz) * iz
    t2z = (bvh.hi_z[node] - oz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x),
                                       torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x),
                                       torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    near = torch.clamp_min(tmin, 0.0)
    return tmax >= near, near


def _tri_test_lane(soup: TriSoup, tri, org, dirn):
    """One gathered triangle per lane: (t, BIG_T where rejected; alpha,
    beta, gamma), the formula of _tri_test_block."""
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    dx, dy, dz = dirn[:, 0], dirn[:, 1], dirn[:, 2]
    ax, ay, az = soup.ax[tri], soup.ay[tri], soup.az[tri]
    nx, ny, nz = soup.nx[tri], soup.ny[tri], soup.nz[tri]
    dn = dx * nx + dy * ny + dz * nz
    t = ((ax - ox) * nx + (ay - oy) * ny + (az - oz) * nz) / dn
    px = ox + t * dx - ax
    py = oy + t * dy - ay
    pz = oz + t * dz - az
    b11 = px * soup.ux[tri] + py * soup.uy[tri] + pz * soup.uz[tri]
    b21 = px * soup.vx[tri] + py * soup.vy[tri] + pz * soup.vz[tri]
    beta = (b11 * soup.m22[tri] - b21 * soup.m12[tri]) * soup.invdetm[tri]
    gamma = (b21 * soup.m11[tri] - b11 * soup.m12[tri]) * soup.invdetm[tri]
    alpha = 1.0 - beta - gamma
    ok = (t >= 0.0) & (beta >= 0.0) & (gamma >= 0.0) & (alpha >= 0.0) \
        & ~t.isnan()
    return torch.where(ok, t, torch.full_like(t, BIG_T)), alpha, beta, gamma


def bvh_hit(bvh: BVHArrays, soup: TriSoup, org, dirn, max_leaf: int,
            stack_depth: int = 48, t_init=None, any_hit_limit=None,
            t_min=None) -> MeshHit:
    """Lockstep BVH closest hit: near-first child order, prune by the
    lane's best t, leaves test <= max_leaf triangles.  t_init (N,) seeds
    the best t (t stays t_init on a miss); any_hit_limit (N,) turns it
    into the shadow variant, a lane stopping once blocked below its
    limit; t_min (N,) rejects hits at or below it."""
    n = org.shape[0]
    dev = org.device
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    ix, iy, iz = 1.0 / dirn[:, 0], 1.0 / dirn[:, 1], 1.0 / dirn[:, 2]
    lanes = torch.arange(n, device=dev)
    n_tris = soup.ax.shape[0]
    n_nodes = bvh.leaf.shape[0]
    leaf_tab = bvh.leaf
    a_tab, b_tab = bvh.a.long(), bvh.b.long()

    stack = torch.zeros((stack_depth, n), dtype=torch.long, device=dev)
    tstack = torch.full((stack_depth, n), BIG_T, device=dev)
    root_hit, root_t = _slab(bvh, torch.zeros(n, dtype=torch.long,
                                              device=dev),
                             ox, oy, oz, ix, iy, iz)
    sp = root_hit.long()
    tstack[0] = torch.where(root_hit, root_t, torch.full_like(root_t, BIG_T))
    best_t = (torch.full((n,), BIG_T, device=dev) if t_init is None
              else t_init.clone())
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    al = torch.ones(n, device=dev)
    be = torch.zeros(n, device=dev)
    ga = torch.zeros(n, device=dev)

    def push(sp, val, tval, mask):
        spc = sp.clamp_max(stack_depth - 1)
        stack[spc, lanes] = torch.where(mask, val, stack[spc, lanes])
        tstack[spc, lanes] = torch.where(mask, tval, tstack[spc, lanes])
        return torch.where(mask, sp + 1, sp)

    while bool((sp > 0).any()):
        active = sp > 0
        sp1 = (sp - 1).clamp_min(0)
        node = stack[sp1, lanes]
        tnear = tstack[sp1, lanes]
        sp = torch.where(active, sp1, sp)
        process = active & (tnear <= best_t)
        leaf = leaf_tab[node]
        a = a_tab[node]
        b = b_tab[node]

        # internal: test both children, push the far one first
        # (a leaf's a, b are a triangle range: clamp them into the node
        # table; do_int masks those lanes out)
        do_int = process & ~leaf
        hit_l, t_l = _slab(bvh, a.clamp_max(n_nodes - 1), ox, oy, oz, ix, iy,
                           iz)
        hit_r, t_r = _slab(bvh, b.clamp_max(n_nodes - 1), ox, oy, oz, ix, iy,
                           iz)
        go_l = do_int & hit_l & (t_l < best_t)
        go_r = do_int & hit_r & (t_r < best_t)
        l_nearer = t_l < t_r
        sp = push(sp, torch.where(l_nearer, b, a),
                  torch.where(l_nearer, t_r, t_l),
                  torch.where(l_nearer, go_r, go_l))
        sp = push(sp, torch.where(l_nearer, a, b),
                  torch.where(l_nearer, t_l, t_r),
                  torch.where(l_nearer, go_l, go_r))

        # leaf: test up to max_leaf triangles
        do_leaf = process & leaf
        for k in range(max_leaf):
            tri = (a + k).clamp_max(n_tris - 1)
            valid = do_leaf & (a + k < b)
            t_k, al_k, be_k, ga_k = _tri_test_lane(soup, tri, org, dirn)
            win = valid & (t_k < best_t)
            if t_min is not None:
                win &= t_k > t_min
            best_t = torch.where(win, t_k, best_t)
            best_tri = torch.where(win, tri.to(torch.int32), best_tri)
            al = torch.where(win, al_k, al)
            be = torch.where(win, be_k, be)
            ga = torch.where(win, ga_k, ga)

        if any_hit_limit is not None:
            sp = torch.where(best_t < any_hit_limit, torch.zeros_like(sp), sp)
    return MeshHit(t=best_t, tri=best_tri, alpha=al, beta=be, gamma=ga)


def bvh_hit_sparse(bvh: BVHArrays, soup: TriSoup, org, dirn, active,
                   max_leaf: int, t, tri, alpha, beta, chunk: int = 65536,
                   t_min=None, stack_depth: int = 48):
    """bvh_hit over the ACTIVE lanes only, `chunk` lanes at a time.

    (t, tri, alpha, beta) are the running best hit per lane; an active
    lane whose traversal (seeded with its t) finds a closer hit is
    improved, every other lane passes through.  Returns new tensors."""
    t, tri, alpha, beta = t.clone(), tri.clone(), alpha.clone(), beta.clone()
    idx_all = active.nonzero()[:, 0]
    for c0 in range(0, idx_all.numel(), chunk):
        idx = idx_all[c0:c0 + chunk]
        t_c = t[idx]
        fh = bvh_hit(bvh, soup, org[idx], dirn[idx], max_leaf=max_leaf,
                     stack_depth=stack_depth, t_init=t_c,
                     t_min=None if t_min is None else t_min[idx])
        win = fh.t < t_c
        t[idx] = torch.where(win, fh.t, t_c)
        tri[idx] = torch.where(win, fh.tri, tri[idx])
        alpha[idx] = torch.where(win, fh.alpha, alpha[idx])
        beta[idx] = torch.where(win, fh.beta, beta[idx])
    return t, tri, alpha, beta
