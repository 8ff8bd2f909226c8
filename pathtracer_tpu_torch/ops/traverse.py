"""Triangle soup and the brute-force exact oracle
(counterpart of pathtracer_tpu/ops/traverse.py).

`brute_force_hit` / `brute_force_any` test every ray against every
triangle with the precomputed edge-matrix formula.  They are the exact
reference the cluster tier (ops/cluster.py) is held against; the port has
no lockstep-BVH tier.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG_T = float(np.float32(1e30))


class TriSoup(NamedTuple):
    """Precomputed triangle data, one (T,) tensor per component."""

    ax: torch.Tensor; ay: torch.Tensor; az: torch.Tensor   # vertex A
    ux: torch.Tensor; uy: torch.Tensor; uz: torch.Tensor   # B - A
    vx: torch.Tensor; vy: torch.Tensor; vz: torch.Tensor   # C - A
    nx: torch.Tensor; ny: torch.Tensor; nz: torch.Tensor   # cross(u, v)
    m11: torch.Tensor; m12: torch.Tensor; m22: torch.Tensor
    invdetm: torch.Tensor


def make_soup(tri_verts: np.ndarray, device='cpu') -> TriSoup:
    """From (T,3,3) corner positions; float64 precompute, float32 out."""
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


def brute_force_hit(soup: TriSoup, org, dirn, t_max=None,
                    chunk: int = 2048) -> MeshHit:
    """Dense all-pairs closest hit, chunked over triangles."""
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
