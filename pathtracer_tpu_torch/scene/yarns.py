"""Yarns: polylines rendered as finite-cylinder tubes (counterpart of
pathtracer_tpu/scene/yarns.py; reference TriangleMesh.h:265-309, .yarn
polylines scaled x50, one Cylinder(r=0.1) per segment, and
Cylinder::intersection, Geometry.h:731-846).

The sweep tests every ray against chunks of CHUNK segments in JAX's chunk
order with its strict `<` update, rays tiled by pointset.RAY_TILE.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from . import pointset as ps_mod

BIG_T = ps_mod.BIG_T

YARN_SCALE = 50.0      # TriangleMesh.h:281
YARN_RADIUS = 0.1
CHUNK = 2048           # segments per chunk (JAX's chunk)


def load_yarn(path: str):
    """Parse a .yarn file (TriangleMesh.h:268-290): the number of yarns,
    then per yarn its number of points and their xyz.  Returns (a (S,3),
    b (S,3)) segment endpoints, scaled x50."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    nb = int(next(it))
    seg_a, seg_b = [], []
    for _ in range(nb):
        npts = int(next(it))
        prev = None
        for _ in range(npts):
            p = np.array([float(next(it)), float(next(it)),
                          float(next(it))]) * YARN_SCALE
            if prev is not None:
                seg_a.append(prev)
                seg_b.append(p)
            prev = p
    return (np.asarray(seg_a, np.float32).reshape(-1, 3),
            np.asarray(seg_b, np.float32).reshape(-1, 3))


@dataclasses.dataclass
class YarnArrays:
    """Device-side segments: start, unit axis, length and radius (S,)."""

    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    length: torch.Tensor
    radius: torch.Tensor
    obj_row: int = 0

    @property
    def num_segments(self):
        return self.ax.shape[0]

    def to(self, dev) -> 'YarnArrays':
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def upload_yarns(seg_a, seg_b, obj_row, radius=YARN_RADIUS,
                 device=None) -> YarnArrays:
    """Segments on `device` (None: the card)."""
    dev = device_mod.resolve(device)
    d = seg_b - seg_a
    ln = np.linalg.norm(d, axis=1)
    u = d / np.maximum(ln[:, None], 1e-12)
    ax, ay, az = ps_mod._columns(seg_a, dev)
    ux, uy, uz = ps_mod._columns(u, dev)
    return YarnArrays(
        ax=ax, ay=ay, az=az, ux=ux, uy=uy, uz=uz,
        length=torch.as_tensor(ln.astype(np.float32), device=dev),
        radius=torch.full((len(seg_a),), float(np.float32(radius)),
                          device=dev),
        obj_row=int(obj_row))


def cylinder_sweep(ya: YarnArrays, org, dirn, t_max, chunk: int = CHUNK):
    """Closest finite-cylinder hit over every segment: the nearest positive
    root of the quadratic in the plane across the axis whose axial
    coordinate lies in [0, length].  Returns (t, segment index, axial s)."""
    n = org.shape[0]
    best_t = t_max.clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    best_s = torch.zeros((n,), device=org.device)
    total = ya.num_segments
    for rs in ps_mod._tiles(n):
        (ox, oy, oz), (dx, dy, dz) = ps_mod._rays(org[rs], dirn[rs])
        bt, bi, bs = best_t[rs], best_i[rs], best_s[rs]
        for start in range(0, total, chunk):
            sl = slice(start, min(start + chunk, total))
            axp, ayp, azp = ya.ax[sl], ya.ay[sl], ya.az[sl]
            uxp, uyp, uzp = ya.ux[sl], ya.uy[sl], ya.uz[sl]
            ln = ya.length[sl]
            r = ya.radius[sl]
            ocx, ocy, ocz = ox - axp, oy - ayp, oz - azp
            du = dx * uxp + dy * uyp + dz * uzp
            ocu = ocx * uxp + ocy * uyp + ocz * uzp
            dpx, dpy, dpz = dx - du * uxp, dy - du * uyp, dz - du * uzp
            opx, opy, opz = ocx - ocu * uxp, ocy - ocu * uyp, ocz - ocu * uzp
            a = dpx * dpx + dpy * dpy + dpz * dpz
            b = dpx * opx + dpy * opy + dpz * opz
            c = opx * opx + opy * opy + opz * opz - r * r
            delta = b * b - a * c
            safe_a = torch.clamp_min(a, 1e-20)
            sq = torch.sqrt(torch.clamp_min(delta, 0.0))
            t1 = (-b - sq) / safe_a
            t2 = (-b + sq) / safe_a
            s1 = ocu + t1 * du
            s2 = ocu + t2 * du
            ok1 = (delta >= 0) & (t1 > 0) & (s1 >= 0) & (s1 <= ln)
            ok2 = (delta >= 0) & (t2 > 0) & (s2 >= 0) & (s2 <= ln)
            t = torch.where(ok1, t1, torch.where(ok2, t2,
                                                 torch.full_like(t2, BIG_T)))
            s_ax = torch.where(ok1, s1, s2)
            bt, bi, win, j = ps_mod._closest(t, start, bt, bi)
            bs = torch.where(win, s_ax.gather(1, j[:, None])[:, 0], bs)
        best_t[rs], best_i[rs], best_s[rs] = bt, bi, bs
    return best_t, best_i, best_s
