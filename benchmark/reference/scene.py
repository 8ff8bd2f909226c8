"""The reference's scene: analytic spheres and planes in world space and
one triangle mesh, queried by brute force over spatial chunks.

Built from the configuration file and the triangles the benchmark made,
never from anything the program derived.  Closest hit: the least t > 0
over the analytic rows (a sphere's nearer positive root, a plane's
crossing), then over the mesh's triangles (Moller-Trumbore, t > 0 and
inside the triangle, edges included), the mesh winning only where it is
strictly nearer.  Occlusion: any analytic t or triangle t in (0, limit).
The mesh's triangles are sorted by the Morton code of their centroids and
cut into chunks of CHUNK; a ray tests the triangles of every chunk whose
padded box it enters before its limit, which finds what testing every
triangle would find.  No triangle is culled by its facing: on a closed
mesh seen from outside the first hit is a front face anyway.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

BIG_T = float(np.float32(1e30))
CHUNK = 128          # triangles per chunk
RAY_BATCH = 2048     # rays per chunk-box test
PAIR_BATCH = 4096    # (ray, chunk) pairs per triangle test
SPHERE, PLANE, MESH = 0, 1, 2


def _normalize(a):
    return a / torch.sqrt(torch.clamp_min((a * a).sum(-1), 1e-20))[..., None]


@dataclasses.dataclass
class Mesh:
    """Triangles in the mesh's own space, in Morton-ordered chunks."""

    v0: torch.Tensor          # (K, CHUNK, 3)
    e1: torch.Tensor
    e2: torch.Tensor
    tri: torch.Tensor         # (K, CHUNK) original triangle index, -1 pad
    lo: torch.Tensor          # (K, 3) padded chunk boxes
    hi: torch.Tensor
    tris: torch.Tensor        # (T, 3) vertex indices
    vertices: torch.Tensor    # (V, 3)
    normals: torch.Tensor     # (V, 3) vertex normals
    translation: torch.Tensor  # (3,)
    row: int                  # the object row the mesh occupies


def build_mesh(vertices, tris, normals, translation, row, device,
               dtype=torch.float32) -> Mesh:
    v = np.asarray(vertices, np.float32)
    t = np.asarray(tris, np.int64)
    tv = v[t]                                             # (T, 3, 3)
    cen = tv.mean(axis=1)
    lo, hi = cen.min(0), cen.max(0)
    q = np.clip(((cen - lo) / np.maximum(hi - lo, 1e-30) * 1023.0),
                0, 1023).astype(np.uint64)

    def spread(x):
        x = x & np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        return (x | (x << np.uint64(2))) & np.uint64(0x09249249)

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2))
    order = np.argsort(code, kind='stable')
    n = len(order)
    k = -(-n // CHUNK)
    idx = np.full(k * CHUNK, -1, np.int64)
    idx[:n] = order
    # pads repeat a vertex three times: a zero-area triangle is never hit
    pad = np.repeat(tv[order[-1], :1], 3, axis=0)
    ctv = np.where((idx >= 0)[:, None, None], tv[np.maximum(idx, 0)], pad)
    ctv = ctv.reshape(k, CHUNK, 3, 3)
    real = ctv.reshape(k, CHUNK * 3, 3)
    box_lo, box_hi = real.min(1), real.max(1)
    eps = 1e-5 * (1.0 + np.abs(real).max())
    f = lambda x, dt=dtype: torch.as_tensor(x, device=device).to(dt)
    return Mesh(v0=f(ctv[:, :, 0]), e1=f(ctv[:, :, 1] - ctv[:, :, 0]),
                e2=f(ctv[:, :, 2] - ctv[:, :, 0]),
                tri=torch.as_tensor(idx.reshape(k, CHUNK), device=device),
                lo=f(box_lo - eps, torch.float32),
                hi=f(box_hi + eps, torch.float32),
                tris=torch.as_tensor(t, device=device), vertices=f(v),
                normals=f(np.asarray(normals, np.float32)),
                translation=f(np.asarray(translation, np.float32)), row=row)


def _chunk_pairs(mesh: Mesh, o, d, limit):
    """(ray, chunk) pairs whose padded box the ray enters in [0, limit),
    by float32 slab tests with axis-parallel rays handled apart."""
    o, d = o.float(), d.float()
    tn = torch.zeros((o.shape[0], mesh.lo.shape[0]), device=o.device)
    tf = torch.full_like(tn, math.inf)
    for a in range(3):
        oa, da = o[:, a:a + 1], d[:, a:a + 1]
        lo, hi = mesh.lo[None, :, a], mesh.hi[None, :, a]
        par = da == 0
        inv = 1.0 / torch.where(par, torch.ones_like(da), da)
        t1, t2 = (lo - oa) * inv, (hi - oa) * inv
        inside = (oa >= lo) & (oa <= hi)
        near = torch.where(par, torch.where(inside, -math.inf, math.inf),
                           torch.minimum(t1, t2))
        far = torch.where(par, torch.where(inside, math.inf, -math.inf),
                          torch.maximum(t1, t2))
        tn, tf = torch.maximum(tn, near), torch.minimum(tf, far)
    ok = (tn <= tf) & (tn < limit.float()[:, None])
    return ok.nonzero(as_tuple=True)


def _tri_t(o, d, v0, e1, e2):
    """Moller-Trumbore over (P, C) triangles for (P, 3) rays: t (inf where
    missed or t <= 0), u, v."""
    o, d = o[:, None], d[:, None]
    pv = torch.cross(d.expand_as(e2), e2, dim=-1)
    det = (e1 * pv).sum(-1)
    inv = 1.0 / det
    tv = o - v0
    u = (tv * pv).sum(-1) * inv
    qv = torch.cross(tv, e1, dim=-1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    return torch.where(ok, t, torch.full_like(t, math.inf)), u, v


def mesh_closest(mesh: Mesh, o, d, tmax):
    """Per ray in mesh space: (t, triangle) of the nearest triangle with
    0 < t < tmax, (tmax, -1) where none (equal t: any of them)."""
    prs, ts, tris = [], [], []
    for r0 in range(0, o.shape[0], RAY_BATCH):
        sl = slice(r0, r0 + RAY_BATCH)
        ri, ci = _chunk_pairs(mesh, o[sl], d[sl], tmax[sl])
        ri = ri + r0
        for p0 in range(0, ri.shape[0], PAIR_BATCH):
            pr, pc = ri[p0:p0 + PAIR_BATCH], ci[p0:p0 + PAIR_BATCH]
            t, _, _ = _tri_t(o[pr], d[pr], mesh.v0[pc], mesh.e1[pc],
                             mesh.e2[pc])
            tmin, j = t.min(dim=1)
            prs.append(pr)
            ts.append(tmin)
            tris.append(mesh.tri[pc].gather(1, j[:, None])[:, 0])
    best_t = tmax.clone()
    best_tri = torch.full(tmax.shape, -1, dtype=torch.int64, device=o.device)
    if not prs:
        return best_t, best_tri
    pr, t, tri = torch.cat(prs), torch.cat(ts), torch.cat(tris)
    t = torch.where(t < tmax[pr], t, torch.full_like(t, math.inf))
    best_t = best_t.scatter_reduce(0, pr, t, 'amin')
    win = (t == best_t[pr]) & torch.isfinite(t)
    best_tri = best_tri.scatter_reduce(0, pr[win], tri[win], 'amax')
    return best_t, best_tri


def mesh_any(mesh: Mesh, o, d, limit):
    """Per ray in mesh space: a triangle with 0 < t < limit exists."""
    hit = torch.zeros(limit.shape, dtype=torch.bool, device=o.device)
    for r0 in range(0, o.shape[0], RAY_BATCH):
        sl = slice(r0, r0 + RAY_BATCH)
        ri, ci = _chunk_pairs(mesh, o[sl], d[sl], limit[sl])
        ri = ri + r0
        for p0 in range(0, ri.shape[0], PAIR_BATCH):
            pr, pc = ri[p0:p0 + PAIR_BATCH], ci[p0:p0 + PAIR_BATCH]
            t, _, _ = _tri_t(o[pr], d[pr], mesh.v0[pc], mesh.e1[pc],
                             mesh.e2[pc])
            hit[pr[(t < limit[pr][:, None]).any(dim=1)]] = True
    return hit


@dataclasses.dataclass
class Scene:
    """World-space analytic rows (the light is row 0, the dome row 1) and
    at most one mesh row."""

    kind: torch.Tensor        # (O,) SPHERE / PLANE / MESH
    center: torch.Tensor      # (O, 3) sphere centre or plane point, world
    radius: torch.Tensor      # (O,)
    normal: torch.Tensor      # (O, 3)
    flip: torch.Tensor        # (O,) bool
    kd: torch.Tensor          # (O, 3)
    ks: torch.Tensor
    ne: torch.Tensor
    transp: torch.Tensor      # (O,) bool
    miroir: torch.Tensor
    refr: torch.Tensor        # (O,)
    light_center: torch.Tensor  # (3,)
    light_radius: torch.Tensor  # 0-d
    light_intensity: torch.Tensor  # 0-d
    mesh: Optional[Mesh] = None
    mesh_material: Optional[dict] = None   # kd, ks, ne (3,), transp, refr

    def replace(self, **kw) -> 'Scene':
        return dataclasses.replace(self, **kw)


UNSUPPORTED = ('ksub', 'ghost', 'textures', 'measured_brdf', 'rotation',
               'scale', 'fog', 'envmap', 'background')


def build_scene(cfg: dict, mesh_arrays, device, dtype=torch.float32) -> Scene:
    """The configuration's objects (see the configuration files) and, for a
    'mesh' object, `mesh_arrays` = (vertices, tris, normals) as the
    benchmark made them."""
    for key in UNSUPPORTED:
        if key in cfg or any(key in o for o in cfg['objects']):
            raise NotImplementedError(f'the reference has no {key!r}')
    rows = cfg['objects']
    if rows[0].get('type') != 'sphere' or len(rows) < 2:
        raise ValueError('row 0 must be the spherical light, row 1 the dome')

    def vec3(o, k, default):
        return np.asarray(o.get(k, default), np.float64)

    kind, center, radius, normal = [], [], [], []
    flip, kd, ks, ne, transp, miroir, refr = [], [], [], [], [], [], []
    mesh = material = None
    for i, o in enumerate(rows):
        tr = vec3(o, 'translation', (0, 0, 0))
        kd.append(vec3(o, 'kd', (1, 1, 1)))
        ks.append(vec3(o, 'ks', (0, 0, 0)))
        ne.append(vec3(o, 'ne', (1, 1, 1)))
        transp.append(bool(o.get('transp', False)))
        miroir.append(bool(o.get('miroir', False)))
        refr.append(float(o.get('refr_index', 1.3)))
        flip.append(bool(o.get('flip_normals', False)))
        normal.append(vec3(o, 'normal', (0, 1, 0)))
        radius.append(float(o.get('radius', 1.0)))
        if o['type'] == 'sphere':
            kind.append(SPHERE)
            center.append(vec3(o, 'center', (0, 0, 0)) + tr)
        elif o['type'] == 'plane':
            kind.append(PLANE)
            center.append(vec3(o, 'point', (0, 0, 0)) + tr)
        elif o['type'] == 'mesh':
            if mesh is not None:
                raise NotImplementedError('one mesh per scene')
            kind.append(MESH)
            center.append(np.zeros(3))
            v, t, n = mesh_arrays
            mesh = build_mesh(v, t, n, tr, i, device, dtype)
            m = cfg['mesh']
            material = dict(kd=m['kd'], ks=m.get('ks', (0, 0, 0)),
                            ne=m.get('ns', (0, 0, 0)),
                            transp=bool(o.get('transp', False)),
                            refr=float(o.get('refr_index', 1.3)))
        else:
            raise NotImplementedError(f'object type {o["type"]!r}')

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(
            dtype)

    def b(x):
        return torch.as_tensor(x, dtype=torch.bool, device=device)

    if material is not None:
        material = {k: (f(v) if k in ('kd', 'ks', 'ne') else v)
                    for k, v in material.items()}
    return Scene(kind=torch.as_tensor(kind, device=device), center=f(center),
                 radius=f(radius), normal=f(normal), flip=b(flip), kd=f(kd),
                 ks=f(ks), ne=f(ne), transp=b(transp), miroir=b(miroir),
                 refr=f(refr), light_center=f(center[0]),
                 light_radius=f(radius[0]),
                 light_intensity=f(cfg['light_intensity']), mesh=mesh,
                 mesh_material=material)


class _Rows(torch.autograd.Function):
    """table[idx], whose backward sums each row's lanes in float64, row by
    row: indexing's own backward adds the lanes of a row one after another
    in float32 on the card, slow and, over millions of lanes, off by more
    than the program's own sums."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        g64 = g.double()
        out = torch.stack([torch.where((idx == r)[:, None], g64, 0.0).sum(0)
                           for r in range(ctx.n_rows)])
        return out.to(g.dtype), None


def rows(table, idx):
    """Rows `idx` of a small material table, one per lane."""
    return _Rows.apply(table, idx)


def _analytic_t(sc: Scene, o, d):
    """(N, O) hit distances of every analytic row, BIG_T where missed."""
    oc = o[:, None, :] - sc.center[None]
    dd = d[:, None, :]
    b = (dd * oc).sum(-1)
    a = (dd * dd).sum(-1)
    c = (oc * oc).sum(-1) - sc.radius * sc.radius
    delta = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    inva = 1.0 / a
    t2 = (-b + sq) * inva
    t1 = (-b - sq) * inva
    t_s = torch.where(t1 > 0, t1, t2)
    ok_s = (delta >= 0) & (t2 >= 0) & (t_s > 0)
    dn = (dd * sc.normal[None]).sum(-1)
    safe = dn.abs() >= 1e-9
    t_p = ((sc.center[None] - o[:, None, :]) * sc.normal[None]).sum(-1) / \
        torch.where(safe, dn, torch.ones_like(dn))
    ok_p = safe & (t_p > 0)
    big = torch.full_like(t_p, BIG_T)
    return torch.where((sc.kind == SPHERE) & ok_s, t_s,
                       torch.where((sc.kind == PLANE) & ok_p, t_p, big))


def intersect(sc: Scene, o, d) -> dict:
    """Closest hit: hit, t, p, n (unit), obj, kd, ks, ne, transp, miroir,
    refr per ray."""
    t_all = _analytic_t(sc, o, d)
    obj = t_all.argmin(dim=1)
    t = t_all.gather(1, obj[:, None])[:, 0]
    p = o + t[:, None] * d
    cen = sc.center[obj]
    n = torch.where((sc.kind[obj] == SPHERE)[:, None], p - cen,
                    sc.normal[obj])
    n = torch.where(sc.flip[obj][:, None], -n, n)
    out = dict(t=t, p=p, n=_normalize(n), obj=obj, kd=rows(sc.kd, obj),
               ks=rows(sc.ks, obj), ne=rows(sc.ne, obj), transp=sc.transp[obj],
               miroir=sc.miroir[obj], refr=sc.refr[obj])
    m = sc.mesh
    if m is not None:
        ol = o - m.translation
        tm, tri = mesh_closest(m, ol, d, t)
        win = tri >= 0
        vi = m.tris[tri.clamp_min(0)]
        v0 = m.vertices[vi[:, 0]]
        _, u, v = _tri_t(ol, d, v0[:, None],
                         (m.vertices[vi[:, 1]] - v0)[:, None],
                         (m.vertices[vi[:, 2]] - v0)[:, None])
        u = torch.where(win, u[:, 0], torch.zeros_like(t))
        v = torch.where(win, v[:, 0], torch.zeros_like(t))
        nl = _normalize(m.normals[vi[:, 0]] * (1.0 - u - v)[:, None]
                        + m.normals[vi[:, 1]] * u[:, None]
                        + m.normals[vi[:, 2]] * v[:, None])
        pw = (ol + tm[:, None] * d) + m.translation
        mat = sc.mesh_material
        rowv = torch.full_like(obj, m.row)

        def sel(new, old):
            w = win[:, None] if old.dim() == 2 else win
            return torch.where(w, new, old)

        out.update(t=sel(tm, t), p=sel(pw, out['p']), n=sel(nl, out['n']),
                   obj=sel(rowv, obj),
                   kd=sel(mat['kd'].expand_as(out['kd']), out['kd']),
                   ks=sel(mat['ks'].expand_as(out['ks']), out['ks']),
                   ne=sel(mat['ne'].expand_as(out['ne']), out['ne']),
                   transp=sel(torch.full_like(win, mat['transp']),
                              out['transp']),
                   miroir=sel(torch.zeros_like(win), out['miroir']),
                   refr=sel(torch.full_like(t, mat['refr']), out['refr']))
    out['hit'] = out['t'] < BIG_T
    return out


def occluded(sc: Scene, o, d, limit):
    """Any analytic or mesh hit with 0 < t < limit."""
    blocked = (_analytic_t(sc, o, d) < limit[:, None]).any(dim=1)
    m = sc.mesh
    if m is not None:
        blocked = blocked | mesh_any(m, o - m.translation, d, limit)
    return blocked
