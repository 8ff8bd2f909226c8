"""Scene tables and intersection (counterpart of pathtracer_tpu/scene/scene.py).

Analytic objects live in one SoA table; a ray is tested against every row
at once ((N rays) x (O objects) candidate t matrix, masked argmin).  Row 0
is the spherical light, row 1 the environment dome, rows 2+ user objects.
Triangle meshes are bound to a row (its transform and flags) and go
through their mesh's tier (scene/mesh.py): cluster, packet, brute force or
lockstep BVH.

Materials (pathtracer_tpu/scene/scene.py): per-row and per-group texture
channels (models/texture.py, sampled in `intersect` for spheres and planes
and in `_merge_mesh_hit` for meshes), alpha cut-outs (`_mesh_closest_hit`
re-intersects past texels with alpha < 0.5 under a rising strict floor,
on closest-hit and shadow rays), tangent-space normal maps, vertex and
face colours, edge display, the env-map dome (`_envmap_ke`) and measured
BRDF tables (`brdf_type`, evaluated by the integrator).

Participating media and compositing (pathtracer_tpu/scene/scene.py): the
fog parameters and flags, ghost rows (hit by `intersect`, casting no
shadow in `intersect_shadow`), the background photo, and the
subsurface probe `reservoir_same_object`: a uniformly random
intersection with the hit object along a segment, from both quadric roots
of an analytic row, the dense count-then-pick over a small mesh's
triangles, or the crossing march (`_mesh_reservoir_march`) on a big one.

Point sets (scene/pointset.py: disk splats, fluid particle spheres on the
brute or the clustered tier, the transparent fluid's union exit) and
yarns (scene/yarns.py, finite cylinders) are bound to rows like meshes and
folded into `intersect` after them (`_merge_pointset_hit`,
`_merge_yarn_hit`); `intersect_shadow` sweeps them unbounded, as JAX does,
and compares with the light distance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..core import vec
from ..io import image as img_io
from ..io import obj as obj_io
from ..models import texture as tex_mod
from ..ops import cluster
from ..ops import packet_bvh
from ..ops import routed_cluster
from ..ops import traverse
from ..parallel import distributed as pd
from . import mesh as mesh_mod
from . import pointset as ps_mod
from . import yarns as yarn_mod

SPHERE = 0
PLANE = 1
MESH = 2
POINTSET = 3
YARNS = 4

BIG_T = float(np.float32(1e30))


@dataclasses.dataclass
class SceneArrays:
    """Device-side scene: SoA over O analytic objects + light + meshes."""

    obj_type: torch.Tensor       # (O,) int32
    center: torch.Tensor         # (O,3) sphere center / plane point
    radius: torch.Tensor         # (O,)
    normal: torch.Tensor         # (O,3) plane normal
    flip_normals: torch.Tensor   # (O,) bool
    kd: torch.Tensor             # (O,3)
    ks: torch.Tensor
    ne: torch.Tensor
    ksub: torch.Tensor
    transp: torch.Tensor         # (O,) bool
    refr_index: torch.Tensor     # (O,)
    miroir: torch.Tensor         # (O,) bool
    ghost: torch.Tensor          # (O,) bool compositing catchers
    trans: torch.Tensor          # (O,12) row-major 3x4
    inv_trans: torch.Tensor      # (O,12)
    rot: torch.Tensor            # (O,9)
    identity_transform: bool     # translation-only transforms
    light_intensity: torch.Tensor   # 0-d
    light_scale: torch.Tensor       # 0-d
    envmap_intensity: torch.Tensor  # 0-d
    center_light: torch.Tensor      # (3,)
    radius_light: torch.Tensor      # 0-d
    meshes: tuple = ()
    envmap: Any = None           # (He,We,3) dome radiance texture or None
    # per-row texture channels (GroupTextures or None): spheres sample
    # spherical UV (Geometry.h:979-984), planes 0.1*(x,z) (:1152-1154)
    obj_textures: tuple = ()
    brdf_type: Any = None        # (O,) int32: 0 Phong, k+1 measured table k
    measured_brdfs: tuple = ()   # models.merl.MeasuredBRDF tables
    # fog (Geometry.h:1371-1377, Raytracer.cpp:44-192): 0-d tensors, so
    # each can be an autograd leaf; ground level is objects[2]'s y
    fog_density: Any = None
    fog_absorption: Any = None
    fog_density_decay: Any = None
    fog_absorption_decay: Any = None
    phase_aniso: Any = None      # Schlick k
    ground_level: Any = None
    fog_enabled: bool = False
    fog_type: int = 0            # 0 uniform, 1 exponential in height
    fog_phase_type: int = 0      # 0 isotropic, 1 Schlick, 2 Rayleigh
    ss_enabled: bool = False     # some object carries ksub
    # (O,) bool: rows with a subsurface reservoir path; the others opt
    # out of the entry RR so the estimator stays unbiased
    ss_obj_ok: Any = None
    ghost_enabled: bool = False
    # background photo, gamma-linearized and scaled by 196964.699
    # (Geometry.h:1355-1362), or None
    background: Any = None       # (Hb,Wb,3)
    pointsets: tuple = ()        # pointset.PointSetArrays, one per row
    yarns: tuple = ()            # yarns.YarnArrays, one per row

    @property
    def num_objects(self) -> int:
        return self.obj_type.shape[0]

    def replace(self, **fields) -> 'SceneArrays':
        """A copy with `fields` replaced (the JAX package's
        `sc.replace(kd=...)`, the idiom of its gradient examples)."""
        return dataclasses.replace(self, **fields)

    @property
    def light_power(self):
        """intensite_lumiere / scale^2."""
        return self.light_intensity / (self.light_scale * self.light_scale)

    @property
    def device(self):
        return self.center.device

    def to(self, dev) -> 'SceneArrays':
        kw = {f.name: getattr(self, f.name).to(dev)
              for f in dataclasses.fields(self)
              if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(
            self, meshes=tuple(m.to(dev) for m in self.meshes),
            pointsets=tuple(p.to(dev) for p in self.pointsets),
            yarns=tuple(y.to(dev) for y in self.yarns),
            obj_textures=tuple(None if t is None else t.to(dev)
                               for t in self.obj_textures),
            measured_brdfs=tuple(t.to(dev) for t in self.measured_brdfs),
            **kw)


class Hit(NamedTuple):
    """Per-ray closest hit."""

    hit: torch.Tensor         # (N,) bool
    t: torch.Tensor           # (N,)
    p: torch.Tensor           # (N,3) world point
    n: torch.Tensor           # (N,3) unit shading normal
    obj_id: torch.Tensor      # (N,) int64
    kd: torch.Tensor          # (N,3)
    ks: torch.Tensor
    ne: torch.Tensor
    ke: torch.Tensor          # emission (the dome's envmap radiance)
    ksub: torch.Tensor
    transp: torch.Tensor      # (N,) bool
    refr_index: torch.Tensor  # (N,)
    miroir: torch.Tensor      # (N,) bool
    brdf_type: torch.Tensor   # (N,) int32: 0 Phong, k+1 measured table k
    lkey: torch.Tensor        # (N,) int64 surface-locality sort key
    ghost: torch.Tensor       # (N,) bool


def _material(table, idx):
    """Rows `idx` of a small (rows, 3) material table, one per lane.  The
    same gather as table[idx]; its backward sums each row's lanes with
    embedding's segment reduction, where indexing's backward (index_put_
    with accumulate) runs the lanes of each row in one serial loop on the
    card."""
    return torch.nn.functional.embedding(idx, table)


def _local_ray(sc: SceneArrays, origins, dirs):
    """Rays in every object's space as per-coordinate (N,O) planes."""
    ox, oy, oz = origins[:, 0:1], origins[:, 1:2], origins[:, 2:3]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    m = sc.inv_trans
    if sc.identity_transform:
        zero = 0.0 * m[:, 0]
        return ((ox + m[:, 3], oy + m[:, 7], oz + m[:, 11]),
                (dx + zero, dy + zero, dz + zero))
    return ((m[:, 0] * ox + m[:, 1] * oy + m[:, 2] * oz + m[:, 3],
             m[:, 4] * ox + m[:, 5] * oy + m[:, 6] * oz + m[:, 7],
             m[:, 8] * ox + m[:, 9] * oy + m[:, 10] * oz + m[:, 11]),
            (m[:, 0] * dx + m[:, 1] * dy + m[:, 2] * dz,
             m[:, 4] * dx + m[:, 5] * dy + m[:, 6] * dz,
             m[:, 8] * dx + m[:, 9] * dy + m[:, 10] * dz))


def _candidate_ts(sc: SceneArrays, origins, dirs):
    """All candidate hit distances (N, O), BIG_T for misses: the sphere
    quadric's smallest positive root (far root from inside) and the plane
    hit, selected by obj_type."""
    (lox, loy, loz), (ldx, ldy, ldz) = _local_ray(sc, origins, dirs)
    ocx = lox - sc.center[:, 0]
    ocy = loy - sc.center[:, 1]
    ocz = loz - sc.center[:, 2]
    b = ldx * ocx + ldy * ocy + ldz * ocz
    a = ldx * ldx + ldy * ldy + ldz * ldz
    c = ocx * ocx + ocy * ocy + ocz * ocz - sc.radius * sc.radius
    delta = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    inva = 1.0 / a
    t2 = (-b + sq) * inva
    t1 = (-b - sq) * inva
    t_sph = torch.where(t1 > 0.0, t1, t2)
    ok_sph = (delta >= 0.0) & (t2 >= 0.0) & (t_sph > 0.0)

    nx, ny, nz = sc.normal[:, 0], sc.normal[:, 1], sc.normal[:, 2]
    ddot = ldx * nx + ldy * ny + ldz * nz
    safe = ddot.abs() >= 1e-9
    tnum = ((sc.center[:, 0] - lox) * nx + (sc.center[:, 1] - loy) * ny
            + (sc.center[:, 2] - loz) * nz)
    t_pl = tnum / torch.where(safe, ddot, torch.ones_like(ddot))
    ok_pl = safe & (t_pl > 0.0)

    big = torch.full_like(t_pl, BIG_T)
    t = torch.where((sc.obj_type == SPHERE) & ok_sph, t_sph,
                    torch.where((sc.obj_type == PLANE) & ok_pl, t_pl, big))
    return t, (lox, loy, loz), (ldx, ldy, ldz)


def intersect(sc: SceneArrays, origins, dirs) -> Hit:
    """Closest hit over the analytic rows, then every mesh, point set and
    yarn set; ghost rows are hit like any other (`Hit.ghost` marks
    them)."""
    t_all, (lox, loy, loz), (ldx, ldy, ldz) = _candidate_ts(
        sc, origins, dirs)
    obj_id = t_all.argmin(dim=-1)
    t = t_all.gather(1, obj_id[:, None])[:, 0]
    hit = t < BIG_T

    def take(m):
        return m.gather(1, obj_id[:, None])[:, 0]

    px = take(lox) + t * take(ldx)
    py = take(loy) + t * take(ldy)
    pz = take(loz) + t * take(ldz)
    is_sphere = sc.obj_type[obj_id] == SPHERE
    cen = sc.center[obj_id]
    nrm_o = sc.normal[obj_id]
    nl = torch.stack([torch.where(is_sphere, px - cen[:, 0], nrm_o[:, 0]),
                      torch.where(is_sphere, py - cen[:, 1], nrm_o[:, 1]),
                      torch.where(is_sphere, pz - cen[:, 2], nrm_o[:, 2])],
                     dim=-1)
    sgn = torch.where(sc.flip_normals[obj_id], -1.0, 1.0)[:, None]
    nl = sgn * nl
    if sc.identity_transform:
        tr = sc.trans[obj_id]
        p = torch.stack([px + tr[:, 3], py + tr[:, 7], pz + tr[:, 11]],
                        dim=-1)
        n = nl
    else:
        tm = sc.trans[obj_id]
        p = torch.stack([
            tm[:, 0] * px + tm[:, 1] * py + tm[:, 2] * pz + tm[:, 3],
            tm[:, 4] * px + tm[:, 5] * py + tm[:, 6] * pz + tm[:, 7],
            tm[:, 8] * px + tm[:, 9] * py + tm[:, 10] * pz + tm[:, 11],
        ], dim=-1)
        rm = sc.rot[obj_id]
        n = torch.stack([
            rm[:, 0] * nl[:, 0] + rm[:, 1] * nl[:, 1] + rm[:, 2] * nl[:, 2],
            rm[:, 3] * nl[:, 0] + rm[:, 4] * nl[:, 1] + rm[:, 5] * nl[:, 2],
            rm[:, 6] * nl[:, 0] + rm[:, 7] * nl[:, 1] + rm[:, 8] * nl[:, 2],
        ], dim=-1)
    # the outward geometric normal before the flip (Geometry.h:965-971),
    # which the dome's lookup and the sphere UV read
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(vec.norm2(nl), 1e-20))
    n_out = sgn * nl * inv_len[:, None]
    brdf_type = (torch.zeros_like(obj_id, dtype=torch.int32)
                 if sc.brdf_type is None else sc.brdf_type[obj_id])
    if sc.envmap is not None:
        # dome radiance: only row 1 carries the env map (Raytracer.cpp:1258)
        ke = torch.where((obj_id == 1)[:, None],
                         _envmap_ke(sc, n_out[:, 0], n_out[:, 1],
                                    n_out[:, 2]), torch.zeros_like(p))
    else:
        ke = torch.zeros_like(p)
    out = Hit(hit=hit, t=t, p=p, n=vec.normalize(n), obj_id=obj_id,
              kd=_material(sc.kd, obj_id), ks=_material(sc.ks, obj_id),
              ne=_material(sc.ne, obj_id), ke=ke,
              ksub=_material(sc.ksub, obj_id),
              transp=sc.transp[obj_id] & hit,
              refr_index=sc.refr_index[obj_id],
              miroir=sc.miroir[obj_id] & hit, brdf_type=brdf_type,
              lkey=obj_id, ghost=sc.ghost[obj_id] & hit)
    if any(gt is not None and gt.any_image for gt in sc.obj_textures):
        out = _object_textures(sc, out, is_sphere, px, pz, n_out)
    for mesh in sc.meshes:
        out = _merge_mesh_hit(sc, mesh, origins, dirs, out)
    for ps in sc.pointsets:
        out = _merge_pointset_hit(sc, ps, origins, dirs, out)
    for ya in sc.yarns:
        out = _merge_yarn_hit(sc, ya, origins, dirs, out)
    return out


def _to_world(sc: SceneArrays, row: int, p_l, n_l):
    """A row's local hit point and normal in world space."""
    if sc.identity_transform:
        tr = sc.trans[row]
        return p_l + torch.stack([tr[3], tr[7], tr[11]]), n_l
    tr = sc.trans[row].view(3, 4)
    return (p_l @ tr[:, :3].T + tr[:, 3],
            vec.normalize(n_l @ sc.rot[row].view(3, 3).T))


def _merge_row_hit(sc: SceneArrays, row: int, cur: Hit, win, t, p_w, n_w,
                   kd) -> Hit:
    """Fold a point-set or yarn row's hit into the running hit where it
    wins: its point, normal and Kd, the row's other material constants.
    The emission is cleared as a mesh clears it (JAX keeps the running
    hit's, so a point set in front of an env-mapped dome glows with it)."""
    def sel(new, old):
        m = win[:, None] if new.dim() > win.dim() else win
        return torch.where(m, new, old)

    def row3(tbl):
        return tbl[row].expand_as(p_w)

    brdf_row = (torch.zeros((), dtype=torch.int32, device=t.device)
                if sc.brdf_type is None else sc.brdf_type[row])
    return Hit(
        hit=cur.hit | win,
        t=torch.where(win, t, cur.t),
        p=sel(p_w, cur.p),
        n=sel(n_w, cur.n),
        obj_id=torch.where(win, row, cur.obj_id),
        kd=sel(kd, cur.kd),
        ks=sel(row3(sc.ks), cur.ks),
        ne=sel(row3(sc.ne), cur.ne),
        ke=sel(torch.zeros_like(cur.ke), cur.ke),
        ksub=sel(row3(sc.ksub), cur.ksub),
        transp=torch.where(win, sc.transp[row], cur.transp),
        refr_index=torch.where(win, sc.refr_index[row], cur.refr_index),
        miroir=torch.where(win, sc.miroir[row], cur.miroir),
        brdf_type=torch.where(win, brdf_row, cur.brdf_type),
        lkey=torch.where(win, row, cur.lkey),
        ghost=torch.where(win, sc.ghost[row], cur.ghost),
    )


def _merge_yarn_hit(sc: SceneArrays, ya, origins, dirs, cur: Hit) -> Hit:
    """Yarn cylinder closest hit (Yarns::intersection via Cylinder,
    TriangleMesh.h:292-299, Geometry.h:731-846)."""
    row = ya.obj_row
    org_l, dir_l = _local_ray_row(sc, row, origins, dirs)
    t_y, idx, s_ax = yarn_mod.cylinder_sweep(ya, org_l, dir_l, cur.t)
    win = t_y < cur.t
    i = idx.clamp_min(0).long()
    a = torch.stack([ya.ax[i], ya.ay[i], ya.az[i]], dim=-1)
    u = torch.stack([ya.ux[i], ya.uy[i], ya.uz[i]], dim=-1)
    p_l = org_l + t_y[:, None] * dir_l
    n_l = vec.normalize(p_l - a - s_ax[:, None] * u)
    n_l = torch.where(sc.flip_normals[row], -n_l, n_l)
    p_w, n_w = _to_world(sc, row, p_l, n_l)
    return _merge_row_hit(sc, row, cur, win, t_y, p_w, n_w,
                          sc.kd[row].expand_as(p_w))


def _merge_pointset_hit(sc: SceneArrays, ps, origins, dirs, cur: Hit) -> Hit:
    """Point-set closest hit (PointSet::intersection, PointSet.cpp:124-244):
    particle spheres (the transparent fluid's interior rays exit at the
    union boundary) or two-sided disks, per-point colour as Kd, rims
    darkened under display_edges."""
    row = ps.obj_row
    org_l, dir_l = _local_ray_row(sc, row, origins, dirs)
    if ps.as_spheres:
        if ps.n_clusters:
            t_ps, idx = ps_mod.clustered_sphere_sweep(ps, org_l, dir_l,
                                                      cur.t)
        else:
            t_ps, idx = ps_mod.sphere_sweep(ps, org_l, dir_l, cur.t)
        if ps.transparent:
            # rays starting inside the particle union exit at its boundary
            # (fluid.cpp:65-171): refraction at entry and exit only
            if ps.n_clusters:
                t_u, idx_u, inside = ps_mod.clustered_union_exit(
                    ps, org_l, dir_l)
            else:
                t_u, idx_u, inside = ps_mod.sphere_union_exit(ps, org_l,
                                                              dir_l)
            use_u = inside & (t_u < cur.t) & (t_u > 0)
            t_ps = torch.where(use_u, t_u, t_ps)
            idx = torch.where(use_u, idx_u, idx)
    else:
        t_ps, idx = ps_mod.disk_sweep(ps, org_l, dir_l, cur.t)
    win = t_ps < cur.t
    i = idx.clamp_min(0).long()
    p_l = org_l + t_ps[:, None] * dir_l
    cen = torch.stack([ps.px[i], ps.py[i], ps.pz[i]], dim=-1)
    if ps.as_spheres:
        n_l = vec.normalize(p_l - cen)
    else:
        n_l = torch.stack([ps.nx[i], ps.ny[i], ps.nz[i]], dim=-1)
        # two-sided disks (PointSet.cpp:205)
        facing = vec.dot(n_l, dir_l) > 0.0
        n_l = torch.where(facing[:, None], -n_l, n_l)
    n_l = torch.where(sc.flip_normals[row], -n_l, n_l)
    kd = ps.colors[i]
    if ps.display_edges:
        r2 = vec.norm2(p_l - cen)
        r95 = ps.radius[i] * 0.95
        kd = torch.where((r2 > r95 * r95)[:, None], torch.zeros_like(kd), kd)
    p_w, n_w = _to_world(sc, row, p_l, n_l)
    return _merge_row_hit(sc, row, cur, win, t_ps, p_w, n_w, kd)


def _envmap_ke(sc: SceneArrays, nx, ny, nz):
    """Dome radiance lookup (reference: Geometry.h:963-977) for the unit
    outward normal: theta = 1 - acos(N.y)/pi, phi = (atan2(-N.z, N.x) +
    pi) / 2pi, Ke = tex[theta*(H-1), phi*(W-1)] * 100000/255."""
    eh, ew = sc.envmap.shape[0], sc.envmap.shape[1]
    theta = 1.0 - torch.arccos(torch.clamp(ny, -1.0, 1.0)) / np.pi
    phi = (torch.atan2(-nz, nx) + np.pi) / (2.0 * np.pi)
    ti = torch.clamp((theta * (eh - 1)).to(torch.int32), 0, eh - 1)
    pi_ = torch.clamp((phi * (ew - 1)).to(torch.int32), 0, ew - 1)
    return tex_mod.fetch(sc.envmap, ti, pi_) * float(
        np.float32(100000.0 / 255.0))


def _object_textures(sc: SceneArrays, out: Hit, is_sphere, px, pz,
                     n_out) -> Hit:
    """Texture channels of the analytic rows (queryMaterial,
    Geometry.h:399-445: image value x the row's constant): spheres at the
    spherical UV of the pre-flip outward normal, planes at 0.1*(x, z) of
    the object-space point (Geometry.h:979-984, 1152-1154)."""
    u = torch.where(is_sphere,
                    1.0 - torch.arccos(torch.clamp(n_out[:, 1], -1.0, 1.0))
                    / np.pi, px * 0.1)
    v = torch.where(is_sphere,
                    (torch.atan2(-n_out[:, 2], n_out[:, 0]) + np.pi)
                    / (2.0 * np.pi), pz * 0.1)
    fields = {}
    for o, gt in enumerate(sc.obj_textures):
        if gt is None or not gt.any_image:
            continue
        m = (out.obj_id == o) & out.hit

        def over(name, img, mult):
            cur = fields.get(name, getattr(out, name))
            return torch.where(m[:, None],
                               tex_mod.sample_point(img, u, v) * mult, cur)

        for name, ch, tbl in (('kd', 'kd', sc.kd), ('ks', 'ks', sc.ks),
                              ('ne', 'roughness', sc.ne),
                              ('ksub', 'ksub', sc.ksub)):
            if getattr(gt, ch) is not None:
                fields[name] = over(name, getattr(gt, ch), tbl[o])
        if gt.transp is not None:
            # getBool: red x multiplier < 0.5 is transparent; the constant
            # multiplier encodes the flag as 0 (transparent) / 1 (opaque)
            tmult = torch.where(sc.transp[o], 0.0, 1.0)
            tval = tex_mod.sample_red(gt.transp, u, v) * tmult < 0.5
            fields['transp'] = torch.where(m, tval, fields.get(
                'transp', out.transp))
        if gt.refr is not None:
            rval = tex_mod.sample_red(gt.refr, u, v) * sc.refr_index[o]
            fields['refr_index'] = torch.where(m, rval, fields.get(
                'refr_index', out.refr_index))
    return out._replace(**fields)


def _local_ray_row(sc: SceneArrays, row: int, origins, dirs):
    """Rays in one object row's space (directions stay unnormalized, so
    t is transform-invariant)."""
    m = sc.inv_trans[row]
    if sc.identity_transform:
        return origins + torch.stack([m[3], m[7], m[11]]), dirs
    rotm = m.view(3, 4)
    return origins @ rotm[:, :3].T + rotm[:, 3], dirs @ rotm[:, :3].T


def _shade_fetch(mesh, tri):
    """The shade_pack rows of triangles `tri` (a miss, -1, reads row 0).
    A scene-axis partition holds the rows [shard_row0, shard_row0 +
    shard_rows) only: each rank gathers the rows it owns, zeros
    elsewhere, and a sum over the scene group assembles every row (each
    triangle has one owner), as the JAX package's psum does."""
    idx = tri.clamp_min(0).long()
    if mesh.scene_group is None:
        return mesh.shade_pack[idx]
    local = idx - mesh.shard_row0
    mine = (local >= 0) & (local < mesh.shard_rows)
    rows = mesh.shade_pack[local.clamp(0, mesh.shade_pack.shape[0] - 1)]
    rows = torch.where(mine[:, None], rows, torch.zeros_like(rows))
    return pd.group_sum_(rows, mesh.scene_group)


def _bary_from_pack(mesh, org_l, dir_l, t, tri, sf=None):
    """Winner barycentrics from the shade_pack 'bary' columns
    (a(3) u(3) v(3) m11 m12 m22 invdet), edge-matrix formula; pass the
    rows already fetched as `sf`."""
    if sf is None:
        sf = _shade_fetch(mesh, tri)
    bb = sf[:, mesh.col('bary')]
    p_b = org_l + t[:, None] * dir_l
    pxv = p_b - bb[:, 0:3]
    b11 = vec.dot(pxv, bb[:, 3:6])
    b21 = vec.dot(pxv, bb[:, 6:9])
    be = (b11 * bb[:, 11] - b21 * bb[:, 10]) * bb[:, 12]
    ga = (b21 * bb[:, 9] - b11 * bb[:, 10]) * bb[:, 12]
    hitl = tri >= 0
    be = torch.where(hitl, be, torch.zeros_like(be))
    ga = torch.where(hitl, ga, torch.zeros_like(ga))
    return 1.0 - be - ga, be, ga


def _mesh_uv(mesh, sf, al, be, ga):
    """Interpolated texture coordinates (TriangleMesh.cpp:930-931); zero
    on a mesh without uv columns (nothing samples them there)."""
    if mesh.col('uv0') is None:
        z = torch.zeros_like(al)
        return z, z
    uv = (sf[:, mesh.col('uv0')] * al[:, None]
          + sf[:, mesh.col('uv1')] * be[:, None]
          + sf[:, mesh.col('uv2')] * ga[:, None])
    return uv[:, 0], uv[:, 1]


def _shade_grp(mesh, sf):
    """Winning triangle's material group, int64 (0 on one-group meshes)."""
    gcol = mesh.col('grp')
    if gcol is None:
        return torch.zeros(sf.shape[0], dtype=torch.int64, device=sf.device)
    return sf[:, gcol][:, 0].contiguous().view(torch.int32).long()


def _sampler(mesh):
    return (tex_mod.sample_bilinear if mesh.bilinear
            else tex_mod.sample_point)


def _atlas(mesh, ch):
    return mesh.atlases[tex_mod.CHANNELS.index(ch)] if mesh.atlases else None


def _mesh_alpha(mesh, tri, al, be, ga):
    """Per-lane alpha-map red value; 1.0 where the group has no map
    (TriangleMesh.cpp:1199-1205)."""
    sf = _shade_fetch(mesh, tri)
    u, v = _mesh_uv(mesh, sf, al, be, ga)
    grp = _shade_grp(mesh, sf)
    aval = torch.ones_like(al)
    at = _atlas(mesh, 'alpha')
    if at is not None:
        val, has = tex_mod.sample_atlas(at, grp, u, v, mesh.bilinear)
        return torch.where(has, val[:, 0], aval)
    samp = _sampler(mesh)
    for g, gt in enumerate(mesh.textures):
        if gt.alpha is not None:
            aval = torch.where(grp == g, samp(gt.alpha, u, v)[:, 0], aval)
    return aval


def _one_hit(mesh, org_l, dir_l, t_max, t_min=None, backface=None):
    """One closest-hit query of one mesh in its own space, by its tier:
    (t — t_max on a miss —, tri, barycentrics (alpha, beta, gamma), or
    None where the cluster tier leaves them to the shade_pack).  t_min:
    an optional per-lane strict floor; backface: the cluster tier's cull
    (None: the mesh's own flag)."""
    if mesh.use_cluster:
        cm = mesh.clustered
        if mesh.use_routed:
            # routed per-lane sweeps, no backface cull (as in JAX); the
            # residual lanes re-traverse the lockstep BVH on either tier
            t, tri, res = routed_cluster.routed_hit(
                cm, org_l, dir_l, t_max, tmin=t_min, return_residual=True,
                with_bary=False)
            t, tri, _, _ = traverse.bvh_hit_sparse(
                mesh.bvh, mesh.soup, org_l, dir_l, res, mesh.max_leaf, t,
                tri, torch.ones_like(t), torch.zeros_like(t), t_min=t_min)
            return t, tri, None
        bf = mesh.backface_cull if backface is None else bool(backface)
        if cm.n_clusters <= cluster.DENSE_CULL_MAX:
            # the windowed rounds leave no residual lane
            t, tri = cluster.two_level_hit(cm, org_l, dir_l, t_max,
                                           tmin=t_min, backface_cull=bf)
            if mesh.scene_group is not None:
                # a scene-axis partition: tri ids are global, so the
                # partitions' winners combine by t
                t, tri = pd.group_closest(t, tri, mesh.scene_group)
            return t, tri, None
        # tree tier: residual lanes re-traverse the lockstep BVH
        t, tri, res = cluster.two_level_hit(
            cm, org_l, dir_l, t_max, tmin=t_min, backface_cull=bf,
            return_residual=True)
        t, tri, _, _ = traverse.bvh_hit_sparse(
            mesh.bvh, mesh.soup, org_l, dir_l, res, mesh.max_leaf, t, tri,
            torch.ones_like(t), torch.zeros_like(t), t_min=t_min)
        return t, tri, None
    if mesh.use_packet:
        t, tri, al, be = packet_bvh.packet_hit(mesh.packed, mesh.soup, org_l,
                                               dir_l, t_max, tmin=t_min)
        return t, tri, (al, be, 1.0 - al - be)
    if mesh.use_brute:
        mh = traverse.brute_force_hit(mesh.soup, org_l, dir_l, t_max=t_max,
                                      t_min=t_min)
    else:
        mh = traverse.bvh_hit(mesh.bvh, mesh.soup, org_l, dir_l,
                              max_leaf=mesh.max_leaf, t_init=t_max,
                              t_min=t_min)
    return mh.t, mh.tri, (mh.alpha, mh.beta, mh.gamma)


# Cut-out instrumentation: a list here receives, per cut-out query,
# {'lanes': lanes pending at the start of each round it ran, 'left':
# lanes still cut out after its last round} (off: None).
CUTOUT_LOG = None


def _mesh_closest_hit(mesh, org_l, dir_l, t_max, t_min=None, backface=None):
    """Closest hit of one mesh honouring alpha cut-outs
    (pallas scene._mesh_closest_hit): a hit on a texel with alpha < 0.5 is
    skipped by querying again with a per-lane strict floor at its t, up to
    mesh.cutout_rounds queries (the reference skips such texels inside
    its leaf loop, TriangleMesh.cpp:1199-1205).  Every lane takes every
    round, as in JAX; once no lane is pending a further round could change
    nothing, so the rounds stop there.  A lane still cut out after the
    last round keeps t = BIG_T (no hit).  t_min: a per-lane strict floor
    the rounds start from (the reservoir march's); backface: as in
    _one_hit.  Returns (t, tri, barycentrics or None as _one_hit)."""
    if not mesh.has_alpha:
        return _one_hit(mesh, org_l, dir_l, t_max, t_min, backface)
    n = org_l.shape[0]
    dev = org_l.device
    acc_t = torch.full((n,), BIG_T, device=dev)
    acc_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    acc_b = (torch.ones((n,), device=dev), torch.zeros((n,), device=dev),
             torch.zeros((n,), device=dev))
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    t_floor = (torch.full((n,), -1.0, device=dev) if t_min is None
               else t_min.expand(n))
    pending = [n]
    for r in range(mesh.cutout_rounds):
        t, tri, bary = _one_hit(mesh, org_l, dir_l, t_max, t_floor, backface)
        if bary is None:
            al, be, _ = _bary_from_pack(mesh, org_l, dir_l, t, tri)
            bary = (al, be, 1.0 - al - be)
        found = t < t_max
        cutout = found & (_mesh_alpha(mesh, tri, *bary) < 0.5) & ~done
        accept = ~done & ~cutout
        acc_t = torch.where(accept, t, acc_t)
        acc_tri = torch.where(accept, tri, acc_tri)
        acc_b = tuple(torch.where(accept, x, y) for x, y in zip(bary, acc_b))
        done = done | accept
        t_floor = torch.where(cutout, t, t_floor)
        left = int((~done).sum())
        if left == 0 or r + 1 == mesh.cutout_rounds:
            break
        pending.append(left)
    if CUTOUT_LOG is not None:
        CUTOUT_LOG.append({'lanes': pending, 'left': left})
    return acc_t, acc_tri, acc_b


def _normal_mapped(mesh, sf, grp, u, v, al, be, ga, n_l):
    """Tangent-space normal mapping (TriangleMesh.cpp:952-970)."""
    tangent = vec.normalize(sf[:, mesh.col('t0')] * al[:, None]
                            + sf[:, mesh.col('t1')] * be[:, None]
                            + sf[:, mesh.col('t2')] * ga[:, None])
    bitangent = vec.cross(n_l, tangent)

    def perturb(ns_loc, n_l):
        ns = (ns_loc[:, 0:1] * tangent + ns_loc[:, 1:2] * bitangent
              + ns_loc[:, 2:3] * n_l)
        degenerate = vec.norm2(ns) < 1e-20
        return torch.where(degenerate[:, None], n_l, vec.normalize(ns))

    at = _atlas(mesh, 'normal')
    if at is not None:
        ns_loc, has = tex_mod.sample_atlas(at, grp, u, v, mesh.bilinear)
        return torch.where(has[:, None], perturb(ns_loc, n_l), n_l)
    samp = _sampler(mesh)
    for g, gt in enumerate(mesh.textures):
        if gt.normal is not None:
            n_l = torch.where((grp == g)[:, None],
                              perturb(samp(gt.normal, u, v), n_l), n_l)
    return n_l


def _mesh_material(mesh, sf, grp, u, v, al, be, ga):
    """kd, ks, ne, ksub, transp, refr of the winning lanes: group constants
    x optional images (queryMaterial, Geometry.h:399-445), then vertex
    colours, face colours and edge display."""
    n = sf.shape[0]
    if mesh.g_kd.shape[0] == 1:
        def mat(tbl):
            return tbl[0].expand((n,) + tbl.shape[1:])
    else:
        def mat(tbl):
            return _material(tbl, grp) if tbl.dim() == 2 else tbl[grp]
    kd, ks, ne, ksub = (mat(mesh.g_kd), mat(mesh.g_ks), mat(mesh.g_ne),
                        mat(mesh.g_ksub))
    transp, refr = mat(mesh.g_transp), mat(mesh.g_refr)
    scaled = (('kd', 'kd', mesh.g_kd), ('ks', 'ks', mesh.g_ks),
              ('ne', 'roughness', mesh.g_ne), ('ksub', 'ksub', mesh.g_ksub))
    out = dict(kd=kd, ks=ks, ne=ne, ksub=ksub)
    if mesh.atlases:
        # one gather per imaged channel, any group count
        for name, ch, tbl in scaled:
            at = _atlas(mesh, ch)
            if at is not None:
                val, has = tex_mod.sample_atlas(at, grp, u, v, mesh.bilinear)
                out[name] = torch.where(has[:, None],
                                        val * _material(tbl, grp), out[name])
        at = _atlas(mesh, 'transp')
        if at is not None:
            # getBool: red x multiplier < 0.5 is transparent; the group
            # flag encodes the multiplier 0 / 1 (Geometry.h:432-436)
            val, has = tex_mod.sample_atlas(at, grp, u, v, mesh.bilinear)
            tmult = torch.where(mesh.g_transp[grp], 0.0, 1.0)
            transp = torch.where(has, val[:, 0] * tmult < 0.5, transp)
        at = _atlas(mesh, 'refr')
        if at is not None:
            # getValRed: red x multiplier (Geometry.h:437-441)
            val, has = tex_mod.sample_atlas(at, grp, u, v, mesh.bilinear)
            refr = torch.where(has, val[:, 0] * mesh.g_refr[grp], refr)
    else:
        samp = _sampler(mesh)
        for g, gt in enumerate(mesh.textures):
            sel = grp == g
            for name, ch, tbl in scaled:
                if getattr(gt, ch) is not None:
                    out[name] = torch.where(
                        sel[:, None], samp(getattr(gt, ch), u, v) * tbl[g],
                        out[name])
            if gt.transp is not None:
                tmult = torch.where(mesh.g_transp[g], 0.0, 1.0)
                tval = samp(gt.transp, u, v)[:, 0] * tmult < 0.5
                transp = torch.where(sel, tval, transp)
            if gt.refr is not None:
                rval = samp(gt.refr, u, v)[:, 0] * mesh.g_refr[g]
                refr = torch.where(sel, rval, refr)
    kd = out['kd']
    if mesh.col('vc0') is not None:
        # vertex-colour override (TriangleMesh.cpp:975-977)
        kd = (sf[:, mesh.col('vc0')] * al[:, None]
              + sf[:, mesh.col('vc1')] * be[:, None]
              + sf[:, mesh.col('vc2')] * ga[:, None])
    if mesh.col('fc') is not None:
        # .seg / .lab overlay replaces Kd outright (TriangleMesh.cpp:988-990)
        kd = sf[:, mesh.col('fc')]
    if mesh.display_edges and mesh.col('ec') is not None:
        # per-edge CSV colours (TriangleMesh.cpp:991-1014): a barycentric
        # < 0.05 takes the crossed edge's colour, black if unmapped; the
        # last matching test wins (alpha, then beta, then gamma)
        ec = sf[:, mesh.col('ec')].reshape(-1, 3, 3)
        em = sf[:, mesh.col('em')] != 0.0
        sel_c = torch.zeros_like(kd)
        on_edge = torch.zeros_like(al, dtype=torch.bool)
        for cond, slot in (((al < 0.05), 1), ((be < 0.05), 2),
                           ((ga < 0.05), 0)):
            col = torch.where(em[:, slot, None], ec[:, slot],
                              torch.zeros_like(kd))
            sel_c = torch.where(cond[:, None], col, sel_c)
            on_edge = on_edge | cond
        kd = torch.where(on_edge[:, None], sel_c, kd)
    elif mesh.display_edges:
        # wireframe: black near real polygon borders, a barycentric < 0.05
        # against the opposite edge's flag (TriangleMesh.cpp:1015-1021)
        se = sf[:, mesh.col('se')] != 0.0
        edge = (((al < 0.05) & se[:, 1]) | ((be < 0.05) & se[:, 2])
                | ((ga < 0.05) & se[:, 0]))
        kd = torch.where(edge[:, None], torch.zeros_like(kd), kd)
    return kd, out['ks'], out['ne'], out['ksub'], transp, refr


def _merge_mesh_hit(sc: SceneArrays, mesh, origins, dirs, cur: Hit) -> Hit:
    """Intersect one mesh (closest hit pruned by the running best t) and
    fold it into the running hit, with its shading from one shade_pack
    row gather."""
    row = mesh.obj_row
    if mesh.world_space:
        # merged mesh: per-lane object state by group -> source row
        org_l, dir_l = origins, dirs
    else:
        org_l, dir_l = _local_ray_row(sc, row, origins, dirs)
    t, tri, bary = _mesh_closest_hit(mesh, org_l, dir_l, cur.t)
    sf = _shade_fetch(mesh, tri)
    win = t < cur.t
    if bary is None:
        bary = _bary_from_pack(mesh, org_l, dir_l, t, tri, sf)
    al, be, ga = traverse.bary_cleanup(*bary)
    if mesh.interp_normals:
        s0, s1, s2 = mesh.col('n0'), mesh.col('n1'), mesh.col('n2')
        n_l = (sf[:, s0] * al[:, None] + sf[:, s1] * be[:, None]
               + sf[:, s2] * ga[:, None])
    else:
        n_l = sf[:, mesh.col('fn')]
    n_l = vec.normalize(n_l)
    grp = _shade_grp(mesh, sf)
    if mesh.group_rows is None:
        row_lane = torch.full_like(grp, row)

        def obj(tbl):
            return tbl[row]
    else:
        row_lane = mesh.group_rows[grp]

        def obj(tbl):
            return tbl[row_lane]
    u, v = _mesh_uv(mesh, sf, al, be, ga)
    if mesh.col('t0') is not None:
        n_l = _normal_mapped(mesh, sf, grp, u, v, al, be, ga, n_l)
    flip = obj(sc.flip_normals)
    n_l = torch.where(flip[:, None] if flip.dim() else flip, -n_l, n_l)
    p_l = org_l + t[:, None] * dir_l
    if mesh.world_space:
        p_w, n_w = p_l, n_l
    elif sc.identity_transform:
        tr = sc.trans[row]
        p_w = p_l + torch.stack([tr[3], tr[7], tr[11]])
        n_w = n_l
    else:
        tr = sc.trans[row].view(3, 4)
        p_w = p_l @ tr[:, :3].T + tr[:, 3]
        n_w = vec.normalize(n_l @ sc.rot[row].view(3, 3).T)
    kd, ks, ne, ksub, transp, refr = _mesh_material(mesh, sf, grp, u, v,
                                                    al, be, ga)

    ghost = obj(sc.ghost)

    def sel(new, old):
        m = win[:, None] if new.dim() > win.dim() else win
        return torch.where(m, new, old)

    brdf_row = (torch.zeros((), dtype=torch.int32, device=t.device)
                if sc.brdf_type is None else obj(sc.brdf_type))
    tris_per_cluster = max(1, -(-mesh.num_triangles // max(mesh.n_clusters,
                                                           1)))
    lkey = torch.clamp_max(tri.long() // tris_per_cluster, 8191)
    return Hit(
        hit=cur.hit | win,
        t=torch.where(win, t, cur.t),
        p=sel(p_w, cur.p),
        n=sel(n_w, cur.n),
        obj_id=torch.where(win, row_lane, cur.obj_id),
        kd=sel(kd, cur.kd),
        ks=sel(ks, cur.ks),
        ne=sel(ne, cur.ne),
        ke=sel(torch.zeros_like(cur.ke), cur.ke),
        ksub=sel(ksub, cur.ksub),
        transp=torch.where(win, transp, cur.transp),
        refr_index=torch.where(win, refr, cur.refr_index),
        miroir=torch.where(win, obj(sc.miroir), cur.miroir),
        brdf_type=torch.where(win, brdf_row, cur.brdf_type),
        lkey=torch.where(win, lkey, cur.lkey),
        ghost=torch.where(win, ghost, cur.ghost),
    )


def intersect_shadow(sc: SceneArrays, origins, dirs, dist_light):
    """Any hit within 0.999 * dist_light.  Returns bool (N,).  A mesh with
    an alpha map takes the closest-hit path bounded by that limit, so its
    cut-out texels do not occlude (TriangleMesh.cpp:1299-1305).  Ghost
    rows cast no shadow (a ghost mesh is not queried)."""
    limit = dist_light * 0.999
    t_all = _candidate_ts(sc, origins, dirs)[0]
    if sc.ghost_enabled:
        t_all = torch.where(sc.ghost, BIG_T, t_all)
    blocked = (t_all < limit[:, None]).any(dim=-1)
    for mesh in sc.meshes:
        if sc.ghost_enabled and bool(sc.ghost[mesh.obj_row]):
            continue
        if mesh.world_space:
            org_l, dir_l = origins, dirs
        else:
            org_l, dir_l = _local_ray_row(sc, mesh.obj_row, origins, dirs)
        if mesh.use_cluster and not mesh.has_alpha:
            occ = cluster.two_level_any(mesh.clustered, org_l, dir_l, limit,
                                        backface_cull=mesh.backface_cull)
            if mesh.scene_group is not None:
                # occlusion is an OR over the scene axis' partitions
                occ = pd.group_sum_(occ.to(torch.int32), mesh.scene_group) > 0
            blocked |= occ
        elif mesh.has_alpha or mesh.use_packet:
            # closest hit bounded by the limit (t is transform-invariant,
            # dir_l unnormalized); the packet tier has no any-hit variant
            blocked |= _mesh_closest_hit(mesh, org_l, dir_l, limit)[0] < limit
        elif mesh.use_brute:
            blocked |= traverse.brute_force_any(mesh.soup, org_l, dir_l,
                                                limit)
        else:
            blocked |= traverse.bvh_hit(mesh.bvh, mesh.soup, org_l, dir_l,
                                        max_leaf=mesh.max_leaf,
                                        any_hit_limit=limit).t < limit
    # point and yarn sets: the closest hit over all of it (unbounded, as
    # JAX sweeps them) against the limit
    big = torch.full_like(limit, BIG_T)
    for ps in sc.pointsets:
        if sc.ghost_enabled and bool(sc.ghost[ps.obj_row]):
            continue
        org_l, dir_l = _local_ray_row(sc, ps.obj_row, origins, dirs)
        if not ps.as_spheres:
            sweep = ps_mod.disk_sweep
        elif ps.n_clusters:
            sweep = ps_mod.clustered_sphere_sweep
        else:
            sweep = ps_mod.sphere_sweep
        blocked |= sweep(ps, org_l, dir_l, big)[0] < limit
    for ya in sc.yarns:
        if sc.ghost_enabled and bool(sc.ghost[ya.obj_row]):
            continue
        org_l, dir_l = _local_ray_row(sc, ya.obj_row, origins, dirs)
        blocked |= yarn_mod.cylinder_sweep(ya, org_l, dir_l, big)[0] < limit
    return blocked


# ---------------------------------------------------------------------------
# Subsurface probe: a uniformly random intersection with the same object
# ---------------------------------------------------------------------------

class ProbeHit(NamedTuple):
    """Result of the restricted reservoir probe (subsurface exit point)."""

    found: torch.Tensor     # (N,) bool
    t: torch.Tensor         # (N,)
    p: torch.Tensor         # (N,3) world
    n: torch.Tensor         # (N,3) unit shading normal (world)
    ksub: torch.Tensor      # (N,3) the hit row's ksub
    # lanes whose crossing march found more than RESERVOIR_MAX_CROSSINGS
    # crossings (reported found=False: a biased miss, counted by the
    # integrator as the ss_reservoir_overflow stat)
    overflow: torch.Tensor  # (N,) bool


MESH_RESERVOIR_MAX_TRIS = 65536   # dense count-then-pick cost cap
RESERVOIR_MAX_CROSSINGS = 16      # crossing-march slot budget (big meshes)


def _mesh_reservoir_supported(mesh) -> bool:
    """Every mesh tier has a reservoir path (pallas
    _mesh_reservoir_supported): the dense count-then-pick up to
    MESH_RESERVOIR_MAX_TRIS triangles with a soup, the crossing march
    otherwise (reference: TriangleMesh.cpp:1321-1428)."""
    return True

# March instrumentation: a list here receives, per march, {'lanes': lanes
# still active entering each round, 'overflow_round': lanes re-queried
# after the last slot (0: no such round), 'overflow': lanes flagged}
# (off: None).
MARCH_LOG = None


def _mesh_reservoir_march(mesh, org_m, dir_m, tmax, u,
                          max_cross=RESERVOIR_MAX_CROSSINGS):
    """Uniform random intersection with a big mesh along [0, tmax)
    (pallas scene._mesh_reservoir_march): march the mesh's closest-hit
    query with a rising strict floor and the backface cull off (a probe
    travels inside the surface), recording each crossing into one of
    max_cross slots, then pick the floor(u * count)-th crossing in
    ascending t (the distribution of the reference's sequential
    reservoir, TriangleMesh.cpp:1321-1428).  Every lane takes every round,
    as in JAX; the rounds stop once no lane found a crossing.

    Overflow: a lane still finding crossings in the last slot round is
    queried once more; only a lane that this further round still finds
    overflowed (found=False).  JAX flags every lane active after the last
    round, so a lane with exactly max_cross crossings, all recorded, is a
    miss there and a hit here.
    Returns (found, t, tri, alpha, beta, gamma, overflow)."""
    n = org_m.shape[0]
    dev = org_m.device
    big = tmax.expand(n)
    t_floor = torch.full((n,), -1.0, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    ts, tris, als, bes, lanes = [], [], [], [], []

    def query(floor):
        t, tri, bary = _mesh_closest_hit(mesh, org_m, dir_m, big, t_min=floor,
                                         backface=False)
        if bary is None:
            bary = _bary_from_pack(mesh, org_m, dir_m, t, tri)
        return t, tri, bary[0], bary[1]

    for _ in range(max_cross):
        if MARCH_LOG is not None:
            lanes.append(int(active.sum()))
        t, tri, al, be = query(t_floor)
        found = active & (t < big)
        ts.append(torch.where(found, t, torch.full_like(t, BIG_T)))
        tris.append(torch.where(found, tri, torch.full_like(tri, -1)))
        als.append(al)
        bes.append(be)
        t_floor = torch.where(found, t, t_floor)
        active = found
        if not bool(active.any()):
            break
    overflow = torch.zeros_like(active)
    extra = 0
    if len(ts) == max_cross and bool(active.any()):
        extra = int(active.sum())
        overflow = active & (query(t_floor)[0] < big)
    if MARCH_LOG is not None:
        MARCH_LOG.append({'lanes': lanes, 'overflow_round': extra,
                          'overflow': int(overflow.sum())})
    ts, tris = torch.stack(ts), torch.stack(tris)
    count = (ts < big[None, :]).sum(dim=0)
    found = (count > 0) & ~overflow
    target = torch.minimum(
        torch.floor(u * count.to(torch.float32)).to(torch.int64).clamp_min(0),
        (count - 1).clamp_min(0))[None, :]

    def pick(x):
        return x.gather(0, target)[0]

    al = pick(torch.stack(als))
    be = pick(torch.stack(bes))
    return (found, pick(ts), pick(tris).clamp_min(0), al, be, 1.0 - al - be,
            overflow)


def _mesh_normal(mesh, tri, al, be, ga):
    """Interpolated vertex normal of triangle `tri` at (al, be, ga), the
    face normal on a mesh without vertex-normal columns (not normalized)."""
    sf = _shade_fetch(mesh, tri)
    if mesh.col('n0') is None:
        return sf[:, mesh.col('fn')]
    return (sf[:, mesh.col('n0')] * al[:, None]
            + sf[:, mesh.col('n1')] * be[:, None]
            + sf[:, mesh.col('n2')] * ga[:, None])


def _mesh_reservoir_dense(mesh, org_m, dir_m, tmax, u, chunk=2048):
    """Count-then-pick over every triangle of a small mesh, in 2,048-
    triangle chunks (pallas reservoir_same_object's dense path): the
    floor(u * count)-th triangle hit in [0, tmax), in soup order.
    Returns (count, t, tri, alpha, beta, gamma)."""
    n = org_m.shape[0]
    dev = org_m.device
    soup = mesh.soup
    t_total = soup.ax.shape[0]
    mcount = torch.zeros((n,), dtype=torch.int64, device=dev)
    for start in range(0, t_total, chunk):
        tt = traverse._tri_test_block(
            soup, slice(start, min(start + chunk, t_total)), org_m, dir_m)[0]
        mcount = mcount + ((tt >= 0.0) & (tt < tmax[:, None])).sum(dim=-1)
    target = torch.floor(u * mcount.to(torch.float32)).to(torch.int64)
    runner = torch.zeros_like(mcount)
    mt = torch.zeros((n,), device=dev)
    mtri = torch.zeros((n,), dtype=torch.int64, device=dev)
    for start in range(0, t_total, chunk):
        tt = traverse._tri_test_block(
            soup, slice(start, min(start + chunk, t_total)), org_m, dir_m)[0]
        valid = (tt >= 0.0) & (tt < tmax[:, None])
        idx_in = valid.long().cumsum(dim=-1) - 1 + runner[:, None]
        want = valid & (idx_in == target[:, None])
        anyw = want.any(dim=-1)
        j = want.to(torch.int32).argmax(dim=-1)
        mt = torch.where(anyw, tt.gather(1, j[:, None])[:, 0], mt)
        mtri = torch.where(anyw, j + start, mtri)
        runner = runner + valid.sum(dim=-1)
    _, a3, b3, g3 = traverse._tri_test_lane(soup, mtri, org_m, dir_m)
    return mcount, mt, mtri, a3, b3, g3


def reservoir_same_object(sc: SceneArrays, origins, dirs, tmax, obj_id, u):
    """Uniformly random intersection with the same object along [0, tmax)
    (pallas reservoir_same_object; reference Geometry.cpp:339-472 with
    sphere_id != -1): count-then-pick with one uniform per lane.  Analytic
    rows contribute both quadric roots (or the plane hit); a mesh of at
    most MESH_RESERVOIR_MAX_TRIS triangles that keeps its soup takes the
    dense count-then-pick, any other mesh the crossing march.  As in JAX,
    every mesh is probed for every lane and the result kept on the lanes
    whose obj_id is its row.  Mesh normals: the interpolated vertex
    normals, or the face normal on a mesh uploaded with
    interp_normals=False (JAX's dense path reads vertex normals there)."""
    n = origins.shape[0]
    device_mod.refuse_grad('reservoir_same_object', origins, dirs, tmax)
    _, (lox, loy, loz), (ldx, ldy, ldz) = _candidate_ts(sc, origins, dirs)
    ocx = lox - sc.center[:, 0]
    ocy = loy - sc.center[:, 1]
    ocz = loz - sc.center[:, 2]
    b = ldx * ocx + ldy * ocy + ldz * ocz
    a = ldx * ldx + ldy * ldy + ldz * ldz
    c = ocx * ocx + ocy * ocy + ocz * ocz - sc.radius * sc.radius
    delta = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    inva = 1.0 / a
    s_t1 = (-b - sq) * inva
    s_t2 = (-b + sq) * inva
    ok_sph = delta >= 0.0
    nx, ny, nz = sc.normal[:, 0], sc.normal[:, 1], sc.normal[:, 2]
    ddot = ldx * nx + ldy * ny + ldz * nz
    safe = ddot.abs() >= 1e-9
    p_t = (((sc.center[:, 0] - lox) * nx + (sc.center[:, 1] - loy) * ny
            + (sc.center[:, 2] - loz) * nz)
           / torch.where(safe, ddot, torch.ones_like(ddot)))
    is_sphere = sc.obj_type == SPHERE
    is_plane = sc.obj_type == PLANE
    row_sel = (torch.arange(sc.num_objects, device=obj_id.device)[None, :]
               == obj_id[:, None])

    def gather(m):
        return torch.where(row_sel, m, torch.zeros_like(m)).sum(dim=1)

    def gatherb(m):
        return (row_sel & m).any(dim=1)

    zero = torch.zeros_like(s_t2)
    c1_t = gather(torch.where(is_sphere, s_t1, p_t))
    c2_t = gather(torch.where(is_sphere, s_t2, zero))
    c1_ok = gatherb((is_sphere & ok_sph) | (is_plane & safe))
    c2_ok = gatherb(is_sphere & ok_sph)
    c1_ok = c1_ok & (c1_t >= 0.0) & (c1_t < tmax)
    c2_ok = c2_ok & (c2_t >= 0.0) & (c2_t < tmax)
    count = c1_ok.long() + c2_ok.long()
    pick2 = (torch.floor(u * count.to(torch.float32)).long() >= c1_ok.long())
    take2 = c2_ok & (pick2 | ~c1_ok)
    t_sel = torch.where(take2, c2_t, c1_t)
    found = count > 0
    lo = torch.stack([gather(lox), gather(loy), gather(loz)], dim=-1)
    ld = torch.stack([gather(ldx), gather(ldy), gather(ldz)], dim=-1)
    p_l = lo + t_sel[:, None] * ld
    n_l = torch.where((sc.obj_type[obj_id] == SPHERE)[:, None],
                      p_l - sc.center[obj_id], sc.normal[obj_id])
    n_l = torch.where(sc.flip_normals[obj_id][:, None], -n_l, n_l)

    overflow = torch.zeros((n,), dtype=torch.bool, device=origins.device)
    for mesh in sc.meshes:
        row = mesh.obj_row
        org_m, dir_m = _local_ray_row(sc, row, origins, dirs)
        lane_on_mesh = obj_id == row
        if mesh.num_triangles > MESH_RESERVOIR_MAX_TRIS or mesh.soup is None:
            found_m, mt, mtri, a3, b3, g3, ov_m = _mesh_reservoir_march(
                mesh, org_m, dir_m, tmax, u)
            overflow = overflow | (lane_on_mesh & ov_m)
        else:
            mcount, mt, mtri, a3, b3, g3 = _mesh_reservoir_dense(
                mesh, org_m, dir_m, tmax, u)
            found_m = mcount > 0
        n_m = _mesh_normal(mesh, mtri, a3, b3, g3)
        m_found = lane_on_mesh & found_m
        found = torch.where(lane_on_mesh, m_found, found)
        t_sel = torch.where(m_found, mt, t_sel)
        p_l = torch.where(m_found[:, None], org_m + mt[:, None] * dir_m, p_l)
        n_l = torch.where(m_found[:, None], n_m, n_l)

    if sc.identity_transform:
        tr = sc.trans[obj_id]
        p_w = p_l + torch.stack([tr[:, 3], tr[:, 7], tr[:, 11]], dim=-1)
        n_w = vec.normalize(n_l)
    else:
        tm = sc.trans[obj_id]
        p_w = torch.stack([
            tm[:, 0] * p_l[:, 0] + tm[:, 1] * p_l[:, 1] + tm[:, 2] * p_l[:, 2]
            + tm[:, 3],
            tm[:, 4] * p_l[:, 0] + tm[:, 5] * p_l[:, 1] + tm[:, 6] * p_l[:, 2]
            + tm[:, 7],
            tm[:, 8] * p_l[:, 0] + tm[:, 9] * p_l[:, 1] + tm[:, 10] * p_l[:, 2]
            + tm[:, 11]], dim=-1)
        rm = sc.rot[obj_id]
        n_w = vec.normalize(torch.stack([
            rm[:, 0] * n_l[:, 0] + rm[:, 1] * n_l[:, 1] + rm[:, 2] * n_l[:, 2],
            rm[:, 3] * n_l[:, 0] + rm[:, 4] * n_l[:, 1] + rm[:, 5] * n_l[:, 2],
            rm[:, 6] * n_l[:, 0] + rm[:, 7] * n_l[:, 1] + rm[:, 8] * n_l[:, 2],
        ], dim=-1))
    return ProbeHit(found=found, t=t_sel, p=p_w, n=n_w,
                    ksub=_material(sc.ksub, obj_id), overflow=overflow)



# ---------------------------------------------------------------------------
# Host-side scene building
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ObjectSpec:
    """Host-side description of one object (builder input); the same
    fields as the JAX package's ObjectSpec."""

    obj_type: int
    center: Any = (0.0, 0.0, 0.0)
    radius: float = 1.0
    normal: Any = (0.0, 1.0, 0.0)
    flip_normals: bool = False
    kd: Any = (1.0, 1.0, 1.0)
    ks: Any = (0.0, 0.0, 0.0)
    ne: Any = (1.0, 1.0, 1.0)
    ksub: Any = (0.0, 0.0, 0.0)
    transp: bool = False
    refr_index: float = 1.3
    miroir: bool = False
    ghost: bool = False
    translation: Any = (0.0, 0.0, 0.0)
    rotation: Any = None
    scale: float = 1.0
    rotation_center: Any = None
    mesh_data: Any = None
    interp_normals: bool = True
    measured_brdf: Any = None
    textures: Any = None
    display_edges: bool = False
    seg_path: Any = None
    edge_csv: Any = None
    bilinear: bool = False
    use_atlas: Any = None
    cutout_rounds: int = 4
    keyframes: Any = None
    # where the object came from, for the scene writers (io/scn_export.py,
    # io/scene_json.py): the .scn object name (a mesh's file), whether
    # its mesh was centred on load, the dome's env-map file; a JSON
    # scene's mesh path, scaling and offset
    name: str = ''
    is_centered: bool = True
    envmap_file: Any = None
    mesh_path: Any = None
    mesh_scaling: float = 30.0
    mesh_offset: Any = (0.0, 0.0, 0.0)


def sphere(center, radius, **kw) -> ObjectSpec:
    spec = ObjectSpec(obj_type=SPHERE, center=center, radius=radius, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = center
    return spec


def plane(point, normal, **kw) -> ObjectSpec:
    spec = ObjectSpec(obj_type=PLANE, center=point, normal=normal, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = (0.0, 0.0, 0.0)
    return spec


def yarn_object(yarn_data, **kw) -> ObjectSpec:
    """A yarn set occupying one object-table row: `yarn_data` is (seg_a
    (S,3), seg_b (S,3)) or a .yarn file path."""
    spec = ObjectSpec(obj_type=YARNS, mesh_data=yarn_data, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = (0.0, 0.0, 0.0)
    return spec


def pointset_object(point_data, **kw) -> ObjectSpec:
    """A point set occupying one object-table row: `point_data` is a
    pointset.PointSetArrays or a host dict {'points', 'normals',
    'colors', 'radii'} (missing normals and radii are estimated)."""
    spec = ObjectSpec(obj_type=POINTSET, mesh_data=point_data, **kw)
    if spec.rotation_center is None:
        spec.rotation_center = (0.0, 0.0, 0.0)
    return spec


def mesh_object(mesh_data, **kw) -> ObjectSpec:
    """A triangle mesh occupying one object-table row."""
    spec = ObjectSpec(obj_type=MESH, mesh_data=mesh_data, **kw)
    if spec.rotation_center is None:
        v = mesh_data.vertices
        spec.rotation_center = ((v.min(0) + v.max(0)) * 0.5).tolist()
    return spec


def _build_matrices(spec: ObjectSpec):
    """Compose 3x4 trans/inv and 3x3 rot."""
    m = (np.eye(3) if spec.rotation is None
         else np.asarray(spec.rotation, np.float64))
    s = float(spec.scale)
    tr = np.asarray(spec.translation, np.float64)
    rc = np.asarray(spec.rotation_center, np.float64)
    trans = np.zeros((3, 4))
    inv = np.zeros((3, 4))
    trans[:, :3] = m * s
    inv[:, :3] = m.T / s
    trans[:, 3] = m @ (-rc) * s + rc + tr
    inv[:, 3] = m.T @ (-rc - tr) / s + rc
    return (trans.astype(np.float32), inv.astype(np.float32),
            m.astype(np.float32))


def _ss_obj_ok(objects) -> np.ndarray:
    """Per-row subsurface-probe support (SceneArrays.ss_obj_ok): every
    analytic row and every mesh tier has a reservoir path; point sets and
    yarns have none, so their rows opt out of the entry RR."""
    return np.asarray([o.obj_type not in (POINTSET, YARNS) for o in objects],
                      bool)


def load_background(path: str, gamma: float = 2.2) -> np.ndarray:
    """(u8 / 255)^gamma * 196964.699 (reference: Scene::load_background,
    Geometry.h:1355-1362)."""
    img = img_io.load_image(path) / 255.0
    return (np.power(img, gamma) * 196964.699).astype(np.float32)


def _edge_colors(o: ObjectSpec):
    """(colours, mask) of the object's edge CSV (a path, or the pair)."""
    if not o.edge_csv:
        return None
    if isinstance(o.edge_csv, str):
        return obj_io.load_edge_csv(o.edge_csv, o.mesh_data)
    return o.edge_csv


def _facecolors(o: ObjectSpec):
    """(T, 3) face colours from a .seg / .lab path, or the array given."""
    if o.seg_path is None:
        return None
    if isinstance(o.seg_path, str):
        t = o.mesh_data.num_triangles
        if o.seg_path.lower().endswith('.lab'):
            return obj_io.load_lab(o.seg_path, t)
        return obj_io.load_seg(o.seg_path, t)
    return np.asarray(o.seg_path, np.float32)


def _mesh_world_aabb(mesh, trans):
    """World-space AABB of a cluster-tier mesh from its cluster bounds."""
    b = mesh.clustered.bounds.cpu().numpy().astype(np.float64)
    lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
    if mesh.world_space:
        return lo, hi
    tr = np.asarray(trans[mesh.obj_row], np.float64)
    corners = np.stack(np.meshgrid(*zip(lo, hi), indexing='ij'),
                       -1).reshape(-1, 3)
    w = corners @ tr[:, :3].T + tr[:, 3]
    return w.min(0), w.max(0)


def _object_overlaps_aabb(o, tr, lo, hi) -> bool:
    """Conservative: could object o's surface lie inside [lo, hi]?"""
    tr = np.asarray(tr, np.float64)
    if o.obj_type == SPHERE:
        c = tr[:, :3] @ np.asarray(o.center, np.float64) + tr[:, 3]
        r = float(o.radius) * abs(float(o.scale))
        near = np.maximum(lo, np.minimum(c, hi))
        return float(np.sum((near - c) ** 2)) <= r * r
    if o.obj_type == PLANE:
        p = tr[:, :3] @ np.asarray(o.center, np.float64) + tr[:, 3]
        n = tr[:, :3] @ np.asarray(o.normal, np.float64)
        nn = np.linalg.norm(n)
        if nn == 0.0:
            return True
        n = n / nn
        ctr = (lo + hi) * 0.5
        ext = (hi - lo) * 0.5
        return abs(float(np.dot(n, ctr - p))) <= float(np.dot(np.abs(n), ext))
    if o.obj_type == MESH and o.mesh_data is not None:
        v = np.asarray(o.mesh_data.vertices, np.float64)
        corners = np.stack(np.meshgrid(*zip(v.min(0), v.max(0)),
                                       indexing='ij'), -1).reshape(-1, 3)
        w = corners @ tr[:, :3].T + tr[:, 3]
        return bool(np.all(w.max(0) >= lo) and np.all(w.min(0) <= hi))
    return True


def _gate_backface_overlap(mesh, objects, trans):
    """Clear the backface cull when another object could seed ray origins
    inside this closed mesh.  Only the subsurface probe relocates a path
    through space, so only ss-capable overlapping objects clear it
    (pathtracer_tpu scene._gate_backface_overlap argues the rest)."""
    if not mesh.backface_cull:
        return mesh
    lo, hi = _mesh_world_aabb(mesh, trans)
    pad = 1e-3 + 1e-4 * float(np.linalg.norm(hi - lo))
    lo, hi = lo - pad, hi + pad
    own = ({mesh.obj_row} if mesh.group_rows is None
           else set(mesh.group_rows.tolist()))
    for j, o in enumerate(objects):
        if j in own or j in (0, 1):
            continue
        ss_capable = bool(np.any(np.broadcast_to(
            np.asarray(o.ksub, np.float32), (3,)) != 0.0))
        if not ss_capable and isinstance(o.textures, (dict, list)):
            tex = o.textures if isinstance(o.textures, list) else [o.textures]
            ss_capable = any(t and 'ksub' in t for t in tex)
        if ss_capable and _object_overlaps_aabb(o, trans[j], lo, hi):
            return dataclasses.replace(mesh, backface_cull=False)
    return mesh


def camera_backface_gate(sc: SceneArrays, cam_pos) -> SceneArrays:
    """Clear the backface cull on meshes whose AABB contains the camera:
    primary rays would start inside the closed surface."""
    p = np.asarray(cam_pos, np.float64)
    out, changed = [], False
    for m in sc.meshes:
        if m.backface_cull:
            b = m.clustered.bounds
            box = torch.cat([b[:, 0:3].amin(0), -b[:, 3:6].amax(0)])
            if m.scene_group is not None:
                # a partition's box is its own; the gate needs the mesh's
                box = pd.group_gather(box, m.scene_group).amin(0)
            box = box.cpu().numpy().astype(np.float64)
            lo, hi = box[0:3], -box[3:6]
            pad = 1e-3 + 1e-4 * float(np.linalg.norm(hi - lo))
            inv = sc.inv_trans[m.obj_row].cpu().numpy().astype(
                np.float64).reshape(3, 4)
            pl = p if m.world_space else inv[:, :3] @ p + inv[:, 3]
            if bool(np.all(pl >= lo - pad) and np.all(pl <= hi + pad)):
                m = dataclasses.replace(m, backface_cull=False)
                changed = True
        out.append(m)
    return dataclasses.replace(sc, meshes=tuple(out)) if changed else sc


def build_scene(objects, light_intensity, envmap_intensity=1.0, envmap=None,
                light_scale=1.0, fog=None, background=None, frame=None,
                merge_meshes=None, device=None) -> SceneArrays:
    """Assemble SceneArrays from ObjectSpecs: objects[0] = light,
    objects[1] = dome, on `device` (None: the card).  `fog`: the .scn fog
    block (density, absorption, type, density_decay, absorption_decay,
    phase_type, phase_aniso; on when density > 1e-8); `background`: an
    (Hb, Wb, 3) photo as load_background returns it.  `frame` evaluates
    per-object keyframes."""
    n = len(objects)
    if n < 2:
        raise ValueError('scene needs at least light (0) and dome (1) objects')
    mesh_items = [(i, o) for i, o in enumerate(objects) if o.obj_type == MESH]

    if frame is not None:
        from ..core import transform as tf
        objects = [dataclasses.replace(o) for o in objects]
        for o in objects:
            if o.keyframes:
                tr, rot, s = tf.interpolate_keyframes(o.keyframes, frame)
                o.translation = tuple(tr)
                o.rotation = rot
                o.scale = float(s)

    device = device_mod.resolve(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def stack3(field):
        return f32([np.broadcast_to(np.asarray(getattr(o, field), np.float32),
                                    (3,)) for o in objects])

    mats = [_build_matrices(o) for o in objects]
    trans = np.stack([m[0] for m in mats])
    inv_trans = np.stack([m[1] for m in mats])
    rot = np.stack([m[2] for m in mats])
    identity = all(o.rotation is None and o.scale == 1.0 for o in objects)
    light = objects[0]
    center_light = (trans[0][:, :3] @ np.asarray(light.center, np.float32)
                    + trans[0][:, 3])

    # merged multi-mesh: eligible meshes baked into ONE world-space BVH
    # when two or more are (merge_meshes None or True), as in JAX
    merged_rows = set()
    if merge_meshes is None or merge_meshes:
        eligible = [i for i, o in mesh_items if mesh_mod.mergeable_spec(o)]
        if len(eligible) >= 2:
            merged_rows = set(eligible)
    meshes = tuple(
        _gate_backface_overlap(mesh_mod.upload_mesh(
            o.mesh_data, obj_row=i, interp_normals=o.interp_normals,
            default_ksub=np.broadcast_to(np.asarray(o.ksub, np.float32),
                                         (3,)),
            default_transp=bool(o.transp), default_refr=float(o.refr_index),
            display_edges=bool(o.display_edges), edge_colors=_edge_colors(o),
            facecolors=_facecolors(o), texture_overrides=o.textures,
            use_atlas=o.use_atlas, bilinear=bool(o.bilinear),
            cutout_rounds=int(o.cutout_rounds),
            # ghosts pass rays through (origins end up inside); flipped
            # normals mark surfaces meant to be seen from inside
            allow_backface=not (o.ghost or o.flip_normals), dev=device),
            objects, trans)
        for i, o in mesh_items if i not in merged_rows)
    if merged_rows:
        entries = [(o, i, trans[i], rot[i])
                   for i, o in mesh_items if i in merged_rows]
        md_m, grow, gdef, tex_ov = mesh_mod.merge_mesh_entries(entries)
        meshes += (_gate_backface_overlap(mesh_mod.upload_mesh(
            md_m, obj_row=entries[0][1], interp_normals=True,
            world_space=True, group_rows=grow,
            group_transp=gdef['transp'], group_refr=gdef['refr'],
            group_ksub=gdef['ksub'], texture_overrides=tex_ov,
            bilinear=any(o.bilinear for _, o in mesh_items),
            cutout_rounds=max(int(o.cutout_rounds) for _, o in mesh_items),
            allow_backface=not any(o.ghost or o.flip_normals
                                   for o, _, _, _ in entries), dev=device),
            objects, trans),)
    obj_textures = tuple(
        tex_mod.make_group_textures(o.textures, device=device)
        if o.textures and o.obj_type in (SPHERE, PLANE) else None
        for o in objects)
    pointsets = []
    for i, o in enumerate(objects):
        if o.obj_type != POINTSET:
            continue
        pd = o.mesh_data
        if isinstance(pd, ps_mod.PointSetArrays):
            pointsets.append(pd.to(device).replace(
                obj_row=i, transparent=bool(o.transp)))
            continue
        pts = np.asarray(pd['points'], np.float32)
        nrm, col, radii = pd.get('normals'), pd.get('colors'), pd.get('radii')
        if nrm is None or radii is None:
            est_n, est_r = ps_mod.estimate_normals(pts)
            nrm = est_n if nrm is None else np.asarray(nrm, np.float32)
            radii = est_r if radii is None else np.asarray(radii, np.float32)
        if col is None:
            col = np.full((len(pts), 3), 1.0 / 255, np.float32)
        pointsets.append(ps_mod.upload_pointset(pts, nrm, col, radii, i,
                                                device=device))
    yarns = []
    for i, o in enumerate(objects):
        if o.obj_type != YARNS:
            continue
        yd = o.mesh_data
        seg_a, seg_b = (yarn_mod.load_yarn(yd) if isinstance(yd, str) else
                        (np.asarray(yd[0], np.float32),
                         np.asarray(yd[1], np.float32)))
        yarns.append(yarn_mod.upload_yarns(seg_a, seg_b, i, device=device))
    # measured BRDFs, tables deduplicated by identity
    tables, brdf_type = [], []
    for o in objects:
        if o.measured_brdf is None:
            brdf_type.append(0)
            continue
        k = next((j for j, tb in enumerate(tables) if tb is o.measured_brdf),
                 len(tables))
        if k == len(tables):
            tables.append(o.measured_brdf)
        brdf_type.append(k + 1)

    def bools(field):
        return torch.as_tensor([bool(getattr(o, field)) for o in objects],
                               device=device)

    # fog block (reference .scn fog parameters, Raytracer.cpp:1134-1139);
    # the ground level is objects[2]'s translation y (Raytracer.cpp:56)
    fog = fog or {}
    fog_density = float(fog.get('density', 0.0))
    ground_y = (float(np.asarray(objects[2].translation).reshape(-1)[1])
                if n > 2 else 0.0)

    return SceneArrays(
        obj_type=torch.as_tensor([o.obj_type for o in objects],
                                 dtype=torch.int32, device=device),
        center=stack3('center'),
        radius=f32([float(o.radius) for o in objects]),
        normal=stack3('normal'),
        flip_normals=bools('flip_normals'),
        kd=stack3('kd'), ks=stack3('ks'), ne=stack3('ne'),
        ksub=stack3('ksub'),
        transp=bools('transp'),
        refr_index=f32([float(o.refr_index) for o in objects]),
        miroir=bools('miroir'),
        ghost=bools('ghost'),
        trans=f32(trans.reshape(n, 12)),
        inv_trans=f32(inv_trans.reshape(n, 12)),
        rot=f32(rot.reshape(n, 9)),
        identity_transform=identity,
        light_intensity=f32(light_intensity),
        light_scale=f32(light_scale * objects[0].scale),
        envmap_intensity=f32(envmap_intensity),
        center_light=f32(center_light),
        radius_light=f32(light.radius * light_scale * objects[0].scale),
        meshes=meshes,
        envmap=None if envmap is None else torch.as_tensor(
            np.asarray(envmap, np.float32), device=device),
        obj_textures=obj_textures,
        brdf_type=torch.as_tensor(brdf_type, dtype=torch.int32,
                                  device=device),
        measured_brdfs=tuple(tb.to(device) for tb in tables),
        fog_density=f32(fog_density),
        fog_absorption=f32(fog.get('absorption', 0.0)),
        fog_density_decay=f32(fog.get('density_decay', 0.0)),
        fog_absorption_decay=f32(fog.get('absorption_decay', 0.0)),
        phase_aniso=f32(fog.get('phase_aniso', 0.8)),
        ground_level=f32(ground_y),
        fog_enabled=fog_density > 1e-8,
        fog_type=int(fog.get('type', 0)),
        fog_phase_type=int(fog.get('phase_type', 0)),
        ss_enabled=any(float(np.sum(np.square(np.broadcast_to(
            np.asarray(o.ksub, np.float32), (3,))))) > 1e-8 for o in objects),
        ss_obj_ok=torch.as_tensor(_ss_obj_ok(objects), device=device),
        ghost_enabled=any(bool(o.ghost) for o in objects),
        background=None if background is None else f32(background),
        pointsets=tuple(pointsets), yarns=tuple(yarns))


def default_objects():
    """The reference default scene's object slate: light sphere at
    (10,23,15) r=10, flipped env dome r=1e6, ground plane at y=-27.3.
    Append user objects after these three."""
    return [
        sphere((10.0, 23.0, 15.0), 10.0),
        sphere((0.0, 0.0, 0.0), 1e6, flip_normals=True),
        plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
              translation=(0.0, -27.3, 0.0)),
    ]


def default_light_intensity(r_lum=10.0):
    """intensite_lumiere = 1e9*4pi/(4pi*R^2*pi)."""
    return 1e9 / (r_lum * r_lum * np.pi)
