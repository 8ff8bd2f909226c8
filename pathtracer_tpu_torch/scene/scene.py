"""Scene tables and intersection (counterpart of pathtracer_tpu/scene/scene.py).

Analytic objects live in one SoA table; a ray is tested against every row
at once ((N rays) x (O objects) candidate t matrix, masked argmin).  Row 0
is the spherical light, row 1 the environment dome, rows 2+ user objects.
Triangle meshes are bound to a row (its transform and flags) and go
through their mesh's tier (scene/mesh.py): cluster, packet, brute force or
lockstep BVH.

Features outside the port's first slice raise NotImplementedError from
`build_scene`, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..core import vec
from ..ops import cluster
from ..ops import packet_bvh
from ..ops import traverse
from . import mesh as mesh_mod

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
            self, meshes=tuple(m.to(dev) for m in self.meshes), **kw)


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
    lkey: torch.Tensor        # (N,) int64 surface-locality sort key


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
    """Closest hit over the analytic rows, then every mesh."""
    t_all, (lox, loy, loz), (ldx, ldy, ldz) = _candidate_ts(sc, origins, dirs)
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
    out = Hit(hit=hit, t=t, p=p, n=vec.normalize(n), obj_id=obj_id,
              kd=_material(sc.kd, obj_id), ks=_material(sc.ks, obj_id),
              ne=_material(sc.ne, obj_id), ke=torch.zeros_like(p),
              ksub=_material(sc.ksub, obj_id),
              transp=sc.transp[obj_id] & hit,
              refr_index=sc.refr_index[obj_id],
              miroir=sc.miroir[obj_id] & hit, lkey=obj_id)
    for mesh in sc.meshes:
        out = _merge_mesh_hit(sc, mesh, origins, dirs, out)
    return out


def _local_ray_row(sc: SceneArrays, row: int, origins, dirs):
    """Rays in one object row's space (directions stay unnormalized, so
    t is transform-invariant)."""
    m = sc.inv_trans[row]
    if sc.identity_transform:
        return origins + torch.stack([m[3], m[7], m[11]]), dirs
    rotm = m.view(3, 4)
    return origins @ rotm[:, :3].T + rotm[:, 3], dirs @ rotm[:, :3].T


def _bary_from_pack(mesh, org_l, dir_l, t, tri, sf):
    """Winner barycentrics from the shade_pack 'bary' columns
    (a(3) u(3) v(3) m11 m12 m22 invdet), edge-matrix formula."""
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


def _mesh_closest_hit(mesh, org_l, dir_l, t_max):
    """Closest hit of one mesh in its own space, by its tier
    (pallas scene._mesh_closest_hit without the alpha-cutout rounds):
    (t — t_max on a miss —, tri, barycentrics (alpha, beta, gamma), or
    None where the cluster tier leaves them to the shade_pack)."""
    if mesh.use_cluster:
        cm = mesh.clustered
        if cm.n_clusters <= cluster.DENSE_CULL_MAX:
            # the windowed rounds leave no residual lane
            t, tri = cluster.two_level_hit(cm, org_l, dir_l, t_max,
                                           backface_cull=mesh.backface_cull)
            return t, tri, None
        # tree tier: residual lanes re-traverse the lockstep BVH
        t, tri, res = cluster.two_level_hit(
            cm, org_l, dir_l, t_max, backface_cull=mesh.backface_cull,
            return_residual=True)
        t, tri, _, _ = traverse.bvh_hit_sparse(
            mesh.bvh, mesh.soup, org_l, dir_l, res, mesh.max_leaf, t, tri,
            torch.ones_like(t), torch.zeros_like(t))
        return t, tri, None
    if mesh.use_packet:
        t, tri, al, be = packet_bvh.packet_hit(mesh.packed, mesh.soup, org_l,
                                               dir_l, t_max)
        return t, tri, (al, be, 1.0 - al - be)
    if mesh.use_brute:
        mh = traverse.brute_force_hit(mesh.soup, org_l, dir_l, t_max=t_max)
    else:
        mh = traverse.bvh_hit(mesh.bvh, mesh.soup, org_l, dir_l,
                              max_leaf=mesh.max_leaf, t_init=t_max)
    return mh.t, mh.tri, (mh.alpha, mh.beta, mh.gamma)


def _merge_mesh_hit(sc: SceneArrays, mesh, origins, dirs, cur: Hit) -> Hit:
    """Intersect one mesh (closest hit pruned by the running best t) and
    fold it into the running hit, with its shading from one shade_pack
    row gather."""
    row = mesh.obj_row
    org_l, dir_l = _local_ray_row(sc, row, origins, dirs)
    t, tri, bary = _mesh_closest_hit(mesh, org_l, dir_l, cur.t)
    sf = mesh.shade_pack[tri.clamp_min(0).long()]
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
    n_l = torch.where(sc.flip_normals[row], -n_l, n_l)
    p_l = org_l + t[:, None] * dir_l
    if sc.identity_transform:
        tr = sc.trans[row]
        p_w = p_l + torch.stack([tr[3], tr[7], tr[11]])
        n_w = n_l
    else:
        tr = sc.trans[row].view(3, 4)
        p_w = p_l @ tr[:, :3].T + tr[:, 3]
        n_w = vec.normalize(n_l @ sc.rot[row].view(3, 3).T)

    gcol = mesh.col('grp')
    if gcol is None:
        def mat(tbl):
            return tbl[0].expand((t.shape[0],) + tbl.shape[1:])
    else:
        grp = sf[:, gcol][:, 0].contiguous().view(torch.int32).long()

        def mat(tbl):
            return _material(tbl, grp) if tbl.dim() == 2 else tbl[grp]

    def sel(new, old):
        m = win[:, None] if new.dim() > win.dim() else win
        return torch.where(m, new, old)

    tris_per_cluster = max(1, -(-mesh.num_triangles // max(mesh.n_clusters,
                                                           1)))
    lkey = torch.clamp_max(tri.long() // tris_per_cluster, 8191)
    return Hit(
        hit=cur.hit | win,
        t=torch.where(win, t, cur.t),
        p=sel(p_w, cur.p),
        n=sel(n_w, cur.n),
        obj_id=torch.where(win, row, cur.obj_id),
        kd=sel(mat(mesh.g_kd), cur.kd),
        ks=sel(mat(mesh.g_ks), cur.ks),
        ne=sel(mat(mesh.g_ne), cur.ne),
        ke=sel(torch.zeros_like(cur.ke), cur.ke),
        ksub=sel(mat(mesh.g_ksub), cur.ksub),
        transp=torch.where(win, mat(mesh.g_transp), cur.transp),
        refr_index=torch.where(win, mat(mesh.g_refr), cur.refr_index),
        miroir=torch.where(win, sc.miroir[row], cur.miroir),
        lkey=torch.where(win, lkey, cur.lkey),
    )


def intersect_shadow(sc: SceneArrays, origins, dirs, dist_light):
    """Any hit within 0.999 * dist_light.  Returns bool (N,)."""
    limit = dist_light * 0.999
    t_all = _candidate_ts(sc, origins, dirs)[0]
    blocked = (t_all < limit[:, None]).any(dim=-1)
    for mesh in sc.meshes:
        org_l, dir_l = _local_ray_row(sc, mesh.obj_row, origins, dirs)
        if mesh.use_cluster:
            blocked |= cluster.two_level_any(
                mesh.clustered, org_l, dir_l, limit,
                backface_cull=mesh.backface_cull)
        elif mesh.use_packet:
            # the packet tier has no any-hit variant: closest hit bounded
            # by the limit (t is transform-invariant, dir_l unnormalized)
            blocked |= _mesh_closest_hit(mesh, org_l, dir_l, limit)[0] < limit
        elif mesh.use_brute:
            blocked |= traverse.brute_force_any(mesh.soup, org_l, dir_l,
                                                limit)
        else:
            blocked |= traverse.bvh_hit(mesh.bvh, mesh.soup, org_l, dir_l,
                                        max_leaf=mesh.max_leaf,
                                        any_hit_limit=limit).t < limit
    return blocked


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


def _unsupported_object(o: ObjectSpec):
    """The first feature of this object outside the port's slice, or None."""
    if o.obj_type in (POINTSET, YARNS):
        return 'pointsets and yarns (ROADMAP Queue 1 item 9)'
    if o.ghost:
        return 'ghost objects (ROADMAP Queue 1 item 8)'
    if o.measured_brdf is not None:
        return 'MERL / Titopo measured BRDFs (ROADMAP Queue 1 item 7)'
    if o.textures or o.seg_path is not None or o.edge_csv is not None \
            or o.display_edges:
        return ('textures, face colours and edge display (ROADMAP Queue 1 '
                'item 7)')
    if np.any(np.asarray(o.ksub, np.float32) != 0.0):
        return 'ksub subsurface scattering (ROADMAP Queue 1 item 8)'
    return None


def _mesh_world_aabb(mesh, trans):
    """World-space AABB of a cluster-tier mesh from its cluster bounds."""
    b = mesh.clustered.bounds.cpu().numpy().astype(np.float64)
    lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
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
    for j, o in enumerate(objects):
        if j in (mesh.obj_row, 0, 1):
            continue
        ss_capable = bool(np.any(np.broadcast_to(
            np.asarray(o.ksub, np.float32), (3,)) != 0.0))
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
            b = m.clustered.bounds.cpu().numpy().astype(np.float64)
            lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
            pad = 1e-3 + 1e-4 * float(np.linalg.norm(hi - lo))
            inv = sc.inv_trans[m.obj_row].cpu().numpy().astype(
                np.float64).reshape(3, 4)
            pl = inv[:, :3] @ p + inv[:, 3]
            if bool(np.all(pl >= lo - pad) and np.all(pl <= hi + pad)):
                m = dataclasses.replace(m, backface_cull=False)
                changed = True
        out.append(m)
    return dataclasses.replace(sc, meshes=tuple(out)) if changed else sc


def build_scene(objects, light_intensity, envmap_intensity=1.0, envmap=None,
                light_scale=1.0, fog=None, background=None, frame=None,
                merge_meshes=None, device=None) -> SceneArrays:
    """Assemble SceneArrays from ObjectSpecs: objects[0] = light,
    objects[1] = dome, on `device` (None: the card).  `frame` evaluates
    per-object keyframes."""
    n = len(objects)
    if n < 2:
        raise ValueError('scene needs at least light (0) and dome (1) objects')
    if envmap is not None:
        raise NotImplementedError(
            'environment-map images are not ported yet (ROADMAP Queue 1 '
            'item 3: _envmap_ke)')
    if background is not None:
        raise NotImplementedError(
            'background photos are not ported yet (ROADMAP Queue 1 item 8)')
    if fog and float(fog.get('density', 0.0)) > 1e-8:
        raise NotImplementedError('fog is not ported yet (ROADMAP Queue 1 '
                                  'item 8)')
    for o in objects:
        why = _unsupported_object(o)
        if why is not None:
            raise NotImplementedError(f'scene feature not ported yet: {why}')
    mesh_items = [(i, o) for i, o in enumerate(objects) if o.obj_type == MESH]
    if len(mesh_items) >= 2 and merge_meshes is not False:
        raise NotImplementedError(
            'the merged multi-mesh BVH is not ported yet (ROADMAP Queue 1 '
            'item 5: merge_mesh_entries); pass merge_meshes=False')

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

    meshes = tuple(
        _gate_backface_overlap(mesh_mod.upload_mesh(
            o.mesh_data, obj_row=i, interp_normals=o.interp_normals,
            default_transp=bool(o.transp), default_refr=float(o.refr_index),
            allow_backface=not (o.ghost or o.flip_normals), dev=device),
            objects, trans)
        for i, o in mesh_items)

    def bools(field):
        return torch.as_tensor([bool(getattr(o, field)) for o in objects],
                               device=device)

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
        trans=f32(trans.reshape(n, 12)),
        inv_trans=f32(inv_trans.reshape(n, 12)),
        rot=f32(rot.reshape(n, 9)),
        identity_transform=identity,
        light_intensity=f32(light_intensity),
        light_scale=f32(light_scale * objects[0].scale),
        envmap_intensity=f32(envmap_intensity),
        center_light=f32(center_light),
        radius_light=f32(light.radius * light_scale * objects[0].scale),
        meshes=meshes)


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
