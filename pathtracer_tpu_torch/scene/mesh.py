"""Device-side triangle meshes (counterpart of
pathtracer_tpu/scene/mesh.py `upload_mesh`).

Every mesh carries ONE packed per-triangle shading table, `shade_pack`,
whose named column ranges (`shade_cols`) follow the JAX package's names,
order and widths: the shading normals (n0-n2, or fn), the group id of
multi-group meshes (grp), the corner UVs of a textured mesh (uv0-uv2),
the corner tangents of a normal-mapped one (t0-t2), vertex colours
(vc0-vc2), face colours (fc), edge flags (se) and per-edge CSV colours
(ec, em) under edge display, and on the cluster tier the edge-matrix
rows of the per-ray barycentric recompute (bary).  Texture images stay
per group (`textures`, one models.texture.GroupTextures per group), and
with ATLAS_MIN_GROUPS textured groups or more each channel is also packed
into one atlas (`atlases`, models.texture.CHANNELS order).

Its closest-hit tier is one of (scene._mesh_closest_hit):
  * the cluster tier (`use_cluster`, the default, the card's counterpart
    of JAX's TPU default): ops/cluster.py, or with `use_routed` its
    routed per-lane variant, ops/routed_cluster.py;
  * the packet tier (`use_packet`: not use_cluster, <= PACKET_MAX_TRIS
    triangles, a CUDA device, as JAX gates it on the TPU backend):
    ops/packet_bvh.py;
  * brute force (`use_brute`, <= BRUTE_FORCE_MAX_TRIS triangles), else the
    lockstep BVH (ops/traverse.py).
A LEAN mesh (cluster tier, not routed, > PACKET_MAX_TRIS triangles, dense
culls) keeps no soup and no BVH on the device; every other mesh keeps both.

A MERGED mesh (`merge_mesh_entries`, world_space) bakes several mesh
objects into one world-space BVH; `group_rows` maps each of its material
groups to its source object's row.

Subsurface materials (ksub constants, `default_ksub` / `group_ksub`, and
ksub maps) clear the backface cull: the subsurface probe relocates paths
inside the mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..io import obj as obj_io
from ..models import texture as tex_mod
from ..ops import bvh as bvh_mod
from ..ops import cluster
from ..ops import packet_bvh
from ..ops import traverse
from . import topology

BRUTE_FORCE_MAX_TRIS = 8192   # below this the brute sweep serves the mesh
PACKET_MAX_TRIS = 8000        # the packet tier's size limit
ATLAS_MIN_GROUPS = 5          # textured groups before the atlas pays off


@dataclasses.dataclass
class MeshArrays:
    clustered: Optional[cluster.ClusteredMesh]   # None off the cluster tier
    shade_pack: torch.Tensor     # (T, C) f32, BVH triangle order
    shade_cols: tuple            # ((name, start, width), ...)
    # per-group constant materials
    g_kd: torch.Tensor           # (G,3)
    g_ks: torch.Tensor
    g_ne: torch.Tensor
    g_ksub: torch.Tensor
    g_transp: torch.Tensor       # (G,) bool
    g_refr: torch.Tensor         # (G,)
    obj_row: int
    n_tris: int
    interp_normals: bool = True
    # exact backface cull of the cluster tier: the mesh is a closed,
    # consistently oriented, fully opaque 2-manifold (the orientation sign
    # is baked into clustered.nrm); build_scene and the Renderer clear it
    # where rays could start inside the mesh
    backface_cull: bool = False
    # non-lean meshes: BVH-ordered soup and flat BVH; packet tier: packed
    soup: Optional[traverse.TriSoup] = None
    bvh: Optional[traverse.BVHArrays] = None
    packed: Optional[packet_bvh.PackedBVH] = None
    max_leaf: int = 0
    use_brute: bool = False
    use_packet: bool = False
    use_cluster: bool = True
    # the cluster tier's routed per-lane variant (ops/routed_cluster.py):
    # keeps its soup and BVH for the residual lanes' fallback
    use_routed: bool = False
    # per-group texture images (GroupTextures, one per group) and, for
    # many textured groups, one ChannelAtlas or None per CHANNELS entry
    textures: tuple = ()
    atlases: tuple = ()
    bilinear: bool = False        # bilinear texture filtering (an option)
    cutout_rounds: int = 4        # alpha-cutout re-intersection rounds
    display_edges: bool = False   # wireframe / per-edge CSV colours
    # merged meshes: triangles in world space, group -> source object row
    group_rows: Optional[torch.Tensor] = None   # (G,) int64
    world_space: bool = False
    # scene axis (parallel/scene_shard.py): this rank's partition of a
    # cluster-tier mesh.  `clustered` holds the partition's clusters (tri
    # ids stay global BVH positions) and `shade_pack` the rows
    # [shard_row0, shard_row0 + shard_rows) of the whole pack; the hit
    # queries and the shading fetch combine over `scene_group`, the
    # process group of the ranks holding the other partitions (None: an
    # unsharded mesh, or a partition not bound to its group yet)
    scene_group: Optional[object] = None
    shard_row0: Optional[int] = None
    shard_rows: Optional[int] = None

    @property
    def has_alpha(self) -> bool:
        """Some group has an alpha map: closest hits run the cut-out
        rounds and shadows skip the any-hit sweep."""
        return any(gt.alpha is not None for gt in self.textures)

    @property
    def num_triangles(self) -> int:
        return self.n_tris

    @property
    def n_clusters(self) -> int:
        """Cluster count; 0 off the cluster tier (the surface sort key
        then puts the whole mesh under one key, as in JAX)."""
        return 0 if self.clustered is None else self.clustered.n_clusters

    def replace(self, **fields) -> 'MeshArrays':
        """A copy with `fields` replaced (the JAX package's
        `mesh.replace(g_kd=...)`)."""
        return dataclasses.replace(self, **fields)

    def col(self, name: str) -> Optional[slice]:
        for nm, s, w in self.shade_cols:
            if nm == name:
                return slice(s, s + w)
        return None

    def to(self, dev) -> 'MeshArrays':
        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(dev)
            if isinstance(x, tuple) and hasattr(x, '_fields'):
                return type(x)(*(move(v) for v in x))   # TriSoup, BVHArrays
            if isinstance(x, tuple):                    # textures, atlases
                return tuple(move(v) for v in x)
            return x.to(dev) if x is not None and hasattr(x, 'to') else x

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name not in ('shade_cols', 'scene_group')})




def _group_textures(md: obj_io.MeshData, load_textures: bool,
                    texture_overrides, dev) -> list:
    """Per-group GroupTextures: the MTL map_* references resolved against
    the OBJ's directory (TriangleMesh.cpp:504-535), then the explicit
    per-group channel overrides (scene-JSON `textures`: a dict applies to
    group 0, a list is per group)."""
    g = len(md.materials)
    textures = []
    for m in md.materials:
        spec = {}
        if load_textures:
            for ch, name in (('kd', m.map_kd), ('ks', m.map_ks),
                             ('normal', m.map_bump), ('alpha', m.map_d)):
                if name:
                    path = os.path.join(md.obj_dir, name.replace('\\', '/'))
                    if os.path.exists(path):
                        spec[ch] = path
        textures.append(tex_mod.make_group_textures(spec, device=dev))
    if texture_overrides:
        ov_list = ([texture_overrides] if isinstance(texture_overrides, dict)
                   else list(texture_overrides))
        for gi, ov in enumerate(ov_list[:g]):
            if ov:
                new = tex_mod.make_group_textures(ov, device=dev)
                textures[gi] = tex_mod.GroupTextures(**{
                    ch: (getattr(new, ch) if getattr(new, ch) is not None
                         else getattr(textures[gi], ch))
                    for ch in tex_mod.CHANNELS})
    return textures


def upload_mesh(md: obj_io.MeshData, obj_row: int,
                interp_normals: bool = True,
                default_transp: bool = False,
                default_refr: float = 1.3,
                allow_backface: bool = True,
                use_cluster: Optional[bool] = None,
                use_routed: bool = False,
                use_brute: Optional[bool] = None,
                lean: Optional[bool] = None,
                load_textures: bool = True,
                default_ksub=(0.0, 0.0, 0.0),
                display_edges: bool = False,
                facecolors=None,
                texture_overrides=None,
                use_atlas: Optional[bool] = None,
                bilinear: bool = False,
                cutout_rounds: int = 4,
                edge_colors=None,
                group_transp=None,
                group_refr=None,
                group_ksub=None,
                group_rows=None,
                world_space: bool = False,
                dev=None) -> MeshArrays:
    """Build the BVH order, the tier's arrays, the textures and the shading
    pack from host MeshData (pallas upload_mesh), on `dev` (None: the
    card).

    use_cluster None: the cluster tier; use_routed: its routed variant.
    use_brute None: brute force up to BRUTE_FORCE_MAX_TRIS triangles.  lean
    None: lean on the cluster tier, not routed, above PACKET_MAX_TRIS
    triangles when the culls are dense.  use_atlas
    None: an atlas from ATLAS_MIN_GROUPS textured groups.  facecolors:
    (T, 3) per original triangle (.seg / .lab); edge_colors: the
    (colours (T, 3, 3), mask (T, 3)) pair of io.obj.load_edge_csv, used
    under display_edges.  group_rows, world_space: a merged mesh
    (merge_mesh_entries)."""
    dev = device_mod.resolve(dev)
    tri_verts = md.vertices[md.vtx_idx]                     # (T,3,3)
    fb = bvh_mod.build_bvh(tri_verts)
    order = fb.order
    n_tris = len(order)
    if use_cluster is None:
        use_cluster = True
    if use_brute is None:
        use_brute = n_tris <= BRUTE_FORCE_MAX_TRIS
    use_packet = (not use_cluster and n_tris <= PACKET_MAX_TRIS
                  and dev.type == 'cuda')

    n_idx = md.n_idx[order]
    normals = md.normals if len(md.normals) else np.zeros((1, 3), np.float32)
    n0 = normals[np.clip(n_idx[:, 0], 0, len(normals) - 1)]
    n1 = normals[np.clip(n_idx[:, 1], 0, len(normals) - 1)]
    n2 = normals[np.clip(n_idx[:, 2], 0, len(normals) - 1)]
    uvs = md.uvs if len(md.uvs) else np.zeros((1, 2), np.float32)
    uvc = np.clip(md.uv_idx[order], 0, len(uvs) - 1)
    vidx = md.vtx_idx[order]
    g = len(md.materials)

    textures = _group_textures(md, load_textures, texture_overrides, dev)
    if use_atlas is None:
        use_atlas = sum(gt.any_image for gt in textures) >= ATLAS_MIN_GROUPS
    atlases = ()
    if use_atlas and any(gt.any_image for gt in textures):
        atlases = tuple(tex_mod.build_atlas([getattr(gt, ch)
                                             for gt in textures], device=dev)
                        for ch in tex_mod.CHANNELS)

    # backface-cull gate, material side: opaque everywhere (no transparent
    # or subsurface group, no alpha / transp / refr / ksub map: any of them
    # lets rays continue inside, where back faces are real hits);
    # geometric side: closed and consistently oriented
    transp_any = (bool(np.any(np.asarray(group_transp)))
                  if group_transp is not None else bool(default_transp))
    ksub_any = bool(np.any(np.asarray(
        group_ksub if group_ksub is not None else default_ksub,
        np.float32) != 0.0))
    tex_block = any(gt.alpha is not None or gt.transp is not None
                    or gt.refr is not None or gt.ksub is not None
                    for gt in textures)
    bf_sign = 0
    cm = None
    if use_cluster:
        if allow_backface and not (transp_any or ksub_any or tex_block):
            bf_sign = topology.closed_orientation(md.vertices, md.vtx_idx)
        cm = cluster.build_clustered(
            tri_verts, fb=fb, nrm_sign=float(bf_sign if bf_sign else 1),
            dev=dev)
    if lean is None:
        lean = (cm is not None and not use_routed
                and n_tris > PACKET_MAX_TRIS
                and cm.n_clusters <= cluster.DENSE_CULL_MAX)

    # packed per-triangle shading fetch: one (T, C) row gather per hit,
    # holding only the columns this mesh's features read
    parts, cols, off = [], [], 0

    def add(name, arr):
        nonlocal off
        a = np.asarray(arr, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        parts.append(a)
        cols.append((name, off, a.shape[1]))
        off += a.shape[1]

    ov = tri_verts[order].astype(np.float64)
    av, uv, vv = ov[:, 0], ov[:, 1] - ov[:, 0], ov[:, 2] - ov[:, 0]
    if interp_normals:
        add('n0', n0)
        add('n1', n1)
        add('n2', n2)
    else:
        add('fn', np.cross(uv, vv))
    if g > 1 or group_rows is not None:
        add('grp', np.asarray(md.group[order], np.int32).view(np.float32))
    if atlases or any(gt.any_image for gt in textures):
        for k in range(3):
            add(f'uv{k}', uvs[uvc[:, k]])
    if any(gt.normal is not None for gt in textures):
        tan = (md.tangents if md.tangents is not None
               else np.zeros((len(md.vertices), 3), np.float32))
        for k in range(3):
            add(f't{k}', tan[vidx[:, k]])
    if md.vertex_colors is not None:
        for k in range(3):
            add(f'vc{k}', md.vertex_colors[vidx[:, k]])
    if facecolors is not None:
        fc = np.asarray(facecolors, np.float32)
        if fc.shape != (n_tris, 3):
            raise ValueError('facecolors must be (T, 3)')
        add('fc', fc[order])
    if display_edges:
        add('se', np.asarray(md.show_edges[order], np.float32))
        if edge_colors is not None:
            # per-edge CSV colours: 9 colour floats + 3 mask floats per
            # triangle, slot layout matching the barycentric crossing test
            ec_arr, em_arr = edge_colors
            add('ec', np.asarray(ec_arr, np.float32)[order].reshape(-1, 9))
            add('em', np.asarray(em_arr, np.float32)[order])
    if use_cluster:
        # edge-matrix rows for the per-ray barycentric recompute (the
        # other tiers return their barycentrics with the hit)
        m11 = (uv * uv).sum(-1)
        m12 = (uv * vv).sum(-1)
        m22 = (vv * vv).sum(-1)
        det = m11 * m22 - m12 * m12
        inv = 1.0 / np.where(det != 0, det, 1.0)
        add('bary', np.concatenate([av, uv, vv, m11[:, None], m12[:, None],
                                    m22[:, None], inv[:, None]], axis=1))

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32, order="C"), device=dev)

    soup = bvh = None
    if not lean:
        soup = traverse.make_soup(tri_verts[order], device=dev)
        bvh = traverse.upload_bvh(fb, device=dev)
    return MeshArrays(
        clustered=cm,
        shade_pack=f32(np.concatenate(parts, axis=1)),
        shade_cols=tuple(cols),
        g_kd=f32(np.stack([m.kd for m in md.materials])),
        g_ks=f32(np.stack([m.ks for m in md.materials])),
        g_ne=f32(np.stack([m.ns for m in md.materials])),
        g_ksub=(f32(group_ksub) if group_ksub is not None else f32(
            np.broadcast_to(np.asarray(default_ksub, np.float32), (g, 3)))),
        # object-level transp / refr seed every group (the reference's
        # per-Object fields); per-group arrays override them
        g_transp=torch.as_tensor(
            np.asarray(group_transp, bool) if group_transp is not None
            else np.full((g,), bool(default_transp)), device=dev),
        g_refr=(f32(group_refr) if group_refr is not None
                else torch.full((g,), float(default_refr), device=dev)),
        obj_row=int(obj_row), n_tris=n_tris,
        interp_normals=bool(interp_normals),
        backface_cull=bool(bf_sign != 0),
        soup=soup, bvh=bvh,
        packed=packet_bvh.pack_bvh(fb, device=dev) if use_packet else None,
        max_leaf=int(fb.max_leaf), use_brute=bool(use_brute),
        use_packet=bool(use_packet), use_cluster=bool(use_cluster),
        use_routed=bool(use_routed),
        textures=tuple(textures), atlases=atlases, bilinear=bool(bilinear),
        cutout_rounds=int(cutout_rounds),
        display_edges=bool(display_edges),
        group_rows=(None if group_rows is None else torch.as_tensor(
            np.asarray(group_rows, np.int64), device=dev)),
        world_space=bool(world_space))


def mergeable_spec(spec) -> bool:
    """Eligibility for the JAX package's merged multi-mesh tier
    (pathtracer_tpu/scene/mesh.py mergeable_spec): meshes without vertex
    colours, face colours, edge display, ghosts or subsurface."""
    md = spec.mesh_data
    return (md is not None
            and md.vertex_colors is None
            and spec.seg_path is None
            and not spec.display_edges
            and not spec.ghost
            and spec.edge_csv is None
            and not np.any(np.broadcast_to(
                np.asarray(spec.ksub, np.float32), (3,)) != 0.0))


def merge_mesh_entries(entries):
    """Bake several mesh objects into ONE world-space MeshData.

    entries: list of (spec, row, trans (3,4) np, rot (3,3) np).
    Returns (MeshData, group_rows (G,) int32, per-group default dict,
    texture_overrides list) ready for upload_mesh(world_space=True).

    The reference reaches the same end through Embree instancing (each
    TriMesh a sub-scene instanced with its 3x4 transform into one top
    scene, Geometry.cpp:255-277, 627-674); here, as in the JAX package,
    the transforms are baked into the soup and the per-object state
    (flags, rows) is recovered per GROUP at shading.  Keyframed objects
    re-bake on every build_scene(frame=...)."""
    verts, normals, uvs, tangents = [], [], [], []
    vtx_idx, n_idx, uv_idx, groups, show_edges = [], [], [], [], []
    materials, group_rows = [], []
    g_transp, g_refr, g_ksub, tex_ov = [], [], [], []
    v_base = n_base = uv_base = g_base = 0
    import dataclasses as dc

    for spec, row, trans, rot in entries:
        md = spec.mesh_data
        m3 = np.asarray(trans, np.float64)[:, :3]
        t3 = np.asarray(trans, np.float64)[:, 3]
        r3 = np.asarray(rot, np.float64)
        V = (md.vertices.astype(np.float64) @ m3.T + t3).astype(np.float32)
        t = md.vtx_idx.shape[0]
        verts.append(V)
        vtx_idx.append(md.vtx_idx + v_base)

        if spec.interp_normals and len(md.normals):
            N = (md.normals.astype(np.float64) @ r3.T).astype(np.float32)
            normals.append(N)
            n_idx.append(np.clip(md.n_idx, 0, len(md.normals) - 1)
                         + n_base)
            n_base += len(N)
        else:
            # face normals expanded per corner (flat shading baked in)
            fv = V[md.vtx_idx]
            fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
            ln = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = (fn / np.maximum(ln, 1e-20)).astype(np.float32)
            normals.append(fn)
            n_idx.append(np.repeat(np.arange(t, dtype=np.int32)[:, None],
                                   3, axis=1) + n_base)
            n_base += t

        if len(md.uvs):
            uvs.append(md.uvs)
            uv_idx.append(np.clip(md.uv_idx, 0, len(md.uvs) - 1)
                          + uv_base)
            uv_base += len(md.uvs)
        else:
            uvs.append(np.zeros((1, 2), np.float32))
            uv_idx.append(np.full((t, 3), uv_base, np.int32))
            uv_base += 1

        if md.tangents is not None:
            tangents.append((md.tangents.astype(np.float64)
                             @ r3.T).astype(np.float32))
        else:
            tangents.append(np.zeros_like(V))

        groups.append(md.group + g_base)
        show_edges.append(md.show_edges if md.show_edges is not None
                          else np.zeros((t, 3), bool))
        ng = len(md.materials)
        for m in md.materials:
            def absify(p):
                if not p:
                    return p
                q = p.replace('\\', '/')
                return q if os.path.isabs(q) else os.path.join(
                    md.obj_dir, q)
            materials.append(dc.replace(
                m, map_kd=absify(m.map_kd), map_ks=absify(m.map_ks),
                map_bump=absify(m.map_bump), map_d=absify(m.map_d)))
        group_rows.extend([row] * ng)
        g_transp.extend([bool(spec.transp)] * ng)
        g_refr.extend([float(spec.refr_index)] * ng)
        ks3 = np.broadcast_to(np.asarray(spec.ksub, np.float32), (3,))
        g_ksub.extend([ks3] * ng)
        ov = spec.textures
        ov_list = ([ov] if isinstance(ov, dict) else list(ov or []))
        ov_list = (ov_list + [None] * ng)[:ng]
        tex_ov.extend(ov_list)
        v_base += len(V)
        g_base += ng

    md_merged = obj_io.MeshData(
        vertices=np.concatenate(verts).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        uvs=np.concatenate(uvs).astype(np.float32),
        vtx_idx=np.concatenate(vtx_idx).astype(np.int32),
        uv_idx=np.concatenate(uv_idx).astype(np.int32),
        n_idx=np.concatenate(n_idx).astype(np.int32),
        group=np.concatenate(groups).astype(np.int32),
        show_edges=np.concatenate(show_edges),
        vertex_colors=None,
        materials=materials,
        group_names={},
        tangents=np.concatenate(tangents).astype(np.float32),
        obj_dir='',
    )
    gdef = {'transp': np.asarray(g_transp, bool),
            'refr': np.asarray(g_refr, np.float32),
            'ksub': np.stack(g_ksub).astype(np.float32)}
    return (md_merged, np.asarray(group_rows, np.int32), gdef, tex_ov)
