"""Device-side triangle meshes (counterpart of
pathtracer_tpu/scene/mesh.py `upload_mesh`).

Every mesh carries ONE packed per-triangle shading table, `shade_pack`,
whose named column ranges (`shade_cols`) hold the shading normals, the
group id of multi-group meshes and, on the cluster tier, the edge-matrix
rows of the per-ray barycentric recompute.  Its closest-hit tier is one
of (scene._mesh_closest_hit):
  * the cluster tier (`use_cluster`, the default, the card's counterpart
    of JAX's TPU default): ops/cluster.py;
  * the packet tier (`use_packet`: not use_cluster, <= PACKET_MAX_TRIS
    triangles, a CUDA device, as JAX gates it on the TPU backend):
    ops/packet_bvh.py;
  * brute force (`use_brute`, <= BRUTE_FORCE_MAX_TRIS triangles), else the
    lockstep BVH (ops/traverse.py).
A LEAN mesh (cluster tier, > PACKET_MAX_TRIS triangles, dense culls) keeps
no soup and no BVH on the device; every other mesh keeps both.

Not ported yet (raise NotImplementedError): textures and alpha cut-outs,
vertex colours, face-colour overlays and edge display (ROADMAP Queue 1
item 7), subsurface materials (item 8), merged multi-mesh BVHs (item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..io import obj as obj_io
from ..ops import bvh as bvh_mod
from ..ops import cluster
from ..ops import packet_bvh
from ..ops import traverse
from . import topology

BRUTE_FORCE_MAX_TRIS = 8192   # below this the brute sweep serves the mesh
PACKET_MAX_TRIS = 8000        # the packet tier's size limit


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
            if isinstance(x, tuple):            # TriSoup, BVHArrays, ...
                return type(x)(*(move(v) for v in x))
            return x.to(dev) if x is not None and hasattr(x, 'to') else x

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name != 'shade_cols'})


def upload_mesh(md: obj_io.MeshData, obj_row: int,
                interp_normals: bool = True,
                default_transp: bool = False,
                default_refr: float = 1.3,
                allow_backface: bool = True,
                use_cluster: Optional[bool] = None,
                use_brute: Optional[bool] = None,
                lean: Optional[bool] = None,
                dev=None) -> MeshArrays:
    """Build the BVH order, the tier's arrays and the shading pack from
    host MeshData (pallas upload_mesh), on `dev` (None: the card).

    use_cluster None: the cluster tier.  use_brute None: brute force up to
    BRUTE_FORCE_MAX_TRIS triangles.  lean None: lean on the cluster tier
    above PACKET_MAX_TRIS triangles when the culls are dense.  Subsurface
    and texture options of the object are refused by scene.build_scene;
    the mesh's own MTL maps and vertex colours here."""
    dev = device_mod.resolve(dev)
    if any(m.map_kd or m.map_ks or m.map_bump or m.map_d
           for m in md.materials):
        raise NotImplementedError('mesh textures are not ported yet '
                                  '(ROADMAP Queue 1 item 7)')
    if md.vertex_colors is not None:
        raise NotImplementedError('vertex colours are not ported yet '
                                  '(ROADMAP Queue 1 item 7)')
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
    g = len(md.materials)

    # backface-cull gate, material side: opaque everywhere (no texture or
    # subsurface reaches here); geometric side: closed and consistently
    # oriented
    bf_sign = 0
    cm = None
    if use_cluster:
        if allow_backface and not default_transp:
            bf_sign = topology.closed_orientation(md.vertices, md.vtx_idx)
        cm = cluster.build_clustered(
            tri_verts, fb=fb, nrm_sign=float(bf_sign if bf_sign else 1),
            dev=dev)
    if lean is None:
        lean = (cm is not None and n_tris > PACKET_MAX_TRIS
                and cm.n_clusters <= cluster.DENSE_CULL_MAX)

    # packed per-triangle shading fetch: one (T, C) row gather per hit
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
    if g > 1:
        add('grp', np.asarray(md.group[order], np.int32).view(np.float32))
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
        g_ksub=torch.zeros((g, 3), device=dev),
        g_transp=torch.full((g,), bool(default_transp), device=dev),
        g_refr=torch.full((g,), float(default_refr), device=dev),
        obj_row=int(obj_row), n_tris=n_tris,
        interp_normals=bool(interp_normals),
        backface_cull=bool(bf_sign != 0),
        soup=soup, bvh=bvh,
        packed=packet_bvh.pack_bvh(fb, device=dev) if use_packet else None,
        max_leaf=int(fb.max_leaf), use_brute=bool(use_brute),
        use_packet=bool(use_packet), use_cluster=bool(use_cluster))
