"""Mesh topology diagnostics, colouring tools and the closed-orientation
gate of the cluster backface cull (counterpart of
pathtracer_tpu/scene/topology.py; the port's own numpy copy).

Reference: TriMesh::getNbConnected TriangleMesh.cpp:1459-1513, findQuads
:1432-1457, colorAnisotropy / randomColors TriangleMesh.h:168-204, the
ShowMeshInfo dialog mainApp.cpp:1397-1431.  All host numpy: diagnostics,
not the render path, apart from `closed_orientation`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import hostcache


@dataclasses.dataclass
class MeshInfo:
    """The ShowMeshInfo numbers (mainApp.cpp:1397-1431)."""

    n_triangles: int
    n_polygons: int          # recovered quads / n-gons (findQuads)
    n_real_edges: int        # edges excluding fan diagonals
    n_edges: int
    n_components: int
    n_non_manifold: int
    n_boundary_edges: int
    euler: int
    genus: float


def _edge_key(a, b):
    return (a, b) if a < b else (b, a)


def _edges_to_faces(vtx_idx):
    out = {}
    for f, (a, b, c) in enumerate(vtx_idx):
        for e in (_edge_key(a, b), _edge_key(b, c), _edge_key(a, c)):
            out.setdefault(e, []).append(f)
    return out


def connected_components(vtx_idx: np.ndarray):
    """Face-adjacency component count and edge statistics
    (TriangleMesh.cpp:1459-1513): (components, edges, non-manifold edges,
    boundary edges)."""
    e2f = _edges_to_faces(vtx_idx)
    n_edges = len(e2f)
    non_manifold = sum(1 for fs in e2f.values() if len(fs) > 2)
    boundary = sum(1 for fs in e2f.values() if len(fs) == 1)
    # union-find over faces sharing an edge
    parent = np.arange(len(vtx_idx))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for fs in e2f.values():
        for f in fs[1:]:
            ra, rb = find(fs[0]), find(f)
            if ra != rb:
                parent[rb] = ra
    comps = len({find(f) for f in range(len(vtx_idx))})
    return comps, n_edges, non_manifold, boundary


def find_quads(vtx_idx: np.ndarray, show_edges: np.ndarray):
    """Polygon counts recovered from the fan-diagonal flags
    (TriangleMesh.cpp:1432-1457): (triangles, polygons, real edges).
    show_edges[f] = the visibility of edges (ij, jk, ik), the reference's
    edge order."""
    edge_visible = {}
    n_triangles = 0
    for f, (a, b, c) in enumerate(vtx_idx):
        se = show_edges[f]
        edge_visible[_edge_key(a, b)] = bool(se[0])
        edge_visible[_edge_key(b, c)] = bool(se[1])
        edge_visible[_edge_key(a, c)] = bool(se[2])
        if se[0] and se[1] and se[2]:
            n_triangles += 1
    n_hidden = sum(1 for v in edge_visible.values() if not v)
    n_real_edges = len(edge_visible) - n_hidden
    n_facets = len(vtx_idx) - n_hidden
    return n_triangles, n_facets - n_triangles, n_real_edges


def mesh_info(md) -> MeshInfo:
    """Full diagnostics of a host MeshData (io/obj.py)."""
    comps, n_edges, non_manifold, boundary = connected_components(md.vtx_idx)
    ntri, npoly, nreal = find_quads(md.vtx_idx, md.show_edges)
    euler = len(md.vertices) - n_edges + len(md.vtx_idx)
    return MeshInfo(
        n_triangles=ntri, n_polygons=npoly, n_real_edges=nreal,
        n_edges=n_edges, n_components=comps, n_non_manifold=non_manifold,
        n_boundary_edges=boundary, euler=euler, genus=(2 * comps - euler)
        / 2.0)


def color_anisotropy(vertices: np.ndarray, vtx_idx: np.ndarray):
    """Per-face anisotropy colour (TriangleMesh.h:168-190): the largest
    |cos| of the triangle's corner angles through a hue ramp."""
    a = vertices[vtx_idx[:, 0]]
    b = vertices[vtx_idx[:, 1]]
    c = vertices[vtx_idx[:, 2]]

    def cosang(u, v):
        nu = np.linalg.norm(u, axis=1)
        nv = np.linalg.norm(v, axis=1)
        return np.abs(np.sum(u * v, axis=1)) / np.maximum(nu * nv, 1e-20)

    m = np.maximum(cosang(b - a, c - a),
                   np.maximum(cosang(a - b, c - b), cosang(a - c, b - c)))
    aniso = np.degrees(np.arccos(np.clip(m, -1, 1)))
    hue = np.clip(aniso / 60.0 * 240.0, 0.0, 240.0)
    return transform_hue(np.array([1.0, 0.0, 0.0]), hue)


def transform_hue(rgb: np.ndarray, hue_deg):
    """Hue rotation of a colour (the reference's TransformH): (F, 3)."""
    hue = np.radians(np.atleast_1d(hue_deg))
    cos_a = np.cos(hue)
    sin_a = np.sin(hue)
    one3 = 1.0 / 3.0
    sq3 = np.sqrt(1.0 / 3.0)
    m = np.empty((len(hue), 3, 3))
    m[:, 0, 0] = cos_a + (1 - cos_a) * one3
    m[:, 0, 1] = one3 * (1 - cos_a) - sq3 * sin_a
    m[:, 0, 2] = one3 * (1 - cos_a) + sq3 * sin_a
    m[:, 1, 0] = one3 * (1 - cos_a) + sq3 * sin_a
    m[:, 1, 1] = cos_a + one3 * (1 - cos_a)
    m[:, 1, 2] = one3 * (1 - cos_a) - sq3 * sin_a
    m[:, 2, 0] = one3 * (1 - cos_a) - sq3 * sin_a
    m[:, 2, 1] = one3 * (1 - cos_a) + sq3 * sin_a
    m[:, 2, 2] = cos_a + one3 * (1 - cos_a)
    return np.clip(np.einsum('fij,j->fi', m, rgb), 0.0, 1.0)


def random_colors(facecolors: np.ndarray, seed: int = 0):
    """Hash recolouring of face colours (TriangleMesh.h:192-204)."""
    rng = np.random.default_rng(seed)
    r1, r2, r3 = (int(rng.integers(1, 10001)) for _ in range(3))
    c = (facecolors * 1024).astype(np.int64)

    def h(x, r, k1, k2):
        return ((x * r + x * x * (r + k1) + x * k2 + r + 3) % 1024) / 1024.0

    return np.stack([h(c[:, 0], r1, 1, 15), h(c[:, 1], r2, 9, 7),
                     h(c[:, 2], r3, 3, 18)], axis=-1)


def save_anisotropy_legend(path: str):
    """The 240x30 hue-strip legend PNG that colorAnisotropy writes beside
    its face colours (TriangleMesh.h:181-190): row i = TransformH(red, i
    degrees), gamma 2.2 encoded.  Returns the uint8 image."""
    img = np.zeros((240, 30, 3), np.float32)
    for i in range(240):
        img[i, :] = transform_hue(np.asarray([1.0, 0.0, 0.0]), float(i))[0]
    u8 = (np.clip(img, 0.0, 1.0) ** (1.0 / 2.2) * 255.0).astype(np.uint8)
    from ..io import image as image_io
    image_io.save_image(path, u8)
    return u8


def _weld_vertices(vertices: np.ndarray, vtx_idx: np.ndarray):
    """Remap triangle indices so exactly-coincident positions share one
    index (pole rings / seams are often duplicated in grids and OBJ
    exports).  Exact float equality only — a tolerance weld would merge
    genuinely distinct geometry.  Returns (n_welded_vertices, (T,3) i64)."""
    v = np.ascontiguousarray(vertices.astype(np.float32, copy=False))
    key = v.view([('x', np.float32), ('y', np.float32),
                  ('z', np.float32)]).reshape(-1)
    uniq, inv = np.unique(key, return_inverse=True)
    return len(uniq), inv[np.asarray(vtx_idx, np.int64)]


def _cc_roots(n: int, edges: np.ndarray) -> np.ndarray:
    """Vectorized connected-component roots over n nodes / (E,2) edges.

    Hook-and-shortcut label propagation: O(log n) rounds of O(E) numpy
    work, fast enough for the multi-million-vertex meshes the
    backface-cull gate must inspect at load time."""
    parent = np.arange(n, dtype=np.int64)
    e0, e1 = edges[:, 0], edges[:, 1]
    while True:
        p0, p1 = parent[e0], parent[e1]
        hi = np.maximum(p0, p1)
        lo = np.minimum(p0, p1)
        m = hi != lo
        if not m.any():
            return parent
        np.minimum.at(parent, hi[m], lo[m])
        while True:
            pp = parent[parent]
            if np.array_equal(pp, parent):
                break
            parent = pp


def closed_orientation(vertices: np.ndarray, vtx_idx: np.ndarray) -> int:
    """_closed_orientation, cached for the same arrays (utils.hostcache)."""
    vertices, vtx_idx = np.asarray(vertices), np.asarray(vtx_idx)
    return hostcache.cached('orientation', hostcache.digest(
        vertices, vtx_idx), lambda: _closed_orientation(vertices, vtx_idx))


def _closed_orientation(vertices: np.ndarray, vtx_idx: np.ndarray) -> int:
    """+1 / -1 iff the indexed mesh is a CLOSED, consistently wound
    2-manifold whose shells all agree on orientation (+1 = outward
    normals, -1 = inward, via per-shell signed volume); 0 otherwise.

    This is the geometric soundness gate for cluster back-face culling
    (ops/cluster normal-bound cull): for a closed oriented surface, a ray
    whose origin lies outside can only FIRST hit a front-facing triangle,
    so clusters that are entirely back-facing for a ray's direction can
    be skipped without ever changing the closest hit.

    Checks, all vectorized for multi-million-triangle meshes:
      * exact-duplicate positions welded (grid seams / pole rings);
      * index-degenerate faces dropped (zero area, unhittable);
      * every directed edge appears EXACTLY once (consistent winding,
        no fins) and its reverse exists (no boundary);
      * per-shell (connected component of the welded vertex graph)
        signed volumes all share one sign.
    """
    if len(vtx_idx) == 0:
        return 0
    nv, f = _weld_vertices(vertices, vtx_idx)
    deg = ((f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2])
           | (f[:, 0] == f[:, 2]))
    f = f[~deg]
    if len(f) == 0:
        return 0
    he = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    code = he[:, 0] * nv + he[:, 1]
    sc = np.sort(code)
    if np.any(sc[1:] == sc[:-1]):
        return 0                       # repeated directed edge (fin/fold)
    # closure: since every directed edge is unique, the surface is closed
    # iff the reversed-edge multiset equals the edge multiset
    rcode = he[:, 1] * nv + he[:, 0]
    if not np.array_equal(np.sort(rcode), sc):
        return 0                       # boundary edge
    # per-shell signed volume: sum of dot(a, cross(b, c))/6 over faces,
    # grouped by the vertex component of each face
    v = vertices.astype(np.float64)
    a, b, c = v[vtx_idx[~deg, 0]], v[vtx_idx[~deg, 1]], v[vtx_idx[~deg, 2]]
    contrib = np.einsum('ij,ij->i', a, np.cross(b, c)) / 6.0
    roots = _cc_roots(nv, f[:, :2])
    comp = roots[f[:, 0]]
    _, cidx = np.unique(comp, return_inverse=True)
    vols = np.bincount(cidx, weights=contrib)
    if np.all(vols > 1e-12):
        return 1
    if np.all(vols < -1e-12):
        return -1
    return 0
