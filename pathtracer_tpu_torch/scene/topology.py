"""Closed-orientation gate for the cluster backface cull.

Copy of `closed_orientation` and its helpers from
pathtracer_tpu/scene/topology.py (host numpy; the mesh diagnostics there
are not ported).
"""

from __future__ import annotations

import numpy as np

from ..utils import hostcache


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
