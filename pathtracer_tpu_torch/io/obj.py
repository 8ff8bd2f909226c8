"""Host-side OBJ/MTL loading (counterpart of pathtracer_tpu/io/obj.py).

The JAX package's loader, copied so the port imports nothing of it:
TriMesh::readOBJ / MTL parsing / init transform (reference:
TriangleMesh.cpp:240-569 reader, :718-841 init).  Pure numpy plus the
native tokenizer (native/obj_parser.cpp, compiled by g++ into the port's
build directory at first use, as the BVH builder is); runs once at
scene-build time.

Reference behaviors reproduced:
  * fan triangulation of n-gons with showEdges flags marking real polygon
    edges (TriangleMesh.cpp:314-458),
  * negative (relative) indices, v/vt/vn index combos, per-vertex colors on
    6-float "v" lines (clamped to [0,1], :278-287),
  * usemtl -> group ids, first mtllib wins (:258-270),
  * MTL: per-group constant Kd/Ks/Ns multipliers; illum 0/1 zeroes Ks
    (:537-560); map_Kd/map_Ks/map_Bump/map_d texture file references
    (:504-535) are recorded (texture loading in texture.py),
  * default per-group material slate Kd=0.5 grey, Ks=0, Ns=0, alpha=1,
    refr=1.3, transp-mask=1 (:481-490),
  * axis swap x<->z with negated x (:742-751), unit-box normalize + center +
    scale + offset (:753-770),
  * face normals appended for faces missing vertex normals (:652-674),
  * per-vertex tangent/bitangent accumulation with handedness (:601-711).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import numpy as np

from .. import device


@dataclasses.dataclass
class GroupMaterial:
    """Per-usemtl-group material (the reference's 8 texture channels with
    constant multipliers; texture file paths resolved lazily)."""

    kd: np.ndarray = None            # (3,) multiplier
    ks: np.ndarray = None
    ns: np.ndarray = None            # phong exponent (RGB)
    map_kd: Optional[str] = None
    map_ks: Optional[str] = None
    map_bump: Optional[str] = None
    map_d: Optional[str] = None

    def __post_init__(self):
        if self.kd is None:
            self.kd = np.array([0.5, 0.5, 0.5], np.float32)
        if self.ks is None:
            self.ks = np.zeros(3, np.float32)
        if self.ns is None:
            self.ns = np.zeros(3, np.float32)


@dataclasses.dataclass
class MeshData:
    """Loaded, transformed mesh ready for BVH build / device upload."""

    vertices: np.ndarray          # (V,3) f32
    normals: np.ndarray           # (Nn,3) f32 (face normals appended)
    uvs: np.ndarray               # (U,2) f32
    vtx_idx: np.ndarray           # (T,3) int32
    uv_idx: np.ndarray            # (T,3) int32, -1 if absent
    n_idx: np.ndarray             # (T,3) int32 (filled by face normals)
    group: np.ndarray             # (T,) int32
    show_edges: np.ndarray        # (T,3) bool
    vertex_colors: Optional[np.ndarray]  # (V,3) or None
    materials: List[GroupMaterial]
    group_names: Dict[str, int]
    tangents: Optional[np.ndarray] = None     # (V,3)
    bitangents: Optional[np.ndarray] = None   # (V,3)
    obj_dir: str = ''

    @property
    def num_triangles(self):
        return self.vtx_idx.shape[0]


def _resolve_idx(i, n):
    """OBJ 1-based / negative-relative index -> 0-based (TriangleMesh.cpp:333)."""
    return n + i if i < 0 else i - 1


_FACE_RE = re.compile(r'(-?\d+)(?:/(-?\d*)(?:/(-?\d+))?)?')


_native_obj_lib = None
_native_obj_tried = False


def _load_native_obj():
    """Compile (once, into the port's build directory) and load the C++
    OBJ tokenizer via ctypes; None when no g++ is available."""
    global _native_obj_lib, _native_obj_tried
    if _native_obj_tried:
        return _native_obj_lib
    _native_obj_tried = True
    import ctypes
    import subprocess
    src = os.path.join(device.PKG_DIR, 'native', 'obj_parser.cpp')
    try:
        lib = device.build_shared(src, 'libptobj.so',
                                  ['g++', '-O3', '-shared', '-fPIC'],
                                  timeout=120)
        dll = ctypes.CDLL(lib)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    dll.pt_obj_parse.restype = ctypes.c_void_p
    dll.pt_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_long]
    dll.pt_obj_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.pt_obj_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
    dll.pt_obj_free.argtypes = [ctypes.c_void_p]
    _native_obj_lib = dll
    return _native_obj_lib


def _read_obj_native(path: str) -> Optional[MeshData]:
    """C++ tokenizer path (native/obj_parser.cpp): byte-identical arrays
    to the Python loop (tests/test_torch_io.py), ~50-100x faster — the
    reference's C++ fscanf loop (TriangleMesh.cpp:240-469) holds the same
    office-scale (23.7M tris) load-seconds contract."""
    import ctypes
    dll = _load_native_obj()
    if dll is None:
        return None
    with open(path, 'rb') as f:
        buf = f.read()
    h = dll.pt_obj_parse(buf, len(buf))
    if not h:
        return None
    try:
        sizes = np.zeros(8, np.int64)
        dll.pt_obj_sizes(h, sizes.ctypes.data_as(ctypes.c_void_p))
        (nv, ncol, nuv, nn, ntri, names_len, mtllib_len,
         ngroups) = (int(x) for x in sizes)
        verts = np.empty((nv, 3), np.float32)
        vcols = np.empty((ncol, 3), np.float32)
        uvs = np.empty((nuv, 2), np.float32)
        norms = np.empty((nn, 3), np.float32)
        vtx = np.empty((ntri, 3), np.int32)
        uvi = np.empty((ntri, 3), np.int32)
        ni = np.empty((ntri, 3), np.int32)
        grp = np.empty(ntri, np.int32)
        show = np.empty((ntri, 3), np.uint8)
        names_buf = ctypes.create_string_buffer(max(names_len, 1))
        mtllib_buf = ctypes.create_string_buffer(max(mtllib_len, 1))

        def p(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        dll.pt_obj_fetch(h, p(verts), p(vcols), p(uvs), p(norms), p(vtx),
                         p(uvi), p(ni), p(grp), p(show),
                         ctypes.cast(names_buf, ctypes.c_void_p),
                         ctypes.cast(mtllib_buf, ctypes.c_void_p))
    finally:
        dll.pt_obj_free(h)

    if ngroups:
        names = names_buf.raw[:names_len].decode('utf-8', errors='replace')
        group_names = {nm: i for i, nm in enumerate(names.split('\n'))}
        assert len(group_names) == ngroups
    else:
        group_names = {'Default': 0}
        grp = np.zeros(ntri, np.int32)
    matfile = (mtllib_buf.raw[:mtllib_len].decode('utf-8', errors='replace')
               if mtllib_len else None)
    return MeshData(
        vertices=verts, normals=norms, uvs=uvs,
        vtx_idx=vtx, uv_idx=uvi, n_idx=ni, group=grp,
        show_edges=show.astype(bool),
        vertex_colors=vcols if (ncol == nv and ncol > 0) else None,
        materials=[GroupMaterial() for _ in range(len(group_names))],
        group_names=group_names,
        obj_dir=os.path.dirname(os.path.abspath(path)),
    ), matfile


def read_obj(path: str, load_materials: bool = True) -> MeshData:
    """Load an OBJ: native C++ tokenizer when available (office-scale
    files in seconds), the reference-exact Python loop otherwise
    (PT_NO_NATIVE_OBJ=1 forces it — the parity oracle)."""
    if os.environ.get('PT_NO_NATIVE_OBJ') != '1':
        out = _read_obj_native(path)
        if out is not None:
            md, matfile = out
            if load_materials and matfile:
                mtl_path = os.path.join(md.obj_dir, matfile)
                if os.path.exists(mtl_path):
                    _read_mtl(mtl_path, md.group_names, md.materials)
            return md
    return _read_obj_python(path, load_materials)


def _read_obj_python(path: str, load_materials: bool = True) -> MeshData:
    vertices: List = []
    vertexcolors: List = []
    normals: List = []
    uvs: List = []
    tris = []          # (vtx3, uv3, n3, group, show_edges3)
    group_names: Dict[str, int] = {}
    cur_group = -1
    matfile = None

    with open(path, 'r', errors='replace') as f:
        for raw in f:
            line = raw.rstrip(' \r\t\n')
            if line.startswith('usemtl'):
                name = line[6:].strip()
                if name not in group_names:
                    group_names[name] = len(group_names)
                cur_group = group_names[name]
            elif line.startswith('mtllib'):
                matfile = line[6:].strip()
            elif line.startswith('v '):
                parts = line.split()
                vals = [float(x) for x in parts[1:7]]
                vertices.append(vals[:3])
                if len(vals) == 6:
                    vertexcolors.append(np.clip(vals[3:6], 0.0, 1.0))
            elif line.startswith('vn'):
                parts = line.split()
                normals.append([float(x) for x in parts[1:4]])
            elif line.startswith('vt'):
                parts = line.split()
                uvs.append([float(x) for x in parts[1:3]])
            elif line.startswith('f ') or line.startswith('f\t'):
                corners = _FACE_RE.findall(line[1:])
                if len(corners) < 3:
                    continue
                nv, nu, nn = len(vertices), len(uvs), len(normals)

                def corner(c):
                    vi = _resolve_idx(int(c[0]), nv)
                    ui = _resolve_idx(int(c[1]), nu) if c[1] else -1
                    ni = _resolve_idx(int(c[2]), nn) if c[2] else -1
                    return vi, ui, ni

                cs = [corner(c) for c in corners]
                # fan triangulation; showEdges marks real polygon borders
                # (TriangleMesh.cpp:322-323 first tri, :396-397 fan tris)
                for k in range(1, len(cs) - 1):
                    first = (k == 1)
                    last = (k == len(cs) - 2)
                    v3 = (cs[0][0], cs[k][0], cs[k + 1][0])
                    u3 = (cs[0][1], cs[k][1], cs[k + 1][1])
                    n3 = (cs[0][2], cs[k][2], cs[k + 1][2])
                    show = (first, True, last)
                    tris.append((v3, u3, n3, cur_group, show))

    if not group_names:
        group_names['Default'] = 0
        tris = [(v, u, n, 0, s) for (v, u, n, g, s) in tris]

    materials = [GroupMaterial() for _ in range(len(group_names))]
    obj_dir = os.path.dirname(os.path.abspath(path))
    if load_materials and matfile:
        mtl_path = os.path.join(obj_dir, matfile)
        if os.path.exists(mtl_path):
            _read_mtl(mtl_path, group_names, materials)

    md = MeshData(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        normals=(np.asarray(normals, np.float32).reshape(-1, 3)
                 if normals else np.zeros((0, 3), np.float32)),
        uvs=(np.asarray(uvs, np.float32).reshape(-1, 2)
             if uvs else np.zeros((0, 2), np.float32)),
        vtx_idx=np.asarray([t[0] for t in tris], np.int32).reshape(-1, 3),
        uv_idx=np.asarray([t[1] for t in tris], np.int32).reshape(-1, 3),
        n_idx=np.asarray([t[2] for t in tris], np.int32).reshape(-1, 3),
        group=np.asarray([t[3] for t in tris], np.int32),
        show_edges=np.asarray([t[4] for t in tris], bool).reshape(-1, 3),
        vertex_colors=(np.asarray(vertexcolors, np.float32)
                       if len(vertexcolors) == len(vertices) and vertexcolors
                       else None),
        materials=materials,
        group_names=group_names,
        obj_dir=obj_dir,
    )
    return md


def _read_mtl(path: str, group_names: Dict[str, int],
              materials: List[GroupMaterial]):
    """MTL parsing (reference: TriangleMesh.cpp:493-564)."""
    cur = None
    illum = -1
    with open(path, 'r', errors='replace') as f:
        for raw in f:
            line = raw.strip()
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == 'newmtl':
                name = line[6:].strip()
                cur = group_names.get(name)
                illum = -1
            elif cur is None:
                continue
            elif key == 'Kd':
                materials[cur].kd = np.asarray(
                    [float(x) for x in parts[1:4]], np.float32)
            elif key == 'Ks':
                ks = np.asarray([float(x) for x in parts[1:4]], np.float32)
                if illum in (0, 1):
                    ks = np.zeros(3, np.float32)
                materials[cur].ks = ks
            elif key == 'Ns':
                vals = [float(x) for x in parts[1:4]]
                if len(vals) == 1:
                    vals = vals * 3
                materials[cur].ns = np.asarray(vals, np.float32)
            elif key == 'illum':
                illum = int(float(parts[1]))
                if illum in (0, 1):
                    materials[cur].ks = np.zeros(3, np.float32)
            elif key == 'map_Kd':
                materials[cur].map_kd = line[6:].strip()
            elif key == 'map_Ks':
                materials[cur].map_ks = line[6:].strip()
            elif key in ('map_Bump', 'map_bump'):
                materials[cur].map_bump = line[8:].strip()
            elif key == 'map_d':
                materials[cur].map_d = line[5:].strip()


def seg_colors(labels: np.ndarray) -> np.ndarray:
    """Per-face overlay color from an integer label, with the reference's
    exact hash formula (mainApp.cpp:2331): for label u,
      r = ((u*u*(u+2)*123 + 51) % 1000) / 1000
      g = ((u*(u+7)*456 + 266) % 1000) / 1000
      b = ((u*u*u*5 + u*33 + 687) % 1000) / 1000
    """
    u = np.asarray(labels, np.int64)
    r = ((u * u * (u + 2) * 123 + 51) % 1000) / 1000.0
    g = ((u * (u + 7) * 456 + 266) % 1000) / 1000.0
    b = ((u * u * u * 5 + u * 33 + 687) % 1000) / 1000.0
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def load_seg(path: str, num_triangles: int) -> np.ndarray:
    """.seg face-label file -> (T,3) facecolors in ORIGINAL triangle order
    (reference: mainApp.cpp:2311-2338 — one integer label per face line,
    hashed to a color; labels beyond T are ignored)."""
    labels = np.zeros(num_triangles, np.int64)
    with open(path) as f:
        for faceid, tok in enumerate(f.read().split()):
            if faceid < num_triangles:
                labels[faceid] = int(tok)
    return seg_colors(labels)


def load_lab(path: str, num_triangles: int) -> np.ndarray:
    """.lab segmentation file -> (T,3) facecolors (reference:
    mainApp.cpp:2340-2377): alternating name line / face-id line pairs;
    face ids are 1-BASED; segment index drives the hash color."""
    colors = np.zeros((num_triangles, 3), np.float32)
    with open(path) as f:
        lines = [ln.rstrip('\n') for ln in f]
    seg_id = 0
    for i in range(0, len(lines) - 1, 2):
        ids = np.asarray([int(x) for x in lines[i + 1].split()], np.int64) - 1
        ids = ids[(ids >= 0) & (ids < num_triangles)]
        colors[ids] = seg_colors(np.asarray([seg_id]))[0]
        seg_id += 1
    return colors


def load_edge_csv(path: str, md: MeshData):
    """Per-edge color map from a cut-analysis CSV (reference:
    TriMesh::load_edge_colors, TriangleMesh.cpp:132-210).

    Each data line is `cut val0 val1 idFace0 n0x n0y n0z idFace1 n1x n1y
    n1z`; the FACE pair maps to its shared vertex edge, whose color is
    the red->white lerp by v = (clamp(val0)+clamp(val1))/2.  Returns
    (edge_colors (T,3,3) f32, edge_mask (T,3) bool) in ORIGINAL triangle
    order, slot layout matching getMaterial's crossing test (scene.py):
    slot 1 = edge (j,k) (the alpha < 0.05 edge), slot 2 = (i,k), slot
    0 = (i,j)."""
    vt = np.asarray(md.vtx_idx, np.int64)
    t = len(vt)
    # undirected edge -> [faces]
    pairs = np.concatenate([
        np.stack([vt[:, 1], vt[:, 2]], 1),   # slot 1 (alpha edge)
        np.stack([vt[:, 0], vt[:, 2]], 1),   # slot 2 (beta edge)
        np.stack([vt[:, 0], vt[:, 1]], 1),   # slot 0 (gamma edge)
    ])
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    nv = int(vt.max()) + 1
    ecode = lo * nv + hi
    e2f = {}
    for row, code in enumerate(ecode):
        e2f.setdefault(int(code), []).append(row % t)
    # (min face, max face) -> vertex-edge code
    f2e = {}
    for code, faces in e2f.items():
        fs = sorted(set(faces))
        if len(fs) == 2:
            f2e[(fs[0], fs[1])] = code
    edge_color = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) != 11:
                continue
            val0 = min(1.0, max(0.0, float(tok[1])))
            val1 = min(1.0, max(0.0, float(tok[2])))
            f0, f1 = int(tok[3]), int(tok[7])
            code = f2e.get((min(f0, f1), max(f0, f1)))
            if code is None:
                continue
            v = 0.5 * (val0 + val1)
            edge_color[code] = np.asarray(
                [v + (1.0 - v), v, v], np.float32)   # lerp(red, white, v)
    colors = np.zeros((3 * t, 3), np.float32)
    mask = np.zeros(3 * t, bool)
    for row, code in enumerate(ecode):
        c = edge_color.get(int(code))
        if c is not None:
            colors[row] = c
            mask[row] = True
    # rows were stacked [slot1 | slot2 | slot0]
    out_c = np.zeros((t, 3, 3), np.float32)
    out_m = np.zeros((t, 3), bool)
    out_c[:, 1], out_c[:, 2], out_c[:, 0] = (colors[:t], colors[t:2 * t],
                                             colors[2 * t:])
    out_m[:, 1], out_m[:, 2], out_m[:, 0] = (mask[:t], mask[t:2 * t],
                                             mask[2 * t:])
    return out_c, out_m


def transform_mesh(md: MeshData, scaling: float = 1.0,
                   offset=(0.0, 0.0, 0.0), preserve_input: bool = False,
                   center: bool = True) -> MeshData:
    """Axis swap + unit-box normalize (reference: TriangleMesh.cpp:742-770)."""
    if preserve_input:
        return md
    v = md.vertices.copy()
    v[:, [0, 2]] = v[:, [2, 0]]
    v[:, 0] = -v[:, 0]
    n = md.normals.copy()
    if len(n):
        n[:, [0, 2]] = n[:, [2, 0]]
        n[:, 0] = -n[:, 0]
    if center and len(v):
        lo, hi = v.min(0), v.max(0)
        s = float(max(hi - lo))
        c = (lo + hi) * 0.5
        v = (v - c) / s * scaling + np.asarray(offset, np.float32)
    md.vertices = v.astype(np.float32)
    md.normals = n.astype(np.float32)
    return md


def fill_face_normals(md: MeshData) -> MeshData:
    """Append face normals for corners missing vertex normals
    (reference: TriangleMesh.cpp:652-674)."""
    need = (md.n_idx < 0).any()
    if not need:
        return md
    a = md.vertices[md.vtx_idx[:, 0]]
    b = md.vertices[md.vtx_idx[:, 1]]
    c = md.vertices[md.vtx_idx[:, 2]]
    fn = np.cross(b - a, c - a)
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = fn / np.maximum(ln, 1e-20)
    missing = (md.n_idx < 0).any(axis=1)
    new_ids = np.arange(missing.sum(), dtype=np.int32) + len(md.normals)
    normals = np.concatenate([md.normals, fn[missing]], axis=0)
    n_idx = md.n_idx.copy()
    rows = np.where(missing)[0]
    for col in range(3):
        mask = n_idx[rows, col] < 0
        n_idx[rows[mask], col] = new_ids[mask]
    md.normals = normals.astype(np.float32)
    md.n_idx = n_idx
    return md


def setup_tangents(md: MeshData) -> MeshData:
    """Per-vertex tangent/bitangent accumulation with handedness
    (reference: TriangleMesh.cpp:601-711), vectorized."""
    nv = len(md.vertices)
    tan1 = np.zeros((nv, 3), np.float64)
    tan2 = np.zeros((nv, 3), np.float64)
    has_uv = (md.uv_idx >= 0).all(axis=1) & (len(md.uvs) > 0)
    if has_uv.any():
        t = np.where(has_uv)[0]
        a, b, c = md.vtx_idx[t, 0], md.vtx_idx[t, 1], md.vtx_idx[t, 2]
        va = md.vertices[b] - md.vertices[a]
        vb = md.vertices[c] - md.vertices[a]
        sa = md.uvs[md.uv_idx[t, 1]] - md.uvs[md.uv_idx[t, 0]]
        sb = md.uvs[md.uv_idx[t, 2]] - md.uvs[md.uv_idx[t, 0]]
        det = sa[:, 0] * sb[:, 1] - sb[:, 0] * sa[:, 1]
        safe = det != 0
        inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
        sdir = np.where(safe[:, None],
                        (sb[:, 1:2] * va - sa[:, 1:2] * vb) * inv[:, None],
                        va * 1e-5)
        tdir = np.where(safe[:, None],
                        (sa[:, 0:1] * vb - sb[:, 0:1] * va) * inv[:, None],
                        vb * 1e-5)
        for vid, dirs in ((a, sdir), (b, sdir), (c, sdir)):
            np.add.at(tan1, vid, dirs)
        for vid, dirs in ((a, tdir), (b, tdir), (c, tdir)):
            np.add.at(tan2, vid, dirs)

    # vertex -> normal id map (last triangle wins, TriangleMesh.cpp:676-681)
    v2n = np.zeros(nv, np.int32)
    for col in range(3):
        v2n[md.vtx_idx[:, col]] = md.n_idx[:, col]
    n = md.normals[v2n]
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    t1 = tan1 - n * np.sum(tan1 * n, axis=-1, keepdims=True)
    t1 = t1 / np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-20)
    w = np.where(np.sum(np.cross(n, tan1) * tan2, axis=-1) < 0, -1.0, 1.0)
    md.tangents = t1.astype(np.float32)
    md.bitangents = (np.cross(n, t1) * w[:, None]).astype(np.float32)
    return md


def read_off(path: str) -> MeshData:
    """OFF reader (reference: TriMesh::readOFF, TriangleMesh.cpp:107-130):
    header, counts, vertex lines, n-gon faces fan-triangulated."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    head = next(it)
    assert head.upper().startswith('OFF'), 'not an OFF file'
    nv, nf, _ne = int(next(it)), int(next(it)), int(next(it))
    verts = np.array([[float(next(it)) for _ in range(3)] for _ in range(nv)],
                     np.float32)
    tris = []
    for _ in range(nf):
        k = int(next(it))
        idx = [int(next(it)) for _ in range(k)]
        for j in range(1, k - 1):
            tris.append(((idx[0], idx[j], idx[j + 1]),
                         (j == 1, True, j == k - 2)))
    vtx = np.asarray([t[0] for t in tris], np.int32).reshape(-1, 3)
    se = np.asarray([t[1] for t in tris], bool).reshape(-1, 3)
    t = len(vtx)
    return MeshData(
        vertices=verts, normals=np.zeros((0, 3), np.float32),
        uvs=np.zeros((0, 2), np.float32), vtx_idx=vtx,
        uv_idx=np.full((t, 3), -1, np.int32),
        n_idx=np.full((t, 3), -1, np.int32),
        group=np.zeros(t, np.int32), show_edges=se, vertex_colors=None,
        materials=[GroupMaterial()], group_names={'Default': 0},
        obj_dir=os.path.dirname(os.path.abspath(path)))


def read_vrml(path: str) -> MeshData:
    """Minimal VRML reader (reference: TriMesh::readVRML,
    TriangleMesh.cpp:10-104): Coordinate point blocks + coordIndex faces
    with -1 separators, fan-triangulated."""
    text = open(path, errors='replace').read()
    verts = []
    tris = []

    def block_after(key, start):
        k = text.find(key, start)
        if k < 0:
            return None, -1
        a = text.find('[', k)
        b = text.find(']', a)
        return text[a + 1:b], b

    pos = 0
    while True:
        blk, pos = block_after('point', pos)
        if blk is None:
            break
        vals = [float(x) for x in blk.replace(',', ' ').split()]
        verts.extend([vals[i:i + 3] for i in range(0, len(vals) - 2, 3)])
    pos = 0
    while True:
        blk, pos = block_after('coordIndex', pos)
        if blk is None:
            break
        idx = [int(x) for x in blk.replace(',', ' ').split()]
        poly = []
        for v in idx:
            if v == -1:
                for j in range(1, len(poly) - 1):
                    tris.append(((poly[0], poly[j], poly[j + 1]),
                                 (j == 1, True, j == len(poly) - 2)))
                poly = []
            else:
                poly.append(v)
        if len(poly) >= 3:
            for j in range(1, len(poly) - 1):
                tris.append(((poly[0], poly[j], poly[j + 1]),
                             (j == 1, True, j == len(poly) - 2)))
    vtx = np.asarray([t[0] for t in tris], np.int32).reshape(-1, 3)
    se = np.asarray([t[1] for t in tris], bool).reshape(-1, 3)
    t = len(vtx)
    return MeshData(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        normals=np.zeros((0, 3), np.float32),
        uvs=np.zeros((0, 2), np.float32), vtx_idx=vtx,
        uv_idx=np.full((t, 3), -1, np.int32),
        n_idx=np.full((t, 3), -1, np.int32),
        group=np.zeros(t, np.int32), show_edges=se, vertex_colors=None,
        materials=[GroupMaterial()], group_names={'Default': 0},
        obj_dir=os.path.dirname(os.path.abspath(path)))


def save_obj(md: MeshData, path: str, mtl_name: Optional[str] = None):
    """OBJ writer (reference: TriMesh::saveOBJ, TriangleMesh.cpp:888-916)."""
    with open(path, 'w') as f:
        if mtl_name:
            f.write(f'mtllib {mtl_name}\n')
        for v in md.vertices:
            f.write(f'v {v[0]} {v[1]} {v[2]}\n')
        name_by_id = {v: k for k, v in md.group_names.items()}
        cur = None
        for i, tri in enumerate(md.vtx_idx):
            g = int(md.group[i])
            if g != cur:
                f.write(f'usemtl {name_by_id.get(g, f"mat{g}")}\n')
                cur = g
            f.write(f'f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n')


def export_mtl(md: MeshData, path: str):
    """MTL writer (reference: TriMesh::exportMTL, TriangleMesh.cpp:571-598)."""
    with open(path, 'w') as f:
        for name, gid in md.group_names.items():
            m = md.materials[gid]
            f.write(f'newmtl {name}\n')
            f.write(f'Kd {m.kd[0]} {m.kd[1]} {m.kd[2]}\n')
            if m.map_kd:
                f.write(f'map_Kd {m.map_kd}\n')
            f.write(f'Ks {m.ks[0]} {m.ks[1]} {m.ks[2]}\n')
            if m.map_ks:
                f.write(f'map_Ks {m.map_ks}\n')
            f.write(f'Ns {m.ns[0]}\n')
            if m.map_d:
                f.write(f'map_d {m.map_d}\n')
            if m.map_bump:
                f.write(f'map_bump {m.map_bump}\n')


def load_mesh(path: str, scaling: float = 30.0, offset=(0.0, 0.0, 0.0),
              preserve_input: bool = False, center: bool = True,
              load_materials: bool = True) -> MeshData:
    """Full load pipeline matching TriMesh::init (TriangleMesh.cpp:718-841):
    format dispatch by extension (.obj/.off/.wrl, :731-740), axis swap,
    normalize, face normals, tangents.

    Default scaling 30 + drop-on-ground offset mirrors the GUI drag-drop
    behavior (mainApp.cpp:2402-2411)."""
    low = path.lower()
    if low.endswith('.off'):
        md = read_off(path)
    elif low.endswith('.wrl'):
        md = read_vrml(path)
    else:
        md = read_obj(path, load_materials=load_materials)
    md = transform_mesh(md, scaling, offset, preserve_input, center)
    md = fill_face_normals(md)
    md = setup_tangents(md)
    return md
