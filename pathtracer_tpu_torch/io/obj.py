"""Host-side mesh containers (the OBJ loader itself is not ported yet).

Copies of `MeshData` and `GroupMaterial` from pathtracer_tpu/io/obj.py,
so procedural meshes and the scene builder share one host contract with
the JAX package.  Pure numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


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
