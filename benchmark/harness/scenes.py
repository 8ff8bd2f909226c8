"""Configuration files to scenes: the program's, through its public API,
and the reference's, from the same file and the same triangles."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import procgen


def mesh_arrays(cfg: dict):
    """(vertices, tris, normals, uvs) of the configuration's mesh, or None
    without one."""
    m = cfg.get('mesh')
    if m is None:
        return None
    if m['generator'] != 'displaced_sphere':
        raise ValueError(f'unknown mesh generator {m["generator"]!r}')
    return procgen.displaced_sphere(m['n_lat'], m['n_lon'], m['radius'],
                                    m['displace_amp'], m['seed'])


def program_scene(cfg: dict, mesh, device):
    """The program's SceneArrays and Camera for the configuration; the
    'program' block's backface_cull false turns the meshes' cull off."""
    from pathtracer_tpu_torch.core import camera as cam_mod
    from pathtracer_tpu_torch.io import obj as obj_io
    from pathtracer_tpu_torch.scene import scene as scn
    objs = []
    for o in cfg['objects']:
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in o.items() if k not in ('type', 'center', 'radius',
                                                 'point', 'normal')}
        if o['type'] == 'sphere':
            objs.append(scn.sphere(tuple(o['center']), o['radius'], **kw))
        elif o['type'] == 'plane':
            objs.append(scn.plane(tuple(o['point']), tuple(o['normal']), **kw))
        elif o['type'] == 'mesh':
            v, t, n, uv = mesh
            mat = obj_io.GroupMaterial(
                kd=np.asarray(cfg['mesh']['kd'], np.float32),
                ks=np.asarray(cfg['mesh'].get('ks', (0, 0, 0)), np.float32),
                ns=np.asarray(cfg['mesh'].get('ns', (0, 0, 0)), np.float32))
            md = obj_io.MeshData(
                vertices=v, normals=n, uvs=uv, vtx_idx=t, uv_idx=t, n_idx=t,
                group=np.zeros(len(t), np.int32),
                show_edges=np.ones((len(t), 3), bool), vertex_colors=None,
                materials=[mat], group_names={'default': 0}, tangents=None,
                obj_dir='')
            objs.append(scn.mesh_object(md, **kw))
        else:
            raise ValueError(f'unknown object type {o["type"]!r}')
    sc = scn.build_scene(objs, cfg['light_intensity'], device=device)
    cull = cfg.get('program', {}).get('backface_cull')
    if cull is not None:
        # the mesh's own switch, as the program's camera gate sets it
        sc = dataclasses.replace(sc, meshes=tuple(
            dataclasses.replace(m, backface_cull=bool(cull) and
                                m.backface_cull) for m in sc.meshes))
    c = cfg['camera']
    cam = cam_mod.make_camera(tuple(c['position']), tuple(c['direction']),
                              tuple(c['up']), fov=c['fov_deg'] * math.pi
                              / 180.0, focus_distance=c['focus_distance'],
                              aperture=c['aperture'])
    return sc, cam


def reference_scene(cfg: dict, mesh, device, dtype=None):
    """The reference's Scene and Camera for the configuration."""
    import torch
    from ..reference import scene as rscn
    from ..reference import tracer
    dtype = dtype or torch.float32
    arrays = None if mesh is None else (mesh[0], mesh[1], mesh[2])
    sc = rscn.build_scene({k: v for k, v in cfg.items() if k != 'program'},
                          arrays, device, dtype)
    return sc, tracer.Camera(cfg, device, dtype)
