"""Scene serialization as JSON (counterpart of
pathtracer_tpu/io/scene_json.py, the same format).

Counterpart of the reference's text scene format (reference:
Raytracer::save_scene/load_scene, Raytracer.cpp:1096-1236; per-object
blocks Object::save_to_file/load_from_file, Geometry.h:455-662).  Same
content — render size/spp/bounces, camera, filter/gamma, lenticular block,
light/envmap intensities, background path, typed object list, fog block —
as structured JSON with a version field instead of sscanf-lookahead
backward compatibility.

The `#`-substitution of the reference (object names containing '#' replaced
by a CLI argument for batch renders, Geometry.h:524-526, mainApp.cpp:41-44)
is kept: mesh paths containing '#' substitute the `name_subst` argument.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .. import device as device_mod
from ..core import camera as cam_mod
from ..render.renderer import RenderConfig
from ..scene import scene as scn

FORMAT_VERSION = 1


def _vec(v):
    return [float(x) for x in np.asarray(v).reshape(-1)]


def save_scene(path: str, objects, light_intensity, cam: cam_mod.Camera,
               cfg: RenderConfig, envmap_intensity: float = 1.0,
               envmap_path: Optional[str] = None,
               background_path: Optional[str] = None,
               fog: Optional[dict] = None):
    """Serialize the host-side scene description (ObjectSpecs, not device
    arrays — mirrors the reference saving source paths + parameters)."""
    doc = {
        'version': FORMAT_VERSION,
        'render': {
            'width': cfg.width, 'height': cfg.height, 'nrays': cfg.nrays,
            'bounces': cfg.nb_bounces, 'sigma_filter': cfg.sigma_filter,
            'gamma': cfg.gamma, 'seed': cfg.seed,
            'double_frustum_start_t': cfg.double_frustum_start_t,
        },
        'camera': {
            'position': _vec(cam.position), 'direction': _vec(cam.direction),
            'up': _vec(cam.up), 'fov': float(cam.fov),
            'focus_distance': float(cam.focus_distance),
            'aperture': float(cam.aperture),
        },
        'light_intensity': float(light_intensity),
        'envmap_intensity': float(envmap_intensity),
        'envmap': envmap_path,
        'background': background_path,
        'fog': fog or {'density': 0.0, 'absorption': 0.0,
                       'density_decay': 0.0, 'absorption_decay': 0.0,
                       'type': 0, 'phase_type': 0, 'phase_aniso': 0.8},
        'objects': [_object_doc(o) for o in objects],
    }
    with open(path, 'w') as f:
        json.dump(doc, f, indent=1)


def _object_doc(o: scn.ObjectSpec) -> dict:
    kind = {scn.SPHERE: 'sphere', scn.PLANE: 'plane', scn.MESH: 'mesh'}[o.obj_type]
    doc = {
        'type': kind,
        'flip_normals': bool(o.flip_normals),
        'kd': _vec(o.kd), 'ks': _vec(o.ks), 'ne': _vec(o.ne),
        'ksub': _vec(o.ksub),
        'transp': bool(o.transp), 'refr_index': float(o.refr_index),
        'miroir': bool(o.miroir), 'ghost': bool(o.ghost),
        'translation': _vec(o.translation),
        'scale': float(o.scale),
        'rotation': None if o.rotation is None else _vec(o.rotation),
        'rotation_center': None if o.rotation_center is None
        else _vec(o.rotation_center),
    }
    if kind == 'sphere':
        doc['center'] = _vec(o.center)
        doc['radius'] = float(o.radius)
    elif kind == 'plane':
        doc['point'] = _vec(o.center)
        doc['normal'] = _vec(o.normal)
    else:
        doc['mesh_path'] = getattr(o, 'mesh_path', None)
        doc['mesh_scaling'] = getattr(o, 'mesh_scaling', 30.0)
        doc['mesh_offset'] = _vec(getattr(o, 'mesh_offset', (0.0, 0.0, 0.0)))
        doc['interp_normals'] = bool(o.interp_normals)
        if o.display_edges:
            doc['display_edges'] = True
        if getattr(o, 'bilinear', False):
            doc['bilinear'] = True
        if isinstance(o.seg_path, str):
            doc['seg_path'] = o.seg_path
    # texture channel paths (path-valued entries only; in-memory arrays
    # are not serialized, matching the reference's filename-based save,
    # Geometry.h:455-520)
    if o.textures:
        tex = o.textures if isinstance(o.textures, list) else [o.textures]
        ser = [{ch: p for ch, p in (t or {}).items() if isinstance(p, str)}
               for t in tex]
        if any(ser):
            doc['textures'] = ser if isinstance(o.textures, list) else ser[0]
    return doc


def load_scene(path: str, name_subst: Optional[str] = None, device=None):
    """Load a scene JSON -> (objects, light_intensity, cam, cfg, extras).

    Mesh files are loaded through io.obj (with '#' substitution in paths,
    the reference's replacedNames mechanism); measured BRDF tables load
    onto `device` (None: the card), the camera on the CPU (Renderer moves
    it).  extras['envmap'] is the env map's path as written; its image
    comes from io.image.load_hdr."""
    from . import obj as obj_io
    device = device_mod.resolve(device)

    with open(path) as f:
        doc = json.load(f)
    assert doc.get('version', 1) <= FORMAT_VERSION

    r = doc['render']
    cfg = RenderConfig(width=r['width'], height=r['height'], nrays=r['nrays'],
                       nb_bounces=r['bounces'],
                       sigma_filter=r.get('sigma_filter', 0.5),
                       gamma=r.get('gamma', 2.2), seed=r.get('seed', 0),
                       double_frustum_start_t=r.get('double_frustum_start_t',
                                                    0.0))
    c = doc['camera']
    cam = cam_mod.make_camera(c['position'], c['direction'], c['up'],
                              fov=c['fov'],
                              focus_distance=c['focus_distance'],
                              aperture=c['aperture'])

    base_dir = os.path.dirname(os.path.abspath(path))
    objects = []
    for od in doc['objects']:
        kw = dict(
            flip_normals=od.get('flip_normals', False),
            kd=od.get('kd', (1.0, 1.0, 1.0)), ks=od.get('ks', (0.0, 0.0, 0.0)),
            ne=od.get('ne', (1.0, 1.0, 1.0)),
            ksub=od.get('ksub', (0.0, 0.0, 0.0)),
            transp=od.get('transp', False),
            refr_index=od.get('refr_index', 1.3),
            miroir=od.get('miroir', False), ghost=od.get('ghost', False),
            translation=od.get('translation', (0.0, 0.0, 0.0)),
            scale=od.get('scale', 1.0),
            rotation=(None if od.get('rotation') is None
                      else np.asarray(od['rotation']).reshape(3, 3)),
            rotation_center=od.get('rotation_center'),
        )
        if od.get('textures'):
            tex = od['textures']
            def _resolve_tex(t):
                return {ch: (p if os.path.isabs(p)
                             else os.path.join(base_dir, p))
                        for ch, p in (t or {}).items()}
            kw['textures'] = ([_resolve_tex(t) for t in tex]
                              if isinstance(tex, list) else _resolve_tex(tex))
        if od.get('merl_path') or od.get('brdf_path'):
            from ..models import merl as merl_mod
            mp = od.get('merl_path') or od['brdf_path']
            if not os.path.isabs(mp):
                mp = os.path.join(base_dir, mp)
            if os.path.exists(mp):
                # extension dispatch: .titopo/.titopoh bind TitopoBRDF
                # with the reference's grid sizes (mainApp.cpp:2418-2434)
                kw['measured_brdf'] = merl_mod.load_measured(
                    mp, device=device)
        if od['type'] == 'sphere':
            objects.append(scn.sphere(od['center'], od['radius'], **kw))
        elif od['type'] == 'plane':
            objects.append(scn.plane(od['point'], od['normal'], **kw))
        else:
            mp = od['mesh_path']
            if name_subst is not None and '#' in mp:
                mp = mp.replace('#', name_subst)
            if not os.path.isabs(mp):
                mp = os.path.join(base_dir, mp)
            md = obj_io.load_mesh(mp, scaling=od.get('mesh_scaling', 30.0),
                                  offset=tuple(od.get('mesh_offset',
                                                      (0.0, 0.0, 0.0))))
            kw['display_edges'] = bool(od.get('display_edges', False))
            kw['bilinear'] = bool(od.get('bilinear', False))
            sp = od.get('seg_path')
            if sp is not None and not os.path.isabs(sp):
                sp = os.path.join(base_dir, sp)
            kw['seg_path'] = sp
            spec = scn.mesh_object(md, **kw)
            spec.mesh_path = od['mesh_path']
            spec.mesh_scaling = od.get('mesh_scaling', 30.0)
            spec.mesh_offset = tuple(od.get('mesh_offset', (0.0, 0.0, 0.0)))
            objects.append(spec)

    extras = {
        'envmap_intensity': doc.get('envmap_intensity', 1.0),
        'envmap': doc.get('envmap'),
        'background': doc.get('background'),
        'fog': doc.get('fog'),
    }
    return objects, doc['light_intensity'], cam, cfg, extras
