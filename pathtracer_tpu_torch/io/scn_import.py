"""Importer for the reference's text `.scn` scene files (counterpart of
pathtracer_tpu/io/scn_import.py).

Parses the exact format written by Raytracer::save_scene (reference:
Raytracer.cpp:1096-1146) and Object::save_to_file (Geometry.h:455-517),
including the sscanf-lookahead backward compatibility of load_scene
(Raytracer.cpp:1149-1236): optional nbframes, lenticular block, denoiser
flag, background line, fog extensions.

Returns the same (objects, light_intensity, cam, cfg, extras) tuple as
scene_json.load_scene, so existing `.scn` scenes drop straight into
build_scene.  Each ObjectSpec keeps the fields the writer reads back
(`name`, `display_edges`, `is_centered`, `envmap_file`).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from .. import device as device_mod
from ..core import camera as cam_mod
from ..render.renderer import RenderConfig
from ..scene import scene as scn


class _Lines:
    def __init__(self, text):
        self.lines = text.splitlines()
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else ''

    def next(self):
        ln = self.peek()
        self.pos += 1
        return ln

    def expect(self, prefix):
        ln = self.next()
        if not ln.startswith(prefix):
            raise ValueError(f'.scn line {self.pos}: expected {prefix!r}, '
                             f'got {ln!r}')
        return ln[len(prefix):].strip()


_NUM = r'[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?'


def _floats(s, n=None):
    vals = [float(x) for x in re.findall(_NUM, s)]
    return vals if n is None else vals[:n]


def _channel(lines, count_key):
    """Parse one texture-channel list: returns [(filename, multiplier)]."""
    n = int(_floats(lines.expect(count_key))[0])
    out = []
    for _ in range(n):
        fname = lines.expect('texture:')
        mult = _floats(lines.expect('multiplier:'))
        out.append((fname, mult))
    return out


def _object_base(lines, name_subst):
    """Object::save_to_file base fields (Geometry.h:455-517)."""
    o = {}
    o['name'] = lines.expect('name:')
    if name_subst and '#' in o['name']:
        o['name'] = o['name'].replace('#', name_subst)
    o['miroir'] = bool(int(_floats(lines.expect('miroir:'))[0]))
    if lines.peek().startswith('ghost:'):
        o['ghost'] = bool(int(_floats(lines.expect('ghost:'))[0]))
    else:
        o['ghost'] = False
    # OUR extension (peek-guarded, reference files simply lack it): a
    # measured-BRDF binding persisted by io/scn_export — the reference
    # only ever binds BRDFs by GUI drag-drop and never saves them
    # (mainApp.cpp:2418-2434), so round-tripping it here EXCEEDS parity
    if lines.peek().startswith('brdf:'):
        o['brdf'] = lines.expect('brdf:')
    else:
        o['brdf'] = None
    o['translation'] = _floats(lines.expect('translation:'), 3)
    o['rotation'] = np.asarray(_floats(lines.expect('rotation:'), 9)
                               ).reshape(3, 3)
    o['rotation_center'] = _floats(lines.expect('center:'), 3)
    o['scale'] = _floats(lines.expect('scale:'))[0]
    o['display_edges'] = bool(int(_floats(lines.expect('display_edges:'))[0]))
    o['interp_normals'] = bool(int(_floats(
        lines.expect('interp_normals:'))[0]))
    o['flip_normals'] = bool(int(_floats(lines.expect('flip_normals:'))[0]))
    nkf = int(_floats(lines.expect('nb_transforms:'))[0])
    # keyframe lines: nkf scale rows, nkf translation rows, nkf rotation rows
    kfs = {}
    for _ in range(nkf):
        f, s = _floats(lines.next(), 2)
        kfs.setdefault(f, {})['scale'] = s
    for _ in range(nkf):
        vals = _floats(lines.next(), 4)
        kfs.setdefault(vals[0], {})['translation'] = vals[1:4]
    for _ in range(nkf):
        vals = _floats(lines.next(), 10)
        kfs.setdefault(vals[0], {})['rotation'] = np.asarray(
            vals[1:10]).reshape(3, 3)
    o['keyframes'] = kfs or None

    chans = {}
    for key, label in (('nb_textures:', 'kd'), ('nb_normalmaps:', 'normal'),
                       ('nb_subsurfaces:', 'ksub'),
                       ('nb_specularmaps:', 'ks'), ('nb_alphamaps:', 'alpha'),
                       ('nb_expmaps:', 'ne'), ('nb_transpmaps:', 'transp'),
                       ('nb_refrindexmaps:', 'refr')):
        chans[label] = _channel(lines, key)
    o['channels'] = chans
    return o


def _mat_kwargs(o):
    """Channel lists -> ObjectSpec material kwargs (first entry wins; the
    reference's queryMaterial uses per-group lists — group 0 here)."""
    ch = o['channels']

    def mult3(label, default):
        lst = ch[label]
        if not lst:
            return default
        m = lst[0][1]
        return tuple(m[:3]) if len(m) >= 3 else (m[0],) * 3

    kw = dict(
        miroir=o['miroir'], ghost=o['ghost'],
        flip_normals=o['flip_normals'],
        translation=tuple(o['translation']),
        rotation=(None if np.allclose(o['rotation'], np.eye(3))
                  else o['rotation']),
        scale=o['scale'], rotation_center=tuple(o['rotation_center']),
        kd=mult3('kd', (1.0, 1.0, 1.0)),
        ks=mult3('ks', (0.0, 0.0, 0.0)),
        ne=mult3('ne', (1.0, 1.0, 1.0)),
        ksub=mult3('ksub', (0.0, 0.0, 0.0)),
        transp=(ch['transp'][0][1][0] < 0.5) if ch['transp'] else False,
        refr_index=ch['refr'][0][1][0] if ch['refr'] else 1.3,
        keyframes=o['keyframes'],
    )
    return kw


def load_scn(path: str, name_subst: Optional[str] = None, device=None):
    """Parse a reference `.scn` file -> (objects, light_intensity, cam, cfg,
    extras).  Measured BRDF tables load onto `device` (None: the card),
    the camera on the CPU (Renderer moves it)."""
    with open(path, errors='replace') as f:
        text = f.read()
    lines = _Lines(text)
    base_dir = os.path.dirname(os.path.abspath(path))

    w, h = (int(x) for x in _floats(lines.expect('W,H:'), 2))
    nrays = int(_floats(lines.expect('nrays:'))[0])
    if lines.peek().startswith('nbframes:'):
        lines.next()
    cam_vals = _floats(lines.expect('Cam:'), 9)
    fov = _floats(lines.expect('fov:'))[0]
    focus = _floats(lines.expect('focus:'))[0]
    aperture = _floats(lines.expect('aperture:'))[0]
    sigma = _floats(lines.expect('sigma_filter:'))[0]
    gamma = _floats(lines.expect('gamma:'))[0]

    lenticular = {}
    if lines.peek().startswith('is_lenticular:'):
        lenticular['is_lenticular'] = bool(int(_floats(lines.next())[0]))
        lenticular['nb_images'] = int(_floats(
            lines.expect('lenticular_nb_images:'))[0])
        lenticular['max_angle'] = _floats(
            lines.expect('lenticular_max_angle:'))[0]
        lenticular['pixel_width'] = int(_floats(
            lines.expect('lenticular_pixel_width:'))[0])
        lines.expect('isArray:')
        lines.expect('nbviewX:')
        lines.expect('nbviewY:')
        lines.expect('maxSpacingX:')
        lines.expect('maxSpacingY:')
    bounces = int(_floats(lines.expect('bounces:'))[0])
    if lines.peek().startswith('has_denoiser:'):
        lines.next()
    light_intensity = _floats(lines.expect('intensite_lum:'))[0]
    envmap_intensity = _floats(lines.expect('intensite_envmap:'))[0]
    background = None
    if lines.peek().startswith('background:'):
        background = lines.expect('background:')
    nbo = int(_floats(lines.expect('nbobjects:'))[0])

    objects: List[scn.ObjectSpec] = []
    for _ in range(nbo):
        kind = lines.next().strip()
        o = _object_base(lines, name_subst)
        kw = _mat_kwargs(o)
        # the reference name and edge flag, read back by io.scn_export
        kw.update(name=o['name'], display_edges=o['display_edges'])
        if o.get('brdf') and o['brdf'] != 'Null':
            bp = o['brdf']
            if not os.path.isabs(bp):
                bp = os.path.join(base_dir, bp)
            if os.path.exists(bp):
                from ..models import merl as merl_mod
                kw['measured_brdf'] = merl_mod.load_measured(
                    bp, device=device_mod.resolve(device))
        if kind == 'NEW SPHERE':
            has_env = bool(int(_floats(lines.expect('is_envmap:'))[0]))
            envfile = lines.expect('envmapfilename:')
            center = _floats(lines.expect('O:'), 3)
            radius = _floats(lines.expect('R:'))[0]
            if has_env:
                kw['flip_normals'] = True
            objects.append(scn.sphere(tuple(center), radius,
                                      envmap_file=envfile if has_env
                                      else None, **kw))
        elif kind == 'NEW PLANE':
            point = _floats(lines.expect('Point:'), 3)
            normal = _floats(lines.expect('N:'), 3)
            objects.append(scn.plane(tuple(point), tuple(normal), **kw))
        elif kind == 'NEW MESH':
            if lines.peek().startswith('is_centered:'):
                center_flag = bool(int(_floats(lines.next())[0]))
            else:
                center_flag = True
            has_csv = bool(int(_floats(lines.expect('has_csv:'))[0]))
            csv_file = lines.expect('csv_file:')
            from . import obj as obj_io
            mp = o['name']
            if not os.path.isabs(mp):
                mp = os.path.join(base_dir, mp)
            md = obj_io.load_mesh(mp, scaling=1.0, center=center_flag)
            edge_csv = None
            if has_csv and csv_file and csv_file != 'Null':
                cp_ = csv_file if os.path.isabs(csv_file) \
                    else os.path.join(base_dir, csv_file)
                if os.path.exists(cp_):
                    edge_csv = cp_
            objects.append(scn.mesh_object(
                md, interp_normals=o['interp_normals'],
                is_centered=center_flag, edge_csv=edge_csv, **kw))
        else:
            raise ValueError(f'unsupported .scn object block: {kind!r}')

    fog = {}
    while lines.pos < len(lines.lines):
        ln = lines.next()
        for key, name in (('fog_density:', 'density'),
                          ('fog_absorption:', 'absorption'),
                          ('fog_density_decay:', 'density_decay'),
                          ('fog_absorption_decay:', 'absorption_decay'),
                          ('fog_type:', 'type'),
                          ('fog_phase_type:', 'phase_type'),
                          ('double_frustum_start_t:', 'double_frustum')):
            if ln.startswith(key):
                fog[name] = _floats(ln)[0]
    dfst = fog.pop('double_frustum', 0.0)
    fog['type'] = int(fog.get('type', 0))
    fog['phase_type'] = int(fog.get('phase_type', 0))

    cam = cam_mod.make_camera(cam_vals[0:3], cam_vals[3:6], cam_vals[6:9],
                              fov=fov, focus_distance=focus,
                              aperture=aperture, **(
        dict(is_lenticular=lenticular['is_lenticular'],
             lenticular_max_angle=lenticular['max_angle'],
             lenticular_nb_images=lenticular['nb_images'],
             lenticular_pixel_width=lenticular['pixel_width'])
        if lenticular else {}))
    cfg = RenderConfig(width=w, height=h, nrays=nrays, nb_bounces=bounces,
                       sigma_filter=sigma, gamma=gamma,
                       double_frustum_start_t=dfst)
    extras = {'envmap_intensity': envmap_intensity, 'background': background,
              'fog': fog, 'envmap': next(
                  (o.envmap_file for o in objects[1:2] if o.envmap_file),
                  None)}
    return objects, light_intensity, cam, cfg, extras
