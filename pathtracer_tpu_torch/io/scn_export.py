"""Writer for the reference's text `.scn` scene files (counterpart of
pathtracer_tpu/io/scn_export.py).

Emits the exact format of Raytracer::save_scene (reference:
Raytracer.cpp:1096-1146) and Object::save_to_file (Geometry.h:455-517,
Sphere Geometry.h:875-885, Plane Geometry.h:1193-1201, TriMesh
TriangleMesh.h:134-140): six-decimal floats, parenthesised vectors, the
eight texture-channel blocks (constant channels as filename "Null" with
the value folded into the multiplier, Geometry.cpp:104-244 semantics —
including the reference's single-float `multiplier: %f)` form for the
transparency/refraction channels), always-written lenticular block, and
the fog tail.

Round-trips with io.scn_import.load_scn: save_scn(load_scn(f)) == parse
of the original for every field the ObjectSpec model carries (test:
tests/test_scn_roundtrip.py).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..scene import scene as scn


def _np(x):
    """A tensor on any device, or an array-like, as a float64 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _v3(v):
    v = _np(v).reshape(-1)
    return '(%f, %f, %f)' % (v[0], v[1], v[2])


def _chan_vec(f, count_key, spec, channel, const_val):
    """One 3-vector texture-channel block (Object::save_to_file pattern).

    A texture file registered for `channel` on the spec wins (multiplier
    stays the constant, matching queryMaterial's texel*multiplier);
    otherwise ONE "Null" constant entry carrying the value.
    """
    tex = spec.textures or {}
    path = tex.get(channel) if isinstance(tex, dict) else None
    fname = path if isinstance(path, str) else 'Null'
    c = _np(const_val).reshape(-1)
    if c.size == 1:
        c = np.repeat(c, 3)
    f.write('%s %u\n' % (count_key, 1))
    f.write('texture: %s\n' % fname)
    f.write('multiplier: %s\n' % _v3(c))


def _chan_scalar(f, count_key, spec, channel, val):
    """Single-float channel block (transp/refr: Geometry.h:508-517 writes
    `multiplier: %f)` with the stray paren — mirrored for byte parity)."""
    tex = spec.textures or {}
    path = tex.get(channel) if isinstance(tex, dict) else None
    fname = path if isinstance(path, str) else 'Null'
    f.write('%s %u\n' % (count_key, 1))
    f.write('texture: %s\n' % fname)
    f.write('multiplier: %f)\n' % float(val))


def _object_base(f, spec, name):
    f.write('name: %s\n' % name)
    f.write('miroir: %u\n' % (1 if spec.miroir else 0))
    f.write('ghost: %u\n' % (1 if spec.ghost else 0))
    # OUR extension (scn_import peek-guards it): persist a measured-BRDF
    # binding the reference only holds in GUI memory (mainApp.cpp:2418)
    if spec.measured_brdf is not None and spec.measured_brdf.path:
        f.write('brdf: %s\n' % spec.measured_brdf.path)
    f.write('translation: %s\n' % _v3(spec.translation))
    rot = np.eye(3) if spec.rotation is None else _np(spec.rotation)
    f.write('rotation: (%f, %f, %f, %f, %f, %f, %f, %f, %f)\n'
            % tuple(rot.reshape(9)))
    rc = spec.rotation_center
    f.write('center: %s\n' % _v3((0.0, 0.0, 0.0) if rc is None else rc))
    f.write('scale: %f\n' % float(spec.scale))
    f.write('display_edges: %u\n' % (1 if spec.display_edges else 0))
    f.write('interp_normals: %u\n' % (1 if spec.interp_normals else 0))
    f.write('flip_normals: %u\n' % (1 if spec.flip_normals else 0))

    kfs = spec.keyframes or {}
    f.write('nb_transforms: %u\n' % len(kfs))
    # three keyframe passes in map order: scale, translation, rotation
    # (Geometry.h:467-476) — missing components repeat the static value
    for frame in sorted(kfs):
        s = kfs[frame].get('scale', spec.scale)
        f.write('%f %f\n' % (float(frame), float(s)))
    for frame in sorted(kfs):
        t = kfs[frame].get('translation', spec.translation)
        f.write('%f %f, %f, %f\n' % ((float(frame),) + tuple(
            float(x) for x in _np(t).reshape(3))))
    for frame in sorted(kfs):
        r = kfs[frame].get('rotation')
        r = rot if r is None else _np(r)
        f.write('%f %f, %f, %f, %f, %f, %f, %f, %f, %f\n'
                % ((float(frame),) + tuple(r.reshape(9))))

    _chan_vec(f, 'nb_textures:', spec, 'kd', spec.kd)
    _chan_vec(f, 'nb_normalmaps:', spec, 'normal', (1.0, 1.0, 1.0))
    _chan_vec(f, 'nb_subsurfaces:', spec, 'ksub', spec.ksub)
    _chan_vec(f, 'nb_specularmaps:', spec, 'ks', spec.ks)
    _chan_vec(f, 'nb_alphamaps:', spec, 'alpha', (1.0, 1.0, 1.0))
    _chan_vec(f, 'nb_expmaps:', spec, 'ne', spec.ne)
    # transparent flag -> multiplier<0.5 convention (scn_import
    # _mat_kwargs; reference setTransparency Geometry.cpp:104-113)
    _chan_scalar(f, 'nb_transpmaps:', spec, 'transp',
                 0.0 if spec.transp else 1.0)
    _chan_scalar(f, 'nb_refrindexmaps:', spec, 'refr',
                 float(spec.refr_index))


def save_scn(path: str, objects, light_intensity, cam, cfg,
             extras: Optional[dict] = None):
    """Write a reference-format `.scn` file (Raytracer.cpp:1096-1146).

    Takes the same (objects, light_intensity, cam, cfg, extras) tuple
    shape that io.scn_import.load_scn returns, so
    ``save_scn(out, *load_scn(inp))`` round-trips a reference scene.
    """
    extras = extras or {}
    fog = extras.get('fog') or {}
    with open(path, 'w') as f:
        f.write('W,H: %u, %u\n' % (cfg.width, cfg.height))
        f.write('nrays: %u\n' % cfg.nrays)
        f.write('nbframes: %u\n' % int(extras.get('nbframes', 1)))
        f.write('Cam: %s, %s, %s\n' % (_v3(cam.position), _v3(cam.direction),
                                       _v3(cam.up)))
        f.write('fov: %f\n' % float(cam.fov))
        f.write('focus: %f\n' % float(cam.focus_distance))
        f.write('aperture: %f\n' % float(cam.aperture))
        f.write('sigma_filter: %f\n' % cfg.sigma_filter)
        f.write('gamma: %f\n' % cfg.gamma)

        f.write('is_lenticular: %u\n' % (1 if cam.is_lenticular else 0))
        f.write('lenticular_nb_images: %u\n' % cam.lenticular_nb_images)
        la = cam.lenticular_max_angle
        f.write('lenticular_max_angle: %f\n'
                % (math.radians(35.0) * 0.25 if la is None else float(la)))
        f.write('lenticular_pixel_width: %u\n' % cam.lenticular_pixel_width)
        f.write('isArray: %u\n' % int(extras.get('isArray', 0)))
        f.write('nbviewX: %u\n' % int(extras.get('nbviewX', 1)))
        f.write('nbviewY: %u\n' % int(extras.get('nbviewY', 1)))
        f.write('maxSpacingX: %f\n' % float(extras.get('maxSpacingX', 0.0)))
        f.write('maxSpacingY: %f\n' % float(extras.get('maxSpacingY', 0.0)))

        f.write('bounces: %u\n' % cfg.nb_bounces)
        f.write('has_denoiser: %u\n' % (1 if cfg.has_denoiser else 0))
        f.write('intensite_lum: %f\n' % float(light_intensity))
        f.write('intensite_envmap: %f\n'
                % float(extras.get('envmap_intensity', 1.0)))
        if extras.get('background'):
            f.write('background: %s\n' % extras['background'])

        f.write('nbobjects: %u\n' % len(objects))
        for i, spec in enumerate(objects):
            if spec.obj_type == scn.SPHERE:
                f.write('NEW SPHERE\n')
                _object_base(f, spec, spec.name or 'Sphere')
                env = spec.envmap_file
                f.write('is_envmap: %u\n' % (1 if env else 0))
                f.write('envmapfilename: %s\n' % (env or 'Null'))
                f.write('O: %s\n' % _v3(spec.center))
                f.write('R: %f\n' % float(spec.radius))
            elif spec.obj_type == scn.PLANE:
                f.write('NEW PLANE\n')
                _object_base(f, spec, spec.name or 'Plane')
                f.write('Point: %s\n' % _v3(spec.center))
                f.write('N: %s\n' % _v3(spec.normal))
            elif spec.obj_type == scn.MESH:
                f.write('NEW MESH\n')
                name = spec.name or spec.mesh_path
                if not name:
                    raise ValueError(
                        'mesh object %d has no source path: set spec.name '
                        'to the OBJ file before save_scn' % i)
                _object_base(f, spec, name)
                f.write('is_centered: %u\n' % (1 if spec.is_centered else 0))
                has_csv = isinstance(spec.edge_csv, str)
                f.write('has_csv: %u\n' % (1 if has_csv else 0))
                f.write('csv_file: %s\n' % (spec.edge_csv if has_csv
                                             else ''))
            else:
                raise ValueError('unsupported obj_type %r for .scn '
                                 'write-back' % (spec.obj_type,))

        f.write('fog_density: %f\n' % float(fog.get('density', 0.0)))
        f.write('fog_absorption: %f\n' % float(fog.get('absorption', 0.0)))
        f.write('fog_density_decay: %f\n'
                % float(fog.get('density_decay', 0.0)))
        f.write('fog_absorption_decay: %f\n'
                % float(fog.get('absorption_decay', 0.0)))
        f.write('fog_type: %u\n' % int(fog.get('type', 0)))
        f.write('fog_phase_type: %u\n' % int(fog.get('phase_type', 0)))
        f.write('double_frustum_start_t: %f\n'
                % float(cfg.double_frustum_start_t))
    return os.path.abspath(path)
