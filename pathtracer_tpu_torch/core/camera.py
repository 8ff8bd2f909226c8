"""Pinhole + thin-lens camera with lenticular interlacing and camera
arrays (counterpart of pathtracer_tpu/core/camera.py; reference
Vector.h:721-840).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import vec


@dataclasses.dataclass
class Camera:
    """Vectors are (3,) float32 tensors, scalars 0-d float32 tensors; the
    lenticular image count and band width are ints (reference fields
    Vector.h:827-836)."""

    position: torch.Tensor
    direction: torch.Tensor
    up: torch.Tensor
    fov: torch.Tensor            # radians
    focus_distance: torch.Tensor
    aperture: torch.Tensor
    # lenticular interlacing (reference: Vector.h:798-812)
    lenticular_max_angle: torch.Tensor = None
    is_lenticular: bool = False
    lenticular_nb_images: int = 10
    lenticular_pixel_width: int = 1

    def to(self, device) -> 'Camera':
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def make_camera(position, direction, up, fov=35.0 * math.pi / 180.0,
                focus_distance=50.0, aperture=0.1, is_lenticular=False,
                lenticular_max_angle=35.0 * math.pi / 180.0 * 0.25,
                lenticular_nb_images=10, lenticular_pixel_width=1):
    """Build a camera on the CPU (defaults match the reference default
    scene, Raytracer.cpp:1250-1253; lenticular defaults Vector.h:725-727);
    Renderer moves it to its device."""
    return Camera(position=_f32(position),
                  direction=vec.normalize(_f32(direction)),
                  up=vec.normalize(_f32(up)), fov=_f32(fov),
                  focus_distance=_f32(focus_distance),
                  aperture=_f32(aperture),
                  lenticular_max_angle=_f32(lenticular_max_angle),
                  is_lenticular=bool(is_lenticular),
                  lenticular_nb_images=int(lenticular_nb_images),
                  lenticular_pixel_width=int(lenticular_pixel_width))


def rotate_camera_np(direction, up, angle_x, angle_y):
    """Host-side camera orbit used during scene setup (pallas
    rotate_camera_np; reference: Vector.h:740-765, called e.g.
    Raytracer.cpp:1273): direction and up rotated by angle_y around x,
    then by angle_x around y, in the reference's axis order.  Returns two
    (3,) float32 numpy arrays."""
    d = np.asarray(direction, np.float64).copy()
    u = np.asarray(up, np.float64).copy()

    def rot(v):
        tmp = np.array([
            v[0],
            math.cos(angle_y) * v[1] - math.sin(angle_y) * v[2],
            math.sin(angle_y) * v[1] + math.cos(angle_y) * v[2],
        ])
        return np.array([
            math.cos(angle_x) * tmp[0] - math.sin(angle_x) * tmp[2],
            tmp[1],
            math.sin(angle_x) * tmp[0] + math.cos(angle_x) * tmp[2],
        ])

    return rot(d).astype(np.float32), rot(u).astype(np.float32)


def camera_array(cam: Camera, nbview_x: int, nbview_y: int,
                 max_spacing_x: float, max_spacing_y: float):
    """Camera-array grid (the render_video camera-array mode,
    mainApp.cpp:868-915): one camera per (vx, vy) view, row by row, each
    moved by (vx - (nX-1)/2) * spacing_x along right and (vy - (nY-1)/2)
    * spacing_y along up."""
    right = vec.cross(cam.direction, cam.up).cpu().numpy()
    up = cam.up.cpu().numpy()
    pos = cam.position.cpu().numpy()
    cams = []
    for vy in range(nbview_y):
        for vx in range(nbview_x):
            ox = (vx - (nbview_x - 1) / 2.0) * max_spacing_x
            oy = (vy - (nbview_y - 1) / 2.0) * max_spacing_y
            cams.append(dataclasses.replace(
                cam, position=_f32(pos + ox * right + oy * up).to(
                    cam.position.device)))
    return cams


def generate_rays(cam: Camera, i, j, dx, dy, dx_aperture, dy_aperture,
                  width: int, height: int, init_t: float = 0.0):
    """Vectorized primary rays.  i, j: pixel row / column index tensors;
    dx, dy: sensor jitter in [-0.5, 0.5]; dx_aperture, dy_aperture: lens
    offsets already scaled by the aperture.  Returns (origins, directions),
    each (..., 3) float32."""
    j_int = j.to(torch.int64)
    i = i.to(torch.float32)
    j = j.to(torch.float32)
    k = width / (2.0 * torch.tan(cam.fov / 2.0))
    camera_right = vec.cross(cam.direction, cam.up)
    if cam.is_lenticular:
        # interlaced views (reference: Vector.h:798-812), its world-axis
        # projection kept literally, with its assumption of an
        # axis-aligned camera; floor division and remainder as in JAX
        nimg = cam.lenticular_nb_images
        el = (cam.focus_distance * torch.tan(cam.lenticular_max_angle / 2.0)
              / (nimg / 2.0))
        band = torch.div(j_int, cam.lenticular_pixel_width,
                         rounding_mode='floor')
        offset = -(torch.remainder(band, nimg) - nimg // 2).to(torch.float32)
        p_focus = cam.position + cam.focus_distance * torch.tensor(
            [0.0, 0.0, 1.0], device=cam.position.device)
        c1 = cam.position + offset[..., None] * el * camera_right
        v1 = vec.normalize(p_focus - c1)
        pproj = (k / vec.dot3(v1, cam.direction)) * v1 + c1
        pix_j = pproj[..., 0] + width / 2.0 - 0.5
        pix_i = pproj[..., 1] + height / 2.0 - 0.5
        dvx = (j - pix_j) + dx
        dvy = (i - pix_i) + dy
    else:
        c1 = cam.position
        dvx = j - width / 2.0 + 0.5 + dx
        dvy = i - height / 2.0 + 0.5 + dy
    dvz = k.expand(dvx.shape)
    d = vec.normalize(torch.stack([dvx, dvy, dvz], dim=-1))
    world_dir = (d[..., 0:1] * camera_right + d[..., 1:2] * cam.up
                 + d[..., 2:3] * cam.direction)

    # focal-plane target, then the jittered lens origin
    denom = vec.dot3(world_dir, cam.direction).abs()
    destination = c1 + cam.focus_distance / denom * world_dir
    new_origin = (c1 + dx_aperture[..., None] * camera_right
                  + dy_aperture[..., None] * cam.up)
    new_dir = vec.normalize(destination - new_origin)
    origin = new_origin + init_t * new_dir / vec.dot3(new_dir, cam.direction)
    return origin, new_dir
