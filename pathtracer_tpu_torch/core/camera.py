"""Pinhole + thin-lens camera (counterpart of pathtracer_tpu/core/camera.py).

Lenticular interlacing and camera arrays are not ported yet (ROADMAP
Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import vec


@dataclasses.dataclass
class Camera:
    """Vectors are (3,) float32 tensors, scalars 0-d float32 tensors."""

    position: torch.Tensor
    direction: torch.Tensor
    up: torch.Tensor
    fov: torch.Tensor            # radians
    focus_distance: torch.Tensor
    aperture: torch.Tensor

    def to(self, device) -> 'Camera':
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})


def make_camera(position, direction, up, fov=35.0 * math.pi / 180.0,
                focus_distance=50.0, aperture=0.1, is_lenticular=False,
                **lenticular):
    """Build a camera on the CPU (defaults match the reference default
    scene); Renderer moves it to its device."""
    if is_lenticular or lenticular:
        raise NotImplementedError(
            'lenticular cameras are not ported yet (ROADMAP Queue 1 item 8: '
            'DoF, lenticular and camera arrays)')

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    return Camera(position=f32(position),
                  direction=vec.normalize(f32(direction)),
                  up=vec.normalize(f32(up)), fov=f32(fov),
                  focus_distance=f32(focus_distance), aperture=f32(aperture))


def generate_rays(cam: Camera, i, j, dx, dy, dx_aperture, dy_aperture,
                  width: int, height: int, init_t: float = 0.0):
    """Vectorized primary rays.  i, j: pixel row / column index tensors;
    dx, dy: sensor jitter in [-0.5, 0.5]; dx_aperture, dy_aperture: lens
    offsets already scaled by the aperture.  Returns (origins, directions),
    each (..., 3) float32."""
    i = i.to(torch.float32)
    j = j.to(torch.float32)
    k = width / (2.0 * torch.tan(cam.fov / 2.0))
    camera_right = vec.cross(cam.direction, cam.up)
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
