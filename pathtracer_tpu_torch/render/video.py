"""Animated and multi-view rendering: the render_video loop (counterpart
of pathtracer_tpu/render/video.py; reference RenderPanel::render_video,
mainApp.cpp:868-915).  Per frame the scene is rebuilt at that frame's
keyframe state, optionally for every camera of a camera array, rendered
offline and saved as exportE<frame>[_vx_nX_vy_nY].png.
"""

from __future__ import annotations

import os
from typing import Optional

from ..core import camera as cam_mod
from ..io import image as image_io
from ..scene import scene as scn
from .renderer import RenderConfig, Renderer


def render_video(objects, light_intensity, cam, cfg: RenderConfig,
                 nb_frames: int, out_dir: str = '.', prefix: str = 'exportE',
                 nbview_x: int = 1, nbview_y: int = 1,
                 max_spacing_x: float = 0.0, max_spacing_y: float = 0.0,
                 scene_kwargs: Optional[dict] = None, device=None):
    """Render nb_frames frames (x views) on `device` (None: the card);
    returns the paths of the images written."""
    scene_kwargs = scene_kwargs or {}
    paths = []
    is_array = nbview_x * nbview_y > 1
    for frame in range(nb_frames):
        sc = scn.build_scene(objects, light_intensity, frame=float(frame),
                             device=device, **scene_kwargs)
        cams = (cam_mod.camera_array(cam, nbview_x, nbview_y,
                                     max_spacing_x, max_spacing_y)
                if is_array else [cam])
        for view, c in enumerate(cams):
            r = Renderer(sc, c, cfg).render()
            if is_array:
                vx, vy = view % nbview_x, view // nbview_x
                name = f'{prefix}{frame}_{vx}_{nbview_x}_{vy}_{nbview_y}.png'
            else:
                name = f'{prefix}{frame}.png'
            path = os.path.join(out_dir, name)
            image_io.save_image(path, r.u8())
            paths.append(path)
    return paths
