"""pathtracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

A second package beside the JAX reference `pathtracer_tpu`, with the same
layout and public surface.  It imports torch and numpy only; the
cluster-tier ray/triangle sweeps are hand-written CUDA kernels for Hopper
(csrc/cluster_sweep.cu) with plain PyTorch versions for CPU tensors.
"""

from . import device  # noqa: F401  (precision rules)
from .core.camera import Camera, make_camera, rotate_camera_np
from .io.obj import load_mesh
from .render.renderer import RenderConfig, Renderer
from .scene.scene import (SceneArrays, build_scene, default_light_intensity,
                          default_objects, mesh_object, plane, sphere)

__all__ = [
    'Camera', 'make_camera', 'rotate_camera_np', 'load_mesh', 'RenderConfig', 'Renderer',
    'SceneArrays',
    'build_scene', 'default_light_intensity', 'default_objects',
    'mesh_object', 'plane', 'sphere',
]
