"""PyTorch port end to end: the port's wavefront renderer against the
sequential per-path CPU reference tracer (tests/reference_cpu.py) on the
three scenes of tests/test_integrator_vs_cpu.py (config 1's shape: the
default slate with a diffuse, a mirror or a glass sphere; 24x20, 4 spp,
3 bounces), at equal per-path PCG sample sequences.

Its tolerance: knife-edge branches (grazing shadow rays, Fresnel RR at
u == R, the lobe choice at u == p) flip a sample entirely under any
float32 reordering, so fewer than 5% of samples may differ beyond 1e-3 of
the image scale, the rest must agree within 1e-3, and the means within 2%.
"""

import math

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.core import rng_host
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import scene as tscn

import reference_cpu as ref
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

W, H, SPP, BOUNCES = 24, 20, 4, 3


def _scenes(extra):
    """The port's scene and the CPU reference's, as
    tests/test_integrator_vs_cpu.py builds them."""
    li = tscn.default_light_intensity()
    objs = tscn.default_objects()
    cpu_objs = [
        ref.Obj('sphere', center=(10, 23, 15), radius=10.0),
        ref.Obj('sphere', center=(0, 0, 0), radius=1e6, flip_normals=True),
        ref.Obj('plane', point=(0, 0, 0), normal=(0, 1, 0),
                translation=(0, -27.3, 0)),
    ]
    kw = {'diffuse': dict(kd=(0.7, 0.3, 0.2), ks=(0.1, 0.1, 0.1),
                          ne=(30.0, 30.0, 30.0)),
          'mirror': dict(miroir=True),
          'transp': dict(transp=True, refr_index=1.4)}[extra]
    objs.append(tscn.sphere((0.0, -17.0, 0.0), 10.0, **kw))
    cpu_objs.append(ref.Obj('sphere', center=(0, -17, 0), radius=10.0, **kw))
    return (tscn.build_scene(objs, li, device='cpu'),
            ref.CPUScene(cpu_objs, li))


@pytest.mark.parametrize('extra', ['diffuse', 'mirror', 'transp'])
def test_renderer_matches_cpu_reference(extra):
    sc, cpu_scene = _scenes(extra)
    cam = tpt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cpu_cam = dict(position=np.array([0, 0, 50], np.float32),
                   direction=np.array([0, 0, -1], np.float32),
                   up=np.array([0, 1, 0], np.float32),
                   fov=35 * math.pi / 180, focus=50.0, aperture=0.1)
    cfg = trnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    cp = rng_host.random_per_pixel_fast(W, H)
    _, smp = trnd.render_unsplatted(sc, cam, torch.as_tensor(cp), cfg)
    smp = smp.numpy()
    smp_cpu = ref.render_cpu(cpu_scene, cpu_cam, W, H, SPP, BOUNCES, cp)
    assert (smp_cpu.max(-1) > 0).mean() > 0.2           # non-vacuous: lit
    scale = max(np.abs(smp_cpu).max(), 1e-6)
    rel = np.abs(smp - smp_cpu).max(-1) / scale         # (H, W, SPP)
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05, (
        f'{extra}: {flipped.mean():.4f} of samples diverge beyond f32 noise')
    assert rel[~flipped].max() < 1e-3
    mean_rel = abs(smp.mean() - smp_cpu.mean()) / scale
    assert mean_rel < 0.02, f'{extra}: aggregate mean differs {mean_rel:.4f}'
