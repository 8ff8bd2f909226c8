"""PyTorch port, the camera and renderer extras against the JAX package:
lenticular ray generation and images, camera arrays, keyframed objects,
render_video's file names, the low-res preview and the progressive
fill-in.

Images are compared per sample with the boundary-flip allowance of
tests/test_integrator_vs_cpu.py (fewer than 5% of samples beyond 1e-3 of
the image scale, the rest within 1e-3, means within 2%).  Ray generation
is compared within 1e-6 (it differs only by the last bits of tan and
sqrt).  The fill-in upsamples with F.interpolate (source coordinate
clamped) where JAX uses jax.image.resize (outside taps renormalised);
the two agree for an upsampling, so the fill-in is compared within 1e-5
on a size whose ratio to the preview is not whole (25 / 2 rows).
"""

import math
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import camera as jcam
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu_torch.core import camera as tcam
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.render import video as tvideo
from pathtracer_tpu_torch.scene import scene as tscn

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

W, H, SPP, BOUNCES = 24, 16, 2, 2
NB_IMAGES, PIX_W, MAX_ANGLE = 4, 2, 0.5
POSE = ((0, 0, 50), (0, 0, -1), (0, 1, 0))
KEYFRAMES = {0.0: {'translation': (-12, 0, 0)},
             1.0: {'translation': (12, 0, 0), 'scale': 1.25}}


def _lenticular(mod):
    return mod.make_camera(*POSE, is_lenticular=True,
                           lenticular_max_angle=MAX_ANGLE,
                           lenticular_nb_images=NB_IMAGES,
                           lenticular_pixel_width=PIX_W)


def _objects(mod, keyframes=None):
    objs = mod.default_objects()
    objs.append(mod.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                           ks=(0.1, 0.1, 0.1), ne=(30.0, 30.0, 30.0),
                           keyframes=keyframes))
    return objs


def _compare_samples(s_j, s_t):
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    assert (s_j.max(-1) > 0).mean() > 0.2          # non-vacuous: lit
    scale = max(np.abs(s_j).max(), 1e-6)
    rel = np.abs(s_t - s_j).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05, flipped.mean()
    assert rel[~flipped].max() < 1e-3
    assert abs(s_t.mean() - s_j.mean()) / scale < 0.02


def _render_both(objs_j, objs_t, cam_j, cam_t, frame=None, w=W, h=H):
    cp = rng_host.random_per_pixel_fast(w, h)
    li = jscn.default_light_intensity()
    cfg = dict(width=w, height=h, nrays=SPP, nb_bounces=BOUNCES)
    _, s_j = jrnd.render_unsplatted(
        jscn.build_scene(objs_j, li, frame=frame), cam_j, jnp.asarray(cp),
        jrnd.RenderConfig(**cfg))
    _, s_t = trnd.render_unsplatted(
        tscn.build_scene(objs_t, li, frame=frame, device='cpu'), cam_t,
        torch.as_tensor(cp), trnd.RenderConfig(**cfg))
    return s_j, s_t


def test_lenticular_rays_match_jax():
    """Every pixel column, negative ones too (floor division and
    remainder as in JAX), with sensor and lens jitter."""
    cam_j, cam_t = _lenticular(jpt), _lenticular(tpt)
    rng = np.random.default_rng(4)
    ii, jj = np.meshgrid(np.arange(H), np.arange(-9, W), indexing='ij')
    ii, jj = ii.reshape(-1).astype(np.int32), jj.reshape(-1).astype(np.int32)
    dx, dy, ax, ay = (rng.uniform(-0.5, 0.5, ii.size).astype(np.float32)
                      for _ in range(4))
    o_j, d_j = jcam.generate_rays(cam_j, jnp.asarray(ii), jnp.asarray(jj),
                                  *(jnp.asarray(x) for x in (dx, dy, ax, ay)),
                                  W, H, init_t=0.5)
    o_t, d_t = tcam.generate_rays(cam_t, torch.as_tensor(ii),
                                  torch.as_tensor(jj),
                                  *(torch.as_tensor(x) for x in (dx, dy, ax,
                                                                 ay)),
                                  W, H, init_t=0.5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-6)
    # interlacing: the view offset (hence origin x) is constant within a
    # PIX_W-wide band and cycles with period NB_IMAGES * PIX_W
    o0, _ = tcam.generate_rays(cam_t, torch.zeros(W, dtype=torch.int64),
                               torch.arange(W), *(torch.zeros(W),) * 4, W, H)
    ox = o0[:, 0].numpy()
    assert np.allclose(ox[:W - NB_IMAGES * PIX_W], ox[NB_IMAGES * PIX_W:],
                       atol=1e-5)
    assert len(np.unique(np.round(ox[:NB_IMAGES * PIX_W], 4))) == NB_IMAGES


def test_lenticular_image_matches_jax():
    s_j, s_t = _render_both(_objects(jscn), _objects(tscn), _lenticular(jpt),
                            _lenticular(tpt))
    _compare_samples(s_j, s_t)
    # and it is not the plain camera's image
    _, s_p = _render_both(_objects(jscn), _objects(tscn),
                          jpt.make_camera(*POSE), tpt.make_camera(*POSE))
    assert not np.allclose(s_p.numpy(), s_t.numpy())


def test_camera_array_matches_jax():
    kw = dict(fov=0.7, focus_distance=40.0, aperture=0.3)
    cj = jcam.camera_array(jpt.make_camera((1, 2, 50), (0.1, 0, -1),
                                           (0, 1, 0), **kw), 3, 2, 2.5, 1.5)
    ct = tcam.camera_array(tpt.make_camera((1, 2, 50), (0.1, 0, -1),
                                           (0, 1, 0), **kw), 3, 2, 2.5, 1.5)
    assert len(cj) == len(ct) == 6
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b.position.numpy(), np.asarray(a.position),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(b.direction.numpy(),
                                      np.asarray(a.direction))
        assert float(b.aperture) == float(a.aperture)
    # the views are spread along right (x here) and up
    xs = sorted({round(float(c.position[0]), 4) for c in ct})
    assert len(xs) == 3


@pytest.mark.parametrize('frame', [0.0, 1.0])
def test_keyframed_sphere_matches_jax(frame):
    s_j, s_t = _render_both(_objects(jscn, KEYFRAMES),
                            _objects(tscn, KEYFRAMES),
                            jpt.make_camera(*POSE), tpt.make_camera(*POSE),
                            frame=frame)
    _compare_samples(s_j, s_t)
    # the sphere moves from left to right (red channel of the mean image)
    img = s_t.mean(dim=2)[..., 0].numpy()
    left, right = img[:, :W // 2].sum(), img[:, W // 2:].sum()
    assert (left > right) == (frame == 0.0)


def test_render_video_names(tmp_path):
    cam = tpt.make_camera(*POSE)
    cfg = trnd.RenderConfig(width=12, height=8, nrays=1, samples_per_wave=1,
                            nb_bounces=1)
    objs = _objects(tscn, {0.0: {'translation': (-5, 0, 0)},
                           1.0: {'translation': (5, 0, 0)}})
    li = tscn.default_light_intensity()
    paths = tvideo.render_video(objs, li, cam, cfg, nb_frames=2,
                                out_dir=str(tmp_path), device='cpu')
    assert [os.path.basename(p) for p in paths] == ['exportE0.png',
                                                    'exportE1.png']
    assert all(os.path.exists(p) for p in paths)
    paths = tvideo.render_video(objs, li, cam, cfg, nb_frames=1,
                                out_dir=str(tmp_path), nbview_x=2,
                                nbview_y=1, max_spacing_x=2.0, device='cpu')
    assert [os.path.basename(p) for p in paths] == [
        'exportE0_0_2_0_1.png', 'exportE0_1_2_0_1.png']


@pytest.fixture(scope='module')
def fill_in():
    """JAX and port renderers of one scene at 32x25, 8 spp, 2 per wave;
    the JAX one with its preview rendered and one wave traced."""
    w, h = 32, 25
    li = jscn.default_light_intensity()
    cfg = dict(width=w, height=h, nrays=8, samples_per_wave=2,
               nb_bounces=BOUNCES)
    cam = POSE
    rj = jrnd.Renderer(jscn.build_scene(_objects(jscn), li),
                       jpt.make_camera(*cam), jrnd.RenderConfig(**cfg))
    rt = trnd.Renderer(tscn.build_scene(_objects(tscn), li, device='cpu'),
                       tpt.make_camera(*cam), trnd.RenderConfig(**cfg))
    return rj, rt


def test_preview_matches_jax(fill_in):
    rj, rt = fill_in
    low_j, low_t = np.asarray(rj.preview()), rt.preview()
    assert low_t.shape == low_j.shape == (2, 2, 3)
    assert low_t.max() > 0
    np.testing.assert_allclose(low_t.numpy(), low_j,
                               rtol=1e-3, atol=1e-3 * np.abs(low_j).max())


def test_fill_in_matches_jax(fill_in):
    """The same preview and film in both: before any wave the display is
    the upsampled preview; after one wave a blend; past 6 spp the plain
    display."""
    rj, rt = fill_in
    rt._preview_lin = torch.as_tensor(np.array(rj.preview()))
    d0_j, d0_t = np.asarray(rj.display_fill_in()), rt.display_fill_in()
    assert d0_t.shape == (25, 32, 3)
    np.testing.assert_allclose(d0_t.numpy(), d0_j, rtol=0, atol=1e-5)
    rj.step(2)
    rt.image = torch.as_tensor(np.array(rj.image))
    rt.sample_count = torch.as_tensor(np.array(rj.sample_count))
    d1_j, d1_t = np.asarray(rj.display_fill_in()), rt.display_fill_in()
    np.testing.assert_allclose(d1_t.numpy(), d1_j, rtol=0, atol=1e-5)
    assert np.abs(d1_j - np.asarray(rj.display())).max() > 1e-5
    # past PREVIEW_BLEND_SPP everywhere: the plain display
    rt.sample_count = torch.full_like(rt.sample_count, 6.0)
    torch.testing.assert_close(rt.display_fill_in(), rt.display(), rtol=0,
                               atol=0)
