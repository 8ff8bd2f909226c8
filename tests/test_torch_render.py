"""PyTorch port, the slice as a whole: one scene traced by both packages.

The JAX scene is carried across with convert.scene_from_numpy (the mesh
uploaded with use_cluster=True, Pallas in interpret mode), so both
packages trace exactly the same arrays.  Per-sample comparison with the
boundary-flip allowance of tests/test_integrator_vs_cpu.py: visibility
knife edges (grazing shadow rays, Fresnel RR at u == R) flip a sample
entirely under any float32 reordering, so fewer than 5% of samples may
differ beyond 1e-3 of the image scale, the rest must agree within 1e-3,
and the means within 2%.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import scene as tscn

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

W, H, SPP, BOUNCES = 32, 24, 2, 3
CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))


def _mesh_data():
    return procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)


@pytest.fixture(scope='module')
def mesh_scene():
    """The bench's mesh scene: default slate + ~2k-tri displaced sphere."""
    md = _mesh_data()
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    sc = jscn.build_scene(objs, jscn.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=sc.meshes[0].obj_row, use_cluster=True)
    assert m.backface_cull
    sc = sc.replace(meshes=(m,))
    return sc, convert.scene_from_numpy(convert.numpy_fields(sc),
                                        device='cpu')


def _flagship(mod, **kw):
    """bench.py's analytic flagship: Phong, mirror and glass spheres."""
    objs = mod.default_objects()
    objs.append(mod.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                           ks=(0.1, 0.1, 0.1), ne=(30.0, 30.0, 30.0)))
    objs.append(mod.sphere((-16.0, -20.0, -10.0), 7.0, miroir=True))
    objs.append(mod.sphere((17.0, -19.0, -5.0), 8.0, transp=True,
                           refr_index=1.4))
    return mod.build_scene(objs, mod.default_light_intensity(), **kw)


def _compare_samples(jsc, tsc):
    cp = rng_host.random_per_pixel_fast(W, H)
    cfg_j = jrnd.RenderConfig(width=W, height=H, nrays=SPP,
                              nb_bounces=BOUNCES)
    cfg_t = trnd.RenderConfig(width=W, height=H, nrays=SPP,
                              nb_bounces=BOUNCES)
    _, s_j = jrnd.render_unsplatted(jsc, jpt.make_camera(*CAM),
                                    jnp.asarray(cp), cfg_j)
    _, s_t = trnd.render_unsplatted(tsc, tpt.make_camera(*CAM),
                                    torch.as_tensor(cp), cfg_t)
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    assert (s_j.max(-1) > 0).mean() > 0.2          # non-vacuous: lit
    scale = max(np.abs(s_j).max(), 1e-6)
    rel = np.abs(s_t - s_j).max(-1) / scale
    flipped = rel > 1e-3
    print(f'flipped {flipped.mean():.5f} tight max {rel[~flipped].max():.3g}'
          f' mean rel {abs(s_t.mean() - s_j.mean()) / scale:.3g}')
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(s_t.mean() - s_j.mean()) / scale < 0.02


def test_mesh_scene_samples_match_jax(mesh_scene):
    _compare_samples(*mesh_scene)


def test_flagship_samples_match_jax():
    _compare_samples(_flagship(jscn), _flagship(tscn, device='cpu'))


def test_renderer_step_matches_jax(mesh_scene):
    """Renderer.step with compaction + octant sort and film splatting,
    against JAX's Renderer.display() (test_cluster_golden_100k criterion)."""
    jsc, tsc = mesh_scene
    kw = dict(width=W, height=H, nrays=SPP, samples_per_wave=SPP,
              nb_bounces=BOUNCES, compact_rays=True)
    rj = jpt.Renderer(jsc, jpt.make_camera(*CAM), jrnd.RenderConfig(**kw))
    rt = tpt.Renderer(tsc, tpt.make_camera(*CAM), trnd.RenderConfig(**kw))
    img_j = np.asarray(rj.step().display())
    img_t = rt.step().display().numpy()
    assert img_t.std() > 0.05
    eq = np.isclose(img_t, img_j, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert eq.mean() > 0.999, eq.mean()
    assert rt.stats(1.0)['rays_traced'] == int(rj.rays_traced)


def _tensor_fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_build_scene_equals_conversion(mesh_scene):
    """The port's own build_scene gives the arrays the conversion gives."""
    _, conv = mesh_scene
    objs = tscn.default_objects()
    objs.append(tscn.mesh_object(_mesh_data(), translation=(0.0, -15.0, 0.0)))
    own = tscn.build_scene(objs, tscn.default_light_intensity(),
                           device='cpu')
    for name, a in _tensor_fields(own).items():
        b = getattr(conv, name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        elif name != 'meshes':
            assert a == b, name
    (mo,), (mc,) = own.meshes, conv.meshes
    for name, a in _tensor_fields(mo).items():
        b = getattr(mc, name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        elif isinstance(a, tuple) and a and isinstance(a[0], torch.Tensor):
            for x, y in zip(a, b):              # soup, bvh
                np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                              err_msg=name)
        elif name != 'clustered':
            assert a == b, name
    for name in ('ctab', 'starts', 'sub_bounds', 'planes', 'nrm', 'top_box',
                 'top_a', 'top_b', 'top_leaf', 'top_order'):
        np.testing.assert_array_equal(getattr(mo.clustered, name).numpy(),
                                      getattr(mc.clustered, name).numpy())
    assert mo.clustered.top_max_leaf == mc.clustered.top_max_leaf


def test_unported_features_raise():
    """Features still outside the port name their ROADMAP item: a mesh
    sharded over a scene axis, carried across by scene_from_numpy.  The
    point sets and yarns, the lenticular camera and the denoiser feed,
    refused until they were ported, now build and render (their parity
    tests are in test_torch_pointset.py, test_torch_camera_extras.py and
    test_torch_denoise.py)."""
    sc = tscn.build_scene(tscn.default_objects(), 1.0, device='cpu')
    fields = convert.numpy_fields(sc)
    fields['meshes'] = [{'scene_axis': 'scene'}]
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        convert.scene_from_numpy(fields, device='cpu')
    objs = tscn.default_objects()
    rng = np.random.default_rng(0)
    objs.append(tscn.pointset_object({
        'points': rng.normal(0, 3, (40, 3)).astype(np.float32)}))
    objs.append(tscn.yarn_object((np.float32([[-5, -10, 0]]),
                                  np.float32([[5, -10, 0]]))))
    ps_sc = tscn.build_scene(objs, tscn.default_light_intensity(),
                             device='cpu')
    assert len(ps_sc.pointsets) == 1 and len(ps_sc.yarns) == 1
    r = tpt.Renderer(ps_sc, tpt.make_camera(*CAM), trnd.RenderConfig(
        width=8, height=6, nrays=1, nb_bounces=1)).render()
    assert r.samples_done == 1 and bool(torch.isfinite(r.image).all())
    cam = tpt.make_camera(*CAM, is_lenticular=True)
    r = tpt.Renderer(sc, cam, trnd.RenderConfig(
        width=8, height=6, nrays=1, nb_bounces=1, has_denoiser=True)).render()
    assert cam.is_lenticular and r.samples_done == 1
    assert float(r.aux[2].abs().sum()) > 0
