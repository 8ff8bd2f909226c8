"""PyTorch port, the parallel layer: the row-block splat, the sharded
render and the training step against the JAX package, and the port at
world 2 and 4 (gloo processes, tests/torch_dist_worker.py, spawned once
for the module) against itself at world 1.

Tolerances:
  * splat blocks: the same float32 operations in both packages, held to
    1e-6 relative of the film's largest value;
  * sharded render, port vs JAX on a (1, 1) mesh: the film-level form of
    the boundary-flip allowance of tests/test_integrator_vs_cpu.py (fewer
    than 5% of pixels beyond 1e-3 of the image scale, the rest within
    1e-3, means within 2%), counts within 1e-6 relative;
  * port at world 4 vs world 1: the image within rtol = atol = 1e-5
    (tests/test_scene_axis_render.py:64-65); the counts within 1e-6
    relative, JAX's own count tolerance there, because the pixels on a
    dp block's border sum the two blocks' splats in another order;
  * gradients: tests/test_torch_grad.py's rule, within 5e-4 of each
    leaf's largest |grad|.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pathtracer_tpu as jpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.parallel import sharding as jsh
from pathtracer_tpu.render import film as jfilm
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.core.camera import make_camera
from pathtracer_tpu_torch.parallel import sharding as tsh
from pathtracer_tpu_torch.render import film as tfilm

import torch_dist_worker as wk
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

W, H = wk.SH_W, wk.SH_H
GRAD_TOL = 5e-4


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The worker's 'sharding' suite at world 4: the dp=2 x sp=2 render,
    train step and gradients, the dp=4 gradients, and the world-2 (dp=2)
    gradients on ranks 0-1."""
    return wk.spawn('sharding', 4, str(tmp_path_factory.mktemp('sharding')))


@pytest.fixture(scope='module')
def scenes():
    """The cluster scene built by JAX and carried across to the port."""
    md = procgen.sphere_mesh(32, 32, radius=10.0, displace_amp=0.3)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -14.0, 0.0),
                                 kd=(0.6, 0.4, 0.3)))
    sc = jpt.build_scene(objs, jpt.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=sc.meshes[0].obj_row, use_cluster=True)
    sc = sc.replace(meshes=(m,))
    return sc, convert.scene_from_numpy(convert.numpy_fields(sc),
                                        device='cpu')


@pytest.fixture(scope='module')
def world1():
    """The port at world 1 on the worker's own scene and inputs: the film
    and the loss and gradients."""
    sc = wk.cluster_scene()
    cp, target, params = wk.train_inputs(sc)
    mesh = tsh.make_mesh(n_devices=1, dp=1)
    cam = make_camera(*wk.CAM)
    img, cnt = tsh.make_sharded_render(mesh, wk.sh_cfg())(
        sc, cam, torch.as_tensor(cp))
    loss, grads = tsh.make_loss_and_grads(mesh, wk.sh_cfg())(
        params, sc, cam, torch.as_tensor(cp), torch.as_tensor(target))
    return dict(image=img.numpy(), count=cnt.numpy(), loss=float(loss),
                grads={k: g.numpy() for k, g in grads.items()},
                params={k: v.numpy() for k, v in params.items()})


def _jax_cfg():
    return jpt.RenderConfig(width=W, height=H, nrays=wk.SH_SPP,
                            nb_bounces=wk.SH_BOUNCES)


def _grads_close(got, ref, what):
    for k, r in ref.items():
        scale = np.abs(r).max()
        err = np.abs(np.asarray(got[k]) - r).max()
        assert err <= GRAD_TOL * max(scale, 1e-30), (what, k, err, scale)


@pytest.mark.parametrize('row0,rows', [(0, None), (0, 4), (4, 4), (3, 2)])
def test_splat_rows_match_jax(row0, rows):
    rng = np.random.default_rng(row0 * 10 + (rows or 0))
    hs = H if rows is None else rows
    col = rng.uniform(0, 5, (hs * W, 3)).astype(np.float32)
    dx, dy = (rng.uniform(-0.5, 0.5, hs * W).astype(np.float32)
              for _ in range(2))
    jf = jfilm.make_film(W, H, 0.5)
    ji, jc = jfilm.splat(jf, *jfilm.alloc(jf), jnp.asarray(col),
                         jnp.asarray(dx), jnp.asarray(dy), row0=row0,
                         block_rows=rows)
    tf = tfilm.make_film(W, H, 0.5, device='cpu')
    ti, tc = tfilm.splat(tf, *tfilm.alloc(tf), torch.as_tensor(col),
                         torch.as_tensor(dx), torch.as_tensor(dy),
                         row0=row0, block_rows=rows)
    ji, jc = np.asarray(ji), np.asarray(jc)
    assert jc.sum() > 0
    np.testing.assert_allclose(ti.numpy(), ji, rtol=0,
                               atol=1e-6 * np.abs(ji).max())
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0,
                               atol=1e-6 * np.abs(jc).max())


def test_sharded_render_matches_jax(scenes):
    jsc, tsc = scenes
    cp = rng_host.random_per_pixel_fast(W, H)
    j_img, j_cnt = jsh.make_sharded_render(
        jsh.make_mesh(n_devices=1, dp=1), _jax_cfg(), None)(
        jsc, jpt.make_camera(*wk.CAM), jnp.asarray(cp))
    t_img, t_cnt = tsh.make_sharded_render(
        tsh.make_mesh(n_devices=1, dp=1), wk.sh_cfg())(
        tsc, make_camera(*wk.CAM), torch.as_tensor(cp))
    j_img, j_cnt = np.asarray(j_img), np.asarray(j_cnt)
    t_img, t_cnt = t_img.numpy(), t_cnt.numpy()
    np.testing.assert_allclose(t_cnt, j_cnt, rtol=1e-6, atol=0)
    scale = np.abs(j_img).max()
    assert (j_img.max(-1) > 0).mean() > 0.2          # non-vacuous: lit
    rel = np.abs(t_img - j_img).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(t_img.mean() - j_img.mean()) / scale < 0.02


def test_train_step_grads_match_jax(scenes):
    """Loss and gradients of kd, ks and light_intensity against jax.grad
    of make_train_step's loss_fn on the same (1, 1) mesh."""
    jsc, tsc = scenes
    cp = rng_host.random_per_pixel_fast(W, H)
    target = np.random.default_rng(5).uniform(
        0.0, 1.0, (H, W, 3)).astype(np.float32)
    render = jsh.make_sharded_render(jsh.make_mesh(n_devices=1, dp=1),
                                     _jax_cfg(), None)
    fs = jfilm.make_film_spec_static(W, H, 0.5)

    def loss_fn(p):
        image, count = render(jsc.replace(**p), jpt.make_camera(*wk.CAM),
                              jnp.asarray(cp))
        image = jfilm.crop(fs, image)
        count = jfilm.crop(fs, count)
        hdr = image / jfilm.RADIANCE_SCALE / jnp.maximum(count,
                                                         1e-9)[..., None]
        return jnp.mean((hdr - target) ** 2)

    names = ('kd', 'ks', 'light_intensity')
    j_loss, j_grads = jax.value_and_grad(loss_fn)(
        {k: getattr(jsc, k) for k in names})
    t_loss, t_grads = tsh.make_loss_and_grads(
        tsh.make_mesh(n_devices=1, dp=1), wk.sh_cfg())(
        {k: getattr(tsc, k) for k in names}, tsc, make_camera(*wk.CAM),
        torch.as_tensor(cp), torch.as_tensor(target))
    ref = {k: np.asarray(g) for k, g in j_grads.items()}
    assert np.abs(ref['kd']).max() > 0 and np.abs(
        ref['light_intensity']).max() > 0             # non-vacuous
    assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * float(j_loss)
    _grads_close({k: g.numpy() for k, g in t_grads.items()}, ref, 'port')


def test_world4_render_matches_world1(ranks, world1):
    for r in ranks:
        np.testing.assert_allclose(r['render_count'], world1['count'],
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(r['render_image'], world1['image'],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('mesh,world', [('dp2', 2), ('dp2sp2', 4),
                                        ('dp4', 4)])
def test_grads_independent_of_world(ranks, world1, mesh, world):
    """Each rank's summed gradients equal world 1's: no factor of the
    world size (the cotangent passes through the forward sum)."""
    assert np.abs(world1['grads']['kd']).max() > 0
    for r in ranks[:world]:
        assert abs(r[f'{mesh}_loss'] - world1['loss']) <= 1e-5 * world1[
            'loss']
        _grads_close({k: r[f'{mesh}_grad_{k}'] for k in world1['grads']},
                     world1['grads'], mesh)


def test_train_step_updates_every_rank_alike(ranks, world1):
    """make_train_step at world 4: the same SGD step on every rank,
    params - lr * grads with world 1's gradients."""
    for r in ranks:
        assert abs(r['step_loss'] - world1['loss']) <= 1e-5 * world1['loss']
        for k, p in world1['params'].items():
            np.testing.assert_array_equal(r[f'step_{k}'],
                                          ranks[0][f'step_{k}'])
            want = p - 1e-2 * world1['grads'][k]
            np.testing.assert_allclose(r[f'step_{k}'], want, rtol=1e-6,
                                       atol=1e-9)
