"""PyTorch port, the denoisers against the JAX package: the a-trous
filter, the renderer's denoiser feed and denoised display, and KPCN-lite
with the shipped weights converted by convert.kpcn_state_dict.

Tolerances: the a-trous filter within 1e-5 relative (exp and the mean
reduce in another order); KPCN-lite within 1e-4 of the output's largest
value (fp32 convolutions summed in another order, then a softmax); the
feed's albedo and normal sums per pixel with the render's boundary-flip
allowance (a silhouette pixel may see another first hit).
"""

import filecmp
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.render import denoise as jdn
from pathtracer_tpu.render import denoise_net as jdnn
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.render import denoise as tdn
from pathtracer_tpu_torch.render import denoise_net as tdnn
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import scene as tscn

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

W, H = 24, 16
POSE = ((0, 0, 50), (0, 0, -1), (0, 1, 0))


def _buffers(seed, h=H, w=28, scale=10.0):
    rng = np.random.default_rng(seed)
    c = (rng.random((h, w, 3)) * scale).astype(np.float32)
    a = rng.random((h, w, 3)).astype(np.float32)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return c, a, n


@pytest.mark.parametrize('iterations', [1, 4])
def test_atrous_matches_jax(iterations):
    c, a, n = _buffers(1)
    # two flat albedo / normal regions: the filter smooths within each
    # and stops at their edge
    a[:] = 0.5
    n[:] = (0.0, 1.0, 0.0)
    n[:, 14:] = (0.0, 0.0, 1.0)
    want = np.asarray(jdn.atrous_denoise(c, a, n, iterations=iterations))
    got = tdn.atrous_denoise(torch.as_tensor(c), torch.as_tensor(a),
                             torch.as_tensor(n), iterations=iterations)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want - c).max() > 1.0           # it filters
    assert want[:, 14:].max() <= c[:, 14:].max() + 1e-5


@pytest.fixture(scope='module')
def renders():
    """The flagship slate rendered by both renderers with the denoiser
    feed, 24x16, 2 spp, 2 bounces."""
    li = jscn.default_light_intensity()
    cfg = dict(width=W, height=H, nrays=2, samples_per_wave=1, nb_bounces=2,
               has_denoiser=True)

    def objs(mod):
        o = mod.default_objects()
        o.append(mod.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2)))
        o.append(mod.sphere((-16.0, -20.0, -10.0), 7.0, miroir=True))
        return o

    rj = jrnd.Renderer(jscn.build_scene(objs(jscn), li),
                       jpt.make_camera(*POSE), jrnd.RenderConfig(**cfg))
    rt = trnd.Renderer(tscn.build_scene(objs(tscn), li, device='cpu'),
                       tpt.make_camera(*POSE), trnd.RenderConfig(**cfg))
    return rj.render(), rt.render()


def test_denoiser_feed_matches_jax(renders):
    rj, rt = renders
    for k, (a, b) in enumerate(zip(rj.aux, rt.aux)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == (H, W, 3)
        scale = max(np.abs(a).max(), 1e-6)
        rel = np.abs(a - b).max(-1) / scale
        flipped = rel > 1e-3
        assert flipped.mean() < 0.05, (k, flipped.mean())
        assert rel[~flipped].max() < 1e-3, k
    # the albedo sum holds the red sphere's kd (2 samples) on its pixels
    alb = rt.aux[1].numpy()
    assert np.isclose(alb, [2 * 0.7, 2 * 0.3, 2 * 0.2]).all(-1).any()


def test_denoised_display_matches_jax(renders):
    """The same buffers through both denoised displays."""
    rj, rt = renders
    rt2 = trnd.Renderer(rt.scene, rt.cam, rt.cfg)
    rt2.aux = tuple(torch.as_tensor(np.array(a)) for a in rj.aux)
    rt2.samples_done = rj.samples_done
    want = np.asarray(rj.denoised_display())
    got = rt2.denoised_display()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match='has_denoiser'):
        trnd.Renderer(rt.scene, rt.cam, rt.cfg._replace(
            has_denoiser=False)).denoised_display()


def _shipped_flat():
    with np.load(jdnn.WEIGHTS_PATH) as d:
        return {k: d[k] for k in d.files}


def test_weights_file_is_the_jax_one():
    assert filecmp.cmp(tdnn.WEIGHTS_PATH, jdnn.WEIGHTS_PATH, shallow=False)
    assert os.path.getsize(tdnn.WEIGHTS_PATH) == 367607


def test_kpcn_matches_jax():
    """The shipped weights, converted, on the same buffers as JAX's
    denoise_apply, and the port's own load of its copy."""
    c, a, n = _buffers(2, h=20, w=26, scale=50.0)
    params = jdnn.load_weights()
    want = np.asarray(jdnn.denoise_apply(params, jnp.asarray(c),
                                         jnp.asarray(a), jnp.asarray(n)))
    model = tdnn.KPCNLite()
    model.load_state_dict(convert.kpcn_state_dict(_shipped_flat()))
    got = tdnn.denoise_apply(model, *(torch.as_tensor(x) for x in (c, a, n)))
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    own = tdnn.load_model(device='cpu')
    got2 = tdnn.denoise_learned(*(torch.as_tensor(x) for x in (c, a, n)))
    np.testing.assert_array_equal(got2.numpy(), tdnn.denoise_apply(
        own, *(torch.as_tensor(x) for x in (c, a, n))).numpy())
    np.testing.assert_allclose(got2.numpy(), want, rtol=0, atol=tol)
    # the logits alone, before the softmax
    x = jdnn.features_from_buffers(jnp.asarray(c), jnp.asarray(a),
                                   jnp.asarray(n))
    lj = np.asarray(jdnn.KPCNLite().apply({'params': params}, x))
    with torch.no_grad():
        lt = model(tdnn.features_from_buffers(
            *(torch.as_tensor(v) for v in (c, a, n))))
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                               atol=1e-4 * np.abs(lj).max())


def test_kpcn_state_dict_rejects_other_keys():
    flat = _shipped_flat()
    flat['Dense_0/kernel'] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match='Dense_0'):
        convert.kpcn_state_dict(flat)


def test_kpcn_is_convex_combination():
    """Softmax kernels cannot invent energy: every output lies within the
    input's range, for randomly initialised weights too (JAX's init)."""
    params = jdnn.init_params(jax.random.PRNGKey(1))
    flat = {f'{m}/{p}': np.asarray(params[m][p]) for m in params
            for p in params[m]}
    model = tdnn.KPCNLite()
    model.load_state_dict(convert.kpcn_state_dict(flat))
    c, a, n = _buffers(0, h=24, w=28)
    out = tdnn.denoise_apply(model, *(torch.as_tensor(x) for x in (c, a, n)))
    assert out.shape == (24, 28, 3) and torch.isfinite(out).all()
    assert float(out.min()) >= c.min() - 1e-5
    assert float(out.max()) <= c.max() + 1e-5
    want = np.asarray(jdnn.denoise_apply(params, jnp.asarray(c),
                                         jnp.asarray(a), jnp.asarray(n)))
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_learned_falls_back_without_weights(monkeypatch, tmp_path):
    monkeypatch.setattr(tdnn, 'WEIGHTS_PATH', str(tmp_path / 'none.npz'))
    assert tdnn.load_weights() is None and tdnn.load_model() is None
    c, a, n = (torch.as_tensor(x) for x in _buffers(3, h=16, w=16))
    got = tdnn.denoise_learned(c, a, n)
    np.testing.assert_array_equal(got.numpy(),
                                  tdn.atrous_denoise(c, a, n).numpy())
