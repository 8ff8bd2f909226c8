"""PyTorch port, the rest of the JAX package's public surface against it:
the mesh topology tools (scene/topology.py), rotate_camera_np,
extensible_lattice_2d_np, box_muller, random_uniform_hemisphere,
lambert_eval / lambert_sample, make_film_spec_static, denoise.denoise,
denoise_net.init_params / save_weights, and the two packages' `__all__`.

Tolerances: the host numpy tools and the film's ratio equal bit for bit
(the same numpy code); the torch helpers within 2e-6 relative + 1e-6
absolute of JAX's (float32 sin / cos / log / sqrt of two libraries may
differ by an ulp or two, which the frame's products carry); the a-trous
entry point as tests/test_torch_denoise.py holds it.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import camera as jcam
from pathtracer_tpu.core import qmc as jqmc
from pathtracer_tpu.core import sampling as jsmp
from pathtracer_tpu.io import obj as jobj
from pathtracer_tpu.models import brdf as jbrdf
from pathtracer_tpu.render import denoise as jdn
from pathtracer_tpu.render import denoise_net as jdnn
from pathtracer_tpu.render import film as jfilm
from pathtracer_tpu.scene import topology as jtp
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.core import camera as tcam
from pathtracer_tpu_torch.core import qmc as tqmc
from pathtracer_tpu_torch.core import sampling as tsmp
from pathtracer_tpu_torch.io import obj as tobj
from pathtracer_tpu_torch.models import brdf as tbrdf
from pathtracer_tpu_torch.render import denoise as tdn
from pathtracer_tpu_torch.render import denoise_net as tdnn
from pathtracer_tpu_torch.render import film as tfilm
from pathtracer_tpu_torch.scene import topology as ttp

from test_utilities import CUBE_OFF
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-6)


def test_mesh_info_cube_off(tmp_path):
    """tests/test_utilities.py:35-50's cube, read by the port's OFF reader."""
    p = tmp_path / 'cube.off'
    p.write_text(CUBE_OFF)
    md = tobj.read_off(str(p))
    info = ttp.mesh_info(md)
    assert info == ttp.MeshInfo(**vars(jtp.mesh_info(jobj.read_off(str(p)))))
    assert (info.n_components, info.n_edges, info.n_real_edges,
            info.n_triangles, info.n_polygons, info.n_non_manifold,
            info.n_boundary_edges, info.euler, info.genus) == \
        (1, 18, 12, 0, 6, 0, 0, 2, 0)


def test_components_and_quads_on_sphere():
    md = procgen.sphere_mesh(16, 24, radius=3.0, displace_amp=0.2)
    two = np.concatenate([md.vtx_idx, md.vtx_idx + len(md.vertices)])
    for f in (md.vtx_idx, two, md.vtx_idx[5:]):
        assert ttp.connected_components(f) == jtp.connected_components(f)
    assert ttp.connected_components(two)[0] == 2
    se = np.random.default_rng(2).uniform(size=md.vtx_idx.shape) < 0.8
    assert ttp.find_quads(md.vtx_idx, se) == jtp.find_quads(md.vtx_idx, se)
    assert ttp.mesh_info(md) == ttp.MeshInfo(**vars(jtp.mesh_info(md)))


def test_colour_tools_equal_jax():
    md = procgen.sphere_mesh(12, 12, radius=2.0, displace_amp=0.3)
    np.testing.assert_array_equal(
        ttp.color_anisotropy(md.vertices, md.vtx_idx),
        jtp.color_anisotropy(md.vertices, md.vtx_idx))
    hue = np.linspace(0.0, 360.0, 37)
    rgb = np.asarray([0.2, 0.7, 0.4])
    np.testing.assert_array_equal(ttp.transform_hue(rgb, hue),
                                  jtp.transform_hue(rgb, hue))
    fc = np.random.default_rng(3).uniform(size=(50, 3))
    for seed in (0, 7):
        np.testing.assert_array_equal(ttp.random_colors(fc, seed),
                                      jtp.random_colors(fc, seed))


def test_anisotropy_legend_bytes(tmp_path):
    pytest.importorskip('PIL')
    pt_, pj = str(tmp_path / 't.png'), str(tmp_path / 'j.png')
    u8 = ttp.save_anisotropy_legend(pt_)
    np.testing.assert_array_equal(u8, jtp.save_anisotropy_legend(pj))
    assert u8.shape == (240, 30, 3)
    with open(pt_, 'rb') as a, open(pj, 'rb') as b:
        assert a.read() == b.read()


def test_rotate_camera_np():
    rng = np.random.default_rng(4)
    for _ in range(5):
        d, u = rng.normal(size=3), rng.normal(size=3)
        ax, ay = rng.uniform(-3, 3, 2)
        for got, want in zip(tcam.rotate_camera_np(d, u, ax, ay),
                             jcam.rotate_camera_np(d, u, ax, ay)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_extensible_lattice_2d_np():
    ids = np.concatenate([np.arange(4096), [2 ** 31, 2 ** 32 - 1]])
    got = tqmc.extensible_lattice_2d_np(ids)
    np.testing.assert_array_equal(got, jqmc.extensible_lattice_2d_np(ids))
    # the host twin of the port's own lattice
    np.testing.assert_array_equal(
        got, tqmc.extensible_lattice_2d(torch.as_tensor(ids)).numpy())


def _uniforms(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return nrm, rng.random(n).astype(np.float32), \
        rng.random(n).astype(np.float32)


def test_sampling_helpers():
    nrm, r1, r2 = _uniforms()
    _close(tsmp.box_muller(torch.as_tensor(r1), torch.as_tensor(r2)),
           jsmp.box_muller(jnp.asarray(r1), jnp.asarray(r2)))
    d = tsmp.random_uniform_hemisphere(torch.as_tensor(nrm),
                                       torch.as_tensor(r1),
                                       torch.as_tensor(r2))
    _close(d, jsmp.random_uniform_hemisphere(jnp.asarray(nrm),
                                             jnp.asarray(r1),
                                             jnp.asarray(r2)))
    assert ((d * torch.as_tensor(nrm)).sum(-1) >= -1e-6).all()


def test_lambert():
    nrm, r1, r2 = _uniforms(seed=6)
    kd = np.random.default_rng(7).random((64, 3)).astype(np.float32)
    _close(tbrdf.lambert_eval(torch.as_tensor(kd)),
           jbrdf.lambert_eval(jnp.asarray(kd)))
    d_t, pdf_t = tbrdf.lambert_sample(torch.as_tensor(nrm),
                                      torch.as_tensor(r1),
                                      torch.as_tensor(r2))
    d_j, pdf_j = jbrdf.lambert_sample(jnp.asarray(nrm), jnp.asarray(r1),
                                      jnp.asarray(r2))
    _close(d_t, d_j)
    _close(pdf_t, pdf_j)


def test_make_film_spec_static():
    got = tfilm.make_film_spec_static(37, 21, 0.5, device='cpu')
    want = jfilm.make_film_spec_static(37, 21, 0.5)
    assert (got.width, got.height, got.sigma, got.filter_size) == \
        (want.width, want.height, want.sigma, want.filter_size)
    np.testing.assert_array_equal(got.ratio.numpy(), np.asarray(want.ratio))


def test_denoise_entry_point():
    rng = np.random.default_rng(8)
    c = (rng.random((24, 32, 3)) * 4.0).astype(np.float32)
    a = rng.random((24, 32, 3)).astype(np.float32)
    n = rng.normal(size=(24, 32, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ct, at, nt = (torch.as_tensor(x) for x in (c, a, n))
    got = tdn.denoise(ct, at, nt, iterations=2)
    assert torch.equal(got, tdn.atrous_denoise(ct, at, nt, iterations=2))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdn.denoise(c, a, n, iterations=2)),
        rtol=1e-5, atol=1e-6)


def test_init_params_save_weights_round_trip(tmp_path):
    state = tdnn.init_params(3)
    assert all(torch.equal(state[k], v)
               for k, v in tdnn.init_params(3).items())
    assert not torch.equal(state['convs.0.weight'],
                           tdnn.init_params(4)['convs.0.weight'])
    path = str(tmp_path / 'w.npz')
    tdnn.save_weights(state, path)
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    back = convert.kpcn_state_dict(flat)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    # the flax layout of JAX's init_params: the same names and shapes
    jflat = {'/'.join(str(getattr(k, 'key', k)) for k in kp): np.shape(v)
             for kp, v in jax.tree_util.tree_flatten_with_path(
                 jdnn.init_params(jax.random.PRNGKey(0)))[0]}
    assert {k: v.shape for k, v in flat.items()} == jflat
    model = tdnn.KPCNLite()
    model.load_state_dict(back)
    tdnn.save_weights(model, path)                  # a module too
    with np.load(path) as f:
        assert all(np.array_equal(f[k], flat[k]) for k in flat)
    assert os.path.exists(tdnn.WEIGHTS_PATH)


def test_public_names_match():
    assert set(tpt.__all__) == set(jpt.__all__)
    for name in tpt.__all__:
        assert getattr(tpt, name) is not None
