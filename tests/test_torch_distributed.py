"""PyTorch port, the multi-process layer: the bootstrap, meshes, row
sharding and checkpoint names in one process, a mirror of
tests/test_multihost.py at 2 gloo ranks (tests/torch_dist_worker.py,
spawned once for the module), and utils/profiling.py.

The 2-rank image is held to JAX's 8-device make_sharded_render with the
film-level boundary-flip allowance of tests/test_torch_sharding.py
(fewer than 5% of pixels beyond 1e-3 of the image scale, the rest within
1e-3, means within 2%), its counts within 1e-6 relative.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pathtracer_tpu as jpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.parallel import sharding as jsh
from pathtracer_tpu.render import film as jfilm
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import profiling as jprof
from pathtracer_tpu_torch.parallel import distributed as pd
from pathtracer_tpu_torch.parallel import sharding as tsh
from pathtracer_tpu_torch.utils import profiling as tprof

import torch_dist_worker as wk
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return wk.spawn('distributed', 2,
                    str(tmp_path_factory.mktemp('distributed')))


def test_init_single_process_noop():
    assert pd.init_multihost() == (0, 1)
    assert pd.init_multihost() == (0, 1)           # idempotent
    assert pd.world() == (0, 1)


def test_init_needs_an_explicit_backend():
    with pytest.raises(ValueError, match='backend'):
        pd.init_multihost('localhost:1', 2, 0)
    with pytest.raises(ValueError, match='backend'):
        pd.init_multihost('localhost:1', 2, 0, backend='mpi')


def test_mesh_axes_single_process():
    mesh = pd.global_mesh(sp=1)
    assert mesh.shape == {'dp': 1, 'sp': 1}
    assert mesh.coords == {'dp': 0, 'sp': 0, 'scene': 0}
    assert all(g is None for g in mesh.groups.values())
    with pytest.raises(AssertionError, match='need 2 ranks'):
        tsh.make_mesh(dp=2)
    assert tuple(tsh.make_mesh(n_devices=1, dp=1).shape) == ('dp', 'sp')


def test_host_shard_rows_single_process():
    mesh = pd.global_mesh(sp=1)
    assert pd.host_shard_rows(8, mesh) == (0, 8, 8)
    rows = torch.arange(24.0).reshape(8, 3)
    assert torch.equal(pd.assemble_rows(rows, mesh), rows)


def test_checkpoint_path_single_process():
    assert pd.checkpoint_path('/tmp/x.npz') == '/tmp/x.npz'


def test_two_ranks_rows_match_jax(ranks):
    """test_multihost at 2 ranks: rows over dp = 2, each rank keeps its own
    rows, and the image assembled from them equals the whole film and
    JAX's 8-device render."""
    w, h, spp = wk.MH_W, wk.MH_H, wk.MH_SPP
    sc = jscn.build_scene(jscn.default_objects(),
                          jscn.default_light_intensity())
    cfg = jrnd.RenderConfig(width=w, height=h, nrays=spp, nb_bounces=2,
                            samples_per_wave=spp)
    film = jfilm.make_film(w, h, cfg.sigma_filter)
    img, cnt = jsh.make_sharded_render(jsh.make_mesh(dp=8, sp=1), cfg,
                                       film.ratio)(
        sc, jpt.make_camera(*wk.CAM),
        jnp.asarray(rng_host.random_per_pixel_fast(w, h)))
    j_img = np.asarray(jfilm.crop(film, img))
    j_cnt = np.asarray(jfilm.crop(film, cnt))
    for r, out in enumerate(ranks):
        assert int(out['dp']) == 2
        assert list(out['rows']) == [r * h // 2, (r + 1) * h // 2]
        assert bool(out['reassembled_equal'])
        assert str(out['ckpt']) == f'/x/ck.p{r}.npz'
        np.testing.assert_allclose(out['count'], j_cnt, rtol=1e-6, atol=0)
        scale = np.abs(j_img).max()
        rel = np.abs(out['image'] - j_img).max(-1) / scale
        flipped = rel > 1e-3
        assert (j_img.max(-1) > 0).mean() > 0.2
        assert flipped.mean() < 0.05
        assert rel[~flipped].max() < 1e-3
        assert abs(out['image'].mean() - j_img.mean()) / scale < 0.02


def test_profiling(tmp_path):
    """PerfChrono on the host clock, trace() writes a Chrome trace,
    rays_per_second is JAX's."""
    ch = tprof.PerfChrono()
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path / 'tr'), cuda=False) as prof:
        (x @ x).sum()
    assert ch.diff_ms() >= 0.0
    assert os.path.getsize(tmp_path / 'tr' / 'trace.json') > 0
    assert any('mm' in e.key for e in prof.key_averages())
    for args in ((1920, 1080, 4, 3, 1.5), (64, 48, 1, 2, 0.01, 2)):
        assert tprof.rays_per_second(*args) == jprof.rays_per_second(*args)
