"""PyTorch port on a CUDA card: the hand-written sweep kernels against
their plain PyTorch versions, and a small render through the kernels
against the CPU plain path.

Imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips.  The kernels round every product
and sum on their own in the plain versions' order, so they must agree
with the plain versions exactly: same t, same tri, same occlusion.
"""

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.render import renderer as rnd
from pathtracer_tpu_torch.scene import scene as scn
from pathtracer_tpu_torch.utils import procgen

BIG_T = float(np.float32(1e30))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _rays(n, seed):
    """Half camera-like coherent rays, half incoherent rays from outside."""
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(-0.35, 0.35, n // 2),
                  rng.uniform(-0.35, 0.35, n // 2), -np.ones(n // 2)], -1)
    o = np.tile([0.0, 0.0, 40.0], (n // 2, 1))
    p = rng.normal(size=(n // 2, 3))
    o2 = 14.0 * p / np.linalg.norm(p, axis=1, keepdims=True)
    d2 = rng.normal(size=(n // 2, 3))
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32)),
            torch.as_tensor(d.astype(np.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize('lat,tris_c', [(32, None), (200, tc.SUBT)])
def test_kernels_match_plain(cuda, lat, tris_c):
    md = procgen.sphere_mesh(lat, lat, radius=12.0, displace_amp=0.25)
    cm = tc.build_clustered(md.vertices[md.vtx_idx], tris_c=tris_c,
                            dev=cuda)
    o, d = (x.to(cuda) for x in _rays(8 * tc.BLOCK, seed=lat))
    n = o.shape[0]
    tmin = torch.full((n,), -1.0, device=cuda)
    tx = tc.root_exit_clamp(cm.bounds, o, d, torch.full((n,), BIG_T,
                                                        device=cuda))
    ids, counts, keys, _ = tc._cull(cm, o, d, tx)
    before = tc.cluster_sweep.launches
    t_k, tri_k = tc.cluster_sweep(cm, ids, counts, keys, o, d, tx, tmin)
    assert tc.cluster_sweep.launches == before + 1
    t_p, tri_p = tc.cluster_sweep_plain(cm, ids, counts, keys, o, d, tx,
                                        tmin)
    assert (tri_k >= 0).float().mean().item() > 0.2
    assert torch.equal(tri_k, tri_p)
    assert torch.equal(t_k, t_p)
    lim = torch.where(tx > 0, tx * 0.5, tx)
    occ_k = tc.cluster_sweep_any(cm, ids, counts, keys, o, d, lim, tmin)
    occ_p = tc.cluster_sweep_any_plain(cm, ids, counts, keys, o, d, lim,
                                       tmin)
    assert torch.equal(occ_k, occ_p)
    assert 0.0 < occ_k.float().mean().item() < 1.0


@pytest.mark.gpu
def test_windowed_queries_match_cpu_plain_path(cuda):
    """two_level_hit / two_level_any through the kernels, including the
    overflow windows that incoherent rays force, equal the CPU plain path
    (the culls are the same torch code on both devices)."""
    md = procgen.sphere_mesh(200, 200, radius=12.0, displace_amp=0.25)
    tri = md.vertices[md.vtx_idx]
    rng = np.random.default_rng(3)
    p = rng.normal(size=(tc.BLOCK + 100, 3))
    o = torch.as_tensor((14.0 * p / np.linalg.norm(p, axis=1,
                                                   keepdims=True))
                        .astype(np.float32))
    d = rng.normal(size=o.shape)
    d = torch.as_tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                        .astype(np.float32))
    tmax = torch.full((o.shape[0],), BIG_T)
    limit = torch.as_tensor(rng.uniform(2.0, 40.0, o.shape[0])
                            .astype(np.float32))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        cm = tc.build_clustered(tri, tris_c=tc.SUBT, dev=dev)
        args = (o.to(dev), d.to(dev))
        if dev.type == 'cuda':
            n = tc.BLOCK
            counts = tc._cull(cm, args[0][:n], args[1][:n],
                              tmax[:n].to(dev))[1]
            assert (counts > tc.MAXC).any()       # windows are exercised
        out[dev.type] = [x.cpu() for x in tc.two_level_hit(
            cm, *args, tmax.to(dev))] + [
            tc.two_level_any(cm, *args, limit.to(dev)).cpu()]
    for a, b in zip(out['cuda'], out['cpu']):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_render_matches_cpu_plain_path(cuda):
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    cfg = rnd.RenderConfig(width=32, height=24, nrays=2, nb_bounces=3,
                           compact_rays=True)
    cp = torch.as_tensor(np.random.default_rng(1).random((32 * 24, 2))
                         .astype(np.float32))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        sc = scn.build_scene(objs, scn.default_light_intensity(), device=dev)
        cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
        out[dev.type] = rnd.render_unsplatted(sc, cam, cp.to(dev),
                                              cfg)[1].cpu().numpy()
    scale = max(np.abs(out['cpu']).max(), 1e-6)
    rel = np.abs(out['cuda'] - out['cpu']).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(out['cuda'].mean() - out['cpu'].mean()) / scale < 0.02
