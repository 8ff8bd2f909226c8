"""PyTorch port, cluster tier (ops/cluster.py) against the JAX package.

The JAX side runs the Pallas sweeps in interpret mode, as its own tests
do; the port runs the plain PyTorch sweeps (CPU tensors).  Tolerances:
  * host build and culls: arrays equal, keys within 1e-6 relative (the
    same float32 slab arithmetic in another framework);
  * closest hit: tri equal on >= 99.9% of lanes, every other lane a tie
    within 2^-16 relative t (the TPU kernel's packed t|lane winner key
    truncates t there; the port keeps an exact argmin), t within 1e-5
    relative where tri agrees (MXU-interpret dot order vs torch);
  * occlusion: equal on every lane.
The CUDA kernels themselves run only on a GPU (tests/test_torch_gpu.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.ops import pallas_cluster as pc
from pathtracer_tpu.utils import procgen as jprocgen
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import traverse as tt
from pathtracer_tpu_torch.scene import topology

BIG_T = np.float32(1e30)
TIE = 2.0 ** -16


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run the port's torch code on one intra-op thread.  The plain
    versions issue thousands of small ops, and each op of a multi-threaded
    pool waits at a barrier for all its threads; with the suite's workers
    sharing the host's cores those threads are often descheduled (the
    tree-tier test took 577 s instead of 3.6 s, six copies on 8 cores).
    Imported by the other JAX-parity test files of the port."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tris(md):
    return md.vertices[md.vtx_idx]


def _camera_rays(n, org=(0.0, 0.0, 40.0), spread=0.35, seed=0):
    """Tile-coherent primary rays toward the origin."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-spread, spread, 16),
                         np.linspace(-spread, spread, pc.BLOCK // 16),
                         indexing='ij')
    d = []
    for p in range(n // pc.BLOCK):
        off = rng.uniform(-0.1, 0.1, 2)
        d.append(np.stack([gx.ravel() + off[0], gy.ravel() + off[1],
                           -np.ones(pc.BLOCK)], -1))
    d = np.concatenate(d).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray(org, np.float32), d.shape).copy()
    return o, d


def _outside_rays(n, radius, seed=1):
    """Incoherent rays starting outside the sphere mesh (bounce-like)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True) * radius
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope='module')
def small():
    """~2k-tri displaced sphere (the bench's mesh scene), both builds."""
    md = jprocgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    tri = _tris(md)
    sign = topology.closed_orientation(md.vertices, md.vtx_idx)
    assert sign != 0                     # closed: the cull is exact
    cj = pc.build_clustered(tri, nrm_sign=float(sign))
    ct = tc.build_clustered(tri, nrm_sign=float(sign), dev='cpu')
    return cj, ct


@pytest.fixture(scope='module')
def big():
    """A sphere cut into > HIER_MIN_CLUSTERS clusters (hierarchical cull)."""
    md = jprocgen.sphere_mesh(200, 200, radius=12.0, displace_amp=0.25)
    tri = _tris(md)
    cj = pc.build_clustered(tri, tris_c=pc.SUBT)
    ct = tc.build_clustered(tri, tris_c=tc.SUBT, dev='cpu')
    assert ct.n_clusters > tc.HIER_MIN_CLUSTERS
    return cj, ct


def _cb(cj):
    return (cj.cb_lox, cj.cb_loy, cj.cb_loz, cj.cb_hix, cj.cb_hiy, cj.cb_hiz)


def _assert_cull_equal(jout, tout):
    ids_j, cnt_j, keys_j = (np.asarray(x) for x in jout[:3])
    ids_t, cnt_t, keys_t = (x.numpy() for x in tout[:3])
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(keys_t, keys_j, rtol=1e-6, atol=0)


@pytest.mark.parametrize('which', ['small', 'big'])
def test_build_clustered_equals_jax(which, request):
    cj, ct = request.getfixturevalue(which)
    conv = tc.from_tpu_arrays(pc.cluster_arrays(cj), dev='cpu')
    for name in ('ctab', 'starts', 'sub_bounds', 'planes', 'nrm'):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      getattr(conv, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(ct.host_tris, cj.host_tris)
    np.testing.assert_array_equal(ct.starts.numpy(), cj.starts)


@pytest.mark.parametrize('backface', [False, True])
def test_dense_cull_equals_jax(small, backface):
    cj, ct = small
    assert ct.n_clusters <= tc.HIER_MIN_CLUSTERS
    o, d = _camera_rays(2 * pc.BLOCK)
    o2, d2 = _outside_rays(2 * pc.BLOCK, 14.0)
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    tmax = np.full(len(o), BIG_T, np.float32)
    jout = pc._dense_cull(_cb(cj), jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(tmax), nrm=cj.nrm if backface else None)
    tout = tc._dense_cull(ct.bounds, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(tmax),
                          nrm=ct.nrm if backface else None)
    _assert_cull_equal(jout, tout)


@pytest.mark.parametrize('rays', ['camera', 'incoherent'])
def test_hier_cull_equals_jax(big, rays):
    cj, ct = big
    if rays == 'camera':
        o, d = _camera_rays(2 * pc.BLOCK)
    else:
        o, d = _outside_rays(pc.BLOCK, 14.0, seed=7)
    tmax = np.full(len(o), BIG_T, np.float32)
    jout = pc._hier_cull(_cb(cj), jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(tmax), nrm=cj.nrm)
    tout = tc._hier_cull(ct.bounds, torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(tmax), nrm=ct.nrm)
    _assert_cull_equal(jout, tout)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    if rays == 'incoherent':
        assert (tout[1].numpy() > tc.MAXC).any()   # overflow exercised


def _assert_hits_match(t_j, tri_j, t_t, tri_t):
    t_j, tri_j = np.asarray(t_j), np.asarray(tri_j)
    t_t, tri_t = t_t.numpy(), tri_t.numpy()
    same = tri_j == tri_t
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(t_t[same], t_j[same], rtol=1e-5, atol=1e-6)
    diff = ~same
    assert (tri_t[diff] >= 0).all() and (tri_j[diff] >= 0).all()
    assert (np.abs(t_t[diff] - t_j[diff]) <= TIE * np.abs(t_j[diff])).all()


@pytest.mark.parametrize('case', ['small-camera', 'small-incoherent',
                                  'small-backface', 'big-incoherent'])
def test_two_level_hit_matches_jax(small, big, case):
    size, kind = case.split('-')
    cj, ct = small if size == 'small' else big
    if kind == 'camera':
        o, d = _camera_rays(2 * pc.BLOCK)
    else:
        o, d = _outside_rays(pc.BLOCK + 100, 14.0, seed=3)
    backface = kind in ('backface', 'camera')
    if kind == 'backface':
        o, d = _outside_rays(pc.BLOCK, 14.0, seed=4)
    tmax = np.full(len(o), BIG_T, np.float32)
    t_j, tri_j, _, _ = pc.two_level_hit(
        cj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        interpret=True, with_bary=False, backface_cull=backface)
    t_t, tri_t = tc.two_level_hit(ct, torch.as_tensor(o), torch.as_tensor(d),
                                  torch.as_tensor(tmax),
                                  backface_cull=backface)
    assert (tri_t.numpy() >= 0).mean() > 0.2     # the rays do hit the mesh
    _assert_hits_match(t_j, tri_j, t_t, tri_t)
    miss = tri_t.numpy() < 0
    np.testing.assert_array_equal(t_t.numpy()[miss], tmax[miss])


@pytest.mark.parametrize('backface', [False, True])
def test_two_level_any_matches_jax(small, backface):
    cj, ct = small
    o, d = _outside_rays(2 * pc.BLOCK, 14.0, seed=5)
    tmax = np.random.default_rng(6).uniform(2.0, 40.0, len(o)) \
        .astype(np.float32)
    tmax[::7] = 0.0                                # zero-limit lanes
    occ_j = pc.two_level_any(cj, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tmax), interpret=True,
                             backface_cull=backface)
    occ_t = tc.two_level_any(ct, torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(tmax), backface_cull=backface)
    assert 0.05 < occ_t.numpy().mean() < 0.95
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


def _slab_stack():
    """MAXC + 2 parallel one-cluster grid slabs along z; the farthest is
    twice as wide (tests/test_cluster_overflow.py geometry)."""
    g = int(np.sqrt(tc.TRIS_C // 2))

    def grid(z, nx, ny):
        x0, y0 = np.meshgrid(np.arange(nx), np.arange(ny), indexing='ij')
        x0, y0 = x0.ravel().astype(np.float32), y0.ravel().astype(np.float32)
        zz = np.full_like(x0, z)
        a = np.stack([x0, y0, zz], -1)
        b = np.stack([x0 + 1, y0, zz], -1)
        c = np.stack([x0 + 1, y0 + 1, zz], -1)
        dd = np.stack([x0, y0 + 1, zz], -1)
        return np.concatenate([np.stack([a, b, c], 1),
                               np.stack([a, c, dd], 1)])

    slabs = [grid(100.0 * k, g, g) for k in range(tc.MAXC + 1)]
    slabs.append(grid(100.0 * (tc.MAXC + 1), 2 * g, g // 2))
    return np.concatenate(slabs).astype(np.float32), g


def test_windowed_overflow_drops_no_hit():
    tri, g = _slab_stack()
    cm = tc.build_clustered(tri, dev='cpu')
    assert cm.n_clusters == tc.MAXC + 2
    n = 2 * tc.BLOCK
    o = np.tile(np.array([5.5 + 1 / 3, 5.5 + 1 / 3, -50.0], np.float32),
                (n, 1))
    o[1000:, 0] = g + 4.5 + 1 / 3     # only the far wide slab covers x > g
    d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    # the near slabs overflow the packet's slot table ...
    ids, counts, keys, _ = tc._cull(cm, torch.as_tensor(o), torch.as_tensor(d),
                                    torch.full((n,), BIG_T))
    assert (counts.numpy()[:, 0] > tc.MAXC).all()
    # ... and the windowed rounds still find the far-slab hits
    t, tri_id = tc.two_level_hit(cm, torch.as_tensor(o), torch.as_tensor(d),
                                 torch.full((n,), BIG_T))
    ref = tt.brute_force_hit(tc.flat_soup(cm, dev='cpu'), torch.as_tensor(o),
                             torch.as_tensor(d))
    np.testing.assert_allclose(t.numpy(), ref.t.numpy(), rtol=1e-6, atol=1e-6)
    assert (t.numpy()[1000:] < BIG_T).all()
    assert (tri_id.numpy() == ref.tri.numpy()).mean() > 0.999


def _random_soup(t, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (t, 3)).astype(np.float32)
    return (centers[:, None, :]
            + rng.normal(0, 0.35, (t, 3, 3)).astype(np.float32))


def test_plain_sweeps_match_brute_force():
    tri = _random_soup(3000, seed=8)
    cm = tc.build_clustered(tri, dev='cpu')
    rng = np.random.default_rng(9)
    n = 2 * tc.BLOCK
    o = torch.as_tensor(rng.uniform(-14, 14, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    tmax = torch.full((n,), BIG_T)
    t, tri_id = tc.two_level_hit(cm, o, d, tmax)
    soup = tc.flat_soup(cm, dev='cpu')
    ref = tt.brute_force_hit(soup, o, d)
    np.testing.assert_allclose(t.numpy(), ref.t.numpy(), rtol=1e-5, atol=1e-5)
    assert (tri_id.numpy() == ref.tri.numpy()).mean() > 0.999
    al, be = tc.recompute_bary(soup, o, d, t, tri_id)
    hit = tri_id.numpy() >= 0
    np.testing.assert_allclose(al.numpy()[hit], ref.alpha.numpy()[hit],
                               atol=1e-4)
    np.testing.assert_allclose(be.numpy()[hit], ref.beta.numpy()[hit],
                               atol=1e-4)
    limit = torch.as_tensor(rng.uniform(1.0, 30.0, n).astype(np.float32))
    occ = tc.two_level_any(cm, o, d, limit)
    np.testing.assert_array_equal(occ.numpy(),
                                  tt.brute_force_any(soup, o, d, limit).numpy())


def test_kernel_wrappers_refuse_non_cuda_tensors(small):
    _, ct = small
    n = tc.BLOCK
    meta = dict(device='meta')
    args = (torch.zeros((1, tc.MAXC), dtype=torch.int32, **meta),
            torch.zeros((1, 1), dtype=torch.int32, **meta),
            torch.zeros((1, tc.MAXC), **meta), torch.zeros((n, 3), **meta),
            torch.zeros((n, 3), **meta), torch.zeros(n, **meta),
            torch.zeros(n, **meta))
    before = (tc.cluster_sweep.launches, tc.cluster_sweep_any.launches)
    with pytest.raises(ValueError):
        tc.cluster_sweep(ct, *args)
    with pytest.raises(ValueError):
        tc.cluster_sweep_any(ct, *args)
    assert (tc.cluster_sweep.launches, tc.cluster_sweep_any.launches) == before
