"""PyTorch port, the scene axis: the partitions against the JAX package's,
the three collective hit forms at 2 ranks against JAX's on 2 virtual
devices, and the integrated scene-sharded render (dp=1 x scene=2) against
the port's own unsharded render.  The ranks are gloo processes of
tests/torch_dist_worker.py, spawned once for the module.

Tolerances: partitions, padded layouts and converted meshes bit for bit;
hits tri equal on >= 99.9% of lanes, the rest ties within 2^-16 of t,
t within 1e-5 relative on equal lanes; the integrated render's counts
exactly and its image within rtol = atol = 1e-5
(tests/test_scene_axis_render.py:64-65).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import pathtracer_tpu as jpt
from pathtracer_tpu.parallel import scene_shard as jss
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.core import rng_host
from pathtracer_tpu_torch.core.camera import make_camera
from pathtracer_tpu_torch.ops import cluster as tcl
from pathtracer_tpu_torch.parallel import scene_shard as tss
from pathtracer_tpu_torch.parallel import sharding as tsh
from pathtracer_tpu_torch.scene import mesh as tmesh
from pathtracer_tpu_torch.scene import scene as tscn

import torch_dist_worker as wk
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

TIE = 2.0 ** -16
CLUSTER_FIELDS = ('ctab', 'starts', 'sub_bounds', 'planes', 'nrm')


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The worker's 'scene_shard' suite at 2 ranks (dp=1 x scene=2)."""
    return wk.spawn('scene_shard', 2,
                    str(tmp_path_factory.mktemp('scene_shard')))


@pytest.fixture(scope='module')
def jax_cluster():
    """tests/test_scene_axis_render.py's cluster scene in JAX, its 4-shard
    scene-axis mesh, and the unsharded scene carried across."""
    md = procgen.sphere_mesh(32, 32, radius=10.0, displace_amp=0.3)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -14.0, 0.0),
                                 kd=(0.6, 0.4, 0.3)))
    sc = jpt.build_scene(objs, jpt.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=sc.meshes[0].obj_row, use_cluster=True)
    assert m.n_clusters >= 4
    sc = sc.replace(meshes=(m,))
    return sc, jss.shard_clustered_mesh(m, 4), convert.scene_from_numpy(
        convert.numpy_fields(sc), device='cpu')


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize('t,d', [(5000, 4), (5, 4)])
def test_partition_mesh_matches_jax(t, d):
    rng = np.random.default_rng(t)
    tri = (rng.uniform(-4, 4, (t, 1, 3))
           + rng.uniform(-0.4, 0.4, (t, 3, 3))).astype(np.float32)
    js, ts = jss.partition_mesh(tri, d), tss.partition_mesh(tri, d, 'cpu')
    np.testing.assert_array_equal(ts.order, np.asarray(js.order))
    for a, b in zip(ts.soup, js.soup):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.tri_base.numpy(),
                                  np.asarray(js.tri_base))


@pytest.mark.parametrize('t,d', [(5000, 4), (5, 4)])
def test_partition_mesh_bvh_matches_jax(t, d):
    """Soups, padded node arrays, boxes (an empty partition's inverted)
    and the order remapped to local BVH order, bit for bit."""
    rng = np.random.default_rng(t + 1)
    tri = (rng.uniform(-4, 4, (t, 1, 3))
           + rng.uniform(-0.4, 0.4, (t, 3, 3))).astype(np.float32)
    js, ts = (jss.partition_mesh_bvh(tri, d),
              tss.partition_mesh_bvh(tri, d, 'cpu'))
    np.testing.assert_array_equal(ts.order, np.asarray(js.order))
    assert ts.max_leaf == js.max_leaf
    for a, b in zip(tuple(ts.soup) + tuple(ts.bvh),
                    tuple(js.soup) + tuple(js.bvh)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    for name in ('valid', 'tri_base', 'part_lo', 'part_hi'):
        np.testing.assert_array_equal(_bits(getattr(ts, name).numpy()),
                                      _bits(getattr(js, name)))


def test_shard_clustered_mesh_matches_jax(jax_cluster):
    """Bounds (inverted boxes on the padding clusters), row ranges and
    each shard's shade_pack slice, bit for bit."""
    _, jm, tsc = jax_cluster
    shards = tss.shard_clustered_mesh(tsc.meshes[0], 4)
    assert [s.shard_row0 for s in shards] == list(np.asarray(jm.shard_row0))
    assert [s.shard_rows for s in shards] == list(np.asarray(jm.shard_rows))
    for d, s in enumerate(shards):
        assert s.n_clusters == jm.n_clusters
        jb = np.stack([np.asarray(jm.clustered[10 + k])[d] for k in range(6)],
                      axis=1)
        np.testing.assert_array_equal(_bits(s.clustered.ctab[:, 0:6].numpy()),
                                      _bits(jb))
        np.testing.assert_array_equal(_bits(s.shade_pack.numpy()),
                                      _bits(np.asarray(jm.shade_pack)[d]))
        np.testing.assert_array_equal(_bits(s.clustered.nrm.numpy()),
                                      _bits(np.asarray(jm.clustered[17])[d]))


@pytest.mark.parametrize('rank', range(4))
def test_scene_axis_mesh_converts_to_each_rank(jax_cluster, rank):
    """convert.scene_from_numpy of JAX's scene-axis scene at scene_rank
    gives the port's own partition of that rank."""
    jsc, jm, tsc = jax_cluster
    got = convert.scene_from_numpy(
        convert.numpy_fields(jsc.replace(meshes=(jm,))), device='cpu',
        scene_rank=rank).meshes[0]
    want = tss.shard_clustered_mesh(tsc.meshes[0], 4)[rank]
    assert (got.shard_row0, got.shard_rows) == (want.shard_row0,
                                                want.shard_rows)
    assert got.scene_group is None and got.soup is None
    for name in CLUSTER_FIELDS:
        np.testing.assert_array_equal(
            _bits(getattr(got.clustered, name).numpy()),
            _bits(getattr(want.clustered, name).numpy()), err_msg=name)
    np.testing.assert_array_equal(_bits(got.shade_pack.numpy()),
                                  _bits(want.shade_pack.numpy()))


def test_scene_axis_shard_balance():
    """test_scene_axis_shard_balance: rows and real clusters per shard
    within 2x; the partition leaves the mesh and the host-build cache's
    unsharded build as they were."""
    sc = wk.cluster_scene()
    m = sc.meshes[0]
    shards = tss.shard_clustered_mesh(m, 4)
    rows = np.array([s.shard_rows for s in shards], np.float64)
    assert rows.max() <= 2.0 * max(rows.min(), 1.0), rows
    nreal = np.array([(s.clustered.ctab[:, 0] <= s.clustered.ctab[:, 3])
                      .sum().item() for s in shards], np.float64)
    assert nreal.max() <= 2.0 * max(nreal.min(), 1.0), nreal
    assert nreal.sum() == m.n_clusters and m.scene_group is None
    again = wk.cluster_scene().meshes[0]
    for name in CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(again.clustered, name).numpy(),
                                      getattr(m.clustered, name).numpy())


def test_shard_tiny_mesh_empty_trailing_shards():
    """Fewer clusters than shards: the trailing shards are empty, all
    padding, and the row table still tiles the triangle range."""
    md = procgen.sphere_mesh(24, 24, radius=10.0, displace_amp=0.3)
    m = tmesh.upload_mesh(md, obj_row=3, use_cluster=True, dev='cpu')
    shards = tss.shard_clustered_mesh(m, 4)
    row0 = np.array([s.shard_row0 for s in shards])
    rows = np.array([s.shard_rows for s in shards])
    assert row0[0] == 0 and (rows >= 0).all()
    assert (row0[1:] == row0[:-1] + rows[:-1]).all()
    assert row0[-1] + rows[-1] == m.shade_pack.shape[0]
    assert rows[-1] == 0
    assert bool((shards[-1].clustered.ctab[:, 0]
                 > shards[-1].clustered.ctab[:, 3]).all())


@pytest.fixture(scope='module')
def jax_hits():
    """JAX's three hit forms on 2 of the virtual devices, on the worker's
    sphere and rays."""
    tris, org, d = wk.hit_inputs()
    mesh = Mesh(np.array(jax.devices()[:2]), ('scene',))
    sm = jss.partition_mesh(tris, 2)
    sb = jss.partition_mesh_bvh(tris, 2)
    out = {'sharded': jss.make_sharded_hit(mesh)(
        sm.soup, sm.valid, sm.tri_base, jnp.asarray(org), jnp.asarray(d)),
        'routed': jss.make_routed_hit(mesh, max_leaf=sb.max_leaf,
                                      block=wk.ROUTE_BLOCK)(
            sb, jnp.asarray(org), jnp.asarray(d)),
        'ring': jss.make_ring_hit(mesh, max_leaf=sb.max_leaf)(
            sb, jnp.asarray(org[:wk.RING_RAYS]),
            jnp.asarray(d[:wk.RING_RAYS]))}
    return {k: (np.asarray(t), np.asarray(g)) for k, (t, g) in out.items()}


@pytest.mark.parametrize('form', ['sharded', 'routed', 'ring'])
def test_hit_forms_match_jax(ranks, jax_hits, form):
    jt, jg = jax_hits[form]
    hit = jt < 1e29
    assert hit.mean() > 0.3, 'vacuous: too few hits'
    for r in ranks:
        t, g = r[f'{form}_t'], r[f'{form}_tri']
        assert t.shape == jt.shape
        same = g == jg
        assert same.mean() >= 0.999, same.mean()
        d = ~same
        assert (np.abs(t[d] - jt[d]) <= TIE * np.abs(jt[d])).all()
        np.testing.assert_allclose(t[same & hit], jt[same & hit], rtol=1e-5)
        assert (t[~hit] >= 1e29).all()


@pytest.mark.parametrize('name,lat', [('scene', 32), ('tiny', 12)])
def test_scene_axis_render_matches_unsharded(ranks, name, lat):
    """make_sharded_render at dp=1 x scene=2 equals the port's unsharded
    render; 'tiny' has one cluster, so rank 1's partition is empty and
    takes part in every collective all the same."""
    sc = wk.cluster_scene(lat)
    img, cnt = tsh.make_sharded_render(tsh.make_mesh(n_devices=1, dp=1),
                                       wk.sh_cfg())(
        sc, make_camera(*wk.CAM),
        torch.as_tensor(rng_host.random_per_pixel_fast(wk.SH_W, wk.SH_H)))
    assert img.sum() > 0
    if name == 'tiny':
        assert ranks[0]['tiny_rows'][1] == 0
    for r in ranks:
        np.testing.assert_array_equal(r[f'{name}_count'], cnt.numpy())
        np.testing.assert_allclose(r[f'{name}_image'], img.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_shade_fetch_without_group_is_the_gather(jax_cluster):
    """Without a scene group, _shade_fetch is the plain row gather, bit
    for bit (a miss, -1, reads row 0)."""
    m = jax_cluster[2].meshes[0]
    tri = torch.tensor([-1, 0, 5, m.shade_pack.shape[0] - 1],
                       dtype=torch.int32)
    assert torch.equal(tscn._shade_fetch(m, tri),
                       m.shade_pack[tri.clamp_min(0).long()])
    assert tcl.DENSE_CULL_MAX >= m.n_clusters


def test_comm_model_shapes():
    cm = tss.scene_axis_comm_model(1920 * 1080, 8, 3, 16)
    assert cm == jss.scene_axis_comm_model(1920 * 1080, 8, 3, 16)
    assert cm['total_bytes_per_device_per_wave'] == (
        cm['allgather_closest_bytes'] + cm['psum_shadow_bytes']
        + cm['psum_shade_bytes'])
    c1 = tss.scene_axis_comm_model(1920 * 1080, 1, 3, 16)
    assert c1['total_bytes_per_device_per_wave'] == 0
    sm = tss.scene_axis_scaling_model(2.9e6, 16, 3, 16)
    assert sm == jss.scene_axis_scaling_model(2.9e6, 16, 3, 16)
    assert 1.0 < sm['modeled_speedup_vs_1chip'] <= 16.0
    assert 0.0 < sm['comm_fraction'] < 1.0
