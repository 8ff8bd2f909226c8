"""The content-keyed cache of host-side mesh builds (utils.hostcache).

A scene rebuilt from the same triangles must give exactly what a fresh
build gives, on tensors of its own; any change of the triangles or of a
build parameter must build anew.  Small meshes on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import bvh as bvh_mod
from pathtracer_tpu_torch.ops import cluster, traverse
from pathtracer_tpu_torch.scene import scene as scn
from pathtracer_tpu_torch.scene import topology
from pathtracer_tpu_torch.utils import hostcache, procgen


def _sphere(lat=24):
    return procgen.sphere_mesh(lat, lat, radius=3.0, displace_amp=0.1)


def _same_clusters(a, b, shared_tensors=False):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(x):
            assert torch.equal(x, y), f.name
            assert (x.data_ptr() == y.data_ptr()) == shared_tensors \
                or x.numel() == 0, f.name
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_rebuilt_scene_reuses_the_host_build():
    md = _sphere()
    objs = scn.default_objects() + [scn.mesh_object(md)]
    hostcache.clear()
    first = scn.build_scene(objs, scn.default_light_intensity(),
                            device='cpu')
    hits = hostcache.STATS['hits']
    again = scn.build_scene(objs, scn.default_light_intensity(),
                            device='cpu')
    # the BVH, the cluster build and the orientation gate
    assert hostcache.STATS['hits'] - hits == 3
    _same_clusters(first.meshes[0].clustered, again.meshes[0].clustered)
    assert first.meshes[0].backface_cull == again.meshes[0].backface_cull
    hostcache.clear()
    fresh = scn.build_scene(objs, scn.default_light_intensity(),
                            device='cpu')
    _same_clusters(fresh.meshes[0].clustered, again.meshes[0].clustered)


def test_cached_arrays_are_read_only():
    tri = _sphere().vertices[_sphere().vtx_idx]
    hostcache.clear()
    fb = bvh_mod.build_bvh(tri)
    assert bvh_mod.build_bvh(tri) is fb
    with pytest.raises(ValueError):
        fb.order[0] = 1
    cm = cluster.build_clustered(tri, fb=fb, dev='cpu')
    with pytest.raises(ValueError):
        cm.host_tris[0, 0, 0] = 0.0
    # tensors on the CPU are copies, so writing one leaves the cache alone
    nodes = traverse.upload_bvh(fb, device='cpu')
    nodes.a.fill_(-7)
    nodes.lo_x.fill_(-7.0)
    assert (fb.node_a != -7).all() and (fb.node_lo[:, 0] != -7.0).all()
    cm.planes.fill_(-7.0)
    again = cluster.build_clustered(tri, fb=fb, dev='cpu')
    assert not (again.planes == -7.0).all()


@pytest.mark.parametrize('change', ['vertex', 'nrm_sign', 'tris_c'])
def test_any_change_builds_anew(change):
    md = _sphere()
    tri = md.vertices[md.vtx_idx].astype(np.float32)
    kw = dict(nrm_sign=1.0, tris_c=None)
    hostcache.clear()
    cluster.build_clustered(tri, dev='cpu', **kw)
    if change == 'vertex':
        tri = tri.copy()
        tri[5, 1, 2] = np.nextafter(tri[5, 1, 2], np.float32(np.inf))
    elif change == 'nrm_sign':
        kw['nrm_sign'] = -1.0
    else:
        kw['tris_c'] = 2 * cluster.SUBT
    misses = hostcache.STATS['misses']
    got = cluster.build_clustered(tri, dev='cpu', **kw)
    assert hostcache.STATS['misses'] > misses
    hostcache.clear()
    _same_clusters(got, cluster.build_clustered(tri, dev='cpu', **kw))


def test_orientation_gate_is_keyed_on_the_winding():
    md = _sphere()
    hostcache.clear()
    sign = topology.closed_orientation(md.vertices, md.vtx_idx)
    assert sign != 0
    flipped = np.ascontiguousarray(md.vtx_idx[:, ::-1])
    assert topology.closed_orientation(md.vertices, flipped) == -sign
    assert topology.closed_orientation(md.vertices, md.vtx_idx) == sign
