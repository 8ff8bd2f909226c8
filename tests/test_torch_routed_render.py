"""PyTorch port, a mesh uploaded with `use_routed=True` against the JAX
package's: the upload (soup and BVH kept, lean never), the refusal of a
scene-axis partition, and 32x24, 2 spp, 2-bounce renders per sample with
the allowance of tests/test_integrator_vs_cpu.py:64-92 (< 5% of samples
beyond 1e-3 of the image scale, the rest within 1e-3, means within 2%);
the cut-out render is in tests/test_torch_routed_cutout.py.  The JAX scene is carried across
with convert.scene_from_numpy, so both packages trace the same arrays;
the JAX side runs Pallas in interpret mode, the port its plain versions.
"""

import numpy as np
import pytest

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.ops import routed_cluster as trc
from pathtracer_tpu_torch.parallel import scene_shard
from pathtracer_tpu_torch.scene import mesh as tmesh
from pathtracer_tpu_torch.scene import scene as tscn

import test_torch_materials as tmat
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

W, H, SPP, BOUNCES = 32, 24, 2, 2
CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))


@pytest.fixture(scope='module')
def routed_uploads():
    """A 12.6k-tri sphere (above PACKET_MAX_TRIS, dense culls: lean unless
    routed) uploaded routed by both packages, and unrouted by the port."""
    md = procgen.sphere_mesh(80, 80, radius=10.0, displace_amp=0.2)
    mj = jmesh.upload_mesh(md, obj_row=3, use_cluster=True, use_routed=True)
    mt = tmesh.upload_mesh(md, obj_row=3, use_cluster=True, use_routed=True,
                           dev='cpu')
    lean = tmesh.upload_mesh(md, obj_row=3, use_cluster=True, dev='cpu')
    return mj, mt, lean


def test_routed_upload_keeps_soup_and_bvh(routed_uploads):
    mj, mt, lean = routed_uploads
    assert mt.n_tris > tmesh.PACKET_MAX_TRIS
    assert lean.soup is None and lean.bvh is None and not lean.use_routed
    assert mt.use_routed and mj.use_routed
    assert mt.soup is not None and mt.bvh is not None
    for x, y in zip(mt.soup, mj.soup):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(mt.bvh, mj.bvh):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(mt.shade_pack.numpy(),
                                  lean.shade_pack.numpy())
    assert mt.backface_cull == mj.backface_cull
    conv = convert._mesh_from_numpy(convert.numpy_fields(mj), 'cpu')
    assert conv.use_routed and conv.soup is not None


def test_scene_axis_refuses_routed_mesh(routed_uploads):
    _, mt, lean = routed_uploads
    with pytest.raises(NotImplementedError, match='routed'):
        scene_shard.shard_clustered_mesh(mt, 2)
    assert len(scene_shard.shard_clustered_mesh(lean, 2)) == 2


def _routed_scene(objs):
    """The JAX scene of `objs` with its mesh re-uploaded routed, with its
    object's options; returns (jax, port)."""
    sc = jscn.build_scene(objs, jscn.default_light_intensity(),
                          merge_meshes=False)
    m = sc.meshes[0]
    o = objs[m.obj_row]
    m = jmesh.upload_mesh(
        o.mesh_data, obj_row=m.obj_row, use_cluster=True, use_routed=True,
        texture_overrides=o.textures, use_atlas=o.use_atlas,
        bilinear=o.bilinear, cutout_rounds=o.cutout_rounds)
    sc = sc.replace(meshes=(m,))
    tsc = tmat.tscn_from(sc)
    assert tsc.meshes[0].use_routed and tsc.meshes[0].soup is not None
    return sc, tsc


def test_routed_render_matches_jax():
    """The routed branch of the closest hit (residual lanes through the
    bvh_hit_sparse net) in a whole render of the 2k-tri mesh scene."""
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    compare_routed(objs)


def compare_routed(objs):
    """Render `objs` with the mesh routed in both packages, per sample;
    the routed tier must have routed lanes.  Returns the port's
    CUTOUT_LOG."""
    jsc, tsc = _routed_scene(objs)
    trc.ROUTE_LOG, tscn.CUTOUT_LOG = [], []
    try:
        tmat._compare_samples_of(jsc, tsc, jpt.make_camera(*CAM),
                                 tpt.make_camera(*CAM), W, H, SPP, BOUNCES)
        assert sum(e['lanes'][0] for e in trc.ROUTE_LOG) > 0
        return tscn.CUTOUT_LOG
    finally:
        trc.ROUTE_LOG, tscn.CUTOUT_LOG = None, None
