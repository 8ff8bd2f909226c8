"""PyTorch port, the backface cull's hierarchical-cull parity and its
end-to-end render, against the JAX package (the other cases of
tests/test_backface_cull.py are in tests/test_torch_backface_cull.py,
whose tolerances apply).  The render: the port's image with the cull on
equals the image with it off bit for bit (the cull is exact, not
approximate), and its samples agree with JAX's per sample with the
allowance of tests/test_integrator_vs_cpu.py:64-92.
"""

import dataclasses

import numpy as np

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.render import renderer as trnd

import test_torch_materials as tmat
from test_torch_backface_cull import cull_parity
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)


def test_two_level_hit_backface_parity_hier():
    md = procgen.sphere_mesh(320, 320, radius=10.0, displace_amp=0.3)
    ct = cull_parity(md, 1024, 1, 300, tris_c=512)[0]
    assert ct.n_clusters > tc.HIER_MIN_CLUSTERS


def test_e2e_render_identical():
    """The sphere (radius 10 + displacement at y = -15) dips below the
    floor plane, so this is also the live check of the overlap gate's
    reachability argument, as in JAX's test."""
    md = procgen.sphere_mesh(48, 48, radius=10.0, displace_amp=0.25)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    jsc = jscn.build_scene(objs, jscn.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=jsc.meshes[0].obj_row,
                          use_cluster=True)
    jsc = jsc.replace(meshes=(m,))
    tsc = tmat.tscn_from(jsc)
    assert tsc.meshes[0].backface_cull and tsc.meshes[0].use_cluster
    cam = ((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = trnd.RenderConfig(width=24, height=16, nrays=2,
                            samples_per_wave=2, nb_bounces=3)
    img_on = tpt.Renderer(tsc, tpt.make_camera(*cam), cfg).render() \
        .display().numpy()
    off = tsc.replace(meshes=(dataclasses.replace(tsc.meshes[0],
                                                  backface_cull=False),))
    img_off = tpt.Renderer(off, tpt.make_camera(*cam), cfg).render() \
        .display().numpy()
    np.testing.assert_array_equal(img_on, img_off)
    assert img_on.mean() > 0.0
    tmat._compare_samples_of(jsc, tsc, jpt.make_camera(*cam),
                             tpt.make_camera(*cam), 24, 16, 2, 3)
