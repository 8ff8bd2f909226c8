"""PyTorch port, a routed mesh with an alpha cut-out map against the JAX
package's: a 32x24, 2 spp, 2-bounce render per sample with the allowance
of tests/test_integrator_vs_cpu.py:64-92 (tests/test_torch_routed_render.
compare_routed).  Two cut-out rounds: the second queries the routed tier
under a rising per-lane strict floor (JAX's compile of its rounds takes
most of this file's time, about 13 s a round).
"""

import numpy as np

from pathtracer_tpu.scene import scene as jscn

import test_torch_materials as tmat
from test_torch_routed_render import compare_routed
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)


def test_routed_cutout_render_matches_jax():
    rng = np.random.default_rng(10)
    md = tmat._grouped_sphere(12, groups=3, uv_scale=3.0)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(
        md, translation=(0.0, -15.0, 0.0), cutout_rounds=2,
        textures=tmat._cutout_textures(rng, 3, (0, 2))))
    log = compare_routed(objs)
    assert any(len(e['lanes']) > 1 for e in log)
