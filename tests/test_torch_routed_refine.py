"""PyTorch port, the routed cluster tier's refine round and tree tier
against the JAX package's, on rays that overflow MAXC (JAX's routed_hit
in interpret mode, the port's with the plain PyTorch sweeps and tree
cull on CPU tensors).  Residual masks equal on every lane; the hits by
`_assert_hits_match` of tests/test_torch_cluster.py; after the port's
bvh_hit_sparse net, t equal to brute force within 1e-5 and tri on >=
99.9% of lanes (tests/test_torch_tiers.py's tree-tier standard).
"""

import numpy as np
import torch
import jax.numpy as jnp

from pathtracer_tpu.ops import pallas_cluster as pc
from pathtracer_tpu.ops import routed_cluster as jrc
from pathtracer_tpu_torch.ops import bvh as tbvh
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import routed_cluster as trc
from pathtracer_tpu_torch.ops import traverse as ttr

import test_torch_tiers as ttiers
from test_torch_cluster import _assert_hits_match
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

BIG_T = np.float32(1e30)
BLOCK = pc.BLOCK


def _overflow_mesh(t, seed):
    tri = ttiers._random_mesh(t, seed)
    return (tri, pc.build_clustered(tri, tris_c=pc.SUBT),
            tc.build_clustered(tri, tris_c=tc.SUBT, dev='cpu'))


def _residual_case(tri, cj, ct, seed, refined=True):
    """JAX's and the port's routed_hit with residual masks, then the
    port's bvh_hit_sparse net against brute force.  `refined`: the rays
    overflow MAXC, a refine round runs and leaves residual lanes."""
    n = 2 * BLOCK
    o, d = ttiers._mixed_rays(n, seed=seed)
    tmax = np.full((n,), BIG_T, np.float32)
    t_j, tri_j, _, _, res_j = (np.asarray(x) for x in jrc.routed_hit(
        cj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        interpret=True, return_residual=True))
    ot, dt, tmt = (torch.as_tensor(x) for x in (o, d, tmax))
    trc.ROUTE_LOG = []
    try:
        t_t, tri_t, res_t = trc.routed_hit(ct, ot, dt, tmt,
                                           return_residual=True,
                                           with_bary=False)
        log = trc.ROUTE_LOG[0]
    finally:
        trc.ROUTE_LOG = None
    np.testing.assert_array_equal(res_t.numpy(), res_j)
    if refined:
        assert log['refined'] and log['refined'][0] > 0
        assert res_j.any() and not res_j.all()
    assert log['residual'] == int(res_j.sum())
    _assert_hits_match(t_j, tri_j, t_t, tri_t)

    fb = tbvh.build_bvh(tri)
    soup = ttr.make_soup(tri[fb.order], device='cpu')
    bvh = ttr.upload_bvh(fb, device='cpu')
    t2, tri2, _, _ = ttr.bvh_hit_sparse(bvh, soup, ot, dt, res_t,
                                        fb.max_leaf, t_t, tri_t,
                                        torch.ones(n), torch.zeros(n))
    ref = ttr.brute_force_hit(soup, ot, dt)
    np.testing.assert_allclose(t2.numpy(), ref.t.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (tri2.numpy() == ref.tri.numpy()).mean() >= 0.999


def test_overflow_refine_matches_jax():
    """~170 clusters, rays inside the mesh's box: packets overflow MAXC,
    the refine round re-culls them, residual lanes remain (dense tier)."""
    tri, cj, ct = _overflow_mesh(30000, 6)
    assert tc.MAXC < ct.n_clusters <= tc.DENSE_CULL_MAX
    _residual_case(tri, cj, ct, seed=7)


def test_tree_tier_matches_jax(monkeypatch):
    """DENSE_CULL_MAX lowered in both packages, as
    tests/test_torch_tiers.py does: the cull takes the tree cull.  The mesh
    (a size no other routed test builds: JAX's jit caches on the cluster
    count) is built here only."""
    tri, cj, ct = _overflow_mesh(9000, 25)
    monkeypatch.setattr(pc, 'DENSE_CULL_MAX', cj.n_clusters - 1)
    monkeypatch.setattr(tc, 'DENSE_CULL_MAX', ct.n_clusters - 1)
    calls = []
    monkeypatch.setattr(tc, 'cull_tree', lambda *a, **k: calls.append(1)
                        or tc.cull_tree_plain(*a, **k))
    _residual_case(tri, cj, ct, seed=26, refined=False)
    assert len(calls) == 1
