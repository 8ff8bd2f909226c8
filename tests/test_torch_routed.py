"""PyTorch port, the routed cluster tier (ops/routed_cluster.py) against
the JAX package's (pathtracer_tpu/ops/routed_cluster.py) on the same numpy
inputs.  The JAX side runs the Pallas sweeps in interpret mode; the port
runs the plain PyTorch sweeps (CPU tensors).  Tolerances:
  * per-lane slab entries, their clusters and the run layout: equal bit
    for bit (the same float32 operations in the same order);
  * closest hits: `_assert_hits_match` of tests/test_torch_cluster.py
    (tri equal on >= 99.9% of lanes, every other lane a tie within 2^-16
    relative t, t within 1e-5 relative where tri agrees), misses return
    the caller's tmax exactly, alpha within 1e-4 where tri agrees (the
    edge-matrix recompute of tests/test_torch_tiers.py);
The refine round and the tree tier are in tests/test_torch_routed_refine.py,
the uploads and renders of a routed mesh in
tests/test_torch_routed_render.py; the kernels themselves run only on a
GPU (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.ops import pallas_cluster as pc
from pathtracer_tpu.ops import routed_cluster as jrc
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import routed_cluster as trc

import test_routed_cluster as jroute
from test_torch_cluster import _assert_hits_match
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

BIG_T = np.float32(1e30)
BLOCK = pc.BLOCK


@pytest.fixture(scope='module')
def terrain():
    """JAX's routed-test terrain, ~16k tris at tris_c = 512, both builds."""
    tri = jroute._terrain(90)
    return (pc.build_clustered(tri, tris_c=512),
            tc.build_clustered(tri, tris_c=512, dev='cpu'))


def _incoherent(n, seed=5):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    org[:, 1] = rng.uniform(6, 30, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] -= 0.6
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d


def _case_rays(case):
    """(org, dirn, tmax, routed_hit keywords) of JAX's routed test cases."""
    kw = {}
    if case == 'incoherent':
        o, d = _incoherent(2 * BLOCK)
    else:
        seed, pitch = {'coherent': (1, -1.8), 'rounds2': (3, -1.8),
                       'bounded': (7, -1.8), 'tmin': (9, -0.5),
                       'two_level': (11, -1.8)}[case]
        o, d = (np.asarray(x) for x in jroute._camera_rays(
            BLOCK, seed=seed, pitch=pitch))
    tmax = np.full(len(o), 26.0 if case == 'bounded' else BIG_T, np.float32)
    if case == 'rounds2':
        kw['rounds'] = 2
    return o, d, tmax, kw


def _torch(*xs):
    return tuple(torch.tensor(np.array(x)) for x in xs)


@pytest.mark.parametrize('case', ['coherent', 'incoherent', 'rounds2',
                                  'bounded', 'tmin', 'two_level'])
def test_routed_hit_matches_jax(terrain, case):
    cj, ct = terrain
    o, d, tmax, kw = _case_rays(case)
    tmin = None
    if case == 'tmin':
        # JAX's test: a strict floor at 1.02x the first hit
        t0 = np.asarray(jrc.routed_hit(cj, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(tmax), interpret=True)[0])
        tmin = np.where(t0 < 1e29, t0 * np.float32(1.02),
                        np.float32(-1.0)).astype(np.float32)
    t_j, tri_j, al_j, _ = (np.asarray(x) for x in jrc.routed_hit(
        cj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        tmin=None if tmin is None else jnp.asarray(tmin), interpret=True,
        **kw))
    ot, dt, tmt = _torch(o, d, tmax)
    trc.ROUTE_LOG = []
    try:
        t_t, tri_t, al_t, _ = trc.routed_hit(
            ct, ot, dt, tmt, tmin=None if tmin is None else
            torch.as_tensor(tmin), **kw)
        log = trc.ROUTE_LOG
    finally:
        trc.ROUTE_LOG = None
    assert (tri_t.numpy() >= 0).any()                     # non-vacuous
    assert len(log[0]['runs']) == kw.get('rounds', 1)
    assert log[0]['lanes'][0] > 0                         # lanes routed
    _assert_hits_match(t_j, tri_j, t_t, tri_t)
    miss = tri_t.numpy() < 0
    np.testing.assert_array_equal(t_t.numpy()[miss], tmax[miss])
    same = (tri_t.numpy() == tri_j) & ~miss
    np.testing.assert_allclose(al_t.numpy()[same], al_j[same], rtol=0,
                               atol=1e-4)
    if case == 'two_level':
        t_p, tri_p = tc.two_level_hit(ct, ot, dt, tmt)
        _assert_hits_match(t_p.numpy(), tri_p.numpy(), t_t, tri_t)


def _jax_round_inputs(cj, o, d, tmax):
    """JAX's first round up to the routing: the clamped tmax, the cull,
    the lane entries and each lane's cluster."""
    org, dirn = jnp.asarray(o), jnp.asarray(d)
    tx = pc.root_exit_clamp(cj, org, dirn, jnp.asarray(tmax))
    ids, counts, keys = pc.cluster_cull(cj, org, dirn, tx)
    ent, cid_k = jrc._lane_entries(
        (cj.cb_lox, cj.cb_loy, cj.cb_loz, cj.cb_hix, cj.cb_hiy, cj.cb_hiz),
        ids, org, dirn, tx, 8)
    j = jnp.argmin(ent, axis=1)
    cid = jnp.take_along_axis(cid_k, j[:, None], axis=1)[:, 0]
    cid = jnp.where((jnp.min(ent, axis=1) < tx) & (cid >= 0), cid,
                    cj.n_clusters)
    return tx, ids, ent, cid_k, cid


def test_lane_entries_and_run_layout_equal_jax(terrain, monkeypatch):
    """_lane_entries' (ent, cid) and the nearest slot bit-equal to JAX's;
    the run packets (cluster of each, ray and tmax of each lane) equal to
    the used prefix of JAX's fixed-capacity layout, whose remaining
    packets hold no lane."""
    cj, ct = terrain
    o, d = _incoherent(2 * BLOCK, seed=13)
    tmax = np.full(len(o), BIG_T, np.float32)
    tx, ids, ent_j, cid_kj, cid_j = (np.asarray(x) for x in
                                     _jax_round_inputs(cj, o, d, tmax))
    ot, dt, tmt = _torch(o, d, tmax)
    tx_t = tc.root_exit_clamp(ct.bounds, ot, dt, tmt)
    np.testing.assert_array_equal(tx_t.numpy(), tx)
    ids_t = tc.cluster_cull(ct, ot, dt, tx_t)[0]
    np.testing.assert_array_equal(ids_t.numpy(), ids)
    ent_t, cid_kt = trc._lane_entries(ct.bounds, ids_t, ot, dt, tx_t, 8)
    np.testing.assert_array_equal(ent_t.numpy().view(np.int32),
                                  ent_j.view(np.int32))
    np.testing.assert_array_equal(cid_kt.numpy(), cid_kj)
    e_min, j = trc._nearest_slot(ent_t)
    np.testing.assert_array_equal(j.numpy(), np.argmin(ent_j, axis=1))
    assert (np.asarray(cid_j) < ct.n_clusters).sum() > 50

    captured = {}

    def capture(ids_r, cnt_r, key_r, packed, org, dirn, tmax_r, tmin_r,
                interpret):
        captured.update(ids=np.asarray(ids_r), cnt=np.asarray(cnt_r),
                        org=np.asarray(org), tmax=np.asarray(tmax_r))
        n = org.shape[0]
        return (tmax_r, jnp.full((n,), -1, jnp.int32), jnp.ones((n,)),
                jnp.zeros((n,)))

    monkeypatch.setattr(jrc, '_sweep_full', capture)
    n = len(o)
    jrc._route_and_sweep(cj.packed, jnp.asarray(o), jnp.asarray(d),
                         jnp.full((n,), -1.0), jnp.asarray(cid_j),
                         jnp.asarray(tx), jnp.full((n,), -1, jnp.int32),
                         jnp.ones((n,)), jnp.zeros((n,)), cj.n_clusters,
                         True)
    c_b, ray, valid = trc.run_layout(torch.tensor(cid_j).long(),
                                     ct.n_clusters)
    nb = c_b.shape[0]
    assert nb > 1
    np.testing.assert_array_equal(c_b.numpy(), captured['ids'][:nb, 0])
    assert (captured['cnt'][:nb] == 1).all()
    assert (captured['cnt'][nb:] == 0).all()
    np.testing.assert_array_equal(ot[ray].numpy(),
                                  captured['org'][:nb * BLOCK])
    tmax_r = torch.where(valid, tx_t[ray], torch.full_like(tx_t[ray], -1.0))
    np.testing.assert_array_equal(tmax_r.numpy(),
                                  captured['tmax'][:nb * BLOCK])
    assert (captured['tmax'][nb * BLOCK:] == -1.0).all()
