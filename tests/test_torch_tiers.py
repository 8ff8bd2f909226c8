"""PyTorch port, the mesh tiers besides the dense cluster tier, against the
JAX package on the same numpy inputs (CPU tensors, so every kernel wrapper
takes its plain version; the JAX side runs Pallas in interpret mode).

  * top tree of the cluster mesh: equal bit for bit (both packages build it
    with the same native builder);
  * tree cull (`cull_tree_plain` vs `pc._cull_call`): counts equal, kept id
    sets equal except ids whose key ties the 128th, keys within 1e-6
    relative;
  * packet tier (`packet_hit_plain` vs `pallas_bvh.packet_hit_packed`) and
    the lockstep BVH (`bvh_hit`, its any-hit variant, `bvh_hit_sparse`):
    t within 1e-6 relative + 1e-6 absolute, tri equal on >= 99.9% of lanes
    and every other lane an equal-t tie, alpha and beta within 1e-4 where
    tri agrees (an ulp of t moves the hit point by |d| ulp(t), which is
    1e-5 of a small triangle's edge: the tolerance of JAX's own
    tests/test_pallas_cluster.py);
  * tree tier end to end (DENSE_CULL_MAX lowered in both packages):
    residual masks equal, the hits to the sweep's tolerance of
    tests/test_torch_cluster.py (the tree tier sweeps with the same
    kernel, whose interpret-mode matmul order rounds t up to about 1e-5
    relative), and after the bvh_hit_sparse net t equal to brute force
    within 1e-5, the tolerance of the sweep's plane formula against the
    edge-matrix formula in tests/test_torch_cluster.py;
  * a render of the 2k mesh scene through the non-cluster tiers, per
    sample with the allowance of tests/test_torch_render.py, and the
    upload arrays (soup, BVH nodes) equal to JAX's bit for bit.
The CUDA kernels run only on a GPU (tests/test_torch_gpu.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.ops import bvh as jbvh
from pathtracer_tpu.ops import pallas_bvh as jpb
from pathtracer_tpu.ops import pallas_cluster as pc
from pathtracer_tpu.ops import traverse as jtr
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch import device as tdevice
from pathtracer_tpu_torch.ops import bvh as tbvh
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import packet_bvh as tpb
from pathtracer_tpu_torch.ops import traverse as ttr
from pathtracer_tpu_torch.render import film as tfilm
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import mesh as tmesh
from pathtracer_tpu_torch.scene import scene as tscn

import test_torch_cluster as tcluster
import test_torch_render as trender
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

BIG_T = np.float32(1e30)


def _random_mesh(t, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    return centers[:, None, :] + rng.normal(0, 0.35, (t, 3, 3)).astype(
        np.float32)


def _mixed_rays(n, seed, radius=30.0):
    """Half incoherent rays from inside the mesh's box, half rays from a
    sphere of `radius` aimed near the centre (distinct cull keys)."""
    rng = np.random.default_rng(seed)
    o1 = rng.uniform(-14, 14, (n // 2, 3))
    d1 = rng.normal(size=(n // 2, 3))
    p = rng.normal(size=(n - n // 2, 3))
    o2 = radius * p / np.linalg.norm(p, axis=1, keepdims=True)
    d2 = rng.normal(0, 6.0, (n - n // 2, 3)) - o2
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _sphere_tris():
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    return md.vertices[md.vtx_idx]


def _assert_hits_match(t_j, tri_j, al_j, be_j, t_t, tri_t, al_t, be_t,
                       min_hit=0.1):
    """Closest-hit agreement (module docstring); at least `min_hit` of the
    lanes hit."""
    t_j, tri_j, al_j, be_j = (np.asarray(x) for x in (t_j, tri_j, al_j, be_j))
    t_t, tri_t, al_t, be_t = (x.numpy() for x in (t_t, tri_t, al_t, be_t))
    np.testing.assert_allclose(t_t, t_j, rtol=1e-6, atol=1e-6)
    same = tri_t == tri_j
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(t_t[~same], t_j[~same])     # ties
    hit = same & (tri_j >= 0)
    assert hit.mean() > min_hit                                 # non-vacuous
    np.testing.assert_allclose(al_t[hit], al_j[hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(be_t[hit], be_j[hit], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# cluster tree tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module', params=[(9000, 5), (30000, 6)],
                ids=['9k', '30k'])
def tree_mesh(request):
    """Random meshes at tris_c = 256: ~50 clusters, and ~170 clusters that
    overflow MAXC."""
    t, seed = request.param
    tri = _random_mesh(t, seed)
    return (pc.build_clustered(tri, tris_c=pc.SUBT),
            tc.build_clustered(tri, tris_c=tc.SUBT, dev='cpu'), seed)


def test_top_tree_equals_jax(tree_mesh):
    cj, ct, _ = tree_mesh
    top = [np.asarray(x) for x in pc._top_arrays(cj)]
    np.testing.assert_array_equal(ct.top_box.numpy(),
                                  np.stack(top[0:6], axis=1))
    for name, ref in zip(('top_a', 'top_b', 'top_leaf', 'top_order'),
                         top[6:10]):
        np.testing.assert_array_equal(getattr(ct, name).numpy(), ref,
                                      err_msg=name)
    assert ct.top_max_leaf == cj.top_max_leaf
    # from_tpu_arrays carries the same tree across
    conv = tc.from_tpu_arrays(pc.cluster_arrays(cj), dev='cpu')
    for name in ('top_box', 'top_a', 'top_b', 'top_leaf', 'top_order'):
        np.testing.assert_array_equal(getattr(conv, name).numpy(),
                                      getattr(ct, name).numpy(),
                                      err_msg=name)
    assert conv.top_max_leaf == ct.top_max_leaf


def test_cull_tree_plain_matches_jax(tree_mesh):
    cj, ct, seed = tree_mesh
    n = 2 * pc.BLOCK
    o, d = _mixed_rays(n, seed + 100)
    tmax = np.full((n,), BIG_T, np.float32)
    tmax[::97] = -1.0                                  # dead lanes
    ids_j, cnt_j, keys_j = (np.asarray(x) for x in pc._cull_call(
        pc._top_arrays(cj), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), max_leaf=cj.top_max_leaf, interpret=True))
    ids_t, cnt_t, keys_t = (x.numpy() for x in tc.cull_tree(
        ct, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)))
    np.testing.assert_array_equal(cnt_t, cnt_j)
    if ct.n_clusters > tc.MAXC:
        assert (cnt_t[:, 0] > tc.MAXC).all()            # overflow exercised
    np.testing.assert_allclose(keys_t, keys_j, rtol=1e-6, atol=0)
    for b in range(n // pc.BLOCK):
        m = min(int(cnt_j[b, 0]), pc.MAXC)
        keep = np.ones(m, bool)
        if cnt_j[b, 0] > pc.MAXC:
            keep = keys_j[b, :m] < keys_j[b, m - 1]
        assert set(ids_t[b, :m][keep]) == set(ids_j[b, :m][keep])
        assert set(ids_t[b, :m]) <= set(range(ct.n_clusters))
        assert (ids_t[b, m:] == -1).all()


def test_cluster_cull_dispatch(tree_mesh, monkeypatch):
    """cluster_cull takes the torch culls up to DENSE_CULL_MAX clusters and
    the tree cull above; both give the same emission on these rays."""
    _, ct, seed = tree_mesh
    n = 2 * tc.BLOCK
    o, d = (torch.as_tensor(x) for x in _mixed_rays(n, seed + 200))
    tmax = torch.full((n,), float(BIG_T))
    dense = tc.cluster_cull(ct, o, d, tmax)
    monkeypatch.setattr(tc, 'DENSE_CULL_MAX', ct.n_clusters - 1)
    tree = tc.cluster_cull(ct, o, d, tmax)
    np.testing.assert_array_equal(tree[1].numpy(), dense[1].numpy())
    np.testing.assert_allclose(tree[2].numpy(), dense[2].numpy(), rtol=1e-6)


def test_tree_tier_matches_jax(monkeypatch):
    """two_level_hit on the tree tier (tree cull, one refine round, the
    residual mask), then the bvh_hit_sparse net against brute force.  The
    mesh (an unusual size: JAX's jit caches on the cluster count) is built
    by no other test."""
    tri = _random_mesh(26000, seed=21)
    cj = pc.build_clustered(tri, tris_c=pc.SUBT)
    ct = tc.build_clustered(tri, tris_c=tc.SUBT, dev='cpu')
    assert ct.n_clusters > tc.MAXC
    monkeypatch.setattr(pc, 'DENSE_CULL_MAX', cj.n_clusters - 1)
    monkeypatch.setattr(tc, 'DENSE_CULL_MAX', ct.n_clusters - 1)
    n = 2 * pc.BLOCK
    o, d = _mixed_rays(n, seed=22)
    tmax = np.full((n,), BIG_T, np.float32)
    t_j, tri_j, _, _, res_j = (np.asarray(x) for x in pc.two_level_hit(
        cj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        interpret=True, return_residual=True))
    ot, dt_, tmt = (torch.as_tensor(x) for x in (o, d, tmax))
    t_t, tri_t, res_t = tc.two_level_hit(ct, ot, dt_, tmt,
                                         return_residual=True)
    np.testing.assert_array_equal(res_t.numpy(), res_j)
    assert res_j.any() and not res_j.all()                   # non-vacuous
    tcluster._assert_hits_match(t_j, tri_j, t_t, tri_t)

    fb = tbvh.build_bvh(tri)
    soup = ttr.make_soup(tri[fb.order], device='cpu')
    bvh = ttr.upload_bvh(fb, device='cpu')
    t2, tri2, _, _ = ttr.bvh_hit_sparse(bvh, soup, ot, dt_, res_t,
                                        fb.max_leaf, t_t, tri_t,
                                        torch.ones(n), torch.zeros(n))
    ref = ttr.brute_force_hit(soup, ot, dt_)
    np.testing.assert_allclose(t2.numpy(), ref.t.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (tri2.numpy() == ref.tri.numpy()).mean() >= 0.999


def test_tree_tier_refuses_occlusion(tree_mesh, monkeypatch):
    """The reference cannot answer occlusion above DENSE_CULL_MAX clusters
    (_hier_cull asserts c <= 1 << 14), so the port refuses it too."""
    _, ct, _ = tree_mesh
    monkeypatch.setattr(tc, 'DENSE_CULL_MAX', ct.n_clusters - 1)
    o = torch.zeros((tc.BLOCK, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(tc.BLOCK, 1)
    with pytest.raises(NotImplementedError, match='1413-1414'):
        tc.two_level_any(ct, o, d, torch.full((tc.BLOCK,), 10.0))


# ---------------------------------------------------------------------------
# packet tier and lockstep BVH
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def small_bvh():
    """The 2k-triangle mesh scene's sphere: BVH, soup and packed nodes in
    both packages, and 2048 rays (camera-like and incoherent)."""
    tri = _sphere_tris()
    fj = jbvh.build_bvh(tri)
    ft = tbvh.build_bvh(tri)
    soup_j = jtr.make_soup(tri[fj.order])
    soup_t = ttr.make_soup(tri[ft.order], device='cpu')
    n = 2048
    rng = np.random.default_rng(31)
    dc = np.stack([rng.uniform(-0.4, 0.4, n // 2),
                   rng.uniform(-0.4, 0.4, n // 2), -np.ones(n // 2)], -1)
    oc = np.tile([0.0, 0.0, 40.0], (n // 2, 1))
    oi, di = _mixed_rays(n // 2, seed=32, radius=20.0)
    o = np.concatenate([oc, oi]).astype(np.float32)
    d = np.concatenate([dc / np.linalg.norm(dc, axis=1, keepdims=True),
                        di]).astype(np.float32)
    return dict(tri=tri, fj=fj, ft=ft, soup_j=soup_j, soup_t=soup_t, o=o, d=d)


def test_bvh_upload_equals_jax(small_bvh):
    s = small_bvh
    np.testing.assert_array_equal(s['ft'].order, s['fj'].order)
    for x, y in zip(s['soup_t'], s['soup_j']):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(ttr.upload_bvh(s['ft'], device='cpu'),
                    jtr.upload_bvh(s['fj'])):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    pk_t = tpb.pack_bvh(s['ft'], device='cpu')
    pk_j = jpb.pack_bvh(s['fj'])
    np.testing.assert_array_equal(
        pk_t.box.numpy(), np.stack([np.asarray(pk_j.lox), np.asarray(pk_j.loy),
                                    np.asarray(pk_j.loz), np.asarray(pk_j.hix),
                                    np.asarray(pk_j.hiy), np.asarray(pk_j.hiz)],
                                   axis=1))
    for name in ('na', 'nb', 'nleaf'):
        np.testing.assert_array_equal(getattr(pk_t, name).numpy(),
                                      np.asarray(getattr(pk_j, name)))
    assert pk_t.max_leaf == pk_j.max_leaf


@pytest.mark.parametrize('with_tmin', [False, True], ids=['tmax', 'tmin'])
def test_packet_hit_plain_matches_jax(small_bvh, with_tmin):
    s = small_bvh
    o, d = s['o'], s['d']
    n = o.shape[0]
    tmax = np.full((n,), BIG_T, np.float32)
    tmax[::5] = 30.0                                   # bounded lanes
    tmin = None
    if with_tmin:
        # exclude each lane's first hit (with a margin: the two packages
        # round its t an ulp apart), so the next one is found
        first = tpb.packet_hit_plain(s['soup_t'], torch.as_tensor(o),
                                     torch.as_tensor(d),
                                     torch.as_tensor(tmax))[0].numpy()
        tmin = np.where(first < tmax, first + 1e-3, -1.0).astype(np.float32)
    pk = jpb.pack_bvh(s['fj'])
    out_j = jpb.packet_hit_packed(
        pk, s['soup_j'], jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        interpret=True, tmin=None if tmin is None else jnp.asarray(tmin))
    out_t = tpb.packet_hit(tpb.pack_bvh(s['ft'], device='cpu'), s['soup_t'],
                           torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(tmax),
                           None if tmin is None else torch.as_tensor(tmin))
    _assert_hits_match(*out_j, *out_t)


@pytest.mark.parametrize('variant', ['closest', 'any_hit', 'sparse'])
def test_bvh_hit_matches_jax(small_bvh, variant):
    s = small_bvh
    o, d = s['o'], s['d']
    n = o.shape[0]
    bvh_j, bvh_t = jtr.upload_bvh(s['fj']), ttr.upload_bvh(s['ft'],
                                                          device='cpu')
    ml = int(s['ft'].max_leaf)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    ot, dt_ = torch.as_tensor(o), torch.as_tensor(d)
    if variant == 'closest':
        hj = jtr.bvh_hit(bvh_j, s['soup_j'], oj, dj, max_leaf=ml)
        ht = ttr.bvh_hit(bvh_t, s['soup_t'], ot, dt_, max_leaf=ml)
        _assert_hits_match(hj.t, hj.tri, hj.alpha, hj.beta,
                           ht.t, ht.tri, ht.alpha, ht.beta)
        ref = ttr.brute_force_hit(s['soup_t'], ot, dt_)
        np.testing.assert_allclose(ht.t.numpy(), ref.t.numpy(), rtol=1e-6)
    elif variant == 'any_hit':
        limit = np.random.default_rng(33).uniform(5, 60, n).astype(
            np.float32)
        bj = np.asarray(jtr.bvh_hit(bvh_j, s['soup_j'], oj, dj, max_leaf=ml,
                                    any_hit_limit=jnp.asarray(limit)).t)
        bt = ttr.bvh_hit(bvh_t, s['soup_t'], ot, dt_, max_leaf=ml,
                         any_hit_limit=torch.as_tensor(limit)).t.numpy()
        blocked = bt < limit
        assert 0.05 < blocked.mean() < 0.95                  # non-vacuous
        np.testing.assert_array_equal(blocked, bj < limit)
        np.testing.assert_allclose(bt, bj, rtol=1e-6, atol=1e-6)
        ref = ttr.brute_force_any(s['soup_t'], ot, dt_,
                                  torch.as_tensor(limit)).numpy()
        assert (blocked == ref).mean() >= 0.999
    else:
        rng = np.random.default_rng(34)
        active = rng.uniform(size=n) < 0.1
        t0 = np.where(rng.uniform(size=n) < 0.5, BIG_T, 35.0).astype(
            np.float32)
        tri0 = np.full((n,), -1, np.int32)
        one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
        out_j = jtr.bvh_hit_sparse(
            bvh_j, s['soup_j'], oj, dj, jnp.asarray(active), ml,
            jnp.asarray(t0), jnp.asarray(tri0), jnp.asarray(one),
            jnp.asarray(zero), chunk=64)
        out_t = ttr.bvh_hit_sparse(
            bvh_t, s['soup_t'], ot, dt_, torch.as_tensor(active), ml,
            torch.as_tensor(t0), torch.as_tensor(tri0), torch.as_tensor(one),
            torch.as_tensor(zero), chunk=64)
        _assert_hits_match(*out_j, *out_t, min_hit=0.03)
        # inactive lanes pass through untouched
        np.testing.assert_array_equal(out_t[0].numpy()[~active], t0[~active])
        assert (out_t[1].numpy()[active] >= 0).any()


# ---------------------------------------------------------------------------
# the 2k mesh scene through the non-cluster tiers
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def noncluster_scene():
    md = trender._mesh_data()
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    sc = jscn.build_scene(objs, jscn.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=sc.meshes[0].obj_row, use_cluster=False)
    assert m.use_brute and not m.use_packet and not m.use_cluster
    sc = sc.replace(meshes=(m,))
    return md, sc, convert.scene_from_numpy(convert.numpy_fields(sc),
                                            device='cpu')


def test_noncluster_upload_equals_jax(noncluster_scene):
    """upload_mesh(use_cluster=False) on the CPU: the brute tier, with the
    soup and BVH nodes of JAX's upload, no 'bary' pack columns and no
    cluster count; the conversion of JAX's mesh gives the same arrays."""
    md, jsc, conv = noncluster_scene
    jm, (cm,) = jsc.meshes[0], conv.meshes
    own = tmesh.upload_mesh(md, obj_row=jm.obj_row, use_cluster=False,
                            dev='cpu')
    assert (own.use_brute, own.use_packet, own.use_cluster) == \
        (True, False, False)
    assert own.n_clusters == 0 and own.clustered is None
    assert own.col('bary') is None
    for x, y in zip(own.soup, jm.soup):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(own.bvh, jm.bvh):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for f in dataclasses.fields(own):
        a, b = getattr(own, f.name), getattr(cm, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f.name)
        elif isinstance(a, tuple) and a and isinstance(a[0], torch.Tensor):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                              err_msg=f.name)
        else:
            assert a == b, f.name


def test_noncluster_render_matches_jax(noncluster_scene):
    """Brute tier against brute tier, per sample."""
    _, jsc, conv = noncluster_scene
    trender._compare_samples(jsc, conv)


def test_bvh_tier_render_matches_brute_tier(noncluster_scene):
    """The lockstep-BVH tier (use_brute=False) renders what the brute tier
    renders, per sample, and its shadow rays take the any-hit walk."""
    md, _, conv = noncluster_scene
    row = conv.meshes[0].obj_row
    m = tmesh.upload_mesh(md, obj_row=row, use_cluster=False,
                          use_brute=False, dev='cpu')
    assert not (m.use_brute or m.use_packet or m.use_cluster)
    cp = rng_host.random_per_pixel_fast(trender.W, trender.H)
    cfg = trnd.RenderConfig(width=trender.W, height=trender.H,
                            nrays=trender.SPP, nb_bounces=trender.BOUNCES)
    cam = tpt.make_camera(*trender.CAM)
    out = [trnd.render_unsplatted(sc, cam, torch.as_tensor(cp), cfg)[1]
           .numpy() for sc in (conv, dataclasses.replace(conv, meshes=(m,)))]
    scale = max(np.abs(out[0]).max(), 1e-6)
    rel = np.abs(out[1] - out[0]).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3


# ---------------------------------------------------------------------------
# the default device
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card():
    """Every entry point called without a device builds on the card; on a
    machine without one it fails at its first CUDA allocation."""
    assert tdevice.default_device() == torch.device('cuda')
    tri = _sphere_tris()[:64]
    fb = tbvh.build_bvh(tri)
    calls = {
        'make_soup': lambda: ttr.make_soup(tri).ax,
        'upload_bvh': lambda: ttr.upload_bvh(fb).a,
        'pack_bvh': lambda: tpb.pack_bvh(fb).box,
        'build_clustered': lambda: tc.build_clustered(tri).planes,
        'make_film': lambda: tfilm.make_film(8, 6).ratio,
        'build_scene': lambda: tscn.build_scene(
            tscn.default_objects(), tscn.default_light_intensity()).kd,
    }
    have_card = torch.cuda.is_available()
    for name, call in calls.items():
        try:
            out = call()
        except (RuntimeError, AssertionError):
            assert not have_card, name
            continue
        assert out.device.type == 'cuda', name
