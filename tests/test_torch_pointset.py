"""PyTorch port, point sets and yarns, against the JAX package on the same
inputs (numpy, from seeds).

Tolerances:
  * host code (load_xyz, estimate_normals, morton_order,
    _cluster_particles, fluid_pointset, load_yarn, upload_yarns) equal;
  * the brute sweeps (disk_sweep, sphere_sweep, sphere_union_exit,
    cylinder_sweep) bit-equal in t, index, axial s and inside: the same
    IEEE operations in the same order, one chunk of points after another
    with a strict `<` update; also with the rays cut into tiles;
  * the clustered sweeps: the port's equal its own brute sweeps bit for
    bit (t and index; the union exit where the brute walk has converged);
    JAX's jitted slot sweeps round the roots in XLA's fused form (up to
    1e-4 relative against its own brute sweep), so against JAX t within
    2e-4 relative (the JAX suite's tolerance for clustered against
    brute, tests/test_fluid_cluster.py) and the index equal on >= 99.5%
    of the hitting lanes; a forced MAXC_P overflow keeps every hit in both
    packages;
  * the overflow reroute, which sweeps only the clusters a lane's ray
    enters, bit-equal to the brute sweeps it stands for (t, index,
    inside); the clustered sweep with most lanes rerouted equals the brute
    sweep in t, and in index but for exact ties (>= 99.9%: the slots
    resolve a tie in key order, the brute sweep by index);
  * intersect / intersect_shadow on a scene with disks, particle spheres
    and yarns: obj_id and occlusion equal on >= 99.5% of lanes; where
    obj_id agrees t within 2e-4 relative, and points, normals and Kd
    within 1e-3 + 2e-4 t on >= 99.9% of the lanes (a grazing root turns
    XLA's 1e-4 into more);
  * per-sample renders (32x24, 2 spp, 2 bounces) of a disk cloud, yarns,
    an opaque and a transparent fluid: the boundary-flip allowance of
    tests/test_integrator_vs_cpu.py (fewer than 5% of samples beyond 1e-3
    of the image scale, the rest within 1e-3, means within 2%);
  * the slot sweeps, which test a slot's cluster only against the lanes
    whose ray enters its padded box, bit-equal to JAX's dense statement of
    them (every lane of the packet) for origins near and 1e3 away;
  * two pinned divergences: a point set in front of an env-mapped dome
    keeps the dome's emission in JAX (its merge never clears ke), the
    port clears it as a mesh does; and from 1e6 away JAX's quadratic
    rounds hits onto rays that pass 20-200 units beside the cloud, which
    the port's padded test does not reproduce.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import pointset as jps
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.scene import yarns as jya
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import pointset as tps
from pathtracer_tpu_torch.scene import scene as tscn
from pathtracer_tpu_torch.scene import yarns as tya

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

BIG_T = np.float32(1e30)
W, H, SPP, BOUNCES = 32, 24, 2, 2
CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _np(xs):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in xs]


def _rays(n, seed, aim=(0.0, 0.0, 0.0), spread=20.0, jitter=3.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = (np.asarray(aim, np.float32)
         + rng.normal(0, jitter, (n, 3)).astype(np.float32)) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32)


def _cloud(n, seed, spread):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, spread / 3.0, (n, 3)).astype(np.float32)


def _surface(n=600, seed=2):
    """A bumpy sheet facing +z around (0, -16, 0), with colours."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, n)
    y = rng.uniform(-24, -8, n)
    z = 2.0 * np.sin(x * 0.3) * np.cos((y + 16.0) * 0.25)
    col = rng.uniform(0.2, 0.9, (n, 3))
    return (np.stack([x, y, z], -1).astype(np.float32),
            col.astype(np.float32))


def _segments(path):
    """A .yarn file: four wavy polylines across the view (scaled x50 on
    load), returned with its path."""
    lines = ['4']
    for k in range(4):
        xs = np.linspace(-0.3, 0.3, 13)
        ys = -0.25 - 0.06 * k + 0.02 * np.sin(xs * 20 + k)
        zs = 0.03 * np.cos(xs * 15 + k)
        lines.append(str(len(xs)))
        lines += [f'{x:.6f} {y:.6f} {z:.6f}' for x, y, z in zip(xs, ys, zs)]
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


def test_xyz_and_normals_match_jax(tmp_path):
    pts, col = _surface()
    nrm = np.zeros_like(pts)
    nrm[:, 2] = 1.0
    data = np.concatenate([pts, nrm, col * 255.0], 1)
    path = tmp_path / 'cloud.xyz'
    np.savetxt(path, data, fmt='%.6f')
    cols = [0, 1, 2, -1, -1, -1, 6, 7, 8]
    for centered in (True, False):
        for a, b in zip(jps.load_xyz(str(path), cols, centered),
                        tps.load_xyz(str(path), cols, centered)):
            np.testing.assert_array_equal(a, b)
    p, _, _ = tps.load_xyz(str(path), cols, centered=False)
    for a, b in zip(jps.estimate_normals(p), tps.estimate_normals(p)):
        np.testing.assert_array_equal(a, b)
    jp = jps.make_pointset(str(path), cols=cols, display_edges=True)
    tp = tps.make_pointset(str(path), cols=cols, display_edges=True,
                           device='cpu')
    for k in ('px', 'py', 'pz', 'nx', 'ny', 'nz', 'radius', 'colors'):
        np.testing.assert_array_equal(np.asarray(getattr(jp, k)),
                                      getattr(tp, k).numpy(), err_msg=k)
    assert tp.display_edges and not tp.as_spheres


def test_morton_and_clusters_match_jax():
    pts = _cloud(9000, 0, 12.0)
    np.testing.assert_array_equal(jps.morton_order(pts),
                                  tps.morton_order(pts))
    rng = np.random.default_rng(1)
    radii = rng.uniform(0.1, 0.5, len(pts)).astype(np.float32)
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    col = rng.uniform(size=pts.shape).astype(np.float32)
    for a, b in zip(jps._cluster_particles(pts, radii, nrm, col),
                    tps._cluster_particles(pts, radii, nrm, col)):
        np.testing.assert_array_equal(a, b)
    jp = jps.fluid_pointset(pts, obj_row=3, radius=0.3, color=col)
    tp = tps.fluid_pointset(pts, obj_row=3, radius=0.3, color=col,
                            device='cpu')
    assert tp.n_clusters == jp.n_clusters > 0 and tp.as_spheres
    assert tp.num_points % tps.CLUSTER_P == 0
    for f in dataclasses.fields(tp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    small = tps.fluid_pointset(pts[:100], device='cpu')
    assert small.n_clusters == 0 and small.c_lox is None


@pytest.fixture(scope='module')
def clouds():
    """An entry cloud (3,000 particles, r 0.35) and a union cloud (2,500,
    r 0.6), both clustered, in both packages."""
    a, b = _cloud(3000, 0, 10.0), _cloud(2500, 5, 6.0)
    return {name: (jps.fluid_pointset(p, obj_row=3, radius=r,
                                      clustered=True),
                   tps.fluid_pointset(p, obj_row=3, radius=r, clustered=True,
                                      device='cpu'))
            for name, p, r in (('entry', a, 0.35), ('union', b, 0.6))}


def _inside_rays(ps, n=500, seed=7):
    """Rays from particle centres (inside the union), random directions."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 2000, n)
    org = np.stack([_np([ps.px])[0][pick], _np([ps.py])[0][pick],
                    _np([ps.pz])[0][pick]], -1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.mark.parametrize('tile', [None, 300])
def test_brute_sweeps_match_jax(clouds, monkeypatch, tile):
    """disk_sweep, sphere_sweep, sphere_union_exit bit-equal to JAX, also
    with the rays tiled."""
    if tile:
        monkeypatch.setattr(tps, 'RAY_TILE', tile)
    jp, tp = clouds['entry']
    org, d = _rays(2000, 1)
    big = np.full(len(org), BIG_T)
    for a, b in zip(_np(jps.sphere_sweep(jp, *_j(org, d, big))),
                    _np(tps.sphere_sweep(tp, *_t(org, d, big)))):
        np.testing.assert_array_equal(a, b)
    jp_u, tp_u = clouds['union']
    org_u, d_u = _inside_rays(jp_u)
    for a, b in zip(_np(jps.sphere_union_exit(jp_u, *_j(org_u, d_u))),
                    _np(tps.sphere_union_exit(tp_u, *_t(org_u, d_u)))):
        np.testing.assert_array_equal(a, b)
    pts, col = _surface()
    jd = jps.make_pointset(pts, colors=col)
    td = tps.make_pointset(pts, colors=col, device='cpu')
    org_d, d_d = _rays(2000, 3, aim=(0.0, -16.0, 0.0), jitter=5.0)
    tmax = np.random.default_rng(4).uniform(10, 80, 2000).astype(np.float32)
    hits = []
    for a, b in zip(_np(jps.disk_sweep(jd, *_j(org_d, d_d, tmax))),
                    _np(tps.disk_sweep(td, *_t(org_d, d_d, tmax)))):
        np.testing.assert_array_equal(a, b)
        hits.append(a)
    assert 0.1 < (hits[1] >= 0).mean() < 0.9


def test_clustered_sweeps_match_brute_and_jax(clouds):
    jp, tp = clouds['entry']
    org, d = _rays(2000, 1)
    big = np.full(len(org), BIG_T)
    tc, ic = _np(tps.clustered_sphere_sweep(tp, *_t(org, d, big)))
    tb, ib = _np(tps.sphere_sweep(tp, *_t(org, d, big)))
    np.testing.assert_array_equal(tc, tb)
    np.testing.assert_array_equal(ic, ib)
    tj, ij = _np(jps.clustered_sphere_sweep(jp, *_j(org, d, big)))
    hit = tj < 1e29
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(tc < 1e29, hit)
    np.testing.assert_allclose(tc[hit], tj[hit], rtol=2e-4)
    assert (ic[hit] == ij[hit]).mean() > 0.995

    jp_u, tp_u = clouds['union']
    org_u, d_u = _inside_rays(jp_u)
    ec, xc, nc = _np(tps.clustered_union_exit(tp_u, *_t(org_u, d_u)))
    eb, xb, nb = _np(tps.sphere_union_exit(tp_u, *_t(org_u, d_u), iters=40))
    assert nc.all() and nb.all()
    np.testing.assert_array_equal(ec, eb)
    np.testing.assert_array_equal(xc, xb)
    ej, xj, nj = _np(jps.clustered_union_exit(jp_u, *_j(org_u, d_u)))
    np.testing.assert_array_equal(nc, nj)
    np.testing.assert_allclose(ec, ej, rtol=2e-4)
    assert (xc == xj).mean() > 0.995


def _dense_slots(ps, ids, keys, org, dirn, tmax, union):
    """JAX's slot sweeps as it states them (_clustered_entry_exec,
    _clustered_union_exec): every lane of a live packet against all of
    the slot's particles."""
    nb = org.shape[0] // 512
    o, d = org.view(nb, 512, 3), dirn.view(nb, 512, 3)
    a = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
         + d[..., 2] * d[..., 2])[..., None]
    ex = torch.zeros((nb, 512)) if union else tmax.view(nb, 512).clone()
    ix = torch.full((nb, 512), -1, dtype=torch.int32)
    ins = torch.zeros((nb, 512), dtype=torch.bool)
    outer = torch.arange(nb)
    for _ in range(tps.UNION_PASSES if union else 1):
        before, live = ex[outer].clone(), outer
        for s in range(tps.MAXC_P):
            k, m = keys[live, s], ex[live].amax(1)
            live = live[k <= m + tps.UNION_EPS if union else k < m]
            if live.numel() == 0:
                break
            cid = ids[live, s]
            c = cid.clamp_min(0).long()
            sx, sy, sz, sr = (v.view(-1, 256)[c][:, None, :]
                              for v in (ps.px, ps.py, ps.pz, ps.radius))
            ol, dl = o[live], d[live]
            delta, t1, t2 = tps._sphere_roots(
                (ol[..., 0:1], ol[..., 1:2], ol[..., 2:3]),
                (dl[..., 0:1], dl[..., 1:2], dl[..., 2:3]), a[live],
                sx, sy, sz, sr)
            base = (c * 256).to(torch.int32)[:, None]
            e = ex[live]
            if union:
                ok = (delta >= 0) & (t2 > 0) & (cid >= 0)[:, None, None]
                ins[live] |= (ok & (t1 < 0)).any(-1)
                straddle = ok & (t1 <= e[..., None] + tps.UNION_EPS) \
                    & (t2 > e[..., None])
                t = torch.where(straddle, t2, torch.full_like(t2, -1.0))
                j = t.argmax(-1)
                tj = t.gather(2, j[..., None])[..., 0]
                win = tj > e
            else:
                t = tps._entry_t(delta, t1, t2)
                t = torch.where((cid >= 0)[:, None, None], t,
                                torch.full_like(t, BIG_T))
                j = t.argmin(-1)
                tj = t.gather(2, j[..., None])[..., 0]
                win = tj < e
            ix[live] = torch.where(win, base + j.to(torch.int32), ix[live])
            ex[live] = torch.where(win, tj, e)
        outer = outer[(ex[outer] > before).any(1)]
    return ex.view(-1), ix.view(-1), ins.view(-1)


def _far_rays(n, dist, seed, beside=(0.0, 0.0)):
    """n rays from `dist` away aimed at the origin, their origins moved
    sideways by a random offset of length in `beside`."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    side = np.cross(d, rng.normal(size=(n, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    off = rng.uniform(*beside, (n, 1)) if beside[1] else 0.0
    org = -d * np.float32(dist) + side * off
    return org.astype(np.float32), d


def test_slot_sweeps_equal_dense_slots(clouds):
    """The slot sweeps test only the lanes whose ray enters a slot
    cluster's padded box; they equal JAX's dense statement of them bit
    for bit, for rays from nearby and from 1e3 away (the far ground)."""
    for union in (False, True):
        jp, tp = clouds['union' if union else 'entry']
        org, d = _inside_rays(jp, 2000, 23) if union else _rays(3000, 21)
        o_f, d_f = _far_rays(1024, 1e3, 22, beside=(0.0, 3.0))
        o, dd = _t(np.concatenate([org, o_f]), np.concatenate([d, d_f]))
        big = torch.full((len(o),), float(BIG_T))
        ids, count, keys, po, pd, pt_ = tps._cull_spheres(tp, o, dd, big)
        ref = _dense_slots(tp, ids, keys, po, pd, pt_, union)
        got = (tps._union_slots(tp, ids, keys, po, pd)[:3] if union
               else tps._entry_slots(tp, ids, keys, po, pd, pt_)[:2])
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert (ref[1] >= 0).float().mean() > 0.1
        assert not union or ref[2].float().mean() > 0.3


def test_far_rounding_hits_pinned(clouds):
    """The pinned divergence: rays from 1e6 away (the dome) passing 20 to
    200 units beside the cloud, in packets with rays through it.  JAX's
    dense slot sweep reports hits on some of them, which its quadratic
    rounds at |o - centre|^2 = 1e12; the port's padded test stops growing
    at PAD_REACH, so it reports none."""
    _, tp = clouds['entry']
    near, d_near = _rays(2048, 31)
    o_f, d_f = _far_rays(2048, 1e6, 32, beside=(20.0, 200.0))
    # interleave: each 512-ray packet holds 256 of each
    org = np.stack([near.reshape(-1, 256, 3), o_f.reshape(-1, 256, 3)],
                   1).reshape(-1, 3)
    d = np.stack([d_near.reshape(-1, 256, 3), d_f.reshape(-1, 256, 3)],
                 1).reshape(-1, 3)
    far = np.tile(np.repeat([False, True], 256), 8)
    o, dd = _t(org, d)
    big = torch.full((len(o),), float(BIG_T))
    ids, count, keys, po, pd, pt_ = tps._cull_spheres(tp, o, dd, big)
    ref_t, ref_i, _ = _dense_slots(tp, ids, keys, po, pd, pt_, False)
    got_t, got_i, _, _ = tps._entry_slots(tp, ids, keys, po, pd, pt_)
    np.testing.assert_array_equal(got_t.numpy()[~far], ref_t.numpy()[~far])
    assert (got_i.numpy()[far] < 0).all()
    assert (ref_i.numpy()[far] >= 0).sum() > 0


def test_reroute_matches_brute(clouds, monkeypatch):
    """The overflow reroute sweeps only the clusters a lane's ray enters
    and gives the brute sweep's bits: (t, index) below each lane's tmax,
    and the union walk's 12 passes.  Incoherent rays from inside the
    cloud overflow their packets, so the clustered sweeps reroute most
    lanes and still equal the brute sweeps."""
    rng = np.random.default_rng(9)
    for name, iters in (('entry', None), ('union', 12)):
        jp, tp = clouds[name]
        org, d = _inside_rays(jp, n=3000, seed=10)
        org = org + rng.normal(0, 0.3, org.shape).astype(np.float32)
        org[:500] -= d[:500] * np.float32(1e5)      # far origins
        o, dd = _t(org, d)
        if iters is None:
            tmax = torch.as_tensor(rng.uniform(1, 30, len(org)).astype(
                np.float32))
            idx0 = torch.full((len(org),), -1, dtype=torch.int32)
            for a, b in zip(tps._reroute_entry(tp, o, dd, tmax, idx0),
                            tps.sphere_sweep(tp, o, dd, tmax)):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            for a, b in zip(tps._reroute_union(tp, o, dd),
                            tps.sphere_union_exit(tp, o, dd)):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    tp = tps.fluid_pointset(_cloud(40000, 12, 12.0), radius=0.3,
                            device='cpu')
    assert tp.n_clusters > 2 * tps.MAXC_P
    rng = np.random.default_rng(11)
    org = _cloud(3000, 13, 12.0)
    d = rng.normal(size=org.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    big = np.full(len(org), BIG_T)
    monkeypatch.setattr(tps, 'SWEEP_LOG', [])
    tc, ic = _np(tps.clustered_sphere_sweep(tp, *_t(org, d, big)))
    assert tps.SWEEP_LOG[0]['residual'] > 0.3 * len(org)
    tb, ib = _np(tps.sphere_sweep(tp, *_t(org, d, big)))
    np.testing.assert_array_equal(tc, tb)
    assert (ic == ib).mean() > 0.999


def test_overflow_reroute_keeps_hits(monkeypatch):
    """A particle chain along +x: an axial ray enters more than MAXC_P
    cluster boxes.  One lane hits the chain at once; one runs along the
    boxes' corner, outside every chain sphere, to a lone particle past the
    64th box, which only the brute reroute finds."""
    n = tps.CLUSTER_P * (tps.MAXC_P + 8)
    x = np.linspace(0.0, 400.0, n).astype(np.float32)
    pts = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)
    pts = np.concatenate([pts, [[390.0, 0.29, 0.29]]]).astype(np.float32)
    jp = jps.fluid_pointset(pts, radius=0.3, clustered=True)
    tp = tps.fluid_pointset(pts, radius=0.3, clustered=True, device='cpu')
    assert tp.n_clusters > tps.MAXC_P
    org = np.asarray([[-5.0, 0.29, 0.29], [405.0, 0.2, 0.0],
                      [-5.0, 0.0, 0.0]], np.float32)
    d = np.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                   np.float32)
    big = np.full(3, BIG_T)
    monkeypatch.setattr(tps, 'SWEEP_LOG', [])
    tc, ic = _np(tps.clustered_sphere_sweep(tp, *_t(org, d, big)))
    log = tps.SWEEP_LOG[0]
    assert log['overflowed'] == 1 and log['residual'] == 1
    tb, ib = _np(tps.sphere_sweep(tp, *_t(org, d, big)))
    tj, ij = _np(jps.clustered_sphere_sweep(jp, *_j(org, d, big)))
    np.testing.assert_array_equal(tc, tb)
    np.testing.assert_array_equal(ic, ib)
    np.testing.assert_allclose(tc, tj, rtol=2e-4)
    np.testing.assert_array_equal(ic, ij)
    assert tc[0] > 390.0 and (tc < 1e29).all()
    # the union walk along the chain: more than MAXC_P clusters straddle
    o_in = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    d_in = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    ec = _np(tps.clustered_union_exit(tp, *_t(o_in, d_in)))
    ej = _np(jps.clustered_union_exit(jp, *_j(o_in, d_in)))
    assert ec[2][0] and ej[2][0]
    np.testing.assert_allclose(ec[0], ej[0], rtol=2e-4)


def test_yarns_match_jax(tmp_path):
    path = _segments(tmp_path / 'w.yarn')
    for a, b in zip(jya.load_yarn(path), tya.load_yarn(path)):
        np.testing.assert_array_equal(a, b)
    seg_a, seg_b = tya.load_yarn(path)
    jy = jya.upload_yarns(seg_a, seg_b, 3, radius=0.4)
    ty = tya.upload_yarns(seg_a, seg_b, 3, radius=0.4, device='cpu')
    for f in dataclasses.fields(ty):
        a, b = getattr(jy, f.name), getattr(ty, f.name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    org, d = _rays(3000, 8, aim=(0.0, -16.0, 0.0), jitter=4.0)
    tmax = np.full(len(org), BIG_T)
    outs = []
    for a, b in zip(_np(jya.cylinder_sweep(jy, *_j(org, d, tmax), chunk=16)),
                    _np(tya.cylinder_sweep(ty, *_t(org, d, tmax), chunk=16))):
        np.testing.assert_array_equal(a, b)
        outs.append(a)
    assert (outs[1] >= 0).mean() > 0.05


def _query_scenes(tmp_path, mod_scn, mod_ps, dev_kw):
    """Disks, a clustered particle cloud and yarns, with transforms."""
    pts, col = _surface()
    cloud = _cloud(9000, 11, 8.0) + np.float32([0.0, -18.0, -8.0])
    objs = mod_scn.default_objects()
    objs.append(mod_scn.pointset_object({'points': pts, 'colors': col}))
    objs.append(mod_scn.pointset_object(
        mod_ps.fluid_pointset(cloud, radius=0.4, color=(0.3, 0.5, 0.9),
                              **dev_kw), transp=True, refr_index=1.33))
    objs.append(mod_scn.yarn_object(_segments(tmp_path / 'w.yarn'),
                                    kd=(0.8, 0.6, 0.2),
                                    translation=(0.0, 2.0, 4.0)))
    return objs


@pytest.fixture(scope='module')
def query_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp('q')
    jsc = jscn.build_scene(_query_scenes(d, jscn, jps, {}),
                           jscn.default_light_intensity())
    tsc = tscn.build_scene(_query_scenes(d, tscn, tps, {'device': 'cpu'}),
                           tscn.default_light_intensity(), device='cpu')
    return jsc, tsc


def test_scene_builds_and_converts(query_scene):
    """build_scene takes point sets (a dict, a PointSetArrays) and yarns
    as JAX does; scene_from_numpy carries JAX's across equal to the
    port's own build."""
    jsc, tsc = query_scene
    assert len(tsc.pointsets) == 2 and len(tsc.yarns) == 1
    assert [p.obj_row for p in tsc.pointsets] == [3, 4]
    assert tsc.pointsets[1].transparent and tsc.pointsets[1].n_clusters
    assert not tsc.pointsets[0].transparent
    assert tsc.ss_obj_ok.tolist() == [True] * 3 + [False] * 3
    conv = convert.scene_from_numpy(convert.numpy_fields(jsc), device='cpu')
    for own, other in ((tsc.pointsets, conv.pointsets),
                       (tsc.yarns, conv.yarns)):
        for a, b in zip(own, other):
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, torch.Tensor):
                    np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                                  err_msg=f.name)
                else:
                    assert x == y, f.name


def test_intersect_and_shadow_match_jax(query_scene):
    jsc, tsc = query_scene
    org, d = _rays(3000, 12, aim=(0.0, -16.0, 0.0), jitter=6.0)
    hj = jscn.intersect(jsc, *_j(org, d))
    ht = tscn.intersect(tsc, *_t(org, d))
    oj, ot = np.asarray(hj.obj_id), ht.obj_id.numpy()
    same = oj == ot
    assert same.mean() > 0.995
    assert all((ot == r).mean() > 0.02 for r in (3, 4, 5))
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    np.testing.assert_allclose(tt[same], tj[same], rtol=2e-4)
    tol = 1e-3 + 2e-4 * np.minimum(tt, 1e6)[same, None]
    for name in ('p', 'n', 'kd'):
        err = np.abs(getattr(ht, name).numpy()[same]
                     - np.asarray(getattr(hj, name))[same])
        assert (err <= tol).all(-1).mean() > 0.999, name
    for name in ('transp', 'refr_index', 'lkey'):
        np.testing.assert_array_equal(getattr(ht, name).numpy()[same],
                                      np.asarray(getattr(hj, name))[same])
    dist = np.random.default_rng(13).uniform(5, 60, len(org))
    bj = np.asarray(jscn.intersect_shadow(jsc, *_j(org, d, dist)))
    bt = tscn.intersect_shadow(tsc, *_t(org, d, dist)).numpy()
    assert (bj == bt).mean() > 0.995 and 0.05 < bt.mean() < 0.95


def test_pointset_clears_dome_emission():
    """The pinned divergence: with an env map, JAX's point-set merge keeps
    the dome's ke on lanes the point set wins; the port clears it."""
    env = np.full((8, 16, 3), 200.0, np.float32)
    pts = _cloud(300, 3, 4.0)

    def scene(mod_scn, mod_ps, **kw):
        objs = mod_scn.default_objects()[:2]
        objs.append(mod_scn.pointset_object(mod_ps.fluid_pointset(
            pts, radius=1.0, **kw)))
        return objs

    jsc = jscn.build_scene(scene(jscn, jps), 1.0, envmap=env)
    tsc = tscn.build_scene(scene(tscn, tps, device='cpu'), 1.0, envmap=env,
                           device='cpu')
    org = np.zeros((64, 3), np.float32) + np.float32([0, 0, 30])
    d = np.tile(np.float32([[0, 0, -1]]), (64, 1))
    d[:, :2] = np.random.default_rng(0).normal(0, 0.02, (64, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hj = jscn.intersect(jsc, *_j(org, d))
    ht = tscn.intersect(tsc, *_t(org, d))
    on = ht.obj_id.numpy() == 2
    np.testing.assert_array_equal(np.asarray(hj.obj_id) == 2, on)
    assert on.mean() > 0.5
    assert (np.asarray(hj.ke)[on] > 0).all()
    assert (ht.ke.numpy()[on] == 0).all()
    np.testing.assert_array_equal(ht.ke.numpy()[~on],
                                  np.asarray(hj.ke)[~on])


def _render_objs(kind, mod_scn, mod_ps, path, dev_kw):
    objs = mod_scn.default_objects()
    if kind == 'disks':
        pts, col = _surface(1500)
        objs.append(mod_scn.pointset_object({'points': pts, 'colors': col},
                                            ks=(0.2, 0.2, 0.2)))
    elif kind == 'yarns':
        objs.append(mod_scn.yarn_object(path, kd=(0.8, 0.6, 0.2)))
        objs.append(mod_scn.sphere((0.0, -17.0, -6.0), 6.0, kd=(0.5, 0.5,
                                                                0.5)))
    else:
        rng = np.random.default_rng(21)
        cloud = (rng.uniform(-7, 7, (9000, 3)) * np.float32([1.0, 0.6, 1.0])
                 + np.float32([0.0, -20.0, 0.0])).astype(np.float32)
        col = rng.uniform(0.2, 0.9, (9000, 3)).astype(np.float32)
        ps = mod_ps.fluid_pointset(cloud, radius=0.7, color=col, **dev_kw)
        objs.append(mod_scn.pointset_object(
            ps, transp=kind == 'transparent', refr_index=1.33))
    return objs


@pytest.mark.parametrize('kind', ['disks', 'yarns', 'fluid', 'transparent'])
def test_render_samples_match_jax(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(tps, 'SWEEP_LOG', [])
    path = _segments(tmp_path / 'w.yarn')
    jsc = jscn.build_scene(_render_objs(kind, jscn, jps, path, {}),
                           jscn.default_light_intensity())
    tsc = tscn.build_scene(
        _render_objs(kind, tscn, tps, path, {'device': 'cpu'}),
        tscn.default_light_intensity(), device='cpu')
    if kind in ('fluid', 'transparent'):
        assert tsc.pointsets[0].n_clusters
    cp = rng_host.random_per_pixel_fast(W, H)
    kw = dict(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    _, s_j = jrnd.render_unsplatted(jsc, jpt.make_camera(*CAM),
                                    jnp.asarray(cp), jrnd.RenderConfig(**kw))
    _, s_t = trnd.render_unsplatted(tsc, tpt.make_camera(*CAM),
                                    torch.as_tensor(cp),
                                    trnd.RenderConfig(**kw))
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    assert (s_j.max(-1) > 0).mean() > 0.2
    kinds = {e['kind'] for e in tps.SWEEP_LOG}
    assert kinds == {'fluid': {'entry'}, 'transparent': {'entry', 'union'}
                     }.get(kind, set())
    scale = max(np.abs(s_j).max(), 1e-6)
    rel = np.abs(s_t - s_j).max(-1) / scale
    flipped = rel > 1e-3
    print(f'{kind}: flipped {flipped.mean():.5f}, tight max '
          f'{rel[~flipped].max():.3g}, mean rel '
          f'{abs(s_t.mean() - s_j.mean()) / scale:.3g}')
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(s_t.mean() - s_j.mean()) / scale < 0.02


def test_renderer_tiles_point_scenes():
    """The Renderer orders a point-set or yarn scene's lanes in 32x32
    tiles, as JAX does (renderer.py:131), not row-major."""
    objs = tscn.default_objects()
    objs.append(tscn.pointset_object(tps.fluid_pointset(
        _cloud(200, 1, 4.0), device='cpu')))
    cfg = trnd.RenderConfig(width=64, height=48, nrays=1)
    r = tpt.Renderer(tscn.build_scene(objs, 1.0, device='cpu'),
                     tpt.make_camera(*CAM), cfg)
    row_major = trnd._pixel_order(64, 48, 0, torch.device('cpu'))
    tiled = trnd._pixel_order(64, 48, 32, torch.device('cpu'))
    assert not torch.equal(tiled[1], row_major[1])
    for a, b in zip(r._order[:2], tiled[:2]):
        assert torch.equal(a, b)
