"""PyTorch port on a CUDA card: the hand-written kernels (cluster sweeps,
tree cull, packet BVH, the sweep's cost probes and ablation) against
their plain PyTorch versions, and a small render and its gradients
through the kernels against the CPU plain path.

Imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips.  The kernels round every product
and sum on their own in the plain versions' order (the fp32 probe
product's FMAs each once, as sweep_micro.fma_rn states them, the same
bits on the card as on the CPU), so the sweeps and the
tree cull must agree with their plain versions exactly: same t, same tri,
same occlusion, the same per-unit sweep counters at each lane group
size, the same tree cull ids, counts, keys and per-packet counters.  The
packet kernel equals its own walk stated in torch (packet_walk_plain) bit
for bit, per-ray counters included; against the brute-force plain
version a ray grazing a leaf box may differ: tri equal on >= 99.9% of
lanes, the rest ties within 2^-16 relative t or at most 0.1% hit/miss
flips, t within 1e-5 relative where tri agrees.
The probes' fp32 product, epilogue, edge-matrix test (over its rep ranges)
and every ablation variant (at several lane group sizes and unit orders)
are bit-equal to their plain versions; the TF32 product agrees
with its TF32-rounded plain version within sweep_micro.TF32_TOL of the
absolute-value bound (the tensor core sums in its own order).
Materials: a small scene M (chip_smoke.material_objects: textured groups
through the atlas, an alpha cut-out mesh, an env map) renders on the
card like the CPU plain path, per sample with the reference render's
allowance, and its kd-texture gradient within 2% of the largest |grad|;
every closest-hit sweep of the cut-out rounds equals its plain version
bit for bit under the rising strict floor; atlas sampling on the card
equals the CPU bit for bit.
Media: a small scene O (chip_smoke.media_objects: config 5's fog and
subsurface material on a 79,600-triangle sphere, whose probes march) and
the ghost + background flagship render on the card like the CPU plain
path, per sample with the same allowance; every closest-hit sweep of a
reservoir march equals its plain version bit for bit under the rising
floor with the backface cull off, and the march's exit points agree with
the CPU's within 1e-5; the fog density and ksub gradients within 2% of the CPU route's.
Headless path: lenticular rays on the card within 1e-5 of the CPU's
(the same view bands); a render stopped by render_resumable after two
waves and resumed equals a straight render bit for bit, film, weights
and denoiser buffers, as two straight renders do; KPCN-lite on the card
within chip_smoke.KPCN_TOL of its CPU run.
Training: the sharded train step's loss and gradients on the card equal
the CPU's; a scene-axis render by two processes sharing the card over
gloo (tests/torch_dist_worker.py) equals the unsharded render.
Routed tier (upload_mesh(use_routed=True)): routed_hit through the
kernels equals the same call with the sweeps' plain versions on the card
bit for bit (t, tri, residual lanes), and after the bvh_hit_sparse net it
agrees with two_level_hit (chip_smoke.agree: tri on >= 99.9% of lanes, at
most 0.05% hit in one only, t within 1e-5 relative); its tree tier
launches the tree cull; a routed scene renders on the card like the CPU
plain path, per sample.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.core import rng_host
from pathtracer_tpu_torch.models import texture as ttex
from pathtracer_tpu_torch.ops import bvh as tb
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import packet_bvh as tp
from pathtracer_tpu_torch.ops import sweep_ablate as sa
from pathtracer_tpu_torch.ops import sweep_micro as sm
from pathtracer_tpu_torch.ops import traverse as tt
from pathtracer_tpu_torch.render import renderer as rnd
from pathtracer_tpu_torch.scene import scene as scn
from pathtracer_tpu_torch.scripts import ablate_sweep as ablate
from pathtracer_tpu_torch.scripts import prof_sweep
from pathtracer_tpu_torch.utils import procgen

BIG_T = float(np.float32(1e30))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _rays(n, seed):
    """Half camera-like coherent rays, half incoherent rays from outside."""
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(-0.35, 0.35, n // 2),
                  rng.uniform(-0.35, 0.35, n // 2), -np.ones(n // 2)], -1)
    o = np.tile([0.0, 0.0, 40.0], (n // 2, 1))
    p = rng.normal(size=(n // 2, 3))
    o2 = 14.0 * p / np.linalg.norm(p, axis=1, keepdims=True)
    d2 = rng.normal(size=(n // 2, 3))
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32)),
            torch.as_tensor(d.astype(np.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize('lat,tris_c', [(32, None), (200, tc.SUBT)])
def test_kernels_match_plain(cuda, lat, tris_c):
    md = procgen.sphere_mesh(lat, lat, radius=12.0, displace_amp=0.25)
    cm = tc.build_clustered(md.vertices[md.vtx_idx], tris_c=tris_c,
                            dev=cuda)
    o, d = (x.to(cuda) for x in _rays(8 * tc.BLOCK, seed=lat))
    n = o.shape[0]
    tmin = torch.full((n,), -1.0, device=cuda)
    tx = tc.root_exit_clamp(cm.bounds, o, d, torch.full((n,), BIG_T,
                                                        device=cuda))
    ids, counts, keys, _ = tc._cull(cm, o, d, tx)
    before = tc.cluster_sweep.launches
    t_k, tri_k = tc.cluster_sweep(cm, ids, counts, keys, o, d, tx, tmin)
    assert tc.cluster_sweep.launches == before + 1
    t_p, tri_p = tc.cluster_sweep_plain(cm, ids, counts, keys, o, d, tx,
                                        tmin)
    assert (tri_k >= 0).float().mean().item() > 0.2
    assert torch.equal(tri_k, tri_p)
    assert torch.equal(t_k, t_p)
    lim = torch.where(tx > 0, tx * 0.5, tx)
    occ_k = tc.cluster_sweep_any(cm, ids, counts, keys, o, d, lim, tmin)
    occ_p = tc.cluster_sweep_any_plain(cm, ids, counts, keys, o, d, lim,
                                       tmin)
    assert torch.equal(occ_k, occ_p)
    assert 0.0 < occ_k.float().mean().item() < 1.0


def _group_workload(dev):
    """Packets for the grouped sweeps on the 80k-tri sphere in 256-tri
    clusters: packet 0 all aimed at the sphere's centre (every lane
    occluded), then coherent and incoherent packets (some overflow);
    packet 1's count is set to exactly MAXC."""
    cm = tc.build_clustered(_sphere(200), tris_c=tc.SUBT, dev=dev)
    rng = np.random.default_rng(31)
    d0 = np.stack([rng.uniform(-0.05, 0.05, tc.BLOCK),
                   rng.uniform(-0.05, 0.05, tc.BLOCK),
                   -np.ones(tc.BLOCK)], -1)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    o0 = np.tile([0.0, 0.0, 40.0], (tc.BLOCK, 1))
    o, d = _rays(6 * tc.BLOCK, seed=32)
    o = torch.cat([torch.as_tensor(o0.astype(np.float32)), o]).to(dev)
    d = torch.cat([torch.as_tensor(d0.astype(np.float32)), d]).to(dev)
    n = o.shape[0]
    tmin = torch.full((n,), -1.0, device=dev)
    tx = tc.root_exit_clamp(cm.bounds, o, d, torch.full((n,), BIG_T,
                                                        device=dev))
    ids, counts, keys, _ = tc._cull_all(cm, o, d, tx, None)
    over = (counts[:, 0] > tc.MAXC).nonzero()[:, 0]
    assert over.numel() > 1
    counts[over[0]] = tc.MAXC                # every slot emitted, no overflow
    return cm, (ids, counts, keys, o, d, tx, tmin)


@pytest.mark.gpu
@pytest.mark.parametrize('group', sorted({tc.SWEEP_GROUP, tc.BLOCK}))
def test_grouped_sweeps_match_plain(cuda, group):
    """Both sweeps at the chosen lane group and at 512: outputs equal to
    the plain version's, and every unit's counters (slots visited,
    clusters entered, subtile slab tests, subtiles swept) too."""
    cm, args = _group_workload(cuda)
    ids, counts, keys, o, d, tx, tmin = args
    nu = ids.shape[0] * (tc.BLOCK // group)
    lim = torch.where(tx > 0, tx * 0.5, tx)
    lim[:tc.BLOCK] = tx[:tc.BLOCK]
    for kern, plain, lanes in (
            (tc.cluster_sweep, tc.cluster_sweep_plain, tx),
            (tc.cluster_sweep_any, tc.cluster_sweep_any_plain, lim)):
        st_k = torch.zeros((nu, tc.STATS), dtype=torch.int64, device=cuda)
        st_p = torch.zeros_like(st_k)
        before = kern.launches
        out_k = kern(cm, ids, counts, keys, o, d, lanes, tmin, group=group,
                     stats=st_k)
        assert kern.launches == before + 1
        out_p = plain(cm, ids, counts, keys, o, d, lanes, tmin, group=group,
                      stats=st_p)
        for a, b in zip(out_k if isinstance(out_k, tuple) else (out_k,),
                        out_p if isinstance(out_p, tuple) else (out_p,)):
            assert torch.equal(a, b)
        assert torch.equal(st_k[:, :4], st_p[:, :4])
        assert bool((st_k[:, 4] > 0).all())           # cycles
        assert int(st_k[:, 3].sum()) > 0
        if kern is tc.cluster_sweep_any:
            assert bool(out_k[:tc.BLOCK].all())       # packet 0 all occluded
            assert 0.0 < out_k.float().mean().item() < 1.0


@pytest.mark.gpu
def test_sweep_order_does_not_change_results(cuda):
    """Heaviest first and packet order give the same outputs."""
    cm, (ids, counts, keys, o, d, tx, tmin) = _group_workload(cuda)
    g = tc.SWEEP_GROUP
    nu = ids.shape[0] * (tc.BLOCK // g)
    order = tc.heaviest_first(counts, g)
    assert sorted(order.tolist()) == list(range(nu))
    ident = torch.arange(nu, dtype=torch.int32, device=cuda)
    a = tc.cluster_sweep(cm, ids, counts, keys, o, d, tx, tmin)
    b = tc.cluster_sweep(cm, ids, counts, keys, o, d, tx, tmin, order=ident)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_one_launch_per_round_matches_chunked(cuda, monkeypatch):
    """two_level_hit / two_level_any over a query that spans several cull
    chunks sweep each round in one launch and give the chunk-by-chunk
    results (each chunk queried alone)."""
    monkeypatch.setattr(tc, 'CHUNK_PACKETS', 2)
    cm = tc.build_clustered(_sphere(200), tris_c=tc.SUBT, dev=cuda)
    o, d = (x.to(cuda) for x in _rays(7 * tc.BLOCK, seed=33))
    n = o.shape[0]
    tmax = torch.full((n,), BIG_T, device=cuda)
    lim = torch.as_tensor(np.random.default_rng(34).uniform(2.0, 40.0, n)
                          .astype(np.float32), device=cuda)
    before = tc.cluster_sweep.launches
    t, tri = tc.two_level_hit(cm, o, d, tmax)
    rounds = tc.cluster_sweep.launches - before
    occ = tc.two_level_any(cm, o, d, lim)
    step = tc.CHUNK_PACKETS * tc.BLOCK
    parts, part_rounds = [], []
    for i in range(0, n, step):
        before = tc.cluster_sweep.launches
        parts.append(tc.two_level_hit(cm, o[i:i + step], d[i:i + step],
                                      tmax[i:i + step]))
        part_rounds.append(tc.cluster_sweep.launches - before)
    # one launch per round: the query's rounds are its slowest chunk's
    assert len(parts) == 4 and rounds == max(part_rounds)
    assert torch.equal(t, torch.cat([p[0] for p in parts]))
    assert torch.equal(tri, torch.cat([p[1] for p in parts]))
    occ_parts = [tc.two_level_any(cm, o[i:i + step], d[i:i + step],
                                  lim[i:i + step]) for i in range(0, n, step)]
    assert torch.equal(occ, torch.cat(occ_parts))


@pytest.mark.gpu
def test_sweep_wrappers_refuse_bad_arguments(cuda):
    cm, (ids, counts, keys, o, d, tx, tmin) = _group_workload(cuda)
    bad = torch.zeros((3, tc.STATS), dtype=torch.int64, device=cuda)
    before = tc.cluster_sweep.launches
    with pytest.raises(ValueError):
        tc.cluster_sweep(cm, ids, counts, keys, o, d, tx, tmin, stats=bad)
    with pytest.raises(ValueError):
        tc.cluster_sweep(cm, ids, counts, keys, o, d, tx, tmin, group=48)
    nu = ids.shape[0] * (tc.BLOCK // tc.SWEEP_GROUP)
    with pytest.raises(ValueError):
        tc.cluster_sweep(cm, ids, counts, keys, o, d, tx, tmin,
                         order=torch.full((nu,), nu, dtype=torch.int32,
                                          device=cuda))
    assert tc.cluster_sweep.launches == before


@pytest.mark.gpu
def test_windowed_queries_match_cpu_plain_path(cuda):
    """two_level_hit / two_level_any through the kernels, including the
    overflow windows that incoherent rays force, equal the CPU plain path
    (the culls are the same torch code on both devices)."""
    md = procgen.sphere_mesh(200, 200, radius=12.0, displace_amp=0.25)
    tri = md.vertices[md.vtx_idx]
    rng = np.random.default_rng(3)
    p = rng.normal(size=(tc.BLOCK + 100, 3))
    o = torch.as_tensor((14.0 * p / np.linalg.norm(p, axis=1,
                                                   keepdims=True))
                        .astype(np.float32))
    d = rng.normal(size=o.shape)
    d = torch.as_tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                        .astype(np.float32))
    tmax = torch.full((o.shape[0],), BIG_T)
    limit = torch.as_tensor(rng.uniform(2.0, 40.0, o.shape[0])
                            .astype(np.float32))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        cm = tc.build_clustered(tri, tris_c=tc.SUBT, dev=dev)
        args = (o.to(dev), d.to(dev))
        if dev.type == 'cuda':
            n = tc.BLOCK
            counts = tc._cull(cm, args[0][:n], args[1][:n],
                              tmax[:n].to(dev))[1]
            assert (counts > tc.MAXC).any()       # windows are exercised
        out[dev.type] = [x.cpu() for x in tc.two_level_hit(
            cm, *args, tmax.to(dev))] + [
            tc.two_level_any(cm, *args, limit.to(dev)).cpu()]
    for a, b in zip(out['cuda'], out['cpu']):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_render_matches_cpu_plain_path(cuda):
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    cfg = rnd.RenderConfig(width=32, height=24, nrays=2, nb_bounces=3,
                           compact_rays=True)
    cp = torch.as_tensor(np.random.default_rng(1).random((32 * 24, 2))
                         .astype(np.float32))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        sc = scn.build_scene(objs, scn.default_light_intensity(), device=dev)
        cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
        out[dev.type] = rnd.render_unsplatted(sc, cam, cp.to(dev),
                                              cfg)[1].cpu().numpy()
    scale = max(np.abs(out['cpu']).max(), 1e-6)
    rel = np.abs(out['cuda'] - out['cpu']).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(out['cuda'].mean() - out['cpu'].mean()) / scale < 0.02


def _mesh_grads(dev, **kw):
    """Gradients of the mean 64x48 image (2 spp, 3 bounces, compaction) of
    the 2k mesh scene with respect to the mesh's g_kd and light_intensity,
    on `dev`."""
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    sc = scn.build_scene(objs, scn.default_light_intensity(), device=dev)
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(64, 48), device=dev)
    g_kd = sc.meshes[0].g_kd.clone().requires_grad_()
    li = sc.light_intensity.clone().requires_grad_()
    sc = sc.replace(meshes=(sc.meshes[0].replace(g_kd=g_kd),),
                    light_intensity=li)
    cfg = rnd.RenderConfig(width=64, height=48, nrays=2, nb_bounces=3,
                           compact_rays=True, **kw)
    loss = rnd.render_unsplatted(sc, cam, cp, cfg)[0].mean()
    return [g.cpu().numpy() for g in torch.autograd.grad(loss, [g_kd, li])]


@pytest.mark.gpu
def test_mesh_gradients_match_cpu_plain_path(cuda):
    """Autograd through the kernels on the card against the CPU plain
    route: within 2%, the reference render's allowance."""
    card, cpu = _mesh_grads(cuda), _mesh_grads('cpu')
    for a, b in zip(card, cpu):
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=0.02)


@pytest.mark.gpu
def test_remat_gradients_agree_on_the_card(cuda):
    """remat_samples recomputes each sample in backward; on the card the
    backward's atomic adds are not bit-stable, so 1e-5 relative."""
    a, b = _mesh_grads(cuda), _mesh_grads(cuda, remat_samples=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-5)


def _sphere(lat):
    md = procgen.sphere_mesh(lat, lat, radius=12.0, displace_amp=0.25)
    return md.vertices[md.vtx_idx]


@pytest.mark.gpu
@pytest.mark.parametrize('with_tmin', [False, True])
def test_packet_hit_matches_plain(cuda, with_tmin):
    tri = _sphere(32)
    fb = tb.build_bvh(tri)
    packed = tp.pack_bvh(fb, device=cuda)
    soup = tt.make_soup(tri[fb.order], device=cuda)
    o, d = (x.to(cuda) for x in _rays(8 * tc.BLOCK, seed=11))
    n = o.shape[0]
    tmax = torch.full((n,), BIG_T, device=cuda)
    tmin = None
    if with_tmin:
        # exclude each lane's first hit, with a margin past it
        tmin = tp.packet_hit_plain(soup, o, d, tmax)[0]
        tmin = torch.where(tmin < BIG_T, tmin + 1e-3, torch.zeros_like(tmin))
    before = tp.packet_hit.launches
    t_k, tri_k, al_k, be_k = tp.packet_hit(packed, soup, o, d, tmax, tmin)
    assert tp.packet_hit.launches == before + 1
    t_p, tri_p, al_p, be_p = tp.packet_hit_plain(soup, o, d, tmax, tmin)
    assert (tri_p >= 0).float().mean().item() > 0.1
    same = tri_k == tri_p
    assert same.float().mean().item() >= 0.999
    flips = ((tri_k < 0) != (tri_p < 0)) & ~same
    assert flips.sum().item() <= max(1, n // 1000)
    tie = ~same & ~flips
    assert bool(((t_k[tie] - t_p[tie]).abs()
                 <= 2.0 ** -16 * t_p[tie].abs()).all())
    h = same & (tri_p >= 0)
    assert bool(((t_k[h] - t_p[h]).abs() <= 1e-5 * t_p[h].abs()).all())
    assert bool(((al_k[h] - al_p[h]).abs() <= 1e-5).all())
    assert bool(((be_k[h] - be_p[h]).abs() <= 1e-5).all())


def _bounce_like(dev, n, seed):
    """Rays leaving points of the 2k sphere's surface (radius about 12)
    in cosine-weighted directions about the outward normal, from a seeded
    torch.Generator."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    nrm = torch.randn((n, 3), generator=g, device=dev)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    u = torch.rand((n, 2), generator=g, device=dev)
    r, phi = u[:, 0].sqrt(), 2.0 * np.pi * u[:, 1]
    ax = torch.where((nrm[:, 0].abs() > 0.9)[:, None],
                     torch.tensor([0.0, 1.0, 0.0], device=dev),
                     torch.tensor([1.0, 0.0, 0.0], device=dev))
    t1 = torch.linalg.cross(ax, nrm)
    t1 = t1 / t1.norm(dim=1, keepdim=True)
    t2 = torch.linalg.cross(nrm, t1)
    d = (r * phi.cos())[:, None] * t1 + (r * phi.sin())[:, None] * t2 \
        + (1.0 - u[:, 0]).sqrt()[:, None] * nrm
    o = (11.9 + 0.4 * torch.rand((n, 1), generator=g, device=dev)) * nrm
    return o.contiguous(), (d / d.norm(dim=1, keepdim=True)).contiguous()


def _in_plane_rays(tri, fb, n, dev):
    """Rays in the plane of a leaf box's face (that direction component
    exactly 0, the origin on the face), each aimed at a vertex on the face
    from 30 units away, on every other lane (the rest _rays'), so that a
    warp mixes rays with and without an infinite 1/d."""
    pk = tp.pack_bvh(fb, device='cpu')
    box, na, nb = pk.box.numpy(), pk.na.numpy(), pk.nb.numpy()
    verts = tri[fb.order].astype(np.float32)
    rng = np.random.default_rng(17)
    o, d = [], []
    for node in np.flatnonzero(pk.nleaf.numpy()):
        for v in verts[na[node]:na[node] + nb[node]].reshape(-1, 3):
            for k in np.flatnonzero((v == box[node, :3])
                                    | (v == box[node, 3:])):
                a = rng.uniform(0.0, 2.0 * np.pi)
                dv = np.zeros(3, np.float32)
                dv[(k + 1) % 3], dv[(k + 2) % 3] = np.cos(a), np.sin(a)
                o.append(v - np.float32(30.0) * dv)
                d.append(dv)
    o, d = np.array(o, np.float32), np.array(d, np.float32)
    idx = np.arange(n // 2) % len(o)
    o2, d2 = (x.numpy() for x in _rays(n - n // 2 + 1, seed=18))
    oo, dd = np.empty((n, 3), np.float32), np.empty((n, 3), np.float32)
    oo[0::2], dd[0::2] = o2[:n - n // 2], d2[:n - n // 2]
    oo[1::2], dd[1::2] = o[idx], d[idx]
    return (torch.as_tensor(oo, device=dev), torch.as_tensor(dd, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize('rays', ['random', 'bounce', 'one-leaf',
                                  'big-tree', 'in-plane'])
def test_packet_hit_equals_its_walk(cuda, rays):
    """The packet kernel equals packet_walk_plain bit for bit: t, tri,
    alpha, beta and both per-ray counters, with tmin and bounded lanes;
    also on a tree whose root is a leaf, on one of 7,812 triangles
    (2,453 records, 157 KB, near the tier's 8,000-triangle limit), and on
    rays in the plane of leaf box faces (the slab's in-plane rule)."""
    tri = _sphere(63 if rays == 'big-tree' else 32)
    if rays == 'one-leaf':
        tri = tri[:3]
    fb = tb.build_bvh(tri)
    packed = tp.pack_bvh(fb, device=cuda)
    assert (packed.pairs.shape[0] == 0) == (rays == 'one-leaf')
    if rays == 'big-tree':
        assert packed.pairs.shape[0] * 64 > 128 * 1024
    soup = tt.make_soup(tri[fb.order], device=cuda)
    n = 8 * tc.BLOCK + 77                          # a ragged last warp
    if rays == 'bounce':
        o, d = _bounce_like(cuda, n, seed=14)
    elif rays == 'in-plane':
        o, d = _in_plane_rays(tri, fb, n, cuda)
    else:
        o, d = (x.to(cuda) for x in _rays(n + 1, seed=13))
        o, d = o[:n].contiguous(), d[:n].contiguous()
    if rays == 'one-leaf':
        # aim at random points of the three triangles
        w = torch.as_tensor(np.random.default_rng(16).dirichlet(
            np.ones(3), n).astype(np.float32), device=cuda)
        corners = torch.as_tensor(tri, device=cuda)[torch.arange(n) % 3]
        d = (w[:, :, None] * corners).sum(1) - o
        d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    rng = np.random.default_rng(15)
    tmax = torch.as_tensor(np.where(rng.uniform(size=n) < 0.2, 30.0, BIG_T)
                           .astype(np.float32), device=cuda)
    tmin = torch.as_tensor(rng.uniform(-1.0, 0.5, n).astype(np.float32),
                           device=cuda)
    work = torch.zeros((n, tp.WORK), dtype=torch.int32, device=cuda)
    before = tp.packet_hit.launches
    out_k = tp.packet_hit(packed, soup, o, d, tmax, tmin, work=work)
    assert tp.packet_hit.launches == before + 1
    out_w = tp.packet_walk_plain(packed, soup, o, d, tmax, tmin)
    for a, b in zip(out_k + (work[:, :2],), out_w):
        assert torch.equal(a, b)
    assert (out_k[1] >= 0).float().mean().item() > 0.02    # non-vacuous
    assert bool((work[:, 2] > 0).all())                    # cycles


def _assert_cull_match(out_k, out_p):
    """Equal ids (the 128 smallest (key, cluster id) pairs, sorted so),
    counts and keys."""
    for a, b in zip(out_k, out_p):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize('lat,tris_c', [(200, tc.SUBT), (12, 2 * tc.SUBT)],
                         ids=['80k', 'one-cluster'])
def test_cull_tree_matches_plain(cuda, lat, tris_c):
    """Kernel against plain version, counters included, on coherent and
    incoherent packets (some overflow) and on a one-cluster tree (the
    root is a leaf)."""
    cm = tc.build_clustered(_sphere(lat), tris_c=tris_c, dev=cuda)
    assert (cm.n_clusters == 1) == (lat == 12)
    o, d = (x.to(cuda) for x in _rays(8 * tc.BLOCK, seed=12))
    tmax = torch.full((o.shape[0],), BIG_T, device=cuda)
    tmax[::97] = -1.0                                   # dead lanes
    nb = o.shape[0] // tc.BLOCK
    work_k = torch.zeros((nb, tc.CULL_WORK), dtype=torch.int64, device=cuda)
    work_p = torch.zeros_like(work_k)
    before = tc.cull_tree.launches
    out_k = tc.cull_tree(cm, o, d, tmax, work=work_k)
    assert tc.cull_tree.launches == before + 1
    out_p = tc.cull_tree_plain(cm, o, d, tmax, work=work_p)
    if cm.n_clusters > tc.MAXC:
        assert (out_p[1] > tc.MAXC).any()              # overflow exercised
    assert (out_p[1] > 0).any()
    _assert_cull_match(out_k, out_p)
    assert torch.equal(work_k[:, :3], work_p[:, :3])
    assert bool((work_k[:, 3] > 0).all())              # cycles


@pytest.mark.gpu
def test_tree_tier_matches_cpu_plain_path(cuda, monkeypatch):
    """two_level_hit on the tree tier through the kernels (cull and sweep,
    refine round) equals the CPU plain path, residual mask included."""
    tri = _sphere(200)
    o, d = _rays(4 * tc.BLOCK, seed=13)
    tmax = torch.full((o.shape[0],), BIG_T)
    out = {}
    for dev in (cuda, torch.device('cpu')):
        cm = tc.build_clustered(tri, tris_c=tc.SUBT, dev=dev)
        monkeypatch.setattr(tc, 'DENSE_CULL_MAX', cm.n_clusters - 1)
        out[dev.type] = [x.cpu() for x in tc.two_level_hit(
            cm, o.to(dev), d.to(dev), tmax.to(dev), return_residual=True)]
    for a, b in zip(out['cuda'], out['cpu']):
        assert torch.equal(a, b)


# ---- the sweep's cost probes (ops/sweep_micro.py, ops/sweep_ablate.py) ----

def _probe_inputs(cuda, m, n, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=cuda)

    return t(m, 8), t(8, n)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize('route', ['fp32', 'tf32'])
@pytest.mark.parametrize('out_cols', [64, 128])
def test_dot_matches_plain(cuda, route, out_cols):
    """fp32: bit-equal; tf32: within TF32_TOL of the absolute-value bound,
    and measurably off the fp32 result (the operands were rounded)."""
    x, w = _probe_inputs(cuda, 64, 128, seed=21)
    kern = sm.dot_fp32 if route == 'fp32' else sm.dot_tf32
    before = kern.launches
    out_k, pairs_k = kern(x, w, 8, 1e-3, out_cols)
    assert kern.launches == before + 1
    out_p, pairs_p = sm.dot_plain(x, w, 8, 1e-3, out_cols,
                                  tf32=route == 'tf32')
    if route == 'fp32':
        assert _same_bits(out_k, out_p) and _same_bits(pairs_k, pairs_p)
        return
    bound = sm.dot_plain(x.abs(), w.abs(), 8, 1e-3, 128)[0]
    assert bool(((out_k - out_p).abs()
                 <= sm.TF32_TOL * bound[:, :out_cols]).all())
    full = sm.dot_plain(x, w, 8, 1e-3, 128)
    assert bool(((pairs_k - pairs_p).abs()
                 <= sm.TF32_TOL * (bound[:, 0::2] + bound[:, 1::2])).all())
    assert float((out_k - full[0][:, :out_cols]).abs().max()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize('m,n,reps,eps,cols,scale', [
    (1024, 1536, 256, 1e-9, 128, 1.0), (1024, 768, 64, 1e-7, 768, 1.0),
    (16, 64, 1, 1e-3, 64, 1.0), (16, 64, 0, 1e-3, 60, 1.0),
    (208, 576, 1, 1e-3, 570, 1.0), (64, 128, 5, 2.0 ** -80, 128, 2.0 ** -66)])
def test_dot_fp32_matches_plain(cuda, m, n, reps, eps, cols, scale):
    """The FMA-chain kernel bit-equal to dot_plain (out and pairs, signed
    zeros included): at both scripts' shapes, the smallest M and N of the
    contract (M % 16 == 0, N % 64 == 0), 0 and 1 reps, out_cols not a
    multiple of 4, and operands scaled so that the results are subnormal."""
    x, w = _probe_inputs(cuda, m, n, seed=28)
    x, w = x * scale, w * scale
    before = sm.dot_fp32.launches
    out_k = sm.dot_fp32(x, w, reps, eps, cols)
    assert sm.dot_fp32.launches == before + 1
    out_p = sm.dot_plain(x, w, reps, eps, cols)
    assert _same_bits(out_k[0], out_p[0]) and _same_bits(out_k[1], out_p[1])
    if scale < 1.0:
        tiny = (out_p[0] != 0) & (out_p[0].abs() < 2.0 ** -126)
        assert tiny.float().mean().item() > 0.5
    if reps == 0:
        assert not out_k[0].any() and not out_k[1].any()


@pytest.mark.gpu
def test_fma_rn_card_equals_cpu(cuda):
    """fma_rn gives the same bits on the card as on the CPU on
    prof_sweep.fma_cases (double-rounding cases, cancelling, subnormal,
    signed zeros, overflow), and the fp32 kernel's FMA equals it."""
    a, b, c = prof_sweep.fma_cases(n_random=1024)
    want = sm.fma_rn(a, b, c)
    assert _same_bits(sm.fma_rn(a.to(cuda), b.to(cuda), c.to(cuda)).cpu(),
                      want)
    x, w = prof_sweep.fma_dot_inputs(*(v[:64].to(cuda) for v in (a, b, c)))
    out_k = sm.dot_fp32(x, w, 1, -1.0, 64)
    assert _same_bits(out_k[0], sm.dot_plain(x, w, 1, -1.0, 64)[0])
    assert _same_bits(out_k[0].diagonal().cpu(), want[:64] + 0.0)
    tail = slice(a.numel() - 64, a.numel())        # subnormal, zeros, inf
    x, w = prof_sweep.fma_dot_inputs(*(v[tail].to(cuda) for v in (a, b, c)))
    assert _same_bits(sm.dot_fp32(x, w, 1, -1.0, 64)[0].diagonal().cpu(),
                      want[tail] + 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize('m,n,reps,eps,tile,cols', [
    (64, 128, 8, 1e-3, 64, 128), (1024, 1536, 256, 1e-9, 96, 128),
    (1024, 768, 64, 1e-7, 96, 768), (208, 576, 9, 1e-3, 64, 570),
    (208, 576, 5, 1e-3, 96, 576), (208, 576, 7, 1e-3, 64, 576)])
def test_dot_tf32_matches_plain_at_every_tile(cuda, m, n, reps, eps, tile,
                                              cols):
    """The wgmma product within TF32_TOL of the absolute-value bound at
    every tile width: the wrapper's own choice at (64, 128) and at the two
    scripts' shapes, and each width asked for where M = 208 leaves a
    partial 64-row tile, with rep counts that leave partial groups of reps
    and with out_cols not a multiple of 4."""
    if m != 208:
        assert sm.dot_tile(n) == tile
    x, w = _probe_inputs(cuda, m, n, seed=26)
    before = sm.dot_tf32.launches
    out_k, pairs_k = sm.dot_tf32(x, w, reps, eps, cols,
                                 tile if m == 208 else None)
    assert sm.dot_tf32.launches == before + 1
    out_p, pairs_p = sm.dot_plain(x, w, reps, eps, cols, tf32=True)
    bound = sm.dot_plain(x.abs(), w.abs(), reps, eps, n)[0]
    assert bool(((out_k - out_p).abs()
                 <= sm.TF32_TOL * bound[:, :cols]).all())
    assert bool(((pairs_k - pairs_p).abs()
                 <= sm.TF32_TOL * (bound[:, 0::2] + bound[:, 1::2])).all())


@pytest.mark.gpu
@pytest.mark.parametrize('m,reps', [(97, 1), (97, 7), (97, 256), (1024, 7)])
def test_epilogue_matches_plain(cuda, m, reps):
    """One thread per ray x triangle, the threads' bests combined by the
    exact key: bit-equal to the plain version."""
    rng = np.random.default_rng(27 + reps)
    p = torch.as_tensor(rng.standard_normal((m, 6 * sm.SUBT))
                        .astype(np.float32), device=cuda)
    tn = torch.as_tensor(np.abs(rng.standard_normal((1, m)))
                         .astype(np.float32) * 0.1, device=cuda)
    before = sm.epilogue.launches
    out_k = sm.epilogue(p, tn, reps, 1e-3)
    assert sm.epilogue.launches == before + 1
    out_p = sm.epilogue_plain(p, tn, reps, 1e-3)
    assert (out_p[0] < BIG_T).float().mean().item() > 0.3
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize('m,reps', [(8, 3), (97, 7), (1024, 7)])
def test_epilogue_keeps_the_first_signed_zero(cuda, m, reps):
    """tn < 0 and t = -0.0 and +0.0 accepted, in one rep and in two: the
    kernel, the plain version on the card and on the CPU give the same
    bits, the first pair in (rep, tri) order with its own sign."""
    p, tn = prof_sweep.signed_zero_inputs(cuda, m, reps, 1e-3)
    out_k = sm.epilogue(p, tn, reps, 1e-3)
    out_p = sm.epilogue_plain(p, tn, reps, 1e-3)
    out_c = sm.epilogue_plain(p.cpu(), tn.cpu(), reps, 1e-3)
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
    assert torch.equal(out_p.cpu().view(torch.int32), out_c.view(torch.int32))
    first = [min(pairs, key=lambda q: (q[1], q[0]))
             for pairs in prof_sweep.SIGNED_ZERO_PAIRS]
    for r in range(m):
        tri, _, sign = first[r % 4]
        assert float(out_k[0, r]) == 0.0
        assert bool(torch.signbit(out_k[0, r])) == (sign < 0)
        assert int(out_k[1, r]) == tri


@pytest.mark.gpu
def test_epilogue_and_edgemat_match_plain(cuda):
    rng = np.random.default_rng(22)
    m = 96

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=cuda)

    p, tn = t(m, 6 * sm.SUBT), t(1, m).abs() * 0.1
    before = sm.epilogue.launches
    out_k = sm.epilogue(p, tn, 16, 1e-3)
    assert sm.epilogue.launches == before + 1
    out_p = sm.epilogue_plain(p, tn, 16, 1e-3)
    assert (out_p[0] < BIG_T).float().mean().item() > 0.5
    assert torch.equal(out_k, out_p)
    o, d, tr = t(3, m), t(3, m), t(12, sm.SUBT)
    before = sm.edgemat.launches
    e_k = sm.edgemat(o, d, tr, 16, 1e-3)
    assert sm.edgemat.launches == before + 1
    e_p = sm.edgemat_plain(o, d, tr, 16, 1e-3)
    assert (e_p < BIG_T).float().mean().item() > 0.2
    assert torch.equal(e_k, e_p)


@pytest.fixture(scope='module')
def terrain_workload():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return ablate.workload(torch.device('cuda'), g=80, packets=8,
                           log=lambda *a: None)


@pytest.mark.gpu
@pytest.mark.parametrize('variant', sa.VARIANTS)
def test_ablate_matches_plain(terrain_workload, variant):
    w = terrain_workload
    before = sa.sweep_ablate.launches
    out_k = sa.sweep_ablate(*w.args(), variant)
    assert sa.sweep_ablate.launches == before + 1
    out_p = sa.sweep_ablate_plain(*w.args(), variant)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    if variant == 'full':
        assert (out_k[1] >= 0).float().mean().item() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize('m,reps', [(97, 1), (97, 7), (97, 256),
                                    (1024, 7)])
def test_edgemat_matches_plain_over_rep_ranges(cuda, m, reps):
    """The kernel cuts the reps into ranges over blocks (one range when
    reps = 1) and combines the ranges' minima exactly."""
    rng = np.random.default_rng(24 + reps)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=cuda)

    o, d, tr = t(3, m), t(3, m), t(12, sm.SUBT)
    before = sm.edgemat.launches
    e_k = sm.edgemat(o, d, tr, reps, 1e-3)
    assert sm.edgemat.launches == before + 1
    e_p = sm.edgemat_plain(o, d, tr, reps, 1e-3)
    assert (e_p < BIG_T).float().mean().item() > 0.2
    assert torch.equal(e_k.view(torch.int32), e_p.view(torch.int32))


@pytest.fixture(scope='module')
def probe_packets():
    """Three packets of every 1350th camera ray over the probe's terrain
    at G = 40 in 256-triangle clusters, so that a packet sees more than
    SLOTS clusters; packet 1's count is set to 0."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    cm = tc.build_clustered(ablate.terrain(40), tris_c=tc.SUBT, dev=dev)
    n = 3 * tc.BLOCK
    o, d = (torch.as_tensor(np.ascontiguousarray(x[::1350][:n]), device=dev)
            for x in ablate.camera_rays(ablate.H * ablate.W))
    tmax = torch.full((n,), BIG_T, device=dev)
    ids, count, _ = tc.cluster_cull(cm, o, d, tmax)
    assert int(count.max()) > sa.SLOTS
    count[1] = 0
    return cm, ids, count, o, d, tmax, torch.full((n,), -1.0, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize('variant', sa.VARIANTS)
def test_ablate_matches_plain_in_any_order(probe_packets, variant):
    """Every variant equals its plain version under heaviest first and a
    shuffled order, at SWEEP_GROUP and at 32 and 512, with a packet of
    count 0 and packets of more than SLOTS slots; the counters' subtiles
    swept equal the plain version's."""
    args = probe_packets
    out_p = sa.sweep_ablate_plain(*args, variant)
    rng = np.random.default_rng(25)
    for g in sorted({tc.SWEEP_GROUP, 32, tc.BLOCK}):
        nu = args[1].shape[0] * (tc.BLOCK // g)
        shuffled = torch.as_tensor(rng.permutation(nu).astype(np.int32),
                                   device=args[3].device)
        for order in (None, shuffled):
            st_k = torch.zeros((nu, sa.STATS), dtype=torch.int64,
                               device=args[3].device)
            st_p = torch.zeros_like(st_k)
            out_k = sa.sweep_ablate(*args, variant, group=g, order=order,
                                    stats=st_k)
            sa.sweep_ablate_plain(*args, variant, group=g, stats=st_p)
            for a, b in zip(out_k, out_p):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(st_k[:, 0], st_p[:, 0])
            assert bool((st_k[:, 1] > 0).all())


@pytest.mark.gpu
def test_probe_wrappers_refuse_mixed_devices(cuda):
    """A CUDA launch whose inputs are not all on the card raises; it does
    not fall back to the plain version."""
    x, w = _probe_inputs(cuda, 64, 128, seed=23)
    counts = (sm.dot_fp32.launches, sm.dot_tf32.launches,
              sm.epilogue.launches, sm.edgemat.launches)
    with pytest.raises(ValueError):
        sm.dot_fp32(x, w.cpu(), 2, 1e-3, 64)
    with pytest.raises(ValueError):
        sm.dot_tf32(x, w.cpu(), 2, 1e-3, 64)
    with pytest.raises(ValueError):
        sm.epilogue(torch.zeros((64, 6 * sm.SUBT), device=cuda),
                    torch.zeros((1, 64)), 2, 1e-3)
    with pytest.raises(ValueError):
        sm.edgemat(x[:, :3].T.contiguous(), torch.zeros((3, 64)),
                   torch.zeros((12, sm.SUBT), device=cuda), 2, 1e-3)
    assert counts == (sm.dot_fp32.launches, sm.dot_tf32.launches,
                      sm.epilogue.launches, sm.edgemat.launches)


def _material_scene(dev):
    """Scene M's recipe at a small size (1,104-triangle cut-out mesh)."""
    return chip_smoke.material_scene(dev, lat=60, cut_lat=24, tex=64,
                                     env=(32, 64))


def _material_samples(dev, leaf=None):
    sc = _material_scene(dev)
    if leaf is not None:
        atl = list(sc.meshes[0].atlases)
        atl[0] = atl[0].replace(img=leaf(atl[0].img))
        sc = sc.replace(meshes=(sc.meshes[0].replace(atlases=tuple(atl)),)
                        + sc.meshes[1:])
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(32, 24), device=dev)
    cfg = rnd.RenderConfig(width=32, height=24, nrays=2, nb_bounces=3,
                           compact_rays=True)
    return rnd.render_unsplatted(sc, cam, cp, cfg)


@pytest.mark.gpu
def test_material_scene_matches_cpu_plain_path(cuda):
    out = {d.type: _material_samples(d)[1].cpu().numpy()
           for d in (cuda, torch.device('cpu'))}
    assert np.isfinite(out['cuda']).all() and out['cpu'].max() > 0
    scale = max(np.abs(out['cpu']).max(), 1e-6)
    rel = np.abs(out['cuda'] - out['cpu']).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(out['cuda'].mean() - out['cpu'].mean()) / scale < 0.02


@pytest.mark.gpu
def test_cutout_round_sweeps_match_plain(cuda):
    """Every closest-hit sweep of the cut-out rounds equals
    cluster_sweep_plain on the card (chip_smoke.cutout_sweep_check), and
    the rounds' hits equal the CPU plain path's."""
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = rnd.RenderConfig(width=64, height=48, nrays=1)
    pix_i, pix_j, _ = rnd._pixel_order(64, 48, 32, 'cpu')
    _, org, dirn, _, _, _ = rnd._camera_paths(
        cam, cfg, pix_i, pix_j, 0, torch.zeros((64 * 48, 2)))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        res = chip_smoke.cutout_sweep_check(
            _material_scene(dev), cam.to(dev), dev,
            rays=(org.to(dev), dirn.to(dev)))
        assert res['floor_lanes'] > 0 and res['hit_at_floor_again'] > 0
        out[dev.type] = res
    assert out['cuda']['rounds'] == out['cpu']['rounds']
    assert torch.equal(out['cuda']['tri'].cpu(), out['cpu']['tri'])
    assert torch.equal(out['cuda']['t'].cpu(), out['cpu']['t'])


@pytest.mark.gpu
@pytest.mark.parametrize('bilinear', [False, True], ids=['point', 'bilinear'])
def test_atlas_sampling_card_equals_cpu(cuda, bilinear):
    rng = np.random.default_rng(5)
    imgs = [rng.random((64, 64, 3), dtype=np.float32), None,
            rng.random((17, 40, 3), dtype=np.float32)]
    n = 1 << 16
    u = torch.as_tensor(rng.uniform(-3, 3, n).astype(np.float32))
    v = torch.as_tensor(rng.uniform(-3, 3, n).astype(np.float32))
    grp = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32))
    out = []
    for dev in (cuda, torch.device('cpu')):
        at = ttex.build_atlas(imgs, device=dev)
        out.append([x.cpu() for x in ttex.sample_atlas(
            at, grp.to(dev), u.to(dev), v.to(dev), bilinear)])
    assert torch.equal(out[0][0].view(torch.int32),
                       out[1][0].view(torch.int32))
    assert torch.equal(out[0][1], out[1][1])


def _texel_grad(dev):
    leaf = {}

    def make(img):
        leaf['x'] = img.clone().requires_grad_()
        return leaf['x']

    mean, _ = _material_samples(dev, leaf=make)
    return torch.autograd.grad(mean.mean(), [leaf['x']])[0].cpu().numpy()


@pytest.mark.gpu
def test_texel_gradient_matches_cpu_plain_path(cuda):
    """The gradient of the mean image with respect to the kd atlas (every
    group's kd map): on the card within 2% of the largest |grad| of the
    CPU route's."""
    card, cpu = _texel_grad(cuda), _texel_grad('cpu')
    assert np.isfinite(card).all() and np.count_nonzero(cpu) > 10
    assert np.abs(card - cpu).max() <= 0.02 * np.abs(cpu).max()


def _media_samples(dev, leaves=None):
    """A small scene O at 32x24, 2 spp, 3 bounces, compaction; with
    `leaves` (fog_density, g_ksub) replaced."""
    sc = chip_smoke.media_scene(dev, lat=200, env=(32, 64))
    if leaves is not None:
        sc = sc.replace(fog_density=leaves['fog_density'], meshes=(
            sc.meshes[0].replace(g_ksub=leaves['g_ksub']),))
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(32, 24), device=dev)
    cfg = rnd.RenderConfig(width=32, height=24, nrays=2, nb_bounces=3,
                           compact_rays=True)
    return rnd.render_unsplatted(sc, cam, cp, cfg)


def _ghost_samples(dev):
    sc = chip_smoke.flagship_scene(
        dev, ghost=True, background=chip_smoke.background_photo(24, 32))
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(dev)
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(32, 24), device=dev)
    cfg = rnd.RenderConfig(width=32, height=24, nrays=2, nb_bounces=3,
                           compact_rays=True)
    return rnd.render_unsplatted(sc, cam, cp, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', ['scene_o', 'ghost_background'])
def test_media_scene_matches_cpu_plain_path(cuda, scene):
    render = _media_samples if scene == 'scene_o' else _ghost_samples
    out = {d.type: render(d)[1].cpu().numpy()
           for d in (cuda, torch.device('cpu'))}
    assert np.isfinite(out['cuda']).all() and out['cpu'].max() > 0
    scale = max(np.abs(out['cpu']).max(), 1e-6)
    rel = np.abs(out['cuda'] - out['cpu']).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(out['cuda'].mean() - out['cpu'].mean()) / scale < 0.02


@pytest.mark.gpu
def test_march_sweeps_match_plain(cuda):
    """Every closest-hit sweep of one reservoir march equals
    cluster_sweep_plain on the card (chip_smoke.march_sweep_check), and
    the march's rounds and found exits equal the CPU plain path's, the
    exit points within 1e-5."""
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        res = chip_smoke.march_sweep_check(
            chip_smoke.media_scene(dev, lat=200, env=(32, 64)), cam.to(dev),
            dev, size=(64, 48))
        assert res['floor_lanes'] > 0 and res['exits_found'] > 0
        out[dev.type] = res
    assert out['cuda']['lanes_per_round'] == out['cpu']['lanes_per_round']
    ok = out['cpu']['exit_ok']
    assert torch.equal(out['cuda']['exit_ok'].cpu(), ok)
    # the exit points come from the sweeps' hits through torch arithmetic,
    # which the card rounds in its own order
    torch.testing.assert_close(out['cuda']['exit_p'].cpu()[ok],
                               out['cpu']['exit_p'][ok], rtol=1e-5,
                               atol=1e-5)


def _media_grads(dev):
    base = chip_smoke.media_scene(dev, lat=200, env=(32, 64))
    leaves = {'fog_density': base.fog_density.clone().requires_grad_(),
              'g_ksub': base.meshes[0].g_ksub.clone().requires_grad_()}
    mean, _ = _media_samples(dev, leaves)
    return [g.cpu().numpy() for g in torch.autograd.grad(
        mean.mean(), list(leaves.values()))]


@pytest.mark.gpu
def test_fog_and_ksub_gradients_match_cpu_plain_path(cuda):
    """The gradients of the mean image with respect to the fog density and
    the mesh's g_ksub: on the card within 2% of the CPU route's."""
    for card, cpu in zip(_media_grads(cuda), _media_grads('cpu')):
        assert np.isfinite(card).all() and np.abs(cpu).max() > 0
        assert np.abs(card - cpu).max() <= 0.02 * np.abs(cpu).max()


@pytest.mark.gpu
def test_lenticular_rays_match_cpu(cuda):
    """The lenticular branch of generate_rays on the card against the CPU:
    the same view bands (integer arithmetic), rays within 1e-5 (tan and
    the divides round on each device)."""
    from pathtracer_tpu_torch.core import camera as tcam
    w, h = 1920, 8
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0),
                         is_lenticular=True)
    ii, jj = torch.meshgrid(torch.arange(h), torch.arange(-16, w),
                            indexing='ij')
    rng = np.random.default_rng(5)
    jit = [torch.as_tensor(rng.uniform(-0.5, 0.5, ii.numel())
                           .astype(np.float32)) for _ in range(4)]
    out = {}
    for dev in (cuda, torch.device('cpu')):
        out[dev.type] = [x.cpu() for x in tcam.generate_rays(
            cam.to(dev), ii.reshape(-1).to(dev), jj.reshape(-1).to(dev),
            *(x.to(dev) for x in jit), w, h, init_t=0.5)]
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(out['cuda'][1], out['cpu'][1], rtol=0,
                               atol=1e-6)


@pytest.mark.gpu
def test_resume_bit_equal_on_card(cuda, tmp_path):
    """The 2k mesh scene at 64x48, 4 samples one a wave, compaction,
    denoiser feed, through the sweeps: render_resumable stopped after two
    waves and resumed equals a straight render bit for bit (film, splat
    weights, aux buffers), as does a second straight render."""
    md = procgen.sphere_mesh(32, 32, radius=12.0, displace_amp=0.25)
    objs = scn.default_objects()
    objs.append(scn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    sc = scn.build_scene(objs, scn.default_light_intensity(), device=cuda)
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = rnd.RenderConfig(width=64, height=48, nrays=4, samples_per_wave=1,
                           nb_bounces=3, compact_rays=True,
                           has_denoiser=True)
    before = tc.cluster_sweep.launches
    straight = [pt.Renderer(sc, cam, cfg).render() for _ in range(2)]
    assert tc.cluster_sweep.launches > before
    path = str(tmp_path / 'ck.npz')
    r = pt.Renderer(sc, cam, cfg)
    r.render_resumable(path, guard=chip_smoke.AfterSamples(r, 2))
    assert r.samples_done == 2
    r2 = pt.Renderer(sc, cam, cfg).render_resumable(path)
    assert r2.samples_done == 4
    for other in (straight[1], r2):
        assert torch.equal(other.image, straight[0].image)
        assert torch.equal(other.sample_count, straight[0].sample_count)
        assert all(torch.equal(a, b) for a, b in zip(other.aux,
                                                     straight[0].aux))


@pytest.mark.gpu
def test_kpcn_matches_cpu(cuda):
    """KPCN-lite with the shipped weights on the card against the CPU,
    within chip_smoke.KPCN_TOL of the largest output (cuDNN sums the
    convolutions in its own order; TF32 stays off)."""
    from pathtracer_tpu_torch.render import denoise_net as dnn
    rng = np.random.default_rng(6)
    c, a, n = (torch.as_tensor(rng.random((48, 64, 3)).astype(np.float32)
                               * s) for s in (50.0, 1.0, 1.0))
    out = {}
    for dev in (cuda, torch.device('cpu')):
        out[dev.type] = dnn.denoise_learned(c.to(dev), a.to(dev),
                                            n.to(dev)).cpu()
    tol = chip_smoke.KPCN_TOL * float(out['cpu'].abs().max())
    torch.testing.assert_close(out['cuda'], out['cpu'], rtol=0, atol=tol)
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.gpu
def test_clustered_particle_sweeps_match_brute(cuda):
    """The particle tier on the card: clustered_sphere_sweep and
    clustered_union_exit against the brute sweeps on the card
    (chip_smoke.hold_particles: index and t equal on >= 99.9% of lanes,
    the rest ties within 2^-16 relative t; the union walk held to the
    brute walk after 12 passes, what a rerouted lane gets, and after 40,
    the slot walk's fixed point), with enough overflowed packets that the
    reroute runs; and against the CPU within 1e-6 relative t."""
    from pathtracer_tpu_torch.scene import pointset as tps
    rng = np.random.default_rng(3)
    u = rng.normal(size=(60000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * (8.0 * rng.uniform(0, 1, (60000, 1)) ** (1 / 3))).astype(
        np.float32)
    out = {}
    for dev in (cuda, torch.device('cpu')):
        ps = tps.fluid_pointset(pts, radius=0.3, device=dev)
        org, d = _rays(4096, 8)
        org, d = (torch.as_tensor(x, device=dev) for x in (org, d))
        big = torch.full((org.shape[0],), BIG_T, device=dev)
        tps.SWEEP_LOG = []
        try:
            t_c, i_c = tps.clustered_sphere_sweep(ps, org, d, big)
            inside = (t_c < BIG_T).nonzero()[:, 0][:512]
            o_in = org[inside] + (t_c[inside] + 0.05)[:, None] * d[inside]
            d_in = d[inside].contiguous()
            e_c, x_c, n_c = tps.clustered_union_exit(ps, o_in, d_in)
            log = tps.SWEEP_LOG
        finally:
            tps.SWEEP_LOG = None
        out[dev.type] = (t_c, i_c, e_c, x_c)
        if dev.type != 'cuda':
            continue
        assert sum(e['residual'] for e in log) > 0
        t_b, i_b = tps.sphere_sweep(ps, org, d, big)
        chip_smoke.hold_particles(t_c, i_c, t_b, i_b, 'entry')
        walks = [tps.sphere_union_exit(ps, o_in, d_in, iters=k)
                 for k in (12, 40)]
        assert all(torch.equal(n_c, w[2]) for w in walks)
        chip_smoke.hold_particles(e_c, x_c, *zip(*(w[:2] for w in walks)),
                                  what='union exit')
        assert float((t_c < BIG_T).float().mean()) > 0.1
    for a, b in zip(out['cuda'], out['cpu']):
        a = a.cpu()
        if a.dtype == torch.int32:
            assert float((a == b).float().mean()) >= 0.999
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_fluid_substep_matches_cpu(cuda):
    """The gallery fluid (24^3, seeded from a checker sphere through the
    sweeps) for one frame of two substeps on the card against the CPU from
    the same state: particles within chip_smoke.FLUID_CPU_TOL of the
    extent, cell types on >= 99.9% of cells (only the CG's reductions sum
    in another order)."""
    from pathtracer_tpu_torch.sim import fluid as fl
    cfg, st, _ = chip_smoke.gallery_fluid(cuda)
    fc = fl.run(cfg, st, 1)
    fh = fl.run(cfg, fl.FluidState(*(x.cpu() for x in st)), 1)
    ext = max(h - lo for lo, h in zip(cfg.lo, cfg.hi))
    assert np.abs(fc[1][-1] - fh[1][-1]).max() <= chip_smoke.FLUID_CPU_TOL \
        * ext
    assert float((fc[0].celltypes.cpu() == fh[0].celltypes).float().mean()) \
        >= 0.999
    assert fc[1][-1][:, 1].mean() < fc[1][0][:, 1].mean()


@pytest.mark.gpu
@pytest.mark.parametrize('scene', ['disks', 'yarns', 'fluid', 'transparent'])
def test_point_scenes_match_cpu_plain_path(cuda, scene, tmp_path):
    """A disk cloud (normals estimated from an XYZ file), yarns from a
    .yarn file, and a clustered fluid, opaque and transparent, at 64x48 on
    the card against the CPU plain path, per sample with the reference
    render's allowance (chip_smoke.card_vs_cpu)."""
    rng = np.random.default_rng(4)
    pts = (rng.uniform(-7, 7, (9000, 3)) * np.float32([1.0, 0.6, 1.0])
           + np.float32([0.0, -20.0, 0.0])).astype(np.float32)
    cols = rng.uniform(0.2, 0.9, (9000, 3)).astype(np.float32)
    scenes = chip_smoke.small_point_scenes(cuda, str(tmp_path), pts, cols)
    assert chip_smoke.card_vs_cpu(scenes[scene], scene) < 0.05


@pytest.mark.gpu
def test_train_step_grads_match_cpu(cuda):
    """parallel.sharding's loss and gradients (world 1) at 64x48 on the
    card, through the sweep kernels, against the CPU plain path: a finite
    loss within 1e-5 relative, each gradient within 5e-4 of its leaf's
    largest |grad| (tests/test_torch_grad.py's rule)."""
    import torch_dist_worker as wk
    from pathtracer_tpu_torch.parallel import sharding
    cfg = rnd.RenderConfig(width=64, height=48, nrays=2, nb_bounces=2)
    cp = rng_host.random_per_pixel_fast(64, 48)
    target = np.random.default_rng(5).uniform(0, 1, (48, 64, 3)).astype(
        np.float32)
    out = {}
    for dev in ('cuda', 'cpu'):
        sc = wk.cluster_scene(device=dev)
        params = {k: getattr(sc, k) for k in ('kd', 'ks', 'light_intensity')}
        tc.cluster_sweep.launches = 0
        loss, grads = sharding.make_loss_and_grads(
            sharding.make_mesh(n_devices=1, dp=1), cfg)(
            params, sc, pt.make_camera(*wk.CAM),
            torch.as_tensor(cp, device=dev),
            torch.as_tensor(target, device=dev))
        out[dev] = (float(loss), {k: g.cpu().numpy() for k, g in
                                  grads.items()})
        if dev == 'cuda':
            assert tc.cluster_sweep.launches > 0
    (lc, gc), (lh, gh) = out['cuda'], out['cpu']
    assert np.isfinite(lc) and abs(lc - lh) <= 1e-5 * lh
    assert np.abs(gh['kd']).max() > 0
    for k, g in gh.items():
        assert np.abs(gc[k] - g).max() <= 5e-4 * max(np.abs(g).max(), 1e-30)


@pytest.mark.gpu
def test_scene_axis_render_on_card(cuda, tmp_path):
    """Two processes share the card over gloo, each with one partition of
    a 7,200-triangle sphere (dp=1 x scene=2), and render 160x90 through
    the sweep kernels: counts equal the unsharded render's, the image
    within rtol = atol = 1e-5."""
    import torch_dist_worker as wk
    from pathtracer_tpu_torch.parallel import sharding
    ranks = wk.spawn('gpu_scene', 2, str(tmp_path))
    w, h = wk.GPU_SIZE
    cfg = rnd.RenderConfig(width=w, height=h, nrays=1, nb_bounces=2)
    with torch.no_grad():
        img, cnt = sharding.make_sharded_render(
            sharding.make_mesh(n_devices=1, dp=1), cfg)(
            wk.cluster_scene(wk.GPU_LAT, device='cuda'),
            pt.make_camera(*wk.CAM),
            torch.as_tensor(rng_host.random_per_pixel_fast(w, h),
                            device='cuda'))
    assert float(img.sum()) > 0
    for r in ranks:
        np.testing.assert_array_equal(r['count'], cnt.cpu().numpy())
        np.testing.assert_allclose(r['image'], img.cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)


def _routed_mesh(dev, lat=200):
    from pathtracer_tpu_torch.scene import mesh as mesh_mod
    md = procgen.sphere_mesh(lat, lat, radius=14.0, displace_amp=0.25)
    return mesh_mod.upload_mesh(md, obj_row=3, use_routed=True, dev=dev)


@pytest.mark.gpu
def test_routed_hits_match_plain_and_two_level(cuda):
    """The 1080p primaries of a 79,600-tri sphere and one bounce of them:
    chip_smoke.routed_hits holds the kernels to the plain sweeps and the
    result to two_level_hit; the card's hits agree with the CPU's."""
    from pathtracer_tpu_torch.ops import routed_cluster as rc
    mesh = _routed_mesh(cuda)
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(cuda)
    org, dirn = chip_smoke.primary_rays(cam, cuda)
    org = org - torch.tensor([0.0, -15.0, 0.0], device=cuda)
    rep, (t, tri) = chip_smoke.routed_hits(mesh, org, dirn, 'primaries')
    assert rep['sweep_launches'] >= 2 and rep['hit_share'] > 0.1
    b_org, b_dir = chip_smoke.bounce_rays(org, dirn, t, tri, mesh.soup, 5)
    chip_smoke.routed_hits(mesh, b_org, b_dir, 'bounce')
    sub = slice(0, 16 * tc.BLOCK)
    cpu = mesh.to('cpu')
    out = {}
    for m, d in ((mesh, cuda), (cpu, torch.device('cpu'))):
        o, di = org[sub].to(d), dirn[sub].to(d)
        out[d.type] = rc.routed_hit(m.clustered, o, di,
                                    torch.full((o.shape[0],), BIG_T,
                                               device=d))
    chip_smoke.check_hits(out['cpu'][0], out['cpu'][1],
                          out['cuda'][0].cpu(), out['cuda'][1].cpu())


@pytest.mark.gpu
def test_routed_tree_tier_launches_cull(cuda, monkeypatch):
    """chip_smoke.routed_tree on a 179,400-tri sphere with DENSE_CULL_MAX
    lowered below its 256-triangle clusters: the tree cull launches and
    the routed hits agree with the tree tier's two_level_hit."""
    monkeypatch.setattr(tc, 'DENSE_CULL_MAX', 256)
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0)).to(cuda)
    rep = chip_smoke.routed_tree(cuda, cam, lat=300)
    assert rep['launches']['cull_tree'] > 0 and rep['clusters'] > 256


@pytest.mark.gpu
def test_routed_scene_matches_cpu_plain_path(cuda):
    """A routed 79,600-tri sphere on the default slate at 64x48: through the
    kernels on the card against the plain versions on the CPU, per sample
    (chip_smoke.card_vs_cpu)."""
    objs = scn.default_objects()
    objs.append(scn.mesh_object(procgen.sphere_mesh(
        200, 200, radius=14.0, displace_amp=0.25),
        translation=(0.0, -15.0, 0.0)))
    sc = scn.build_scene(objs, scn.default_light_intensity(), device=cuda)
    rsc = chip_smoke.routed_scene(sc, cuda, lat=200)
    assert rsc.meshes[0].use_routed and rsc.meshes[0].soup is not None
    assert chip_smoke.card_vs_cpu(rsc, 'routed') < 0.05
