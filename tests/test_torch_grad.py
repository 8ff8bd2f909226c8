"""PyTorch port, gradients: autograd through `render_unsplatted` against
`jax.grad` of the JAX package on the same scenes, and on the torch side
alone against finite differences.

The estimator is the JAX package's detached-sampling one: the sampled
indirect direction and its pdf are constants, hit queries are constants,
and the same PCG streams drive every evaluation, so the Monte Carlo noise
is shared and central differences are accurate.  Tolerances:
  * analytic scene of tests/test_gradients.py (16x12, 2 spp, 3 bounces),
    leaves kd, ks, ne, light_intensity: the largest difference from
    jax.grad at most 5e-4 of the leaf's largest |grad| (measured <= 1.9e-4;
    without the detached direction ks and ne differ by 1.2e-3 and 4.2e-3);
  * the 2k-triangle cluster-tier mesh scene of tests/test_torch_render.py
    (32x24, 2 spp), leaves g_kd and light_intensity: within 1e-5 relative
    of jax.grad, with compaction off and on (JAX's own jax.grad fails with
    compaction on, so both are held to its compaction-off gradient, which
    compaction, being exact, does not change);
  * finite differences: the steps and tolerances of tests/test_gradients.py;
  * remat_samples on and off: bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.core import camera as tcam
from pathtracer_tpu_torch.io import obj as tobj
from pathtracer_tpu_torch.ops import bvh as tbvh
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import packet_bvh as tpb
from pathtracer_tpu_torch.ops import traverse as ttr
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import scene as tscn

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)
from test_torch_render import _mesh_data

CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))
RADIANCE = 196964.7          # the loss of tests/test_gradients.py
ANALYTIC = ('kd', 'ks', 'ne', 'light_intensity')
MESH = ('g_kd', 'light_intensity')


def _leaf(sc, name):
    """A scene leaf; g_* names are mesh 0's per-group materials."""
    return getattr(sc.meshes[0] if name.startswith('g_') else sc, name)


def _with_leaves(sc, leaves):
    """sc with the named leaves replaced (either package's scene)."""
    kw = {k: v for k, v in leaves.items() if not k.startswith('g_')}
    mesh_kw = {k: v for k, v in leaves.items() if k.startswith('g_')}
    if mesh_kw:
        kw['meshes'] = (sc.meshes[0].replace(**mesh_kw),) + tuple(
            sc.meshes[1:])
    return sc.replace(**kw)


def _cfg(mod, w, h, **kw):
    return mod.RenderConfig(width=w, height=h, nrays=2, nb_bounces=3, **kw)


def _jax_grads(sc, w, h, names):
    """jax.grad of the scaled mean image over all `names` in one call."""
    cp = jnp.asarray(rng_host.random_per_pixel_fast(w, h))
    cfg = _cfg(jrnd, w, h)

    def loss(leaves):
        img, _ = jrnd.render_unsplatted(_with_leaves(sc, leaves),
                                        jpt.make_camera(*CAM), cp, cfg)
        return jnp.mean(img) / RADIANCE

    g = jax.grad(loss)({n: _leaf(sc, n) for n in names})
    return {n: np.asarray(v) for n, v in g.items()}


def _torch_loss(sc, w, h, leaves, **kw):
    cp = torch.as_tensor(rng_host.random_per_pixel_fast(w, h))
    img, _ = trnd.render_unsplatted(_with_leaves(sc, leaves),
                                    tpt.make_camera(*CAM), cp,
                                    _cfg(trnd, w, h, **kw))
    return img.mean() / RADIANCE


def _torch_grads(sc, w, h, names, **kw):
    leaves = {n: _leaf(sc, n).detach().clone().requires_grad_()
              for n in names}
    loss = _torch_loss(sc, w, h, leaves, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {n: g.numpy() for n, g in zip(names, grads)}


@pytest.fixture(scope='module')
def analytic():
    """tests/test_gradients.py's scene in both packages, and jax.grad."""
    objs = jscn.default_objects()
    objs.append(jscn.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2),
                            ks=(0.15, 0.15, 0.15), ne=(25.0, 25.0, 25.0)))
    sc = jscn.build_scene(objs, jscn.default_light_intensity())
    return dict(tsc=convert.scene_from_numpy(convert.numpy_fields(sc),
                                             device='cpu'),
                jgrad=_jax_grads(sc, 16, 12, ANALYTIC), w=16, h=12)


@pytest.fixture(scope='module')
def mesh():
    """The 2k-triangle cluster-tier mesh scene in both packages, and
    jax.grad (compaction off)."""
    md = _mesh_data()
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -15.0, 0.0)))
    sc = jscn.build_scene(objs, jscn.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=sc.meshes[0].obj_row, use_cluster=True)
    sc = sc.replace(meshes=(m,))
    return dict(jsc=sc,
                tsc=convert.scene_from_numpy(convert.numpy_fields(sc),
                                             device='cpu'),
                jgrad=_jax_grads(sc, 32, 24, MESH), w=32, h=24)


def test_analytic_grads_match_jax(analytic):
    a = analytic
    got = _torch_grads(a['tsc'], a['w'], a['h'], ANALYTIC)
    for name in ANALYTIC:
        want = a['jgrad'][name]
        scale = np.abs(want).max()
        assert scale > 0, name
        err = np.abs(got[name] - want).max() / scale
        assert err <= 5e-4, f'{name}: {err:.3g} of its largest |grad|'


@pytest.mark.parametrize('compact', [False, True], ids=['flat', 'compact'])
def test_mesh_grads_match_jax(mesh, compact):
    got = _torch_grads(mesh['tsc'], mesh['w'], mesh['h'], MESH,
                       compact_rays=compact)
    for name in MESH:
        want = mesh['jgrad'][name]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got[name], want, rtol=1e-5, err_msg=name)


def test_jax_grad_refuses_compaction(mesh):
    """The reference's fault the port does not share: jax.grad through
    the JAX renderer with compact_rays=True reaches the Pallas sweep's
    JVP rule, which raises (ROADMAP Queue 3)."""
    sc = mesh['jsc']
    cp = jnp.asarray(rng_host.random_per_pixel_fast(8, 4))
    cfg = jrnd.RenderConfig(width=8, height=4, nrays=1, nb_bounces=2,
                            compact_rays=True)

    def loss(li):
        img, _ = jrnd.render_unsplatted(sc.replace(light_intensity=li),
                                        jpt.make_camera(*CAM), cp, cfg)
        return jnp.mean(img)

    with pytest.raises(NotImplementedError):
        jax.grad(loss)(sc.light_intensity)


# finite differences on the torch side alone: tests/test_gradients.py's
# leaf, step, tolerance and entries
FD_CASES = [('analytic', 'kd', 1e-3, 2e-2, ((3, 0), (3, 2), (2, 1))),
            ('analytic', 'ks', 1e-3, 5e-2, ((3, 0),)),
            ('analytic', 'ne', 1e-2, 5e-2, ((3, 1),)),
            ('analytic', 'light_intensity', 1e-3, 1e-2, ((),)),
            ('mesh', 'g_kd', 1e-3, 5e-2, ((0, 0), (0, 2))),
            ('mesh', 'light_intensity', 1e-3, 1e-2, ((),))]


def _fd_check(sc, w, h, name, eps, rtol, indices, **kw):
    base = _leaf(sc, name)
    grad = _torch_grads(sc, w, h, (name,), **kw)[name]
    assert np.isfinite(grad).all(), name
    if base.dim() == 0:
        assert grad > 0, name
    for idx in indices:
        step = eps * max(abs(float(base[idx])), 1.0)
        delta = torch.zeros_like(base)
        delta[idx] = step
        with torch.no_grad():
            lp = float(_torch_loss(sc, w, h, {name: base + delta}, **kw))
            lm = float(_torch_loss(sc, w, h, {name: base - delta}, **kw))
        fd = (lp - lm) / (2 * step)
        assert np.isclose(fd, grad[idx], rtol=rtol, atol=1e-12), (
            f'{name}{idx}: fd={fd:.6g} autograd={grad[idx]:.6g}')


@pytest.mark.parametrize('scene,name,eps,rtol,indices', FD_CASES,
                         ids=[f'{c[0]}-{c[1]}' for c in FD_CASES])
def test_grads_match_finite_differences(request, scene, name, eps, rtol,
                                        indices):
    s = request.getfixturevalue(scene)
    _fd_check(s['tsc'], s['w'], s['h'], name, eps, rtol, indices,
              compact_rays=scene == 'mesh')


def _one_triangle():
    """tests/test_gradients.py's triangle, from arrays (the port has no
    OBJ loader yet): the MeshData the JAX loader gives for its OBJ."""
    return tobj.MeshData(
        vertices=np.array([[-8, -12, 0], [8, -12, 0], [0, -4, 0]],
                          np.float32),
        normals=np.array([[0, 0, 1]], np.float32),
        uvs=np.zeros((0, 2), np.float32),
        vtx_idx=np.array([[0, 1, 2]], np.int32),
        uv_idx=np.full((1, 3), -1, np.int32),
        n_idx=np.zeros((1, 3), np.int32),
        group=np.zeros(1, np.int32),
        show_edges=np.ones((1, 3), bool),
        vertex_colors=None,
        materials=[tobj.GroupMaterial()],
        group_names={'Default': 0})


def test_grad_mesh_group_kd(analytic, tmp_path):
    """Gradients reach per-group mesh materials: the port's own
    build_scene of the one-triangle mesh, against jax.grad of the JAX
    package's scene loaded from the same triangle's OBJ, and against a
    central difference."""
    (tmp_path / 'tri.obj').write_text(
        'v -8 -12 0\nv 8 -12 0\nv 0 -4 0\nf 1 2 3\n')
    jmd = jpt.load_mesh(str(tmp_path / 'tri.obj'), preserve_input=True)
    tmd = _one_triangle()
    for f in ('vertices', 'normals', 'vtx_idx', 'n_idx', 'group'):
        np.testing.assert_array_equal(getattr(tmd, f), getattr(jmd, f))
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(jmd))
    jsc = jscn.build_scene(objs, jscn.default_light_intensity())
    objs = tscn.default_objects()
    objs.append(tscn.mesh_object(tmd))
    tsc = tscn.build_scene(objs, tscn.default_light_intensity(),
                           device='cpu')
    w, h = analytic['w'], analytic['h']
    want = _jax_grads(jsc, w, h, ('g_kd',))['g_kd']
    assert want[0, 0] > 0
    _fd_check(tsc, w, h, 'g_kd', 1e-3, 5e-2, ((0, 0),))
    got = _torch_grads(tsc, w, h, ('g_kd',))['g_kd']
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize('scene', ['analytic', 'mesh'])
def test_remat_grads_bit_equal(request, scene):
    """remat_samples recomputes each sample in backward from its streams:
    the same gradient bit for bit (compaction on, whose prefix length must
    come out the same in the recompute)."""
    s = request.getfixturevalue(scene)
    names = ANALYTIC if scene == 'analytic' else MESH
    a = _torch_grads(s['tsc'], s['w'], s['h'], names, compact_rays=True)
    b = _torch_grads(s['tsc'], s['w'], s['h'], names, compact_rays=True,
                     remat_samples=True)
    for name in names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _spy(monkeypatch, module, name, seen):
    """Wrap module.name so that each call records whether any tensor
    argument requires grad."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        seen.setdefault(name, []).append(any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in (*args, *kw.values())))
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


def _packet_tier(tsc):
    """The mesh scene with its mesh on the packet tier (on the CPU its
    wrapper takes packet_hit's plain version)."""
    md = _mesh_data()
    m = tsc.meshes[0]
    fb = tbvh.build_bvh(md.vertices[md.vtx_idx])
    m = dataclasses.replace(m, use_cluster=False, use_packet=True,
                            packed=tpb.pack_bvh(fb, device='cpu'))
    return tsc.replace(meshes=(m,))


@pytest.mark.parametrize('tier', ['cluster', 'packet', 'tree'])
def test_no_gradient_reaches_a_hit_query(mesh, monkeypatch, tier):
    """With g_kd and light_intensity requiring grad, no kernel wrapper
    (cluster_sweep, cluster_sweep_any, cull_tree, packet_hit) is given a
    tensor that requires grad, on the CPU route; backward runs."""
    seen = {}
    for name in ('cluster_sweep', 'cluster_sweep_any', 'cull_tree'):
        _spy(monkeypatch, tc, name, seen)
    _spy(monkeypatch, tpb, 'packet_hit', seen)
    leaves = {n: _leaf(mesh['tsc'], n).detach().clone().requires_grad_()
              for n in MESH}
    if tier == 'tree':
        # the tree tier serves closest hits only (no shadow query), so one
        # intersect of the camera's rays, differentiated through shading
        monkeypatch.setattr(tc, 'DENSE_CULL_MAX', 1)
        sc = _with_leaves(mesh['tsc'], leaves)
        cam = tpt.make_camera(*CAM)
        pix = torch.arange(16 * 12)
        org, dirn = tcam.generate_rays(
            cam, pix // 16, pix % 16, torch.zeros(192), torch.zeros(192),
            torch.zeros(192), torch.zeros(192), 16, 12)
        hit = tscn.intersect(sc, org, dirn)
        loss = (hit.kd * sc.light_power).sum()
        want = ('cull_tree', 'cluster_sweep')
    else:
        sc = mesh['tsc'] if tier == 'cluster' else _packet_tier(mesh['tsc'])
        loss = _torch_loss(sc, 16, 12, leaves, compact_rays=True)
        want = (('cluster_sweep', 'cluster_sweep_any') if tier == 'cluster'
                else ('packet_hit',))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert all(bool(g.abs().sum() > 0) for g in grads)
    for name in want:
        assert seen.get(name), f'{name} never called on the {tier} tier'
    assert not any(any(v) for v in seen.values()), seen


@pytest.mark.parametrize('query', ['cluster_sweep', 'cluster_sweep_any',
                                   'cull_tree', 'packet_hit'])
def test_hit_query_refuses_a_ray_that_requires_grad(query):
    """A ray that carries a gradient into a hit query raises on the CPU
    route as on the card, naming the missing detach."""
    n = tc.BLOCK
    org = torch.zeros((n, 3), requires_grad=True)
    dirn = torch.ones((n, 3)) / 3.0 ** 0.5
    tmax = torch.full((n,), 1e30)
    md = procgen.sphere_mesh(8, 8, radius=5.0)
    tri = md.vertices[md.vtx_idx]
    with pytest.raises(ValueError, match='detach'):
        if query == 'packet_hit':
            fb = tbvh.build_bvh(tri)
            tpb.packet_hit(tpb.pack_bvh(fb, device='cpu'),
                           ttr.make_soup(tri[fb.order], device='cpu'),
                           org, dirn, tmax)
        else:
            cm = tc.build_clustered(tri, dev='cpu')
            if query == 'cull_tree':
                tc.cull_tree(cm, org, dirn, tmax)
            else:
                ids = torch.zeros((1, tc.MAXC), dtype=torch.int32)
                counts = torch.ones((1, 1), dtype=torch.int32)
                keys = torch.zeros((1, tc.MAXC))
                getattr(tc, query)(cm, ids, counts, keys, org, dirn, tmax,
                                   torch.full((n,), -1.0))


def test_render_unsplatted_gates_an_inside_camera():
    """The camera backface gate at every render_unsplatted call (as the
    port's Renderer does; JAX applies it in Renderer.__init__ only).  With
    the camera inside a closed mesh the port's image equals JAX's
    render_unsplatted of the gated scene, per sample with the flip
    allowance of tests/test_torch_render.py, and JAX's ungated image,
    which looks through the mesh's culled back faces, differs."""
    # 8,064 triangles in 23 clusters: narrow enough normal bounds that the
    # cull drops the far wall's clusters for rays from inside
    md = procgen.sphere_mesh(64, 64, radius=20.0)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, 0.0, 45.0)))
    sc = jscn.build_scene(objs, jscn.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=sc.meshes[0].obj_row, use_cluster=True)
    sc = sc.replace(meshes=(m,))
    assert m.backface_cull
    w, h = 16, 12
    cp = rng_host.random_per_pixel_fast(w, h)
    cam = jpt.make_camera(*CAM)
    gated = jscn.camera_backface_gate(sc, cam.position)
    assert not gated.meshes[0].backface_cull

    def jax_samples(s):
        return np.asarray(jrnd.render_unsplatted(
            s, cam, jnp.asarray(cp), _cfg(jrnd, w, h))[1])

    s_gated, s_raw = jax_samples(gated), jax_samples(sc)
    tsc = convert.scene_from_numpy(convert.numpy_fields(sc), device='cpu')
    assert tsc.meshes[0].backface_cull
    s_t = trnd.render_unsplatted(tsc, tpt.make_camera(*CAM),
                                 torch.as_tensor(cp),
                                 _cfg(trnd, w, h))[1].numpy()
    scale = max(np.abs(s_gated).max(), 1e-6)
    rel = np.abs(s_t - s_gated).max(-1) / scale
    flipped = rel > 1e-3
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(s_t.mean() - s_gated.mean()) / scale < 0.02
    apart = np.abs(s_raw - s_gated).max(-1) / scale > 1e-3
    assert apart.mean() > 0.3, apart.mean()      # measured 0.67
