"""PyTorch port, the rest of the bounce: fog, subsurface scattering, ghost
objects and background compositing, against the JAX package on the same
inputs (numpy, from seeds).  The JAX side runs Pallas in interpret mode.

Tolerances:
  * _int_exponential: 2e-6 relative plus 2^-22 (two ulps) of the two
    exponentials over |uy * beta| (the far branch subtracts them; XLA and
    torch round exp by an ulp apart);
  * _fog_event, both fog types and all three phase functions: the draws
    equal, the validity flags on 99.5% of the lanes (a scatter ray that
    grazes the sphere flips its visibility: 1 lane of 1,024 in one of the
    six cases), the transmittance, the scatter origin
    and direction within 2e-5 relative, the weight within 5e-4 relative
    on 99.5% of the valid lanes and within 5e-2 on all (the equiangular
    sample's atan2 / tan round differently in XLA and in torch by ulps,
    and a scatter ray that grazes the light sphere turns an ulp of its
    origin into up to 2% of its light pdf: measured on 0.2% of the lanes,
    the rest within 4.3e-4);
  * _subsurface_event: every output flag and the draws equal, points,
    normals and directions within 1e-4 absolute, the weight factor within
    1e-4 relative;
  * reservoir_same_object: found equal, t within 1e-5 relative, points
    and normals within 1e-4; the march on the cluster tier and on the tree
    tier (DENSE_CULL_MAX lowered in both packages, as in
    tests/test_torch_tiers.py), MESH_RESERVOIR_MAX_TRIS lowered on both
    sides;
  * the reservoir overflow: the one pinned divergence.  With exactly
    RESERVOIR_MAX_CROSSINGS walls in range JAX reports an overflow and a
    miss while the port finds the crossing it picks among all 16; with 24
    walls both report the overflow;
  * renders (16x12, 2 spp, 3 bounces): per sample with the allowance of
    tests/test_torch_render.py (fewer than 5% beyond 1e-3 of the image
    scale, the rest within 1e-3, means within 2%); fog is held to the
    same allowance (measured 0 flips on both fog scenes);
  * Renderer.stats()['ss_reservoir_overflow'] equal to JAX's;
  * a fog + ksub + ghost + background scene built by the port equals its
    conversion from JAX, field for field, bit for bit;
  * gradients of config 5's fog density and mesh ksub (12x10, 2 spp)
    against jax.grad: within 5e-4 of the leaf's largest |grad|
    (tests/test_torch_grad.py).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu.core import rng as jrng
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.io import image as jimg
from pathtracer_tpu.io import scene_json as jjson
from pathtracer_tpu.ops import pallas_cluster as pc
from pathtracer_tpu.render import integrator as jint
from pathtracer_tpu.render import renderer as jrnd
from pathtracer_tpu.scene import mesh as jmesh
from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.core import rng as trng
from pathtracer_tpu_torch.io import scene_json as tjson
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.render import integrator as tint
from pathtracer_tpu_torch.render import renderer as trnd
from pathtracer_tpu_torch.scene import mesh as tmesh
from pathtracer_tpu_torch.scene import scene as tscn

import test_config_parity as tcp
import test_subsurface_mesh as tsm
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)
from test_torch_materials import _to_torch_md

W, H, SPP, BOUNCES = 16, 12, 2, 3
CAM = ((0, 0, 50), (0, 0, -1), (0, 1, 0))
RADIANCE = 196964.7
KSUB = (0.6, 0.4, 0.3)
FOG_UNIFORM = {'density': 0.4, 'absorption': 0.4, 'type': 0,
               'phase_type': 0}
FOG_EXP = {'density': 0.5, 'absorption': 0.5, 'density_decay': 0.05,
           'absorption_decay': 0.05, 'type': 1, 'phase_type': 1,
           'phase_aniso': 0.6}


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _port(jsc):
    return convert.scene_from_numpy(convert.numpy_fields(jsc), device='cpu')


def _streams(n, seed):
    """The same PCG streams in both packages (JAX uint32, port int64)."""
    key = np.arange(n, dtype=np.uint32) * np.uint32(7) + np.uint32(seed)
    js = jrng.make_stream(jnp.zeros(n, jnp.uint32), jnp.asarray(key))
    ts = trng.make_stream(torch.zeros(n, dtype=torch.int64),
                          torch.as_tensor(key.astype(np.int64)))
    return js, ts


def _same_streams(js, ts):
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


def _sphere_objs(mod, **kw):
    objs = mod.default_objects()
    objs.append(mod.sphere((0.0, -17.0, 0.0), 10.0, kd=(0.7, 0.3, 0.2), **kw))
    return objs


def _pair(objs_of, **kw):
    """(JAX scene, the port's own build) of objs_of(module)."""
    return (jscn.build_scene(objs_of(jscn), jscn.default_light_intensity(),
                             **kw),
            tscn.build_scene(objs_of(tscn), tscn.default_light_intensity(),
                             device='cpu', **kw))


def _rays(n, seed, target=(0.0, -17.0, 0.0), spread=12.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-30.0, 30.0, (n, 3)).astype(np.float32)
    org[:, 1] = rng.uniform(-20.0, 25.0, n)
    aim = np.asarray(target, np.float32) + rng.normal(0.0, spread, (n, 3))
    d = (aim - org).astype(np.float32)
    return org, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# fog
# ---------------------------------------------------------------------------

def test_int_exponential_matches_jax():
    rng = np.random.default_rng(0)
    n = 4096
    y0 = rng.uniform(-30.0, 40.0, n).astype(np.float32)
    s = np.exp(rng.uniform(-3.0, 14.0, n)).astype(np.float32)
    uy = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    uy[:64] = rng.uniform(-1e-3, 1e-3, 64)          # the series branch
    for beta in (0.05, 0.02, 1e-5):
        want = np.asarray(jint._int_exponential(
            jnp.asarray(y0), jnp.float32(-27.3), jnp.float32(beta),
            jnp.asarray(s), jnp.asarray(uy)))
        got = tint._int_exponential(_t(y0), torch.tensor(-27.3),
                                    torch.tensor(beta), _t(s), _t(uy))
        assert np.isfinite(want).all()
        # the far branch subtracts two exponentials: an ulp of either,
        # over |uy * beta|, is the formula's own rounding
        e1 = np.exp(np.clip(-beta * (y0 - -27.3), -80, 80))
        e2 = np.exp(np.clip(-beta * (y0 + s * uy - -27.3), -80, 80))
        ulps = 2.0 ** -22 * (e1 + e2) / np.maximum(np.abs(uy * beta), 1e-4)
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert (err <= 2e-6 * np.abs(want) + ulps).all(), beta


@pytest.mark.parametrize('fog_type', [0, 1], ids=['uniform', 'exponential'])
@pytest.mark.parametrize('phase', [0, 1, 2],
                         ids=['isotropic', 'schlick', 'rayleigh'])
def test_fog_event_matches_jax(fog_type, phase):
    fog = dict(FOG_EXP, type=fog_type, phase_type=phase)
    jsc, tsc = _pair(_sphere_objs, fog=fog)
    n = 1024
    org, d = _rays(n, 1 + phase + 3 * fog_type)
    hit = jscn.intersect(jsc, jnp.asarray(org), jnp.asarray(d))
    seg = np.array(hit.t)
    seg[:16] = 1e30                               # as miss lanes carry
    assert (seg > 1e5).sum() > 16 and (seg < 1e3).any()      # the dome
    rng = np.random.default_rng(9)
    lp = (np.asarray(jsc.center_light)
          + rng.normal(0.0, 6.0, (n, 3))).astype(np.float32)
    js, ts = _streams(n, 3)
    want = jint._fog_event(jsc, jnp.asarray(org), jnp.asarray(d),
                           jnp.asarray(seg), jnp.asarray(lp), js)
    got = tint._fog_event(tsc, _t(org), _t(d), _t(seg), _t(lp), ts)
    _same_streams(want[5], got[5])
    valid = np.asarray(want[4])
    assert (got[4].numpy() == valid).mean() >= 0.995
    assert 0.2 < valid.mean() < 1.0
    valid = valid & got[4].numpy()
    for k in (0, 1, 2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-5, atol=2e-5)
    w_j = np.asarray(want[3])[valid]
    rel = np.abs(got[3].numpy()[valid] - w_j) / np.abs(w_j)
    assert (rel <= 5e-4).mean() >= 0.995 and rel.max() <= 5e-2


# ---------------------------------------------------------------------------
# subsurface
# ---------------------------------------------------------------------------

def test_subsurface_event_matches_jax():
    jsc, tsc = _pair(lambda m: _sphere_objs(m, ksub=KSUB))
    assert jsc.ss_enabled and tsc.ss_enabled
    n = 1024
    org, d = _rays(n, 11, spread=6.0)
    jh = jscn.intersect(jsc, jnp.asarray(org), jnp.asarray(d))
    th = tscn.intersect(tsc, _t(org), _t(d))
    np.testing.assert_array_equal(th.obj_id.numpy(), np.asarray(jh.obj_id))
    take = (np.asarray(jh.obj_id) == 3) & (
        np.random.default_rng(12).uniform(size=n) < 0.7)
    assert take.sum() > 200
    js, ts = _streams(n, 5)
    want = jint._subsurface_event(jsc, jh, jh.p, jh.n, jnp.asarray(d),
                                  jnp.asarray(take), js)
    got = tint._subsurface_event(tsc, th, th.p, th.n, _t(take), ts)
    _same_streams(want[6], got[6])
    ok = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), ok)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
    assert ok.sum() > 100
    for k in (1, 2, 3):
        np.testing.assert_allclose(got[k].numpy()[ok],
                                   np.asarray(want[k])[ok], atol=1e-4)
    np.testing.assert_allclose(got[4].numpy()[ok], np.asarray(want[4])[ok],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))


def _check_probe(want, got, min_found=0.5):
    found = np.asarray(want.found)
    np.testing.assert_array_equal(got.found.numpy(), found)
    assert found.mean() > min_found
    np.testing.assert_allclose(got.t.numpy()[found],
                               np.asarray(want.t)[found], rtol=1e-5)
    for k in ('p', 'n'):
        np.testing.assert_allclose(getattr(got, k).numpy()[found],
                                   np.asarray(getattr(want, k))[found],
                                   atol=1e-4)
    np.testing.assert_array_equal(got.ksub.numpy(), np.asarray(want.ksub))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_reservoir_analytic_rows_match_jax():
    """Both roots of the light, dome and sphere rows and the ground plane,
    every row a probe target."""
    jsc, tsc = _pair(lambda m: _sphere_objs(m, ksub=KSUB))
    n = 2048
    rng = np.random.default_rng(13)
    org, d = _rays(n, 14, spread=8.0)
    tmax = rng.uniform(1.0, 80.0, n).astype(np.float32)
    obj = rng.integers(0, 4, n).astype(np.int32)
    obj[: n // 2] = 3
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    want = jscn.reservoir_same_object(jsc, jnp.asarray(org), jnp.asarray(d),
                                      jnp.asarray(tmax), jnp.asarray(obj),
                                      jnp.asarray(u))
    got = tscn.reservoir_same_object(tsc, _t(org), _t(d), _t(tmax),
                                     _t(obj.astype(np.int64)), _t(u))
    _check_probe(want, got, min_found=0.2)


def _probe_rays(n, seed):
    """tests/test_subsurface_mesh.py's probe rays through the sphere."""
    rng = np.random.default_rng(seed)
    org = (np.array([0.0, -17.0, 30.0], np.float32)
           + rng.normal(0, 2.0, (n, 3)).astype(np.float32))
    d = (np.array([0.0, 0.0, -1.0], np.float32)
         + rng.normal(0, 0.05, (n, 3)).astype(np.float32))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (org, d.astype(np.float32), np.full(n, 60.0, np.float32),
            rng.uniform(0.05, 0.95, n).astype(np.float32))


def _probe_both(jsc, tsc, n, seed):
    org, d, tmax, u = _probe_rays(n, seed)
    want = jscn.reservoir_same_object(
        jsc, jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmax),
        jnp.full((n,), 3, jnp.int32), jnp.asarray(u))
    got = tscn.reservoir_same_object(tsc, _t(org), _t(d), _t(tmax),
                                     torch.full((n,), 3), _t(u))
    return want, got


def test_reservoir_dense_mesh_matches_jax():
    """The dense count-then-pick on a 12.6k-triangle BVH-tier mesh."""
    jsc = tsm._mesh_scene()
    tsc = _port(jsc)
    mesh = tsc.meshes[0]
    assert mesh.soup is not None and not mesh.use_cluster
    assert mesh.num_triangles <= tscn.MESH_RESERVOIR_MAX_TRIS
    _check_probe(*_probe_both(jsc, tsc, 64, 0))


def _cluster_ss_scene(n, ksub=KSUB):
    """tests/test_subsurface_mesh.py's ksub sphere, uploaded on the
    cluster tier in JAX and converted."""
    md = procgen.sphere_mesh(n, n, radius=10.0)
    objs = jscn.default_objects()
    objs.append(jscn.mesh_object(md, translation=(0.0, -17.0, 0.0),
                                 ksub=ksub))
    sc = jscn.build_scene(objs, jscn.default_light_intensity())
    m = jmesh.upload_mesh(md, obj_row=3, use_cluster=True,
                          default_ksub=ksub)
    assert not m.backface_cull
    sc = sc.replace(meshes=(m,))
    return sc, _port(sc)


@pytest.mark.parametrize('tier', ['cluster', 'tree'])
def test_reservoir_march_matches_jax(tier, monkeypatch):
    """The crossing march (MESH_RESERVOIR_MAX_TRIS lowered in both
    packages) on the dense cluster tier, and on the tree tier with its
    bvh_hit_sparse net (a mesh below PACKET_MAX_TRIS, so it keeps its soup
    and BVH, then DENSE_CULL_MAX lowered below its cluster count in both
    packages).  The two meshes differ in size: JAX's jit caches on the
    cluster count."""
    monkeypatch.setattr(jscn, 'MESH_RESERVOIR_MAX_TRIS', 1000)
    monkeypatch.setattr(tscn, 'MESH_RESERVOIR_MAX_TRIS', 1000)
    jsc, tsc = _cluster_ss_scene(80 if tier == 'cluster' else 56)
    mesh = tsc.meshes[0]
    if tier == 'tree':
        assert mesh.soup is not None and mesh.n_clusters > 1
        monkeypatch.setattr(pc, 'DENSE_CULL_MAX', mesh.n_clusters - 1)
        monkeypatch.setattr(tc, 'DENSE_CULL_MAX', mesh.n_clusters - 1)
    assert mesh.use_cluster and not mesh.backface_cull
    assert (mesh.n_clusters > tc.DENSE_CULL_MAX) == (tier == 'tree')
    tscn.MARCH_LOG = []
    try:
        want, got = _probe_both(jsc, tsc, 48, 1)
    finally:
        log, tscn.MARCH_LOG = tscn.MARCH_LOG, None
    assert len(log) == 1 and log[0]['lanes'][0] == 48
    assert len(log[0]['lanes']) >= 3 and log[0]['overflow'] == 0
    _check_probe(want, got)


def _walls(n_walls):
    """tests/test_subsurface_mesh.py's wall stack in both packages, on the
    brute-force tier."""
    md = tsm._wall_stack_mesh(n_walls)
    jm = jmesh.upload_mesh(md, obj_row=2, interp_normals=False,
                           use_cluster=False)
    tm = tmesh.upload_mesh(_to_torch_md(md), obj_row=2, interp_normals=False,
                           use_cluster=False, dev='cpu')
    assert jm.use_brute and tm.use_brute
    return jm, tm


@pytest.mark.parametrize('extra', [0, 8], ids=['exactly_k', 'beyond_k'])
def test_reservoir_overflow(extra):
    """Lanes 0-3 cross every wall, lanes 4-7 two of them.  With exactly
    RESERVOIR_MAX_CROSSINGS walls JAX flags the long lanes as overflows
    (still & (i_end >= K), pallas scene.py:1111) and reports a miss,
    though all 16 crossings are recorded; the port queries once more,
    finds nothing, and picks the floor(u * 16)-th crossing.  With 8 walls
    more both report the overflow and a miss."""
    k = jscn.RESERVOIR_MAX_CROSSINGS
    assert tscn.RESERVOIR_MAX_CROSSINGS == k
    jm, tm = _walls(k + extra)
    n = 8
    org = np.tile(np.array([[0.0, 0.0, 5.0]], np.float32), (n, 1))
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    tmax = np.where(np.arange(n) < 4, 1e4, 6.5).astype(np.float32)
    u = np.full(n, 0.5, np.float32)
    want = jscn._mesh_reservoir_march(jm, jnp.asarray(org), jnp.asarray(d),
                                      jnp.asarray(tmax), jnp.asarray(u))
    got = tscn._mesh_reservoir_march(tm, _t(org), _t(d), _t(tmax), _t(u))
    jfound, jov = np.asarray(want[0]), np.asarray(want[6])
    tfound, tov = got[0].numpy(), got[6].numpy()
    # short lanes: two crossings, found by both, the same pick
    assert jfound[4:].all() and tfound[4:].all()
    assert not jov[4:].any() and not tov[4:].any()
    np.testing.assert_array_equal(got[1].numpy()[4:], np.asarray(want[1])[4:])
    # long lanes: JAX always overflows; the port only past K crossings
    assert jov[:4].all() and not jfound[:4].any()
    if extra:
        assert tov[:4].all() and not tfound[:4].any()
    else:
        assert not tov[:4].any() and tfound[:4].all()
        # the floor(0.5 * 16) = 8th crossing: the wall at z = -8
        np.testing.assert_array_equal(got[1].numpy()[:4], 13.0)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def _compare(jsc, tsc):
    cp = rng_host.random_per_pixel_fast(W, H)
    cfg = dict(width=W, height=H, nrays=SPP, nb_bounces=BOUNCES)
    _, s_j = jrnd.render_unsplatted(jsc, jpt.make_camera(*CAM),
                                    jnp.asarray(cp), jrnd.RenderConfig(**cfg))
    _, s_t = trnd.render_unsplatted(tsc, tpt.make_camera(*CAM),
                                    torch.as_tensor(cp),
                                    trnd.RenderConfig(**cfg))
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    assert (s_j.max(-1) > 0).mean() > 0.2          # non-vacuous: lit
    scale = max(np.abs(s_j).max(), 1e-6)
    rel = np.abs(s_t - s_j).max(-1) / scale
    flipped = rel > 1e-3
    print(f'flipped {flipped.mean():.5f} tight max {rel[~flipped].max():.3g}'
          f' mean rel {abs(s_t.mean() - s_j.mean()) / scale:.3g}')
    assert flipped.mean() < 0.05
    assert rel[~flipped].max() < 1e-3
    assert abs(s_t.mean() - s_j.mean()) / scale < 0.02
    return s_j, s_t


def _background(color=(0.3, 0.5, 0.9)):
    bg = np.zeros((6, 8, 3), np.float32)
    bg[:] = np.asarray(color, np.float32) * 196964.699
    bg[:3] *= 0.5
    return bg


def _ghost_objs(mod, md=None):
    objs = mod.default_objects()
    objs.append(mod.sphere((5.0, -10.0, 8.0), 8.0, ghost=True))
    objs.append(mod.sphere((-8.0, -20.0, 0.0), 7.0, kd=(0.7, 0.3, 0.2)))
    if md is not None:
        objs.append(mod.mesh_object(md, translation=(12.0, -22.0, -4.0),
                                    ghost=True))
    return objs


def _media_scene(name, monkeypatch):
    if name in ('fog_uniform', 'fog_exponential'):
        fog = FOG_UNIFORM if name == 'fog_uniform' else FOG_EXP
        jsc = jscn.build_scene(_sphere_objs(jscn),
                               jscn.default_light_intensity(), fog=fog)
        return jsc, _port(jsc)
    if name == 'ss_analytic':
        return _pair(lambda m: _sphere_objs(m, ksub=KSUB))
    if name == 'ss_dense_mesh':
        md = procgen.sphere_mesh(16, 16, radius=10.0)
        objs = jscn.default_objects()
        objs.append(jscn.mesh_object(md, translation=(0.0, -17.0, 0.0),
                                     ksub=KSUB))
        jsc = jscn.build_scene(objs, jscn.default_light_intensity())
        assert jsc.meshes[0].use_brute
        return jsc, _port(jsc)
    if name == 'ss_march':
        monkeypatch.setattr(jscn, 'MESH_RESERVOIR_MAX_TRIS', 100)
        monkeypatch.setattr(tscn, 'MESH_RESERVOIR_MAX_TRIS', 100)
        return _cluster_ss_scene(20)
    md = procgen.sphere_mesh(8, 8, radius=4.0)
    jsc = jscn.build_scene(_ghost_objs(jscn, md),
                           jscn.default_light_intensity(),
                           background=_background())
    tsc = tscn.build_scene(_ghost_objs(tscn, _to_torch_md(md)),
                           tscn.default_light_intensity(),
                           background=_background(), device='cpu')
    assert tsc.ghost_enabled and tsc.background is not None
    return jsc, tsc


@pytest.mark.parametrize('name', ['fog_uniform', 'fog_exponential',
                                  'ss_analytic', 'ss_dense_mesh', 'ss_march',
                                  'ghost_background'])
def test_media_render_matches_jax(name, monkeypatch):
    jsc, tsc = _media_scene(name, monkeypatch)
    _compare(jsc, tsc)


def test_overflow_stat_matches_jax(monkeypatch):
    """Renderer.stats()['ss_reservoir_overflow'] on the march scene."""
    jsc, tsc = _media_scene('ss_march', monkeypatch)
    kw = dict(width=W, height=H, nrays=1, nb_bounces=BOUNCES,
              samples_per_wave=1)
    rj = jpt.Renderer(jsc, jpt.make_camera(*CAM), jrnd.RenderConfig(**kw))
    rt = tpt.Renderer(tsc, tpt.make_camera(*CAM), trnd.RenderConfig(**kw))
    tscn.MARCH_LOG = []
    try:
        rj.step()
        rt.step()
    finally:
        log, tscn.MARCH_LOG = tscn.MARCH_LOG, None
    assert log, 'no march ran'
    st_j, st_t = rj.stats(1.0), rt.stats(1.0)
    assert st_t['ss_reservoir_overflow'] == st_j['ss_reservoir_overflow']
    assert st_t['rays_traced'] == st_j['rays_traced']


# ---------------------------------------------------------------------------
# scene state
# ---------------------------------------------------------------------------

def _assert_same(a, b, name):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    elif dataclasses.is_dataclass(a) and not isinstance(
            a, (tc.ClusteredMesh,)):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f'{name}.{f.name}')
    elif isinstance(a, tuple) and not (a and isinstance(a[0], str)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{name}[{i}]')
    elif isinstance(a, tc.ClusteredMesh):
        for k in ('ctab', 'starts', 'sub_bounds', 'planes', 'nrm', 'bounds'):
            _assert_same(getattr(a, k), getattr(b, k), f'{name}.{k}')
    else:
        assert a == b, name


def test_build_scene_equals_conversion():
    """Fog, a ksub-mapped mesh, a ghost sphere, a ghost mesh and a
    background photo: the port's own build_scene against the conversion
    of JAX's (its meshes re-uploaded on the cluster tier), field for
    field."""
    rng = np.random.default_rng(21)
    ksub_map = rng.uniform(0.2, 1.0, (4, 4, 3)).astype(np.float32)
    md = procgen.sphere_mesh(12, 12, radius=5.0)
    gmd = procgen.sphere_mesh(8, 8, radius=3.0)

    def objs_of(mod, md, gmd):
        objs = _ghost_objs(mod, gmd)
        objs.append(mod.mesh_object(md, translation=(-5.0, -20.0, 6.0),
                                    ksub=KSUB, textures={'ksub': ksub_map}))
        return objs

    kw = dict(fog=FOG_EXP, background=_background(), merge_meshes=False)
    jsc = jscn.build_scene(objs_of(jscn, md, gmd),
                           jscn.default_light_intensity(), **kw)
    objs = objs_of(jscn, md, gmd)
    meshes = tuple(jmesh.upload_mesh(
        objs[m.obj_row].mesh_data, obj_row=m.obj_row, use_cluster=True,
        default_ksub=objs[m.obj_row].ksub,
        texture_overrides=objs[m.obj_row].textures,
        allow_backface=not objs[m.obj_row].ghost) for m in jsc.meshes)
    conv = _port(jsc.replace(meshes=meshes))
    own = tscn.build_scene(objs_of(tscn, _to_torch_md(md), _to_torch_md(gmd)),
                           tscn.default_light_intensity(), device='cpu', **kw)
    assert own.fog_enabled and own.ss_enabled and own.ghost_enabled
    assert own.meshes[1].textures[0].ksub is not None
    assert not any(m.backface_cull for m in own.meshes)
    _assert_same(own, conv, 'scene')


def test_load_background_matches_jax(tmp_path):
    from PIL import Image
    img = np.random.default_rng(22).integers(0, 256, (5, 7, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / 'bg.png')
    np.testing.assert_array_equal(
        tscn.load_background(str(tmp_path / 'bg.png')),
        jscn.load_background(str(tmp_path / 'bg.png')))


# ---------------------------------------------------------------------------
# config 5 gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def config5(tmp_path_factory):
    """config5_office.json with tests/test_gradcheck_ladder.py's stand-ins
    (antiqueOffice.obj = sphere_mesh(6, 6), an 8 x 16 HDR), loaded and
    built by each package."""
    from pathtracer_tpu_torch.io import image as timg
    d = tmp_path_factory.mktemp('config5')
    shutil.copy(os.path.join(tcp.CONFIG_DIR, 'config5_office.json'), d)
    tcp._write_obj(d / 'antiqueOffice.obj',
                   procgen.sphere_mesh(6, 6, radius=1.0))
    jimg.save_hdr(str(d / 'env.hdr'), np.random.default_rng(7).uniform(
        0.05, 3.0, (8, 16, 3)).astype(np.float32))
    path = str(d / 'config5_office.json')
    jo, jli, jcam, _, jex = jjson.load_scene(path)
    to, tli, tcam, _, tex = tjson.load_scene(path, device='cpu')
    jsc = jscn.build_scene(jo, jli, envmap_intensity=jex['envmap_intensity'],
                           envmap=jimg.load_hdr(
                               str(d / jex['envmap'])), fog=jex['fog'])
    tsc = tscn.build_scene(to, tli, envmap_intensity=tex['envmap_intensity'],
                           envmap=timg.load_hdr(str(d / tex['envmap'])),
                           fog=tex['fog'], device='cpu')
    assert jsc.fog_enabled and tsc.fog_enabled and tsc.ss_enabled
    return jsc, tsc, jcam, tcam


def test_config5_grads_match_jax(config5):
    """jax.grad against the port's autograd for fog density and the mesh's
    g_ksub at 12x10 x 2 spp (tests/test_gradcheck_ladder.py's size)."""
    jsc, tsc, jcam, tcam = config5
    w, h = 12, 10
    cp = rng_host.random_per_pixel_fast(w, h)
    cfg = dict(width=w, height=h, nrays=2, nb_bounces=3)

    def with_leaves(sc, leaves):
        mesh = sc.meshes[0]
        return sc.replace(fog_density=leaves['fog_density'],
                          meshes=(mesh.replace(g_ksub=leaves['g_ksub']),))

    def jloss(leaves):
        img, _ = jrnd.render_unsplatted(with_leaves(jsc, leaves), jcam,
                                        jnp.asarray(cp),
                                        jrnd.RenderConfig(**cfg))
        return jnp.mean(img) / RADIANCE

    base = {'fog_density': jsc.fog_density, 'g_ksub': jsc.meshes[0].g_ksub}
    want = {k: np.asarray(v) for k, v in jax.grad(jloss)(base).items()}
    leaves = {'fog_density': tsc.fog_density.clone().requires_grad_(),
              'g_ksub': tsc.meshes[0].g_ksub.clone().requires_grad_()}
    img, _ = trnd.render_unsplatted(with_leaves(tsc, leaves), tcam,
                                    torch.as_tensor(cp),
                                    trnd.RenderConfig(**cfg))
    grads = torch.autograd.grad(img.mean() / RADIANCE, list(leaves.values()))
    for k, g in zip(leaves, grads):
        scale = np.abs(want[k]).max()
        assert scale > 0 and np.isfinite(g.numpy()).all(), k
        err = np.abs(g.numpy() - want[k]).max() / scale
        print(f'{k}: {err:.3g} of the largest |grad|')
        assert err <= 5e-4, f'{k}: {err:.3g} of its largest |grad|'
