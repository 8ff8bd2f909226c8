"""PyTorch port, the MAC fluid simulator, against the JAX package on the
same numpy state (a 16^3 grid from seeds: random face velocities, fluid
cells marked by seeded particles, a ball of solid cells).

Tolerances:
  * elementwise steps (_sample_face_vel, advect, add_forces,
    _neighbor_counts, _apply_A, _divergence, pressure_update, extrapolate,
    extrapolate_jfa, move_particles) bit-equal: the same float32
    operations in the same order, and every division is a true division
    on both sides;
  * reclassify exact (round half to even as jnp.round);
  * pressure_solve: the CG's dot products sum in another order than
    XLA's, so the solution differs by rounding, amplified over the
    iterations: x within 1e-3 of its largest |x|, the residual at or
    below cg_tol on both sides and the iteration counts within 2 of each
    other (measured 0 and 1);
  * substep and run (2 frames of 2 substeps): particles within 1e-4 of
    the extent's size, cell types equal on >= 99.9% of cells;
  * rasterize_solids and seed_from_object on sphere_mesh(20, 20) through
    the port's scene.intersect (backface cull off): masks, colours and
    seeded particles equal;
  * the one pinned divergence: _jfa_nearest's corner cell (see the port's
    sim/fluid.py): JAX leaves an invalid cell (0, 0, 0) on its sentinel
    and gathers a clamped index, the port gives it the nearest valid
    site; pressure_update zeroes that boundary face, so a substep carries
    no difference.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.scene import scene as jscn
from pathtracer_tpu.sim import fluid as jfl
from pathtracer_tpu.utils import procgen
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.scene import scene as tscn
from pathtracer_tpu_torch.sim import fluid as tfl

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)
from test_torch_materials import _to_torch_md

N = 16


def _cfg(mod, n=N, **kw):
    return mod.FluidConfig(lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0),
                           nx=n, ny=n, nz=n, dt=0.02, **kw)


def _numpy_state(n=N, seed=0):
    """Face velocities from a seed, particles in the lower half, solid
    cells in a ball around (0.4, -0.5, 0.3)."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    zz, yy, xx = np.meshgrid(c, c, c, indexing='ij')
    solid = (xx - 0.4) ** 2 + (yy + 0.5) ** 2 + (zz - 0.3) ** 2 < 0.16
    pts = rng.uniform((-0.9, -0.95, -0.9), (0.9, 0.1, 0.9),
                      (3000, 3)).astype(np.float32)
    vel = [rng.normal(0, 1, s).astype(np.float32)
           for s in ((n, n, n + 1), (n, n + 1, n), (n + 1, n, n))]
    return vel, pts, solid


def _states(n=N, seed=0):
    vel, pts, solid = _numpy_state(n, seed)
    js = jfl.init_state(_cfg(jfl, n), pts, solid)
    js = jfl.reclassify(_cfg(jfl, n), js)._replace(
        velx=jnp.asarray(vel[0]), vely=jnp.asarray(vel[1]),
        velz=jnp.asarray(vel[2]))
    ts = convert.fluid_state(convert.numpy_fields(js), device='cpu')
    return js, ts


@pytest.fixture(scope='module')
def states():
    return _states()


def _eq(a, b, what=''):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def _eq_state(js, ts):
    for name in jfl.FluidState._fields:
        _eq(getattr(js, name), getattr(ts, name), name)


def test_init_and_conversion(states):
    js, ts = states
    vel, pts, solid = _numpy_state()
    own = tfl.reclassify(_cfg(tfl), tfl.init_state(_cfg(tfl), pts, solid,
                                                   device='cpu'))
    np.testing.assert_array_equal(own.celltypes.numpy(),
                                  np.asarray(js.celltypes))
    assert ts.celltypes.dtype == torch.int8
    kinds = np.bincount(ts.celltypes.numpy().ravel(), minlength=3)
    assert (kinds > 100).all(), kinds
    _eq_state(js, ts)
    by_name = convert.fluid_state(dict(zip(jfl.FluidState._fields, js)),
                                  device='cpu')
    _eq_state(js, by_name)
    np.testing.assert_array_equal(
        tfl.seed_box(_cfg(tfl), (0, 0, 0), (1, 1, 1), 100, seed=3),
        jfl.seed_box(_cfg(jfl), (0, 0, 0), (1, 1, 1), 100, seed=3))


def test_elementwise_steps_match_jax(states):
    js, ts = states
    jc, tc = _cfg(jfl), _cfg(tfl)
    p = np.random.default_rng(1).uniform(-1.2, 1.2, (4000, 3)).astype(
        np.float32)
    _eq(jfl._sample_face_vel(jc, js, jnp.asarray(p)),
        tfl._sample_face_vel(tc, ts, torch.as_tensor(p)))
    _eq_state(jfl.advect(jc, js), tfl.advect(tc, ts))
    _eq_state(jfl.add_forces(jc, js), tfl.add_forces(tc, ts))
    _eq(jfl._neighbor_counts(js.celltypes),
        tfl._neighbor_counts(ts.celltypes))
    x = np.random.default_rng(2).normal(size=(N, N, N)).astype(np.float32)
    _eq(jfl._apply_A(js.celltypes, jnp.asarray(x)),
        tfl._apply_A(ts.celltypes, torch.as_tensor(x)))
    _eq(jfl._divergence(jc, js), tfl._divergence(tc, ts))
    _eq_state(jfl.pressure_update(jc, js, jnp.asarray(x)),
              tfl.pressure_update(tc, ts, torch.as_tensor(x)))
    _eq_state(jfl.extrapolate(jc, js), tfl.extrapolate(tc, ts))
    _eq(jfl.move_particles(jc, js), tfl.move_particles(tc, ts))


def test_reclassify_exact(states):
    js, ts = states
    jc, tc = _cfg(jfl), _cfg(tfl)
    # particles on exact cell-centre ties (round half to even) and outside
    dx = 2.0 / N
    ties = np.asarray([[-1.0 + k * dx, -1.0 + (k + 1) * dx, 0.0]
                       for k in range(N)] + [[3.0, -3.0, 0.1]], np.float32)
    for extra in (None, ties):
        pj, pt = js.particles, ts.particles
        if extra is not None:
            pj = jnp.concatenate([pj, jnp.asarray(extra)])
            pt = torch.cat([pt, torch.as_tensor(extra)])
        _eq(jfl.reclassify(jc, js._replace(particles=pj)).celltypes,
            tfl.reclassify(tc, ts._replace(particles=pt)).celltypes)


def test_pressure_solve_matches_jax(states, monkeypatch):
    js, ts = states
    jc, tc = _cfg(jfl), _cfg(tfl)
    js = jfl.add_forces(jc, jfl.advect(jc, js))
    ts = tfl.add_forces(tc, tfl.advect(tc, ts))
    monkeypatch.setattr(tfl, 'CG_LOG', [])
    xj, rj = jfl.pressure_solve(jc, js)
    xt, rt = tfl.pressure_solve(tc, ts)
    xj = np.asarray(xj)
    assert float(rj) <= jc.cg_tol and float(rt) <= tc.cg_tol
    scale = np.abs(xj).max()
    assert scale > 1.0
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-3 * scale)
    iters = tfl.CG_LOG[0]['iters']
    # JAX's count lies within 1 of the port's: capped one short of it, its
    # solve has not converged; allowed one more, it has
    for cap, done in ((iters - 2, False), (iters + 1, True)):
        _, r = jfl.pressure_solve(dataclasses.replace(jc, cg_iters=cap), js)
        assert (float(r) <= jc.cg_tol) == done, (cap, float(r))
    assert tfl.CG_LOG[0]['residual'] == float(rt)
    # a capped solve reports the residual the cap left
    _, r_cap = tfl.pressure_solve(dataclasses.replace(tc, cg_iters=3), ts)
    assert float(r_cap) > tc.cg_tol


def test_substep_and_run_match_jax():
    """One substep and a run of 2 frames x 2 substeps (JAX's jitted
    substep, compiled once).  Cell (0, 0, 0) holds no fluid, so its faces
    are where _jfa_nearest differs (test_jfa_corner_divergence_pinned):
    the substep agrees all the same."""
    js, ts = _states(seed=4)
    assert int(ts.celltypes[0, 0, 0]) != tfl.FLUID
    jc = _cfg(jfl, nsubsteps=2)
    tc = _cfg(tfl, nsubsteps=2)
    ext = 2.0
    sj, st = jfl.substep_jit(jc, js), tfl.substep(tc, ts)
    np.testing.assert_allclose(st.particles.numpy(), np.asarray(sj.particles),
                               atol=1e-4 * ext)
    assert (st.celltypes.numpy() == np.asarray(sj.celltypes)).mean() > 0.999
    fj, frames_j = jfl.run(jc, js, nb_frames=2)
    ft, frames_t = tfl.run(tc, ts, nb_frames=2)
    assert len(frames_t) == len(frames_j) == 3
    np.testing.assert_array_equal(frames_t[0], frames_j[0])
    for a, b in zip(frames_j[1:], frames_t[1:]):
        np.testing.assert_allclose(b, a, atol=1e-4 * ext)
    assert (ft.celltypes.numpy() == np.asarray(fj.celltypes)).mean() > 0.999
    # the fluid falls and stays in the extent
    assert frames_t[-1][:, 1].mean() < frames_t[0][:, 1].mean()
    assert np.abs(frames_t[-1]).max() <= 1.0


@pytest.fixture(scope='module')
def shape_objects():
    """A sphere mesh coloured (0.8, 0.2, 0.1), for both packages."""
    md = procgen.sphere_mesh(20, 20, radius=1.0, kd=(0.8, 0.2, 0.1))
    out = []
    for mod, mesh in ((jscn, md), (tscn, _to_torch_md(md))):
        objs = mod.default_objects()
        objs.append(mod.mesh_object(mesh))
        out.append(objs)
    return out


def test_shape_authoring_matches_jax(shape_objects):
    jobjs, tobjs = shape_objects
    cfg_j = jfl.FluidConfig(lo=(-1.2, -1.2, -1.2), hi=(1.2, 1.2, 1.2),
                            nx=16, ny=16, nz=16)
    cfg_t = tfl.FluidConfig(**dataclasses.asdict(cfg_j))
    inside_j, col_j = jfl.cells_inside_object(cfg_j, jobjs, 3)
    inside_t, col_t = tfl.cells_inside_object(cfg_t, tobjs, 3,
                                              device='cpu')
    np.testing.assert_array_equal(inside_t, inside_j)
    np.testing.assert_array_equal(col_t, col_j)
    assert 0.25 < inside_t.mean() < 0.35
    for a, b in zip(jfl.seed_from_object(cfg_j, jobjs, 3, 2000),
                    tfl.seed_from_object(cfg_t, tobjs, 3, 2000,
                                         device='cpu')):
        np.testing.assert_array_equal(a, b)
    # solids: the mesh sphere and an analytic sphere beside it
    jobjs = jobjs + [jscn.sphere((1.0, 1.0, 1.0), 0.3)]
    tobjs = tobjs + [tscn.sphere((1.0, 1.0, 1.0), 0.3)]
    sj = jfl.rasterize_solids(cfg_j, jobjs)
    stt = tfl.rasterize_solids(cfg_t, tobjs, device='cpu')
    np.testing.assert_array_equal(stt, sj)
    assert stt[-1, -1, -1] and stt[8, 8, 8] and not stt[0, 0, 0]


def test_backface_cull_off_for_inside_casts(monkeypatch):
    """With the cull left on, the casts from inside a cluster-tier sphere
    (9,660 triangles in small clusters) would pass through its back faces
    and lose inside cells."""
    tobjs = tscn.default_objects()
    tobjs.append(tscn.mesh_object(_to_torch_md(
        procgen.sphere_mesh(70, 70, radius=1.0))))
    cfg = tfl.FluidConfig(lo=(-1.2, -1.2, -1.2), hi=(1.2, 1.2, 1.2),
                          nx=12, ny=12, nz=12)
    sc = tscn.build_scene([tobjs[0], tobjs[1], tobjs[3]], 1.0, device='cpu')
    assert sc.meshes[0].backface_cull and sc.meshes[0].n_clusters > 8
    inside, _ = tfl.cells_inside_object(cfg, tobjs, 3, device='cpu')
    assert inside.mean() > 0.3
    build = tscn.build_scene

    def keep_cull(*args, **kw):
        sc = build(*args, **kw)
        sc.replace = lambda **fields: sc
        return sc

    monkeypatch.setattr(tscn, 'build_scene', keep_cull)
    culled, _ = tfl.cells_inside_object(cfg, tobjs, 3, device='cpu')
    assert culled.mean() < 0.5 * inside.mean()


def test_jfa_corner_divergence_pinned():
    """An invalid corner cell (0, 0, 0): JAX's int32 sentinel squares to
    distance 0 there, so the cell keeps the sentinel and its gather reads
    a clamped index; the port gives it the nearest valid site.  Every
    other cell agrees.  On a fluid state the port fills each axis' corner
    face from its nearest valid face, and pressure_update zeroes those
    faces (they lie on the domain boundary) whatever they hold, so the
    difference does not survive a substep (test_substep_and_run_match_jax
    runs such a state)."""
    valid = np.zeros((5, 5, 6), bool)
    valid[2:4, 3, 1:3] = True
    sj = np.asarray(jfl._jfa_nearest(jnp.asarray(valid)))
    st = tfl._jfa_nearest(torch.as_tensor(valid)).numpy()
    f = np.full(1, -(1 << 20), np.int32)
    assert sj[0, 0, 0] == (f * np.int32(30) + f * np.int32(6) + f)[0]
    sites = np.argwhere(valid)
    zz, yy, xx = np.unravel_index(st[0, 0, 0], valid.shape)
    assert valid[zz, yy, xx]
    assert zz ** 2 + yy ** 2 + xx ** 2 == (sites ** 2).sum(1).min()
    other = np.ones(valid.shape, bool)
    other[0, 0, 0] = False
    np.testing.assert_array_equal(st[other], sj[other])

    _, ts = _states(seed=4)
    tc = _cfg(tfl)
    et = tfl.extrapolate_jfa(tc, ts)
    for vol, ext, valid_f in zip((ts.velx, ts.vely, ts.velz),
                                 (et.velx, et.vely, et.velz),
                                 tfl._face_valid(ts)):
        v = valid_f.numpy()
        assert not v[0, 0, 0]
        sites = np.argwhere(v)
        near = sites[(sites ** 2).sum(1) == (sites ** 2).sum(1).min()]
        assert float(ext[0, 0, 0]) in {float(vol[tuple(s_)]) for s_ in near}
    p = torch.randn((N, N, N), generator=torch.Generator().manual_seed(0))
    up = tfl.pressure_update(tc, et, p)
    assert float(up.velx[0, 0, 0]) == float(up.vely[0, 0, 0]) \
        == float(up.velz[0, 0, 0]) == 0.0
