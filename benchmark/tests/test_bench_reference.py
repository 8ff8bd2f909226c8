"""The reference on the CPU: its streams, rotation table, lane order and
mesh queries each against a second statement of them; its agreement with
the program on tiny cells; the control and the planted faults, each of
which must turn `correct` false.  The tests marked `gpu` repeat the
control on the card."""

import math

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.reference import pcg
from benchmark.reference import scene as rscn
from benchmark.reference import tracer
from benchmark.tests.conftest import BENCH, CELLS, tiny

FRAME_CELLS = [c for c in CELLS if not c.endswith('.grad')]
GRAD_CELLS = [c for c in CELLS if c.endswith('.grad')]


def _pcg_sequence(n):
    """The first n floats of pcg32(0) on its default stream, sequentially
    with Python integers."""
    mult, inc, mask = pcg.MULT, pcg.DEFAULT_INC, (1 << 64) - 1
    s = ((0 + inc) * mult + inc) & mask
    out = []
    for _ in range(n):
        xs = (((s >> 18) ^ s) >> 27) & 0xFFFFFFFF
        rot = s >> 59
        o = ((xs >> rot) | (xs << ((32 - rot) & 31))) & 0xFFFFFFFF
        out.append(np.float32(np.float32(o) * np.float32(pcg.INV_U32)))
        s = (s * mult + inc) & mask
    return np.asarray(out, np.float32)


def test_streams_equal_python_integers():
    pcg.self_check('cpu')


def test_rotation_table_jump_equals_sequence():
    seq = _pcg_sequence(2 * 300)
    lanes = np.array([0, 1, 2, 17, 255, 299])
    got = pcg.cp_shifts(lanes)
    assert np.array_equal(got[:, 0], seq[2 * lanes])
    assert np.array_equal(got[:, 1], seq[2 * lanes + 1])


@pytest.mark.parametrize('w,h,tile', [(1920, 1080, 32), (48, 40, 32),
                                      (24, 16, 0), (30, 7, 32)])
def test_lane_order_is_the_renderers(w, h, tile):
    from pathtracer_tpu_torch.render import renderer
    pi, pj, _ = renderer._pixel_order(w, h, tile, 'cpu')
    lane = tracer.lane_of(pi, pj, w, h, tile)
    assert torch.equal(lane, torch.arange(w * h))


def _brute(tris, o, d, tmax):
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    t, _, _ = rscn._tri_t(o, d, v0[None].expand(len(o), -1, -1),
                          (v1 - v0)[None].expand(len(o), -1, -1),
                          (v2 - v0)[None].expand(len(o), -1, -1))
    t = torch.where(t < tmax[:, None], t, torch.full_like(t, math.inf))
    return t.min(dim=1)


def test_chunked_mesh_queries_equal_brute_force():
    from benchmark.harness import procgen
    v, t, n, _ = procgen.displaced_sphere(40, 40, 5.0, 0.25, 9)
    mesh = rscn.build_mesh(v, t, n, (0.0, 0.0, 0.0), 3, 'cpu')
    g = torch.Generator().manual_seed(4)
    o = torch.randn(3000, 3, generator=g) * 8.0
    d = tracer.normalize(torch.randn(3000, 3, generator=g) - 0.1 * o)
    tmax = torch.full((3000,), 1e30)
    tb, jb = _brute(torch.as_tensor(v)[torch.as_tensor(t).long()], o, d,
                    tmax)
    tc, jc = rscn.mesh_closest(mesh, o, d, tmax)
    hit = torch.isfinite(tb)
    assert int(hit.sum()) > 500
    assert torch.equal(tc[hit], tb[hit]) and torch.equal(jc[hit], jb[hit])
    assert bool((jc[~hit] == -1).all())
    lim = torch.rand(3000, generator=g) * 12.0
    assert torch.equal(rscn.mesh_any(mesh, o, d, lim), tb < lim)


@pytest.mark.parametrize('cell', CELLS)
def test_reference_agrees_with_the_program(cell):
    """The frozen reference against the program on a tiny scene: every
    pixel and the gradients within float32 rounding."""
    res, _ = bench_run.run(cell, 424242, 0.3, False, device='cpu',
                           overrides=tiny(cell))
    assert res['correct'] is True
    for name, v in res['check'].items():
        assert v['value'] <= (0.0 if name == 'flipped_share' else 1e-5)


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails(cell):
    """The reference in bfloat16 in the program's place fails the cell's
    limits."""
    res, _ = bench_run.run(cell, 31337, 0.3, False, device='cpu',
                           overrides=tiny(cell),
                           controls=(torch.bfloat16,))
    assert res['correct'] is True
    assert res['controls']['bfloat16']['correct'] is False


def _stuck_step(self, nsamples=None):
    """A render step that returns the film unchanged."""
    self.samples_done += nsamples or self.cfg.samples_per_wave
    return self


def _half_samples(monkeypatch):
    """Every other sample's splat is dropped; the film's weights make the
    image the mean over the rest."""
    from pathtracer_tpu_torch.render import film
    orig, calls = film.splat, [0]

    def splat(*a, **k):
        calls[0] += 1
        if calls[0] % 2:
            return orig(*a, **k)
        return a[1], a[2]

    monkeypatch.setattr(film, 'splat', splat)


def _altered_colors(monkeypatch):
    """Each path's radiance altered by 1% where the integrator makes it."""
    from pathtracer_tpu_torch.render import integrator
    orig = integrator.trace_paths

    def trace_paths(*a, **k):
        out = orig(*a, **k)
        return (out[0] * 1.01,) + tuple(out[1:])

    monkeypatch.setattr(integrator, 'trace_paths', trace_paths)


def _stuck(monkeypatch):
    from pathtracer_tpu_torch.render import renderer
    monkeypatch.setattr(renderer.Renderer, 'step', _stuck_step)


def _half_batch_mean(monkeypatch):
    """The mean image over the first half of the samples only."""
    from pathtracer_tpu_torch.render import renderer
    orig = renderer.render_unsplatted

    def render_unsplatted(*a, **k):
        img, samples = orig(*a, **k)
        return samples[:, :, :samples.shape[2] // 2].mean(dim=2), samples

    monkeypatch.setattr(renderer, 'render_unsplatted', render_unsplatted)


def _altered_mean(monkeypatch):
    from pathtracer_tpu_torch.render import renderer
    orig = renderer.render_unsplatted

    def render_unsplatted(*a, **k):
        img, samples = orig(*a, **k)
        return img * 1.01, samples

    monkeypatch.setattr(renderer, 'render_unsplatted', render_unsplatted)


FAULTS = ([(c, f) for c in FRAME_CELLS
           for f in (_stuck, _half_samples, _altered_colors)]
          + [(c, f) for c in GRAD_CELLS
             for f in (_half_batch_mean, _altered_mean)])


@pytest.mark.parametrize('cell,fault', FAULTS,
                         ids=[f'{c}-{f.__name__.strip("_")}'
                              for c, f in FAULTS])
def test_planted_fault_turns_correct_false(cell, fault, monkeypatch):
    """The whole run, the chip's look skipped, with the timed path broken
    underneath: `correct` comes out false."""
    fault(monkeypatch)
    res, _ = bench_run.run(cell, 2024, 0.3, False, device='cpu',
                           overrides=tiny(cell))
    assert res['correct'] is False


def test_limits_are_held_in_cell_files():
    import json
    import os
    from benchmark.tests.conftest import ROOT
    for w in BENCH['workloads']:
        with open(os.path.join(ROOT, 'benchmark', 'workloads',
                               w['name'] + '.json')) as f:
            lim = json.load(f)['limits']
        assert lim and all(v > 0 for v in lim.values())


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_on_the_card(cell, card):
    """On the card at a reduced size: the program passes and the bfloat16
    control fails, on three seeds."""
    ov = tiny(cell)
    ov['config']['resolution'] = [480, 270]
    if 'mesh' in ov['config']:
        ov['config']['mesh'] = {'n_lat': 300, 'n_lon': 300}
    for seed in (11, 12, 13):
        res, _ = bench_run.run(cell, seed, 1.0, False, device='cuda',
                               overrides=ov, controls=(torch.bfloat16,))
        assert res['correct'] is True
        assert res['controls']['bfloat16']['correct'] is False


def test_mesh_copy_equals_the_ports_generator():
    """The benchmark's generator is a copy of utils.procgen.sphere_mesh."""
    from benchmark.harness import procgen
    from pathtracer_tpu_torch.utils import procgen as port
    v, t, n, uv = procgen.displaced_sphere(30, 34, 14.0, 0.25, 0)
    md = port.sphere_mesh(30, 34, radius=14.0, displace_amp=0.25)
    assert np.array_equal(v, md.vertices) and np.array_equal(t, md.vtx_idx)
    assert np.array_equal(n, md.normals) and np.array_equal(uv, md.uvs)
